"""E5: pretrained ViT -> MHLA fine-tune (port of
``focused_attention_vit_tpu/experiments/mhla_pretrained.py``; reference:
experiments/mhla_pretrained.py).

The model is :class:`~..models.VisionTransformerMHLA` with
``use_mhla=True`` (W = 7 by default), as in JAX. Surgery: the converted ViT
weights and an identity ``latent_proj`` (reference: :224-225). LR groups:
body 1x, ``latent_proj`` 5x, head at ``head_learning_rate`` (reference:
:319-327); ``freeze_layers`` keeps the head and ``latent_proj`` trainable
(reference: :237-247). Complexity ratio W/(N+1) (reference: :264-283).
CSV: ``exp4_pretrained_mhla.csv`` (reference: :490-524).

At ViT-B/16 (S = 197) the MHLA layer takes the plain dense band, no kernel;
``FAVIT_MHLA_IMPL=shiftband FAVIT_USE_PALLAS_MHLA=1`` takes the tile band
(K6/K7) on the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from focused_attention_vit_tpu_torch.convert.checkpoints import (
    vit_state_to_mhla,
)
from focused_attention_vit_tpu_torch.experiments.base import ExperimentBase
from focused_attention_vit_tpu_torch.experiments.pretrained_common import (
    PretrainedMixin,
)
from focused_attention_vit_tpu_torch.models import VisionTransformerMHLA
from focused_attention_vit_tpu_torch.ops.window import DENSE_BAND_MAX_SEQ
from focused_attention_vit_tpu_torch.utils.metrics import (
    calculate_vit_complexity,
)

@dataclass
class PretrainedMHLAViTExperiment(PretrainedMixin, ExperimentBase):
    window_size: int = 7
    model_display_name: str = "Pretrained ViT + MHLA"
    csv_filename: str = "exp4_pretrained_mhla.csv"

    def _auto_microbatch_value(self) -> Optional[int]:
        # JAX's shape (its own value past the dense band's reach, the field
        # below it), kept so a card measurement can fill either; JAX's 1 and
        # 16 are TPU measurements, so both are off here (PERF.md's sweep).
        s = (self.img_size // self.patch_size) ** 2 + 1
        if s > DENSE_BAND_MAX_SEQ:
            return None
        return self.auto_microbatch

    def build_model(self):
        return VisionTransformerMHLA(
            img_size=self.img_size,
            patch_size=self.patch_size,
            in_channels=self.in_channels,
            num_classes=self.num_classes,
            embed_dim=self.embed_dim,
            depth=self.depth,
            num_heads=self.num_heads,
            mlp_ratio=self.mlp_ratio,
            window_size=self.window_size,
            use_mhla=True,
            dropout=self.dropout,
            attn_dropout=self.attn_dropout,
            embed_dropout=self.embed_dropout,
            device=self.torch_device,
            generator=torch.Generator().manual_seed(self.seed),
        )

    def surgery(self, vit_state):
        return vit_state_to_mhla(vit_state, self.depth,
                                 self.embed_dim // self.num_heads)

    def label_fn(self, path: str) -> str:
        if path.startswith("head"):
            return "head"
        if "latent_proj" in path:
            return "latent"
        return "frozen" if self._is_frozen_path(path, True) else "body"

    def group_lrs(self) -> Dict[str, float]:
        return {
            "body": self.learning_rate,
            "latent": self.learning_rate * 5,  # reference: :320-327
            "head": self.head_learning_rate,
        }

    def theoretical_metrics(self) -> Dict[str, Any]:
        traditional = calculate_vit_complexity(
            img_size=self.img_size,
            patch_size=self.patch_size,
            embed_dim=self.embed_dim,
            depth=self.depth,
            num_heads=self.num_heads,
            mlp_ratio=self.mlp_ratio,
            in_channels=self.in_channels,
        )
        num_tokens = (self.img_size // self.patch_size) ** 2 + 1
        ratio = self.window_size / num_tokens  # reference: :274
        self.metrics["traditional_complexity"] = traditional
        self.metrics["complexity_reduction"] = {
            "ratio": ratio,
            "window_size": self.window_size,
            "num_tokens": num_tokens,
        }
        return {
            # The reference adds depth * D latent params (:280; the latent
            # projection is d x d + d a block, shared by the heads).
            "parameters": traditional["parameters"]
            + self.depth * self.embed_dim,
            "flops": traditional["flops"] * ratio,
            "time_complexity": traditional["time_complexity"] * ratio,
            "space_complexity_bytes": traditional["space_complexity_bytes"],
            "space_complexity_mb": traditional["space_complexity_bytes"]
            / (1024 * 1024),
        }

    def results_row(self) -> Dict[str, Any]:
        row = super().results_row()
        row.pop("parameters", None)
        out = {
            "model": self.model_display_name,
            "pretrained_source": self.pretrained_source,
            "pretrained_model_variant": self.pretrained_model_variant,
            "freeze_layers": str(self.freeze_layers),
        }
        for k, v in row.items():
            if k == "model":
                continue
            out[k] = v
            if k == "num_heads":
                out["window_size"] = self.window_size
                out["complexity_reduction_ratio"] = self.metrics[
                    "complexity_reduction"]["ratio"]
                out["total_parameters"] = self.param_counts["total_params"]
                out["trainable_parameters"] = self.param_counts[
                    "trainable_params"]
                out["frozen_parameters"] = self.param_counts["frozen_params"]
        return out
