"""E6: pretrained ViT -> SPPP + MHLA fine-tune (port of
``focused_attention_vit_tpu/experiments/sppp_mhla_pretrained.py``;
reference: experiments/sppp_mhla_pretrained.py).

The model is :class:`~..models.SPPPViTMHLA` with ``use_mhla=True`` (W = 7).
Surgery: no ``pos_embed`` (SPPP), then an identity ``latent_proj`` (MHLA).
Four LR groups: body 1x, ``latent_proj`` 5x, the SPPP components 2x (they
have no parameters, here as in JAX and the reference, so the group is
empty) and the head (reference: :348-362). Complexity ratio
``token_ratio * window_ratio`` (reference: :281-306). CSV:
``exp5_pretrained_sppp_mhla.csv`` (reference: :525-562).

After pooling the MHLA layer sees R + 1 = 17 tokens: the plain dense band
by default; ``FAVIT_MHLA_IMPL=shiftband FAVIT_USE_PALLAS_MHLA=1`` takes the
tile band (K6/K7) on the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from focused_attention_vit_tpu_torch.convert.checkpoints import (
    vit_state_to_mhla,
    vit_state_to_sppp,
)
from focused_attention_vit_tpu_torch.experiments.pretrained_common import (
    PretrainedMixin,
)
from focused_attention_vit_tpu_torch.experiments.sppp import (
    SPPPExperiment,
    token_reduction,
)
from focused_attention_vit_tpu_torch.models import SPPPViTMHLA


@dataclass
class PretrainedSPPPMHLAExperiment(PretrainedMixin, SPPPExperiment):
    window_size: int = 7
    model_display_name: str = "Pretrained ViT + SPPP + MHLA"
    csv_filename: str = "exp5_pretrained_sppp_mhla.csv"
    auto_microbatch: Optional[int] = None

    def build_model(self):
        return SPPPViTMHLA(
            img_size=self.img_size,
            patch_size=self.patch_size,
            in_channels=self.in_channels,
            num_classes=self.num_classes,
            embed_dim=self.embed_dim,
            depth=self.depth,
            num_heads=self.num_heads,
            mlp_ratio=self.mlp_ratio,
            dropout=self.dropout,
            attn_dropout=self.attn_dropout,
            embed_dropout=self.embed_dropout,
            num_superpixels=self.num_superpixels,
            compactness=self.compactness,
            pooling_type=self.pooling_type,
            slic_connectivity=self._slic_connectivity(),
            slic_iters=self.slic_iters,
            window_size=self.window_size,
            use_mhla=True,
            device=self.torch_device,
            generator=torch.Generator().manual_seed(self.seed),
        )

    def surgery(self, vit_state):
        return vit_state_to_mhla(vit_state_to_sppp(vit_state), self.depth,
                                 self.embed_dim // self.num_heads,
                                 keep_pos_embed=False)

    def label_fn(self, path: str) -> str:
        if path.startswith("head"):
            return "head"
        if "latent_proj" in path:
            return "latent"
        if any(x in path for x in ("segmentation", "patch_mapper",
                                   "pooling")):
            return "sppp"  # no parameter has such a name: an empty group
        return "frozen" if self._is_frozen_path(path, True) else "body"

    def group_lrs(self) -> Dict[str, float]:
        return {
            "body": self.learning_rate,
            "latent": self.learning_rate * 5,
            "sppp": self.learning_rate * 2,  # reference: :356-358
            "head": self.head_learning_rate,
        }

    def theoretical_metrics(self) -> Dict[str, Any]:
        traditional, token_ratio, (slic, pooling) = token_reduction(self)
        window_ratio = self.window_size / (self.num_superpixels + 1)
        combined = token_ratio * window_ratio  # reference: :294
        self.metrics["complexity_reduction"] = {
            "token_ratio": token_ratio,
            "window_ratio": window_ratio,
            "combined_ratio": combined,
        }
        space = traditional["space_complexity_bytes"] * token_ratio
        return {
            "parameters": traditional["parameters"]
            + self.depth * self.embed_dim,
            "flops": traditional["flops"] * combined + slic + pooling,
            "time_complexity": traditional["time_complexity"] * combined
            + slic + pooling,
            "space_complexity_bytes": space,
            "space_complexity_mb": space / (1024 * 1024),
        }

    def results_row(self) -> Dict[str, Any]:
        row = super().results_row()  # E2's row with the token columns
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
            if k == "num_superpixels":
                out["window_size"] = self.window_size
            if k == "token_reduction_factor":
                out["complexity_reduction_ratio"] = self.metrics[
                    "complexity_reduction"]["combined_ratio"]
                out["total_parameters"] = self.param_counts["total_params"]
                out["trainable_parameters"] = self.param_counts[
                    "trainable_params"]
                out["frozen_parameters"] = self.param_counts["frozen_params"]
        return out
