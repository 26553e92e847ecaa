"""E7/E8: the cross-attention experiments and their batch runners (port of
``focused_attention_vit_tpu/experiments/attention.py``; reference
experiments/attention.py:32-819).

One experiment over (``use_sppp`` x ``use_pretrained`` x
``use_multi_head``) with the reference's CSV names,
``exp{4,5}_{experiment_type}[_pretrained]_{model_type}.csv`` (reference
:558-562), and the two runners of sub-experiments 4A-4D and 5A-5D (scratch,
SPPP, pretrained, SPPP + pretrained; reference :628-819). The pretrained
runs split the checkpoint's fused qkv into q, k and v projections
(:func:`~..convert.checkpoints.vit_state_to_cross`).

The runners pass the CLI's flags through, ``--compute_dtype``,
``--device`` and the schedule flags included, where JAX's
``_args_to_kwargs`` drops them (its runs are always f32); the CLI refuses
``--checkpoint_dir`` for them, since four runs would share one directory.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from focused_attention_vit_tpu_torch.convert.checkpoints import (
    vit_state_to_cross,
)
from focused_attention_vit_tpu_torch.experiments.base import ExperimentBase
from focused_attention_vit_tpu_torch.experiments.pretrained_common import (
    PretrainedMixin,
)
from focused_attention_vit_tpu_torch.models import (
    CrossAttentionSPPPViT,
    CrossAttentionViT,
)
from focused_attention_vit_tpu_torch.utils.metrics import (
    calculate_vit_complexity,
)


@dataclass
class CrossAttentionExperiment(PretrainedMixin, ExperimentBase):
    use_sppp: bool = False
    num_superpixels: int = 16
    compactness: float = 0.1
    pooling_type: str = "mean"
    slic_connectivity: str = "auto"  # 'auto' | 'on' | 'off' | 'host'
    slic_iters: int = 10
    use_pretrained: bool = False
    use_multi_head: bool = False
    auto_microbatch: Optional[int] = None

    @property
    def experiment_type(self) -> str:
        return ("multihead_cross_attention" if self.use_multi_head
                else "cross_attention")

    @property
    def model_type(self) -> str:
        return "sppp" if self.use_sppp else "traditional"

    @property
    def csv_filename(self) -> str:  # type: ignore[override]
        n = 5 if self.use_multi_head else 4
        if self.use_pretrained:
            return (f"exp{n}_{self.experiment_type}_pretrained_"
                    f"{self.model_type}.csv")
        return f"exp{n}_{self.experiment_type}_{self.model_type}.csv"

    @csv_filename.setter
    def csv_filename(self, _value):  # the dataclass assigns the default
        pass

    @property
    def model_display_name(self) -> str:  # type: ignore[override]
        mh = "MultiHead " if self.use_multi_head else ""
        sp = "SPPP " if self.use_sppp else ""
        return f"{mh}CrossAttention {sp}ViT"

    @model_display_name.setter
    def model_display_name(self, _value):
        pass

    def build_model(self):
        common = dict(
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
            use_multi_head=self.use_multi_head,
            device=self.torch_device,
            generator=torch.Generator().manual_seed(self.seed),
        )
        if self.use_sppp:
            return CrossAttentionSPPPViT(
                num_superpixels=self.num_superpixels,
                compactness=self.compactness,
                pooling_type=self.pooling_type,
                slic_connectivity=self._slic_connectivity(),
                slic_iters=self.slic_iters,
                **common,
            )
        return CrossAttentionViT(**common)

    # ---- pretrained handling --------------------------------------------
    def build_params(self, model: torch.nn.Module) -> None:
        if self.use_pretrained:
            super().build_params(model)
            return
        self.pretrained_loaded = False
        self.merge_counts = {"copied": 0, "skipped": 0}
        self._record_param_counts(model)

    def surgery(self, vit_state):
        # The SPPP side drops pos_embed (JAX's vit_params_to_sppp, then
        # vit_params_to_cross with keep_pos_embed False).
        return vit_state_to_cross(vit_state, self.depth,
                                  keep_pos_embed=not self.use_sppp)

    def label_fn(self, path: str) -> str:
        if path.startswith("head"):
            return "head"
        frozen = self.use_pretrained and self._is_frozen_path(path, True)
        return "frozen" if frozen else "body"

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
        if not self.use_sppp:
            return traditional
        num_patches = (self.img_size // self.patch_size) ** 2
        tokens_traditional = num_patches + 1
        tokens_sppp = self.num_superpixels + 1
        token_ratio = tokens_sppp / tokens_traditional
        self.metrics["token_reduction"] = {
            "traditional_tokens": tokens_traditional,
            "sppp_tokens": tokens_sppp,
            "reduction_factor": tokens_traditional / tokens_sppp,
        }
        space = traditional["space_complexity_bytes"] * token_ratio
        return {
            "parameters": traditional["parameters"],
            "flops": traditional["flops"] * token_ratio ** 2,
            "time_complexity": traditional["time_complexity"]
            * token_ratio ** 2,
            "space_complexity_bytes": space,
            "space_complexity_mb": space / (1024 * 1024),
        }

    def results_row(self) -> Dict[str, Any]:
        row = super().results_row()
        row.pop("parameters", None)
        pre = self.use_pretrained
        out = {
            "model": self.model_display_name,
            "use_pretrained": pre,
            "pretrained_source": self.pretrained_source if pre else "None",
            "pretrained_model_variant": (self.pretrained_model_variant
                                         if pre else "None"),
            "freeze_layers": str(self.freeze_layers) if pre else "False",
        }
        for k, v in row.items():
            if k == "model":
                continue
            out[k] = v
            if k == "num_heads":
                out["use_multi_head"] = self.use_multi_head
                out["total_parameters"] = self.param_counts["total_params"]
                out["trainable_parameters"] = self.param_counts[
                    "trainable_params"]
                out["frozen_parameters"] = self.param_counts["frozen_params"]
        if self.use_sppp:
            tr = self.metrics["token_reduction"]
            out.update(
                num_superpixels=self.num_superpixels,
                traditional_tokens=tr["traditional_tokens"],
                sppp_tokens=tr["sppp_tokens"],
                token_reduction_factor=tr["reduction_factor"],
            )
        return out


SUITE = (
    ("A: scratch", dict(use_sppp=False, use_pretrained=False)),
    ("B: SPPP", dict(use_sppp=True, use_pretrained=False)),
    ("C: pretrained", dict(use_sppp=False, use_pretrained=True)),
    ("D: SPPP+pretrained", dict(use_sppp=True, use_pretrained=True)),
)


def _args_to_kwargs(args) -> Dict[str, Any]:
    from focused_attention_vit_tpu_torch import cli

    kw = {**cli._common_kwargs(args), **cli._sppp_kwargs(args),
          **cli._pretrained_kwargs(args)}
    for flag in ("checkpoint_dir", "sync_checkpoint"):
        kw.pop(flag)
    return kw


def _run_suite(args, use_multi_head: bool) -> None:
    """Sub-experiments A-D (reference experiments/attention.py:628-819)."""
    base = _args_to_kwargs(args)
    letter = "5" if use_multi_head else "4"
    for name, cfg in SUITE:
        print(f"=== Experiment {letter}{name} ===")
        CrossAttentionExperiment(**base, use_multi_head=use_multi_head,
                                 **cfg).run()


def run_cross_attention_experiments(args) -> None:
    """Batch runner 4A-4D (reference experiments/attention.py:628-722)."""
    _run_suite(args, use_multi_head=False)


def run_multihead_cross_attention_experiments(args) -> None:
    """Batch runner 5A-5D (reference experiments/attention.py:725-819)."""
    _run_suite(args, use_multi_head=True)
