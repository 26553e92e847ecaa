"""E2: scratch SPPP ViT (port of ``focused_attention_vit_tpu/experiments/
sppp.py``; reference experiments/sppp.py).

Token-reduction accounting: FLOPs scaled by the squared token ratio plus
the reference's SLIC and pooling overhead estimates (reference:
experiments/sppp.py:150-191). CSV: ``exp2_sppp.csv`` (reference:
:365-397), the token columns after ``num_heads``. The reference's default
batch is 124 (:53).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from focused_attention_vit_tpu_torch.experiments.base import ExperimentBase
from focused_attention_vit_tpu_torch.models import SPPPViT
from focused_attention_vit_tpu_torch.utils.metrics import (
    calculate_vit_complexity,
)


def token_reduction(e) -> Dict[str, Any]:
    """The ViT-B complexity and the token counts of an SPPP experiment,
    stored in its metrics (``traditional_complexity``,
    ``token_reduction``); returns the complexity, the token ratio and the
    SLIC and the pooling overhead."""
    traditional = calculate_vit_complexity(
        img_size=e.img_size, patch_size=e.patch_size, embed_dim=e.embed_dim,
        depth=e.depth, num_heads=e.num_heads, mlp_ratio=e.mlp_ratio,
        in_channels=e.in_channels)
    num_patches = (e.img_size // e.patch_size) ** 2
    tokens_traditional = num_patches + 1
    tokens_sppp = e.num_superpixels + 1
    e.metrics["traditional_complexity"] = traditional
    e.metrics["token_reduction"] = {
        "traditional_tokens": tokens_traditional,
        "sppp_tokens": tokens_sppp,
        "reduction_factor": tokens_traditional / tokens_sppp,
    }
    # The reference's overhead estimates (experiments/sppp.py:171-174).
    return (traditional, tokens_sppp / tokens_traditional,
            (e.img_size * e.img_size * 10, num_patches * e.embed_dim))


@dataclass
class SPPPExperiment(ExperimentBase):
    num_superpixels: int = 16
    compactness: float = 0.1
    pooling_type: str = "mean"
    slic_connectivity: str = "auto"  # 'auto' | 'on' | 'off' | 'host'
    slic_iters: int = 10
    batch_size: int = 124  # reference default (experiments/sppp.py:53)
    model_display_name: str = "SPPP ViT"
    csv_filename: str = "exp2_sppp.csv"
    auto_microbatch: Optional[int] = None

    def build_model(self):
        return SPPPViT(
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
            device=self.torch_device,
            generator=torch.Generator().manual_seed(self.seed),
        )

    def theoretical_metrics(self) -> Dict[str, Any]:
        traditional, token_ratio, (slic, pooling) = token_reduction(self)
        attention_scaling = token_ratio ** 2
        space = traditional["space_complexity_bytes"] * token_ratio
        return {
            "parameters": traditional["parameters"],
            "flops": traditional["flops"] * attention_scaling + slic
            + pooling,
            "time_complexity": traditional["time_complexity"]
            * attention_scaling + slic + pooling,
            "space_complexity_bytes": space,
            "space_complexity_mb": space / (1024 * 1024),
        }

    def results_row(self) -> Dict[str, Any]:
        row = super().results_row()
        tr = self.metrics["token_reduction"]
        extra = {
            "num_superpixels": self.num_superpixels,
            "traditional_tokens": tr["traditional_tokens"],
            "sppp_tokens": tr["sppp_tokens"],
            "token_reduction_factor": tr["reduction_factor"],
        }
        out = {}
        for k, v in row.items():  # the reference's order: after num_heads
            out[k] = v
            if k == "num_heads":
                out.update(extra)
        return out


def main(argv=None):
    """Standalone entry (the reference's ``main()``); ``--device cpu`` runs
    on the CPU."""
    import argparse

    p = argparse.ArgumentParser(description="SPPP ViT Experiment")
    p.add_argument("--img_size", type=int, default=224)
    p.add_argument("--patch_size", type=int, default=4)
    p.add_argument("--num_superpixels", type=int, default=16)
    p.add_argument("--pooling_type", type=str, default="mean",
                   choices=["mean", "max", "attention"])
    p.add_argument("--batch_size", type=int, default=124)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--subset_size", type=int, default=None)
    p.add_argument("--data_dir", type=str, default="./data")
    p.add_argument("--results_dir", type=str, default="./results")
    p.add_argument("--device", type=str, default=None)
    args = p.parse_args(argv)

    SPPPExperiment(
        img_size=args.img_size,
        patch_size=args.patch_size,
        num_superpixels=args.num_superpixels,
        pooling_type=args.pooling_type,
        batch_size=args.batch_size,
        epochs=args.epochs,
        subset_size=args.subset_size,
        data_dir=args.data_dir,
        results_dir=args.results_dir,
        device=args.device,
    ).run()


if __name__ == "__main__":
    main()
