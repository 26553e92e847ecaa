"""E1: scratch ViT on CIFAR-10 (port of
``focused_attention_vit_tpu/experiments/traditional.py``).

CSV: ``exp1_traditional.csv`` with the reference schema.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from focused_attention_vit_tpu_torch.experiments.base import ExperimentBase
from focused_attention_vit_tpu_torch.models import VisionTransformer


@dataclass
class TraditionalViTExperiment(ExperimentBase):
    model_display_name: str = "Traditional ViT"
    csv_filename: str = "exp1_traditional.csv"

    def build_model(self):
        return VisionTransformer(
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
            device=self.torch_device,
            generator=torch.Generator().manual_seed(self.seed),
        )


def main(argv=None):
    """Standalone entry (the reference gives each experiment its own
    ``main()``); ``--device cpu`` runs on the CPU."""
    import argparse

    p = argparse.ArgumentParser(description="Traditional ViT Experiment")
    p.add_argument("--img_size", type=int, default=224)
    p.add_argument("--patch_size", type=int, default=16)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--subset_size", type=int, default=None)
    p.add_argument("--data_dir", type=str, default="./data")
    p.add_argument("--results_dir", type=str, default="./results")
    p.add_argument("--device", type=str, default=None)
    args = p.parse_args(argv)

    TraditionalViTExperiment(
        img_size=args.img_size,
        patch_size=args.patch_size,
        batch_size=args.batch_size,
        epochs=args.epochs,
        subset_size=args.subset_size,
        data_dir=args.data_dir,
        results_dir=args.results_dir,
        device=args.device,
    ).run()


if __name__ == "__main__":
    main()
