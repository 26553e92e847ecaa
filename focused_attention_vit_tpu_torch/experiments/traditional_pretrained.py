"""E3: pretrained ViT fine-tune (port of
``focused_attention_vit_tpu/experiments/traditional_pretrained.py``;
reference: experiments/traditional_pretrained.py).

Two LR groups (body vs head, reference: :196-209); ``freeze_layers`` keeps
only the head trainable. CSV: ``exp3_pretrained_traditional.csv``
(reference: :372-404).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch

from focused_attention_vit_tpu_torch.experiments.base import ExperimentBase
from focused_attention_vit_tpu_torch.experiments.pretrained_common import (
    PretrainedMixin,
)
from focused_attention_vit_tpu_torch.models import VisionTransformer


@dataclass
class PretrainedTraditionalViTExperiment(PretrainedMixin, ExperimentBase):
    model_display_name: str = "Pretrained Traditional ViT"
    csv_filename: str = "exp3_pretrained_traditional.csv"

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
                out["total_parameters"] = self.param_counts["total_params"]
                out["trainable_parameters"] = self.param_counts[
                    "trainable_params"]
                out["frozen_parameters"] = self.param_counts["frozen_params"]
        return out


# Reference spelling kept importable (main.py:41 imports this name).
TraditionalPretrainedViTExperiment = PretrainedTraditionalViTExperiment
