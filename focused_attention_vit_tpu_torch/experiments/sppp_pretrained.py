"""E4: pretrained ViT -> SPPP fine-tune (port of
``focused_attention_vit_tpu/experiments/sppp_pretrained.py``; reference:
experiments/sppp_pretrained.py).

Surgery: the converted ViT weights without the learned ``pos_embed`` (the
SPPP model adds the centroid encoding instead; reference :177-232); the
head is kept only when its class count matches, by the shape-checked
merge. CSV: ``exp3_pretrained_sppp.csv`` (reference: :487-521).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

from focused_attention_vit_tpu_torch.convert.checkpoints import (
    vit_state_to_sppp,
)
from focused_attention_vit_tpu_torch.experiments.pretrained_common import (
    PretrainedMixin,
)
from focused_attention_vit_tpu_torch.experiments.sppp import SPPPExperiment


@dataclass
class PretrainedSPPPExperiment(PretrainedMixin, SPPPExperiment):
    model_display_name: str = "Pretrained SPPP ViT"
    csv_filename: str = "exp3_pretrained_sppp.csv"
    auto_microbatch: Optional[int] = None

    def surgery(self, vit_state):
        return vit_state_to_sppp(vit_state)

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
            if k == "token_reduction_factor":
                out["total_parameters"] = self.param_counts["total_params"]
                out["trainable_parameters"] = self.param_counts[
                    "trainable_params"]
                out["frozen_parameters"] = self.param_counts["frozen_params"]
        return out


# The reference's spelling, kept importable (main.py:43 imports this name).
SPPPPretrainedViTExperiment = PretrainedSPPPExperiment
