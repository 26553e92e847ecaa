"""Experiment runners (the JAX package's ``experiments`` names that the port
has): E1 ``traditional``, the scratch ViT; E3 ``traditional_pretrained``
and E5 ``mhla_pretrained``, the fine-tunes from a pretrained ViT
checkpoint. The SPPP (E2, E4, E6) and cross-attention (E7, E8) experiments
are still to be ported."""

from focused_attention_vit_tpu_torch.experiments.base import ExperimentBase
from focused_attention_vit_tpu_torch.experiments.mhla_pretrained import (
    PretrainedMHLAViTExperiment,
)
from focused_attention_vit_tpu_torch.experiments.traditional import (
    TraditionalViTExperiment,
)
from focused_attention_vit_tpu_torch.experiments.traditional_pretrained import (
    PretrainedTraditionalViTExperiment,
)

__all__ = ["ExperimentBase", "TraditionalViTExperiment",
           "PretrainedTraditionalViTExperiment",
           "PretrainedMHLAViTExperiment"]
