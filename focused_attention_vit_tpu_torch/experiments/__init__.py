"""Experiment runners (the JAX package's ``experiments`` names that the port
has): E1, the scratch ViT. The other seven are still to be ported."""

from focused_attention_vit_tpu_torch.experiments.base import ExperimentBase
from focused_attention_vit_tpu_torch.experiments.traditional import (
    TraditionalViTExperiment,
)

__all__ = ["ExperimentBase", "TraditionalViTExperiment"]
