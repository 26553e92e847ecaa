"""Experiment runners (the JAX package's ``experiments`` names): E1
``traditional`` and E2 ``sppp``, from scratch; E3
``traditional_pretrained``, E4 ``sppp_pretrained``, E5 ``mhla_pretrained``
and E6 ``sppp_mhla_pretrained``, the fine-tunes from a pretrained ViT
checkpoint; and the cross-attention suites E7 and E8
(:class:`CrossAttentionExperiment` and its two batch runners)."""

from focused_attention_vit_tpu_torch.experiments.attention import (
    CrossAttentionExperiment,
    run_cross_attention_experiments,
    run_multihead_cross_attention_experiments,
)
from focused_attention_vit_tpu_torch.experiments.base import ExperimentBase
from focused_attention_vit_tpu_torch.experiments.mhla_pretrained import (
    PretrainedMHLAViTExperiment,
)
from focused_attention_vit_tpu_torch.experiments.sppp import SPPPExperiment
from focused_attention_vit_tpu_torch.experiments.sppp_mhla_pretrained import (
    PretrainedSPPPMHLAExperiment,
)
from focused_attention_vit_tpu_torch.experiments.sppp_pretrained import (
    PretrainedSPPPExperiment,
    SPPPPretrainedViTExperiment,
)
from focused_attention_vit_tpu_torch.experiments.traditional import (
    TraditionalViTExperiment,
)
from focused_attention_vit_tpu_torch.experiments.traditional_pretrained import (
    PretrainedTraditionalViTExperiment,
)

__all__ = ["ExperimentBase", "TraditionalViTExperiment", "SPPPExperiment",
           "PretrainedTraditionalViTExperiment", "PretrainedSPPPExperiment",
           "SPPPPretrainedViTExperiment", "PretrainedMHLAViTExperiment",
           "PretrainedSPPPMHLAExperiment", "CrossAttentionExperiment",
           "run_cross_attention_experiments",
           "run_multihead_cross_attention_experiments"]
