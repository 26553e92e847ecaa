"""Models of the port."""

from focused_attention_vit_tpu_torch.models.mhla_models import (
    PretrainedViTWithMHLA,
)
from focused_attention_vit_tpu_torch.models.vit import VisionTransformer
from focused_attention_vit_tpu_torch.models.vit_mhla import VisionTransformerMHLA

__all__ = ["VisionTransformer", "VisionTransformerMHLA",
           "PretrainedViTWithMHLA"]
