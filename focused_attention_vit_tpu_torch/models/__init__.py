"""Models of the port."""

from focused_attention_vit_tpu_torch.models.attention import (
    CrossAttentionSPPPViT,
    CrossAttentionViT,
)
from focused_attention_vit_tpu_torch.models.mhla_models import (
    PretrainedSPPPViTWithMHLA,
    PretrainedViTWithMHLA,
)
from focused_attention_vit_tpu_torch.models.sppp import SPPPViT
from focused_attention_vit_tpu_torch.models.sppp_mhla import SPPPViTMHLA
from focused_attention_vit_tpu_torch.models.vit import VisionTransformer
from focused_attention_vit_tpu_torch.models.vit_mhla import VisionTransformerMHLA

__all__ = ["VisionTransformer", "VisionTransformerMHLA",
           "PretrainedViTWithMHLA", "SPPPViT", "SPPPViTMHLA",
           "PretrainedSPPPViTWithMHLA", "CrossAttentionViT",
           "CrossAttentionSPPPViT"]
