"""Cross-attention ViT variants (port of
``focused_attention_vit_tpu/models/attention.py``; reference
models/attention.py:222-609).

Self-attention is emulated by passing the same tokens as query and
key/value (reference models/attention.py:349-350): each block of these
models is a :class:`~.layers.CrossAttentionTransformerBlock` called on one
sequence. The reference's Conv2d patch embedding is the linear
:class:`~.layers.PatchEmbedding` (a p x p, stride-p convolution is a
reshaped GEMM), as in JAX.
"""

from __future__ import annotations

import torch

from focused_attention_vit_tpu_torch.models.layers import (
    CrossAttentionTransformerBlock,
)
from focused_attention_vit_tpu_torch.models.sppp_common import SPPPBase
from focused_attention_vit_tpu_torch.models.vit import ViTBase


class CrossAttentionViT(ViTBase):
    """ViT with cross-attention blocks (reference models/attention.py:
    222-380): patch embedding, cls token, learned ``pos_embed``,
    ``embed_dropout``, ``depth`` blocks (:class:`~.layers.MultiHeadCrossAttention`
    when ``use_multi_head``, else the single-head
    :class:`~.layers.CrossAttention` with the full-width scale), final
    LayerNorm and the head on the cls token."""

    def __init__(
        self,
        img_size: int = 224,
        patch_size: int = 4,
        in_channels: int = 3,
        num_classes: int = 1000,
        embed_dim: int = 768,
        depth: int = 12,
        num_heads: int = 12,
        mlp_ratio: float = 4.0,
        dropout: float = 0.0,
        attn_dropout: float = 0.0,
        embed_dropout: float = 0.0,
        use_multi_head: bool = False,
        *,
        device=None,
        generator: torch.Generator | None = None,
    ):
        super().__init__(
            lambda: CrossAttentionTransformerBlock(
                embed_dim, num_heads, mlp_ratio, dropout, attn_dropout,
                use_multi_head, device=device),
            img_size=img_size, patch_size=patch_size,
            in_channels=in_channels, num_classes=num_classes,
            embed_dim=embed_dim, depth=depth, num_heads=num_heads,
            embed_dropout=embed_dropout, device=device, generator=generator,
        )
        self.use_multi_head = use_multi_head


class CrossAttentionSPPPViT(SPPPBase):
    """The SPPP pipeline with cross-attention blocks (reference
    models/attention.py:383-609): R + 1 superpixel tokens from
    :func:`~.sppp_common.sppp_tokens`, no ``pos_embed``. Its patch size
    defaults to 16 (reference :410), unlike 4 elsewhere.
    ``slic_connectivity`` is :func:`~..ops.slic.slic_segment`'s
    ``enforce_connectivity``."""

    def __init__(
        self,
        img_size: int = 224,
        patch_size: int = 16,
        in_channels: int = 3,
        num_classes: int = 1000,
        embed_dim: int = 768,
        depth: int = 12,
        num_heads: int = 12,
        mlp_ratio: float = 4.0,
        dropout: float = 0.0,
        attn_dropout: float = 0.0,
        embed_dropout: float = 0.0,
        num_superpixels: int = 16,
        compactness: float = 0.1,
        pooling_type: str = "mean",
        use_multi_head: bool = False,
        slic_iters: int = 10,
        slic_connectivity: "bool | str" = "auto",
        *,
        device=None,
        generator: torch.Generator | None = None,
    ):
        super().__init__(
            lambda: CrossAttentionTransformerBlock(
                embed_dim, num_heads, mlp_ratio, dropout, attn_dropout,
                use_multi_head, device=device),
            img_size=img_size, patch_size=patch_size,
            in_channels=in_channels, num_classes=num_classes,
            embed_dim=embed_dim, depth=depth, num_heads=num_heads,
            embed_dropout=embed_dropout, num_superpixels=num_superpixels,
            compactness=compactness, pooling_type=pooling_type,
            slic_iters=slic_iters, slic_connectivity=slic_connectivity,
            device=device, generator=generator,
        )
        self.use_multi_head = use_multi_head
