"""SPPP Vision Transformer (port of ``focused_attention_vit_tpu/models/
sppp.py``; reference models/sppp.py:303-521)."""

from __future__ import annotations

import torch

from focused_attention_vit_tpu_torch.models.layers import TransformerBlock
from focused_attention_vit_tpu_torch.models.sppp_common import SPPPBase


class SPPPViT(SPPPBase):
    """ViT with Superpixel Patch Pooling; the arguments mirror the
    reference constructor. The blocks are the dense ViT's pre-LN
    :class:`~.layers.TransformerBlock` with ``use_flash=False``, as in JAX:
    they see R + 1 tokens, so the attention is the materialised softmax and
    the ``FAVIT_FUSED_MHA`` switch never applies. ``slic_connectivity`` is
    :func:`~..ops.slic.slic_segment`'s ``enforce_connectivity``."""

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
        num_superpixels: int = 16,
        compactness: float = 0.1,
        pooling_type: str = "mean",
        slic_iters: int = 10,
        slic_connectivity: "bool | str" = "auto",
        *,
        device=None,
        generator: torch.Generator | None = None,
    ):
        super().__init__(
            lambda: TransformerBlock(
                embed_dim, num_heads, mlp_ratio, dropout, attn_dropout,
                use_flash=False, device=device),
            img_size=img_size, patch_size=patch_size,
            in_channels=in_channels, num_classes=num_classes,
            embed_dim=embed_dim, depth=depth, num_heads=num_heads,
            embed_dropout=embed_dropout, num_superpixels=num_superpixels,
            compactness=compactness, pooling_type=pooling_type,
            slic_iters=slic_iters, slic_connectivity=slic_connectivity,
            device=device, generator=generator,
        )
