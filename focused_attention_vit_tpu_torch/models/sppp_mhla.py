"""SPPP with switchable MHLA / dense blocks (port of
``focused_attention_vit_tpu/models/sppp_mhla.py``; reference
models/sppp_mhla.py:113-334)."""

from __future__ import annotations

import torch

from focused_attention_vit_tpu_torch.models.layers import (
    SwitchableTransformerBlock,
)
from focused_attention_vit_tpu_torch.models.sppp_common import SPPPBase


class SPPPViTMHLA(SPPPBase):
    """The SPPP token pipeline around ``depth`` switchable blocks
    (``use_flash=False``, as in JAX): windowed latent attention over the
    R + 1 tokens with ``use_mhla=True`` (the dense band at the default
    R = 16 and W = 7; the tile band, K6/K7 on the card, under
    ``FAVIT_MHLA_IMPL=shiftband FAVIT_USE_PALLAS_MHLA=1``), dense attention
    under the reference's ``in_proj``/``out_proj`` names otherwise. The
    arguments mirror the reference constructor but for JAX's ``use_flash``
    field, which JAX does not pass to the blocks either."""

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
        window_size: int = 7,
        use_mhla: bool = False,
        slic_iters: int = 10,
        slic_connectivity: "bool | str" = "auto",
        *,
        device=None,
        generator: torch.Generator | None = None,
    ):
        super().__init__(
            lambda: SwitchableTransformerBlock(
                embed_dim, num_heads, window_size, mlp_ratio, use_mhla,
                dropout, attn_dropout, use_flash=False, device=device),
            img_size=img_size, patch_size=patch_size,
            in_channels=in_channels, num_classes=num_classes,
            embed_dim=embed_dim, depth=depth, num_heads=num_heads,
            embed_dropout=embed_dropout, num_superpixels=num_superpixels,
            compactness=compactness, pooling_type=pooling_type,
            slic_iters=slic_iters, slic_connectivity=slic_connectivity,
            device=device, generator=generator,
        )
        self.window_size = window_size
        self.use_mhla = use_mhla
