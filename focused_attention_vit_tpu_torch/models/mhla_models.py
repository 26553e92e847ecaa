"""Pretrained-surgery MHLA models (port of
``focused_attention_vit_tpu/models/mhla_models.py``):
``PretrainedViTWithMHLA``, the ViT skeleton hard-wired to MHLA blocks, and
its SPPP sibling ``PretrainedSPPPViTWithMHLA``."""

from __future__ import annotations

import torch

from focused_attention_vit_tpu_torch.models.layers import MHLATransformerBlock
from focused_attention_vit_tpu_torch.models.sppp_common import SPPPBase
from focused_attention_vit_tpu_torch.models.vit import ViTBase


class PretrainedViTWithMHLA(ViTBase):
    """The stem and head of :class:`~.vit.ViTBase` around ``depth``
    :class:`~.layers.MHLATransformerBlock` s (reference
    models/mhla_models.py:22-175). The defaults are the reference's: patch
    4 (S = 3137 at 224 pixels, so the layer takes the S-minor band, K1/K2 on
    the card), window 4, 1000 classes, no dropout. Its blocks' keys are the
    reference MHLA block's (``attn.qkv``, ``attn.latent_proj``,
    ``attn.proj``, ``mlp.0``, ``mlp.3``).

    At an even window the tile-band opt-in (``FAVIT_MHLA_IMPL=shiftband
    FAVIT_USE_PALLAS_MHLA=1``) computes another function than the default
    path: its interior rows read W + 1 keys, as in JAX (ROADMAP §C 1).
    ``sp_mesh`` splits the token rows over its ``sp_axis`` dimension
    (:meth:`~.vit.ViTBase.enable_sequence_parallel`); the model has no
    pipeline parallelism, as in JAX."""

    def __init__(
        self,
        img_size: int = 224,
        patch_size: int = 4,
        in_channels: int = 3,
        num_classes: int = 1000,
        embed_dim: int = 768,
        depth: int = 12,
        num_heads: int = 12,
        window_size: int = 4,
        mlp_ratio: float = 4.0,
        dropout: float = 0.0,
        attn_dropout: float = 0.0,
        embed_dropout: float = 0.0,
        sp_mesh=None,
        sp_axis: str = "seq",
        *,
        device=None,
        generator: torch.Generator | None = None,
    ):
        super().__init__(
            lambda: MHLATransformerBlock(
                embed_dim, num_heads, window_size, mlp_ratio, dropout,
                attn_dropout, device=device),
            img_size=img_size, patch_size=patch_size,
            in_channels=in_channels, num_classes=num_classes,
            embed_dim=embed_dim, depth=depth, num_heads=num_heads,
            embed_dropout=embed_dropout, device=device, generator=generator,
        )
        self.window_size = window_size
        self.sp_mesh = sp_mesh
        if sp_mesh is not None:
            self.enable_sequence_parallel(sp_mesh, sp_axis)


class PretrainedSPPPViTWithMHLA(SPPPBase):
    """The SPPP token pipeline around ``depth``
    :class:`~.layers.MHLATransformerBlock` s (JAX
    ``models/mhla_models.py`` :116-191; reference models/mhla_models.py:
    178-396), with the reference's defaults: patch 4, W = 4, 1000 classes,
    no dropout. After pooling the layer sees R + 1 = 17 tokens: the dense
    band by default, the tile band (K6/K7) under ``FAVIT_MHLA_IMPL=shiftband
    FAVIT_USE_PALLAS_MHLA=1`` and the S-minor band (K1/K2) under
    ``FAVIT_MHLA_IMPL=roll``, since 17 > 2W."""

    def __init__(
        self,
        img_size: int = 224,
        patch_size: int = 4,
        in_channels: int = 3,
        num_classes: int = 1000,
        embed_dim: int = 768,
        depth: int = 12,
        num_heads: int = 12,
        window_size: int = 4,
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
            lambda: MHLATransformerBlock(
                embed_dim, num_heads, window_size, mlp_ratio, dropout,
                attn_dropout, device=device),
            img_size=img_size, patch_size=patch_size,
            in_channels=in_channels, num_classes=num_classes,
            embed_dim=embed_dim, depth=depth, num_heads=num_heads,
            embed_dropout=embed_dropout, num_superpixels=num_superpixels,
            compactness=compactness, pooling_type=pooling_type,
            slic_iters=slic_iters, slic_connectivity=slic_connectivity,
            device=device, generator=generator,
        )
        self.window_size = window_size
