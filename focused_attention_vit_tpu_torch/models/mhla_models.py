"""Pretrained-surgery MHLA model (port of
``focused_attention_vit_tpu/models/mhla_models.py`` :28-113):
``PretrainedViTWithMHLA``, the ViT skeleton hard-wired to MHLA blocks. Its
SPPP sibling ``PretrainedSPPPViTWithMHLA`` comes with the SPPP family
(ROADMAP §A 2)."""

from __future__ import annotations

import torch

from focused_attention_vit_tpu_torch import NotPortedError
from focused_attention_vit_tpu_torch.models.layers import MHLATransformerBlock
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
    Sequence parallelism (``sp_mesh``) is not ported and raises."""

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
        *,
        device=None,
        generator: torch.Generator | None = None,
    ):
        if sp_mesh is not None:
            raise NotPortedError(
                "PretrainedViTWithMHLA: sequence parallelism (sp_mesh) is "
                "not ported yet (ROADMAP §A 6)")
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
