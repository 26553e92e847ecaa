"""ViT with switchable MHLA / dense blocks (port of
``focused_attention_vit_tpu/models/vit_mhla.py``): a plain loop over the
blocks, each optionally rematerialised under a policy; ``scan_layers`` a
no-op (:mod:`.vit`); no sequence or pipeline parallelism."""

from __future__ import annotations

from typing import Optional

import torch

from focused_attention_vit_tpu_torch.models.layers import (
    SwitchableTransformerBlock,
    resolve_remat_policy,
)
from focused_attention_vit_tpu_torch.models.vit import ViTBase


class VisionTransformerMHLA(ViTBase):
    """The stem and head of :class:`~.vit.ViTBase` around ``depth``
    switchable blocks: windowed latent attention with ``use_mhla=True``,
    dense attention (under the reference's ``in_proj``/``out_proj``
    parameter names) otherwise.

    In training mode (``model.train()``) ``dropout`` applies in the MLPs,
    ``attn_dropout`` to the attention weights and the attention output, and
    ``embed_dropout`` after the position embedding, drawn from the
    :class:`~.layers.DropoutRNG` passed to :meth:`forward`.

    ``remat`` rematerialises each block in training; ``remat_policy``
    (:func:`~.layers.resolve_remat_policy`: None or ``'full'`` saves
    nothing, ``'band_weights'`` saves the band's weights) selects what the
    MHLA blocks keep; dense blocks (``use_mhla=False``) have no band and
    save nothing. ``scan_layers`` is a no-op (:mod:`.vit`).
    """

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
        window_size: int = 7,
        use_mhla: bool = True,
        dropout: float = 0.0,
        attn_dropout: float = 0.0,
        embed_dropout: float = 0.0,
        use_flash: bool | None = None,
        remat: bool = False,
        remat_policy: Optional[str] = None,
        scan_layers: bool = False,
        *,
        device=None,
        generator: torch.Generator | None = None,
    ):
        policy = resolve_remat_policy(remat_policy)
        super().__init__(
            lambda: SwitchableTransformerBlock(
                embed_dim, num_heads, window_size, mlp_ratio, use_mhla,
                dropout, attn_dropout, use_flash, device=device),
            img_size=img_size, patch_size=patch_size,
            in_channels=in_channels, num_classes=num_classes,
            embed_dim=embed_dim, depth=depth, num_heads=num_heads,
            embed_dropout=embed_dropout, device=device, generator=generator,
            remat=remat, remat_context=policy if use_mhla else None,
            scan_layers=scan_layers,
        )
        self.window_size = window_size
        self.use_mhla = use_mhla
        self.remat = remat
        self.remat_policy = remat_policy
        self.scan_layers = scan_layers
