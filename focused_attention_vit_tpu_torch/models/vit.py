"""Dense Vision Transformer (port of
``focused_attention_vit_tpu/models/vit.py``), and the stem and head that
:class:`~.vit_mhla.VisionTransformerMHLA` shares with it: a plain loop over
the blocks, each optionally rematerialised (``remat``); no pipeline
parallelism. ``scan_layers`` is accepted and does nothing: JAX rolls the
blocks into one ``lax.scan`` to shrink its XLA program and to feed its
pipeline, and an eager loop has neither need."""

from __future__ import annotations

import sys

import torch
from torch import nn

from focused_attention_vit_tpu_torch.models.layers import (
    DropoutRNG,
    PatchEmbedding,
    TransformerBlock,
    checkpoint_block,
    init_weights,
    inverted_dropout,
)

SCAN_LAYERS_NOTE = (
    "scan_layers: a no-op in the PyTorch port (the blocks run in an eager "
    "loop; JAX's lax.scan over depth has no counterpart here)")


class ViTBase(nn.Module):
    """Patch embedding, cls token and learned positions, ``depth`` pre-LN
    blocks built by ``make_block()``, final LayerNorm and a linear head on
    the cls token.

    Input is NHWC ``[B, H, W, C]`` float images; output ``[B, num_classes]``
    logits. Weights are drawn from ``generator`` (a CPU
    :class:`torch.Generator`; a fresh one seeded 0 when None) with the
    reference init, then live on ``device``. The model computes in the dtype
    of its parameters: ``model.to(torch.bfloat16)`` serves in bf16, and
    training runs bf16 under ``torch.autocast`` over f32 parameters.

    In training mode (``model.train()``) ``embed_dropout`` applies after
    the position embedding and the blocks apply their own rates, all drawn
    from the :class:`~.layers.DropoutRNG` passed to :meth:`forward`.

    With ``remat`` a training forward under autograd runs each block under
    :func:`~.layers.checkpoint_block` (JAX's per-block ``nn.remat``),
    saving what ``remat_context`` (a policy of
    :func:`~.layers.resolve_remat_policy`) names; ``scan_layers`` prints
    :data:`SCAN_LAYERS_NOTE` to stderr and changes nothing.
    """

    def __init__(self, make_block, *, img_size: int, patch_size: int,
                 in_channels: int, num_classes: int, embed_dim: int,
                 depth: int, num_heads: int, embed_dropout: float, device,
                 generator: torch.Generator | None, remat: bool = False,
                 remat_context=None, scan_layers: bool = False):
        super().__init__()
        # Private: only the models that take the options in JAX expose
        # ``remat`` and ``scan_layers`` (the experiments read them).
        self._remat = remat
        self._remat_context = remat_context
        if scan_layers:
            print(SCAN_LAYERS_NOTE, file=sys.stderr, flush=True)
        if img_size % patch_size:
            raise ValueError(
                f"patch_size {patch_size} must divide img_size {img_size}"
            )
        self.img_size = img_size
        self.patch_size = patch_size
        self.num_classes = num_classes
        self.embed_dim = embed_dim
        self.depth = depth
        self.num_heads = num_heads
        self.embed_dropout = embed_dropout
        self.patch_embed = PatchEmbedding(
            patch_size, embed_dim, in_channels, device=device
        )
        self.cls_token = nn.Parameter(
            torch.empty(1, 1, embed_dim, device=device)
        )
        self.pos_embed = nn.Parameter(
            torch.empty(1, self.num_patches + 1, embed_dim, device=device)
        )
        self.blocks = nn.ModuleList(make_block() for _ in range(depth))
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5, device=device)
        self.head = nn.Linear(embed_dim, num_classes, device=device)

        if generator is None:
            generator = torch.Generator().manual_seed(0)
        with torch.no_grad():
            for p in (self.cls_token, self.pos_embed):
                p.copy_(
                    torch.empty(p.shape).normal_(0.0, 0.02,
                                                 generator=generator)
                )
        init_weights(self, generator)

    @property
    def num_patches(self) -> int:
        return (self.img_size // self.patch_size) ** 2

    def forward_features(self, images: torch.Tensor,
                         rng: DropoutRNG | None = None) -> torch.Tensor:
        """``[B, H, W, C]`` images to ``[B, D]`` cls-token features."""
        x = self.patch_embed(images)
        cls = self.cls_token.expand(x.shape[0], -1, -1).to(x.dtype)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(x.dtype)
        x = inverted_dropout(
            x, self.embed_dropout if self.training else 0.0, rng)
        remat = self._remat and self.training and torch.is_grad_enabled()
        for block in self.blocks:
            if remat:
                x = checkpoint_block(block, x, rng, self._remat_context)
            else:
                x = block(x, rng=rng)
        return self.norm(x)[:, 0]

    def forward(self, images: torch.Tensor,
                rng: DropoutRNG | None = None) -> torch.Tensor:
        return self.head(self.forward_features(images, rng))


class VisionTransformer(ViTBase):
    """ViT classifier with dense attention; the arguments mirror the
    reference constructor. ``dropout`` applies in the MLPs, ``attn_dropout``
    to the attention weights and the attention output, ``embed_dropout``
    after the position embedding. ``use_flash=None`` takes the flash op
    from 512 tokens on (patch 4 on 224x224 gives S = 3137); True or False
    forces either path. ``remat`` rematerialises each block in training
    (full remat: JAX's dense ViT takes no policy); ``scan_layers`` is a
    no-op (module docstring)."""

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
        use_flash: bool | None = None,
        remat: bool = False,
        scan_layers: bool = False,
        *,
        device=None,
        generator: torch.Generator | None = None,
    ):
        super().__init__(
            lambda: TransformerBlock(
                embed_dim, num_heads, mlp_ratio, dropout, attn_dropout,
                use_flash, device=device),
            img_size=img_size, patch_size=patch_size,
            in_channels=in_channels, num_classes=num_classes,
            embed_dim=embed_dim, depth=depth, num_heads=num_heads,
            embed_dropout=embed_dropout, device=device, generator=generator,
            remat=remat, scan_layers=scan_layers,
        )
        self.remat = remat
        self.scan_layers = scan_layers
