"""Dense Vision Transformer (port of
``focused_attention_vit_tpu/models/vit.py``), and the stem and head that
:class:`~.vit_mhla.VisionTransformerMHLA` shares with it: a plain loop over
the blocks, each optionally rematerialised (``remat``), or, under pipeline
parallelism (``pp_mesh``), the GPipe schedule of
:mod:`..parallel.pipeline` over the same blocks. ``scan_layers`` is
accepted and does nothing: JAX rolls the blocks into one ``lax.scan`` to
shrink its XLA program and to feed its pipeline, and an eager loop has
neither need; ``pp_mesh`` still asks for it, as JAX's does, so that the
flags mean what they mean there."""

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

PP_NEEDS_SCAN = ("pp_mesh (pipeline parallelism) requires scan_layers=True "
                 "(the pipeline consumes the stacked block params)")

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

    Under sequence parallelism (:meth:`enable_sequence_parallel`) each rank
    of the ``seq`` group keeps its L token rows after the position
    embedding and its dropout, the attention layers exchange halos or
    gather the sequence, and the cls row's features reach every rank by a
    differentiable broadcast from rank 0. Under pipeline parallelism
    (:meth:`enable_pipeline_parallel`) the blocks run as the GPipe schedule
    over the ``stage`` group, each block under the remat policy as above.
    """

    sp = None  # SeqShards (parallel.sequence) under sequence parallelism
    pp = None  # the stage Axis (parallel.collectives) under PP
    pp_microbatches = None

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

    def enable_sequence_parallel(self, mesh, axis: str = "seq") -> None:
        """Split the token rows over the ``axis`` dimension of ``mesh``
        (JAX's ``sp_mesh``/``sp_axis``); every attention layer learns the
        split."""
        from focused_attention_vit_tpu_torch.models.layers import (
            MultiHeadAttention,
            MultiHeadLatentAttention,
        )
        from focused_attention_vit_tpu_torch.parallel.sequence import (
            SeqShards,
        )

        self.sp = SeqShards.of(mesh, axis, self.num_patches + 1)
        for m in self.modules():
            if isinstance(m, (MultiHeadAttention, MultiHeadLatentAttention)):
                m.sp = self.sp

    def enable_pipeline_parallel(self, mesh, axis: str = "stage",
                                 microbatches: int | None = None) -> None:
        """Run the blocks as a pipeline over the ``axis`` dimension of
        ``mesh`` in ``microbatches`` microbatches (default: the stage
        count), JAX's ``pp_mesh``/``pp_axis``/``pp_microbatches``.
        ``parallel.shard_params`` then drops the other stages' blocks."""
        from focused_attention_vit_tpu_torch.parallel.collectives import Axis
        from focused_attention_vit_tpu_torch.parallel.pipeline import (
            stage_blocks,
        )

        self.pp = Axis.of(mesh, axis)
        stage_blocks(self.depth, self.pp)
        self.pp_microbatches = microbatches

    def forward_features(self, images: torch.Tensor,
                         rng: DropoutRNG | None = None) -> torch.Tensor:
        """``[B, H, W, C]`` images to ``[B, D]`` cls-token features."""
        x = self.patch_embed(images)
        cls = self.cls_token.expand(x.shape[0], -1, -1).to(x.dtype)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(x.dtype)
        x = inverted_dropout(
            x, self.embed_dropout if self.training else 0.0, rng)
        if self.sp is not None:
            from focused_attention_vit_tpu_torch.parallel import sequence

            x = sequence.local_rows(x, self.sp, dim=1)
        remat = self._remat and self.training and torch.is_grad_enabled()

        def apply_block(block, x, rng):
            if remat:
                return checkpoint_block(block, x, rng, self._remat_context)
            return block(x, rng=rng)

        if self.pp is not None:
            from focused_attention_vit_tpu_torch.parallel.pipeline import (
                spmd_pipeline,
            )

            x = spmd_pipeline(apply_block, self.blocks, x, self.pp,
                              microbatches=self.pp_microbatches, rng=rng)
        else:
            for block in self.blocks:
                x = apply_block(block, x, rng)
        x = self.norm(x)[:, 0]
        if self.sp is not None:
            x = sequence.from_first_rank(x, self.sp)
        return x

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
    no-op (module docstring). ``pp_mesh`` runs the blocks as a pipeline
    over its ``pp_axis`` dimension in ``pp_microbatches`` microbatches and
    needs ``scan_layers``, as in JAX."""

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
        pp_mesh=None,
        pp_axis: str = "stage",
        pp_microbatches: int | None = None,
        *,
        device=None,
        generator: torch.Generator | None = None,
    ):
        if pp_mesh is not None and not scan_layers:
            raise ValueError(PP_NEEDS_SCAN)
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
        self.pp_mesh = pp_mesh
        if pp_mesh is not None:
            self.enable_pipeline_parallel(pp_mesh, pp_axis, pp_microbatches)
