"""ViT with switchable MHLA / dense blocks (port of
``focused_attention_vit_tpu/models/vit_mhla.py``): a plain loop over the
blocks, each optionally rematerialised under a policy; ``scan_layers`` a
no-op (:mod:`.vit`); sequence parallelism (``sp_mesh``) and pipeline
parallelism (``pp_mesh``), alone or together."""

from __future__ import annotations

from typing import Optional

import torch

from focused_attention_vit_tpu_torch.models.layers import (
    SwitchableTransformerBlock,
    resolve_remat_policy,
)
from focused_attention_vit_tpu_torch.models.vit import PP_NEEDS_SCAN, ViTBase


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

    ``sp_mesh`` splits the token rows over its ``sp_axis`` dimension
    (:meth:`~.vit.ViTBase.enable_sequence_parallel`: the MHLA band
    exchanges halos, a dense block gathers the sequence), ``pp_mesh`` runs
    the blocks as a pipeline over ``pp_axis`` and needs ``scan_layers``,
    as in JAX. With both, each stage's blocks exchange their halos over
    ``seq`` (JAX lets GSPMD partition the plain band instead, because
    Shardy rejects a manual region nested in the pipeline's; the numbers
    are the same without dropout).
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
        sp_mesh=None,
        sp_axis: str = "seq",
        pp_mesh=None,
        pp_axis: str = "stage",
        pp_microbatches: Optional[int] = None,
        *,
        device=None,
        generator: torch.Generator | None = None,
    ):
        if pp_mesh is not None and not scan_layers:
            raise ValueError(PP_NEEDS_SCAN)
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
        self.sp_mesh, self.pp_mesh = sp_mesh, pp_mesh
        if sp_mesh is not None:
            self.enable_sequence_parallel(sp_mesh, sp_axis)
        if pp_mesh is not None:
            self.enable_pipeline_parallel(pp_mesh, pp_axis, pp_microbatches)
