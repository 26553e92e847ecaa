"""Building blocks of the dense, the MHLA and the cross-attention ViTs (port of
``focused_attention_vit_tpu/models/layers.py``).

Module and parameter names follow the reference torch layout, so that
``state_dict()`` keys are the ones ``convert/torch_to_jax.py`` reads:
``patch_embed.projection.1``, ``attn.qkv`` (fused ``[q | k | v]`` rows with
contiguous heads), ``attn.latent_proj``, ``attn.proj``, ``norm1``/``norm2``
and ``mlp.fc1``/``mlp.fc2``; the dense attention of a switchable block
carries ``attn.in_proj_weight``, ``attn.in_proj_bias`` and
``attn.out_proj`` instead, and the MLP of :class:`MHLATransformerBlock`
and :class:`CrossAttentionTransformerBlock` ``mlp.0``/``mlp.3``; the
cross-attention blocks carry ``norm1_query``, ``norm1_kv`` and
``attn.{q,k,v,out}_proj``.

Numerics follow the JAX package: LayerNorm eps 1e-5, exact (erf) GELU, and
the attention dispatch of ``MultiHeadAttention`` and
``MultiHeadLatentAttention`` by sequence length.
``nn.Module.training`` plays the role of JAX's ``deterministic=False``:
in training mode dropout draws from the :class:`DropoutRNG` a forward is
given. The cross-attention layers take an attention mask; the MHLA
layer does not yet (ROADMAP §A 7).
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F
from torch import nn

from focused_attention_vit_tpu_torch import NotPortedError
from focused_attention_vit_tpu_torch.ops import attention as attn_ops
from focused_attention_vit_tpu_torch.ops import window as window_ops
from focused_attention_vit_tpu_torch.ops.flash_attention import (
    dropout_attention_q_chunked,
)
from focused_attention_vit_tpu_torch.ops.mha_kernel import (
    fused_mha_supported,
    fused_multi_head_attention,
)
from focused_attention_vit_tpu_torch.ops.patch_embed import extract_patches


class DropoutRNG:
    """The random streams of one train-mode forward, as JAX's ``dropout``
    rng: ``device`` (a ``torch.Generator`` on the activations' device)
    draws the dropout masks, ``host`` (a CPU generator) draws the band's
    per-call dropout seeds, which go to the kernel as an int without a
    device sync. Both are seeded from ``seed``; with no seed, both are
    torch's default generators (a train-mode forward given no rng)."""

    def __init__(self, seed: int | None = None, device=None):
        self.device = self.host = None
        if seed is not None:
            self.device = torch.Generator(device=device).manual_seed(seed)
            self.host = torch.Generator().manual_seed(seed)

    def band_seed(self) -> int:
        """A seed for an op's in-kernel dropout (the band's, the fused
        attention's), in [0, 2**31 - 1) as the JAX layers draw it."""
        return int(torch.randint(0, 2**31 - 1, (), generator=self.host))


def inverted_dropout(x: torch.Tensor, rate: float,
                     rng: DropoutRNG | None) -> torch.Tensor:
    """Inverted dropout as Flax's ``nn.Dropout``: keep with probability
    ``1 - rate`` and scale the kept values by ``1 / (1 - rate)``. The mask
    comes from ``rng.device`` (the default generator when ``rng`` is
    None); autograd keeps only the bool mask."""
    if rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    rng = rng or DropoutRNG()
    keep = torch.empty(x.shape, dtype=torch.bool, device=x.device).bernoulli_(
        1.0 - rate, generator=rng.device)
    return torch.where(keep, x / (1.0 - rate), 0.0)


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """The reference init: Linear weights (and a dense attention's
    ``in_proj_weight``) N(0, 0.02) with zero bias, LayerNorm ones and
    zeros. Values are drawn on the CPU from ``generator`` in module order,
    so a seed gives the same weights on any device."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Linear):
                m.weight.copy_(
                    torch.empty(m.weight.shape).normal_(
                        0.0, 0.02, generator=generator
                    )
                )
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, MultiHeadAttention) and m.in_proj_names:
                m.in_proj_weight.copy_(
                    torch.empty(m.in_proj_weight.shape).normal_(
                        0.0, 0.02, generator=generator
                    )
                )
                m.in_proj_bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()


class ExtractPatches(nn.Module):
    """Parameter-free first stage of the patch projection (the reference's
    ``Rearrange``)."""

    def __init__(self, patch_size: int):
        super().__init__()
        self.patch_size = patch_size

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return extract_patches(images, self.patch_size)


class PatchEmbedding(nn.Module):
    """NHWC images -> ``[B, N, D]`` patch embeddings."""

    def __init__(self, patch_size: int, embed_dim: int, in_channels: int = 3,
                 device=None):
        super().__init__()
        self.projection = nn.Sequential(
            ExtractPatches(patch_size),
            nn.Linear(patch_size * patch_size * in_channels, embed_dim,
                      device=device),
        )

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.projection(images)


class MLP(nn.Module):
    """fc1 -> exact GELU -> dropout -> fc2 -> dropout."""

    def __init__(self, embed_dim: int, hidden_dim: int, dropout: float = 0.0,
                 device=None):
        super().__init__()
        self.dropout = dropout
        self.fc1 = nn.Linear(embed_dim, hidden_dim, device=device)
        self.fc2 = nn.Linear(hidden_dim, embed_dim, device=device)

    def forward(self, x: torch.Tensor, rng: DropoutRNG | None = None
                ) -> torch.Tensor:
        rate = self.dropout if self.training else 0.0
        x = inverted_dropout(F.gelu(self.fc1(x)), rate, rng)
        return inverted_dropout(self.fc2(x), rate, rng)


class MultiHeadAttention(nn.Module):
    """Dense multi-head self-attention: a fused qkv projection, attention
    on ``[B, h, S, d]`` and the output projection.

    In eval mode, or with ``dropout == 0``, the core is
    :func:`~..ops.attention.multi_head_attention`: the flash op from
    ``FLASH_MIN_SEQ_LEN`` tokens on (the CUDA kernels on a CUDA tensor),
    the materialised softmax below it; ``use_flash`` True or False forces
    either. In training mode with ``dropout > 0`` (the model's
    ``attn_dropout``) the attention weights are dropped as in JAX
    (``models/layers.py`` :133-173): from ``FLASH_MIN_SEQ_LEN`` tokens on
    in query chunks that never hold ``[B, h, S, S]``, with the chunks'
    seeds drawn from ``rng.host``; below it on the materialised f32
    weights. The output is dropped at the same rate.

    With ``FAVIT_FUSED_MHA=1`` in the environment (read at each call, off
    by default, as in JAX), ``use_flash`` None and a shape that
    :func:`~..ops.mha_kernel.fused_mha_supported` takes, the core is the
    fused short-S op instead, with and without dropout: the CUDA kernels on
    a CUDA tensor, their plain versions on a CPU tensor. Its dropout seed
    is drawn once per call from ``rng.host``.

    ``in_proj_names=True`` registers the same parameters under the names a
    reference switchable block with ``use_mhla=False`` saves them by:
    ``in_proj_weight`` ``[3D, D]``, ``in_proj_bias`` and ``out_proj``,
    with the same ``[q | k | v]`` row order. The arithmetic is this
    module's either way.
    """

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 use_flash: bool | None = None, in_proj_names: bool = False,
                 device=None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(
                f"embed_dim {embed_dim} is not divisible by num_heads "
                f"{num_heads}"
            )
        self.num_heads = num_heads
        self.dropout = dropout
        self.use_flash = use_flash
        self.in_proj_names = in_proj_names
        if in_proj_names:
            self.in_proj_weight = nn.Parameter(
                torch.empty(3 * embed_dim, embed_dim, device=device))
            self.in_proj_bias = nn.Parameter(
                torch.empty(3 * embed_dim, device=device))
            self.out_proj = nn.Linear(embed_dim, embed_dim, device=device)
        else:
            self.qkv = nn.Linear(embed_dim, 3 * embed_dim, device=device)
            self.proj = nn.Linear(embed_dim, embed_dim, device=device)

    def forward(self, x: torch.Tensor, rng: DropoutRNG | None = None
                ) -> torch.Tensor:
        if self.in_proj_names:
            qkv = F.linear(x, self.in_proj_weight, self.in_proj_bias)
        else:
            qkv = self.qkv(x)
        q, k, v = attn_ops.qkv_split(qkv, self.num_heads)
        rate = self.dropout if self.training else 0.0
        use_fused = (
            os.environ.get("FAVIT_FUSED_MHA", "0") == "1"
            and self.use_flash is None  # explicit True/False: caller's choice
            and fused_mha_supported(q.shape[2], q.shape[3])
        )
        if use_fused:
            seed = (rng or DropoutRNG()).band_seed() if rate > 0.0 else None
            out = fused_multi_head_attention(
                q.contiguous(), k.contiguous(), v.contiguous(),
                dropout_rate=rate, dropout_seed=seed)
        elif rate == 0.0:
            out = attn_ops.multi_head_attention(q, k, v,
                                                use_flash=self.use_flash)
        elif q.shape[2] >= attn_ops.FLASH_MIN_SEQ_LEN:
            out = dropout_attention_q_chunked(
                q, k, v, rate, (rng or DropoutRNG()).host)
        else:
            logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (
                q.shape[-1] ** -0.5)
            weights = inverted_dropout(torch.softmax(logits, dim=-1), rate,
                                       rng)
            out = torch.matmul(weights.to(v.dtype), v)
        out = attn_ops.merge_heads(out)
        out = self.out_proj(out) if self.in_proj_names else self.proj(out)
        return inverted_dropout(out, rate, rng)


class MultiHeadLatentAttention(nn.Module):
    """Windowed latent attention: a fused qkv projection, one latent
    ``Linear(d, d)`` shared by all heads and applied to K and V, window-local
    attention with the reference edge rule, and the output projection.

    Dispatch as in the JAX package (``models/layers.py`` :361-592), by
    sequence length S and ``FAVIT_MHLA_IMPL`` (read at each call). At
    S > ``DENSE_BAND_MAX_SEQ`` with ``auto`` (the default) or ``roll`` the
    band op gets its S-minor ``[B, h, d, S]`` layout
    (:meth:`_forward_sminor`) and launches the CUDA kernels K1/K2 on a CUDA
    tensor; JAX's ``auto`` takes that branch on the TPU only, and on the
    CPU the two branches compute the same shift band. Otherwise the layer
    keeps token-major ``[B, h, S, d]`` and calls
    :func:`~..ops.window.windowed_latent_attention`, whose dispatch picks the
    gather form, the dense band, the shift band or, with
    ``FAVIT_USE_PALLAS_MHLA=1`` on a CUDA tensor, the tile band (K6/K7).

    In training mode with ``dropout > 0`` (the model's ``attn_dropout``)
    the window weights are dropped as in JAX (``models/layers.py``
    :408-424, :513-574): per window slot inside the band op on the S-minor
    branch, with a seed drawn once per call from ``rng.host``; per slot on
    the token-major shift band's ``[B, h, W, S]`` weights at long S
    otherwise (no kernel); per merged key on the dense band's
    ``[B, h, S, S]`` weights; per slot on the gather form's ``[B, h, S, W]``
    weights. The output is dropped at the same rate.
    """

    def __init__(self, embed_dim: int, num_heads: int, window_size: int = 7,
                 dropout: float = 0.0, device=None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(
                f"embed_dim {embed_dim} is not divisible by num_heads "
                f"{num_heads}"
            )
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.window_size = window_size
        self.dropout = dropout
        self.qkv = nn.Linear(embed_dim, 3 * embed_dim, device=device)
        self.latent_proj = nn.Linear(self.head_dim, self.head_dim,
                                     device=device)
        self.proj = nn.Linear(embed_dim, embed_dim, device=device)

    def forward(self, x: torch.Tensor, rng: DropoutRNG | None = None
                ) -> torch.Tensor:
        b, s, dim = x.shape
        h, d = self.num_heads, self.head_dim
        w = self.window_size
        rate = self.dropout if self.training else 0.0
        long_s = s > window_ops.DENSE_BAND_MAX_SEQ
        if long_s and os.environ.get("FAVIT_MHLA_IMPL", "auto") in ("auto",
                                                                    "roll"):
            return inverted_dropout(self._forward_sminor(x, rate, rng), rate,
                                    rng)
        q, k, v = self.qkv(x).view(b, s, 3, h, d).permute(2, 0, 3, 1, 4)
        k = self.latent_proj(k)
        v = self.latent_proj(v)
        if rate > 0.0:
            def drop(wts):
                return inverted_dropout(wts, rate, rng)

            if long_s:
                out = window_ops._shift_banded_attention(q, k, v, w, drop)
            elif s > 2 * w:
                out = window_ops._dense_band_attention(q, k, v, w, drop)
            else:
                out = window_ops._gather_windowed_attention(q, k, v, w, drop)
        else:
            out = window_ops.windowed_latent_attention(q, k, v, w)
        out = self.proj(out.transpose(1, 2).reshape(b, s, dim))
        return inverted_dropout(out, rate, rng)

    def _forward_sminor(self, x: torch.Tensor, rate: float,
                        rng: DropoutRNG | None) -> torch.Tensor:
        """Long-S sublayer with the band in the S-minor layout (the JAX
        package's ``HeadQKVProjDS`` / ``LatentProjDS`` /
        ``HeadMergeProjDS``, which XLA fused into its matmuls).

        The fused qkv ``Linear`` runs token-major (one GEMM, bias in its
        epilogue) and one copy turns it into contiguous ``[3, B, h, d, S]``;
        the shared latent ``Linear`` is a ``bmm`` over the ``B*h`` rows; the
        output comes back token-major by one copy before ``proj``. Measured
        on the card this beats writing S-minor straight from ``bmm`` over
        stride-0 weights, for which cuBLAS picks slow kernels (PERF.md)."""
        b, s, dim = x.shape
        h, d = self.num_heads, self.head_dim
        q, k, v = (
            self.qkv(x).view(b, s, 3, h, d).permute(2, 0, 3, 4, 1).contiguous()
        )
        w_lat = self.latent_proj.weight.expand(b * h, d, d)
        b_lat = self.latent_proj.bias.view(d, 1)
        k, v = (
            torch.bmm(w_lat, t.view(b * h, d, s)).add_(b_lat).view(b, h, d, s)
            for t in (k, v)
        )
        seed = None
        if rate > 0.0:
            seed = (rng or DropoutRNG()).band_seed()
        out = window_ops.windowed_latent_attention_ds(
            q, k, v, self.window_size, (rate, seed)
        )
        return self.proj(out.view(b, dim, s).transpose(1, 2).contiguous())


class SequentialMLP(nn.Sequential):
    """:class:`MLP` under the reference MHLA block's anonymous
    ``nn.Sequential`` names (reference models/mhla.py:197-203): Linear
    ``0``, GELU ``1``, dropout ``2``, Linear ``3``, dropout ``4``. The
    dropout slots hold no parameters; the masks come from the
    :class:`DropoutRNG` as in :class:`MLP`."""

    def __init__(self, embed_dim: int, hidden_dim: int, dropout: float = 0.0,
                 device=None):
        super().__init__(
            nn.Linear(embed_dim, hidden_dim, device=device), nn.GELU(),
            nn.Identity(), nn.Linear(hidden_dim, embed_dim, device=device),
            nn.Identity())
        self.dropout = dropout

    def forward(self, x: torch.Tensor, rng: DropoutRNG | None = None
                ) -> torch.Tensor:
        rate = self.dropout if self.training else 0.0
        x = inverted_dropout(F.gelu(self[0](x)), rate, rng)
        return inverted_dropout(self[3](x), rate, rng)


class _PreLNBlock(nn.Module):
    """Pre-LN block: ``x += attn(LN(x)); x += mlp(LN(x))``, with
    ``attn_dropout`` in the attention and ``dropout`` in the MLP
    (``mlp_cls``: :class:`MLP` or :class:`SequentialMLP`)."""

    def __init__(self, attn: nn.Module, embed_dim: int, mlp_ratio: float,
                 dropout: float, device=None, mlp_cls=MLP):
        super().__init__()
        self.norm1 = nn.LayerNorm(embed_dim, eps=1e-5, device=device)
        self.attn = attn
        self.norm2 = nn.LayerNorm(embed_dim, eps=1e-5, device=device)
        self.mlp = mlp_cls(embed_dim, int(embed_dim * mlp_ratio), dropout,
                           device=device)

    def forward(self, x: torch.Tensor, rng: DropoutRNG | None = None
                ) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), rng)
        return x + self.mlp(self.norm2(x), rng)


class TransformerBlock(_PreLNBlock):
    """The dense ViT's block: :class:`MultiHeadAttention` with ``attn.qkv``
    and ``attn.proj``."""

    def __init__(self, embed_dim: int, num_heads: int,
                 mlp_ratio: float = 4.0, dropout: float = 0.0,
                 attn_dropout: float = 0.0, use_flash: bool | None = None,
                 device=None):
        attn = MultiHeadAttention(embed_dim, num_heads, attn_dropout,
                                  use_flash, device=device)
        super().__init__(attn, embed_dim, mlp_ratio, dropout, device=device)


class SwitchableTransformerBlock(_PreLNBlock):
    """The MHLA ViT's block: :class:`MultiHeadLatentAttention` with
    ``use_mhla=True``, else dense :class:`MultiHeadAttention` under the
    reference's ``in_proj``/``out_proj`` parameter names."""

    def __init__(self, embed_dim: int, num_heads: int, window_size: int = 7,
                 mlp_ratio: float = 4.0, use_mhla: bool = True,
                 dropout: float = 0.0, attn_dropout: float = 0.0,
                 use_flash: bool | None = None, device=None):
        if use_mhla:
            attn = MultiHeadLatentAttention(
                embed_dim, num_heads, window_size, attn_dropout,
                device=device)
        else:
            attn = MultiHeadAttention(embed_dim, num_heads, attn_dropout,
                                      use_flash, in_proj_names=True,
                                      device=device)
        super().__init__(attn, embed_dim, mlp_ratio, dropout, device=device)


class MHLATransformerBlock(_PreLNBlock):
    """The pre-LN MHLA block of ``PretrainedViTWithMHLA`` (JAX
    ``models/layers.py`` :629-670; reference models/mhla.py:164-222):
    :class:`MultiHeadLatentAttention` as ``attn.qkv``, ``attn.latent_proj``
    and ``attn.proj``, and the MLP as ``mlp.0`` and ``mlp.3``, the keys
    JAX's ``reference_mhla_vit_to_flax`` reads. Attention masks are not
    ported yet: a mask raises (ROADMAP §A 7)."""

    def __init__(self, embed_dim: int, num_heads: int, window_size: int = 7,
                 mlp_ratio: float = 4.0, dropout: float = 0.0,
                 attn_dropout: float = 0.0, device=None):
        attn = MultiHeadLatentAttention(embed_dim, num_heads, window_size,
                                        attn_dropout, device=device)
        super().__init__(attn, embed_dim, mlp_ratio, dropout, device=device,
                         mlp_cls=SequentialMLP)

    def forward(self, x: torch.Tensor,
                attention_mask: torch.Tensor | None = None,
                rng: DropoutRNG | None = None) -> torch.Tensor:
        if attention_mask is not None:
            raise NotPortedError(
                "MHLATransformerBlock: attention masks are not ported yet "
                "(ROADMAP §A 7)")
        return super().forward(x, rng)


def _cross_attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float, mask: torch.Tensor | None,
                          rate: float, rng: DropoutRNG | None
                          ) -> torch.Tensor:
    """Attention over ``[..., S, d]`` q and ``[..., T, d]`` k, v as JAX's
    cross layers compute it: logits and softmax in f32 with autocast off
    (JAX asks for ``preferred_element_type=float32``), masked logits set to
    the most negative finite f32 (a fully masked row gives uniform weights,
    not NaN), the weights dropped at ``rate``, then cast to v's dtype for
    the product with V."""
    with torch.autocast(q.device.type, enabled=False):
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
        if mask is not None:
            logits = torch.where(mask == 0, torch.finfo(torch.float32).min,
                                 logits)
        weights = torch.softmax(logits, dim=-1)
    weights = inverted_dropout(weights, rate, rng)
    return torch.matmul(weights.to(v.dtype), v)


class CrossAttention(nn.Module):
    """Single-head cross-attention (JAX ``models/layers.py`` :726-767):
    separate ``q_proj``, ``k_proj`` and ``v_proj``, the logits scaled by
    ``embed_dim**-0.5`` (the full width, not a head's: the reference's
    quirk, kept), and ``out_proj``. ``attention_mask`` broadcasts to
    ``[B, S, T]``; zero entries are masked. In training mode the weights
    are dropped at ``dropout`` after the softmax; the output is not."""

    def __init__(self, embed_dim: int, dropout: float = 0.0, device=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.dropout = dropout
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self, name, nn.Linear(embed_dim, embed_dim,
                                          device=device))

    def forward(self, query: torch.Tensor, key_value: torch.Tensor,
                attention_mask: torch.Tensor | None = None,
                rng: DropoutRNG | None = None) -> torch.Tensor:
        out = _cross_attention_core(
            self.q_proj(query), self.k_proj(key_value),
            self.v_proj(key_value), self.embed_dim ** -0.5, attention_mask,
            self.dropout if self.training else 0.0, rng)
        return self.out_proj(out)


class MultiHeadCrossAttention(CrossAttention):
    """Multi-head cross-attention (JAX ``models/layers.py`` :770-808): the
    same projections, split into ``num_heads`` heads scaled by
    ``head_dim**-0.5``; ``attention_mask`` ``[B, S, T]`` applies to every
    head."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 device=None):
        if embed_dim % num_heads:
            raise ValueError(
                f"embed_dim {embed_dim} is not divisible by num_heads "
                f"{num_heads}"
            )
        super().__init__(embed_dim, dropout, device=device)
        self.num_heads = num_heads

    def forward(self, query: torch.Tensor, key_value: torch.Tensor,
                attention_mask: torch.Tensor | None = None,
                rng: DropoutRNG | None = None) -> torch.Tensor:
        h = self.num_heads
        q = attn_ops.split_heads(self.q_proj(query), h)
        k = attn_ops.split_heads(self.k_proj(key_value), h)
        v = attn_ops.split_heads(self.v_proj(key_value), h)
        mask = attention_mask[:, None] if attention_mask is not None else None
        out = _cross_attention_core(
            q, k, v, q.shape[-1] ** -0.5, mask,
            self.dropout if self.training else 0.0, rng)
        return self.out_proj(attn_ops.merge_heads(out))


class CrossAttentionTransformerBlock(nn.Module):
    """Pre-LN cross-attention block (JAX ``models/layers.py`` :811-855):
    ``query += attn(norm1_query(query), norm1_kv(key_value)); query +=
    mlp(norm2(query))``, with :class:`MultiHeadCrossAttention` when
    ``use_multi_head`` else :class:`CrossAttention`, and the MLP under the
    reference block's ``mlp.0``/``mlp.3``. ``key_value=None`` attends to
    the query tokens themselves, as the cross-attention ViTs call it."""

    def __init__(self, embed_dim: int, num_heads: int,
                 mlp_ratio: float = 4.0, dropout: float = 0.0,
                 attn_dropout: float = 0.0, use_multi_head: bool = False,
                 device=None):
        super().__init__()
        self.norm1_query = nn.LayerNorm(embed_dim, eps=1e-5, device=device)
        self.norm1_kv = nn.LayerNorm(embed_dim, eps=1e-5, device=device)
        if use_multi_head:
            self.attn = MultiHeadCrossAttention(embed_dim, num_heads,
                                                attn_dropout, device=device)
        else:
            self.attn = CrossAttention(embed_dim, attn_dropout, device=device)
        self.norm2 = nn.LayerNorm(embed_dim, eps=1e-5, device=device)
        self.mlp = SequentialMLP(embed_dim, int(embed_dim * mlp_ratio),
                                 dropout, device=device)

    def forward(self, query: torch.Tensor,
                key_value: torch.Tensor | None = None,
                attention_mask: torch.Tensor | None = None,
                rng: DropoutRNG | None = None) -> torch.Tensor:
        key_value = query if key_value is None else key_value
        query = query + self.attn(self.norm1_query(query),
                                  self.norm1_kv(key_value), attention_mask,
                                  rng)
        return query + self.mlp(self.norm2(query), rng)
