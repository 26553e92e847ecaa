"""MHLA windowed local attention (port of
``focused_attention_vit_tpu/ops/window.py``).

Each query attends to a fixed window of W keys centred on it, after a shared
latent projection of K and V. The edge rule is the reference's
(``window_index_table``): a left-edge window is padded with key S-1, a
right-edge window with key 0, and a duplicated key enters the softmax once
per slot it fills. Even W is defined as the asymmetric window
``[i - W//2, i + W//2 - 1]`` with the same padding.

The formulations, chosen as in the JAX package by sequence length and by
``FAVIT_MHLA_IMPL`` and ``FAVIT_USE_PALLAS_MHLA`` (read at each call):

* S <= 2W: the gather form, which materialises the ``[B, h, S, W, d]``
  window tensor (only tiny sequences reach it);
* the dense band, S x S attention with a static log-multiplicity bias that
  encodes the window rule exactly: ``densefull`` at any S, ``auto`` (the
  default) at S <= ``DENSE_BAND_MAX_SEQ``;
* ``roll``: the band op of :mod:`.mhla_band_roll` on S-minor ``[B, h, d, S]``
  tensors, which launches the CUDA kernels on a CUDA tensor and runs the
  halo-padded shift band below on a CPU tensor;
* any other value, with ``FAVIT_USE_PALLAS_MHLA=1`` on a CUDA tensor: the
  clamped tile band of :mod:`.mhla_kernel_v4` (the CUDA kernels K6/K7), its
  2*(W//2) edge rows overwritten with the reference's windows;
* otherwise the token-major shift band :func:`_shift_banded_attention`.

The gather form, the dense band and both shift bands take an optional
``weights_transform``, applied to their f32 softmax weights before the
product with V: the train-mode attention-weight dropout hook of the MHLA
layer (JAX ``ops/window.py``). Attention masks are not ported.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def window_index_table(seq_len: int, window_size: int) -> np.ndarray:
    """Closed-form ``[S, W]`` int32 window-index table (the reference edge
    rule, extended to even W as the module docstring says)."""
    s, w = seq_len, window_size
    hw = w // 2
    up = hw if w % 2 else hw - 1  # window is [i - hw, i + up]
    i = np.arange(s, dtype=np.int64)[:, None]
    j = np.arange(w, dtype=np.int64)[None, :]

    interior = i - hw + j
    # Left edge: [0 .. min(i + up, S - 1)] first, then S-1 to fill the slots.
    left = np.where(j <= np.minimum(i + up, s - 1), j, s - 1)
    # Right edge: p = i + up + 1 - S copies of key 0 first, then [i-hw .. S-1].
    p = i + up + 1 - s
    right = np.where(j >= p, i - hw + j - p, 0)
    # The left rule wins when both apply (S < W), as in the reference.
    table = np.where(i <= hw, left, np.where(i + up >= s, right, interior))
    return np.asarray(np.clip(table, 0, s - 1), dtype=np.int32)


def _gather_windowed_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window_size: int,
    weights_transform=None,
) -> torch.Tensor:
    """Table-gather form on ``[B, h, S, d]``: logits and softmax in f32,
    ``weights_transform`` on the ``[B, h, S, W]`` weights, weights cast to
    V's dtype for the weighted sum."""
    d = q.shape[-1]
    table = torch.as_tensor(
        window_index_table(q.shape[2], window_size), device=q.device
    ).long()
    k_win = k[:, :, table]  # [B, h, S, W, d]
    v_win = v[:, :, table]
    logits = torch.einsum(
        "bhsd,bhswd->bhsw", q.float(), k_win.float()
    ) * (d ** -0.5)
    weights = torch.softmax(logits, dim=-1)
    if weights_transform is not None:
        weights = weights_transform(weights)
    return torch.einsum("bhsw,bhswd->bhsd", weights.to(v.dtype), v_win)


@functools.lru_cache(maxsize=32)
def _band_log_multiplicity(seq_len: int, window_size: int) -> np.ndarray:
    """Static ``[S, S]`` additive logit bias: ``log(m_ij)`` where key j fills
    ``m_ij`` slots of query i's window, ``-inf`` outside the window. A dense
    softmax with this bias equals the softmax over the W slots."""
    table = window_index_table(seq_len, window_size)
    counts = np.zeros((seq_len, seq_len), np.float32)
    rows = np.repeat(np.arange(seq_len), window_size)
    np.add.at(counts, (rows, table.reshape(-1)), 1.0)
    with np.errstate(divide="ignore"):
        bias = np.log(counts, where=counts > 0)
    bias[counts == 0] = -np.inf
    return bias.astype(np.float32)


# Above this length the band op replaces the dense band (as in the JAX
# package, where S x S logits stop paying for themselves). Which S the dense
# band should keep on the card is not measured yet.
DENSE_BAND_MAX_SEQ = 512


def _dense_band_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window_size: int,
    weights_transform=None,
) -> torch.Tensor:
    """Windowed attention as dense biased attention on ``[B, h, S, d]``:
    f32 logits plus the log-multiplicity bias, f32 softmax,
    ``weights_transform`` on the ``[B, h, S, S]`` weights (train-mode
    dropout then draws one Bernoulli per merged duplicated edge key, as in
    JAX), weights cast to V's dtype for the product with V. Unlike JAX,
    autograd keeps the ``[B, h, S, S]`` weights for the backward instead of
    recomputing them; only S <= ``DENSE_BAND_MAX_SEQ`` comes here."""
    s, d = q.shape[2], q.shape[3]
    bias = torch.as_tensor(_band_log_multiplicity(s, window_size),
                           device=q.device)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (
        d ** -0.5
    ) + bias
    weights = torch.softmax(logits, dim=-1)
    if weights_transform is not None:
        weights = weights_transform(weights)
    return torch.matmul(weights.to(v.dtype), v)


def _halo_pad(x: torch.Tensor, window_size: int, dim: int) -> torch.Tensor:
    """Pad ``dim`` with ``W//2`` copies of row S-1 on the left and
    ``W-1-W//2`` copies of row 0 on the right, so that padded row ``i + o``
    is the key the reference window puts in slot o of query i."""
    w = window_size
    hw = w // 2
    s = x.shape[dim]
    last = x.narrow(dim, s - 1, 1)
    first = x.narrow(dim, 0, 1)
    parts = [last] * hw + [x] + [first] * (w - 1 - hw)
    return torch.cat(parts, dim) if len(parts) > 1 else x


def _shift_band_weights_ds(
    q: torch.Tensor, k: torch.Tensor, window_size: int
) -> torch.Tensor:
    """f32 ``[B, h, W, S]`` softmax weights of the shift band on S-minor
    ``[B, h, d, S]`` q and k: W shifted multiply-reduces over the
    halo-padded K, scaled by ``d**-0.5``, softmax over W."""
    d, s = q.shape[2], q.shape[3]
    kp = _halo_pad(k, window_size, dim=3)
    qf = q.float()
    logits = torch.stack(
        [(qf * kp[..., o:o + s].float()).sum(dim=2)
         for o in range(window_size)],
        dim=2,
    ) * (d ** -0.5)
    return torch.softmax(logits, dim=2)


def _shift_band_apply_ds(weights: torch.Tensor, v: torch.Tensor
                         ) -> torch.Tensor:
    """``sum_o weights[:, :, o] * v`` shifted to slot o, in f32 over the
    halo-padded V; ``[B, h, d, S]`` f32."""
    w, s = weights.shape[2], v.shape[3]
    vp = _halo_pad(v, w, dim=3)
    return sum(
        weights[:, :, o:o + 1] * vp[..., o:o + s].float() for o in range(w)
    )


def _shift_banded_attention_ds(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window_size: int,
    weights_transform=None,
) -> torch.Tensor:
    """Shift band on S-minor ``[B, h, d, S]`` tensors: W shifted multiply-
    reduces over the halo-padded K for the ``[B, h, W, S]`` logits, an f32
    softmax over W, ``weights_transform`` on those weights, and W shifted
    multiply-adds of V in f32; the result is rounded once to the input
    dtype. Exact edge rule, no gather. This is the plain version the band
    kernel is held against."""
    weights = _shift_band_weights_ds(q, k, window_size)
    if weights_transform is not None:
        weights = weights_transform(weights)
    return _shift_band_apply_ds(weights, v).to(q.dtype)


def _shift_banded_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window_size: int,
    weights_transform=None,
) -> torch.Tensor:
    """The shift band on token-major ``[B, h, S, d]`` tensors: the S-minor
    shift band on transposed views, so the same ``[B, h, W, S]`` weights
    (one Bernoulli per window slot under a dropout ``weights_transform``)
    and the same exact edge rule."""
    out = _shift_banded_attention_ds(
        q.transpose(2, 3), k.transpose(2, 3), v.transpose(2, 3), window_size,
        weights_transform)
    return out.transpose(2, 3)


def windowed_latent_attention_ds(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window_size: int,
    dropout=(0.0, None),
) -> torch.Tensor:
    """Window-local attention on S-minor ``[B, h, d, S]`` tensors; K and V
    already carry the latent projection. S <= 2W takes the gather form,
    longer sequences the band op (the CUDA kernels on a CUDA tensor), which
    applies ``dropout=(rate, seed)`` per window slot."""
    s = q.shape[3]
    if s <= 2 * window_size:
        if dropout[1] is not None and dropout[0] > 0.0:
            raise ValueError(
                f"band dropout requires S > 2*W (got S={s}, W={window_size})"
            )
        out = _gather_windowed_attention(
            q.transpose(2, 3), k.transpose(2, 3), v.transpose(2, 3),
            window_size,
        )
        return out.transpose(2, 3)
    from focused_attention_vit_tpu_torch.ops.mhla_band_roll import (
        roll_banded_attention,
    )

    return roll_banded_attention(q, k, v, window_size, dropout)


@functools.lru_cache(maxsize=64)
def _edge_slab_index(seq_len: int, window_size: int, device: torch.device):
    """Indices of the exact edge rows, on ``device``: ``q_rows`` the first
    and last W//2 queries; ``k_rows`` the slab of 2W + 2 keys their
    reference windows read (keys 0..W-1 and S-1 for the left edge, key 0
    and keys S-W..S-1 for the right); ``slots`` ``[2*(W//2), W]``, each
    window as positions in that slab. Cached, so that a call copies nothing
    from the host, and made outside inference mode, so that a later
    autograd pass may save them."""
    s, w = seq_len, window_size
    hw = w // 2
    table = window_index_table(s, w)
    left = np.where(table[:hw] < w, table[:hw], w)
    rtab = table[s - hw:]
    right = np.where(rtab == 0, w + 1, rtab - (s - w) + w + 2)
    q_rows = np.r_[0:hw, s - hw:s]
    k_rows = np.r_[0:w, s - 1, 0, s - w:s]
    with torch.inference_mode(False):
        return tuple(torch.as_tensor(x, dtype=torch.long, device=device)
                     for x in (q_rows, k_rows, np.concatenate([left, right])))


def _tile_band_on_card(x: torch.Tensor) -> bool:
    """Whether the opt-in tile band may run: on a CUDA tensor, where JAX
    asks ``jax.default_backend() == "tpu"``. One predicate, so that a CPU
    test can monkeypatch it as the JAX tests patch the backend."""
    return x.is_cuda


def windowed_latent_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window_size: int
) -> torch.Tensor:
    """Window-local attention on per-head ``[B, h, S, d]`` tensors; K and V
    already carry the latent projection. Returns ``[B, h, S, d]``. The
    formulation follows ``FAVIT_MHLA_IMPL`` and ``FAVIT_USE_PALLAS_MHLA``,
    read at each call, as the module docstring lists."""
    s, d = q.shape[2], q.shape[3]
    w = window_size
    hw = w // 2
    if s <= 2 * w:
        return _gather_windowed_attention(q, k, v, w)
    impl = os.environ.get("FAVIT_MHLA_IMPL", "auto")
    if impl == "densefull" or (impl == "auto" and s <= DENSE_BAND_MAX_SEQ):
        return _dense_band_attention(q, k, v, w)
    if impl == "roll":
        out = windowed_latent_attention_ds(
            q.transpose(2, 3).contiguous(), k.transpose(2, 3).contiguous(),
            v.transpose(2, 3).contiguous(), w,
        )
        return out.transpose(2, 3)
    if not (os.environ.get("FAVIT_USE_PALLAS_MHLA", "0") == "1"
            and _tile_band_on_card(q)):
        return _shift_banded_attention(q, k, v, w)

    from focused_attention_vit_tpu_torch.ops.mhla_kernel_v4 import (
        banded_attention_v4,
    )

    out = banded_attention_v4(q, k, v, w)
    if hw == 0:
        return out
    # The tile band clamps at the edges; the reference pads a left-edge
    # window with key S-1 and a right-edge window with key 0. The first and
    # last hw rows are recomputed from a slab of the 2W + 2 keys their
    # windows read (so the backward scatters into no full K/V beyond one
    # index_add) and joined to the band's rows by concatenation, which
    # autograd carries.
    q_rows, k_rows, slots = _edge_slab_index(s, w, q.device)
    q_e = q.index_select(2, q_rows)  # [B, h, 2*hw, d]
    k_e = k.index_select(2, k_rows)[:, :, slots]  # [B, h, 2*hw, W, d]
    v_e = v.index_select(2, k_rows)[:, :, slots]
    logits = torch.einsum("bhed,bhewd->bhew", q_e.float(),
                          k_e.float()) * (d ** -0.5)
    weights = torch.softmax(logits, dim=-1)
    edges = torch.einsum("bhew,bhewd->bhed", weights,
                         v_e.float()).to(out.dtype)
    return torch.cat([edges[:, :, :hw], out[:, :, hw:s - hw],
                      edges[:, :, hw:]], dim=2)
