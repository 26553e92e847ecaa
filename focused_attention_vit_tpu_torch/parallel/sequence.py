"""Sequence parallelism (SP) for windowed latent attention (port of
``focused_attention_vit_tpu/parallel/sequence.py``).

Windowed MHLA attends each query to W neighbours, so the token axis shards
over a ``seq`` group with O(W) traffic: each rank holds L = ceil(S/n) rows
(the last rank's tail padded), takes a W//2-row halo from each neighbour,
and every query's window is then local. As in JAX:

* the reference's circular edge rule (left-edge windows padded with key
  S-1, right-edge windows with key 0, a duplicated key weighted once per
  slot) needs global rows 0 and S-1 of K and V on the edge ranks: one
  stacked ``[B, h, 4, d]`` sum over the group brings them to every rank;
* pad rows (global index >= S) become copies of row 0, which is what the
  single-device halo puts right of row S-1;
* the left halo is the previous rank's last W//2 rows (rank 0: copies of
  row S-1), the right halo the next rank's first W-1-W//2 rows (the last
  rank: copies of row 0);
* the band itself is the single-device shift band on the
  ``[L + W - 1]`` strip (``ops/window.py`` ``_strip_logits_ds`` and
  ``_strip_apply_ds``): f32 logits over the W offsets, softmax over W,
  an optional ``weights_transform`` (train-mode dropout), f32 sums.

The exchange is split from the compute: :func:`sp_band_local` is a plain
function of ``(q_l, k_l, v_l, left, right)``, and the exchange runs through
a transport: :class:`_Ranks` over a process group (the differentiable
collectives of :mod:`.collectives`, whose backward sends a halo's gradient
back to the rank it came from and sums the edge rows' gradients again), or
:class:`_Virtual`, n shards stacked in one process, which
:func:`virtual_sp_windowed_attention` stitches back together (a test holds
it to the single-device band without any process group).

JAX's SP band is plain XLA and skips the roll kernel; so is this one, on
the card too: the band kernels K1/K2 keep the whole sequence's circular
edge rule inside the kernel and cannot take a shard's strip as they are.

The models (:meth:`~..models.vit.ViTBase.enable_sequence_parallel`) keep a
rank's token rows after the position embedding (:func:`local_rows`); the
other attention cores under SP gather the sequence (:func:`gather_rows`),
and the cls row reaches every rank by a differentiable broadcast from rank
0 of the group.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from focused_attention_vit_tpu_torch.ops import window as window_ops
from focused_attention_vit_tpu_torch.parallel import collectives
from focused_attention_vit_tpu_torch.parallel.collectives import Axis


@dataclass(frozen=True)
class SeqShards:
    """A sequence of ``seq_len`` rows split over ``axis``: ``rows`` =
    ceil(seq_len / n) a rank, ``pad`` rows at the end of the last."""

    axis: Axis
    seq_len: int

    @classmethod
    def of(cls, mesh, dim: str, seq_len: int) -> "SeqShards":
        return cls(Axis.of(mesh, dim), seq_len)

    @property
    def rows(self) -> int:
        return -(-self.seq_len // self.axis.n)

    @property
    def pad(self) -> int:
        return self.rows * self.axis.n - self.seq_len


def check_shards(seq_len: int, n: int, window_size: int) -> tuple:
    """``(L, pad)`` of ``seq_len`` rows over ``n`` shards; raises JAX's
    ``ValueError`` when a shard cannot hold a window or the pad spans more
    than the last shard."""
    s = seq_len
    L = -(-s // n)
    pad = L * n - s
    if L < window_size:
        raise ValueError(
            f"sequence shards too small for SP: ceil({s}/{n})={L} < "
            f"window_size={window_size}"
        )
    if pad >= L:
        raise ValueError(
            f"padding {pad} spans more than the last shard (L={L}); "
            f"use fewer sequence shards for S={s}"
        )
    return L, pad


def sp_band_local(q_l: torch.Tensor, k_l: torch.Tensor, v_l: torch.Tensor,
                  left: torch.Tensor, right: torch.Tensor, window_size: int,
                  weights_transform: Optional[Callable] = None
                  ) -> torch.Tensor:
    """One shard's band on token-major ``[..., h, L, d]`` rows: ``left``
    ``[2, ..., h, W//2, d]`` and ``right`` ``[2, ..., h, W-1-W//2, d]``
    hold the K (index 0) and V (index 1) halo rows around the shard, so
    the ``[L + W - 1]`` strip is the globally halo-padded sequence's rows
    around it. ``weights_transform`` acts on the f32 ``[..., h, W, L]``
    weights. Returns ``[..., h, L, d]`` in q's dtype."""
    kp = torch.cat([left[0], k_l, right[0]], dim=-2)
    vp = torch.cat([left[1], v_l, right[1]], dim=-2)
    weights = torch.softmax(window_ops._strip_logits_ds(
        q_l.transpose(-1, -2), kp.transpose(-1, -2), window_size), dim=-2)
    if weights_transform is not None:
        weights = weights_transform(weights)
    out = window_ops._strip_apply_ds(weights, vp.transpose(-1, -2))
    return out.to(q_l.dtype).transpose(-1, -2)


class _Ranks:
    """One shard a rank, the exchange over a process group: tensors carry
    a leading shard dimension of 1."""

    def __init__(self, axis: Axis):
        self.n, self.indices = axis.n, [axis.index]
        self.axis = axis

    def sum(self, x):
        return collectives.all_sum(x, self.axis)

    def from_prev(self, x):
        return collectives.shift(x, self.axis, 1)

    def from_next(self, x):
        return collectives.shift(x, self.axis, -1)


class _Virtual:
    """``n`` shards stacked on a leading dimension in one process."""

    def __init__(self, n: int):
        self.n, self.indices = n, list(range(n))

    def sum(self, x):
        return x.sum(0, keepdim=True).expand_as(x)

    def from_prev(self, x):
        return torch.cat([torch.zeros_like(x[:1]), x[:-1]])

    def from_next(self, x):
        return torch.cat([x[1:], torch.zeros_like(x[:1])])


def _sp_shards(q, k, v, window_size: int, seq_len: int, comm,
               weights_transform=None):
    """The band of the shards ``comm`` holds, ``[m, B, h, L, d]`` each."""
    m, b, h, L, d = q.shape
    w = window_size
    hw, rc = w // 2, w - 1 - w // 2
    first = torch.as_tensor(comm.indices, device=q.device)
    gidx = first[:, None] * L + torch.arange(L, device=q.device)  # [m, L]

    def row(x, own):
        return (x * own[:, None, None, :, None].to(x.dtype)).sum(
            3, keepdim=True)

    # Global rows 0 and S-1 of K and V on every shard: one stacked sum.
    own0, own_last = gidx == 0, gidx == seq_len - 1
    edges = comm.sum(torch.cat([row(k, own0), row(v, own0),
                                row(k, own_last), row(v, own_last)], dim=3))
    k0, v0, k_last, v_last = edges.split(1, dim=3)
    # Pad rows act as copies of row 0.
    padm = (gidx >= seq_len)[:, None, None, :, None]
    k = torch.where(padm, k0, k)
    v = torch.where(padm, v0, v)
    kv = torch.stack([k, v], dim=1)  # [m, 2, B, h, L, d]
    shard = first[:, None, None, None, None, None]
    if hw:
        tail = kv[..., L - hw:, :]
        edge = torch.stack([k_last, v_last], 1).expand_as(tail)
        left = torch.where(shard == 0, edge, comm.from_prev(tail))
    else:
        left = kv[..., :0, :]
    if rc:
        head = kv[..., :rc, :]
        edge = torch.stack([k0, v0], 1).expand_as(head)
        right = torch.where(shard == comm.n - 1, edge, comm.from_next(head))
    else:
        right = kv[..., :0, :]
    out = sp_band_local(
        q.reshape(m * b, h, L, d), k.reshape(m * b, h, L, d),
        v.reshape(m * b, h, L, d),
        left.transpose(0, 1).reshape(2, m * b, h, hw, d),
        right.transpose(0, 1).reshape(2, m * b, h, rc, d),
        w, weights_transform)
    return out.reshape(m, b, h, L, d)


def sp_windowed_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          window_size: int, shards: SeqShards,
                          weights_transform: Optional[Callable] = None
                          ) -> torch.Tensor:
    """Sequence-parallel windowed latent attention on this rank's rows
    ``[B, h, L, d]`` of a ``[B, h, S, d]`` sequence split over
    ``shards.axis`` (S = ``shards.seq_len``, L = ceil(S/n), the last rank's
    tail padded); K and V already carry the latent projection. Equals the
    single-device band's rows, the edge rule included. Every rank of the
    group calls it; the backward runs the exchange's transposes.
    ``weights_transform`` (train-mode dropout, from a stream with the
    ``seq`` rank folded in) acts on the ``[B, h, W, L]`` weights."""
    L, _ = check_shards(shards.seq_len, shards.axis.n, window_size)
    if q.shape[2] != L:
        raise ValueError(f"a rank holds {L} rows of S={shards.seq_len} over "
                         f"{shards.axis.n} shards, got {q.shape[2]}")
    out = _sp_shards(q[None], k[None], v[None], window_size, shards.seq_len,
                     _Ranks(shards.axis), weights_transform)
    return out[0]


def virtual_sp_windowed_attention(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, window_size: int, n: int,
                                  weights_transform: Optional[Callable] = None
                                  ) -> torch.Tensor:
    """The band of ``n`` sequence shards run in one process on full
    ``[B, h, S, d]`` tensors: split into L-row shards (the tail padded),
    exchanged by stacking, stitched and trimmed back to S rows."""
    b, h, s, d = q.shape
    L, pad = check_shards(s, n, window_size)

    def split(x):
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        return x.reshape(b, h, n, L, d).permute(2, 0, 1, 3, 4)

    out = _sp_shards(split(q), split(k), split(v), window_size, s,
                     _Virtual(n), weights_transform)
    return out.permute(1, 2, 0, 3, 4).reshape(b, h, n * L, d)[:, :, :s]


def local_rows(x: torch.Tensor, shards: SeqShards, dim: int
               ) -> torch.Tensor:
    """This rank's ``L`` rows of the full sequence ``x`` along ``dim`` (the
    pad rows zeros)."""
    L, pad = shards.rows, shards.pad
    if pad:
        shape = list(x.shape)
        shape[dim] = pad
        x = torch.cat([x, x.new_zeros(shape)], dim)
    return x.narrow(dim, shards.axis.index * L, L)


def gather_rows(x: torch.Tensor, shards: SeqShards, dim: int
                ) -> torch.Tensor:
    """The full sequence along ``dim`` from every rank's rows (pad rows
    dropped); the backward gives each rank its rows' summed gradient."""
    full = collectives.all_gather(x, shards.axis, dim)
    return full.narrow(dim, 0, shards.seq_len)


def from_first_rank(x: torch.Tensor, shards: SeqShards) -> torch.Tensor:
    """Rank 0's ``x`` (the cls row's values) on every rank of the group,
    differentiably."""
    return collectives.broadcast(x, shards.axis, 0)
