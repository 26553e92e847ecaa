"""The kernels' forwards as ``torch.library`` operators (``favit::``).

A kernel launched through :mod:`ctypes` is opaque to ``torch.export`` and to
a selective-checkpoint policy. Each op below is an operator of its own,
defined by its schema with ``torch.library.Library`` (whose dispatch costs
the host less per call than a ``custom_op``'s wrapper, and the kernels are
called twelve times a forward), with three implementations:

- CUDA: launches the hand-written kernel (and counts the launch in its
  module's counter) or raises;
- CPU: the kernel's plain PyTorch version, what the CPU has always run;
- fake: an empty tensor of the output's shape, dtype, strides and device,
  which is what ``torch.export`` traces through.

The ops:

- ``favit::band_fwd`` — K1's eval forward, S-minor ``[B, h, d, S]``
  (:mod:`.mhla_band_roll`);
- ``favit::band_fwd_train`` — K1's training form: the output and the f32
  pre-dropout weights ``[B*h, W, S]`` that the backward reads; the op a
  ``band_weights`` remat policy saves (``models.layers``);
- ``favit::flash_fwd`` — K5's eval forward, ``[B, h, S, d]``
  (:mod:`.flash_attention`);
- ``favit::fused_mha_fwd`` — K3's eval forward, ``[B, h, S, d]``
  (:mod:`.mha_kernel`);
- ``favit::tile_band_fwd`` — K6 on ``[B*h, S, d]`` (:mod:`.mhla_kernel_v4`).

An operator's ``int`` is a signed 64-bit integer and the dropout seeds lie
in ``[0, 2**64)``, so a seed travels as its two 32-bit halves. The backward
kernels (K2, K4, K5's, K7) and K8 have no operator: they run under the
modules' ``torch.autograd.Function``\\s, which no export or remat policy
needs to see through. The wrappers check their arguments before they call
an op; the checks read shapes, dtypes, devices and contiguity, which a
fake tensor has, and the CUDA implementations check alignment.

This module is imported by ``ops/__init__.py``, so that importing any op
module registers the operators.
"""

from __future__ import annotations

import torch

from focused_attention_vit_tpu_torch.ops import flash_attention as _flash
from focused_attention_vit_tpu_torch.ops import mha_kernel as _fused
from focused_attention_vit_tpu_torch.ops import mhla_band_roll as _band
from focused_attention_vit_tpu_torch.ops import mhla_kernel_v4 as _tile

_LIB = torch.library.Library("favit", "DEF")


def _define(name: str, schema: str, cpu, cuda, fake):
    """Define ``favit::<name><schema>`` with its CPU, CUDA and fake
    implementations; returns the operator."""
    _LIB.define(name + schema)
    _LIB.impl(name, cpu, "CPU")
    _LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"favit::{name}", fake, lib=_LIB)
    return getattr(torch.ops.favit, name)


def _join_seed(lo: int, hi: int) -> int:
    return (hi << 32) | lo


_BAND = ("(Tensor q, Tensor k, Tensor v, int window_size, float rate, "
         "int seed_lo, int seed_hi)")

# K1, eval.
band_fwd = _define(
    "band_fwd", _BAND + " -> Tensor",
    lambda q, k, v, w, rate, lo, hi: _band.plain_band_forward_train(
        q, k, v, w, rate, _join_seed(lo, hi))[0],
    lambda q, k, v, w, rate, lo, hi: _band._launch_forward(
        q, k, v, w, rate, _join_seed(lo, hi), save=False)[0],
    lambda q, k, v, w, rate, lo, hi: torch.empty_like(q))

# K1, training form: the output and the f32 weights [B*h, W, S].
band_fwd_train = _define(
    "band_fwd_train", _BAND + " -> (Tensor, Tensor)",
    lambda q, k, v, w, rate, lo, hi: _band.plain_band_forward_train(
        q, k, v, w, rate, _join_seed(lo, hi)),
    lambda q, k, v, w, rate, lo, hi: _band._launch_forward(
        q, k, v, w, rate, _join_seed(lo, hi), save=True),
    lambda q, k, v, w, rate, lo, hi: (
        torch.empty_like(q),
        q.new_empty(q.shape[0] * q.shape[1], w, q.shape[3],
                    dtype=torch.float32)))

# K5, eval (``chunk`` is the plain version's key chunk).
flash_fwd = _define(
    "flash_fwd", "(Tensor q, Tensor k, Tensor v, int chunk) -> Tensor",
    lambda q, k, v, chunk: _flash.plain_flash_forward(q, k, v, chunk)[0],
    lambda q, k, v, chunk: _flash._launch_forward(q, k, v, save=False)[0],
    lambda q, k, v, chunk: torch.empty_like(q))

# K3, eval.
fused_mha_fwd = _define(
    "fused_mha_fwd",
    "(Tensor q, Tensor k, Tensor v, float rate, int seed_lo, int seed_hi)"
    " -> Tensor",
    lambda q, k, v, rate, lo, hi: _fused.plain_fused_mha_forward(
        q, k, v, rate, _join_seed(lo, hi) if rate > 0.0 else None)[0],
    lambda q, k, v, rate, lo, hi: _fused._launch_forward(
        q, k, v, rate, _join_seed(lo, hi), save=False)[0],
    lambda q, k, v, rate, lo, hi: torch.empty_like(q))

# K6 on [B*h, S, d].
tile_band_fwd = _define(
    "tile_band_fwd",
    "(Tensor q, Tensor k, Tensor v, int window_size) -> Tensor",
    lambda q, k, v, w: _tile.plain_tile_band_forward(q, k, v, w),
    lambda q, k, v, w: _tile._launch_forward(q, k, v, w),
    lambda q, k, v, w: torch.empty_like(q))

OPS = {"band_fwd": band_fwd, "band_fwd_train": band_fwd_train,
       "flash_fwd": flash_fwd, "fused_mha_fwd": fused_mha_fwd,
       "tile_band_fwd": tile_band_fwd}
