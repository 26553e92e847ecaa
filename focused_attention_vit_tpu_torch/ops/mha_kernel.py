"""Fused short-sequence attention with dropout on the attention weights
(port of ``focused_attention_vit_tpu/ops/mha_kernel.py``).

At patch 16 a ViT runs S = 197 tokens. The materialised form of attention
with weight dropout writes, per block, the f32 ``[B, h, S, S]`` logits, the
softmax, the mask and the cast weights to device memory and keeps them for
the backward. :func:`fused_multi_head_attention` computes
``softmax(q k^T / sqrt(d)) -> inverted dropout -> . V`` on ``[B, h, S, d]``
without anything of size S x S leaving the chip, in either direction.

It goes through one ``torch.autograd.Function`` whenever autograd records
(grad enabled and q, k or v requiring grad); otherwise it runs the lean
forward, which writes no log-sum-exp. On a CUDA tensor each part launches a
hand-written kernel or raises; on a CPU tensor it runs the kernel's plain
version. There is no fallback from a kernel to a plain version.

- eval forward: ``csrc/fused_mha_fwd.cu``, launch count ``"fwd"``, plain
  version :func:`plain_fused_mha_forward`, through the
  ``favit::fused_mha_fwd`` operator (``ops/library.py``);
- training forward (dropout drawn in the kernel; also writes the
  log-sum-exp, f32 ``[B, h, S]``): the same source, ``"fwd_train"``, the
  same plain version;
- backward (dq, dk, dv; regenerates the mask from the seed):
  ``csrc/fused_mha_bwd.cu``, one count ``"bwd"`` a call,
  :func:`plain_fused_mha_backward`.

The plain versions are the JAX kernels' arithmetic on whole ``[S, S]``
tensors: f32 logits and softmax, the weights cast to v's dtype for the
product with V. The JAX backward keeps q, k, v and the seed and recomputes
the softmax from a full row; the CUDA backward takes the forward's ``out``
and log-sum-exp instead (it cannot hold a row's ``[S, S]`` tile on chip) and
computes the same function. The plain backward takes the row sum either
way.

The dropout mask comes from Philox keyed on (seed, b*h row, query, key)
(:mod:`.philox`): the CPU path and the card draw the same mask, the backward
regenerates the forward's, and neither depends on tiling or dtype. A weight
is kept iff its 32-bit word is at least ``rate * 2**32``, the band op's
rule; kept weights are scaled by ``1 / (1 - rate)``. The TPU kernel draws
from its core's generator, whose bits exist nowhere else: rate and
independence carry over, the stream does not.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from focused_attention_vit_tpu_torch.ops import philox
from focused_attention_vit_tpu_torch.ops.flash_attention import wide_args

FWD_KERNEL_SOURCE = "focused_attention_vit_tpu_torch/csrc/fused_mha_fwd.cu"
BWD_KERNEL_SOURCE = "focused_attention_vit_tpu_torch/csrc/fused_mha_bwd.cu"
# Largest padded S the JAX single-tile formulation accepts; kept as the
# op's range so that both packages take the fused path at the same shapes.
MAX_TILE_SEQ = 1024
# The kernels take every head dim that is a multiple of 8 (JAX's rule, which
# fused_mha_supported keeps, so the op never pads): up to 256 at the flash
# kernels' tile widths, past it through the dense kernels' wide blocks with
# the op's mask (csrc/flash_wide.cuh) at flash_attention.wide_plan's slices.

LAUNCH_KINDS = ("fwd", "fwd_train", "bwd")
_launches = dict.fromkeys(LAUNCH_KINDS, 0)
_launch_lock = threading.Lock()


def launch_count(kind: str = "fwd") -> int:
    """Kernel launches of one kind since the last
    :func:`reset_launch_count`: ``"fwd"`` the eval forward, ``"fwd_train"``
    the training forward, ``"bwd"`` the backward (one per call of its three
    kernels)."""
    return _launches[kind]


def reset_launch_count() -> None:
    with _launch_lock:
        for kind in LAUNCH_KINDS:
            _launches[kind] = 0


def _count(kind: str) -> None:
    with _launch_lock:
        _launches[kind] += 1


def _row_tile(s: int) -> int:
    return -(-s // 128) * 128


def fused_mha_supported(seq_len: int, head_dim: int) -> bool:
    """The JAX op's rule: S rounded up to 128 is at most ``MAX_TILE_SEQ``
    and the head dim is a multiple of 8 (any such head dim, on the card
    too). Off that grid the dense layer takes the non-fused path, as JAX
    does."""
    return _row_tile(seq_len) <= MAX_TILE_SEQ and head_dim % 8 == 0


_PTR, _INT, _UINT, _FLOAT = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                             ctypes.c_float)
# rows, s, d, is_bf16, scale; dropout on, seed low and high words,
# threshold, 1 - rate; device, stream; then the wide plan
# (flash_attention.wide_args: the forward's slices and tiles, the
# backward's of dkv and dq)
_TAIL = [ctypes.c_longlong, _INT, _INT, _INT, _FLOAT,
         _INT, _UINT, _UINT, _UINT, _FLOAT, _INT, _PTR]
_SIGNATURES = {
    ("fused_mha_fwd", "fused_mha_fwd"): [_PTR] * 5 + _TAIL + [_INT] * 2,
    ("fused_mha_fwd", "fused_mha_keep_bits"):
        [_PTR, ctypes.c_longlong, _INT, _UINT, _UINT, _INT, _PTR],
    ("fused_mha_bwd", "fused_mha_bwd"): [_PTR] * 10 + _TAIL + [_INT] * 4,
}


def _kernel(source: str, fn_name: str):
    from focused_attention_vit_tpu_torch.utils import kernel_build

    fn = getattr(kernel_build.load(source), fn_name)
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURES[(source, fn_name)]
        fn.restype = ctypes.c_int
    return fn


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4:
        raise ValueError(f"expected [B, h, S, d] tensors, got {tuple(q.shape)}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"q, k, v shapes differ: {tuple(q.shape)}, {tuple(k.shape)}, "
            f"{tuple(v.shape)}"
        )
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
        k.dtype == v.dtype == q.dtype
    ):
        raise TypeError(
            f"fused attention takes float32 or bfloat16 q/k/v of one dtype, "
            f"got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    if not (k.device == v.device == q.device):
        raise ValueError("q, k, v must be on one device")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused attention runs on cpu or cuda, got "
                         f"{q.device}")
    b, h, s, d = q.shape
    if s < 1 or b * h < 1:
        raise ValueError(f"fused attention needs B*h >= 1 and S >= 1, got "
                         f"{tuple(q.shape)}")
    if d < 1 or not fused_mha_supported(s, d):
        raise ValueError(
            f"fused attention supports S <= {MAX_TILE_SEQ} and head dims "
            f"that are multiples of 8, got S={s}, d={d}"
        )
    _check_layout(q=q, k=k, v=v)


def _check_layout(**tensors: torch.Tensor) -> None:
    for name, x in tensors.items():
        if not x.is_contiguous():
            raise ValueError(f"fused attention needs contiguous {name}")


def _check_aligned(**tensors: torch.Tensor) -> None:
    """The kernels' 16-byte alignment, checked where they launch: a fake
    tensor that ``torch.export`` traces has no address."""
    for name, x in tensors.items():
        if x.data_ptr() % 16:
            raise ValueError(f"fused attention needs 16-byte aligned {name}")


def _dropout_args(rate: float, seed) -> tuple[float, int]:
    """Validated ``(rate, seed)``; rate 0 needs no seed."""
    rate = float(rate)
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    if rate == 0.0:
        return 0.0, 0
    if seed is None:
        raise ValueError("dropout_rate > 0 requires a seed")
    seed = int(seed)
    if not 0 <= seed < 2**64:
        raise ValueError(f"dropout seed must be in [0, 2**64), got {seed}")
    return rate, seed


def _launch_args(q: torch.Tensor, rate: float, seed: int) -> list:
    b, h, s, d = q.shape
    device = q.get_device()
    drop = [0, 0, 0, 0, 1.0]
    if rate > 0.0:
        drop = [1, seed & 0xFFFFFFFF, seed >> 32,
                philox.keep_threshold(rate), 1.0 - rate]
    return [b * h, s, d, int(q.dtype == torch.bfloat16), d ** -0.5, *drop,
            device, torch.cuda.current_stream(device).cuda_stream]


def _check_launch(err: int, what: str, q: torch.Tensor) -> None:
    if err != 0:
        raise RuntimeError(
            f"{what} launch failed with CUDA error {err} "
            f"(shape {tuple(q.shape)}, {q.dtype})"
        )


# --- plain versions -------------------------------------------------------


def _weights(q, k, rate: float, seed: int):
    """``(p, z, keep, lse)``: the f32 softmax ``[B, h, S, S]``, the dropped
    weights, the bool keep mask (``p`` itself and None at rate 0) and the
    log-sum-exp of the scaled logits. The logits stay f32 under an
    autocast region too (CPU autocast would run the product in bf16)."""
    b, h, s, d = q.shape
    with torch.autocast(q.device.type, enabled=False):
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (
            d ** -0.5)
    lse = torch.logsumexp(logits, dim=-1)
    p = torch.softmax(logits, dim=-1)
    if rate == 0.0:
        return p, p, None, lse
    keep = philox.mha_keep_mask(b * h, s, rate, seed, q.device).view(
        b, h, s, s)
    return p, torch.where(keep, p / (1.0 - rate), 0.0), keep, lse


def plain_fused_mha_forward(q, k, v, rate: float = 0.0,
                            seed: int | None = None):
    """``(out, lse)``: ``out = (softmax(q k^T scale) * mask / (1 - rate))
    v`` in q's dtype, with f32 logits and softmax, the mask applied to the
    normalised weights and the weights cast to v's dtype for the product;
    ``lse`` the log-sum-exp of the scaled logits, f32 ``[B, h, S]``."""
    rate, seed = _dropout_args(rate, seed)
    _, z, _, lse = _weights(q, k, rate, seed)
    return torch.matmul(z.to(v.dtype), v), lse


def plain_fused_mha_backward(q, k, v, g, rate: float = 0.0,
                             seed: int | None = None, out=None):
    """``(dq, dk, dv)`` by the JAX backward kernel's formulas on whole
    ``[S, S]`` tensors: the softmax p and the mask recomputed,
    ``dv = z^T g``, ``dz = g v^T``, ``dp = dz * mask``,
    ``ds = p (dp - rowsum(dp p)) scale``, ``dq = ds k``, ``dk = ds^T q``;
    z and ds are cast to the inputs' dtype for their products, sums are
    f32.

    With ``out`` (the forward's output) the row sum is taken as the CUDA
    backward takes it, ``rowsum(g * out)``: the same number in exact
    arithmetic (``sum_j dp_j p_j = sum_j dz_j z_j = g . out``), but in bf16
    it carries the rounding of ``out``. Holding the bf16 kernels to this
    form separates that rounding from a fault; the f32 kernels are held to
    the direct form, which shows the identity at rate > 0."""
    rate, seed = _dropout_args(rate, seed)
    scale = q.shape[-1] ** -0.5
    p, z, keep, _ = _weights(q, k, rate, seed)
    dv = torch.matmul(z.to(g.dtype).transpose(-1, -2), g)
    dp = torch.matmul(g.float(), v.float().transpose(-1, -2))
    if keep is not None:
        dp = torch.where(keep, dp / (1.0 - rate), 0.0)
    if out is None:
        delta = (dp * p).sum(dim=-1, keepdim=True)
    else:
        delta = (g.float() * out.float()).sum(dim=-1, keepdim=True)
    ds = ((p * (dp - delta)) * scale).to(q.dtype)
    dq = torch.matmul(ds, k)
    dk = torch.matmul(ds.transpose(-1, -2), q)
    return dq, dk, dv


# --- kernels ----------------------------------------------------------------


def _launch_forward(q, k, v, rate: float, seed: int, save: bool):
    _check_aligned(q=q, k=k, v=v)
    b, h, s, _ = q.shape
    fn = _kernel("fused_mha_fwd", "fused_mha_fwd")
    out = torch.empty_like(q)
    lse = (torch.empty(b, h, s, dtype=torch.float32, device=q.device)
           if save else None)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             None if lse is None else lse.data_ptr(),
             *_launch_args(q, rate, seed), *wide_args(q, "fwd"))
    _check_launch(err, "fused_mha_fwd", q)
    _count("fwd_train" if save else "fwd")
    return out, lse


def fused_mha_forward_train(q, k, v, rate: float = 0.0,
                            seed: int | None = None):
    """The training forward: ``(out, lse)`` as
    :func:`plain_fused_mha_forward`; on a CUDA tensor the kernel writes
    them, on a CPU tensor the plain version does."""
    _check(q, k, v)
    rate, seed = _dropout_args(rate, seed)
    if q.device.type == "cpu":
        return plain_fused_mha_forward(q, k, v, rate, seed)
    return _launch_forward(q, k, v, rate, seed, save=True)


def fused_mha_backward(q, k, v, out, lse, g, rate: float = 0.0,
                       seed: int | None = None):
    """``(dq, dk, dv)`` as :func:`plain_fused_mha_backward`; on a CUDA
    tensor the backward kernels compute them from the forward's ``out`` and
    ``lse``, on a CPU tensor the plain version does."""
    _check(q, k, v)
    rate, seed = _dropout_args(rate, seed)
    b, h, s, _ = q.shape
    for name, x in (("out", out), ("g", g)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(
                f"{name} must match q in shape, dtype and device: "
                f"{tuple(x.shape)} {x.dtype} {x.device} vs {tuple(q.shape)} "
                f"{q.dtype} {q.device}"
            )
    if (lse.shape != (b, h, s) or lse.dtype != torch.float32
            or lse.device != q.device):
        raise ValueError(
            f"lse must be float32 [B, h, S] = {(b, h, s)} on {q.device}, "
            f"got {lse.dtype} {tuple(lse.shape)} on {lse.device}"
        )
    _check_layout(out=out, g=g, lse=lse)
    if q.device.type == "cpu":
        return plain_fused_mha_backward(q, k, v, g, rate, seed)
    _check_aligned(q=q, k=k, v=v, out=out, g=g, lse=lse)
    fn = _kernel("fused_mha_bwd", "fused_mha_bwd")
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    delta = torch.empty_like(lse)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr(), g.data_ptr(), dq.data_ptr(), dk.data_ptr(),
             dv.data_ptr(), delta.data_ptr(), *_launch_args(q, rate, seed),
             *wide_args(q, "bwd"))
    _check_launch(err, "fused_mha_bwd", q)
    _count("bwd")
    return dq, dk, dv


def keep_bits(rows: int, seq_len: int, seed: int, device) -> torch.Tensor:
    """The dropout words ``[rows, S, S]`` (int64 holding 32-bit values) as
    the kernels draw them on a CUDA device, or as :mod:`.philox` draws them
    on the CPU; for holding the two to each other."""
    device = torch.device(device)
    if device.type == "cpu":
        return philox.mha_keep_bits(rows, seq_len, seed)
    if not 0 <= seed < 2**64:
        raise ValueError(f"seed must be in [0, 2**64), got {seed}")
    out = torch.empty(rows, seq_len, seq_len, dtype=torch.int32,
                      device=device)
    fn = _kernel("fused_mha_fwd", "fused_mha_keep_bits")
    index = device.index if device.index is not None else (
        torch.cuda.current_device())
    err = fn(out.data_ptr(), rows, seq_len, seed & 0xFFFFFFFF, seed >> 32,
             index, torch.cuda.current_stream(index).cuda_stream)
    _check_launch(err, "fused_mha_keep_bits", out)
    return out.long() & 0xFFFFFFFF


class _FusedFunction(torch.autograd.Function):
    """The op under autograd: saves q, k, v, out and the log-sum-exp, and
    the seed; nothing of size S x S, and no mask."""

    @staticmethod
    def forward(ctx, q, k, v, rate, seed):
        out, lse = fused_mha_forward_train(q, k, v, rate, seed)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.dropout = (rate, seed)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        # The cotangent may arrive strided (the model transposes the
        # output) or in another dtype; the kernels take q's, contiguous.
        g = g.to(q.dtype).contiguous()
        dq, dk, dv = fused_mha_backward(q, k, v, out, lse, g, *ctx.dropout)
        return dq, dk, dv, None, None


def fused_multi_head_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    dropout_rate: float = 0.0, dropout_seed: int | None = None,
) -> torch.Tensor:
    """Fused attention (and weight dropout) on contiguous ``[B, h, S, d]``
    q/k/v of one dtype (f32 or bf16); returns ``[B, h, S, d]`` in that
    dtype. ``dropout_seed`` (an int in ``[0, 2**64)``, where JAX takes a
    ``dropout_rng`` key) is required when ``dropout_rate > 0``."""
    _check(q, k, v)
    rate, seed = _dropout_args(dropout_rate, dropout_seed)
    if torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad
    ):
        return _FusedFunction.apply(q, k, v, rate, seed)
    # The eval forward: the favit::fused_mha_fwd operator (ops/library.py).
    return torch.ops.favit.fused_mha_fwd(q, k, v, rate, seed & 0xFFFFFFFF,
                                         seed >> 32)
