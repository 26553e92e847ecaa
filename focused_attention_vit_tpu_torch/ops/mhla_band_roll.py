"""The MHLA window band on S-minor ``[B, h, d, S]`` tensors, eval and
training (port of ``focused_attention_vit_tpu/ops/mhla_band_roll.py``).

:func:`roll_banded_attention` is the band op. It goes through one
``torch.autograd.Function`` whenever autograd records (grad enabled and q, k
or v requiring grad); otherwise it runs the lean forward, which writes no
saved weights, as the JAX op's primal path does. On a CUDA tensor each part
launches a hand-written kernel or raises; on a CPU tensor it runs the
kernel's plain version. There is no fallback from a kernel to a plain
version.

- eval forward: ``csrc/mhla_band_fwd.cu``, launch count ``"fwd"``, plain
  version :data:`plain_banded_attention`, through the ``favit::band_fwd``
  operator (``ops/library.py``);
- training forward, which also saves the pre-dropout weights: the same
  source, ``"fwd_train"``, :func:`plain_band_forward_train`;
- backward (dq, dk, dv): ``csrc/mhla_band_bwd.cu``, ``"bwd"``,
  :func:`plain_band_backward`.

Semantics are the JAX op's: slot o of query i reads key ``i - W//2 + o``,
wrapping to row S-1 below 0 and to row 0 past S-1, with f32 logits, f32
softmax over the W slots and f32 accumulation, rounded once to the input
dtype. ``dropout=(rate, seed)`` drops each window slot independently with
probability ``rate`` and scales the kept weights by ``1 / (1 - rate)``; the
mask comes from Philox keyed on (seed, b*h row, slot, query)
(:mod:`.philox`), so the CPU path and the card draw the same mask, and the
backward regenerates it instead of saving it.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from focused_attention_vit_tpu_torch.ops import philox
from focused_attention_vit_tpu_torch.ops.flash_attention import (
    pad_head_dim,
    unpad_head_dim,
)
from focused_attention_vit_tpu_torch.ops.window import (
    _halo_pad,
    _shift_band_apply_ds,
    _shift_band_weights_ds,
    _shift_banded_attention_ds,
)

KERNEL_SOURCE = "focused_attention_vit_tpu_torch/csrc/mhla_band_fwd.cu"
BWD_KERNEL_SOURCE = "focused_attention_vit_tpu_torch/csrc/mhla_band_bwd.cu"
# The kernels' range on a CUDA tensor: JAX's roll band takes W <= 129 (its
# halo of 128 lanes) and any head dim; so do the kernels, which stage
# channels in chunks of 8 (bf16) or 4 (f32), hold the slots of W > 16 in
# groups of 16 (kMaxWindow in the sources), and take a head dim off the grid
# of 8 padded with zero channels (pad_head_dim). A CPU tensor takes any W
# with S > 2W and any head dim, as JAX's shift band does.
MAX_WINDOW = 129

# The plain version the eval kernel is held against.
plain_banded_attention = _shift_banded_attention_ds

LAUNCH_KINDS = ("fwd", "fwd_train", "bwd")
_launches = dict.fromkeys(LAUNCH_KINDS, 0)
_launch_lock = threading.Lock()


def launch_count(kind: str = "fwd") -> int:
    """Kernel launches of one kind since the last
    :func:`reset_launch_count`: ``"fwd"`` the eval forward, ``"fwd_train"``
    the training forward, ``"bwd"`` the backward."""
    return _launches[kind]


def reset_launch_count() -> None:
    with _launch_lock:
        for kind in LAUNCH_KINDS:
            _launches[kind] = 0


def _count(kind: str) -> None:
    with _launch_lock:
        _launches[kind] += 1


_PTR, _INT, _UINT, _FLOAT = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                             ctypes.c_float)
# on, seed low and high words, threshold, 1 - rate
_DROPOUT_ARGS = [_INT, _UINT, _UINT, _UINT, _FLOAT]
_SIGNATURES = {
    ("mhla_band_fwd", "mhla_band_fwd"):
        [_PTR] * 6 + [ctypes.c_longlong, _INT, _INT, _INT, _INT, _FLOAT]
        + _DROPOUT_ARGS + [_INT, _PTR],
    ("mhla_band_fwd", "mhla_band_keep_bits"):
        [_PTR, ctypes.c_longlong, _INT, _INT, _UINT, _UINT, _INT, _PTR],
    ("mhla_band_bwd", "mhla_band_bwd"):
        [_PTR] * 9 + [ctypes.c_longlong, _INT, _INT, _INT, _INT, _FLOAT]
        + _DROPOUT_ARGS + [_INT, _PTR],
}


def _kernel(source: str, fn_name: str):
    from focused_attention_vit_tpu_torch.utils import kernel_build

    fn = getattr(kernel_build.load(source), fn_name)
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURES[(source, fn_name)]
        fn.restype = ctypes.c_int
    return fn


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window_size: int) -> None:
    if q.dim() != 4:
        raise ValueError(f"expected [B, h, d, S] tensors, got {tuple(q.shape)}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"q, k, v shapes differ: {tuple(q.shape)}, {tuple(k.shape)}, "
            f"{tuple(v.shape)}"
        )
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
        k.dtype == v.dtype == q.dtype
    ):
        raise TypeError(
            f"band op takes float32 or bfloat16 q/k/v of one dtype, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    if not (k.device == v.device == q.device):
        raise ValueError("q, k, v must be on one device")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"band op runs on cpu or cuda, got {q.device}")
    d, s = q.shape[2], q.shape[3]
    if window_size < 1:
        raise ValueError(f"band op needs window_size >= 1, got {window_size}")
    if s <= 2 * window_size:
        raise ValueError(
            f"band op needs S > 2*W (got S={s}, W={window_size}); the gather "
            f"form covers shorter sequences"
        )
    if q.device.type == "cuda":
        _check_kernel_range(window_size)
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("band op needs contiguous q, k, v")


def _check_kernel_range(window_size: int) -> None:
    """The kernels' range: W <= 129 (JAX's roll band's rule and message);
    every head dim."""
    if window_size > MAX_WINDOW:
        raise ValueError(
            f"band op supports window_size <= {MAX_WINDOW} (got "
            f"{window_size}); use the shift path for wider windows"
        )


def _dropout_args(rate: float, seed) -> tuple[float, int]:
    """Validated ``(rate, seed)``; a None seed means no dropout."""
    if seed is None:
        return 0.0, 0
    rate = float(rate)
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    seed = int(seed)
    if not 0 <= seed < 2**64:
        raise ValueError(f"dropout seed must be in [0, 2**64), got {seed}")
    return rate, seed


def _kernel_dropout_args(rate: float, seed: int) -> list:
    if rate == 0.0:
        return [0, 0, 0, 0, 1.0]
    return [1, seed & 0xFFFFFFFF, seed >> 32, philox.keep_threshold(rate),
            1.0 - rate]


def _check_launch(err: int, what: str, q: torch.Tensor, w: int) -> None:
    if err != 0:
        raise RuntimeError(
            f"{what} launch failed with CUDA error {err} "
            f"(shape {tuple(q.shape)}, W={w}, {q.dtype})"
        )


def _stream_args(q: torch.Tensor) -> list:
    device = q.get_device()
    return [device, torch.cuda.current_stream(device).cuda_stream]


# --- plain versions -------------------------------------------------------


def _keep_mask(q: torch.Tensor, window_size: int, rate: float, seed: int
               ) -> torch.Tensor:
    b, h, _, s = q.shape
    return philox.band_keep_mask(b * h, window_size, s, rate, seed,
                                 q.device).view(b, h, window_size, s)


def plain_band_forward_train(q, k, v, window_size: int, rate: float = 0.0,
                             seed: int | None = None):
    """``(out, wts)``: the band output in q's dtype and the pre-dropout
    softmax weights, f32 ``[B*h, W, S]``, with the kernels' dropout rule."""
    rate, seed = _dropout_args(rate, seed)
    b, h, _, s = q.shape
    weights = _shift_band_weights_ds(q, k, window_size)  # [B, h, W, S] f32
    dropped = weights
    if rate > 0.0:
        keep = _keep_mask(q, window_size, rate, seed)
        dropped = torch.where(keep, weights / (1.0 - rate), 0.0)
    out = _shift_band_apply_ds(dropped, v).to(q.dtype)
    return out, weights.reshape(b * h, window_size, s)


def _fold_ext(d_ext: torch.Tensor, s: int, w: int) -> torch.Tensor:
    """Fold a cotangent of the halo-padded keys (``[.., S+W-1]``) back to
    ``[.., S]``: the edge copies accumulate into rows S-1 and 0 (JAX
    ``_fold_ext``)."""
    hw = w // 2
    core = d_ext[..., hw:hw + s].clone()
    if hw:
        core[..., s - 1] += d_ext[..., :hw].sum(-1)
    if w - 1 - hw:
        core[..., 0] += d_ext[..., hw + s:s + w - 1].sum(-1)
    return core


def plain_band_backward(q, k, v, g, wts, window_size: int, rate: float = 0.0,
                        seed: int | None = None):
    """``(dq, dk, dv)`` of the band from the forward's saved f32 weights
    ``[B*h, W, S]`` and the regenerated mask, by the JAX backward kernel's
    formulas: halo-padded K/V, the softmax backward, and the fold of the
    halo cotangents into rows S-1 and 0. Sums in f32, results rounded to
    the inputs' dtype."""
    rate, seed = _dropout_args(rate, seed)
    b, h, d, s = q.shape
    w = window_size
    scale = d ** -0.5
    qf, gf = q.float(), g.float()
    kp = _halo_pad(k, w, dim=3).float()
    vp = _halo_pad(v, w, dim=3).float()
    wts = wts.view(b, h, w, s)
    u = torch.stack([(gf * vp[..., o:o + s]).sum(dim=2) for o in range(w)],
                    dim=2)  # [B, h, W, S]
    dw, wd = u, wts
    if rate > 0.0:
        keep = _keep_mask(q, w, rate, seed)
        dw = torch.where(keep, u / (1.0 - rate), 0.0)
        wd = torch.where(keep, wts / (1.0 - rate), 0.0)
    dlog = wts * (dw - (wts * dw).sum(dim=2, keepdim=True))
    dq = sum(dlog[:, :, o:o + 1] * kp[..., o:o + s] for o in range(w)) * scale
    dk_ext = qf.new_zeros(b, h, d, s + w - 1)
    dv_ext = qf.new_zeros(b, h, d, s + w - 1)
    qs = qf * scale
    for o in range(w):
        dk_ext[..., o:o + s] += dlog[:, :, o:o + 1] * qs
        dv_ext[..., o:o + s] += wd[:, :, o:o + 1] * gf
    return (dq.to(q.dtype), _fold_ext(dk_ext, s, w).to(k.dtype),
            _fold_ext(dv_ext, s, w).to(v.dtype))


# --- kernels ----------------------------------------------------------------


# Slots the kernels hold in registers (csrc: kMaxSlots); past it, groups.
_MAX_SLOTS = 16


def _launch_forward(q, k, v, w: int, rate: float, seed: int, save: bool):
    b, h, d, s = q.shape
    q, k, v = (pad_head_dim(x, 2) for x in (q, k, v))
    fn = _kernel("mhla_band_fwd", "mhla_band_fwd")
    out = torch.empty_like(q)
    wts = (torch.empty(b * h, w, s, dtype=torch.float32, device=q.device)
           if save else None)
    # Past 16 slots the kernel writes the logits, then the weights it
    # applies, to f32 [B*h, W, S]: the saved weights themselves when they
    # are the ones applied (training without dropout), scratch otherwise.
    scratch = None
    if w > _MAX_SLOTS and (wts is None or rate > 0.0):
        scratch = torch.empty(b * h, w, s, dtype=torch.float32,
                              device=q.device)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             None if wts is None else wts.data_ptr(),
             None if scratch is None else scratch.data_ptr(), b * h,
             q.shape[2], s, w, int(q.dtype == torch.bfloat16), d ** -0.5,
             *_kernel_dropout_args(rate, seed), *_stream_args(q))
    _check_launch(err, "mhla_band_fwd", q, w)
    _count("fwd_train" if save else "fwd")
    return unpad_head_dim(out, d, 2), wts


def band_forward_train(q, k, v, window_size: int, rate: float = 0.0,
                       seed: int | None = None):
    """The training forward: ``(out, wts)`` as
    :func:`plain_band_forward_train`, through the ``favit::band_fwd_train``
    operator; on a CUDA tensor the kernel writes them, on a CPU tensor the
    plain version does."""
    _check(q, k, v, window_size)
    rate, seed = _dropout_args(rate, seed)
    out, wts = torch.ops.favit.band_fwd_train(
        q, k, v, window_size, rate, seed & 0xFFFFFFFF, seed >> 32)
    return out, wts


def band_backward(q, k, v, g, wts, window_size: int, rate: float = 0.0,
                  seed: int | None = None):
    """``(dq, dk, dv)`` as :func:`plain_band_backward`; on a CUDA tensor
    the backward kernel computes them, on a CPU tensor the plain version."""
    _check(q, k, v, window_size)
    rate, seed = _dropout_args(rate, seed)
    b, h, d, s = q.shape
    if g.shape != q.shape or g.dtype != q.dtype or g.device != q.device:
        raise ValueError(
            f"g must match q in shape, dtype and device: {tuple(g.shape)} "
            f"{g.dtype} {g.device} vs {tuple(q.shape)} {q.dtype} {q.device}"
        )
    if (wts.shape != (b * h, window_size, s) or wts.dtype != torch.float32
            or wts.device != q.device):
        raise ValueError(
            f"wts must be float32 [B*h, W, S] = {(b * h, window_size, s)} "
            f"on {q.device}, got {wts.dtype} {tuple(wts.shape)} on "
            f"{wts.device}"
        )
    if not (g.is_contiguous() and wts.is_contiguous()):
        raise ValueError("band backward needs contiguous g and wts")
    if q.device.type == "cpu":
        return plain_band_backward(q, k, v, g, wts, window_size, rate, seed)
    q, k, v, g = (pad_head_dim(x, 2) for x in (q, k, v, g))
    fn = _kernel("mhla_band_bwd", "mhla_band_bwd")
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    scratch = torch.empty(2, b * h, window_size, s, dtype=torch.float32,
                          device=q.device)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
             wts.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             scratch.data_ptr(), b * h, q.shape[2], s, window_size,
             int(q.dtype == torch.bfloat16), d ** -0.5,
             *_kernel_dropout_args(rate, seed), *_stream_args(q))
    _check_launch(err, "mhla_band_bwd", q, window_size)
    _count("bwd")
    return tuple(unpad_head_dim(x, d, 2) for x in (dq, dk, dv))


def keep_bits(rows: int, window_size: int, seq_len: int, seed: int,
              device) -> torch.Tensor:
    """The dropout words ``[rows, W, S]`` (int64 holding 32-bit values) as
    the kernels draw them on a CUDA device, or as :mod:`.philox` draws them
    on the CPU; for holding the two to each other."""
    device = torch.device(device)
    if device.type == "cpu":
        return philox.band_keep_bits(rows, window_size, seq_len, seed)
    if not 1 <= window_size <= MAX_WINDOW:
        raise ValueError(f"window_size must be in [1, {MAX_WINDOW}]")
    _, seed = _dropout_args(0.0, seed)
    out = torch.empty(rows, window_size, seq_len, dtype=torch.int32,
                      device=device)
    fn = _kernel("mhla_band_fwd", "mhla_band_keep_bits")
    index = device.index if device.index is not None else (
        torch.cuda.current_device())
    err = fn(out.data_ptr(), rows, seq_len, window_size, seed & 0xFFFFFFFF,
             seed >> 32, index, torch.cuda.current_stream(index).cuda_stream)
    _check_launch(err, "mhla_band_keep_bits", out, window_size)
    return out.long() & 0xFFFFFFFF


class _BandFunction(torch.autograd.Function):
    """The band op under autograd: the training forward (the
    ``favit::band_fwd_train`` operator, which a remat policy can name)
    saves q, k, v and the pre-dropout weights; the backward regenerates the
    mask."""

    @staticmethod
    def forward(ctx, q, k, v, window_size, rate, seed):
        out, wts = band_forward_train(q, k, v, window_size, rate, seed)
        ctx.save_for_backward(q, k, v, wts)
        ctx.band_args = (window_size, rate, seed)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        q, k, v, wts = ctx.saved_tensors
        # The cotangent may arrive strided (the model transposes the band
        # output) or in another dtype; the kernel takes q's, contiguous.
        g = g.to(q.dtype).contiguous()
        dq, dk, dv = band_backward(q, k, v, g, wts, *ctx.band_args)
        return dq, dk, dv, None, None, None


def roll_banded_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          window_size: int, dropout=(0.0, None)
                          ) -> torch.Tensor:
    """Window band on S-minor ``[B, h, d, S]`` q/k/v (K and V already carry
    the latent projection); returns ``[B, h, d, S]`` in the input dtype.
    ``dropout`` is ``(rate, seed)`` with an int seed in ``[0, 2**64)``; a
    None seed means no dropout, as in the JAX op."""
    _check(q, k, v, window_size)
    rate, seed = _dropout_args(*dropout)
    if torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad
    ):
        return _BandFunction.apply(q, k, v, window_size, rate, seed)
    # The eval forward: the favit::band_fwd operator (ops/library.py).
    return torch.ops.favit.band_fwd(q, k, v, window_size, rate,
                                    seed & 0xFFFFFFFF, seed >> 32)
