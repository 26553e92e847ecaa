"""The MHLA window band on S-minor ``[B, h, d, S]`` tensors, forward only
(port of the eval path of ``focused_attention_vit_tpu/ops/mhla_band_roll.py``).

:func:`roll_banded_attention` is the band op. On a CUDA tensor it launches
the hand-written kernel ``csrc/mhla_band_fwd.cu`` (built with nvcc at first
use, see :mod:`..utils.kernel_build`) or raises; on a CPU tensor it runs the
plain version, :data:`plain_banded_attention`, the S-minor shift band of
:mod:`.window`. There is no fallback from the kernel to the plain version.

Semantics are the JAX op's at dropout rate 0: slot o of query i reads key
``i - W//2 + o``, wrapping to row S-1 below 0 and to row 0 past S-1, with
f32 logits, f32 softmax over the W slots and f32 accumulation, rounded once
to the input dtype.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from focused_attention_vit_tpu_torch.ops.window import (
    _shift_banded_attention_ds,
)

KERNEL_SOURCE = "focused_attention_vit_tpu_torch/csrc/mhla_band_fwd.cu"
# The kernel unrolls its slots to 16 (kMaxWindow in the source).
MAX_WINDOW = 16
HEAD_DIMS = (16, 32, 64, 128)  # the kernel's instantiations

# The plain version the kernel is held against, and what CPU tensors run.
plain_banded_attention = _shift_banded_attention_ds

_launches = 0
_launch_lock = threading.Lock()


def launch_count() -> int:
    """Kernel launches since the last :func:`reset_launch_count`."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    with _launch_lock:
        _launches = 0


def _library() -> ctypes.CDLL:
    from focused_attention_vit_tpu_torch.utils import kernel_build

    lib = kernel_build.load("mhla_band_fwd")
    fn = lib.mhla_band_fwd
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return lib


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
    d, s = q.shape[2], q.shape[3]
    if not 1 <= window_size <= MAX_WINDOW:
        raise ValueError(
            f"band op supports 1 <= window_size <= {MAX_WINDOW}, got "
            f"{window_size}"
        )
    if s <= 2 * window_size:
        raise ValueError(
            f"band op needs S > 2*W (got S={s}, W={window_size}); the gather "
            f"form covers shorter sequences"
        )
    if d not in HEAD_DIMS:
        raise ValueError(f"band op supports head dims {HEAD_DIMS}, got {d}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("band op needs contiguous q, k, v")


def roll_banded_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          window_size: int) -> torch.Tensor:
    """Window band on S-minor ``[B, h, d, S]`` q/k/v (K and V already carry
    the latent projection); returns ``[B, h, d, S]`` in the input dtype."""
    _check(q, k, v, window_size)
    if q.device.type == "cpu":
        return plain_banded_attention(q, k, v, window_size)
    if q.device.type != "cuda":
        raise ValueError(f"band op runs on cpu or cuda, got {q.device}")
    lib = _library()
    b, h, d, s = q.shape
    out = torch.empty_like(q)
    device = q.get_device()
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.mhla_band_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h, d,
        s, window_size, int(q.dtype == torch.bfloat16), d ** -0.5, device,
        stream,
    )
    if err != 0:
        raise RuntimeError(
            f"mhla_band_fwd launch failed with CUDA error {err} "
            f"(shape {tuple(q.shape)}, W={window_size}, {q.dtype})"
        )
    global _launches
    with _launch_lock:
        _launches += 1
    return out
