"""The MHLA tile band on token-major tensors (port of
``focused_attention_vit_tpu/ops/mhla_kernel_v4.py``).

The **clamped** window band: query r reads the keys at positions
``r - W//2 .. r + W//2``, each clamped to ``[0, S-1]`` (the edge-replicated
pad of JAX's ``_pad_seq``), so a replicated key counts once per position and
an even W reads W+1 keys. Logits and softmax are f32, the weights are
rounded to the input dtype before the product with V, which accumulates in
f32 and is rounded once, as JAX's ``_fwd_kernel`` does. The caller
(``ops/window.py``) overwrites the first and last W//2 rows with the
reference's exact windows.

Three kernels, each with its plain PyTorch version and launch count. On a
CUDA tensor each launches its kernel or raises; on a CPU tensor it runs the
plain version. Nothing falls back.

- K6, the forward on ``[B*h, S, d]``: :func:`tile_band_forward`,
  ``csrc/mhla_tile_band_fwd.cu``, count ``"fwd"``, plain
  :func:`plain_tile_band_forward`;
- K7, its backward: :func:`tile_band_backward`,
  ``csrc/mhla_tile_band_bwd.cu``, count ``"bwd"``; what JAX's ``_bwd_rule``
  returns, dq, dk and dv with the clamped positions' mass folded into rows
  0 and S-1 (the kernel folds in one launch), plain :func:`plain_bwd_rule`:
  :func:`plain_tile_band_backward` (JAX's ``_bwd_kernel``, the in-range
  positions), then :func:`_edge_fold`, as in JAX;
- K8, the same band from prebuilt ``[B*h, n_t, t + 2*halo, d]`` window
  tiles, forward only: :func:`window_tile_band`, the forward's source,
  count ``"fwd_b"``, plain :func:`plain_window_tile_band`.

:func:`banded_attention_v4` joins K6 and K7 in one ``torch.autograd.Function``
that saves q, k and v, as JAX's ``_fwd_rule``. :func:`banded_attention_v4b`
builds the window tiles in plain PyTorch, as XLA does in JAX, and runs K8.
The kernels stage a halo of 16 rows, so they take ``W // 2 <= 16`` (W up to
33); JAX's halo grows with W.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import numpy as np
import torch

KERNEL_SOURCE = "focused_attention_vit_tpu_torch/csrc/mhla_tile_band_fwd.cu"
BWD_KERNEL_SOURCE = "focused_attention_vit_tpu_torch/csrc/mhla_tile_band_bwd.cu"
DEFAULT_BLOCK = 256
# JAX's v4b groups this many (b*h) rows per grid step when B*h divides by
# it; the result does not depend on the grouping, and the port's K8 does not
# group.
GROUP = 8
# The kernels' halo (kHalo in the sources): W // 2 up to 16.
MAX_HALF_WINDOW = 16
MAX_WINDOW = 2 * MAX_HALF_WINDOW + 1
HEAD_DIMS = (16, 32, 64, 128)  # the kernels' instantiations

LAUNCH_KINDS = ("fwd", "bwd", "fwd_b")
_launches = dict.fromkeys(LAUNCH_KINDS, 0)
_launch_lock = threading.Lock()


def launch_count(kind: str = "fwd") -> int:
    """Kernel launches of one kind since the last
    :func:`reset_launch_count`: ``"fwd"`` K6 (eval and training forward),
    ``"bwd"`` K7, ``"fwd_b"`` K8."""
    return _launches[kind]


def reset_launch_count() -> None:
    with _launch_lock:
        for kind in LAUNCH_KINDS:
            _launches[kind] = 0


def _count(kind: str) -> None:
    with _launch_lock:
        _launches[kind] += 1


# --- JAX's helpers --------------------------------------------------------


def _band_mask(n_q: int, n_k: int, q_off: int, hw: int, device=None
               ) -> torch.Tensor:
    """``[n_q, n_k]`` bool: key column ``c - q_off`` within ``hw`` of query
    row r."""
    r = torch.arange(n_q, device=device)[:, None]
    c = torch.arange(n_k, device=device)[None, :]
    return (c - q_off - r).abs() <= hw


def _halo(block: int, hw: int) -> int:
    """JAX's halo: at least ``hw``, a multiple of 16."""
    return max(16, -(-hw // 16) * 16)


def _pad_seq(x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Edge-pad ``[BH, S, d]`` along S: ``lo`` copies of row 0 in front,
    ``hi`` copies of row S-1 behind."""
    parts = [x[:, :1].expand(-1, lo, -1)] if lo else []
    parts.append(x)
    if hi:
        parts.append(x[:, -1:].expand(-1, hi, -1))
    return torch.cat(parts, 1) if len(parts) > 1 else x


def _window_tiles(x: torch.Tensor, t: int, halo: int, sp: int
                  ) -> torch.Tensor:
    """``[BH, S, d]`` -> ``[BH, n_t, t + 2*halo, d]`` overlapping key
    windows from two shifted reshapes: window i covers rows
    ``[i*t, i*t + t + 2*halo)`` of the sequence edge-padded by ``halo`` in
    front and ``sp - S + halo`` behind."""
    bh, s, d = x.shape
    n_t = sp // t
    xp = _pad_seq(x, halo, sp - s + halo + t)
    main = xp[:, :n_t * t].reshape(bh, n_t, t, d)
    head = xp[:, t:t + n_t * t].reshape(bh, n_t, t, d)[:, :, :2 * halo]
    return torch.cat([main, head], 2)


# --- plain versions ---------------------------------------------------------


def _shifts(x: torch.Tensor, hw: int):
    """The ``2*hw + 1`` row shifts of ``[BH, S, d]`` x in f32: shift j holds
    row ``clamp(r + j - hw)`` at row r."""
    s = x.shape[1]
    xp = _pad_seq(x, hw, hw).float()
    return [xp[:, j:j + s] for j in range(2 * hw + 1)]


def _band_weights(q: torch.Tensor, k: torch.Tensor, hw: int) -> torch.Tensor:
    """f32 ``[BH, S, 2*hw + 1]`` softmax weights of the clamped band."""
    qf = q.float()
    logits = torch.stack([(qf * ks).sum(-1) for ks in _shifts(k, hw)], -1)
    return torch.softmax(logits * q.shape[-1] ** -0.5, -1)


def plain_tile_band_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            window_size: int) -> torch.Tensor:
    """K6's plain version on ``[BH, S, d]``: the clamped band as
    ``2*hw + 1`` shifted multiply-reduces (JAX's ``_clamp_shift``), the
    weights rounded to the input dtype before the f32 sum with V."""
    hw = window_size // 2
    p = _band_weights(q, k, hw).to(q.dtype).float()
    out = sum(p[..., j:j + 1] * vs for j, vs in enumerate(_shifts(v, hw)))
    return out.to(q.dtype)


def plain_tile_band_backward(q, k, v, g, window_size: int):
    """K7's plain version: ``(dq, dk, dv)`` on ``[BH, S, d]`` by the JAX
    kernel's formulas (the softmax VJP of the clamped band, ds and p rounded
    to the input dtype for the second products, f32 sums). dk and dv hold
    the in-range positions only; :func:`_edge_fold` adds the clamped ones."""
    bh, s, d = q.shape
    hw = window_size // 2
    n = 2 * hw + 1
    scale = d ** -0.5
    qf, gf = q.float(), g.float()
    ks, vs = _shifts(k, hw), _shifts(v, hw)
    p = _band_weights(q, k, hw)
    dp = torch.stack([(gf * x).sum(-1) for x in vs], -1)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True)) * scale
    dsb = ds.to(q.dtype).float()
    pb = p.to(q.dtype).float()
    dq = sum(dsb[..., j:j + 1] * ks[j] for j in range(n))
    # Position r + j - hw of query r is row r + j of the padded sums.
    dk_ext = qf.new_zeros(bh, s + 2 * hw, d)
    dv_ext = qf.new_zeros(bh, s + 2 * hw, d)
    for j in range(n):
        dk_ext[:, j:j + s] += dsb[..., j:j + 1] * qf
        dv_ext[:, j:j + s] += pb[..., j:j + 1] * gf
    return (dq.to(q.dtype), dk_ext[:, hw:hw + s].to(k.dtype),
            dv_ext[:, hw:hw + s].to(v.dtype))


@functools.lru_cache(maxsize=64)
def _fold_index(seq_len: int, hw: int, device: torch.device):
    """For :func:`_edge_fold`: the first and last ``hw`` query rows, the
    clamped key row of each of their ``2*hw + 1`` positions, and 1.0 where
    that position is out of range. Cached on ``device`` (made outside
    inference mode, so that a later autograd pass may use them)."""
    rows = np.r_[0:hw, seq_len - hw:seq_len]
    pos = rows[:, None] + np.arange(-hw, hw + 1)[None, :]
    idx = np.clip(pos, 0, seq_len - 1)
    with torch.inference_mode(False):
        return (torch.as_tensor(rows, device=device),
                torch.as_tensor(idx, device=device),
                torch.as_tensor((pos != idx).astype(np.float32),
                                device=device))


def _edge_fold(q, k, v, g, dk, dv, window_size: int):
    """Add the gradient mass that the clamped (out-of-range) positions of
    the first and last ``hw`` queries send to rows 0 and S-1 (JAX
    ``_edge_fold``), recomputed densely in f32 over those ``2*hw`` rows in
    one pass; returns new dk, dv."""
    s, d = q.shape[1], q.shape[2]
    hw = window_size // 2
    scale = d ** -0.5
    rows, idx, clamped = _fold_index(s, hw, q.device)
    qe, ge = q[:, rows].float(), g[:, rows].float()  # [bh, 2*hw, d]
    ke, ve = k[:, idx].float(), v[:, idx].float()  # [bh, 2*hw, W, d]
    p = torch.softmax(torch.einsum("bed,bewd->bew", qe, ke) * scale, -1)
    dp = torch.einsum("bed,bewd->bew", ge, ve)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    # Each edge row's mass on its clamped positions, then summed per side:
    # the left rows' goes to row 0, the right rows' to row S-1.
    mk = ((ds * scale * clamped).sum(-1, keepdim=True) * qe).view(
        -1, 2, hw, d).sum(2)
    mv = ((p * clamped).sum(-1, keepdim=True) * ge).view(-1, 2, hw, d).sum(2)
    dk, dv = dk.clone(), dv.clone()
    dk[:, 0] += mk[:, 0].to(dk.dtype)
    dv[:, 0] += mv[:, 0].to(dv.dtype)
    dk[:, s - 1] += mk[:, 1].to(dk.dtype)
    dv[:, s - 1] += mv[:, 1].to(dv.dtype)
    return dk, dv


def plain_bwd_rule(q, k, v, g, window_size: int):
    """K7's plain version: JAX's ``_bwd_rule`` in plain PyTorch,
    :func:`plain_tile_band_backward` and then, where W//2 > 0,
    :func:`_edge_fold`."""
    dq, dk, dv = plain_tile_band_backward(q, k, v, g, window_size)
    if window_size // 2 > 0:
        dk, dv = _edge_fold(q, k, v, g, dk, dv, window_size)
    return dq, dk, dv


def plain_window_tile_band(qt: torch.Tensor, ke: torch.Tensor,
                           ve: torch.Tensor, window_size: int) -> torch.Tensor:
    """K8's plain version: per-tile masked attention of query tiles
    ``[BH, n_t, t, d]`` over window tiles ``[BH, n_t, t + 2*halo, d]``, f32
    logits and softmax, weights rounded to the input dtype, f32 sums."""
    t, ext, d = qt.shape[2], ke.shape[2], qt.shape[3]
    mask = _band_mask(t, ext, (ext - t) // 2, window_size // 2, qt.device)
    logits = torch.matmul(qt.float(), ke.float().transpose(-1, -2)) * (
        d ** -0.5)
    p = torch.softmax(logits.masked_fill(~mask, float("-inf")), -1)
    return torch.matmul(p.to(qt.dtype).float(), ve.float()).to(qt.dtype)


# --- kernels ----------------------------------------------------------------


_PTR, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LL = ctypes.c_longlong
_SIGNATURES = {
    ("mhla_tile_band_fwd", "mhla_tile_band_fwd"):
        [_PTR] * 4 + [_LL, _INT, _INT, _INT, _INT, _FLOAT, _INT, _PTR],
    ("mhla_tile_band_fwd", "mhla_tile_band_fwd_tiles"):
        [_PTR] * 4 + [_LL, _INT, _INT, _INT, _INT, _INT, _FLOAT, _INT, _PTR],
    ("mhla_tile_band_fwd", "mhla_tile_band_fwd_smem"): [_INT],
    ("mhla_tile_band_bwd", "mhla_tile_band_bwd"):
        [_PTR] * 7 + [_LL, _INT, _INT, _INT, _INT, _FLOAT, _INT, _PTR],
    ("mhla_tile_band_bwd", "mhla_tile_band_bwd_smem"): [_INT],
}


def _kernel(source: str, fn_name: str):
    from focused_attention_vit_tpu_torch.utils import kernel_build

    fn = getattr(kernel_build.load(source), fn_name)
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURES[(source, fn_name)]
        fn.restype = ctypes.c_int
    return fn


def _check(tensors, window_size: int, what: str) -> None:
    """One dtype (f32 or bf16), one device (cpu or cuda), contiguous, a
    head dim the kernels take and ``W // 2 <= MAX_HALF_WINDOW``."""
    x = tensors[0]
    if x.dtype not in (torch.float32, torch.bfloat16) or any(
            t.dtype != x.dtype for t in tensors):
        raise TypeError(f"{what} takes float32 or bfloat16 tensors of one "
                        f"dtype, got {[t.dtype for t in tensors]}")
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"{what}: tensors must be on one device")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda, got {x.device}")
    if not 1 <= window_size <= MAX_WINDOW:
        raise ValueError(
            f"{what} takes 1 <= window_size <= {MAX_WINDOW} (a halo of "
            f"{MAX_HALF_WINDOW} rows), got {window_size}")
    if x.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"{what} takes head dims {HEAD_DIMS}, got "
                         f"{x.shape[-1]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what} needs contiguous tensors")


def _check_rows(tensors, window_size: int, what: str) -> None:
    _check(tensors, window_size, what)
    q = tensors[0]
    if q.dim() != 3 or q.shape[1] < 1 or any(t.shape != q.shape
                                             for t in tensors):
        raise ValueError(f"{what} takes [B*h, S, d] tensors of one shape, "
                         f"got {[tuple(t.shape) for t in tensors]}")


def _launch_args(q: torch.Tensor) -> list:
    device = q.get_device()
    return [int(q.dtype == torch.bfloat16), q.shape[-1] ** -0.5, device,
            torch.cuda.current_stream(device).cuda_stream]


def _check_launch(err: int, what: str, q: torch.Tensor, w: int) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed with CUDA error {err} "
                           f"(shape {tuple(q.shape)}, W={w}, {q.dtype})")


def tile_band_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      window_size: int) -> torch.Tensor:
    """K6 on ``[BH, S, d]``: the kernel on a CUDA tensor, its plain version
    on a CPU tensor."""
    _check_rows((q, k, v), window_size, "tile band forward")
    if q.device.type == "cpu":
        return plain_tile_band_forward(q, k, v, window_size)
    bh, s, d = q.shape
    out = torch.empty_like(q)
    fn = _kernel("mhla_tile_band_fwd", "mhla_tile_band_fwd")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh,
             s, d, window_size // 2, *_launch_args(q))
    _check_launch(err, "mhla_tile_band_fwd", q, window_size)
    _count("fwd")
    return out


def tile_band_backward(q, k, v, g, window_size: int):
    """K7: ``(dq, dk, dv)`` of JAX's ``_bwd_rule``, the clamped positions'
    mass folded into rows 0 and S-1 of dk and dv; one kernel launch on a
    CUDA tensor, :func:`plain_bwd_rule` on a CPU tensor."""
    _check_rows((q, k, v, g), window_size, "tile band backward")
    if q.device.type == "cpu":
        return plain_bwd_rule(q, k, v, g, window_size)
    bh, s, d = q.shape
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    fn = _kernel("mhla_tile_band_bwd", "mhla_tile_band_bwd")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
             dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh, s, d,
             window_size // 2, *_launch_args(q))
    _check_launch(err, "mhla_tile_band_bwd", q, window_size)
    _count("bwd")
    return dq, dk, dv


def window_tile_band(qt: torch.Tensor, ke: torch.Tensor, ve: torch.Tensor,
                     window_size: int) -> torch.Tensor:
    """K8 on query tiles ``[BH, n_t, t, d]`` and window tiles
    ``[BH, n_t, t + 2*halo, d]``: the kernel on a CUDA tensor (halo 16),
    its plain version on a CPU tensor. Returns ``[BH, n_t, t, d]``."""
    _check((qt, ke, ve), window_size, "window tile band")
    bh, n_t, t, d = qt.shape
    ext = ke.shape[2]
    hw = window_size // 2
    if (qt.dim() != 4 or ke.shape != ve.shape
            or ke.shape[:2] != qt.shape[:2] or ke.shape[3] != d
            or ext - t < 2 * hw or (ext - t) % 2):
        raise ValueError(
            f"window tile band takes q tiles [BH, n_t, t, d] and window "
            f"tiles [BH, n_t, t + 2*halo, d] with halo >= W//2, got "
            f"{tuple(qt.shape)}, {tuple(ke.shape)}, {tuple(ve.shape)}")
    if qt.device.type == "cpu":
        return plain_window_tile_band(qt, ke, ve, window_size)
    if ext - t != 2 * MAX_HALF_WINDOW:
        raise ValueError(f"the K8 kernel takes a halo of {MAX_HALF_WINDOW} "
                         f"rows, got {(ext - t) // 2}")
    out = torch.empty_like(qt)
    fn = _kernel("mhla_tile_band_fwd", "mhla_tile_band_fwd_tiles")
    err = fn(qt.data_ptr(), ke.data_ptr(), ve.data_ptr(), out.data_ptr(),
             bh, n_t, t, d, hw, *_launch_args(qt))
    _check_launch(err, "mhla_tile_band_fwd_tiles", qt, window_size)
    _count("fwd_b")
    return out


class _TileBandFunction(torch.autograd.Function):
    """K6 forward, K7 backward (the edge fold included); saves q, k, v."""

    @staticmethod
    def forward(ctx, q, k, v, window_size):
        ctx.save_for_backward(q, k, v)
        ctx.window_size = window_size
        return tile_band_forward(q, k, v, window_size)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        g = g.to(q.dtype).contiguous()
        return (*tile_band_backward(q, k, v, g, ctx.window_size), None)


def _check_block(block: int) -> None:
    if int(block) < 1:
        raise ValueError(f"block must be positive, got {block}")


def banded_attention_v4(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        window_size: int, block: int = DEFAULT_BLOCK
                        ) -> torch.Tensor:
    """Clamped band on ``[B, h, S, d]`` through K6 (and K7 under
    autograd). ``block`` is JAX's query tile; the clamped band does not
    depend on it, and the kernel tiles the queries by 64 of its own."""
    _check_block(block)
    b, h, s, d = q.shape
    out = _TileBandFunction.apply(
        *(x.reshape(b * h, s, d).contiguous() for x in (q, k, v)),
        window_size)
    return out.view(b, h, s, d)


def banded_attention_v4b(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         window_size: int, block: int = DEFAULT_BLOCK
                         ) -> torch.Tensor:
    """Forward-only clamped band on ``[B, h, S, d]`` through K8: the
    window tiles are built in plain PyTorch, with JAX's tile rule
    ``t = max(2*halo, min(block, ceil(S/8)*8))``."""
    _check_block(block)
    b, h, s, d = q.shape
    bh = b * h
    hw = window_size // 2
    halo = _halo(block, hw)
    t = max(2 * halo, min(block, -(-s // 8) * 8))
    sp = -(-s // t) * t
    n_t = sp // t
    qf = q.reshape(bh, s, d)
    ke = _window_tiles(k.reshape(bh, s, d), t, halo, sp)
    ve = _window_tiles(v.reshape(bh, s, d), t, halo, sp)
    qp = _pad_seq(qf, 0, sp - s).reshape(bh, n_t, t, d)
    out = window_tile_band(qp.contiguous(), ke, ve, window_size)
    return out.reshape(bh, sp, d)[:, :s].reshape(b, h, s, d)
