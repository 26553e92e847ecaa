"""Memory-bounded dense attention for long sequences (port of
``focused_attention_vit_tpu/ops/flash_attention.py`` and of the kernel it
reaches through ``ops/flash_attention_pallas.py``).

:func:`flash_attention` computes ``softmax(q k^T / sqrt(d)) v`` (no mask,
non-causal) on contiguous ``[B, h, S, d]`` tensors without ever holding a
``[B, h, S, S]`` tensor. It goes through one ``torch.autograd.Function``
whenever autograd records (grad enabled and q, k or v requiring grad);
otherwise it runs the lean forward, which writes no log-sum-exp. On a CUDA
tensor each part launches a hand-written kernel or raises; on a CPU tensor
it runs the kernel's plain version. There is no fallback from a kernel to a
plain version. The kernels take every head dim: one off their grid of
multiples of 8 is padded with zero columns (:func:`pad_head_dim`, which the
other ops' wrappers call too), and one past 256 runs the wide blocks of
``csrc/flash_wide.cuh`` at the slices :func:`wide_plan` chooses (the fused
op's kernels take the same plan).

- eval forward: ``csrc/flash_attention_fwd.cu``, launch count ``"fwd"``,
  plain version :func:`plain_flash_forward`, through the
  ``favit::flash_fwd`` operator (``ops/library.py``);
- training forward, which also writes ``lse = m + log l`` (f32
  ``[B, h, S]``): the same source, ``"fwd_train"``, the same plain version;
- backward (dq, dk, dv from q, k, v, out, lse and the cotangent): the three
  kernels of ``csrc/flash_attention_bwd.cu``, one count ``"bwd"`` a call,
  :func:`plain_flash_backward`.

The plain forward is the JAX package's ``_chunked_attention``: the online
softmax over key chunks with f32 running maximum, sum and accumulator and
one rounding to the input dtype. JAX pads the last chunk and masks the
padded keys to -inf; here the last chunk is simply shorter, which gives the
same maximum and the same sums. The plain backward is written out by the
formulas the backward kernels use, chunk by chunk over the keys, so that it
too runs at S = 3137 on the card.

:func:`dropout_attention_q_chunked` is long-S attention with dropout on the
attention weights. It is plain tensor code in the JAX package (a scan over
query chunks with rematerialisation) and so it is plain PyTorch here.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

FWD_KERNEL_SOURCE = "focused_attention_vit_tpu_torch/csrc/flash_attention_fwd.cu"
BWD_KERNEL_SOURCE = "focused_attention_vit_tpu_torch/csrc/flash_attention_bwd.cu"
# The kernels of every op take head dims that are multiples of
# HEAD_DIM_STEP: a TMA row stride, or a run of 16-byte copies, of d * 2
# bytes is then a multiple of 16 bytes. The wrappers pad any other head dim
# with zero columns (pad_head_dim) and run the kernel at the true head dim's
# scale. Up to d = 256 the dense bf16 kernels hold a whole row of d in one
# block, at one of a few tile widths; past it they split the output columns
# over blocks (csrc/flash_wide.cuh, wide_plan). The plain versions take any d.
HEAD_DIM_STEP = 8
DEFAULT_CHUNK = 512  # keys per step of the plain versions
WIDE_MIN_HEAD_DIM = 257  # the bf16 kernels' wide blocks from here on
WIDE_TILE = 64  # columns of the wide blocks' output tiles
# Output tiles a consumer warpgroup accumulates, at most (csrc/flash_wide.cuh
# kMaxTiles: 256 columns).
WIDE_MAX_TILES = 4
CARD_SMS = 132  # the H100's streaming multiprocessors (wide_plan)

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


_PTR, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# ... rows, s, d, is_bf16, scale, device, stream; then the wide plan
# (wide_args): the forward's slices and tiles, the backward's of dkv and dq.
_SIGNATURES = {
    "flash_attention_fwd":
        [_PTR] * 5 + [ctypes.c_longlong, _INT, _INT, _INT, _FLOAT, _INT,
                      _PTR] + [_INT] * 2,
    "flash_attention_bwd":
        [_PTR] * 10 + [ctypes.c_longlong, _INT, _INT, _INT, _FLOAT, _INT,
                       _PTR] + [_INT] * 4,
}


def _kernel(name: str):
    from focused_attention_vit_tpu_torch.utils import kernel_build

    fn = getattr(kernel_build.load(name), name)
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURES[name]
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
            f"flash op takes float32 or bfloat16 q/k/v of one dtype, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    if not (k.device == v.device == q.device):
        raise ValueError("q, k, v must be on one device")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash op runs on cpu or cuda, got {q.device}")
    if q.shape[2] < 1 or q.shape[0] * q.shape[1] < 1 or q.shape[3] < 1:
        raise ValueError(f"flash op needs B*h >= 1, S >= 1 and d >= 1, got "
                         f"{tuple(q.shape)}")
    _check_layout(q=q, k=k, v=v)


def _check_layout(**tensors: torch.Tensor) -> None:
    for name, x in tensors.items():
        if not x.is_contiguous():
            raise ValueError(f"flash op needs contiguous [B, h, S, d] {name}")


def _check_aligned(**tensors: torch.Tensor) -> None:
    """The kernels' 16-byte alignment, checked where they launch: a fake
    tensor that ``torch.export`` traces has no address."""
    for name, x in tensors.items():
        if x.data_ptr() % 16:
            raise ValueError(f"flash op needs 16-byte aligned {name}")


def _launch_args(q: torch.Tensor, d: int) -> list:
    """The kernels' arguments after the pointers: q is padded to the
    kernels' grid of head dims, d is the true head dim, whose scale the
    kernels apply."""
    b, h, s, d_grid = q.shape
    device = q.get_device()
    return [b * h, s, d_grid, int(q.dtype == torch.bfloat16), d ** -0.5,
            device, torch.cuda.current_stream(device).cuda_stream]


# --- the wide blocks' slice plan ---------------------------------------------


class WidePlan(NamedTuple):
    """How a wide kernel (``csrc/flash_wide.cuh``) covers a head dim."""

    slices: int  # blocks over the grid's y, each a slice of the output
    tiles: int  # 64-column output tiles a consumer warpgroup accumulates
    # The kernel's operations over the function's own: the forward's over
    # 4 S^2 d; dkv's and dq's shares of the backward's 10 S^2 d.
    factor: float

    @property
    def cols(self) -> int:
        """Output columns a consumer warpgroup accumulates."""
        return WIDE_TILE * self.tiles


def wide_plan(rows: int, s: int, d: int, kind: str) -> WidePlan:
    """The slice plan of a wide kernel (``kind`` ``"fwd"``, ``"dkv"`` or
    ``"dq"``) at ``rows`` heads, sequence length ``s`` and head dim ``d``
    (past 256, a multiple of 8). The forward's and dq's two consumer
    warpgroups split a slice's columns, dkv's each take all of them (one
    dk, one dv); a warpgroup holds at most ``WIDE_MAX_TILES`` 64-column
    tiles, so the slices are the fewest that cover d, and the tiles the
    fewest that cover it in that many slices. Every slice forms the logits
    (and dP) over all of d once: the forward does (slices + 1) / 2 times its
    4 S^2 d operations, dkv (4 slices + 4) / 10 and dq (4 slices + 2) / 10
    of the backward's 10 S^2 d. Where the grid would fill less than half of
    the card's ``CARD_SMS`` SMs, a plan of 2 tiles a warpgroup (more
    slices) is taken if all its blocks still fit one wave."""
    if kind not in ("fwd", "dkv", "dq"):
        raise ValueError(f"wide plan kind is fwd, dkv or dq, got {kind!r}")
    if d < WIDE_MIN_HEAD_DIM or d % HEAD_DIM_STEP:
        raise ValueError(f"the wide blocks take head dims past 256 that are "
                         f"multiples of {HEAD_DIM_STEP}, got {d}")
    ct = -(-d // WIDE_TILE)
    split = 1 if kind == "dkv" else 2
    slices = -(-ct // (split * WIDE_MAX_TILES))
    tiles = -(-ct // (split * slices))
    blocks = rows * -(-s // 64)
    if tiles > 2 and 2 * blocks * slices <= CARD_SMS:
        narrow = -(-ct // (split * 2))
        if blocks * narrow <= CARD_SMS:
            slices, tiles = narrow, 2
    factor = {"fwd": (slices + 1) / 2, "dkv": (4 * slices + 4) / 10,
              "dq": (4 * slices + 2) / 10}[kind]
    return WidePlan(slices, tiles, factor)


def wide_factor(rows: int, s: int, d: int, direction: str) -> float:
    """The operations the bf16 kernels do over the function's own at this
    shape: the forward's (``direction`` ``"fwd"``) or the backward's
    (``"bwd"``: dkv's and dq's shares); 1 up to d = 256, where whole rows
    form each logit once."""
    if d < WIDE_MIN_HEAD_DIM:
        return 1.0
    if direction == "fwd":
        return wide_plan(rows, s, d, "fwd").factor
    return (wide_plan(rows, s, d, "dkv").factor
            + wide_plan(rows, s, d, "dq").factor)


def wide_args(q: torch.Tensor, direction: str) -> list:
    """The wide plan's launch arguments for q (padded to the kernels' grid
    of head dims): the forward's slices and tiles, or dkv's and dq's; zeros
    where the kernels do not run the wide blocks (d <= 256, or f32)."""
    b, h, s, d = q.shape
    kinds = ("fwd",) if direction == "fwd" else ("dkv", "dq")
    if q.dtype != torch.bfloat16 or d < WIDE_MIN_HEAD_DIM:
        return [0] * (2 * len(kinds))
    args = []
    for kind in kinds:
        plan = wide_plan(b * h, s, d, kind)
        args += [plan.slices, plan.tiles]
    return args


def _check_launch(err: int, what: str, q: torch.Tensor) -> None:
    if err != 0:
        raise RuntimeError(
            f"{what} launch failed with CUDA error {err} "
            f"(shape {tuple(q.shape)}, {q.dtype})"
        )


# --- head dims off the kernels' grid -----------------------------------------


def pad_head_dim(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """x with zero columns appended along its head dim ``dim`` up to the
    next multiple of :data:`HEAD_DIM_STEP`, for a kernel; x itself when it
    is one. Zero columns leave every logit q . k unchanged, so with the true
    head dim's scale the weights, the dropout masks (keyed by row, query and
    key) and the first d columns of every result are those of the unpadded
    call; the columns past d of an output or a gradient are zeros."""
    pad = -x.shape[dim] % HEAD_DIM_STEP
    if not pad:
        return x
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, x.new_zeros(shape)], dim)


def unpad_head_dim(x: torch.Tensor, d: int, dim: int = -1) -> torch.Tensor:
    """The first d entries of a kernel's result along its head dim ``dim``,
    contiguous; x itself when it has d."""
    if x.shape[dim] == d:
        return x
    return x.narrow(dim, 0, d).contiguous()


# --- plain versions -------------------------------------------------------


def plain_flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        chunk: int = DEFAULT_CHUNK,
                        scale: float | None = None):
    """``(out, lse)``: attention on ``[B, h, S, d]`` by the online softmax
    over key chunks of ``chunk`` (f32 logits, running max ``m``, running
    sum ``l`` and accumulator; the weights stay f32 for the product with
    V), ``out`` rounded once to q's dtype, ``lse = m + log l`` f32
    ``[B, h, S]``. ``scale`` defaults to ``d**-0.5``."""
    b, h, s, d = q.shape
    scale = d ** -0.5 if scale is None else scale
    qf = q.float()
    m = qf.new_full((b, h, s), float("-inf"))
    l = qf.new_zeros(b, h, s)
    acc = qf.new_zeros(b, h, s, d)
    for j0 in range(0, k.shape[2], chunk):
        kb = k[:, :, j0:j0 + chunk].float()
        vb = v[:, :, j0:j0 + chunk].float()
        s_blk = torch.matmul(qf, kb.transpose(-1, -2)) * scale
        m_new = torch.maximum(m, s_blk.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s_blk - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.matmul(p, vb)
        m = m_new
    return (acc / l[..., None]).to(q.dtype), m + torch.log(l)


def plain_flash_backward(q, k, v, out, lse, g, chunk: int = DEFAULT_CHUNK,
                         scale: float | None = None):
    """``(dq, dk, dv)`` from the forward's ``out`` and ``lse`` and the
    cotangent ``g``, by the backward kernels' formulas, one key chunk at a
    time: ``p = exp(q k^T scale - lse)``, ``delta = rowsum(g * out)``,
    ``dv = p^T g``, ``dp = g v^T``, ``ds = p (dp - delta) scale``,
    ``dq = ds k``, ``dk = ds^T q``. Sums in f32, results rounded to the
    inputs' dtype; ``scale`` defaults to ``d**-0.5``."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    qf, gf = q.float(), g.float()
    delta = (gf * out.float()).sum(dim=-1, keepdim=True)
    lse = lse[..., None]
    dq = torch.zeros_like(qf)
    dk, dv = [], []
    for j0 in range(0, k.shape[2], chunk):
        kb = k[:, :, j0:j0 + chunk].float()
        vb = v[:, :, j0:j0 + chunk].float()
        p = torch.exp(torch.matmul(qf, kb.transpose(-1, -2)) * scale - lse)
        dv.append(torch.matmul(p.transpose(-1, -2), gf))
        ds = p * (torch.matmul(gf, vb.transpose(-1, -2)) - delta) * scale
        dq += torch.matmul(ds, kb)
        dk.append(torch.matmul(ds.transpose(-1, -2), qf))
    return (dq.to(q.dtype), torch.cat(dk, dim=2).to(k.dtype),
            torch.cat(dv, dim=2).to(v.dtype))


# --- kernels ----------------------------------------------------------------


def _launch_forward(q, k, v, save: bool):
    b, h, s, d = q.shape
    q, k, v = (pad_head_dim(x) for x in (q, k, v))
    _check_aligned(q=q, k=k, v=v)
    fn = _kernel("flash_attention_fwd")
    out = torch.empty_like(q)
    lse = (torch.empty(b, h, s, dtype=torch.float32, device=q.device)
           if save else None)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             None if lse is None else lse.data_ptr(), *_launch_args(q, d),
             *wide_args(q, "fwd"))
    _check_launch(err, "flash_attention_fwd", q)
    _count("fwd_train" if save else "fwd")
    return unpad_head_dim(out, d), lse


def flash_forward_train(q, k, v, chunk: int = DEFAULT_CHUNK):
    """The training forward: ``(out, lse)`` as :func:`plain_flash_forward`;
    on a CUDA tensor the kernel writes them, on a CPU tensor the plain
    version does (``chunk`` is the plain version's)."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return plain_flash_forward(q, k, v, chunk)
    return _launch_forward(q, k, v, save=True)


def flash_backward(q, k, v, out, lse, g, chunk: int = DEFAULT_CHUNK):
    """``(dq, dk, dv)`` as :func:`plain_flash_backward`; on a CUDA tensor
    the backward kernels compute them, on a CPU tensor the plain version."""
    _check(q, k, v)
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
        return plain_flash_backward(q, k, v, out, lse, g, chunk)
    d = q.shape[3]
    q, k, v, out, g = (pad_head_dim(x) for x in (q, k, v, out, g))
    _check_aligned(q=q, k=k, v=v, out=out, g=g, lse=lse)
    fn = _kernel("flash_attention_bwd")
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    delta = torch.empty_like(lse)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr(), g.data_ptr(), dq.data_ptr(), dk.data_ptr(),
             dv.data_ptr(), delta.data_ptr(), *_launch_args(q, d),
             *wide_args(q, "bwd"))
    _check_launch(err, "flash_attention_bwd", q)
    _count("bwd")
    return tuple(unpad_head_dim(x, d) for x in (dq, dk, dv))


class _FlashFunction(torch.autograd.Function):
    """The flash op under autograd: saves q, k, v, out and lse, nothing of
    size S x S."""

    @staticmethod
    def forward(ctx, q, k, v, chunk):
        out, lse = flash_forward_train(q, k, v, chunk)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.chunk = chunk
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        # The cotangent may arrive strided (the model transposes the
        # output) or in another dtype; the kernels take q's, contiguous.
        g = g.to(q.dtype).contiguous()
        dq, dk, dv = flash_backward(q, k, v, out, lse, g, ctx.chunk)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """Dense attention on contiguous ``[B, h, S, d]`` q/k/v of one dtype
    (f32 or bf16); returns ``[B, h, S, d]`` in that dtype. ``chunk`` is the
    key chunk of the plain versions, which run on a CPU tensor; the CUDA
    kernels have their own tiles."""
    _check(q, k, v)
    if torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad
    ):
        return _FlashFunction.apply(q, k, v, chunk)
    # The eval forward: the favit::flash_fwd operator (ops/library.py).
    return torch.ops.favit.flash_fwd(q, k, v, chunk)


# --- attention-weight dropout at long S --------------------------------------


def _dropout_chunk(qblk, k, v, rate: float, seed: int) -> torch.Tensor:
    """One query chunk: full-key f32 logits, f32 softmax, inverted dropout
    from a generator seeded with ``seed`` (so that the recomputation in the
    backward draws the same mask), weights cast to v's dtype, P V."""
    d = qblk.shape[-1]
    logits = torch.matmul(qblk.float(), k.float().transpose(-1, -2)) * (
        d ** -0.5)
    w = torch.softmax(logits, dim=-1)
    if rate > 0.0:
        gen = torch.Generator(device=w.device).manual_seed(seed)
        keep = torch.empty(w.shape, dtype=torch.bool,
                           device=w.device).bernoulli_(1.0 - rate,
                                                       generator=gen)
        w = torch.where(keep, w / (1.0 - rate), 0.0)
    return torch.matmul(w.to(v.dtype), v)


def dropout_attention_q_chunked(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, rate: float,
    generator: torch.Generator | None = None, chunk: int = 256,
) -> torch.Tensor:
    """Attention with dropout on the attention weights at long S, computed
    in query chunks of ``chunk``: memory is O(B h chunk S), never the
    ``[B, h, S, S]`` tensor. Per chunk: full-key logits, softmax, inverted
    dropout, P V. Each chunk's mask comes from a seed drawn from
    ``generator`` (a CPU generator; torch's default when None), so a seeded
    generator gives the same output, and under autograd each chunk is
    checkpointed: its logits are recomputed in the backward, with the same
    mask, instead of being saved. ``rate=0`` is exactly dense attention.
    Semantics match the materialised dropout branch in distribution, not
    in the realised mask."""
    rate = float(rate)
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    s = q.shape[2]
    n = -(-s // chunk)
    seeds = [0] * n
    if rate > 0.0:
        seeds = torch.randint(0, 2**62, (n,), generator=generator).tolist()
    remat = torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad
    )
    outs = []
    for i in range(n):
        qblk = q[:, :, i * chunk:(i + 1) * chunk]
        if remat:
            # The mask comes from the explicit seed, so torch's global RNG
            # state need not be saved and restored around the chunk.
            outs.append(checkpoint(_dropout_chunk, qblk, k, v, rate,
                                   seeds[i], use_reentrant=False,
                                   preserve_rng_state=False))
        else:
            outs.append(_dropout_chunk(qblk, k, v, rate, seeds[i]))
    return torch.cat(outs, dim=2)
