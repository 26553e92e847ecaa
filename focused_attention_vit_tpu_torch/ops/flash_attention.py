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
plain version.

- eval forward: ``csrc/flash_attention_fwd.cu``, launch count ``"fwd"``,
  plain version :func:`plain_flash_forward`;
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

import torch
from torch.utils.checkpoint import checkpoint

FWD_KERNEL_SOURCE = "focused_attention_vit_tpu_torch/csrc/flash_attention_fwd.cu"
BWD_KERNEL_SOURCE = "focused_attention_vit_tpu_torch/csrc/flash_attention_bwd.cu"
# The kernels' instantiations; the plain versions take any head dim.
HEAD_DIMS = (16, 32, 64, 128)
DEFAULT_CHUNK = 512  # keys per step of the plain versions

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
_SIGNATURES = {
    "flash_attention_fwd":
        [_PTR] * 5 + [ctypes.c_longlong, _INT, _INT, _INT, _FLOAT, _INT,
                      _PTR],
    "flash_attention_bwd":
        [_PTR] * 10 + [ctypes.c_longlong, _INT, _INT, _INT, _FLOAT, _INT,
                       _PTR],
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
    if q.shape[2] < 1 or q.shape[0] * q.shape[1] < 1:
        raise ValueError(f"flash op needs B*h >= 1 and S >= 1, got "
                         f"{tuple(q.shape)}")
    if q.device.type == "cuda" and q.shape[3] not in HEAD_DIMS:
        raise ValueError(
            f"the flash kernels support head dims {HEAD_DIMS}, got "
            f"{q.shape[3]}"
        )
    _check_layout(q=q, k=k, v=v)


def _check_layout(**tensors: torch.Tensor) -> None:
    for name, x in tensors.items():
        if not x.is_contiguous():
            raise ValueError(f"flash op needs contiguous [B, h, S, d] {name}")
        if x.device.type == "cuda" and x.data_ptr() % 16:
            raise ValueError(f"flash op needs 16-byte aligned {name}")


def _launch_args(q: torch.Tensor) -> list:
    b, h, s, d = q.shape
    device = q.get_device()
    return [b * h, s, d, int(q.dtype == torch.bfloat16), d ** -0.5, device,
            torch.cuda.current_stream(device).cuda_stream]


def _check_launch(err: int, what: str, q: torch.Tensor) -> None:
    if err != 0:
        raise RuntimeError(
            f"{what} launch failed with CUDA error {err} "
            f"(shape {tuple(q.shape)}, {q.dtype})"
        )


# --- plain versions -------------------------------------------------------


def plain_flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        chunk: int = DEFAULT_CHUNK):
    """``(out, lse)``: attention on ``[B, h, S, d]`` by the online softmax
    over key chunks of ``chunk`` (f32 logits, running max ``m``, running
    sum ``l`` and accumulator; the weights stay f32 for the product with
    V), ``out`` rounded once to q's dtype, ``lse = m + log l`` f32
    ``[B, h, S]``."""
    b, h, s, d = q.shape
    scale = d ** -0.5
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


def plain_flash_backward(q, k, v, out, lse, g, chunk: int = DEFAULT_CHUNK):
    """``(dq, dk, dv)`` from the forward's ``out`` and ``lse`` and the
    cotangent ``g``, by the backward kernels' formulas, one key chunk at a
    time: ``p = exp(q k^T scale - lse)``, ``delta = rowsum(g * out)``,
    ``dv = p^T g``, ``dp = g v^T``, ``ds = p (dp - delta) scale``,
    ``dq = ds k``, ``dk = ds^T q``. Sums in f32, results rounded to the
    inputs' dtype."""
    d = q.shape[-1]
    scale = d ** -0.5
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
    b, h, s, _ = q.shape
    fn = _kernel("flash_attention_fwd")
    out = torch.empty_like(q)
    lse = (torch.empty(b, h, s, dtype=torch.float32, device=q.device)
           if save else None)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             None if lse is None else lse.data_ptr(), *_launch_args(q))
    _check_launch(err, "flash_attention_fwd", q)
    _count("fwd_train" if save else "fwd")
    return out, lse


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
    fn = _kernel("flash_attention_bwd")
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    delta = torch.empty_like(lse)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr(), g.data_ptr(), dq.data_ptr(), dk.data_ptr(),
             dv.data_ptr(), delta.data_ptr(), *_launch_args(q))
    _check_launch(err, "flash_attention_bwd", q)
    _count("bwd")
    return dq, dk, dv


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
    if q.device.type == "cpu":
        return plain_flash_forward(q, k, v, chunk)[0]
    return _launch_forward(q, k, v, save=False)[0]


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
