"""Dense multi-head attention primitives (port of
``focused_attention_vit_tpu/ops/attention.py``): scaled dot-product with the
per-head scale ``head_dim**-0.5``, softmax over keys, no causal mask.

:func:`multi_head_attention` dispatches by sequence length: at
``FLASH_MIN_SEQ_LEN`` and above it takes the flash op of
:mod:`.flash_attention` on any device (the CUDA kernels on a CUDA tensor,
the plain online softmax on a CPU tensor), below it the materialised form.
The JAX package takes its flash kernel only on its accelerator backend; the
two forms agree to rounding, so the port's rule needs no backend test.
"""

from __future__ import annotations

import torch

# Sequence length at or above which the flash op replaces the materialised
# [S, S] scores.
FLASH_MIN_SEQ_LEN = 512


def scaled_dot_product_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    mask: torch.Tensor | None = None, scale: float | None = None,
) -> torch.Tensor:
    """Attention over ``[..., S, d]`` q and ``[..., T, d]`` k, v: f32
    logits, f32 softmax, weights cast to v's dtype for the product with V.

    ``mask`` is an optional boolean or 0/1 tensor broadcastable to
    ``[..., S, T]``; zero entries are filled with the most negative finite
    f32 before the softmax. ``scale`` defaults to ``d**-0.5``."""
    d = q.shape[-1]
    scale = d ** -0.5 if scale is None else scale
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        logits = torch.where(mask == 0, torch.finfo(logits.dtype).min, logits)
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(weights, v)


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """``[B, S, D] -> [B, h, S, d]`` with contiguous head slices of D (a
    view)."""
    b, s, d = x.shape
    return x.view(b, s, num_heads, d // num_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """``[B, h, S, d] -> [B, S, D]``."""
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def qkv_split(qkv: torch.Tensor, num_heads: int):
    """Split a fused qkv projection ``[B, S, 3D]``, ordered ``[q | k | v]``
    with contiguous heads inside each, into q, k, v ``[B, h, S, d]``
    (views)."""
    b, s, three_d = qkv.shape
    d = three_d // 3
    return qkv.view(b, s, 3, num_heads, d // num_heads).permute(2, 0, 3, 1, 4)


def multi_head_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    use_flash: bool | None = None,
) -> torch.Tensor:
    """Attention core on ``[B, h, S, d]`` inputs, ``[B, h, S, d]`` out.
    ``use_flash=None`` takes the flash op from ``FLASH_MIN_SEQ_LEN`` tokens
    on; True or False forces either path. The flash op needs contiguous
    inputs, so strided head views are copied for it.

    The JAX package checkpoints the materialised form so that autodiff
    recomputes the ``[S, S]`` weights instead of saving them. That changes
    memory, not numbers; here autograd keeps the weights, and only
    sequences below ``FLASH_MIN_SEQ_LEN`` come this way by default."""
    if use_flash is None:
        use_flash = q.shape[-2] >= FLASH_MIN_SEQ_LEN
    if use_flash:
        from focused_attention_vit_tpu_torch.ops.flash_attention import (
            flash_attention,
        )

        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    return scaled_dot_product_attention(q, k, v)
