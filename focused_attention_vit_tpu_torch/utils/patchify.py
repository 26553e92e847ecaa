"""Patchify and unpatchify (port of
``focused_attention_vit_tpu/utils/patchify.py``).

Plain reshapes and permutes in both directions, for one image or a batch,
NHWC. The flattening order is :func:`~..ops.patch_embed.extract_patches`'s,
``(p1 p2 c)``.
"""

from __future__ import annotations

import torch

from focused_attention_vit_tpu_torch.ops.patch_embed import extract_patches


def patchify_image(image: torch.Tensor, patch_size: int) -> torch.Tensor:
    """``[H, W, C]`` or ``[B, H, W, C]`` -> ``[(B,) N, p*p*C]``."""
    single = image.dim() == 3
    out = extract_patches(image[None] if single else image, patch_size)
    return out[0] if single else out


def unpatchify_image(patches: torch.Tensor, img_size: int, patch_size: int,
                     channels: int = 3) -> torch.Tensor:
    """The inverse of :func:`patchify_image`, for a square image."""
    single = patches.dim() == 2
    if single:
        patches = patches[None]
    b = patches.shape[0]
    g = img_size // patch_size
    x = patches.reshape(b, g, g, patch_size, patch_size, channels)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, img_size, img_size, channels)
    return x[0] if single else x
