"""Patch extraction (port of ``focused_attention_vit_tpu/ops/patch_embed.py``).

Images are NHWC. Patches are cut in row-major order and each is flattened in
``(p1, p2, c)`` order -- the reference's
``Rearrange('b c (h p1) (w p2) -> b (h w) (p1 p2 c)')`` -- so the weights of
the reference's patch Linear line up.
"""

from __future__ import annotations

import torch


def extract_patches(images: torch.Tensor, patch_size: int) -> torch.Tensor:
    """``[B, H, W, C]`` -> ``[B, (H/p)(W/p), p*p*C]``."""
    b, h, w, c = images.shape
    p = patch_size
    if h % p or w % p:
        raise ValueError(f"patch_size {p} must divide image dims {(h, w)}")
    gh, gw = h // p, w // p
    x = images.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, p * p * c)
