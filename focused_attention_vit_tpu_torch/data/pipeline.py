"""Eval-time input preparation (port of the eval half of
``focused_attention_vit_tpu/data/pipeline.py``): uint8 NHWC images are
scaled to [0, 1], resized bilinearly to the model's size and normalised,
all on the images' device."""

from __future__ import annotations

import torch
import torch.nn.functional as F

CIFAR10_MEAN = (0.4914, 0.4822, 0.4465)
CIFAR10_STD = (0.2470, 0.2435, 0.2616)


def _normalize(x: torch.Tensor, mean, std) -> torch.Tensor:
    mean = torch.tensor(mean, dtype=x.dtype, device=x.device)
    std = torch.tensor(std, dtype=x.dtype, device=x.device)
    return (x - mean) / std


def _resize(x: torch.Tensor, img_size: int) -> torch.Tensor:
    """Bilinear NHWC resize with half-pixel centres and no antialiasing,
    as ``jax.image.resize(..., "bilinear", antialias=False)``."""
    if x.shape[1] == img_size and x.shape[2] == img_size:
        return x
    y = F.interpolate(
        x.permute(0, 3, 1, 2), size=(img_size, img_size), mode="bilinear",
        align_corners=False, antialias=False,
    )
    return y.permute(0, 2, 3, 1)


def prepare_eval_batch(
    images_u8: torch.Tensor,
    img_size: int,
    mean=CIFAR10_MEAN,
    std=CIFAR10_STD,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """uint8 ``[B, h, w, C]`` -> normalised ``[B, img_size, img_size, C]``
    of ``dtype``."""
    x = images_u8.to(dtype) / 255.0
    x = _resize(x, img_size)
    return _normalize(x, mean, std)
