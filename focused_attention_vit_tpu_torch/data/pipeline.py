"""Input preparation and host-side batch iteration (port of
``focused_attention_vit_tpu/data/pipeline.py``).

Transform semantics are the reference CIFAR-10 pipeline's: train
RandomCrop(32, padding=4, zero fill) -> RandomHorizontalFlip -> Resize
(bilinear) -> scale to [0, 1] -> Normalize; eval Resize -> Normalize. All
pixel math runs on the images' device. The random crop offsets and flips are
drawn by :func:`draw_augment_params` from an explicit ``torch.Generator``,
and :func:`augment_train_batch` also takes them as arguments, so a test can
hand it the draws of another framework.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np
import torch
import torch.nn.functional as F

CIFAR10_MEAN = (0.4914, 0.4822, 0.4465)
CIFAR10_STD = (0.2470, 0.2435, 0.2616)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


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


def draw_augment_params(batch: int, generator: torch.Generator | None,
                        crop_padding: int = 4, device=None):
    """``(offsets, flips)``: int64 ``[B, 2]`` crop offsets (row, column) in
    ``[0, 2 * crop_padding]`` and bool ``[B]`` flips with p=0.5, drawn from
    ``generator`` on its device (the default generator when None)."""
    if generator is not None:
        device = generator.device
    offsets = torch.randint(0, 2 * crop_padding + 1, (batch, 2),
                            generator=generator, device=device)
    flips = torch.rand(batch, generator=generator, device=device) < 0.5
    return offsets, flips


def augment_train_batch(
    images_u8: torch.Tensor,
    generator: torch.Generator | None,
    img_size: int,
    crop_padding: int = 4,
    mean=CIFAR10_MEAN,
    std=CIFAR10_STD,
    dtype: torch.dtype = torch.float32,
    *,
    offsets: torch.Tensor | None = None,
    flips: torch.Tensor | None = None,
) -> torch.Tensor:
    """Random zero-pad crop, horizontal flip, resize and normalise, on the
    images' device. The crop runs at the native resolution before the
    resize, as in the reference. ``offsets``/``flips`` (see
    :func:`draw_augment_params`) replace the draw from ``generator``."""
    b, h, w, _ = images_u8.shape
    if offsets is None or flips is None:
        offsets, flips = draw_augment_params(b, generator, crop_padding,
                                             images_u8.device)
    offsets = offsets.to(images_u8.device)
    flips = flips.to(images_u8.device)

    x = images_u8.to(dtype) / 255.0
    p = crop_padding
    xp = F.pad(x, (0, 0, p, p, p, p))  # zero fill of H and W
    iy = offsets[:, 0:1] + torch.arange(h, device=x.device)  # [B, h]
    ix = offsets[:, 1:2] + torch.arange(w, device=x.device)  # [B, w]
    rows = torch.arange(b, device=x.device)[:, None, None]
    x = xp[rows, iy[:, :, None], ix[:, None, :]]  # [B, h, w, C]
    x = torch.where(flips[:, None, None, None], x.flip(2), x)
    x = _resize(x, img_size)
    return _normalize(x, mean, std)


def batch_iterator(
    images: np.ndarray,
    labels: np.ndarray,
    batch_size: int,
    *,
    shuffle: bool,
    rng: np.random.Generator | None = None,
    drop_last: bool = True,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Host-side batch slicer over uint8 arrays (numpy, as in JAX).
    Training drops the last partial batch; evaluation uses
    :func:`padded_eval_batches`."""
    n = len(images)
    idx = np.arange(n)
    if shuffle:
        (rng or np.random.default_rng()).shuffle(idx)
    end = n - (n % batch_size) if drop_last else n
    for start in range(0, end, batch_size):
        sel = idx[start:start + batch_size]
        yield images[sel], labels[sel]


def padded_eval_batches(
    images: np.ndarray,
    labels: np.ndarray,
    batch_size: int,
) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Fixed-shape eval batches with a validity mask: the final partial
    batch is padded by repeating example 0, and the mask zeroes the padded
    entries out of the metric sums."""
    n = len(images)
    for start in range(0, n, batch_size):
        sel = np.arange(start, min(start + batch_size, n))
        pad = batch_size - len(sel)
        mask = np.ones(batch_size, dtype=np.float32)
        if pad:
            mask[len(sel):] = 0.0
            sel = np.concatenate([sel, np.zeros(pad, dtype=sel.dtype)])
        yield images[sel], labels[sel], mask
