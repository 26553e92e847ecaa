"""ImageFolder-style ImageNet subset loader (port of
``focused_attention_vit_tpu/data/imagenet.py``).

Reads ``<root>/{train,val}/<class_name>/*.{jpg,jpeg,png,bmp,webp}`` from a
local folder, decodes each image with Pillow to RGB uint8 at a fixed base
resolution (bilinear resize), and returns the dict contract of
:mod:`.datasets`, so the train and eval steps take it unchanged. Classes are
the sorted class directory names. Nothing is downloaded: a missing folder
raises ``FileNotFoundError`` naming it, and Pillow is imported only to
decode, so the error names Pillow where it is not installed.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, Optional

import numpy as np

logger = logging.getLogger(__name__)

_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def _scan_split(split_dir: str):
    classes = sorted(d for d in os.listdir(split_dir)
                     if os.path.isdir(os.path.join(split_dir, d)))
    files, labels = [], []
    for idx, cname in enumerate(classes):
        cdir = os.path.join(split_dir, cname)
        for f in sorted(os.listdir(cdir)):
            if f.lower().endswith(_EXTS):
                files.append(os.path.join(cdir, f))
                labels.append(idx)
    return classes, files, np.asarray(labels, dtype=np.int32)


def _decode(files, base_size: int) -> np.ndarray:
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "--dataset imagenet decodes images with Pillow (PIL), which is "
            "not installed") from e

    out = np.zeros((len(files), base_size, base_size, 3), dtype=np.uint8)
    for i, path in enumerate(files):
        with Image.open(path) as im:
            im = im.convert("RGB").resize((base_size, base_size),
                                          Image.BILINEAR)
            out[i] = np.asarray(im, dtype=np.uint8)
    return out


def load_imagenet_subset(data_dir: str = "./data/imagenet",
                         base_size: int = 64,
                         subset_size: Optional[int] = None,
                         seed: int = 42) -> Dict[str, Any]:
    """Load an ImageFolder tree into host arrays at ``base_size`` squared
    (the train and eval steps resize to the model's ``img_size``). Without
    ``val/`` the first tenth of the train files is the validation split; a
    ``subset_size`` draws that many train images and a fifth as many
    validation images with a numpy generator seeded ``seed``."""
    train_dir = os.path.join(data_dir, "train")
    val_dir = os.path.join(data_dir, "val")
    if not os.path.isdir(train_dir):
        raise FileNotFoundError(
            f"No ImageFolder layout under {data_dir} (expected train/ and "
            "val/ class subdirectories)")

    classes, train_files, train_labels = _scan_split(train_dir)
    if os.path.isdir(val_dir):
        _, val_files, val_labels = _scan_split(val_dir)
    else:
        val_files = train_files[:len(train_files) // 10]
        val_labels = train_labels[:len(train_labels) // 10]

    if subset_size is not None:
        rng = np.random.default_rng(seed)
        tr = rng.permutation(len(train_files))[:subset_size]
        te = rng.permutation(len(val_files))[:max(1, subset_size // 5)]
        train_files = [train_files[i] for i in tr]
        train_labels = train_labels[tr]
        val_files = [val_files[i] for i in te]
        val_labels = val_labels[te]

    logger.info("ImageNet subset: %d train / %d val images, %d classes",
                len(train_files), len(val_files), len(classes))
    return {
        "train_images": _decode(train_files, base_size),
        "train_labels": train_labels,
        "test_images": _decode(val_files, base_size),
        "test_labels": val_labels,
        "class_names": classes,
        "num_classes": len(classes),
        "synthetic": False,
    }


def get_sample_batch(data: Optional[Dict[str, Any]] = None,
                     batch_size: int = 8, img_size: int = 32, seed: int = 0):
    """The first ``batch_size`` train images and labels of ``data``, or a
    random uint8 batch drawn from a numpy generator seeded ``seed``."""
    if data is not None:
        return (np.asarray(data["train_images"][:batch_size]),
                np.asarray(data["train_labels"][:batch_size]))
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, size=(batch_size, img_size, img_size, 3),
                          dtype=np.uint8)
    labels = rng.integers(0, 10, size=(batch_size,)).astype(np.int32)
    return images, labels
