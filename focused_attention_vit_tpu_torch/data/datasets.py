"""Dataset loading: CIFAR-10/100 from disk, synthetic fallback (port of
``focused_attention_vit_tpu/data/datasets.py``, pure numpy, unchanged in
behaviour: the same arrays for the same arguments).

The reference downloads CIFAR-10 through torchvision
(utils/data_utils.py:106-120). This environment has no network egress and
no torchvision, so the loader reads the standard CIFAR binary formats from
``data_dir`` when present (the same files torchvision would have cached)
and otherwise falls back to a clearly-labelled deterministic synthetic
dataset with learnable class structure, so every pipeline stays runnable
end-to-end.

Returned arrays are NHWC uint8, the host-side format of the on-device
augmentation pipeline (see data/pipeline.py).
"""

from __future__ import annotations

import logging
import os
import pickle
import tarfile
from typing import Any, Dict, Optional

import numpy as np

logger = logging.getLogger(__name__)

# Reference class names (utils/data_utils.py:148-150).
CIFAR10_CLASS_NAMES = [
    "airplane", "automobile", "bird", "cat", "deer",
    "dog", "frog", "horse", "ship", "truck",
]


def _maybe_extract(data_dir: str, archive: str, marker: str) -> None:
    path = os.path.join(data_dir, archive)
    if os.path.exists(path) and not os.path.exists(os.path.join(data_dir, marker)):
        with tarfile.open(path, "r:gz") as tf:
            tf.extractall(data_dir)


def _load_cifar10_from_disk(data_dir: str) -> Optional[Dict[str, np.ndarray]]:
    _maybe_extract(data_dir, "cifar-10-python.tar.gz", "cifar-10-batches-py")
    base = os.path.join(data_dir, "cifar-10-batches-py")
    if not os.path.isdir(base):
        return None

    def read(fname):
        with open(os.path.join(base, fname), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        images = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        return images, np.asarray(d[b"labels"], dtype=np.int32)

    train = [read(f"data_batch_{i}") for i in range(1, 6)]
    test_x, test_y = read("test_batch")
    return {
        "train_images": np.concatenate([t[0] for t in train]),
        "train_labels": np.concatenate([t[1] for t in train]),
        "test_images": test_x,
        "test_labels": test_y,
    }


def _load_cifar100_from_disk(data_dir: str) -> Optional[Dict[str, np.ndarray]]:
    _maybe_extract(data_dir, "cifar-100-python.tar.gz", "cifar-100-python")
    base = os.path.join(data_dir, "cifar-100-python")
    if not os.path.isdir(base):
        return None

    def read(fname):
        with open(os.path.join(base, fname), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        images = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        return images, np.asarray(d[b"fine_labels"], dtype=np.int32)

    train_x, train_y = read("train")
    test_x, test_y = read("test")
    return {
        "train_images": train_x,
        "train_labels": train_y,
        "test_images": test_x,
        "test_labels": test_y,
    }


def _synthetic_cifar(
    num_classes: int, n_train: int, n_test: int, seed: int = 0
) -> Dict[str, np.ndarray]:
    """Deterministic synthetic stand-in with learnable per-class structure.

    Each class gets a characteristic low-frequency color pattern plus
    noise; a small model can overfit it, which is what the smoke-train and
    benchmark paths need.
    """
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, 32), np.linspace(0, 1, 32), indexing="ij")
    protos = []
    for c in range(num_classes):
        phase = 2 * np.pi * c / num_classes
        pattern = np.stack(
            [
                np.sin(2 * np.pi * (yy * (1 + c % 3)) + phase),
                np.cos(2 * np.pi * (xx * (1 + c % 4)) + phase),
                np.sin(2 * np.pi * (yy + xx) * (1 + c % 2) + phase),
            ],
            axis=-1,
        )
        protos.append(pattern)
    protos = np.stack(protos)  # [C, 32, 32, 3]

    def make(n, seed_off):
        r = np.random.default_rng(seed + seed_off)
        labels = r.integers(0, num_classes, size=n).astype(np.int32)
        noise = r.normal(0, 0.35, size=(n, 32, 32, 3))
        imgs = 0.5 + 0.25 * protos[labels] + noise * 0.15
        return (np.clip(imgs, 0, 1) * 255).astype(np.uint8), labels

    train_x, train_y = make(n_train, 1)
    test_x, test_y = make(n_test, 2)
    return {
        "train_images": train_x,
        "train_labels": train_y,
        "test_images": test_x,
        "test_labels": test_y,
    }


def load_dataset(
    name: str = "cifar10",
    data_dir: str = "./data",
    subset_size: Optional[int] = None,
    seed: int = 42,
    synthetic_fallback: bool = True,
    synthetic_sizes: tuple[int, int] = (50_000, 10_000),
) -> Dict[str, Any]:
    """Load a dataset by name.

    Mirrors the reference loader's contract (utils/data_utils.py:83-156):
    optional ``subset_size`` shrinks the train split and uses
    ``subset_size // 5`` test examples (reference: utils/data_utils.py:121-126).

    Returns a dict with uint8 NHWC image arrays, int32 labels, class names
    and ``num_classes``; plus ``synthetic: bool``.
    """
    name = name.lower()
    if name == "cifar10":
        data = _load_cifar10_from_disk(data_dir)
        num_classes, class_names = 10, CIFAR10_CLASS_NAMES
    elif name == "cifar100":
        data = _load_cifar100_from_disk(data_dir)
        num_classes, class_names = 100, [f"class_{i}" for i in range(100)]
    else:
        raise ValueError(f"Unknown dataset: {name}")

    synthetic = data is None
    if synthetic:
        if not synthetic_fallback:
            raise FileNotFoundError(
                f"{name} not found under {data_dir} and no network egress; "
                "place the standard python-format archive there or enable "
                "synthetic_fallback."
            )
        logger.warning(
            "%s not found under %s — using DETERMINISTIC SYNTHETIC data "
            "(shapes/classes match; accuracies are not comparable to real %s).",
            name, data_dir, name,
        )
        data = _synthetic_cifar(num_classes, *synthetic_sizes, seed=0)

    if subset_size is not None:
        rng = np.random.default_rng(seed)
        tr = rng.permutation(len(data["train_images"]))[:subset_size]
        te = rng.permutation(len(data["test_images"]))[: max(1, subset_size // 5)]
        data = {
            "train_images": data["train_images"][tr],
            "train_labels": data["train_labels"][tr],
            "test_images": data["test_images"][te],
            "test_labels": data["test_labels"][te],
        }

    return {
        **data,
        "class_names": class_names,
        "num_classes": num_classes,
        "synthetic": synthetic,
    }


def load_cifar10(**kw) -> Dict[str, Any]:
    return load_dataset("cifar10", **kw)


def load_cifar100(**kw) -> Dict[str, Any]:
    return load_dataset("cifar100", **kw)
