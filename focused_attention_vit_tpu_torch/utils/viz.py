"""Plots of sample images and of one image's patches (port of
``focused_attention_vit_tpu/utils/viz.py``).

matplotlib is imported only when a plot is made, with the ``Agg`` backend,
so training without ``--visualize`` never needs it; where it is not
installed the error names it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

CIFAR10_MEAN = (0.4914, 0.4822, 0.4465)
CIFAR10_STD = (0.2470, 0.2435, 0.2616)


def _pyplot():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(
            "--visualize draws with matplotlib, which is not installed"
        ) from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _denormalize(images: np.ndarray, mean, std) -> np.ndarray:
    return np.clip(images * np.asarray(std) + np.asarray(mean), 0, 1)


def _finish(plt, fig, save_path: Optional[str]):
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=120)
        plt.close(fig)
        return save_path
    return fig


def visualize_images(images, labels: Optional[Sequence[int]] = None,
                     class_names: Optional[Sequence[str]] = None,
                     num_images: int = 16, mean=CIFAR10_MEAN,
                     std=CIFAR10_STD, save_path: Optional[str] = None):
    """A grid of the first ``num_images`` normalised NHWC images,
    denormalised, titled by class; saved to ``save_path`` (returned) or
    returned as a figure."""
    plt = _pyplot()
    images = _denormalize(np.asarray(images)[:num_images], mean, std)
    n = len(images)
    cols = int(np.ceil(np.sqrt(n)))
    rows = int(np.ceil(n / cols))
    fig, axes = plt.subplots(rows, cols, figsize=(2 * cols, 2 * rows))
    axes = np.atleast_1d(axes).reshape(-1)
    for i, ax in enumerate(axes):
        ax.axis("off")
        if i < n:
            ax.imshow(images[i])
            if labels is not None:
                label = int(labels[i])
                ax.set_title(class_names[label] if class_names is not None
                             else str(label), fontsize=8)
    return _finish(plt, fig, save_path)


def visualize_patches(image, patch_size: int, mean=CIFAR10_MEAN,
                      std=CIFAR10_STD, save_path: Optional[str] = None):
    """One normalised NHWC image as a grid of its ``patch_size`` patches."""
    plt = _pyplot()
    image = _denormalize(np.asarray(image), mean, std)
    g = image.shape[0] // patch_size
    fig, axes = plt.subplots(g, g, figsize=(g, g))
    axes = np.atleast_2d(axes)
    for i in range(g):
        for j in range(g):
            axes[i, j].imshow(image[i * patch_size:(i + 1) * patch_size,
                                    j * patch_size:(j + 1) * patch_size])
            axes[i, j].axis("off")
    return _finish(plt, fig, save_path)
