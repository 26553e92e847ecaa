"""Batch inference (port of ``focused_attention_vit_tpu/infer.py``).

A :class:`Predictor` serves uint8 NHWC images at one fixed device batch:
requests of any size are cut into ``batch_size`` chunks, the last one padded
by repeating its first image and the padding dropped on the way out.
"""

from __future__ import annotations

import os
from collections import deque
from pathlib import Path
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from focused_attention_vit_tpu_torch.data.pipeline import (
    CIFAR10_MEAN,
    CIFAR10_STD,
    prepare_eval_batch,
)


def padded_predict_proba(
    fwd: Callable[[np.ndarray], torch.Tensor], batch_size: int,
    num_classes: int, images_u8: np.ndarray, *, max_in_flight: int = 2,
) -> np.ndarray:
    """Run a fixed-batch function over a request of any size.

    ``fwd`` maps one uint8 ``[batch_size, h, w, C]`` array to device
    probabilities. Up to ``max_in_flight`` chunks are enqueued before the
    oldest result is copied back, so the host prepares the next chunk while
    the device works.
    """
    n = len(images_u8)
    if n == 0:
        return np.zeros((0, num_classes), dtype=np.float32)
    pending: deque = deque()  # (device probs, pad)
    out = []

    def collect():
        dev, pad = pending.popleft()
        probs = dev.cpu().numpy()
        out.append(probs[: len(probs) - pad] if pad else probs)

    for start in range(0, n, batch_size):
        chunk = images_u8[start : start + batch_size]
        pad = batch_size - len(chunk)
        if pad:
            chunk = np.concatenate([chunk, np.repeat(chunk[:1], pad, axis=0)])
        pending.append((fwd(chunk), pad))
        if len(pending) >= max(1, max_in_flight):
            collect()
    while pending:
        collect()
    return np.concatenate(out)[:n]


def load_state_dict(path, in_proj_names: bool | None = None
                    ) -> Dict[str, torch.Tensor]:
    """Weights for :class:`~.models.VisionTransformer` or
    :class:`~.models.VisionTransformerMHLA` from a ``.pt`` / ``.pth`` state
    dict in the reference torch layout, or a ``.npz`` of ``/``-joined JAX
    param paths (converted by :mod:`.convert.from_jax`, which reads
    ``in_proj_names``)."""
    path = Path(path)
    if path.suffix == ".npz":
        from focused_attention_vit_tpu_torch.convert.from_jax import (
            npz_to_state_dict,
        )

        return npz_to_state_dict(path, in_proj_names)
    if path.suffix in (".pt", ".pth"):
        return torch.load(path, map_location="cpu", weights_only=True)
    raise ValueError(f"weights must be .pt, .pth or .npz, got {path.name}")


class Predictor:
    """Classifier over uint8 NHWC images at a fixed device batch.

    Moves ``model`` to ``device`` and ``compute_dtype`` (in place) and runs
    it under :func:`torch.inference_mode`. A batch larger than ``chunk`` and
    divisible by it runs as ``batch_size // chunk`` forward passes of
    ``chunk`` images, as the JAX package scans over chunks.
    """

    def __init__(
        self,
        model: torch.nn.Module,
        *,
        img_size: int,
        device,
        batch_size: int = 256,
        compute_dtype: torch.dtype = torch.bfloat16,
        mean=CIFAR10_MEAN,
        std=CIFAR10_STD,
        chunk: int = 64,
    ):
        self.device = torch.device(device)
        self.model = model.to(device=self.device, dtype=compute_dtype).eval()
        self.img_size = img_size
        self.batch_size = batch_size
        self.compute_dtype = compute_dtype
        self.num_classes = int(model.num_classes)
        self._mean, self._std = mean, std
        split = batch_size > chunk and batch_size % chunk == 0
        self._chunk = chunk if split else batch_size

    @classmethod
    def from_weights(cls, model: torch.nn.Module, path, **kw) -> "Predictor":
        """Load weights into ``model`` (see :func:`load_state_dict`), then
        build the predictor."""
        from focused_attention_vit_tpu_torch.models import (
            VisionTransformerMHLA,
        )

        model.load_state_dict(load_state_dict(
            path, in_proj_names=isinstance(model, VisionTransformerMHLA)))
        return cls(model, **kw)

    @classmethod
    def from_checkpoint(cls, model: torch.nn.Module, checkpoint_dir,
                        **kw) -> "Predictor":
        """Load the params-only sidecar of a training checkpoint directory
        into ``model``, then build the predictor: the port's
        ``params_latest.pt`` (``train.checkpoint.CheckpointManager``), or,
        where only a JAX run's ``params_latest.msgpack`` is there, that file
        through the msgpack reader and :mod:`.convert.from_jax`."""
        from focused_attention_vit_tpu_torch.train.checkpoint import (
            PARAMS_FILE,
            load_params,
        )

        path = os.path.join(checkpoint_dir, PARAMS_FILE)
        jax_path = os.path.join(checkpoint_dir, "params_latest.msgpack")
        if os.path.exists(path):
            state = load_params(path)
        elif os.path.exists(jax_path):
            from focused_attention_vit_tpu_torch.convert.flax_msgpack import (
                read_msgpack,
            )
            from focused_attention_vit_tpu_torch.convert.from_jax import (
                flax_to_state_dict_for,
            )

            state = flax_to_state_dict_for(model, read_msgpack(jax_path))
        else:
            raise FileNotFoundError(
                f"no params sidecar at {path} or {jax_path}")
        model.load_state_dict(state)
        return cls(model, **kw)

    @torch.inference_mode()
    def _fwd(self, images_u8: np.ndarray) -> torch.Tensor:
        x = torch.from_numpy(np.ascontiguousarray(images_u8)).to(self.device)
        probs = []
        for xc in x.split(self._chunk):
            xc = prepare_eval_batch(
                xc, self.img_size, mean=self._mean, std=self._std,
                dtype=self.compute_dtype,
            )
            probs.append(torch.softmax(self.model(xc).float(), dim=-1))
        return torch.cat(probs)

    def warmup(self, input_hw: Tuple[int, int] | None = None) -> None:
        """Run one batch of the expected input shape (default the model's
        own size): builds the CUDA kernels on their first call."""
        h, w = input_hw if input_hw is not None else (
            self.img_size, self.img_size
        )
        self._fwd(np.zeros((self.batch_size, h, w, 3), dtype=np.uint8)).cpu()

    def predict_proba(self, images_u8: np.ndarray) -> np.ndarray:
        """``[N, h, w, C]`` uint8 -> ``[N, num_classes]`` float32."""
        return padded_predict_proba(
            self._fwd, self.batch_size, self.num_classes, images_u8
        )

    def predict(self, images_u8: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(predicted class ids, their probabilities)."""
        probs = self.predict_proba(images_u8)
        ids = probs.argmax(-1)
        return ids, probs[np.arange(len(ids)), ids]
