"""Batch inference (port of ``focused_attention_vit_tpu/infer.py``).

A :class:`Predictor` serves uint8 NHWC images at one fixed device batch:
requests of any size are cut into ``batch_size`` chunks, the last one padded
by repeating its first image and the padding dropped on the way out. With a
device mesh it serves on every rank of the process group (JAX's
``Predictor(mesh=...)``).
"""

from __future__ import annotations

import os
import threading
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


class ServingModule(torch.nn.Module):
    """The tensor part of serving: uint8 ``[batch, h, w, C]`` on the
    model's device to f32 ``[batch, num_classes]`` probabilities. The batch
    runs in chunks of ``chunk`` images (one chunk when ``chunk`` does not
    split it), each resized and normalised on the device
    (:func:`~.data.pipeline.prepare_eval_batch`), classified by ``model``
    in ``dtype`` and put through an f32 softmax. :class:`Predictor` serves
    with it and :mod:`.export` exports it, so the two give the same
    numbers."""

    def __init__(self, model: torch.nn.Module, *, img_size: int,
                 dtype: torch.dtype, mean, std, chunk: int):
        super().__init__()
        self.model = model
        self.img_size = img_size
        self.dtype = dtype
        self.mean, self.std = mean, std
        self.chunk = chunk

    def forward(self, images_u8: torch.Tensor) -> torch.Tensor:
        probs = []
        for xc in images_u8.split(self.chunk):
            xc = prepare_eval_batch(xc, self.img_size, mean=self.mean,
                                    std=self.std, dtype=self.dtype)
            probs.append(torch.softmax(self.model(xc).float(), dim=-1))
        return torch.cat(probs)


class Predictor:
    """Classifier over uint8 NHWC images at a fixed device batch.

    Moves ``model`` to ``device`` and ``compute_dtype`` (in place) and runs
    it under :func:`torch.inference_mode`. A batch larger than ``chunk`` and
    divisible by it runs as ``batch_size // chunk`` forward passes of
    ``chunk`` images, as the JAX package scans over chunks.

    With ``mesh`` (a ``(data, model)`` mesh of :mod:`.parallel` over the
    ranks of the process group) the parameters are placed by the
    tensor-parallel rules (``parallel.shard_params``), each batch's rows
    are split over ``data``, and there is no chunking, as in JAX;
    ``batch_size`` must divide by the data size. Rank 0 serves: each of its
    batches is broadcast to every rank, each rank runs its rows and the
    probabilities are gathered on rank 0. The other ranks run
    :meth:`follow` until rank 0 calls :meth:`close`. Batches from
    concurrent threads of rank 0 go through one at a time.
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
        mesh=None,
    ):
        self.device = torch.device(device)
        self.model = model.to(device=self.device, dtype=compute_dtype).eval()
        self.img_size = img_size
        self.batch_size = batch_size
        self.compute_dtype = compute_dtype
        self.num_classes = int(model.num_classes)
        self.mesh = mesh
        if mesh is not None:
            from focused_attention_vit_tpu_torch.parallel import sharding

            dp = sharding.mesh_size(mesh, sharding.DATA)
            if batch_size % dp:
                raise ValueError(
                    f"batch_size={batch_size} must be divisible by the "
                    f"'data' axis size {dp}"
                )
            sharding.shard_params(self.model, mesh, ddp=False)
            # On a mesh, chunking would split the rows that DP shards; the
            # per-device batch is already small.
            chunk = batch_size // dp
            self._lock = threading.Lock()
            self._stopped = False
        split = batch_size > chunk and batch_size % chunk == 0
        self.serving = ServingModule(
            self.model, img_size=img_size, dtype=compute_dtype, mean=mean,
            std=std, chunk=chunk if split else batch_size)

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
        if self.mesh is not None:
            with self._lock:
                return self._mesh_step(np.ascontiguousarray(images_u8))
        x = torch.from_numpy(np.ascontiguousarray(images_u8)).to(self.device)
        return self.serving(x)

    def _mesh_step(self, images_u8: np.ndarray | None):
        """One batch over the mesh: rank 0 passes it (None: the stop) and
        gets the probabilities of every row; the other ranks pass None and
        get the same, or None at the stop."""
        import torch.distributed as dist

        from focused_attention_vit_tpu_torch.parallel import sharding

        lead = dist.get_rank() == 0
        header = torch.zeros(5, dtype=torch.int64, device=self.device)
        if lead and images_u8 is not None:
            header[0] = 1
            header[1:] = torch.as_tensor(images_u8.shape)
        dist.broadcast(header, 0)
        if not int(header[0]):
            return None
        shape = [int(v) for v in header[1:]]
        x = (torch.from_numpy(images_u8).to(self.device) if lead else
             torch.empty(shape, dtype=torch.uint8, device=self.device))
        dist.broadcast(x, 0)
        rows = sharding.data_rows(shape[0], self.mesh)
        return sharding.gather_rows(self.serving(x[rows]), self.mesh)

    def follow(self) -> None:
        """On a rank other than 0 of a mesh: run rank 0's batches until it
        calls :meth:`close`. SIGINT is ignored here, so a Ctrl-C reaching
        every process stops the ranks through rank 0."""
        import signal

        if threading.current_thread() is threading.main_thread():
            signal.signal(signal.SIGINT, signal.SIG_IGN)
        with torch.inference_mode():
            while self._mesh_step(None) is not None:
                pass

    def close(self) -> None:
        """On rank 0 of a mesh: stop the ranks in :meth:`follow` (once)."""
        import torch.distributed as dist

        if self.mesh is None or dist.get_rank() != 0:
            return
        with self._lock:
            if not self._stopped:
                self._stopped = True
                self._mesh_step(None)

    def warmup(self, input_hw: Tuple[int, int] | None = None) -> None:
        """Run one batch of the expected input shape (default the model's
        own size): builds the CUDA kernels on their first call. On a mesh
        rank 0 warms every rank up; the others do nothing here."""
        if self.mesh is not None:
            import torch.distributed as dist

            if dist.get_rank() != 0:
                return
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
