"""Checkpoint and resume of a :class:`~.state.TrainState` (port of
``focused_attention_vit_tpu/train/checkpoint.py``).

The JAX package writes Orbax directories. The port keeps its own state in
torch format instead, and reads no Orbax directory: the card's machine has
neither Orbax nor tensorstore. What it keeps of JAX's semantics:

* one committed directory per step, ``<dir>/<step>/state.pt``, holding the
  model's ``state_dict()``, the AdamW state, the optimizer's update count
  (which is all the state an LR schedule has) and ``step``;
* the directory is written under a temporary name and renamed, so a crash
  mid-save leaves the previous step whole, and :meth:`latest_step` sees
  committed directories only; the newest ``max_to_keep`` are kept;
* after each save a params-only sidecar, ``params_latest.pt`` (the model's
  state dict), is replaced atomically, for serving
  (``Predictor.from_checkpoint``, ``serve --checkpoint_dir``);
* files hold only tensors, numbers, strings, lists and dicts, and load
  under ``torch.load(..., weights_only=True)``.

Async saves (``async_save=True``, the experiment default): ``save()``
clones every tensor of the state on the training stream and records an
event, then returns. AdamW updates parameters and moments in place, so the
clones are what make this safe: the next step's in-place update is queued
after them. A background thread copies the clones to pinned host memory on
a side stream that waits on the event, then writes the files. At most one
save is in flight; a failure in the background is raised again at the next
``save``, ``restore``, ``latest_step`` or ``close``. While a save is in
flight the clones take one more copy of the state on the card.

A state sharded over a device mesh (``state.layout``, :mod:`..parallel`) is
saved in exactly the single-device format: every rank calls ``save``, the
full state is gathered on every rank (FSDP shards, then the tensor-parallel
slices), and rank 0 alone writes it. ``restore`` cuts the full state into
each rank's pieces, so a checkpoint restores on any topology.
"""

from __future__ import annotations

import os
import re
import shutil
import threading
import time
from typing import Any, Callable, Dict, Mapping, Optional

import torch
import torch.distributed as dist

STATE_FILE = "state.pt"
PARAMS_FILE = "params_latest.pt"


def _map_tensors(tree: Any, fn: Callable[[torch.Tensor], torch.Tensor]):
    """``fn`` on every tensor of a tree of dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, Mapping):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(v, fn) for v in tree)
    return tree


def _tensors(tree: Any):
    out = []
    _map_tensors(tree, out.append)
    return out


def _state_tree(state) -> Dict[str, Any]:
    """The live state's tensors (no copies; a sharded state's gathered
    full tensors): model, AdamW, update count and step."""
    if state.layout is not None:
        return state.layout.full_state(state)
    return {
        "model": state.model.state_dict(),
        "optimizer": state.tx.adamw.state_dict(),
        "count": int(state.tx.count),
        "step": int(state.step),
    }


def _pull_to_host(tree: Any, event: Optional[torch.cuda.Event],
                  device: Optional[torch.device]) -> Any:
    """Copy the CUDA tensors of ``tree`` to pinned host memory on a side
    stream that first waits on ``event``; CPU tensors pass through."""
    if device is None:
        return tree
    stream = torch.cuda.Stream(device=device)
    stream.wait_event(event)
    with torch.cuda.stream(stream):
        host = _map_tensors(tree, lambda t: torch.empty(
            t.shape, dtype=t.dtype, pin_memory=True).copy_(
                t, non_blocking=True) if t.is_cuda else t)
    stream.synchronize()
    return host


def _atomic_save(obj: Any, path: str) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        torch.save(obj, tmp)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


class CheckpointManager:
    """Per-step :class:`~.state.TrainState` checkpoints under ``directory``
    with retention; ``async_save=True`` makes :meth:`save` return after an
    on-device snapshot (see the module docstring).

    ``stats`` holds the last save's host seconds on the training thread
    (``held_s``), the background pull and write seconds (``pull_s``,
    ``write_s``) and the bytes of its tensors."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 async_save: bool = False):
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        self._max_to_keep = max_to_keep
        self._async = bool(async_save)
        self._pending: Optional[threading.Thread] = None
        self._pending_exc: Optional[Exception] = None
        self.stats: Dict[str, float] = {}

    def save(self, step: int, state) -> None:
        self.wait_until_finished()  # one save in flight; surface a failure
        t0 = time.perf_counter()
        tree = _state_tree(state)
        nbytes = sum(t.numel() * t.element_size() for t in _tensors(tree))
        if dist.is_initialized() and dist.get_rank() != 0:
            # The gather above was this rank's part; rank 0 writes.
            self.stats = {"held_s": time.perf_counter() - t0, "bytes": nbytes}
            return
        if not self._async:
            self._write(step, _map_tensors(tree, lambda t: t.detach().cpu()))
            self.stats = {"held_s": time.perf_counter() - t0, "pull_s": 0.0,
                          "write_s": time.perf_counter() - t0,
                          "bytes": nbytes}
            return
        snapshot = _map_tensors(tree, lambda t: t.detach().clone())
        device = next((t.device for t in _tensors(snapshot) if t.is_cuda),
                      None)
        event = None
        if device is not None:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(device))
        self.stats = {"held_s": time.perf_counter() - t0, "bytes": nbytes}
        t = threading.Thread(target=self._background_write,
                             args=(step, snapshot, event, device),
                             name=f"ckpt-save-{step}", daemon=True)
        self._pending = t
        t.start()

    def _background_write(self, step, snapshot, event, device) -> None:
        try:
            t0 = time.perf_counter()
            host = _pull_to_host(snapshot, event, device)
            del snapshot  # the card's copy is free once the pull is done
            t1 = time.perf_counter()
            self._write(step, host)
            self.stats.update(pull_s=t1 - t0,
                              write_s=time.perf_counter() - t1)
        except Exception as e:  # raised again at the next sync point
            self._pending_exc = e

    def _write(self, step: int, host_tree: Dict[str, Any]) -> None:
        final = os.path.join(self._dir, str(int(step)))
        tmp = f"{final}.tmp-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(host_tree, os.path.join(tmp, STATE_FILE))
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        for old in self.all_steps()[:-self._max_to_keep]:
            shutil.rmtree(os.path.join(self._dir, str(old)))
        save_params(self.params_path(), host_tree["model"])

    def wait_until_finished(self) -> None:
        """Block until the save in flight, if any, has committed; raise its
        failure if it had one."""
        t = self._pending
        if t is not None:
            t.join()
            self._pending = None
        if self._pending_exc is not None:
            exc, self._pending_exc = self._pending_exc, None
            raise RuntimeError(
                "async checkpoint save failed (raised in the background "
                "writer; training continued past the failed epoch)"
            ) from exc

    def params_path(self) -> str:
        return os.path.join(self._dir, PARAMS_FILE)

    def all_steps(self) -> list:
        """The committed steps, oldest first: directories named by an
        integer that hold the state file (a temporary one is not)."""
        return sorted(
            int(n) for n in os.listdir(self._dir)
            if re.fullmatch(r"\d+", n)
            and os.path.isfile(os.path.join(self._dir, n, STATE_FILE)))

    def latest_step(self) -> Optional[int]:
        self.wait_until_finished()
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, state, step: Optional[int] = None):
        """Load the checkpoint of ``step`` (default the latest) into the
        live ``state`` on its own device and return it; None when there is
        no checkpoint."""
        self.wait_until_finished()
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        ckpt = torch.load(os.path.join(self._dir, str(step), STATE_FILE),
                          map_location="cpu", weights_only=True)
        if state.layout is not None:
            state.layout.load_full_state(state, ckpt)
            return state
        state.model.load_state_dict(ckpt["model"])
        # AdamW moves the moments to their parameters' device and keeps its
        # step counters on the host, where they were saved from.
        state.tx.adamw.load_state_dict(ckpt["optimizer"])
        state.tx.count = ckpt["count"]
        state.step = ckpt["step"]
        return state

    def close(self) -> None:
        self.wait_until_finished()


def save_params(path: str, params: Mapping[str, torch.Tensor]) -> str:
    """Write a state dict (host copies of its tensors) to ``path``: a
    temporary file, then ``os.replace``, so that a crash mid-write leaves
    the previous copy whole."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    _atomic_save({k: v.detach().cpu() for k, v in params.items()}, path)
    return path


def load_params(path: str) -> Dict[str, torch.Tensor]:
    """The state dict that :func:`save_params` wrote, on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)
