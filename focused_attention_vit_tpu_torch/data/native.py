"""ctypes binding of the native C++ batch prefetcher (port of
``focused_attention_vit_tpu/data/native.py``).

``native/batcher.cpp`` (a worker thread that shuffles with
``std::mt19937_64`` and keeps ``depth`` assembled batches ahead of the
consumer) is built with g++ into ``build/native/`` at first use
(:func:`~..utils.kernel_build.load_native`), through its plain C ABI:
``favit_prefetcher_create``, ``favit_prefetcher_next`` and
``favit_prefetcher_destroy``. Where JAX falls back to the numpy iterator
when the build fails, the port raises
:class:`~..utils.kernel_build.NativeBuildError` naming the cause, so that a
run never changes its batch order silently.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Iterator, Tuple

import numpy as np

from focused_attention_vit_tpu_torch.utils import kernel_build


def _configure(lib: ctypes.CDLL) -> None:
    lib.favit_prefetcher_create.restype = ctypes.c_void_p
    lib.favit_prefetcher_create.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
    ]
    lib.favit_prefetcher_next.restype = ctypes.c_int64
    lib.favit_prefetcher_next.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.favit_prefetcher_destroy.restype = None
    lib.favit_prefetcher_destroy.argtypes = [ctypes.c_void_p]


def get_lib() -> ctypes.CDLL:
    """The built library; raises ``NativeBuildError`` when g++ is missing
    or fails."""
    return kernel_build.load_native("batcher", _configure)


class NativePrefetcher:
    """Shuffled batches over host uint8 arrays, assembled by a C++ worker
    thread. One instance serves every epoch (:meth:`epoch_batches` yields
    one epoch); ``close()`` stops the worker and frees the C++ object."""

    def __init__(self, images: np.ndarray, labels: np.ndarray,
                 batch_size: int, *, shuffle: bool = True,
                 drop_last: bool = True, depth: int = 4, seed: int = 0):
        # The gather copies whole items byte by byte, so only uint8 items
        # have the byte count it assumes.
        if images.dtype != np.uint8:
            raise TypeError(
                f"NativePrefetcher requires uint8 images, got {images.dtype}")
        self._lib = get_lib()
        # Own contiguous copies: the C++ side keeps raw pointers into them.
        self._images = np.ascontiguousarray(images)
        self._labels = np.ascontiguousarray(labels.astype(np.int32))
        self.batch_size = batch_size
        self.item_shape = self._images.shape[1:]
        item_bytes = int(self._images[0].nbytes) if len(self._images) else 0
        self._handle = self._lib.favit_prefetcher_create(
            self._images.ctypes.data_as(ctypes.c_void_p),
            self._labels.ctypes.data_as(ctypes.c_void_p),
            len(self._images), item_bytes, batch_size, depth,
            seed & (2**64 - 1), int(shuffle), int(drop_last))
        self._out_img = np.empty((batch_size, *self.item_shape), np.uint8)
        self._out_lab = np.empty((batch_size,), np.int32)
        self._closed = False
        self._close_lock = threading.Lock()

    def epoch_batches(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        while not self._closed:  # after close() the C++ object is gone
            n = self._lib.favit_prefetcher_next(
                self._handle,
                self._out_img.ctypes.data_as(ctypes.c_void_p),
                self._out_lab.ctypes.data_as(ctypes.c_void_p))
            if n <= 0:  # 0: end of the epoch; -1: shutting down
                return
            # Copied out: the staging buffers take the next batch.
            yield self._out_img[:n].copy(), self._out_lab[:n].copy()

    def close(self) -> None:
        # Locked, so that two closes (an explicit one and the finaliser's)
        # cannot free the handle twice; destroy waits for a copy in flight.
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
        self._lib.favit_prefetcher_destroy(self._handle)

    def __del__(self):
        if getattr(self, "_close_lock", None) is not None:
            self.close()
