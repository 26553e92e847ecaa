"""ctypes binding of the host SLIC connectivity pass (port of
``focused_attention_vit_tpu/ops/native_connectivity.py``).

``native/connectivity.cpp`` (skimage ``_enforce_label_connectivity_cython``
semantics, then the device pass's reduce to at most R labels, threaded over
the batch) is built with g++ into ``build/native/`` at first use
(:func:`~..utils.kernel_build.build_native`). Without g++, or when the build
fails, the call raises and names the cause: JAX turns connectivity off
there, which would hide the host path.
"""

from __future__ import annotations

import ctypes

import numpy as np

from focused_attention_vit_tpu_torch.utils import kernel_build


def _configure(lib: ctypes.CDLL) -> None:
    # native/connectivity.cpp: int favit_enforce_connectivity(const int32_t*
    # labels, int32_t* out, int b, int h, int w, int min_size,
    # int max_labels, int n_threads)
    fn = lib.favit_enforce_connectivity
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int]


def get_lib() -> ctypes.CDLL:
    return kernel_build.load_native("connectivity", _configure)


def enforce_connectivity_host(labels: np.ndarray, min_size: int,
                              max_labels: int,
                              n_threads: int = 0) -> np.ndarray:
    """Connectivity on the host for int labels ``[B, H, W]`` (or
    ``[H, W]``): skimage's scan-order BFS merge of components smaller than
    ``min_size``, then at most ``max_labels`` labels, dense in scan order.
    ``n_threads`` 0 takes one thread per core, at most one per image."""
    lib = get_lib()
    single = labels.ndim == 2
    arr = np.ascontiguousarray(labels[None] if single else labels,
                               dtype=np.int32)
    b, h, w = arr.shape
    out = np.empty_like(arr)
    rc = lib.favit_enforce_connectivity(
        arr.ctypes.data_as(ctypes.c_void_p),
        out.ctypes.data_as(ctypes.c_void_p),
        b, h, w, int(min_size), int(max_labels), int(n_threads))
    if rc != 0:
        raise RuntimeError(f"favit_enforce_connectivity failed (rc={rc}) on "
                           f"labels of shape {arr.shape}, max_labels "
                           f"{max_labels}")
    return out[0] if single else out
