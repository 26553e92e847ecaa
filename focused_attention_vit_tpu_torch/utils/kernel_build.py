"""Build the package's CUDA sources with nvcc at first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled for Hopper
(``sm_90a``) into a shared library and loaded with :mod:`ctypes`, so no
PyTorch headers are compiled. The library goes to ``build/kernels/`` at the
repository root (listed in ``.gitignore``), in a directory named by a hash of
the source, the headers of ``csrc/`` and the flags: an edited source or
header builds anew, an unchanged one loads the library built before.
:func:`build_many` starts one nvcc per source, all at once.

There is no fallback: without ``nvcc``, or when it fails, the build raises
:class:`KernelCompileError`.

:func:`build_native` does the same for the repository's host C++ sources
(``native/<name>.cpp``, plain C interface): ``g++ -O3 -shared -fPIC`` into
``build/native/<name>-<hash>/``, raising :class:`NativeBuildError` without
``g++`` or when it fails. The ``.so`` files beside the sources are not read.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_ROOT = PACKAGE_DIR.parent / "build" / "kernels"
NATIVE_DIR = PACKAGE_DIR.parent / "native"
NATIVE_BUILD_ROOT = PACKAGE_DIR.parent / "build" / "native"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers and spills per kernel, kept in build.log
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


class KernelCompileError(RuntimeError):
    """nvcc is missing or failed to build a kernel source."""


class NativeBuildError(RuntimeError):
    """g++ is missing or failed to build a host C++ source."""


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the toolkit's
    default install location; raises :class:`KernelCompileError` if none."""
    for var in ("CUDA_HOME", "CUDA_PATH"):
        home = os.environ.get(var)
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.is_file():
        return str(default)
    raise KernelCompileError(
        "nvcc not found (set CUDA_HOME or put the CUDA toolkit's bin "
        "directory on PATH): the CUDA kernels cannot be built"
    )


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, keyed by source, headers and
    flags."""
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update("\0".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_ROOT / f"{name}-{digest}" / f"lib{name}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built."""
    lib = library_path(name)
    if lib.is_file():
        return lib
    nvcc = find_nvcc()
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (lib.parent / "build.log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr
    )
    if proc.returncode != 0:
        raise KernelCompileError(
            f"nvcc exited {proc.returncode} building {name}.cu:\n"
            f"{proc.stderr[-4000:]}"
        )
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    return lib


def build_many(names) -> list[Path]:
    """:func:`build` each source, one nvcc process per source, all started
    together; raises the first failure."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return list(pool.map(build, names))


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; loaded once per
    process, thread-safe."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _loaded[name] = lib
        return lib


def native_library_path(name: str) -> Path:
    """Where ``native/<name>.cpp`` builds to, keyed by source and flags."""
    h = hashlib.sha256((NATIVE_DIR / f"{name}.cpp").read_bytes())
    h.update("\0".join(GXX_FLAGS).encode())
    return (NATIVE_BUILD_ROOT / f"{name}-{h.hexdigest()[:16]}"
            / f"lib{name}.so")


def build_native(name: str) -> Path:
    """Compile ``native/<name>.cpp`` with g++ unless its library is already
    built; raises :class:`NativeBuildError` naming the cause."""
    lib = native_library_path(name)
    if lib.is_file():
        return lib
    gxx = shutil.which("g++")
    if gxx is None:
        raise NativeBuildError(
            f"g++ not found on PATH: native/{name}.cpp cannot be built")
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [gxx, *GXX_FLAGS, "-o", str(tmp), str(NATIVE_DIR / f"{name}.cpp")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (lib.parent / "build.log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise NativeBuildError(
            f"g++ exited {proc.returncode} building native/{name}.cpp:\n"
            f"{proc.stderr[-4000:]}")
    os.replace(tmp, lib)
    return lib


def load_native(name: str, configure) -> ctypes.CDLL:
    """Build (if needed) and load ``native/<name>.cpp``, then
    ``configure(lib)`` (which declares the argument and result types); once
    per process, thread-safe."""
    key = f"native/{name}"
    with _lock:
        lib = _loaded.get(key)
        if lib is None:
            lib = ctypes.CDLL(str(build_native(name)))
            configure(lib)
            _loaded[key] = lib
        return lib
