"""Build and load the port's CUDA kernels.

Each ``<name>.cu`` beside this module is compiled at first use with
``nvcc`` for Hopper (``sm_90a``) into a plain shared library with a C
interface, loaded through ``ctypes`` (no PyTorch headers, so a build
takes seconds). Libraries are cached under ``pio_tpu_torch/_build/``,
keyed by a hash of the source and the flags. Nothing here runs at import
time: importing the port never needs ``nvcc`` or a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor

#: every kernel source of the port, by name (``<name>.cu`` in this folder)
KERNELS = ("quantized_scan", "segment_flush", "gather_rows", "packed_matvec",
           "flash_attention")

_KERNEL_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(_KERNEL_DIR)), "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
#: compiler output of each build made by this process (ptxas register and
#: shared-memory counts), by kernel name
BUILD_LOG: dict[str, str] = {}


class KernelBuildError(RuntimeError):
    pass


class LaunchCounter:
    """Launches of one kernel, counted by its wrapper where it launches
    and nowhere else, so a run can show which kernels its path went
    through. Thread-safe: the query server predicts on many threads."""

    def __init__(self):
        self._n = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self._n += 1

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def value(self) -> int:
        with self._lock:
            return self._n


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get(
        "CUDA_PATH", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise KernelBuildError(
            "nvcc not found on PATH or under CUDA_HOME; the CUDA toolkit "
            "is needed to build the port's kernels")
    return path


def build_library(name: str) -> str:
    """Compile ``<name>.cu`` to a shared library; returns its path."""
    src = os.path.join(_KERNEL_DIR, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(
            f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    os.makedirs(_BUILD_DIR, exist_ok=True)
    so_path = os.path.join(_BUILD_DIR, f"{name}-{digest}.so")
    if os.path.exists(so_path):
        return so_path
    tmp = so_path + f".tmp{os.getpid()}"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise KernelBuildError(
            f"nvcc failed for {src}:\n{proc.stdout}\n{proc.stderr}")
    BUILD_LOG[name] = proc.stdout + proc.stderr
    os.replace(tmp, so_path)  # atomic: concurrent builds race benignly
    return so_path


def build_all(names=KERNELS) -> dict[str, float]:
    """Build the named kernels at once, one ``nvcc`` each, all started
    together; returns the seconds each build took (about 0 when the
    library was already built from the same source and flags)."""
    def timed(name):
        t0 = time.perf_counter()
        build_library(name)
        return time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return dict(zip(names, pool.map(timed, names)))


def load_library(name: str) -> ctypes.CDLL:
    with _LOCK:
        if name not in _LIBS:
            # one build per process; the lock serializes exactly it
            _LIBS[name] = ctypes.CDLL(build_library(name))
        return _LIBS[name]
