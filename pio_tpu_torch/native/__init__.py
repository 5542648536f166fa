"""Native (C++) runtime components.

The reference delegates its native compute to Spark/MLlib's JVM+BLAS stack;
this package holds the port's own native runtime pieces — currently the
append-only event log (``eventlog.cpp`` beside this module), compiled on
demand with g++ and loaded via ctypes (no pybind11 in the image). It is host
code: no CUDA compiler or card is involved.

Copy of ``pio_tpu.native`` pointed at the port's own source (this folder,
not the repository's ``native/``) and at the port's build folder
``pio_tpu_torch/_build/``, where the CUDA kernels are built too. Libraries
are cached there keyed by source hash, so the first use pays one compile of
a few seconds and later ones load the cached .so.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_SOURCE_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(os.path.dirname(_SOURCE_DIR), "_build")
_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


class NativeBuildError(RuntimeError):
    pass


def _source_path(name: str) -> str:
    return os.path.join(_SOURCE_DIR, f"{name}.cpp")


def build_library(name: str) -> str:
    """Compile <name>.cpp to a shared library; returns the .so path."""
    src = _source_path(name)
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    os.makedirs(_BUILD_DIR, exist_ok=True)
    so_path = os.path.join(_BUILD_DIR, f"{name}-{digest}.so")
    if os.path.exists(so_path):
        return so_path
    tmp = so_path + f".tmp{os.getpid()}"
    cmd = [
        "g++", "-O2", "-shared", "-fPIC", "-std=c++17",
        "-Wall", "-Werror", "-o", tmp, src,
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise NativeBuildError(
            f"g++ failed for {src}:\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, so_path)  # atomic: concurrent builders race benignly
    return so_path


def load_library(name: str) -> ctypes.CDLL:
    with _LOCK:
        if name not in _LIBS:
            # pio: lint-ok[blocking-under-lock] one-time g++ build per
            # process; the lock exists to serialize exactly this build
            # so concurrent importers don't compile twice
            _LIBS[name] = ctypes.CDLL(build_library(name))
        return _LIBS[name]


def native_available(name: str = "eventlog") -> bool:
    """True if the native library builds/loads on this machine."""
    try:
        load_library(name)
        return True
    except (NativeBuildError, OSError):
        return False
