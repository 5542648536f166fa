"""Batched block matvec on lane-packed A: CUDA kernel wrapper and its plain
version.

Replaces the Pallas TPU kernel ``packed_block_matvec`` ->
``_packed_matvec_kernel`` (``pio_tpu/ops/als_pallas.py``), the matvec of
every Jacobi-CG iteration on packed normal equations (ALS
``packed_a=True``):

    out[b] = A_b @ x[b]     a_packed (n, k²) f32, row b = A_b row-major;
                            x (n, k) f32 -> (n, k) f32

The reference pads n to its kernel's row block once per solve, with
identity rows; the kernel here takes any n, so the port never copies A
(2.3 GB at the ML-20M users side) to pad it. The pad was exact either way:
no row of the product mixes with another.

``packed_block_matvec`` launches ``packed_matvec.cu`` for CUDA tensors and
raises if it cannot; only for tensors on the CPU does it compute the plain
version, ``packed_block_matvec_reference``.
"""

from __future__ import annotations

import ctypes

import torch

from pio_tpu_torch.ops.kernels.build import LaunchCounter, load_library

#: launches of the CUDA kernel (the CPU path does not count)
launches = LaunchCounter()

MAX_K = 256   # packed A comes from the streaming flush, which stops here

_lib: "ctypes.CDLL | None" = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = load_library("packed_matvec")
        lib.pio_packed_matvec.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        lib.pio_packed_matvec.restype = ctypes.c_int
        lib.pio_cuda_error_string.argtypes = [ctypes.c_int]
        lib.pio_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def packed_block_matvec_reference(a_packed: torch.Tensor,
                                  x: torch.Tensor) -> torch.Tensor:
    """Plain torch version: one batched matmul on a (n, k, k) view."""
    n, k = x.shape
    return torch.bmm(a_packed.view(n, k, k), x[:, :, None])[:, :, 0]


def _check(a_packed: torch.Tensor, x: torch.Tensor) -> None:
    if x.device != a_packed.device:
        raise ValueError(f"x is on {x.device}, a_packed on "
                         f"{a_packed.device}")
    for name, t in (("a_packed", a_packed), ("x", x)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} dtype {t.dtype}; want torch.float32")
        if t.ndim != 2:
            raise ValueError(f"{name} has shape {tuple(t.shape)}; want 2-d")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n, k = x.shape
    if a_packed.shape != (n, k * k):
        raise ValueError(f"a_packed {tuple(a_packed.shape)} does not match "
                         f"x {tuple(x.shape)}: want ({n}, {k * k})")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"block width {k} outside the kernel's 1..{MAX_K}")


def packed_block_matvec(a_packed: torch.Tensor,
                        x: torch.Tensor) -> torch.Tensor:
    """out[b] = A_b @ x[b] for packed A; same contract as
    ``packed_block_matvec_reference``. On a CUDA device it launches the
    kernel (a build or launch failure raises)."""
    if a_packed.device.type == "cpu":
        return packed_block_matvec_reference(a_packed, x)
    if a_packed.device.type != "cuda":
        raise ValueError(f"packed_block_matvec runs on cuda or cpu, not "
                         f"{a_packed.device}")
    _check(a_packed, x)
    n, k = x.shape
    out = torch.empty((n, k), dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    vec = int(k % 4 == 0 and a_packed.data_ptr() % 16 == 0)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.pio_packed_matvec(a_packed.data_ptr(), x.data_ptr(),
                                    out.data_ptr(), n, k, vec, stream)
    if err:
        raise RuntimeError(f"packed_block_matvec launch failed: "
                           f"{lib.pio_cuda_error_string(err).decode()}")
    launches.add()
    return out
