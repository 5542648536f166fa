"""The quantized candidate scan: CUDA kernel wrapper and its plain version.

Replaces the Pallas TPU kernel ``quantized_scores_pallas``
(``pio_tpu/ops/retrieval.py``) together with the probed-cluster gather and
pad mask that surround it in ``_clustered_topk_jit``:

    qs[b, p*Lmax + l] = (sum_j float(table[c, l, j]) * u[b, j]) * scales[c, l]
                        if gidx[c, l] >= 0 else -inf,      c = top_c[b, p]

``quantized_scan`` launches ``quantized_scan.cu`` for CUDA tensors and
raises if it cannot; only for tensors on the CPU does it compute the plain
version, ``quantized_scan_reference``. The kernel is bound by latency, one
thread per row with the row read as 16-byte vectors (see the note in the
``.cu`` source); ``empty_launch`` times an empty kernel on its grid.
"""

from __future__ import annotations

import ctypes
import math

import torch

from pio_tpu_torch.ops.kernels.build import LaunchCounter, load_library

#: launches of the CUDA kernel (the CPU path does not count)
launches = LaunchCounter()

_MAX_K = 12 * 1024   # u[b] is staged in the default 48 KiB of shared memory


def quantized_scan_reference(table: torch.Tensor, scales: torch.Tensor,
                             gidx: torch.Tensor, top_c: torch.Tensor,
                             u: torch.Tensor) -> torch.Tensor:
    """Plain torch version: table (C,Lmax,k) int8|bfloat16, scales
    (C,Lmax) f32, gidx (C,Lmax) int32 (-1 = pad), top_c (B,P) int, u
    (B,k) f32 -> (B, P*Lmax) f32."""
    b, p = top_c.shape
    idx = top_c.long()
    qs = torch.einsum("bplk,bk->bpl", table[idx].float(), u) * scales[idx]
    qs = torch.where(gidx[idx] >= 0, qs, torch.full_like(qs, -math.inf))
    return qs.reshape(b, p * table.shape[1])


_SYMBOLS = {torch.int8: "pio_quantized_scan_int8",
            torch.bfloat16: "pio_quantized_scan_bf16"}
_lib: "ctypes.CDLL | None" = None


def _library() -> ctypes.CDLL:
    """The built kernel library, its C signatures declared (ctypes would
    otherwise pass each pointer as a 32-bit int). Declaring twice from
    racing threads is harmless."""
    global _lib
    if _lib is None:
        lib = load_library("quantized_scan")
        for symbol in _SYMBOLS.values():
            fn = getattr(lib, symbol)
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.pio_quantized_scan_empty.argtypes = [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        lib.pio_quantized_scan_empty.restype = ctypes.c_int
        lib.pio_cuda_error_string.argtypes = [ctypes.c_int]
        lib.pio_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(table, scales, gidx, top_c, u) -> None:
    dev = table.device
    for name, t in (("scales", scales), ("gidx", gidx), ("top_c", top_c),
                    ("u", u)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, table on {dev}")
    if table.dtype not in (torch.int8, torch.bfloat16):
        raise TypeError(f"table dtype {table.dtype}; want int8 or bfloat16")
    for name, t, dtype in (("scales", scales, torch.float32),
                           ("gidx", gidx, torch.int32),
                           ("top_c", top_c, torch.int32),
                           ("u", u, torch.float32)):
        if t.dtype != dtype:
            raise TypeError(f"{name} dtype {t.dtype}; want {dtype}")
    c, lmax, k = table.shape
    if scales.shape != (c, lmax) or gidx.shape != (c, lmax):
        raise ValueError(
            f"scales {tuple(scales.shape)} / gidx {tuple(gidx.shape)} do "
            f"not match table {tuple(table.shape)}")
    if top_c.ndim != 2 or u.shape != (top_c.shape[0], k):
        raise ValueError(
            f"top_c {tuple(top_c.shape)} / u {tuple(u.shape)} do not "
            f"match table width {k}")
    if k > _MAX_K:
        raise ValueError(f"factor width {k} exceeds the kernel's {_MAX_K}")
    for name, t in (("table", table), ("scales", scales), ("gidx", gidx),
                    ("top_c", top_c), ("u", u)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def quantized_scan(table: torch.Tensor, scales: torch.Tensor,
                   gidx: torch.Tensor, top_c: torch.Tensor,
                   u: torch.Tensor) -> torch.Tensor:
    """The scan for one query batch; same contract as
    ``quantized_scan_reference``, with top_c int32. On a CUDA device it
    launches the kernel (a build or launch failure raises)."""
    if table.device.type == "cpu":
        return quantized_scan_reference(table, scales, gidx, top_c, u)
    if table.device.type != "cuda":
        raise ValueError(f"quantized_scan runs on cuda or cpu, not "
                         f"{table.device}")
    _check(table, scales, gidx, top_c, u)
    _, lmax, k = table.shape
    b, p = top_c.shape
    out = torch.empty((b, p * lmax), dtype=torch.float32,
                      device=table.device)
    if out.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = getattr(lib, _SYMBOLS[table.dtype])(
            table.data_ptr(), scales.data_ptr(), gidx.data_ptr(),
            top_c.data_ptr(), u.data_ptr(), out.data_ptr(),
            b, p, lmax, k, stream)
    if err:
        raise RuntimeError(
            f"quantized_scan launch failed: "
            f"{lib.pio_cuda_error_string(err).decode()}")
    launches.add()
    return out


def empty_launch(b: int, p: int, lmax: int, device) -> None:
    """An empty kernel on the scan's grid for (B, P, Lmax) on ``device``:
    the launch floor of the scan's shape. Not counted in ``launches``."""
    lib = _library()
    with torch.cuda.device(device):
        err = lib.pio_quantized_scan_empty(
            b, p, lmax, torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"empty scan launch failed: "
                           f"{lib.pio_cuda_error_string(err).decode()}")
