"""The segment flush of the ALS normal equations: CUDA kernel wrapper and
its plain version.

Replaces the Pallas TPU kernel ``_segment_kernel`` with ``_flush_slot_fn``
(``pio_tpu/ops/als_pallas.py``, reached from ``normal_equations_hybrid``,
which ``accum="hybrid"`` runs), together with the trail fold of
``_chain_groups``. Slots are sorted by row and carry precomputed blocks:

    A[r] = sum of a_blk[s], b[r] = sum of b_blk[s]  over s with rows[s] == r

rows (S,) int32 non-decreasing, slots with ``rows == n_self`` are padding
and are dropped; a_blk (S,k,k), b_blk (S,k) f32, k <= 256. Rows with no
slot come out zero.

``segment_flush_stream`` is K3, the port of ``_segment_kernel_stream``
(``normal_equations_hybrid(overlap=True[, packed=True])``, which
``accum="stream"`` runs): the same sums, add for add, so its A and b are
bit-identical to ``segment_flush``'s, with each finished row written by one
TMA bulk store from a two-slot staging ring. With ``packed=True`` it
returns A as (n_self, k²), the form the packed CG matvec (K6) consumes; the
port never pads lanes, so that is the same bytes as (n_self, k, k).

Each wrapper launches ``segment_flush.cu`` for CUDA tensors and raises if
it cannot; only for tensors on the CPU does it compute the plain version,
``segment_flush_reference``. The kernels use no float atomics: two launches
on the same inputs give bit-identical A and b.
"""

from __future__ import annotations

import ctypes

import torch

from pio_tpu_torch.ops.kernels.build import LaunchCounter, load_library

#: launches of the K2 kernel (the CPU path does not count)
launches = LaunchCounter()
#: launches of the K3 kernel, ``segment_flush_stream``
launches_stream = LaunchCounter()

MAX_K = 256   # the reference's own limit for the flush (ops/als.py)

_lib: "ctypes.CDLL | None" = None


def segment_flush_reference(rows: torch.Tensor, a_blk: torch.Tensor,
                            b_blk: torch.Tensor, n_self: int,
                            out: "tuple[torch.Tensor, torch.Tensor] | None"
                            = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version: two ``index_add_`` calls, the pad slots
    (row ``n_self``) dropped through one spare row. With ``out`` the sums
    are added into the given (A, b)."""
    k = a_blk.shape[-1]
    A2 = a_blk.new_zeros((n_self + 1, k, k))
    b2 = b_blk.new_zeros((n_self + 1, k))
    idx = rows.long()
    A2.index_add_(0, idx, a_blk)
    b2.index_add_(0, idx, b_blk)
    if out is None:
        return A2[:n_self], b2[:n_self]
    A, b = out
    A += A2[:n_self]
    b += b2[:n_self]
    return A, b


def _library() -> ctypes.CDLL:
    """The built kernel library, its C signature declared (ctypes would
    otherwise pass each pointer as a 32-bit int)."""
    global _lib
    if _lib is None:
        lib = load_library("segment_flush")
        lib.pio_segment_flush.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        lib.pio_segment_flush.restype = ctypes.c_int
        lib.pio_segment_flush_stream.argtypes = lib.pio_segment_flush.argtypes
        lib.pio_segment_flush_stream.restype = ctypes.c_int
        lib.pio_segment_flush_tile.argtypes = []
        lib.pio_segment_flush_tile.restype = ctypes.c_int
        lib.pio_cuda_error_string.argtypes = [ctypes.c_int]
        lib.pio_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(rows, a_blk, b_blk, n_self, A, b) -> None:
    dev = rows.device
    for name, t in (("a_blk", a_blk), ("b_blk", b_blk), ("A", A), ("b", b)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, rows on {dev}")
    if rows.dtype != torch.int32:
        raise TypeError(f"rows dtype {rows.dtype}; want torch.int32")
    for name, t in (("a_blk", a_blk), ("b_blk", b_blk), ("A", A), ("b", b)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} dtype {t.dtype}; want torch.float32")
    if rows.ndim != 1 or a_blk.ndim != 3:
        raise ValueError(f"rows {tuple(rows.shape)} / a_blk "
                         f"{tuple(a_blk.shape)}: want (S,) and (S,k,k)")
    s, k = rows.shape[0], a_blk.shape[-1]
    if a_blk.shape != (s, k, k) or b_blk.shape != (s, k):
        raise ValueError(f"a_blk {tuple(a_blk.shape)} / b_blk "
                         f"{tuple(b_blk.shape)} do not match {s} slots")
    if A.shape != (n_self, k, k) or b.shape != (n_self, k):
        raise ValueError(f"A {tuple(A.shape)} / b {tuple(b.shape)} do not "
                         f"match n_self={n_self}, k={k}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"block width {k} outside the kernel's 1..{MAX_K}")
    for name, t in (("rows", rows), ("a_blk", a_blk), ("b_blk", b_blk),
                    ("A", A), ("b", b)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _vec(width: int, *tensors) -> int:
    """1 when rows of `width` floats can move as float4."""
    return int(width % 4 == 0
               and all(t.data_ptr() % 16 == 0 for t in tensors))


def _launch(symbol: str, rows, a_blk, b_blk, n_self: int, A,
            b) -> bool:
    """Launch one of the flush kernels; False when there is nothing to
    flush (and nothing was launched)."""
    _check(rows, a_blk, b_blk, n_self, A, b)
    s, k = rows.shape[0], a_blk.shape[-1]
    if s == 0 or n_self == 0:
        return False
    lib = _library()
    n_tiles = -(-s // lib.pio_segment_flush_tile())
    part_row = torch.empty(n_tiles, dtype=torch.int32, device=rows.device)
    part_a = torch.empty((n_tiles, k * k), dtype=torch.float32,
                         device=rows.device)
    part_b = torch.empty((n_tiles, k), dtype=torch.float32,
                         device=rows.device)
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        err = getattr(lib, symbol)(
            rows.data_ptr(), a_blk.data_ptr(), b_blk.data_ptr(),
            A.data_ptr(), b.data_ptr(), part_row.data_ptr(),
            part_a.data_ptr(), part_b.data_ptr(), s, n_self, k,
            _vec(k * k, a_blk, A), _vec(k, b_blk, b), stream)
    if err:
        raise RuntimeError(
            f"{symbol} launch failed: "
            f"{lib.pio_cuda_error_string(err).decode()}")
    return True


def _on_cuda(name: str, rows: torch.Tensor) -> None:
    if rows.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {rows.device}")


def segment_flush(rows: torch.Tensor, a_blk: torch.Tensor,
                  b_blk: torch.Tensor, n_self: int,
                  out: "tuple[torch.Tensor, torch.Tensor] | None" = None,
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Segmented sums of a_blk/b_blk over row-sorted slots -> (A, b),
    A (n_self,k,k), b (n_self,k) f32; same contract as
    ``segment_flush_reference``. On a CUDA device it launches the kernel
    (a build or launch failure raises).

    ``out=(A, b)`` flushes one run of consecutive slots of a longer layout
    into buffers the caller zeroed: the sum of ``rows[0]`` is added onto
    its row (it may continue from slots flushed before), every other row
    this call touches is written. Runs flushed in slot order into one
    zeroed (A, b) give the sums over all of them."""
    if rows.device.type == "cpu":
        return segment_flush_reference(rows, a_blk, b_blk, n_self, out)
    _on_cuda("segment_flush", rows)
    k = a_blk.shape[-1]
    if out is None:
        A = a_blk.new_zeros((n_self, k, k))
        b = b_blk.new_zeros((n_self, k))
    else:
        A, b = out
    if _launch("pio_segment_flush", rows, a_blk, b_blk, n_self, A, b):
        launches.add()
    return A, b


def segment_flush_stream(rows: torch.Tensor, a_blk: torch.Tensor,
                         b_blk: torch.Tensor, n_self: int,
                         out: "tuple[torch.Tensor, torch.Tensor] | None"
                         = None, packed: bool = False,
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """``segment_flush`` through the overlapped flush (K3): the same sums,
    bit for bit, and the same ``out=`` chaining. With ``packed=True`` A is
    (n_self, k²), and a given ``out`` A may be either shape. On a CUDA
    device it launches the kernel (a build or launch failure raises)."""
    k = a_blk.shape[-1]
    if out is None:
        A = a_blk.new_zeros((n_self, k * k) if packed else (n_self, k, k))
        b = b_blk.new_zeros((n_self, k))
    else:
        A, b = out
    A3 = A.view(n_self, k, k) if A.ndim == 2 else A
    if rows.device.type == "cpu":
        segment_flush_reference(rows, a_blk, b_blk, n_self, out=(A3, b))
    else:
        _on_cuda("segment_flush_stream", rows)
        if _launch("pio_segment_flush_stream", rows, a_blk, b_blk, n_self,
                   A3, b):
            launches_stream.add()
    return (A.view(n_self, k * k) if packed else A3), b
