"""Row gathers of the ALS block build: CUDA kernel wrappers and their plain
version.

Both compute ``table[idx]`` for a table (N, k) of f32 or bf16 rows and
int32 indices (M,), in the table's type (the caller casts to f32, as the
reference does, so a launch can be held bytewise to ``table[idx]``):

- ``gather_rows_stream`` (K5) replaces the Pallas TPU kernel
  ``gather_rows_stream`` -> ``_gather_kernel_stream``
  (``pio_tpu/ops/als_pallas.py``, ALS ``gather="stream"``): any table size.
- ``gather_rows_resident`` (K4) replaces ``gather_rows_pallas`` with its
  ``_gather_kernel_copy`` and ``_gather_kernel_take`` variants
  (``gather="pallas-copy" | "pallas-take"``). The reference runs it only
  for a table within ``GATHER_VMEM_TABLE_BUDGET`` (``gather_table_bytes``,
  its TPU lane padding included); ``ops/als._chunk_blocks`` applies the
  same rule before any launch, and a larger table takes ``src[i_c]``.

On a CUDA device each wrapper launches ``gather_rows.cu`` and raises if it
cannot; only for tensors on the CPU does it compute the plain version,
``gather_rows_reference``.
"""

from __future__ import annotations

import ctypes

import torch

from pio_tpu_torch.ops.kernels.build import LaunchCounter, load_library

#: launches of the streaming gather (K5; the CPU path does not count)
launches_stream = LaunchCounter()
#: launches of the resident gather (K4), both variants
launches_resident = LaunchCounter()

VARIANTS = ("copy", "take")

# copied from pio_tpu/ops/als_pallas.py: the table-size rule of the
# reference's resident gather (16 MB scoped VMEM minus the output block's
# double buffer and headroom)
GATHER_VMEM_TABLE_BUDGET = 10 * 2**20


def _lane_for(k: int) -> int:
    return max(128, -(-k // 128) * 128)  # round UP to a lane multiple


def gather_table_bytes(n_rows: int, k: int, bf16: bool) -> int:
    """Physical VMEM bytes for an (n_rows, k) factor table at TPU lane
    padding (minor dim padded UP to a multiple of 128, matching the
    padding gather_rows_pallas applies — max(128, k) would under-count
    e.g. k=192, which physically pads to 256)."""
    lane = _lane_for(k)
    return n_rows * lane * (2 if bf16 else 4)


_lib: "ctypes.CDLL | None" = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = load_library("gather_rows")
        lib.pio_gather_stream.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.pio_gather_stream.restype = ctypes.c_int
        lib.pio_gather_resident.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        lib.pio_gather_resident.restype = ctypes.c_int
        lib.pio_cuda_error_string.argtypes = [ctypes.c_int]
        lib.pio_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def gather_rows_reference(table: torch.Tensor,
                          idx: torch.Tensor) -> torch.Tensor:
    """Plain torch version: ``table[idx]``."""
    return table[idx.long()]


def _check(table: torch.Tensor, idx: torch.Tensor) -> None:
    if idx.device != table.device:
        raise ValueError(f"idx is on {idx.device}, table on {table.device}")
    if table.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"table dtype {table.dtype}; want float32 or "
                        f"bfloat16")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx dtype {idx.dtype}; want torch.int32")
    if table.ndim != 2 or idx.ndim != 1:
        raise ValueError(f"table {tuple(table.shape)} / idx "
                         f"{tuple(idx.shape)}: want (N, k) and (M,)")
    for name, t in (("table", table), ("idx", idx)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch(fn_name: str, table, idx, *extra) -> torch.Tensor:
    if table.device.type != "cuda":
        raise ValueError(f"{fn_name} runs on cuda or cpu, not "
                         f"{table.device}")
    _check(table, idx)
    m, k = idx.shape[0], table.shape[1]
    out = torch.empty((m, k), dtype=table.dtype, device=table.device)
    if m == 0 or k == 0:
        return out
    esize = table.element_size()
    vec = int((k * esize) % 16 == 0 and table.data_ptr() % 16 == 0
              and out.data_ptr() % 16 == 0)
    lib = _library()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = getattr(lib, fn_name)(
            table.data_ptr(), idx.data_ptr(), out.data_ptr(), m, k, esize,
            vec, *extra, stream)
    if err:
        raise RuntimeError(f"{fn_name} launch failed: "
                           f"{lib.pio_cuda_error_string(err).decode()}")
    return out


def gather_rows_stream(table: torch.Tensor,
                       idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` -> (M, k) in the table's dtype, for a table of any
    size; idx (M,) int32 with 0 <= idx < N. On a CUDA device it launches
    the streaming gather (a build or launch failure raises)."""
    if table.device.type == "cpu":
        return gather_rows_reference(table, idx)
    out = _launch("pio_gather_stream", table, idx)
    launches_stream.add()
    return out


def gather_rows_resident(table: torch.Tensor, idx: torch.Tensor,
                         variant: str = "copy") -> torch.Tensor:
    """``table[idx]`` with the table resident on chip (in L2 on this
    card); ``variant`` is ``"copy"`` (a warp per 8 rows, 16-byte pieces)
    or ``"take"`` (the output as one run of 16-byte vectors, four a
    thread, the row indices read once a CTA; a thread per element where
    rows are not whole vectors, for both). The caller keeps it to tables
    within ``GATHER_VMEM_TABLE_BUDGET``, as the reference does. On a CUDA
    device it launches the kernel (a build or launch failure raises)."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}; want one of {VARIANTS}")
    if table.device.type == "cpu":
        return gather_rows_reference(table, idx)
    out = _launch("pio_gather_resident", table, idx, VARIANTS.index(variant))
    launches_resident.add()
    return out
