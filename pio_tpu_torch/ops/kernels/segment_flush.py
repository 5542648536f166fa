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

``normal_equations_fused`` is K1, the port of ``_segment_kernel`` with
``_ne_slot_fn`` (``normal_equations_pallas``, which ``accum="pallas"``
runs): it takes the slot layout and the opposing factors and sums each
row's normal equations in one pass, with the gather, the weights, the
products and K2's flush fused:

    A[r] = sum of w_outer * y ⊗ y, b[r] = sum of w_rhs * y
           over the entries w < lens[s] of the slots s with rows[s] == r

y = src[idx[s, w]] in f32; w_outer, w_rhs = alpha*v, 1 + alpha*v for
implicit data and 1, v for explicit (v = val[s, w]). K1 runs its products
on the tensor cores, split into TF32 hi and lo parts so they stay
f32-accurate (three passes for f32 ``src``, two for bf16), and writes every
row of A and b itself, zeros included.

Each wrapper launches ``segment_flush.cu`` for CUDA tensors and raises if
it cannot; only for tensors on the CPU does it compute the plain version
(``segment_flush_reference``, ``normal_equations_fused_reference``). The
kernels use no float atomics: two launches on the same inputs give
bit-identical A and b. ``normal_equations_fused_fenced`` launches K1 with
its buffers fenced by poison, to show on the card that it reads and writes
nothing outside them.
"""

from __future__ import annotations

import ctypes

import torch

from pio_tpu_torch.ops.kernels.build import LaunchCounter, load_library

#: launches of the K2 kernel (the CPU path does not count)
launches = LaunchCounter()
#: launches of the K3 kernel, ``segment_flush_stream``
launches_stream = LaunchCounter()
#: launches of the K1 kernel, ``normal_equations_fused``
launches_fused = LaunchCounter()

MAX_K = 256   # the reference's own limit for the flush (ops/als.py)
#: K1's largest k (the reference's fused path states none): grid rows hold
#: (k/64)² blocks of A, and at k = 1024 a row of A is already 4 MiB
MAX_K_FUSED = 1024
# floats of one chunk of the plain K1 (gathered rows and blocks)
_PLAIN_CHUNK_FLOATS = 1 << 26

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
        lib.pio_normal_equations_fused.argtypes = (
            [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_float]
            + [ctypes.c_void_p])
        lib.pio_normal_equations_fused.restype = ctypes.c_int
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
    part_row, part_a, part_b = _partials(lib, s, k, rows.device)
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        err = getattr(lib, symbol)(
            rows.data_ptr(), a_blk.data_ptr(), b_blk.data_ptr(),
            A.data_ptr(), b.data_ptr(), part_row.data_ptr(),
            part_a.data_ptr(), part_b.data_ptr(), s, n_self, k,
            _vec(k * k, a_blk, A), _vec(k, b_blk, b), stream)
    _raise_on(lib, symbol, err)
    return True


def _partials(lib, s: int, k: int, device):
    """Scratch of the flush-and-fold: a row id and a partial (A, b) row
    for each tile of slots."""
    n_tiles = -(-s // lib.pio_segment_flush_tile())
    return (torch.empty(n_tiles, dtype=torch.int32, device=device),
            torch.empty((n_tiles, k * k), dtype=torch.float32, device=device),
            torch.empty((n_tiles, k), dtype=torch.float32, device=device))


def _raise_on(lib, symbol: str, err: int) -> None:
    if err:
        raise RuntimeError(
            f"{symbol} launch failed: "
            f"{lib.pio_cuda_error_string(err).decode()}")


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


# -- K1: the fused normal equations -------------------------------------------

def normal_equations_fused_reference(rows: torch.Tensor, idx: torch.Tensor,
                                     val: torch.Tensor, lens: torch.Tensor,
                                     src: torch.Tensor, n_self: int,
                                     implicit: bool, alpha: float,
                                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of K1: chunk by chunk of slots, the rows of
    ``src`` gathered, the masked weights, one ``bmm`` each for the blocks
    and the right-hand sides, and ``index_add_`` into (A, b), the pad slots
    (row ``n_self``) dropped through one spare row. In f32, or in f64 when
    ``src`` is f64."""
    s, w = idx.shape
    k = src.shape[1]
    dtype = torch.promote_types(src.dtype, torch.float32)
    A = torch.zeros((n_self + 1, k, k), dtype=dtype, device=src.device)
    b = torch.zeros((n_self + 1, k), dtype=dtype, device=src.device)
    step = max(1, _PLAIN_CHUNK_FLOATS // (w * k + k * k))
    cols = torch.arange(w, device=idx.device)
    for c0 in range(0, s, step):
        sl = slice(c0, c0 + step)
        y = src[idx[sl].long()].to(dtype)                    # (C, W, k)
        mask = (cols[None, :] < lens[sl, None]).to(dtype)
        v = val[sl].to(dtype)
        if implicit:
            w_outer = alpha * v * mask
            w_rhs = (1.0 + alpha * v) * mask
        else:
            w_outer, w_rhs = mask, v * mask
        r = rows[sl].long()
        yt = y.transpose(1, 2)
        A.index_add_(0, r, torch.bmm(yt, y * w_outer[:, :, None]))
        b.index_add_(0, r, torch.bmm(yt, w_rhs[:, :, None])[:, :, 0])
    return A[:n_self], b[:n_self]


def _check_fused(rows, idx, val, lens, src, n_self: int) -> None:
    dev = rows.device
    named = (("rows", rows), ("idx", idx), ("val", val), ("lens", lens),
             ("src", src))
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, rows on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("rows", rows), ("idx", idx), ("lens", lens)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} dtype {t.dtype}; want torch.int32")
    if val.dtype != torch.float32:
        raise TypeError(f"val dtype {val.dtype}; want torch.float32")
    if src.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"src dtype {src.dtype}; want float32 or bfloat16")
    if idx.ndim != 2 or src.ndim != 2:
        raise ValueError(f"idx {tuple(idx.shape)} / src {tuple(src.shape)}: "
                         f"want (S, W) and (n_other, k)")
    s, w = idx.shape
    if rows.shape != (s,) or lens.shape != (s,) or val.shape != (s, w):
        raise ValueError(f"rows {tuple(rows.shape)}, val {tuple(val.shape)}, "
                         f"lens {tuple(lens.shape)} do not match idx "
                         f"{tuple(idx.shape)}")
    if w < 1:
        raise ValueError("slot width W must be at least 1")
    if not 1 <= src.shape[1] <= MAX_K_FUSED:
        raise ValueError(f"rank {src.shape[1]} outside the fused kernel's "
                         f"1..{MAX_K_FUSED}")
    if n_self < 0:
        raise ValueError(f"n_self={n_self}")


def normal_equations_fused(rows: torch.Tensor, idx: torch.Tensor,
                           val: torch.Tensor, lens: torch.Tensor,
                           src: torch.Tensor, n_self: int, implicit: bool,
                           alpha: float,
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Normal equations of every row from the slot layout (rows (S,) int32
    non-decreasing, pads at ``n_self``; idx (S,W) int32; val (S,W) f32;
    lens (S,) int32) and the opposing factors ``src`` (n_other, k), f32 or
    bf16 -> A (n_self,k,k), b (n_self,k) f32, rows with no slot zero; the
    contract of ``normal_equations_fused_reference``. On a CUDA device it
    launches K1 (a build or launch failure raises); it refuses, on either
    device, what the kernel does not take, k above ``MAX_K_FUSED``
    included."""
    _check_fused(rows, idx, val, lens, src, n_self)
    if rows.device.type == "cpu":
        return normal_equations_fused_reference(rows, idx, val, lens, src,
                                                n_self, implicit, alpha)
    _on_cuda("normal_equations_fused", rows)
    s, k = idx.shape[0], src.shape[1]
    if not (s and n_self):
        return (torch.zeros((n_self, k, k), dtype=torch.float32,
                            device=rows.device),
                torch.zeros((n_self, k), dtype=torch.float32,
                            device=rows.device))
    # K1 writes every element of A and b, zeros included
    A = torch.empty((n_self, k, k), dtype=torch.float32, device=rows.device)
    b = torch.empty((n_self, k), dtype=torch.float32, device=rows.device)
    _launch_fused(rows, idx, val, lens, src, n_self, implicit, alpha, A, b,
                  (*_partials(_library(), s, k, rows.device),
                   _written(n_self, rows.device)))
    return A, b


def _written(n_self: int, device) -> torch.Tensor:
    """K1's scratch: a zeroed flag per row, set where a CTA assigns it."""
    return torch.zeros(n_self, dtype=torch.uint8, device=device)


def _launch_fused(rows, idx, val, lens, src, n_self: int, implicit: bool,
                  alpha: float, A, b, scratch) -> None:
    """Launch K1 into (A, b), whatever they hold, with the given scratch:
    the partials and the zeroed row flags."""
    lib = _library()
    part_row, part_a, part_b, written = scratch
    s, w = idx.shape
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        err = lib.pio_normal_equations_fused(
            rows.data_ptr(), idx.data_ptr(), val.data_ptr(),
            lens.data_ptr(), src.data_ptr(), A.data_ptr(), b.data_ptr(),
            part_row.data_ptr(), part_a.data_ptr(), part_b.data_ptr(),
            written.data_ptr(), s, w, n_self, src.shape[1],
            int(src.dtype == torch.bfloat16), int(implicit), float(alpha),
            stream)
    _raise_on(lib, "pio_normal_equations_fused", err)
    launches_fused.add()


#: elements of poison on either side of each buffer of a fenced K1 launch
#: (a multiple of 4, so float4 rows stay 16-byte aligned)
FENCE = 4096
_BAD_INDEX = 1 << 30


def _fenced(t: torch.Tensor, fill) -> tuple[torch.Tensor, torch.Tensor]:
    """A copy of ``t`` in the middle of a buffer whose ``FENCE`` elements
    on either side hold ``fill`` -> (the copy, the whole buffer)."""
    buf = torch.full((t.numel() + 2 * FENCE,), fill, dtype=t.dtype,
                     device=t.device)
    inner = buf[FENCE:FENCE + t.numel()].view(t.shape)
    inner.copy_(t)
    return inner, buf


def normal_equations_fused_fenced(rows: torch.Tensor, idx: torch.Tensor,
                                  val: torch.Tensor, lens: torch.Tensor,
                                  src: torch.Tensor, n_self: int,
                                  implicit: bool, alpha: float,
                                  ) -> tuple[torch.Tensor, torch.Tensor, bool]:
    """K1 with every buffer it touches fenced by poison, a memory check
    that needs no tool. Each input and output lies between ``FENCE``
    elements of poison: NaN for floats, an index of 2**30 for idx, lens
    and the partials' rows, row 0 for rows (a stray slot of row 0 changes
    A[0]), 7 for the row flags. Every entry at or past its slot's ``lens``
    is poisoned too, and A, b and the partials start as poison, so the
    kernel must write every element of A and b (it owns their zero-fill)
    and the fold may read only the partials the kernel wrote. A read
    outside what the kernel may read then faults or changes A or b, and a
    write outside A, b, the partials and the flags changes a
    fence. -> (A, b, fences intact); A and b equal
    ``normal_equations_fused``'s bit for bit when no read strays. CUDA
    tensors only."""
    _check_fused(rows, idx, val, lens, src, n_self)
    if rows.device.type != "cuda":
        raise ValueError(f"the fenced launch needs CUDA tensors, not "
                         f"{rows.device}")
    nan = float("nan")
    s, w = idx.shape
    k = src.shape[1]
    past = (torch.arange(w, device=idx.device)[None, :]
            >= lens[:, None].clamp(0, w))
    launch = bool(s and n_self)
    # A and b start as poison where K1 runs (it must write all of them)
    out_fill = nan if launch else 0.0
    fills = [(rows, 0), (idx.masked_fill(past, _BAD_INDEX), _BAD_INDEX),
             (val.masked_fill(past, nan), nan), (lens, _BAD_INDEX),
             (src, nan),
             (rows.new_full((n_self, k, k), out_fill, dtype=torch.float32),
              nan),
             (rows.new_full((n_self, k), out_fill, dtype=torch.float32),
              nan)]
    part_row, part_a, part_b = _partials(_library(), max(s, 1), k,
                                         rows.device)
    fills += [(part_row.fill_(_BAD_INDEX), _BAD_INDEX),
              (part_a.fill_(nan), nan), (part_b.fill_(nan), nan),
              (_written(n_self, rows.device), 7)]
    fenced = [(*_fenced(t, fill), fill) for t, fill in fills]
    inner = [t for t, _, _ in fenced]
    if launch:
        _launch_fused(*inner[:5], n_self, implicit, alpha, *inner[5:7],
                      inner[7:])
    intact = True
    for _, buf, fill in fenced:
        for edge in (buf[:FENCE], buf[-FENCE:]):
            intact &= bool((edge.isnan() if edge.is_floating_point()
                            else edge == fill).all())
    return inner[5], inner[6], intact
