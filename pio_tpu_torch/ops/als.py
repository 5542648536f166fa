"""ALS (alternating least squares) matrix factorization: training and the
scoring functions of the factor model.

Counterpart of ``pio_tpu.ops.als``, function for function (``ALSParams``,
``_device_slot_layout``, ``_chunk_blocks``, ``_normal_equations``,
``_cg_solve``, ``_solve_factors``, ``als_train``, ``als_train_validated``,
``als_build_layouts``, ``sweep_safe_params``, ``als_train_stacked``,
``als_train_sharded``, ``fold_in_params``, ``als_fold_in``;
``predict_pairs``, ``recommend_topk``, ``rmse``).
The algorithm is the reference's:

 * ratings sit in fixed-width slots sorted by row (``_device_slot_layout``,
   built on the device from the COO arrays: one stable sort, cummax,
   cumsum, one scatter);
 * each slot's normal-equation block Yᵀdiag(w)Y and right-hand side Yᵀw
   come from one batched matmul (``_chunk_blocks``), in true f32: the
   reference asks XLA for Precision.HIGH because a one-pass bf16 product
   loses ~3e-3 relative on A, which CG cannot recover, so the port never
   turns on TF32 and refuses to train on CUDA when it is on;
 * the factor rows of a chunk are gathered by ``gather``: ``src[i_c]``
   ("xla", what "auto" runs), the streaming gather kernel ("stream", K5)
   or the table-resident one ("pallas-copy"/"pallas-take", K4, for a
   table within the reference's budget; a larger table takes
   ``src[i_c]``, as in the reference), all in ``ops/kernels/gather_rows``;
 * the blocks are summed into each row's system, A (n,k,k) and b (n,k),
   by ``accum``: ``"carry"``/``"stacked"`` with ``index_add_`` on the
   CPU and, on CUDA, a round of ordered adds per slot of a row
   (``_add_blocks``: no atomics, so the sums repeat bit for bit),
   ``"hybrid"`` with the segment-flush kernel (K2), or ``"stream"`` with
   the overlapped flush (K3); ``packed_a=True`` has K3 return A
   lane-packed, (n,k²). ``"pallas"`` skips the blocks: the fused kernel
   (K1) gathers, weighs, multiplies and flushes in one pass, takes no
   ``gather``, ``packed_a`` or ``group_slots`` and returns (n,k,k) at every
   rank, as the reference's does. All three kernels are in
   ``ops/kernels/segment_flush``;
 * each side is solved by warm-started Jacobi-CG or a batched Cholesky;
   on packed A, CG's matvec is the packed matvec kernel (K6,
   ``ops/kernels/packed_matvec``).

``accum="auto"`` is ``"hybrid"`` on a CUDA device and ``"carry"`` on the
CPU: the port takes the card for the reference's accelerator, whose auto
mode is hybrid; ``gather="auto"`` is "xla" everywhere, as in the
reference. Every accum and gather mode of the reference runs, and no mode
runs another in its place. JAX's
``jit``/``scan`` become plain Python loops over eagerly launched torch ops;
the threefry init becomes a seeded ``torch.Generator`` (the two give
different numbers; tests pass ``init=``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import numpy as np
import torch

from pio_tpu_torch.ops import topk
from pio_tpu_torch.ops.bucketing import (
    MIN_SCORING_COLUMNS, dispatch_rows, padded_rows, pow2_bucket,
)
from pio_tpu_torch.ops.kernels.gather_rows import (
    GATHER_VMEM_TABLE_BUDGET,
    gather_rows_resident,
    gather_rows_stream,
    gather_table_bytes,
)
from pio_tpu_torch.ops.kernels.packed_matvec import packed_block_matvec
from pio_tpu_torch.ops.kernels.segment_flush import (
    normal_equations_fused,
    segment_flush,
    segment_flush_stream,
)
from pio_tpu_torch.workflow.context import resolve_device


@dataclass(frozen=True)
class ALSParams:
    """Same fields, defaults and meaning as ``pio_tpu.ops.als.ALSParams``
    (whose comments carry the measurements behind each default)."""

    rank: int = 16
    iterations: int = 10
    reg: float = 0.1
    alpha: float = 1.0
    implicit: bool = False
    seed: int = 3
    chunk: int = 65536        # nnz padding quantum
    width: int = 128          # ratings per slot
    chunk_slots: int = 8192   # slots per block build (bounds gather temp)
    bf16_gather: bool = True
    cg_iters: int = -1        # -1 auto per side, 0 Cholesky, >0 CG iters
    auto_cg_rows: int = 8192
    cg_warm_iters: int = 6
    cg_warm_sweeps: int = 2
    accum: str = "auto"
    packed_a: bool = False
    group_slots: int = 73728
    gather: str = "auto"

    _GATHER_MODES = ("auto", "xla", "pallas-copy", "pallas-take", "stream")
    _ACCUM_MODES = ("auto", "carry", "stacked", "pallas", "hybrid", "stream")

    def __post_init__(self):
        if self.gather not in self._GATHER_MODES:
            raise ValueError(
                f"ALSParams.gather={self.gather!r}; "
                f"expected one of {self._GATHER_MODES}")
        if self.accum not in self._ACCUM_MODES:
            raise ValueError(
                f"ALSParams.accum={self.accum!r}; "
                f"expected one of {self._ACCUM_MODES}")

    def resolved_cg_iters(self, n_self: int | None = None) -> int:
        """-1 (default) = auto, per factor side: exact Cholesky (0) for
        sides of at most ``auto_cg_rows`` rows, else warm-started CG at
        max(16, rank // 4) iterations. With n_self=None, the CG cap."""
        if self.cg_iters >= 0:
            return self.cg_iters
        if n_self is not None and n_self <= self.auto_cg_rows:
            return 0
        return max(16, self.rank // 4)

    def resolved_accum(self, device) -> str:
        """The accumulation that runs on ``device``: "auto" is "hybrid"
        on CUDA and "carry" on the CPU, packed_a promotes hybrid to
        stream (only the streaming flush writes packed rows), and hybrid
        and stream fall back to stacked above rank 256 (the reference's
        limit for the flush kernels; keep in sync with
        _normal_equations). "pallas" stays itself at every rank and with
        packed_a."""
        mode = self.accum
        if mode == "auto":
            mode = "hybrid" if _accelerator_backend(device) else "carry"
        if self.packed_a and mode == "hybrid":
            mode = "stream"
        if mode in ("hybrid", "stream") and self.rank > 256:
            mode = "stacked"
        return mode

    def resolved_packed(self, device) -> bool:
        """True when A flows lane-packed on ``device``: packed_a asked for
        and the streaming flush runs (the other paths give (n,k,k))."""
        return self.packed_a and self.resolved_accum(device) == "stream"


@dataclass(frozen=True)
class ALSValidation:
    """Per-sweep heldout trajectory from ``als_train_validated`` (the
    reference's ``ALSValidation``, same fields).

    The reference's eval workflow picks the best PARAMS but always keeps
    the LAST sweep's model; when the heldout RMSE curve bottoms early
    and then climbs, "final" commits the worst point on its own curve.
    So the trainer tracks the argmin sweep's factors (a copy, selected
    on the device after every sweep) and returns the curve's minimum,
    not its tail."""

    curve: tuple          # heldout RMSE after each sweep, in order
    best_sweep: int       # 1-based sweep index of the minimum
    best_rmse: float
    final_rmse: float     # last sweep's RMSE (what "no selection" returns)


@dataclass(frozen=True)
class ALSLayouts:
    """Both slot layouts, resident on the device and reusable across
    ``als_train`` calls (``als_train(..., layouts=)``): retrain loops,
    per-sweep trajectory evaluations and warm-started continuations pay
    the layout build once. About twice the COO bytes on the device (ids
    and values padded to slot width), freed when the object is dropped.
    ``chip_smoke.py`` times the build against the sweeps at the ML-20M
    shape."""

    by_user: tuple     # (rows, idx, val, lens) device tensors
    by_item: tuple
    cs: int
    n_users: int
    n_items: int
    width: int         # layouts are rank-blind: any rank trains on them


@dataclass
class ALSModel:
    """Factor matrices (f32). user_factors: (n_users, k); item_factors:
    (n_items, k)."""

    user_factors: torch.Tensor
    item_factors: torch.Tensor


def _accelerator_backend(device) -> bool:
    return torch.device(device).type == "cuda"


def blocks_group_budget_slots(k: int) -> int:
    """Max slots whose (k,k) f32 blocks are materialized at once (1.2 GB
    of blocks; the stacked and hybrid paths group by it)."""
    return max(1, (1_200 * 2**20) // (k * k * 4))


def _slots_for(nnz: int, n_self: int, width: int, chunk_slots: int) -> int:
    """Static upper bound on slot count, padded to a chunk multiple: at
    most min(n_self, nnz) non-empty rows plus nnz // width splits."""
    s = nnz // width + 1 + min(n_self, nnz)
    return math.ceil(s / chunk_slots) * chunk_slots


def _device_slot_layout(u, o, v, n_self: int, width: int, slots_max: int):
    """Build the slot layout on the device from (possibly sentinel-padded)
    COO. u: (nnz,) int32 row ids, entries with u >= n_self are padding and
    are dropped; o: opposing-side ids; v: values. Returns (rows (S,) int32,
    idx (S,width) int32, val (S,width) f32, lens (S,) int32), element for
    element the reference's: rows is non-decreasing, unused slots carry
    the sentinel row n_self. Dropped entries land in one spare slot past
    the end (the reference's mode="drop")."""
    dev = u.device
    nnz = u.shape[0]
    u_s, perm = torch.sort(u, stable=True)
    o_s, v_s = o[perm], v[perm]
    t = torch.arange(nnz, device=dev)
    newrow = torch.ones(nnz, dtype=torch.bool, device=dev)
    newrow[1:] = u_s[1:] != u_s[:-1]
    row_start = torch.cummax(torch.where(newrow, t, 0), 0).values
    pos = t - row_start                       # position within the row
    newslot = newrow | (pos % width == 0)     # heavy rows split every width
    slot_id = torch.cumsum(newslot, 0) - 1
    col = pos % width
    keep = (u_s < n_self) & (slot_id < slots_max)
    slot_id = torch.where(keep, slot_id, slots_max)

    rows = torch.full((slots_max + 1,), n_self, dtype=torch.int32,
                      device=dev)
    rows.scatter_reduce_(0, slot_id, u_s.to(torch.int32), "amin")
    lens = torch.bincount(slot_id, minlength=slots_max + 1).to(torch.int32)
    flat = slot_id * width + col
    idx = torch.zeros((slots_max + 1) * width, dtype=torch.int32,
                      device=dev)
    idx[flat] = o_s.to(torch.int32)
    val = torch.zeros((slots_max + 1) * width, dtype=torch.float32,
                      device=dev)
    val[flat] = v_s.to(torch.float32)
    return (rows[:slots_max],
            idx.view(slots_max + 1, width)[:slots_max],
            val.view(slots_max + 1, width)[:slots_max],
            lens[:slots_max])


def _gather(src, i_c, gather: str):
    """The factor rows of one chunk, (C, W, k) in src's dtype: the
    reference's _chunk_blocks gather, mode by mode."""
    C, W = i_c.shape
    k = src.shape[1]
    if gather == "stream":
        return gather_rows_stream(src, i_c.reshape(-1)).view(C, W, k)
    if gather.startswith("pallas"):
        # the reference's table-size rule, decided before any launch
        fits = gather_table_bytes(
            src.shape[0], k,
            src.dtype == torch.bfloat16) <= GATHER_VMEM_TABLE_BUDGET
        if fits:
            return gather_rows_resident(
                src, i_c.reshape(-1),
                variant=gather.split("-", 1)[1]).view(C, W, k)
    return src[i_c]


def _slot_alpha(alpha, lo: int, hi: int):
    """The confidence weight of slots [lo, hi): a float shared by every
    slot, or a per-slot (S,) tensor (the stacked sweep's candidates)
    sliced to the range and shaped to broadcast over the slot width."""
    if torch.is_tensor(alpha):
        return alpha[lo:hi, None]
    return alpha


def _chunk_blocks(src, i_c, v_c, l_c, implicit: bool, alpha,
                  out=None, gather: str = "xla"):
    """One slot chunk -> per-slot normal-equation blocks a_blk (C,k,k),
    b_blk (C,k), by batched matmuls in f32. ``out=(a, b)`` writes the
    blocks into those buffers. ``alpha`` is a float or a (C, 1) tensor
    of per-slot weights (``_slot_alpha``): the product alpha * v is the
    same f32 multiplication either way."""
    W = i_c.shape[1]
    mask = (torch.arange(W, device=i_c.device)[None, :]
            < l_c[:, None]).to(torch.float32)
    y = _gather(src, i_c, gather).to(torch.float32)     # (C, W, k)
    if implicit:
        # c = 1 + alpha*v; A += (c-1) y y^T ; b += c * y   (p == 1)
        w_outer = alpha * v_c * mask
        w_rhs = (1.0 + alpha * v_c) * mask
    else:
        w_outer = mask
        w_rhs = v_c * mask
    a_out, b_out = out if out is not None else (None, None)
    a_blk = torch.bmm((y * w_outer[:, :, None]).transpose(1, 2), y,
                      out=a_out)
    b_blk = torch.bmm(y.transpose(1, 2), w_rhs[:, :, None],
                      out=None if b_out is None else b_out[:, :, None])
    return a_blk, b_blk.reshape(b_blk.shape[0], -1)


def _group_bounds(S: int, k: int, chunk_slots: int, group_slots: int):
    """[lo, hi) slot bounds of the groups whose blocks the stacked and
    hybrid accumulations materialize at once: whole chunks, at most
    min(group_slots, blocks_group_budget_slots(k)) slots. The reference's
    hybrid path pads S to lcm(kernel chunk, chunk_slots) first; its
    kernel chunk is a power of two that divides chunk_slots, and S is a
    multiple of chunk_slots already, so that pad is always empty."""
    per_group = max(1, min(group_slots, blocks_group_budget_slots(k))
                    // chunk_slots)
    g_slots = per_group * chunk_slots
    return [(lo, min(S, lo + g_slots)) for lo in range(0, S, g_slots)]


def _group_blocks(src, idx, val, lens, lo: int, hi: int, chunk_slots: int,
                  implicit: bool, alpha, gather: str = "xla"):
    """The blocks of slots [lo, hi), built chunk by chunk into one buffer
    (the reference's lax.scan with the blocks as outputs)."""
    k = src.shape[1]
    a_blks = torch.empty((hi - lo, k, k), dtype=torch.float32,
                         device=src.device)
    b_blks = torch.empty((hi - lo, k), dtype=torch.float32,
                         device=src.device)
    for c0 in range(lo, hi, chunk_slots):
        c1 = min(hi, c0 + chunk_slots)
        _chunk_blocks(src, idx[c0:c1], val[c0:c1], lens[c0:c1], implicit,
                      _slot_alpha(alpha, c0, c1),
                      out=(a_blks[c0 - lo:c1 - lo],
                                  b_blks[c0 - lo:c1 - lo]), gather=gather)
    return a_blks, b_blks


def _normal_equations(layout, other_factors, n_self, implicit: bool,
                      alpha, chunk_slots: int,
                      bf16_gather: bool = False, accum: str = "auto",
                      group_slots: int = 73728, gather: str = "auto",
                      packed: bool = False):
    """Accumulate per-row normal equations A (n_self,k,k), b (n_self,k)
    (without the shared YᵀY and reg terms, which the solve adds).

    "carry" adds each chunk's blocks into A (``_add_blocks``: each row's
    slots in slot order); "stacked" builds a group of chunks' blocks,
    then adds the group the same way;
    "hybrid" builds the same groups and flushes each with the segment
    flush kernel, which writes each finished row once and folds a row
    that runs across tiles and groups in slot order; "stream" does the
    same through the overlapped flush (bit-identical sums); "pallas"
    runs the fused kernel on the layout itself, with no blocks, groups or
    gather. Pad slots carry the sentinel row n_self: the index_add_ paths
    drop them into one spare row, the kernels stop at them.

    packed=True asks for A lane-packed, (n_self, k²): hybrid is promoted
    to stream, the only flush that writes it, and the other paths return
    (n,k,k) all the same (callers tell the form by A.ndim, see
    _solve_factors).

    ``alpha`` is a float, or a per-slot (S,) tensor on the carry and
    stacked paths (the stacked sweep, ``als_train_stacked``)."""
    rows, idx, val, lens = layout
    k = other_factors.shape[1]
    S = idx.shape[0]
    dev = other_factors.device
    src = (other_factors.to(torch.bfloat16) if bf16_gather
           else other_factors)
    if accum == "auto":
        # keep in sync with ALSParams.resolved_accum
        accum = "hybrid" if _accelerator_backend(dev) else "carry"
    if gather == "auto":
        gather = "xla"
    if S % chunk_slots:
        raise ValueError(f"{S} slots is not a multiple of chunk_slots "
                         f"{chunk_slots}")
    if accum == "pallas":
        # the fused kernel sizes its own work: it takes the whole layout and
        # gives (n,k,k) whatever packed, gather or the rank ask
        return normal_equations_fused(rows, idx, val, lens, src, n_self,
                                      implicit, alpha)
    if packed and accum == "hybrid":
        accum = "stream"
    if accum in ("hybrid", "stream") and k > 256:
        accum = "stacked"

    if accum in ("hybrid", "stream"):
        packed = packed and accum == "stream"
        A = torch.zeros((n_self, k * k) if packed else (n_self, k, k),
                        dtype=torch.float32, device=dev)
        b = torch.zeros((n_self, k), dtype=torch.float32, device=dev)
        for lo, hi in _group_bounds(S, k, chunk_slots, group_slots):
            a_blks, b_blks = _group_blocks(src, idx, val, lens, lo, hi,
                                           chunk_slots, implicit, alpha,
                                           gather)
            if accum == "hybrid":
                segment_flush(rows[lo:hi], a_blks, b_blks, n_self,
                              out=(A, b))
            else:
                segment_flush_stream(rows[lo:hi], a_blks, b_blks, n_self,
                                     out=(A, b), packed=packed)
        return A, b

    # one spare row takes the sentinel slots
    A = torch.zeros((n_self + 1, k, k), dtype=torch.float32, device=dev)
    b = torch.zeros((n_self + 1, k), dtype=torch.float32, device=dev)
    if accum == "carry":
        for c0 in range(0, S, chunk_slots):
            c1 = c0 + chunk_slots
            a_blk, b_blk = _chunk_blocks(src, idx[c0:c1], val[c0:c1],
                                         lens[c0:c1], implicit,
                                         _slot_alpha(alpha, c0, c1),
                                         gather=gather)
            _add_blocks(A, b, rows[c0:c1], a_blk, b_blk, n_self)
    elif accum == "stacked":
        for lo, hi in _group_bounds(S, k, chunk_slots, group_slots):
            a_blks, b_blks = _group_blocks(src, idx, val, lens, lo, hi,
                                           chunk_slots, implicit, alpha,
                                           gather)
            _add_blocks(A, b, rows[lo:hi], a_blks, b_blks, n_self)
    else:
        raise ValueError(f"unknown accum mode {accum!r}")
    return A[:n_self], b[:n_self]


def _add_blocks(A, b, rows, a_blk, b_blk, n_self: int) -> None:
    """A[rows[s]] += a_blk[s], b likewise, for the slots of one chunk or
    group, each row's blocks summed in slot order.

    On the CPU ``index_add_`` adds the slots one after another, which is
    that order. On CUDA it adds with atomics, in an order that changes
    from run to run, so there the slots go in rounds instead: round j adds
    the j-th slot of every row, one add per row and no atomics. A row's
    slots are contiguous and ``rows`` does not decrease, so every row sums
    ((b0 + b1) + b2)... whatever the other rows of the chunk are. Sentinel
    slots (row n_self) are dropped."""
    r = rows.long()
    if not _accelerator_backend(A.device):
        A.index_add_(0, r, a_blk)
        b.index_add_(0, r, b_blk)
        return
    t = torch.arange(r.shape[0], device=r.device)
    first = torch.ones_like(r, dtype=torch.bool)
    first[1:] = r[1:] != r[:-1]
    pos = t - torch.cummax(torch.where(first, t, 0), 0).values
    real = r < n_self
    # slots by round, in slot order within a round; the sentinel's run,
    # which can be a whole chunk long, sorts past every round
    key = torch.where(real, pos, r.shape[0])
    order = torch.sort(key, stable=True).indices
    counts = torch.bincount(key[real]).tolist()
    lo = 0
    for n in counts:
        sel = order[lo:lo + n]
        lo += n
        rj = r[sel]
        A[rj] = A[rj] + a_blk[sel]
        b[rj] = b[rj] + b_blk[sel]


def _cg_body(mv, dinv, b, x0, n_iter: int):
    """The Jacobi-CG iteration (the reference's fori_loop body)."""
    x = x0
    r = b - mv(x)
    z = r * dinv
    p = z
    rz = torch.sum(r * z, -1)
    for _ in range(n_iter):
        ap = mv(p)
        alpha = rz / torch.clamp(torch.sum(p * ap, -1), min=1e-30)
        x = x + alpha[:, None] * p
        r = r - alpha[:, None] * ap
        z = r * dinv
        rz_new = torch.sum(r * z, -1)
        beta = rz_new / torch.clamp(rz, min=1e-30)
        p = z + beta[:, None] * p
        rz = rz_new
    return x


def _cg_solve(A, b, x0, n_iter: int):
    """Batched Jacobi-preconditioned conjugate gradient for SPD systems;
    the matvec is one batched matmul in f32."""
    dinv = 1.0 / torch.diagonal(A, dim1=1, dim2=2)

    def mv(x):
        return torch.bmm(A, x[:, :, None])[:, :, 0]

    return _cg_body(mv, dinv, b, x0, n_iter)


def _cg_solve_packed(A, b, x0, n_iter: int):
    """_cg_solve on lane-packed A (n, k²): the matvec is the packed
    matvec kernel, and the Jacobi diagonal a strided view of the packed
    rows, so A is never unpacked or copied."""
    k = b.shape[1]
    dinv = 1.0 / A[:, ::k + 1]

    def mv(x):
        return packed_block_matvec(A, x)

    return _cg_body(mv, dinv, b, x0, n_iter)


def _shared_yty(other_factors, yty):
    """Shared YᵀY term (the confidence-1 part of implicit A)."""
    if yty is not None:
        return yty
    return other_factors.T @ other_factors


def _solve_packed(A, b, reg, implicit, other_factors, yty, x0,
                  cg_iters: int):
    """The solve on lane-packed A (n, k²) from the streaming flush. YᵀY
    and reg are added in place in packed space (the diagonal of a packed
    row is every (k+1)-th element). CG runs on the packed matvec; an
    exact-Cholesky side (cg_iters 0) takes a free (n,k,k) view. The
    reference pads n to its matvec's row block here; the port's kernel
    takes any n, so A (2.3 GB at the ML-20M users side) is never
    copied."""
    n_self, k2 = A.shape
    k = b.shape[1]
    if implicit:
        A += _shared_yty(other_factors, yty).reshape(1, k2)
    A[:, ::k + 1].add_(reg)
    if cg_iters <= 0:
        chol = torch.linalg.cholesky(A.view(n_self, k, k))
        return torch.cholesky_solve(b[:, :, None], chol)[:, :, 0]
    if x0 is None:
        x0 = torch.zeros_like(b)
    return _cg_solve_packed(A, b, x0, cg_iters)


def _solve_factors(layout, other_factors, n_self, reg, implicit, alpha,
                   chunk_slots, x0=None, cg_iters: int = 0,
                   bf16_gather: bool = False, accum: str = "auto",
                   group_slots: int = 73728, yty=None,
                   gather: str = "auto", packed: bool = False):
    A, b = _normal_equations(
        layout, other_factors, n_self, implicit, alpha, chunk_slots,
        bf16_gather=bf16_gather, accum=accum, group_slots=group_slots,
        gather=gather, packed=packed,
    )
    return _solve_system(A, b, reg, implicit, other_factors, yty, x0,
                         cg_iters)


def _solve_system(A, b, reg, implicit, other_factors, yty, x0,
                  cg_iters: int):
    """Add the shared YᵀY (implicit) and reg terms to A in place and
    solve: CG from x0 (cg_iters > 0) or the exact Cholesky."""
    if A.ndim == 2:
        # the streaming flush wrote lane-packed (n, k²) rows
        return _solve_packed(A, b, reg, implicit, other_factors, yty, x0,
                             cg_iters)
    # in place: A is this call's own buffer, and at the ML-20M shape a
    # copy of it is 2.3 GB
    if implicit:
        A += _shared_yty(other_factors, yty)[None, :, :]
    A.diagonal(dim1=1, dim2=2).add_(reg)
    if cg_iters > 0:
        if x0 is None:
            x0 = torch.zeros_like(b)
        return _cg_solve(A, b, x0, cg_iters)
    chol = torch.linalg.cholesky(A)
    return torch.cholesky_solve(b[:, :, None], chol)[:, :, 0]


def init_factors(n: int, rank: int, generator: torch.Generator):
    """MLlib-style init: |normal| / sqrt(rank), drawn on the generator's
    device."""
    return torch.abs(torch.randn(
        (n, rank), generator=generator, dtype=torch.float32,
        device=generator.device)) / math.sqrt(rank)


def _cg_schedule(params: ALSParams, cg_u: int, cg_i: int):
    """-> (n_full, n_warm, w_u, w_i): how many sweeps run at full CG
    strength vs at the warm count, and the per-side warm iteration
    counts (a side on the exact-Cholesky path, cg=0, stays exact)."""
    n_full = params.iterations
    n_warm = 0
    # >= 1: cg_iters=0 is the exact-Cholesky sentinel
    if 1 <= params.cg_warm_iters < max(cg_u, cg_i):
        n_full = min(params.iterations, max(0, params.cg_warm_sweeps))
        n_warm = params.iterations - n_full
    w_u = params.cg_warm_iters if cg_u > 0 else cg_u
    w_i = params.cg_warm_iters if cg_i > 0 else cg_i
    return n_full, n_warm, w_u, w_i


def _build_layouts(u, i, v, n_users: int, n_items: int, params: ALSParams):
    """Slot layouts for both halves + the chunk size actually used."""
    nnz = u.shape[0]
    cs = min(params.chunk_slots, _slots_for(nnz, 0, params.width, 1))
    su = _slots_for(nnz, n_users, params.width, cs)
    si = _slots_for(nnz, n_items, params.width, cs)
    by_user = _device_slot_layout(u, i, v, n_users, params.width, su)
    by_item = _device_slot_layout(i, u, v, n_items, params.width, si)
    return by_user, by_item, cs


def _sweep_factory(by_user, by_item, n_users: int, n_items: int, cs: int,
                   params: ALSParams):
    """-> sweep_with(cg_u_n, cg_i_n) -> sweep((users, items)) -> (users,
    items): one sweep solves the users against the items, then the items
    against the new users."""
    def sweep_with(cg_u_n: int, cg_i_n: int):
        def sweep(carry):
            users, items = carry
            users = _solve_factors(
                by_user, items, n_users, params.reg, params.implicit,
                params.alpha, cs, x0=users, cg_iters=cg_u_n,
                bf16_gather=params.bf16_gather, accum=params.accum,
                group_slots=params.group_slots, gather=params.gather,
                packed=params.packed_a,
            )
            items = _solve_factors(
                by_item, users, n_items, params.reg, params.implicit,
                params.alpha, cs, x0=items, cg_iters=cg_i_n,
                bf16_gather=params.bf16_gather, accum=params.accum,
                group_slots=params.group_slots, gather=params.gather,
                packed=params.packed_a,
            )
            return users, items
        return sweep
    return sweep_with


def _run_schedule(sweep_with, params: ALSParams, cg_u: int, cg_i: int,
                  carry, after_sweep=None):
    """Full-strength CG for the first sweeps, cg_warm_iters after.
    ``after_sweep(carry)`` runs after every sweep (the validated
    trainer's heldout score)."""
    n_full, n_warm, w_u, w_i = _cg_schedule(params, cg_u, cg_i)
    for n, sweep in ((n_full, sweep_with(cg_u, cg_i)),
                     (n_warm, sweep_with(w_u, w_i))):
        for _ in range(n):
            carry = sweep(carry)
            if after_sweep is not None:
                after_sweep(carry)
    return carry


def _require_f32_matmul(device: torch.device) -> None:
    """The normal equations need true f32 products: refuse to train on
    CUDA with TF32 matmuls turned on."""
    if device.type == "cuda" and (
            torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "ALS training needs f32 matmuls: TF32 is on "
            "(torch.backends.cuda.matmul.allow_tf32 / "
            "torch.set_float32_matmul_precision); a 10-bit product loses "
            "about 1e-3 relative on A, which the CG solve cannot recover")


def als_build_layouts(user_idx, item_idx, values, n_users: int,
                      n_items: int, params: ALSParams,
                      device=None) -> ALSLayouts:
    """Build both slot layouts on the device and return them for reuse
    via ``als_train(..., layouts=...)``. Inputs as for ``als_train``."""
    dev = resolve_device(device)
    u, i, v = _prep_coo(user_idx, item_idx, values, n_users, n_items,
                        params, dev)
    by_user, by_item, cs = _build_layouts(u, i, v, n_users, n_items, params)
    return ALSLayouts(by_user, by_item, cs, n_users, n_items, params.width)


def _train_schedule(layouts: ALSLayouts, params: ALSParams, carry,
                    after_sweep=None):
    """Every sweep of the schedule over prebuilt layouts."""
    cg_u = params.resolved_cg_iters(layouts.n_users)
    cg_i = params.resolved_cg_iters(layouts.n_items)
    sweep_with = _sweep_factory(layouts.by_user, layouts.by_item,
                                layouts.n_users, layouts.n_items,
                                layouts.cs, params)
    return _run_schedule(sweep_with, params, cg_u, cg_i, carry,
                         after_sweep)


def als_train(user_idx, item_idx, values, n_users: int, n_items: int,
              params: ALSParams, init: ALSModel | None = None,
              device=None, layouts: ALSLayouts | None = None) -> ALSModel:
    """Train on one device: CUDA unless ``device="cpu"`` is asked for.

    Inputs are numpy arrays or torch tensors of dense ids and values.
    ``init`` warm-starts from an existing model (any device; its factors
    are copied to ``device`` as f32) in place of the seeded init.
    ``layouts`` (from ``als_build_layouts``, same data and params, on
    ``device``) skips the layout build; the COO arguments are ignored
    then (pass the same arrays for clarity)."""
    dev = resolve_device(device)
    _require_f32_matmul(dev)
    if layouts is not None and (
            layouts.n_users, layouts.n_items, layouts.width) != (
            n_users, n_items, params.width):
        raise ValueError(
            f"layouts built for shape ({layouts.n_users}, "
            f"{layouts.n_items}, width {layouts.width}), train called "
            f"with ({n_users}, {n_items}, width {params.width})")
    user0, item0 = _init_or(init, n_users, n_items, params, dev)
    if layouts is None:
        layouts = als_build_layouts(user_idx, item_idx, values, n_users,
                                    n_items, params, dev)
    users, items = _train_schedule(layouts, params, (user0, item0))
    return ALSModel(users, items)


def als_train_validated(user_idx, item_idx, values, n_users: int,
                        n_items: int, params: ALSParams, val_user_idx,
                        val_item_idx, val_values,
                        init: ALSModel | None = None,
                        device=None) -> tuple[ALSModel, ALSValidation]:
    """Train with a heldout slice scored after every sweep; return the
    BEST-sweep model plus the full trajectory (see ALSValidation). The
    heldout slice must be disjoint from the training triples; for
    implicit models the curve is RMSE of raw scores against the heldout
    values — a proxy, but a monotone regression on it still flags
    overfit sweeps.

    The sweeps are ``als_train``'s. After each, the heldout RMSE is
    computed on the device and the factors of the lowest one so far
    (strict ``<``) are kept in a copy, selected on the device; the
    returned ``best_sweep`` is the argmin of the unrounded curve, which
    is then rounded to 6 places."""
    dev = resolve_device(device)
    _require_f32_matmul(dev)
    user0, item0 = _init_or(init, n_users, n_items, params, dev)
    layouts = als_build_layouts(user_idx, item_idx, values, n_users,
                                n_items, params, dev)
    vu, vi = _index(val_user_idx, dev), _index(val_item_idx, dev)
    vv = torch.as_tensor(np.asarray(val_values, np.float32), device=dev)
    best = [user0, item0, torch.full((), math.inf, device=dev)]
    curve = []

    def score(carry):
        users, items = carry
        # a product and a row sum: einsum runs it as a batched GEMM of
        # one-element outputs, one per heldout pair
        pred = (users[vu] * items[vi]).sum(dim=1)
        r = torch.sqrt(torch.mean((pred - vv) ** 2))
        better = r < best[2]
        best[0] = torch.where(better, users, best[0])
        best[1] = torch.where(better, items, best[1])
        best[2] = torch.where(better, r, best[2])
        curve.append(r)

    _train_schedule(layouts, params, (user0, item0), after_sweep=score)
    raw = torch.stack(curve).cpu().numpy()
    # argmin on the UNROUNDED curve: the strict `r < best` keeps the
    # truly-lowest sweep, and ties after rounding must not relabel it
    best_sweep = int(np.argmin(raw)) + 1
    curve_h = tuple(round(float(x), 6) for x in raw)
    return ALSModel(best[0], best[1]), ALSValidation(
        curve=curve_h,
        best_sweep=best_sweep,
        best_rmse=curve_h[best_sweep - 1],
        final_rmse=curve_h[-1],
    )


def _prep_coo(user_idx, item_idx, values, n_users, n_items,
              params: ALSParams, device):
    """COO arrays as int32/f32 tensors on ``device``, sentinel-padded to
    a ``params.chunk`` multiple: padding entries carry the sentinel id on
    both sides (u = n_users, i = n_items), so either layout drops them."""
    def to(x, dtype):
        if not torch.is_tensor(x):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(device, dtype)

    u = to(user_idx, torch.int32)
    i = to(item_idx, torch.int32)
    v = to(values, torch.float32)
    pad = -u.shape[0] % max(1, params.chunk)
    if pad:
        u = torch.cat([u, u.new_full((pad,), n_users)])
        i = torch.cat([i, i.new_full((pad,), n_items)])
        v = torch.cat([v, v.new_zeros(pad)])
    return u, i, v


def _init_or(init: ALSModel | None, n_users: int, n_items: int,
             params: ALSParams, device):
    if init is not None:
        return (init.user_factors.to(device, torch.float32),
                init.item_factors.to(device, torch.float32))
    g = torch.Generator(device=device)
    g.manual_seed(params.seed)
    return (init_factors(n_users, params.rank, g),
            init_factors(n_items, params.rank, g))


# ---------------------------------------------------------------------------
# stacked multi-candidate path — the hyperparameter sweep's batched train:
# one layout build trains EVERY candidate that shares the static shape
# config (rank, iterations, implicit, CG schedule); candidates differ only
# in (reg, alpha)
# ---------------------------------------------------------------------------

def sweep_safe_params(params: ALSParams, device=None) -> ALSParams:
    """The static config the stacked trainer actually runs, as the
    reference's: the plain accumulation paths (carry on the CPU, stacked
    on CUDA) with the plain gather. The kernels (hybrid/stream/packed/
    fused) are written for one candidate's block shapes; the stacked
    program trades them for candidate-level batching."""
    accum = ("stacked" if _accelerator_backend(resolve_device(device))
             else "carry")
    return replace(params, accum=accum, gather="xla", packed_a=False)


@dataclass
class StackedALSModel:
    """C candidates' factors: user_factors (C, n_users, k), item_factors
    (C, n_items, k)."""

    user_factors: torch.Tensor
    item_factors: torch.Tensor

    def __len__(self) -> int:
        return int(self.user_factors.shape[0])

    def candidate(self, c: int) -> ALSModel:
        return ALSModel(self.user_factors[c], self.item_factors[c])


def _stack_layout(layout, n_self: int, n_other: int, n_cand: int):
    """One half's slot layout repeated for C candidates with the
    candidate axis folded into the rows: candidate c's row r is row
    c*n_self + r and its opposing ids index the stacked (C*n_other, k)
    factors at c*n_other + o. Unused slots keep the sentinel, now
    C*n_self. Every candidate's slots stay whole chunks (S is a
    chunk multiple), so a chunk's blocks are the batched matmul of the
    same shape and data as in a single candidate's training."""
    rows, idx, val, lens = layout
    S = rows.shape[0]
    c = torch.arange(n_cand, device=rows.device).repeat_interleave(S)
    rows_c = rows.repeat(n_cand)
    rows_c = torch.where(rows_c < n_self, rows_c + c * n_self,
                         n_cand * n_self).to(torch.int32)
    idx_c = (idx.repeat(n_cand, 1) + (c * n_other)[:, None]
             ).to(torch.int32)
    return rows_c, idx_c, val.repeat(n_cand, 1), lens.repeat(n_cand)


def _solve_stacked(layout, other, n_self: int, regs, alphas_slot,
                   params: ALSParams, cs: int, x0, cg_iters: int):
    """One half-sweep of every candidate: the normal equations of all
    C*n_self rows in one accumulation (blocks built with each slot's own
    alpha), then each candidate's rows solved alone with its own reg and
    YᵀY, on the same shapes a single-candidate solve has."""
    n_cand = len(regs)
    A, b = _normal_equations(
        layout, other, n_cand * n_self, params.implicit, alphas_slot, cs,
        bf16_gather=params.bf16_gather, accum=params.accum,
        group_slots=params.group_slots, gather=params.gather)
    n_other = other.shape[0] // n_cand
    out = []
    for c in range(n_cand):
        rs = slice(c * n_self, (c + 1) * n_self)
        out.append(_solve_system(
            A[rs], b[rs], float(regs[c]), params.implicit,
            other[c * n_other:(c + 1) * n_other], None, x0[rs], cg_iters))
    return torch.cat(out)


def als_train_stacked(user_idx, item_idx, values, n_users: int,
                      n_items: int, params: ALSParams, regs, alphas,
                      device=None,
                      init: ALSModel | None = None) -> StackedALSModel:
    """Train C candidates sharing ``params``' static config as one
    program, differing per candidate only in (reg, alpha).

    The candidate count is rounded up to a power of two (the padding
    repeats the last candidate) and the padding is trimmed before
    returning, as in the reference. The layout is built once, and every
    candidate starts from the same seeded init (or ``init``). The
    candidate axis is folded into the row axis (``_stack_layout``): the
    plain accumulation (``sweep_safe_params``: carry on the CPU, the
    ordered rounds of stacked on CUDA) and the solves then run over
    C*n rows, so candidate c's factors are those of a sequential
    ``als_train(sweep_safe_params(params with c's reg and alpha))``
    from the same init: each row's blocks, their sums in slot order and
    the solve are the same operations on the same shapes. The
    reference's ``mesh=`` (candidates sharded over devices) is not
    ported: the port holds one device."""
    dev = resolve_device(device)
    _require_f32_matmul(dev)
    params = sweep_safe_params(params, dev)
    regs = np.ascontiguousarray(regs, dtype=np.float32)
    alphas = np.ascontiguousarray(alphas, dtype=np.float32)
    if regs.shape != alphas.shape or regs.ndim != 1 or not len(regs):
        raise ValueError(
            f"regs/alphas must be equal-length 1-d vectors, got "
            f"{regs.shape} / {alphas.shape}")
    n_cand = len(regs)
    bucket = pow2_bucket(n_cand)
    if bucket != n_cand:
        regs = np.concatenate(
            [regs, np.full(bucket - n_cand, regs[-1], np.float32)])
        alphas = np.concatenate(
            [alphas, np.full(bucket - n_cand, alphas[-1], np.float32)])
    u, i, v = _prep_coo(user_idx, item_idx, values, n_users, n_items,
                        params, dev)
    by_user, by_item, cs = _build_layouts(u, i, v, n_users, n_items, params)
    st_user = _stack_layout(by_user, n_users, n_items, bucket)
    st_item = _stack_layout(by_item, n_items, n_users, bucket)
    del by_user, by_item
    alphas_t = torch.as_tensor(alphas, device=dev)
    a_user = alphas_t.repeat_interleave(st_user[0].shape[0] // bucket)
    a_item = alphas_t.repeat_interleave(st_item[0].shape[0] // bucket)
    user0, item0 = _init_or(init, n_users, n_items, params, dev)
    carry = (user0.repeat(bucket, 1), item0.repeat(bucket, 1))
    cg_u = params.resolved_cg_iters(n_users)
    cg_i = params.resolved_cg_iters(n_items)

    def sweep_with(cg_u_n: int, cg_i_n: int):
        def sweep(carry):
            users, items = carry
            users = _solve_stacked(st_user, items, n_users, regs, a_user,
                                   params, cs, users, cg_u_n)
            items = _solve_stacked(st_item, users, n_items, regs, a_item,
                                   params, cs, items, cg_i_n)
            return users, items
        return sweep

    users, items = _run_schedule(sweep_with, params, cg_u, cg_i, carry)
    k = params.rank
    return StackedALSModel(
        users.view(bucket, n_users, k)[:n_cand],
        items.view(bucket, n_items, k)[:n_cand])


# ---------------------------------------------------------------------------
# sharded multi-rank path — users/items blocked per rank, all_gather per
# half-sweep (the MLlib-shuffle replacement)
# ---------------------------------------------------------------------------

def _block(n: int, n_dev: int) -> int:
    return math.ceil(n / n_dev)


def _partition(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
               block: int, n_dev: int, rank: int, chunk: int):
    """This rank's share of the COO -> (r, c, v, nnz_max), on the COO's
    device: the entries of rows [rank * block, (rank + 1) * block) in
    their input order, with LOCAL row ids, padded to nnz_max (the largest
    share over all ranks, rounded up to a chunk multiple, so every rank
    has the same shape); padding entries carry row id = block (the
    sentinel >= any local id)."""
    dev_of = torch.div(rows, block, rounding_mode="floor")
    nnz_max = int(torch.bincount(dev_of, minlength=n_dev).max())
    nnz_max += -nnz_max % max(1, chunk)
    ix = torch.nonzero(dev_of == rank).squeeze(1)
    n = ix.shape[0]
    r = rows.new_full((nnz_max,), block)
    c = cols.new_zeros(nnz_max)
    v = vals.new_zeros(nnz_max)
    r[:n] = rows[ix] - rank * block
    c[:n] = cols[ix]
    v[:n] = vals[ix]
    return r, c, v, nnz_max


def _gram_psum(block: torch.Tensor, mesh) -> torch.Tensor:
    """Yᵀ Y of the full factor matrix from the LOCAL block: a (b,k)x(k,b)
    product on each rank (f32, TF32 refused by _require_f32_matmul: the
    reference's Precision.HIGH) and one (k,k) all_reduce, in place of
    every rank forming it from the gathered matrix."""
    return mesh.psum(block.T @ block)


def _sharded_setup(user_idx, item_idx, values, n_users: int, n_items: int,
                   params: ALSParams, mesh, init: ALSModel | None = None):
    """This rank's part of ``als_train_sharded`` before its first sweep:
    (by_user, by_item, cs, (users, items)), its blocks' slot layouts on
    ``mesh.device`` (local row ids, every rank at the same shapes) and
    its (block, k) rows of the init, the phantom rows past n zero."""
    n_dev = mesh.shape["data"]
    dev = mesh.device
    ub, ib = _block(n_users, n_dev), _block(n_items, n_dev)
    # the whole COO on the device (no sentinel padding: chunk=0), each
    # block cut from it there
    rows, cols, vals = _prep_coo(user_idx, item_idx, values, n_users,
                                 n_items, replace(params, chunk=0), dev)
    u_r, u_c, u_v, u_nnz = _partition(rows, cols, vals, ub, n_dev,
                                      mesh.rank, params.chunk)
    i_r, i_c, i_v, i_nnz = _partition(cols, rows, vals, ib, n_dev,
                                      mesh.rank, params.chunk)
    del rows, cols, vals
    cs = min(params.chunk_slots,
             _slots_for(max(u_nnz, i_nnz), 0, params.width, 1))
    su = _slots_for(u_nnz, ub, params.width, cs)
    si = _slots_for(i_nnz, ib, params.width, cs)
    by_user = _device_slot_layout(u_r, u_c, u_v, ub, params.width, su)
    by_item = _device_slot_layout(i_r, i_c, i_v, ib, params.width, si)
    del u_r, u_c, u_v, i_r, i_c, i_v

    user0, item0 = _init_or(init, n_users, n_items, params, dev)
    lo_u, lo_i = mesh.rank * ub, mesh.rank * ib
    users = user0.new_zeros((ub, params.rank))
    items = item0.new_zeros((ib, params.rank))
    users[:max(0, min(ub, n_users - lo_u))] = user0[lo_u:lo_u + ub]
    items[:max(0, min(ib, n_items - lo_i))] = item0[lo_i:lo_i + ib]
    return by_user, by_item, cs, (users, items)


def als_train_sharded(user_idx, item_idx, values, n_users: int,
                      n_items: int, params: ALSParams, mesh,
                      init: ALSModel | None = None) -> ALSModel:
    """ALS over the ranks of ``mesh`` (``parallel.mesh.create_mesh``),
    one block of users and one of items a rank: every rank of the group
    calls it with the same arguments.

    As in the reference, users and their ratings are partitioned into
    contiguous blocks of ``_block(n, ranks)`` rows (likewise items),
    sentinel-padded so every rank has the same shapes; no rebalancing,
    so under a skewed distribution the first block holds most ratings.
    Every rank holds the whole COO (numpy arrays or tensors), so the
    padded sizes come from the global maximum. Each rank builds its
    block's slot layouts on its device (``_sharded_setup``). Each
    half-sweep it forms the shared YᵀY (implicit) from the blocks
    (``_gram_psum``), gathers the whole opposing factor matrix (a tiled
    all_gather; the factors are small, n x k, and the ratings never
    move) and solves its block's normal equations with
    ``_solve_factors``, as ``als_train`` does: the accumulation
    (``accum``, K1-K3), the gather (K4, K5) and the packed matvec (K6)
    run as on one device, with the same warm-CG schedule, the
    CG-or-Cholesky choice keyed on the block's row count.

    The init is drawn at the unpadded shape, the draw ``als_train`` makes
    (or taken from ``init``), and the phantom rows past n are zero: a
    non-zero phantom row would enter the shared YᵀY of the implicit
    first sweep. At the end every rank gathers both factor matrices, so
    each returns the same bits, on its own device."""
    _require_f32_matmul(mesh.device)
    ub = _block(n_users, mesh.shape["data"])
    ib = _block(n_items, mesh.shape["data"])
    by_user, by_item, cs, carry = _sharded_setup(
        user_idx, item_idx, values, n_users, n_items, params, mesh, init)

    def solve(layout, other, n_self, x0, cg_n, yty):
        return _solve_factors(
            layout, other, n_self, params.reg, params.implicit,
            params.alpha, cs, x0=x0, cg_iters=cg_n,
            bf16_gather=params.bf16_gather, accum=params.accum,
            group_slots=params.group_slots, yty=yty, gather=params.gather,
            packed=params.packed_a,
        )

    def sweep_with(cg_u_n: int, cg_i_n: int):
        def sweep(carry):
            users, items = carry  # local blocks (ub, k) / (ib, k)
            yty_i = _gram_psum(items, mesh) if params.implicit else None
            users = solve(by_user, mesh.all_gather(items), ub, users,
                          cg_u_n, yty_i)
            yty_u = _gram_psum(users, mesh) if params.implicit else None
            items = solve(by_item, mesh.all_gather(users), ib, items,
                          cg_i_n, yty_u)
            return users, items
        return sweep

    # each rank solves its LOCAL block of rows, so the auto exact-vs-CG
    # decision keys on the block's size, as in the reference
    users, items = _run_schedule(sweep_with, params,
                                 params.resolved_cg_iters(ub),
                                 params.resolved_cg_iters(ib), carry)
    return ALSModel(mesh.all_gather(users)[:n_users],
                    mesh.all_gather(items)[:n_items])


# ---------------------------------------------------------------------------
# streaming fold-in: refresh user rows against FIXED item factors
# ---------------------------------------------------------------------------

# The fold-in builds its blocks in chunks of this many slots whatever the
# batch, so a slot's block always comes from a batched matmul of the same
# shape (a library may pick another kernel, and another order of the
# 128-wide sums, for another batch count). The reference's chunk is
# min(chunk_slots, nnz // width + 1); the blocks are the same numbers. On
# an H100 the blocks came out the same at every chunk size that rule
# gives (chip_smoke.py, the foldin phase's hazards): the fixed chunk keeps
# the contract from resting on that observation.
FOLD_IN_CHUNK_SLOTS = 1024


def _solve_rows_invariant(A, b):
    """Exact per-row solve whose bits do not depend on the batch: one
    unbatched Cholesky and triangular solve per row, so a row's solution
    is the same whether it is solved alone or among any batch mates (a
    batched factorization may take another routine for another batch
    size). Raises where a system is not positive definite, as the
    trainer's exact solve does."""
    out, infos = [], []
    for a_row, b_row in zip(A, b):
        chol, info = torch.linalg.cholesky_ex(a_row)
        out.append(torch.cholesky_solve(b_row[:, None], chol)[:, 0])
        infos.append(info)
    if infos and bool(torch.stack(infos).ne(0).any()):
        raise torch.linalg.LinAlgError(
            "fold-in: a user's system is not positive definite")
    return (torch.stack(out) if out
            else b.new_zeros((0, b.shape[1])))


def _fold_in_systems(u, i, v, item_factors, n_users: int,
                     params: ALSParams):
    """The reference's ``_fold_in_jit`` up to its solve: one users
    half-sweep of ``_normal_equations`` with the shared YᵀY (implicit)
    and reg terms added -> A (n_users,k,k), b (n_users,k)."""
    nnz = u.shape[0]
    cs = FOLD_IN_CHUNK_SLOTS
    su = _slots_for(nnz, n_users, params.width, cs)
    by_user = _device_slot_layout(u, i, v, n_users, params.width, su)
    A, b = _normal_equations(
        by_user, item_factors, n_users, params.implicit, params.alpha, cs,
        bf16_gather=params.bf16_gather, accum=params.accum,
        group_slots=params.group_slots, gather=params.gather,
        packed=params.packed_a,
    )
    if params.implicit:
        A += _shared_yty(item_factors, None)[None, :, :]
    A.diagonal(dim1=1, dim2=2).add_(params.reg)
    return A, b


def fold_in_params(params: ALSParams) -> ALSParams:
    """The bit-conservative variant of ``params`` a fold-in solve runs
    under: f32 gather and the plain accumulation and gather paths, so a
    refreshed row is a pure function of (events, item factors), the same
    in every batch composition and on every restart. Iteration-schedule
    fields are irrelevant (fold-in is one half-sweep) and are zeroed."""
    return replace(
        params, bf16_gather=False, accum="carry", gather="xla",
        packed_a=False, iterations=1, cg_warm_iters=-1, seed=0, chunk=0,
    )


def als_fold_in(item_factors, user_idx, item_idx, values, n_users: int,
                params: ALSParams) -> torch.Tensor:
    """Solve one ridge system per user against FIXED item factors (the
    online half of ALS): one users half-sweep of ``_normal_equations``
    and the exact solve, nothing else. Returns (n_users, k) f32 rows on
    the item factors' device (a numpy table is taken as the CPU's).

    ``user_idx`` holds local dense ids in [0, n_users); ``item_idx``
    indexes ``item_factors`` rows. Users with no events get the zero row
    (b = 0 under the exact solve), which callers treat as "don't apply".

    Batch-composition invariance, the freshness subsystem's contract: a
    user's row is bit-identical whether the user is folded alone or in
    any batch, on the CPU and on CUDA. The blocks come from batched
    matmuls of one fixed shape (``FOLD_IN_CHUNK_SLOTS``), each row sums
    its slots in slot order (``_add_blocks``) and ``_solve_rows_invariant``
    solves each row alone. The user space and the event count are padded
    to powers of two, as in the reference; the padding events carry the
    sentinel user and are dropped by the slot layout."""
    itf = item_factors if torch.is_tensor(item_factors) else \
        torch.from_numpy(np.ascontiguousarray(item_factors, np.float32))
    itf = itf.to(torch.float32)
    dev, k = itf.device, itf.shape[1]
    nnz = len(values)
    if nnz == 0 or n_users <= 0:
        return torch.zeros((max(n_users, 0), k), dtype=torch.float32,
                           device=dev)
    _require_f32_matmul(dev)
    u = np.ascontiguousarray(user_idx, dtype=np.int32)
    i = np.ascontiguousarray(item_idx, dtype=np.int32)
    v = np.ascontiguousarray(values, dtype=np.float32)
    n_bucket = pow2_bucket(n_users)
    pad = pow2_bucket(nnz) - nnz
    if pad:
        u = np.concatenate([u, np.full(pad, n_bucket, np.int32)])
        i = np.concatenate([i, np.zeros(pad, np.int32)])
        v = np.concatenate([v, np.zeros(pad, np.float32)])
    u, i, v = (torch.from_numpy(x).to(dev) for x in (u, i, v))
    A, b = _fold_in_systems(u, i, v, itf, n_bucket, fold_in_params(params))
    # the bucket's padding rows would solve to zero: only the real users
    # are solved
    return _solve_rows_invariant(A[:n_users], b[:n_users])


# ---------------------------------------------------------------------------
# prediction / scoring
# ---------------------------------------------------------------------------

def _index(idx, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(idx, np.int64), device=device)


def predict_pairs(model: ALSModel, user_idx, item_idx) -> torch.Tensor:
    dev = model.user_factors.device
    return torch.einsum(
        "nk,nk->n",
        model.user_factors[_index(user_idx, dev)],
        model.item_factors[_index(item_idx, dev)],
    )


def recommend_topk(model: ALSModel, user_idx, k: int):
    """Top-k items for a batch of users: one (B,k)x(k,I) matmul + topk.

    k is bucketed to the next power of two and trimmed afterwards, as the
    reference does, and the matmul runs at the batch's dispatch rows
    (``ops.bucketing.dispatch_rows``), so a query answers the same bits
    whether it is served alone or inside a micro-batch or a coalesced
    batch. The columns run at ``MIN_SCORING_COLUMNS`` at the least, so a
    shard's slice of the items scores each item as the whole table does."""
    n_items = model.item_factors.shape[0]
    k = max(1, min(int(k), n_items))
    k_bucket = pow2_bucket(k, cap=n_items)
    user_idx = np.asarray(user_idx)
    b = len(user_idx)
    n = dispatch_rows(b)
    if n != b:
        user_idx = np.concatenate(
            [user_idx, np.zeros(n - b, user_idx.dtype)])
    rows = model.user_factors[_index(user_idx, model.user_factors.device)]
    items = padded_rows(model.item_factors, MIN_SCORING_COLUMNS)
    scores, idx = topk.topk_lowest_index(
        (rows @ items.T)[:b, :n_items], k_bucket)
    return scores[:, :k], idx[:, :k]


def rmse(model: ALSModel, user_idx, item_idx, values) -> float:
    pred = predict_pairs(model, user_idx, item_idx)
    v = torch.as_tensor(np.asarray(values, np.float32), device=pred.device)
    return float(torch.sqrt(torch.mean((pred - v) ** 2)))
