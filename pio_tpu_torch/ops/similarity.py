"""Cosine-similarity top-k over factor/embedding matrices, and the exact
all-pairs column cosine of the DIMSUM template.

Counterpart of ``pio_tpu.ops.similarity``: ``normalize_rows``,
``cosine_topk``, ``mean_vector`` and ``column_cosine_topk``, with the
reference's arguments and results (host arrays from the column cosine,
tensors on the inputs' device from the rest). What differs:

 * ``cosine_topk``'s product runs at ``ops.bucketing.dispatch_rows`` rows
   and at least ``MIN_SCORING_COLUMNS`` columns, where the reference pads
   the batch to a power of two: a query then gets the same bits alone,
   micro-batched or coalesced (the serving path's batch-invariance rule,
   as in ``ops.als.recommend_topk``);
 * every top-k goes through ``ops.topk.topk_lowest_index``, which orders
   ties as ``lax.top_k`` does;
 * ``mean_vector`` sums a group's rows one at a time in their order
   (``group_means``), so a group's mean has the same bits whatever other
   groups share its gather;
 * the Gram of ``column_cosine_topk`` is accumulated from bf16 strips into
   f32 by ``torch.mm(..., out_dtype=torch.float32)`` on CUDA (the
   reference's ``preferred_element_type=float32``); the CPU has no such
   kernel, so there the strips are widened to f32 first (a bf16 x bf16
   product is exact in f32) and multiplied in f32.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from pio_tpu_torch.ops.bucketing import (
    MIN_SCORING_COLUMNS, dispatch_rows, padded_rows, pow2_bucket,
)
from pio_tpu_torch.ops.topk import topk_lowest_index
from pio_tpu_torch.workflow.context import resolve_device


def normalize_rows(m: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    return m / (torch.linalg.vector_norm(m, dim=1, keepdim=True) + eps)


def cosine_topk(matrix: torch.Tensor, queries, k: int):
    """matrix: (I, d) item vectors; queries: (B, d). Returns (scores, idx)
    of the k most cosine-similar rows per query, tensors on the matrix's
    device. k is bucketed to a power of two and trimmed; the product runs
    at the batch's dispatch rows (zero rows, NaN-safe through
    ``normalize_rows``' eps) and at least MIN_SCORING_COLUMNS columns, so
    each query's scores have the bits they have alone."""
    n = matrix.shape[0]
    k = max(1, min(int(k), n))
    bucket = pow2_bucket(k, cap=n)
    q = torch.as_tensor(queries, dtype=matrix.dtype, device=matrix.device)
    b = q.shape[0]
    q = normalize_rows(padded_rows(q, dispatch_rows(b)))
    items = padded_rows(normalize_rows(matrix), MIN_SCORING_COLUMNS)
    scores, idx = topk_lowest_index((q @ items.T)[:b, :n], bucket)
    return scores[:, :k], idx[:, :k]


def group_means(matrix: torch.Tensor,
                groups: Sequence[np.ndarray]) -> torch.Tensor:
    """(B, d) means of ``matrix``'s rows ``groups[g]`` for each group g,
    from one gather of every group's rows. A group's rows are summed one
    at a time in their order, an elementwise add a position, and the sum
    is divided by the group's size: the bits of a group's mean do not
    depend on the groups beside it."""
    dev = matrix.device
    b = len(groups)
    width = max(len(g) for g in groups)
    idx = np.zeros((b, width), np.int64)
    lens = np.zeros(b, np.int64)
    for r, g in enumerate(groups):
        idx[r, :len(g)] = g
        lens[r] = len(g)
    rows = matrix[torch.as_tensor(idx, device=dev)]       # (B, L, d)
    lens_t = torch.as_tensor(lens, device=dev)
    acc = rows[:, 0]
    for j in range(1, width):
        acc = torch.where((lens_t > j)[:, None], acc + rows[:, j], acc)
    return acc / lens_t[:, None].to(matrix.dtype)


def mean_vector(matrix: torch.Tensor, indices: np.ndarray) -> torch.Tensor:
    """Average of the given rows, (1, d) — the similarproduct query
    combiner (reference ALSAlgorithm.scala: sum of query-item feature
    vectors)."""
    return group_means(matrix, [np.asarray(indices, np.int64)])


def bf16_mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The product of bf16 ``a`` and ``b`` summed in f32 (the reference's
    ``preferred_element_type=float32``): ``torch.mm``'s ``out_dtype`` on
    CUDA; on the CPU, which has no such kernel, the operands widened to
    f32 first (a bf16 x bf16 product is exact in f32)."""
    if a.device.type == "cuda":
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _gram(u_b: torch.Tensor, i_b: torch.Tensor, v_b: torch.Tensor,
          counts: np.ndarray, n_items_pad: int,
          user_batch: int) -> torch.Tensor:
    """G = M^T M over the users x items matrix M: each user batch's COO
    slice summed into a dense f32 strip, cast to bf16, and its Gram
    accumulated in f32."""
    dev = u_b.device
    G = torch.zeros((n_items_pad, n_items_pad), dtype=torch.float32,
                    device=dev)
    D = torch.empty((user_batch, n_items_pad), dtype=torch.float32,
                    device=dev)
    for b, n in enumerate(counts):
        n = int(n)
        D.zero_()
        if n:
            flat = (u_b[b, :n].long() * n_items_pad + i_b[b, :n].long())
            D.view(-1).index_put_((flat,), v_b[b, :n], accumulate=True)
        Db = D.to(torch.bfloat16)
        G.add_(bf16_mm_f32(Db.T, Db))
    return G


#: rows of the normalized Gram sorted for top-k at a time (bounds the
#: sort's working memory at the full catalog)
_TOPK_ROWS = 2048


def column_cosine_topk(
    user_idx: np.ndarray,
    item_idx: np.ndarray,
    values: np.ndarray,
    n_users: int,
    n_items: int,
    k: int,
    threshold: float = 0.0,
    user_batch: int = 4096,
    chunk: int = 65536,
    device=None,
):
    """All-pairs item-to-item cosine over the raw interaction matrix — the
    answer to MLlib `RowMatrix.columnSimilarities(threshold)` as used by
    the reference DIMSUM similarproduct template
    (examples/experimental/scala-parallel-similarproduct-dimsum/src/main/
    scala/DIMSUMAlgorithm.scala:125-132), on ``device`` (CUDA unless
    ``device="cpu"``).

    The EXACT similarities are computed and `threshold` is honored as the
    reference's contract knob (entries below it zero). Normalization
    comes from the accumulated Gram's own diagonal (the true column norms
    AFTER duplicate (user, item) entries have summed in the scatter).
    The diagonal and the padding columns are masked to -1e9, so they never
    rank. Memory bound: the f32 Gram is (n_items_pad^2).

    Returns (scores, idx): (n_items, k) host arrays, k-nearest per item,
    equal scores in index order.
    """
    dev = resolve_device(device)
    n_items_pad = max(256, -(-n_items // 256) * 256)
    k = max(1, min(int(k), n_items - 1))
    k_bucket = pow2_bucket(k, cap=n_items_pad)

    u = np.ascontiguousarray(user_idx, dtype=np.int64)
    i = np.ascontiguousarray(item_idx, dtype=np.int32)
    v = np.ascontiguousarray(values, dtype=np.float32)

    # group the COO by user batch on host so each step scatters only its
    # own slice — total scatter work stays O(nnz), not
    # O(nnz * n_batches). Skewed batches waste padding; widening the batch
    # evens them out (bounded so the dense strip stays ~<=2GB).
    while True:
        n_batches = max(1, -(-n_users // user_batch))
        counts = np.bincount(u // user_batch, minlength=n_batches)
        L = -(-int(counts.max()) // max(1, chunk)) * max(1, chunk)
        # stop once: padding waste is bounded, OR widening cannot help any
        # more (single batch / batch >= n_users), OR the dense strip would
        # exceed ~2GB. L is floored at `chunk`, so the waste bound alone
        # would otherwise escalate tiny inputs to the memory cap.
        if (n_batches * L <= 4 * max(len(u), 1)
                or n_batches == 1
                or user_batch >= n_users
                or user_batch * n_items_pad >= 1 << 29):
            break
        user_batch *= 2

    order = np.argsort(u // user_batch, kind="stable")
    u, i, v = u[order], i[order], v[order]
    starts = np.zeros(n_batches + 1, np.int64)
    np.cumsum(np.bincount(u // user_batch, minlength=n_batches),
              out=starts[1:])
    u_b = np.full((n_batches, L), user_batch, np.int32)   # sentinel: OOB row
    i_b = np.full((n_batches, L), n_items_pad, np.int32)  # sentinel: OOB col
    v_b = np.zeros((n_batches, L), np.float32)
    for b in range(n_batches):
        s, e = starts[b], starts[b + 1]
        u_b[b, : e - s] = u[s:e] - b * user_batch
        i_b[b, : e - s] = i[s:e]
        v_b[b, : e - s] = v[s:e]

    # only each batch's first (e - s) entries are real: the sentinels the
    # reference drops in its scatter are never read
    G = _gram(torch.from_numpy(u_b).to(dev), torch.from_numpy(i_b).to(dev),
              torch.from_numpy(v_b).to(dev), np.diff(starts), n_items_pad,
              user_batch)
    d = torch.diagonal(G).clone()
    inv = torch.where(d > 0, torch.rsqrt(torch.clamp(d, min=1e-30)),
                      torch.zeros_like(d))
    G.mul_(inv[:, None]).mul_(inv[None, :])
    G.masked_fill_(~(G >= threshold), 0.0)
    # self-similarity and padding columns must never rank: padded ids
    # would decode out of range in callers that trust the idx contract
    G.fill_diagonal_(-1e9)
    G[:, n_items:] = -1e9
    scores = np.empty((n_items, k), np.float32)
    idx = np.empty((n_items, k), np.int32)
    for lo in range(0, n_items, _TOPK_ROWS):
        hi = min(lo + _TOPK_ROWS, n_items)
        s, j = topk_lowest_index(G[lo:hi], k_bucket)
        scores[lo:hi] = s[:, :k].cpu().numpy()
        idx[lo:hi] = j[:, :k].cpu().numpy()
    return scores, idx
