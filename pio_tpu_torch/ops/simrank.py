"""SimRank similarity as dense matrix iteration.

Counterpart of ``pio_tpu.ops.simrank`` (reference friend-recommendation
template's Delta-SimRank over GraphX, examples/experimental/
scala-parallel-friend-recommendation/src/main/scala/DeltaSimRankRDD.scala),
on one device. The closed recurrence

    S_{t+1} = decay * W^T S_t W,   diag(S) := 1

with W the in-neighbor-normalized adjacency (W[i,j] = A[i,j]/indeg(j)) is
two dense (n, n) products an iteration. As in the reference both products
take bf16 operands and accumulate in f32 (``ops/similarity.bf16_mm_f32``:
``torch.mm(..., out_dtype=torch.float32)`` on CUDA, whose transposed
operand is a view, so W^T is never materialised; widened operands on the
CPU). The (n_pad, n_pad) state lives on
the device; n is padded to a multiple of 128, at least 128, as the
reference pads it. Past ~16k nodes (1 GiB of f32 state, the size the
reference names), sample the graph first (models/friendrecommendation.py).
"""

from __future__ import annotations

import numpy as np
import torch

from pio_tpu_torch.ops.similarity import bf16_mm_f32
from pio_tpu_torch.workflow.context import resolve_device


def padded_nodes(n_nodes: int) -> int:
    return max(128, -(-n_nodes // 128) * 128)


def simrank_device(src, dst, n_nodes: int, decay: float = 0.8,
                   iterations: int = 5, *, device=None) -> torch.Tensor:
    """-> the (n_pad, n_pad) f32 SimRank state on ``device`` (CUDA unless
    "cpu"); rows and columns past n_nodes belong to no node."""
    dev = resolve_device(device)
    n_pad = padded_nodes(n_nodes)
    s = torch.as_tensor(np.asarray(src, np.int64), device=dev)
    d = torch.as_tensor(np.asarray(dst, np.int64), device=dev)
    A = torch.zeros((n_pad, n_pad), dtype=torch.float32, device=dev)
    A[s, d] = 1.0                      # parallel edges count once
    indeg = A.sum(dim=0)               # in-degree of each dst column
    scale = torch.where(indeg > 0, 1.0 / indeg.clamp_min(1.0),
                        torch.zeros_like(indeg))
    Wb = (A * scale[None, :]).to(torch.bfloat16)
    del A
    S = torch.eye(n_pad, dtype=torch.float32, device=dev)
    for _ in range(int(iterations)):
        T = bf16_mm_f32(Wb.T, S.to(torch.bfloat16))            # W^T S
        S = decay * bf16_mm_f32(T.to(torch.bfloat16), Wb)      # (W^T S) W
        S.fill_diagonal_(1.0)
    return S


def simrank_scores(
    src: np.ndarray,
    dst: np.ndarray,
    n_nodes: int,
    decay: float = 0.8,
    iterations: int = 5,
    *,
    device=None,
) -> np.ndarray:
    """-> (n_nodes, n_nodes) SimRank matrix (host numpy), computed on
    ``device``.

    decay/iterations mirror the reference SimRankParams
    (SimRankAlgorithm.scala:10-12; DeltaSimRankRDD.decay default 0.8)."""
    if n_nodes <= 0:
        return np.zeros((0, 0), np.float32)
    S = simrank_device(src, dst, n_nodes, decay, iterations, device=device)
    return S[:n_nodes, :n_nodes].cpu().numpy()


def simrank_topk(S: np.ndarray, k: int):
    """Top-k most similar nodes per node, self excluded.
    Returns (scores, idx): (n, k)."""
    n = S.shape[0]
    if n == 0:
        return np.zeros((0, 0), np.float32), np.zeros((0, 0), np.int64)
    k = max(1, min(int(k), n - 1))
    M = S.copy()
    np.fill_diagonal(M, -np.inf)
    idx = np.argpartition(-M, k - 1, axis=1)[:, :k]
    part = np.take_along_axis(M, idx, axis=1)
    order = np.argsort(-part, axis=1, kind="stable")
    idx = np.take_along_axis(idx, order, axis=1)
    scores = np.take_along_axis(part, order, axis=1)
    return scores.astype(np.float32), idx
