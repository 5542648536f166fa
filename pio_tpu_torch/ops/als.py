"""ALS serving half: the factor model and its scoring functions.

Counterpart of the prediction/scoring section of ``pio_tpu.ops.als``
(``ALSModel``, ``predict_pairs``, ``recommend_topk``, ``rmse``). The JAX
package leaves this path to XLA (one matmul + top-k), so the port leaves
it to ``torch.matmul``/``torch.topk``: there is no Pallas kernel here to
translate. Training (``ALSParams``, ``als_train``) comes with the
training slice.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from pio_tpu_torch.ops.bucketing import pow2_bucket


@dataclass
class ALSModel:
    """Factor matrices (f32). user_factors: (n_users, k); item_factors:
    (n_items, k)."""

    user_factors: torch.Tensor
    item_factors: torch.Tensor


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

    k and the batch dim are bucketed to the next power of two and trimmed
    afterwards, as the reference does, so a query answers the same
    whether it is served alone or inside a batch of the same bucket."""
    n_items = model.item_factors.shape[0]
    k = max(1, min(int(k), n_items))
    k_bucket = pow2_bucket(k, cap=n_items)
    user_idx = np.asarray(user_idx)
    b = len(user_idx)
    b_bucket = pow2_bucket(b)
    if b_bucket != b:
        user_idx = np.concatenate(
            [user_idx, np.zeros(b_bucket - b, user_idx.dtype)])
    rows = model.user_factors[_index(user_idx, model.user_factors.device)]
    scores, idx = torch.topk(rows @ model.item_factors.T, k_bucket)
    return scores[:b, :k], idx[:b, :k]


def rmse(model: ALSModel, user_idx, item_idx, values) -> float:
    pred = predict_pairs(model, user_idx, item_idx)
    v = torch.as_tensor(np.asarray(values, np.float32), device=pred.device)
    return float(torch.sqrt(torch.mean((pred - v) ** 2)))
