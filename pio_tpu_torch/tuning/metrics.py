"""Vectorized ranking metrics — batched tensor functions over top-k
rankings.

Counterpart of ``pio_tpu.tuning.metrics``: the sweep's metric layer.
MAP@k, NDCG@k, precision@k, recall@k and AUC are fixed-shape batched
tensor functions, so scoring C stacked candidates x B test users is a
handful of tensor ops instead of C x B Python loops; they run on the
device of their inputs. Every metric also plugs into the
``controller.evaluation.Metric`` contract (``calculate`` over the
(query, prediction, actual) triples the generic Engine.eval path
produces), and each batched function has a pure-Python scalar oracle
(``*_scalar``, copied from the reference) that the parity tests hold it
to — the vectorized form is never the only definition of a score.

Definitions (binary relevance):

 * precision@k  = |top-k ∩ actual| / min(k, |actual|)  — the repo's
   existing PrecisionAtK convention (tp over the best achievable, so a
   perfect ranking scores 1.0 even when |actual| < k);
 * MAP@k        = (1 / min(k, |actual|)) * sum_{i<=k, rel_i} P@i
   (average precision at each hit, truncated at k);
 * NDCG@k       = DCG@k / IDCG@k with gain 1 / log2(1 + rank);
 * AUC          = P(score(pos) > score(neg)) + 0.5 P(=) over the
   user's (positive, candidate-negative) pairs — needs the FULL score
   row, so it only runs on paths that have one (the batched sweep; the
   QPA adapter raises a clear error instead of silently approximating).

Per-user scores are averaged with Option semantics: a user with no
actuals is excluded, a user with actuals but no predictions scores 0
(under-predicting is penalized, never excluded).
"""

from __future__ import annotations

import math
from typing import Any, Sequence

import numpy as np
import torch

from pio_tpu_torch.controller.evaluation import EvalDataSet, Metric

# masked-score sentinel: seen-in-train / padded items are pushed below
# any real score before the top-k (callers of the sweep scorer)
MASKED_SCORE = -1e30


# ---------------------------------------------------------------------------
# batched functions (fixed shapes from the caller's padding)
# ---------------------------------------------------------------------------

def _tensor(x, device=None) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                           device=device)


def hits_matrix(topk_idx, actual_idx):
    """(..., K) ranked item indices x (..., A) -1-padded actuals ->
    (..., K) float32 hit indicators."""
    topk_idx = _tensor(topk_idx)
    actual_idx = _tensor(actual_idx, topk_idx.device)
    hit = topk_idx[..., :, None] == actual_idx[..., None, :]
    hit &= actual_idx[..., None, :] >= 0
    return torch.any(hit, dim=-1).to(torch.float32)


def _n_actual(actual_idx):
    return torch.sum(actual_idx >= 0, dim=-1).to(torch.float32)


def _nan_where_empty(score, n_act):
    return torch.where(n_act > 0, score,
                       torch.full_like(score, float("nan")))


def precision_at_k_batch(topk_idx, actual_idx, k: int):
    """-> (...,) per-user precision@k; users with no actuals get NaN
    (excluded by the nanmean aggregation)."""
    topk_idx = _tensor(topk_idx)
    actual_idx = _tensor(actual_idx, topk_idx.device)
    hits = hits_matrix(topk_idx[..., :k], actual_idx)
    n_act = _n_actual(actual_idx)
    denom = torch.clamp(n_act, max=float(k))
    score = torch.sum(hits, dim=-1) / torch.clamp(denom, min=1.0)
    return _nan_where_empty(score, n_act)


def recall_at_k_batch(topk_idx, actual_idx, k: int):
    """-> (...,) per-user recall@k = |top-k ∩ actual| / |actual|."""
    topk_idx = _tensor(topk_idx)
    actual_idx = _tensor(actual_idx, topk_idx.device)
    hits = hits_matrix(topk_idx[..., :k], actual_idx)
    n_act = _n_actual(actual_idx)
    score = torch.sum(hits, dim=-1) / torch.clamp(n_act, min=1.0)
    return _nan_where_empty(score, n_act)


def map_at_k_batch(topk_idx, actual_idx, k: int):
    topk_idx = _tensor(topk_idx)
    actual_idx = _tensor(actual_idx, topk_idx.device)
    hits = hits_matrix(topk_idx[..., :k], actual_idx)
    ranks = torch.arange(1, hits.shape[-1] + 1, dtype=torch.float32,
                         device=hits.device)
    prec_at_i = torch.cumsum(hits, dim=-1) / ranks
    n_act = _n_actual(actual_idx)
    ap = torch.sum(prec_at_i * hits, dim=-1) / torch.clamp(
        torch.clamp(n_act, max=float(k)), min=1.0)
    return _nan_where_empty(ap, n_act)


def ndcg_at_k_batch(topk_idx, actual_idx, k: int):
    topk_idx = _tensor(topk_idx)
    actual_idx = _tensor(actual_idx, topk_idx.device)
    hits = hits_matrix(topk_idx[..., :k], actual_idx)
    discounts = 1.0 / torch.log2(torch.arange(
        2, k + 2, dtype=torch.float32, device=hits.device))
    dcg = torch.sum(hits * discounts[:hits.shape[-1]], dim=-1)
    n_act = _n_actual(actual_idx)
    ideal_n = torch.clamp(n_act, max=float(k)).to(torch.int64)
    idcg = torch.cumsum(discounts, dim=0)[torch.clamp(ideal_n - 1, min=0)]
    score = dcg / torch.where(idcg > 0, idcg, torch.ones_like(idcg))
    return _nan_where_empty(score, n_act)


def auc_batch(scores, pos_mask, valid_mask):
    """(..., I) full score rows -> (...,) per-user AUC.

    ``pos_mask`` marks the heldout positives, ``valid_mask`` the items
    eligible as negatives OR positives (False = excluded: seen-in-train
    items and padding). For each positive, the negatives strictly below
    it (a win) and tied with it (half a win) are counted by two
    searchsorteds into the row's sorted negative scores — O(I log I),
    exact tie handling, no O(I^2) pairwise matrix — so ties between a
    positive and a negative count 0.5, matching the pairwise scalar
    oracle exactly."""
    scores = _tensor(scores)
    dev = scores.device
    pos_mask = _tensor(pos_mask, dev).to(torch.bool)
    valid_mask = _tensor(valid_mask, dev).to(torch.bool)
    lead = scores.shape[:-1]
    n = scores.shape[-1]
    s = scores.reshape(-1, n).contiguous()
    pos = pos_mask.reshape(-1, n)
    valid = valid_mask.reshape(-1, n)
    neg_mask = valid & ~pos
    neg_sorted = torch.sort(torch.where(
        neg_mask, s, torch.full_like(s, float("inf"))), dim=-1).values
    below = torch.searchsorted(neg_sorted, s, side="left")
    upto = torch.searchsorted(neg_sorted, s, side="right")
    is_pos = pos & valid
    credit = below.to(torch.float32) + 0.5 * (upto - below).to(
        torch.float32)
    wins = torch.sum(torch.where(is_pos, credit, torch.zeros_like(credit)),
                     dim=-1)
    n_pos = torch.sum(is_pos, dim=-1)
    n_neg = torch.sum(neg_mask, dim=-1)
    auc = wins / torch.clamp(n_pos * n_neg, min=1).to(torch.float32)
    auc = torch.where((n_pos > 0) & (n_neg > 0), auc,
                      torch.full_like(auc, float("nan")))
    return auc.reshape(lead)


# ---------------------------------------------------------------------------
# pure-Python scalar oracles (the parity suite's ground truth)
# ---------------------------------------------------------------------------

def precision_at_k_scalar(ranked: Sequence, actual: Sequence,
                          k: int) -> float | None:
    actual_set = set(actual)
    if not actual_set:
        return None
    tp = sum(1 for it in list(ranked)[:k] if it in actual_set)
    return tp / min(k, len(actual_set))


def recall_at_k_scalar(ranked: Sequence, actual: Sequence,
                       k: int) -> float | None:
    actual_set = set(actual)
    if not actual_set:
        return None
    tp = sum(1 for it in list(ranked)[:k] if it in actual_set)
    return tp / len(actual_set)


def map_at_k_scalar(ranked: Sequence, actual: Sequence,
                    k: int) -> float | None:
    actual_set = set(actual)
    if not actual_set:
        return None
    hits = 0
    total = 0.0
    for i, it in enumerate(list(ranked)[:k], start=1):
        if it in actual_set:
            hits += 1
            total += hits / i
    return total / min(k, len(actual_set))


def ndcg_at_k_scalar(ranked: Sequence, actual: Sequence,
                     k: int) -> float | None:
    actual_set = set(actual)
    if not actual_set:
        return None
    dcg = sum(
        1.0 / math.log2(i + 1)
        for i, it in enumerate(list(ranked)[:k], start=1)
        if it in actual_set)
    idcg = sum(1.0 / math.log2(i + 1)
               for i in range(1, min(k, len(actual_set)) + 1))
    return dcg / idcg


def auc_scalar(scores: Sequence[float], positives: Sequence[int],
               valid: Sequence[int] | None = None) -> float | None:
    """O(P*N) pairwise oracle over one user's full score row."""
    pos_set = set(positives)
    idxs = (range(len(scores)) if valid is None else valid)
    pos = [scores[i] for i in idxs if i in pos_set]
    neg = [scores[i] for i in idxs if i not in pos_set]
    if not pos or not neg:
        return None
    wins = sum(
        1.0 if p > n else (0.5 if p == n else 0.0)
        for p in pos for n in neg)
    return wins / (len(pos) * len(neg))


# ---------------------------------------------------------------------------
# Metric-contract adapters (the generic Engine.eval / QPA path)
# ---------------------------------------------------------------------------

def pad_actuals(actuals: Sequence[np.ndarray], pad_to: int | None = None
                ) -> np.ndarray:
    """Ragged per-user index arrays -> (B, A) int32, -1-padded."""
    width = max((len(a) for a in actuals), default=0)
    if pad_to is not None:
        width = max(width, pad_to)
    out = np.full((len(actuals), max(width, 1)), -1, np.int32)
    for j, a in enumerate(actuals):
        out[j, :len(a)] = a
    return out


def nanmean_sum_count(per_user: np.ndarray) -> tuple[float, int]:
    """-> (sum, count) over non-NaN per-user scores; the sweep persists
    these per fold so the overall mean weights users, not folds."""
    valid = ~np.isnan(per_user)
    return float(np.sum(per_user[valid])), int(np.count_nonzero(valid))


class RankingMetric(Metric[float]):
    """Vectorized ranking metric: Metric contract over QPA triples AND a
    batched ``score_ranked(topk_idx, actual_idx)`` array path — the two
    entry points share the ONE batched function, so the sweep's batched
    scores and the generic path's scores cannot drift."""

    higher_is_better = True
    needs_full_scores = False

    def __init__(self, k: int = 10):
        self.k = int(k)

    @property
    def header(self) -> str:
        return f"{self._NAME}@{self.k}"

    @property
    def key(self) -> str:
        return f"{self._NAME.lower()}@{self.k}"

    # -- batched array path -------------------------------------------------
    def score_ranked(self, topk_idx, actual_idx) -> np.ndarray:
        """(..., K>=k) ranked indices x (..., A) padded actuals ->
        per-user scores (numpy) with NaN for unscorable users; runs on
        the device of ``topk_idx``."""
        topk_idx = _tensor(topk_idx)
        if topk_idx.shape[-1] < self.k:
            # rankings shorter than k: pad with an impossible index so
            # the missing tail scores as misses, never as hits
            pad = self.k - topk_idx.shape[-1]
            topk_idx = torch.cat([
                topk_idx,
                torch.full(topk_idx.shape[:-1] + (pad,), -2,
                           dtype=topk_idx.dtype, device=topk_idx.device)],
                dim=-1)
        return self._KERNEL(topk_idx, actual_idx, self.k).cpu().numpy()

    # -- QPA / Metric-contract path ----------------------------------------
    def calculate(self, ctx, eval_data_set: EvalDataSet) -> float:
        ranked_ids: list[list] = []
        actual_ids: list[list] = []
        for _, qpa in eval_data_set:
            for _q, p, a in qpa:
                ranked_ids.append(_ranked_items(p))
                actual_ids.append(list(a or []))
        if not ranked_ids:
            return float("nan")
        # local id vocabulary: metric only needs equality, not identity
        vocab: dict[Any, int] = {}

        def enc(ids):
            out = np.empty(len(ids), np.int32)
            for j, it in enumerate(ids):
                code = vocab.get(it)
                if code is None:
                    code = vocab[it] = len(vocab)
                out[j] = code
            return out
        topk = pad_actuals(
            [enc(r[:self.k]) for r in ranked_ids], pad_to=self.k)
        # -1 padding in the RANKING must never match -1 actual padding
        topk[topk < 0] = -2
        actual = pad_actuals([enc(a) for a in actual_ids])
        per_user = self.score_ranked(topk, actual)
        s, c = nanmean_sum_count(per_user)
        return s / c if c else float("nan")


def _ranked_items(prediction) -> list:
    if isinstance(prediction, dict):
        return [s["item"] for s in prediction.get("itemScores", [])]
    return list(prediction or [])


class MAPAtK(RankingMetric):
    _NAME = "MAP"
    _KERNEL = staticmethod(map_at_k_batch)


class NDCGAtK(RankingMetric):
    _NAME = "NDCG"
    _KERNEL = staticmethod(ndcg_at_k_batch)


class PrecisionAtK(RankingMetric):
    _NAME = "Precision"
    _KERNEL = staticmethod(precision_at_k_batch)


class RecallAtK(RankingMetric):
    _NAME = "Recall"
    _KERNEL = staticmethod(recall_at_k_batch)


class AUC(Metric[float]):
    """Area under the ROC curve over full score rows (batched path
    only: a top-k ItemScores list cannot rank the items it omitted, so
    the QPA adapter refuses rather than silently approximating)."""

    higher_is_better = True
    needs_full_scores = True
    k = 0

    @property
    def header(self) -> str:
        return "AUC"

    key = "auc"

    def score_full(self, scores, pos_mask, valid_mask) -> np.ndarray:
        return auc_batch(scores, pos_mask, valid_mask).cpu().numpy()

    def calculate(self, ctx, eval_data_set: EvalDataSet) -> float:
        raise ValueError(
            "AUC needs full per-item score rows; it is computed on the "
            "batched sweep path (pio eval --sweep), not from top-k "
            "prediction lists — use map@k/ndcg@k/precision@k here")


_METRIC_NAMES = {
    "map": MAPAtK, "ndcg": NDCGAtK, "precision": PrecisionAtK,
    "p": PrecisionAtK, "recall": RecallAtK, "r": RecallAtK,
}


def parse_metric(spec: str) -> Metric:
    """'map@10' / 'ndcg@5' / 'precision@10' / 'auc' -> metric object."""
    s = spec.strip().lower()
    if s == "auc":
        return AUC()
    name, _, k = s.partition("@")
    cls = _METRIC_NAMES.get(name)
    if cls is None or not k:
        raise ValueError(
            f"unknown metric {spec!r} (expected map@K, ndcg@K, "
            "precision@K, recall@K, or auc)")
    try:
        return cls(int(k))
    except ValueError:
        raise ValueError(f"bad k in metric {spec!r}") from None
