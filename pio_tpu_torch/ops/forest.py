"""Random forest classifier — histogram split search + array-flattened trees.

Counterpart of ``pio_tpu.ops.forest``. Parity target: MLlib RandomForest
as used by the classification template's add-algorithm variant
(examples/scala-parallel-classification/add-algorithm/src/main/scala/
RandomForestAlgorithm.scala:28-43). MLlib grows trees by histogram split
search over quantile bins (Strategy maxBins, default 32); this does the
same, vectorized in numpy, as the reference does (the induction is its
code): features are quantile-binned once, each node accumulates
per-feature class histograms in a single np.add.at pass, and all
candidate thresholds are scored at once from cumulative counts. Tree
GROWTH stays host-side (branchy, data-dependent control flow). Trained
trees are flattened to (tree, node) index arrays, so INFERENCE is a fixed
max_depth-step gather loop batched over rows x trees: vectorized numpy
for ad-hoc queries (``predict``), or the same loop in torch on a device
(``predict_device``, CUDA unless ``device="cpu"``) for large catalogs,
where the reference jits it.

`max_bins=0` selects the exact unique-threshold search (the pre-histogram
behavior) — kept for small property tables and as the accuracy yardstick
the histogram path is tested against.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from pio_tpu_torch.workflow.context import resolve_device


@dataclass
class _Node:
    feature: int = -1
    threshold: float = 0.0
    left: Optional["_Node"] = None
    right: Optional["_Node"] = None
    prediction: int = 0

    @property
    def is_leaf(self) -> bool:
        return self.left is None


# ---------------------------------------------------------------------------
# binning
# ---------------------------------------------------------------------------

_BIN_SAMPLE = 100_000


def _quantile_thresholds(x: np.ndarray, max_bins: int, rng) -> np.ndarray:
    """(D, max_bins-1) per-feature candidate thresholds at quantile points
    (MLlib findSplits uses sampled quantiles the same way). Repeated
    quantiles of low-cardinality features just yield duplicate thresholds —
    harmless: their histogram bins are empty."""
    sample = x
    if len(x) > _BIN_SAMPLE:
        sample = x[rng.choice(len(x), _BIN_SAMPLE, replace=False)]
    qs = np.linspace(0, 1, max_bins + 1)[1:-1]
    return np.quantile(sample, qs, axis=0).T.astype(np.float32)  # (D, B-1)


def _bin_features(x: np.ndarray, thresholds: np.ndarray) -> np.ndarray:
    """bin b <=> thresholds[b-1] < x <= thresholds[b]; so a split at bin j
    means x <= thresholds[j]."""
    binned = np.empty(x.shape, np.int16)
    for f in range(x.shape[1]):
        binned[:, f] = np.searchsorted(thresholds[f], x[:, f], side="left")
    return binned


# ---------------------------------------------------------------------------
# split search
# ---------------------------------------------------------------------------

def _best_split_hist(binned, y, feature_subset, n_classes, n_bins, min_leaf):
    """One histogram pass over the node's rows scores every (feature, bin)
    threshold simultaneously. Returns (feature, bin, score) or (None,)*3."""
    sub = binned[:, feature_subset]                     # (n, F)
    n, n_feat = sub.shape
    hist = np.zeros((n_feat, n_bins, n_classes), np.int64)
    f_idx = np.broadcast_to(np.arange(n_feat), sub.shape)
    np.add.at(hist, (f_idx, sub, y[:, None]), 1)

    left = hist.cumsum(axis=1).astype(np.float64)       # counts with bin <= j
    total = left[:, -1:, :]
    right = total - left
    nl = left.sum(-1)                                   # (F, B)
    nr = right.sum(-1)
    # weighted gini: nl*gini_l = nl - sum_c lc^2 / nl
    gl = nl - (left * left).sum(-1) / np.maximum(nl, 1)
    gr = nr - (right * right).sum(-1) / np.maximum(nr, 1)
    score = (gl + gr) / n
    score[(nl < min_leaf) | (nr < min_leaf)] = np.inf
    score[:, -1] = np.inf  # last bin has no threshold (right side empty)
    flat = score.argmin()
    fi, b = divmod(flat, n_bins)
    if not np.isfinite(score[fi, b]):
        return None, None, np.inf
    return int(feature_subset[fi]), int(b), float(score[fi, b])


def _gini(counts: np.ndarray) -> float:
    total = counts.sum()
    if total == 0:
        return 0.0
    p = counts / total
    return float(1.0 - (p * p).sum())


def _best_split_exact(x, y, n_classes, feature_subset, min_leaf):
    """Exact search over every unique value (max_bins=0 path)."""
    best = (None, None, np.inf)
    n = len(y)
    parent_counts = np.bincount(y, minlength=n_classes)
    for f in feature_subset:
        vals = x[:, f]
        for t in np.unique(vals)[:-1]:
            mask = vals <= t
            nl = mask.sum()
            if nl < min_leaf or n - nl < min_leaf:
                continue
            lc = np.bincount(y[mask], minlength=n_classes)
            rc = parent_counts - lc
            score = (nl * _gini(lc) + (n - nl) * _gini(rc)) / n
            if score < best[2]:
                best = (f, float(t), score)
    return best


# ---------------------------------------------------------------------------
# growth
# ---------------------------------------------------------------------------

def _grow(x, binned, y, thresholds, n_classes, max_depth, min_leaf, n_sub,
          n_bins, rng) -> _Node:
    node = _Node(prediction=int(np.bincount(y, minlength=n_classes).argmax()))
    if max_depth <= 0 or len(np.unique(y)) == 1 or len(y) < 2 * min_leaf:
        return node
    n_feat = x.shape[1]
    subset = rng.choice(n_feat, size=min(n_sub, n_feat), replace=False)

    def search(feats):
        if n_bins:
            f, b, score = _best_split_hist(
                binned, y, np.asarray(feats), n_classes, n_bins, min_leaf
            )
            t = None if f is None else float(thresholds[f][b])
            return f, t, b, score
        f, t, score = _best_split_exact(x, y, n_classes, feats, min_leaf)
        return f, t, None, score

    f, t, b, score = search(subset)
    if f is None and len(subset) < n_feat:
        # the sampled subset had no usable split (e.g. already-exhausted
        # features); fall back to the full set before giving up
        f, t, b, score = search(np.arange(n_feat))
    if f is None:
        return node
    # split on the binned representation when binning is on, so growth and
    # the stored raw threshold stay consistent (bin <= b <=> x <= t)
    mask = (binned[:, f] <= b) if n_bins else (x[:, f] <= t)
    node.feature, node.threshold = f, t
    node.left = _grow(x[mask], binned[mask], y[mask], thresholds, n_classes,
                      max_depth - 1, min_leaf, n_sub, n_bins, rng)
    node.right = _grow(x[~mask], binned[~mask], y[~mask], thresholds,
                       n_classes, max_depth - 1, min_leaf, n_sub, n_bins, rng)
    return node


# ---------------------------------------------------------------------------
# array flattening + batched inference
# ---------------------------------------------------------------------------

def _flatten(root: _Node) -> tuple[np.ndarray, ...]:
    """Preorder arrays: feature (-1 = leaf), threshold, left, right (leaves
    self-loop so the gather loop can run a fixed depth), prediction."""
    feats, thrs, lefts, rights, preds = [], [], [], [], []

    def visit(node: _Node) -> int:
        i = len(feats)
        feats.append(node.feature)
        thrs.append(node.threshold)
        lefts.append(i)
        rights.append(i)
        preds.append(node.prediction)
        if not node.is_leaf:
            lefts[i] = visit(node.left)
            rights[i] = visit(node.right)
        return i

    visit(root)
    return (
        np.asarray(feats, np.int32),
        np.asarray(thrs, np.float32),
        np.asarray(lefts, np.int32),
        np.asarray(rights, np.int32),
        np.asarray(preds, np.int32),
    )


@dataclass
class RandomForestModel:
    """Stacked (num_trees, max_nodes) arrays; leaves self-loop, unused
    padding nodes are leaves predicting class 0 but are never reached."""

    feature: np.ndarray = field(default_factory=lambda: np.zeros((0, 0), np.int32))
    threshold: np.ndarray = field(default_factory=lambda: np.zeros((0, 0), np.float32))
    left: np.ndarray = field(default_factory=lambda: np.zeros((0, 0), np.int32))
    right: np.ndarray = field(default_factory=lambda: np.zeros((0, 0), np.int32))
    prediction: np.ndarray = field(default_factory=lambda: np.zeros((0, 0), np.int32))
    n_classes: int = 2
    max_depth: int = 5

    @staticmethod
    def from_trees(trees: list[_Node], n_classes: int,
                   max_depth: int) -> "RandomForestModel":
        flat = [_flatten(t) for t in trees]
        n_nodes = max(len(f[0]) for f in flat)

        def stack(i, dtype, fill=0):
            out = np.full((len(flat), n_nodes), fill, dtype)
            for t, arrs in enumerate(flat):
                out[t, : len(arrs[i])] = arrs[i]
            return out

        return RandomForestModel(
            feature=stack(0, np.int32, -1),
            threshold=stack(1, np.float32),
            left=stack(2, np.int32),
            right=stack(3, np.int32),
            prediction=stack(4, np.int32),
            n_classes=n_classes,
            max_depth=max_depth,
        )

    def _votes(self, x: np.ndarray) -> np.ndarray:
        """(B, D) -> (B, T) per-tree class votes, vectorized over both."""
        B = len(x)
        T = self.feature.shape[0]
        tree = np.arange(T)
        cur = np.zeros((B, T), np.int32)
        rows = np.arange(B)[:, None]
        for _ in range(self.max_depth):
            f = self.feature[tree, cur]                       # (B, T)
            go_left = x[rows, np.maximum(f, 0)] <= self.threshold[tree, cur]
            nxt = np.where(go_left, self.left[tree, cur], self.right[tree, cur])
            cur = np.where(f >= 0, nxt, cur)                  # leaves stay
        return self.prediction[tree, cur]

    def predict(self, x: np.ndarray) -> np.ndarray:
        """(B, D) -> (B,) majority-vote labels."""
        x = np.atleast_2d(np.asarray(x, np.float32))
        votes = self._votes(x)
        counts = np.zeros((len(x), self.n_classes), np.int64)
        np.add.at(counts, (np.arange(len(x))[:, None], votes), 1)
        return counts.argmax(axis=1)

    def predict_device(self, x, device=None) -> torch.Tensor:
        """On-device inference for large catalogs: the same fixed
        max_depth gather loop as `_votes`, batched over rows x trees on
        ``device`` (CUDA unless ``device="cpu"``), votes counted per row,
        the label the lowest class among the most votes. Returns a (B,)
        int64 tensor on that device."""
        dev = resolve_device(device)
        tables = [torch.as_tensor(a, device=dev).long()
                  for a in (self.feature, self.left, self.right,
                            self.prediction)]
        return _predict_device(
            tables[0], torch.as_tensor(self.threshold, device=dev),
            *tables[1:], torch.as_tensor(x, dtype=torch.float32, device=dev),
            self.n_classes, self.max_depth)


def _predict_device(feature, threshold, left, right, prediction, x,
                    n_classes: int, max_depth: int) -> torch.Tensor:
    B, T = x.shape[0], feature.shape[0]
    tree = torch.arange(T, device=x.device)[None, :]
    rows = torch.arange(B, device=x.device)[:, None]
    cur = torch.zeros((B, T), dtype=torch.long, device=x.device)
    for _ in range(max_depth):
        f = feature[tree, cur]                               # (B, T)
        go_left = x[rows, f.clamp(min=0)] <= threshold[tree, cur]
        nxt = torch.where(go_left, left[tree, cur], right[tree, cur])
        cur = torch.where(f >= 0, nxt, cur)                  # leaves stay
    votes = prediction[tree, cur]                            # (B, T)
    counts = torch.zeros((B, n_classes), dtype=torch.long, device=x.device)
    counts.scatter_add_(1, votes, torch.ones_like(votes))
    return counts.argmax(dim=1)


# ---------------------------------------------------------------------------
# training entry point
# ---------------------------------------------------------------------------

def random_forest_train(
    x: np.ndarray,
    y: np.ndarray,
    n_classes: int,
    num_trees: int = 10,
    max_depth: int = 5,
    min_leaf: int = 1,
    feature_subset: str = "auto",
    max_bins: int = 32,
    seed: int = 0,
) -> RandomForestModel:
    """Reference RandomForest.trainClassifier parameter shape
    (numTrees/maxDepth/featureSubsetStrategy/maxBins). max_bins=0 selects
    the exact unique-threshold search."""
    x = np.ascontiguousarray(x, np.float32)
    y = np.asarray(y, np.int64)
    min_leaf = max(1, min_leaf)  # empty children are never valid splits
    rng = np.random.default_rng(seed)
    n_feat = x.shape[1]
    n_sub = (
        max(1, int(np.sqrt(n_feat)))
        if feature_subset == "auto"
        else n_feat
    )
    if max_bins:
        thresholds = _quantile_thresholds(x, max_bins, rng)
        binned = _bin_features(x, thresholds)
        n_bins = thresholds.shape[1] + 1
    else:
        thresholds = np.zeros((n_feat, 0), np.float32)
        binned = np.zeros(x.shape, np.int16)
        n_bins = 0
    trees = []
    for _ in range(num_trees):
        idx = rng.integers(0, len(y), size=len(y))  # bootstrap
        trees.append(
            _grow(x[idx], binned[idx], y[idx], thresholds, n_classes,
                  max_depth, min_leaf, n_sub, n_bins, rng)
        )
    return RandomForestModel.from_trees(trees, n_classes, max_depth)
