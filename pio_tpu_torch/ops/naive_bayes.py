"""Naive Bayes models.

Counterpart of ``pio_tpu.ops.naive_bayes``, with its two variants:
 * ``MultinomialNBModel`` — count/one-hot vectors, replacing MLlib
   NaiveBayes as used by the classification template
   (examples/scala-parallel-classification/.../NaiveBayesAlgorithm.scala:15-27):
   trained and scored in torch on a device (CUDA unless ``device="cpu"``),
   its scores one (B,D)x(D,L) product at ``ops.bucketing.dispatch_rows``
   rows, the label an argmax that takes the lowest index among equal
   scores, as ``jnp.argmax`` does;
 * ``CategoricalNBModel`` — string-categorical features, replacing
   e2/.../engine/CategoricalNaiveBayes.scala:6-176: host numpy, as in the
   reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from pio_tpu_torch.data.bimap import BiMap
from pio_tpu_torch.ops.bucketing import dispatch_rows, padded_rows
from pio_tpu_torch.workflow.context import resolve_device


# ---------------------------------------------------------------------------
# multinomial NB over vectors
# ---------------------------------------------------------------------------

@dataclass
class MultinomialNBModel:
    log_prior: torch.Tensor      # (L,)
    log_theta: torch.Tensor      # (L, D)


def multinomial_nb_train(
    x: np.ndarray, y: np.ndarray, n_classes: int, smoothing: float = 1.0,
    device=None,
) -> MultinomialNBModel:
    """x: (N, D) non-negative counts; y: (N,) int labels. f32 on
    ``device``, as the reference's arrays are."""
    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(x, np.float32), device=dev)
    y = torch.as_tensor(np.asarray(y, np.int64), device=dev)
    one_hot = torch.nn.functional.one_hot(y, n_classes).to(torch.float32)
    class_count = one_hot.sum(dim=0)                           # (L,)
    feat_count = one_hot.T @ x                                 # (L, D)
    log_prior = torch.log(class_count + smoothing) - torch.log(
        class_count.sum() + smoothing * n_classes
    )
    smoothed = feat_count + smoothing
    log_theta = torch.log(smoothed) - torch.log(
        smoothed.sum(dim=1, keepdim=True)
    )
    return MultinomialNBModel(log_prior, log_theta)


def multinomial_nb_scores(model: MultinomialNBModel, x) -> torch.Tensor:
    """(B, D) -> (B, L) joint log-likelihoods, on the model's device."""
    lt = model.log_theta
    x = torch.as_tensor(x, dtype=lt.dtype, device=lt.device)
    b = x.shape[0]
    scores = padded_rows(x, dispatch_rows(b)) @ lt.T
    return scores[:b] + model.log_prior[None, :]


def multinomial_nb_predict(model: MultinomialNBModel,
                           x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float32)
    return torch.argmax(multinomial_nb_scores(model, x),
                        dim=1).cpu().numpy()


# ---------------------------------------------------------------------------
# categorical NB over string features (e2 parity)
# ---------------------------------------------------------------------------

@dataclass
class CategoricalNBModel:
    """Reference CategoricalNaiveBayes.Model: priors + per-position
    log-likelihoods, with a smoothed floor for unseen categories."""

    labels: BiMap                     # label -> index
    categories: list[BiMap]           # per position: value -> index
    log_prior: np.ndarray             # (L,)
    log_likelihood: np.ndarray        # (L, P, Cmax)
    log_floor: np.ndarray             # (L, P) score for unseen values

    def _encode(self, features: Sequence[str]) -> tuple[np.ndarray, np.ndarray]:
        idx = np.zeros(len(features), np.int32)
        seen = np.zeros(len(features), bool)
        for p, v in enumerate(features):
            j = self.categories[p].get(v, -1) if p < len(self.categories) else -1
            if j is not None and j >= 0:
                idx[p] = j
                seen[p] = True
        return idx, seen

    def log_score(self, features: Sequence[str], label: str) -> float | None:
        """Reference Model.logScore: None when the label is unknown; unseen
        feature values use the smoothed floor."""
        if label not in self.labels:
            return None
        li = self.labels[label]
        idx, seen = self._encode(features)
        pos = np.arange(len(features))
        ll = np.where(
            seen, self.log_likelihood[li, pos, idx], self.log_floor[li, pos]
        )
        return float(self.log_prior[li] + ll.sum())

    def predict(self, features: Sequence[str]) -> str:
        """Reference Model.predict: argmax over labels."""
        idx, seen = self._encode(features)
        pos = np.arange(len(features))
        ll = np.where(
            seen[None, :],
            self.log_likelihood[:, pos, idx],
            self.log_floor[:, pos],
        ).sum(axis=1)
        scores = self.log_prior + ll
        return self.labels.inverse()[int(np.argmax(scores))]


def categorical_nb_train(
    labeled_points: Sequence[tuple[str, Sequence[str]]],
    smoothing: float = 1.0,
) -> CategoricalNBModel:
    """labeled_points: [(label, [feature values...])] — the reference's
    LabeledPoint shape (CategoricalNaiveBayes.scala LabeledPoint)."""
    if not labeled_points:
        raise ValueError("categorical_nb_train needs at least one point")
    n_pos = len(labeled_points[0][1])
    for lbl, feats in labeled_points:
        if len(feats) != n_pos:
            raise ValueError("all points must have the same feature count")
    labels = BiMap.string_int(lbl for lbl, _ in labeled_points)
    categories = [
        BiMap.string_int(f[p] for _, f in labeled_points)
        for p in range(n_pos)
    ]
    L = len(labels)
    cmax = max((len(c) for c in categories), default=1)
    counts = np.zeros((L, n_pos, cmax), np.float64)
    label_counts = np.zeros(L, np.float64)
    for lbl, feats in labeled_points:
        li = labels[lbl]
        label_counts[li] += 1
        for p, v in enumerate(feats):
            counts[li, p, categories[p][v]] += 1
    log_prior = np.log(label_counts) - np.log(label_counts.sum())
    denom = label_counts[:, None, None] + smoothing * np.array(
        [len(c) for c in categories]
    )[None, :, None]
    log_likelihood = np.log(counts + smoothing) - np.log(denom)
    log_floor = (np.log(smoothing) - np.log(denom))[:, :, 0]
    return CategoricalNBModel(
        labels=labels,
        categories=categories,
        log_prior=log_prior,
        log_likelihood=log_likelihood,
        log_floor=log_floor,
    )
