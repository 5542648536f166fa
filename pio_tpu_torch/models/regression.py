"""Regression engine template — ridge (closed form) + linear SGD.

Counterpart of ``pio_tpu.models.regression``: the same datasource (a
"label f1 f2 ..." file or event-store properties, seeded k folds), params,
``LinearModel``, query {"features": [...]} and AverageServing
(reference examples/experimental/scala-parallel-regression/Run.scala:33-80,
scala-local-regression/Run.scala:26-60).

Both algorithms train on the context's device in f32. Ridge forms the
Gram matrix by one (D, N) x (N, D) product and solves it by Cholesky
(``torch.linalg.cholesky_ex``); where the factorization fails (a singular
Gram: collinear or constant features, D > N, with reg 0) it takes the
min-norm least-squares answer from the pseudo-inverse on the same device,
the reference's own branch (its ``lstsq`` after a NaN Cholesky). SGD runs
MLlib's GradientDescent schedule (stepSize / sqrt(t)) as a loop on the
device; mini-batches are the reference's index matrix, drawn from
``np.random.default_rng(seed)`` in the same order. The model's weights
live on the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from pio_tpu_torch.controller.base import (
    AverageServing,
    DataSource,
    IdentityPreparator,
    P2LAlgorithm,
    Params,
)
from pio_tpu_torch.controller.engine import Engine, EngineFactory
from pio_tpu_torch.e2.crossvalidation import split_data
from pio_tpu_torch.workflow.context import resolve_device


@dataclass(frozen=True)
class DataSourceParams(Params):
    """Either a whitespace-separated text file ("label f1 f2 ...", the
    reference ParallelDataSource filepath contract) or event-store entity
    properties (numeric `attributes` + `label`, like the classification
    template)."""

    path_fields = ("filepath",)  # engine-dir-relative (CLI absolutizes)

    filepath: str = ""
    app_name: str = ""
    attributes: tuple[str, ...] = ()
    label: str = "label"
    entity_type: str = "point"
    eval_k: int = 0
    seed: int = 9527


@dataclass
class RegressionData:
    x: np.ndarray  # (N, D) float32
    y: np.ndarray  # (N,) float32

    def sanity_check(self):
        if len(self.y) == 0:
            raise ValueError(
                "RegressionData is empty; check filepath / event properties."
            )
        if not np.isfinite(self.x).all() or not np.isfinite(self.y).all():
            raise ValueError("RegressionData contains non-finite values.")


class RegressionDataSource(DataSource):
    """Reference ParallelDataSource (Run.scala:33-51): parse rows, k-fold
    for eval. Event-store mode mirrors ClassificationDataSource but with
    numeric attributes only."""

    params_class = DataSourceParams

    def __init__(self, params: DataSourceParams):
        self.params = params

    def _read(self, ctx) -> RegressionData:
        p = self.params
        if p.filepath:
            rows = []
            with open(p.filepath) as f:
                for line in f:
                    parts = line.split()
                    if parts:
                        rows.append([float(v) for v in parts])
            if not rows:
                return RegressionData(
                    np.zeros((0, 0), np.float32), np.zeros(0, np.float32)
                )
            arr = np.asarray(rows, np.float32)
            return RegressionData(x=arr[:, 1:], y=arr[:, 0])
        props = ctx.event_store.aggregate_properties(
            app_name=p.app_name,
            entity_type=p.entity_type,
            required=[p.label, *p.attributes],
        )
        xs, ys = [], []
        for _, pm in sorted(props.items()):
            xs.append([float(pm.get(a)) for a in p.attributes])
            ys.append(float(pm.get(p.label)))
        return RegressionData(
            x=np.asarray(xs, np.float32).reshape(len(ys), -1),
            y=np.asarray(ys, np.float32),
        )

    def read_training(self, ctx) -> RegressionData:
        return self._read(ctx)

    def read_eval(self, ctx):
        data = self._read(ctx)
        if self.params.eval_k <= 1:
            return []
        # seeded shuffle before the index-mod-k split: the reference's
        # MLUtils.kFold is seeded-random (Run.scala:45, seed 9527), and an
        # unshuffled file sorted by label would otherwise give skewed folds
        rows = list(np.random.default_rng(self.params.seed).permutation(
            len(data.y)))
        folds = []
        for train_rows, info, test_rows in split_data(rows, self.params.eval_k):
            tr = RegressionData(x=data.x[train_rows], y=data.y[train_rows])
            qa = [
                ({"features": data.x[i].tolist()}, float(data.y[i]))
                for i in test_rows
            ]
            folds.append((tr, info, qa))
        return folds


@dataclass
class LinearModel:
    """w·x + b. Weights live on host (few KB); prediction is a matvec."""

    weights: np.ndarray  # (D,)
    intercept: float

    def predict(self, x: np.ndarray) -> np.ndarray:
        return x @ self.weights + self.intercept


def _predict_query(model: LinearModel, query: dict) -> float:
    x = np.asarray(query["features"], np.float32)
    return float(x @ model.weights + model.intercept)


def _batch_predict(model: LinearModel, queries: Sequence[dict]) -> list:
    if not queries:
        return []
    x = np.stack([np.asarray(q["features"], np.float32) for q in queries])
    return [float(v) for v in model.predict(x)]


def _device_of(ctx) -> torch.device:
    return ctx.device if ctx is not None else resolve_device(None)


@dataclass(frozen=True)
class RidgeParams(Params):
    reg: float = 0.0          # L2 penalty (0 = ordinary least squares)
    fit_intercept: bool = True


def ridge_solve(x: torch.Tensor, y: torch.Tensor, reg: float,
                fit_intercept: bool = True):
    """(N, D) x and (N,) y, f32 on one device -> (weights (D,), intercept
    ()) on that device: the centred Gram plus reg·I solved by Cholesky,
    or, where it does not factor, the min-norm least-squares weights."""
    if fit_intercept:
        x_mean = x.mean(dim=0)
        y_mean = y.mean()
        xc, yc = x - x_mean, y - y_mean
    else:
        xc, yc = x, y
    d = xc.shape[1]
    gram = xc.T @ xc + reg * torch.eye(d, dtype=x.dtype, device=x.device)
    rhs = xc.T @ yc
    chol, info = torch.linalg.cholesky_ex(gram)
    w = torch.cholesky_solve(rhs[:, None], chol)[:, 0]
    if int(info) != 0 or not bool(torch.isfinite(w).all()):
        # singular Gram (collinear features / D > N) with reg == 0: the
        # min-norm least-squares solution, as the reference's lstsq
        w = torch.linalg.pinv(xc) @ yc
    if not fit_intercept:
        return w, torch.zeros((), device=x.device)
    return w, y_mean - x_mean @ w


class RidgeRegressionAlgorithm(P2LAlgorithm):
    """Closed-form ridge on the device — the answer to both the local
    example's breeze normal equations (scala-local-regression/Run.scala:
    nak LinearRegression) and MLlib RidgeRegressionWithSGD."""

    params_class = RidgeParams

    def __init__(self, params: RidgeParams = RidgeParams()):
        self.params = params

    def train(self, ctx, data: RegressionData) -> LinearModel:
        data.sanity_check()
        dev = _device_of(ctx)
        w, b = ridge_solve(torch.as_tensor(data.x, device=dev),
                           torch.as_tensor(data.y, device=dev),
                           self.params.reg, self.params.fit_intercept)
        return LinearModel(weights=w.cpu().numpy().astype(np.float64),
                           intercept=float(b))

    def predict(self, model: LinearModel, query: dict) -> float:
        return _predict_query(model, query)

    def batch_predict(self, model: LinearModel, queries) -> list:
        return _batch_predict(model, queries)


@dataclass(frozen=True)
class SGDParams(Params):
    """MLlib LinearRegressionWithSGD.train signature
    (scala-parallel-regression/Run.scala:55-63)."""

    num_iterations: int = 200
    step_size: float = 0.1
    mini_batch_fraction: float = 1.0
    seed: int = 0


def sgd_fit(x: torch.Tensor, y: torch.Tensor, p: SGDParams
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The SGD iterations on x's device: full-batch when the fraction
    covers every row, else the reference's (num_iterations, batch) index
    matrix from ``default_rng(seed)``. -> (weights (D,), intercept ())."""
    n, d = x.shape
    dev = x.device
    batch = max(1, int(round(n * min(1.0, p.mini_batch_fraction))))
    steps = p.step_size / torch.sqrt(torch.arange(
        1, p.num_iterations + 1, dtype=torch.float32, device=dev))
    w = torch.zeros(d, dtype=torch.float32, device=dev)
    b = torch.zeros((), dtype=torch.float32, device=dev)
    idx = None
    if batch < n:
        rng = np.random.default_rng(p.seed)
        idx = torch.as_tensor(rng.integers(0, n, size=(p.num_iterations,
                                                       batch)), device=dev)
    for it in range(p.num_iterations):
        xb, yb = (x, y) if idx is None else (x[idx[it]], y[idx[it]])
        resid = xb @ w + b - yb           # (B,)
        gw = xb.T @ resid / (n if idx is None else batch)
        gb = resid.mean()
        w = w - steps[it] * gw
        b = b - steps[it] * gb
    return w, b


class SGDRegressionAlgorithm(P2LAlgorithm):
    """LinearRegressionWithSGD parity: the iteration loop runs on the
    device; mini-batches are drawn by a pre-generated index matrix."""

    params_class = SGDParams

    def __init__(self, params: SGDParams = SGDParams()):
        self.params = params

    def train(self, ctx, data: RegressionData) -> LinearModel:
        data.sanity_check()
        dev = _device_of(ctx)
        w, b = sgd_fit(torch.as_tensor(data.x, device=dev),
                       torch.as_tensor(data.y, device=dev), self.params)
        return LinearModel(
            weights=w.cpu().numpy().astype(np.float64), intercept=float(b)
        )

    def predict(self, model: LinearModel, query: dict) -> float:
        return _predict_query(model, query)

    def batch_predict(self, model: LinearModel, queries) -> list:
        return _batch_predict(model, queries)


class RegressionEngine(EngineFactory):
    """Reference RegressionEngineFactory (scala-parallel-regression/
    Run.scala:72-80): datasource + identity preparator + SGD algo +
    LAverageServing; plus the exact ridge solver as a second algorithm."""

    @classmethod
    def apply(cls) -> Engine:
        return Engine(
            RegressionDataSource,
            IdentityPreparator,
            {"ridge": RidgeRegressionAlgorithm, "sgd": SGDRegressionAlgorithm},
            AverageServing,
        )
