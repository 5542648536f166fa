"""Stock backtesting engine template — indicator regression + walk-forward
backtest.

Counterpart of ``pio_tpu.models.stock``: the same price panel, params,
model, query {"tickers"?: [...]} and result {"tickerScores", "toEnter",
"toExit"} (reference examples/experimental/scala-stock:
YahooDataSource.scala / DataSource.scala, Indicators.scala,
RegressionStrategy.scala:38-53, BackTestingMetrics.scala:19-60).

The whole universe is one batched solve: the indicator features are a
(T, N, F) tensor (``ops/indicators.py``), the per-ticker normal equations
one einsum pair, and the solve a batched Cholesky
(``torch.linalg.cholesky`` + ``torch.cholesky_solve``), all on the
training device. ``StockModel`` holds host arrays, and scoring, the
threshold policy and the backtest's portfolio bookkeeping stay on the host
as in the reference; only the (re)training solves run on the device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from pio_tpu_torch.controller.base import (
    DataSource,
    FirstServing,
    IdentityPreparator,
    P2LAlgorithm,
    Params,
)
from pio_tpu_torch.controller.engine import Engine, EngineFactory
from pio_tpu_torch.ops.indicators import indicator_matrix, log_returns
from pio_tpu_torch.workflow.context import resolve_device

DEFAULT_INDICATORS = (("return", 1), ("return", 5), ("rsi", 14))


@dataclass(frozen=True)
class DataSourceParams(Params):
    """Price series from `$set` events carrying a `price` property on
    ticker entities (one event per ticker per day), or a CSV file of
    `date,ticker,price` rows (the offline stand-in for the reference's
    YahooDataSource)."""

    path_fields = ("filepath",)

    filepath: str = ""
    app_name: str = ""
    entity_type: str = "ticker"
    price_key: str = "price"


@dataclass
class PriceFrame:
    """(T, N) price panel + labels (the reference's saddle Frame role)."""

    log_price: np.ndarray        # (T, N) float32 log prices
    tickers: list[str]
    dates: list                  # length T, sorted ascending

    def sanity_check(self):
        if self.log_price.size == 0:
            raise ValueError("PriceFrame is empty; check price events/file.")
        if not np.isfinite(self.log_price).all():
            raise ValueError("PriceFrame has non-finite log prices.")


def _frame_from_rows(rows: list[tuple]) -> PriceFrame:
    """rows: (date, ticker, price). Missing points forward-fill; leading
    gaps back-fill from the first seen price."""
    dates = sorted({d for d, _, _ in rows})
    tickers = sorted({t for _, t, _ in rows})
    d_ix = {d: i for i, d in enumerate(dates)}
    t_ix = {t: j for j, t in enumerate(tickers)}
    m = np.full((len(dates), len(tickers)), np.nan, np.float64)
    for d, t, p in rows:
        if p <= 0:
            raise ValueError(f"non-positive price {p} for {t} @ {d}")
        m[d_ix[d], t_ix[t]] = np.log(p)
    # forward-fill then back-fill per column
    for j in range(m.shape[1]):
        col = m[:, j]
        mask = np.isnan(col)
        if mask.all():
            raise ValueError(f"ticker {tickers[j]} has no prices")
        idx = np.where(~mask, np.arange(len(col)), 0)
        np.maximum.accumulate(idx, out=idx)
        col[:] = col[idx]
        first = np.flatnonzero(~mask)[0]
        col[:first] = col[first]
    return PriceFrame(m.astype(np.float32), tickers, dates)


class StockDataSource(DataSource):
    params_class = DataSourceParams

    def __init__(self, params: DataSourceParams):
        self.params = params

    def read_training(self, ctx) -> PriceFrame:
        p = self.params
        rows: list[tuple] = []
        if p.filepath:
            with open(p.filepath) as f:
                for line in f:
                    line = line.strip()
                    if not line or line.startswith("date,"):
                        continue
                    d, t, price = line.split(",")
                    rows.append((d, t, float(price)))
        else:
            # $set price events only; the panel row key is the DATE — one
            # row per calendar day regardless of intraday timestamps, the
            # latest event of a day winning (events arrive time-ordered,
            # and _frame_from_rows overwrites on duplicate (date, ticker))
            events = sorted(
                ctx.event_store.find(
                    app_name=p.app_name, entity_type=p.entity_type,
                    event_names=["$set"],
                ),
                key=lambda e: e.event_time,
            )
            for e in events:
                price = e.properties.get_or_else(p.price_key, None)
                if price is not None:
                    rows.append(
                        (e.event_time.date(), e.entity_id, float(price)))
        return _frame_from_rows(rows)


@dataclass(frozen=True)
class RegressionStrategyParams(Params):
    """Reference RegressionStrategyParams (indicators +
    maxTrainingWindowSize) merged with BacktestingParams (enter/exit
    thresholds, maxPositions)."""

    indicators: tuple = DEFAULT_INDICATORS
    max_training_window: int = 200
    enter_threshold: float = 0.001
    exit_threshold: float = 0.0
    max_positions: int = 3
    ridge: float = 1e-4


def score_with_weights(feats: np.ndarray, weights: np.ndarray) -> np.ndarray:
    """(N, F) features x (N, F+1) weights (bias last) -> (N,) scores —
    the ONE scoring implementation predict and backtest both use."""
    f1 = np.concatenate(
        [feats, np.ones((feats.shape[0], 1), np.float32)], axis=1)
    return np.einsum("nf,nf->n", f1, weights)


def select_positions(
    scores: np.ndarray,
    held: set[int],
    params: "RegressionStrategyParams",
) -> set[int]:
    """The threshold policy (reference BacktestingParams semantics): exit
    holdings below exit_threshold, then enter the top scorers above
    enter_threshold until max_positions are held. Shared by predict
    (held = empty: stateless advice) and backtest (persistent holdings)."""
    held = {i for i in held if scores[i] >= params.exit_threshold}
    for i in np.argsort(-scores):
        if len(held) >= params.max_positions:
            break
        if scores[i] > params.enter_threshold:
            held.add(int(i))
    return held


@dataclass
class StockModel:
    weights: np.ndarray          # (N, F+1) per-ticker regression weights
    latest_features: np.ndarray  # (N, F) indicator values at the last day
    tickers: list[str]
    params: RegressionStrategyParams

    def scores(self) -> np.ndarray:
        return score_with_weights(self.latest_features, self.weights)


def fit_ticker_regressions(
    feats: torch.Tensor, targets: torch.Tensor, ridge: float
) -> torch.Tensor:
    """Batched per-ticker least squares on the inputs' device: feats
    (T, N, F), targets (T, N) -> weights (N, F+1) with a bias column — the
    reference's per-symbol nak regression (RegressionStrategy.scala:39-53)
    as ONE batched Cholesky solve."""
    T, N, F = feats.shape
    X = torch.cat([feats, feats.new_ones((T, N, 1))], dim=-1)  # (T, N, F+1)
    A = torch.einsum("tnf,tng->nfg", X, X)
    A = A + ridge * torch.eye(F + 1, dtype=X.dtype, device=X.device)[None]
    b = torch.einsum("tnf,tn->nf", X, targets)
    # cholesky_solve takes its right-hand sides as columns: (N, F+1, 1)
    chol = torch.linalg.cholesky(A)
    return torch.cholesky_solve(b.unsqueeze(-1), chol).squeeze(-1)


def _features_targets(log_price: torch.Tensor, indicators):
    """-> (features (T, N, F), realized 1-day returns (T, N)) on the
    price tensor's device."""
    return (indicator_matrix(log_price, tuple(indicators)),
            log_returns(log_price, 1))


class RegressionStrategyAlgorithm(P2LAlgorithm):
    params_class = RegressionStrategyParams

    def __init__(self, params=RegressionStrategyParams()):
        self.params = params

    def train(self, ctx, frame: PriceFrame) -> StockModel:
        """The indicators and the batched solve on ``ctx.device``."""
        frame.sanity_check()
        p = self.params
        dev = ctx.device if ctx is not None else resolve_device(None)
        feats, target = _features_targets(
            torch.as_tensor(frame.log_price, device=dev), p.indicators)
        # predict NEXT day's return from today's features
        latest = feats[-1]
        feats, targets = feats[:-1], target[1:]
        w = p.max_training_window
        if feats.shape[0] > w:
            feats, targets = feats[-w:], targets[-w:]
        weights = fit_ticker_regressions(feats, targets, p.ridge)
        return StockModel(
            weights=weights.cpu().numpy(),
            latest_features=latest.cpu().numpy(),
            tickers=frame.tickers,
            params=p,
        )

    def predict(self, model: StockModel, query: dict) -> dict:
        """{"tickers"?: [...]} -> predicted next-day log returns + the
        threshold strategy's enter/exit calls (reference DailyResult)."""
        scores = model.scores()
        order = {t: i for i, t in enumerate(model.tickers)}
        asked = [t for t in (query.get("tickers") or model.tickers)
                 if t in order]
        idx = {order[t] for t in asked}
        # the SAME policy the backtest simulates, restricted to the asked
        # universe, from a flat (no holdings) position
        mask = np.full(len(scores), -np.inf)
        for i in idx:
            mask[i] = scores[i]
        enter_idx = select_positions(mask, set(), model.params)
        out = sorted(
            ({"ticker": t, "score": float(scores[order[t]])} for t in asked),
            key=lambda d: -d["score"],
        )
        enter = sorted((model.tickers[i] for i in enter_idx),
                       key=lambda t: -scores[order[t]])
        exit_ = [t for t in asked
                 if scores[order[t]] < model.params.exit_threshold]
        return {
            "tickerScores": out,
            "toEnter": enter,
            "toExit": exit_,
        }


# ---------------------------------------------------------------------------
# walk-forward backtest (reference BackTestingMetrics.scala)
# ---------------------------------------------------------------------------

@dataclass
class BacktestResult:
    nav: list[float]             # daily net asset value (starts at 1.0)
    daily_returns: list[float]
    total_return: float
    volatility: float            # stdev of daily returns
    sharpe: float                # annualized (sqrt(252))
    days: int

    def to_dict(self) -> dict:
        return {
            "nav": self.nav, "dailyReturns": self.daily_returns,
            "ret": self.total_return, "vol": self.volatility,
            "sharpe": self.sharpe, "days": self.days,
        }


def backtest(
    frame: PriceFrame,
    params: RegressionStrategyParams = RegressionStrategyParams(),
    train_window: int = 100,
    retrain_every: int = 5,
    *,
    device=None,
) -> BacktestResult:
    """Walk-forward: retrain the batched regression every `retrain_every`
    days on the trailing window, each day enter the top-scoring tickers
    above enter_threshold (up to max_positions, reference
    BacktestingParams), exit below exit_threshold, and realize the held
    tickers' next-day returns equal-weighted into NAV. The indicators and
    each retrain's solve run on ``device`` (CUDA unless "cpu"); the
    features and returns come to the host once for the daily loop."""
    lp = frame.log_price
    T, N = lp.shape
    if T <= train_window + 2:
        raise ValueError(
            f"need more than {train_window + 2} days, have {T}"
        )
    dev = resolve_device(device)
    feats_dev, rets_dev = _features_targets(
        torch.as_tensor(lp, device=dev), params.indicators)
    feats_all = feats_dev.cpu().numpy()
    rets_all = rets_dev.cpu().numpy()

    nav = [1.0]
    daily: list[float] = []
    held: set[int] = set()
    weights = None
    for t in range(train_window, T - 1):
        if weights is None or (t - train_window) % retrain_every == 0:
            weights = fit_ticker_regressions(
                feats_dev[t - train_window:t - 1],
                rets_dev[t - train_window + 1:t], params.ridge,
            ).cpu().numpy()
        scores = score_with_weights(feats_all[t], weights)
        held = select_positions(scores, held, params)
        day_ret = (
            float(np.mean([rets_all[t + 1, i] for i in held]))
            if held else 0.0
        )
        daily.append(day_ret)
        nav.append(nav[-1] * float(np.exp(day_ret)))
    arr = np.array(daily)
    vol = float(arr.std())
    mean = float(arr.mean())
    sharpe = float(mean / vol * np.sqrt(252)) if vol > 0 else 0.0
    return BacktestResult(
        nav=[float(v) for v in nav],
        daily_returns=[float(r) for r in daily],
        total_return=float(nav[-1] - 1.0),
        volatility=vol,
        sharpe=sharpe,
        days=len(daily),
    )


class StockEngine(EngineFactory):
    """Reference scala-stock Run.scala composition: DataSource +
    RegressionStrategy + (backtest via `backtest()` / the evaluation
    workflow)."""

    @classmethod
    def apply(cls) -> Engine:
        return Engine(
            StockDataSource,
            IdentityPreparator,
            {"regression": RegressionStrategyAlgorithm},
            FirstServing,
        )
