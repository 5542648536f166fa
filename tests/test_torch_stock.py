"""The stock template of the port against the JAX package, on the CPU.

The indicators and the batched per-ticker solve run on the same seeded
inputs in both packages and agree within f32 rounding: the indicators to
1e-5 relative and 1e-6 absolute (the RSI, on a 0-100 scale, to 1e-4
absolute: cumsum differences of f32 returns in another order; the EMA
distance of prices near 5 to 4 f32 ulps of the prices, the rounding of
the recurrence left after the cancellation); the solve's
weights to 1e-4 relative and 1e-5 absolute (normal equations of up to a
few hundred f32 rows, a Cholesky factor of the other triangle). The
walk-forward backtest holds the same positions every day the two
packages' scores are further apart than SCORE_TOL (1e-5) from each other
and from the thresholds, and its NAV agrees to 1e-5 relative where every
day's positions are the same. The reference's own cases
(``tests/test_stock.py``) run on the port, and the committed example goes
through the train verb from another working directory, its relative
``filepath`` resolved against ``--engine-dir``, then a deploy over HTTP.
"""

import _torch_cpu  # noqa: F401  (one CPU thread: see the module)
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pio_tpu.models import stock as ref_stock
from pio_tpu.ops import indicators as ref_ind
from pio_tpu_torch.data.storage import Storage
from pio_tpu_torch.models import stock
from pio_tpu_torch.ops import indicators as ind
from pio_tpu_torch.workflow.context import create_workflow_context

import _torch_verbs as verbs

RTOL, ATOL = 1e-5, 1e-6
RSI_ATOL = 1e-4
W_RTOL, W_ATOL = 1e-4, 1e-5
SCORE_TOL = 1e-5
NAV_RTOL = 1e-5
FACTORY = "pio_tpu_torch.models.stock.StockEngine"


def _ctx():
    return create_workflow_context(
        Storage(env={"PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
                     "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
                     "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
                     "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM"}),
        device="cpu")


def _walks(T=300, N=6, seed=0):
    rng = np.random.default_rng(seed)
    return (5.0 + np.cumsum(rng.normal(0.0005, 0.01, (T, N)), axis=0)
            ).astype(np.float32)


@pytest.mark.parametrize("name, arg, atol", [
    ("log_returns", 1, ATOL), ("log_returns", 5, ATOL),
    ("rolling_mean", 7, ATOL), ("rsi", 14, RSI_ATOL), ("ema", 10, ATOL)])
def test_indicator_matches_reference(name, arg, atol):
    x = _walks()
    got = getattr(ind, name)(torch.from_numpy(x), arg).numpy()
    want = np.asarray(getattr(ref_ind, name)(jnp.asarray(x), arg))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol)


def test_indicator_matrix_matches_reference():
    x = _walks()
    spec = (("return", 1), ("return", 5), ("rsi", 14), ("ema_ratio", 12))
    got = ind.indicator_matrix(torch.from_numpy(x), spec).numpy()
    want = np.asarray(ref_ind.indicator_matrix(jnp.asarray(x), spec))
    assert got.shape == want.shape == (300, 6, 4)
    np.testing.assert_allclose(got[..., :3], want[..., :3], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got[..., 3], want[..., 3], rtol=0, atol=4
                               * np.spacing(np.float32(np.abs(x).max())))
    with pytest.raises(ValueError, match="unknown indicator"):
        ind.indicator_matrix(torch.from_numpy(x), (("macd", 3),))


def test_indicator_reference_cases():
    """tests/test_stock.py's naive windows, RSI extremes and first valid
    row, and the EMA of a constant."""
    x = np.random.default_rng(0).normal(size=(30, 3)).astype(np.float32)
    got = ind.log_returns(torch.from_numpy(x), 5).numpy()
    want = np.zeros_like(x)
    want[5:] = x[5:] - x[:-5]
    np.testing.assert_allclose(got, want, atol=1e-6)
    got = ind.rolling_mean(torch.from_numpy(x), 7).numpy()
    want = np.zeros_like(x)
    for t in range(6, 30):
        want[t] = x[t - 6:t + 1].mean(axis=0)
    np.testing.assert_allclose(got, want, atol=1e-5)
    up = np.cumsum(np.full((40, 1), 0.01, np.float32), axis=0)
    r_up = ind.rsi(torch.from_numpy(up), 14).numpy()
    assert (r_up[:14] == 0).all() and r_up[14] > 99 and (r_up[20:] > 99).all()
    assert (ind.rsi(torch.from_numpy(-up), 14).numpy()[20:] < 1).all()
    np.testing.assert_allclose(
        ind.rsi(torch.zeros(40, 1), 14).numpy()[20:], 50.0)
    np.testing.assert_allclose(
        ind.ema(torch.full((60, 2), 3.5), 10).numpy()[-1], 3.5, atol=1e-4)


def _regression_inputs(T=300, N=4, F=2, seed=1):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(T, N, F)).astype(np.float32)
    w_true = rng.normal(size=(N, F)).astype(np.float32)
    b_true = (rng.normal(size=N) * 0.1).astype(np.float32)
    y = (np.einsum("tnf,nf->tn", feats, w_true) + b_true
         + rng.normal(0, 0.01, (T, N))).astype(np.float32)
    return feats, y, w_true, b_true


@pytest.mark.parametrize("ridge", [1e-6, 1e-4, 1.0])
def test_fit_ticker_regressions_matches_reference(ridge):
    feats, y, w_true, b_true = _regression_inputs()
    got = stock.fit_ticker_regressions(torch.from_numpy(feats),
                                       torch.from_numpy(y), ridge).numpy()
    want = np.asarray(ref_stock.fit_ticker_regressions(
        jnp.asarray(feats), jnp.asarray(y), ridge))
    assert got.shape == (4, 3)
    np.testing.assert_allclose(got, want, rtol=W_RTOL, atol=W_ATOL)
    if ridge < 1e-3:   # the reference's recovery case
        np.testing.assert_allclose(got[:, :2], w_true, atol=1e-2)
        np.testing.assert_allclose(got[:, 2], b_true, atol=1e-2)


def _trending_frame(module, T=200, seed=2):
    rng = np.random.default_rng(seed)
    up = np.cumsum(np.full(T, 0.01) + rng.normal(0, 0.002, T))
    down = np.cumsum(np.full(T, -0.01) + rng.normal(0, 0.002, T))
    noise = np.cumsum(rng.normal(0, 0.002, T))
    lp = np.stack([up, down, noise], axis=1).astype(np.float32) + 5.0
    return module.PriceFrame(lp, ["UP", "DOWN", "NOISE"], list(range(T)))


def test_strategy_train_and_predict_as_reference():
    """The reference's trending-universe case on both packages: the same
    weights within W_* and the same answers."""
    params = dict(enter_threshold=0.0005, max_positions=1)
    algo = stock.RegressionStrategyAlgorithm(
        stock.RegressionStrategyParams(**params))
    model = algo.train(_ctx(), _trending_frame(stock))
    ref_algo = ref_stock.RegressionStrategyAlgorithm(
        ref_stock.RegressionStrategyParams(**params))
    ref_model = ref_algo.train(None, _trending_frame(ref_stock))
    np.testing.assert_allclose(model.weights, ref_model.weights,
                               rtol=W_RTOL, atol=W_ATOL)
    np.testing.assert_allclose(model.latest_features,
                               ref_model.latest_features, rtol=RTOL,
                               atol=ATOL)
    for q in ({}, {"tickers": ["DOWN", "nope"]}, {"tickers": ["NOISE"]}):
        got, want = algo.predict(model, q), ref_algo.predict(ref_model, q)
        assert [s["ticker"] for s in got["tickerScores"]] == [
            s["ticker"] for s in want["tickerScores"]]
        np.testing.assert_allclose(
            [s["score"] for s in got["tickerScores"]],
            [s["score"] for s in want["tickerScores"]], rtol=1e-4, atol=1e-6)
        assert (got["toEnter"], got["toExit"]) == (want["toEnter"],
                                                   want["toExit"])
    out = algo.predict(model, {})
    assert out["tickerScores"][0]["ticker"] == "UP"
    assert out["toEnter"] == ["UP"] and "DOWN" in out["toExit"]


def _recorded_positions(module, monkeypatch):
    """Every select_positions call of the module: (scores, held after)."""
    days = []
    real = module.select_positions

    def record(scores, held, params):
        out = real(scores, held, params)
        days.append((np.array(scores, np.float64), set(out)))
        return out

    monkeypatch.setattr(module, "select_positions", record)
    return days


def _apart(scores, params) -> bool:
    """Every score further than SCORE_TOL from every other score and from
    the thresholds: no rounding can reorder or re-classify them."""
    v = np.sort(np.concatenate([scores, [params.enter_threshold,
                                         params.exit_threshold]]))
    return bool((np.diff(v) > SCORE_TOL).all())


@pytest.mark.parametrize("universe", ["trending", "walks"])
def test_backtest_matches_reference(universe, monkeypatch):
    if universe == "trending":
        frames = (_trending_frame(stock, T=260),
                  _trending_frame(ref_stock, T=260))
        params = dict(enter_threshold=0.0005, max_positions=1)
        window = 60
    else:
        lp = _walks(T=320, N=12, seed=3)
        tickers = [f"T{j}" for j in range(12)]
        frames = (stock.PriceFrame(lp, tickers, list(range(320))),
                  ref_stock.PriceFrame(lp, tickers, list(range(320))))
        params = dict(enter_threshold=0.0005, max_positions=3)
        window = 100
    p, rp = (stock.RegressionStrategyParams(**params),
             ref_stock.RegressionStrategyParams(**params))
    port_days = _recorded_positions(stock, monkeypatch)
    ref_days = _recorded_positions(ref_stock, monkeypatch)
    res = stock.backtest(frames[0], p, train_window=window, device="cpu")
    ref = ref_stock.backtest(frames[1], rp, train_window=window)
    assert res.days == ref.days == len(port_days) == len(ref_days)
    assert len(res.nav) == res.days + 1
    same = True
    for (s, held), (rs, rheld) in zip(port_days, ref_days):
        np.testing.assert_allclose(s, rs, rtol=1e-3, atol=SCORE_TOL)
        if same and _apart(rs, rp):
            assert held == rheld
        same = same and held == rheld
    assert same, "positions parted on a day of near-tied scores"
    np.testing.assert_allclose(res.nav, ref.nav, rtol=NAV_RTOL)
    np.testing.assert_allclose(
        [res.total_return, res.volatility, res.sharpe],
        [ref.total_return, ref.volatility, ref.sharpe], rtol=1e-4, atol=1e-7)
    if universe == "trending":   # the reference's semantics case
        assert res.total_return > 0.5 and res.sharpe > 1.0
        np.testing.assert_allclose(res.nav[-1],
                                   np.exp(np.sum(res.daily_returns)),
                                   rtol=1e-6)


def test_backtest_requires_history_and_a_device():
    with pytest.raises(ValueError, match="need more"):
        stock.backtest(_trending_frame(stock, T=50), train_window=100,
                       device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            stock.backtest(_trending_frame(stock, T=260), train_window=60)


def test_frames_and_csv_as_reference(tmp_path):
    rows = [("d1", "A", 10.0), ("d2", "A", 11.0), ("d4", "A", 12.0),
            ("d2", "B", 5.0), ("d3", "B", 6.0), ("d4", "B", 7.0)]
    got, want = stock._frame_from_rows(rows), ref_stock._frame_from_rows(rows)
    np.testing.assert_array_equal(got.log_price, want.log_price)
    assert (got.tickers, got.dates) == (want.tickers, want.dates)
    with pytest.raises(ValueError, match="non-positive"):
        stock._frame_from_rows([("d1", "A", -3.0)])
    csv = os.path.join(verbs.EXAMPLES, "stock", "data", "prices.csv")
    got = stock.StockDataSource(
        stock.DataSourceParams(filepath=csv)).read_training(None)
    want = ref_stock.StockDataSource(
        ref_stock.DataSourceParams(filepath=csv)).read_training(None)
    np.testing.assert_array_equal(got.log_price, want.log_price)
    assert got.tickers == want.tickers


def test_engine_dir_relative_filepath_train_and_deploy(tmp_path,
                                                        monkeypatch):
    """The committed example (relative ./data/prices.csv) trained by the
    verb from another working directory, then served: each body equals
    the in-process answer, and the model equals the reference's on the
    same CSV."""
    d = tmp_path / "stock"
    verbs.copy_example("stock", d, FACTORY)
    elsewhere = tmp_path / "elsewhere"
    elsewhere.mkdir()
    storage = Storage(env=verbs.sqlite_env(tmp_path / "pio.db"))
    assert verbs.train_in_process(d, storage, monkeypatch, elsewhere) == 0
    with verbs.deployed(d, storage, "stock") as (port, qs):
        tickers = qs.models[0].tickers
        queries = [{}, {"tickers": tickers[:2]}, {"tickers": ["nope"]}]
        bodies = verbs.served_as_in_process(port, qs, queries)
        assert bodies[0]["tickerScores"] and bodies[2]["tickerScores"] == []
        assert verbs.batchpredict(d, storage, monkeypatch, queries,
                                  tmp_path) == bodies
        csv = os.path.join(verbs.EXAMPLES, "stock", "data", "prices.csv")
        ref_algo = ref_stock.RegressionStrategyAlgorithm(
            ref_stock.RegressionStrategyParams(
                indicators=(("return", 1), ("return", 5), ("rsi", 14)),
                enter_threshold=0.0005, max_positions=2))
        ref_model = ref_algo.train(None, ref_stock.StockDataSource(
            ref_stock.DataSourceParams(filepath=csv)).read_training(None))
        np.testing.assert_allclose(qs.models[0].weights, ref_model.weights,
                                   rtol=W_RTOL, atol=W_ATOL)
    storage.close()
