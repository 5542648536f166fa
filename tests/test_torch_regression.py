"""The regression template of the port against the JAX package, on the CPU.

Both packages fit the same seeded data. Ridge's weights and intercept
agree to 1e-5 relative and 1e-6 absolute (a Gram matrix of a few hundred
f32 rows summed in another order, solved by Cholesky); a singular Gram
(a constant feature with reg 0) takes the min-norm answer in both, the
port's from the pseudo-inverse, the reference's from ``lstsq``, to the same
tolerance. SGD, full batch and mini-batch (the same index matrix from
``default_rng(seed)``), agrees to 1e-4 absolute after its iterations (f32
products in another order each step; the step-size schedule is the same
f32 sequence). The engine's k-fold eval gives the same MSE to 1e-4
relative, AverageServing averages the two algorithms as the reference's
does, the reference's own cases (``tests/test_regression.py``) run on the
port, and the committed example trains through ``python -m pio_tpu_torch
train`` started in another working directory, its relative
``./data/sample.txt`` resolved against ``--engine-dir``, then deploys.
"""

import _torch_cpu  # noqa: F401  (one CPU thread: see the module)
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pio_tpu.controller import EngineParams as RefEngineParams
from pio_tpu.e2.metrics import MeanSquareError as RefMSE
from pio_tpu.models import regression as ref_reg
from pio_tpu_torch.controller import AverageServing, EngineParams
from pio_tpu_torch.data.storage import Storage
from pio_tpu_torch.e2.metrics import MeanSquareError
from pio_tpu_torch.models import regression as reg
from pio_tpu_torch.workflow.context import create_workflow_context

import _torch_verbs as verbs

RTOL, ATOL = 1e-5, 1e-6
SGD_ATOL = 1e-4
MSE_RTOL = 1e-4
FACTORY = "pio_tpu_torch.models.regression.RegressionEngine"
W_TRUE = np.array([2.0, -1.0, 0.5, 3.0])
B_TRUE = 1.5


def _ctx():
    return create_workflow_context(
        Storage(env={"PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
                     "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
                     "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
                     "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM"}),
        device="cpu")


def _make(n=400, noise=0.01, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, len(W_TRUE))).astype(np.float32)
    y = (x @ W_TRUE + B_TRUE + rng.normal(scale=noise, size=n)).astype(
        np.float32)
    return x, y


def _both(x, y):
    return reg.RegressionData(x=x, y=y), ref_reg.RegressionData(x=x, y=y)


def _same_model(got, want, atol=ATOL):
    np.testing.assert_allclose(got.weights, want.weights, rtol=RTOL,
                               atol=atol)
    assert got.intercept == pytest.approx(want.intercept, rel=RTOL, abs=atol)


@pytest.mark.parametrize("reg_, fit_intercept", [
    (1e-6, True), (0.0, True), (1e4, True), (1e-6, False), (0.1, True)])
def test_ridge_matches_reference(reg_, fit_intercept):
    data, ref_data = _both(*_make())
    p = dict(reg=reg_, fit_intercept=fit_intercept)
    got = reg.RidgeRegressionAlgorithm(reg.RidgeParams(**p)).train(
        _ctx(), data)
    want = ref_reg.RidgeRegressionAlgorithm(ref_reg.RidgeParams(**p)).train(
        None, ref_data)
    _same_model(got, want)
    if not fit_intercept:
        assert got.intercept == 0.0
    elif reg_ < 1e-3:   # the reference's recovery case
        np.testing.assert_allclose(got.weights, W_TRUE, atol=0.02)
        assert got.intercept == pytest.approx(B_TRUE, abs=0.01)


@pytest.mark.parametrize("column, fit_intercept", [
    (0, True), (4, True), (2, False)])
def test_ridge_singular_gram_takes_the_min_norm_answer(column,
                                                       fit_intercept):
    """A feature that is always 0 makes the Gram singular at reg 0 (its
    row and column exactly 0): the reference's Cholesky gives NaN, the
    port's reports the failed pivot, and both take the min-norm least
    squares, which puts no weight on that feature."""
    x, y = _make(n=60)
    x = np.insert(x, column, 0.0, axis=1)
    data, ref_data = _both(x, y)
    p = dict(reg=0.0, fit_intercept=fit_intercept)
    got = reg.RidgeRegressionAlgorithm(reg.RidgeParams(**p)).train(
        _ctx(), data)
    want = ref_reg.RidgeRegressionAlgorithm(ref_reg.RidgeParams(**p)).train(
        None, ref_data)
    _same_model(got, want)
    xc, yc = (x - x.mean(axis=0), y - y.mean()) if fit_intercept else (x, y)
    lstsq, *_ = jnp.linalg.lstsq(jnp.asarray(xc), jnp.asarray(yc))
    np.testing.assert_allclose(got.weights, np.asarray(lstsq), rtol=RTOL,
                               atol=ATOL)
    assert abs(got.weights[column]) <= ATOL
    # the branch itself: the port's factorization does fail here
    xt = torch.from_numpy(xc)
    _, info = torch.linalg.cholesky_ex(xt.T @ xt)
    assert int(info) == column + 1


@pytest.mark.parametrize("n, params", [
    (800, dict(num_iterations=400, step_size=0.5)),
    (512, dict(num_iterations=300, step_size=0.5, mini_batch_fraction=0.25)),
    (200, dict(num_iterations=200, step_size=0.1, mini_batch_fraction=0.5,
               seed=7)),
])
def test_sgd_matches_reference(n, params):
    data, ref_data = _both(*_make(n=n))
    got = reg.SGDRegressionAlgorithm(reg.SGDParams(**params)).train(
        _ctx(), data)
    want = ref_reg.SGDRegressionAlgorithm(ref_reg.SGDParams(**params)).train(
        None, ref_data)
    _same_model(got, want, atol=SGD_ATOL)
    if params.get("mini_batch_fraction", 1.0) == 1.0:
        np.testing.assert_allclose(got.weights, W_TRUE, atol=0.15)
        assert got.intercept == pytest.approx(B_TRUE, abs=0.15)
    else:
        assert float(np.mean((got.predict(data.x) - data.y) ** 2)) < 1.0


def test_predict_batch_predict_and_empty_data():
    data, _ = _both(*_make())
    algo = reg.RidgeRegressionAlgorithm()
    model = algo.train(_ctx(), data)
    queries = [{"features": data.x[i].tolist()} for i in range(5)]
    np.testing.assert_allclose([algo.predict(model, q) for q in queries],
                               algo.batch_predict(model, queries), rtol=1e-6)
    assert algo.batch_predict(model, []) == []
    with pytest.raises(ValueError, match="empty"):
        algo.train(_ctx(), reg.RegressionData(np.zeros((0, 0), np.float32),
                                              np.zeros(0, np.float32)))


def _points_file(path, n=90, noise=0.05):
    x, y = _make(n=n, noise=noise)
    with open(path, "w") as f:
        for i in range(len(y)):
            f.write(" ".join(str(v) for v in [y[i], *x[i]]) + "\n")
    return x, y


def test_filepath_folds_as_reference(tmp_path):
    path = tmp_path / "points.txt"
    _points_file(path)
    folds = reg.RegressionDataSource(reg.DataSourceParams(
        filepath=str(path), eval_k=3)).read_eval(None)
    ref_folds = ref_reg.RegressionDataSource(ref_reg.DataSourceParams(
        filepath=str(path), eval_k=3)).read_eval(None)
    assert len(folds) == len(ref_folds) == 3
    for (tr, info, qa), (rtr, rinfo, rqa) in zip(folds, ref_folds):
        np.testing.assert_array_equal(tr.x, rtr.x)
        np.testing.assert_array_equal(tr.y, rtr.y)
        assert qa == rqa and len(tr.y) == 60
    assert sum(len(qa) for _, _, qa in folds) == 90


@pytest.mark.parametrize("algo, params, ref_params", [
    ("ridge", reg.RidgeParams(reg=0.01), ref_reg.RidgeParams(reg=0.01)),
    ("sgd", reg.SGDParams(num_iterations=3, step_size=0.01),
     ref_reg.SGDParams(num_iterations=3, step_size=0.01))])
def test_engine_eval_mse_as_reference(tmp_path, algo, params, ref_params):
    """Engine.eval over the file's k folds scored by MeanSquareError: the
    same MSE as the reference's, the exact solver's below 0.01."""
    path = tmp_path / "points.txt"
    _points_file(path)
    metric = MeanSquareError()
    assert not metric.higher_is_better
    got = metric.calculate(None, reg.RegressionEngine.apply().eval(
        _ctx(), EngineParams(
            datasource=("", reg.DataSourceParams(filepath=str(path),
                                                 eval_k=3)),
            algorithms=[(algo, params)])))
    want = RefMSE().calculate(None, ref_reg.RegressionEngine.apply().eval(
        None, RefEngineParams(
            datasource=("", ref_reg.DataSourceParams(filepath=str(path),
                                                     eval_k=3)),
            algorithms=[(algo, ref_params)])))
    assert got == pytest.approx(want, rel=MSE_RTOL)
    if algo == "ridge":
        assert got < 0.01
    else:
        assert got > 0.01


def test_average_serving_combines_algos():
    data, _ = _both(*_make(n=200))
    ctx = _ctx()
    ridge = reg.RidgeRegressionAlgorithm().train(ctx, data)
    sgd = reg.SGDRegressionAlgorithm(reg.SGDParams(
        num_iterations=200, step_size=0.5)).train(ctx, data)
    q = {"features": data.x[0].tolist()}
    p1 = reg.RidgeRegressionAlgorithm().predict(ridge, q)
    p2 = reg.SGDRegressionAlgorithm().predict(sgd, q)
    assert reg.RegressionEngine.apply().serving_classes[""] is AverageServing
    assert AverageServing().serve(q, [p1, p2]) == pytest.approx((p1 + p2) / 2)


def test_train_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    data, _ = _both(*_make(n=20))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        reg.RidgeRegressionAlgorithm().train(None, data)


def test_train_verb_from_another_directory_then_deploy(tmp_path,
                                                       monkeypatch):
    """``python -m pio_tpu_torch train --engine-dir <copy of
    examples/regression>`` as a process started elsewhere: the relative
    ./data/sample.txt resolves against the engine dir; the deployed
    instance answers as the in-process composition does, ~3.5 at
    [1, 0, 0, 0] (2*f0 - f1 + 0.5*f2 + 3*f3 + 1.5), and batchpredict as
    the deploy does."""
    d = tmp_path / "regression"
    verbs.copy_example("regression", d, FACTORY)
    elsewhere = tmp_path / "elsewhere"
    elsewhere.mkdir()
    env = verbs.sqlite_env(tmp_path / "pio.db")
    out = verbs.train_subprocess(d, env, elsewhere)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "Training completed" in out.stdout
    storage = Storage(env=env)
    queries = [{"features": [1.0, 0.0, 0.0, 0.0]},
               {"features": [0.0, 1.0, -1.0, 0.5]}]
    with verbs.deployed(d, storage, "regression") as (port, qs):
        bodies = verbs.served_as_in_process(port, qs, queries)
        assert abs(float(bodies[0]) - 3.5) < 0.5
        assert verbs.batchpredict(d, storage, monkeypatch, queries,
                                  tmp_path) == bodies
    storage.close()


def test_engine_dir_relative_filepath_resolves():
    from pio_tpu_torch.__main__ import _engine_from_variant, _load_variant

    d = os.path.join(verbs.EXAMPLES, "regression")
    variant = _load_variant(d)
    variant["engineFactory"] = FACTORY
    _, ep = _engine_from_variant(variant, d)
    assert ep.datasource[1].filepath == os.path.join(
        os.path.abspath(d), "./data/sample.txt")
    assert os.path.isfile(ep.datasource[1].filepath)
    _, ep = _engine_from_variant(variant)       # no engine dir: untouched
    assert ep.datasource[1].filepath == "./data/sample.txt"
