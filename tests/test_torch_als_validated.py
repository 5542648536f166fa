"""Validated ALS training and reusable layouts in the port, against the
JAX package, on the CPU.

``als_train_validated`` from the same ``init=`` as the reference's, on
explicit ratings whose heldout curve has a clear interior minimum: the
curves agree within CURVE_RTOL, the best sweeps are the same and the
returned factors agree within FACTOR_RTOL; they are bit for bit the
factors of ``als_train`` run for ``best_sweep`` sweeps. ``als_train``
over prebuilt ``layouts=`` is bit-identical to ``als_train`` and refuses
layouts of another shape. The recommendation engine with
``validation_fraction > 0`` splits as the reference does, trains through
``python -m pio_tpu_torch train --device cpu``, and its model blob
carries the curve to deploy.
"""

import _torch_cpu  # noqa: F401  (one CPU thread: see the module)
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pio_tpu.models import recommendation as ref_rec
from pio_tpu.ops import als as ref_als
from pio_tpu_torch.__main__ import main as port_main
from pio_tpu_torch.data.dao import App
from pio_tpu_torch.data.event import Event
from pio_tpu_torch.data.eventstore import EventStore
from pio_tpu_torch.data.storage import Storage
from pio_tpu_torch.models import recommendation as port_rec
from pio_tpu_torch.ops import als
from pio_tpu_torch.workflow.context import create_workflow_context
from pio_tpu_torch.workflow.train import load_models

CPU = torch.device("cpu")
# heldout RMSE after each of 10 sweeps from the same init, relative to
# the curve's max: f32 Cholesky solves in another order (measured ~1e-6
# with f32 gathers)
CURVE_RTOL = 1e-5
# the best sweep's factors, relative to their max |value| (measured ~6e-6)
FACTOR_RTOL = 1e-4
# the engine's curve: the template gathers the factors in bf16, and the
# two frameworks' f32 sums round differently around those coarser values;
# six sweeps amplify that (measured 9.2e-5 relative at the last sweep)
ENGINE_CURVE_RTOL = 1e-3


def _ratings(dens, noise, seed=0, n_users=60, n_items=50, k=2):
    """A rank-k rating matrix plus noise, a fifth of it held out."""
    rng = np.random.default_rng(seed)
    u_true = rng.standard_normal((n_users, k))
    i_true = rng.standard_normal((n_items, k))
    u, i = np.nonzero(rng.random((n_users, n_items)) < dens)
    r = ((u_true[u] * i_true[i]).sum(1)
         + noise * rng.standard_normal(len(u))).astype(np.float32)
    perm = rng.permutation(len(u))
    va, tr = perm[:len(u) // 5], perm[len(u) // 5:]
    return (u[tr], i[tr], r[tr]), (u[va], i[va], r[va]), n_users, n_items


# (density, noise, rank, reg): both overfit after a few sweeps
CASES = [(0.4, 1.0, 4, 0.1), (0.4, 0.5, 8, 0.02)]


def _params(rank, reg, **over):
    return als.ALSParams(**{
        "rank": rank, "iterations": 10, "reg": reg, "implicit": False,
        "seed": 1, "chunk": 512, "cg_warm_iters": -1, "bf16_gather": False,
        **over})


def _ref_params(p):
    return ref_als.ALSParams(**{f: getattr(p, f)
                                for f in p.__dataclass_fields__})


@pytest.mark.parametrize("dens, noise, rank, reg", CASES)
def test_validated_curve_and_best_sweep_equal_the_reference(dens, noise,
                                                            rank, reg):
    train, val, nu, ni = _ratings(dens, noise)
    p = _params(rank, reg)
    u0, i0 = als._init_or(None, nu, ni, p, CPU)
    want_m, want = ref_als.als_train_validated(
        *train, nu, ni, _ref_params(p), *val,
        init=ref_als.ALSModel(jnp.asarray(u0.numpy()),
                              jnp.asarray(i0.numpy())))
    got_m, got = als.als_train_validated(
        *train, nu, ni, p, *val, init=als.ALSModel(u0, i0), device="cpu")

    curve = np.asarray(want.curve)
    b = want.best_sweep - 1
    assert 0 < b < len(curve) - 1            # an interior minimum ...
    gap = min(curve[b - 1], curve[b + 1]) - curve[b]
    assert gap > 100 * CURVE_RTOL * curve.max()   # ... and a clear one
    np.testing.assert_allclose(got.curve, curve, rtol=0,
                               atol=CURVE_RTOL * curve.max())
    assert got.best_sweep == want.best_sweep
    assert got.best_rmse == got.curve[b] and got.final_rmse == got.curve[-1]
    for g, w in ((got_m.user_factors, want_m.user_factors),
                 (got_m.item_factors, want_m.item_factors)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=FACTOR_RTOL * np.abs(w).max())

    # the best sweep's factors are those of a run that stops there
    short = als.als_train(*train, nu, ni, als.ALSParams(
        **{**p.__dict__, "iterations": want.best_sweep}),
        init=als.ALSModel(u0, i0), device="cpu")
    assert torch.equal(got_m.user_factors, short.user_factors)
    assert torch.equal(got_m.item_factors, short.item_factors)


@pytest.mark.parametrize("over", [{}, {"implicit": True, "alpha": 3.0},
                                  {"bf16_gather": True, "cg_iters": 4}])
def test_train_on_prebuilt_layouts_is_bit_identical(over):
    (u, i, r), _, nu, ni = _ratings(0.3, 0.5, seed=3)
    train = (u, i, np.abs(r))       # implicit confidences must be >= 0
    p = _params(6, 0.05, **over)
    layouts = als.als_build_layouts(*train, nu, ni, p, device="cpu")
    init = als.ALSModel(*als._init_or(None, nu, ni, p, CPU))
    want = als.als_train(*train, nu, ni, p, init=init, device="cpu")
    for _ in range(2):                    # the layouts are reused as they are
        got = als.als_train(*train, nu, ni, p, init=init, device="cpu",
                            layouts=layouts)
        assert torch.equal(got.user_factors, want.user_factors)
        assert torch.equal(got.item_factors, want.item_factors)
    # layouts are rank-blind: another rank trains on them
    p2 = _params(3, 0.05, **over)
    assert torch.equal(
        als.als_train(*train, nu, ni, p2, device="cpu",
                      layouts=layouts).user_factors,
        als.als_train(*train, nu, ni, p2, device="cpu").user_factors)


@pytest.mark.parametrize("shape", [(61, 50, 128), (60, 49, 128),
                                   (60, 50, 64)])
def test_layouts_of_another_shape_raise(shape):
    train, _, nu, ni = _ratings(0.3, 0.5, seed=3)
    layouts = als.als_build_layouts(*train, nu, ni, _params(4, 0.1),
                                    device="cpu")
    n_users, n_items, width = shape
    with pytest.raises(ValueError, match="layouts built for shape"):
        als.als_train(*train, n_users, n_items,
                      _params(4, 0.1, width=width), device="cpu",
                      layouts=layouts)


# -- the engine: validation_fraction through the train verb ------------------

APP = "ValApp"
ALGO = {"rank": 4, "num_iterations": 6, "lambda_": 0.1,
        "implicit_prefs": False, "seed": 5, "chunk": 512,
        "cg_warm_iters": -1, "validation_fraction": 0.2}


def _env(tmp_path):
    return {"PIO_STORAGE_SOURCES_SQL_TYPE": "sqlite",
            "PIO_STORAGE_SOURCES_SQL_PATH": str(tmp_path / "pio.db"),
            "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "SQL",
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "SQL",
            "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "SQL"}


def _variant():
    return {"id": "rec-val", "engineFactory":
            "pio_tpu_torch.models.recommendation.RecommendationEngine",
            "datasource": {"params": {"app_name": APP}},
            "algorithms": [{"name": "als", "params": ALGO}]}


def test_engine_trains_validated_and_deploy_loads_the_curve(tmp_path,
                                                            monkeypatch):
    storage = Storage(env=_env(tmp_path))
    app_id = storage.get_metadata_apps().insert(App(0, APP))
    events = storage.get_events()
    events.init(app_id)
    (u, i, r), _, _, _ = _ratings(0.5, 0.5, seed=7, n_users=30,
                                  n_items=20)
    events.insert_batch([
        Event("rate", "user", f"u{a}", "item", f"i{b}",
              {"rating": float(np.clip(np.round(v + 3), 1, 5))})
        for a, b, v in zip(u, i, r)], app_id)
    d = tmp_path / "engine"
    d.mkdir()
    (d / "engine.json").write_text(json.dumps(_variant()))
    monkeypatch.setattr("pio_tpu_torch.__main__.get_storage",
                        lambda: storage)
    try:
        assert port_main(["train", "--engine-dir", str(d), "--device",
                          "cpu"]) == 0
        inst = storage.get_metadata_engine_instances().get_latest_completed(
            "rec-val", "1", "default")
        engine = port_rec.RecommendationEngine.apply()
        ep = engine.engine_params_from_variant(_variant())
        ctx = create_workflow_context(storage, device="cpu")
        [model] = load_models(storage, engine, ep, inst.id, ctx)
        data = EventStore(storage).interactions(
            app_name=APP, entity_type="user", target_entity_type="item",
            event_names=["rate", "buy"], value_key="rating",
            default_value=4.0, value_event="rate", dedup="last")
    finally:
        storage.close()
    got = model.validation
    assert isinstance(got, als.ALSValidation)
    assert len(got.curve) == ALGO["num_iterations"]
    assert model.factors.user_factors.device.type == "cpu"

    # the reference's algorithm on the same interactions, from the port's
    # seeded init: its split of the interactions is the port's
    algo = port_rec.ALSAlgorithm(port_rec.ALSAlgorithmParams(**ALGO))
    p = algo._als_params()
    u0, i0 = als._init_or(None, data.n_users, data.n_items, p, CPU)
    monkeypatch.setattr(ref_als, "_init_or", lambda *a: (
        jnp.asarray(u0.numpy()), jnp.asarray(i0.numpy())))
    ref_algo = ref_rec.ALSAlgorithm(ref_rec.ALSAlgorithmParams(**ALGO))
    ctx = type("Ctx", (), {"mesh": None})()
    want = ref_algo.train(ctx, data).validation
    np.testing.assert_allclose(got.curve, want.curve, rtol=0,
                               atol=ENGINE_CURVE_RTOL * max(want.curve))
    assert got.best_sweep == want.best_sweep
