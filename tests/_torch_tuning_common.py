"""Shared constants, fixtures and helpers of the port's tuning tests
(``tests/test_torch_tuning*.py``): seeded interactions and events, a
sqlite store open in both packages, the reference's trainers started from
the port's seeded init, sweep candidates and configs.

Tolerances: the ALS factors of the two packages agree within 2e-3 of the
largest factor after 3 sweeps from the same init (test_torch_train.py),
within 1e-4 with f32 gathers (measured: 3e-5);
scores that rank on such factors within the reference's own stacked-vs-
sequential tolerance, abs 0.02 (tests/test_tuning.py); batched metrics on
equal rankings within 1e-6 of the JAX values (f32 sums in another order)
and 1e-5 of the oracles (f32 against float64).
"""

import json
import os
import urllib.request
from datetime import datetime, timedelta, timezone

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pio_tpu.data.storage import Storage as RefStorage
from pio_tpu.ops import als as ref_als
from pio_tpu.tuning import metrics as ref_tm
from pio_tpu_torch.data.dao import App
from pio_tpu_torch.data.event import Event
from pio_tpu_torch.data.storage import Storage
from pio_tpu_torch.models import recommendation as port_rec
from pio_tpu_torch.ops import als as port_als
from pio_tpu_torch.tuning import SweepConfig, parse_metric
from pio_tpu_torch.tuning import metrics as tm
from pio_tpu_torch.workflow.context import create_workflow_context
from pio_tpu_torch.workflow.evaluate import run_sweep_evaluation

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T0 = datetime(2026, 1, 1, tzinfo=timezone.utc)
APP = "tuneapp"
FACTORY = "pio_tpu_torch.models.recommendation.RecommendationEngine"
RTOL_TRAIN = 2e-3          # of the largest factor, 3 sweeps, same init
SCORE_ABS = 0.02           # tests/test_tuning.py's stacked-vs-sequential
METRIC_ABS = 1e-6          # torch vs JAX batched metric, f32
ORACLE_ABS = 1e-5          # batched (f32) vs scalar oracle (float64)
STACKED_RTOL = 1e-5        # stacked candidate vs sequential als_train
F32_GATHER_RTOL = 1e-4     # of the largest factor, f32 gathers, same init


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------

def _arrays(n_users=60, n_items=40, nnz=900, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n_users, nnz).astype(np.int32),
            rng.integers(0, n_items, nnz).astype(np.int32),
            rng.uniform(1, 5, nnz).astype(np.float32), n_users, n_items)


def _interactions(pkg_cls, index_cls, **kw):
    u, i, v, n_users, n_items = _arrays(**kw)
    return pkg_cls(
        user_idx=u, item_idx=i, values=v,
        users=index_cls([f"u{x}" for x in range(n_users)]),
        items=index_cls([f"i{x}" for x in range(n_items)]))


def _storage_env(path):
    return {
        "PIO_STORAGE_SOURCES_SQL_TYPE": "sqlite",
        "PIO_STORAGE_SOURCES_SQL_PATH": str(path / "pio.db"),
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "SQL",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "SQL",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "SQL",
    }


def _seed_events(storage, app_name=APP, n_users=40, n_items=30,
                 n_events=1000, seed=1, kinds=("rate",)):
    """The reference tests' seeded rate events (tests/test_tuning.py),
    one minute apart."""
    app_id = storage.get_metadata_apps().insert(App(0, app_name))
    ev = storage.get_events()
    ev.init(app_id)
    rng = np.random.default_rng(seed)
    ev.insert_batch([
        Event(event=kinds[j % len(kinds)], entity_type="user",
              entity_id=f"u{rng.integers(0, n_users)}",
              target_entity_type="item",
              target_entity_id=f"i{rng.integers(0, n_items)}",
              properties={"rating": float(rng.integers(1, 6))},
              event_time=T0 + timedelta(minutes=j))
        for j in range(n_events)
    ], app_id)
    return app_id


@pytest.fixture()
def store(tmp_path):
    """One sqlite db with the seeded events, open in both packages."""
    env = _storage_env(tmp_path)
    storage = Storage(env=env)
    _seed_events(storage)
    ref = RefStorage(env=env)
    yield storage, ref, env
    storage.close()
    ref.close()


@pytest.fixture()
def same_init(monkeypatch):
    """The reference's trainers start from the port's seeded init (the
    two packages' generators give different numbers)."""
    def init_or(init, n_users, n_items, params):
        if init is not None:
            return init.user_factors, init.item_factors
        u0, i0 = port_als._init_or(None, n_users, n_items, params,
                                   torch.device("cpu"))
        return jnp.asarray(u0.numpy()), jnp.asarray(i0.numpy())

    monkeypatch.setattr(ref_als, "_init_or", init_or)


def _candidates(ep_cls, rec, regs=(0.01, 1.0, 100.0), rank=8,
                iterations=3, **ds_kw):
    ds = rec.DataSourceParams(app_name=APP, **ds_kw)
    return [
        ep_cls(datasource=("", ds),
               algorithms=[("als", rec.ALSAlgorithmParams(
                   rank=rank, num_iterations=iterations, lambda_=reg,
                   chunk=256))])
        for reg in regs
    ]


def _config(cfg_cls, parse, split="kfold", folds=2, metric="map@5",
            others=("ndcg@5", "auc")):
    return cfg_cls(metric=parse(metric),
                   other_metrics=[parse(m) for m in others],
                   split=split, folds=folds, seed=42)


def _port_sweep(storage, cands, split="kfold", folds=2, resume=None,
                metric="map@5", others=("ndcg@5", "auc")):
    return run_sweep_evaluation(
        port_rec.RecommendationEngine.apply(), cands, storage,
        _config(SweepConfig, parse_metric, split, folds, metric, others),
        engine_id="tune-e",
        ctx=create_workflow_context(storage, device="cpu"),
        resume_eval_id=resume)


_RANKED = {
    "precision": (tm.precision_at_k_batch, ref_tm.precision_at_k_batch,
                  tm.precision_at_k_scalar),
    "recall": (tm.recall_at_k_batch, ref_tm.recall_at_k_batch,
               tm.recall_at_k_scalar),
    "map": (tm.map_at_k_batch, ref_tm.map_at_k_batch, tm.map_at_k_scalar),
    "ndcg": (tm.ndcg_at_k_batch, ref_tm.ndcg_at_k_batch,
             tm.ndcg_at_k_scalar),
}


def _fuzz_cases(seed=7, trials=60):
    """The reference's fuzz (tests/test_tuning.py): rankings with k past
    the catalog, users without actuals, integer scores with ties."""
    rng = np.random.default_rng(seed)
    for _ in range(trials):
        n_items = int(rng.integers(3, 25))
        k = int(rng.integers(1, n_items + 5))
        b = int(rng.integers(1, 5))
        topk, actuals = [], []
        for _ in range(b):
            n_act = int(rng.integers(0, min(8, n_items) + 1))
            actuals.append(rng.choice(
                n_items, size=n_act, replace=False).astype(np.int32))
            topk.append(rng.choice(
                n_items, size=min(k, n_items), replace=False
            ).astype(np.int32))
        topk_m = tm.pad_actuals(topk, pad_to=k)
        topk_m[topk_m < 0] = -2
        act_m = tm.pad_actuals(actuals)
        scores = rng.integers(0, 4, size=(b, n_items)).astype(np.float32)
        pos = np.zeros((b, n_items), bool)
        valid = np.ones((b, n_items), bool)
        for j in range(b):
            pos[j, actuals[j]] = True
            seen = rng.choice(n_items,
                              size=int(rng.integers(0, n_items // 2 + 1)),
                              replace=False)
            valid[j, seen] = False
            valid[j, actuals[j]] = True
        yield k, topk, actuals, topk_m, act_m, scores, pos, valid


def _assert_folds_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.info == w.info
        for f in ("user_idx", "item_idx", "values"):
            a, b = getattr(g.train, f), getattr(w.train, f)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert g.train.users.ids() == w.train.users.ids()
        assert g.train.items.ids() == w.train.items.ids()
        np.testing.assert_array_equal(g.test_user_idx, w.test_user_idx)
        assert len(g.actual_idx) == len(w.actual_idx)
        for a, b in zip(g.actual_idx + g.seen_idx,
                        w.actual_idx + w.seen_idx):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert g.qa_pairs(num=7) == w.qa_pairs(num=7)


def _seq_candidates(ep_cls, seq, lrs=(1e-3, 2e-3), app_name=APP):
    ds = seq.SequenceDataSourceParams(app_name=app_name, max_len=8)
    return [ep_cls(datasource=("", ds),
                   algorithms=[("sasrec", seq.SequenceParams(
                       max_len=8, embed_dim=8, num_heads=2, num_layers=1,
                       ffn_dim=16, steps=3, batch_size=16,
                       learning_rate=lr))])
            for lr in lrs]


def _engine_dir(tmp_path, retrieval=None):
    algo = {"rank": 8, "num_iterations": 3, "lambda_": 0.1, "chunk": 256}
    if retrieval is not None:
        algo["retrieval"] = retrieval
    d = tmp_path / "engine"
    d.mkdir(exist_ok=True)
    (d / "engine.json").write_text(json.dumps({
        "id": "tune-cli", "engineFactory": FACTORY,
        "datasource": {"params": {"app_name": APP}},
        "algorithms": [{"name": "als", "params": algo}]}))
    return d


def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/queries.json",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.status, json.loads(r.read())
