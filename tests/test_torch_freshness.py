"""The port's streaming fold-in (``pio_tpu_torch.freshness``) on the CPU,
sqlite in a temporary directory: the reference's own freshness cases
(``tests/test_freshness.py``) run against the port, and the whole slice
against the JAX package.

  * the single-host oracle: rows served after a fold-in cycle equal, bit
    for bit, a solo ``als_fold_in`` of the same events;
  * a chaos kill at ``foldin.solve``, then a restart: no loss, no
    duplicate; the microsecond boundary; a window over the batch cap;
    the durable cursor; the apply breaker; the staleness budget;
    unknown-item users;
  * serving's ``/model/upsert_users`` (guarded, validated), its
    ``/readyz`` (never gated on fold-in), an item upsert re-encoding the
    clustered-retrieval sidecar, a user upsert keeping it;
  * the folder resolves the instance the deploy serves;
  * the fleet: folds routed by the router to every replica of the owner
    group bit for bit (``RouterFleetApplier``, ``foldin --router-url``),
    rejected and misrouted rows, a dead group reported and the applier
    raising;
  * parity with ``pio_tpu``: the same seeded factors persisted in both
    packages, the same events, one fold-in cycle in each.
"""

import json
import os
import subprocess
import sys
import time
import urllib.error
import urllib.parse
import urllib.request
from datetime import datetime, timedelta, timezone

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fleet import time_limit  # noqa: F401

from pio_tpu.data import DataMap as RefDataMap
from pio_tpu.data import Event as RefEvent
from pio_tpu.data.bimap import EntityIdIndex as RefIdIndex
from pio_tpu.data.dao import App as RefApp
from pio_tpu.data.dao import EngineInstance as RefEngineInstance
from pio_tpu.data.dao import Model as RefModel
from pio_tpu.data.storage import Storage as RefStorage
from pio_tpu.freshness import FoldInConfig as RefFoldInConfig
from pio_tpu.freshness import FoldInWorker as RefFoldInWorker
from pio_tpu.freshness import LocalServingApplier as RefLocalApplier
from pio_tpu.models import recommendation as ref_rec
from pio_tpu.ops import als as ref_als
from pio_tpu.workflow.checkpoint import models_to_bytes as ref_models_to_bytes
from pio_tpu.workflow.context import create_workflow_context as ref_ctx
from pio_tpu.workflow.serve import QueryServer as RefQueryServer
from pio_tpu.workflow.serve import ServingConfig as RefServingConfig
from pio_tpu_torch.__main__ import main as port_main
from pio_tpu_torch.convert import recommendation_model_from_numpy
from pio_tpu_torch.data.dao import App
from pio_tpu_torch.data.datamap import DataMap
from pio_tpu_torch.data.event import Event
from pio_tpu_torch.data.storage import Storage
from pio_tpu_torch.freshness import (
    CursorStore,
    FoldCursor,
    FoldInApplyError,
    FoldInConfig,
    FoldInWorker,
    LocalServingApplier,
    RouterFleetApplier,
    ServingHttpApplier,
    build_foldin_app,
)
from pio_tpu_torch.freshness.tail import _micros
from pio_tpu_torch.models import recommendation as port_rec
from pio_tpu_torch.ops import als
from pio_tpu_torch.ops import retrieval as rt
from pio_tpu_torch.resilience import CircuitOpenError, chaos
from pio_tpu_torch.server.http import Request
from pio_tpu_torch.serving_fleet.fleet import (
    deploy_fleet,
    resolve_fleet_model,
)
from pio_tpu_torch.serving_fleet.plan import persist_fleet_artifacts, shard_of
from pio_tpu_torch.serving_fleet.shard import ShardConfig, ShardServer
from pio_tpu_torch.utils.time import utcnow
from pio_tpu_torch.workflow.context import create_workflow_context
from pio_tpu_torch.workflow.serve import ServingConfig, create_query_server
from pio_tpu_torch.workflow.train import persist_models, run_train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FACTORY = "pio_tpu_torch.models.recommendation.RecommendationEngine"
T0 = datetime(2026, 1, 1, tzinfo=timezone.utc)
ALGO = {"rank": 4, "num_iterations": 2, "lambda_": 0.05, "alpha": 0.6,
        "chunk": 1024}
# the two packages' fold-ins of one user: two f32 solves of the same
# ridge system, summed and factored in other orders; relative to the
# row's norm
ROW_RTOL = 1e-4


def storage_env(path) -> dict:
    return {
        "PIO_STORAGE_SOURCES_SQL_TYPE": "sqlite",
        "PIO_STORAGE_SOURCES_SQL_PATH": str(path / "pio.db"),
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "SQL",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "SQL",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "SQL",
    }


@pytest.fixture()
def storage(tmp_path, monkeypatch):
    monkeypatch.setenv("PIO_TPU_CKPT_ROOT", str(tmp_path / "ckpt"))
    s = Storage(env=storage_env(tmp_path))
    yield s
    s.close()


def variant(implicit=False, retrieval=None) -> dict:
    params = {**ALGO, "implicit_prefs": implicit}
    if retrieval is not None:
        params["retrieval"] = retrieval
    return {"id": "rec", "engineFactory": FACTORY,
            "datasource": {"params": {"app_name": "mlapp"}},
            "algorithms": [{"name": "als", "params": params}]}


def train(storage, implicit=False, retrieval=None):
    """The reference test's training set (20 users x 12 items, two
    tastes), trained by the port on the CPU."""
    app_id = storage.get_metadata_apps().insert(App(0, "mlapp"))
    ev = storage.get_events()
    ev.init(app_id)
    rng = np.random.default_rng(0)
    m = 0
    for u in range(20):
        for i in range(12):
            match = (u % 2) == (i % 2)
            if rng.random() < (0.8 if match else 0.1):
                ev.insert(Event(
                    event="rate", entity_type="user", entity_id=f"u{u}",
                    target_entity_type="item", target_entity_id=f"i{i}",
                    properties=DataMap({"rating": 5 if match else 1}),
                    event_time=T0 + timedelta(minutes=m)), app_id)
                m += 1
    engine = port_rec.RecommendationEngine.apply()
    ep = engine.engine_params_from_variant(variant(implicit, retrieval))
    ctx = create_workflow_context(storage, device="cpu")
    iid = run_train(engine, ep, storage, engine_id="rec",
                    engine_factory=FACTORY, ctx=ctx)
    return engine, ep, ctx, iid, app_id


def foldin_config(tmp_path, implicit=False, **kw):
    return FoldInConfig(
        app_name="mlapp", engine_id="rec",
        als_params=als.ALSParams(rank=4, reg=0.05, alpha=0.6,
                                 implicit=implicit),
        state_path=str(tmp_path / "cursor.bin"), **kw)


def worker_of(storage, tmp_path, applier, implicit=False, **kw):
    return FoldInWorker(storage, foldin_config(tmp_path, implicit, **kw),
                        applier, device="cpu")


def stamp():
    """Now, to the millisecond, in a millisecond after any earlier stamp
    or cursor: the sqlite store keeps event times to the millisecond (as
    the reference's does), and a fresh cursor is pinned at now to the
    microsecond, so an event stamped in the cursor's own millisecond
    would be stored before it."""
    time.sleep(0.002)
    t = utcnow()
    return t.replace(microsecond=t.microsecond // 1000 * 1000)


def ingest(storage, app_id, user, pairs, event="rate"):
    """Insert fresh (now-stamped) interaction events; returns them."""
    ev = storage.get_events()
    out = []
    for item, rating in pairs:
        e = Event(
            event=event, entity_type="user", entity_id=user,
            target_entity_type="item", target_entity_id=item,
            properties=DataMap({} if rating is None else {"rating": rating}),
            event_time=stamp())
        ev.insert(e, app_id)
        out.append(e)
    return out


def oracle_row(model, events, params):
    """The cold oracle: the SAME events, deduplicated with the training
    read's semantics (latest value per item wins; rate events read
    properties.rating, others take 4.0), solved SOLO through
    ``als_fold_in`` against the deployed item factors. Built from
    scratch, not through the freshness helpers."""
    vals: dict = {}
    for e in sorted(events, key=lambda ev: ev.event_time):
        v = (float(e.properties.get_or_else("rating", 4.0))
             if e.event == "rate" else 4.0)
        vals[e.target_entity_id] = v
    known = [(model.items.bimap[i], v) for i, v in vals.items()
             if i in model.items]
    rows = als.als_fold_in(
        model.factors.item_factors,
        np.zeros(len(known), np.int32),
        np.asarray([i for i, _ in known], np.int32),
        np.asarray([v for _, v in known], np.float32),
        1, params)
    return rows[0].numpy()


def call(port, method, path, body=None, **params):
    url = f"http://127.0.0.1:{port}{path}"
    if params:
        url += "?" + urllib.parse.urlencode(params)
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(
        url, data=data, method=method,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def app_get(app, path):
    return app.dispatch(Request(method="GET", path=path, params={},
                                headers={}))


class Sink:
    """An applier that records the batches it is given."""

    def __init__(self):
        self.batches = []

    def apply(self, rows, staleness_s=None):
        self.batches.append(dict(rows))
        return {"applied": len(rows)}


def serve(storage, engine, ep, ctx, **config):
    http, qs = create_query_server(
        engine, ep, storage,
        ServingConfig(ip="127.0.0.1", port=0, engine_id="rec", **config),
        ctx=ctx)
    http.start()
    return http, qs


# -- the oracle: single host ------------------------------------------------

@pytest.mark.parametrize("implicit", [False, True])
@pytest.mark.parametrize("over_http", [False, True])
def test_foldin_oracle_parity_single_host(storage, tmp_path, implicit,
                                          over_http):
    """Fold-in of a new user's events AND an existing user's new events
    lands rows bit-identical to the cold oracle, served by the
    single-host QueryServer, in process and through
    ``/model/upsert_users``."""
    engine, ep, ctx, iid, app_id = train(storage, implicit=implicit)
    http, qs = serve(storage, engine, ep, ctx, server_key="sk")
    try:
        applier = (ServingHttpApplier(f"http://127.0.0.1:{http.port}", "sk")
                   if over_http else LocalServingApplier(qs))
        worker = worker_of(storage, tmp_path, applier, implicit)
        assert worker.device.type == "cpu"
        # a mixed history for the NEW user: rated twice (latest wins),
        # one un-rated buy (the 4.0 implicit-value rule)
        newbie = ingest(storage, app_id, "newbie",
                        [("i1", 2), ("i1", 5), ("i4", 3)])
        newbie += ingest(storage, app_id, "newbie", [("i6", None)],
                         event="buy")
        ingest(storage, app_id, "u0", [("i9", 1)])
        stats = worker.run_once()
        assert stats["folded"] == 2 and stats["skipped"] == 0
        assert worker.queue_depth() == 0
        assert worker.staleness_seconds() == 0.0

        with qs._lock:
            model = qs.models[0]
        assert "newbie" in model.users
        served = model.factors.user_factors.numpy()
        got = served[model.users.index_of("newbie")]
        want = oracle_row(model, newbie, worker.config.als_params)
        assert (got == want).all(), (got, want)
        # the existing user's row was REPLACED by a fold of the FULL
        # history (the trained events and the new one)
        u0_events = list(storage.get_events().find(
            app_id=app_id, entity_type="user", entity_id="u0", limit=-1))
        got0 = served[model.users.index_of("u0")]
        assert (got0 == oracle_row(model, u0_events,
                                   worker.config.als_params)).all()
        st, body = call(http.port, "POST", "/queries.json",
                        {"user": "newbie", "num": 3})
        assert st == 200 and len(body["itemScores"]) == 3
    finally:
        http.stop()
        qs.close()


def test_folder_solves_against_the_instance_the_deploy_serves(storage,
                                                              tmp_path):
    """With no rollout records, the folder's ``latest_eligible_completed``
    picks the instance the deploy loaded (the latest COMPLETED), and its
    item factors land on the worker's device."""
    engine, ep, ctx, iid, app_id = train(storage)
    # a second, newer COMPLETED instance with other factors
    rng = np.random.default_rng(3)
    model = recommendation_model_from_numpy(
        rng.standard_normal((2, 4)).astype(np.float32),
        rng.standard_normal((12, 4)).astype(np.float32),
        ["u0", "u1"], [f"i{i}" for i in range(12)], device="cpu")
    newer = persist_models([model], ep, storage, "rec",
                           engine_factory=FACTORY)
    http, qs = serve(storage, engine, ep, ctx)
    try:
        worker = worker_of(storage, tmp_path, LocalServingApplier(qs))
        ingest(storage, app_id, "newbie", [("i1", 5)])
        worker.run_once()
        assert qs.instance.id == newer != iid
        assert worker.snapshot()["modelInstanceId"] == newer
        itf = worker._model.factors.item_factors
        assert torch.is_tensor(itf) and itf.device.type == "cpu"
        assert torch.equal(itf, model.factors.item_factors)
        inst, raw = resolve_fleet_model(storage, "rec")
        assert inst.id == newer and isinstance(
            raw.factors.item_factors, np.ndarray)
    finally:
        http.stop()
        qs.close()


def test_worker_without_cuda_raises_unless_cpu_is_asked(storage, tmp_path,
                                                        monkeypatch):
    storage.get_metadata_apps().insert(App(0, "mlapp"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FoldInWorker(storage, foldin_config(tmp_path), Sink())
    assert FoldInWorker(storage, foldin_config(tmp_path), Sink(),
                        device="cpu").device.type == "cpu"


# -- durable cursor + chaos resume ------------------------------------------

def test_chaos_solve_kill_then_restart_resumes_without_loss_or_dup(
        storage, tmp_path):
    """``foldin.solve`` chaos kills the folder mid-batch (after the
    window was read, before any row lands): the durable cursor does not
    advance and serving answers; a RESTARTED folder (fresh state, same
    cursor file) folds each event exactly once."""
    engine, ep, ctx, iid, app_id = train(storage)
    http, qs = serve(storage, engine, ep, ctx)
    try:
        w1 = worker_of(storage, tmp_path, LocalServingApplier(qs))
        disk_before = CursorStore(w1.config.state_path).load()
        events = ingest(storage, app_id, "newbie", [("i1", 5), ("i4", 2)])
        with chaos.inject("foldin.solve", error=1.0, seed=3) as monkey:
            with pytest.raises(chaos.ChaosError):
                w1.run_once()
            assert "foldin.solve" in monkey.injected
        assert CursorStore(w1.config.state_path).load() == disk_before
        st, _ = call(http.port, "POST", "/queries.json",
                     {"user": "u0", "num": 3})
        assert st == 200
        assert "newbie" not in qs.models[0].users

        w2 = worker_of(storage, tmp_path, LocalServingApplier(qs))
        assert w2.run_once()["folded"] == 1          # not lost
        assert w2.folded_total == 1
        assert w2.run_once()["folded"] == 0          # not duplicated
        assert w2.folded_total == 1
        assert CursorStore(w2.config.state_path).load().folded_total == 1
        with qs._lock:
            model = qs.models[0]
        got = model.factors.user_factors.numpy()[
            model.users.index_of("newbie")]
        assert (got == oracle_row(model, events,
                                  w2.config.als_params)).all()
    finally:
        http.stop()
        qs.close()


def test_boundary_microsecond_straggler_not_dropped(storage, tmp_path):
    """An event landing at EXACTLY the cursor's boundary microsecond
    between polls changes the boundary signature and refolds the user."""
    engine, ep, ctx, iid, app_id = train(storage)
    sink = Sink()
    worker = worker_of(storage, tmp_path, sink)
    t = stamp()
    ev = storage.get_events()
    ev.insert(Event(event="rate", entity_type="user", entity_id="ub",
                    target_entity_type="item", target_entity_id="i1",
                    properties=DataMap({"rating": 5}), event_time=t),
              app_id)
    assert worker.run_once()["folded"] == 1
    assert worker.cursor.time_us == _micros(t)
    assert worker.cursor.boundary == {"ub": 1}
    assert worker.run_once()["folded"] == 0
    ev.insert(Event(event="rate", entity_type="user", entity_id="ub",
                    target_entity_type="item", target_entity_id="i3",
                    properties=DataMap({"rating": 1}), event_time=t),
              app_id)
    assert worker.run_once()["folded"] == 1
    assert worker.cursor.boundary == {"ub": 2}
    assert worker.run_once()["folded"] == 0
    assert set(sink.batches[-1]) == {"ub"}
    assert len(sink.batches) == 2


def test_window_bigger_than_batch_cap_drains_and_cursor_advances(
        storage, tmp_path):
    engine, ep, ctx, iid, app_id = train(storage)
    sink = Sink()
    worker = worker_of(storage, tmp_path, sink, max_batch_users=2)
    for n in range(5):
        ingest(storage, app_id, f"burst{n}", [("i1", 5)])
    stats = worker.run_once()
    assert stats["folded"] == 5
    assert len(sink.batches) == 3               # 2 + 2 + 1
    assert all(len(b) <= 2 for b in sink.batches)
    assert worker.queue_depth() == 0
    assert worker.cursor.time_us > 0
    assert CursorStore(worker.config.state_path).load() == worker.cursor
    assert worker.run_once()["folded"] == 0
    assert len(sink.batches) == 3


def test_cursor_store_durable_roundtrip_and_corrupt_fallback(tmp_path):
    path = str(tmp_path / "c" / "cursor.bin")
    store = CursorStore(path)
    assert store.load() == FoldCursor()
    cur = FoldCursor(time_us=123456789, boundary={"u1": 2}, folded_total=7)
    store.save(cur)
    assert store.load() == cur
    from pio_tpu_torch.utils.durable import unframe

    raw = open(path, "rb").read()
    unframe(raw)
    with open(path, "wb") as f:
        f.write(raw[:-1] + bytes([raw[-1] ^ 0xFF]))
    assert store.load() == FoldCursor()


# -- degradation: breaker, staleness budget, unknown items -------------------

def test_apply_breaker_opens_and_keeps_users_pending(storage, tmp_path):
    engine, ep, ctx, iid, app_id = train(storage)

    class Down:
        def apply(self, rows, staleness_s=None):
            raise FoldInApplyError("serving is down")

    worker = worker_of(storage, tmp_path, Down())
    ingest(storage, app_id, "newbie", [("i1", 5)])
    for _ in range(3):
        with pytest.raises(FoldInApplyError):
            worker.run_once()
    with pytest.raises(CircuitOpenError):
        worker.run_once()
    assert worker.queue_depth() == 1
    assert worker.staleness_seconds() > 0.0
    app = build_foldin_app(worker)
    status, body = app_get(app, "/readyz")
    assert status == 503 and not body["ready"]
    assert not body["checks"]["applyBreaker"]["ok"]
    status, body = app_get(app, "/healthz")
    assert status == 200
    assert body["staleness_seconds"] > 0.0
    assert body["foldin_queue_depth"] == 1


def test_staleness_budget_flips_foldin_readyz(storage, tmp_path):
    train(storage)
    worker = worker_of(storage, tmp_path, LocalServingApplier(None),
                       staleness_budget_s=0.05)
    app = build_foldin_app(worker)
    status, body = app_get(app, "/readyz")
    assert status == 200 and body["ready"]
    with worker._lock:
        worker._pending["slow-user"] = _micros(utcnow()) - 10_000_000
    status, body = app_get(app, "/readyz")
    assert status == 503
    assert not body["checks"]["freshness"]["ok"]
    assert body["checks"]["freshness"]["stalenessSeconds"] > 0.05


def test_unknown_item_users_skipped_not_busy_looped(storage, tmp_path):
    engine, ep, ctx, iid, app_id = train(storage)
    worker = worker_of(storage, tmp_path, Sink())
    ingest(storage, app_id, "martian", [("unreleased-item", 5)])
    stats = worker.run_once()
    assert stats == {"windowRows": 1, "touched": 1, "folded": 0,
                     "skipped": 1}
    assert worker.queue_depth() == 0
    assert worker.skipped_unknown_items == 1
    assert worker.cursor.time_us > 0
    assert worker.run_once()["touched"] == 0


# -- serving surfaces ------------------------------------------------------

def test_upsert_users_route_guarded_and_validated(storage):
    engine, ep, ctx, iid, app_id = train(storage)
    http, qs = serve(storage, engine, ep, ctx, server_key="sk")
    try:
        row = [0.1, 0.2, 0.3, 0.4]
        st, _ = call(http.port, "POST", "/model/upsert_users",
                     {"users": {"nu": row}})
        assert st == 401
        st, _ = call(http.port, "POST", "/model/upsert_users",
                     {"users": {"nu": row}}, accessKey="wrong")
        assert st == 401
        st, _ = call(http.port, "POST", "/model/upsert_users",
                     {"rows": []}, accessKey="sk")
        assert st == 400
        st, body = call(http.port, "POST", "/model/upsert_users",
                        {"users": {"nu": [1.0, 2.0]}}, accessKey="sk")
        assert st == 400 and "rank" in body["message"]
        st, body = call(http.port, "POST", "/model/upsert_users",
                        {"users": {"nu": row}, "stalenessSeconds": 1.25},
                        accessKey="sk")
        assert st == 200
        assert body == {"applied": 1, "new": 1, "engineInstanceId": iid}
        assert np.allclose(
            qs.models[0].factors.user_factors.numpy()[
                qs.models[0].users.index_of("nu")], row)
        st, body = call(http.port, "GET", "/")
        assert st == 200
        assert body["foldin"]["appliedUsers"] == 1
        assert body["foldin"]["stalenessSeconds"] == 1.25
    finally:
        http.stop()
        qs.close()


def test_serving_readyz_never_gated_on_foldin(storage):
    engine, ep, ctx, iid, app_id = train(storage)
    http, qs = serve(storage, engine, ep, ctx)
    try:
        st, body = call(http.port, "GET", "/readyz")
        assert st == 200 and body["ready"]
        fr = body["checks"]["freshness"]
        assert fr["ok"] is True and fr["appliedUsers"] == 0
        assert body["checks"]["model"]["engineInstanceId"] == iid
    finally:
        http.stop()
        qs.close()


CLUSTERED = {"mode": "clustered", "dtype": "int8", "nprobe": 1,
             "rerank_k": 8, "impl": "pallas"}


def test_item_upsert_reencodes_the_sidecar_and_user_upsert_keeps_it(
        storage):
    """An item-row upsert updates the f32 rows AND the quantized/cluster
    sidecar in the same apply: the upserted item is retrievable through
    the candidate tier (the scan kernel's wrapper) at once, its quantized
    rows are a fresh encoding of the new rows, and unknown item ids are
    rejected. A user-only upsert keeps the sidecar object (no k-means
    rebuild)."""
    engine, ep, ctx, iid, app_id = train(storage, retrieval=CLUSTERED)
    http, qs = serve(storage, engine, ep, ctx)
    try:
        st, out = call(http.port, "POST", "/queries.json",
                       {"user": "u0", "num": 3})
        assert st == 200 and out["itemScores"]
        model = qs.models[0]
        cache = model._retrieval_cache
        urow = model.factors.user_factors.numpy()[model.users.index_of("u0")]
        st, out = call(http.port, "POST", "/model/upsert_users",
                       {"users": {"u_plain": [0.5, 0.5, 0.5, 0.5]}})
        assert st == 200
        assert qs.models[0]._retrieval_cache is cache
        new_item = [float(10.0 * x) for x in urow]
        st, out = call(
            http.port, "POST", "/model/upsert_users",
            {"users": {"u_new": [float(x) for x in urow]},
             "items": {"i7": new_item, "zzz": [0.0] * 4}})
        assert st == 200, out
        assert out["applied"] == 1 and out["new"] == 1
        assert out["itemsApplied"] == 1 and out["itemsRejected"] == ["zzz"]
        model = qs.models[0]
        pos = model.items.index_of("i7")
        idx, didx = model._retrieval_cache[1]
        assert model._retrieval_cache[0] is model.factors.item_factors
        fresh = rt.quantize_table(np.asarray([new_item], np.float32), "int8")
        assert (idx.table.data[pos] == fresh.data[0]).all()
        assert idx.table.scales[pos] == fresh.scales[0]
        # every other row keeps its encoding and its cluster
        old_idx = cache[1][0]
        keep = np.arange(len(idx.assign)) != pos
        assert (idx.table.data[keep] == old_idx.table.data[keep]).all()
        assert (idx.assign[keep] == old_idx.assign[keep]).all()
        assert int((didx.gidx == pos).sum()) == 1
        for user in ("u0", "u_new"):
            st, out = call(http.port, "POST", "/queries.json",
                           {"user": user, "num": 1})
            assert st == 200
            assert out["itemScores"][0]["item"] == "i7", (user, out)
        assert qs.foldin_status()["appliedItems"] == 1
    finally:
        http.stop()
        qs.close()


def test_concurrent_apply_is_refused_not_dropped(storage):
    """A model swapped between build and swap (another apply, a reload)
    is reported, never overwritten."""
    engine, ep, ctx, iid, app_id = train(storage)
    http, qs = serve(storage, engine, ep, ctx)
    try:
        import pio_tpu_torch.workflow.serve as serve_mod

        real = serve_mod._fold_rows_into

        def racing(models, rows):
            out = real(models, rows)
            serve_mod._fold_rows_into = real
            qs.foldin_upsert({"other": [0.0, 0.0, 0.0, 1.0]})
            return out

        serve_mod._fold_rows_into = racing
        try:
            with pytest.raises(ValueError, match="concurrent fold-in"):
                qs.foldin_upsert({"mine": [1.0, 0.0, 0.0, 0.0]})
        finally:
            serve_mod._fold_rows_into = real
        assert "other" in qs.models[0].users
        assert "mine" not in qs.models[0].users
    finally:
        http.stop()
        qs.close()


# -- the command line ------------------------------------------------------

def test_foldin_verb_once_against_a_deploy_process(tmp_path, monkeypatch):
    """``python -m pio_tpu_torch deploy --server-key K`` and ``foldin
    --once`` as real processes: the verb folds the new events, applies
    them over HTTP and prints its stats; the deploy then serves the
    user."""
    env = storage_env(tmp_path)
    store = Storage(env=env)
    engine_dir = tmp_path / "engine"
    engine_dir.mkdir()
    (engine_dir / "engine.json").write_text(json.dumps(variant()))
    monkeypatch.setenv("PIO_TPU_CKPT_ROOT", str(tmp_path / "ckpt"))
    try:
        engine, ep, ctx, iid, app_id = train(store)
        ingest(store, app_id, "newbie", [("i1", 5), ("i2", 4)])
    finally:
        store.close()
    penv = {**os.environ, **env, "PYTHONPATH": REPO,
            "PIO_TPU_HOME": str(tmp_path / "home")}
    proc = subprocess.Popen(
        [sys.executable, "-m", "pio_tpu_torch", "deploy", "--engine-dir",
         str(engine_dir), "--device", "cpu", "--port", "0", "--ip",
         "127.0.0.1", "--server-key", "K"],
        cwd=REPO, env=penv, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        line = proc.stdout.readline()
        assert "deployed" in line, line + (
            proc.stderr.read() if proc.poll() is not None else "")
        port = int(line.split("127.0.0.1:")[1].split()[0])
        url = f"http://127.0.0.1:{port}"
        base = [sys.executable, "-m", "pio_tpu_torch", "foldin",
                "--engine-dir", str(engine_dir), "--serving-url", url,
                "--once", "--replay", "--device", "cpu",
                "--state-path", str(tmp_path / "cursor.bin")]
        bad = subprocess.run(base + ["--server-key", "wrong"], cwd=REPO,
                             env=penv, capture_output=True, text=True,
                             timeout=300)
        assert bad.returncode == 1
        assert "Invalid accessKey" in json.loads(
            bad.stdout.strip().splitlines()[-1])["error"]
        ok = subprocess.run(base + ["--server-key", "K"], cwd=REPO,
                            env=penv, capture_output=True, text=True,
                            timeout=300)
        assert ok.returncode == 0, ok.stderr
        stats = json.loads(ok.stdout.strip().splitlines()[-1])
        assert stats["folded"] == 21 and stats["queueDepth"] == 0
        assert stats["modelInstanceId"] == iid
        st, body = call(port, "POST", "/queries.json",
                        {"user": "newbie", "num": 2})
        assert st == 200 and len(body["itemScores"]) == 2
        st, body = call(port, "GET", "/")
        assert body["foldin"]["appliedUsers"] == 21
    finally:
        proc.terminate()
        try:
            proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()


def test_foldin_verb_without_cuda_raises(tmp_path, monkeypatch):
    engine_dir = tmp_path / "engine"
    engine_dir.mkdir()
    (engine_dir / "engine.json").write_text(json.dumps(variant()))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    store = Storage(env=storage_env(tmp_path))
    monkeypatch.setattr("pio_tpu_torch.__main__.get_storage", lambda: store)
    try:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port_main(["foldin", "--engine-dir", str(engine_dir), "--once",
                       "--state-path", str(tmp_path / "c.bin")])
    finally:
        store.close()


# -- the slice against the JAX package --------------------------------------

N_USERS, N_ITEMS, RANK = 30, 60, 6


def slice_events(rng):
    """(user, item, event, rating, minute) rows: some users with several
    ratings of one item (the latest wins), buys without a rating, new
    users and one user on unknown items only."""
    rows, m = [], 0
    users = [f"u{u}" for u in range(N_USERS)] + [f"new{u}" for u in range(8)]
    for user in users:
        for _ in range(int(rng.integers(1, 14))):
            item = f"i{int(rng.integers(0, N_ITEMS))}"
            kind = "rate" if rng.random() < 0.7 else "buy"
            rating = float(rng.integers(1, 6)) if kind == "rate" else None
            rows.append((user, item, kind, rating, m))
            m += 1
    rows.append(("martian", "nope", "rate", 5.0, m))
    return rows


def _write(store, app_cls, event_cls, datamap_cls, rows):
    app_id = store.get_metadata_apps().insert(app_cls(0, "mlapp"))
    ev = store.get_events()
    ev.init(app_id)
    for user, item, kind, rating, m in rows:
        ev.insert(event_cls(
            event=kind, entity_type="user", entity_id=user,
            target_entity_type="item", target_entity_id=item,
            properties=datamap_cls({} if rating is None
                                   else {"rating": rating}),
            event_time=T0 + timedelta(minutes=m)), app_id)


@pytest.mark.parametrize("implicit", [False, True])
def test_slice_matches_the_reference(tmp_path, implicit):
    """The same seeded factors persisted in both packages, the same
    events in each store, one replayed fold-in cycle in each: the served
    rows agree within ROW_RTOL of each row's norm, the same users are
    folded and skipped, and the top-k ids agree wherever the score gaps
    exceed the tolerance."""
    rng = np.random.default_rng(5)
    uf = rng.standard_normal((N_USERS, RANK)).astype(np.float32)
    itf = rng.standard_normal((N_ITEMS, RANK)).astype(np.float32)
    users = [f"u{u}" for u in range(N_USERS)]
    items = [f"i{i}" for i in range(N_ITEMS)]
    rows = slice_events(rng)
    algo = {"rank": RANK, "lambda_": 0.05, "alpha": 0.8,
            "implicit_prefs": implicit}
    var = {"id": "rec", "engineFactory": FACTORY,
           "datasource": {"params": {"app_name": "mlapp"}},
           "algorithms": [{"name": "als", "params": algo}]}

    # the reference
    (tmp_path / "ref").mkdir()
    ref_store = RefStorage(env=storage_env(tmp_path / "ref"))
    _write(ref_store, RefApp, RefEvent, RefDataMap, rows)
    ref_engine = ref_rec.RecommendationEngine.apply()
    ref_ep = ref_engine.engine_params_from_variant(var)
    ref_model = ref_rec.RecommendationModel(
        ref_als.ALSModel(jnp.asarray(uf), jnp.asarray(itf)),
        RefIdIndex(users), RefIdIndex(items))
    iid = ref_store.get_metadata_engine_instances().insert(
        RefEngineInstance(
            id="", status="COMPLETED", start_time=T0, end_time=T0,
            engine_id="rec", engine_version="1", engine_variant="default",
            engine_factory="pio_tpu.models.recommendation"
                           ".RecommendationEngine"))
    ref_store.get_model_data_models().insert(
        RefModel(iid, ref_models_to_bytes([ref_model])))
    rqs = RefQueryServer(
        ref_engine, ref_ep, ref_store,
        RefServingConfig(ip="127.0.0.1", port=0, engine_id="rec"),
        ctx=ref_ctx(ref_store, use_mesh=False))
    ref_worker = RefFoldInWorker(ref_store, RefFoldInConfig(
        app_name="mlapp", engine_id="rec", replay=True,
        als_params=ref_als.ALSParams(rank=RANK, reg=0.05, alpha=0.8,
                                     implicit=implicit),
        state_path=str(tmp_path / "ref" / "cursor.bin")),
        RefLocalApplier(rqs))
    ref_stats = ref_worker.run_once()

    # the port
    (tmp_path / "port").mkdir()
    store = Storage(env=storage_env(tmp_path / "port"))
    _write(store, App, Event, DataMap, rows)
    engine = port_rec.RecommendationEngine.apply()
    ep = engine.engine_params_from_variant(var)
    persist_models([recommendation_model_from_numpy(
        uf, itf, users, items, device="cpu")], ep, store, "rec",
        engine_factory=FACTORY)
    http, qs = serve(store, engine, ep,
                     create_workflow_context(store, device="cpu"))
    worker = FoldInWorker(store, FoldInConfig(
        app_name="mlapp", engine_id="rec", replay=True,
        als_params=als.ALSParams(rank=RANK, reg=0.05, alpha=0.8,
                                 implicit=implicit),
        state_path=str(tmp_path / "port" / "cursor.bin")),
        LocalServingApplier(qs), device="cpu")
    try:
        stats = worker.run_once()
        assert stats == ref_stats
        assert stats["folded"] == N_USERS + 8 and stats["skipped"] == 1
        got_m, want_m = qs.models[0], rqs.models[0]
        assert got_m.users.ids() == want_m.users.ids()
        got = got_m.factors.user_factors.numpy()
        want = np.asarray(want_m.factors.user_factors)
        norm = np.linalg.norm(want, axis=1, keepdims=True)
        assert (np.abs(got - want) <= ROW_RTOL * norm).all()
        # top-k ids through both servers' exact tier
        for user in ("u0", "u7", "new0", "new5"):
            q = {"user": user, "num": 10}
            mine = qs.query(dict(q))["itemScores"]
            theirs = rqs.query(dict(q))["itemScores"]
            ws = [s["score"] for s in theirs]
            tol = ROW_RTOL * max(abs(s) for s in ws) * 10
            for j, (a, b) in enumerate(zip(mine, theirs)):
                assert abs(a["score"] - b["score"]) <= tol
                gaps = [abs(ws[j] - ws[x]) for x in (j - 1, j + 1)
                        if 0 <= x < len(ws)]
                if min(gaps) > tol:
                    assert a["item"] == b["item"], (user, j)
    finally:
        http.stop()
        qs.close()
        store.close()
        rqs.close()
        ref_store.close()


# -- the fleet: RouterFleetApplier and the shards' upserts -------------------

@pytest.mark.usefixtures("time_limit")
@pytest.mark.parametrize("implicit", [False, True])
def test_foldin_oracle_parity_fleet(storage, tmp_path, implicit):
    """The cold oracle through the sharded fleet: the router routes the
    fold to the owner shard group, every replica holds the oracle's row
    bit for bit, the other group none, and the user serves through
    /queries.json."""
    engine, ep, ctx, iid, app_id = train(storage, implicit=implicit)
    handle = deploy_fleet(storage, engine_id="rec", n_shards=2,
                          n_replicas=2, device="cpu")
    try:
        worker = worker_of(
            storage, tmp_path,
            RouterFleetApplier(f"http://127.0.0.1:{handle.router_http.port}"),
            implicit)
        events = ingest(storage, app_id, "newbie",
                        [("i1", 5), ("i4", 2), ("i7", 4)])
        stats = worker.run_once()
        assert stats["folded"] == 1
        with worker._lock:
            model = worker._model
        want = oracle_row(model, events, worker.config.als_params)
        owner = shard_of("newbie", 2)
        for rep in range(2):
            _http, srv = handle.shards[owner * 2 + rep]
            assert srv.config.shard_index == owner
            row = srv.user_row("newbie")
            assert row is not None, f"replica {rep} missed the fold"
            assert (np.asarray(row, np.float32) == want).all(), rep
        for rep in range(2):
            _http, srv = handle.shards[(1 - owner) * 2 + rep]
            assert srv.user_row("newbie") is None
        st, body = call(handle.router_http.port, "POST", "/queries.json",
                        {"user": "newbie", "num": 3})
        assert st == 200 and len(body["itemScores"]) == 3
        assert not body.get("degraded")
    finally:
        handle.close()


@pytest.mark.usefixtures("time_limit")
def test_router_upsert_rejected_rows_not_counted_as_applied(storage):
    """A shard that answers 200 but rejects the rows (a plan mismatch)
    is no successful apply: its group is in failedGroups and the applier
    raises, so the folder keeps the users pending."""
    train(storage)
    handle = deploy_fleet(storage, engine_id="rec", n_shards=2,
                          n_replicas=1, device="cpu")
    try:
        url = f"http://127.0.0.1:{handle.router_http.port}"
        u0 = next(u for u in ("a", "b", "c", "d") if shard_of(u, 2) == 0)
        handle.shards[0][1].config.shard_index = 1
        st, out = call(handle.router_http.port, "POST",
                       "/fleet/upsert_users",
                       {"users": {u0: [0.5, 0.5, 0.5, 0.5]}})
        assert st == 200
        assert out["ok"] is False and out["failedGroups"] == [0]
        assert out["groups"]["0"]["ok"] is False
        assert out["groups"]["0"]["replicas"]["0"]["rejected"] == [u0]
        with pytest.raises(FoldInApplyError, match="incomplete"):
            RouterFleetApplier(url).apply({u0: [0.5, 0.5, 0.5, 0.5]})
        assert handle.router.replicas[0][0].breaker.snapshot() \
            .state == "closed"
    finally:
        handle.close()


@pytest.mark.usefixtures("time_limit")
def test_shard_upsert_rejects_misrouted_rows(storage):
    """A row another shard owns is rejected, never shadowing the owner's
    copy."""
    _engine, _ep, _ctx, iid, _app_id = train(storage)
    _, model = resolve_fleet_model(storage, "rec")
    persist_fleet_artifacts(storage, iid, model, 2, 1)
    srv = ShardServer(storage, ShardConfig(
        shard_index=0, n_shards=2, engine_id="rec", instance_id=iid,
        device="cpu"))
    mine = next(u for u in ("a", "b", "c", "d") if shard_of(u, 2) == 0)
    theirs = next(u for u in ("a", "b", "c", "d") if shard_of(u, 2) == 1)
    row = [1.0, 0.0, 0.0, 0.0]
    out = srv.upsert_user_rows({mine: row, theirs: row})
    assert out["applied"] == 1 and out["rejected"] == [theirs]
    assert srv.user_row(mine) == row
    assert srv.user_row(theirs) is None


@pytest.mark.usefixtures("time_limit")
def test_router_upsert_reports_failed_group_and_applier_raises(storage):
    """One shard group down: the router applies what it can, names the
    dead group in failedGroups, and RouterFleetApplier raises."""
    train(storage)
    handle = deploy_fleet(storage, engine_id="rec", n_shards=2,
                          n_replicas=1, device="cpu")
    try:
        url = f"http://127.0.0.1:{handle.router_http.port}"
        users = ["a", "b", "c", "d", "e"]
        live_u = next(u for u in users if shard_of(u, 2) == 0)
        dead_u = next(u for u in users if shard_of(u, 2) == 1)
        handle.shards[1][0].stop()
        row = [0.5, 0.5, 0.5, 0.5]
        st, out = call(handle.router_http.port, "POST",
                       "/fleet/upsert_users",
                       {"users": {live_u: row, dead_u: row}})
        assert st == 200
        assert out["ok"] is False and out["failedGroups"] == [1]
        assert out["groups"]["0"]["ok"] and out["groups"]["0"]["fullyApplied"]
        assert handle.shards[0][1].user_row(live_u) == row
        with pytest.raises(FoldInApplyError, match="incomplete"):
            RouterFleetApplier(url).apply({dead_u: row})
    finally:
        handle.close()


@pytest.mark.usefixtures("time_limit")
def test_foldin_verb_router_url_folds_through_the_fleet(storage, tmp_path,
                                                        monkeypatch,
                                                        capsys):
    """``foldin --router-url URL --once --replay`` folds every user and
    applies through the router: the new user's owner group holds the
    oracle's row on every replica."""
    engine_dir = tmp_path / "engine"
    engine_dir.mkdir()
    (engine_dir / "engine.json").write_text(json.dumps(variant()))
    _engine, _ep, _ctx, _iid, app_id = train(storage)
    monkeypatch.setattr("pio_tpu_torch.__main__.get_storage",
                        lambda: storage)
    handle = deploy_fleet(storage, engine_id="rec", n_shards=2,
                          n_replicas=2, device="cpu", server_key="K")
    try:
        events = ingest(storage, app_id, "newbie", [("i2", 5), ("i3", 1)])
        rc = port_main(["foldin", "--engine-dir", str(engine_dir), "--once",
                        "--replay", "--router-url",
                        f"http://127.0.0.1:{handle.router_http.port}",
                        "--server-key", "K", "--device", "cpu",
                        "--state-path", str(tmp_path / "cursor.bin")])
        stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert rc == 0, stats
        assert stats["folded"] == 21 and stats["queueDepth"] == 0
        _, model = resolve_fleet_model(storage, "rec", device="cpu")
        want = oracle_row(model, events, foldin_config(tmp_path).als_params)
        owner = shard_of("newbie", 2)
        for rep in range(2):
            row = handle.shards[owner * 2 + rep][1].user_row("newbie")
            assert (np.asarray(row, np.float32) == want).all(), rep
    finally:
        handle.close()
