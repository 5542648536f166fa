"""The port's admission stage against the JAX package's contract.

  * ``serving/batcher.ContinuousBatcher``, the port's copy, under the
    reference's unit cases: coalescing into one dispatch, a
    deadline-doomed query going solo, a spent budget shed before enqueue,
    never waiting past a deadline, a batch failure retried solo;
  * end to end over HTTP on seeded factors, exact and clustered: answers
    through the continuous and the micro batcher are the port's solo
    answers bit for bit (mixed users, blackList, whiteList, an unknown
    user, an over-fetch), and so are rows of in-process batches of 1, 2,
    16 and 64; the item ids are the JAX ``QueryServer``'s, the scores
    within ``RTOL``/``ATOL`` of them (ROADMAP C3: the reference's own
    scores move with the batch on jax CPU);
  * ``/batcher.json``, the guarded ``/batcher/window`` and the occupancy
    histogram on ``/metrics``;
  * a 2-shard fleet behind the router's coalescer: batched shard frames
    answering bit for bit the single-host deploy (exact) or the same
    fleet a query at a time (clustered), a shard group killed mid-fan
    (no 5xx, only the queries that need it degraded), and a shard that
    refuses batched frames downgraded for good, logged once.
"""

import _torch_cpu  # noqa: F401  (one CPU thread: see the module)
import json
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from datetime import datetime, timezone

import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_fleet import answer as fleet_answer
from test_torch_fleet import oracle as fleet_oracle
from test_torch_fleet import time_limit, trained  # noqa: F401
from test_torch_retrieval import mixture_rows

from pio_tpu.data.bimap import EntityIdIndex as RefIdIndex
from pio_tpu.data.dao import EngineInstance as RefEngineInstance
from pio_tpu.data.dao import Model as RefModel
from pio_tpu.data.storage import Storage as RefStorage
from pio_tpu.models import recommendation as ref_rec
from pio_tpu.ops import als as ref_als
from pio_tpu.workflow.checkpoint import models_to_bytes as ref_models_to_bytes
from pio_tpu.workflow.context import create_workflow_context as ref_ctx
from pio_tpu.workflow.serve import QueryServer as RefQueryServer
from pio_tpu.workflow.serve import ServingConfig as RefServingConfig
from pio_tpu_torch.convert import recommendation_model_from_numpy
from pio_tpu_torch.data.storage import Storage
from pio_tpu_torch.models import recommendation as port_rec
from pio_tpu_torch.resilience import Deadline, DeadlineExceeded, chaos
from pio_tpu_torch.serving.batcher import ContinuousBatcher
from pio_tpu_torch.serving_fleet import rpcwire
from pio_tpu_torch.serving_fleet.fleet import deploy_fleet
from pio_tpu_torch.serving_fleet.plan import shard_of
from pio_tpu_torch.serving_fleet.router import RouterConfig
from pio_tpu_torch.utils.tracing import Tracer
from pio_tpu_torch.workflow.context import create_workflow_context
from pio_tpu_torch.workflow.serve import (
    QueryServer,
    ServingConfig,
    create_query_server,
)
from pio_tpu_torch.workflow.train import persist_models

FACTORY = "pio_tpu_torch.models.recommendation.RecommendationEngine"
N_USERS, N_ITEMS, RANK = 40, 600, 16
# the JAX package's scores: the same f32 dots summed in another order
RTOL = 1e-5
ATOL = 1e-5
CLUSTERED = {"mode": "clustered", "dtype": "int8", "nprobe": 8,
             "impl": "pallas"}
KEY = "SRVKEY"
T0 = datetime(2026, 1, 1, tzinfo=timezone.utc)

MIXED_QUERIES = [
    {"user": "u0", "num": 4},
    {"user": "u3", "num": 6, "blackList": ["i1", "i5"]},
    {"user": "u5", "num": 3, "whiteList": ["i2", "i7", "i9", "nope"]},
    {"user": "u5", "num": 2, "whiteList": ["i2", "i7", "i9"],
     "blackList": ["i7"]},
    {"user": "ghost", "num": 4},           # unknown user
    {"user": "u7", "num": 50},
    {"user": "u11", "num": 5},
    {"user": "u2", "num": 3, "blackList": ["i0"]},
]


# -- ContinuousBatcher unit contract ------------------------------------------

class FakeServer:
    """Stands in for QueryServer: records solo vs batched dispatches."""

    def __init__(self, batch_delay_s=0.0, fail_batch=False):
        self.tracer = Tracer()
        self.batch_delay_s = batch_delay_s
        self.fail_batch = fail_batch
        self.solo_calls = []
        self.batch_calls = []
        self.lock = threading.Lock()

    def query(self, q):
        with self.lock:
            self.solo_calls.append(dict(q))
        return {"user": q["user"], "via": "solo"}

    def query_batch(self, queries, record=True, observe_batch_errors=True):
        with self.lock:
            self.batch_calls.append([dict(q) for q in queries])
        if self.batch_delay_s:
            time.sleep(self.batch_delay_s)
        if self.fail_batch:
            raise RuntimeError("device fell over")
        return [{"user": q["user"], "via": "batch"} for q in queries]


def _concurrently(fn, n):
    """``fn(i)`` for i < n on n threads that start it together: a thread
    still being created must not arrive after the others' batch left."""
    out = [None] * n
    start = threading.Barrier(n)

    def one(i):
        start.wait(timeout=60)
        out[i] = fn(i)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert all(r is not None for r in out)
    return out


def test_coalesces_concurrent_queries_into_one_dispatch():
    srv = FakeServer()
    b = ContinuousBatcher(srv, window_s=0.08, max_batch=64)
    try:
        out = _concurrently(lambda i: b.query({"user": f"u{i}"}), 8)
        # every caller got ITS OWN answer back (scatter is positional)
        assert sorted(r["user"] for r in out) == sorted(
            f"u{i}" for i in range(8))
        assert all(r["via"] == "batch" for r in out)
        # one window, one device dispatch — not eight
        assert len(srv.batch_calls) == 1
        assert len(srv.batch_calls[0]) == 8
        st = b.stats()
        assert st["mode"] == "continuous"
        assert st["dispatches"] == 1 and st["coalescedQueries"] == 8
        assert st["meanOccupancy"] == pytest.approx(8 / 64)
    finally:
        b.close()


def test_deadline_doomed_query_bypasses_solo_immediately():
    srv = FakeServer()
    b = ContinuousBatcher(srv, window_s=0.2, max_batch=8)
    try:
        with Deadline.budget(0.05):     # budget < window: can't wait
            t0 = time.monotonic()
            out = b.query({"user": "u1"})
            took = time.monotonic() - t0
        assert out["via"] == "solo"     # never entered the queue
        assert took < 0.15              # did NOT sleep the window
        assert b.stats()["bypassSolo"] == 1
        assert srv.batch_calls == []
    finally:
        b.close()


def test_spent_budget_sheds_before_enqueue():
    srv = FakeServer()
    b = ContinuousBatcher(srv, window_s=0.01, max_batch=8)
    try:
        with Deadline.budget(0.0):
            with pytest.raises(DeadlineExceeded):
                b.query({"user": "u1"})
        assert b.stats()["shed"] == 1
        assert srv.solo_calls == [] and srv.batch_calls == []
    finally:
        b.close()


def test_never_waits_past_deadline_even_when_execution_stalls():
    """A stalled device dispatch must not hold a request past its budget:
    the waiter sheds on time instead."""
    srv = FakeServer(batch_delay_s=1.0)   # execution far over budget
    b = ContinuousBatcher(srv, window_s=0.001, max_batch=8,
                          pipeline_depth=1)
    try:
        t0 = time.monotonic()
        with Deadline.budget(0.15):
            with pytest.raises(DeadlineExceeded):
                b.query({"user": "u1"})
        took = time.monotonic() - t0
        assert took < 0.6, f"waited {took:.2f}s past a 0.15s budget"
    finally:
        b.close()


def test_batch_failure_retries_each_query_solo():
    srv = FakeServer(fail_batch=True)
    b = ContinuousBatcher(srv, window_s=0.08, max_batch=8)
    try:
        out = _concurrently(lambda i: b.query({"user": f"u{i}"}), 3)
        assert all(r["via"] == "solo" for r in out)
        assert sorted(r["user"] for r in out) == ["u0", "u1", "u2"]
        assert len(srv.solo_calls) == 3
    finally:
        b.close()


# -- single host, end to end --------------------------------------------------

def _env(path) -> dict:
    return {
        "PIO_STORAGE_SOURCES_SQL_TYPE": "sqlite",
        "PIO_STORAGE_SOURCES_SQL_PATH": str(path / "pio.db"),
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "SQL",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "SQL",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "SQL",
    }


def _variant(retrieval) -> dict:
    algo = {"name": "als", "params": {"rank": RANK}}
    if retrieval is not None:
        algo["params"]["retrieval"] = retrieval
    return {"id": "rec", "engineFactory": FACTORY, "algorithms": [algo]}


@pytest.fixture(scope="module")
def seeded():
    rng = np.random.default_rng(11)
    uf = rng.standard_normal((N_USERS, RANK)).astype(np.float32)
    itf = mixture_rows(N_ITEMS, RANK, 24, rng)
    users = [f"u{i}" for i in range(N_USERS)]
    items = [f"i{i}" for i in range(N_ITEMS)]
    return uf, itf, users, items


@pytest.fixture(scope="module", params=[None, CLUSTERED],
                ids=["exact", "clustered"])
def deployment(request, seeded, tmp_path_factory):
    """The seeded factors persisted in a sqlite store of each package,
    the port's solo QueryServer (the oracle) and the JAX one."""
    retrieval = request.param
    uf, itf, users, items = seeded
    root = tmp_path_factory.mktemp("batching")
    (root / "port").mkdir()
    (root / "ref").mkdir()
    storage = Storage(env=_env(root / "port"))
    engine = port_rec.RecommendationEngine.apply()
    ep = engine.engine_params_from_variant(_variant(retrieval))
    persist_models([recommendation_model_from_numpy(
        uf, itf, users, items, device="cpu")], ep, storage, "rec",
        engine_factory=FACTORY)
    ctx = create_workflow_context(storage, device="cpu")
    solo = QueryServer(engine, ep, storage,
                       ServingConfig(engine_id="rec"), ctx=ctx)

    ref_store = RefStorage(env=_env(root / "ref"))
    ref_engine = ref_rec.RecommendationEngine.apply()
    ref_ep = ref_engine.engine_params_from_variant(
        {**_variant(retrieval), "engineFactory":
         "pio_tpu.models.recommendation.RecommendationEngine"})
    iid = ref_store.get_metadata_engine_instances().insert(
        RefEngineInstance(
            id="", status="COMPLETED", start_time=T0, end_time=T0,
            engine_id="rec", engine_version="1", engine_variant="default",
            engine_factory="pio_tpu.models.recommendation"
                           ".RecommendationEngine"))
    ref_store.get_model_data_models().insert(RefModel(
        iid, ref_models_to_bytes([ref_rec.RecommendationModel(
            ref_als.ALSModel(jnp.asarray(uf), jnp.asarray(itf)),
            RefIdIndex(users), RefIdIndex(items))])))
    ref = RefQueryServer(
        ref_engine, ref_ep, ref_store,
        RefServingConfig(ip="127.0.0.1", port=0, engine_id="rec"),
        ctx=ref_ctx(ref_store, use_mesh=False))
    yield storage, engine, ep, ctx, solo, ref
    solo.close()
    ref.close()
    storage.close()
    ref_store.close()


def call(port, method, path, body=None, **params):
    url = f"http://127.0.0.1:{port}{path}"
    if params:
        url += "?" + urllib.parse.urlencode(params)
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            raw = resp.read().decode()
            return resp.status, (json.loads(raw) if raw.startswith(("{", "["))
                                 else raw)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode() or "{}")


def _serve(deployment, **cfg):
    storage, engine, ep, ctx, _, _ = deployment
    http, qs = create_query_server(
        engine, ep, storage,
        ServingConfig(ip="127.0.0.1", port=0, engine_id="rec",
                      server_key=KEY, **cfg), ctx=ctx)
    http.start()
    return http, qs


def _ids(result):
    return [s["item"] for s in result["itemScores"]]


MODES = {"continuous": {"coalesce_window_ms": 60.0},
         "micro": {"batch_window_ms": 25.0}}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_batched_answers_equal_solo_bit_for_bit(deployment, mode):
    """Concurrent queries through either batcher answer exactly what the
    port's solo path answers (JSON bodies equal, so every score's bits),
    the ids are the JAX QueryServer's, and the batcher really shared
    dispatches."""
    solo, ref = deployment[4], deployment[5]
    http, qs = _serve(deployment, **MODES[mode])
    sizes = []
    batch = qs.query_batch

    def spy(queries, record=True, **kw):
        if record:           # the background warm sweep passes False
            sizes.append(len(queries))
        return batch(queries, record, **kw)

    qs.query_batch = spy
    try:
        for _round in range(2):
            out = _concurrently(lambda i: call(
                http.port, "POST", "/queries.json", MIXED_QUERIES[i]),
                len(MIXED_QUERIES))
            for q, (status, body) in zip(MIXED_QUERIES, out):
                assert status == 200, (q, body)
                assert body == json.loads(json.dumps(
                    solo.query(dict(q), record=False))), q
                want = ref.query(dict(q), record=False)
                assert _ids(body) == _ids(want), q
                np.testing.assert_allclose(
                    [s["score"] for s in body["itemScores"]],
                    [s["score"] for s in want["itemScores"]],
                    rtol=RTOL, atol=ATOL)
        assert sum(sizes) == 2 * len(MIXED_QUERIES)
        assert len(sizes) < 2 * len(MIXED_QUERIES), sizes
        _, st = call(http.port, "GET", "/batcher.json")
        assert st["enabled"] is True
        assert st["mode"] == mode
    finally:
        http.stop()
        qs.close()


@pytest.mark.parametrize("b", [1, 2, 16, 64])
def test_rows_of_any_batch_equal_solo_bit_for_bit(deployment, b):
    """In process: every row of a batch of b known users (a blackList
    over-fetch among them) is the solo answer, bits and all."""
    solo = deployment[4]
    queries = [{"user": f"u{(7 * i) % N_USERS}", "num": 10}
               for i in range(b)]
    queries[-1]["blackList"] = ["i3", "i4"]
    got = solo.query_batch(queries, record=False)
    for q, g in zip(queries, got):
        assert g == solo.query(dict(q), record=False), q


def test_batcher_json_window_and_occupancy_histogram(deployment):
    http, qs = _serve(deployment, coalesce_window_ms=60.0)
    try:
        _concurrently(lambda i: call(http.port, "POST", "/queries.json",
                                     {"user": f"u{i}", "num": 3}), 12)
        status, st = call(http.port, "GET", "/batcher.json")
        assert status == 200 and st["enabled"] and st["mode"] == "continuous"
        assert st["coalescedQueries"] + st["bypassSolo"] == 12
        assert 1 <= st["dispatches"] < st["coalescedQueries"]
        status, text = call(http.port, "GET", "/metrics")
        assert status == 200
        assert "pio_serving_batch_occupancy_bucket" in text
        assert call(http.port, "POST", "/batcher/window",
                    {"windowMs": 5})[0] == 401
        assert call(http.port, "POST", "/batcher/window", {"windowMs": 0},
                    accessKey=KEY)[0] == 400
        assert call(http.port, "POST", "/batcher/window",
                    {"windowMs": 5000}, accessKey=KEY)[0] == 400
        status, st = call(http.port, "POST", "/batcher/window",
                          {"windowMs": 5}, accessKey=KEY)
        assert status == 200 and st["windowMs"] == pytest.approx(5.0)
    finally:
        http.stop()
        qs.close()
    http, qs = _serve(deployment)
    try:
        assert call(http.port, "GET", "/batcher.json") == (
            200, {"mode": None, "enabled": False})
        assert call(http.port, "POST", "/batcher/window", {"windowMs": 5},
                    accessKey=KEY)[0] == 409
    finally:
        http.stop()
        qs.close()


def test_batch_max_above_the_dispatch_rows_is_refused(deployment):
    storage, engine, ep, ctx, _, _ = deployment
    with pytest.raises(ValueError, match="batch_max 128"):
        QueryServer(engine, ep, storage,
                    ServingConfig(engine_id="rec", coalesce_window_ms=2.0,
                                  batch_max=128), ctx=ctx)


# -- 2-shard fleet: the router's coalescer ------------------------------------

def _fleet_coalescing(storage, window_ms=60.0, **kw):
    return deploy_fleet(
        storage, engine_id="rec", n_shards=2, n_replicas=1, device="cpu",
        router_config=RouterConfig(coalesce_window_ms=window_ms,
                                   probe_interval_s=0.2), **kw)


def _warm_binary(port, n=3):
    """A few sequential queries, so every replica's binary wire is
    confirmed: only then does the router send batched frames."""
    for u in range(n):
        status, _ = call(port, "POST", "/queries.json",
                         {"user": f"u{u}", "num": 3})
        assert status == 200


@pytest.mark.usefixtures("time_limit")
def test_fleet_coalesced_answers_equal_solo_bit_for_bit(deployment):
    """Concurrent queries through the coalescing router ride batched
    shard frames and answer bit for bit what the port's single-host
    deploy answers (exact) or the same fleet answers a query at a time
    (clustered: each shard's clusters are its own); ids are the JAX
    QueryServer's in exact mode."""
    storage, engine, ep, ctx, solo, ref = deployment
    retrieval = ep.algorithms[0][1].retrieval
    oracle_fleet = None
    if retrieval is not None:
        oracle_fleet = deploy_fleet(storage, engine_id="rec", n_shards=2,
                                    n_replicas=1, retrieval=retrieval,
                                    device="cpu")
    handle = _fleet_coalescing(storage, retrieval=retrieval)
    try:
        port = handle.router_http.port
        _warm_binary(port)

        def want(q):
            if oracle_fleet is None:
                return json.loads(json.dumps(
                    solo.query(dict(q), record=False)))
            return call(oracle_fleet.router_http.port, "POST",
                        "/queries.json", dict(q))[1]

        wants = [want(q) for q in MIXED_QUERIES]
        for _round in range(2):
            out = _concurrently(lambda i: call(
                port, "POST", "/queries.json", MIXED_QUERIES[i]),
                len(MIXED_QUERIES))
            for q, w, (status, body) in zip(MIXED_QUERIES, wants, out):
                assert status == 200, (q, body)
                assert body == w, q
                if oracle_fleet is None:
                    assert _ids(body) == _ids(
                        ref.query(dict(q), record=False)), q
        status, batch = call(port, "POST", "/batch/queries.json",
                             [dict(q) for q in MIXED_QUERIES])
        assert status == 200 and batch == wants
        _, fs = call(port, "GET", "/fleet.json")
        bt = fs["batching"]
        assert bt["enabled"]
        assert bt["coalescedCalls"] >= 1
        assert bt["coalescedQueries"] >= 2 * bt["coalescedCalls"]
        assert all(rep["batchWire"] for g in fs["shards"].values()
                   for rep in g["replicas"])
    finally:
        handle.close()
        if oracle_fleet is not None:
            oracle_fleet.close()


@pytest.mark.usefixtures("time_limit")
def test_fleet_chaos_kill_shard_mid_coalesced_fan(trained):
    """One shard group down mid-fan on the coalesced plane: no 5xx, the
    queries that need it degrade (flagged), a whiteList query owned by
    the live shard alone stays exact."""
    storage, *_ = trained
    handle = _fleet_coalescing(storage)
    try:
        port = handle.router_http.port
        _warm_binary(port)
        live, dead = 0, 1
        users = [f"u{u}" for u in range(20) if shard_of(f"u{u}", 2) == live]
        items = [f"i{i}" for i in range(12) if shard_of(f"i{i}", 2) == live]
        assert users and len(items) >= 2
        plain = [{"user": users[0], "num": 3},
                 {"user": users[1 % len(users)], "num": 4}]
        isolated = [{"user": users[0], "num": 2, "whiteList": items[:3]}]
        queries = plain + isolated
        with chaos.inject(f"fleet.shard{dead}", error=1.0, seed=7):
            out = _concurrently(lambda i: call(
                port, "POST", "/queries.json", queries[i]), len(queries))
        assert all(status < 500 for status, _ in out), out
        for status, body in out[:len(plain)]:
            assert status == 200 and body.get("degraded") is True
        for status, body in out[len(plain):]:
            assert status == 200 and "degraded" not in body, body
        status, body = call(port, "POST", "/queries.json",
                            {"user": users[0], "num": 3})
        assert status == 200 and not body.get("degraded")
    finally:
        handle.close()


@pytest.mark.usefixtures("time_limit")
def test_fleet_pre_batch_replica_sticky_fallback_logged_once(
        trained, monkeypatch, caplog):
    """A shard that 400s the batched frame is downgraded to solo frames
    for good (logged once); the coalescer re-runs each query solo, and
    every answer stays the single-host deploy's."""
    import logging

    storage, engine, ep, ctx, iid = trained
    qs = fleet_oracle(storage, engine, ep, ctx, iid)
    handle = _fleet_coalescing(storage)
    try:
        port = handle.router_http.port
        _warm_binary(port)
        orig = rpcwire.decode_scoring_request

        def pre_batch_decode(data, op):
            rows, ks, arm, batched = orig(data, op)
            if batched:
                raise rpcwire.RpcWireError(
                    "unexpected batch header (pre-batch build)")
            return rows, ks, arm, batched

        monkeypatch.setattr(rpcwire, "decode_scoring_request",
                            pre_batch_decode)
        queries = MIXED_QUERIES[:4]
        with caplog.at_level(logging.WARNING,
                             logger="pio_tpu_torch.fleet.router"):
            for _round in range(3):
                out = _concurrently(lambda i: call(
                    port, "POST", "/queries.json", queries[i]),
                    len(queries))
                for q, (status, body) in zip(queries, out):
                    assert status == 200, (q, body)
                    assert body == fleet_answer(qs, q), q
        downgrades = [r for r in caplog.records
                      if "sticky solo-frame downgrade" in r.message]
        assert 1 <= len(downgrades) <= 2
        _, fs = call(port, "GET", "/fleet.json")
        assert fs["batching"]["fallbackCalls"] >= 1
        assert all(rep["batchWire"] is False
                   for g in fs["shards"].values()
                   for rep in g["replicas"]
                   if rep["batchWire"] is not None)
    finally:
        handle.close()
        qs.close()
