"""The port's sharded serving fleet (``pio_tpu_torch/serving_fleet/``)
against the JAX package's, on the CPU:

  * the shard plan blob of one model equals the reference's byte for
    byte, and each partition blob holds the reference's partition field
    for field (a partition blob pickles its class, so the two name other
    modules);
  * plan determinism, partitions covering the model disjointly, the
    memory budget (the retrieval sidecar charged too);
  * the port's fleet answers — plain, blackList over-fetch, whiteList,
    unknown user, k past the catalog — bit for bit the port's
    single-host deploy in exact and exhaustive mode, and the reference
    fleet's (ids exact, scores within ``RTOL``/``ATOL``) in exact,
    clustered and exhaustive mode on seeded factors;
  * replica failover, the kill-one-shard drill, the per-shard chaos
    point, the degraded blend (the reference fleet's answer in the same
    outage), the corrupt-partition last-good fallback, /reload;
  * the clustered route through the scan kernel's wrapper once a scan
    dispatch, counted on ``/metrics.json``; a narrow slice scoring its
    items as the whole table does;
  * every entry point raising without CUDA unless the CPU is asked for,
    and the deploy verb's fleet options and refusals;
  * a slow-marked 2 shards x 2 replicas subprocess drill (SIGKILL,
    rejoin).

The trained model is the reference tests' (20 users x 12 items, rank 4,
trained by the port on the CPU); the seeded one has 300 users and 400
items at rank 8, persisted in a store of each package.
"""

import _torch_cpu  # noqa: F401  (one CPU thread: see the module)
import dataclasses
import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from datetime import datetime, timedelta, timezone

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_retrieval import mixture_rows

from pio_tpu.data.bimap import EntityIdIndex as RefIdIndex
from pio_tpu.data.dao import EngineInstance as RefEngineInstance
from pio_tpu.data.dao import Model as RefModel
from pio_tpu.data.storage import Storage as RefStorage
from pio_tpu.models import recommendation as ref_rec
from pio_tpu.ops import als as ref_als
from pio_tpu.serving_fleet.fleet import deploy_fleet as ref_deploy_fleet
from pio_tpu.workflow.checkpoint import models_to_bytes as ref_models_to_bytes
from pio_tpu_torch.__main__ import main as port_main
from pio_tpu_torch.convert import recommendation_model_from_numpy
from pio_tpu_torch.data.dao import App, Model
from pio_tpu_torch.data.datamap import DataMap
from pio_tpu_torch.data.event import Event
from pio_tpu_torch.data.storage import Storage
from pio_tpu_torch.models import recommendation as port_rec
from pio_tpu_torch.ops import als, retrieval
from pio_tpu_torch.resilience import chaos
from pio_tpu_torch.serving_fleet import __main__ as fleet_main
from pio_tpu_torch.serving_fleet.fleet import (
    deploy_fleet,
    resolve_fleet_model,
)
from pio_tpu_torch.serving_fleet.plan import (
    ShardPartition,
    ShardPlan,
    build_plan,
    load_partition,
    model_nbytes,
    partition_from_bytes,
    partition_model,
    partition_to_bytes,
    persist_fleet_artifacts,
    shard_model_id,
    shard_of,
)
from pio_tpu_torch.serving_fleet.router import RouterConfig
from pio_tpu_torch.serving_fleet.shard import (
    ShardConfig,
    ShardMemoryBudgetExceeded,
    _prepare_arm,
    create_shard_server,
)
from pio_tpu_torch.workflow.context import create_workflow_context
from pio_tpu_torch.workflow.serve import QueryServer, ServingConfig
from pio_tpu_torch.workflow.train import persist_models, run_train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FACTORY = "pio_tpu_torch.models.recommendation.RecommendationEngine"
REF_FACTORY = "pio_tpu.models.recommendation.RecommendationEngine"
T0 = datetime(2026, 1, 1, tzinfo=timezone.utc)
N_USERS = 20
MEM_ENV = {
    "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
    "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
    "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
    "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM",
}
# the JAX package's scores on the same factors: the same f32 dots summed
# in another order
RTOL = 1e-5
ATOL = 1e-5
SEEDED_USERS, SEEDED_ITEMS, SEEDED_RANK = 300, 400, 8
# each test of the fleet's files is failed past this many seconds (the
# longest takes about 10 s alone)
TEST_LIMIT_S = 120
QUERIES = [
    {"user": "u0", "num": 4},
    {"user": "u3", "num": 6, "blackList": ["i1", "i5"]},
    {"user": "u5", "num": 3, "whiteList": ["i2", "i7", "i9", "nope"]},
    {"user": "u5", "num": 2, "whiteList": ["i2", "i7", "i9"],
     "blackList": ["i7"]},
    {"user": "ghost", "num": 4},
    {"user": "u7", "num": 50},   # over-fetch past n_items
]


@pytest.fixture()
def time_limit():
    """A limit of TEST_LIMIT_S seconds on the test: a server or an RPC
    that hangs fails it, instead of holding the run."""
    def expire(signum, frame):
        raise TimeoutError(f"over the test's {TEST_LIMIT_S} s limit")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.alarm(TEST_LIMIT_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, previous)


pytestmark = pytest.mark.usefixtures("time_limit")


def sqlite_env(path) -> dict:
    return {
        "PIO_STORAGE_SOURCES_SQL_TYPE": "sqlite",
        "PIO_STORAGE_SOURCES_SQL_PATH": str(path),
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "SQL",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "SQL",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "SQL",
    }


def _variant(n_iter: int = 4) -> dict:
    return {"id": "rec", "engineFactory": FACTORY,
            "datasource": {"params": {"app_name": "mlapp"}},
            "algorithms": [{"name": "als", "params": {
                "rank": 4, "num_iterations": n_iter, "lambda_": 0.05,
                "chunk": 1024}}]}


def seed_and_train(storage, n_iter=4, engine_id="rec"):
    """The reference tests' events (20 users x 12 items, two tastes)
    trained by the port on the CPU: -> (engine, ep, ctx, instance id)."""
    app_id = storage.get_metadata_apps().insert(App(0, "mlapp"))
    ev = storage.get_events()
    ev.init(app_id)
    rng = np.random.default_rng(0)
    m = 0
    for u in range(N_USERS):
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
    ep = engine.engine_params_from_variant(_variant(n_iter))
    ctx = create_workflow_context(storage, device="cpu")
    iid = run_train(engine, ep, storage, engine_id=engine_id,
                    engine_factory=FACTORY, ctx=ctx)
    return engine, ep, ctx, iid


def retrain(storage, engine, ep, ctx, engine_id="rec"):
    return run_train(engine, ep, storage, engine_id=engine_id,
                     engine_factory=FACTORY, ctx=ctx)


def call(port, method, path, body=None, **params):
    qs = urllib.parse.urlencode(params)
    url = f"http://127.0.0.1:{port}{path}" + (f"?{qs}" if qs else "")
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode() or "{}")


def oracle(storage, engine, ep, ctx, instance_id=None) -> QueryServer:
    """The port's single-host deploy of one instance, in process."""
    return QueryServer(engine, ep, storage,
                       ServingConfig(ip="127.0.0.1", port=0,
                                     engine_id="rec"),
                       ctx=ctx, instance_id=instance_id)


def answer(qs, q) -> dict:
    """A single-host answer as its JSON body carries it."""
    return json.loads(json.dumps(qs.query(dict(q), record=False)))


def cpu_fleet(storage, n_shards=2, n_replicas=2, **kw):
    """``deploy_fleet`` on the CPU with the drills' quick breakers."""
    return deploy_fleet(
        storage, engine_id="rec", n_shards=n_shards, n_replicas=n_replicas,
        router_config=RouterConfig(
            breaker_min_calls=2, breaker_open_s=0.5, probe_interval_s=0.2),
        device="cpu", **kw)


@pytest.fixture()
def trained(tmp_path, monkeypatch):
    monkeypatch.setenv("PIO_TPU_CKPT_ROOT", str(tmp_path / "ckpt"))
    storage = Storage(env=MEM_ENV, test=True)
    engine, ep, ctx, iid = seed_and_train(storage)
    yield storage, engine, ep, ctx, iid
    storage.close()


# -- seeded factors in both packages ------------------------------------------

def _seeded_factors():
    rng = np.random.default_rng(31)
    uf = rng.standard_normal((SEEDED_USERS, SEEDED_RANK)).astype(np.float32)
    itf = mixture_rows(SEEDED_ITEMS, SEEDED_RANK, 16, rng)
    users = [f"u{i}" for i in range(SEEDED_USERS)]
    items = [f"i{i}" for i in range(SEEDED_ITEMS)]
    return uf, itf, users, items


def _ref_model(uf, itf, users, items):
    return ref_rec.RecommendationModel(
        ref_als.ALSModel(jnp.asarray(uf), jnp.asarray(itf)),
        RefIdIndex(users), RefIdIndex(items))


@pytest.fixture(scope="module")
def seeded():
    """The seeded factors persisted as one instance in a memory store of
    each package, and the port's single-host deploy of it."""
    uf, itf, users, items = _seeded_factors()
    storage = Storage(env=MEM_ENV, test=True)
    engine = port_rec.RecommendationEngine.apply()
    ep = engine.engine_params_from_variant(
        {"id": "rec", "engineFactory": FACTORY,
         "algorithms": [{"name": "als", "params": {"rank": SEEDED_RANK}}]})
    iid = persist_models([recommendation_model_from_numpy(
        uf, itf, users, items, device="cpu")], ep, storage, "rec",
        engine_factory=FACTORY)
    ctx = create_workflow_context(storage, device="cpu")
    ref_store = RefStorage(env=MEM_ENV, test=True)
    ref_iid = ref_store.get_metadata_engine_instances().insert(
        RefEngineInstance(
            id="", status="COMPLETED", start_time=T0, end_time=T0,
            engine_id="rec", engine_version="1", engine_variant="default",
            engine_factory=REF_FACTORY))
    ref_store.get_model_data_models().insert(RefModel(
        ref_iid, ref_models_to_bytes([_ref_model(uf, itf, users, items)])))
    solo = oracle(storage, engine, ep, ctx, iid)
    yield storage, ref_store, solo
    solo.close()
    storage.close()
    ref_store.close()


SEEDED_QUERIES = [
    {"user": "u0", "num": 10},
    {"user": "u17", "num": 5, "blackList": ["i1", "i5", "i12"]},
    {"user": "u23", "num": 4,
     "whiteList": ["i2", "i70", "i91", "i333", "nope"]},
    {"user": "u42", "num": 3, "whiteList": ["i2", "i70", "i91"],
     "blackList": ["i70"]},
    {"user": "ghost", "num": 4},
    {"user": "u99", "num": 500},    # over-fetch past the catalog
] + [{"user": f"u{u}", "num": 10} for u in range(100, 300, 20)]


def _flags(body: dict) -> dict:
    """A body's keys beside its scores, each fleet's shard URLs masked."""
    return {k: re.sub(r"http://127\.0\.0\.1:\d+", "URL", str(v))
            for k, v in body.items() if k != "itemScores"}


def assert_matches_reference(got: dict, want: dict, what) -> None:
    """The port's body against the reference's: ids and flags exact,
    scores within RTOL/ATOL."""
    assert [s["item"] for s in got["itemScores"]] == \
        [s["item"] for s in want["itemScores"]], what
    np.testing.assert_allclose(
        [s["score"] for s in got["itemScores"]],
        [s["score"] for s in want["itemScores"]], rtol=RTOL, atol=ATOL,
        err_msg=str(what))
    assert _flags(got) == _flags(want), what
    assert [s.get("fallback") for s in got["itemScores"]] == \
        [s.get("fallback") for s in want["itemScores"]], what


# -- plan and blobs -----------------------------------------------------------

@pytest.mark.parametrize("n_shards", [1, 2, 3])
def test_plan_and_partition_blobs_equal_the_reference(n_shards):
    """The plan blob of one model is the reference's byte for byte. Each
    partition blob pickles its class, so the two name other modules; the
    reference's partition, field for field in the port's class, makes the
    port's blob byte for byte. The port's model holds its factors as
    tensors; the blobs come from their host bytes."""
    uf, itf, users, items = _seeded_factors()
    port_model = recommendation_model_from_numpy(uf, itf, users, items,
                                                 device="cpu")
    assert isinstance(port_model.factors.user_factors, torch.Tensor)
    port_store = Storage(env=MEM_ENV, test=True)
    ref_store = RefStorage(env=MEM_ENV, test=True)
    try:
        from pio_tpu.serving_fleet.plan import (
            partition_from_bytes as ref_partition_from_bytes,
        )
        from pio_tpu.serving_fleet.plan import (
            persist_fleet_artifacts as ref_persist,
        )

        plan = persist_fleet_artifacts(port_store, "inst-1", port_model,
                                       n_shards, 2)
        ref_plan = ref_persist(ref_store, "inst-1",
                               _ref_model(uf, itf, users, items),
                               n_shards, 2)
        assert plan.to_json() == ref_plan.to_json()
        port_models = port_store.get_model_data_models()
        ref_models = ref_store.get_model_data_models()
        assert port_models.get("inst-1:shardplan").models == \
            ref_models.get("inst-1:shardplan").models
        for s in range(n_shards):
            mid = shard_model_id("inst-1", s)
            port_blob = port_models.get(mid).models
            ref_part = ref_partition_from_bytes(ref_models.get(mid).models)
            fields = {f.name: getattr(ref_part, f.name)
                      for f in dataclasses.fields(ShardPartition)}
            assert partition_to_bytes(ShardPartition(**fields)) == port_blob
            part = partition_from_bytes(port_blob)
            for name, value in fields.items():
                got = getattr(part, name)
                if isinstance(value, np.ndarray):
                    assert got.dtype == value.dtype, name
                    assert got.tobytes() == value.tobytes(), name
                else:
                    assert got == value, name
    finally:
        port_store.close()
        ref_store.close()


def test_shard_plan_deterministic(trained):
    storage, engine, ep, ctx, iid = trained
    _, model = resolve_fleet_model(storage, "rec")
    p1 = build_plan(model, iid, n_shards=3, n_replicas=2)
    p2 = build_plan(model, iid, n_shards=3, n_replicas=2)
    assert p1 == p2
    assert p1.plan_hash == p2.plan_hash
    assert ShardPlan.from_json(p1.to_json()) == p1
    assert build_plan(model, iid, 2, 2).plan_hash != p1.plan_hash
    for u in ("u0", "u7", "anyone"):
        assert shard_of(u, 3) == shard_of(u, 3)
        assert 0 <= shard_of(u, 3) < 3


def test_partitions_cover_model_disjointly(trained):
    storage, *_, iid = trained
    _, model = resolve_fleet_model(storage, "rec")
    parts = partition_model(model, iid, 3)
    users = [u for p in parts for u in p.user_ids]
    items = [i for p in parts for i in p.item_ids]
    assert sorted(users) == sorted(model.users.ids())
    assert sorted(items) == sorted(model.items.ids())
    assert len(set(users)) == len(users) and len(set(items)) == len(items)
    full = np.asarray(model.factors.item_factors)
    for p in parts:
        assert all(shard_of(u, 3) == p.shard_index for u in p.user_ids)
        assert all(shard_of(i, 3) == p.shard_index for i in p.item_ids)
        np.testing.assert_array_equal(p.item_rows, full[p.item_gidx])


def test_memory_budget_enforced(trained):
    storage, *_, iid = trained
    _, model = resolve_fleet_model(storage, "rec")
    persist_fleet_artifacts(storage, iid, model, 2, 1)
    part = load_partition(storage, iid, 0)
    with pytest.raises(ShardMemoryBudgetExceeded, match="more shards"):
        create_shard_server(storage, ShardConfig(
            shard_index=0, n_shards=2, engine_id="rec", instance_id=iid,
            memory_budget_bytes=part.nbytes() - 1, device="cpu"))


# -- the fleet against the single-host deploy and the reference fleet --------

def test_fleet_bit_identical_to_single_host_under_memory_cap(trained):
    """A model over one shard's memory budget serves across 2 shards,
    and every answer is the port's single-host deploy's bit for bit,
    solo and through the batch route."""
    storage, engine, ep, ctx, iid = trained
    _, model = resolve_fleet_model(storage, "rec")
    total = model_nbytes(model)
    budget = int(total * 0.75)
    handle = deploy_fleet(storage, engine_id="rec", n_shards=2,
                          n_replicas=1, memory_budget_bytes=budget,
                          device="cpu")
    qs = oracle(storage, engine, ep, ctx, iid)
    try:
        for _http, srv in handle.shards:
            assert srv.partition.nbytes() <= budget
            assert srv.device.type == "cpu"
            assert srv.partition.nbytes() < total
        for q in QUERIES:
            status, out = call(handle.router_http.port, "POST",
                               "/queries.json", body=dict(q))
            assert status == 200, (q, out)
            assert out == answer(qs, q), q
        status, batch = call(handle.router_http.port, "POST",
                             "/batch/queries.json",
                             body=[dict(q) for q in QUERIES])
        assert status == 200
        assert batch == [answer(qs, q) for q in QUERIES]
    finally:
        handle.close()
        qs.close()


MODES = {
    "exact": None,
    # every probed candidate survives the re-rank, so the two packages'
    # candidate sets cannot part over a near-tie of quantized scores
    "clustered": {"mode": "clustered", "dtype": "int8", "n_clusters": 8,
                  "nprobe": 3, "rerank_k": 1024, "impl": "pallas"},
    "exhaustive": {"mode": "clustered", "dtype": "int8", "n_clusters": 8,
                   "nprobe": 8, "rerank_k": 64, "impl": "pallas"},
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_fleet_matches_the_reference_fleet(seeded, mode):
    """2 shards x 2 replicas of each package on the same seeded model:
    every answer's ids are the reference fleet's and its scores within
    RTOL/ATOL; in exact and exhaustive mode each body is also the port's
    single-host deploy's bit for bit."""
    storage, ref_store, solo = seeded
    retrieval = MODES[mode]
    handle = deploy_fleet(storage, engine_id="rec", n_shards=2,
                          n_replicas=2, retrieval=retrieval, device="cpu")
    ref_retrieval = None if retrieval is None else {
        k: v for k, v in retrieval.items() if k != "impl"}
    ref = ref_deploy_fleet(ref_store, engine_id="rec", n_shards=2,
                           n_replicas=2, retrieval=ref_retrieval)
    try:
        for q in SEEDED_QUERIES:
            status, got = call(handle.router_http.port, "POST",
                               "/queries.json", body=dict(q))
            assert status == 200, (q, got)
            rstatus, want = call(ref.router_http.port, "POST",
                                 "/queries.json", body=dict(q))
            assert rstatus == 200
            assert_matches_reference(got, want, q)
            if mode != "clustered":
                assert got == answer(solo, q), q
        if mode == "clustered":
            # the candidate tier answered: an answer that is not the
            # exact one shows the scan ran
            exact = [answer(solo, q) for q in SEEDED_QUERIES[:2]]
            fleet = [call(handle.router_http.port, "POST", "/queries.json",
                          body=dict(q))[1] for q in SEEDED_QUERIES[:2]]
            assert all(len(f["itemScores"]) == len(e["itemScores"])
                       for f, e in zip(fleet, exact))
            _, m = call(handle.shards[0][0].port, "GET", "/metrics.json")
            assert m["scoringDispatches"]["scan"] > 1
    finally:
        handle.close()
        ref.close()


def test_degraded_answers_match_the_reference(seeded):
    """One shard group down in both packages' fleets: each answer is
    200, flagged degraded with the same reason, and blends the same
    popularity fallback as the reference's."""
    storage, ref_store, _solo = seeded
    handle = deploy_fleet(storage, engine_id="rec", n_shards=2,
                          n_replicas=1, device="cpu")
    ref = ref_deploy_fleet(ref_store, engine_id="rec", n_shards=2,
                           n_replicas=1)
    try:
        handle.shards[1][0].stop()
        ref.shards[1][0].stop()
        qs = [{"user": f"u{u}", "num": 8} for u in range(12)] + [
            {"user": "u3", "num": 5, "blackList": ["i1", "i2"]},
            {"user": "u4", "num": 3, "whiteList": ["i1", "i2", "i3"]}]
        degraded = 0
        for q in qs:
            status, got = call(handle.router_http.port, "POST",
                               "/queries.json", body=dict(q))
            rstatus, want = call(ref.router_http.port, "POST",
                                 "/queries.json", body=dict(q))
            assert status == rstatus == 200, (q, got)
            assert_matches_reference(got, want, q)
            degraded += bool(got.get("degraded"))
        assert degraded >= len(qs) - 1
    finally:
        handle.close()
        ref.close()


# -- failover / degradation ---------------------------------------------------

def test_replica_failover_serves_through_replica_loss(trained):
    storage, *_ = trained
    handle = cpu_fleet(storage)
    try:
        handle.shards[0][0].stop()
        out = [call(handle.router_http.port, "POST", "/queries.json",
                    body={"user": f"u{u}", "num": 3}) for u in range(10)]
        assert all(status == 200 for status, _ in out), out
        assert not any(body.get("degraded") for _, body in out)
        assert all(body["itemScores"] for _, body in out)
        _, fs = call(handle.router_http.port, "GET", "/fleet.json")
        assert fs["reroutedCalls"] >= 1
        status, _ = call(handle.router_http.port, "GET", "/readyz")
        assert status == 200
    finally:
        handle.close()


def test_kill_one_shard_drill_degrades_then_recovers(trained):
    """Both replicas of one shard killed under load: no 5xx, degraded
    answers during the outage, full service once it rejoins."""
    storage, *_ = trained
    handle = cpu_fleet(storage)
    port = handle.router_http.port
    statuses: list[tuple[int, bool]] = []
    lock = threading.Lock()
    stop = threading.Event()

    def hammer(w):
        while not stop.is_set():
            s, body = call(port, "POST", "/queries.json",
                           body={"user": f"u{w}", "num": 3})
            with lock:
                statuses.append((s, bool(body.get("degraded"))))

    threads = [threading.Thread(target=hammer, args=(w,)) for w in range(4)]
    try:
        for t in threads:
            t.start()
        time.sleep(0.3)
        for http, _srv in handle.shards[:2]:
            http.stop()
        time.sleep(1.5)
        with lock:
            during = list(statuses)
        old_port = int(handle.endpoints[0][0].rsplit(":", 1)[1])
        http2, _srv2 = create_shard_server(storage, ShardConfig(
            ip="127.0.0.1", port=old_port, shard_index=0, n_shards=2,
            engine_id="rec", device="cpu"))
        http2.start()
        try:
            deadline = time.monotonic() + 10
            recovered = False
            while time.monotonic() < deadline and not recovered:
                s, body = call(port, "POST", "/queries.json",
                               body={"user": "u2", "num": 3})
                recovered = s == 200 and not body.get("degraded")
                time.sleep(0.1)
            stop.set()
            for t in threads:
                t.join(timeout=30)
            assert not any(t.is_alive() for t in threads)
            assert all(s < 500 for s, _ in statuses), \
                [s for s, _ in statuses if s >= 500][:5]
            assert any(d for _, d in during), "no degraded response seen"
            assert recovered, "fleet never returned to full service"
            with lock:
                tail = statuses[-3:]
            assert not any(d for _, d in tail), tail
        finally:
            http2.stop()
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=5)
        handle.close()


def test_chaos_point_per_shard_drives_degrade_path(trained):
    storage, *_ = trained
    handle = cpu_fleet(storage, n_replicas=1)
    try:
        port = handle.router_http.port
        with chaos.inject("fleet.shard1", error=1.0, seed=7) as monkey:
            s, body = call(port, "POST", "/queries.json",
                           body={"user": "u2", "num": 3})
            assert s == 200 and body["degraded"] is True
            assert "shard group(s) [1]" in body["degradedReason"]
            assert any(p.startswith("fleet.shard1.")
                       for p in monkey.injected)
        s, body = call(port, "POST", "/queries.json",
                       body={"user": "u2", "num": 3})
        assert s == 200 and not body.get("degraded")
    finally:
        handle.close()


def test_whitelist_ignores_down_nonowner_shard(trained):
    storage, engine, ep, ctx, iid = trained
    handle = cpu_fleet(storage, n_replicas=1)
    qs = oracle(storage, engine, ep, ctx, iid)
    try:
        live, dead = 0, 1
        users = [f"u{u}" for u in range(N_USERS)
                 if shard_of(f"u{u}", 2) == live]
        items = [f"i{i}" for i in range(12) if shard_of(f"i{i}", 2) == live]
        assert users and len(items) >= 2
        handle.shards[dead][0].stop()
        q = {"user": users[0], "num": 2, "whiteList": items[:3]}
        s, body = call(handle.router_http.port, "POST", "/queries.json",
                       body=dict(q))
        assert s == 200
        assert "degraded" not in body, body
        assert body == answer(qs, q)
    finally:
        handle.close()
        qs.close()


def test_degraded_fallback_when_owner_shard_down(trained):
    storage, *_ = trained
    handle = cpu_fleet(storage, n_replicas=1)
    try:
        owner = shard_of("u0", 2)
        handle.shards[owner][0].stop()
        s, body = call(handle.router_http.port, "POST", "/queries.json",
                       body={"user": "u0", "num": 3})
        assert s == 200 and body["degraded"] is True
        assert body["itemScores"]
        assert all(x.get("fallback") for x in body["itemScores"])
        for _ in range(3):
            call(handle.router_http.port, "POST", "/queries.json",
                 body={"user": "u0", "num": 3})
        status, ready = call(handle.router_http.port, "GET", "/readyz")
        assert status == 503 and not ready["ready"]
    finally:
        handle.close()


# -- last-good partition fallback and reload ----------------------------------

def test_corrupt_partition_falls_back_to_previous_instance(trained):
    storage, engine, ep, ctx, iid1 = trained
    _, model1 = resolve_fleet_model(storage, "rec", instance_id=iid1)
    persist_fleet_artifacts(storage, iid1, model1, 2, 1)
    iid2 = retrain(storage, engine, ep, ctx)
    _, model2 = resolve_fleet_model(storage, "rec", instance_id=iid2)
    persist_fleet_artifacts(storage, iid2, model2, 2, 1)
    models_dao = storage.get_model_data_models()
    blob = bytearray(models_dao.get(shard_model_id(iid2, 0)).models)
    blob[-1] ^= 0xFF
    models_dao.insert(Model(shard_model_id(iid2, 0), bytes(blob)))

    handle = cpu_fleet(storage, n_replicas=1, repartition=False)
    try:
        served = {srv.config.shard_index: srv.partition.instance_id
                  for _http, srv in handle.shards}
        assert served[0] == iid1
        assert served[1] == iid2
        s, body = call(handle.router_http.port, "POST", "/queries.json",
                       body={"user": "u0", "num": 3})
        assert s == 200 and body["itemScores"]
        deadline = time.monotonic() + 10
        skew = False
        while time.monotonic() < deadline and not skew:
            s, fs = call(handle.router_http.port, "GET", "/fleet.json")
            skew = fs["instanceSkew"]
            time.sleep(0.1)
        assert skew, fs
    finally:
        handle.close()


def test_fleet_reload_moves_to_new_partitioned_instance(trained):
    storage, engine, ep, ctx, iid1 = trained
    handle = cpu_fleet(storage, n_replicas=1)
    try:
        iid2 = retrain(storage, engine, ep, ctx)
        _, model2 = resolve_fleet_model(storage, "rec", instance_id=iid2)
        persist_fleet_artifacts(storage, iid2, model2, 2, 1)
        s, out = call(handle.router_http.port, "GET", "/reload")
        assert s == 200
        assert out["planInstanceId"] == iid2
        assert all(r["ok"] and r["engineInstanceId"] == iid2
                   for r in out["replicas"].values()), out
        qs = oracle(storage, engine, ep, ctx, iid2)
        try:
            for q in QUERIES:
                s, body = call(handle.router_http.port, "POST",
                               "/queries.json", body=dict(q))
                assert s == 200 and body == answer(qs, q), q
        finally:
            qs.close()
    finally:
        handle.close()


# -- the clustered route: the scan kernel's wrapper, the sidecar, budgets ----

def test_clustered_fleet_serves_and_item_upsert_retrievable(trained):
    storage, engine, ep, ctx, iid = trained
    _, model = resolve_fleet_model(storage, "rec")
    handle = deploy_fleet(
        storage, engine_id="rec", n_shards=2, n_replicas=1, device="cpu",
        retrieval={"mode": "clustered", "dtype": "int8",
                   "nprobe": 1, "rerank_k": 8, "impl": "pallas"})
    try:
        status, out = call(handle.router_http.port, "POST",
                           "/queries.json", body={"user": "u0", "num": 3})
        assert status == 200 and out["itemScores"]
        sport = handle.shards[0][0].port
        status, info = call(sport, "GET", "/shard/info")
        assert status == 200
        r = info["retrieval"]
        assert (r["mode"], r["dtype"], r["nprobe"]) == ("clustered",
                                                        "int8", 1)
        assert r["quantizedBytes"] > 0 and r["f32ItemBytes"] > 0
        urow = np.asarray(model.factors.user_factors)[
            model.users.index_of("u0")]
        status, cand = call(sport, "POST", "/shard/candidates",
                            body={"row": [float(x) for x in urow], "k": 2})
        assert status == 200 and cand["items"]
        assert len(cand["items"]) == len(cand["scores"])
        status, out = call(
            handle.router_http.port, "POST", "/fleet/upsert_users",
            body={"items": {"i7": [float(10.0 * x) for x in urow],
                            "zzz": [0.0, 0.0, 0.0, 0.0]}})
        assert status == 200, out
        assert out["itemsApplied"] == 1
        assert out["itemsFailed"] == ["zzz"]
        # the owner re-encoded the scan table beside its device slice
        owner = shard_of("i7", 2)
        srv = handle.shards[owner][1]
        at = srv._item_local_of["i7"]
        assert torch.equal(srv._item_factors_dev[at],
                           torch.tensor(10.0 * urow, dtype=torch.float32))
        data, scales = retrieval.encode_rows(
            (10.0 * urow)[None, :].astype(np.float32), "int8")
        idx = srv._retrieval[0]
        np.testing.assert_array_equal(idx.table.data[at], data[0])
        np.testing.assert_array_equal(idx.table.scales[at], scales[0])
        status, out = call(handle.router_http.port, "POST",
                           "/queries.json", body={"user": "u0", "num": 1})
        assert status == 200
        assert out["itemScores"][0]["item"] == "i7", out
    finally:
        handle.close()


def test_clustered_exhaustive_fleet_bit_identical_to_single_host(trained):
    storage, engine, ep, ctx, iid = trained
    qs = oracle(storage, engine, ep, ctx, iid)
    handle = deploy_fleet(
        storage, engine_id="rec", n_shards=2, n_replicas=1, device="cpu",
        retrieval={"mode": "clustered", "dtype": "int8",
                   "nprobe": 32, "rerank_k": 64})
    try:
        for q in QUERIES:
            status, out = call(handle.router_http.port, "POST",
                               "/queries.json", body=dict(q))
            assert status == 200, (q, out)
            assert out == answer(qs, q), q
    finally:
        handle.close()
        qs.close()
    with pytest.raises(ValueError, match="unknown retrieval config"):
        deploy_fleet(storage, engine_id="rec", n_shards=1, n_replicas=1,
                     retrieval={"nprobes": 4}, device="cpu")


def test_shard_budget_charges_retrieval_sidecar(trained):
    storage, *_, iid = trained
    persist_fleet_artifacts(
        storage, iid, resolve_fleet_model(storage, "rec")[1], 1, 1)
    part = load_partition(storage, iid, 0)
    block = {"mode": "clustered", "dtype": "int8", "nprobe": 1,
             "rerank_k": 8}
    with pytest.raises(ShardMemoryBudgetExceeded, match="sidecar"):
        create_shard_server(storage, ShardConfig(
            shard_index=0, n_shards=1, engine_id="rec", instance_id=iid,
            memory_budget_bytes=part.nbytes(), retrieval=block,
            device="cpu"))
    _http, srv = create_shard_server(storage, ShardConfig(
        shard_index=0, n_shards=1, engine_id="rec", instance_id=iid,
        memory_budget_bytes=part.nbytes(), device="cpu"))
    assert srv.partition is not None
    _http2, srv2 = create_shard_server(storage, ShardConfig(
        shard_index=0, n_shards=1, engine_id="rec", instance_id=iid,
        retrieval=block, device="cpu"))
    arm = _prepare_arm(srv2.partition, srv2._rparams, srv2.device)
    # the realized bytes: the f32 partition, the host index and what the
    # device layout really holds
    idx, didx = arm.retrieval
    assert didx.nbytes() == sum(t.element_size() * t.numel() for t in (
        didx.centroids, didx.table, didx.scales, didx.gidx))
    srv2.config.memory_budget_bytes = srv2.partition.nbytes() + 1
    with pytest.raises(ShardMemoryBudgetExceeded, match="realized"):
        srv2._enforce_budget_realized(srv2.partition, arm)


def test_scan_dispatches_go_through_the_kernel_wrapper(trained,
                                                       monkeypatch):
    """On a clustered fleet with ``"impl": "pallas"`` every scan
    dispatch of every shard (its warm one included) calls the scan
    kernel's wrapper once — on a CUDA tensor that is one K7 launch; the
    CPU's plain version counts none — and ``/metrics.json`` gives the
    shard's dispatches by route beside the process's kernel launches."""
    storage, *_ = trained
    calls = []
    real = retrieval.quantized_scan

    def counted(*args):
        calls.append(args[0].device.type)
        return real(*args)

    monkeypatch.setattr(retrieval, "quantized_scan", counted)
    handle = deploy_fleet(
        storage, engine_id="rec", n_shards=2, n_replicas=2, device="cpu",
        retrieval={"mode": "clustered", "dtype": "int8", "n_clusters": 4,
                   "nprobe": 1, "rerank_k": 8, "impl": "pallas"})
    try:
        assert len(calls) == 4          # one warm dispatch a shard
        for u in range(N_USERS):
            status, _ = call(handle.router_http.port, "POST",
                             "/queries.json",
                             body={"user": f"u{u}", "num": 3})
            assert status == 200
        scans = exact = 0
        for http, _srv in handle.shards:
            _, m = call(http.port, "GET", "/metrics.json")
            scans += m["scoringDispatches"]["scan"]
            exact += m["scoringDispatches"]["exact"]
            assert m["device"] == "cpu"
            assert m["kernelLaunches"]["quantized_scan"] == 0   # plain
        assert scans == len(calls) and exact == 0
        assert scans >= 4 + N_USERS      # every shard group, every query
        assert set(calls) == {"cpu"}
    finally:
        handle.close()


@pytest.mark.parametrize("width", [1, 7, 100, 333])
def test_a_narrow_slice_scores_its_items_as_the_whole_table(width):
    """A shard's exact route scores each of its items with the bits the
    whole table gives it, however few items the shard holds: the
    product runs at ``MIN_SCORING_COLUMNS`` columns at least (a one-
    column product takes another kernel on the CPU, as narrow ones do
    on an H100)."""
    rng = np.random.default_rng(5)
    uf = torch.tensor(rng.standard_normal((64, 8)), dtype=torch.float32)
    itf = torch.tensor(rng.standard_normal((2000, 8)), dtype=torch.float32)
    cols = np.sort(rng.choice(2000, width, replace=False))
    users = np.arange(3)
    full_s, full_i = als.recommend_topk(als.ALSModel(uf, itf), users, 2000)
    sub_s, sub_i = als.recommend_topk(
        als.ALSModel(uf, itf[torch.from_numpy(cols)]), users, width)
    for b in range(3):
        by_item = dict(zip(full_i[b].tolist(), full_s[b].tolist()))
        got = dict(zip(cols[sub_i[b].numpy()].tolist(), sub_s[b].tolist()))
        assert got == {c: by_item[c] for c in got}
        assert len(got) == width


# -- the device and the deploy verb -------------------------------------------

def test_fleet_without_cuda_raises_unless_cpu_is_asked(trained,
                                                       monkeypatch):
    storage, *_, iid = trained
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    persist_fleet_artifacts(
        storage, iid, resolve_fleet_model(storage, "rec")[1], 2, 1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_shard_server(storage, ShardConfig(
            shard_index=0, n_shards=2, engine_id="rec", instance_id=iid))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        deploy_fleet(storage, engine_id="rec", n_shards=2, n_replicas=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fleet_main.main(["shard", "--shard-index", "0", "--n-shards", "2",
                         "--engine-id", "rec", "--instance-id", iid])
    _http, srv = create_shard_server(storage, ShardConfig(
        shard_index=0, n_shards=2, engine_id="rec", instance_id=iid,
        device="cpu"))
    assert srv.device.type == "cpu"
    assert srv._item_factors_dev.device.type == "cpu"


def _engine_dir(root) -> str:
    d = root / "engine"
    d.mkdir()
    (d / "engine.json").write_text(json.dumps(_variant()))
    return str(d)


@pytest.mark.parametrize("argv,message", [
    (["--cert", "c.pem", "--key", "k.pem"], "TLS termination"),
    (["--feedback"], "--feedback not supported in fleet"),
    (["--warm-query", '{"user": "u1"}'], "--warm-query not supported"),
    (["--batch-window-ms", "2"], "--batch-window-ms not supported"),
    (["--replicas", "0"], "--replicas must be >= 1"),
    (["--from-eval", "latest"], "--from-eval is not supported with"),
])
def test_deploy_verb_refuses_single_host_options_in_fleet_mode(
        tmp_path, monkeypatch, capsys, argv, message):
    storage = Storage(env=sqlite_env(tmp_path / "pio.db"))
    monkeypatch.setattr("pio_tpu_torch.__main__.get_storage",
                        lambda: storage)
    try:
        rc = port_main(["deploy", "--engine-dir", _engine_dir(tmp_path),
                        "--shards", "2", "--device", "cpu", *argv])
    finally:
        storage.close()
    assert rc == 1
    assert message in capsys.readouterr().err


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait_ready(port: int, timeout=60):
    deadline = time.monotonic() + timeout
    # pio: lint-ok[bare-retry] test poll waiting for a freshly
    # spawned server process to bind and report ready
    while time.monotonic() < deadline:
        try:
            s, _ = call(port, "GET", "/readyz")
            if s == 200:
                return
        except OSError:
            pass
        time.sleep(0.2)
    raise AssertionError(f"server on port {port} never became ready")


def test_deploy_verb_boots_the_fleet_and_undeploy_stops_it(tmp_path):
    """``python -m pio_tpu_torch deploy --shards 2 --replicas 1 --device
    cpu`` as a process: its router answers the in-process single-host
    deploy's bodies; ``undeploy`` stops it; without --device the verb
    raises (no CUDA here)."""
    env_map = sqlite_env(tmp_path / "pio.db")
    storage = Storage(env=env_map)
    try:
        engine, ep, ctx, iid = seed_and_train(storage)
        qs = oracle(storage, engine, ep, ctx, iid)
        want = [answer(qs, q) for q in QUERIES]
        qs.close()
    finally:
        storage.close()
    engine_dir = _engine_dir(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"} | {
        "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu", **env_map}
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "pio_tpu_torch", "deploy", "--engine-dir",
         engine_dir, "--shards", "2", "--replicas", "1", "--port",
         str(port), "--ip", "127.0.0.1", "--device", "cpu",
         "--server-key", "SK"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        _wait_ready(port)
        for q, w in zip(QUERIES, want):
            status, got = call(port, "POST", "/queries.json", body=dict(q))
            assert status == 200 and got == w, q
        out = subprocess.run(
            [sys.executable, "-m", "pio_tpu_torch", "undeploy", "--port",
             str(port), "--server-key", "SK"],
            env=env, capture_output=True, text=True, timeout=60)
        assert out.returncode == 0, out.stderr
        text, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0, text
        assert f"Fleet router for instance {iid}" in text
        assert "2 shards x 1 replicas, retrieval: exact, cpu" in text
        assert "Fleet stopped." in text
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
    out = subprocess.run(
        [sys.executable, "-m", "pio_tpu_torch", "deploy", "--engine-dir",
         engine_dir, "--shards", "2", "--port", "0"],
        env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr


@pytest.mark.parametrize("impl", ["pallas", "auto"])
def test_shard_process_takes_the_retrieval_impl(tmp_path, impl):
    """``python -m pio_tpu_torch.serving_fleet shard --retrieval-mode
    clustered --retrieval-impl pallas --device cpu``: the process scans
    through the kernel's wrapper (its CPU plain version here, no launch
    counted), reports the impl it was given, and answers each
    ``/shard/candidates`` as an in-process shard built with the same
    block does; without the flag the scan is ``auto``'s."""
    env_map = sqlite_env(tmp_path / "fleet.db")
    storage = Storage(env=env_map)
    # nprobe 1 of a shard's 2 clusters: the scan, not the exact route
    block = {"mode": "clustered", "dtype": "int8", "nprobe": 1,
             "rerank_k": 16, "impl": impl}
    try:
        _engine, _ep, _ctx, iid = seed_and_train(storage)
        _, model = resolve_fleet_model(storage, "rec")
        persist_fleet_artifacts(storage, iid, model, 2, 1)
        http, srv = create_shard_server(storage, ShardConfig(
            ip="127.0.0.1", port=0, shard_index=0, n_shards=2,
            engine_id="rec", instance_id=iid, retrieval=block,
            device="cpu"))
        http.start()
        rows = [list(map(float, model.factors.user_factors[u].tolist()))
                for u in range(4)]
        want = [call(http.port, "POST", "/shard/candidates",
                     body={"row": r, "k": 5}) for r in rows]
        http.stop()
    finally:
        storage.close()
    proc_env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"} \
        | {"PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu", **env_map}
    port = _free_port()
    flag = ["--retrieval-impl", impl] if impl != "auto" else []
    proc = subprocess.Popen(
        [sys.executable, "-m", "pio_tpu_torch.serving_fleet", "shard",
         "--shard-index", "0", "--n-shards", "2", "--engine-id", "rec",
         "--instance-id", iid, "--port", str(port), "--device", "cpu",
         "--retrieval-mode", "clustered", "--retrieval-nprobe", "1",
         "--retrieval-rerank-k", "16", *flag],
        env=proc_env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        _wait_ready(port)
        _, info = call(port, "GET", "/shard/info")
        assert info["retrieval"]["mode"] == "clustered"
        assert info["retrieval"]["impl"] == impl
        _, before = call(port, "GET", "/metrics.json")
        got = [call(port, "POST", "/shard/candidates",
                    body={"row": r, "k": 5}) for r in rows]
        _, after = call(port, "GET", "/metrics.json")
        assert got == want
        assert all(s == 200 and out["items"] for s, out in got)
        assert (after["scoringDispatches"]["scan"]
                - before["scoringDispatches"]["scan"]) == len(rows)
        assert after["kernelLaunches"]["quantized_scan"] == 0   # plain
        assert after["device"] == "cpu"
    finally:
        proc.kill()
        proc.wait(timeout=10)


# -- subprocess drill ---------------------------------------------------------

@pytest.mark.slow
def test_subprocess_fleet_chaos_drill(tmp_path):
    """2 shards x 2 replicas as processes (``python -m
    pio_tpu_torch.serving_fleet shard --device cpu``) over one sqlite
    store: SIGKILL both replicas of shard 1 under load -> no 5xx,
    degraded answers; restart one -> full service."""
    from pio_tpu_torch.serving_fleet.router import create_fleet_router

    env_map = sqlite_env(tmp_path / "fleet.db")
    storage = Storage(env=env_map)
    try:
        _engine, _ep, _ctx, iid = seed_and_train(storage)
        _, model = resolve_fleet_model(storage, "rec")
        plan = persist_fleet_artifacts(storage, iid, model, 2, 2)
    finally:
        storage.close()
    proc_env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"} \
        | {"PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu", **env_map}

    def spawn(shard_index: int, port: int) -> subprocess.Popen:
        return subprocess.Popen(
            [sys.executable, "-m", "pio_tpu_torch.serving_fleet", "shard",
             "--shard-index", str(shard_index), "--n-shards", "2",
             "--engine-id", "rec", "--instance-id", iid,
             "--port", str(port), "--device", "cpu"],
            env=proc_env, stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL)

    ports = [[_free_port() for _ in range(2)] for _ in range(2)]
    procs = {(s, r): spawn(s, ports[s][r])
             for s in range(2) for r in range(2)}
    handle = None
    stop = threading.Event()
    storage = Storage(env=env_map)
    try:
        for s in range(2):
            for r in range(2):
                _wait_ready(ports[s][r])
        router_http, router = create_fleet_router(
            storage,
            RouterConfig(engine_id="rec", breaker_min_calls=2,
                         breaker_open_s=0.5, probe_interval_s=0.2,
                         device="cpu"),
            plan,
            [[f"http://127.0.0.1:{p}" for p in group] for group in ports])
        router_http.start()
        handle = (router_http, router)
        statuses: list[tuple[int, bool]] = []
        lock = threading.Lock()

        def hammer(w):
            while not stop.is_set():
                st, body = call(router_http.port, "POST", "/queries.json",
                                body={"user": f"u{w}", "num": 3})
                with lock:
                    statuses.append((st, bool(body.get("degraded"))))

        threads = [threading.Thread(target=hammer, args=(w,))
                   for w in range(4)]
        for t in threads:
            t.start()
        time.sleep(0.5)
        for r in range(2):
            procs[(1, r)].kill()
        time.sleep(2.0)
        with lock:
            during = list(statuses)
        assert any(d for _, d in during), "no degraded response during kill"
        procs[(1, 0)] = spawn(1, ports[1][0])
        _wait_ready(ports[1][0])
        deadline = time.monotonic() + 15
        recovered = False
        while time.monotonic() < deadline and not recovered:
            st, body = call(router_http.port, "POST", "/queries.json",
                            body={"user": "u2", "num": 3})
            recovered = st == 200 and not body.get("degraded")
            time.sleep(0.2)
        stop.set()
        for t in threads:
            t.join(timeout=30)
        assert all(st < 500 for st, _ in statuses), \
            [st for st, _ in statuses if st >= 500][:5]
        assert recovered, "fleet never recovered after the shard rejoined"
        st, _ = call(router_http.port, "GET", "/readyz")
        assert st == 200
    finally:
        stop.set()
        if handle is not None:
            handle[0].stop()
            handle[1].close()
        storage.close()
        for p in procs.values():
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p in procs.values():
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
