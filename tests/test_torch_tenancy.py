"""The port's multi-tenant fleet pool (``serving_fleet/tenancy.py``) as
the JAX package's tests hold the reference's, on the CPU, and against
the reference on the same tenants:

  * the packer: disjoint cover under the budget, deterministic, a clean
    error over capacity, an incremental join that never moves
    residents, and the reference's owners on the same seeded sizes;
  * ``FleetPlan``: a round trip, and the plan ``build_fleet_plan`` and
    ``join_fleet_plan`` write byte-equal to the reference's for the same
    tenants, with equal per-tenant ``ShardPlan``s, partition blobs equal
    field for field and ``partition_sizes`` equal for a model whose
    tables are tensors;
  * the pool's bodies byte-equal to the port's single host per tenant
    and equal to the reference pool's (ids exact where score gaps exceed
    1e-5, scores within ``RTOL``/``ATOL``);
  * tenant resolution, the shard's 421, the 409 on ``/reshard/begin``;
  * isolation: a flood sheds only its tenant (429 + Retry-After), a
    tenant-scoped chaos spec and a corrupt blob degrade only their
    tenant; live detach and attach (a co-tenant served through a held
    attach, the detached tenant's device tensors released); the
    ``tenant=`` metrics and the host's ``/metrics.json``; the event
    server's per-app ingest quota;
  * the verbs: ``deploy --fleet-join`` twice, ``deploy --fleet`` as a
    process, queries a tenant, ``undeploy --tenant`` and a live
    re-join, the ``--fleet`` + ``--fleet-join`` refusal and a
    similarproduct engine refused; without CUDA every entry point
    raises unless the CPU is asked for.

The tenants are the reference tests' (20 users x 12 items and 16 x 10,
rank 4), trained by the reference and carried across through
``convert.recommendation_model_from_numpy``.
"""

import _torch_cpu  # noqa: F401  (one CPU thread: see the module)
import dataclasses
import gc
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
import weakref
from datetime import datetime, timezone

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_verbs import copy_example
from test_tenancy import seed_and_train as ref_seed_and_train
from test_torch_fleet import (  # noqa: F401
    ATOL,
    MEM_ENV,
    REPO,
    RTOL,
    _free_port,
    _wait_ready,
    answer,
    sqlite_env,
    time_limit,
)

from pio_tpu.data.bimap import EntityIdIndex as RefIdIndex
from pio_tpu.data.dao import EngineInstance as RefEngineInstance
from pio_tpu.data.dao import Model as RefModel
from pio_tpu.data.storage import Storage as RefStorage
from pio_tpu.models import recommendation as ref_rec
from pio_tpu.ops import als as ref_als
from pio_tpu.serving_fleet import tenancy as ref_tenancy
from pio_tpu.serving_fleet.fleet import (
    resolve_fleet_model as ref_resolve_fleet_model,
)
from pio_tpu.serving_fleet.plan import load_plan as ref_load_plan
from pio_tpu.serving_fleet.plan import (
    partition_from_bytes as ref_partition_from_bytes,
)
from pio_tpu.workflow.checkpoint import models_to_bytes as ref_models_to_bytes
from pio_tpu_torch.__main__ import main as port_main
from pio_tpu_torch.convert import recommendation_model_from_numpy
from pio_tpu_torch.data.dao import AccessKey, App, Model
from pio_tpu_torch.data.storage import Storage
from pio_tpu_torch.models import recommendation as port_rec
from pio_tpu_torch.resilience import chaos
from pio_tpu_torch.serving_fleet import shard as shard_mod
from pio_tpu_torch.serving_fleet import tenancy as port_tenancy
from pio_tpu_torch.serving_fleet.plan import (
    N_PARTITIONS,
    ShardPartition,
    load_plan,
    partition_from_bytes,
    shard_model_id,
)
from pio_tpu_torch.serving_fleet.router import RouterConfig
from pio_tpu_torch.serving_fleet.shard import ShardConfig, create_shard_server
from pio_tpu_torch.serving_fleet.tenancy import (
    FleetCapacityError,
    FleetPlan,
    MultiFleetRouter,
    TenantPlacement,
    TenantSpec,
    build_fleet_plan,
    create_shard_host,
    deploy_multi_fleet,
    join_fleet_plan,
    load_fleet_plan,
    pack_partitions,
    partition_sizes,
    remove_tenant,
    tenant_key,
    tenant_label,
)
from pio_tpu_torch.workflow.context import create_workflow_context
from pio_tpu_torch.workflow.serve import QueryServer, ServingConfig
from pio_tpu_torch.workflow.train import persist_models

pytestmark = pytest.mark.usefixtures("time_limit")

FACTORY = "pio_tpu_torch.models.recommendation.RecommendationEngine"
REF_FACTORY = "pio_tpu.models.recommendation.RecommendationEngine"
RANK = 4
# (engine id, app, users, items, seed): the reference tests' two tenants
TENANTS = {"a": ("rec", "appa", 20, 12, 0), "b": ("recb", "appb", 16, 10, 3)}
QUERIES = [
    {"user": "u0", "num": 4},
    {"user": "u3", "num": 6, "blackList": ["i1"]},
    {"user": "u5", "num": 3, "whiteList": ["i2", "i7", "i9", "nope"]},
    {"user": "ghost", "num": 3},
    {"user": "u7", "num": 50},   # over-fetch past n_items
]


def call(port, method, path, body=None, headers=None, **params):
    qs = urllib.parse.urlencode(params)
    url = f"http://127.0.0.1:{port}{path}" + (f"?{qs}" if qs else "")
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method,
                                 headers=dict(headers or {}))
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read().decode()), \
                dict(resp.headers)
    except urllib.error.HTTPError as e:
        payload = e.read().decode()
        return e.code, (json.loads(payload) if payload else {}), \
            dict(e.headers)


# -- the tenants in both packages ---------------------------------------------

@pytest.fixture(scope="module")
def factors():
    """Each tenant trained by the reference on its events -> {tag: (user
    factors, item factors, user ids, item ids)} as host numpy."""
    out = {}
    for tag, (engine_id, app, users, items, seed) in TENANTS.items():
        store = RefStorage(env=MEM_ENV, test=True)
        try:
            ref_seed_and_train(store, app, engine_id, users=users,
                               items=items, seed=seed)
            _, model = ref_resolve_fleet_model(store, engine_id)
            out[tag] = (np.asarray(model.factors.user_factors, np.float32),
                        np.asarray(model.factors.item_factors, np.float32),
                        list(model.users.ids()), list(model.items.ids()))
        finally:
            store.close()
    return out


def _port_engine():
    engine = port_rec.RecommendationEngine.apply()
    ep = engine.engine_params_from_variant(
        {"id": "rec", "engineFactory": FACTORY,
         "algorithms": [{"name": "als", "params": {"rank": RANK}}]})
    return engine, ep


def persist_port(storage, engine_id, uf, itf, users, items) -> str:
    _, ep = _port_engine()
    return persist_models([recommendation_model_from_numpy(
        uf, itf, users, items, device="cpu")], ep, storage, engine_id,
        engine_factory=FACTORY)


def persist_ref(store, engine_id, uf, itf, users, items) -> str:
    """As ``persist_port`` in the reference's store: the latest instance
    of an engine is the one its tenant resolves to."""
    now = datetime.now(timezone.utc)
    iid = store.get_metadata_engine_instances().insert(RefEngineInstance(
        id="", status="COMPLETED", start_time=now, end_time=now,
        engine_id=engine_id, engine_version="1", engine_variant="default",
        engine_factory=REF_FACTORY))
    store.get_model_data_models().insert(RefModel(iid, ref_models_to_bytes(
        [ref_rec.RecommendationModel(
            ref_als.ALSModel(jnp.asarray(uf), jnp.asarray(itf)),
            RefIdIndex(users), RefIdIndex(items))])))
    return iid


def solo(storage, engine_id, iid) -> QueryServer:
    """The port's single-host deploy of one tenant's instance."""
    engine, ep = _port_engine()
    return QueryServer(engine, ep, storage,
                       ServingConfig(ip="127.0.0.1", port=0,
                                     engine_id=engine_id),
                       ctx=create_workflow_context(storage, device="cpu"),
                       instance_id=iid)


@pytest.fixture()
def stores(factors):
    """Both tenants persisted, in the same order, in a memory store of
    each package (so their instance ids agree), joined to nothing."""
    port = Storage(env=MEM_ENV, test=True)
    ref = RefStorage(env=MEM_ENV, test=True)
    iids = {}
    for tag in ("a", "b"):
        engine_id = TENANTS[tag][0]
        iids[tag] = persist_port(port, engine_id, *factors[tag])
        assert persist_ref(ref, engine_id, *factors[tag]) == iids[tag]
    yield port, ref, iids
    port.close()
    ref.close()


def _join_both(storage, tenancy, quota: float = 5.0) -> None:
    tenancy.join_fleet_plan(
        storage, "pool",
        tenancy.TenantSpec("rec", quota_qps=quota, quota_burst=quota),
        n_shards=2, n_replicas=1)
    tenancy.join_fleet_plan(storage, "pool", tenancy.TenantSpec("recb"),
                            n_shards=2, n_replicas=1)


@pytest.fixture()
def two_tenants(stores):
    """The reference tests' pool (tenant A quota-capped at 5 qps, B
    unlimited, on 2 shards x 1 replica) in the port's store, with each
    tenant's single-host oracle."""
    storage, _ref, iids = stores
    _join_both(storage, port_tenancy)
    oracles = {tag: solo(storage, TENANTS[tag][0], iids[tag])
               for tag in ("a", "b")}
    yield {
        "storage": storage,
        **{tag: {"key": tenant_key(TENANTS[tag][0]), "iid": iids[tag],
                 "oracle": (lambda q, qs=oracles[tag]: answer(qs, q))}
           for tag in ("a", "b")},
    }
    for qs in oracles.values():
        qs.close()


def cpu_pool(storage, name="pool", **kw):
    return deploy_multi_fleet(storage, name, device="cpu", **kw)


# -- bin packer ---------------------------------------------------------------

def _sizes(rng, lo=100, hi=5000):
    return [int(rng.integers(lo, hi)) for _ in range(N_PARTITIONS)]


def test_pack_disjoint_cover_under_budget():
    rng = np.random.default_rng(42)
    tenants = {f"t{i}/1/default": _sizes(rng) for i in range(5)}
    budget = 120_000
    owners = pack_partitions(tenants, 4, budget)
    loads = [0] * 4
    for t, sizes in tenants.items():
        assert len(owners[t]) == N_PARTITIONS
        assert all(0 <= s < 4 for s in owners[t])
        for p, s in enumerate(owners[t]):
            loads[s] += sizes[p]
    assert all(b <= budget for b in loads), loads
    assert owners == ref_tenancy.pack_partitions(tenants, 4, budget)


def test_pack_deterministic():
    rng = np.random.default_rng(7)
    tenants = {f"t{i}/1/default": _sizes(rng) for i in range(3)}
    assert pack_partitions(tenants, 3, 100_000) == \
        pack_partitions(tenants, 3, 100_000)
    rev = dict(reversed(list(tenants.items())))
    assert pack_partitions(tenants, 3, 100_000) == \
        pack_partitions(rev, 3, 100_000)


@pytest.mark.parametrize("seed,n_shards,budget", [
    (1, 2, 0), (2, 3, 120_000), (3, 4, 90_000), (4, 5, 0)])
def test_pack_owners_equal_the_reference(seed, n_shards, budget):
    """The same seeded sizes give the reference's owners, from an empty
    pool and onto a resident's loads."""
    rng = np.random.default_rng(seed)
    tenants = {f"t{i}/1/default": _sizes(rng) for i in range(3)}
    assert pack_partitions(tenants, n_shards, budget) == \
        ref_tenancy.pack_partitions(tenants, n_shards, budget)
    base = [int(b) for b in rng.integers(0, 5000, n_shards)]
    joiner = {"j/1/default": _sizes(rng, lo=10, hi=500)}
    assert pack_partitions(joiner, n_shards, 0, base_loads=base) == \
        ref_tenancy.pack_partitions(joiner, n_shards, 0, base_loads=base)


def test_pack_rejects_over_capacity():
    with pytest.raises(FleetCapacityError) as ei:
        pack_partitions({"big/1/default": [1000] * N_PARTITIONS}, 2,
                        memory_budget_bytes=2000)
    msg = str(ei.value)
    assert "budget" in msg and "big/1/default" in msg


def test_pack_incremental_join_respects_base_loads():
    rng = np.random.default_rng(9)
    resident = {"r/1/default": _sizes(rng)}
    budget = 60_000
    first = pack_partitions(resident, 2, budget)
    base = [0, 0]
    for p, s in enumerate(first["r/1/default"]):
        base[s] += resident["r/1/default"][p]
    joiner = {"j/1/default": _sizes(rng, lo=10, hi=500)}
    second = pack_partitions(joiner, 2, budget, base_loads=base)
    total = list(base)
    for p, s in enumerate(second["j/1/default"]):
        total[s] += joiner["j/1/default"][p]
    assert all(b <= budget for b in total)
    assert pack_partitions(resident, 2, budget) == first


def test_fleet_plan_roundtrip_and_reference_json():
    fields = dict(
        name="pool", n_shards=2, n_replicas=2,
        memory_budget_bytes=1 << 20)
    placement = dict(
        tenant="rec/1/default", engine_id="rec", engine_version="1",
        engine_variant="default", instance_id="i42",
        owners=tuple(p % 2 for p in range(N_PARTITIONS)),
        partition_bytes=tuple(range(N_PARTITIONS)),
        quota_qps=5.0, weight=2.0, max_concurrency=8)
    plan = FleetPlan(**fields, tenants=(TenantPlacement(**placement),))
    assert FleetPlan.from_json(plan.to_json()) == plan
    ref = ref_tenancy.FleetPlan(
        **fields, tenants=(ref_tenancy.TenantPlacement(**placement),))
    assert plan.to_json() == ref.to_json()


# -- placement against the reference ------------------------------------------

def _assert_blobs_equal(port_models, ref_models, iid, shards) -> None:
    """Each partition blob pickles its class, so the two packages' blobs
    name other modules: equal field for field."""
    for s in shards:
        mid = shard_model_id(iid, s)
        got = partition_from_bytes(port_models.get(mid).models)
        want = ref_partition_from_bytes(ref_models.get(mid).models)
        for f in dataclasses.fields(ShardPartition):
            g, w = getattr(got, f.name), getattr(want, f.name)
            if isinstance(w, np.ndarray):
                assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), \
                    (s, f.name)
            else:
                assert g == w, (s, f.name)


def _assert_placements_equal(port, ref, plan_name) -> None:
    plan = load_fleet_plan(port, plan_name)
    ref_plan = ref_tenancy.load_fleet_plan(ref, plan_name)
    assert plan.to_json() == ref_plan.to_json()
    port_models = port.get_model_data_models()
    ref_models = ref.get_model_data_models()
    assert port_models.get(f"fleet:{plan_name}:plan").models == \
        ref_models.get(f"fleet:{plan_name}:plan").models
    for t in plan.tenants:
        sp = load_plan(port, t.instance_id)
        assert sp.to_json() == ref_load_plan(ref, t.instance_id).to_json()
        assert sp.owners == t.owners
        mid = f"{t.instance_id}:shardplan"
        assert port_models.get(mid).models == ref_models.get(mid).models
        _assert_blobs_equal(port_models, ref_models, t.instance_id,
                            range(plan.n_shards))


@pytest.mark.parametrize("budget", [0, 2_000])
def test_build_fleet_plan_equals_the_reference(stores, budget):
    """Both tenants packed at once: the FleetPlan, each tenant's
    ShardPlan and every partition blob are the reference's."""
    port, ref, _ = stores
    specs = [TenantSpec("rec", quota_qps=5.0, quota_burst=5.0),
             TenantSpec("recb", weight=2.0, max_concurrency=4)]
    ref_specs = [ref_tenancy.TenantSpec(**dataclasses.asdict(s))
                 for s in specs]
    plan = build_fleet_plan(port, "pool", specs, 3, 2, budget)
    ref_plan = ref_tenancy.build_fleet_plan(ref, "pool", ref_specs, 3, 2,
                                            budget)
    assert plan.to_json() == ref_plan.to_json()
    assert len(plan.tenants) == 2
    _assert_placements_equal(port, ref, "pool")


def test_join_fleet_plan_equals_the_reference(stores, factors):
    """Two joins, then a re-join of a retrained tenant A: after each, the
    pool's plan and artifacts are the reference's."""
    port, ref, _ = stores
    _join_both(port, port_tenancy)
    _join_both(ref, ref_tenancy)
    _assert_placements_equal(port, ref, "pool")
    uf, itf, users, items = factors["a"]
    noisy = uf + np.float32(0.01)
    iid2 = persist_port(port, "rec", noisy, itf, users, items)
    assert persist_ref(ref, "rec", noisy, itf, users, items) == iid2
    plan, placement = join_fleet_plan(port, "pool", TenantSpec("rec"))
    ref_plan, ref_placement = ref_tenancy.join_fleet_plan(
        ref, "pool", ref_tenancy.TenantSpec("rec"))
    assert placement.instance_id == ref_placement.instance_id == iid2
    assert plan.to_json() == ref_plan.to_json()
    _assert_placements_equal(port, ref, "pool")


def test_partition_sizes_of_tensor_tables_equal_the_reference(stores):
    """``partition_sizes`` counts f32 bytes whether the model's tables
    are numpy or tensors (on the card they are CUDA tensors)."""
    from pio_tpu_torch.serving_fleet.fleet import resolve_fleet_model

    port, ref, _ = stores
    for engine_id in ("rec", "recb"):
        _, model = resolve_fleet_model(port, engine_id, device="cpu")
        assert isinstance(model.factors.user_factors, torch.Tensor)
        _, ref_model = ref_resolve_fleet_model(ref, engine_id)
        assert partition_sizes(model) == \
            ref_tenancy.partition_sizes(ref_model)


# -- plan build / join / remove over real storage -----------------------------

def test_join_records_plan_and_artifacts(two_tenants):
    storage = two_tenants["storage"]
    plan = load_fleet_plan(storage, "pool")
    assert plan is not None and len(plan.tenants) == 2
    assert [t.tenant for t in plan.tenants] == sorted(
        [two_tenants["a"]["key"], two_tenants["b"]["key"]])
    models = storage.get_model_data_models()
    for t in plan.tenants:
        sp = load_plan(storage, t.instance_id)
        assert sp is not None
        assert sp.owners == t.owners
        assert len(t.owners) == N_PARTITIONS
        for s in sorted(set(t.owners)):
            assert models.get(shard_model_id(t.instance_id, s))
    assert sum(plan.shard_loads()) == sum(
        t.total_bytes() for t in plan.tenants)


def test_remove_tenant_keeps_others(two_tenants):
    storage = two_tenants["storage"]
    plan = remove_tenant(storage, "pool", two_tenants["a"]["key"])
    assert [t.tenant for t in plan.tenants] == [two_tenants["b"]["key"]]
    with pytest.raises(ValueError, match="not on fleet"):
        remove_tenant(storage, "pool", two_tenants["a"]["key"])


def test_join_over_capacity_fails_loudly(stores):
    storage, *_ = stores
    with pytest.raises(FleetCapacityError):
        join_fleet_plan(storage, "tiny", TenantSpec("rec"),
                        n_shards=2, n_replicas=1, memory_budget_bytes=64)
    assert load_fleet_plan(storage, "tiny") is None


# -- serving ------------------------------------------------------------------

def _assert_near_reference(got: dict, want: dict, what) -> None:
    """The port's body against the reference pool's: scores within
    RTOL/ATOL, ids exact wherever the scores around them are more than
    1e-5 apart."""
    g = [(s["item"], s["score"]) for s in got["itemScores"]]
    w = [(s["item"], s["score"]) for s in want["itemScores"]]
    assert len(g) == len(w), what
    np.testing.assert_allclose([s for _, s in g], [s for _, s in w],
                               rtol=RTOL, atol=ATOL, err_msg=str(what))
    scores = [s for _, s in w]
    for i, (item, _) in enumerate(w):
        gaps = [abs(scores[i] - scores[j]) for j in (i - 1, i + 1)
                if 0 <= j < len(scores)]
        if all(gap > 1e-5 for gap in gaps):
            assert g[i][0] == item, (what, i)
    assert {k: v for k, v in got.items() if k != "itemScores"} == \
        {k: v for k, v in want.items() if k != "itemScores"}, what


def test_pool_bodies_equal_single_host_and_the_reference_pool(stores):
    """Each tenant's bodies through the port's pool are its single-host
    answers byte for byte, and the reference pool's on the same tenants;
    ``?tenant=`` and the header route alike."""
    port, ref, iids = stores
    _join_both(port, port_tenancy, quota=0.0)
    _join_both(ref, ref_tenancy, quota=0.0)
    handle = cpu_pool(port)
    ref_handle = ref_tenancy.deploy_multi_fleet(ref, "pool")
    try:
        for tag in ("a", "b"):
            engine_id = TENANTS[tag][0]
            key = tenant_key(engine_id)
            qs = solo(port, engine_id, iids[tag])
            try:
                for q in QUERIES:
                    s, body, _ = call(handle.router_http.port, "POST",
                                      "/queries.json", body=dict(q),
                                      tenant=key)
                    assert s == 200, (tag, q, body)
                    assert body == answer(qs, q), (tag, q)
                    s, rbody, _ = call(ref_handle.router_http.port, "POST",
                                       "/queries.json", body=dict(q),
                                       tenant=key)
                    assert s == 200, (tag, q, rbody)
                    _assert_near_reference(body, rbody, (tag, q))
                s, body, _ = call(handle.router_http.port, "POST",
                                  "/queries.json", body=dict(QUERIES[0]),
                                  headers={"X-Pio-Tenant": key})
                assert s == 200 and body == answer(qs, QUERIES[0])
            finally:
                qs.close()
    finally:
        handle.close()
        ref_handle.close()


def test_pool_reports_its_device_and_counts_exact_dispatches(two_tenants):
    """Every host names the device on ``/host/info`` and
    ``/metrics.json``; each tenant's queries count exact scoring
    dispatches on its hosts, never a scan (the pool serves exact)."""
    handle = cpu_pool(two_tenants["storage"])
    try:
        assert handle.router.device == "cpu"
        for tag in ("a", "b"):
            for u in range(4):
                s, _, _ = call(handle.router_http.port, "POST",
                               "/queries.json",
                               body={"user": f"u{u}", "num": 3},
                               tenant=two_tenants[tag]["key"])
                assert s == 200
        for http, host in handle.hosts:
            s, info, _ = call(http.port, "GET", "/host/info")
            assert s == 200 and info["device"] == "cpu"
            s, m, _ = call(http.port, "GET", "/metrics.json")
            assert s == 200 and m["device"] == "cpu"
            assert m["kernelLaunches"]["quantized_scan"] == 0
            for tag in ("a", "b"):
                key = two_tenants[tag]["key"]
                d = m["tenants"][key]["scoringDispatches"]
                assert d["exact"] > 0 and d["scan"] == 0, (key, d)
                srv = host.servers[key]
                assert srv.config.retrieval is None
                assert srv._item_factors_dev.device.type == "cpu"
                s, tm, _ = call(http.port, "GET", "/metrics.json",
                                headers={"X-Pio-Tenant": key})
                assert s == 200 and tm["device"] == "cpu"
    finally:
        handle.close()


def test_tenant_resolution_errors(two_tenants):
    handle = cpu_pool(two_tenants["storage"])
    try:
        port = handle.router_http.port
        s, body, _ = call(port, "POST", "/queries.json",
                          body={"user": "u0", "num": 3})
        assert s == 400 and "X-Pio-Tenant" in body["message"]
        s, body, _ = call(port, "POST", "/queries.json",
                          body={"user": "u0", "num": 3},
                          tenant="nope/1/default")
        assert s == 404 and "tenant-unknown" in body["message"]
        host_port = handle.hosts[0][0].port
        s, body, _ = call(host_port, "POST", "/shard/topk",
                          body={"userRow": [0, 0, 0, 0], "k": 2},
                          headers={"X-Pio-Tenant": "nope/1/default"})
        assert s == 404 and "tenant-unknown" in body["message"]
    finally:
        handle.close()


def test_shard_validates_tenant_header_421(two_tenants):
    storage = two_tenants["storage"]
    a = two_tenants["a"]
    http, _srv = create_shard_server(storage, ShardConfig(
        shard_index=0, n_shards=2, engine_id="rec",
        instance_id=a["iid"], tenant=a["key"], device="cpu"))
    http.start()
    try:
        s, body, _ = call(http.port, "POST", "/shard/user_row",
                          body={"user": "u0"},
                          headers={"X-Pio-Tenant": "recb/1/default"})
        assert s == 421 and "tenant-mismatch" in body["message"]
        s, _, _ = call(http.port, "POST", "/shard/user_row",
                       body={"user": "u0"},
                       headers={"X-Pio-Tenant": a["key"]})
        assert s == 200
    finally:
        http.stop()


def test_reshard_refused_on_multi_tenant_plan(two_tenants):
    handle = cpu_pool(two_tenants["storage"])
    try:
        port = handle.router_http.port
        s, body, _ = call(port, "POST", "/reshard/begin",
                          body={"shards": 3})
        assert s == 409 and "not supported in v1" in body["message"]
        s, body, _ = call(port, "GET", "/reshard/status")
        assert s == 200 and body == {"inFlight": False,
                                     "multiTenant": True}
    finally:
        handle.close()


# -- isolation drills ---------------------------------------------------------

def test_flooding_tenant_sheds_alone_victim_exact(two_tenants):
    """A floods past its 5 qps quota (burst 5) with B's queries between:
    A's sheds answer 429 + Retry-After naming it, B answers 200 and
    exact throughout. A's bucket runs on a clock that stands still, so
    how fast this host answers refills nothing between the queries."""
    handle = cpu_pool(two_tenants["storage"])
    try:
        port = handle.router_http.port
        a, b = two_tenants["a"], two_tenants["b"]
        admission = handle.router.admission
        now = time.monotonic()
        admission._clock = lambda: now
        admission.configure(a["key"], load_fleet_plan(
            two_tenants["storage"], "pool").tenant(a["key"]).quota())
        q = {"user": "u1", "num": 3}
        expect_b = b["oracle"](q)
        statuses = []
        for _ in range(50):
            s, body, hdrs = call(port, "POST", "/queries.json",
                                 body=dict(q), tenant=a["key"])
            statuses.append(s)
            if s == 429:
                assert "Retry-After" in hdrs
                assert body["tenant"] == a["key"]
                assert body["reason"] == "quota"
            s, vbody, _ = call(port, "POST", "/queries.json",
                               body=dict(q), tenant=b["key"])
            assert s == 200, vbody
            assert vbody == expect_b
        assert statuses.count(429) >= 40, statuses
        assert statuses.count(200) >= 1
        snap = handle.router.admission.snapshot()
        assert snap[a["key"]]["shed"]["quota"] >= 40
        assert snap[b["key"]]["shedTotal"] == 0
    finally:
        handle.close()


def test_tenant_scoped_chaos_degrades_only_target(two_tenants):
    handle = cpu_pool(two_tenants["storage"])
    try:
        port = handle.router_http.port
        a, b = two_tenants["a"], two_tenants["b"]
        label = tenant_label(a["key"])
        q = {"user": "u2", "num": 3}
        with chaos.inject(f"fleet.{label}", error=1.0, seed=7) as monkey:
            s, body, _ = call(port, "POST", "/queries.json",
                              body=dict(q), tenant=a["key"])
            assert s == 200 and body["degraded"] is True
            s, vbody, _ = call(port, "POST", "/queries.json",
                               body=dict(q), tenant=b["key"])
            assert s == 200 and not vbody.get("degraded")
            assert vbody == b["oracle"](q)
            assert all(p.startswith(f"fleet.{label}.")
                       for p in monkey.injected), monkey.injected
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            s, body, _ = call(port, "POST", "/queries.json",
                              body=dict(q), tenant=a["key"])
            if s == 200 and not body.get("degraded"):
                break
            time.sleep(0.2)
        assert s == 200 and not body.get("degraded")
        assert body == a["oracle"](q)
    finally:
        handle.close()


def test_corrupt_blob_degrades_only_that_tenant(two_tenants, factors):
    """A retrained tenant A re-joined, then the latest blob on one of its
    shards corrupted: A serves last-good there, B stays exact."""
    storage = two_tenants["storage"]
    a, b = two_tenants["a"], two_tenants["b"]
    uf, itf, users, items = factors["a"]
    iid2 = persist_port(storage, "rec", uf + np.float32(0.01), itf, users,
                        items)
    join_fleet_plan(storage, "pool",
                    TenantSpec("rec", quota_qps=5.0, quota_burst=5.0))
    placed = load_fleet_plan(storage, "pool").tenant(a["key"])
    assert placed.instance_id == iid2
    shard = placed.owners[0]
    models = storage.get_model_data_models()
    blob = bytearray(models.get(shard_model_id(iid2, shard)).models)
    blob[-1] ^= 0xFF
    models.insert(Model(shard_model_id(iid2, shard), bytes(blob)))
    handle = cpu_pool(storage)
    try:
        port = handle.router_http.port
        s, body, _ = call(port, "POST", "/queries.json",
                          body={"user": "u0", "num": 3}, tenant=a["key"])
        assert s == 200 and body["itemScores"]
        q = {"user": "u1", "num": 4}
        s, vbody, _ = call(port, "POST", "/queries.json",
                           body=dict(q), tenant=b["key"])
        assert s == 200 and vbody == b["oracle"](q)
        host = handle.hosts[shard][1]
        assert host.servers[a["key"]].partition.instance_id == a["iid"]
        other = handle.hosts[1 - shard][1]
        assert other.servers[a["key"]].partition.instance_id == iid2
        assert all(h.servers[b["key"]].partition.instance_id == b["iid"]
                   for _, h in handle.hosts)
    finally:
        handle.close()


def test_detach_attach_tenant_live(two_tenants, monkeypatch):
    """B detached (its device tensors released, A untouched), then
    attached again while A is queried through the held attach."""
    handle = cpu_pool(two_tenants["storage"])
    try:
        port = handle.router_http.port
        a, b = two_tenants["a"], two_tenants["b"]
        old = [h.servers[b["key"]] for _, h in handle.hosts]
        tables = [weakref.ref(srv._item_factors_dev) for srv in old]
        s, out, _ = call(port, "POST", "/fleet/detach_tenant",
                         body={"tenant": b["key"]})
        assert s == 200 and all(h["ok"] for h in out["hosts"].values())
        assert all(srv._item_factors_dev is None and srv.partition is None
                   for srv in old)
        del old
        gc.collect()
        assert all(t() is None for t in tables)
        s, body, _ = call(port, "POST", "/queries.json",
                          body={"user": "u0", "num": 3}, tenant=b["key"])
        assert s == 404
        s, _, _ = call(port, "POST", "/queries.json",
                       body={"user": "u0", "num": 3}, tenant=a["key"])
        assert s == 200
        # hold B's shard servers in their construction (partition load
        # and warm dispatch): A keeps answering through the attach
        building, release = threading.Event(), threading.Event()
        server_cls = shard_mod.ShardServer

        class HeldServer(server_cls):
            def __init__(self, storage, config):
                if config.tenant == b["key"]:
                    building.set()
                    release.wait(timeout=60)
                super().__init__(storage, config)

        monkeypatch.setattr(shard_mod, "ShardServer", HeldServer)
        attached: dict = {}
        t = threading.Thread(target=lambda: attached.update(zip(
            ("status", "body", "headers"),
            call(port, "POST", "/fleet/attach_tenant",
                 body={"tenant": b["key"]}))))
        t.start()
        try:
            assert building.wait(timeout=60)
            q = {"user": "u3", "num": 4}
            s, body, _ = call(port, "POST", "/queries.json", body=dict(q),
                              tenant=a["key"])
            assert s == 200 and body == a["oracle"](q)
        finally:
            release.set()
            t.join(timeout=60)
        assert attached["status"] == 200, attached
        q = {"user": "u0", "num": 3}
        s, body, _ = call(port, "POST", "/queries.json",
                          body=dict(q), tenant=b["key"])
        assert s == 200 and body == b["oracle"](q)
    finally:
        handle.close()


def test_metrics_carry_tenant_label(two_tenants):
    handle = cpu_pool(two_tenants["storage"])
    try:
        port = handle.router_http.port
        call(port, "POST", "/queries.json",
             body={"user": "u0", "num": 3},
             tenant=two_tenants["a"]["key"])
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics", timeout=10) as resp:
            text = resp.read().decode()
        label = f'tenant="{two_tenants["a"]["key"]}"'
        assert "pio_tenant_requests_total" in text
        assert label in text
        with urllib.request.urlopen(
                f"http://127.0.0.1:{handle.hosts[0][0].port}/metrics",
                timeout=10) as resp:
            host_text = resp.read().decode()
        assert "pio_tenant_partition_bytes" in host_text
        assert label in host_text
    finally:
        handle.close()


# -- event-server ingest quotas -----------------------------------------------

RATE = {
    "event": "rate", "entityType": "user", "entityId": "u1",
    "targetEntityType": "item", "targetEntityId": "i1",
    "properties": {"rating": 4},
    "eventTime": "2026-01-01T00:00:00.000Z",
}


def test_ingest_quota_sheds_per_app():
    from pio_tpu_torch.server.eventserver import (
        EventServerConfig, create_event_server,
    )

    storage = Storage(env=MEM_ENV, test=True)
    apps = storage.get_metadata_apps()
    keys = storage.get_metadata_access_keys()
    ev = storage.get_events()
    ids = {}
    for name, key in (("flooder", "FKEY"), ("victim", "VKEY")):
        app_id = apps.insert(App(0, name))
        keys.insert(AccessKey(key, app_id, ()))
        ev.init(app_id)
        ids[name] = app_id
    srv = create_event_server(
        storage,
        EventServerConfig(ip="127.0.0.1", port=0, metrics_key="MK",
                          ingest_quota_qps=2.0, ingest_quota_burst=2.0),
    ).start()
    try:
        statuses = []
        for _ in range(20):
            s, body, hdrs = call(srv.port, "POST", "/events.json",
                                 body=dict(RATE), accessKey="FKEY")
            statuses.append(s)
            if s == 429:
                assert "Retry-After" in hdrs
                assert "ingest quota" in body["message"]
            s, _, _ = call(srv.port, "POST", "/events.json",
                           body=dict(RATE), accessKey="VKEY")
            assert s in (201, 429)
        assert statuses.count(429) >= 10, statuses
        assert statuses.count(201) >= 1
        assert srv.app.ingest_shed.get(ids["flooder"], 0) >= 10
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/metrics?accessKey=MK",
                timeout=10) as resp:
            text = resp.read().decode()
        assert "pio_ingest_shed_total" in text
        assert f'app="{ids["flooder"]}"' in text
        s, _, _ = call(srv.port, "GET", "/events.json", accessKey="FKEY",
                       limit=1)
        assert s in (200, 404)
    finally:
        srv.stop()
        storage.close()


def test_tenant_key_label_shapes():
    assert tenant_key("rec") == "rec/1/default"
    assert tenant_label("rec/1/default") == "rec.1.default"
    assert not set(tenant_label("a/2/x")) & set(":,;=/")
    assert tenant_label("a/2/x") == ref_tenancy.tenant_label("a/2/x")


# -- the device and the verbs -------------------------------------------------

def test_pool_without_cuda_raises_unless_cpu_is_asked(two_tenants,
                                                      monkeypatch):
    storage = two_tenants["storage"]
    plan = load_fleet_plan(storage, "pool")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        deploy_multi_fleet(storage, "pool")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_shard_host(storage, plan, 0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MultiFleetRouter(storage, plan, [["http://127.0.0.1:9"]] * 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MultiFleetRouter(storage, plan, [["http://127.0.0.1:9"]] * 2,
                         router_config=RouterConfig())
    monkeypatch.setattr("pio_tpu_torch.__main__.get_storage",
                        lambda: storage)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_main(["deploy", "--fleet", "pool", "--port", "0"])
    handle = cpu_pool(storage)
    try:
        assert handle.router.device == "cpu"
        assert all(h.device == "cpu" for _, h in handle.hosts)
    finally:
        handle.close()


def _engine_dir(root, engine_id: str, app: str):
    d = root / engine_id
    d.mkdir()
    (d / "engine.json").write_text(json.dumps({
        "id": engine_id, "engineFactory": FACTORY,
        "datasource": {"params": {"app_name": app}},
        "algorithms": [{"name": "als", "params": {"rank": RANK}}]}))
    return str(d)


def _verb(env, *argv, timeout=120):
    return subprocess.run([sys.executable, "-m", "pio_tpu_torch", *argv],
                          env=env, capture_output=True, text=True,
                          timeout=timeout)


def test_deploy_verb_refuses_fleet_with_fleet_join(tmp_path, monkeypatch,
                                                   capsys):
    storage = Storage(env=sqlite_env(tmp_path / "pio.db"))
    monkeypatch.setattr("pio_tpu_torch.__main__.get_storage",
                        lambda: storage)
    try:
        rc = port_main(["deploy", "--fleet", "pool", "--fleet-join", "pool",
                        "--device", "cpu"])
        assert rc == 1
        assert "run them as separate commands" in capsys.readouterr().err
        rc = port_main(["undeploy", "--tenant", "rec/1/default", "--fleet",
                        "nowhere"])
        assert rc == 1
        assert "has no recorded plan" in capsys.readouterr().err
    finally:
        storage.close()


def test_fleet_join_refuses_a_similarproduct_engine(tmp_path, monkeypatch,
                                                    capsys):
    storage = Storage(env=sqlite_env(tmp_path / "pio.db"))
    monkeypatch.setattr("pio_tpu_torch.__main__.get_storage",
                        lambda: storage)
    engine_dir = tmp_path / "sp"
    copy_example("similarproduct", engine_dir,
                 "pio_tpu_torch.models.similarproduct.SimilarProductEngine")
    try:
        rc = port_main(["deploy", "--engine-dir", str(engine_dir),
                        "--fleet-join", "pool"])
    finally:
        storage.close()
    assert rc == 1
    err = capsys.readouterr().err
    assert "--fleet-join serves the recommendation template's ALS" in err
    storage = Storage(env=sqlite_env(tmp_path / "pio.db"))
    try:
        assert load_fleet_plan(storage, "pool") is None
    finally:
        storage.close()


def test_the_pool_verbs_end_to_end(tmp_path, factors, monkeypatch, capsys):
    """``deploy --fleet-join`` for both tenants (the pool not running),
    ``deploy --fleet pool --device cpu`` as a process answering each
    tenant's single-host bodies, ``undeploy --tenant`` and a live
    ``--fleet-join`` back into the running pool, then ``undeploy``."""
    env_map = sqlite_env(tmp_path / "pio.db")
    storage = Storage(env=env_map)
    monkeypatch.setattr("pio_tpu_torch.__main__.get_storage",
                        lambda: storage)
    dirs, iids, want = {}, {}, {}
    port = _free_port()
    try:
        for tag in ("a", "b"):
            engine_id, app = TENANTS[tag][:2]
            dirs[tag] = _engine_dir(tmp_path, engine_id, app)
            iids[tag] = persist_port(storage, engine_id, *factors[tag])
            qs = solo(storage, engine_id, iids[tag])
            want[tag] = [answer(qs, q) for q in QUERIES]
            qs.close()
        quota = ["--tenant-quota-qps", "50", "--tenant-quota-burst", "50"]
        for tag, extra in (("a", quota), ("b", [])):
            rc = port_main(["deploy", "--engine-dir", dirs[tag],
                            "--fleet-join", "pool", "--shards", "2",
                            "--replicas", "1", "--port", str(port),
                            *extra])
            assert rc == 0
            out = capsys.readouterr().out
            key = tenant_key(TENANTS[tag][0])
            assert f"Tenant {key} joined fleet 'pool': instance " \
                   f"{iids[tag]}" in out
            assert "no live router attached at" in out
        plan = load_fleet_plan(storage, "pool")
        assert plan.tenant("rec/1/default").quota_qps == 50.0
        assert plan.tenant("recb/1/default").quota_qps == 0.0
    finally:
        storage.close()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"} | {
        "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu", **env_map}
    proc = subprocess.Popen(
        [sys.executable, "-m", "pio_tpu_torch", "deploy", "--fleet", "pool",
         "--port", str(port), "--ip", "127.0.0.1", "--device", "cpu",
         "--server-key", "SK"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        _wait_ready(port)

        def served(tag):
            for q, w in zip(QUERIES, want[tag]):
                s, got, _ = call(port, "POST", "/queries.json",
                                 body=dict(q),
                                 tenant=tenant_key(TENANTS[tag][0]))
                assert s == 200 and got == w, (tag, q)

        served("a")
        served("b")
        out = _verb(env, "undeploy", "--tenant", "recb/1/default",
                    "--fleet", "pool", "--port", str(port),
                    "--server-key", "SK")
        assert out.returncode == 0, out.stderr
        assert "Tenant recb/1/default removed from fleet 'pool' " \
               "(1 tenant(s) remain)" in out.stdout
        assert "live detach: " in out.stdout
        s, _, _ = call(port, "POST", "/queries.json",
                       body=dict(QUERIES[0]), tenant="recb/1/default")
        assert s == 404
        served("a")
        out = _verb(env, "deploy", "--engine-dir", dirs["b"],
                    "--fleet-join", "pool", "--port", str(port),
                    "--server-key", "SK")
        assert out.returncode == 0, out.stderr
        assert "live attach: " in out.stdout
        assert '"message": "tenant attached"' in out.stdout
        served("b")
        served("a")
        out = _verb(env, "undeploy", "--port", str(port), "--server-key",
                    "SK")
        assert out.returncode == 0, out.stderr
        text, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0, text
        assert f"Multi-tenant fleet 'pool' on http://127.0.0.1:{port} " \
               "(2 shards x 1 replicas, 2 tenants, cpu)" in text
        assert f"  tenant rec/1/default: instance {iids['a']}" in text
        assert "  shard host 1: " in text
        assert "Fleet stopped." in text
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
