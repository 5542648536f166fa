"""The similar-product and e-commerce templates of the port against the JAX
package, end to end on one sqlite store, on the CPU.

Both packages read the same events (the reference's
``tests/test_templates.py`` fixtures, written once to a sqlite file both
open). Each template's training builds the reference's ``ALSParams``
(``als_train`` itself, from one ``init=``, is held by
``test_torch_als_train.py``); the reference's trained model, carried
across by ``convert.py``, answers the reference's queries with the
reference's ids (whiteList, blackList, categories; for ecommerce the
unseen-only rule, the unavailable items with their TTL cache and the
stale set through an outage, the cold start from recent views); and
``batch_predict`` equals ``predict`` for every query, bit for bit. The
reference's template cases run on the port's own trained models, and the
similarproduct (ALS and DIMSUM) and ecommerce engine.json variants go
through ``python -m pio_tpu_torch train``, then ``create_query_server``
(what ``deploy`` serves) over HTTP (classification's in
``test_torch_classification.py``).

Tolerances: scores within 1e-5 relative of the reference's on the same
factors (f32 products in another order); ids exact wherever the gap to a
neighbouring score exceeds 1e-5. DIMSUM's tables: see
``test_torch_similarity.py``.
"""

import _torch_cpu  # noqa: F401  (one CPU thread: see the module)
import contextlib
import dataclasses
import json
import urllib.request
from datetime import datetime, timedelta, timezone

import numpy as np
import pytest
import torch

from pio_tpu.controller.engine import EngineParams as RefEngineParams
from pio_tpu.data.storage import Storage as RefStorage
from pio_tpu.models import ecommerce as ref_ec
from pio_tpu.models import similarproduct as ref_sp
from pio_tpu.workflow.context import (
    create_workflow_context as ref_context,
)
from pio_tpu_torch import convert
from pio_tpu_torch.__main__ import main as port_main
from pio_tpu_torch.controller.engine import EngineParams
from pio_tpu_torch.data.dao import App
from pio_tpu_torch.data.event import Event
from pio_tpu_torch.data.storage import Storage
from pio_tpu_torch.models import ecommerce as ec
from pio_tpu_torch.models import similarproduct as sp
from pio_tpu_torch.workflow.context import create_workflow_context
from pio_tpu_torch.workflow.serve import ServingConfig, create_query_server

RTOL = 1e-5
GAP = 1e-5
T0 = datetime(2026, 1, 1, tzinfo=timezone.utc)
# the reference's template params (tests/test_templates.py) but for the
# sweeps: 2 where the reference trains too (its compile grows with them),
# the reference's 8 where the port's model must cluster
ALS = dict(rank=8, num_iterations=2, lambda_=0.05, alpha=10.0, chunk=1024)
ALS_FULL = {**ALS, "num_iterations": 8}


def _env(path):
    return {
        "PIO_STORAGE_SOURCES_SQL_TYPE": "sqlite",
        "PIO_STORAGE_SOURCES_SQL_PATH": str(path / "pio.db"),
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "SQL",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "SQL",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "SQL",
    }


def _set(entity_type, entity_id, props, minute=0):
    return Event(event="$set", entity_type=entity_type, entity_id=entity_id,
                 properties=props, event_time=T0 + timedelta(minutes=minute))


def _ev(name, uid, iid, minute=0):
    return Event(event=name, entity_type="user", entity_id=uid,
                 target_entity_type="item", target_entity_id=iid,
                 event_time=T0 + timedelta(minutes=minute))


def _write(storage, app, buys: bool, seed: int, p_in: float):
    """The reference fixtures: items 0-9 cluster A, 10-19 cluster B;
    users view (and for ecommerce buy) within their cluster."""
    app_id = storage.get_metadata_apps().insert(App(0, app))
    ev = storage.get_events()
    ev.init(app_id)
    rng = np.random.default_rng(seed)
    m = 0
    batch = []
    for u in range(30):
        cluster = u % 2
        for i in range(20):
            in_cluster = (i < 10) == (cluster == 0)
            if rng.random() < (p_in if in_cluster else 0.05):
                batch.append(_ev("view", f"u{u}", f"i{i}", m))
                m += 1
                if buys and rng.random() < 0.3:
                    batch.append(_ev("buy", f"u{u}", f"i{i}", m))
                    m += 1
    for i in range(20):
        batch.append(_set("item", f"i{i}",
                          {"categories": ["catA" if i < 10 else "catB"]}))
    ev.insert_batch(batch, app_id)
    return app_id


class _Stores:
    def __init__(self, path):
        self.env = _env(path)
        self.port = Storage(env=self.env)
        self.ref = RefStorage(env=self.env)

    def close(self):
        self.port.close()
        self.ref.close()


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    s = _Stores(tmp_path_factory.mktemp("sim"))
    _write(s.port, "simapp", buys=False, seed=1, p_in=0.7)
    yield s
    s.close()


@pytest.fixture(scope="module")
def shop(tmp_path_factory):
    s = _Stores(tmp_path_factory.mktemp("shop"))
    s.app_id = _write(s.port, "shopapp", buys=True, seed=2, p_in=0.6)
    yield s
    s.close()


def _same_answer(got: dict, want: dict, what=""):
    """Equal ids where the reference's neighbouring scores are apart, the
    scores within RTOL."""
    g, w = got["itemScores"], want["itemScores"]
    assert len(g) == len(w), (what, got, want)
    ws = np.array([x["score"] for x in w])
    np.testing.assert_allclose([x["score"] for x in g], ws, rtol=RTOL,
                               atol=RTOL, err_msg=str(what))
    for j in range(len(w)):
        left = j == 0 or abs(ws[j] - ws[j - 1]) > GAP
        right = j == len(w) - 1 or abs(ws[j + 1] - ws[j]) > GAP
        if left and right:
            assert g[j]["item"] == w[j]["item"], (what, got, want)


def _captured_als_params(monkeypatch, ref_module):
    seen = []
    real = ref_module.als.als_train

    def capture(*a, **kw):
        seen.append(a[5])
        return real(*a, **kw)

    monkeypatch.setattr(ref_module.als, "als_train", capture)
    return seen


def _fields(p):
    return {f.name: getattr(p, f.name) for f in dataclasses.fields(p)}


# -- similarproduct ---------------------------------------------------------

SIM_QUERIES = [
    {"items": ["i0", "i1"], "num": 5},
    {"items": ["i12"], "num": 3, "blackList": ["i13"]},
    {"items": ["unknown-item"], "num": 3},
    {"items": ["i2"], "num": 2, "whiteList": ["i3", "i4", "i5"]},
    {"items": ["i0"], "num": 2, "whiteList": ["i19", "i17"]},
    {"items": ["i0"], "num": 5, "categories": ["catB"]},
    {"items": ["i3", "i15", "i7"], "num": 6},
    {"items": ["i0"], "num": 5, "blackList": ["i2"]},
]


@pytest.fixture(scope="module")
def sim_models(sim):
    mp = pytest.MonkeyPatch()
    seen = _captured_als_params(mp, ref_sp)
    ref_engine = ref_sp.SimilarProductEngine.apply()
    ref_ep = RefEngineParams(
        datasource=("", ref_sp.DataSourceParams(app_name="simapp")),
        algorithms=[("als", ref_sp.ALSAlgorithmParams(**ALS))])
    (ref_model,) = ref_engine.train(ref_context(sim.ref, use_mesh=False),
                                    ref_ep)
    port_seen = _captured_als_params(mp, sp)
    engine = sp.SimilarProductEngine.apply()
    ep = EngineParams(
        datasource=("", sp.DataSourceParams(app_name="simapp")),
        algorithms=[("als", sp.ALSAlgorithmParams(**ALS))])
    ctx = create_workflow_context(sim.port, device="cpu")
    engine.train(ctx, ep)
    mp.undo()
    (model,) = engine.train(ctx, EngineParams(
        datasource=ep.datasource,
        algorithms=[("als", sp.ALSAlgorithmParams(**ALS_FULL))]))
    return dict(ref=ref_model, ref_algo=ref_engine._doers(ref_ep)[2][0],
                ref_params=seen[0], params=port_seen[0], model=model,
                algo=engine._doers(ep)[2][0])


def test_similarproduct_trains_with_the_reference_params(sim_models):
    assert _fields(sim_models["params"]) == _fields(sim_models["ref_params"])
    assert isinstance(sim_models["model"].item_factors, torch.Tensor)


def test_similarproduct_converted_model_answers_as_reference(sim_models):
    ref = sim_models["ref"]
    model = convert.similarproduct_model_from_numpy(
        np.asarray(ref.item_factors), ref.items.ids(), ref.item_categories,
        device="cpu")
    algo = sim_models["algo"]
    for q in SIM_QUERIES:
        _same_answer(algo.predict(model, q),
                     sim_models["ref_algo"].predict(ref, q), q)
    assert algo.batch_predict(model, SIM_QUERIES) == [
        algo.predict(model, q) for q in SIM_QUERIES]


def test_similarproduct_reference_cases_on_the_port_model(sim_models):
    """tests/test_templates.py's clusters and filters cases."""
    model, algo = sim_models["model"], sim_models["algo"]
    r = algo.predict(model, {"items": ["i0", "i1"], "num": 5})
    items = [s["item"] for s in r["itemScores"]]
    assert len(items) == 5 and "i0" not in items and "i1" not in items
    assert sum(1 for it in items if int(it[1:]) < 10) >= 4, items
    scores = [s["score"] for s in r["itemScores"]]
    assert scores == sorted(scores, reverse=True)
    r = algo.predict(model, {"items": ["i0"], "num": 5,
                             "categories": ["catB"]})
    assert all(int(s["item"][1:]) >= 10 for s in r["itemScores"])
    r = algo.predict(model, {"items": ["i0"], "num": 2,
                             "whiteList": ["i19", "i17"]})
    assert {s["item"] for s in r["itemScores"]} == {"i19", "i17"}
    assert algo.predict(model, {"items": ["nope"], "num": 3}) == {
        "itemScores": []}
    assert algo.batch_predict(model, SIM_QUERIES) == [
        algo.predict(model, q) for q in SIM_QUERIES]


def test_dimsum_template_as_reference(sim):
    ref_engine = ref_sp.SimilarProductEngine.apply()
    ref_ep = RefEngineParams(
        datasource=("", ref_sp.DataSourceParams(app_name="simapp")),
        algorithms=[("dimsum", ref_sp.DIMSUMParams(k_sim=6))])
    (ref_model,) = ref_engine.train(ref_context(sim.ref, use_mesh=False),
                                    ref_ep)
    engine = sp.SimilarProductEngine.apply()
    ep = EngineParams(
        datasource=("", sp.DataSourceParams(app_name="simapp")),
        algorithms=[("dimsum", sp.DIMSUMParams(k_sim=6))])
    (model,) = engine.train(create_workflow_context(sim.port, device="cpu"),
                            ep)
    np.testing.assert_allclose(model.sim_scores, ref_model.sim_scores,
                               rtol=RTOL, atol=RTOL)
    carried = convert.dimsum_model_from_numpy(
        ref_model.sim_scores, ref_model.sim_idx, ref_model.items.ids(),
        ref_model.item_categories)
    algo, ref_algo = engine._doers(ep)[2][0], ref_engine._doers(ref_ep)[2][0]
    for q in SIM_QUERIES:
        assert algo.predict(carried, q) == ref_algo.predict(ref_model, q)
        _same_answer(algo.predict(model, q), ref_algo.predict(ref_model, q),
                     q)


def test_dimsum_reference_cases():
    """tests/test_dimsum.py's end-to-end and multi-item cases."""
    from pio_tpu_torch.data.bimap import EntityIdIndex
    from pio_tpu_torch.data.eventstore import Interactions

    ctx = create_workflow_context(Storage(env=_mem_env()), device="cpu")
    uu, ii = zip(*[(u, i) for u in range(40) for i in range(10)
                   if (u + i) % 2 == 0])
    inter = Interactions(
        user_idx=np.array(uu), item_idx=np.array(ii),
        values=np.ones(len(uu), np.float32),
        users=EntityIdIndex(f"u{u}" for u in range(40)),
        items=EntityIdIndex(f"i{i}" for i in range(10)))
    data = sp.SimilarProductData(
        inter, {f"i{i}": ["even" if i % 2 == 0 else "odd"]
                for i in range(10)})
    algo = sp.DIMSUMAlgorithm(sp.DIMSUMParams(k_sim=6))
    model = algo.train(ctx, data)
    got = [s["item"] for s in
           algo.predict(model, {"items": ["i0"], "num": 3})["itemScores"]]
    assert got and all(int(g[1:]) % 2 == 0 for g in got) and "i0" not in got
    r2 = algo.predict(model, {"items": ["i0"], "num": 3,
                              "blackList": [got[0]]})
    assert got[0] not in [s["item"] for s in r2["itemScores"]]
    assert algo.predict(model, {"items": ["i0"], "num": 5,
                                "categories": ["odd"]}) == {"itemScores": []}
    # i0 co-occurs with i1, i2 with i3: a query of both surfaces both
    inter = Interactions(
        user_idx=np.array([0, 0, 1, 1, 2, 2, 3, 3]),
        item_idx=np.array([0, 1, 0, 1, 2, 3, 2, 3]),
        values=np.ones(8, np.float32),
        users=EntityIdIndex(f"u{u}" for u in range(4)),
        items=EntityIdIndex(f"i{i}" for i in range(4)))
    algo = sp.DIMSUMAlgorithm(sp.DIMSUMParams(k_sim=3))
    model = algo.train(ctx, sp.SimilarProductData(inter, {}))
    r = algo.predict(model, {"items": ["i0", "i2"], "num": 4})
    assert {"i1", "i3"} <= {s["item"] for s in r["itemScores"]}


def _mem_env():
    return {"PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
            "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
            "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM"}


# -- ecommerce --------------------------------------------------------------

SHOP_QUERIES = [
    {"user": "u0", "num": 4},
    {"user": "u2", "num": 3, "blackList": ["i1"]},
    {"user": "cold-a", "num": 3},
    {"user": "brand-new-user", "num": 3},
    {"user": "u1", "num": 3, "categories": ["catA"]},
    {"user": "cold-b", "num": 4},
    {"user": "u3", "num": 5},
    {"user": "u2", "num": 5, "categories": ["catB"]},
    {"user": "u4", "num": 3, "whiteList": ["i1", "i2", "i11", "i3"]},
    {"user": "cold-a", "num": 2, "whiteList": ["i15", "i3", "i12"]},
]


@pytest.fixture(scope="module")
def shop_models(shop):
    mp = pytest.MonkeyPatch()
    seen = _captured_als_params(mp, ref_ec)
    ref_engine = ref_ec.ECommerceEngine.apply()
    ref_ep = RefEngineParams(
        datasource=("", ref_ec.DataSourceParams(app_name="shopapp")),
        algorithms=[("ecomm", ref_ec.ECommAlgorithmParams(
            app_name="shopapp", **ALS))])
    rctx = ref_context(shop.ref, use_mesh=False)
    (ref_model,) = ref_engine.train(rctx, ref_ep)
    port_seen = _captured_als_params(mp, ec)
    ref_algo = ref_engine._doers(ref_ep)[2][0]
    ref_model = ref_algo.prepare_model_for_deploy(rctx, ref_model)
    engine = ec.ECommerceEngine.apply()
    ep = EngineParams(
        datasource=("", ec.DataSourceParams(app_name="shopapp")),
        algorithms=[("ecomm", ec.ECommAlgorithmParams(
            app_name="shopapp", **ALS))])
    ctx = create_workflow_context(shop.port, device="cpu")
    engine.train(ctx, ep)
    mp.undo()
    ep = EngineParams(
        datasource=ep.datasource,
        algorithms=[("ecomm", ec.ECommAlgorithmParams(
            app_name="shopapp", **ALS_FULL))])
    (model,) = engine.train(ctx, ep)
    # serve path: a fresh doer + prepare_model_for_deploy binds the
    # serve-time event store (what load_models does at deploy)
    algo = engine._doers(ep)[2][0]
    model = algo.prepare_model_for_deploy(ctx, model)
    # cold users with recent views and a live constraint, written after
    # training (the reference's batch case)
    shop.port.get_events().insert_batch([
        _ev("view", "cold-a", "i15", 9000), _ev("view", "cold-a", "i16", 9001),
        _ev("view", "cold-b", "i2", 9002),
        _set("constraint", "unavailableItems", {"items": ["i3"]},
             minute=9999)], shop.app_id)
    return dict(ref=ref_model, ref_algo=ref_algo, ref_params=seen[0],
                params=port_seen[0], model=model, algo=algo, engine=engine,
                ep=ep, ctx=ctx)


def test_ecommerce_trains_with_the_reference_params(shop_models):
    assert _fields(shop_models["params"]) == _fields(
        shop_models["ref_params"])


def _carried(shop_models):
    ref = shop_models["ref"]
    return convert.ecommerce_model_from_numpy(
        np.asarray(ref.factors.user_factors),
        np.asarray(ref.factors.item_factors), ref.users.ids(),
        ref.items.ids(), ref.item_categories, device="cpu")


def test_ecommerce_converted_model_answers_as_reference(shop_models):
    """Same ids as the reference on the reference's factors: seen items
    dropped, the unavailable item dropped, cold users from their recent
    views, categories and whiteList ranked within; batch = solo."""
    model = _carried(shop_models)
    algo, ref_algo = shop_models["algo"], shop_models["ref_algo"]
    answers = [algo.predict(model, q) for q in SHOP_QUERIES]
    for q, got in zip(SHOP_QUERIES, answers):
        _same_answer(got, ref_algo.predict(shop_models["ref"], q), q)
        assert all(s["item"] != "i3" for s in got["itemScores"])
    assert answers[2]["itemScores"], "a cold user with views gets results"
    assert answers[3] == {"itemScores": []}
    assert algo.batch_predict(model, SHOP_QUERIES) == answers


def test_ecommerce_reference_cases_on_the_port_model(shop, shop_models):
    """tests/test_templates.py's seen-items, cold-start and category
    cases, and a just-bought item dropping out of the next answer."""
    model, algo = shop_models["model"], shop_models["algo"]
    seen = {e.target_entity_id for e in shop.port.get_events().find(
        shop.app_id, entity_type="user", entity_id="u0",
        event_names=["view", "buy"], limit=-1)}
    items = {s["item"] for s in algo.predict(
        model, {"user": "u0", "num": 8})["itemScores"]}
    assert items and not (items & seen)
    first = algo.predict(model, {"user": "u5", "num": 3})["itemScores"][0]
    shop.port.get_events().insert(
        _ev("buy", "u5", first["item"], 9500), shop.app_id)
    assert first["item"] not in [s["item"] for s in algo.predict(
        model, {"user": "u5", "num": 3})["itemScores"]]
    shop.port.get_events().insert_batch(
        [_ev("view", "newbie", "i15", 9000), _ev("view", "newbie", "i16",
                                                 9001)], shop.app_id)
    got = [s["item"] for s in algo.predict(
        model, {"user": "newbie", "num": 5})["itemScores"]]
    assert sum(1 for it in got if int(it[1:]) >= 10) >= 3, got
    assert algo.predict(model, {"user": "ghost", "num": 5}) == {
        "itemScores": []}
    r = algo.predict(model, {"user": "u2", "num": 5, "categories": ["catB"]})
    assert all(int(s["item"][1:]) >= 10 for s in r["itemScores"])
    assert algo.batch_predict(model, SHOP_QUERIES) == [
        algo.predict(model, q) for q in SHOP_QUERIES]


def test_ecommerce_constraint_ttl_and_outage(shop, shop_models):
    """Within the TTL the cached set serves without a read; after expiry
    the next query reads again; through a storage outage the last good
    set serves (the reference drops to it too) and the expiry re-arms
    at most a second ahead."""
    engine, ep, ctx = (shop_models[k] for k in ("engine", "ep", "ctx"))
    algo = engine._doers(ep)[2][0]
    algo.params = dataclasses.replace(algo.params, constraint_cache_ttl_s=60.0)
    model = algo.prepare_model_for_deploy(ctx, shop_models["model"])
    before = [s["item"] for s in algo.predict(
        model, {"user": "u1", "num": 5})["itemScores"]]
    shop.port.get_events().insert(
        _set("constraint", "unavailableItems", {"items": ["i3", before[0]]},
             minute=9998 + 2), shop.app_id)
    calls = {"n": 0}
    store = algo._event_store
    real = store.aggregate_properties

    def counting(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    store.aggregate_properties = counting
    stale = [s["item"] for s in algo.predict(
        model, {"user": "u1", "num": 5})["itemScores"]]
    assert before[0] in stale and calls["n"] == 0
    algo._constraint_cache = (ec.time.monotonic() - 1,
                              algo._constraint_cache[1])
    fresh = [s["item"] for s in algo.predict(
        model, {"user": "u1", "num": 5})["itemScores"]]
    assert before[0] not in fresh and calls["n"] == 1

    def down(*a, **k):
        raise ConnectionError("storage down")

    store.aggregate_properties = down
    algo._constraint_cache = (ec.time.monotonic() - 1,
                              algo._constraint_cache[1])
    t0 = ec.time.monotonic()
    assert algo._unavailable_items() == {"i3", before[0]}
    assert algo._constraint_cache[0] <= t0 + 1.0 + 0.5


# -- the verbs: train, then deploy over HTTP -------------------------------

VARIANTS = {
    "similarproduct": ("pio_tpu_torch.models.similarproduct."
                       "SimilarProductEngine", "simapp",
                       [{"name": "als", "params": ALS}],
                       [{"items": ["i0", "i1"], "num": 4},
                        {"items": ["i3"], "num": 3, "categories": ["catB"]}]),
    "similarproduct-dimsum": (
        "pio_tpu_torch.models.similarproduct.SimilarProductEngine",
        "simapp", [{"name": "dimsum", "params": {"threshold": 0.1,
                                                 "k_sim": 5}}],
        [{"items": ["i0", "i1"], "num": 4}]),
}


def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/queries.json",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.status, json.loads(r.read())


@contextlib.contextmanager
def train_and_serve(storage, tmp_path, name, factory, app, algorithms,
                    queries, monkeypatch):
    """`train --device cpu` of an engine.json, then the stored instance
    served over HTTP: every body equals the in-process predict. Yields
    (port, query server) while it serves."""
    from pio_tpu_torch.__main__ import _engine_from_variant

    d = tmp_path / name
    d.mkdir()
    variant = {"id": name, "engineFactory": factory,
               "datasource": {"params": {"app_name": app}},
               "algorithms": algorithms}
    (d / "engine.json").write_text(json.dumps(variant))
    monkeypatch.setattr("pio_tpu_torch.__main__.get_storage",
                        lambda: storage)
    assert port_main(["train", "--engine-dir", str(d), "--device",
                      "cpu"]) == 0
    engine, ep = _engine_from_variant(variant, str(d))
    http, qs = create_query_server(
        engine, ep, storage,
        ServingConfig(ip="127.0.0.1", port=0, engine_id=name),
        ctx=create_workflow_context(storage, device="cpu"))
    http.start()
    try:
        for q in queries:
            status, body = _post(http.port, q)
            assert status == 200
            assert body == qs.algorithms[0].predict(qs.models[0], q)
            assert body.get("itemScores") or "label" in body
        yield http.port, qs
    finally:
        http.stop()
        qs.close()


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_similarproduct_variants_train_and_deploy(sim, tmp_path, name,
                                                  monkeypatch):
    with train_and_serve(sim.port, tmp_path, name, *VARIANTS[name],
                         monkeypatch=monkeypatch):
        pass


def test_ecommerce_trains_and_deploys(shop, tmp_path, monkeypatch):
    """The deploy binds its store on the instance that serves: an item
    marked unavailable and an item the user just bought drop out of the
    next answer over HTTP."""
    algos = [{"name": "ecomm", "params": {**ALS, "app_name": "shopapp"}}]
    with train_and_serve(
            shop.port, tmp_path, "ecommerce",
            "pio_tpu_torch.models.ecommerce.ECommerceEngine", "shopapp",
            algos, [{"user": "u6", "num": 4}, {"user": "cold-b", "num": 3}],
            monkeypatch) as (port, qs):
        _, body = _post(port, {"user": "u7", "num": 4})
        top = [s["item"] for s in body["itemScores"]]
        events = shop.port.get_events()
        events.insert(_set("constraint", "unavailableItems",
                           {"items": [top[0]]}, minute=9999 + 5),
                      shop.app_id)
        events.insert(_ev("buy", "u7", top[1], 9600), shop.app_id)
        _, after = _post(port, {"user": "u7", "num": 4})
        got = [s["item"] for s in after["itemScores"]]
        assert top[0] not in got and top[1] not in got, (top, got)
        assert after == qs.algorithms[0].predict(qs.models[0],
                                                 {"user": "u7", "num": 4})


@pytest.mark.parametrize("factory, algo", [
    ("pio_tpu_torch.models.similarproduct.SimilarProductEngine", "als"),
    ("pio_tpu_torch.models.ecommerce.ECommerceEngine", "ecomm")])
def test_fleet_deploy_refuses_the_other_templates(tmp_path, monkeypatch,
                                                   capsys, factory, algo):
    """``deploy --shards`` serves the recommendation template's factor
    tables only: these engines are refused before anything boots."""
    (tmp_path / "engine.json").write_text(json.dumps({
        "id": "other", "engineFactory": factory,
        "datasource": {"params": {"app_name": "x"}},
        "algorithms": [{"name": algo, "params": {}}]}))
    monkeypatch.setattr("pio_tpu_torch.__main__.get_storage",
                        lambda: None)
    assert port_main(["deploy", "--engine-dir", str(tmp_path), "--shards",
                      "2", "--device", "cpu"]) == 1
    assert "--shards serves the recommendation template" in \
        capsys.readouterr().err


def test_foldin_refuses_a_model_without_factor_tables(sim, sim_models):
    """The fold-in worker and the fleet resolve their model through
    ``resolve_fleet_model``, which refuses the other templates' models
    with a clear error."""
    from pio_tpu_torch.serving_fleet.fleet import resolve_fleet_model
    from pio_tpu_torch.workflow.train import persist_models

    engine = sp.SimilarProductEngine.apply()
    ep = EngineParams(
        datasource=("", sp.DataSourceParams(app_name="simapp")),
        algorithms=[("als", sp.ALSAlgorithmParams(**ALS))])
    iid = persist_models([sim_models["model"]], ep, sim.port,
                         engine_id="sim-foldin")
    with pytest.raises(ValueError, match="factor-table model"):
        resolve_fleet_model(sim.port, "sim-foldin", instance_id=iid,
                            device="cpu")
