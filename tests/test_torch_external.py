"""The external-engine bridge of the port against the JAX package, and the
verbs' handling of the engine-dir-relative paths and the fleet refusals
for this slice's templates, on the CPU.

Both packages drive ``examples/external-engine/engine_server.py`` (stdlib
only) over the same stdio JSON protocol on the same sqlite events: the
stored model is the same JSON and every answer, solo or through
``/batch/queries.json``, is equal (the engine's answers are exact).
``tests/test_examples.py``'s protocol, bad-command and hang-timeout cases
run on the port; an engine without ``predict_batch`` falls back to
per-query predicts; the committed example trains through the verb from
another working directory, its relative ``workdir`` resolved against
``--engine-dir``; and ``deploy --shards`` refuses every template of the
slice before anything boots.
"""

import _torch_cpu  # noqa: F401  (one CPU thread: see the module)
import json
import os
import sys

import pytest

from pio_tpu.data.storage import Storage as RefStorage
from pio_tpu.tools.cli import _engine_from_variant as ref_engine_from_variant
from pio_tpu.workflow.context import create_workflow_context as ref_context
from pio_tpu_torch.__main__ import _engine_from_variant, main as port_main
from pio_tpu_torch.controller import external as ext
from pio_tpu_torch.data.dao import App
from pio_tpu_torch.data.datamap import DataMap
from pio_tpu_torch.data.event import Event
from pio_tpu_torch.data.storage import Storage
from pio_tpu_torch.workflow.context import create_workflow_context
from pio_tpu_torch.workflow.train import run_train

import _torch_verbs as verbs

FACTORY = "pio_tpu_torch.controller.external.ExternalEngine"
EXAMPLE = os.path.join(verbs.EXAMPLES, "external-engine")
QUERIES = [{"user": "u0", "num": 3}, {"user": "u1", "num": 4},
           {"user": "brand-new", "num": 2}, {"user": "u7", "num": 20}]


def _seed(storage, app_name="MyApp", n_users=30, n_items=12):
    """tests/test_examples.py's block-structured ratings: users rate the
    items of their parity."""
    app_id = storage.get_metadata_apps().insert(App(0, app_name))
    ev = storage.get_events()
    ev.init(app_id)
    ev.insert_batch([
        Event(event="rate", entity_type="user", entity_id=f"u{u}",
              target_entity_type="item", target_entity_id=f"i{i}",
              properties=DataMap({"rating": 5}))
        for u in range(n_users) for i in range(n_items) if (u + i) % 2 == 0],
        app_id)
    return app_id


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("external")
    env = verbs.sqlite_env(tmp / "pio.db")
    storage = Storage(env=env)
    _seed(storage)
    ref = RefStorage(env=env)
    yield storage, ref
    storage.close()
    ref.close()


def _example_variant():
    with open(os.path.join(EXAMPLE, "engine.json")) as f:
        return json.load(f)


def test_protocol_train_and_serve_as_reference(store):
    """The example engine trained and served by both packages: the same
    stored model, equal answers, the reference's popularity and
    seen-filter cases, the batch route through predict_batch."""
    storage, ref_storage = store
    variant = {**_example_variant(), "engineFactory": FACTORY}
    engine, ep = _engine_from_variant(variant, EXAMPLE)
    assert ep.algorithms[0][1].workdir == os.path.join(
        os.path.abspath(EXAMPLE), ".")
    run_train(engine, ep, storage, engine_id="external-engine",
              ctx=create_workflow_context(storage, device="cpu"))
    ref_engine, ref_ep = ref_engine_from_variant(_example_variant(),
                                                 EXAMPLE)
    (ref_model,) = ref_engine.train(ref_context(ref_storage, use_mesh=False),
                                    ref_ep)
    with verbs.deployed(EXAMPLE, storage, "external-engine") as (port, qs):
        model = qs.models[0]
        assert model == ref_model
        ref_algo = ref_engine._doers(ref_ep)[2][0]
        try:
            bodies = verbs.served_as_in_process(port, qs, QUERIES)
            assert bodies == [ref_algo.predict(ref_model, q)
                              for q in QUERIES]
        finally:
            ref_algo.close()
        items = [s["item"] for s in bodies[0]["itemScores"]]
        assert len(items) == 3 and all(int(i[1:]) % 2 == 1 for i in items)
        scores = [s["score"] for s in bodies[1]["itemScores"]]
        assert scores == sorted(scores, reverse=True)
        assert len(bodies[2]["itemScores"]) == 2
        status, batch = verbs.post(port, QUERIES[:2], "/batch/queries.json")
        assert status == 200 and batch == bodies[:2]


def test_bad_command_fails_cleanly():
    algo = ext.ExternalAlgorithm(ext.ExternalAlgorithmParams(
        command=("/nonexistent/engine-binary",)))
    with pytest.raises(ext.ExternalEngineError, match="cannot spawn"):
        algo.train(None, [])


def test_hang_times_out(tmp_path):
    """A wedged engine must not block train forever: the bridge enforces
    its timeout and kills the child."""
    hang = tmp_path / "hang.py"
    hang.write_text("import time\nwhile True: time.sleep(1)\n")
    algo = ext.ExternalAlgorithm(ext.ExternalAlgorithmParams(
        command=(sys.executable, str(hang)), timeout=2.0, train_timeout=2.0))
    with pytest.raises(ext.ExternalEngineError, match="did not answer"):
        algo.train(None, [])


def test_engine_without_predict_batch_falls_back(tmp_path):
    """An engine that refuses predict_batch as an unknown method is asked
    query by query from then on; its answers are the solo ones."""
    server = tmp_path / "solo_only.py"
    with open(os.path.join(EXAMPLE, "engine_server.py")) as f:
        src = f.read()
    server.write_text(src.replace(
        '    "predict_batch": handle_predict_batch,\n', ""))
    algo = ext.ExternalAlgorithm(ext.ExternalAlgorithmParams(
        command=(sys.executable, str(server)), config={"top_n": 5}))
    events = [{"entityId": f"u{u}", "targetEntityId": f"i{i}"}
              for u in range(4) for i in range(u + 3)]
    model = algo.train(None, events)
    assert model["engine"] == "popularity-ranker"
    try:
        solo = [algo.predict(model, q) for q in QUERIES]
        assert algo.batch_predict(model, QUERIES) == solo
        assert algo._batch_unsupported
        assert solo[0]["itemScores"] == [
            {"item": "i3", "score": 3.0}, {"item": "i4", "score": 2.0}]
    finally:
        algo.close()


def test_engine_dir_relative_workdir_train_and_deploy(tmp_path,
                                                      monkeypatch):
    """The committed example copied and trained through the verb from
    another working directory: the child starts in the engine dir (its
    relative ``workdir`` "." resolved against --engine-dir), and the
    deploy answers every query as the in-process composition does."""
    d = tmp_path / "external"
    verbs.copy_example("external-engine", d, FACTORY)
    elsewhere = tmp_path / "elsewhere"
    elsewhere.mkdir()
    storage = Storage(env=verbs.sqlite_env(tmp_path / "pio.db"))
    _seed(storage)
    assert verbs.train_in_process(d, storage, monkeypatch, elsewhere) == 0
    with verbs.deployed(d, storage, "external-engine") as (port, qs):
        assert qs.algorithms[0].params.workdir == os.path.join(str(d), ".")
        bodies = verbs.served_as_in_process(port, qs, QUERIES)
        assert all(b["itemScores"] for b in bodies)
        assert verbs.batchpredict(d, storage, monkeypatch, QUERIES,
                                  tmp_path) == bodies
    storage.close()


@pytest.mark.parametrize("factory, algo", [
    ("pio_tpu_torch.models.twotower.TwoTowerEngine", "twotower"),
    ("pio_tpu_torch.models.regression.RegressionEngine", "ridge"),
    ("pio_tpu_torch.models.stock.StockEngine", "regression"),
    ("pio_tpu_torch.models.friendrecommendation.FriendRecommendationEngine",
     "simrank"),
    (FACTORY, "external")])
def test_fleet_deploy_refuses_the_slice_templates(tmp_path, monkeypatch,
                                                  capsys, factory, algo):
    (tmp_path / "engine.json").write_text(json.dumps({
        "id": "other", "engineFactory": factory,
        "datasource": {"params": {}},
        "algorithms": [{"name": algo, "params": {}}]}))
    monkeypatch.setattr("pio_tpu_torch.__main__.get_storage", lambda: None)
    assert port_main(["deploy", "--engine-dir", str(tmp_path), "--shards",
                      "2", "--device", "cpu"]) == 1
    assert "--shards serves the recommendation template" in \
        capsys.readouterr().err
