"""The port's deploy server: output plugins, feedback events and the
``/profile/*`` device trace, as the JAX package's ``tests/test_serve.py``
holds the reference's (its output plugin, feedback and plugin-route
cases), on the CPU:

  * an output blocker rewrites every answer, solo and batched, and the
    plugged answers' ids equal the JAX ``QueryServer``'s with the same
    plugin on the same seeded factors, the scores within ``RTOL``/``ATOL``;
  * ``feedback=True`` records each recorded query as a ``pio_pr``
    ``predict`` event in the feedback app (on a detached thread), never
    a warm-up, and rewrites a prediction's ``prId`` as the reference
    does; ``deploy --feedback --feedback-app`` as a process;
  * ``/plugins.json`` and ``/plugins/<name>/*``;
  * ``/profile/start`` and ``/profile/stop``: server-key guarded, a
    torch.profiler trace file written, 409 on a second start and on a
    stop with none running.
"""

import _torch_cpu  # noqa: F401  (one CPU thread: see the module)
import glob
import json
import os
import socket
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

from pio_tpu.data.bimap import EntityIdIndex as RefIdIndex
from pio_tpu.data.dao import EngineInstance as RefEngineInstance
from pio_tpu.data.dao import Model as RefModel
from pio_tpu.data.storage import Storage as RefStorage
from pio_tpu.models import recommendation as ref_rec
from pio_tpu.ops import als as ref_als
from pio_tpu.server.plugins import EngineServerPlugin as RefPlugin
from pio_tpu.server.plugins import PluginContext as RefPluginContext
from pio_tpu.workflow.checkpoint import models_to_bytes as ref_models_to_bytes
from pio_tpu.workflow.context import create_workflow_context as ref_ctx
from pio_tpu.workflow.serve import QueryServer as RefQueryServer
from pio_tpu.workflow.serve import ServingConfig as RefServingConfig
from pio_tpu_torch.convert import recommendation_model_from_numpy
from pio_tpu_torch.data.dao import App
from pio_tpu_torch.data.datamap import DataMap
from pio_tpu_torch.data.event import Event
from pio_tpu_torch.data.storage import Storage
from pio_tpu_torch.models import recommendation as port_rec
from pio_tpu_torch.server.plugins import EngineServerPlugin, PluginContext
from pio_tpu_torch.workflow.context import create_workflow_context
from pio_tpu_torch.workflow.serve import (
    QueryServer,
    ServingConfig,
    create_query_server,
)
from pio_tpu_torch.workflow.train import persist_models, run_train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FACTORY = "pio_tpu_torch.models.recommendation.RecommendationEngine"
T0 = datetime(2026, 1, 1, tzinfo=timezone.utc)
KEY = "SRVKEY"
# the JAX package's scores on the same factors: the same f32 dots summed
# in another order, doubled by the plugin
RTOL = 1e-5
ATOL = 1e-5


def _env(path) -> dict:
    return {
        "PIO_STORAGE_SOURCES_SQL_TYPE": "sqlite",
        "PIO_STORAGE_SOURCES_SQL_PATH": str(path / "pio.db"),
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "SQL",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "SQL",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "SQL",
    }


def _variant() -> dict:
    return {"id": "rec", "engineFactory": FACTORY,
            "datasource": {"params": {"app_name": "mlapp"}},
            "algorithms": [{"name": "als", "params": {
                "rank": 4, "num_iterations": 6, "lambda_": 0.05,
                "chunk": 1024}}]}


def _doubler(base):
    """The reference test's output blocker: every score doubled."""

    class Doubler(base):
        plugin_name = "score-doubler"
        plugin_type = base.OUTPUT_BLOCKER

        def process(self, query, prediction, context):
            return {"itemScores": [dict(s, score=s["score"] * 2)
                                   for s in prediction["itemScores"]]}

    return Doubler()


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


@pytest.fixture()
def deployed(tmp_path, monkeypatch):
    """The reference test's deploy: its events (20 users x 12 items)
    trained by the port on the CPU, the score doubler, feedback into the
    events' app, a server key and a warm query."""
    monkeypatch.setenv("PIO_TPU_CKPT_ROOT", str(tmp_path / "ckpt"))
    storage = Storage(env=_env(tmp_path))
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
    ep = engine.engine_params_from_variant(_variant())
    ctx = create_workflow_context(storage, device="cpu")
    iid = run_train(engine, ep, storage, engine_id="rec",
                    engine_factory=FACTORY, ctx=ctx)
    http, qs = create_query_server(
        engine, ep, storage,
        ServingConfig(ip="127.0.0.1", port=0, engine_id="rec",
                      feedback=True, feedback_app_name="mlapp",
                      server_key=KEY,
                      warm_query={"user": "u0", "num": 3}),
        ctx=ctx, plugin_context=PluginContext([_doubler(EngineServerPlugin)]))
    http.start()
    plain = QueryServer(engine, ep, storage,
                        ServingConfig(engine_id="rec"), ctx=ctx,
                        instance_id=iid)
    yield http, qs, plain, storage, app_id, iid
    http.stop()
    qs.close()
    plain.close()
    storage.close()


def _predict_events(storage, app_id, want: int, timeout_s: float = 10.0):
    """The app's pio_pr events once ``want`` of them landed (feedback is
    written on a detached thread)."""
    deadline = time.monotonic() + timeout_s
    while True:
        found = list(storage.get_events().find(
            app_id, entity_type="pio_pr", limit=-1))
        if len(found) >= want or time.monotonic() > deadline:
            return found
        time.sleep(0.02)


def test_output_plugin_applied(deployed):
    http, qs, plain, *_ = deployed
    for q in ({"user": "u0", "num": 2}, {"user": "u3", "num": 4,
                                          "blackList": ["i1"]}):
        status, body = call(http.port, "POST", "/queries.json", q)
        assert status == 200
        want = plain.query(dict(q), record=False)
        assert body == {"itemScores": [dict(s, score=s["score"] * 2)
                                       for s in want["itemScores"]]}
    # score-doubler doubled ALS scores (~5) to ~10
    assert body["itemScores"][0]["score"] > 6
    # the batch route runs the blocker on each answer too
    status, batch = call(http.port, "POST", "/batch/queries.json",
                         [{"user": "u0", "num": 2}, {"user": "u5",
                                                     "num": 3}])
    assert status == 200
    assert batch[0] == call(http.port, "POST", "/queries.json",
                            {"user": "u0", "num": 2})[1]


def test_feedback_records_predict_event(deployed):
    http, qs, plain, storage, app_id, iid = deployed
    # the warm query ran unrecorded: no event for it
    assert _predict_events(storage, app_id, 1, timeout_s=0.3) == []
    status, body = call(http.port, "POST", "/queries.json",
                        {"user": "u2", "num": 2})
    assert status == 200
    found = _predict_events(storage, app_id, 1)
    assert len(found) == 1, "no feedback event recorded"
    e = found[0]
    assert e.event == "predict" and e.entity_type == "pio_pr"
    assert len(e.entity_id) == 64
    props = e.properties
    assert props.get("query") == {"user": "u2", "num": 2}
    assert props.get("engineInstanceId") == iid
    # the event holds the engine's prediction, before the output plugin
    assert props.get("prediction") == plain.query(
        {"user": "u2", "num": 2}, record=False)
    status, _ = call(http.port, "POST", "/batch/queries.json",
                     [{"user": f"u{u}", "num": 2} for u in range(3)])
    assert status == 200
    assert len(_predict_events(storage, app_id, 4)) == 4


def test_feedback_rewrites_pr_id(deployed):
    """A prediction that carries a ``prId`` answers with the event's id;
    the query's ``prId`` becomes the event's."""
    _, qs, _, storage, app_id, iid = deployed
    out, event = qs._feedback_event({"user": "u1", "prId": "q-7"},
                                    {"itemScores": [], "prId": ""}, iid)
    qs._send_feedback([event])
    (e,) = _predict_events(storage, app_id, 1)
    assert out["prId"] == e.entity_id and len(out["prId"]) == 64
    assert e.pr_id == "q-7"
    out, event = qs._feedback_event(
        {"user": "u1"}, {"itemScores": [], "prId": "mine"}, iid)
    qs._send_feedback([event])
    assert out["prId"] == "mine"
    ids = {x.entity_id for x in _predict_events(storage, app_id, 2)}
    assert "mine" in ids


def test_plugins_routes(deployed):
    http, *_ = deployed
    status, body = call(http.port, "GET", "/plugins.json")
    assert status == 200
    assert body == {"plugins": {"score-doubler": {"type": "outputblocker"}}}
    status, _ = call(http.port, "GET", "/plugins/score-doubler/info")
    assert status == 200
    assert call(http.port, "GET", "/plugins/nope/info")[0] == 404


def test_profile_start_stop_writes_a_trace(deployed, tmp_path):
    http, *_ = deployed
    logdir = str(tmp_path / "profile")
    assert call(http.port, "POST", "/profile/start", logdir=logdir)[0] == 401
    assert call(http.port, "POST", "/profile/stop")[0] == 401
    assert call(http.port, "POST", "/profile/stop", accessKey=KEY)[0] == 409
    status, out = call(http.port, "POST", "/profile/start", accessKey=KEY,
                       logdir=logdir)
    assert status == 200 and out["logdir"] == logdir
    status, out = call(http.port, "POST", "/profile/start", accessKey=KEY,
                       logdir=logdir)
    assert status == 409 and out["message"] == "profile already running"
    for u in range(16):
        assert call(http.port, "POST", "/queries.json",
                    {"user": f"u{u}", "num": 3})[0] == 200
    status, out = call(http.port, "POST", "/profile/stop", accessKey=KEY)
    assert status == 200 and out["logdir"] == logdir
    (trace,) = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    with open(trace) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    # the queries' scoring ran on the request threads and was recorded
    assert any(n and n.startswith("aten::") for n in names)
    assert call(http.port, "POST", "/profile/stop", accessKey=KEY)[0] == 409


# -- against the JAX package ---------------------------------------------------

def test_plugged_answers_match_the_reference(tmp_path):
    """The same seeded factors in a store of each package, each deploy
    with the same doubler: equal ids, scores within RTOL/ATOL."""
    rng = np.random.default_rng(31)
    users = [f"u{i}" for i in range(30)]
    items = [f"i{i}" for i in range(200)]
    uf = rng.standard_normal((30, 8)).astype(np.float32)
    itf = rng.standard_normal((200, 8)).astype(np.float32)
    variant = {"id": "rec", "engineFactory": FACTORY,
               "algorithms": [{"name": "als", "params": {"rank": 8}}]}
    (tmp_path / "port").mkdir()
    (tmp_path / "ref").mkdir()
    storage = Storage(env=_env(tmp_path / "port"))
    engine = port_rec.RecommendationEngine.apply()
    ep = engine.engine_params_from_variant(variant)
    persist_models([recommendation_model_from_numpy(
        uf, itf, users, items, device="cpu")], ep, storage, "rec",
        engine_factory=FACTORY)
    port = QueryServer(engine, ep, storage, ServingConfig(engine_id="rec"),
                       ctx=create_workflow_context(storage, device="cpu"),
                       plugin_context=PluginContext(
                           [_doubler(EngineServerPlugin)]))
    ref_store = RefStorage(env=_env(tmp_path / "ref"))
    ref_engine = ref_rec.RecommendationEngine.apply()
    ref_store.get_metadata_engine_instances().insert(RefEngineInstance(
        id="", status="COMPLETED", start_time=T0, end_time=T0,
        engine_id="rec", engine_version="1", engine_variant="default",
        engine_factory="pio_tpu.models.recommendation.RecommendationEngine"))
    iid = ref_store.get_metadata_engine_instances().get_completed(
        "rec", "1", "default")[0].id
    ref_store.get_model_data_models().insert(RefModel(
        iid, ref_models_to_bytes([ref_rec.RecommendationModel(
            ref_als.ALSModel(jnp.asarray(uf), jnp.asarray(itf)),
            RefIdIndex(users), RefIdIndex(items))])))
    ref = RefQueryServer(
        ref_engine, ref_engine.engine_params_from_variant(
            {**variant, "engineFactory":
             "pio_tpu.models.recommendation.RecommendationEngine"}),
        ref_store, RefServingConfig(ip="127.0.0.1", port=0, engine_id="rec"),
        ctx=ref_ctx(ref_store, use_mesh=False),
        plugin_context=RefPluginContext([_doubler(RefPlugin)]))
    try:
        queries = [{"user": f"u{u}", "num": 6} for u in range(30)]
        queries[2]["blackList"] = ["i5", "i9"]
        for got, want in ((port.query_batch(queries),
                           ref.query_batch(queries)),
                          ([port.query(q) for q in queries],
                           [ref.query(q) for q in queries])):
            for q, g, w in zip(queries, got, want):
                assert [s["item"] for s in g["itemScores"]] == \
                    [s["item"] for s in w["itemScores"]], q
                np.testing.assert_allclose(
                    [s["score"] for s in g["itemScores"]],
                    [s["score"] for s in w["itemScores"]],
                    rtol=RTOL, atol=ATOL)
    finally:
        port.close()
        ref.close()
        storage.close()
        ref_store.close()


def test_deploy_feedback_flags_subprocess(deployed, tmp_path):
    """``python -m pio_tpu_torch deploy --feedback --feedback-app`` as a
    process: each answered query lands as a predict event in that app."""
    _, _, _, storage, app_id, iid = deployed
    eng = tmp_path / "eng"
    eng.mkdir()
    (eng / "engine.json").write_text(json.dumps(_variant()))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, **_env(tmp_path),
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", "pio_tpu_torch", "deploy", "--engine-dir",
         str(eng), "--ip", "127.0.0.1", "--port", str(port), "--device",
         "cpu", "--engine-instance-id", iid, "--feedback",
         "--feedback-app", "mlapp", "--server-key", "SK"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=REPO)
    try:
        line = proc.stdout.readline()
        assert f"deployed on http://127.0.0.1:{port} (cpu)" in line, (
            line + (proc.stdout.read() if proc.poll() is not None else ""))
        before = len(_predict_events(storage, app_id, 0))
        for u in range(3):
            assert call(port, "POST", "/queries.json",
                        {"user": f"u{u}", "num": 2})[0] == 200
        found = _predict_events(storage, app_id, before + 3)
        assert len(found) == before + 3
        assert call(port, "POST", "/stop", accessKey="SK")[0] == 200
        proc.wait(timeout=60)
        assert proc.returncode == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
