"""The port's deploy server lifecycle, as the JAX package's tests hold it.

Counterparts of ``tests/test_serve.py``'s stop and reload auth, warm
query, adaptive backpressure, micro-batching, concurrent reloads, hedged
dispatch and Prometheus cases, and of ``tests/test_cli_verbs.py``'s
deploy/undeploy subprocess case, on a model the port trains on the CPU
(the reference tests' 20 users x 12 items). Also: a failed reload keeps
serving the last-good model with 503, the request budget answers 503 +
Retry-After, HTTPS from ``certfile``/``keyfile``, the dispatch-RTT
probe, and the fold-in worker's ``/healthz`` on both transports.
"""

import _torch_cpu  # noqa: F401  (one CPU thread: see the module)
import json
import os
import socket
import ssl
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from datetime import datetime, timedelta, timezone

import numpy as np
import pytest

from pio_tpu_torch.data.dao import App, EngineInstance
from pio_tpu_torch.data.datamap import DataMap
from pio_tpu_torch.data.event import Event
from pio_tpu_torch.data.storage import Storage
from pio_tpu_torch.freshness import FoldInConfig, FoldInWorker
from pio_tpu_torch.freshness.folder import create_foldin_server
from pio_tpu_torch.models import recommendation as port_rec
from pio_tpu_torch.ops import als
from pio_tpu_torch.server.http import AsyncHttpServer, HttpServer
from pio_tpu_torch.workflow import serve as serve_mod
from pio_tpu_torch.workflow.context import create_workflow_context
from pio_tpu_torch.workflow.serve import ServingConfig, create_query_server
from pio_tpu_torch.workflow.train import run_train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FACTORY = "pio_tpu_torch.models.recommendation.RecommendationEngine"
T0 = datetime(2026, 1, 1, tzinfo=timezone.utc)
KEY = "SRVKEY"


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


def _seed(storage) -> None:
    """The reference tests' events: 20 users x 12 items, two tastes."""
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


def _train(storage, ctx):
    engine = port_rec.RecommendationEngine.apply()
    ep = engine.engine_params_from_variant(_variant())
    iid = run_train(engine, ep, storage, engine_id="rec",
                    engine_factory=FACTORY, ctx=ctx)
    return engine, ep, iid


@pytest.fixture()
def trained(tmp_path, monkeypatch):
    monkeypatch.setenv("PIO_TPU_CKPT_ROOT", str(tmp_path / "ckpt"))
    monkeypatch.setenv("PIO_TPU_COMPILE_CACHE", str(tmp_path / "cache"))
    storage = Storage(env=_env(tmp_path))
    _seed(storage)
    ctx = create_workflow_context(storage, device="cpu")
    engine, ep, iid = _train(storage, ctx)
    yield storage, engine, ep, ctx, iid
    storage.close()


def _serve(trained, **cfg):
    storage, engine, ep, ctx, _ = trained
    http, qs = create_query_server(
        engine, ep, storage,
        ServingConfig(ip="127.0.0.1", port=0, engine_id="rec", **cfg),
        ctx=ctx)
    http.start()
    return http, qs


def call(port, method, path, body=None, scheme="http", context=None,
         **params):
    url = f"{scheme}://127.0.0.1:{port}{path}"
    if params:
        url += "?" + urllib.parse.urlencode(params)
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=30,
                                    context=context) as resp:
            return resp.status, json.loads(resp.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode() or "{}")


def test_stop_and_reload_auth(trained):
    storage, engine, ep, ctx, iid = trained
    http, qs = _serve(trained, server_key=KEY)
    try:
        assert http.__class__ is AsyncHttpServer     # the default transport
        assert call(http.port, "GET", "/reload")[0] == 401
        assert call(http.port, "POST", "/reload")[0] == 401
        assert call(http.port, "POST", "/stop")[0] == 401
        assert not qs._stop_requested.is_set()
        # train a second instance; an authorized reload hot-swaps to it
        _, _, iid2 = _train(storage, ctx)
        status, body = call(http.port, "POST", "/reload", accessKey=KEY)
        assert status == 200 and body["engineInstanceId"] == iid2
        assert call(http.port, "GET", "/")[1]["engineInstance"]["id"] == iid2
        status, body = call(http.port, "GET", "/reload", accessKey=KEY)
        assert status == 200 and body["engineInstanceId"] == iid2
        status, body = call(http.port, "POST", "/stop", accessKey=KEY)
        assert status == 200
        assert qs._stop_requested.is_set()
    finally:
        http.stop()
        qs.close()


def test_failed_reload_keeps_serving_last_good(trained):
    """A COMPLETED instance whose model blob is missing: /reload answers
    503 + Retry-After with the id still served, queries keep answering
    from the last-good model, /readyz shows the error and stays ready."""
    storage, engine, ep, ctx, iid = trained
    http, qs = _serve(trained, server_key=KEY)
    try:
        before = call(http.port, "POST", "/queries.json",
                      {"user": "u1", "num": 3})
        storage.get_metadata_engine_instances().insert(EngineInstance(
            id="", status="COMPLETED", start_time=T0 + timedelta(days=400),
            end_time=T0 + timedelta(days=400), engine_id="rec",
            engine_version="1", engine_variant="default",
            engine_factory=FACTORY))
        req = urllib.request.Request(
            f"http://127.0.0.1:{http.port}/reload?accessKey={KEY}",
            method="POST")
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=30)
        assert err.value.code == 503
        assert err.value.headers["Retry-After"] == "1"
        body = json.loads(err.value.read())
        assert body["engineInstanceId"] == iid
        assert "last-good" in body["message"]
        assert call(http.port, "POST", "/queries.json",
                    {"user": "u1", "num": 3}) == before
        status, ready = call(http.port, "GET", "/readyz")
        assert status == 200 and ready["ready"] is True
        assert "ValueError" in ready["checks"]["model"]["lastReloadError"]
        assert qs.last_reload_error is not None
    finally:
        http.stop()
        qs.close()


def test_warm_query_runs_unrecorded_and_warms_every_bucket(trained):
    http, qs = _serve(trained, warm_query={"user": "u0", "num": 3},
                      coalesce_window_ms=2.0)
    try:
        # the warm query and the bucket sweep ran before the bind, and
        # none of them counts as a request or arms the hedge
        status, st = call(http.port, "GET", "/")
        assert st["requestCount"] == 0
        assert qs.tracer.histogram("predict").count == 0
        assert qs._buckets_warmed and qs._buckets_ready.is_set()
        # every batch runs its products at the one dispatch shape, so the
        # sweep is one batch of batch_max (64) queries
        assert qs._warm_bucket_set() == [64]
        status, ready = call(http.port, "GET", "/readyz")
        assert status == 200 and ready["checks"]["buckets"]["ok"] is True
        sweep = ready["checks"]["buckets"]["sweep"]
        assert sweep["buckets"] == [64]
        assert sweep["seconds"] > 0
        status, body = call(http.port, "POST", "/queries.json",
                            {"user": "u0", "num": 3})
        assert status == 200 and len(body["itemScores"]) == 3
    finally:
        http.stop()
        qs.close()
    http, qs = _serve(trained, warm_query={"user": "u0", "num": 3},
                      batch_window_ms=2.0, batch_max=12)
    try:
        assert qs._warm_bucket_set() == [16]
        assert qs.warm_sweep["buckets"] == [16]
    finally:
        http.stop()
        qs.close()


def test_failed_warm_query_is_logged_and_ready(trained, caplog):
    http, qs = _serve(trained, warm_query={"num": 3},      # no "user"
                      batch_window_ms=2.0)
    try:
        assert "warm query failed" in caplog.text
        assert "warm batch failed" in caplog.text
        assert qs._buckets_ready.is_set()
    finally:
        http.stop()
        qs.close()


def test_adaptive_batching_backpressure(trained):
    """Adaptive mode (batch_window_ms < 0): with execution slowed and a
    single pipeline slot, requests arriving mid-execution coalesce into
    later batches, and every request still answers."""
    http, qs = _serve(trained, batch_window_ms=-1.0, batch_max=16,
                      batch_pipeline=1)
    try:
        assert qs.batcher is not None
        calls = []
        orig = qs.query_batch

        def slow(queries, record=True, **kw):
            if record:  # ignore the background auto-warm's batches
                calls.append(len(queries))
                time.sleep(0.15)  # hold the single pipeline slot
            return orig(queries, record, **kw)

        qs.query_batch = slow
        results = {}

        def hit(u):
            results[u] = call(http.port, "POST", "/queries.json",
                              {"user": f"u{u}", "num": 3})

        threads = [threading.Thread(target=hit, args=(u,)) for u in range(8)]
        for t in threads:
            t.start()
            time.sleep(0.02)  # staggered arrivals DURING execution
        for t in threads:
            t.join(timeout=30)
        assert all(status == 200 for status, _ in results.values())
        assert sum(calls) >= 8 and len(calls) < 8, calls
        assert max(calls) >= 2, calls
    finally:
        http.stop()
        qs.close()


def test_micro_batching_coalesces(trained):
    """Concurrent /queries.json under batch_window_ms resolve through
    fewer query_batch calls than requests, with the unbatched path's
    answers; a malformed query fails alone, not its batch-mates."""
    http, qs = _serve(trained, batch_window_ms=25.0, batch_max=16)
    try:
        calls = []
        orig = qs.query_batch

        def spy(queries, record=True, **kw):
            if record:
                calls.append(len(queries))
            return orig(queries, record, **kw)

        qs.query_batch = spy
        results = {}

        def hit(u):
            results[u] = call(http.port, "POST", "/queries.json",
                              {"user": f"u{u}", "num": 3})

        threads = [threading.Thread(target=hit, args=(u,)) for u in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert all(status == 200 for status, _ in results.values())
        assert sum(calls) >= 8 and len(calls) < 8
        for u, (_, body) in results.items():
            assert body == qs.query({"user": f"u{u}", "num": 3},
                                    record=False)
        statuses = {}

        def hit_raw(key, q):
            statuses[key] = call(http.port, "POST", "/queries.json", q)

        threads = [
            threading.Thread(target=hit_raw, args=("bad", {"num": 3})),
            threading.Thread(target=hit_raw,
                             args=("good", {"user": "u1", "num": 3})),
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert statuses["bad"][0] == 400
        assert statuses["good"][0] == 200
        assert statuses["good"][1]["itemScores"]
        status, st = call(http.port, "GET", "/batcher.json")
        assert st == {"enabled": True, "mode": "micro", "windowMs": 25.0,
                      "maxBatch": 16}
    finally:
        http.stop()
        qs.close()


def test_queries_survive_concurrent_reloads(trained):
    """Clients hammering /queries.json while /reload hot-swaps the model
    repeatedly never see an error: the swap is atomic under the lock."""
    http, qs = _serve(trained, server_key="SK")
    failures = []
    stop = threading.Event()

    def hammer(w):
        while not stop.is_set():
            status, body = call(http.port, "POST", "/queries.json",
                                {"user": f"u{w}", "num": 2})
            if status != 200 or "itemScores" not in body:
                failures.append((w, status, body))
                return

    threads = [threading.Thread(target=hammer, args=(w,)) for w in range(4)]
    try:
        for t in threads:
            t.start()
        for _ in range(5):
            status, _ = call(http.port, "POST", "/reload", accessKey="SK")
            assert status == 200
        stop.set()
        for t in threads:
            t.join(timeout=30)
        assert not failures, failures[:3]
        assert qs.request_count > 0
    finally:
        stop.set()
        http.stop()
        qs.close()


def test_hedged_dispatch_tames_stalled_predict(trained):
    """A predict dispatch that stalls gets a duplicate after hedge_after x
    the rolling median, and the request completes at the duplicate's
    latency; with hedging off or not yet armed (fewer than 20 predict
    spans; warm-ups record none) no duplicate is issued."""
    http, qs = _serve(trained, batch_window_ms=2.0, batch_max=16,
                      hedge_after=3.0, warm_query={"user": "u0", "num": 3})
    try:
        assert qs.tracer.histogram("predict").count == 0
        assert qs._hedge_timeout() is None
        algo = qs.algorithms[0]
        real = algo.batch_predict
        calls = {"n": 0}

        def stalling_batch_predict(model, queries):
            calls["n"] += 1
            if calls["n"] == 30:   # one mid-traffic stall, after arming
                time.sleep(1.0)
            return real(model, queries)

        algo.batch_predict = stalling_batch_predict
        lat = []
        for i in range(60):
            t0 = time.monotonic()
            out = qs.batcher.query({"user": f"u{i % 20}", "num": 3})
            lat.append(time.monotonic() - t0)
            assert out["itemScores"]
        assert max(lat) < 0.9, f"stall leaked to caller: {max(lat):.3f}s"
        assert qs.hedged_dispatches >= 1
        assert qs._hedge_timeout() >= 0.05
        status, m = call(http.port, "GET", "/metrics.json")
        assert m["hedgedDispatches"] == qs.hedged_dispatches
    finally:
        http.stop()
        qs.close()
    http, qs = _serve(trained, batch_window_ms=2.0, hedge_after=0.0)
    try:
        for i in range(25):
            qs.batcher.query({"user": f"u{i % 20}", "num": 3})
        assert qs._hedge_timeout() is None
        assert qs.hedged_dispatches == 0
    finally:
        http.stop()
        qs.close()


def test_request_budget_answers_503_when_spent(trained):
    """request_budget_s opens a Deadline around each dispatch: a query
    that cannot survive the coalesce window goes solo and answers; one
    whose wait outlives the budget answers 503 + Retry-After."""
    http, qs = _serve(trained, coalesce_window_ms=200.0,
                      request_budget_s=0.1)
    try:
        status, body = call(http.port, "POST", "/queries.json",
                            {"user": "u1", "num": 3})
        assert status == 200 and body["itemScores"]
        assert call(http.port, "GET", "/batcher.json")[1]["bypassSolo"] == 1
    finally:
        http.stop()
        qs.close()
    http, qs = _serve(trained, batch_window_ms=2.0, request_budget_s=0.1)
    real = qs.query_batch

    def stalled(queries, record=True, **kw):
        time.sleep(0.5)
        return real(queries, record, **kw)

    qs.query_batch = stalled
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{http.port}/queries.json",
            data=json.dumps({"user": "u1", "num": 3}).encode(),
            method="POST")
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=30)
        assert err.value.code == 503
        assert err.value.headers["Retry-After"] == "1"
        assert "budget" in json.loads(err.value.read())["message"]
    finally:
        http.stop()
        qs.close()


def test_prometheus_metrics_endpoint(trained):
    http, qs = _serve(trained)
    try:
        call(http.port, "POST", "/queries.json", {"user": "u0", "num": 2})
        with urllib.request.urlopen(
                f"http://127.0.0.1:{http.port}/metrics", timeout=30) as resp:
            assert resp.status == 200
            assert resp.headers["Content-Type"].startswith("text/plain")
            text = resp.read().decode()
        assert "# TYPE pio_span_latency_seconds summary" in text
        assert 'span="predict"' in text and 'quantile="0.99"' in text
        assert "pio_uptime_seconds" in text
        assert "pio_hedged_dispatches_total" in text
        status, m = call(http.port, "GET", "/metrics.json")
        assert status == 200 and m["spans"]["query"]["count"] == 1
        for stage in ("supplement", "predict", "serve"):
            assert m["spans"][stage]["count"] == 1
        # the CPU's plain versions launch no kernel
        assert m["kernelLaunches"]["quantized_scan"] == 0
        assert call(http.port, "GET", "/healthz") == (200,
                                                      {"status": "alive"})
    finally:
        http.stop()
        qs.close()


def test_tls_and_threaded_transport(trained, tmp_path):
    from pio_tpu_torch.server.security import generate_self_signed

    cert, key = generate_self_signed(str(tmp_path / "tls"))
    http, qs = _serve(trained, certfile=cert, keyfile=key,
                      backend="threaded")
    try:
        assert http.__class__ is HttpServer and http.tls
        context = ssl.create_default_context(cafile=cert)
        status, body = call(http.port, "POST", "/queries.json",
                            {"user": "u0", "num": 2}, scheme="https",
                            context=context)
        assert status == 200 and len(body["itemScores"]) == 2
    finally:
        http.stop()
        qs.close()


def test_pipeline_depth_from_the_dispatch_round_trip():
    assert serve_mod._depth_for_rtt(0.0002) == 2   # co-located device
    assert serve_mod._depth_for_rtt(0.004) == 2
    assert serve_mod._depth_for_rtt(0.066) == 4    # a remote link
    assert serve_mod._auto_pipeline_depth("cpu") == 2


def test_deploy_and_undeploy_subprocess(trained, tmp_path):
    """`python -m pio_tpu_torch deploy` with the batching, warm-query and
    server-key flags as a real process answers /queries.json; `undeploy`
    without the key is refused, with it the server exits 0."""
    storage = trained[0]
    eng = tmp_path / "eng"
    eng.mkdir()
    (eng / "engine.json").write_text(json.dumps(_variant()))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, **_env(tmp_path),
               PIO_TPU_COMPILE_CACHE=str(tmp_path / "cache"),
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    run = [sys.executable, "-m", "pio_tpu_torch"]
    proc = subprocess.Popen(
        [*run, "deploy", "--engine-dir", str(eng), "--ip", "127.0.0.1",
         "--port", str(port), "--device", "cpu", "--server-key", "SK",
         "--coalesce-window-ms", "2",
         "--warm-query", json.dumps({"user": "u0", "num": 2})],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=REPO)
    try:
        line = proc.stdout.readline()
        assert f"deployed on http://127.0.0.1:{port} (cpu)" in line, (
            line + (proc.stdout.read() if proc.poll() is not None else ""))
        status, body = call(port, "POST", "/queries.json",
                            {"user": "u0", "num": 2})
        assert status == 200 and len(body["itemScores"]) == 2
        assert call(port, "GET", "/batcher.json")[1]["mode"] == "continuous"
        out = subprocess.run([*run, "undeploy", "--port", str(port)],
                             capture_output=True, text=True, timeout=60,
                             env=env, cwd=REPO)
        assert out.returncode == 1 and "401" in out.stderr
        out = subprocess.run(
            [*run, "undeploy", "--port", str(port), "--server-key", "SK"],
            capture_output=True, text=True, timeout=60, env=env, cwd=REPO)
        assert out.returncode == 0, out.stderr
        assert json.loads(out.stdout) == {"message": "Shutting down."}
        proc.wait(timeout=60)
        assert proc.returncode == 0
        assert "Server stopped." in proc.stdout.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert storage.get_metadata_engine_instances().get_completed(
        "rec", "1", "default")


@pytest.mark.parametrize("backend", ["threaded", "async"])
def test_foldin_health_server_on_both_transports(trained, tmp_path,
                                                 backend):
    storage = trained[0]

    class Sink:
        def apply(self, rows, staleness_s=None):
            return {"applied": len(rows)}

    worker = FoldInWorker(storage, FoldInConfig(
        app_name="mlapp", engine_id="rec",
        als_params=als.ALSParams(rank=4, reg=0.05),
        state_path=str(tmp_path / "cursor.bin"), port=0, backend=backend),
        Sink(), device="cpu")
    http = create_foldin_server(worker)
    assert http.__class__ is (AsyncHttpServer if backend == "async"
                              else HttpServer)
    http.start()
    try:
        status, alive = call(http.port, "GET", "/healthz")
        assert status == 200 and alive["status"] == "alive"
        assert alive["foldin_queue_depth"] == 0
        status, ready = call(http.port, "GET", "/readyz")
        assert status in (200, 503) and "checks" in ready
    finally:
        http.stop()
