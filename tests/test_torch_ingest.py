"""Event ingest in the port against the reference: the app, accesskey,
import and export verbs, the SDK, the storage resilience proxy, tenant
quotas, the memory and localfs backends, fold-in over the event server's
tail, and the README quickstart end to end on the CPU.

Every comparison runs both packages on the same seeded inputs, each on
its own store, and holds what they print and store equal; access keys,
minted event ids and creation times are the only values set aside
(tolerance: exact equality of everything else, and bit equality of the
folded rows).
"""

from __future__ import annotations

import _torch_cpu  # noqa: F401  (one CPU thread: see the module)

import gzip
import json
import re
import shutil
from dataclasses import replace
from types import SimpleNamespace

import numpy as np
import pytest

import pio_tpu.data.dao as ref_dao
import pio_tpu.data.storage as ref_storage
import pio_tpu.resilience.chaos as ref_chaos
import pio_tpu.resilience.quota as ref_quota
import pio_tpu.sdk as ref_sdk
import pio_tpu.server.eventserver as ref_es
import pio_tpu.tools.cli as ref_cli
import pio_tpu_torch.__main__ as port_cli
import pio_tpu_torch.data.dao as port_dao
import pio_tpu_torch.data.storage as port_storage
import pio_tpu_torch.resilience.chaos as port_chaos
import pio_tpu_torch.resilience.quota as port_quota
import pio_tpu_torch.sdk as port_sdk
import pio_tpu_torch.server.eventserver as port_es
from pio_tpu_torch.freshness import FoldInWorker
from pio_tpu_torch.freshness.tail import HttpEventSource, LocalEventSource
from tests.test_torch_eventserver import MEM_ENV, norm, rate
from tests.test_torch_freshness import (
    Sink,
    foldin_config,
    serve,
    stamp,
    storage_env,
    train,
    variant,
)

PKGS = {
    "ref": SimpleNamespace(cli=ref_cli, dao=ref_dao, storage=ref_storage,
                           chaos=ref_chaos, quota=ref_quota, sdk=ref_sdk,
                           es=ref_es),
    "port": SimpleNamespace(cli=port_cli, dao=port_dao, storage=port_storage,
                            chaos=port_chaos, quota=port_quota, sdk=port_sdk,
                            es=port_es),
}
# a minted access key: 64 URL-safe characters, the first alphanumeric
KEY = re.compile(r"(?<![\w-])[A-Za-z0-9][\w-]{63}(?![\w-])")
QUICKSTART = "examples/quickstart"


def run_cli(pkg, storage, capsys, argv) -> tuple[int, str, str]:
    pkg.storage.set_storage(storage)
    try:
        rc = pkg.cli.main(argv)
    finally:
        pkg.storage.set_storage(None)
    out = capsys.readouterr()
    return rc, KEY.sub("<key>", out.out), KEY.sub("<key>", out.err)


def stored(storage, app_id, channel_id=None) -> list:
    evs = storage.get_events().find(app_id, channel_id=channel_id, limit=-1)
    return sorted((norm(e.to_api_dict()) for e in evs),
                  key=lambda d: json.dumps(d, sort_keys=True))


# -- the verbs -----------------------------------------------------------------

@pytest.mark.parametrize("ext", ["jsonl", "jsonl.gz", "parquet"])
def test_app_accesskey_import_export_verbs_equal_the_reference(
        tmp_path, capsys, ext):
    lines = [json.dumps(rate(j, "buy" if j % 4 == 0 else "rate"))
             for j in range(30)]
    lines += [json.dumps({k: v for k, v in rate(40 + j).items()
                          if k != "eventId"}) for j in range(5)]
    lines += ["{not json", json.dumps({"event": "", "entityType": "user",
                                       "entityId": "u1"}), ""]
    src = tmp_path / "in.jsonl"
    src.write_text("\n".join(lines) + "\n")
    seen = {}
    for name, pkg in PKGS.items():
        storage = pkg.storage.Storage(env=MEM_ENV, test=True)
        out = tmp_path / f"{name}.{ext}"
        steps = [
            ["app", "new", "MyApp"],
            ["app", "new", "MyApp"],
            ["app", "new", "Second", "--id", "7", "--access-key",
             "FIXEDKEY", "--description", "the second"],
            ["app", "new", "Third"],
            ["app", "list"],
            ["app", "channel-new", "MyApp", "ch1"],
            ["app", "channel-new", "MyApp", "bad name!"],
            ["app", "channel-new", "Nope", "ch1"],
            ["app", "show", "MyApp"],
            ["app", "show", "Nope"],
            ["accesskey", "new", "MyApp", "--event", "rate", "--event", "buy"],
            ["accesskey", "new", "Nope"],
            ["accesskey", "list"],
            ["accesskey", "list", "MyApp"],
            ["accesskey", "list", "Nope"],
            ["import", "--appid", "1", "--input", str(src)],
            ["export", "--appid", "1", "--output", str(out)],
            ["export", "--appid", "99", "--output", str(out)],
            ["export", "--appid", "1", "--channel", "nope", "--output",
             str(out)],
            ["import", "--appid", "7", "--input", str(out)],
            ["app", "trim", "MyApp", "Third", "--start",
             "2026-01-01T00:00:10Z", "--until", "2026-01-01T00:00:20Z"],
            ["app", "cleanup", "Second", "--until", "2026-01-01T00:00:25Z"],
            ["app", "data-delete", "MyApp", "--channel", "nope"],
            ["app", "data-delete", "MyApp", "--channel", "ch1"],
            ["app", "channel-delete", "MyApp", "ch1"],
            ["app", "channel-delete", "MyApp", "ch1"],
            ["accesskey", "delete", "FIXEDKEY"],
            ["app", "show", "Second"],
        ]
        runs = [run_cli(pkg, storage, capsys, argv) for argv in steps]
        stores = [stored(storage, a) for a in (1, 7, 8)]
        runs += [run_cli(pkg, storage, capsys, argv) for argv in (
            ["app", "data-delete", "MyApp"], ["app", "delete", "Second"],
            ["app", "list"])]
        seen[name] = (
            [(rc, o.replace(str(out), "<out>"), e) for rc, o, e in runs],
            stores, stored(storage, 1))
        assert runs[15][0] == 1 and "Imported 35 events (2 failed)" in \
            runs[15][1]
        assert "Imported 35 events (0 failed)" in runs[19][1]
        # cleanup kept app 7's events from 00:00:25 on
        assert len(stores[1]) == 10
    assert seen["port"] == seen["ref"]


def test_eventserver_verb_flags_build_the_reference_config(monkeypatch):
    """``eventserver``'s flags give the EventServerConfig the reference's
    verb gives, and neither verb takes a spill or quota flag."""
    made = {}
    for name, pkg in PKGS.items():
        class Stop(Exception):
            pass

        def fake(storage, config, _name=name):
            made[_name] = config
            raise Stop

        monkeypatch.setattr(pkg.es, "create_event_server", fake)
        monkeypatch.setattr(pkg.cli, "get_storage", lambda: None)
        with pytest.raises(Stop):
            pkg.cli.main(["eventserver", "--ip", "127.0.0.1", "--port", "0",
                          "--stats", "--metrics-key", "MK",
                          "--server-backend", "threaded"])
    assert made["port"] == port_es.EventServerConfig(
        **vars(made["ref"]))
    # the reference's flag set: the spill and quota settings stay at
    # EventServerConfig's defaults, as the reference's CLI leaves them
    for name, pkg in PKGS.items():
        with pytest.raises(SystemExit):
            pkg.cli.main(["eventserver", "--spill-capacity", "5"])


# -- the SDK ---------------------------------------------------------------------

def test_sdk_against_each_packages_server_equal():
    seen = {}
    for name, pkg in PKGS.items():
        storage = pkg.storage.Storage(env=MEM_ENV, test=True)
        app_id = storage.get_metadata_apps().insert(pkg.dao.App(0, "sdk"))
        storage.get_metadata_access_keys().insert(
            pkg.dao.AccessKey("K", app_id, ()))
        storage.get_events().init(app_id)
        srv = pkg.es.create_event_server(storage, pkg.es.EventServerConfig(
            ip="127.0.0.1", port=0, ingest_quota_qps=0.001,
            ingest_quota_burst=3)).start()
        url = f"http://127.0.0.1:{srv.port}"
        try:
            client = pkg.sdk.EventClient("K", url)
            naps = []
            client._sleep = naps.append
            got = [{"eventId": client.create_event(
                "rate", "user", "u1", "item", "i1", {"rating": 4},
                "2026-01-01T00:00:00.000Z")},
                client.create_events_batch(
                    [rate(j) for j in range(300)] + [rate(1, "")]),
                pkg.sdk.EventClient("K", url, wire="json")
                .create_events_batch([rate(400 + j) for j in range(50)]),
                client.get_event("ev00007"),
                client.find_events(entityId="u3", limit=-1),
                client.delete_event("ev00007")]
            for call in (lambda: client.get_event("ev00007"),
                         lambda: client.create_events_batch(
                             [rate(0)] * 10_001),
                         lambda: pkg.sdk.EventClient("BAD", url)
                         .create_event("rate", "user", "u1"),
                         # the app's burst of 3 POSTs is spent: the
                         # client retries the 429 and then surfaces it
                         lambda: client.set_user("u2", {"plan": "pro"})):
                try:
                    got.append(call())
                except Exception as e:  # noqa: BLE001 - compared below
                    got.append((type(e).__name__, getattr(e, "status", None),
                                str(e)))
            got += [client.stats, len(naps)]
        finally:
            srv.stop()
        seen[name] = (norm(got), stored(storage, app_id))
    assert seen["port"] == seen["ref"]
    assert seen["port"][0][-2] == {"shed": 4, "retried": 3}


# -- resilience ------------------------------------------------------------------

def test_storage_daos_are_guarded_like_the_reference(monkeypatch):
    seen = {}
    for name, pkg in PKGS.items():
        storage = pkg.storage.Storage(env=MEM_ENV, test=True)
        apps = storage.get_metadata_apps()
        got = [type(apps).__name__, apps.__class__.__name__,
               type(pkg.storage.Storage(env=MEM_ENV, resilience=False)
                    .get_metadata_apps()).__name__]
        monkeypatch.setenv("PIO_TPU_RESILIENCE", "off")
        got.append(type(pkg.storage.Storage(env=MEM_ENV)
                        .get_metadata_apps()).__name__)
        monkeypatch.delenv("PIO_TPU_RESILIENCE")
        with pkg.chaos.inject("storage.MEM.get_by_name", error=1.0, seed=3):
            for _ in range(6):
                try:
                    apps.get_by_name("x")
                except Exception as e:  # noqa: BLE001 - compared below
                    got.append((type(e).__name__, str(e)))
        snap = storage.breakers["MEM"].snapshot()
        got.append((snap.state, snap.calls, snap.opened_count))
        seen[name] = got
    assert seen["port"] == seen["ref"]
    assert seen["port"][0] == "ResilientDAO" and seen["port"][3] != \
        "ResilientDAO"


def test_token_bucket_and_tenant_admission_on_a_scripted_clock():
    seen = {}
    for name, pkg in PKGS.items():
        now = [100.0]

        def clock():
            return now[0]

        bucket = pkg.quota.TokenBucket(2.0, 3.0, clock=clock)
        adm = pkg.quota.TenantAdmission(watermark=3, clock=clock)
        adm.configure("a", pkg.quota.TenantQuota(rate=1.0, burst=2.0))
        adm.configure("b", pkg.quota.TenantQuota(max_concurrency=1,
                                                 weight=2.0))
        got = []
        for step, dt in enumerate([0, 0, 0, 0, 0.25, 0.25, 1.0, 0, 5.0]):
            now[0] += dt
            got.append(bucket.try_acquire(1.0 + (step == 7)))
            for tenant in ("a", "b", "c"):
                got.append(adm.admit(tenant))
                if step % 3 == 2:
                    adm.release(tenant)
        got += [bucket.snapshot(), adm.snapshot(), adm.shed_total("a")]
        seen[name] = got
    assert seen["port"] == seen["ref"]


def test_localfs_models_written_by_one_package_read_by_the_other(tmp_path):
    env = {"PIO_STORAGE_SOURCES_FS_TYPE": "localfs",
           "PIO_STORAGE_SOURCES_FS_PATH": str(tmp_path / "models"),
           "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
           "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
           "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
           "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "FS"}
    blob = np.random.default_rng(0).bytes(4096)
    port_storage.Storage(env=env).get_model_data_models().insert(
        port_dao.Model("m1", blob))
    ref_models = ref_storage.Storage(env=env).get_model_data_models()
    assert ref_models.get("m1").models == blob
    ref_models.insert(ref_dao.Model("m2", blob[::-1]))
    port_models = port_storage.Storage(env=env).get_model_data_models()
    assert port_models.get("m2").models == blob[::-1]
    port_models.delete("m1")
    assert ref_models.get("m1") is None and port_models.get("zz") is None


# -- fold-in over the event server's tail --------------------------------------

@pytest.mark.parametrize("replay", [False, True])
def test_http_event_source_folds_the_local_sources_rows(tmp_path,
                                                        monkeypatch, replay):
    """Two workers on one store, one tailing the event server's
    ``/tail/events.json`` (long-poll) and reading histories over
    ``/events.json``, the other reading the store: the same users and
    the same rows, bit for bit; with ``--replay`` over the whole log."""
    monkeypatch.setenv("PIO_TPU_CKPT_ROOT", str(tmp_path / "ckpt"))
    storage = port_storage.Storage(env=storage_env(tmp_path))
    engine, ep, ctx, iid, app_id = train(storage)
    storage.get_metadata_access_keys().insert(
        port_dao.AccessKey("AK", app_id, ()))
    srv = port_es.create_event_server(storage, port_es.EventServerConfig(
        ip="127.0.0.1", port=0)).start()
    url = f"http://127.0.0.1:{srv.port}"
    try:
        local, remote = Sink(), Sink()
        workers = [FoldInWorker(storage, replace(
            foldin_config(tmp_path, replay=replay),
            state_path=str(tmp_path / f"c{j}")),
            sink, source=src, device="cpu") for j, (sink, src) in enumerate(
                [(local, None), (remote, HttpEventSource(url, "AK",
                                                        wait_s=5.0))])]
        assert isinstance(workers[0].source, LocalEventSource)
        t = stamp().isoformat()
        client = port_sdk.EventClient("AK", url)
        client.create_events_batch(
            [{"event": "rate", "entityType": "user", "entityId": "newbie",
              "targetEntityType": "item", "targetEntityId": f"i{j}",
              "properties": {"rating": j % 5 + 1}, "eventTime": t}
             for j in range(5)]
            + [{"event": "buy", "entityType": "user", "entityId": "u3",
                "targetEntityType": "item", "targetEntityId": "i2",
                "eventTime": t}])
        stats = [w.run_once() for w in workers]
    finally:
        srv.stop()
        storage.close()
    assert stats[0] == stats[1]
    assert stats[0]["folded"] == (21 if replay else 2)
    assert [sorted(b) for b in remote.batches] == \
        [sorted(b) for b in local.batches]
    for got, want in zip(remote.batches, local.batches):
        for user, row in want.items():
            assert np.array_equal(np.asarray(got[user], np.float32),
                                  np.asarray(row, np.float32)), user


def test_foldin_verb_takes_the_event_server_flags(tmp_path, monkeypatch,
                                                  capsys):
    monkeypatch.setenv("PIO_TPU_CKPT_ROOT", str(tmp_path / "ckpt"))
    storage = port_storage.Storage(env=storage_env(tmp_path))
    engine, ep, ctx, iid, app_id = train(storage)
    storage.get_metadata_access_keys().insert(
        port_dao.AccessKey("AK", app_id, ()))
    engine_dir = tmp_path / "engine"
    engine_dir.mkdir()
    (engine_dir / "engine.json").write_text(json.dumps(variant()))
    http, qs = serve(storage, engine, ep, ctx, server_key="SK")
    srv = port_es.create_event_server(storage, port_es.EventServerConfig(
        ip="127.0.0.1", port=0)).start()
    sources = []
    real = FoldInWorker.__init__

    def kept(self, *a, **kw):
        real(self, *a, **kw)
        sources.append(self.source)

    monkeypatch.setattr(FoldInWorker, "__init__", kept)
    monkeypatch.setattr(port_cli, "get_storage", lambda: storage)
    try:
        rc = port_cli.main([
            "foldin", "--engine-dir", str(engine_dir), "--serving-url",
            f"http://127.0.0.1:{http.port}", "--server-key", "SK",
            "--event-server-url", f"http://127.0.0.1:{srv.port}",
            "--access-key", "AK", "--tail-wait", "0", "--once", "--replay",
            "--device", "cpu", "--state-path", str(tmp_path / "cursor")])
    finally:
        srv.stop()
        http.stop()
        qs.close()
        storage.close()
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and stats["folded"] == 20 and stats["queueDepth"] == 0
    [source] = sources
    assert isinstance(source, HttpEventSource) and source.wait_s == 0.0
    assert source.access_key == "AK"


# -- the README quickstart, on the CPU -----------------------------------------

def test_quickstart_through_the_ports_verbs(tmp_path, capsys, monkeypatch):
    """app new -> import the committed 100,000 events -> an event server
    taking one POST /events.json and one segment.io webhook -> train the
    committed engine.json's params -> deploy and query through the SDK
    -> export and re-import into a fresh app, whose columnar read equals
    the first."""
    from pio_tpu_torch.models.recommendation import RecommendationEngine
    from pio_tpu_torch.workflow.context import create_workflow_context
    from pio_tpu_torch.workflow.serve import ServingConfig, create_query_server

    monkeypatch.setenv("PIO_TPU_CKPT_ROOT", str(tmp_path / "ckpt"))
    storage = port_storage.Storage(env=MEM_ENV, test=True)

    def verb(*argv):
        rc, out, err = run_cli(PKGS["port"], storage, capsys, list(argv))
        assert rc == 0, err
        return out

    out = verb("app", "new", "quickstart")
    app_id = int(re.search(r"\(id (\d+)\)", out).group(1))
    key = storage.get_metadata_access_keys().get_by_appid(app_id)[0].key
    data = f"{QUICKSTART}/events.jsonl.gz"
    assert "Imported 100000 events (0 failed)" in verb(
        "import", "--appid", str(app_id), "--input", data)

    srv = port_es.create_event_server(storage, port_es.EventServerConfig(
        ip="127.0.0.1", port=0)).start()
    try:
        url = f"http://127.0.0.1:{srv.port}"
        client = port_sdk.EventClient(key, url)
        client.create_event("rate", "user", "u_new", "item", "i_1",
                            {"rating": 5}, "2026-01-01T00:00:00.000Z")
        hook = client._http.call("POST", "/webhooks/segmentio.json", {
            "version": "2", "type": "track", "userId": "u_new",
            "event": "signup", "timestamp": "2026-01-01T00:00:01.000Z"},
            accessKey=key)
        assert "eventId" in hook
    finally:
        srv.stop()

    engine_dir = tmp_path / "engine"
    engine_dir.mkdir()
    with open(f"{QUICKSTART}/engine.json") as f:
        v = json.load(f)
    v["engineFactory"] = (
        "pio_tpu_torch.models.recommendation.RecommendationEngine")
    (engine_dir / "engine.json").write_text(json.dumps(v))
    assert "Training completed" in verb(
        "train", "--engine-dir", str(engine_dir), "--device", "cpu")

    engine = RecommendationEngine.apply()
    ep = engine.engine_params_from_variant(v)
    http, qs = create_query_server(
        engine, ep, storage,
        ServingConfig(ip="127.0.0.1", port=0, engine_id=v["id"]),
        ctx=create_workflow_context(storage, device="cpu"))
    http.start()
    try:
        with gzip.open(data, "rt") as f:
            users = sorted({json.loads(next(f))["entityId"]
                            for _ in range(50)})[:7] + ["u_new"]
        engine_client = port_sdk.EngineClient(f"http://127.0.0.1:{http.port}")
        for user in users:
            body = engine_client.send_query({"user": user, "num": 5})
            assert len(body["itemScores"]) == 5
            assert all(s["item"].startswith("i_") for s in body["itemScores"])
    finally:
        http.stop()
        qs.close()

    out_path = tmp_path / "export.jsonl"
    assert "Exported 100002 events" in verb(
        "export", "--appid", str(app_id), "--output", str(out_path))
    again = int(re.search(r"\(id (\d+)\)", verb(
        "app", "new", "again")).group(1))
    assert "Imported 100002 events (0 failed)" in verb(
        "import", "--appid", str(again), "--input", str(out_path))
    dao = storage.get_events()
    first, second = (dao.find_columnar(a) for a in (app_id, again))
    for f in ("event_code", "entity_code", "target_code", "time_us",
              "tz_min"):
        assert np.array_equal(getattr(first, f), getattr(second, f)), f
    assert (first.event_names, first.entity_ids, first.target_ids) == (
        second.event_names, second.entity_ids, second.target_ids)
    assert [first.props(i) for i in range(len(first))] == [
        second.props(i) for i in range(len(second))]
    shutil.rmtree(tmp_path / "ckpt", ignore_errors=True)
