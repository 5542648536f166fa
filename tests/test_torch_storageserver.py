"""The port's storage server and ``remote`` backend against the
reference's, in both directions.

Each test runs one package's storage server over a local store and the
other package's ``remote`` client against it (and the port against
itself), with the reference against itself as the oracle: every DAO
family's results, the server-side ``columnarize``, the binary
``find_columnar`` and its JSON fallback against a server without
``/rpc/columnar``, paging across timestamp ties, the server key and the
error mapping must be equal. A CPU train through the port's shared store
gives the factors of the same train on a local store, and its deploy
from another client answers alike. The ``storageserver`` verb and the
``/readyz`` surfaces with a storage breaker open are held to the
reference's. Tolerance: exact equality (bits of every column and factor,
strings of every message with the server's URL set aside); minted keys
and instance ids are the only values set aside.
"""

from __future__ import annotations

import _torch_cpu  # noqa: F401  (one CPU thread: see the module)

import contextlib
import dataclasses
import json
import re
import subprocess
import sys
import urllib.error
import urllib.request
from datetime import datetime, timedelta, timezone
from types import SimpleNamespace

import numpy as np
import pytest

import pio_tpu.data.backends.remote as ref_remote
import pio_tpu.data.columnar as ref_columnar
import pio_tpu.data.dao as ref_dao
import pio_tpu.data.datamap as ref_datamap
import pio_tpu.data.event as ref_event
import pio_tpu.data.storage as ref_storage
import pio_tpu.resilience.health as ref_health
import pio_tpu.server.storageserver as ref_ss
import pio_tpu.tools.cli as ref_cli
import pio_tpu_torch.__main__ as port_cli
import pio_tpu_torch.data.backends.remote as port_remote
import pio_tpu_torch.data.columnar as port_columnar
import pio_tpu_torch.data.dao as port_dao
import pio_tpu_torch.data.datamap as port_datamap
import pio_tpu_torch.data.event as port_event
import pio_tpu_torch.data.storage as port_storage
import pio_tpu_torch.resilience.health as port_health
import pio_tpu_torch.server.storageserver as port_ss

PKGS = {
    "ref": SimpleNamespace(remote=ref_remote, columnar=ref_columnar,
                           dao=ref_dao, datamap=ref_datamap, event=ref_event,
                           storage=ref_storage, ss=ref_ss, cli=ref_cli,
                           health=ref_health),
    "port": SimpleNamespace(remote=port_remote, columnar=port_columnar,
                            dao=port_dao, datamap=port_datamap,
                            event=port_event, storage=port_storage,
                            ss=port_ss, cli=port_cli, health=port_health),
}
#: (server, client) pairs held to the reference against itself
PAIRS = [("ref", "port"), ("port", "ref"), ("port", "port")]
PAIR_IDS = ["ref_server-port_client", "port_server-ref_client",
            "port_server-port_client"]
T0 = datetime(2021, 6, 1, tzinfo=timezone.utc)
URL = re.compile(r"https?://127\.0\.0\.1:\d+")


def backing_env(kind: str, tmp) -> dict:
    env = {"PIO_STORAGE_SOURCES_M_TYPE": "memory",
           "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "M",
           "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "E",
           "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "M"}
    if kind == "eventlog":
        env |= {"PIO_STORAGE_SOURCES_E_TYPE": "eventlog",
                "PIO_STORAGE_SOURCES_E_PATH": str(tmp / "log")}
    elif kind == "sqlite":
        env |= {"PIO_STORAGE_SOURCES_E_TYPE": "sqlite",
                "PIO_STORAGE_SOURCES_E_PATH": str(tmp / "events.db")}
    else:
        env["PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE"] = "M"
    return env


def client_env(port: int, key: str = "") -> dict:
    env = {"PIO_STORAGE_SOURCES_NET_TYPE": "remote",
           "PIO_STORAGE_SOURCES_NET_URL": f"http://127.0.0.1:{port}",
           "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "NET",
           "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "NET",
           "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "NET"}
    if key:
        env["PIO_STORAGE_SOURCES_NET_KEY"] = key
    return env


@contextlib.contextmanager
def served(name: str, env: dict, key: str = "", columnar_route: bool = True):
    """Package ``name``'s storage server over the store ``env`` names;
    yields (server, backing storage)."""
    pkg = PKGS[name]
    backing = pkg.storage.Storage(env=env, test=True)
    srv = pkg.ss.create_storage_server(backing, pkg.ss.StorageServerConfig(
        ip="127.0.0.1", port=0, server_key=key))
    if not columnar_route:      # a server from before the binary route
        srv.app.routes[:] = [r for r in srv.app.routes
                             if r[1].pattern != "^/rpc/columnar$"]
    srv.start()
    try:
        yield srv, backing
    finally:
        srv.stop()
        backing.close()


def canon(x):
    """A comparable form of DAO results from either package."""
    if hasattr(x, "entity_type") and hasattr(x, "event_time"):   # Event
        return [x.event, x.entity_type, x.entity_id, x.target_entity_type,
                x.target_entity_id, x.properties.to_json(),
                x.event_time.isoformat(), list(x.tags), x.pr_id, x.event_id,
                "<created>"]
    if hasattr(x, "first_updated"):                     # PropertyMap
        return [x.to_json(), canon(x.first_updated), canon(x.last_updated)]
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return [type(x).__name__, {f.name: canon(getattr(x, f.name))
                                   for f in dataclasses.fields(x)}]
    if hasattr(x, "to_json"):
        return x.to_json()
    if isinstance(x, datetime):
        return x.isoformat()
    if isinstance(x, bytes):
        return x.hex()
    if isinstance(x, np.ndarray):
        return [str(x.dtype), x.tobytes().hex()]
    if isinstance(x, dict):
        return {str(k): canon(v) for k, v in sorted(x.items())}
    if isinstance(x, (list, tuple)):
        return [canon(v) for v in x]
    return x


def columnar(cols) -> bytes:
    """A columnar read as the binary read frame it encodes to: equal
    frames are equal rows, tables and property sidecars, bit for bit,
    whichever dictionary layout the read came in."""
    return port_columnar.encode_columnar_events(cols)


def events_of(pkg, n: int = 40) -> list:
    """Seeded events with supplied ids, four of them at each time."""
    E, D = pkg.event.Event, pkg.datamap.DataMap
    return [E(event=("rate", "buy", "$set")[m % 3], entity_type="user",
              entity_id=f"u{m % 7}",
              target_entity_type=None if m % 3 == 2 else "item",
              target_entity_id=None if m % 3 == 2 else f"i{(m * 3) % 5}",
              properties=D({"rating": float(1 + m % 4), "n": m}),
              event_time=T0 + timedelta(seconds=m // 4),
              event_id=f"ev{m:03d}", tags=("t",) if m % 5 == 0 else ())
            for m in range(n)]


def dao_script(pkg, storage) -> list:
    """Every DAO family through ``storage``; the results, canonical."""
    d = pkg.dao
    out = []
    apps = storage.get_metadata_apps()
    a1 = apps.insert(d.App(0, "a1", "first"))
    a2 = apps.insert(d.App(0, "a2"))
    out += [a1, a2, canon(apps.get(a1)), canon(apps.get_by_name("a2")),
            canon(apps.get(999)), canon(sorted(apps.get_all(),
                                               key=lambda a: a.id))]
    apps.update(d.App(a1, "a1", "changed"))
    apps.delete(a2)
    out += [canon(apps.get(a1)), canon(apps.get_all())]

    keys = storage.get_metadata_access_keys()
    out.append(keys.insert(d.AccessKey("k1", a1, ("rate", "buy"))))
    minted = keys.insert(d.AccessKey("", a1, ()))
    out.append(len(minted))
    keys.update(d.AccessKey("k1", a1, ("view",)))
    got = sorted(keys.get_by_appid(a1), key=lambda k: k.key != "k1")
    out += [canon(keys.get("k1")), canon(got[0]), len(keys.get_all())]
    keys.delete(minted)
    out += [canon(keys.get(minted)), len(keys.get_all())]

    chans = storage.get_metadata_channels()
    c1 = chans.insert(d.Channel(0, "mobile", a1))
    out += [c1, canon(chans.get(c1)), canon(chans.get_by_appid(a1))]
    chans.delete(c1)
    out.append(canon(chans.get_by_appid(a1)))

    insts = storage.get_metadata_engine_instances()
    base = d.EngineInstance(
        id="", status="INIT", start_time=T0, end_time=T0, engine_id="e",
        engine_version="1", engine_variant="default", engine_factory="f",
        env={"A": "1"}, progress={"step": 3})
    i1 = insts.insert(base)
    i2 = insts.insert(dataclasses.replace(base, start_time=T0 +
                                          timedelta(hours=1)))
    for i in (i1, i2):
        insts.update(dataclasses.replace(insts.get(i), status="COMPLETED",
                                         end_time=T0 + timedelta(days=1)))
    latest = insts.get_latest_completed("e", "1", "default")
    out += [latest.id == i2, canon(dataclasses.replace(latest, id="<id>")),
            len(insts.get_completed("e", "1", "default")),
            len(insts.get_all())]
    insts.delete(i1)
    out += [canon(insts.get(i1)), len(insts.get_all())]

    mans = storage.get_metadata_engine_manifests()
    mans.insert(d.EngineManifest("m", "1", "name", "desc", ("a.py",), "f"))
    mans.update(d.EngineManifest("m", "1", "renamed"), upsert=True)
    out += [canon(mans.get("m", "1")), canon(mans.get_all())]
    mans.delete("m", "1")
    out.append(canon(mans.get("m", "1")))

    evals = storage.get_metadata_evaluation_instances()
    ev1 = evals.insert(d.EvaluationInstance(
        id="", status="INIT", start_time=T0, end_time=T0, batch="b",
        evaluator_results_json='{"x": 1}'))
    evals.update(dataclasses.replace(evals.get(ev1), status="EVALCOMPLETED"))
    out += [canon(dataclasses.replace(evals.get(ev1), id="<id>")),
            len(evals.get_completed()), len(evals.get_all())]
    evals.delete(ev1)
    out.append(canon(evals.get(ev1)))

    models = storage.get_model_data_models()
    blob = bytes(range(256)) * 64
    models.insert(d.Model("inst1", blob))
    out.append(models.get("inst1").models == blob)
    models.delete("inst1")
    out.append(canon(models.get("inst1")))

    ev = storage.get_events()
    out.append(ev.init(a1))
    evs = events_of(pkg)
    out.append(ev.insert(evs[0], a1))
    out.append(canon(ev.insert_batch(evs[1:], a1)))
    out += [canon(ev.get("ev005", a1)), canon(ev.get("nope", a1))]
    for kw in ({}, {"entity_id": "u3"}, {"event_names": ["buy"]},
               {"target_entity_type": None}, {"target_entity_id": "i2"},
               {"start_time": T0 + timedelta(seconds=3),
                "until_time": T0 + timedelta(seconds=7)},
               {"limit": 5, "reversed": True}, {"limit": 3}):
        out.append(canon(list(ev.find(a1, **{"limit": -1, **kw}))))
    out += [ev.delete("ev007", a1), ev.delete("ev007", a1),
            ev.delete_many(["ev008", "ev009", "nope"], a1)]
    out.append(canon(ev.aggregate_properties(a1, "user")))
    for dedup in ("none", "last", "sum"):
        cols = ev.columnarize(a1, entity_type="user",
                              event_names=["rate", "buy"],
                              default_value=2.0, dedup=dedup,
                              value_event="rate")
        out.append(canon([cols.user_idx, cols.item_idx, cols.values,
                          cols.times_us, cols.users, cols.items]))
    out.append(columnar(ev.find_columnar(a1, event_names=["rate", "$set"])))
    out.append(ev.remove(a1))
    return out


@pytest.fixture(scope="module")
def oracle():
    """The reference against itself, each case computed once."""
    return {}


def _script_over_the_wire(server: str, client: str, store: str, tmp) -> list:
    with served(server, backing_env(store, tmp)) as (srv, _):
        pkg = PKGS[client]
        storage = pkg.storage.Storage(env=client_env(srv.port))
        try:
            return dao_script(pkg, storage)
        finally:
            storage.close()


@pytest.mark.parametrize("store", ["memory", "eventlog"])
@pytest.mark.parametrize("server,client", PAIRS, ids=PAIR_IDS)
def test_every_dao_family_over_the_wire_equals_the_reference(
        tmp_path, oracle, store, server, client):
    if ("dao", store) not in oracle:
        oracle[("dao", store)] = _script_over_the_wire(
            "ref", "ref", store, tmp_path / "ref")
    got = _script_over_the_wire(server, client, store, tmp_path / "pair")
    assert got == oracle[("dao", store)]


@pytest.mark.parametrize("binary_route", [True, False],
                         ids=["rpc_columnar", "json_fallback"])
@pytest.mark.parametrize("server,client", PAIRS, ids=PAIR_IDS)
def test_find_columnar_equals_the_servers_own_read(
        tmp_path, server, client, binary_route):
    """The binary frame decodes to the server store's own
    ``find_columnar`` bit for bit; a server that 404s ``/rpc/columnar``
    gets the paged-JSON read, the same rows, and the client stays on it."""
    with served(server, backing_env("sqlite", tmp_path),
                columnar_route=binary_route) as (srv, backing):
        pkg = PKGS[client]
        storage = pkg.storage.Storage(env=client_env(srv.port))
        app_id = storage.get_metadata_apps().insert(pkg.dao.App(0, "col"))
        dao = storage.get_events()
        dao.init(app_id)
        dao.insert_batch(events_of(pkg, 60), app_id)
        for kw in ({}, {"entity_type": "user", "event_names": ["rate"]},
                   {"target_entity_type": None}):
            got = dao.find_columnar(app_id, **kw)
            want = backing.get_events().find_columnar(app_id, **kw)
            assert columnar(got) == columnar(want), kw
            assert len(got) > 0
        assert dao._dao._columnar_downgraded is (not binary_route)
        storage.close()


@pytest.mark.parametrize("server,client", PAIRS, ids=PAIR_IDS)
def test_unbounded_find_pages_exactly_across_timestamp_ties(
        tmp_path, monkeypatch, server, client):
    """More events at one time than a page: the keyset cursor (time,
    ids seen at it) returns every event once, in the store's order."""
    for pkg in PKGS.values():
        monkeypatch.setattr(pkg.remote, "FIND_PAGE", 4)
    with served(server, backing_env("memory", tmp_path)) as (srv, backing):
        pkg = PKGS[client]
        storage = pkg.storage.Storage(env=client_env(srv.port))
        app_id = storage.get_metadata_apps().insert(pkg.dao.App(0, "ties"))
        dao = storage.get_events()
        dao.init(app_id)
        evs = events_of(pkg, 17)
        evs = [dataclasses.replace(e, event_time=T0 + timedelta(
            seconds=0 if j < 11 else j)) for j, e in enumerate(evs)]
        dao.insert_batch(evs, app_id)
        got = [e.event_id for e in dao.find(app_id, limit=-1)]
        want = [e.event_id for e in backing.get_events().find(
            app_id, limit=-1)]
        assert got == want and len(set(got)) == 17
        rev = [e.event_id for e in dao.find(app_id, limit=-1, reversed=True)]
        assert rev == [e.event_id for e in backing.get_events().find(
            app_id, limit=-1, reversed=True)]
        storage.close()


def _errors(pkg, port: int, key: str) -> list:
    """What a client meets: a wrong key, an uninitialized namespace, a
    bad argument, and a server that is gone."""
    out = []
    storage = pkg.storage.Storage(env=client_env(port, key))
    for call in (lambda: storage.get_metadata_apps().get_all(),
                 lambda: storage.get_events().insert(
                     events_of(pkg, 1)[0], 42),
                 lambda: storage.get_metadata_engine_instances().get(None)):
        try:
            out.append(["ok", canon(call())])
        except pkg.storage.StorageError as e:
            out.append([type(e).__name__, URL.sub("<url>", str(e))])
    storage.close()
    return out


def _met_errors(server: str, client: str, tmp) -> list:
    with served(server, backing_env("memory", tmp), key="sk") as (srv, _):
        pkg = PKGS[client]
        got = _errors(pkg, srv.port, "wrong") + _errors(pkg, srv.port, "sk")
        keyless = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/rpc", method="POST",
            data=b'{"family": "apps", "method": "get_all"}')
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(keyless, timeout=10)
        got.append(exc.value.code)
        port = srv.port
    return got + _errors(pkg, port, "sk")               # the server is gone


@pytest.mark.parametrize("server,client", PAIRS, ids=PAIR_IDS)
def test_server_key_and_error_mapping_equal_the_reference(
        tmp_path, oracle, server, client):
    if "errors" not in oracle:
        oracle["errors"] = _met_errors("ref", "ref", tmp_path / "ref")
    want = oracle["errors"]
    assert _met_errors(server, client, tmp_path / "pair") == want
    assert want[0][1].endswith("Invalid accessKey.")
    assert want[6] == 401
    assert want[-1][1].startswith("storage server <url> unreachable")


# -- train and deploy through the port's shared store ----------------------------

def _factors(storage, instance_id: str) -> list:
    from pio_tpu_torch.workflow.checkpoint import models_from_bytes

    model = models_from_bytes(
        storage.get_model_data_models().get(instance_id).models)[0]
    arrays = []

    def walk(x):
        if isinstance(x, np.ndarray):
            arrays.append(x)
        elif dataclasses.is_dataclass(x):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)

    walk(model)
    return arrays


def test_cpu_train_and_deploy_through_the_ports_shared_store(
        tmp_path, capsys, monkeypatch):
    """``train --device cpu`` with every repository on ``remote`` (the
    trainer shares nothing with the store but the wire) stores the
    factors the same verb stores on a local store, bit for bit; a second
    client deploys that instance and answers as the local deploy does."""
    from pio_tpu_torch.data.dao import App
    from pio_tpu_torch.models.recommendation import RecommendationEngine
    from pio_tpu_torch.workflow.context import create_workflow_context
    from pio_tpu_torch.workflow.serve import ServingConfig, QueryServer
    from tests.test_torch_freshness import variant

    monkeypatch.setenv("PIO_TPU_CKPT_ROOT", str(tmp_path / "ckpt"))
    engine_dir = tmp_path / "engine"
    engine_dir.mkdir()
    v = variant()
    (engine_dir / "engine.json").write_text(json.dumps(v))
    rng = np.random.default_rng(0)
    rows = [(u, i, 5 if (u % 2) == (i % 2) else 1)
            for u in range(20) for i in range(12)
            if rng.random() < (0.8 if (u % 2) == (i % 2) else 0.1)]

    def train_on(storage) -> str:
        app_id = storage.get_metadata_apps().insert(App(0, "mlapp"))
        ev = storage.get_events()
        ev.init(app_id)
        ev.insert_batch([port_event.Event(
            event="rate", entity_type="user", entity_id=f"u{u}",
            target_entity_type="item", target_entity_id=f"i{i}",
            properties=port_datamap.DataMap({"rating": r}),
            event_time=T0 + timedelta(minutes=m))
            for m, (u, i, r) in enumerate(rows)], app_id)
        port_storage.set_storage(storage)
        try:
            rc = port_cli.main(["train", "--engine-dir", str(engine_dir),
                                "--device", "cpu"])
        finally:
            port_storage.set_storage(None)
        assert rc == 0
        return capsys.readouterr().out.rsplit(
            "Engine instance: ", 1)[1].split()[0]

    def answers(storage) -> list:
        engine = RecommendationEngine.apply()
        ep = engine.engine_params_from_variant(v)
        qs = QueryServer(engine, ep, storage,
                         ServingConfig(engine_id=v["id"]),
                         ctx=create_workflow_context(storage, device="cpu"))
        try:
            return [qs.query({"user": f"u{u}", "num": 4}) for u in range(6)]
        finally:
            qs.close()

    local = port_storage.Storage(env=backing_env("sqlite", tmp_path / "l"))
    local_iid = train_on(local)
    with served("port", backing_env("sqlite", tmp_path / "s")) as (srv, _):
        host_a = port_storage.Storage(env=client_env(srv.port))
        remote_iid = train_on(host_a)
        host_b = port_storage.Storage(env=client_env(srv.port))
        want, got = _factors(local, local_iid), _factors(host_b, remote_iid)
        assert len(got) == len(want) >= 2
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
        assert answers(host_b) == answers(local)
        host_a.close()
        host_b.close()
    local.close()


# -- the verb and the readiness surfaces -----------------------------------------

def test_storageserver_verb_flags_and_output_equal_the_reference(
        monkeypatch, tmp_path):
    """Both verbs build the same config from the same flags, take no
    other flag, and print the same line with the port bound."""
    made = {}
    for name, pkg in PKGS.items():
        class Stop(Exception):
            pass

        def fake(storage, config, _name=name):
            made[_name] = config
            raise Stop

        monkeypatch.setattr(pkg.ss, "create_storage_server", fake)
        monkeypatch.setattr(pkg.cli, "get_storage", lambda: None)
        with pytest.raises(Stop):
            pkg.cli.main(["storageserver"])
        made[name + "_defaults"] = made[name]
        with pytest.raises(Stop):
            pkg.cli.main(["storageserver", "--ip", "0.0.0.0", "--port", "0",
                          "--server-key", "sk", "--cert", "c.pem",
                          "--key", "k.pem"])
        with pytest.raises(SystemExit):
            pkg.cli.main(["storageserver", "--device", "cpu"])
    assert made["port_defaults"] == port_ss.StorageServerConfig(
        **vars(made["ref_defaults"]))
    assert made["port_defaults"] == port_ss.StorageServerConfig(
        ip="127.0.0.1", port=7072)
    assert made["port"] == port_ss.StorageServerConfig(**vars(made["ref"]))
    monkeypatch.undo()

    env = {**backing_env("sqlite", tmp_path), "PYTHONUNBUFFERED": "1"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "pio_tpu_torch", "storageserver", "--port",
         "0"], env={**__import__("os").environ, **env},
        stdout=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert re.fullmatch(r"Storage Server on http://127\.0\.0\.1:\d+\n",
                            line), line
        port = int(line.rsplit(":", 1)[1])
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/health",
                                    timeout=10) as resp:
            assert json.loads(resp.read())["status"] == "ok"
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    assert proc.returncode == -15          # SIGTERM's default, as the reference


def _get(port: int, path: str) -> list:
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=10) as resp:
            return [resp.status, json.loads(resp.read())]
    except urllib.error.HTTPError as e:
        return [e.code, json.loads(e.read())]


def _open_breaker(storage, source: str) -> None:
    breaker = storage.breaker_for(source)
    for _ in range(200):
        breaker.record(False)
        if breaker.snapshot().state == "open":
            return
    raise AssertionError(breaker.snapshot())


def test_readyz_answers_alike_with_a_storage_breaker_open(tmp_path):
    """The storage server's /readyz of each package, and the port's
    deploy /readyz, are 503 with the same breaker checks while a storage
    breaker is open, and 200 once it closes."""
    from tests.test_torch_freshness import serve, train

    seen = {}
    for name, pkg in PKGS.items():
        with served(name, backing_env("sqlite", tmp_path / name)) as (
                srv, backing):
            backing.get_metadata_apps().get_all()      # breakers in use
            closed = _get(srv.port, "/readyz")
            _open_breaker(backing, "E")
            opened = _get(srv.port, "/readyz")
            seen[name] = [closed, opened, pkg.health.breaker_checks(backing)]
    assert seen["ref"] == seen["port"]
    assert seen["port"][0][0] == 200 and seen["port"][1][0] == 503

    storage = port_storage.Storage(env=backing_env("sqlite", tmp_path / "d"))
    engine, ep, ctx, iid, _ = train(storage)
    http, qs = serve(storage, engine, ep, ctx)
    try:
        assert _get(http.port, "/readyz")[0] == 200
        _open_breaker(storage, "E")
        status, body = _get(http.port, "/readyz")
        assert status == 503 and body["ready"] is False
        # "queue" is the async transport's shedder check, as in the
        # reference's deploy readiness
        storage_checks = {k: v for k, v in body["checks"].items()
                          if k not in ("model", "freshness", "queue")}
        assert storage_checks == ref_health.breaker_checks(
            _RefBreakers(storage))
        assert body["checks"]["model"]["ok"] is True
    finally:
        http.stop()
        qs.close()
        storage.close()


class _RefBreakers:
    """The port storage's breakers, seen through the reference's check."""

    def __init__(self, storage):
        self.breakers = storage.breakers
