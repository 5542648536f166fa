"""The port's native event log against the reference's.

Both packages' ``EventLogBackend`` run on the same seeded events, each on
its own directory: the log files they write must be byte-identical, each
package reads the other's log with equal results under every scan filter,
the C++ ``columnarize`` gives equal columns under every dedup mode,
``insert_api_batch`` gives equal verdicts on a seeded corpus of valid,
invalid and garbage bodies, and tombstones, ``delete_many``, the supplied
id window and the recovery of a torn tail behave alike. The port's event
server takes its native fast path on this store. Tolerance: exact
equality (bytes, bits, strings); minted event ids and creation times are
the only values set aside where the log mints them.
"""

from __future__ import annotations

import _torch_cpu  # noqa: F401  (one CPU thread: see the module)

import http.client
import json
import os
import random
import shutil
import string
from datetime import datetime, timedelta, timezone
from types import SimpleNamespace

import numpy as np
import pytest

import pio_tpu.data.backends.eventlog as ref_backend
import pio_tpu.data.datamap as ref_datamap
import pio_tpu.data.event as ref_event
import pio_tpu.data.storage as ref_storage
import pio_tpu.native.eventlog as ref_native
import pio_tpu_torch.data.backends.eventlog as port_backend
import pio_tpu_torch.data.datamap as port_datamap
import pio_tpu_torch.data.event as port_event
import pio_tpu_torch.data.storage as port_storage
import pio_tpu_torch.native as port_native_pkg
import pio_tpu_torch.native.eventlog as port_native
from pio_tpu_torch.data.columnar import columnar_interactions

PKGS = {
    "ref": SimpleNamespace(backend=ref_backend, datamap=ref_datamap,
                           event=ref_event, storage=ref_storage,
                           native=ref_native),
    "port": SimpleNamespace(backend=port_backend, datamap=port_datamap,
                            event=port_event, storage=port_storage,
                            native=port_native),
}
OTHER = {"ref": "port", "port": "ref"}
T0 = datetime(2026, 1, 1, tzinfo=timezone.utc)
APP = 1
N_EVENTS = 300


def corpus(pkg, n: int = N_EVENTS, seed: int = 0) -> list:
    """Seeded events with supplied ids and creation times: every field
    the record layout carries, in several zones, with and without a
    target, tags and a pr id."""
    r = np.random.default_rng(seed)
    out = []
    for j in range(n):
        tz = timezone(timedelta(minutes=int(r.integers(-600, 600))))
        name = ("rate", "buy", "view", "$set")[j % 4]
        target = name != "$set"
        props = ({"rating": float(r.integers(1, 6))} if name == "rate"
                 else {"k": [int(r.integers(9)), "é"]} if name == "$set"
                 else {})
        t = T0 + timedelta(seconds=int(r.integers(0, 10**6)),
                           microseconds=int(r.integers(10**6)))
        out.append(pkg.event.Event(
            event=name, entity_type="user",
            entity_id=f"u{int(r.integers(20))}",
            target_entity_type="item" if target else None,
            target_entity_id=f"i{int(r.integers(30))}" if target else None,
            properties=pkg.datamap.DataMap(props),
            event_time=t.astimezone(tz),
            tags=("a", "b") if j % 5 == 0 else (),
            pr_id="pr1" if j % 7 == 0 else None,
            event_id=f"ev{j:04d}", creation_time=T0 + timedelta(days=j)))
    return out


def key(e) -> tuple:
    """Every field of an event, zone and microseconds included."""
    return (e.event, e.entity_type, e.entity_id, e.target_entity_type,
            e.target_entity_id, e.properties.to_json(),
            e.event_time.isoformat(), tuple(e.tags), e.pr_id, e.event_id,
            e.creation_time.isoformat())


def open_backend(name: str, path):
    pkg = PKGS[name]
    return pkg.backend.EventLogBackend(pkg.storage.StorageClientConfig(
        properties={"PATH": str(path)}))


def written(name: str, path, batch: bool = True):
    """A log of the corpus written by package ``name`` under ``path``."""
    b = open_backend(name, path)
    dao = b.events()
    dao.init(APP)
    evs = corpus(PKGS[name])
    if batch:
        dao.insert_batch(evs, APP)
    else:
        for e in evs:
            dao.insert(e, APP)
    b.close()
    return path


def log_bytes(path) -> bytes:
    with open(os.path.join(path, f"app_{APP}", "events.log"), "rb") as f:
        return f.read()


# -- the build -------------------------------------------------------------------

def test_the_port_builds_its_own_source_into_its_build_folder():
    so = port_native_pkg.build_library("eventlog")
    pkg_dir = os.path.dirname(os.path.abspath(port_native_pkg.__file__))
    assert os.path.dirname(so) == os.path.join(
        os.path.dirname(pkg_dir), "_build")
    assert port_native_pkg._source_path("eventlog") == os.path.join(
        pkg_dir, "eventlog.cpp")
    assert port_native_pkg.native_available()


def test_a_failed_build_raises_and_nothing_falls_back(tmp_path, monkeypatch):
    """A source g++ refuses raises NativeBuildError at the first use of
    the store; no other store or path answers in its place."""
    bad = tmp_path / "eventlog.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(port_native_pkg, "_source_path", lambda name: str(bad))
    monkeypatch.setattr(port_native_pkg, "_BUILD_DIR", str(tmp_path / "b"))
    monkeypatch.setattr(port_native_pkg, "_LIBS", {})
    with pytest.raises(port_native_pkg.NativeBuildError):
        port_native_pkg.build_library("eventlog")
    assert not port_native_pkg.native_available()
    storage = port_storage.Storage(env={
        "PIO_STORAGE_SOURCES_EL_TYPE": "eventlog",
        "PIO_STORAGE_SOURCES_EL_PATH": str(tmp_path / "el"),
        "PIO_STORAGE_SOURCES_M_TYPE": "memory",
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "M",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "EL",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "M",
    }, resilience=False)
    dao = storage.get_events()
    assert type(dao).__name__ == "_EventLogEvents"
    dao.init(APP)
    with pytest.raises(port_native_pkg.NativeBuildError):
        dao.insert(corpus(PKGS["port"], 1)[0], APP)
    storage.close()


@pytest.mark.parametrize("kind", ["postgres", "postgresql", "mysql"])
def test_the_sql_servers_stay_unregistered(kind):
    with pytest.raises(port_storage.StorageError) as exc:
        port_storage._load_backend_class(kind)
    msg = str(exc.value)
    assert msg.startswith(f"No storage backend registered for type '{kind}'")
    for known in ("eventlog", "hbase", "remote", "sharded", "replicated",
                  "sqlite", "memory", "localfs"):
        assert f"'{known}'" in msg


# -- the on-disk format ----------------------------------------------------------

@pytest.mark.parametrize("batch", [True, False], ids=["insert_batch", "insert"])
def test_both_packages_write_byte_identical_logs(tmp_path, batch):
    ref = written("ref", tmp_path / "ref", batch)
    port = written("port", tmp_path / "port", batch)
    assert log_bytes(port) == log_bytes(ref)
    assert len(log_bytes(port)) > 8 * N_EVENTS


def _find_kwargs(flag: str) -> dict:
    """A find() whose scan filter sets ``flag`` (and nothing else)."""
    return {
        "none": {},
        "start": {"start_time": T0 + timedelta(seconds=300_000)},
        "until": {"until_time": T0 + timedelta(seconds=600_000)},
        "etype": {"entity_type": "user"},
        "eid": {"entity_id": "u3"},
        "events": {"event_names": ["buy", "$set"]},
        "tetype_eq": {"target_entity_type": "item"},
        "tetype_absent": {"target_entity_type": None},
        "teid_eq": {"target_entity_id": "i7"},
        "teid_absent": {"target_entity_id": None},
        "limit_reversed": {"limit": 17, "reversed": True},
    }[flag]


FLAGS = ["none", "start", "until", "etype", "eid", "events", "tetype_eq",
         "tetype_absent", "teid_eq", "teid_absent", "limit_reversed"]


@pytest.fixture(scope="module")
def logs(tmp_path_factory):
    """One corpus log written by each package."""
    root = tmp_path_factory.mktemp("logs")
    return {name: written(name, root / name) for name in PKGS}


@pytest.mark.parametrize("writer", ["ref", "port"])
@pytest.mark.parametrize("flag", FLAGS)
def test_each_package_reads_the_others_log(logs, tmp_path, writer, flag):
    """find() under each scan filter flag: the reader of the other
    package's log answers what the writer's own package answers."""
    results = {}
    for reader in PKGS:
        path = tmp_path / reader
        shutil.copytree(logs[writer], path)
        b = open_backend(reader, path)
        kw = {"limit": -1, **_find_kwargs(flag)}
        results[reader] = [key(e) for e in b.events().find(APP, **kw)]
        b.close()
    assert results["ref"] == results["port"]
    assert 0 < len(results["port"]) <= N_EVENTS


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_native_scans_and_gets_agree_on_one_file(logs, writer):
    """The raw ``EventLog.scan`` of each package over one file, under a
    filter with every hash flag, and ``get`` by event id (F_EVENTID)."""
    path = os.path.join(logs[writer], f"app_{APP}", "events.log")
    got = {}
    for name, pkg in PKGS.items():
        log = pkg.native.EventLog(path, create=False)
        try:
            f = pkg.native.ScanFilter(
                start_time=T0, until_time=T0 + timedelta(days=30),
                entity_type="user", entity_id="u5",
                event_names=["rate", "buy"], target_entity_type="item",
                target_entity_id="i3")
            all_f = pkg.native.ScanFilter(event_id="ev0042")
            got[name] = ([key(e) for e in log.scan(f)],
                         [key(e) for e in log.scan(all_f)], log.stats())
        finally:
            log.close()
    assert got["ref"] == got["port"]
    assert got["port"][2][1] == N_EVENTS
    assert [k[9] for k in got["port"][1]] == ["ev0042"]
    for reader in PKGS:
        b = open_backend(reader, logs[writer])
        e = b.events().get("ev0042", APP)
        assert key(e) == got["port"][1][0]
        assert b.events().get("nope", APP) is None
        b.close()


# -- the columnarizer ------------------------------------------------------------

def _columns(cols) -> tuple:
    return (cols.user_idx.tobytes(), cols.item_idx.tobytes(),
            cols.values.tobytes(), cols.times_us.tobytes(), cols.users,
            cols.items, cols.user_idx.dtype, cols.values.dtype)


def _triples(cols) -> list:
    return sorted(zip([cols.users[u] for u in cols.user_idx],
                      [cols.items[i] for i in cols.item_idx],
                      cols.values.tolist()))


@pytest.mark.parametrize("value_event", [None, "rate"])
@pytest.mark.parametrize("dedup", ["none", "last", "sum"])
def test_columnarize_equal_in_both_packages(logs, tmp_path, dedup,
                                            value_event):
    """The C++ sweep of both packages over one log gives the same columns
    bit for bit; its (user, item, value) triples equal the port's
    Python path (find_columnar + the columnar fold), whose code order is
    the time order where the log's is the arrival order."""
    got = {}
    for name in PKGS:
        path = tmp_path / name
        shutil.copytree(logs["ref"], path)
        b = open_backend(name, path)
        dao = b.events()
        kw = dict(entity_type="user", event_names=["rate", "buy"],
                  value_key="rating", default_value=4.0, dedup=dedup,
                  value_event=value_event)
        cols = dao.columnarize(APP, **kw)
        got[name] = _columns(cols)
        if name == "port":
            python = columnar_interactions(
                dao.find_columnar(APP, entity_type="user",
                                  event_names=["rate", "buy"]),
                value_key="rating", default_value=4.0, dedup=dedup,
                value_event=value_event)
            assert _triples(cols) == _triples(python)
            assert isinstance(cols, port_native.Columns)
            assert len(cols.user_idx) > 100
        b.close()
    assert got["ref"] == got["port"]


# -- the ingest fast path --------------------------------------------------------

def _random_value(rng: random.Random, depth: int = 0):
    kind = rng.randrange(7 if depth < 2 else 5)
    if kind == 0:
        return rng.randrange(-5, 100)
    if kind == 1:
        return rng.random() * 10 - 5
    if kind == 2:
        return rng.choice([True, False, None])
    if kind == 3:
        return "".join(rng.choice(string.ascii_letters + " $_é日")
                       for _ in range(rng.randrange(0, 10)))
    if kind == 4:
        return rng.choice(["$set", "pio_x", "", "2026-07-30T12:00:00Z",
                           "2026-02-31T00:00:00Z", "user", "item"])
    if kind == 5:
        return [_random_value(rng, depth + 1) for _ in range(rng.randrange(3))]
    return {f"k{i}": _random_value(rng, depth + 1)
            for i in range(rng.randrange(3))}


def _api_event(rng: random.Random):
    """Mostly valid events; the rest break one rule of the API."""
    d = {"event": rng.choice(["rate", "view", "buy"]), "entityType": "user",
         "entityId": rng.choice(["u1", "u2", "идент"])}
    if rng.random() < 0.7:
        d["targetEntityType"] = "item"
        d["targetEntityId"] = rng.choice(["i1", "i2"])
    if rng.random() < 0.6:
        d["properties"] = {"rating": rng.randrange(1, 6)}
    if rng.random() < 0.5:
        d["eventTime"] = rng.choice(["2026-07-30T12:00:00.5+02:00",
                                     "2026-07-30T12:00:00Z"])
    if rng.random() < 0.2:
        d["tags"] = ["a", "b"]
    if rng.random() < 0.2:
        d["prId"] = "pr1"
    if rng.random() < 0.4:
        field = rng.choice(["event", "entityType", "entityId", "eventTime",
                            "properties", "targetEntityType", "tags",
                            "creationTime", "eventId"])
        d[field] = _random_value(rng)
    if rng.random() < 0.1:
        d.pop(rng.choice(["event", "entityType", "entityId"]))
    return d


def _bodies(seed: int) -> list:
    """(raw body, single, max_events) requests: batches, single events,
    non-object elements, garbage bytes, truncations, an oversize batch."""
    rng = random.Random(seed)
    out = []
    for j in range(60):
        kind = j % 6
        if kind in (0, 1):
            out.append((json.dumps([_api_event(rng) for _ in range(8)]
                                   ).encode(), False, 50))
        elif kind == 2:
            out.append((json.dumps(_api_event(rng)).encode(), True, 0))
        elif kind == 3:
            out.append((json.dumps([_api_event(rng), 5, "x", None,
                                    [1]]).encode(), False, 50))
        elif kind == 4:
            base = json.dumps([_api_event(rng)]).encode()
            out.append((base[:rng.randrange(len(base))], False, 50))
        else:
            out.append((bytes(rng.randrange(256)
                              for _ in range(rng.randrange(60))), False, 50))
    out.append((json.dumps([_api_event(rng) for _ in range(51)]).encode(),
                False, 50))
    return out


def _verdict(dao, raw: bytes, single: bool, max_events: int):
    try:
        res = dao.insert_api_batch(raw, APP, allowed_events=["rate", "buy"],
                                   single=single, max_events=max_events)
    except (ValueError, ref_native.BatchTooLarge,
            port_native.BatchTooLarge) as e:
        return type(e).__name__
    return [(status, "<id>" if status == 0 else payload, name, etype)
            for status, payload, name, etype in res]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_insert_api_batch_verdicts_equal(tmp_path, monkeypatch, seed):
    import pio_tpu.utils.time as ref_time
    import pio_tpu_torch.utils.time as port_time

    now = datetime(2026, 7, 30, 12, 0, 0, 250_000, tzinfo=timezone.utc)
    for mod in (ref_time, port_time):
        monkeypatch.setattr(mod, "utcnow", lambda: now)
    verdicts, stored = {}, {}
    for name in PKGS:
        b = open_backend(name, tmp_path / name)
        dao = b.events()
        dao.init(APP)
        verdicts[name] = [_verdict(dao, *body) for body in _bodies(seed)]
        stored[name] = [key(e)[:9] for e in dao.find(APP, limit=-1)]
        b.close()
    assert verdicts["ref"] == verdicts["port"]
    flat = [v for v in verdicts["port"] if isinstance(v, list)]
    statuses = [s for v in flat for s, *_ in v]
    assert {0, 1, 2} <= set(statuses)            # 201, 400, 403 all seen
    assert "BatchTooLarge" in verdicts["port"]
    assert "ValueError" in verdicts["port"]
    # the records stored equal, minted ids and creation times aside
    assert stored["ref"] == stored["port"]
    assert len(stored["port"]) == statuses.count(0)


# -- tombstones, the id window, recovery -----------------------------------------

def test_tombstones_and_delete_many_alike(tmp_path):
    outcomes = {}
    for name in PKGS:
        path = written(name, tmp_path / name)
        b = open_backend(name, path)
        dao = b.events()
        outcomes[name] = (
            dao.delete("ev0003", APP), dao.delete("ev0003", APP),
            dao.delete_many(["ev0010", "ev0011", "nope", "ev0011",
                             "ev0003"], APP),
            dao.delete_many(["ev0010"], APP), dao.delete_many([], APP),
            dao.get("ev0011", APP))
        b.close()
    assert outcomes["ref"] == outcomes["port"] == (
        True, False, 2, 0, 0, None)
    tomb = {name: (tmp_path / name / f"app_{APP}" / "tombstones.bin"
                   ).read_bytes() for name in PKGS}
    assert tomb["ref"] == tomb["port"] != b""
    # each package reads the other's tombstoned namespace alike
    for reader in PKGS:
        b = open_backend(reader, tmp_path / OTHER[reader])
        ids = [e.event_id for e in b.events().find(APP, limit=-1)]
        cols = b.events().columnarize(APP, dedup="none")
        b.close()
        assert len(ids) == N_EVENTS - 3
        assert not {"ev0003", "ev0010", "ev0011"} & set(ids)
        outcomes[reader] = (ids, _columns(cols))
    assert outcomes["ref"] == outcomes["port"]


def test_supplied_id_window_dedupes_retries_alike(tmp_path):
    """A retried supplied id within RECENT_ID_WINDOW appends once; past
    the window it appends again, in both packages."""
    counts = {}
    for name, pkg in PKGS.items():
        b = open_backend(name, tmp_path / name)
        dao = b.events()
        dao.init(APP)
        evs = corpus(pkg, 2)
        window = pkg.backend._EventLogEvents.RECENT_ID_WINDOW
        assert window == 4096
        dao.insert(evs[0], APP)
        dao.insert(evs[0], APP)
        dao.insert_batch([evs[0], evs[1], evs[1]], APP)
        n_dedup = len(list(dao.find(APP, limit=-1)))
        filler = [e.with_id(f"f{j}") for j, e in
                  enumerate(corpus(pkg, 1) * window)]
        dao.insert_batch(filler, APP)
        dao.insert(evs[0], APP)                     # fell out of the window
        counts[name] = (n_dedup, len(list(dao.find(APP, limit=-1))))
        b.close()
    assert counts["ref"] == counts["port"] == (2, 4096 + 3)
    assert log_bytes(tmp_path / "ref") == log_bytes(tmp_path / "port")


@pytest.mark.parametrize("damage", ["partial_frame", "cut_record", "bitflip"])
def test_a_damaged_log_recovers_alike(tmp_path, damage):
    """A torn tail (a partial frame, a cut record) is truncated to the
    last whole record on open; a record failing its CRC is skipped. Both
    packages read the damaged log alike and append after it alike."""
    src = written("ref", tmp_path / "src")
    log = os.path.join(src, f"app_{APP}", "events.log")
    data = bytearray(open(log, "rb").read())
    if damage == "partial_frame":
        data += (9999).to_bytes(4, "little") + b"\x01\x02\x03"
    elif damage == "cut_record":
        del data[-37:]
    else:
        data[30] ^= 0xFF
    with open(log, "wb") as f:
        f.write(data)
    got = {}
    for name, pkg in PKGS.items():
        path = tmp_path / name
        shutil.copytree(src, path)
        b = open_backend(name, path)
        dao = b.events()
        before = [key(e) for e in dao.find(APP, limit=-1)]
        dao.insert(corpus(pkg, 1)[0].with_id("after"), APP)
        after = dao.get("after", APP)
        b.close()
        got[name] = (before, key(after), log_bytes(path))
    assert got["ref"] == got["port"]
    lost = {"partial_frame": 0, "cut_record": 1, "bitflip": 1}[damage]
    assert len(got["port"][0]) == N_EVENTS - lost


# -- the event server's native fast path -----------------------------------------

def _post(port: int, path: str, body: bytes, ctype: str = "application/json"):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("POST", path, body=body, headers={"Content-Type": ctype})
        resp = conn.getresponse()
        return [resp.status, json.loads(resp.read())]
    finally:
        conn.close()


def test_event_server_json_routes_take_the_native_fast_path(tmp_path,
                                                            monkeypatch):
    """JSON single events and JSON batches go through
    ``EventLog.ingest_batch`` (one call a request, a malformed body
    included, which then falls through to the Python path for its
    message), answer as the reference's event server on its eventlog
    store does, and store what the binary route stores for the same
    events."""
    import pio_tpu.data.dao as ref_dao
    import pio_tpu.server.eventserver as ref_es
    import pio_tpu_torch.data.dao as port_dao
    import pio_tpu_torch.sdk as port_sdk
    import pio_tpu_torch.server.eventserver as port_es
    from tests.test_torch_eventserver import norm

    calls = {"n": 0}
    real = port_native.EventLog.ingest_batch

    def counted(self, *a, **kw):
        calls["n"] += 1
        return real(self, *a, **kw)

    monkeypatch.setattr(port_native.EventLog, "ingest_batch", counted)
    rng = random.Random(5)
    requests = [("/batch/events.json", json.dumps(
        [_api_event(rng) for _ in range(50)]).encode()) for _ in range(3)]
    requests += [("/events.json", json.dumps(_api_event(rng)).encode())
                 for _ in range(8)]
    requests += [("/batch/events.json", b"[{not json"),
                 ("/events.json", b"[1, 2]")]
    twins = [{"event": "rate", "entityType": "user", "entityId": f"u{j}",
              "targetEntityType": "item", "targetEntityId": f"i{j % 7}",
              "properties": {"rating": j % 5 + 1},
              "eventTime": f"2026-01-01T00:00:{j:02d}.000Z"}
             for j in range(50)]
    answers = {}
    for name, (dao_mod, es, storage_mod) in {
            "ref": (ref_dao, ref_es, ref_storage),
            "port": (port_dao, port_es, port_storage)}.items():
        storage = storage_mod.Storage(env={
            "PIO_STORAGE_SOURCES_EL_TYPE": "eventlog",
            "PIO_STORAGE_SOURCES_EL_PATH": str(tmp_path / name),
            "PIO_STORAGE_SOURCES_M_TYPE": "memory",
            "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "M",
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "EL",
            "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "M",
        })
        apps = {}
        for key_, app_name in (("K", "fast"), ("J", "jtwin"), ("T", "twin")):
            a = storage.get_metadata_apps().insert(dao_mod.App(0, app_name))
            storage.get_metadata_access_keys().insert(
                dao_mod.AccessKey(key_, a, ()))
            storage.get_events().init(a)
            apps[key_] = a
        srv = es.create_event_server(storage, es.EventServerConfig(
            ip="127.0.0.1", port=0)).start()
        try:
            before = calls["n"]
            out = [_post(srv.port, f"{path}?accessKey=K", body)
                   for path, body in requests]
            out.append(_post(srv.port, "/batch/events.json?accessKey=J",
                             json.dumps(twins).encode()))
            if name == "port":
                assert calls["n"] - before == len(requests) + 1
                port_sdk.EventClient("T", f"http://127.0.0.1:{srv.port}"
                                     ).create_events_batch(twins)
                assert calls["n"] - before == len(requests) + 1

                def rows(a):
                    evs = storage.get_events().find(a, limit=-1)
                    return [norm(e.to_api_dict(with_id=False)) for e in evs]

                assert rows(apps["J"]) == rows(apps["T"])
                assert len(rows(apps["J"])) == 50
            answers[name] = norm(out)
        finally:
            srv.stop()
            storage.close()
    assert answers["ref"] == answers["port"]
    statuses = [st for st, _ in answers["port"]]
    assert {200, 201, 400} <= set(statuses)
