"""The port's replicated event store against the reference's.

Both packages' ``ReplicatedEventsDAO`` (three in-process memory replicas,
W 2) go through one scripted sequence: acks at W, ``QuorumLostError``
(transient) below it, hints written before the ack, a drain into a wiped
rejoiner, a corrupt hint skipped and counted, read-repair, a scrub that
finds and repairs divergence. The outcomes (counts, statuses, verdicts)
must be equal; the event ids they mint are set aside. One drill runs
three of the port's ``storageserver`` verbs as processes, SIGKILLs a
replica mid-ingest and restarts it: every batch is acked, its hints
drain, a scrub finds nothing left to repair, and the three replicas'
columnar reads are equal. A dead remote replica's error reaches the
replicas' sort as the same type in both packages. Tolerance: exact
equality.
"""

from __future__ import annotations

import _torch_cpu  # noqa: F401  (one CPU thread: see the module)

import os
import signal
import socket
import subprocess
import sys
import threading
import time
from datetime import datetime, timedelta, timezone
from types import SimpleNamespace


import pio_tpu.data.backends.memory as ref_memory
import pio_tpu.data.backends.remote as ref_remote
import pio_tpu.data.backends.replicated as ref_replicated
import pio_tpu.data.datamap as ref_datamap
import pio_tpu.data.event as ref_event
import pio_tpu.data.storage as ref_storage
import pio_tpu.resilience as ref_resilience
import pio_tpu.utils.durable as ref_durable
import pio_tpu_torch.data.backends.memory as port_memory
import pio_tpu_torch.data.backends.remote as port_remote
import pio_tpu_torch.data.backends.replicated as port_replicated
import pio_tpu_torch.data.datamap as port_datamap
import pio_tpu_torch.data.event as port_event
import pio_tpu_torch.data.storage as port_storage
import pio_tpu_torch.resilience as port_resilience
import pio_tpu_torch.utils.durable as port_durable
from pio_tpu_torch.data.columnar import encode_columnar_events

PKGS = {
    "ref": SimpleNamespace(memory=ref_memory, remote=ref_remote,
                           replicated=ref_replicated, datamap=ref_datamap,
                           event=ref_event, storage=ref_storage,
                           resilience=ref_resilience, durable=ref_durable),
    "port": SimpleNamespace(memory=port_memory, remote=port_remote,
                            replicated=port_replicated,
                            datamap=port_datamap, event=port_event,
                            storage=port_storage,
                            resilience=port_resilience,
                            durable=port_durable),
}
APP = 1
T0 = datetime(2026, 1, 1, tzinfo=timezone.utc)


class DeadDAO:
    """Every call fails like a dead transport."""

    def __getattr__(self, name):
        def boom(*a, **k):
            raise ConnectionError("replica dead")

        return boom


def _ev(pkg, i: int, name: str = "rate"):
    return pkg.event.Event(
        event=name, entity_type="user", entity_id=f"u{i}",
        target_entity_type="item", target_entity_id=f"i{i % 7}",
        properties=pkg.datamap.DataMap({"rating": i % 5 + 1}),
        event_time=T0 + timedelta(seconds=i))


def _corrupt_second_record(pkg, path: str) -> None:
    with open(path, "r+b") as f:
        data = bytearray(f.read())
        starts = []
        off = data.find(pkg.durable.LOG_MAGIC)
        while off >= 0:
            starts.append(off)
            off = data.find(pkg.durable.LOG_MAGIC, off + 1)
        end = starts[2] if len(starts) > 2 else len(data)
        data[(starts[1] + end) // 2] ^= 0xFF
        f.seek(0)
        f.write(data)


def scripted(pkg, tmp) -> list:
    """One sequence through the replicated DAO; what it observed."""
    mem = lambda: pkg.memory.MemoryBackend(  # noqa: E731
        pkg.storage.StorageClientConfig()).events()
    replicas = [mem() for _ in range(3)]
    dao = pkg.replicated.ReplicatedEventsDAO(
        list(replicas), write_quorum=2, hint_dir=str(tmp / "hints"))
    out = []
    try:
        dao.init(APP)
        ids = dao.insert_batch([_ev(pkg, i) for i in range(10)], APP)
        out.append(("acked at R", len(set(ids)),
                    [len(list(r.find(APP, limit=-1))) for r in replicas]))

        dao.replicas[2] = DeadDAO()                 # one down: ack at W
        hinted = dao.insert_batch([_ev(pkg, i, "buy") for i in range(5)],
                                  APP)
        st = dao.replication_status()               # hint BEFORE the ack
        out.append(("acked at W", len(hinted), st["replicas"][2]["hintDepth"],
                    st["counters"]["hinted"], st["hintDepthTotal"],
                    st["replicas"][2]["hintOldestAgeSeconds"] is not None))

        dao.replicas[1] = DeadDAO()                 # two down: below W
        try:
            dao.insert_batch([_ev(pkg, 99)], APP)
            out.append("acked below W")
        except pkg.replicated.QuorumLostError as e:
            out.append(("quorum lost", pkg.resilience.is_transient(e),
                        isinstance(e, pkg.storage.StorageError),
                        dao.replication_status()["hintDepthTotal"]))
        dao.replicas[1] = replicas[1]
        dao.breakers[1].reset()

        fresh = mem()                                # rejoin WIPED
        dao.replicas[2] = fresh
        dao.breakers[2].reset()
        out.append(("drain", dao.drain_hints(2), dao.hint_logs[2].depth(),
                    set(hinted) <= {e.event_id
                                    for e in fresh.find(APP, limit=-1)}))
        check = dao.scrub(APP, repair=False)
        fix = dao.scrub(APP, repair=True)
        after = dao.scrub(APP, repair=False)
        out.append(("scrub", check["divergentBuckets"] > 0,
                    fix["repairedEvents"], after["divergentBuckets"],
                    [len(list(r.find(APP, limit=-1)))
                     for r in dao.replicas]))

        dao.replicas[2] = DeadDAO()                 # a corrupt hint
        batches = [dao.insert_batch([_ev(pkg, 50 + k)], APP)
                   for k in range(3)]
        log_path = dao.hint_logs[2].path
        _corrupt_second_record(pkg, log_path)
        healed = mem()
        healed.init(APP)
        dao.replicas[2] = healed
        dao.breakers[2].reset()
        dao.hint_logs[2] = pkg.durable.FrameLog(log_path)
        drained = dao.drain_hints(2)
        got = {e.event_id for e in healed.find(APP, limit=-1)}
        out.append(("corrupt hint", drained,
                    [set(b) <= got for b in batches],
                    dao.hint_logs[2].corrupt_total >= 1))

        lost = dao.insert_batch([_ev(pkg, 70)], APP)[0]  # read-repair
        replicas[0].delete(lost, APP)
        hit = dao.get(lost, APP) is not None
        deadline = time.monotonic() + 5
        while (replicas[0].get(lost, APP) is None
               and time.monotonic() < deadline):
            time.sleep(0.02)
        out.append(("read repair", hit,
                    replicas[0].get(lost, APP) is not None,
                    dao.replication_status()["counters"]["readRepairs"]))
        out.append(("read", len(list(dao.find(APP, limit=-1))),
                    len(dao.find_columnar(APP))))
    finally:
        dao.close()
    return out


def test_one_scripted_sequence_ends_alike_in_both_packages(tmp_path):
    seen = {name: scripted(pkg, tmp_path / name)
            for name, pkg in PKGS.items()}
    assert seen["port"] == seen["ref"]
    assert seen["port"] == [
        ("acked at R", 10, [10, 10, 10]),
        ("acked at W", 5, 1, 1, 1, True),
        ("quorum lost", True, False, 1),      # transient, no hint added
        ("drain", True, 0, True),
        # the partial write below W stayed on replica 0: the scrub
        # converges it with the 11 events the wiped rejoiner lacked
        ("scrub", True, 12, 0, [16, 16, 16]),
        ("corrupt hint", True, [True, False, True], True),
        ("read repair", True, True, 1),
        ("read", 20, 20)]


def test_a_dead_remote_replica_sorts_as_the_reference_does(tmp_path):
    """Replicas are bare ``RemoteBackend`` children (no guard): a closed
    port raises the same ``StorageError`` type, which ``is_transient``
    calls transient, in both packages."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    seen = {}
    for name, pkg in PKGS.items():
        backend = pkg.storage.Storage(env={
            "PIO_STORAGE_SOURCES_M_TYPE": "memory",
            "PIO_STORAGE_SOURCES_R_TYPE": "replicated",
            "PIO_STORAGE_SOURCES_R_URLS": ",".join(
                [f"http://127.0.0.1:{port}"] * 3),
            "PIO_STORAGE_SOURCES_R_HINT_DIR": str(tmp_path / name),
            "PIO_STORAGE_SOURCES_R_TIMEOUT": "2",
            "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "M",
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "R",
            "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "M",
        }, resilience=False).get_events()
        child = backend.replicas[0]
        try:
            child.get("ev", APP)
        except Exception as e:  # noqa: BLE001 - the type is the result
            seen[name] = (type(child).__name__, type(e).__name__,
                          isinstance(e, pkg.storage.StorageError),
                          pkg.resilience.is_transient(e))
        backend.close()
    assert seen["port"] == seen["ref"] == (
        "_RemoteEvents", "StorageError", True, True)


# -- one drill over processes ----------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_sigkilled_replica_rejoins_through_the_storageserver_verb(tmp_path):
    ports = [_free_port() for _ in range(3)]

    def spawn(i: int) -> subprocess.Popen:
        """The verb on replica i's store and port, once it has printed
        the line that says it serves."""
        env = {**os.environ, "PYTHONUNBUFFERED": "1",
               "PIO_STORAGE_SOURCES_SQL_TYPE": "sqlite",
               "PIO_STORAGE_SOURCES_SQL_PATH": str(tmp_path / f"r{i}.db"),
               "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "SQL",
               "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "SQL",
               "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "SQL"}
        proc = subprocess.Popen(
            [sys.executable, "-m", "pio_tpu_torch", "storageserver",
             "--port", str(ports[i])], env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL)
        line = proc.stdout.readline()
        assert line == f"Storage Server on http://127.0.0.1:{ports[i]}\n"
        return proc

    procs = []
    client = None
    try:
        procs += [spawn(i) for i in range(3)]
        client = port_storage.Storage(env={
            "PIO_STORAGE_SOURCES_M_TYPE": "memory",
            "PIO_STORAGE_SOURCES_R_TYPE": "replicated",
            "PIO_STORAGE_SOURCES_R_URLS": ",".join(
                f"http://127.0.0.1:{p}" for p in ports),
            "PIO_STORAGE_SOURCES_R_WRITE_QUORUM": "2",
            "PIO_STORAGE_SOURCES_R_HINT_DIR": str(tmp_path / "hints"),
            "PIO_STORAGE_SOURCES_R_TIMEOUT": "5",
            "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "M",
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "R",
            "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "M",
        })
        dao = client.get_events()
        dao.init(APP)
        acked: list[str] = []
        errors: list[str] = []

        def ingest(worker: int, lo: int, hi: int) -> None:
            for k in range(lo, hi):
                batch = [_ev(PKGS["port"], 1000 * worker + 10 * k + j)
                         for j in range(10)]
                try:
                    acked.extend(dao.insert_batch(batch, APP))
                except Exception as e:  # noqa: BLE001 - fails the drill
                    errors.append(f"{worker}: {e!r}")
                    return

        def round_(lo: int, hi: int) -> None:
            workers = [threading.Thread(target=ingest, args=(w, lo, hi))
                       for w in range(3)]
            for t in workers:
                t.start()
            for t in workers:
                t.join(timeout=60)
                assert not t.is_alive()

        round_(0, 5)
        procs[2].send_signal(signal.SIGKILL)        # mid-ingest
        procs[2].wait(timeout=10)
        round_(5, 10)
        assert not errors, errors[:3]
        assert len(acked) == len(set(acked)) == 300
        inner = dao._dao
        assert inner.hint_logs[2].depth() >= 1
        have = {e.event_id for e in dao.find(APP, limit=-1)}
        assert set(acked) <= have

        procs[2] = spawn(2)                          # the same store
        inner.breakers[2].reset()
        deadline = time.monotonic() + 60
        while inner.hint_logs[2].depth() and time.monotonic() < deadline:
            time.sleep(0.1)
        assert inner.hint_logs[2].depth() == 0, "hints never drained"
        assert inner.scrub(APP, repair=False)["divergentBuckets"] == 0
        frames = [encode_columnar_events(r.find_columnar(APP))
                  for r in inner.replicas]
        assert frames[0] == frames[1] == frames[2]
        assert len(inner.replicas[2].find_columnar(APP)) == 300
    finally:
        if client is not None:
            client.close()
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            p.wait(timeout=30)
