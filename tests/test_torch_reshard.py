"""The port's live elastic resharding (``serving_fleet/reshard.py`` and
the shards' and router's reshard paths) as the JAX package's tests hold
the reference's, on the CPU:

  * the owners map and the move set of a reshard equal the reference's
    byte for byte, deterministic, minimal and balanced; N' = N is a
    no-op; the record round-trips;
  * a partition slice through the kind-5 wire, and a corrupt one refused;
  * grow 2 -> 3 and shrink back 3 -> 2 under concurrent queries and
    fold-ins: no 5xx, every answer the single-host deploy's on both
    sides of each cutover, no acked fold-in lost on any replica (nor
    one acked while a shard builds or holds its new arm), the
    migration on every surface;
  * mid-flight dual routing and dual-written fold-ins; an abort
    restoring the old plan bit for bit; a failed cutover aborting by
    itself; transfer faults absorbed by the retry; a shrink whose
    retiring group is dead rebuilt from the stored blobs; bad requests
    refused; the gauges; the ``reshard`` verb.
"""

import _torch_cpu  # noqa: F401  (one CPU thread: see the module)
import json
import threading
import time

import numpy as np
import pytest

from test_torch_fleet import (  # noqa: F401
    answer,
    call,
    cpu_fleet,
    oracle,
    time_limit,
    trained,
)

from pio_tpu.serving_fleet.plan import (
    compute_reshard_owners as ref_compute_reshard_owners,
)
from pio_tpu.serving_fleet.plan import default_owners as ref_default_owners
from pio_tpu.serving_fleet.plan import plan_diff as ref_plan_diff
from pio_tpu_torch.__main__ import main as port_main
from pio_tpu_torch.resilience import chaos
from pio_tpu_torch.serving_fleet import rpcwire
from pio_tpu_torch.serving_fleet.fleet import resolve_fleet_model
from pio_tpu_torch.serving_fleet.plan import (
    N_PARTITIONS,
    compute_reshard_owners,
    default_owners,
    load_plan,
    partition_model,
    partition_of,
    plan_diff,
    slice_partition,
)
from pio_tpu_torch.serving_fleet.reshard import (
    VERDICT_ABORTED,
    VERDICT_COMMITTED,
    ReshardRecord,
    load_reshard_record,
)
from pio_tpu_torch.serving_fleet.shard import (
    ShardConfig,
    create_shard_server,
)

pytestmark = pytest.mark.usefixtures("time_limit")


# -- owners maps and move sets ------------------------------------------------

@pytest.mark.parametrize("n_old,n_new", [(1, 2), (2, 3), (3, 2), (2, 5),
                                         (5, 3), (4, 4), (3, 1), (7, 32)])
def test_reshard_owners_equal_the_reference(n_old, n_new):
    """The successor owners map and its move set, serialized, are the
    reference's byte for byte, from a default map and from a resharded
    one."""
    for old, ref_old in (
            (default_owners(n_old), ref_default_owners(n_old)),
            (compute_reshard_owners(default_owners(5), n_old),
             ref_compute_reshard_owners(ref_default_owners(5), n_old))):
        assert json.dumps(old) == json.dumps(ref_old)
        new = compute_reshard_owners(old, n_new)
        assert json.dumps(new) == json.dumps(
            ref_compute_reshard_owners(ref_old, n_new))
        assert json.dumps(plan_diff(old, new)) == json.dumps(
            ref_plan_diff(ref_old, ref_compute_reshard_owners(ref_old,
                                                               n_new)))


def test_reshard_owners_deterministic_and_byte_identical():
    old = default_owners(2)
    a = compute_reshard_owners(old, 3)
    b = compute_reshard_owners(tuple(old), 3)
    assert a == b
    assert json.dumps(plan_diff(old, a)) == json.dumps(plan_diff(old, b))
    c1 = compute_reshard_owners(compute_reshard_owners(old, 5), 3)
    c2 = compute_reshard_owners(compute_reshard_owners(old, 5), 3)
    assert c1 == c2


def test_reshard_owners_minimal_and_balanced():
    old = default_owners(2)
    new = compute_reshard_owners(old, 3)
    moves = plan_diff(old, new)
    changed = [p for p in range(N_PARTITIONS) if old[p] != new[p]]
    assert [m[0] for m in moves] == changed
    assert all(old[p] == o and new[p] == n for p, o, n in moves)
    assert sorted(new.count(s) for s in range(3)) == [10, 11, 11]
    assert len(moves) == new.count(2)
    back = compute_reshard_owners(new, 2)
    shrink = plan_diff(new, back)
    assert {m[0] for m in shrink} >= {p for p in range(N_PARTITIONS)
                                      if new[p] == 2}
    assert all(o != n for _, o, n in shrink)
    assert max(back) <= 1


def test_reshard_noop_when_already_at_target():
    old = default_owners(3)
    assert compute_reshard_owners(old, 3) == old
    assert plan_diff(old, compute_reshard_owners(old, 3)) == ()


def test_reshard_record_roundtrip():
    rec = ReshardRecord(
        instance_id="i1", plan_version_old=1, plan_version_new=2,
        n_shards_old=2, n_shards_new=3, owners_old=default_owners(2),
        owners_new=compute_reshard_owners(default_owners(2), 3),
        moving=((7, 1, 2), (9, 0, 2)), staged=(7,))
    assert ReshardRecord.from_json(rec.to_json()) == rec


# -- slice / kind-5 wire ------------------------------------------------------

def test_partition_slice_wire_roundtrip(trained):
    storage, *_, iid = trained
    _, model = resolve_fleet_model(storage, "rec")
    part = partition_model(model, iid, 2)[0]
    sl = slice_partition(part, partition_of(part.user_ids[0]))
    assert sl.user_ids
    out = rpcwire.decode_partition_slice(rpcwire.encode_partition_slice(sl))
    assert out.partition == sl.partition and out.instance_id == iid
    assert out.user_ids == sl.user_ids and out.item_ids == sl.item_ids
    np.testing.assert_array_equal(out.user_rows, sl.user_rows)
    np.testing.assert_array_equal(out.item_gidx, sl.item_gidx)
    np.testing.assert_array_equal(out.item_rows, sl.item_rows)


def test_partition_slice_wire_rejects_corruption(trained):
    storage, *_, iid = trained
    _, model = resolve_fleet_model(storage, "rec")
    part = partition_model(model, iid, 2)[0]
    data = bytearray(rpcwire.encode_partition_slice(
        slice_partition(part, partition_of(part.user_ids[0]))))
    data[len(data) // 2] ^= 0xFF
    with pytest.raises(rpcwire.RpcWireError):
        rpcwire.decode_partition_slice(bytes(data))


# -- in-process end to end ----------------------------------------------------

def _join_group(storage, shard_index, n_shards, n_replicas=2):
    """Boot the NEW shard group a grow adds (join-reshard mode: empty,
    awaiting staged slices)."""
    servers, urls = [], []
    for _r in range(n_replicas):
        http, srv = create_shard_server(storage, ShardConfig(
            ip="127.0.0.1", port=0, shard_index=shard_index,
            n_shards=n_shards, engine_id="rec", join_reshard=True,
            device="cpu"))
        http.start()
        servers.append((http, srv))
        urls.append(f"http://127.0.0.1:{http.port}")
    return servers, urls


def _wait_reshard_done(port, timeout=60):
    deadline = time.monotonic() + timeout
    st = None
    while time.monotonic() < deadline:
        _, st = call(port, "GET", "/reshard/status")
        if not st.get("inFlight"):
            return st
        time.sleep(0.05)
    raise AssertionError(f"reshard still in flight after {timeout}s: {st}")


def test_grow_2_to_3_and_back_zero_5xx_under_load(trained):
    """Reshard 2 -> 3 and back to 2 while queries and fold-ins hammer the
    router: no 5xx, the single-host answers on every side of both
    cutovers, no fold-in acked during either lost on any replica, the
    migration on every surface."""
    storage, engine, ep, ctx, iid = trained
    qs = oracle(storage, engine, ep, ctx, iid)
    handle = cpu_fleet(storage)
    port = handle.router_http.port
    queries = [{"user": f"u{u}", "num": 4} for u in range(12)]
    untouched = queries[8:]     # users the fold-in thread never folds

    def parity(qs_):
        for q in qs_:
            s, out = call(port, "POST", "/queries.json", body=dict(q))
            assert s == 200 and out == answer(qs, q), q

    parity(queries)
    statuses: list[int] = []
    lock = threading.Lock()
    stop = threading.Event()

    def hammer(w):
        while not stop.is_set():
            s, _ = call(port, "POST", "/queries.json",
                        body={"user": f"u{w}", "num": 3})
            with lock:
                statuses.append(s)

    fold_rows: dict[str, list[float]] = {}

    def folder(stop_folds, i):
        while not stop_folds.is_set():
            uid = f"u{i % 8}"
            row = [float(i + 1)] * 4
            out = handle.router.upsert_users({uid: row}, staleness_s=0.1)
            if out.get("ok"):
                fold_rows[uid] = row
            i += 1
            time.sleep(0.02)

    def served_rows(groups):
        """Every acked fold-in is the row each replica of its owner
        serves."""
        plan = handle.router.plan
        for uid, row in fold_rows.items():
            for url in groups[plan.owner_of(uid)]:
                s, got = call(int(url.rsplit(":", 1)[1]), "POST",
                              "/shard/user_row", body={"user": uid})
                assert s == 200 and got["found"], (uid, url, got)
                assert got["row"] == row, (uid, url)

    threads = [threading.Thread(target=hammer, args=(w,)) for w in range(3)]
    stop_folds = threading.Event()
    fold_thread = threading.Thread(target=folder, args=(stop_folds, 0))
    new_servers, urls = _join_group(storage, shard_index=2, n_shards=3)
    try:
        for t in threads + [fold_thread]:
            t.start()
        time.sleep(0.2)
        s, out = call(port, "POST", "/reshard/begin",
                      body={"nShards": 3, "endpoints": [urls]})
        assert s == 200, out
        assert out["inFlight"] and out["planVersionNew"] == 2
        st = _wait_reshard_done(port)
        assert st["verdict"] == VERDICT_COMMITTED, st
        assert st["partitionsStaged"] == st["partitionsMoving"] > 0
        time.sleep(0.3)
        stop_folds.set()
        fold_thread.join(timeout=30)
        assert not fold_thread.is_alive()
        parity(untouched)
        served_rows(handle.endpoints + [urls])
        s, fs = call(port, "GET", "/fleet.json")
        assert fs["plan"]["nShards"] == 3
        assert fs["plan"]["planVersion"] == 2
        assert fs["reshard"]["verdict"] == VERDICT_COMMITTED
        assert fs["reshardPartitionsPending"] == 0
        assert load_plan(storage, iid).plan_version == 2
        rec = load_reshard_record(storage, iid)
        assert rec.verdict == VERDICT_COMMITTED
        assert set(rec.staged) == {m[0] for m in rec.moving}
        # and back to 2 under the queries and the fold-ins
        stop_folds = threading.Event()
        fold_thread = threading.Thread(target=folder,
                                       args=(stop_folds, 10_000))
        fold_thread.start()
        s, out = call(port, "POST", "/reshard/begin", body={"nShards": 2})
        assert s == 200, out
        assert out["planVersionNew"] == 3
        st = _wait_reshard_done(port)
        assert st["verdict"] == VERDICT_COMMITTED, st
        time.sleep(0.3)
        stop_folds.set()
        fold_thread.join(timeout=30)
        assert not fold_thread.is_alive()
        stop.set()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        assert statuses and all(s < 500 for s in statuses), \
            [s for s in statuses if s >= 500][:5]
        parity(untouched)
        plan = handle.router.plan
        assert plan.n_shards == 2 and plan.plan_version == 3
        served_rows(handle.endpoints)
        s, _ = call(port, "GET", "/readyz")
        assert s == 200
    finally:
        stop.set()
        stop_folds.set()
        for http, _ in new_servers:
            http.stop()
        handle.close()
        qs.close()


def _pause_at(point_name):
    """Patch chaos.maybe_inject to block at one named point until
    released: the mid-migration window the dual-route test needs."""
    reached = threading.Event()
    release = threading.Event()
    orig = chaos.maybe_inject

    def patched(point):
        if point == point_name:
            reached.set()
            release.wait(timeout=60)
        return orig(point)

    return patched, reached, release


def test_midflight_dual_route_and_foldin(trained, monkeypatch):
    storage, *_ = trained
    handle = cpu_fleet(storage)
    port = handle.router_http.port
    patched, reached, release = _pause_at("reshard.cutover")
    monkeypatch.setattr(chaos, "maybe_inject", patched)
    new_servers, urls = _join_group(storage, shard_index=2, n_shards=3)
    try:
        s, out = call(port, "POST", "/reshard/begin",
                      body={"nShards": 3, "endpoints": [urls]})
        assert s == 200, out
        assert reached.wait(timeout=60), "migration never hit the cutover"
        _, st = call(port, "GET", "/reshard/status")
        assert st["inFlight"] and st["partitionsStaged"] == \
            st["partitionsMoving"]
        moving = {m["partition"]: (m["from"], m["to"]) for m in st["moves"]}
        uid = next(f"u{u}" for u in range(20)
                   if partition_of(f"u{u}") in moving)
        src, dst = moving[partition_of(uid)]
        assert dst == 2
        row = [0.25, -0.5, 0.75, 1.0]
        out = handle.router.upsert_users({uid: row}, staleness_s=0.1)
        assert out.get("ok") and out.get("reshardDualFailures") == 0, out
        new_port = int(urls[0].rsplit(":", 1)[1])
        s, got = call(new_port, "POST", "/shard/user_row",
                      body={"user": uid})
        assert s == 200 and got["found"] and got["row"] == row, got
        for h, _srv in handle.shards[2 * src:2 * src + 2]:
            h.stop()
        s, out = call(port, "POST", "/queries.json",
                      body={"user": uid, "num": 3})
        assert s == 200, out
        assert out["itemScores"], "dual-routed read lost the user row"
        release.set()
        st = _wait_reshard_done(port)
        assert st["verdict"] == VERDICT_COMMITTED, st
        s, got = call(new_port, "POST", "/shard/user_row",
                      body={"user": uid})
        assert s == 200 and got["found"] and got["row"] == row, got
    finally:
        release.set()
        for http, _ in new_servers:
            http.stop()
        handle.close()


@pytest.mark.parametrize("pause", ["prepare", "cutover"])
def test_foldin_of_a_kept_user_mid_reshard_survives_activation(
        trained, monkeypatch, pause):
    """A fold-in of a user whose partition stays where it is, acked while
    its shard builds the new topology's arm (``prepare``) or after that
    arm is built (``cutover``): the activated arm serves it on every
    replica, as it serves a moving user's dual-written row."""
    from pio_tpu_torch.serving_fleet import shard as shard_mod

    storage, *_ = trained
    handle = cpu_fleet(storage)
    port = handle.router_http.port
    if pause == "cutover":
        patched, reached, release = _pause_at("reshard.cutover")
        monkeypatch.setattr(chaos, "maybe_inject", patched)
    else:
        reached, release = threading.Event(), threading.Event()
        merge = shard_mod.merge_reshard

        def paused_merge(*args, **kw):
            if not reached.is_set():
                reached.set()
                release.wait(timeout=60)
            return merge(*args, **kw)

        monkeypatch.setattr(shard_mod, "merge_reshard", paused_merge)
    new_servers, urls = _join_group(storage, shard_index=2, n_shards=3)
    try:
        s, out = call(port, "POST", "/reshard/begin",
                      body={"nShards": 3, "endpoints": [urls]})
        assert s == 200, out
        assert reached.wait(timeout=60), f"migration never hit {pause}"
        _, st = call(port, "GET", "/reshard/status")
        moving = {m["partition"] for m in st["moves"]}
        uid = next(f"u{u}" for u in range(40)
                   if partition_of(f"u{u}") not in moving
                   and handle.router.plan.owner_of(f"u{u}") == 0)
        row = [0.5, -0.25, 1.5, -2.0]
        out = handle.router.upsert_users({uid: row}, staleness_s=0.1)
        assert out.get("ok") and out["groups"]["0"]["fullyApplied"], out
        release.set()
        st = _wait_reshard_done(port)
        assert st["verdict"] == VERDICT_COMMITTED, st
        assert handle.router.plan.owner_of(uid) == 0
        for url in handle.endpoints[0]:
            s, got = call(int(url.rsplit(":", 1)[1]), "POST",
                          "/shard/user_row", body={"user": uid})
            assert s == 200 and got["found"] and got["row"] == row, \
                (url, got)
    finally:
        release.set()
        for http, _ in new_servers:
            http.stop()
        handle.close()


@pytest.mark.parametrize("lands", ["before_cutover", "after_cutover"])
def test_foldin_routed_before_the_reshard_is_acked_only_where_served(
        trained, monkeypatch, lands):
    """C16: a fold-in whose router read the routing before the reshard
    set its own (the fan held at the old owner's chaos point) reaches
    the old owner after the partition was extracted and staged, with
    the migration held at the cutover (``before_cutover``) or committed
    (``after_cutover``). Either it is not acked, or every replica of the
    partition's new owner serves it after the cutover."""
    storage, *_ = trained
    handle = cpu_fleet(storage)
    port = handle.router_http.port
    old = default_owners(2)
    moving = {p: (o, n)
              for p, o, n in plan_diff(old, compute_reshard_owners(old, 3))}
    uid = next(f"u{u}" for u in range(40) if partition_of(f"u{u}") in moving)
    src, dst = moving[partition_of(uid)]
    patched, at_fold, release_fold = _pause_at(
        f"fleet.shard{src}.upsert_users")
    monkeypatch.setattr(chaos, "maybe_inject", patched)
    patched, at_cutover, release_cutover = _pause_at("reshard.cutover")
    monkeypatch.setattr(chaos, "maybe_inject", patched)
    new_servers, urls = _join_group(storage, shard_index=dst, n_shards=3)
    row = [0.75, -1.25, 0.5, 2.0]
    result: dict = {}
    fold = threading.Thread(target=lambda: result.update(
        handle.router.upsert_users({uid: row}, staleness_s=0.1)))
    try:
        fold.start()
        assert at_fold.wait(timeout=60), "the fold never reached its fan"
        assert handle.router.reshard_routing is None
        s, out = call(port, "POST", "/reshard/begin",
                      body={"nShards": 3, "endpoints": [urls]})
        assert s == 200, out
        assert at_cutover.wait(timeout=60), "migration never hit cutover"
        _, st = call(port, "GET", "/reshard/status")
        assert st["partitionsStaged"] == st["partitionsMoving"], st
        if lands == "after_cutover":
            release_cutover.set()
            assert _wait_reshard_done(port)["verdict"] == VERDICT_COMMITTED
        release_fold.set()
        fold.join(timeout=60)
        assert not fold.is_alive() and "ok" in result, result
        release_cutover.set()
        st = _wait_reshard_done(port)
        assert st["verdict"] == VERDICT_COMMITTED, st
        assert handle.router.plan.owner_of(uid) == dst
        if result["ok"]:
            for url in urls:
                s, got = call(int(url.rsplit(":", 1)[1]), "POST",
                              "/shard/user_row", body={"user": uid})
                assert s == 200 and got["found"] and got["row"] == row, \
                    (url, got, result)
    finally:
        release_fold.set()
        release_cutover.set()
        for http, _ in new_servers:
            http.stop()
        handle.close()


def test_abort_midflight_restores_old_plan_bit_identical(trained,
                                                         monkeypatch):
    storage, engine, ep, ctx, iid = trained
    qs = oracle(storage, engine, ep, ctx, iid)
    handle = cpu_fleet(storage)
    port = handle.router_http.port
    old_plan_json = handle.router.plan.to_json()
    reached = threading.Event()
    release = threading.Event()
    orig = chaos.maybe_inject

    def patched(point):
        if point == "reshard.cutover":
            reached.set()
            deadline = time.monotonic() + 60
            while (not release.is_set()
                   and not handle.router.reshard._abort.is_set()
                   and time.monotonic() < deadline):
                time.sleep(0.01)
        return orig(point)

    monkeypatch.setattr(chaos, "maybe_inject", patched)
    new_servers, urls = _join_group(storage, shard_index=2, n_shards=3)
    try:
        s, out = call(port, "POST", "/reshard/begin",
                      body={"nShards": 3, "endpoints": [urls]})
        assert s == 200, out
        assert reached.wait(timeout=60)
        s, out = call(port, "POST", "/reshard/abort")
        assert s == 200, out
        st = _wait_reshard_done(port)
        assert st["verdict"] == VERDICT_ABORTED, st
        assert handle.router.plan.to_json() == old_plan_json
        assert load_plan(storage, iid).to_json() == old_plan_json
        s, fs = call(port, "GET", "/fleet.json")
        assert fs["plan"]["nShards"] == 2
        assert fs["plan"]["planVersion"] == 1
        assert sorted(int(k) for k in fs["shards"]) == [0, 1]
        for u in range(10):
            q = {"user": f"u{u}", "num": 4}
            s, out = call(port, "POST", "/queries.json", body=dict(q))
            assert s == 200 and out == answer(qs, q), q
        s, _ = call(port, "GET", "/readyz")
        assert s == 200
        assert load_reshard_record(storage, iid).verdict == VERDICT_ABORTED
        s, out = call(port, "POST", "/reshard/begin", body={"nShards": 2})
        assert s == 200 and out.get("noop"), out
    finally:
        release.set()
        for http, _ in new_servers:
            http.stop()
        handle.close()
        qs.close()


def test_failed_cutover_auto_aborts(trained):
    storage, *_ = trained
    handle = cpu_fleet(storage)
    port = handle.router_http.port
    old_plan_json = handle.router.plan.to_json()
    new_servers, urls = _join_group(storage, shard_index=2, n_shards=3)
    try:
        with chaos.inject("reshard.cutover", error=1.0, seed=3) as monkey:
            s, out = call(port, "POST", "/reshard/begin",
                          body={"nShards": 3, "endpoints": [urls]})
            assert s == 200, out
            st = _wait_reshard_done(port)
        assert monkey.injected["reshard.cutover"]["error"] >= 1
        assert st["verdict"] == VERDICT_ABORTED, st
        assert handle.router.plan.to_json() == old_plan_json
        s, out = call(port, "POST", "/queries.json",
                      body={"user": "u1", "num": 3})
        assert s == 200 and out["itemScores"]
    finally:
        for http, _ in new_servers:
            http.stop()
        handle.close()


def test_transfer_chaos_absorbed_by_retry(trained):
    storage, *_ = trained
    handle = cpu_fleet(storage)
    port = handle.router_http.port
    new_servers, urls = _join_group(storage, shard_index=2, n_shards=3)
    try:
        # the reference's seed: several injected failures, never three
        # in a row for one partition (the retry budget)
        with chaos.inject("reshard.transfer", error=0.4, seed=1) as monkey:
            s, out = call(port, "POST", "/reshard/begin",
                          body={"nShards": 3, "endpoints": [urls]})
            assert s == 200, out
            st = _wait_reshard_done(port)
        assert st["verdict"] == VERDICT_COMMITTED, st
        assert monkey.injected.get("reshard.transfer",
                                   {}).get("error", 0) >= 1
    finally:
        for http, _ in new_servers:
            http.stop()
        handle.close()


def test_shrink_with_dead_source_rebuilds_from_storage(trained):
    storage, engine, ep, ctx, iid = trained
    qs = oracle(storage, engine, ep, ctx, iid)
    handle = cpu_fleet(storage, n_shards=3)
    port = handle.router_http.port
    try:
        for http, _srv in handle.shards[4:6]:
            http.stop()
        s, out = call(port, "POST", "/reshard/begin", body={"nShards": 2})
        assert s == 200, out
        st = _wait_reshard_done(port)
        assert st["verdict"] == VERDICT_COMMITTED, st
        s, fs = call(port, "GET", "/fleet.json")
        assert fs["plan"]["nShards"] == 2
        assert sorted(int(k) for k in fs["shards"]) == [0, 1]
        for u in range(10):
            q = {"user": f"u{u}", "num": 4}
            s, out = call(port, "POST", "/queries.json", body=dict(q))
            assert s == 200 and out == answer(qs, q), q
    finally:
        handle.close()
        qs.close()


def test_reshard_refuses_bad_requests(trained):
    storage, *_ = trained
    handle = cpu_fleet(storage)
    port = handle.router_http.port
    try:
        s, out = call(port, "POST", "/reshard/abort")
        assert s == 409 and "no reshard" in out["message"]
        s, out = call(port, "POST", "/reshard/begin", body={"nShards": 0})
        assert s == 409
        s, out = call(port, "POST", "/reshard/begin",
                      body={"nShards": N_PARTITIONS + 1})
        assert s == 409
        s, out = call(port, "POST", "/reshard/begin", body={"nShards": 3})
        assert s == 409 and "endpoint" in out["message"]
        s, out = call(port, "GET", "/reshard/status")
        assert s == 200 and out == {"inFlight": False, "planVersion": 1}
    finally:
        handle.close()


def test_reshard_gauges_on_metrics(trained):
    import urllib.request

    storage, *_ = trained
    handle = cpu_fleet(storage)
    port = handle.router_http.port
    new_servers, urls = _join_group(storage, shard_index=2, n_shards=3)
    try:
        s, out = call(port, "POST", "/reshard/begin",
                      body={"nShards": 3, "endpoints": [urls]})
        assert s == 200, out
        _wait_reshard_done(port)
        text = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=10).read().decode()
        assert "pio_reshard_partitions_moved_total" in text
        assert "pio_reshard_partitions_pending_total" in text
        s, mj = call(port, "GET", "/metrics.json")
        assert mj["reshard"]["partitionsPending"] == 0
        assert mj["reshard"]["partitionsMoved"] > 0
    finally:
        for http, _ in new_servers:
            http.stop()
        handle.close()


def test_reshard_verb_follows_and_reports_the_migration(trained, capsys):
    """``reshard --shards 3 --endpoint ...`` drives and follows the
    migration to COMMITTED (rc 0); ``--status`` prints the record;
    ``--abort`` with nothing in flight is refused (rc 1)."""
    storage, *_ = trained
    handle = cpu_fleet(storage)
    port = handle.router_http.port
    new_servers, urls = _join_group(storage, shard_index=2, n_shards=3)
    try:
        rc = port_main(["reshard", "--shards", "3", "--endpoint",
                        ",".join(urls), "--port", str(port)])
        out = capsys.readouterr().out
        assert rc == 0, out
        assert "resharding 2 -> 3 shard(s)" in out
        assert "reshard COMMITTED" in out
        assert port_main(["reshard", "--status", "--port", str(port)]) == 0
        st = json.loads(capsys.readouterr().out)
        assert st["verdict"] == VERDICT_COMMITTED and not st["inFlight"]
        assert port_main(["reshard", "--abort", "--port", str(port)]) == 1
        assert port_main(["reshard", "--port", str(port)]) == 1
        assert "needs --shards" in capsys.readouterr().err
    finally:
        for http, _ in new_servers:
            http.stop()
        handle.close()
