"""The port's binary shard-RPC wire (``serving_fleet/rpcwire.py``) against
the JAX package's, and the pooled RPC plane end to end, on the CPU:

  * every frame kind the port encodes is the reference's byte for byte,
    and each package decodes the other's frames to the same values;
  * round-trips with non-string ids and empty shards, direction and kind
    confusion, every truncation and random bit-flips rejected, a forged
    count dying before allocation;
  * the shard routes' Accept/Content-Type negotiation with bit-identical
    values on both codecs;
  * the fleet's answers on the binary wire, on the JSON wire and on a
    mixed fleet (a JSON-only shard: a sticky downgrade logged once) all
    the port's single-host deploy's bit for bit;
  * per-codec RPC counters on the router's and the shards' /metrics;
  * the keep-alive drill: a shard listener killed under load, failover
    with no 5xx, the pool evicting the dead sockets and re-dialling.
"""

import logging
import random
import struct
import threading
import time
import urllib.request

import numpy as np
import pytest

from test_torch_fleet import (  # noqa: F401
    QUERIES,
    answer,
    call,
    oracle,
    time_limit,
    trained,
)

from pio_tpu.serving_fleet import rpcwire as ref_rpcwire
from pio_tpu.serving_fleet.plan import PartitionSlice as RefPartitionSlice
from pio_tpu_torch.ops.retrieval import encode_rows
from pio_tpu_torch.server.http import HttpApp, HttpServer
from pio_tpu_torch.serving_fleet import rpcwire
from pio_tpu_torch.serving_fleet.fleet import deploy_fleet
from pio_tpu_torch.serving_fleet.plan import PartitionSlice, shard_of
from pio_tpu_torch.serving_fleet.router import (
    RouterConfig,
    create_fleet_router,
)
from pio_tpu_torch.serving_fleet.shard import (
    ShardConfig,
    create_shard_server,
)
from pio_tpu_torch.utils import durable
from pio_tpu_torch.utils.httpclient import (
    HttpClientError,
    JsonHttpClient,
    default_pool,
)

pytestmark = pytest.mark.usefixtures("time_limit")


def _slice(cls, qdtype):
    rng = np.random.default_rng(4)
    item_rows = rng.standard_normal((5, 3)).astype(np.float32)
    qrows = qscales = None
    if qdtype is not None:
        qrows, qscales = encode_rows(item_rows, qdtype)
    return cls(
        partition=2, instance_id="inst-1", k=3,
        user_ids=["u1", "u2"],
        user_rows=rng.standard_normal((2, 3)).astype(np.float32),
        item_ids=[f"i{n}" for n in range(5)],
        item_gidx=np.arange(5, dtype=np.int32),
        item_rows=item_rows,
        qdtype=qdtype, item_qrows=qrows, item_qscales=qscales)


def _frames(mod, slice_cls):
    """Every frame kind, encoded by ``mod`` from the same seeded values,
    by name."""
    rng = np.random.default_rng(0)
    row = rng.standard_normal(8).astype(np.float32)
    rows = rng.standard_normal((3, 8)).astype(np.float32)
    scores = rng.standard_normal(17).astype(np.float32)
    gidx = rng.integers(0, 1000, 17).astype(np.int32)
    items = [f"i{n}" for n in range(16)] + [42]
    mat = rng.standard_normal((3, 4)).astype(np.float32)
    results = [(items[:4], gidx[:4], scores[:4]), ([], gidx[:0], scores[:0]),
               (items[4:9], gidx[4:9], scores[4:9])]
    return {
        "topk_request": mod.encode_topk_request(row, 7, "candidate"),
        "topk_request_list": mod.encode_topk_request(
            [float(x) for x in row], 7),
        "candidates_request": mod.encode_candidates_request(row, 5),
        "topk_batch_request": mod.encode_topk_batch_request(
            rows, [3, 5, 3], "active"),
        "candidates_batch_request": mod.encode_candidates_batch_request(
            rows, [2, 2, 9], "candidate"),
        "topk_response": mod.encode_topk_response(items, gidx, scores),
        "topk_response_empty": mod.encode_topk_response(
            [], gidx[:0], scores[:0]),
        "topk_batch_response": mod.encode_topk_batch_response(results),
        "user_row_found": mod.encode_user_row_response(row),
        "user_row_missing": mod.encode_user_row_response(None),
        "item_rows": mod.encode_item_rows_response(["a", "b", 9], mat),
        "item_rows_empty": mod.encode_item_rows_response(
            [], np.zeros((0, 4), np.float32)),
        **{f"partition_slice_{q}": mod.encode_partition_slice(
            _slice(slice_cls, q)) for q in (None, "int8", "bf16")},
    }


_DECODERS = {
    "topk_request": "decode_topk_request",
    "topk_request_list": "decode_topk_request",
    "candidates_request": "decode_candidates_request",
    "topk_response": "decode_topk_response",
    "topk_response_empty": "decode_topk_response",
    "topk_batch_response": "decode_topk_batch_response",
    "user_row_found": "decode_user_row_response",
    "user_row_missing": "decode_user_row_response",
    "item_rows": "decode_item_rows_response",
    "item_rows_empty": "decode_item_rows_response",
}


def _plain(value):
    """A decoded value with its arrays as (dtype, bytes), comparable
    across the packages' classes."""
    if isinstance(value, np.ndarray):
        return (str(value.dtype), value.shape, value.tobytes())
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_plain(v) for v in value]
    if hasattr(value, "__dataclass_fields__"):
        return {f: _plain(getattr(value, f))
                for f in value.__dataclass_fields__}
    return value


@pytest.mark.parametrize("kind", sorted(_frames(rpcwire, PartitionSlice)))
def test_frames_equal_the_reference_both_ways(kind):
    """Each frame the port encodes is the reference's byte for byte; the
    port decodes the reference's frame, and the reference the port's,
    to the same values."""
    port = _frames(rpcwire, PartitionSlice)[kind]
    ref = _frames(ref_rpcwire, RefPartitionSlice)[kind]
    assert port == ref
    if kind.startswith("partition_slice"):
        got = rpcwire.decode_partition_slice(ref)
        want = ref_rpcwire.decode_partition_slice(port)
    elif kind.endswith("batch_request"):
        op = "topk" if kind.startswith("topk") else "candidates"
        got = rpcwire.decode_scoring_request(ref, op)
        want = ref_rpcwire.decode_scoring_request(port, op)
    else:
        got = getattr(rpcwire, _DECODERS[kind])(ref)
        want = getattr(ref_rpcwire, _DECODERS[kind])(port)
    assert _plain(got) == _plain(want)


def test_topk_roundtrip_bit_exact():
    rng = np.random.default_rng(0)
    scores = rng.standard_normal(17).astype(np.float32)
    gidx = rng.integers(0, 1000, 17).astype(np.int32)
    items = [f"i{n}" for n in range(16)] + [42]
    out = rpcwire.decode_topk_response(
        rpcwire.encode_topk_response(items, gidx, scores))
    assert out["items"] == items
    assert out["indices"].tolist() == gidx.tolist()
    assert out["scores"].tobytes() == scores.tobytes()


def test_scoring_batch_request_roundtrip():
    rows = np.random.default_rng(1).standard_normal((4, 6)).astype(
        np.float32)
    for op, enc in (("topk", rpcwire.encode_topk_batch_request),
                    ("candidates", rpcwire.encode_candidates_batch_request)):
        got_rows, ks, arm, batched = rpcwire.decode_scoring_request(
            enc(rows, [1, 2, 3, 4], "candidate"), op)
        assert batched and arm == "candidate" and list(ks) == [1, 2, 3, 4]
        assert np.asarray(got_rows, np.float32).tobytes() == rows.tobytes()
    # a solo frame decodes through the same entry point, unbatched
    got_rows, ks, arm, batched = rpcwire.decode_scoring_request(
        rpcwire.encode_topk_request(rows[0], 9), "topk")
    assert not batched and list(ks) == [9] and arm == "active"


def test_direction_and_kind_confusion_rejected():
    frame = rpcwire.encode_topk_request(np.zeros(4, np.float32), 3)
    with pytest.raises(rpcwire.RpcWireError):
        rpcwire.decode_topk_response(frame)
    with pytest.raises(rpcwire.RpcWireError):
        rpcwire.decode_user_row_response(frame)
    with pytest.raises(rpcwire.RpcWireError):
        rpcwire.decode_response("nope", frame)
    row = np.zeros(6, np.float32)
    with pytest.raises(rpcwire.RpcWireError):
        rpcwire.decode_topk_request(rpcwire.encode_candidates_request(row, 5))
    with pytest.raises(rpcwire.RpcWireError):
        rpcwire.decode_candidates_request(rpcwire.encode_topk_request(row, 5))


def test_every_truncation_and_bitflip_rejected():
    scores = np.arange(9, dtype=np.float32)
    gidx = np.arange(9, dtype=np.int32)
    frame = rpcwire.encode_topk_response(
        [f"i{n}" for n in range(9)], gidx, scores)
    for n in range(len(frame)):
        with pytest.raises(rpcwire.RpcWireError):
            rpcwire.decode_topk_response(frame[:n])
    rng = random.Random(0)
    for _ in range(64):
        flipped = bytearray(frame)
        pos = rng.randrange(len(frame))
        flipped[pos] ^= 1 << rng.randrange(8)
        with pytest.raises(rpcwire.RpcWireError):
            rpcwire.decode_topk_response(bytes(flipped))


@pytest.mark.parametrize("qdtype", ["int8", "bf16"])
def test_partition_slice_bitflips_rejected(qdtype):
    frame = rpcwire.encode_partition_slice(_slice(PartitionSlice, qdtype))
    out = rpcwire.decode_partition_slice(frame)
    assert out.qdtype == qdtype
    r = random.Random(5)
    for _ in range(32):
        flipped = bytearray(frame)
        pos = r.randrange(len(flipped))
        flipped[pos] ^= 1 << r.randrange(8)
        with pytest.raises(rpcwire.RpcWireError):
            rpcwire.decode_partition_slice(bytes(flipped))


def test_forged_count_dies_before_allocation():
    import json as _json

    hdr = _json.dumps({"n": 1 << 40, "items": []}).encode()
    payload = struct.pack(">BI", 2, len(hdr)) + hdr
    frame = durable.frame(payload, magic=rpcwire.RPC_MAGIC)
    t0 = time.monotonic()
    with pytest.raises(rpcwire.RpcWireError):
        rpcwire.decode_topk_response(frame)
    assert time.monotonic() - t0 < 0.1


# -- shard route negotiation --------------------------------------------------

def test_shard_routes_negotiate_binary_bit_identical(trained):
    storage, *_ = trained
    handle = deploy_fleet(storage, engine_id="rec", n_shards=2,
                          n_replicas=1, device="cpu")
    try:
        c = JsonHttpClient(handle.endpoints[0][0])
        jrow = c.request("POST", "/shard/user_row", {"user": "u0"})
        brow = rpcwire.decode_user_row_response(c.request(
            "POST", "/shard/user_row", {"user": "u0"},
            accept=rpcwire.RPC_CONTENT_TYPE))
        if jrow["found"]:
            assert [float(x) for x in brow["row"]] == jrow["row"]
        row = jrow.get("row") or [0.0] * 4
        jtop = c.request("POST", "/shard/topk", {"row": row, "k": 5})
        btop = rpcwire.decode_topk_response(c.request(
            "POST", "/shard/topk", {"row": row, "k": 5},
            accept=rpcwire.RPC_CONTENT_TYPE))
        btop2 = rpcwire.decode_topk_response(c.request(
            "POST", "/shard/topk",
            raw=rpcwire.encode_topk_request(row, 5),
            content_type=rpcwire.RPC_CONTENT_TYPE,
            accept=rpcwire.RPC_CONTENT_TYPE))
        for b in (btop, btop2):
            assert b["items"] == jtop["items"]
            assert b["indices"].tolist() == jtop["indices"]
            assert [float(s) for s in b["scores"]] == jtop["scores"]
        jrows = c.request("POST", "/shard/item_rows",
                          {"items": jtop["items"][:3] + ["nope"]})
        brows = rpcwire.decode_item_rows_response(c.request(
            "POST", "/shard/item_rows",
            {"items": jtop["items"][:3] + ["nope"]},
            accept=rpcwire.RPC_CONTENT_TYPE))
        assert {i: [float(x) for x in r]
                for i, r in brows["rows"].items()} == jrows["rows"]
        with pytest.raises(HttpClientError) as err:
            c.request("POST", "/shard/topk", raw=b"PIOR\x01garbage",
                      content_type=rpcwire.RPC_CONTENT_TYPE)
        assert err.value.status == 400
    finally:
        handle.close()


# -- fleet parity over both wires and a mixed fleet ---------------------------

def test_binary_and_json_wires_bit_identical_to_single_host(trained):
    storage, engine, ep, ctx, iid = trained
    qs = oracle(storage, engine, ep, ctx, iid)
    handle = deploy_fleet(storage, engine_id="rec", n_shards=2,
                          n_replicas=1, device="cpu")
    json_router = None
    try:
        json_http, json_router = create_fleet_router(
            storage, RouterConfig(engine_id="rec", rpc_wire="json",
                                  http_pooled=False, probe_interval_s=0,
                                  device="cpu"),
            handle.plan, handle.endpoints)
        for q in QUERIES:
            want = answer(qs, q)
            assert handle.router.query(dict(q)) == want, q
            assert json_router.query(dict(q)) == want, q
        assert handle.router.rpc_codec_counts["binary"] > 0
        assert handle.router.rpc_codec_counts["json"] == 0
        assert json_router.rpc_codec_counts["json"] > 0
        assert json_router.rpc_codec_counts["binary"] == 0
        for g in handle.router.shard_health().values():
            for rep in g["replicas"]:
                assert rep["binaryWire"] is True
                assert rep["connReuse"] is not None
    finally:
        if json_router is not None:
            json_http.stop()
            json_router.close()
        handle.close()
        qs.close()


def _legacy_shard_http(srv) -> HttpServer:
    """A JSON-only shard: the real ShardServer's compute behind routes
    without Accept negotiation or frame decoding."""
    app = HttpApp("legacy-shard")

    @app.route("POST", r"/shard/user_row")
    def user_row(req):
        body = req.json()
        row = srv.user_row(body["user"], arm=body.get("arm", "active"))
        if row is None:
            return 200, {"found": False}
        return 200, {"found": True, "row": row}

    @app.route("POST", r"/shard/topk")
    def topk(req):
        body = req.json()
        return 200, srv.topk(body["row"], int(body["k"]),
                             arm=body.get("arm", "active"))

    @app.route("POST", r"/shard/item_rows")
    def item_rows(req):
        body = req.json()
        return 200, srv.item_rows(list(body["items"]),
                                  arm=body.get("arm", "active"))

    @app.route("GET", r"/shard/info")
    def info(req):
        return 200, srv.info()

    @app.route("GET", r"/healthz")
    @app.route("GET", r"/readyz")
    def health(req):
        return 200, {"ready": True}

    return HttpServer(app).start()


def test_mixed_fleet_sticky_downgrade_logged_once(trained, caplog):
    storage, engine, ep, ctx, iid = trained
    qs = oracle(storage, engine, ep, ctx, iid)
    handle = deploy_fleet(storage, engine_id="rec", n_shards=2,
                          n_replicas=1, device="cpu")
    legacy = router = None
    try:
        legacy = _legacy_shard_http(handle.shards[0][1])
        endpoints = [[f"http://127.0.0.1:{legacy.port}"],
                     handle.endpoints[1]]
        http, router = create_fleet_router(
            storage, RouterConfig(engine_id="rec", probe_interval_s=0,
                                  device="cpu"),
            handle.plan, endpoints)
        with caplog.at_level(logging.WARNING,
                             logger="pio_tpu_torch.fleet.router"):
            for q in QUERIES:
                assert router.query(dict(q)) == answer(qs, q), q
                assert router.query(dict(q)) == answer(qs, q), q
        downgrades = [r for r in caplog.records
                      if "sticky JSON downgrade" in r.message]
        assert len(downgrades) == 1
        assert router.replicas[0][0].binary_wire is False
        assert router.replicas[1][0].binary_wire is True
        assert router.rpc_codec_counts["json"] > 0
        assert router.rpc_codec_counts["binary"] > 0
    finally:
        if router is not None:
            http.stop()
            router.close()
        if legacy is not None:
            legacy.stop()
        handle.close()
        qs.close()


def test_confirmed_binary_replica_rolled_back_downgrades_not_500s(
        trained, caplog):
    storage, engine, ep, ctx, iid = trained
    qs = oracle(storage, engine, ep, ctx, iid)
    handle = deploy_fleet(storage, engine_id="rec", n_shards=2,
                          n_replicas=1, device="cpu")
    legacy = router = None
    try:
        legacy = _legacy_shard_http(handle.shards[0][1])
        endpoints = [[f"http://127.0.0.1:{legacy.port}"],
                     handle.endpoints[1]]
        http, router = create_fleet_router(
            storage, RouterConfig(engine_id="rec", probe_interval_s=0,
                                  device="cpu"),
            handle.plan, endpoints)
        router.replicas[0][0].binary_wire = True
        user = next(f"u{i}" for i in range(10)
                    if shard_of(f"u{i}", 2) == 1)
        q = {"user": user, "num": 4}
        with caplog.at_level(logging.WARNING,
                             logger="pio_tpu_torch.fleet.router"):
            assert router.query(dict(q)) == answer(qs, q)
        assert router.replicas[0][0].binary_wire is False
        assert any("sticky JSON downgrade" in r.message
                   for r in caplog.records)
        for q2 in QUERIES:
            assert router.query(dict(q2)) == answer(qs, q2), q2
    finally:
        if router is not None:
            http.stop()
            router.close()
        if legacy is not None:
            legacy.stop()
        handle.close()
        qs.close()


def _text(port, path):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=30) as resp:
        return resp.status, resp.read().decode()


def test_per_codec_counters_on_metrics_surfaces(trained):
    storage, *_ = trained
    handle = deploy_fleet(storage, engine_id="rec", n_shards=2,
                          n_replicas=1, device="cpu")
    try:
        for q in QUERIES:
            handle.router.query(dict(q))
        status, text = _text(handle.router_http.port, "/metrics")
        assert status == 200
        assert 'pio_rpc_requests_total{surface="router",codec="binary"}' \
            in text
        assert "pio_http_client_connections_reused_total" in text
        sport = int(handle.endpoints[0][0].rsplit(":", 1)[1])
        status, stext = _text(sport, "/metrics")
        assert status == 200
        assert 'codec="binary"' in stext
        assert "pio_rpc_requests_total" in stext
        _, m = call(sport, "GET", "/metrics.json")
        assert m["rpcCodecCounts"]["binary"] > 0
    finally:
        handle.close()


def test_keepalive_chaos_drill_failover_evict_redial(trained):
    storage, *_ = trained
    handle = deploy_fleet(
        storage, engine_id="rec", n_shards=2, n_replicas=2, device="cpu",
        router_config=RouterConfig(breaker_min_calls=2,
                                   breaker_open_s=0.5,
                                   probe_interval_s=0.2))
    port = handle.router_http.port
    statuses: list[int] = []
    lock = threading.Lock()
    stop = threading.Event()

    def hammer(w):
        while not stop.is_set():
            s, _ = call(port, "POST", "/queries.json",
                        body={"user": f"u{w}", "num": 3})
            with lock:
                statuses.append(s)

    threads = [threading.Thread(target=hammer, args=(w,))
               for w in range(3)]
    pool0 = default_pool().stats()
    try:
        for t in threads:
            t.start()
        time.sleep(0.4)
        handle.shards[0][0].stop()
        time.sleep(1.0)
        old_port = int(handle.endpoints[0][0].rsplit(":", 1)[1])
        http2, _srv2 = create_shard_server(storage, ShardConfig(
            ip="127.0.0.1", port=old_port, shard_index=0, n_shards=2,
            engine_id="rec", device="cpu"))
        http2.start()
        try:
            time.sleep(1.0)
            stop.set()
            for t in threads:
                t.join(timeout=30)
            assert not any(t.is_alive() for t in threads)
            assert statuses and all(s < 500 for s in statuses), \
                [s for s in statuses if s >= 500][:5]
            pool1 = default_pool().stats()
            evicted0 = pool0["evictedError"] + pool0["staleRetries"]
            evicted1 = pool1["evictedError"] + pool1["staleRetries"]
            assert evicted1 > evicted0
            assert pool1["reused"] > pool0["reused"]
            s, body = call(port, "POST", "/queries.json",
                           body={"user": "u2", "num": 3})
            assert s == 200 and body["itemScores"]
        finally:
            http2.stop()
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=5)
        handle.close()
