"""The port's event server against the reference's, request for request.

Each package's event server runs on its own memory store, set up the same
way (two apps, a whitelisted key, a channel, an input-blocker plugin),
and one scripted list of requests goes to each over a real socket, on
the threaded and on the async transport. Statuses, bodies and the
headers a client acts on (Retry-After, Content-Type) must be equal;
minted event ids, creation times and the hour a stats window started are
the only fields set aside (tolerance: exact equality of everything
else). Request lists that depend on a spill drain thread stop the drain
while the script runs, so every status is determined by the requests.
"""

from __future__ import annotations

import _torch_cpu  # noqa: F401  (one CPU thread: see the module)

import base64
import http.client
import json
import threading
import time
import urllib.parse
from types import SimpleNamespace

import pytest

import pio_tpu.data.columnar as ref_columnar
import pio_tpu.data.dao as ref_dao
import pio_tpu.data.storage as ref_storage
import pio_tpu.resilience.chaos as ref_chaos
import pio_tpu.server.eventserver as ref_es
import pio_tpu.server.plugins as ref_plugins
import pio_tpu_torch.data.columnar as port_columnar
import pio_tpu_torch.data.dao as port_dao
import pio_tpu_torch.data.storage as port_storage
import pio_tpu_torch.resilience.chaos as port_chaos
import pio_tpu_torch.server.eventserver as port_es
import pio_tpu_torch.server.plugins as port_plugins

PKGS = {
    "ref": SimpleNamespace(columnar=ref_columnar, dao=ref_dao,
                           storage=ref_storage, chaos=ref_chaos, es=ref_es,
                           plugins=ref_plugins),
    "port": SimpleNamespace(columnar=port_columnar, dao=port_dao,
                            storage=port_storage, chaos=port_chaos,
                            es=port_es, plugins=port_plugins),
}
MEM_ENV = {
    "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
    "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
    "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
    "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM",
}
T0 = "2026-01-01T00:00:00.000Z"


def rate(i: int, event: str = "rate", **extra) -> dict:
    return {"event": event, "entityType": "user", "entityId": f"u{i % 7}",
            "targetEntityType": "item", "targetEntityId": f"i{i % 5}",
            "properties": {"rating": i % 5 + 1},
            "eventTime": f"2026-01-01T00:{i // 60 % 60:02d}:{i % 60:02d}"
                         ".000Z", "eventId": f"ev{i:05d}", **extra}


class Client:
    """One package's server: its store, app, and raw HTTP calls."""

    def __init__(self, pkg: SimpleNamespace, backend: str, **cfg):
        self.pkg = pkg
        d = pkg.dao
        self.storage = pkg.storage.Storage(env=MEM_ENV, test=True)
        apps = self.storage.get_metadata_apps()
        keys = self.storage.get_metadata_access_keys()
        ev = self.storage.get_events()
        self.app_id = apps.insert(d.App(0, "testapp"))
        keys.insert(d.AccessKey("KEY", self.app_id, ()))
        keys.insert(d.AccessKey("RATEONLY", self.app_id, ("rate",)))
        cid = self.storage.get_metadata_channels().insert(
            d.Channel(0, "mobile", self.app_id))
        ev.init(self.app_id)
        ev.init(self.app_id, cid)
        other = apps.insert(d.App(0, "other"))
        keys.insert(d.AccessKey("OTHER", other, ()))
        ev.init(other)

        class Blocker(pkg.plugins.EventServerPlugin):
            plugin_name = "blocker"
            plugin_type = pkg.plugins.EventServerPlugin.INPUT_BLOCKER

            def process(self, event_dict, context):
                if event_dict.get("event") == "blocked":
                    raise pkg.plugins.PluginRejection("blocked by plugin")

        self.srv = pkg.es.create_event_server(
            self.storage,
            pkg.es.EventServerConfig(ip="127.0.0.1", port=0, backend=backend,
                                     **cfg),
            pkg.plugins.PluginContext([Blocker()])).start()

    def close(self):
        self.srv.stop()
        if self.srv.app.spill is not None:
            self.srv.app.spill.close()

    def call(self, method: str, path: str, body=None, raw: bytes = None,
             ctype: str = None, form: dict = None, headers: dict = None,
             **params):
        qs = urllib.parse.urlencode(params)
        url = path + (f"?{qs}" if qs else "")
        hdrs = dict(headers or {})
        if form is not None:
            raw = urllib.parse.urlencode(form).encode()
            hdrs["Content-Type"] = "application/x-www-form-urlencoded"
        elif body is not None:
            raw = json.dumps(body).encode()
            hdrs["Content-Type"] = "application/json"
        elif ctype is not None:
            hdrs["Content-Type"] = ctype
        conn = http.client.HTTPConnection("127.0.0.1", self.srv.port,
                                          timeout=30)
        try:
            conn.request(method, url, body=raw, headers=hdrs)
            resp = conn.getresponse()
            data = resp.read()
            got = {"status": resp.status,
                   "type": resp.getheader("Content-Type"),
                   "retryAfter": resp.getheader("Retry-After")}
        finally:
            conn.close()
        if got["type"] and got["type"].startswith("application/json"):
            got["body"] = json.loads(data) if data else None
        else:
            got["body"] = data
        return got

    def binary(self, events, **params):
        return self.call("POST", "/batch/events.json",
                         raw=self.pkg.columnar.encode_api_batch(events),
                         ctype=self.pkg.columnar.COLUMNAR_CONTENT_TYPE,
                         **params)

    def stored(self):
        evs = self.storage.get_events().find(self.app_id, limit=-1)
        return sorted((norm(e.to_api_dict()) for e in evs),
                      key=lambda x: json.dumps(x, sort_keys=True))

    def store_back(self):
        """The outage is over: close the storage breakers the chaos
        faults opened, so the next write is not refused for open_s."""
        for breaker in self.storage.breakers.values():
            breaker.reset()

    def drain_spill(self):
        """Start the spill drain (held back while the script ran) and
        wait until the queue is empty."""
        self.store_back()
        spill = self.srv.app.spill
        spill._thread = threading.Thread(target=spill._drain_loop,
                                         daemon=True)
        spill._thread.start()
        deadline = time.monotonic() + 15
        while spill.size and time.monotonic() < deadline:
            spill._wake.set()
            time.sleep(0.01)
        assert spill.size == 0


def hold_spill_drain(c: Client):
    """Keep the drain thread from starting: offers only queue."""
    c.srv.app.spill._thread = threading.Thread()


def norm(x):
    """Minted ids (not the scripted ``ev…`` ones), creation times and the
    stats window's start are set aside; everything else stays."""
    if isinstance(x, dict):
        out = {}
        for k, v in x.items():
            if k == "eventId" and not str(v).startswith("ev"):
                v = "<minted>"
            elif k in ("creationTime", "hourStart"):
                v = "<time>"
            out[k] = norm(v)
        return out
    if isinstance(x, list):
        return [norm(v) for v in x]
    return x


def metric_lines(text: bytes, *families: str) -> list[str]:
    return sorted(ln for ln in text.decode().splitlines()
                  if ln.split("{")[0].split(" ")[0] in families
                  or any(ln.startswith(f"# TYPE {f} ") for f in families))


# -- the scripts: each takes one package's client, returns what it saw --------

def script_rest(c: Client) -> list:
    basic = base64.b64encode(b"KEY:").decode()
    out = [c.call("GET", "/"),
           c.call("POST", "/events.json", body=rate(1)),
           c.call("POST", "/events.json", body=rate(1), accessKey="BAD"),
           c.call("POST", "/events.json", body=rate(1),
                  headers={"Authorization": f"Basic {basic}"}),
           c.call("POST", "/events.json", body=rate(2), accessKey="KEY",
                  channel="nope"),
           c.call("POST", "/events.json", body=rate(3), accessKey="KEY",
                  channel="mobile"),
           c.call("POST", "/events.json", body=rate(4, "view"),
                  accessKey="RATEONLY"),
           c.call("POST", "/events.json", body=rate(5), accessKey="RATEONLY"),
           c.call("POST", "/events.json", body=rate(6, ""), accessKey="KEY"),
           c.call("POST", "/events.json", body=[rate(7)], accessKey="KEY"),
           c.call("POST", "/events.json", raw=b"{not json",
                  ctype="application/json", accessKey="KEY"),
           c.call("POST", "/events.json", body=rate(8, "blocked"),
                  accessKey="KEY"),
           c.call("POST", "/events.json", body={
               "event": "$set", "entityType": "user", "entityId": "u9",
               "properties": {"plan": "pro"}, "eventTime": T0},
               accessKey="KEY"),
           c.call("GET", "/events/ev00001.json", accessKey="KEY"),
           c.call("GET", "/events/ev00003.json", accessKey="KEY"),
           c.call("GET", "/events/ev00003.json", accessKey="KEY",
                  channel="mobile"),
           c.call("DELETE", "/events/ev00005.json", accessKey="KEY"),
           c.call("DELETE", "/events/ev00005.json", accessKey="KEY")]
    for params in ({"limit": "-1"}, {"entityType": "user", "limit": "2"},
                   {"entityId": "u1", "reversed": "true"},
                   {"event": "nothing"}, {"targetEntityType": ""},
                   {"startTime": "not-a-time"},
                   {"startTime": T0, "untilTime": "2026-01-02T00:00:00Z"},
                   {"channel": "mobile"}):
        out.append(c.call("GET", "/events.json", accessKey="KEY", **params))
    out += [c.call("GET", "/stats.json", accessKey="KEY"),
            c.call("GET", "/nope"), c.call("PUT", "/"),
            c.call("GET", "/healthz"), c.call("GET", "/readyz")]
    return [norm(r) for r in out] + [c.stored()]


def script_batch(c: Client) -> list:
    mixed = [rate(10), rate(11, ""), rate(12, "blocked"), {"event": 1},
             rate(13, tags=["a"]), rate(14, "$unset", properties={})]
    fifty_one = [rate(100 + j) for j in range(51)]
    out = [c.call("POST", "/batch/events.json", body=mixed, accessKey="KEY"),
           c.call("POST", "/batch/events.json", body=[rate(20), rate(21,
                  "view")], accessKey="RATEONLY"),
           c.call("POST", "/batch/events.json", body=fifty_one,
                  accessKey="KEY"),
           c.call("POST", "/batch/events.json", body={"a": 1},
                  accessKey="KEY"),
           c.binary([dict(e, eventId=f"ev9{j}") if isinstance(e, dict)
                     and "eventId" in e else e
                     for j, e in enumerate(mixed)], accessKey="KEY"),
           c.binary([rate(30), rate(31, "view")], accessKey="RATEONLY"),
           c.binary(fifty_one, accessKey="KEY"),
           c.binary([rate(200 + j) for j in range(10_001)],
                    accessKey="KEY")]
    frame = bytearray(c.pkg.columnar.encode_api_batch([rate(40), rate(41)]))
    frame[len(frame) // 2] ^= 0x10
    out.append(c.call("POST", "/batch/events.json", raw=bytes(frame),
                      ctype=c.pkg.columnar.COLUMNAR_CONTENT_TYPE,
                      accessKey="KEY"))
    cols = c.storage.get_events().find_columnar(c.app_id)
    out.append(c.call("POST", "/batch/events.json",
                      raw=c.pkg.columnar.encode_columnar_events(cols),
                      ctype=c.pkg.columnar.COLUMNAR_CONTENT_TYPE,
                      accessKey="KEY"))
    return [norm(r) for r in out] + [c.stored()]


def script_tail(c: Client) -> list:
    c.binary([rate(j, "buy" if j % 3 == 0 else "rate") for j in range(40)]
             + [rate(50, "view")], accessKey="KEY")
    q = dict(accessKey="KEY", events="rate,buy", entityType="user",
             targetEntityType="item")
    out = [c.call("GET", "/tail/events.json", sinceUs="-1", **q),
           c.call("GET", "/tail/events.json", sinceUs="-1", limit="5", **q),
           c.call("GET", "/tail/events.json",
                  sinceUs=str(1767225600_000000 + 20_000_000), **q)]
    binary = c.call("GET", "/tail/events.json", sinceUs="-1",
                    headers={"Accept": c.pkg.columnar.COLUMNAR_CONTENT_TYPE},
                    **q)
    cols = ref_columnar.decode_columnar_events(binary["body"])
    out.append({**binary, "rows": [
        (cols.entity_ids[e], cols.target_ids[t], cols.event_names[v], int(u))
        for e, t, v, u in zip(cols.entity_code, cols.target_code,
                              cols.event_code, cols.time_us)]})
    last = out[0]["body"]["nextUs"]
    # an idle long-poll answers the empty window when its wait elapses
    out.append(c.call("GET", "/tail/events.json", sinceUs=str(last),
                      waitS="0.2", **q))
    # one woken by an ingest answers the new row
    timer = threading.Timer(0.3, c.call, ("POST", "/events.json"),
                            {"body": rate(99, eventTime="2026-01-02T00:00"
                                          ":00.000Z"), "accessKey": "KEY"})
    timer.start()
    woke = c.call("GET", "/tail/events.json", sinceUs=str(last), waitS="10",
                  **q)
    timer.join()
    out.append(woke)
    return [norm(r) for r in out]


def script_webhooks(c: Client) -> list:
    segment = {"version": "2", "type": "track", "userId": "u42",
               "event": "signup", "properties": {"plan": "pro"},
               "timestamp": "2026-01-02T03:04:05.000Z"}
    form = {"type": "subscribe", "fired_at": "2026-01-02 21:31:18",
            "data[id]": "8a25ff1d98", "data[list_id]": "a6b5da1054",
            "data[email]": "api@mailchimp.com",
            "data[merges][FNAME]": "MailChimp",
            "data[merges][LNAME]": "API"}
    out = [c.call("POST", "/webhooks/segmentio.json", body=segment,
                  accessKey="KEY"),
           c.call("GET", "/webhooks/segmentio.json", accessKey="KEY"),
           c.call("POST", "/webhooks/segmentio.json", body={"type": "track"},
                  accessKey="KEY"),
           c.call("POST", "/webhooks/segmentio.json", body=[1],
                  accessKey="KEY"),
           c.call("POST", "/webhooks/nope.json", body={}, accessKey="KEY"),
           c.call("GET", "/webhooks/nope.json", accessKey="KEY"),
           c.call("POST", "/webhooks/mailchimp", form=form, accessKey="KEY"),
           c.call("GET", "/webhooks/mailchimp", accessKey="KEY"),
           c.call("POST", "/webhooks/nope", form=form, accessKey="KEY"),
           c.call("POST", "/webhooks/segmentio.json", body=segment)]
    return [norm(r) for r in out] + [c.stored()]


def script_metrics(c: Client) -> list:
    for j in range(3):
        c.call("POST", "/events.json", body=rate(j), accessKey="KEY")
    c.call("POST", "/batch/events.json", body=[rate(10), rate(11)],
           accessKey="KEY")
    c.binary([rate(20), rate(21), rate(22, "")], accessKey="KEY")
    out = [c.call("GET", "/metrics"),
           c.call("GET", "/metrics", accessKey="WRONG"),
           c.call("GET", "/stats.json", accessKey="KEY"),
           c.call("GET", "/stats.json", accessKey="OTHER")]
    text = c.call("GET", "/metrics", accessKey="MK")
    lines = metric_lines(text.pop("body"), *(
        f"pio_ingest_wire_{m}_total" for m in ("events", "bytes",
                                                "batches")),
        "pio_events_ingested_total", "pio_spill_queue_depth")
    return [norm(r) for r in out] + [text, lines]


def script_spill(c: Client) -> list:
    hold_spill_drain(c)
    with c.pkg.chaos.inject("storage.MEM.insert", error=1.0, seed=1):
        out = [c.call("POST", "/events.json", body=rate(1), accessKey="KEY"),
               c.call("POST", "/batch/events.json", body=[rate(2), rate(3),
                      rate(4, "")], accessKey="KEY"),
               c.binary([rate(5), rate(6)], accessKey="KEY"),
               c.call("POST", "/webhooks/segmentio.json", body={
                   "version": "2", "type": "track", "userId": "u1",
                   "messageId": "m", "timestamp": T0}, accessKey="KEY")]
        snap = c.srv.app.spill.snapshot()
    c.drain_spill()
    return [norm(r) for r in out] + [
        {k: snap[k] for k in ("size", "spilled", "capacity")},
        [norm(c.call("GET", f"/events/ev0000{j}.json", accessKey="KEY"))
         for j in (1, 2, 3, 5, 6)]]


def script_backpressure(c: Client) -> list:
    hold_spill_drain(c)
    with c.pkg.chaos.inject("storage.MEM.insert", error=1.0, seed=1):
        out = [c.call("POST", "/events.json", body=rate(j), accessKey="KEY")
               for j in range(7)]
        out.append(c.call("POST", "/batch/events.json",
                          body=[rate(10), rate(11)], accessKey="KEY"))
        ready = c.call("GET", "/readyz")
    # the store is back: writes go straight in, whatever the queue holds
    c.store_back()
    out.append(c.call("POST", "/events.json", body=rate(20), accessKey="KEY"))
    c.drain_spill()
    spill = ready["body"]["checks"]["spill"]
    return [norm(r) for r in out] + [
        ready["status"], {k: v for k, v in spill.items()
                          if k != "oldestAgeSeconds"},
        c.srv.app.spill.snapshot()["saturated"]]


def script_quota(c: Client) -> list:
    out = [c.call("POST", "/events.json", body=rate(j), accessKey="KEY")
           for j in range(3)]
    out += [c.call("POST", "/batch/events.json", body=[rate(5)],
                   accessKey="KEY"),
            c.call("POST", "/events.json", body=rate(6), accessKey="OTHER"),
            c.call("GET", "/events.json", accessKey="KEY", limit="-1")]
    text = c.call("GET", "/metrics", accessKey="MK")["body"]
    return [norm(r) for r in out] + [metric_lines(text, "pio_ingest_shed_total")]


SCRIPTS = {
    "rest": (script_rest, dict(stats=True)),
    "batch": (script_batch, {}),
    "tail": (script_tail, {}),
    "webhooks": (script_webhooks, {}),
    "metrics": (script_metrics, dict(stats=True, metrics_key="MK")),
    "spill": (script_spill, dict(spill_capacity=100)),
    "backpressure": (script_backpressure, dict(
        spill_capacity=100, spill_high_water=4, spill_low_water=2)),
    # 0.001 POSTs/s: the bucket refills one token in 1000 s, so after
    # its burst of 2 every further POST of the app is shed, whatever
    # the wall clock does during the test
    "quota": (script_quota, dict(ingest_quota_qps=0.001,
                                 ingest_quota_burst=2, metrics_key="MK")),
}


@pytest.mark.parametrize("backend", ["threaded", "async"])
@pytest.mark.parametrize("name", list(SCRIPTS))
def test_scripted_requests_equal_the_reference(name, backend):
    script, cfg = SCRIPTS[name]
    seen = {}
    for pkg in ("ref", "port"):
        c = Client(PKGS[pkg], backend, **cfg)
        try:
            seen[pkg] = script(c)
        finally:
            c.close()
    assert seen["port"] == seen["ref"]


def test_metrics_key_unset_answers_404_in_both():
    for pkg in ("ref", "port"):
        c = Client(PKGS[pkg], "async")
        try:
            got = c.call("GET", "/metrics", accessKey="anything")
        finally:
            c.close()
        assert got["status"] == 404, pkg


@pytest.mark.parametrize("backend", ["threaded", "async"])
def test_port_wire_counters_split_a_batch_on_the_server_clock(backend):
    """The port's per-codec counters add the time the store's insert and
    the batch route were busy: with one request at a time each codec's
    route time holds its decode and insert seconds (tolerance: exact
    order of the sums), and /metrics exports both counters."""
    c = Client(PKGS["port"], backend, metrics_key="MK")
    try:
        c.binary([rate(j) for j in range(20)], accessKey="KEY")
        c.call("POST", "/batch/events.json", body=[rate(30), rate(31)],
               accessKey="KEY")
        wire = {k: dict(v) for k, v in c.srv.app.wire_stats.items()}
        text = c.call("GET", "/metrics", accessKey="MK")["body"]
    finally:
        c.close()
    for codec, events in (("binary", 20), ("json", 2)):
        w = wire[codec]
        assert w["events"] == events and w["insert_busy_seconds"] > 0
        assert w["handle_busy_seconds"] >= (w["decode_seconds"]
                                            + w["insert_busy_seconds"])
    families = [f"pio_ingest_wire_{m}_busy_seconds_total"
                for m in ("insert", "handle")]
    lines = [ln for ln in metric_lines(text, *families)
             if not ln.startswith("#")]
    assert len(lines) == 4


def test_port_busy_counters_count_overlapping_batches_once(monkeypatch):
    """Batches that overlap in the store count their shared time once:
    with the store's insert_batch held open until four batches are
    inside, the insert busy time stays under the sum of the four."""
    c = Client(PKGS["port"], "async")
    dao_class = c.storage.get_events().__class__  # the memory events DAO
    plain = dao_class.insert_batch
    inside = threading.Barrier(4)

    def held(self, *a, **k):
        inside.wait(timeout=10)
        time.sleep(0.2)
        return plain(self, *a, **k)

    monkeypatch.setattr(dao_class, "insert_batch", held)
    try:
        threads = [threading.Thread(target=c.binary, args=([rate(j)],),
                                    kwargs={"accessKey": "KEY"})
                   for j in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        w = dict(c.srv.app.wire_stats["binary"])
    finally:
        c.close()
    assert w["events"] == 4
    assert 0.2 <= w["insert_busy_seconds"] < 0.4
