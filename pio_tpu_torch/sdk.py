"""Client SDK — the counterpart of the reference's PredictionIO-python-sdk.

Two clients, mirroring the SDK surface users of the reference already know
(predictionio.EventClient / predictionio.EngineClient):

    from pio_tpu_torch.sdk import EventClient, EngineClient

    events = EventClient(access_key="...", url="http://localhost:7070")
    events.create_event(event="rate", entity_type="user", entity_id="u1",
                        target_entity_type="item", target_entity_id="i9",
                        properties={"rating": 5})
    events.create_events_batch([...])            # <= 50 per request

    engine = EngineClient(url="http://localhost:8000")
    engine.send_query({"user": "u1", "num": 10})
    engine.send_queries_batch([{...}, {...}])    # bulk endpoint

Stdlib-only (urllib), keep-alive not required — for high-volume ingest use
create_events_batch. Errors raise PIOError carrying the server's status
and message.

Wire format: ``create_events_batch`` encodes the binary columnar frame
(``application/x-pio-columnar``, data/columnar.py — the server decodes
it by pointer-cast instead of per-event JSON) by default; pass
``wire="json"`` for pre-binary servers. Responses are identical either
way (per-event statuses, same verdicts/messages).

Backpressure: the event server answers 429 + Retry-After past its spill
high-water mark (whole-request on /events.json, per-slot inside a batch
response). The client absorbs both through its resilience RetryPolicy
(full jitter, deadline-capped, floored at the server's Retry-After
hint) instead of surfacing the 429 to callers; ``EventClient.stats``
counts shed/retried so load generators can report them.
"""

from __future__ import annotations

import time
import urllib.parse
from typing import Any, Sequence

from pio_tpu_torch.data.columnar import COLUMNAR_CONTENT_TYPE, encode_api_batch
from pio_tpu_torch.resilience import Deadline, RetryPolicy
from pio_tpu_torch.utils.httpclient import HttpClientError, JsonHttpClient

BATCH_LIMIT = 50  # server-enforced (reference EventServer.scala:68)
# the binary columnar route's bulk ceiling (eventserver
# MAX_EVENTS_PER_BINARY_BATCH): the JSON limit is reference compat; the
# binary frame is built to amortize per-request cost over big batches
BINARY_BATCH_LIMIT = 10_000

# backpressure default: absorb short spill-queue saturation bursts (the
# server drains to its low-water mark in ~seconds) without hammering it
_DEFAULT_RETRY = RetryPolicy(attempts=4, base_delay_s=0.1, max_delay_s=2.0)


class PIOError(HttpClientError):
    """SDK error: .status (0 = transport failure) + server message."""


def _looks_pre_binary(e: PIOError) -> bool:
    """True when a 400 to a binary-frame POST reads like a pre-binary
    server JSON-parsing the frame bytes (see _post_batch)."""
    if e.status != 400:
        return False
    msg = e.message or ""
    return (msg == "Invalid JSON body"
            or "codec can't decode" in msg
            or msg.startswith("Expecting value")
            or msg.startswith("Extra data"))


class _Http(JsonHttpClient):
    def call(self, method: str, path: str, body: Any = None,
             raw: bytes | None = None, content_type: str | None = None,
             accept: str | None = None, **params) -> Any:
        try:
            return self.request(method, path, body, params, raw=raw,
                                content_type=content_type, accept=accept)
        except HttpClientError as e:
            raise PIOError(e.status, e.message,
                           retry_after=e.retry_after) from e


class EventClient:
    """Event Server client (reference python-sdk EventClient)."""

    def __init__(self, access_key: str, url: str = "http://localhost:7070",
                 channel: str | None = None, timeout: float = 30.0,
                 verify_tls: bool = True, wire: str = "binary",
                 retry: RetryPolicy | None = None):
        if wire not in ("binary", "json"):
            raise ValueError("wire must be 'binary' or 'json'")
        self.access_key = access_key
        self.channel = channel
        self.wire = wire
        self.retry = retry or _DEFAULT_RETRY
        # shed/retry accounting for load generators: `shed` counts 429
        # verdicts received (whole-request or per-slot), `retried` the
        # re-submissions this client performed on the caller's behalf
        self.stats = {"shed": 0, "retried": 0}
        self._sleep = time.sleep  # injectable for tests
        self._http = _Http(url, timeout, verify_tls)

    # -- backpressure ------------------------------------------------------
    def _call_absorbing_429(self, fn):
        """Run fn() under the RetryPolicy, retrying ONLY 429 (the spill
        high-water backpressure signal): backoff is full-jitter from the
        policy, floored at the server's Retry-After hint and capped by
        the ambient Deadline. Other failures surface unchanged."""
        state: dict[str, Any] = {"retry_after": None}

        def retry_if(e: BaseException) -> bool:
            if getattr(e, "status", None) != 429:
                return False
            state["retry_after"] = getattr(e, "retry_after", None)
            self.stats["shed"] += 1
            return True

        def sleep(d: float) -> None:
            hint = state["retry_after"]
            if hint:
                d = max(d, min(float(hint), self.retry.max_delay_s))
            rem = Deadline.remaining()
            if rem is not None:
                d = min(d, max(0.0, rem))
            self.stats["retried"] += 1
            self._sleep(d)

        return self.retry.call(fn, retry_if=retry_if, sleep=sleep)

    # -- write --------------------------------------------------------------
    def create_event(self, event: str, entity_type: str, entity_id: str,
                     target_entity_type: str | None = None,
                     target_entity_id: str | None = None,
                     properties: dict | None = None,
                     event_time: str | None = None) -> str:
        """-> eventId. event_time: ISO-8601 string (server default: now)."""
        body: dict[str, Any] = {
            "event": event, "entityType": entity_type, "entityId": entity_id,
        }
        if target_entity_type:
            body["targetEntityType"] = target_entity_type
        if target_entity_id:
            body["targetEntityId"] = target_entity_id
        if properties:
            body["properties"] = properties
        if event_time:
            body["eventTime"] = event_time
        out = self._call_absorbing_429(lambda: self._http.call(
            "POST", "/events.json", body,
            accessKey=self.access_key, channel=self.channel,
        ))
        return out["eventId"]

    def _post_batch(self, events: Sequence[dict]) -> list[dict]:
        if self.wire == "binary":
            # encode ONCE outside the retry closure: the bytes are
            # identical on every 429 re-attempt
            blob = encode_api_batch(list(events))
            try:
                return self._call_absorbing_429(lambda: self._http.call(
                    "POST", "/batch/events.json",
                    raw=blob,
                    content_type=COLUMNAR_CONTENT_TYPE,
                    accessKey=self.access_key, channel=self.channel,
                ))
            except PIOError as e:
                # a PRE-BINARY server ran req.json() on the frame:
                # depending on where the parse failed, its authed
                # wrapper answers 400 with a UnicodeDecodeError text
                # ("codec can't decode", the usual case — the frame's
                # CRC bytes are rarely valid UTF-8), a JSONDecodeError
                # text ("Expecting value"/"Extra data"), or the
                # dispatch-level "Invalid JSON body". A binary-capable
                # server decodes the frame BEFORE any JSON parse, so its
                # 400s on this route are WireFormatError/limit messages
                # that match none of these. Downgrade to the JSON wire
                # for this client's lifetime, like the read paths
                # degrade on 404/Accept.
                if not _looks_pre_binary(e):
                    raise
                self.wire = "json"
        batch = list(events)
        if len(batch) > BATCH_LIMIT:
            raise PIOError(
                400, f"server only speaks the JSON wire, whose batch "
                f"limit is {BATCH_LIMIT} events per request")
        return self._call_absorbing_429(lambda: self._http.call(
            "POST", "/batch/events.json", batch,
            accessKey=self.access_key, channel=self.channel,
        ))

    def create_events_batch(self, events: Sequence[dict]) -> list[dict]:
        """<= 50 events (server limit); returns per-item statuses.

        Slots the server shed with a per-event 429 (spill backpressure)
        are re-submitted on the RetryPolicy schedule — callers see 429
        only after the policy's attempts are exhausted. Statuses come
        back in input order either way. The binary wire accepts bulk
        frames up to BINARY_BATCH_LIMIT; the JSON wire keeps the
        reference's 50-event contract."""
        events = list(events)
        limit = (BINARY_BATCH_LIMIT if self.wire == "binary"
                 else BATCH_LIMIT)
        if len(events) > limit:
            raise ValueError(
                f"batch limit is {limit} events per request"
            )
        out = self._post_batch(events)
        pending = [i for i, r in enumerate(out)
                   if isinstance(r, dict) and r.get("status") == 429]
        # policy-driven resend of shed slots: .delays() is the schedule
        for d in self.retry.delays() if pending else ():
            self.stats["shed"] += len(pending)
            rem = Deadline.remaining()
            if rem is not None:
                if rem <= 0:
                    break
                d = min(d, rem)
            self._sleep(d)
            self.stats["retried"] += len(pending)
            try:
                resent = self._post_batch([events[i] for i in pending])
            except HttpClientError:
                # a failed RESEND must not discard the receipts already
                # in `out` — the caller keeps the accepted slots' ids
                # (re-posting the whole batch would duplicate them) and
                # sees the still-shed slots as honest per-slot 429s
                break
            for i, r in zip(pending, resent):
                out[i] = r
            pending = [i for i in pending
                       if isinstance(out[i], dict)
                       and out[i].get("status") == 429]
            if not pending:
                break
        return out

    # -- convenience entity ops (reference SDK set_user/set_item/record) ----
    def set_user(self, uid: str, properties: dict | None = None) -> str:
        return self.create_event("$set", "user", uid, properties=properties)

    def set_item(self, iid: str, properties: dict | None = None) -> str:
        return self.create_event("$set", "item", iid, properties=properties)

    def record_user_action_on_item(self, action: str, uid: str, iid: str,
                                   properties: dict | None = None) -> str:
        return self.create_event(
            action, "user", uid, target_entity_type="item",
            target_entity_id=iid, properties=properties,
        )

    # -- read ---------------------------------------------------------------
    def get_event(self, event_id: str) -> dict:
        return self._http.call(
            "GET", f"/events/{urllib.parse.quote(event_id)}.json",
            accessKey=self.access_key, channel=self.channel,
        )

    def find_events(self, **filters) -> list[dict]:
        """filters: startTime/untilTime/entityType/entityId/event/limit/
        reversed — the /events.json query params."""
        return self._http.call(
            "GET", "/events.json",
            accessKey=self.access_key, channel=self.channel, **filters,
        )

    def delete_event(self, event_id: str) -> None:
        self._http.call(
            "DELETE", f"/events/{urllib.parse.quote(event_id)}.json",
            accessKey=self.access_key, channel=self.channel,
        )


class EngineClient:
    """Deploy-server client (reference python-sdk EngineClient)."""

    def __init__(self, url: str = "http://localhost:8000",
                 timeout: float = 30.0, verify_tls: bool = True):
        self._http = _Http(url, timeout, verify_tls)

    def send_query(self, query: dict) -> Any:
        return self._http.call("POST", "/queries.json", query)

    def send_queries_batch(self, queries: Sequence[dict]) -> list:
        """Bulk endpoint: one batch_predict per algorithm server-side."""
        return self._http.call("POST", "/batch/queries.json", list(queries))

    def status(self) -> dict:
        return self._http.call("GET", "/")
