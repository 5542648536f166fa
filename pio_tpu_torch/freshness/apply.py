"""Appliers: land refreshed user rows in the serving layer.

Three shapes, one contract — ``apply(rows, staleness_s) -> dict`` where
``rows`` maps user id → (k,) float sequence, raising
``FoldInApplyError`` when NOTHING durable was applied (the folder then
keeps the users pending and the cursor does not advance):

  * ``LocalServingApplier``  — in-process QueryServer (tests, bench,
    and ``pio deploy`` + folder in one process);
  * ``ServingHttpApplier``   — ``POST /model/upsert_users`` on a
    single-host deploy server (server-key guarded);
  * ``RouterFleetApplier``   — ``POST /fleet/upsert_users`` on the
    fleet router, which crc32c-routes each row to EVERY replica of its
    owning shard group (the same plan queries route by, so a fold-in
    lands exactly where /shard/user_row will look for it). During a
    live reshard the router ALSO dual-writes rows of moving partitions
    to their NEW owner group (docs/serving.md "Elastic resharding"), so
    freshness never regresses across the cutover; dual-write delivery is
    best-effort and reported under ``reshardDualFailures`` without ever
    flipping ``ok`` — the primary (old-plan) owner remains the applier's
    durability contract until the plan swap.

Apply is idempotent (a row upsert with the same bytes is a no-op in
effect), so the folder may replay after a crash or partial failure
without corrupting serving state.

All three appliers also take ``items`` (item id → row): EXISTING items'
factor rows are upserted together with the two-stage retrieval sidecar
(quantized table + cluster assignment, ops/retrieval.py) in the same
atomic swap, so refreshed items are retrievable through the candidate
tier the moment apply returns. Unknown item ids are rejected, never
appended — a new item needs the dense index space only a retrain
assigns.
"""

from __future__ import annotations

from typing import Mapping, Sequence


class FoldInApplyError(ConnectionError):
    """No serving target accepted the fold-in batch. ConnectionError
    subclass so resilience classification (``is_transient``) retries it
    — a down serving layer is an outage to ride out, not a bug."""


class LocalServingApplier:
    """Apply straight into an in-process QueryServer."""

    def __init__(self, query_server):
        self.query_server = query_server

    def apply(self, rows: Mapping[object, Sequence[float]],
              staleness_s: float | None = None,
              items: Mapping[object, Sequence[float]] | None = None,
              ) -> dict:
        return self.query_server.foldin_upsert(rows, staleness_s,
                                               items=items)


class ServingHttpApplier:
    """Apply to a single-host deploy server over its REST surface."""

    def __init__(self, url: str, server_key: str = "",
                 timeout: float = 10.0):
        from pio_tpu_torch.utils.httpclient import JsonHttpClient

        self.client = JsonHttpClient(url, timeout=timeout)
        self.server_key = server_key

    def apply(self, rows: Mapping[object, Sequence[float]],
              staleness_s: float | None = None,
              items: Mapping[object, Sequence[float]] | None = None,
              ) -> dict:
        from pio_tpu_torch.utils.httpclient import HttpClientError

        body = {"users": {u: [float(x) for x in r]
                          for u, r in rows.items()}}
        if items:
            body["items"] = {i: [float(x) for x in r]
                             for i, r in items.items()}
        if staleness_s is not None:
            body["stalenessSeconds"] = staleness_s
        params = ({"accessKey": self.server_key}
                  if self.server_key else None)
        try:
            return self.client.request("POST", "/model/upsert_users",
                                       body, params=params)
        except HttpClientError as e:
            raise FoldInApplyError(
                f"serving upsert failed: {e.message}") from e


class RouterFleetApplier:
    """Apply through the fleet router (one address; the router fans each
    row to every replica of its crc32c owner shard group)."""

    def __init__(self, url: str, server_key: str = "",
                 timeout: float = 10.0):
        from pio_tpu_torch.utils.httpclient import JsonHttpClient

        self.client = JsonHttpClient(url, timeout=timeout)
        self.server_key = server_key

    def apply(self, rows: Mapping[object, Sequence[float]],
              staleness_s: float | None = None,
              items: Mapping[object, Sequence[float]] | None = None,
              ) -> dict:
        from pio_tpu_torch.utils.httpclient import HttpClientError

        body = {"users": {u: [float(x) for x in r]
                          for u, r in rows.items()}}
        if items:
            body["items"] = {i: [float(x) for x in r]
                             for i, r in items.items()}
        if staleness_s is not None:
            body["stalenessSeconds"] = staleness_s
        params = ({"accessKey": self.server_key}
                  if self.server_key else None)
        try:
            out = self.client.request("POST", "/fleet/upsert_users",
                                      body, params=params)
        except HttpClientError as e:
            raise FoldInApplyError(
                f"fleet upsert failed: {e.message}") from e
        if not out.get("ok", False):
            # a whole owner group rejected/unreachable: those users'
            # rows are NOT servable — keep them pending and retry
            raise FoldInApplyError(
                f"fleet upsert incomplete: {out.get('failedGroups')}")
        return out
