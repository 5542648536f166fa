"""Appliers: land refreshed user rows in the serving layer.

Two shapes, one contract — ``apply(rows, staleness_s) -> dict`` where
``rows`` maps user id → (k,) float sequence, raising
``FoldInApplyError`` when NOTHING durable was applied (the folder then
keeps the users pending and the cursor does not advance):

  * ``LocalServingApplier``  — in-process QueryServer (tests, and a
    deploy + folder in one process);
  * ``ServingHttpApplier``   — ``POST /model/upsert_users`` on a
    single-host deploy server (server-key guarded).

The reference's third, ``RouterFleetApplier`` (``POST
/fleet/upsert_users`` on the fleet router), waits for the port's fleet.

Apply is idempotent (a row upsert with the same bytes is a no-op in
effect), so the folder may replay after a crash or partial failure
without corrupting serving state.

Both appliers also take ``items`` (item id → row): EXISTING items'
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
