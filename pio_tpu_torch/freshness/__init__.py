"""Streaming ALS fold-in: event → recommendation in seconds.

The train→deploy loop is batch-only — a new user's events do nothing
until the next ``pio train``. This subsystem closes that gap with the
MLlib-ALS division of labor (Meng et al., 1505.06807; the reference's
DASE serving split): heavy factorization stays offline, and a cheap
per-user ridge solve against the FIXED item factors runs online:

  tail   (tail.py)    — follow the event stream over the columnar batch
                        path (``find_columnar`` locally, the event
                        server's ``GET /tail/events.json`` remotely) and
                        detect users with new interactions;
  cursor (cursor.py)  — a durable resume point (utils/durable.py
                        framing + atomic write) so a restarted folder
                        continues where it stopped, with no replay loss;
  solve  (solver.py)  — batched fold-in of pending users' FULL event
                        histories through the exact per-row
                        normal equations training uses (ops/als.py
                        ``als_fold_in`` → ``_normal_equations``), on the
                        worker's device, bit for bit the same row in any
                        batch;
  apply  (apply.py)   — hot-swap the refreshed user rows into serving:
                        the single-host QueryServer (in-process or
                        ``POST /model/upsert_users``);
  folder (folder.py)  — the worker loop wiring it together, with
                        ``foldin.solve`` / ``foldin.apply`` chaos
                        points, an apply circuit breaker, a per-cycle
                        deadline, and ``staleness_seconds`` + queue
                        depth exported on its ``/healthz``/``/readyz``.

Failure contract: a wedged folder degrades serving to batch-stale —
queries keep answering from the last trained model — and NEVER takes
serving down; the fold-in cursor only advances after a successful
apply, so a crash anywhere in the cycle replays (idempotently — a fold
is a pure function of the user's full history and the item factors)
rather than loses. docs/freshness.md has the architecture, the
staleness contract, and the runbook.

Counterpart of ``pio_tpu.freshness``. Not ported yet:
``RouterFleetApplier`` (the fleet router) and the folder's ``async``
health transport.
"""

from pio_tpu_torch.freshness.apply import (
    FoldInApplyError,
    LocalServingApplier,
    ServingHttpApplier,
)
from pio_tpu_torch.freshness.cursor import CursorStore, FoldCursor
from pio_tpu_torch.freshness.folder import (
    FoldInConfig,
    FoldInWorker,
    build_foldin_app,
    create_foldin_server,
)
from pio_tpu_torch.freshness.solver import FoldInSolver, user_pairs
from pio_tpu_torch.freshness.tail import (
    HttpEventSource,
    LocalEventSource,
    TailWindow,
    tail_window,
)

__all__ = [
    "CursorStore",
    "FoldCursor",
    "FoldInApplyError",
    "FoldInConfig",
    "FoldInSolver",
    "FoldInWorker",
    "HttpEventSource",
    "LocalEventSource",
    "LocalServingApplier",
    "ServingHttpApplier",
    "TailWindow",
    "build_foldin_app",
    "create_foldin_server",
    "tail_window",
    "user_pairs",
]
