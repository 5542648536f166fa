"""Liveness/readiness endpoints shared by every server surface.

Kubernetes-shaped contract (docs/resilience.md):

  * ``GET /healthz`` — liveness. 200 the moment the process can answer
    HTTP at all; never consults storage or breakers. A failing healthz
    means "restart me", so it must not flap with a dependency.
  * ``GET /readyz``  — readiness. 200 only when every registered check
    passes (model loaded, breakers closed, queues under watermark …);
    503 with the full per-check detail otherwise. A failing readyz
    means "stop routing to me", which is exactly what a degraded-but-
    alive server wants during a storage outage.

Both endpoints are exempt from load shedding in the async transport —
probes must keep answering precisely when the server is saturated.

``install_health_routes(app, readiness=...)`` wires both onto an
HttpApp; `readiness` returns ``{check_name: {"ok": bool, ...detail}}``
and is evaluated per request (closures over live server objects).
"""

from __future__ import annotations

from typing import Callable

# HEALTH_PATHS lives in server/http.py (the transport special-cases the
# probe paths); re-exported here for callers thinking in health terms
from pio_tpu_torch.server.http import HEALTH_PATHS, HttpApp, Request  # noqa: F401

Readiness = Callable[[], dict]


def install_health_routes(app: HttpApp,
                          readiness: Readiness | None = None) -> None:
    @app.route("GET", r"/healthz")
    def healthz(req: Request):
        return 200, {"status": "alive"}

    @app.route("GET", r"/readyz")
    def readyz(req: Request):
        try:
            checks = readiness() if readiness is not None else {}
        except Exception as e:  # noqa: BLE001 - a broken probe is NOT ready
            return 503, {"ready": False,
                         "checks": {"probe": {"ok": False, "error": str(e)}}}
        ready = all(c.get("ok", False) for c in checks.values())
        return (200 if ready else 503), {"ready": ready, "checks": checks}


def breaker_checks(storage) -> dict:
    """One readiness check per storage-source circuit breaker: ready
    while the breaker is closed or probing (half-open means the backend
    is being re-tried — routing can resume), not-ready while open."""
    checks = {}
    # dict(...) snapshots atomically (C-level copy under the GIL):
    # breaker_for() may be inserting a first-use breaker concurrently,
    # and iterating the live dict would raise "changed size during
    # iteration" — turning a healthy /readyz into a spurious 503
    for name, breaker in sorted(dict(getattr(storage, "breakers", {})).items()):
        snap = breaker.snapshot()
        checks[f"breaker:{name}"] = {
            "ok": snap.state != "open",
            "state": snap.state,
            "failureRate": round(snap.failure_rate, 3),
            "windowCalls": snap.calls,
            "opened": snap.opened_count,
        }
    return checks


def shedder_check(transport) -> dict:
    """Readiness check for the async transport's load shedder (absent on
    the threaded transport -> no check)."""
    shedder = getattr(transport, "shedder", None)
    if shedder is None:
        return {}
    snap = shedder.snapshot()
    return {"queue": {
        "ok": snap["depth"] < snap["watermark"],
        "depth": snap["depth"], "watermark": snap["watermark"],
        "shed": snap["shed"],
    }}
