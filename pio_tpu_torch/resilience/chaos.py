"""Deterministic fault injection (chaos) harness.

Instrumented I/O boundaries call ``maybe_inject("storage.MEM.insert")``
(and similar points: ``http.request``, ``serve.reload``, and the
training-lifecycle family ``train.step.<n>`` / ``train.checkpoint`` /
``train.persist`` — see docs/training-fault-tolerance.md); when a chaos
monkey is active and a spec matches the point, the call fails with a
connection-reset-flavored error, stalls for a configured latency, or
passes through — decided by a SEEDED RNG so a failing run replays
exactly. Inactive (the default), the hook is one module-global read.

Activation, in priority order:

  * context manager (tests):
        with chaos.inject("storage", error=0.3, seed=7):
            ...
  * env (whole process, e.g. the CI chaos job):
        PIO_TPU_CHAOS="storage:error=0.3,seed=42;http:slow=0.1,slow_s=0.05"

Spec grammar: ``target:knob=value,knob=value`` joined by ``;`` where
target is a point PREFIX (``storage`` matches ``storage.MEM.insert``;
``*`` matches everything) and knobs are

    error   probability of raising ChaosError            (default 0)
    reset   probability of raising ChaosReset            (default 0)
    slow    probability of sleeping slow_s before the op (default 0)
    slow_s  stall duration in seconds                    (default 0.05)
    seed    RNG seed (per-activation, shared by all specs; default 0)

Both error flavors subclass ConnectionError, so every resilience policy
(retry, breaker, spill, degraded serve) classifies them as transient —
which is the point: the chaos tests prove those policies actually fire.
"""

from __future__ import annotations

import os
import random
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

__all__ = [
    "ChaosError", "ChaosMonkey", "ChaosReset", "ChaosSpec", "active",
    "inject", "install", "maybe_inject", "uninstall", "watches",
]

ENV_VAR = "PIO_TPU_CHAOS"


class ChaosError(ConnectionError):
    """Injected storage/transport failure. Carries the injection
    ``point`` so failed trace spans can be labeled ``chaos=<point>``
    (pio_tpu/obs/recorder.py chaos_point_of walks the cause chain)."""

    def __init__(self, message: str, point: str | None = None):
        super().__init__(message)
        self.point = point


class ChaosReset(ConnectionResetError):
    """Injected connection reset (ConnectionResetError -> ConnectionError
    subclass, like a peer RST mid-call). Carries ``point`` like
    ChaosError."""

    def __init__(self, message: str, point: str | None = None):
        super().__init__(message)
        self.point = point


@dataclass(frozen=True)
class ChaosSpec:
    target: str = "*"       # point prefix ("*" = every point)
    error: float = 0.0
    reset: float = 0.0
    slow: float = 0.0
    slow_s: float = 0.05

    def matches(self, point: str) -> bool:
        return self.target == "*" or point.startswith(self.target)


def parse_specs(text: str) -> tuple[list[ChaosSpec], int]:
    """Parse the ENV_VAR grammar -> (specs, seed). Raises ValueError on
    malformed input — a typo'd chaos spec silently doing nothing would
    defeat the whole experiment."""
    specs: list[ChaosSpec] = []
    seed = 0
    for part in text.split(";"):
        part = part.strip()
        if not part:
            continue
        target, sep, knobs = part.partition(":")
        if not sep:
            raise ValueError(
                f"chaos spec {part!r} missing ':' (want target:knob=value)"
            )
        kw: dict[str, float] = {}
        for item in knobs.split(","):
            item = item.strip()
            if not item:
                continue
            k, sep, v = item.partition("=")
            if not sep:
                raise ValueError(f"chaos knob {item!r} missing '='")
            k = k.strip()
            if k == "seed":
                seed = int(v)
                continue
            if k not in ("error", "reset", "slow", "slow_s"):
                raise ValueError(f"unknown chaos knob {k!r}")
            kw[k] = float(v)
        specs.append(ChaosSpec(target=target.strip() or "*", **kw))
    return specs, seed


class ChaosMonkey:
    """Seeded injector over a list of specs. Thread-safe: the RNG is
    consulted under a lock, so a fixed seed yields a reproducible
    injection SEQUENCE (per-point interleaving across threads is the
    only nondeterminism, and single-threaded tests have none)."""

    def __init__(self, specs: list[ChaosSpec], seed: int = 0,
                 sleep=time.sleep):
        self.specs = list(specs)
        self.seed = seed
        self._rng = random.Random(seed)
        self._sleep = sleep
        self._lock = threading.Lock()
        # point -> {"error": n, "reset": n, "slow": n} (observability:
        # tests and `pio doctor` can see what actually fired)
        self.injected: dict[str, dict[str, int]] = {}

    def _count(self, point: str, kind: str) -> None:
        # pio: lint-ok[attr-no-lock] only called from maybe() under
        # self._lock (the same lock that serializes the RNG)
        self.injected.setdefault(
            point, {"error": 0, "reset": 0, "slow": 0})[kind] += 1

    def maybe(self, point: str) -> None:
        stall = 0.0
        with self._lock:
            for spec in self.specs:
                if not spec.matches(point):
                    continue
                roll = self._rng.random()
                if roll < spec.error:
                    self._count(point, "error")
                    raise ChaosError(
                        f"chaos: injected failure at {point}", point)
                if roll < spec.error + spec.reset:
                    self._count(point, "reset")
                    raise ChaosReset(
                        f"chaos: connection reset at {point}", point)
                if roll < spec.error + spec.reset + spec.slow:
                    self._count(point, "slow")
                    stall = max(stall, spec.slow_s)
        if stall > 0:
            self._sleep(stall)  # outside the lock: stalls must not serialize


# -- activation --------------------------------------------------------------

# module-global active monkey; None = chaos off, _UNSET = env not yet read
_UNSET = object()
_active: object = _UNSET
_lock = threading.Lock()


def _from_env() -> ChaosMonkey | None:
    text = os.environ.get(ENV_VAR, "").strip()
    if not text:
        return None
    specs, seed = parse_specs(text)
    return ChaosMonkey(specs, seed)


def active() -> ChaosMonkey | None:
    """The currently-active monkey (env-configured on first call)."""
    global _active
    got = _active
    if got is _UNSET:
        with _lock:
            if _active is _UNSET:
                _active = _from_env()
            got = _active
    return got  # type: ignore[return-value]


def install(monkey: ChaosMonkey | None) -> None:
    """Install (or, with None, clear) the process-wide monkey."""
    global _active
    with _lock:
        _active = monkey


def uninstall() -> None:
    install(None)


@contextmanager
def inject(target: str = "*", *, error: float = 0.0, reset: float = 0.0,
           slow: float = 0.0, slow_s: float = 0.05, seed: int = 0,
           sleep=time.sleep):
    """Activate one chaos spec for the dynamic extent of the block and
    restore whatever was active before (including env-configured chaos).
    Yields the ChaosMonkey so tests can assert on `.injected`."""
    global _active
    monkey = ChaosMonkey(
        [ChaosSpec(target=target, error=error, reset=reset, slow=slow,
                   slow_s=slow_s)],
        seed, sleep=sleep,
    )
    with _lock:
        prior = _active
        _active = monkey
    try:
        yield monkey
    finally:
        with _lock:
            _active = prior


def maybe_inject(point: str) -> None:
    """The instrumentation hook: no-op unless a monkey is active AND a
    spec matches `point`. Call it at the top of every guarded I/O
    operation."""
    monkey = active()
    if monkey is not None:
        monkey.maybe(point)


def watches(point: str) -> bool:
    """True when an active spec could fire at `point` or any point under
    it — i.e. the spec's target prefix-overlaps `point` in either
    direction (a spec targeting ``train.step.42`` watches the
    ``train.step`` family; so does a spec targeting ``train``). The
    trainers use this to degrade their multi-step device spans to
    per-step spans so a ``train.step.<n>`` fault lands at EXACTLY step n
    — deterministic kill-at-step for the resume tests."""
    monkey = active()
    if monkey is None:
        return False
    return any(
        spec.target == "*"
        or spec.target.startswith(point)
        or point.startswith(spec.target)
        for spec in monkey.specs
    )
