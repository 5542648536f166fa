"""Fleet router: query front-end over the shard servers.

Query path (POST /queries.json):

  1. owner = plan.owner_of(user) — fetch the user's factor row from the
     owning shard group (row-fetch RPC, replica failover);
  2. fan a partial-top-k RPC to EVERY shard group concurrently (each
     scores the row against its item slice with the single-host kernel);
  3. merge by ``(-score, global_index)`` — exactly ``ops/topk.py``'s
     descending-score, lowest-index-first order — then apply black/white
     list semantics IDENTICALLY to ALSAlgorithm.predict, so the fleet's
     answer is bit-identical to the single-host oracle.

Every shard call runs under the resilience stack: a per-replica
``CircuitBreaker`` (an open breaker skips the replica without a network
attempt), single-attempt failover across replicas in preference order
(no backoff — a replica either answers within the RPC timeout or the
next one is tried), the ambient ``Deadline`` checked before every
replica attempt, and a ``chaos.maybe_inject`` point per shard
(``fleet.shard<i>.<op>``) so drills can kill exactly one shard. With a
whole shard group down the router DEGRADES instead of 5xx-ing: partial
results from the live shards are blended with the plan's popularity
fallback list and the response is flagged ``"degraded": true``.

A background prober keeps per-replica /readyz freshness for replica
ordering, ``/fleet.json`` (what ``pio doctor --fleet`` reads), and the
router's own ``/readyz`` (ready while every shard group has a live
replica).

Live elastic resharding (docs/serving.md "Elastic resharding"): while a
``ReshardController`` (serving_fleet/reshard.py) migrates partitions to
a new topology, the router double-routes the affected groups the way a
rollout runs two arms — every scoring RPC pins the topology it was
planned against via the ``X-Pio-Plan-Version`` header (a shard answers
from its active, prepared, or retired arm accordingly), fold-in upserts
are dual-written to BOTH owners of a moving partition, and a user_row
miss on a dead old owner fails over to the new owner's staged copy. The
cutover itself is one plan swap under the router lock
(``apply_reshard_plan``), after which in-flight old-plan fans still
complete against the shards' retired arms — zero 5xx either side of the
flip.
"""

from __future__ import annotations

import logging
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import TimeoutError as FuturesTimeoutError
from dataclasses import dataclass, field

from pio_tpu_torch.resilience import (
    CircuitBreaker, CircuitOpenError, Deadline, DeadlineExceeded,
    is_transient,
)
from pio_tpu_torch.resilience import chaos
from pio_tpu_torch.resilience.health import install_health_routes, shedder_check
from pio_tpu_torch.rollout import ARM_ACTIVE, ARM_CANDIDATE, install_rollout_routes
from pio_tpu_torch.server.http import (
    AsyncHttpServer, HttpApp, HttpServer, Request, json_response,
    server_key_ok,
)
from pio_tpu_torch.serving_fleet.plan import TENANT_HEADER, ShardPlan, partition_of
from pio_tpu_torch.utils.httpclient import HttpClientError, JsonHttpClient
from pio_tpu_torch.utils.time import format_time, utcnow
from pio_tpu_torch.utils.tracing import Tracer
from pio_tpu_torch.workflow.context import resolve_device

log = logging.getLogger("pio_tpu_torch.fleet.router")


class ShardUnavailable(ConnectionError):
    """Every replica of a shard group refused or failed transiently.

    ConnectionError subclass so the ambient resilience classification
    (is_transient) treats it like any other transport outage; the router
    catches it itself and degrades instead of letting it 5xx.
    """

    def __init__(self, shard_index: int, last_error: Exception | None):
        super().__init__(
            f"shard {shard_index} unavailable"
            + (f" (last error: {last_error})" if last_error else "")
        )
        self.shard_index = shard_index


class _BatchUnsupported(Exception):
    """A batched frame can't be used for this dispatch — JSON-wire
    config, a replica not yet confirmed on the binary wire, or a
    replica that 400'd the batched layout (pre-batch shard build).
    Internal to the coalescer, which falls back to per-query solo
    calls; never surfaced to a caller."""


class _ShardCoalescer:
    """Cross-request coalescing for the scoring RPCs: concurrent calls
    to the same ``(shard, op, arm, plan_version)`` within one coalesce
    window merge into ONE batched binary frame — one RPC, one device
    program on the shard — instead of N.

    Leader/follower, no dispatcher thread: the FIRST caller to open a
    key becomes the leader. It is already running in a router worker
    thread (the per-query fan pool or the batch pool), so it simply
    sleeps out the window there, pops whatever accumulated, and
    dispatches; later arrivals append and park on their futures. A
    window that ends with a single member takes the untouched solo
    path (``_call(..., coalesce=False)``) — same chaos point, same
    wire negotiation, same tracing — so coalescing is strictly
    additive. A deadline-doomed caller (budget <= window) never waits:
    it dispatches solo immediately, and the solo path's Deadline.check
    sheds it if the budget is already spent.

    Failure semantics match solo exactly: a whole-group failure
    (ShardUnavailable, injected chaos fault) lands on EVERY member's
    future — each would have seen the same outcome calling alone — and
    the router's existing degrade path flags only the affected slots.
    ``_BatchUnsupported`` (pre-batch replica) falls back to sequential
    per-query solo calls with per-future results/exceptions."""

    def __init__(self, router: "FleetRouter", window_s: float,
                 max_batch: int):
        self.router = router
        self.window_s = float(window_s)
        self.max_batch = int(max_batch)
        self._lock = threading.Lock()
        # key -> list[(body, Future, t_enq)]; popped wholesale by the
        # key's leader when its window closes
        self._groups: dict[tuple, list] = {}
        self.coalesced_calls = 0    # batched dispatches (>= 2 members)
        self.coalesced_queries = 0  # queries riding them
        self.solo_windows = 0       # windows that closed with 1 member
        self.fallback_calls = 0     # _BatchUnsupported sequential runs
        self.doomed_bypass = 0      # deadline-doomed immediate solos

    def call(self, shard: int, op: str, path: str, body: dict,
             plan_version: int | None) -> dict:
        rem = Deadline.remaining()
        if rem is not None and rem <= self.window_s:
            # can't afford the window: dispatch solo NOW (Deadline.check
            # on the solo path sheds it if the budget is already gone)
            with self._lock:
                self.doomed_bypass += 1
            return self.router._call(shard, op, path, body,
                                     plan_version, coalesce=False)
        key = (shard, op, body.get("arm", ARM_ACTIVE), plan_version,
               path)
        fut: Future = Future()
        with self._lock:
            pending = self._groups.get(key)
            if pending is not None and len(pending) < self.max_batch:
                pending.append((body, fut, time.monotonic()))
                leader = False
            else:
                self._groups[key] = [(body, fut, time.monotonic())]
                leader = True
        if leader:
            # window anchored at the FIRST member's arrival (ours)
            self._lead(key, shard, op, path, plan_version)
            # _lead resolved every future in the batch, ours included
        try:
            return fut.result(timeout=rem)
        except FuturesTimeoutError:
            raise DeadlineExceeded(
                f"request budget exhausted waiting for coalesced "
                f"shard {shard} {op}") from None

    def _lead(self, key: tuple, shard: int, op: str, path: str,
              plan_version: int | None) -> None:
        if self.window_s > 0:
            time.sleep(self.window_s)
        with self._lock:
            batch = self._groups.pop(key, [])
        if not batch:
            return
        now = time.monotonic()
        tracer = self.router.tracer
        tracer.histogram("fleet.batch_occupancy").record(
            len(batch) / self.max_batch)
        for _, _, t_enq in batch:
            tracer.record("fleet.coalesce_wait", now - t_enq)
        if len(batch) == 1:
            with self._lock:
                self.solo_windows += 1
            self._solo_each(batch, shard, op, path, plan_version)
            return
        with self._lock:
            self.coalesced_calls += 1
            self.coalesced_queries += len(batch)
        bodies = [b for b, _, _ in batch]
        try:
            results = self.router._call_batch(shard, op, path, bodies,
                                              plan_version)
        except _BatchUnsupported:
            with self._lock:
                self.fallback_calls += 1
            self._solo_each(batch, shard, op, path, plan_version)
            return
        except BaseException as e:
            # whole-group failure: every member sees exactly what it
            # would have seen calling alone, and the caller's existing
            # degrade path handles it (only the affected slots degrade)
            for _, fut, _ in batch:
                fut.set_exception(e)
            return
        if len(results) != len(batch):
            # decode bounds every count, but nothing ties the shard's
            # answer length to OUR request length — treat a mismatch
            # like a corrupt frame rather than misdelivering answers
            err = HttpClientError(
                0, f"batched shard {shard} {op} answered "
                   f"{len(results)} results for {len(batch)} queries")
            for _, fut, _ in batch:
                fut.set_exception(err)
            return
        for (_, fut, _), out in zip(batch, results):
            fut.set_result(out)

    def _solo_each(self, batch: list, shard: int, op: str, path: str,
                   plan_version: int | None) -> None:
        for body, fut, _ in batch:
            try:
                fut.set_result(self.router._call(
                    shard, op, path, body, plan_version,
                    coalesce=False))
            except BaseException as e:
                fut.set_exception(e)

    def stats(self) -> dict:
        tracer = self.router.tracer
        occ = tracer.histogram("fleet.batch_occupancy")
        wait = tracer.histogram("fleet.coalesce_wait")
        occ_snap = occ.snapshot()
        wait_q = wait.quantiles()
        with self._lock:
            out = {
                "enabled": True,
                "windowMs": self.window_s * 1e3,
                "maxBatch": self.max_batch,
                "coalescedCalls": self.coalesced_calls,
                "coalescedQueries": self.coalesced_queries,
                "soloWindows": self.solo_windows,
                "fallbackCalls": self.fallback_calls,
                "doomedBypass": self.doomed_bypass,
            }
        out["meanOccupancy"] = (round(occ_snap["avg"], 4)
                                if occ_snap["count"] else None)
        out["occupancy"] = {k: round(v, 4)
                            for k, v in occ.quantiles().items()}
        out["coalesceWaitMs"] = {k: round(v * 1e3, 3)
                                 for k, v in wait_q.items()}
        return out


@dataclass
class RouterConfig:
    ip: str = "127.0.0.1"
    port: int = 0
    engine_id: str = ""
    engine_version: str = "1"
    engine_variant: str = "default"
    server_key: str = ""            # guards /reload and /stop
    # per replica-attempt HTTP timeout; the ambient Deadline is checked
    # before EVERY attempt, so a spent budget stops the failover scan,
    # but an in-flight attempt runs to this timeout
    rpc_timeout_s: float = 5.0
    request_budget_s: float = 0.0   # per-request Deadline budget; 0 = off
    probe_interval_s: float = 1.0   # replica /readyz prober; 0 = off
    backend: str = "async"
    # per-replica breaker sizing: small window + short open so a dead
    # replica stops eating connection attempts after a handful of
    # failures and is re-probed quickly once it rejoins
    breaker_min_calls: int = 4
    breaker_failure_rate: float = 0.5
    breaker_open_s: float = 2.0
    breaker_window_s: float = 30.0
    # internal RPC plane (docs/performance.md): "binary" negotiates the
    # CRC32C-framed f32/int32 shard wire (rpcwire.py) per replica, with
    # a sticky logged-once JSON downgrade against pre-binary shards;
    # "json" pins the legacy wire (the bench smoke cell's control arm).
    rpc_wire: str = "binary"
    # keep-alive pooling for the shard RPC clients; False restores a
    # fresh connection per RPC (the other control arm)
    http_pooled: bool = True
    # multi-tenant fleet (serving_fleet/tenancy.py): the tenant triple
    # this router speaks for. Non-empty stamps X-Pio-Tenant on EVERY
    # shard RPC (scoring, fold-in, rollout, control, probes) and labels
    # this router's spans + Prometheus lines `tenant=`.
    tenant: str = ""
    # chaos drill namespace: injection points are
    # `<chaos_prefix>.shard<i>.<op>`. The single-tenant default keeps
    # the historical `fleet.shard...` names; a multi-tenant fleet scopes
    # each tenant's router under `fleet.<tenant-label>` so a drill can
    # take down exactly one tenant's fan-out.
    chaos_prefix: str = "fleet"
    # two-stage retrieval (ops/retrieval.py): "clustered" fans the
    # top-k as the /shard/candidates op — quantized candidate scan +
    # exact re-rank shard-side; the merge is unchanged because the
    # candidates RPC answers on the same kind-2 frame with the same
    # (-score, global_index) semantics. "exact" (default) keeps the
    # /shard/topk fan, including against pre-retrieval shards.
    retrieval_mode: str = "exact"
    # cross-request continuous batching (docs/serving.md "Continuous
    # batching"): > 0 coalesces concurrent per-shard scoring fan-outs
    # arriving within this window (ms) into ONE multi-query binary
    # frame per shard group (rpcwire.py batched kinds 1/6), answered
    # from one batched device dispatch — N concurrent user queries
    # cost one RPC + one device program per group instead of N. Only
    # topk/candidates coalesce; queries whose Deadline cannot survive
    # the window dispatch solo. 2 ms is the recommended value when
    # enabling. 0 = off (every fan-out is its own RPC, the historical
    # behavior).
    coalesce_window_ms: float = 0.0
    # most queries one batched frame may carry; arrivals past it start
    # the next batch immediately
    coalesce_max_batch: int = 64
    # the device the whiteList ranking scores on (_score_candidates):
    # CUDA unless the caller asks for the CPU, as the single-host deploy
    # scores, so the fleet's whiteList answers carry its bits
    device: str | None = None


class _TenantClient(JsonHttpClient):
    """JsonHttpClient that stamps the X-Pio-Tenant header on every
    request — the multi-tenant wire contract's client half (the client
    ALWAYS sends; the shard host routes + validates against placement).
    Subclassing keeps all call sites (scoring fan, control fan, fold-in,
    prober GETs) on one code path with zero single-tenant overhead."""

    def __init__(self, url: str, tenant: str, **kw):
        super().__init__(url, **kw)
        self._tenant = tenant

    def request(self, method, path, body=None, params=None, **kw):
        hdrs = dict(kw.pop("headers", None) or {})
        hdrs.setdefault(TENANT_HEADER, self._tenant)
        return super().request(method, path, body, params,
                               headers=hdrs, **kw)


def _new_client(config: RouterConfig, url: str) -> JsonHttpClient:
    if config.tenant:
        return _TenantClient(url, config.tenant,
                             timeout=config.rpc_timeout_s,
                             pooled=config.http_pooled)
    return JsonHttpClient(url, timeout=config.rpc_timeout_s,
                          pooled=config.http_pooled)


@dataclass
class _Replica:
    url: str
    client: JsonHttpClient
    breaker: CircuitBreaker
    healthy: bool = True        # last prober verdict (optimistic start)
    last_probe: float = 0.0
    info: dict = field(default_factory=dict)   # last /shard/info payload
    # binary RPC wire negotiation state (rpcwire.py): None = untested
    # (send JSON bodies + binary Accept), True = confirmed (top-k
    # request bodies go binary too), False = STICKY JSON downgrade (a
    # pre-binary shard ignored the negotiation; logged once)
    binary_wire: bool | None = None
    # batched-frame negotiation state, same ladder one level up: None =
    # untested, True = confirmed (batched multi-query frames OK), False
    # = STICKY per-query downgrade (a pre-batch shard 400'd the batched
    # frame; logged once). Only meaningful once binary_wire is True.
    batch_wire: bool | None = None


class FleetRouter:
    """Shard-plan-aware query front-end (see module docstring)."""

    def __init__(self, storage, config: RouterConfig, plan: ShardPlan,
                 endpoints: list[list[str]]):
        if len(endpoints) != plan.n_shards:
            raise ValueError(
                f"endpoints cover {len(endpoints)} shards but the plan "
                f"has {plan.n_shards}"
            )
        self.storage = storage
        self.config = config
        self.device = resolve_device(config.device)
        self.plan = plan
        self.start_time = utcnow()
        # distributed tracing (pio_tpu_torch/obs/): the router is where a
        # fleet trace fans out, so its recorder holds the hop spans
        # (`shard.rpc`) that stitch the per-shard trees together
        from pio_tpu_torch.obs import make_recorder

        self.recorder = make_recorder("router")
        self.tracer = Tracer(recorder=self.recorder)
        self._lock = threading.RLock()
        self._stop_requested = threading.Event()
        self.degraded_count = 0
        self.rerouted_count = 0
        # guarded rollout (pio_tpu_torch/rollout/): the controller splitting
        # traffic and the candidate instance's shard plan. Each shard
        # group serves candidate partitions from the already-recorded
        # `<iid>:shard<i>` blobs; the ROUTER carries the split by
        # stamping {"arm": "candidate"} on canary-arm RPCs.
        self.rollout = None
        self.candidate_plan: ShardPlan | None = None
        # live elastic resharding (serving_fleet/reshard.py): the
        # controller driving a migration, plus the router-side routing
        # state while one is in flight. `reshard_routing` holds
        # {"moving": {partition: (old_owner, new_owner)},
        #  "staged": set[partition]} — what the dual-write fan and the
        # alternate-owner read fallback consult; None outside a
        # migration. The moved/pending counts back the
        # pio_reshard_partitions_{moved,pending}_total gauges.
        self.reshard = None
        self.reshard_routing: dict | None = None
        self.reshard_partitions_moved = 0
        self.reshard_partitions_pending = 0
        self.reshard_dual_failures = 0
        # per-codec RPC accounting (docs/performance.md "Internal RPC
        # plane"): which wire the shard fan-out actually rides, plus the
        # downgrade log-once latch per replica
        self.rpc_codec_counts = {"binary": 0, "json": 0}
        self.replicas: list[list[_Replica]] = [
            [
                _Replica(
                    url=url,
                    client=_new_client(config, url),
                    breaker=CircuitBreaker(
                        f"shard{s}/replica{r}",
                        min_calls=config.breaker_min_calls,
                        failure_rate=config.breaker_failure_rate,
                        open_s=config.breaker_open_s,
                        window_s=config.breaker_window_s,
                    ),
                )
                for r, url in enumerate(urls)
            ]
            for s, urls in enumerate(endpoints)
        ]
        self._preferred = [0] * plan.n_shards
        # with coalescing on, follower fan tasks PARK in the coalescer
        # holding their pool thread until the leader dispatches — size
        # the fan pool for parked concurrency, not just one fan in
        # flight, or queued fan tasks would serialize behind each window
        fan_workers = (max(16, 4 * plan.n_shards)
                       if config.coalesce_window_ms > 0
                       else max(4, 2 * plan.n_shards))
        self._pool = ThreadPoolExecutor(
            max_workers=fan_workers,
            thread_name_prefix="fleet-fan",
        )
        # cross-request coalescing of the scoring fan (docs/serving.md
        # "Continuous batching"); None = historical per-query RPCs
        self._coalescer = (
            _ShardCoalescer(self, config.coalesce_window_ms / 1e3,
                            config.coalesce_max_batch)
            if config.coalesce_window_ms > 0 else None
        )
        # dedicated pool for query_batch concurrency under coalescing:
        # the query layer must NEVER run on the fan pool (its shard
        # fan-outs land there — nesting would deadlock the pool on its
        # own children). Lazily built on first use.
        self._batch_pool: ThreadPoolExecutor | None = None
        self._prober: threading.Thread | None = None
        if config.probe_interval_s > 0:
            # pio: lint-ok[context-loss] deliberate detach: the health
            # prober is a process-lifetime loop with no originating
            # request — there is no Deadline/trace to carry
            self._prober = threading.Thread(
                target=self._probe_loop, name="fleet-prober", daemon=True
            )
            self._prober.start()

    # -- shard RPC with failover --------------------------------------------
    def _replica_order(self, shard: int, group: list[_Replica]) -> list[int]:
        """Preferred (last-good) replica first, then prober-healthy ones,
        then the rest — a dead replica is tried LAST, not skipped, so a
        stale health verdict can never strand a reachable shard."""
        with self._lock:
            pref = (self._preferred[shard]
                    if shard < len(self._preferred) else 0)
        order = sorted(
            range(len(group)),
            key=lambda r: (r != pref, not group[r].healthy, r),
        )
        return order

    def _call(self, shard: int, op: str, path: str, body,
              plan_version: int | None = None,
              coalesce: bool = True) -> dict:
        """One shard-group RPC: replicas in preference order, per-replica
        breaker guard, transient failures roll to the next replica.
        Raises ShardUnavailable when the whole group is down. The whole
        group attempt is one `shard.rpc` trace span (labels shard/op/
        arm); a whole-group failure — including an injected
        fleet.shard<i>.<op> chaos fault — records as a FAILED span
        tagged with the chaos point, so `pio trace` shows exactly which
        hop a drill (or real outage) took down.

        With coalescing on, scoring RPCs detour through the coalescer
        (which groups concurrent same-(shard, op, arm, plan) calls into
        one batched frame); `coalesce=False` is the coalescer's own
        re-entry guard for its singleton/fallback dispatches."""
        if (coalesce and self._coalescer is not None
                and op in ("topk", "candidates")
                and isinstance(body, dict)):
            return self._coalescer.call(shard, op, path, body,
                                        plan_version)
        arm = (body.get("arm", ARM_ACTIVE) if isinstance(body, dict)
               else ARM_ACTIVE)
        attrs = {"shard": shard, "op": op, "arm": arm}
        if self.config.tenant:
            attrs["tenant"] = self.config.tenant
        with self.tracer.span("shard.rpc", **attrs):
            return self._call_group(shard, op, path, body, plan_version)

    def _call_group(self, shard: int, op: str, path: str, body,
                    plan_version: int | None = None) -> dict:
        Deadline.check(f"shard {shard} {op}")
        try:
            # drill point: a spec targeting fleet.shard<i> takes that
            # whole shard group down FROM THE ROUTER'S VIEW — the injected
            # ConnectionError classifies as the group being unreachable,
            # so the drill exercises the same degrade path a real outage
            # does
            chaos.maybe_inject(
                f"{self.config.chaos_prefix}.shard{shard}.{op}")
        except ConnectionError as e:
            raise ShardUnavailable(shard, e) from e
        # snapshot: a reshard swaps self.replicas wholesale (never
        # mutates in place), so an in-flight old-plan fan racing a
        # shrink's group trim degrades instead of IndexError-ing
        replicas = self.replicas
        if shard >= len(replicas):
            raise ShardUnavailable(
                shard, ConnectionError("shard group removed by reshard"))
        group = replicas[shard]
        last_error: Exception | None = None
        for r in self._replica_order(shard, group):
            Deadline.check(f"shard {shard} {op} replica {r}")
            rep = group[r]
            if not rep.breaker.allow():
                last_error = CircuitOpenError(
                    rep.breaker.name,
                    retry_after_s=rep.breaker.retry_after_s() or 1.0)
                continue
            try:
                out = self._rpc(rep, op, path, body, plan_version)
            except HttpClientError as e:
                if (e.status == 503 and isinstance(e.message, str)
                        and e.message.startswith(("candidate-arm-missing",
                                                  "plan-version-missing"))):
                    # the replica is HEALTHY — it just has no staged
                    # candidate arm (restarted mid-canary, or its
                    # load_candidate failed while a sibling's succeeded)
                    # or no arm for the pinned plan version (restarted
                    # mid-reshard and lost the epoch). Fail over to a
                    # replica that has it WITHOUT charging this
                    # replica's breaker, or active-arm traffic would
                    # lose the replica too
                    rep.breaker.record(True)
                    last_error = e
                    log.warning("shard %d replica %d (%s) has no arm "
                                "for %s (%s); trying next",
                                shard, r, rep.url, op, e.message)
                    continue
                rep.breaker.record(not is_transient(e))
                if e.status and e.status not in (408, 429, 502, 503, 504):
                    raise  # application error: the shard DID answer
                last_error = e
                log.warning("shard %d replica %d (%s) failed %s: %s",
                            shard, r, rep.url, op, e)
                continue
            rep.breaker.record(True)
            with self._lock:
                if (shard < len(self._preferred)
                        and self._preferred[shard] != r):
                    self.rerouted_count += 1
                    self._preferred[shard] = r
            return out
        raise ShardUnavailable(shard, last_error)

    # -- binary RPC wire (rpcwire.py) ----------------------------------------
    _BINARY_OPS = frozenset({"user_row", "topk", "candidates",
                             "item_rows"})

    def _count_rpc(self, codec: str) -> None:
        with self._lock:
            self.rpc_codec_counts[codec] += 1

    def _rpc(self, rep: _Replica, op: str, path: str, body,
             plan_version: int | None = None) -> dict:
        """One replica RPC with wire negotiation. The scoring RPCs are
        read-only, so they are marked idempotent — a stale pooled
        socket gets the client's ONE transparent resend instead of
        burning a replica failover. Binary negotiation rides Accept; a
        replica that answers JSON anyway (pre-binary shard) is
        downgraded STICKILY and logged once, mirroring find_columnar's
        downgrade. Only a CONFIRMED-binary replica gets binary request
        bodies (the top-k f32 row), so a pre-binary shard never sees a
        frame it would 400 on. ``plan_version`` pins the topology the
        query was planned against (the reshard cutover's two-arm
        discipline) as an ``X-Pio-Plan-Version`` header — a HEADER so it
        rides both the JSON and the binary wire without a frame-format
        change; a pre-reshard shard simply ignores it."""
        from pio_tpu_torch.serving_fleet import rpcwire

        hdrs = ({"X-Pio-Plan-Version": str(int(plan_version))}
                if plan_version is not None else None)
        read_op = op in self._BINARY_OPS
        if (not read_op or self.config.rpc_wire != "binary"
                or rep.binary_wire is False):
            if read_op:
                self._count_rpc("json")
                return rep.client.request("POST", path,
                                          self._jsonable(op, body),
                                          idempotent=True, headers=hdrs)
            return rep.client.request("POST", path, body)
        if op in ("topk", "candidates") and rep.binary_wire:
            encode_req = (rpcwire.encode_candidates_request
                          if op == "candidates"
                          else rpcwire.encode_topk_request)
            try:
                resp = rep.client.request(
                    "POST", path,
                    raw=encode_req(
                        body["row"], body["k"], body.get("arm", ARM_ACTIVE)),
                    content_type=rpcwire.RPC_CONTENT_TYPE,
                    accept=rpcwire.RPC_CONTENT_TYPE, idempotent=True,
                    headers=hdrs)
            except HttpClientError as e:
                if not e.status:
                    raise   # transport-level: breaker/failover handles it
                # a CONFIRMED-binary replica answering an HTTP error to
                # a frame it negotiated for is usually a shard rolled
                # back to a pre-binary build mid-flight (its handler
                # can't parse the body at all): retry this one call as
                # JSON — a JSON success hits the sticky downgrade
                # below, a JSON failure is the real error and raises
                resp = rep.client.request(
                    "POST", path, self._jsonable(op, body),
                    accept=rpcwire.RPC_CONTENT_TYPE, idempotent=True,
                    headers=hdrs)
        else:
            resp = rep.client.request(
                "POST", path, self._jsonable(op, body),
                accept=rpcwire.RPC_CONTENT_TYPE, idempotent=True,
                headers=hdrs)
        if isinstance(resp, (bytes, bytearray)):
            rep.binary_wire = True
            self._count_rpc("binary")
            try:
                return rpcwire.decode_response(op, resp)
            except rpcwire.RpcWireError as e:
                # a corrupt frame from a confirmed-binary replica gets
                # the transport-failure treatment: charge the breaker,
                # fail over to the next replica
                raise HttpClientError(
                    0, f"corrupt binary rpc frame from {rep.url}: {e}"
                ) from e
        # JSON answer to a binary negotiation: pre-binary shard — pin
        # the replica to the JSON wire for this router's lifetime
        if rep.binary_wire is not False:
            rep.binary_wire = False
            log.warning(
                "shard replica %s ignored the binary RPC negotiation "
                "(pre-binary shard?); sticky JSON downgrade for this "
                "replica", rep.url)
        self._count_rpc("json")
        return resp

    @staticmethod
    def _jsonable(op: str, body):
        """A JSON-wire body for `op`: the top-k row may be an f32 numpy
        array (fetched over the binary wire from the owner shard) —
        float64 text of f32 values round-trips exactly, so converting
        here preserves bit-parity on mixed-wire fleets."""
        if (op in ("topk", "candidates") and isinstance(body, dict)
                and not isinstance(body.get("row"), list)):
            return {**body, "row": [float(x) for x in body["row"]]}
        return body

    # -- batched scoring RPCs (continuous batching) --------------------------
    def _call_batch(self, shard: int, op: str, path: str, bodies: list,
                    plan_version: int | None = None) -> list:
        """Batched analog of _call for one coalesced window: one RPC,
        one device program, ``len(bodies)`` answers in request order.
        Raises _BatchUnsupported when the usable replica can't take
        batched frames (the coalescer falls back to per-query solo
        calls) and ShardUnavailable when the whole group is down —
        the same degrade contract as the solo path."""
        arm = bodies[0].get("arm", ARM_ACTIVE)
        attrs = {"shard": shard, "op": op, "arm": arm,
                 "batch": len(bodies)}
        if self.config.tenant:
            attrs["tenant"] = self.config.tenant
        with self.tracer.span("shard.rpc", **attrs):
            return self._call_group_batch(shard, op, path, bodies,
                                          plan_version)

    def _call_group_batch(self, shard: int, op: str, path: str,
                          bodies: list,
                          plan_version: int | None = None) -> list:
        Deadline.check(f"shard {shard} {op} batch")
        if self.config.rpc_wire != "binary":
            raise _BatchUnsupported("json rpc wire configured")
        try:
            # SAME drill point as the solo path: a spec targeting
            # fleet.shard<i>.<op> takes down coalesced dispatches too,
            # so existing chaos drills exercise the batched plane
            chaos.maybe_inject(
                f"{self.config.chaos_prefix}.shard{shard}.{op}")
        except ConnectionError as e:
            raise ShardUnavailable(shard, e) from e
        replicas = self.replicas
        if shard >= len(replicas):
            raise ShardUnavailable(
                shard, ConnectionError("shard group removed by reshard"))
        group = replicas[shard]
        last_error: Exception | None = None
        for r in self._replica_order(shard, group):
            Deadline.check(f"shard {shard} {op} batch replica {r}")
            rep = group[r]
            if not rep.breaker.allow():
                last_error = CircuitOpenError(
                    rep.breaker.name,
                    retry_after_s=rep.breaker.retry_after_s() or 1.0)
                continue
            if rep.binary_wire is not True or rep.batch_wire is False:
                # only a CONFIRMED-binary replica that hasn't rejected
                # a batched frame gets one; otherwise fall back to solo
                # calls, which run the normal wire negotiation (and
                # confirm the replica for the NEXT window)
                raise _BatchUnsupported(
                    f"replica {rep.url} not confirmed batch-capable")
            try:
                out = self._rpc_batch(rep, op, path, bodies,
                                      plan_version)
            except _BatchUnsupported:
                # the replica DID answer (an application 400): it is
                # healthy, just pre-batch — don't charge its breaker
                rep.breaker.record(True)
                raise
            except HttpClientError as e:
                if (e.status == 503 and isinstance(e.message, str)
                        and e.message.startswith(
                            ("candidate-arm-missing",
                             "plan-version-missing"))):
                    # healthy replica without the arm/epoch — fail over
                    # without charging the breaker (same as solo)
                    rep.breaker.record(True)
                    last_error = e
                    log.warning("shard %d replica %d (%s) has no arm "
                                "for batched %s (%s); trying next",
                                shard, r, rep.url, op, e.message)
                    continue
                rep.breaker.record(not is_transient(e))
                if e.status and e.status not in (408, 429, 502, 503,
                                                 504):
                    raise  # application error: the shard DID answer
                last_error = e
                log.warning("shard %d replica %d (%s) failed batched "
                            "%s: %s", shard, r, rep.url, op, e)
                continue
            rep.breaker.record(True)
            with self._lock:
                if (shard < len(self._preferred)
                        and self._preferred[shard] != r):
                    self.rerouted_count += 1
                    self._preferred[shard] = r
            return out
        raise ShardUnavailable(shard, last_error)

    def _rpc_batch(self, rep: _Replica, op: str, path: str,
                   bodies: list,
                   plan_version: int | None = None) -> list:
        """One batched replica RPC. Only reached for a confirmed-binary
        replica whose batch_wire isn't known-False. A 400 means a
        pre-batch shard build whose solo decoder rejected the layout:
        sticky ``batch_wire=False`` downgrade, logged once — the
        binary→JSON negotiation ladder one level up (that replica keeps
        serving solo frames; everything else keeps batching)."""
        from pio_tpu_torch.serving_fleet import rpcwire

        hdrs = ({"X-Pio-Plan-Version": str(int(plan_version))}
                if plan_version is not None else None)
        rows = [b["row"] for b in bodies]
        ks = [int(b["k"]) for b in bodies]
        arm = bodies[0].get("arm", ARM_ACTIVE)
        encode = (rpcwire.encode_candidates_batch_request
                  if op == "candidates"
                  else rpcwire.encode_topk_batch_request)
        try:
            resp = rep.client.request(
                "POST", path, raw=encode(rows, ks, arm),
                content_type=rpcwire.RPC_CONTENT_TYPE,
                accept=rpcwire.RPC_CONTENT_TYPE, idempotent=True,
                headers=hdrs)
        except HttpClientError as e:
            if e.status == 400:
                if rep.batch_wire is not False:
                    rep.batch_wire = False
                    log.warning(
                        "shard replica %s rejected the batched scoring "
                        "frame (pre-batch shard?); sticky solo-frame "
                        "downgrade for this replica", rep.url)
                raise _BatchUnsupported(str(e.message)) from e
            raise
        if not isinstance(resp, (bytes, bytearray)):
            # a JSON answer to a batched frame a confirmed-binary
            # replica accepted shouldn't happen — treat it like a
            # rejection rather than guessing at the payload shape
            if rep.batch_wire is not False:
                rep.batch_wire = False
                log.warning(
                    "shard replica %s answered a batched scoring frame "
                    "with JSON; sticky solo-frame downgrade for this "
                    "replica", rep.url)
            raise _BatchUnsupported("non-binary answer to batched frame")
        rep.batch_wire = True
        self._count_rpc("binary")
        try:
            return rpcwire.decode_topk_batch_response(bytes(resp))
        except rpcwire.RpcWireError as e:
            # corrupt frame from a confirmed replica: transport-failure
            # treatment — charge the breaker, fail over
            raise HttpClientError(
                0, f"corrupt binary rpc frame from {rep.url}: {e}"
            ) from e

    # -- query path ---------------------------------------------------------
    def _plan_for(self, arm: str) -> ShardPlan:
        with self._lock:
            if arm == ARM_CANDIDATE and self.candidate_plan is not None:
                return self.candidate_plan
            return self.plan

    @staticmethod
    def _arm_body(body: dict, arm: str) -> dict:
        if arm != ARM_ACTIVE:
            body["arm"] = arm
        return body

    def query(self, q: dict) -> dict:
        """Single-host-oracle-equivalent prediction, or a flagged
        degraded response when part of the fleet is unreachable. With a
        rollout in flight the controller picks the arm (sticky crc32c
        user split — the SAME split function the single-host server
        uses, so a user rides the same arm fleet-wide)."""
        t0 = time.monotonic()
        user = q["user"]
        num = int(q.get("num", 10))
        black = set(q.get("blackList") or ())
        white = q.get("whiteList")
        rollout = self.rollout
        arm = rollout.arm_for(q) if rollout is not None else ARM_ACTIVE
        # RAW id value, no str() coercion: the single-host oracle treats
        # a non-string id as unknown (dict-keyed id index), and the
        # fleet must agree; owner routing str-coerces only for hashing
        out = self._query_inner(user, num, black, white, arm=arm)
        if out.get("degraded"):
            with self._lock:
                self.degraded_count += 1
        self.tracer.record("query", time.monotonic() - t0)
        if rollout is not None:
            rollout.observe(arm, q, out, time.monotonic() - t0)
        return out

    def shadow_predict(self, q: dict, arm: str) -> dict:
        """Score `q` on one arm without stats — the rollout
        controller's divergence sampler."""
        return self._query_inner(
            q["user"], int(q.get("num", 10)),
            set(q.get("blackList") or ()), q.get("whiteList"), arm=arm)

    def _query_inner(self, user, num: int, black: set,
                     white, arm: str = ARM_ACTIVE) -> dict:
        if arm == ARM_CANDIDATE:
            # a candidate query racing a just-finished rollback/promote
            # rides the ACTIVE arm (the single-host _arm_snapshot
            # contract: a dropped arm is never served) — stamping the
            # dead arm would 503 on every replica and degrade to the
            # popularity fallback instead
            with self._lock:
                if self.candidate_plan is None:
                    arm = ARM_ACTIVE
        # ONE plan snapshot per query: owner routing, the top-k fan set,
        # and the plan-version pin must all describe the SAME topology,
        # or a reshard cutover racing this query could fan the new
        # group count against old-plan partitions (duplicate or missing
        # item coverage). Every shard answers the pinned version from
        # its matching arm, so the merged answer is always one
        # consistent topology's answer.
        plan = self._plan_for(arm)
        owner = plan.owner_of(user)
        with self.tracer.span("user_row"):
            try:
                row_resp = self._call(
                    owner, "user_row", "/shard/user_row",
                    self._arm_body({"user": user}, arm),
                    plan_version=plan.plan_version)
            except ShardUnavailable as e:
                row_resp = self._reshard_alt_user_row(user, owner, arm,
                                                      plan)
                if row_resp is None:
                    return self._fallback(num, black, str(e), arm=arm)
        if not row_resp.get("found"):
            return {"itemScores": []}  # unknown user: same as single-host
        row = row_resp["row"]
        if white:
            return self._white_query(row, num, black, white, arm=arm,
                                     plan=plan)
        return self._topk_query(row, num, black, arm=arm, plan=plan)

    def _reshard_alt_user_row(self, user, owner: int, arm: str,
                              plan: ShardPlan) -> dict | None:
        """During a live reshard a MOVING partition has a second copy —
        the staged slice (or prepared arm) on its other owner. When the
        planned owner's whole group is down, try that copy before
        degrading to the popularity fallback; None means no usable
        alternate (caller degrades exactly as before resharding)."""
        with self._lock:
            rs = self.reshard_routing
        if rs is None:
            return None
        mv = rs["moving"].get(partition_of(user))
        if mv is None:
            return None
        alt = mv[1] if mv[1] != owner else mv[0]
        if alt == owner or alt >= len(self.replicas):
            return None
        try:
            out = self._call(alt, "user_row", "/shard/user_row",
                             self._arm_body({"user": user}, arm),
                             plan_version=plan.plan_version)
        except ShardUnavailable:
            return None
        # only a FOUND row counts: the alternate may not hold the copy
        # yet (transfer not staged), and `found: false` from it would
        # masquerade as "unknown user" instead of a degraded answer
        return out if out.get("found") else None

    def _fan(self, op: str, path: str, body, shards=None,
             plan_version: int | None = None,
             ) -> tuple[dict[int, dict], list[int]]:
        """Concurrent RPC to `shards` (default: every shard group) ->
        ({shard: result}, [down shards]). Each task runs in a COPY of
        the caller's context so the ambient Deadline follows the work
        onto the pool (a spent budget surfaces as DeadlineExceeded ->
        the edge's 503, never a silent over-budget fan-out)."""
        import contextvars

        futs = {
            s: self._pool.submit(
                contextvars.copy_context().run,
                self._call, s, op, path, body, plan_version)
            for s in (range(self.plan.n_shards) if shards is None
                      else shards)
        }
        results: dict[int, dict] = {}
        down: list[int] = []
        for s, f in futs.items():
            try:
                results[s] = f.result()
            except ShardUnavailable as e:
                log.warning("degrading: %s", e)
                down.append(s)
        return results, down

    def _topk_query(self, row: list[float], num: int, black: set,
                    arm: str = ARM_ACTIVE,
                    plan: ShardPlan | None = None) -> dict:
        if plan is None:
            plan = self._plan_for(arm)
        # over-fetch exactly like ALSAlgorithm.predict: k = num + |black|
        # capped at the (global) item count, so blacklist filtering can
        # never starve the result below the single-host answer
        n_items = sum(plan.item_counts)
        k = min(num + len(black), n_items)
        # two-stage retrieval: a clustered fleet fans the candidates op
        # instead — same body, same kind-2 response frame, same merge;
        # exact-mode (and exhaustive) shards answer it from the literal
        # /shard/topk compute path, so flipping this knob on an
        # exact fleet changes no bit of any response
        op, path = (("candidates", "/shard/candidates")
                    if self.config.retrieval_mode == "clustered"
                    else ("topk", "/shard/topk"))
        with self.tracer.span("score"):
            results, down = self._fan(
                op, path,
                self._arm_body({"row": row, "k": k}, arm),
                shards=range(plan.n_shards),
                plan_version=plan.plan_version)
        merged: list[tuple[float, int, str]] = []
        for res in results.values():
            merged.extend(zip(res["scores"], res["indices"], res["items"]))
        # descending score, ties to the LOWEST global index — the exact
        # ops/topk.py order the single-host oracle produces
        merged.sort(key=lambda t: (-t[0], t[1]))
        out = []
        for score, _, item in merged:
            if item in black:
                continue
            out.append({"item": item, "score": float(score)})
            if len(out) >= num:
                break
        if not down:
            return {"itemScores": out}
        return self._blend(out, num, black,
                           f"shard group(s) {sorted(down)} unavailable",
                           arm=arm)

    def _white_query(self, row: list[float], num: int, black: set,
                     white: list, arm: str = ARM_ACTIVE,
                     plan: ShardPlan | None = None) -> dict:
        if plan is None:
            plan = self._plan_for(arm)
        # row-fetch the candidates' factor rows from their owning shards
        # ONLY (a non-owner group being down is irrelevant to this
        # query and must not flag it degraded), then score HERE in one
        # einsum with the exact operand shapes the single-host oracle
        # uses (n candidates at once) — shard-side per-subset scoring
        # drifts by an ULP because the library's product kernels are
        # shape-sensitive
        owners = sorted({plan.owner_of(w) for w in white})
        with self.tracer.span("score"):
            results, down = self._fan(
                "item_rows", "/shard/item_rows",
                self._arm_body({"items": list(white)}, arm), shards=owners,
                plan_version=plan.plan_version)
        rows: dict[str, list[float]] = {}
        for res in results.values():
            rows.update(res["rows"])
        # candidate order matches the oracle: whiteList order, filtered
        # to known items not blacklisted; then the same argsort ranking.
        # Membership is RAW (JSON object keys are strings, and so are
        # all owned ids) — a non-string candidate is unknown, exactly
        # like the oracle's id-index membership
        cand = [w for w in white if w in rows and w not in black]
        if not cand and not down:
            return {"itemScores": []}
        ranked = (self._score_candidates(row, cand, rows, num)
                  if cand else {"itemScores": []})
        if not down:
            return ranked
        ranked["degraded"] = True
        ranked["degradedReason"] = (
            f"shard group(s) {sorted(down)} unavailable; whiteList "
            "candidates on those shards were not scored")
        return ranked

    def _score_candidates(self, row: list[float], cand: list,
                          rows: dict[str, list[float]], num: int) -> dict:
        """ALSAlgorithm.predict's whiteList ranking, reassembled from
        fetched rows: same predict_pairs einsum over the same (n, k)
        operand values on the router's device, same _rank_candidates
        argsort — bit-identical."""
        import numpy as np
        import torch

        from pio_tpu_torch.models.recommendation import _rank_candidates
        from pio_tpu_torch.ops import als

        n = len(cand)
        model = als.ALSModel(
            torch.as_tensor(np.asarray([row], dtype=np.float32)).to(
                self.device),
            torch.as_tensor(np.asarray([rows[c] for c in cand],
                                       dtype=np.float32)).to(self.device),
        )
        scores = als.predict_pairs(
            model, np.zeros(n, dtype=np.int32),
            np.arange(n, dtype=np.int32)).cpu().numpy()
        return _rank_candidates(cand, scores, num)

    def _blend(self, partial: list[dict], num: int, black: set,
               reason: str, arm: str = ARM_ACTIVE) -> dict:
        """Partial real results + popularity fallback fill, flagged
        (the arm's own plan carries its popularity list)."""
        have = {s["item"] for s in partial}
        out = list(partial)
        for fb in self._plan_for(arm).fallback:
            if len(out) >= num:
                break
            if fb["item"] in have or fb["item"] in black:
                continue
            out.append({"item": fb["item"], "score": fb["score"],
                        "fallback": True})
        return {"itemScores": out, "degraded": True,
                "degradedReason": reason}

    def _fallback(self, num: int, black: set, reason: str,
                  arm: str = ARM_ACTIVE) -> dict:
        return self._blend([], num, black, reason, arm=arm)

    # -- guarded rollout (pio_tpu_torch/rollout/) ----------------------------------
    def rollout_active_instance_id(self) -> str:
        with self._lock:
            return self.plan.instance_id

    def _fan_control(self, op: str, path: str, body: dict) -> dict:
        """Fan a candidate-control RPC to EVERY replica concurrently on
        the query pool (per-replica breaker + ambient Deadline + the
        fleet.shard<i>.<op> chaos family, like every other shard RPC) —
        staging a candidate on N×R replicas pays one blob-load
        wall-clock, not N×R serial ones, and a breach-triggered
        rollback's drop fan doesn't hold the observing request thread
        for the serial sum. Returns
        {shard: {"ok": n_replicas_ok, "errors": [...]}}."""
        import contextvars

        key = self.config.server_key

        def one(s: int, r: int, rep) -> str | None:
            Deadline.check(f"shard {s} {op} replica {r}")
            try:
                chaos.maybe_inject(
                    f"{self.config.chaos_prefix}.shard{s}.{op}")
                with rep.breaker.guard():
                    rep.client.request(
                        "POST", path, body,
                        params={"accessKey": key} if key else None)
                return None
            except (CircuitOpenError, HttpClientError,
                    ConnectionError) as e:
                return f"replica{r}: {e}"

        futs = {
            (s, r): self._pool.submit(
                contextvars.copy_context().run, one, s, r, rep)
            for s, group in enumerate(self.replicas)
            for r, rep in enumerate(group)
        }
        out: dict[int, dict] = {
            s: {"ok": 0, "errors": []} for s in range(len(self.replicas))
        }
        for (s, r), f in futs.items():
            err = f.result()
            if err is None:
                out[s]["ok"] += 1
            else:
                out[s]["errors"].append(err)
        return out

    def load_candidate(self, instance_id: str) -> None:
        """Stage the candidate on every shard replica from its
        already-recorded `<iid>:shard<i>` blobs (partitioning them
        first if this instance was never fleet-deployed). EVERY shard
        group needs at least one replica holding the candidate or the
        canary cannot serve its partition — a fully-failed group
        (corrupt blob, group down) unwinds the load and raises, which
        the rollout controller records as an automatic rollback."""
        if self.storage is None:
            raise ValueError(
                "router has no storage; cannot resolve candidate "
                "partitions")
        from pio_tpu_torch.serving_fleet.plan import (
            load_plan, persist_fleet_artifacts,
        )

        plan = load_plan(self.storage, instance_id)
        if plan is None or plan.n_shards != self.plan.n_shards:
            from pio_tpu_torch.serving_fleet.fleet import resolve_fleet_model

            c = self.config
            _, model = resolve_fleet_model(
                self.storage, c.engine_id, c.engine_version,
                c.engine_variant, instance_id)
            plan = persist_fleet_artifacts(
                self.storage, instance_id, model, self.plan.n_shards,
                self.plan.n_replicas)
        results = self._fan_control("load_candidate",
                                    "/shard/load_candidate",
                                    {"instanceId": instance_id})
        failed = {s: g["errors"] for s, g in results.items()
                  if g["ok"] == 0}
        if failed:
            # unwind: replicas that DID load must not keep a half-staged
            # arm around (best-effort — traffic never routed to it)
            self._fan_control("drop_candidate", "/shard/drop_candidate", {})
            raise ConnectionError(
                f"candidate {instance_id} failed to load on shard "
                f"group(s) {sorted(failed)}: {failed}")
        with self._lock:
            self.candidate_plan = plan
        log.info("candidate arm staged fleet-wide: instance %s",
                 instance_id)

    def promote_candidate(self) -> None:
        """Every replica swaps its candidate partition in; the router
        then switches to the candidate plan. A replica that fails keeps
        serving the old instance — visible as instanceSkew — but a
        FULLY-failed group aborts (its partition of the new instance
        would be unreachable). The shard-side swap is IDEMPOTENT
        against the instance id, so retrying `pio promote` after a
        partial failure converges: already-swapped replicas answer
        success, only the stragglers swap."""
        with self._lock:
            plan = self.candidate_plan
        if plan is None:
            raise ValueError("no candidate plan to promote")
        results = self._fan_control(
            "promote_candidate", "/shard/promote_candidate",
            {"instanceId": plan.instance_id})
        failed = {s: g["errors"] for s, g in results.items()
                  if g["ok"] == 0}
        if failed:
            raise ConnectionError(
                f"promote failed on whole shard group(s) "
                f"{sorted(failed)}: {failed}; fleet may be skewed — "
                "retry `pio promote` (idempotent: already-swapped "
                "replicas no-op) or `pio rollback` + POST /reload to "
                "revert every group to the last eligible instance")
        with self._lock:
            self.plan = plan
            self.candidate_plan = None

    def drop_candidate(self) -> None:
        """Rollback: best-effort drop everywhere; the router stops
        stamping candidate arms the instant the plan clears, so a
        replica that misses the drop merely holds a cold partition."""
        with self._lock:
            self.candidate_plan = None
        self._fan_control("drop_candidate", "/shard/drop_candidate", {})

    # -- live elastic resharding (serving_fleet/reshard.py) ------------------
    def add_shard_groups(self, endpoint_groups: list[list[str]]) -> None:
        """Append replica groups for shards JOINING a grow: the replica
        table covers the old and new topology for the whole migration,
        so health probing, dual-writes, and post-swap queries all
        address one table. The table is REPLACED, never mutated in
        place — concurrent readers hold a consistent snapshot."""
        if not endpoint_groups:
            return
        c = self.config
        with self._lock:
            base = len(self.replicas)
        groups = [
            [
                _Replica(
                    url=url,
                    client=_new_client(c, url),
                    breaker=CircuitBreaker(
                        f"shard{base + i}/replica{r}",
                        min_calls=c.breaker_min_calls,
                        failure_rate=c.breaker_failure_rate,
                        open_s=c.breaker_open_s,
                        window_s=c.breaker_window_s,
                    ),
                )
                for r, url in enumerate(urls)
            ]
            for i, urls in enumerate(endpoint_groups)
        ]
        with self._lock:
            self.replicas = self.replicas + groups
            self._preferred = self._preferred + [0] * len(groups)

    def set_reshard_routing(self, moving) -> None:
        """Install the migration's routing state: the move set feeds
        the dual-write fan, the alternate-owner read fallback, and the
        progress gauges. Queries keep riding the OLD plan until
        ``apply_reshard_plan``."""
        with self._lock:
            self.reshard_routing = {
                "moving": {int(p): (int(o), int(n)) for p, o, n in moving},
                "staged": set(),
            }
            self.reshard_partitions_moved = 0
            self.reshard_partitions_pending = len(moving)

    def mark_partition_staged(self, p: int) -> None:
        with self._lock:
            rs = self.reshard_routing
            if rs is None:
                return
            rs["staged"].add(int(p))
            self.reshard_partitions_moved = len(rs["staged"])
            self.reshard_partitions_pending = (
                len(rs["moving"]) - len(rs["staged"]))

    def apply_reshard_plan(self, new_plan: ShardPlan) -> None:
        """The router-side cutover: ONE plan swap under the lock (the
        promote_candidate discipline). New queries plan against v<new>
        and pin it on every RPC — shards that have not activated yet
        answer from their prepared arm, so the swap is safe in either
        order relative to the activate fan. A shrink trims the replica
        table; an in-flight old-plan fan racing the trim degrades (the
        _call_group snapshot), never errors."""
        with self._lock:
            self.plan = new_plan
            self.reshard_routing = None
            self.reshard_partitions_pending = 0
            if len(self.replicas) > new_plan.n_shards:
                self.replicas = self.replicas[:new_plan.n_shards]
                self._preferred = self._preferred[:new_plan.n_shards]

    def clear_reshard_routing(self, trim_to: int | None = None) -> None:
        """Abort path: drop the routing state and any groups added for
        the abandoned grow. The active plan was never swapped, so
        serving is bit-identical to pre-reshard."""
        with self._lock:
            self.reshard_routing = None
            self.reshard_partitions_pending = 0
            self.reshard_partitions_moved = 0
            if trim_to is not None and len(self.replicas) > trim_to:
                self.replicas = self.replicas[:trim_to]
                self._preferred = self._preferred[:trim_to]

    # -- streaming fold-in (pio_tpu_torch/freshness/) ------------------------------
    def upsert_users(self, rows: dict,
                     staleness_s: float | None = None,
                     items: dict | None = None) -> dict:
        """Fan refreshed user rows to EVERY replica of each row's
        owner shard group under the active plan — the same ``owner_of``
        routing queries use, so a fold-in lands exactly where the next
        ``/shard/user_row`` will look. Unlike the query path this is a
        fan-to-ALL, not a failover scan: every replica must hold the
        row or it serves stale until the next fold or /reload. A group
        where NO replica applied lands in ``failedGroups`` (callers —
        ``RouterFleetApplier`` — keep those users pending and retry); a
        partially-applied group stays ok, with the lagging replica
        visible in per-replica results and in ``pio doctor --fleet``'s
        fold-in lag column.

        During a live reshard, rows whose partition is MOVING are
        additionally dual-written to the partition's NEW owner group,
        where they land in the arriving copy (prepared arm, staged
        slice, or the pending queue — shard.upsert_user_rows) so no
        fold-in is lost at the cutover. Dual delivery is best-effort:
        failures are counted under ``reshardDualFailures`` and never
        flip ``ok`` — the old-plan owner stays the durability contract
        until the plan swap (freshness/apply.py).

        ``items`` (item id → row) upserts EXISTING items' factor rows
        plus their two-stage retrieval sidecar (shard.upsert_item_rows).
        Items are index-partitioned — the router has no id→shard map for
        them — so item rows fan to EVERY group and each shard applies
        the subset it owns, rejecting the rest; an item is failed only
        if NO group applied it (``itemsFailed``). Item rejections never
        flip a group's ``ok``: a cross-shard reject is the routing
        working, not a fault. Item upserts land on the ACTIVE partition
        only — during a live reshard, items of a moving partition may
        need a refold after the cutover (users dual-write; items do
        not)."""
        items = items or {}
        with self._lock:
            plan = self.plan
            rs = self.reshard_routing
        replicas = self.replicas
        owners = plan.effective_owners()
        groups: dict[int, dict] = {}
        dual: dict[int, dict] = {}
        for uid, row in rows.items():
            p = partition_of(uid)
            owner = owners[p]
            groups.setdefault(owner, {})[uid] = row
            if rs is not None:
                mv = rs["moving"].get(p)
                if mv is not None and mv[1] != owner:
                    dual.setdefault(mv[1], {})[uid] = row
        if items:
            # every group gets the full item batch (see docstring)
            for s in range(len(replicas)):
                groups.setdefault(s, {})
        key = self.config.server_key
        results: dict[str, dict] = {}
        failed_groups: list[int] = []
        items_landed: set = set()
        for s, group_rows in sorted(groups.items()):
            body: dict = {"users": group_rows}
            if items:
                body["items"] = items
            if staleness_s is not None:
                body["stalenessSeconds"] = staleness_s
            try:
                # same drill point family as the query path: a spec
                # targeting fleet.shard<i> takes this group's applies
                # down from the router's view
                chaos.maybe_inject(
                    f"{self.config.chaos_prefix}.shard{s}.upsert_users")
            except ConnectionError as e:
                failed_groups.append(s)
                results[str(s)] = {"ok": False, "error": str(e)}
                continue
            reps: dict[str, dict] = {}
            ok_replicas = 0
            for r, rep in enumerate(replicas[s] if s < len(replicas)
                                    else ()):
                Deadline.check(f"shard {s} upsert replica {r}")
                try:
                    # same per-replica breaker as the query path: a dead
                    # replica stops eating a full HTTP timeout on every
                    # apply once its breaker opens (half-open re-probes),
                    # and its failures stay visible on /fleet.json and
                    # `pio doctor --fleet`
                    with rep.breaker.guard():
                        out = rep.client.request(
                            "POST", "/shard/upsert_users", body,
                            params={"accessKey": key} if key else None)
                except CircuitOpenError as e:
                    reps[str(r)] = {"ok": False, "error": str(e)}
                    continue
                except HttpClientError as e:
                    reps[str(r)] = {"ok": False, "error": e.message}
                    continue
                rejected = out.get("rejected") or []
                # 200-with-rejections means the shard REFUSED rows (a
                # plan mismatch, e.g. mid-rolling-redeploy): they are
                # NOT servable there, so the replica cannot count
                # toward the group being ok — group "ok" must keep
                # implying "every row of this group landed", or the
                # folder pops users whose rows never applied
                reps[str(r)] = {"ok": not rejected,
                                "applied": out.get("applied"),
                                "rejected": rejected}
                if items:
                    items_rej = set(out.get("itemsRejected") or ())
                    items_landed.update(
                        i for i in items if i not in items_rej)
                    reps[str(r)]["itemsApplied"] = out.get("itemsApplied")
                if not rejected:
                    ok_replicas += 1
            if ok_replicas == 0:
                failed_groups.append(s)
            results[str(s)] = {"ok": ok_replicas > 0,
                               "fullyApplied":
                                   ok_replicas == len(replicas[s])
                                   if s < len(replicas) else False,
                               "replicas": reps}
        out = {"ok": not failed_groups, "groups": results,
               "failedGroups": failed_groups,
               "engineInstanceId": plan.instance_id}
        if items:
            out["itemsApplied"] = len(items_landed)
            out["itemsFailed"] = sorted(
                (str(i) for i in items if i not in items_landed))
        if rs is not None:
            out["reshardDualFailures"] = self._dual_write(dual, staleness_s,
                                                          key, replicas)
        return out

    def _dual_write(self, dual: dict[int, dict],
                    staleness_s: float | None, key: str,
                    replicas: list[list[_Replica]]) -> int:
        """Best-effort second copy of moving-partition rows on their NEW
        owner group (see upsert_users). Returns the count of failed
        per-replica deliveries — reported, never fatal."""
        failures = 0
        for s, dual_rows in sorted(dual.items()):
            body: dict = {"users": dual_rows}
            if staleness_s is not None:
                body["stalenessSeconds"] = staleness_s
            group = replicas[s] if s < len(replicas) else ()
            if not group:
                failures += 1
                continue
            for r, rep in enumerate(group):
                Deadline.check(f"shard {s} dual-write replica {r}")
                try:
                    with rep.breaker.guard():
                        rep.client.request(
                            "POST", "/shard/upsert_users", body,
                            params={"accessKey": key} if key else None)
                except (CircuitOpenError, HttpClientError) as e:
                    failures += 1
                    log.warning("reshard dual-write of %d row(s) to "
                                "shard %d replica %d failed: %s",
                                len(dual_rows), s, r, e)
        if failures:
            with self._lock:
                self.reshard_dual_failures += failures
        return failures

    def query_batch(self, queries: list[dict]) -> list[dict]:
        if self._coalescer is None or len(queries) <= 1:
            # sequential on purpose: each query already fans across
            # shards on the router pool; nesting batch-level fan-out on
            # the same pool could deadlock it against its own children
            return [self.query(q) for q in queries]
        # with the coalescer on, run the queries concurrently on a
        # DEDICATED pool (never the fan pool — see above) so their
        # scoring RPCs arrive inside the same coalesce window and merge
        # into batched frames; copy_context carries the ambient
        # Deadline/tenant into the workers
        import contextvars

        with self._lock:
            if self._batch_pool is None:
                self._batch_pool = ThreadPoolExecutor(
                    max_workers=min(32, max(4,
                                            self.config.coalesce_max_batch)),
                    thread_name_prefix="router-batch")
            pool = self._batch_pool
        futs = [pool.submit(contextvars.copy_context().run, self.query,
                            q)
                for q in queries]
        return [f.result() for f in futs]

    # -- health / status ----------------------------------------------------
    def _probe_loop(self) -> None:
        interval = self.config.probe_interval_s
        while not self._stop_requested.wait(timeout=interval):
            for s, group in enumerate(self.replicas):
                for rep in group:
                    try:
                        rep.client.request("GET", "/readyz")
                        info = rep.client.request("GET", "/shard/info")
                        ok = True
                    except HttpClientError:
                        ok, info = False, rep.info
                    with self._lock:
                        rep.healthy = ok
                        rep.last_probe = time.monotonic()
                        rep.info = info or {}

    def shard_health(self) -> dict:
        """Per shard group: replica breaker/health detail + whether at
        least one replica is routable (breaker not open)."""
        from pio_tpu_torch.utils.httpclient import default_pool

        pool = default_pool()
        shards = {}
        for s, group in enumerate(self.replicas):
            reps = []
            routable = 0
            for r, rep in enumerate(group):
                snap = rep.breaker.snapshot()
                if snap.state != "open":
                    routable += 1
                with self._lock:
                    healthy, info = rep.healthy, dict(rep.info)
                # client-side connection-reuse ratio toward this replica
                # (docs/operations.md): ~0 under steady traffic means
                # every RPC re-dialed — a keep-alive-stripping proxy or
                # an idle-timeout shorter than the query cadence,
                # visible here before it becomes a latency page
                hs = pool.host_stats(rep.url)
                dials = hs["opened"] + hs["reused"]
                reps.append({
                    "replica": r, "url": rep.url,
                    "breaker": snap.state,
                    "failureRate": round(snap.failure_rate, 3),
                    "opened": snap.opened_count,
                    "healthy": healthy,
                    "engineInstanceId": info.get("engineInstanceId"),
                    # guarded rollout: which candidate (if any) this
                    # replica has staged — doctor --fleet's coverage
                    "candidateInstanceId": info.get("candidateInstanceId"),
                    # elastic resharding: the plan version this replica
                    # actually serves — `pio doctor --fleet` WARNs when
                    # replicas disagree (a stale-plan replica missed the
                    # activate fan and needs a /reload)
                    "planVersion": info.get("planVersion"),
                    # internal RPC plane (docs/performance.md)
                    "binaryWire": rep.binary_wire,
                    # continuous batching: whether this replica accepts
                    # batched scoring frames (None = not yet probed)
                    "batchWire": rep.batch_wire,
                    "connReuse": (round(hs["reused"] / dials, 3)
                                  if dials else None),
                })
            shards[str(s)] = {
                "ok": routable > 0,
                "routable": routable,
                "replicas": reps,
            }
        return shards

    def fleet_status(self) -> dict:
        shards = self.shard_health()
        instances = {
            rep.get("engineInstanceId")
            for g in shards.values() for rep in g["replicas"]
            if rep.get("engineInstanceId")
        }
        with self._lock:
            degraded, rerouted = self.degraded_count, self.rerouted_count
            candidate_plan = self.candidate_plan
            moved = self.reshard_partitions_moved
            pending = self.reshard_partitions_pending
        rollout = self.rollout
        reshard = self.reshard
        return {
            "plan": {
                "instanceId": self.plan.instance_id,
                "nShards": self.plan.n_shards,
                "nReplicas": self.plan.n_replicas,
                "strategy": self.plan.strategy,
                "planHash": self.plan.plan_hash,
                "planVersion": self.plan.plan_version,
                "userCounts": list(self.plan.user_counts),
                "itemCounts": list(self.plan.item_counts),
            },
            "shards": shards,
            "instanceSkew": len(instances) > 1,
            "degradedResponses": degraded,
            "reroutedCalls": rerouted,
            "startTime": format_time(self.start_time),
            "candidatePlanInstanceId": (candidate_plan.instance_id
                                        if candidate_plan else None),
            "rollout": rollout.status() if rollout is not None else None,
            # elastic resharding: migration progress (what `pio reshard
            # --status` and `pio doctor --fleet` read)
            "reshard": reshard.status() if reshard is not None else None,
            "reshardPartitionsMoved": moved,
            "reshardPartitionsPending": pending,
            # continuous batching (docs/serving.md): coalescer health —
            # what `pio doctor --fleet` renders occupancy/wait from
            "batching": (self._coalescer.stats()
                         if self._coalescer is not None
                         else {"enabled": False}),
        }

    def reload(self) -> dict:
        """Fan /reload to every replica, then re-resolve the newest plan
        for this topology (shards that hit a corrupt blob keep serving
        their last-good partition — the fleet survives, possibly with
        instance skew, which /fleet.json surfaces)."""
        from pio_tpu_torch.serving_fleet.plan import (
            load_plan, partitioned_instances,
        )

        results: dict[str, dict] = {}
        key = self.config.server_key
        for s, group in enumerate(self.replicas):
            for r, rep in enumerate(group):
                try:
                    out = rep.client.request(
                        "POST", "/reload",
                        params={"accessKey": key} if key else None)
                    results[f"shard{s}/replica{r}"] = {
                        "ok": True,
                        "engineInstanceId": out.get("engineInstanceId"),
                    }
                except HttpClientError as e:
                    results[f"shard{s}/replica{r}"] = {
                        "ok": False, "error": e.message,
                    }
        if self.storage is not None:
            c = self.config
            insts = partitioned_instances(
                self.storage, c.engine_id, c.engine_version,
                c.engine_variant, self.plan.n_shards)
            if insts:
                plan = load_plan(self.storage, insts[0].id)
                if plan is not None:
                    with self._lock:
                        self.plan = plan
        return {"replicas": results, "planInstanceId": self.plan.instance_id}

    def close(self) -> None:
        self._stop_requested.set()
        if self.rollout is not None:
            self.rollout.close()
        if self.reshard is not None:
            # stop the migration worker without recording a verdict —
            # an IN_FLIGHT record is exactly what resume keys off
            self.reshard.stop()
        self._pool.shutdown(wait=False)
        if self._batch_pool is not None:
            self._batch_pool.shutdown(wait=False)
        if self._prober is not None:
            self._prober.join(timeout=2)


def build_router_app(router: FleetRouter) -> HttpApp:
    app = HttpApp("fleet-router")
    config = router.config

    def check_server_key(req: Request) -> bool:
        return server_key_ok(req, config.server_key)

    def _budgeted(fn):
        """Same request-edge policy as the single-host server: per-
        request Deadline budget, breaker/deadline failures -> 503 +
        Retry-After (degradation below this layer answers 200)."""
        try:
            if config.request_budget_s > 0:
                with Deadline.budget(config.request_budget_s):
                    return 200, fn()
            return 200, fn()
        except KeyError as e:
            return 400, {"message": f"query missing field {e}"}
        except DeadlineExceeded as e:
            return 503, json_response(
                {"message": f"request budget exhausted: {e}"},
                {"Retry-After": "1"},
            )
        except CircuitOpenError as e:
            return 503, json_response(
                {"message": str(e)},
                {"Retry-After": f"{max(1, round(e.retry_after_s))}"},
            )

    @app.route("GET", r"/")
    def root(req: Request):
        h = router.tracer.histogram("query")
        return 200, {
            "status": "alive",
            "role": "fleet-router",
            "engineInstanceId": router.plan.instance_id,
            "nShards": router.plan.n_shards,
            "nReplicas": router.plan.n_replicas,
            "requestCount": h.count,
            "avgServingSec": round(h.total / h.count, 6) if h.count else 0.0,
            "startTime": format_time(router.start_time),
        }

    @app.route("POST", r"/queries\.json")
    def queries(req: Request):
        try:
            q = req.json()
        except Exception as e:  # noqa: BLE001 - malformed body
            return 400, {"message": f"Invalid query: {e}"}
        if not isinstance(q, dict):
            return 400, {"message": "query must be a JSON object"}
        return _budgeted(lambda: router.query(q))

    @app.route("POST", r"/batch/queries\.json")
    def batch_queries(req: Request):
        try:
            qs = req.json()
        except Exception as e:  # noqa: BLE001 - malformed body
            return 400, {"message": f"Invalid query batch: {e}"}
        if not isinstance(qs, list) or not all(isinstance(q, dict)
                                               for q in qs):
            return 400, {"message": "body must be a JSON array of objects"}
        if not qs:
            return 200, []
        return _budgeted(lambda: router.query_batch(qs))

    @app.route("POST", r"/fleet/upsert_users")
    def fleet_upsert_users(req: Request):
        """Streaming fold-in apply surface (pio_tpu_torch/freshness/):
        ``{"users": {id: [row]}, "items"?: {id: [row]},
        "stalenessSeconds"?: s}``. User rows route to every replica of
        each row's owner shard group; item rows fan to EVERY group
        (index-partitioned — each shard applies the subset it owns).
        Guarded like /reload — it mutates serving state."""
        if not check_server_key(req):
            return 401, {"message": "Invalid accessKey."}
        try:
            body = req.json()
        except Exception as e:  # noqa: BLE001 - malformed body
            return 400, {"message": f"Invalid body: {e}"}
        users = body.get("users") if isinstance(body, dict) else None
        items = body.get("items") if isinstance(body, dict) else None
        if not isinstance(users, dict) and not isinstance(items, dict):
            return 400, {"message": "body must be {\"users\": {id: [row]}}"
                                    " and/or {\"items\": {id: [row]}}"}
        return 200, router.upsert_users(
            users if isinstance(users, dict) else {},
            body.get("stalenessSeconds"),
            items=items if isinstance(items, dict) else None)

    @app.route("GET", r"/fleet\.json")
    def fleet(req: Request):
        return 200, router.fleet_status()

    @app.route("GET", r"/metrics\.json")
    def metrics(req: Request):
        from pio_tpu_torch.utils.httpclient import default_pool

        with router._lock:
            degraded, rerouted = router.degraded_count, router.rerouted_count
            codec_counts = dict(router.rpc_codec_counts)
            reshard = {
                "partitionsMoved": router.reshard_partitions_moved,
                "partitionsPending": router.reshard_partitions_pending,
                "dualWriteFailures": router.reshard_dual_failures,
            }
        out = {
            "startTime": format_time(router.start_time),
            "spans": router.tracer.snapshot(),
            "degradedResponses": degraded,
            "reroutedCalls": rerouted,
            "rpcCodecCounts": codec_counts,
            "reshard": reshard,
            "connPool": default_pool().stats(),
        }
        if router.recorder is not None:
            # slow-trace exemplars: each span's slowest recent trace id,
            # fetchable with `pio trace <id>` for the full fan-out tree
            out["exemplars"] = router.recorder.exemplars()
        return 200, out

    @app.route("GET", r"/metrics")
    def metrics_prometheus(req: Request):
        """Prometheus twin of /metrics.json through the shared renderer
        (uniform `surface` label — docs/observability.md)."""
        from pio_tpu_torch.server.http import RawResponse
        from pio_tpu_torch.utils.httpclient import pool_counters
        from pio_tpu_torch.utils.tracing import (
            PROMETHEUS_CONTENT_TYPE, prometheus_labeled_counter,
            prometheus_text,
        )

        with router._lock:
            degraded, rerouted = router.degraded_count, router.rerouted_count
            codec_counts = dict(router.rpc_codec_counts)
            moved = router.reshard_partitions_moved
            pending = router.reshard_partitions_pending
        labels = {"surface": "router"}
        if router.config.tenant:
            labels["tenant"] = router.config.tenant
        counters = {
            "degraded_responses_total": float(degraded),
            "rerouted_calls_total": float(rerouted),
            "uptime_seconds":
                (utcnow() - router.start_time).total_seconds(),
        }
        counters.update(pool_counters())
        text = prometheus_text(router.tracer.snapshot(), counters,
                               labels=labels)
        text += "\n".join(prometheus_labeled_counter(
            "rpc_requests_total",
            [({**labels, "codec": codec}, float(count))
             for codec, count in sorted(codec_counts.items())])) + "\n"
        # elastic resharding progress gauges (gauges, not counters:
        # pending DECREASES as partitions land) — what the reshard-chaos
        # CI drill scrapes for convergence
        text += "\n".join(prometheus_labeled_counter(
            "reshard_partitions_moved_total", [(labels, float(moved))],
            mtype="gauge")) + "\n"
        text += "\n".join(prometheus_labeled_counter(
            "reshard_partitions_pending_total", [(labels, float(pending))],
            mtype="gauge")) + "\n"
        return 200, RawResponse(text, PROMETHEUS_CONTENT_TYPE)

    # -- live elastic resharding (serving_fleet/reshard.py) ------------------
    @app.route("POST", r"/reshard/begin")
    def reshard_begin(req: Request):
        """Start an N->N' migration: ``{"nShards": N', "endpoints"?:
        [[url, ...], ...], "block"?: bool}`` — endpoint groups for the
        JOINING shards when growing. Answers immediately (the migration
        runs on a controller worker; poll /reshard/status) unless
        ``block`` is true. Guarded: it changes production topology."""
        if not check_server_key(req):
            return 401, {"message": "Invalid accessKey."}
        try:
            body = req.json()
        except Exception as e:  # noqa: BLE001 - malformed body
            return 400, {"message": f"Invalid body: {e}"}
        if not isinstance(body, dict) or "nShards" not in body:
            return 400, {"message": "body must be {\"nShards\": N', "
                                    "\"endpoints\"?: [[url, ...], ...]}"}
        from pio_tpu_torch.serving_fleet.reshard import ReshardController

        ctl = router.reshard
        if ctl is None:
            ctl = ReshardController(router, router.storage,
                                    server_key=config.server_key)
            router.reshard = ctl
        try:
            out = ctl.begin(
                int(body["nShards"]),
                [list(g) for g in body.get("endpoints") or []],
                block=bool(body.get("block", False)))
        except ValueError as e:
            return 409, {"message": str(e)}
        return 200, out

    @app.route("GET", r"/reshard/status")
    def reshard_status(req: Request):
        if not check_server_key(req):
            return 401, {"message": "Invalid accessKey."}
        ctl = router.reshard
        if ctl is None:
            return 200, {"inFlight": False,
                         "planVersion": router.plan.plan_version}
        out = ctl.status()
        out["planVersion"] = router.plan.plan_version
        return 200, out

    @app.route("POST", r"/reshard/abort")
    def reshard_abort(req: Request):
        """Abort the in-flight migration: the old plan was never
        swapped, so serving is restored bit-identical."""
        if not check_server_key(req):
            return 401, {"message": "Invalid accessKey."}
        ctl = router.reshard
        if ctl is None:
            return 409, {"message": "no reshard in flight"}
        try:
            return 200, ctl.abort()
        except ValueError as e:
            return 409, {"message": str(e)}

    @app.route("POST", r"/reload")
    @app.route("GET", r"/reload")  # deprecated alias (docs/serving.md:
    # reload mutates serving state, POST is canonical)
    def reload(req: Request):
        if not check_server_key(req):
            return 401, {"message": "Invalid accessKey."}
        return 200, router.reload()

    @app.route("POST", r"/stop")
    def stop(req: Request):
        if not check_server_key(req):
            return 401, {"message": "Invalid accessKey."}
        router._stop_requested.set()
        return 200, {"message": "Shutting down."}

    def readiness() -> dict:
        """Ready while EVERY shard group has >= 1 routable replica
        (breaker not open). Instance skew across shards is surfaced but
        does not fail readiness — a skewed fleet still serves."""
        checks: dict[str, dict] = {}
        status = router.shard_health()
        for s, g in status.items():
            checks[f"shard:{s}"] = {
                "ok": g["ok"], "routable": g["routable"],
                "replicas": len(g["replicas"]),
            }
        instances = {
            rep.get("engineInstanceId")
            for g in status.values() for rep in g["replicas"]
            if rep.get("engineInstanceId")
        }
        checks["plan"] = {
            "ok": True,
            "instanceId": router.plan.instance_id,
            "planHash": router.plan.plan_hash,
            "planVersion": router.plan.plan_version,
            "instanceSkew": len(instances) > 1,
        }
        # reshard visibility, never a gate — a fleet mid-migration
        # serves every query from a consistent topology by design
        reshard = router.reshard
        if reshard is not None:
            st = reshard.status()
            checks["reshard"] = {
                "ok": True,
                "inFlight": st.get("inFlight", False),
                "verdict": st.get("verdict"),
                "partitionsStaged": st.get("partitionsStaged"),
                "partitionsMoving": st.get("partitionsMoving"),
            }
        # rollout visibility, never a gate (a breached canary already
        # rolled itself back to the active plan)
        rollout = router.rollout
        if rollout is not None:
            st = rollout.status()
            checks["rollout"] = {
                "ok": True,
                "stagePct": st["stagePct"],
                "verdict": st["verdict"],
                "candidateInstanceId": st["candidateInstanceId"],
            }
        checks.update(shedder_check(getattr(app, "transport", None)))
        return checks

    install_health_routes(app, readiness)
    # distributed tracing (pio_tpu_torch/obs/): /debug routes + traced edge
    from pio_tpu_torch.obs.http import install_trace_routes

    app.tracer = router.tracer
    install_trace_routes(app, router.recorder, check_server_key)
    # guarded rollout verbs (pio_tpu_torch/rollout/): same surface as the
    # single-host server, so `pio deploy --canary` / `pio promote` /
    # `pio rollback` speak to either
    install_rollout_routes(app, router, router.storage, check_server_key)
    return app


def create_fleet_router(storage, config: RouterConfig, plan: ShardPlan,
                        endpoints: list[list[str]]):
    """-> (http transport, FleetRouter)."""
    router = FleetRouter(storage, config, plan, endpoints)
    server_cls = AsyncHttpServer if config.backend == "async" else HttpServer
    try:
        http = server_cls(build_router_app(router), host=config.ip,
                          port=config.port)
    except BaseException:
        router.close()   # bind failed: stop the prober/pool we started
        raise
    return http, router
