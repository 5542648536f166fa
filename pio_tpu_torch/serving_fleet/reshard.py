"""Live elastic resharding: grow/shrink the serving fleet with zero
downtime (docs/serving.md "Elastic resharding").

The ``ReshardController`` drives an N->N' topology change against a
running fleet the way the rollout controller drives a canary — a
durable state machine whose every transition is persisted BEFORE it
takes effect, so a crash at any instruction leaves the fleet serving
one consistent topology:

  1. **Plan.** ``compute_reshard_owners`` produces the successor
     partition->shard map (minimal movement, deterministic);
     ``plan_diff`` is the move set. An ``IN_FLIGHT`` ``ReshardRecord``
     lands at ``<instance>:reshardplan`` through the rollout state
     machine's shared transition writer (rollout/state.save_transition)
     before anything moves.
  2. **Transfer.** Each moving partition is extracted from a source
     replica as a CRC32C-framed kind-5 blob (rpcwire.py) over the
     pooled binary RPC plane and staged on EVERY replica of its new
     owner. Transfers are per-partition resumable: the record's
     ``staged`` set advances durably after each landing, and a
     controller restart re-begins from it. A fully-dead source group
     falls back to rebuilding the slice from the old generation's
     durable partition blob — a SIGKILLed shard cannot strand its
     partitions.
  3. **Prepare.** Every new-topology shard merges residents + staged
     slices into a SECOND arm and persists the versioned blob
     (shard.prepare_reshard) — serving stays on the old partition.
  4. **Cutover.** ``save_plan`` flips the durable plan (THE commit
     point), the record transitions to ``COMMITTED``, the router swaps
     plans atomically (``apply_reshard_plan``), and the activate fan
     retires the old arms. Queries pin their topology per-RPC
     (``X-Pio-Plan-Version``), so the swap is correct in either order
     relative to activation and in-flight old-plan fans complete
     against retired arms — zero 5xx.

Abort (operator ``pio reshard --abort`` or any pre-commit failure)
records ``ABORTED``, drops the shard epochs, and clears the router's
routing state; the active plan and partitions were never touched, so
serving is restored bit-identical to pre-reshard. Chaos points
``reshard.transfer`` (before each partition's transfer attempt) and
``reshard.cutover`` (before the durable flip) let drills fail exactly
those edges (docs/resilience.md).
"""

from __future__ import annotations

import json
import logging
import threading
from dataclasses import asdict, dataclass

from pio_tpu_torch.resilience import RetryPolicy, is_transient
from pio_tpu_torch.resilience import chaos
from pio_tpu_torch.rollout.state import save_transition
from pio_tpu_torch.serving_fleet import rpcwire
from pio_tpu_torch.serving_fleet.plan import (
    N_PARTITIONS, compute_reshard_owners, load_partition, plan_diff,
    resharded_plan, save_plan, slice_partition,
)
from pio_tpu_torch.utils.durable import ModelIntegrityError, unframe
from pio_tpu_torch.utils.httpclient import HttpClientError

log = logging.getLogger("pio_tpu_torch.fleet.reshard")

VERDICT_IN_FLIGHT = "IN_FLIGHT"
VERDICT_COMMITTED = "COMMITTED"
VERDICT_ABORTED = "ABORTED"

# per-step retry: transfers and control fans ride the same policy shape
# the storage layer uses — jittered backoff, deadline-capped, fail-fast
# on declared outages. Short, because every step is also resumable.
RESHARD_RETRY = RetryPolicy(attempts=3, base_delay_s=0.05, max_delay_s=0.5)


def reshard_model_id(instance_id: str) -> str:
    return f"{instance_id}:reshardplan"


@dataclass
class ReshardRecord:
    """One migration's durable state (see module docstring)."""

    instance_id: str
    plan_version_old: int
    plan_version_new: int
    n_shards_old: int
    n_shards_new: int
    owners_old: tuple[int, ...]
    owners_new: tuple[int, ...]
    moving: tuple[tuple[int, int, int], ...]  # (partition, from, to)
    staged: tuple[int, ...] = ()              # partitions landed so far
    verdict: str = VERDICT_IN_FLIGHT
    reason: str = ""
    updated: str = ""                         # stamped by save_transition

    def to_json(self) -> str:
        return json.dumps(asdict(self), sort_keys=True)

    @staticmethod
    def from_json(text: str) -> "ReshardRecord":
        d = json.loads(text)
        return ReshardRecord(
            instance_id=d["instance_id"],
            plan_version_old=int(d["plan_version_old"]),
            plan_version_new=int(d["plan_version_new"]),
            n_shards_old=int(d["n_shards_old"]),
            n_shards_new=int(d["n_shards_new"]),
            owners_old=tuple(int(o) for o in d["owners_old"]),
            owners_new=tuple(int(o) for o in d["owners_new"]),
            moving=tuple(tuple(int(x) for x in m) for m in d["moving"]),
            staged=tuple(int(p) for p in d.get("staged", ())),
            verdict=d.get("verdict", VERDICT_IN_FLIGHT),
            reason=d.get("reason", ""),
            updated=d.get("updated", ""),
        )


def save_reshard_record(storage, record: ReshardRecord) -> ReshardRecord:
    """Persist a transition through the shared writer (stamps
    ``updated``, CRC32C-frames, upserts) — the same durability
    discipline rollout records use."""
    return save_transition(storage, reshard_model_id(record.instance_id),
                           record)


def load_reshard_record(storage, instance_id: str) -> ReshardRecord | None:
    """The instance's reshard record, or None when it was never
    resharded. Raises ModelIntegrityError on a corrupt blob."""
    rec = storage.get_model_data_models().get(reshard_model_id(instance_id))
    if rec is None:
        return None
    return ReshardRecord.from_json(
        unframe(rec.models, source=reshard_model_id(instance_id))
        .decode("utf-8"))


class _Aborted(Exception):
    """Internal: the operator (or close) asked the worker to stop."""


class ReshardController:
    """Drives one migration against a live FleetRouter (see module
    docstring). One controller per router; one migration at a time."""

    def __init__(self, router, storage, server_key: str = ""):
        if storage is None:
            raise ValueError("reshard needs the router's MODELDATA "
                             "storage for durable records and blobs")
        self.router = router
        self.storage = storage
        self.server_key = server_key
        self._lock = threading.Lock()
        self._record: ReshardRecord | None = None
        self._worker: threading.Thread | None = None
        self._abort = threading.Event()

    # -- public surface ------------------------------------------------------
    def in_flight(self) -> bool:
        with self._lock:
            rec = self._record
        return rec is not None and rec.verdict == VERDICT_IN_FLIGHT

    def begin(self, n_new: int, endpoint_groups: list[list[str]] | None
              = None, block: bool = False) -> dict:
        """Validate, persist the IN_FLIGHT record, install the router's
        routing state, and start the migration worker (or run it inline
        with ``block=True`` — tests and scripted drills). Raises
        ValueError on anything refusable: a migration or rollout already
        in flight, a bad shard count, or missing endpoints for a grow."""
        router = self.router
        if n_new < 1 or n_new > N_PARTITIONS:
            raise ValueError(
                f"nShards must be in [1, {N_PARTITIONS}] (one shard "
                f"owns at least one virtual partition), got {n_new}")
        if self.in_flight():
            raise ValueError("a reshard is already in flight; abort it "
                             "first (pio reshard --abort) or wait")
        with router._lock:
            candidate = router.candidate_plan
        if candidate is not None:
            raise ValueError(
                f"a rollout of instance {candidate.instance_id} is in "
                "flight; promote or roll it back before resharding")
        old_plan = router.plan
        old_owners = old_plan.effective_owners()
        new_owners = compute_reshard_owners(old_owners, n_new)
        moving = plan_diff(old_owners, new_owners)
        if not moving and n_new == old_plan.n_shards:
            return {"inFlight": False, "noop": True,
                    "planVersion": old_plan.plan_version,
                    "nShards": old_plan.n_shards,
                    "message": f"fleet already at {n_new} shard(s) with "
                               "a balanced owners map"}
        groups = [list(g) for g in (endpoint_groups or [])]
        have = len(router.replicas)
        need = max(n_new, old_plan.n_shards)
        if have + len(groups) < need:
            raise ValueError(
                f"growing to {n_new} shards needs endpoint groups for "
                f"shard(s) {list(range(have, need))}; got {len(groups)}")
        rec = ReshardRecord(
            instance_id=old_plan.instance_id,
            plan_version_old=old_plan.plan_version,
            plan_version_new=old_plan.plan_version + 1,
            n_shards_old=old_plan.n_shards,
            n_shards_new=n_new,
            owners_old=tuple(old_owners),
            owners_new=new_owners,
            moving=moving,
        )
        # resume: a prior run of the SAME migration (controller/router
        # restarted mid-transfer) donates its staged set — stage is
        # idempotent shard-side, so a stale entry restages harmlessly
        try:
            prior = load_reshard_record(self.storage, rec.instance_id)
        except ModelIntegrityError as e:
            log.warning("corrupt reshard record for %s (%s); starting "
                        "the migration from scratch", rec.instance_id, e)
            prior = None
        if (prior is not None and prior.verdict == VERDICT_IN_FLIGHT
                and prior.owners_new == rec.owners_new
                and prior.plan_version_new == rec.plan_version_new):
            rec.staged = prior.staged
            log.info("resuming reshard of %s: %d/%d partition(s) "
                     "already staged", rec.instance_id, len(rec.staged),
                     len(rec.moving))
        save_reshard_record(self.storage, rec)
        router.add_shard_groups(groups)
        router.set_reshard_routing(rec.moving)
        for p in rec.staged:
            router.mark_partition_staged(p)
        with self._lock:
            self._record = rec
            self._abort.clear()
        if block:
            self._run()
        else:
            # pio: lint-ok[context-loss] deliberate detach: the
            # migration worker is controller-lifetime work with no
            # originating request — begin answers immediately and
            # /reshard/status follows the progress
            self._worker = threading.Thread(
                target=self._run, name="fleet-reshard", daemon=True)
            self._worker.start()
        return self.status()

    def abort(self) -> dict:
        """Operator abort: stop the worker and restore the old plan's
        reign (it never stopped — nothing the migration did touched an
        active arm). Raises ValueError when nothing is in flight."""
        with self._lock:
            rec = self._record
            worker = self._worker
        if rec is None or rec.verdict != VERDICT_IN_FLIGHT:
            raise ValueError("no reshard in flight")
        self._abort.set()
        if (worker is not None and worker.is_alive()
                and worker is not threading.current_thread()):
            worker.join(timeout=15)
        # a dead/wedged worker can't run its own cleanup — do it here
        # (idempotent: _finish_abort no-ops once the verdict moved)
        self._finish_abort("operator abort")
        return self.status()

    def stop(self) -> None:
        """Router shutdown: stop the worker WITHOUT recording a verdict
        — an IN_FLIGHT record is exactly what resume keys off."""
        self._abort.set()

    def status(self) -> dict:
        with self._lock:
            rec = self._record
        if rec is None:
            return {"inFlight": False}
        staged = set(rec.staged)
        in_flight = rec.verdict == VERDICT_IN_FLIGHT
        return {
            "inFlight": in_flight,
            "verdict": rec.verdict,
            "reason": rec.reason,
            "instanceId": rec.instance_id,
            "planVersionOld": rec.plan_version_old,
            "planVersionNew": rec.plan_version_new,
            "nShardsOld": rec.n_shards_old,
            "nShardsNew": rec.n_shards_new,
            "partitionsMoving": len(rec.moving),
            "partitionsStaged": len(staged),
            "partitionsPending": (len(rec.moving) - len(staged)
                                  if in_flight else 0),
            "moves": [
                {"partition": p, "from": o, "to": n, "staged": p in staged}
                for p, o, n in rec.moving
            ],
            "updated": rec.updated,
        }

    # -- migration worker ----------------------------------------------------
    def _run(self) -> None:
        try:
            self._migrate()
        except _Aborted:
            self._finish_abort("operator abort")
        except Exception as e:  # noqa: BLE001 - any pre-commit failure
            # converges to a clean abort: old plan intact, zero 5xx
            if self._committed():
                # post-commit failures (a straggling activate fan) are
                # NOT abortable — the durable plan already flipped;
                # stale replicas converge on their next /reload
                log.error("reshard post-commit step failed: %s — the "
                          "new plan is live; stale replicas converge "
                          "via /reload", e)
                return
            log.error("reshard migration failed: %s; aborting back to "
                      "the old plan", e)
            self._finish_abort(f"migration failed: {e}")

    def _committed(self) -> bool:
        with self._lock:
            rec = self._record
        return rec is not None and rec.verdict == VERDICT_COMMITTED

    def _check_abort(self) -> None:
        if self._abort.is_set():
            raise _Aborted()

    def _migrate(self) -> None:
        router, storage = self.router, self.storage
        with self._lock:
            rec = self._record
        old_plan = router.plan
        pv = rec.plan_version_new
        # 1) open the epoch on every new-topology group — receivers
        # learn their incoming set, pure senders still need the epoch
        # for prepare. Old-only groups (a shrink's retirees) stay out:
        # they keep serving the old topology until decommissioned.
        incoming: dict[int, list[int]] = {
            s: [] for s in range(rec.n_shards_new)}
        for p, _, dst in rec.moving:
            incoming.setdefault(dst, []).append(p)
        for s in sorted(incoming):
            self._check_abort()
            RESHARD_RETRY.call(
                self._fan_group, s, "/shard/begin_reshard",
                {"instanceId": rec.instance_id, "planVersion": pv,
                 "newOwners": list(rec.owners_new),
                 "nShardsNew": rec.n_shards_new,
                 "incoming": sorted(incoming[s])},
                retry_if=is_transient)
        # 2) per-partition transfer, durably resumable
        done = set(rec.staged)
        for p, src, dst in rec.moving:
            self._check_abort()
            if p in done:
                continue
            RESHARD_RETRY.call(self._transfer_once, rec, p, src, dst,
                               retry_if=is_transient)
            done.add(p)
            with self._lock:
                rec.staged = tuple(sorted(done))
            save_reshard_record(storage, rec)
            router.mark_partition_staged(p)
            log.info("reshard: partition %d landed on shard %d "
                     "(%d/%d)", p, dst, len(done), len(rec.moving))
        # 3) prepare: every new-topology shard builds + persists its
        # successor partition as a second arm; the per-shard counts
        # come back for the successor plan record
        users = [0] * rec.n_shards_new
        items = [0] * rec.n_shards_new
        for s in range(rec.n_shards_new):
            self._check_abort()
            out = RESHARD_RETRY.call(
                self._fan_group, s, "/shard/prepare_reshard",
                {"planVersion": pv}, retry_if=is_transient)
            users[s] = int(out.get("users", 0))
            items[s] = int(out.get("items", 0))
        # 4) durable cutover — THE commit point. A crash one
        # instruction before save_plan leaves the old plan (and its
        # still-present blobs) fully in charge.
        self._check_abort()
        chaos.maybe_inject("reshard.cutover")
        self._check_abort()   # last exit before the durable flip
        new_plan = resharded_plan(old_plan, rec.owners_new,
                                  rec.n_shards_new, tuple(users),
                                  tuple(items))
        save_plan(storage, new_plan)
        with self._lock:
            rec.verdict = VERDICT_COMMITTED
            rec.reason = (f"resharded {rec.n_shards_old} -> "
                          f"{rec.n_shards_new} shard(s), "
                          f"{len(rec.moving)} partition(s) moved")
        save_reshard_record(storage, rec)
        # 5) router cutover: new queries plan against v<pv> and pin it;
        # un-activated replicas answer from their prepared arm
        router.apply_reshard_plan(new_plan)
        # 6) activate: pointer swap everywhere; old arms retire so
        # in-flight old-plan fans still complete. Idempotent and
        # best-effort per group — the plan is already live, a replica
        # that misses the fan serves the prepared arm until /reload.
        for s in range(rec.n_shards_new):
            try:
                RESHARD_RETRY.call(
                    self._fan_group, s, "/shard/activate_reshard",
                    {"planVersion": pv}, retry_if=is_transient)
            except (ConnectionError, HttpClientError) as e:
                log.warning("activate fan to shard %d failed (%s); its "
                            "replicas serve the prepared arm until the "
                            "next /reload", s, e)
        log.info("reshard committed: plan v%d, %d shard(s)",
                 new_plan.plan_version, new_plan.n_shards)

    def _transfer_once(self, rec: ReshardRecord, p: int, src: int,
                       dst: int) -> None:
        """One attempt at moving partition ``p``: extract (replica
        failover, storage-blob fallback) then stage on every replica of
        the new owner. Wrapped in RESHARD_RETRY by the caller."""
        self._check_abort()
        # drill point: fail exactly one partition's transfer attempt —
        # the retry/resume machinery absorbs it (docs/resilience.md)
        chaos.maybe_inject("reshard.transfer")
        data = self._extract(rec, p, src)
        with self.router.tracer.span("reshard.transfer", partition=p,
                                     source=src, dest=dst,
                                     bytes=len(data)):
            self._stage(rec, p, dst, data)

    def _extract(self, rec: ReshardRecord, p: int, src: int) -> bytes:
        """Partition ``p`` as a kind-5 frame, from any live source
        replica — or rebuilt from the old generation's durable blob
        when the whole source group is gone (the SIGKILL drill)."""
        router = self.router
        replicas = router.replicas
        errors: list[str] = []
        for rep in (replicas[src] if src < len(replicas) else ()):
            try:
                out = rep.client.request(
                    "POST", "/shard/extract_partition", {"p": int(p)},
                    params=self._params(),
                    accept=rpcwire.RPC_CONTENT_TYPE)
            except HttpClientError as e:
                errors.append(f"{rep.url}: {e.message}")
                continue
            if isinstance(out, (bytes, bytearray)):
                return bytes(out)
            errors.append(f"{rep.url}: non-binary extract answer")
        log.warning(
            "reshard: partition %d unreachable on every replica of "
            "source shard %d (%s); rebuilding the slice from the "
            "durable partition blob", p, src, "; ".join(errors))
        part = load_partition(self.storage, rec.instance_id, src,
                              rec.plan_version_old)
        if part is None:
            raise ConnectionError(
                f"partition {p}: source shard {src} is down and no "
                f"durable blob exists for instance {rec.instance_id} "
                f"plan v{rec.plan_version_old}")
        return rpcwire.encode_partition_slice(slice_partition(part, p))

    def _stage(self, rec: ReshardRecord, p: int, dst: int,
               data: bytes) -> None:
        router = self.router
        replicas = router.replicas
        group = replicas[dst] if dst < len(replicas) else ()
        ok = 0
        errors: list[str] = []
        for rep in group:
            try:
                rep.client.request(
                    "POST", "/shard/stage_partition", raw=data,
                    content_type=rpcwire.RPC_CONTENT_TYPE,
                    params=self._params())
                ok += 1
            except HttpClientError as e:
                errors.append(f"{rep.url}: {e.message}")
        if ok == 0:
            raise ConnectionError(
                f"partition {p}: no replica of destination shard {dst} "
                f"accepted the slice: {'; '.join(errors) or 'no replicas'}")
        if errors:
            # a lagging replica refuses prepare later and converges via
            # /reload — visible, never silent
            log.warning("reshard: partition %d staged on %d/%d "
                        "replica(s) of shard %d (%s)", p, ok,
                        len(group), dst, "; ".join(errors))

    # -- plumbing ------------------------------------------------------------
    def _params(self) -> dict | None:
        return ({"accessKey": self.server_key}
                if self.server_key else None)

    def _fan_group(self, s: int, path: str, body: dict,
                   min_ok: int = 1) -> dict:
        """POST a control RPC to every replica of group ``s`` -> the
        first success's response. Raises ConnectionError when fewer
        than ``min_ok`` replicas accepted (transient to RESHARD_RETRY
        and to is_transient — the fan is idempotent shard-side)."""
        router = self.router
        replicas = router.replicas
        group = replicas[s] if s < len(replicas) else ()
        first: dict | None = None
        ok = 0
        errors: list[str] = []
        for rep in group:
            try:
                out = rep.client.request("POST", path, body,
                                         params=self._params())
            except HttpClientError as e:
                errors.append(f"{rep.url}: {e.message}")
                continue
            ok += 1
            if first is None:
                first = out if isinstance(out, dict) else {}
        if ok < min_ok:
            raise ConnectionError(
                f"{path} reached {ok}/{len(group)} replica(s) of shard "
                f"{s} (need {min_ok}): {'; '.join(errors) or 'no replicas'}")
        return first if first is not None else {}

    def _finish_abort(self, reason: str) -> None:
        """Record ABORTED, drop the shard epochs, clear the router's
        routing state. Idempotent; a COMMITTED migration is never
        abortable (the durable plan already flipped)."""
        router = self.router
        with self._lock:
            rec = self._record
            if rec is None or rec.verdict != VERDICT_IN_FLIGHT:
                return
            rec.verdict = VERDICT_ABORTED
            rec.reason = reason
        try:
            save_reshard_record(self.storage, rec)
        except Exception as e:  # noqa: BLE001 - abort must not raise
            log.error("could not persist the ABORTED reshard record: "
                      "%s (the epoch drop below still restores "
                      "serving)", e)
        for s in range(max(rec.n_shards_new, rec.n_shards_old)):
            try:
                self._fan_group(s, "/shard/abort_reshard", {}, min_ok=0)
            except ConnectionError:  # min_ok=0 never raises; belt-and-
                pass                 # braces against future edits
        router.clear_reshard_routing(trim_to=rec.n_shards_old)
        log.warning("reshard aborted: %s — the old plan (v%d, %d "
                    "shard(s)) was never touched", reason,
                    rec.plan_version_old, rec.n_shards_old)
