"""Shard server: serves ONE partition of the factor tables over RPC.

Each shard process loads only its partition blob (CRC32C-framed, see
plan.py) — never the full model — and answers three RPCs the router
composes into a query:

  POST /shard/user_row   {"user": id}            -> {"found", "row"}
  POST /shard/topk       {"row": [...], "k": n}  -> {"items", "indices",
                                                     "scores"}
  POST /shard/candidates {"row": [...], "k": n}  -> same shape as /topk
  POST /shard/item_rows  {"items": [ids]}        -> {"rows": {id: row}}

``/shard/candidates`` is the two-stage retrieval tier
(ops/retrieval.py): a clustered scan over the quantized item table
picks candidates, the exact oracle einsum re-ranks them. On an
exact-mode shard — or whenever the scan would be exhaustive
(nprobe >= n_clusters) — the route answers from the LITERAL /topk
compute path, so its response is bit-identical to /shard/topk and the
router may fan either op without a parity caveat.

(the whiteList path fetches candidate ROWS and scores router-side — see
``item_rows`` below for why shard-side pair scoring would break
bit-parity).

Scoring reuses the exact single-host kernels (``als.recommend_topk`` /
``als.predict_pairs``) on the local slice, so per-item scores are
bit-identical to the full-table path and the router's
``(-score, global_index)`` merge reproduces the single-host top-k
exactly (``item_gidx`` carries the global dense index). Each arm's item
slice and its clustered sidecar live on the shard's device
(``ShardConfig.device``: CUDA unless the caller asks for the CPU), where
the clustered route's scan is the quantized-scan kernel (K7,
``ops/kernels/quantized_scan.cu``) under ``"impl": "pallas"``.
``/metrics.json`` gives the process's kernel launches
(``kernelLaunches``) beside this shard's scoring dispatches by route
(``scoringDispatches``): shards in one process share the launch counts.

Model lifecycle mirrors workflow/serve.py: ``/reload`` resolves the
latest COMPLETED instance partitioned with this topology and swaps
atomically; a corrupt partition blob (ModelIntegrityError) falls back to
the previous COMPLETED instance's partition — one bad blob on one shard
must never take down the fleet. An optional ``memory_budget_bytes``
makes "loads only its partition" an enforced invariant, not a habit.

Elastic resharding (docs/serving.md "Elastic resharding"): a reshard
epoch opened by ``/shard/begin_reshard`` streams whole virtual
partitions between shards as kind-5 rpcwire frames
(``/shard/extract_partition`` -> ``/shard/stage_partition``);
``/shard/prepare_reshard`` merges the staged slices into a SECOND
partition arm held alongside the active one — the rollout two-arm
discipline — which ``/shard/activate_reshard`` swaps in after the
router has flipped plans. Scoring RPCs address a specific topology via
the ``X-Pio-Plan-Version`` header, so during cutover a replica serves
the old partition to old-plan fans and the prepared one to new-plan
fans, and a mixed-moment fleet still answers every query from exactly
one consistent topology (zero 5xx, oracle bit-parity throughout).

Run standalone (its own host/process) via
``python -m pio_tpu_torch.serving_fleet shard --shard-index I --n-shards N``
with the storage configured by the usual PIO_STORAGE_* environment.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass

import numpy as np

from pio_tpu_torch.resilience.health import (
    breaker_checks, install_health_routes, shedder_check,
)
from pio_tpu_torch.server.http import (
    AsyncHttpServer, HttpApp, HttpServer, Request, server_key_ok,
)
from pio_tpu_torch.serving_fleet import rpcwire
from pio_tpu_torch.serving_fleet.plan import (
    TENANT_HEADER, PartitionSlice, ShardPartition, default_owners,
    load_partition, load_plan, merge_reshard, partition_of,
    partition_to_bytes, partitioned_instances, shard_model_id,
    slice_partition,
)
from pio_tpu_torch.utils.durable import ModelIntegrityError
from pio_tpu_torch.utils.time import format_time, utcnow
from pio_tpu_torch.workflow.context import resolve_device

log = logging.getLogger("pio_tpu_torch.fleet.shard")


class ShardMemoryBudgetExceeded(RuntimeError):
    """The partition does not fit this shard's configured memory budget
    — the deployment needs more shards, not a bigger lie."""


class CandidateArmMissing(RuntimeError):
    """A candidate-arm RPC hit a replica with no candidate loaded. The
    route answers 503 so the router fails over to a replica that has
    it (or degrades the group) instead of silently serving the wrong
    arm."""


class PlanVersionMissing(RuntimeError):
    """A scoring RPC addressed a plan version this replica holds no arm
    for (mid-cutover skew: the prepared arm is not built yet, or the
    retired one was already dropped). 503, same non-breaker-charging
    failover cue as CandidateArmMissing — serving the WRONG topology
    would double-count or drop items in the router's merge."""


@dataclass
class ShardConfig:
    ip: str = "127.0.0.1"
    port: int = 0
    shard_index: int = 0
    n_shards: int = 1
    engine_id: str = ""
    engine_version: str = "1"
    engine_variant: str = "default"
    instance_id: str = ""         # pin an instance; "" = latest partitioned
    server_key: str = ""          # guards /reload and /stop
    # hard cap on partition bytes this shard may hold; 0 = unlimited.
    # Loading enforces it BEFORE swap, so an oversized partition can
    # never evict a serving one.
    memory_budget_bytes: int = 0
    backend: str = "threaded"     # many shards ride one test process
    # grow-path boot: a NEW shard joining a reshard has no partition
    # blob for its topology yet — it boots empty and waits for staged
    # slices instead of failing resolution
    join_reshard: bool = False
    # multi-tenant fleet (serving_fleet/tenancy.py): the tenant triple
    # this shard serves. Non-empty makes the scoring/fold-in/rollout
    # routes VALIDATE the X-Pio-Tenant header against it (421 on
    # mismatch — a mis-routed tenant RPC must fail loudly, never answer
    # from the wrong tenant's partitions) and labels /metrics `tenant=`.
    tenant: str = ""
    # two-stage retrieval (ops/retrieval.py): the engine.json
    # ``retrieval`` block this shard serves under. None/{} = exact mode,
    # which leaves every serving path on the oracle einsum untouched.
    retrieval: dict | None = None
    # the device the arms' item slices and sidecars live on: CUDA unless
    # the caller asks for the CPU (resolve_device raises without CUDA)
    device: str | None = None

    def retrieval_params(self):
        from pio_tpu_torch.ops.retrieval import RetrievalParams

        return RetrievalParams.from_config(self.retrieval)


@dataclass
class _ArmState:
    """One loaded partition + its lookup state. The ACTIVE arm is the
    shard's normal serving state; a guarded rollout (pio_tpu_torch/rollout/)
    loads a CANDIDATE arm alongside it from the candidate instance's
    already-recorded ``<iid>:shard<i>`` blob — no repartitioning, no
    swap until promote."""

    partition: ShardPartition
    item_factors_dev: object
    user_row_of: dict
    item_local_of: dict
    # two-stage retrieval sidecar: (RetrievalIndex, DeviceRetrievalIndex)
    # built beside the f32 partition when the shard runs clustered mode;
    # None on exact-mode shards and empty partitions
    retrieval: object = None


def _empty_answer() -> tuple[list, np.ndarray, np.ndarray]:
    return ([], np.zeros(0, dtype=np.int32), np.zeros(0, dtype=np.float32))


def _slice_with_rows(sl: PartitionSlice, rows: dict) -> PartitionSlice:
    """Copy-on-write user-row upsert into a staged partition slice (the
    dual-write landing path). Raises ValueError on a rank mismatch —
    the caller queues those rows instead."""
    k = int(sl.k)
    if any(len(r) != k for r in rows.values()):
        raise ValueError("fold-in row rank does not match the slice")
    user_ids = list(sl.user_ids)
    user_rows = np.array(sl.user_rows, dtype=np.float32, copy=True)
    at_of = {u: i for i, u in enumerate(user_ids)}
    appended: list[np.ndarray] = []
    for uid, row in rows.items():
        vec = np.asarray(row, dtype=np.float32)
        at = at_of.get(uid)
        if at is not None:
            user_rows[at] = vec
        else:
            at_of[uid] = len(user_ids)
            user_ids.append(uid)
            appended.append(vec)
    if appended:
        user_rows = np.concatenate(
            [user_rows.reshape(-1, k), np.stack(appended)]
        ).astype(np.float32)
    import dataclasses

    return dataclasses.replace(sl, user_ids=user_ids, user_rows=user_rows)


def _arm_with_user_rows(arm: "_ArmState", rows: dict) -> "_ArmState":
    """Copy-on-write user-row upsert into an arm (a reshard's prepared
    arm). Raises ValueError on a rank mismatch."""
    import dataclasses

    part = arm.partition
    k = (int(part.user_rows.shape[1]) if part.user_rows.size
         else int(part.item_rows.shape[1]))
    if any(len(r) != k for r in rows.values()):
        raise ValueError("fold-in row rank does not match the arm")
    user_rows = np.array(part.user_rows, dtype=np.float32, copy=True)
    user_ids = list(part.user_ids)
    row_of = dict(arm.user_row_of)
    appended: list[np.ndarray] = []
    for uid, row in rows.items():
        vec = np.asarray(row, dtype=np.float32)
        at = row_of.get(uid)
        if at is not None:
            user_rows[at] = vec
        else:
            row_of[uid] = len(user_ids)
            user_ids.append(uid)
            appended.append(vec)
    if appended:
        user_rows = np.concatenate(
            [user_rows.reshape(-1, k), np.stack(appended)]
        ).astype(np.float32)
    return dataclasses.replace(
        arm, partition=dataclasses.replace(part, user_ids=user_ids,
                                           user_rows=user_rows),
        user_row_of=row_of)


def _on_device(item_rows, device):
    """The arm's f32 item slice on the shard's device."""
    import torch

    return torch.as_tensor(np.asarray(item_rows, dtype=np.float32)).to(
        device)


def _prepare_arm(part: ShardPartition, rparams, device) -> "_ArmState":
    ret = None
    if (rparams is not None and rparams.mode == "clustered"
            and len(part.item_ids)):
        from pio_tpu_torch.ops import retrieval as rt

        idx = rt.build_index(part.item_rows, rparams)
        ret = (idx, rt.build_device_index(idx, device))
    return _ArmState(
        partition=part,
        item_factors_dev=_on_device(part.item_rows, device),
        user_row_of={u: i for i, u in enumerate(part.user_ids)},
        item_local_of={it: i for i, it in enumerate(part.item_ids)},
        retrieval=ret,
    )


class ShardServer:
    """Partition holder + scorer (the fleet's per-host serving runtime)."""

    def __init__(self, storage, config: ShardConfig):
        self.storage = storage
        self.config = config
        self.start_time = utcnow()
        # distributed tracing (pio_tpu_torch/obs/): shard-local model spans
        # (user_row/topk/item_rows) join the router's trace via the
        # traceparent the RPC carried; the surface name carries the
        # shard index so the merged tree shows WHICH process served
        from pio_tpu_torch.obs import make_recorder
        from pio_tpu_torch.utils.tracing import Tracer

        self.recorder = make_recorder(f"shard{config.shard_index}")
        self.tracer = Tracer(recorder=self.recorder)
        self.device = resolve_device(config.device)
        self._lock = threading.RLock()
        self._load_lock = threading.Lock()
        self._stop_requested = threading.Event()
        self.last_reload_error: str | None = None
        self.partition: ShardPartition | None = None
        self._item_factors_dev = None   # device copy of the item rows
        self._user_row_of: dict[str, int] = {}
        self._item_local_of: dict[str, int] = {}
        # two-stage retrieval: the config block parses AT BOOT so a
        # typo'd knob fails the process loudly, never silently serves
        # exact; the sidecar for the active arm lives beside the
        # partition pointer and swaps with it
        self._rparams = config.retrieval_params()
        self._retrieval = None
        # guarded rollout: candidate partition served alongside the
        # active one (queries carry {"arm": "candidate"} to ride it)
        self.candidate: _ArmState | None = None
        self._candidate_foldin_pending: dict = {}
        # elastic resharding: the serving plan's partition->shard owners
        # map + version (set by _load), the in-flight epoch state, and
        # the retired arm kept after activation so in-flight old-plan
        # fans still complete (dropped on the next load/epoch)
        self.owners: tuple[int, ...] = default_owners(
            max(1, config.n_shards))
        self.plan_version: int = 1
        self._reshard: dict | None = None
        self._retired: tuple[int, _ArmState] | None = None
        # per-codec RPC accounting (docs/performance.md "Internal RPC
        # plane"): how many scoring RPCs answered on the binary wire vs
        # JSON — a fleet stuck on "json" after a rollout is a router
        # downgrade worth investigating, visible on /metrics
        self.rpc_codec_counts = {"binary": 0, "json": 0}
        # device scoring dispatches by route (/metrics.json
        # scoringDispatches): "exact" the recommend_topk product, "scan"
        # the clustered route's candidate_topk, one K7 launch each under
        # "impl": "pallas" on CUDA; an arm's warm dispatch counts too
        self.scoring_dispatches = {"exact": 0, "scan": 0}
        # streaming fold-in accounting (upsert_user_rows): surfaced on
        # /shard/info so `pio doctor --fleet` can compare fold-in lag
        # across shard groups
        self.foldin_applied_users = 0
        self.foldin_applied_items = 0
        self.foldin_last_time = None
        self.foldin_last_staleness_s: float | None = None
        self._load(config.instance_id or None)

    # -- partition lifecycle ------------------------------------------------
    def _candidates(self, instance_id: str | None) -> list[str]:
        if instance_id is not None:
            return [instance_id]
        c = self.config
        insts = partitioned_instances(
            self.storage, c.engine_id, c.engine_version, c.engine_variant,
            c.n_shards,
        )
        if not insts:
            raise ValueError(
                f"no COMPLETED instance of engine {c.engine_id} "
                f"{c.engine_version} {c.engine_variant} has been "
                f"partitioned for {c.n_shards} shards — run "
                "`pio deploy --shards N` (it partitions at deploy time)"
            )
        return [i.id for i in insts]

    def _resolve_partition(self, instance_id: str | None,
                           ) -> tuple[ShardPartition, object]:
        """-> (partition, plan-or-None) with last-good fallback; a
        join-reshard boot that finds no blob for its topology
        synthesises an EMPTY partition on the newest partitioned
        instance and awaits staged slices."""
        part = None
        plan = None
        last_error: Exception | None = None
        try:
            cids = self._candidates(instance_id)
        except ValueError:
            if not self.config.join_reshard:
                raise
            cids = []
        for cid in cids:
            try:
                plan = load_plan(self.storage, cid)
                part = load_partition(
                    self.storage, cid, self.config.shard_index,
                    plan.plan_version if plan is not None else 1)
            except ModelIntegrityError as e:
                log.error(
                    "shard %d partition of instance %s is corrupt "
                    "(%s); trying the previous COMPLETED instance",
                    self.config.shard_index, cid, e,
                )
                last_error = e
                continue
            if part is None:
                last_error = ValueError(
                    f"instance {cid} has no partition blob for shard "
                    f"{self.config.shard_index}"
                )
                continue
            break
        if part is None and self.config.join_reshard:
            iid, plan = self._join_instance(instance_id)
            part = ShardPartition(
                shard_index=self.config.shard_index,
                n_shards=self.config.n_shards,
                instance_id=iid,
                user_ids=[],
                user_rows=np.zeros((0, 0), dtype=np.float32),
                item_ids=[],
                item_gidx=np.zeros(0, dtype=np.int32),
                item_rows=np.zeros((0, 0), dtype=np.float32),
            )
            log.info("shard %d joining reshard of instance %s with an "
                     "empty partition", self.config.shard_index, iid)
        if part is None:
            raise last_error or ValueError("no partition found")
        return part, plan

    def _join_instance(self, instance_id: str | None):
        """Join-reshard boot target: the pinned instance, or the newest
        COMPLETED instance that has a shard plan at all (any topology —
        this shard is not in the old owners map yet)."""
        c = self.config
        if instance_id:
            return instance_id, load_plan(self.storage, instance_id)
        instances = self.storage.get_metadata_engine_instances()
        for inst in instances.get_completed(c.engine_id, c.engine_version,
                                            c.engine_variant):
            plan = load_plan(self.storage, inst.id)
            if plan is not None:
                return inst.id, plan
        raise ValueError(
            f"join-reshard boot: no COMPLETED instance of engine "
            f"{c.engine_id} {c.engine_version} {c.engine_variant} has a "
            "shard plan yet")

    def _sidecar_estimate(self, part: ShardPartition) -> int:
        """Bytes the two-stage retrieval sidecar would add for this
        partition — the small-fix half of the memory-budget contract:
        the budget must charge the f32 partition AND its quantized
        sidecar BEFORE swap, or a clustered shard could pass the check
        and then blow the budget building tables it never accounted."""
        if self._rparams.mode != "clustered" or not len(part.item_ids):
            return 0
        from pio_tpu_torch.ops.retrieval import sidecar_nbytes_estimate

        k = (int(part.item_rows.shape[1])
             if getattr(part.item_rows, "ndim", 0) == 2 else 0)
        return sidecar_nbytes_estimate(len(part.item_ids), k, self._rparams)

    def _enforce_budget_realized(self, part: ShardPartition, arm) -> None:
        """The second half of the budget contract: the estimate rejects
        obvious oversizes BEFORE the k-means build, but a pathologically
        imbalanced clustering can pad the device scan layout past the
        estimate's allowance — so the REALIZED f32 + sidecar bytes are
        re-checked after the build and before any swap."""
        budget = self.config.memory_budget_bytes
        if not budget or arm.retrieval is None:
            return
        idx, didx = arm.retrieval
        need = part.nbytes() + idx.nbytes() + didx.nbytes()
        if need > budget:
            raise ShardMemoryBudgetExceeded(
                f"shard {self.config.shard_index} partition of instance "
                f"{part.instance_id} realized {need} bytes (f32 + built "
                f"retrieval sidecar) over the {budget}-byte budget — "
                "deploy with more shards")

    def _load(self, instance_id: str | None = None) -> None:
        """Resolve + restore + swap, with last-good fallback: a corrupt
        partition blob on the latest instance falls back to the previous
        COMPLETED partitioned instance (explicitly pinned instances do
        not fall back — the operator asked for THAT one). The swap is
        atomic under self._lock; a failed load leaves the serving
        partition untouched."""
        with self._load_lock, self.tracer.span(
                "reload", shard=self.config.shard_index):
            part, plan = self._resolve_partition(instance_id)
            budget = self.config.memory_budget_bytes
            need = part.nbytes() + self._sidecar_estimate(part)
            if budget and need > budget:
                raise ShardMemoryBudgetExceeded(
                    f"shard {self.config.shard_index} partition of "
                    f"instance {part.instance_id} needs {need} "
                    f"bytes (f32 + retrieval sidecar) but the shard's "
                    f"budget is {budget} — deploy with more shards"
                )
            owners = (plan.effective_owners() if plan is not None
                      else default_owners(self.config.n_shards))
            pv = plan.plan_version if plan is not None else 1
            # the blob-load span `pio trace` shows for a migration:
            # which partition landed and how many bytes moved
            with self.tracer.span(
                    "reload.partition", shard=self.config.shard_index,
                    instance=part.instance_id, bytes=part.nbytes()):
                arm = self._ready_arm(part)
                self._enforce_budget_realized(part, arm)
                with self._lock:
                    if self._reshard is not None:
                        log.warning(
                            "shard %d reload drops an in-flight reshard "
                            "epoch (plan %s)", self.config.shard_index,
                            self._reshard["planVersion"])
                    self.partition = part
                    self._item_factors_dev = arm.item_factors_dev
                    self._user_row_of = arm.user_row_of
                    self._item_local_of = arm.item_local_of
                    self._retrieval = arm.retrieval
                    self.owners = owners
                    self.plan_version = pv
                    self._reshard = None
                    self._retired = None
            log.info("shard %d serving instance %s plan v%d (%d users, "
                     "%d items, %d bytes)", self.config.shard_index,
                     part.instance_id, pv, len(part.user_ids),
                     len(part.item_ids), part.nbytes())

    def reload(self) -> str:
        try:
            self._load(None)
        except Exception as e:
            self.last_reload_error = f"{type(e).__name__}: {e}"
            raise
        self.last_reload_error = None
        with self._lock:
            return self.partition.instance_id

    # -- guarded rollout arms (pio_tpu_torch/rollout/) -----------------------------
    def load_candidate(self, instance_id: str) -> None:
        """Load the candidate instance's ALREADY-RECORDED partition blob
        for this shard alongside the active one. No last-good fallback —
        a corrupt candidate blob raises (ModelIntegrityError), which is
        exactly the guard breach the rollout controller rolls back on."""
        with self._load_lock:
            part = load_partition(self.storage, instance_id,
                                  self.config.shard_index)
            if part is None:
                raise ValueError(
                    f"instance {instance_id} has no partition blob for "
                    f"shard {self.config.shard_index} — was it deployed "
                    "with this topology?")
            budget = self.config.memory_budget_bytes
            need = part.nbytes() + self._sidecar_estimate(part)
            if budget and need > budget:
                raise ShardMemoryBudgetExceeded(
                    f"candidate partition of instance {instance_id} needs "
                    f"{need} bytes (f32 + retrieval sidecar) over shard "
                    f"{self.config.shard_index}'s {budget}-byte budget")
            arm = self._ready_arm(part)
            self._enforce_budget_realized(part, arm)
            with self._lock:
                self.candidate = arm
                self._candidate_foldin_pending = {}
        log.info("shard %d candidate arm loaded: instance %s",
                 self.config.shard_index, instance_id)

    def drop_candidate(self) -> None:
        with self._lock:
            self.candidate = None
            self._candidate_foldin_pending = {}

    def promote_candidate(self, expected_instance_id: str | None = None
                          ) -> str:
        """The candidate partition becomes the active one (one pointer
        swap under the lock — the same shape /reload's swap uses).
        Queued candidate fold-ins flush FIRST so the promoted arm is as
        fresh as the active one was (the single-host contract — see
        QueryServer.promote_candidate). IDEMPOTENT against
        ``expected_instance_id``: a replica that already swapped (the
        router retrying a partially-failed promote fan) answers success
        instead of 409, so a retry converges instead of aborting on the
        replicas that succeeded the first time."""
        with self._load_lock:
            with self._lock:
                has_pending = bool(self._candidate_foldin_pending)
            if has_pending:
                left = self._upsert_candidate_rows({})
                if left:
                    log.warning(
                        "shard %d: %d queued candidate fold-in row(s) "
                        "could not apply at promote and are dropped "
                        "(next fold-in cycle re-solves those users)",
                        self.config.shard_index, left)
            with self._lock:
                cand = self.candidate
                if cand is None:
                    if (expected_instance_id is not None
                            and self.partition is not None
                            and self.partition.instance_id
                            == expected_instance_id):
                        return self.partition.instance_id  # already done
                    raise ValueError("no candidate partition to promote")
                if (expected_instance_id is not None
                        and cand.partition.instance_id
                        != expected_instance_id):
                    raise ValueError(
                        f"candidate arm holds instance "
                        f"{cand.partition.instance_id}, promote expected "
                        f"{expected_instance_id}")
                self.partition = cand.partition
                self._item_factors_dev = cand.item_factors_dev
                self._user_row_of = cand.user_row_of
                self._item_local_of = cand.item_local_of
                self._retrieval = cand.retrieval
                self.candidate = None
                self._candidate_foldin_pending = {}
                return self.partition.instance_id

    # -- elastic resharding epoch (docs/serving.md) --------------------------
    def begin_reshard(self, instance_id: str, plan_version: int,
                      new_owners: tuple[int, ...], n_new: int,
                      incoming: list[int]) -> dict:
        """Open a reshard epoch: remember the successor owners map and
        which partitions this shard will RECEIVE. Idempotent for the
        same plan version (the controller retries its fan); a different
        in-flight epoch is refused — one reshard at a time."""
        if len(new_owners) == 0 or n_new < 1:
            raise ValueError("reshard needs a non-empty owners map and "
                             "n_new >= 1")
        with self._lock:
            part = self.partition
            if part is None:
                raise ValueError("shard has no partition loaded")
            if instance_id != part.instance_id:
                raise ValueError(
                    f"reshard targets instance {instance_id} but this "
                    f"shard serves {part.instance_id}")
            if plan_version <= self.plan_version:
                raise ValueError(
                    f"reshard plan version {plan_version} is not newer "
                    f"than the serving plan v{self.plan_version}")
            rs = self._reshard
            if rs is not None and rs["planVersion"] != int(plan_version):
                raise ValueError(
                    f"another reshard (plan v{rs['planVersion']}) is "
                    "already in flight on this shard")
            if rs is None:
                self._reshard = {
                    "planVersion": int(plan_version),
                    "instanceId": instance_id,
                    "newOwners": tuple(int(o) for o in new_owners),
                    "nShardsNew": int(n_new),
                    "incoming": {int(p) for p in incoming},
                    "staged": {},
                    "pending": {},
                    "prepared": None,
                    # rows landed while prepare builds the arm from its
                    # snapshot: applied over the arm when it is set
                    "journal": None,
                }
            self._retired = None    # a new epoch retires the retiree
        return self.reshard_status()

    def extract_partition(self, p: int) -> PartitionSlice:
        """Slice virtual partition ``p`` out of the ACTIVE partition for
        a transfer — the shard keeps serving it until activation, so an
        extract is always safe to retry."""
        with self.tracer.span("reshard.extract",
                              shard=self.config.shard_index, partition=p):
            with self._lock:
                part = self.partition
            if part is None:
                raise ValueError("shard has no partition loaded")
            sl = slice_partition(part, int(p))
            rp = self._rparams
            if rp.mode == "clustered" and len(sl.item_ids):
                # carry the quantized sidecar rows with the slice:
                # encode_rows is a deterministic pure function, so the
                # destination re-encodes and VERIFIES carried == rebuilt
                # (stage_partition) instead of trusting the wire
                import dataclasses

                from pio_tpu_torch.ops.retrieval import encode_rows

                data, scales = encode_rows(sl.item_rows, rp.dtype)
                sl = dataclasses.replace(sl, qdtype=rp.dtype,
                                         item_qrows=data,
                                         item_qscales=scales)
            return sl

    def stage_partition(self, sl: PartitionSlice) -> dict:
        """Land a transferred slice for an incoming partition. Queued
        dual-write fold-ins for that partition are applied OVER the
        slice (they are newer than the extracted blob). Idempotent: a
        resumed transfer restages harmlessly."""
        if sl.qdtype is not None and len(sl.item_ids):
            # quantized-carry verification: re-encode the slice's f32
            # rows (deterministic) and require byte-identity with what
            # the wire carried — a mismatch means the sidecar and the
            # f32 truth diverged somewhere and MUST NOT be staged
            from pio_tpu_torch.ops.retrieval import encode_rows

            data, scales = encode_rows(sl.item_rows, sl.qdtype)
            if not (np.array_equal(data, sl.item_qrows)
                    and np.array_equal(scales, sl.item_qscales)):
                raise ValueError(
                    f"partition {sl.partition} slice carries a quantized "
                    f"sidecar that does not match its f32 rows "
                    f"(dtype {sl.qdtype}) — refusing to stage")
        with self._lock:
            rs = self._reshard
            if rs is None:
                raise ValueError("no reshard epoch open on this shard")
            part = self.partition
            if part is not None and sl.instance_id != part.instance_id:
                raise ValueError(
                    f"slice belongs to instance {sl.instance_id}, shard "
                    f"serves {part.instance_id}")
            if sl.partition not in rs["incoming"]:
                raise ValueError(
                    f"partition {sl.partition} is not incoming on shard "
                    f"{self.config.shard_index}")
            pending = rs["pending"].pop(sl.partition, {})
            if pending:
                try:
                    sl = _slice_with_rows(sl, pending)
                except ValueError:
                    rs["pending"][sl.partition] = pending
            rs["staged"][sl.partition] = sl
            staged = sorted(rs["staged"])
        return {"staged": staged, "partition": sl.partition,
                "bytes": sl.nbytes()}

    def reshard_status(self) -> dict:
        with self._lock:
            rs = self._reshard
            out = {
                "inFlight": rs is not None,
                "planVersion": self.plan_version,
                "retiredPlanVersion": (self._retired[0]
                                       if self._retired else None),
            }
            if rs is not None:
                out.update({
                    "reshardPlanVersion": rs["planVersion"],
                    "incoming": sorted(rs["incoming"]),
                    "staged": sorted(rs["staged"]),
                    "pendingRows": sum(len(v)
                                       for v in rs["pending"].values()),
                    "prepared": rs["prepared"] is not None,
                })
            return out

    def prepare_reshard(self, plan_version: int) -> dict:
        """Build + persist this shard's NEW-topology partition (resident
        entities it keeps + staged slices it gained, items re-sorted by
        global index) and hold it as a second arm. Serving stays on the
        OLD partition: the router flips plans first and addresses this
        arm by plan version until activate swaps it in. Idempotent per
        plan version."""
        from pio_tpu_torch.data.dao import Model

        with self._load_lock:
            with self._lock:
                if plan_version <= self.plan_version:
                    # already activated past it (a retried fan)
                    return {"prepared": True,
                            "planVersion": self.plan_version,
                            "users": len(self.partition.user_ids),
                            "items": len(self.partition.item_ids),
                            "bytes": self.partition.nbytes()}
                rs = self._reshard
                if rs is None or rs["planVersion"] != int(plan_version):
                    raise ValueError(
                        f"no reshard epoch at plan v{plan_version} on "
                        f"shard {self.config.shard_index}")
                if rs["prepared"] is not None:
                    new_part = rs["prepared"].partition
                    return {"prepared": True, "planVersion": plan_version,
                            "users": len(new_part.user_ids),
                            "items": len(new_part.item_ids),
                            "bytes": new_part.nbytes()}
                missing = rs["incoming"] - set(rs["staged"])
                if missing:
                    raise ValueError(
                        f"cannot prepare plan v{plan_version}: partitions "
                        f"{sorted(missing)} are not staged yet")
                part = self.partition
                staged = dict(rs["staged"])
                new_owners = rs["newOwners"]
                n_new = rs["nShardsNew"]
                rs["journal"] = {}
            new_part = merge_reshard(part, staged, new_owners,
                                     self.config.shard_index, n_new)
            budget = self.config.memory_budget_bytes
            need = new_part.nbytes() + self._sidecar_estimate(new_part)
            if budget and need > budget:
                raise ShardMemoryBudgetExceeded(
                    f"resharded partition of instance "
                    f"{new_part.instance_id} needs {need} "
                    f"bytes (f32 + retrieval sidecar) over shard "
                    f"{self.config.shard_index}'s {budget}-byte budget")
            # durable BEFORE the plan flips anywhere: the v<N> blob key
            # is unreferenced until save_plan writes the successor plan
            self.storage.get_model_data_models().insert(Model(
                shard_model_id(new_part.instance_id,
                               self.config.shard_index, int(plan_version)),
                partition_to_bytes(new_part)))
            arm = self._ready_arm(new_part)
            self._enforce_budget_realized(new_part, arm)
            with self._lock:
                rs2 = self._reshard
                if rs2 is not None and rs2["planVersion"] == int(plan_version):
                    # fold-ins acked since the snapshot above, over it
                    journal = rs2["journal"] or {}
                    rs2["journal"] = None
                    k = (int(new_part.user_rows.shape[1])
                         if new_part.user_rows.size
                         else int(new_part.item_rows.shape[1]))
                    journal = {u: r for u, r in journal.items()
                               if len(r) == k}
                    if journal:
                        arm = _arm_with_user_rows(arm, journal)
                    rs2["prepared"] = arm
            return {"prepared": True, "planVersion": int(plan_version),
                    "users": len(new_part.user_ids),
                    "items": len(new_part.item_ids),
                    "bytes": new_part.nbytes()}

    def activate_reshard(self, plan_version: int) -> dict:
        """The prepared arm becomes the active partition (a pointer swap
        under the lock — the /reload discipline); the old arm is kept
        RETIRED so old-plan fans already in flight still complete.
        Idempotent: a replica that already swapped answers success so a
        retried controller fan converges."""
        with self._load_lock, self._lock:
            if self.plan_version >= int(plan_version):
                return {"activated": True,
                        "planVersion": self.plan_version}
            rs = self._reshard
            if (rs is None or rs["planVersion"] != int(plan_version)
                    or rs["prepared"] is None):
                raise ValueError(
                    f"no prepared arm for plan v{plan_version} on shard "
                    f"{self.config.shard_index}")
            old_pv = self.plan_version
            old = _ArmState(
                partition=self.partition,
                item_factors_dev=self._item_factors_dev,
                user_row_of=self._user_row_of,
                item_local_of=self._item_local_of,
                retrieval=self._retrieval)
            arm = rs["prepared"]
            self.partition = arm.partition
            self._item_factors_dev = arm.item_factors_dev
            self._user_row_of = arm.user_row_of
            self._item_local_of = arm.item_local_of
            self._retrieval = arm.retrieval
            self.owners = rs["newOwners"]
            self.plan_version = int(plan_version)
            self.config.n_shards = rs["nShardsNew"]
            self._retired = (old_pv, old)
            self._reshard = None
            return {"activated": True, "planVersion": self.plan_version}

    def abort_reshard(self) -> dict:
        """Drop the epoch: staged slices, pending dual-writes, and the
        prepared arm. The active partition was never touched, so
        serving is bit-identical to pre-reshard. Idempotent."""
        with self._lock:
            was = self._reshard is not None
            self._reshard = None
        return {"aborted": was, "planVersion": self.plan_version}

    def _arm(self, arm: str, plan_version: int | None = None):
        """-> (partition, item_dev, user_row_of, item_local_of) for one
        arm. Unlike the single-host server this does NOT silently fall
        back for a missing candidate: a replica without the candidate
        loaded must 503 so the router fails over, never serve the wrong
        model as if it were the right one. ``plan_version`` (the
        ``X-Pio-Plan-Version`` header) addresses a TOPOLOGY during a
        reshard cutover: the prepared arm answers for the successor
        plan before activation, the retired arm keeps answering the old
        plan just after it — and a version this replica holds no arm
        for 503s rather than serving the wrong partition cut."""
        with self._lock:
            if arm == "candidate":
                c = self.candidate
                if c is None:
                    raise CandidateArmMissing(
                        f"shard {self.config.shard_index} replica has no "
                        "candidate arm loaded")
                return (c.partition, c.item_factors_dev, c.user_row_of,
                        c.item_local_of)
            if (plan_version is not None
                    and plan_version != self.plan_version):
                rs = self._reshard
                if (rs is not None and rs["planVersion"] == plan_version
                        and rs["prepared"] is not None):
                    p = rs["prepared"]
                    return (p.partition, p.item_factors_dev,
                            p.user_row_of, p.item_local_of)
                ret = self._retired
                if ret is not None and ret[0] == plan_version:
                    p = ret[1]
                    return (p.partition, p.item_factors_dev,
                            p.user_row_of, p.item_local_of)
                raise PlanVersionMissing(
                    f"shard {self.config.shard_index} replica serves "
                    f"plan v{self.plan_version}, has no arm for "
                    f"v{plan_version}")
            return (self.partition, self._item_factors_dev,
                    self._user_row_of, self._item_local_of)

    # -- RPC bodies ---------------------------------------------------------
    # Each scoring RPC has an *_arrays variant producing the raw numpy
    # factor/score values — what the binary wire (rpcwire.py) frames
    # directly, and what the JSON routes float()-convert. One compute
    # path under the two codecs, so their values cannot drift.

    def count_rpc(self, codec: str) -> None:
        with self._lock:
            self.rpc_codec_counts[codec] += 1

    def user_row_array(self, user, arm: str = "active",
                       plan_version: int | None = None,
                       ) -> np.ndarray | None:
        with self.tracer.span("user_row",
                              shard=self.config.shard_index, arm=arm):
            part, _, row_of, _ = self._arm(arm, plan_version)
            row = row_of.get(user)
            if row is None:
                if arm == "active":
                    # mid-migration serve-from-new-owner: a user whose
                    # partition was staged here (but not activated yet)
                    # is readable the moment the slice lands
                    return self._reshard_user_row(user)
                return None
            return np.asarray(part.user_rows[row], dtype=np.float32)

    def _reshard_user_row(self, user) -> np.ndarray | None:
        """A staged (or dual-written pending / prepared-arm) user row
        for an INCOMING partition — freshest source first."""
        try:
            p = partition_of(user)
        except Exception:  # noqa: BLE001 - non-string id: unknown user
            return None
        with self._lock:
            rs = self._reshard
            if rs is None or p not in rs["incoming"]:
                return None
            row = rs["pending"].get(p, {}).get(user)
            if row is not None:
                return np.asarray(row, dtype=np.float32)
            prep = rs["prepared"]
            if prep is not None:
                at = prep.user_row_of.get(user)
                if at is not None:
                    return np.asarray(prep.partition.user_rows[at],
                                      dtype=np.float32)
            sl = rs["staged"].get(p)
            if sl is not None and user in sl.user_ids:
                return np.asarray(
                    sl.user_rows[sl.user_ids.index(user)],
                    dtype=np.float32)
        return None

    def user_row(self, user, arm: str = "active",
                 plan_version: int | None = None) -> list[float] | None:
        row = self.user_row_array(user, arm=arm, plan_version=plan_version)
        return None if row is None else [float(x) for x in row]

    def topk_arrays(self, row, k: int, arm: str = "active",
                    plan_version: int | None = None,
                    ) -> tuple[list, np.ndarray, np.ndarray]:
        """Partial top-k of the query user's row against this shard's
        item slice — same kernel as the single-host path, so the
        per-item scores are bit-identical and the router's merge is
        exact. -> (item ids, global indices i32, scores f32). The `topk`
        span IS this shard's model span in the merged trace."""
        with self.tracer.span("topk",
                              shard=self.config.shard_index, arm=arm):
            return self._topk_arrays(row, k, arm, plan_version)

    def _topk_arrays(self, row, k: int, arm: str,
                     plan_version: int | None = None,
                     ) -> tuple[list, np.ndarray, np.ndarray]:
        return self._topk_group(np.asarray(row, dtype=np.float32)[None, :],
                                k, arm, plan_version)[0]

    def topk(self, row: list[float], k: int, arm: str = "active") -> dict:
        items, gidx, scores = self.topk_arrays(row, k, arm=arm)
        return {
            "items": items,
            "indices": [int(g) for g in gidx],
            "scores": [float(s) for s in scores],
        }

    def _retrieval_of(self, arm: str, plan_version: int | None = None):
        """The (RetrievalIndex, DeviceRetrievalIndex) sidecar for one
        arm — the same arm-selection ladder as ``_arm`` (which the
        caller runs FIRST, so missing-arm 503s are raised there and
        this lookup only answers for arms that exist)."""
        with self._lock:
            if arm == "candidate":
                c = self.candidate
                return None if c is None else c.retrieval
            if (plan_version is not None
                    and plan_version != self.plan_version):
                rs = self._reshard
                if (rs is not None and rs["planVersion"] == plan_version
                        and rs["prepared"] is not None):
                    return rs["prepared"].retrieval
                ret = self._retired
                if ret is not None and ret[0] == plan_version:
                    return ret[1].retrieval
                return None
            return self._retrieval

    def candidates_arrays(self, row, k: int, arm: str = "active",
                          plan_version: int | None = None,
                          ) -> tuple[list, np.ndarray, np.ndarray]:
        """Two-stage candidate top-k against this shard's item slice:
        clustered quantized scan -> exact f32 re-rank
        (ops/retrieval.py). The exactness contract: an exact-mode
        shard, a shard with no sidecar for the addressed arm, or an
        EXHAUSTIVE scan (nprobe >= n_clusters) answers from the literal
        ``topk_arrays`` compute path — bit-identical to /shard/topk —
        so the router can fan the candidates op unconditionally."""
        with self.tracer.span("candidates",
                              shard=self.config.shard_index, arm=arm):
            return self._candidates_group(
                np.asarray(row, dtype=np.float32)[None, :], k, arm,
                plan_version)[0]

    def topk_arrays_batch(self, rows, ks: list[int], arm: str = "active",
                          plan_version: int | None = None,
                          ) -> list[tuple[list, np.ndarray, np.ndarray]]:
        """N coalesced queries' partial top-k in ONE device dispatch per
        DISTINCT k (docs/serving.md "Continuous batching"): queries are
        grouped by k because k shapes the compiled program (pow2 k
        bucket) and, on the clustered path, the rerank width — scoring
        everyone at max(k) would change which candidates survive for
        smaller-k queries and break bit-parity with the solo path. The
        serving mix has a handful of distinct k values (num +
        blackList over-fetch), so this stays one-or-few dispatches per
        frame. -> per-query (item ids, global indices i32, scores f32),
        request order."""
        with self.tracer.span("topk", shard=self.config.shard_index,
                              arm=arm, batch=len(ks)):
            return self._scoring_batch(rows, ks, arm, plan_version,
                                       self._topk_group)

    def candidates_arrays_batch(self, rows, ks: list[int],
                                arm: str = "active",
                                plan_version: int | None = None,
                                ) -> list[tuple[list, np.ndarray,
                                                np.ndarray]]:
        """Batched candidate generation — same distinct-k grouping and
        exactness contract as candidates_arrays (exact mode / no sidecar
        / exhaustive scan answer from the literal top-k path)."""
        with self.tracer.span("candidates",
                              shard=self.config.shard_index,
                              arm=arm, batch=len(ks)):
            return self._scoring_batch(rows, ks, arm, plan_version,
                                       self._candidates_group)

    def _scoring_batch(self, rows, ks, arm, plan_version, group_fn):
        mat = np.asarray(rows, dtype=np.float32)
        results: list = [None] * len(ks)
        by_k: dict[int, list[int]] = {}
        for i, k in enumerate(ks):
            by_k.setdefault(int(k), []).append(i)
        for k, idxs in by_k.items():
            for i, res in zip(idxs, group_fn(mat[idxs], k, arm,
                                             plan_version)):
                results[i] = res
        return results

    def _topk_group(self, rows_g: np.ndarray, k: int, arm: str,
                    plan_version: int | None,
                    ) -> list[tuple[list, np.ndarray, np.ndarray]]:
        """One same-k group as one recommend_topk dispatch. The product
        runs at the dispatch rows (``ops.bucketing.dispatch_rows``), so
        row i has the bits of the (1, d) solo dispatch — the same
        contract the single-host batch_predict path is pinned to."""
        part, item_dev, _, _ = self._arm(arm, plan_version)
        return self._exact_group(part, item_dev, rows_g, k)

    def _candidates_group(self, rows_g: np.ndarray, k: int, arm: str,
                          plan_version: int | None,
                          ) -> list[tuple[list, np.ndarray, np.ndarray]]:
        part, item_dev, _, _ = self._arm(arm, plan_version)
        ret = self._retrieval_of(arm, plan_version)
        return self._scan_group(part, item_dev, ret, rows_g, k)

    def _exact_group(self, part: ShardPartition, item_dev, rows_g, k: int,
                     ) -> list[tuple[list, np.ndarray, np.ndarray]]:
        import torch

        from pio_tpu_torch.ops import als

        if len(part.item_ids) == 0:
            return [_empty_answer() for _ in range(len(rows_g))]
        rows = torch.from_numpy(np.array(rows_g, dtype=np.float32)).to(
            item_dev.device)
        scores, idx = als.recommend_topk(
            als.ALSModel(rows, item_dev), np.arange(len(rows_g)), int(k))
        with self._lock:
            self.scoring_dispatches["exact"] += 1
        scores = scores.cpu().numpy()
        idx = idx.cpu().numpy()
        all_gidx = np.asarray(part.item_gidx)
        return [([part.item_ids[i] for i in idx[b]],
                 all_gidx[idx[b]].astype(np.int32), scores[b])
                for b in range(len(rows_g))]

    def _scan_group(self, part: ShardPartition, item_dev, ret, rows_g,
                    k: int) -> list[tuple[list, np.ndarray, np.ndarray]]:
        """The candidate tier for one same-k group: an exact-mode shard,
        an arm without a sidecar or an EXHAUSTIVE scan (nprobe >=
        n_clusters) answers from the exact product, bit-identical to
        /shard/topk; otherwise one ``candidate_topk`` dispatch (K7)."""
        n_local = len(part.item_ids)
        if n_local == 0:
            return [_empty_answer() for _ in range(len(rows_g))]
        rp = self._rparams
        if (ret is None or rp.mode != "clustered"
                or rp.is_exhaustive(n_local)):
            return self._exact_group(part, item_dev, rows_g, k)
        from pio_tpu_torch.ops import retrieval as rt

        _, didx = ret
        scores, lidx = rt.candidate_topk(
            didx, item_dev, np.array(rows_g, dtype=np.float32), int(k))
        with self._lock:
            self.scoring_dispatches["scan"] += 1
        all_gidx = np.asarray(part.item_gidx)
        out = []
        for b in range(len(rows_g)):
            keep = lidx[b] >= 0   # fewer real survivors than k: drop pads
            row_lidx = lidx[b][keep]
            row_scores = np.asarray(scores[b][keep], dtype=np.float32)
            out.append(([part.item_ids[int(i)] for i in row_lidx],
                        all_gidx[row_lidx].astype(np.int32),
                        row_scores))
        return out

    def _ready_arm(self, part: ShardPartition) -> _ArmState:
        """``_prepare_arm`` on this shard's device, then one warm
        dispatch through the route the arm serves (counted in
        ``scoring_dispatches``): the load returns, and /readyz answers,
        only once the sidecar is on the device and the scoring path has
        run, so the router's first fan-out does not time its start."""
        arm = _prepare_arm(part, self._rparams, self.device)
        if len(part.item_ids):
            k = int(arm.item_factors_dev.shape[1])
            self._scan_group(part, arm.item_factors_dev, arm.retrieval,
                             np.zeros((1, k), dtype=np.float32), 1)
        return arm

    def item_rows_arrays(self, items: list, arm: str = "active",
                         plan_version: int | None = None,
                         ) -> tuple[list, np.ndarray]:
        """Factor ROWS for the subset of `items` this shard owns (the
        whiteList path's row-fetch) — (owned ids, f32 row matrix) in
        request order; unowned ids are simply absent, which is how the
        router learns ownership. The ROUTER scores candidates, in one
        einsum with the exact operand shapes the single-host oracle
        uses: per-pair scores computed shard-side in smaller batches
        drift by an ULP (the library's product kernels are
        shape-sensitive),
        which would break bit-parity."""
        with self.tracer.span("item_rows",
                              shard=self.config.shard_index, arm=arm):
            part, _, _, local_of = self._arm(arm, plan_version)
            owned = [(it, local_of[it]) for it in items if it in local_of]
            if not owned:
                k = (int(part.item_rows.shape[1])
                     if getattr(part.item_rows, "ndim", 0) == 2 else 0)
                return [], np.zeros((0, k), dtype=np.float32)
            rows = np.asarray(part.item_rows,
                              dtype=np.float32)[[i for _, i in owned]]
            return [it for it, _ in owned], rows

    def item_rows(self, items: list, arm: str = "active") -> dict:
        ids, rows = self.item_rows_arrays(items, arm=arm)
        return {"rows": {
            it: [float(x) for x in rows[i]] for i, it in enumerate(ids)
        }}

    def upsert_user_rows(self, rows: dict,
                         staleness_s: float | None = None) -> dict:
        """Streaming fold-in apply (pio_tpu_torch/freshness/): replace or
        append user factor rows in THIS shard's partition. Only rows
        this shard OWNS under the plan's owners map are accepted — a
        mis-routed row is rejected loudly (``rejected`` in the result)
        instead of silently shadowing the owner shard's copy — EXCEPT
        rows for partitions this shard is RECEIVING in an in-flight
        reshard: those are the router's dual-writes, landed in the
        staged/prepared arm (or queued until the slice arrives) so the
        new topology is exactly as fresh as the old at activation.
        Last-good semantics: the updated partition is built
        copy-on-write and swapped atomically; the memory budget is
        enforced BEFORE the swap, exactly like /reload."""
        import dataclasses

        with self._lock:
            part = self.partition
            owners = self.owners
            rs = self._reshard
            incoming = set(rs["incoming"]) if rs is not None else set()
        if part is None:
            raise ValueError("shard has no partition loaded")
        k = int(part.user_rows.shape[1]) if part.user_rows.size else (
            int(part.item_rows.shape[1]))
        owned: list[tuple] = []
        rejected: list = []
        moving: dict = {}
        for uid, row in rows.items():
            p = partition_of(uid)
            if owners[p] != self.config.shard_index:
                if p in incoming:
                    moving[uid] = row
                else:
                    rejected.append(uid)
                continue
            if len(row) != k:
                raise ValueError(
                    f"fold-in row for {uid!r} has {len(row)} dims, "
                    f"partition rank is {k}")
            owned.append((uid, row))
        if owned:
            user_rows = np.array(part.user_rows, dtype=np.float32,
                                 copy=True)
            user_ids = list(part.user_ids)
            row_of = dict(self._user_row_of)
            appended: list[np.ndarray] = []
            for uid, row in owned:
                at = row_of.get(uid)
                vec = np.asarray(row, dtype=np.float32)
                if at is not None:
                    user_rows[at] = vec
                else:
                    row_of[uid] = len(user_ids)
                    user_ids.append(uid)
                    appended.append(vec)
            if appended:
                user_rows = np.concatenate(
                    [user_rows.reshape(-1, k),
                     np.stack(appended)]).astype(np.float32)
            new_part = dataclasses.replace(
                part, user_ids=user_ids, user_rows=user_rows)
            budget = self.config.memory_budget_bytes
            if budget and new_part.nbytes() > budget:
                raise ShardMemoryBudgetExceeded(
                    f"fold-in would grow shard {self.config.shard_index} "
                    f"to {new_part.nbytes()} bytes over its "
                    f"{budget}-byte budget — repartition with more shards"
                )
            with self._lock:
                if self.partition is not part:
                    # a /reload swapped instances mid-build: applying
                    # rows solved against the OLD factors onto the new
                    # partition would mix factor spaces
                    raise ValueError(
                        "partition changed during fold-in apply; retry")
                self.partition = new_part
                self._user_row_of = row_of
                self._land_kept_rows(owned)
                self.foldin_applied_users += len(owned)
                self.foldin_last_time = utcnow()
                if staleness_s is not None:
                    self.foldin_last_staleness_s = float(staleness_s)
        # second arm (guarded rollout): best-effort-with-queue, so fleet
        # freshness never silently diverges the experiment; the ACTIVE
        # apply above is the durable one the folder's cursor rides
        queued = self._upsert_candidate_rows(dict(owned))
        # reshard dual-writes: best-effort into the arriving topology
        applied = len(owned)
        reshard_queued = self._apply_reshard_rows(moving) if moving else 0
        if reshard_queued is None:
            # the epoch closed since the rows were sorted: activated,
            # they are this shard's own now; aborted, they are refused
            again = self.upsert_user_rows(moving, staleness_s)
            applied += again["applied"]
            rejected += again["rejected"]
            moving, reshard_queued = {}, 0
        return {"applied": applied, "rejected": rejected,
                "engineInstanceId": part.instance_id,
                "candidateQueued": queued,
                "reshardApplied": len(moving) - reshard_queued,
                "reshardQueued": reshard_queued}

    def upsert_item_rows(self, rows: dict) -> dict:
        """Streaming fold-in for ITEM factor rows: replace rows of items
        this shard already holds, updating the f32 partition, the device
        scoring matrix, AND the two-stage retrieval sidecar (re-encode
        row, reassign cluster against the frozen centroids) in the SAME
        atomic swap — the freshness contract: an upserted item is
        retrievable through the candidate tier the moment the apply
        returns. Unknown item ids are rejected loudly (appending a NEW
        item needs a global dense index, which only a repartition can
        assign without breaking the router's merge order)."""
        import dataclasses

        with self._lock:
            part = self.partition
            ret = self._retrieval
            local_of = dict(self._item_local_of)
        if part is None:
            raise ValueError("shard has no partition loaded")
        k = int(part.item_rows.shape[1]) if part.item_rows.size else (
            int(part.user_rows.shape[1]) if part.user_rows.size else 0)
        owned: list[tuple] = []
        rejected: list = []
        for iid, row in rows.items():
            at = local_of.get(iid)
            if at is None:
                rejected.append(iid)
                continue
            if len(row) != k:
                raise ValueError(
                    f"fold-in item row for {iid!r} has {len(row)} dims, "
                    f"partition rank is {k}")
            owned.append((at, row))
        if owned:
            positions = np.array([at for at, _ in owned], dtype=np.int64)
            new_rows = np.stack([np.asarray(r, dtype=np.float32)
                                 for _, r in owned])
            item_rows = np.array(part.item_rows, dtype=np.float32,
                                 copy=True)
            item_rows[positions] = new_rows
            new_part = dataclasses.replace(part, item_rows=item_rows)
            budget = self.config.memory_budget_bytes
            need = new_part.nbytes() + self._sidecar_estimate(new_part)
            if budget and need > budget:
                raise ShardMemoryBudgetExceeded(
                    f"item fold-in would grow shard "
                    f"{self.config.shard_index} to {need} bytes (f32 + "
                    f"retrieval sidecar) over its {budget}-byte budget")
            new_ret = ret
            if ret is not None:
                from pio_tpu_torch.ops import retrieval as rt

                idx = ret[0].updated(positions, new_rows)
                new_ret = (idx, rt.build_device_index(idx, self.device))
            dev = _on_device(item_rows, self.device)
            with self._lock:
                if self.partition is not part:
                    # a /reload swapped instances mid-build (see
                    # upsert_user_rows): mixing factor spaces is worse
                    # than a retry
                    raise ValueError(
                        "partition changed during fold-in apply; retry")
                self.partition = new_part
                self._item_factors_dev = dev
                self._retrieval = new_ret
                self.foldin_applied_items += len(owned)
                self.foldin_last_time = utcnow()
        return {"applied": len(owned), "rejected": rejected,
                "engineInstanceId": part.instance_id}

    def _land_kept_rows(self, owned: list) -> None:
        """Owned rows this shard keeps in the arriving topology, into the
        prepared arm when it exists, else into the journal of a prepare
        under way (a prepare not yet begun snapshots the active partition,
        which already holds them). Called under ``_lock`` in the same hold
        as the active apply, so no acked row misses the new arm."""
        rs = self._reshard
        if rs is None:
            return
        me = self.config.shard_index
        kept = {uid: row for uid, row in owned
                if rs["newOwners"][partition_of(uid)] == me}
        if not kept:
            return
        if rs["prepared"] is not None:
            rs["prepared"] = _arm_with_user_rows(rs["prepared"], kept)
        elif rs["journal"] is not None:
            rs["journal"].update(kept)

    def _apply_reshard_rows(self, moving: dict) -> int | None:
        """Land dual-written fold-in rows for partitions this shard is
        RECEIVING: into the prepared arm when it exists (so activation
        serves them), else onto the staged slice, else queued until the
        slice arrives (the queue then wins over the transferred blob —
        it is newer); a prepare under way also journals them. Returns
        the rows left queued, or None when no epoch is open any more.
        Never raises — the dual-write is best-effort on top of the
        primary owner's apply, which is the folder's durability
        contract."""
        queued = 0
        with self._lock:
            rs = self._reshard
            if rs is None:
                return None
            by_part: dict[int, dict] = {}
            for uid, row in moving.items():
                by_part.setdefault(partition_of(uid), {})[uid] = row
            prep = rs["prepared"]
            prep_rows: dict = {}
            for p, prows in by_part.items():
                if p not in rs["incoming"]:
                    queued += len(prows)     # mis-addressed: drop count
                    continue
                if prep is not None:
                    prep_rows.update(prows)
                    continue
                if rs["journal"] is not None:
                    rs["journal"].update(prows)
                if p in rs["staged"]:
                    sl = rs["staged"][p]
                    try:
                        rs["staged"][p] = _slice_with_rows(sl, prows)
                    except ValueError:
                        rs["pending"].setdefault(p, {}).update(prows)
                        queued += len(prows)
                else:
                    rs["pending"].setdefault(p, {}).update(prows)
                    queued += len(prows)
            if prep is not None and prep_rows:
                try:
                    rs["prepared"] = _arm_with_user_rows(prep, prep_rows)
                except ValueError:
                    for uid, row in prep_rows.items():
                        rs["pending"].setdefault(
                            partition_of(uid), {})[uid] = row
                    queued += len(prep_rows)
        return queued

    def _upsert_candidate_rows(self, owned: dict) -> int:
        """Apply owned fold-in rows (plus anything queued) to the
        candidate arm; returns the queue depth left (0 = applied).
        Never raises — a canary hiccup must not fail the active apply
        the folder just committed."""
        import dataclasses

        with self._lock:
            cand = self.candidate
            if cand is None:
                self._candidate_foldin_pending = {}
                return 0
            pending = dict(self._candidate_foldin_pending)
            pending.update(owned)
            part = cand.partition
        k = int(part.user_rows.shape[1]) if part.user_rows.size else (
            int(part.item_rows.shape[1]))
        if any(len(r) != k for r in pending.values()):
            with self._lock:
                self._candidate_foldin_pending = pending
            log.warning("fold-in rows queued for shard %d candidate arm "
                        "(%d users): rank mismatch",
                        self.config.shard_index, len(pending))
            return len(pending)
        user_rows = np.array(part.user_rows, dtype=np.float32, copy=True)
        user_ids = list(part.user_ids)
        row_of = dict(cand.user_row_of)
        appended: list[np.ndarray] = []
        for uid, row in pending.items():
            at = row_of.get(uid)
            vec = np.asarray(row, dtype=np.float32)
            if at is not None:
                user_rows[at] = vec
            else:
                row_of[uid] = len(user_ids)
                user_ids.append(uid)
                appended.append(vec)
        if appended:
            user_rows = np.concatenate(
                [user_rows.reshape(-1, k),
                 np.stack(appended)]).astype(np.float32)
        new_part = dataclasses.replace(
            part, user_ids=user_ids, user_rows=user_rows)
        with self._lock:
            cand2 = self.candidate
            if cand2 is None:
                self._candidate_foldin_pending = {}
                return 0
            if cand2.partition is not part:
                # arm moved mid-build (promote/drop/reload-candidate):
                # queue and land on the next apply
                self._candidate_foldin_pending = pending
                return len(pending)
            self.candidate = _ArmState(
                partition=new_part,
                item_factors_dev=cand2.item_factors_dev,
                user_row_of=row_of,
                item_local_of=cand2.item_local_of,
                retrieval=cand2.retrieval)
            self._candidate_foldin_pending = {}
        return 0

    def foldin_status(self) -> dict:
        with self._lock:
            return {
                "appliedUsers": self.foldin_applied_users,
                "appliedItems": self.foldin_applied_items,
                "lastAppliedTime": (format_time(self.foldin_last_time)
                                    if self.foldin_last_time else None),
                "stalenessSeconds": self.foldin_last_staleness_s,
            }

    def _retrieval_info(self, part) -> dict:
        """The /shard/info retrieval block `pio doctor --fleet` renders:
        mode knobs, quantized-sidecar bytes vs the f32 item bytes they
        stand in for, and how many MORE items fit under the memory
        budget at this partition's per-item cost (f32 row + sidecar
        share). Headroom is None on unbudgeted shards."""
        rp = self._rparams
        with self._lock:
            ret = self._retrieval
        qbytes = 0
        if ret is not None:
            qbytes = int(ret[0].nbytes() + ret[1].nbytes())
        f32_item_bytes = int(part.item_rows.nbytes) if part is not None else 0
        budget = self.config.memory_budget_bytes
        headroom = None
        if budget and part is not None:
            n = len(part.item_ids)
            k = (int(part.item_rows.shape[1])
                 if getattr(part.item_rows, "ndim", 0) == 2 else 0)
            if k:
                per_item = k * 4
                est = self._sidecar_estimate(part)
                if n and est:
                    per_item += est // n
                used = part.nbytes() + est
                headroom = max(0, (budget - used) // max(1, per_item))
        return {
            "mode": rp.mode,
            "dtype": rp.dtype,
            "nprobe": rp.nprobe,
            "rerankK": rp.rerank_k,
            # the candidate scan: "pallas" launches K7 on a CUDA shard
            "impl": rp.impl,
            "quantizedBytes": qbytes,
            "f32ItemBytes": f32_item_bytes,
            "itemsHeadroom": headroom,
        }

    def info(self) -> dict:
        with self._lock:
            part = self.partition
            cand = self.candidate
            cand_queued = len(self._candidate_foldin_pending)
            plan_version = self.plan_version
            rs = self._reshard
            reshard = None
            if rs is not None:
                reshard = {
                    "planVersion": rs["planVersion"],
                    "incoming": sorted(rs["incoming"]),
                    "staged": sorted(rs["staged"]),
                    "prepared": rs["prepared"] is not None,
                }
        return {
            "shardIndex": self.config.shard_index,
            "nShards": self.config.n_shards,
            # plan topology version: doctor --fleet WARNs when replicas
            # disagree (a stale-plan replica after a reshard)
            "planVersion": plan_version,
            "reshard": reshard,
            "engineInstanceId": part.instance_id if part else None,
            "users": len(part.user_ids) if part else 0,
            "items": len(part.item_ids) if part else 0,
            "partitionBytes": part.nbytes() if part else 0,
            "memoryBudgetBytes": self.config.memory_budget_bytes,
            # two-stage retrieval: doctor --fleet renders these columns
            # and WARNs when replicas of one group disagree on mode
            "retrieval": self._retrieval_info(part),
            "startTime": format_time(self.start_time),
            "lastReloadError": self.last_reload_error,
            "foldin": self.foldin_status(),
            # guarded rollout: what `pio doctor --fleet` aggregates into
            # the per-group candidate-coverage column
            "candidateInstanceId": (cand.partition.instance_id
                                    if cand else None),
            "candidateFoldinQueued": cand_queued,
        }


def build_shard_app(server: ShardServer) -> HttpApp:
    app = HttpApp(f"shard{server.config.shard_index}")
    config = server.config

    def check_server_key(req: Request) -> bool:
        return server_key_ok(req, config.server_key)

    def _media_type(req: Request, header: str) -> str:
        return (req.header(header) or "").split(";")[0].strip().lower()

    def _binary_accept(req: Request) -> bool:
        """Accept negotiation for the binary RPC wire (rpcwire.py): a
        router that sent Accept: application/x-pio-rpc gets the framed
        f32/int32 body; everyone else keeps JSON. Pre-binary routers
        never send the header, so they are untouched."""
        return _media_type(req, "accept") == rpcwire.RPC_CONTENT_TYPE

    def _binary_response(items, gidx, scores):
        from pio_tpu_torch.server.http import RawResponse

        return 200, RawResponse(
            rpcwire.encode_topk_response(items, gidx, scores),
            rpcwire.RPC_CONTENT_TYPE)

    def _tenant_mismatch(req: Request):
        """The shard half of the X-Pio-Tenant contract: a request that
        NAMES a tenant must name THIS shard's tenant. In a multi-tenant
        pool the host mux routes on the header before this app ever
        sees the request, so a mismatch landing here means the caller's
        placement state is stale or corrupt — 421 (Misdirected Request)
        fails it loudly instead of answering from the wrong tenant's
        partitions. Headerless requests (single-tenant fleets,
        pre-tenant routers) pass untouched."""
        named = req.header(TENANT_HEADER.lower())
        if named and config.tenant and named != config.tenant:
            return 421, {
                "message": f"tenant-mismatch: this shard serves "
                           f"{config.tenant!r}, not {named!r}"}
        return None

    def _plan_version_of(req: Request) -> int | None:
        """The topology a scoring RPC addresses (X-Pio-Plan-Version,
        sent by reshard-aware routers mid-cutover). Absent/garbled =
        the replica's current plan, which is also what pre-reshard
        routers get."""
        h = req.header("x-pio-plan-version")
        if not h:
            return None
        try:
            return int(h)
        except ValueError:
            return None

    @app.route("GET", r"/")
    def root(req: Request):
        return 200, server.info()

    @app.route("GET", r"/shard/info")
    def shard_info(req: Request):
        return 200, server.info()

    @app.route("GET", r"/metrics\.json")
    def metrics_json(req: Request):
        from pio_tpu_torch.ops.kernels import launch_counts

        with server._lock:
            codec_counts = dict(server.rpc_codec_counts)
            dispatches = dict(server.scoring_dispatches)
        out = {
            "startTime": format_time(server.start_time),
            "spans": server.tracer.snapshot(),
            "shardIndex": config.shard_index,
            "foldin": server.foldin_status(),
            "rpcCodecCounts": codec_counts,
            "scoringDispatches": dispatches,
            # the process's launches of each CUDA kernel (the CPU's plain
            # versions count none): shards in one process share them
            "kernelLaunches": launch_counts(),
            "device": str(server.device),
        }
        if server.recorder is not None:
            out["exemplars"] = server.recorder.exemplars()
        return 200, out

    @app.route("GET", r"/metrics")
    def metrics_prometheus(req: Request):
        """Prometheus exposition through the shared renderer with the
        uniform label set: `surface="shard", shard="<i>"` on every
        sample (docs/observability.md), plus the per-codec RPC counters
        and the outbound connection-pool counters (docs/performance.md
        "Internal RPC plane")."""
        from pio_tpu_torch.server.http import RawResponse
        from pio_tpu_torch.utils.httpclient import pool_counters
        from pio_tpu_torch.utils.tracing import (
            PROMETHEUS_CONTENT_TYPE, prometheus_labeled_counter,
            prometheus_text,
        )

        with server._lock:
            part = server.partition
            applied = server.foldin_applied_users
            codec_counts = dict(server.rpc_codec_counts)
        labels = {"surface": "shard", "shard": str(config.shard_index)}
        if config.tenant:
            labels["tenant"] = config.tenant
        counters = {
            "partition_bytes": float(part.nbytes() if part else 0),
            "foldin_applied_users_total": float(applied),
            "uptime_seconds":
                (utcnow() - server.start_time).total_seconds(),
        }
        counters.update(pool_counters())
        text = prometheus_text(server.tracer.snapshot(), counters,
                               labels=labels)
        text += "\n".join(prometheus_labeled_counter(
            "rpc_requests_total",
            [({**labels, "codec": codec}, float(count))
             for codec, count in sorted(codec_counts.items())])) + "\n"
        return 200, RawResponse(text, PROMETHEUS_CONTENT_TYPE)

    def _arm_of(body: dict):
        """The arm a scoring RPC rides ({"arm": "candidate"} during a
        guarded rollout; absent = active). Returns (arm, error)."""
        arm = body.get("arm", "active")
        if arm not in ("active", "candidate"):
            return None, (400, {"message": f"unknown arm {arm!r}"})
        return arm, None

    @app.route("POST", r"/shard/user_row")
    def shard_user_row(req: Request):
        mis = _tenant_mismatch(req)
        if mis:
            return mis
        body = req.json()
        if not isinstance(body, dict) or "user" not in body:
            return 400, {"message": "body must be {\"user\": id}"}
        arm, err = _arm_of(body)
        if err:
            return err
        binary = _binary_accept(req)
        server.count_rpc("binary" if binary else "json")
        # RAW value lookup, no str() coercion: the single-host oracle
        # treats a non-string id as unknown (not in the id index), and
        # the fleet must agree
        try:
            row = server.user_row_array(body["user"], arm=arm,
                                        plan_version=_plan_version_of(req))
        except CandidateArmMissing as e:
            # the "candidate-arm-missing:" prefix is the router's cue to
            # fail over WITHOUT charging this replica's breaker: the
            # replica is healthy, it just has no staged arm
            return 503, {"message": f"candidate-arm-missing: {e}"}
        except PlanVersionMissing as e:
            return 503, {"message": f"plan-version-missing: {e}"}
        if binary:
            from pio_tpu_torch.server.http import RawResponse

            return 200, RawResponse(
                rpcwire.encode_user_row_response(row),
                rpcwire.RPC_CONTENT_TYPE)
        if row is None:
            return 200, {"found": False}
        return 200, {"found": True, "row": [float(x) for x in row]}

    def _scoring_route(req: Request, op: str, solo_fn, batch_fn):
        """Shared body of /shard/topk + /shard/candidates: JSON solo,
        binary solo, and the batched multi-query frame (a coalescing
        router's fan unit — answered from ONE batched device dispatch
        via the *_arrays_batch compute and the batched kind-2 frame).
        Binary request bodies only arrive after this replica confirmed
        the wire with a binary response (router negotiation)."""
        mis = _tenant_mismatch(req)
        if mis:
            return mis
        if _media_type(req, "content-type") == rpcwire.RPC_CONTENT_TYPE:
            try:
                rows, ks, arm, batched = rpcwire.decode_scoring_request(
                    req.body, op)
            except rpcwire.RpcWireError as e:
                return 400, {"message": f"bad rpc frame: {e}"}
            if arm not in ("active", "candidate"):
                return 400, {"message": f"unknown arm {arm!r}"}
            if batched:
                server.count_rpc("binary")
                try:
                    results = batch_fn(rows, ks, arm=arm,
                                       plan_version=_plan_version_of(req))
                except CandidateArmMissing as e:
                    return 503, {"message": f"candidate-arm-missing: {e}"}
                except PlanVersionMissing as e:
                    return 503, {"message": f"plan-version-missing: {e}"}
                from pio_tpu_torch.server.http import RawResponse

                # a batched frame implies a batch-aware binary client:
                # the answer is always the batched kind-2 frame
                return 200, RawResponse(
                    rpcwire.encode_topk_batch_response(results),
                    rpcwire.RPC_CONTENT_TYPE)
            row, k = rows[0], ks[0]
        else:
            body = req.json()
            if (not isinstance(body, dict) or "row" not in body
                    or "k" not in body):
                return 400, {
                    "message": "body must be {\"row\": [...], \"k\": n}"}
            arm, err = _arm_of(body)
            if err:
                return err
            row, k = body["row"], int(body["k"])
        binary = _binary_accept(req)
        server.count_rpc("binary" if binary else "json")
        try:
            items, gidx, scores = solo_fn(
                row, k, arm=arm, plan_version=_plan_version_of(req))
        except CandidateArmMissing as e:
            # the "candidate-arm-missing:" prefix is the router's cue to
            # fail over WITHOUT charging this replica's breaker: the
            # replica is healthy, it just has no staged arm
            return 503, {"message": f"candidate-arm-missing: {e}"}
        except PlanVersionMissing as e:
            return 503, {"message": f"plan-version-missing: {e}"}
        if binary:
            return _binary_response(items, gidx, scores)
        return 200, {"items": items,
                     "indices": [int(g) for g in gidx],
                     "scores": [float(s) for s in scores]}

    @app.route("POST", r"/shard/topk")
    def shard_topk(req: Request):
        return _scoring_route(req, "topk", server.topk_arrays,
                              server.topk_arrays_batch)

    @app.route("POST", r"/shard/candidates")
    def shard_candidates(req: Request):
        """Two-stage retrieval candidates (ops/retrieval.py): answered
        on the SAME kind-2 response frame as /shard/topk so the
        router's (-score, global_index) merge is shared verbatim.
        nprobe/rerank_k are shard config, NOT wire parameters — a
        replica always answers from its own knobs (doctor --fleet WARNs
        when replicas of one group disagree)."""
        return _scoring_route(req, "candidates", server.candidates_arrays,
                              server.candidates_arrays_batch)

    @app.route("POST", r"/shard/item_rows")
    def shard_item_rows(req: Request):
        mis = _tenant_mismatch(req)
        if mis:
            return mis
        body = req.json()
        if not isinstance(body, dict) or not isinstance(
                body.get("items"), list):
            return 400, {"message": "body must be {\"items\": [...]}"}
        arm, err = _arm_of(body)
        if err:
            return err
        binary = _binary_accept(req)
        server.count_rpc("binary" if binary else "json")
        # raw values: see /shard/user_row — membership must match the
        # single-host id-index semantics exactly
        try:
            ids, rows = server.item_rows_arrays(
                list(body["items"]), arm=arm,
                plan_version=_plan_version_of(req))
        except CandidateArmMissing as e:
            # the "candidate-arm-missing:" prefix is the router's cue to
            # fail over WITHOUT charging this replica's breaker: the
            # replica is healthy, it just has no staged arm
            return 503, {"message": f"candidate-arm-missing: {e}"}
        except PlanVersionMissing as e:
            return 503, {"message": f"plan-version-missing: {e}"}
        if binary:
            from pio_tpu_torch.server.http import RawResponse

            return 200, RawResponse(
                rpcwire.encode_item_rows_response(ids, rows),
                rpcwire.RPC_CONTENT_TYPE)
        return 200, {"rows": {
            it: [float(x) for x in rows[i]] for i, it in enumerate(ids)
        }}

    @app.route("POST", r"/shard/load_candidate")
    def shard_load_candidate(req: Request):
        """Guarded rollout: load the candidate instance's recorded
        partition alongside the active one. Server-key guarded — it
        stages a model for production traffic."""
        mis = _tenant_mismatch(req)
        if mis:
            return mis
        if not check_server_key(req):
            return 401, {"message": "Invalid accessKey."}
        body = req.json()
        if not isinstance(body, dict) or not body.get("instanceId"):
            return 400, {"message": "body must be {\"instanceId\": id}"}
        try:
            server.load_candidate(str(body["instanceId"]))
        except ShardMemoryBudgetExceeded as e:
            return 507, {"message": str(e)}
        except Exception as e:  # noqa: BLE001 - corrupt blob/missing ->
            # the rollout controller rolls back on this 503
            return 503, {"message": f"{type(e).__name__}: {e}"}
        return 200, {"message": "candidate loaded",
                     "candidateInstanceId": body["instanceId"]}

    @app.route("POST", r"/shard/promote_candidate")
    def shard_promote_candidate(req: Request):
        mis = _tenant_mismatch(req)
        if mis:
            return mis
        if not check_server_key(req):
            return 401, {"message": "Invalid accessKey."}
        try:
            body = req.json() or {}
        except Exception:  # noqa: BLE001 - body is optional
            body = {}
        expected = body.get("instanceId") if isinstance(body, dict) else None
        try:
            instance_id = server.promote_candidate(expected)
        except ValueError as e:
            return 409, {"message": str(e)}
        return 200, {"message": "Promoted", "engineInstanceId": instance_id}

    @app.route("POST", r"/shard/drop_candidate")
    def shard_drop_candidate(req: Request):
        mis = _tenant_mismatch(req)
        if mis:
            return mis
        if not check_server_key(req):
            return 401, {"message": "Invalid accessKey."}
        server.drop_candidate()
        return 200, {"message": "candidate dropped"}

    @app.route("POST", r"/shard/upsert_users")
    def shard_upsert_users(req: Request):
        """Streaming fold-in apply (pio_tpu_torch/freshness/). Guarded like
        /reload — it mutates the serving partition."""
        mis = _tenant_mismatch(req)
        if mis:
            return mis
        if not check_server_key(req):
            return 401, {"message": "Invalid accessKey."}
        body = req.json()
        users = body.get("users") if isinstance(body, dict) else None
        items = body.get("items") if isinstance(body, dict) else None
        if not isinstance(users, dict) and not isinstance(items, dict):
            return 400, {"message": "body must be {\"users\": {id: [row]}}"
                                    " and/or {\"items\": {id: [row]}}"}
        try:
            if isinstance(users, dict):
                out = server.upsert_user_rows(
                    users, body.get("stalenessSeconds"))
            else:
                with server._lock:
                    part = server.partition
                out = {"applied": 0, "rejected": [],
                       "engineInstanceId": (part.instance_id
                                            if part else None)}
            if isinstance(items, dict):
                # item rows ride the SAME apply call so an upserted item
                # is retrievable through the candidate tier the moment
                # this request returns (the freshness contract)
                iout = server.upsert_item_rows(items)
                out["itemsApplied"] = iout["applied"]
                out["itemsRejected"] = iout["rejected"]
        except ShardMemoryBudgetExceeded as e:
            return 507, {"message": str(e)}
        except ValueError as e:
            return 400, {"message": str(e)}
        return 200, out

    @app.route("POST", r"/shard/begin_reshard")
    def shard_begin_reshard(req: Request):
        """Elastic resharding: open an epoch (docs/serving.md). Guarded
        — it stages a topology change for production traffic."""
        if not check_server_key(req):
            return 401, {"message": "Invalid accessKey."}
        body = req.json()
        if (not isinstance(body, dict) or not body.get("instanceId")
                or not isinstance(body.get("newOwners"), list)):
            return 400, {"message": "body must be {\"instanceId\", "
                                    "\"planVersion\", \"newOwners\", "
                                    "\"nShardsNew\", \"incoming\"}"}
        try:
            out = server.begin_reshard(
                str(body["instanceId"]), int(body.get("planVersion", 0)),
                tuple(int(o) for o in body["newOwners"]),
                int(body.get("nShardsNew", 0)),
                [int(p) for p in body.get("incoming") or []])
        except ValueError as e:
            return 409, {"message": str(e)}
        return 200, out

    @app.route("POST", r"/shard/extract_partition")
    def shard_extract_partition(req: Request):
        """One virtual partition's slice as a kind-5 rpc frame — what
        the reshard controller streams to the new owner."""
        if not check_server_key(req):
            return 401, {"message": "Invalid accessKey."}
        from pio_tpu_torch.server.http import RawResponse

        body = req.json()
        if not isinstance(body, dict) or "p" not in body:
            return 400, {"message": "body must be {\"p\": partition}"}
        try:
            sl = server.extract_partition(int(body["p"]))
        except ValueError as e:
            return 409, {"message": str(e)}
        return 200, RawResponse(rpcwire.encode_partition_slice(sl),
                                rpcwire.RPC_CONTENT_TYPE)

    @app.route("POST", r"/shard/stage_partition")
    def shard_stage_partition(req: Request):
        """Land a transferred partition slice (kind-5 rpc frame body).
        CRC32C-framed end-to-end: a corrupt transfer dies here as a 400
        and the controller retries — never a silently wrong row."""
        if not check_server_key(req):
            return 401, {"message": "Invalid accessKey."}
        if _media_type(req, "content-type") != rpcwire.RPC_CONTENT_TYPE:
            return 400, {"message": "stage_partition body must be a "
                                    f"{rpcwire.RPC_CONTENT_TYPE} frame"}
        try:
            sl = rpcwire.decode_partition_slice(req.body)
        except rpcwire.RpcWireError as e:
            return 400, {"message": f"bad rpc frame: {e}"}
        # the migration span `pio trace` shows end-to-end: which
        # partition landed here and how many bytes moved
        with server.tracer.span("reshard.transfer",
                                shard=config.shard_index,
                                partition=sl.partition,
                                bytes=len(req.body)):
            try:
                out = server.stage_partition(sl)
            except ValueError as e:
                return 409, {"message": str(e)}
        return 200, out

    @app.route("GET", r"/shard/reshard_status")
    def shard_reshard_status(req: Request):
        return 200, server.reshard_status()

    @app.route("POST", r"/shard/prepare_reshard")
    def shard_prepare_reshard(req: Request):
        if not check_server_key(req):
            return 401, {"message": "Invalid accessKey."}
        body = req.json()
        if not isinstance(body, dict) or "planVersion" not in body:
            return 400, {"message": "body must be {\"planVersion\": v}"}
        try:
            out = server.prepare_reshard(int(body["planVersion"]))
        except ShardMemoryBudgetExceeded as e:
            return 507, {"message": str(e)}
        except ValueError as e:
            return 409, {"message": str(e)}
        return 200, out

    @app.route("POST", r"/shard/activate_reshard")
    def shard_activate_reshard(req: Request):
        if not check_server_key(req):
            return 401, {"message": "Invalid accessKey."}
        body = req.json()
        if not isinstance(body, dict) or "planVersion" not in body:
            return 400, {"message": "body must be {\"planVersion\": v}"}
        try:
            out = server.activate_reshard(int(body["planVersion"]))
        except ValueError as e:
            return 409, {"message": str(e)}
        return 200, out

    @app.route("POST", r"/shard/abort_reshard")
    def shard_abort_reshard(req: Request):
        if not check_server_key(req):
            return 401, {"message": "Invalid accessKey."}
        return 200, server.abort_reshard()

    @app.route("POST", r"/reload")
    @app.route("GET", r"/reload")  # deprecated alias (docs/serving.md:
    # reload mutates serving state, POST is canonical)
    def reload(req: Request):
        if not check_server_key(req):
            return 401, {"message": "Invalid accessKey."}
        try:
            instance_id = server.reload()
        except Exception as e:  # noqa: BLE001 - degrade, don't die
            with server._lock:
                part = server.partition
            return 503, {
                "message": f"Reload failed ({type(e).__name__}: {e}); "
                           "still serving last-good partition",
                "engineInstanceId": part.instance_id if part else None,
            }
        return 200, {"message": "Reloaded", "engineInstanceId": instance_id}

    @app.route("POST", r"/stop")
    def stop(req: Request):
        if not check_server_key(req):
            return 401, {"message": "Invalid accessKey."}
        server._stop_requested.set()
        return 200, {"message": "Shutting down."}

    def readiness() -> dict:
        checks = breaker_checks(server.storage)
        with server._lock:
            part = server.partition
        checks["partition"] = {
            "ok": part is not None,
            "shardIndex": config.shard_index,
            "engineInstanceId": part.instance_id if part else None,
            "lastReloadError": server.last_reload_error,
        }
        checks.update(shedder_check(getattr(app, "transport", None)))
        return checks

    install_health_routes(app, readiness)
    # distributed tracing (pio_tpu_torch/obs/): /debug routes + traced edge,
    # so shard-local spans are fetchable by `pio trace` per process
    from pio_tpu_torch.obs.http import install_trace_routes

    app.tracer = server.tracer
    install_trace_routes(app, server.recorder, check_server_key)
    return app


def create_shard_server(storage,
                        config: ShardConfig) -> tuple[object, ShardServer]:
    """-> (http transport, ShardServer); start() the transport yourself
    (with port=0 the real port is only known after bind)."""
    srv = ShardServer(storage, config)
    server_cls = AsyncHttpServer if config.backend == "async" else HttpServer
    http = server_cls(build_shard_app(srv), host=config.ip, port=config.port)
    return http, srv


def main(argv: list[str] | None = None) -> int:
    """Standalone shard process (``python -m pio_tpu_torch.serving_fleet shard``).
    Storage comes from the PIO_STORAGE_* environment like every other
    pio process; prints the bound port so supervisors can discover it."""
    import argparse

    from pio_tpu_torch.data.storage import get_storage

    p = argparse.ArgumentParser(prog="pio_tpu_torch.serving_fleet shard")
    p.add_argument("--ip", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--shard-index", type=int, required=True)
    p.add_argument("--n-shards", type=int, required=True)
    p.add_argument("--engine-id", required=True)
    p.add_argument("--engine-version", default="1")
    p.add_argument("--engine-variant", default="default")
    p.add_argument("--instance-id", default="")
    p.add_argument("--server-key", default="")
    p.add_argument("--memory-budget-bytes", type=int, default=0)
    p.add_argument("--server-backend", choices=["async", "threaded"],
                   default="threaded")
    p.add_argument("--join-reshard", action="store_true",
                   help="grow-path boot: start empty and await staged "
                        "partition slices when no blob exists for this "
                        "shard's topology yet")
    p.add_argument("--retrieval-mode", choices=["exact", "clustered"],
                   default="exact",
                   help="two-stage retrieval tier (docs/serving.md): "
                        "clustered builds the quantized candidate index "
                        "beside the f32 partition")
    p.add_argument("--retrieval-dtype", choices=["bf16", "int8"],
                   default="int8")
    p.add_argument("--retrieval-nprobe", type=int, default=32)
    p.add_argument("--retrieval-rerank-k", type=int, default=1024)
    p.add_argument("--retrieval-impl", choices=["auto", "xla", "pallas"],
                   default="auto",
                   help="the clustered scan: pallas launches the CUDA "
                        "kernel, auto/xla the plain torch einsum")
    p.add_argument("--device", choices=["cuda", "cpu"], default=None,
                   help="scoring device (default cuda; cpu must be asked "
                        "for)")
    args = p.parse_args(argv)
    config = ShardConfig(
        ip=args.ip, port=args.port, shard_index=args.shard_index,
        n_shards=args.n_shards, engine_id=args.engine_id,
        engine_version=args.engine_version,
        engine_variant=args.engine_variant,
        instance_id=args.instance_id, server_key=args.server_key,
        memory_budget_bytes=args.memory_budget_bytes,
        backend=args.server_backend,
        join_reshard=args.join_reshard,
        retrieval={
            "mode": args.retrieval_mode,
            "dtype": args.retrieval_dtype,
            "nprobe": args.retrieval_nprobe,
            "rerank_k": args.retrieval_rerank_k,
            "impl": args.retrieval_impl,
        },
        device=args.device,
    )
    http, srv = create_shard_server(get_storage(), config)
    http.start()
    print(f"shard {args.shard_index}/{args.n_shards} on "
          f"http://{args.ip}:{http.port} (instance "
          f"{srv.partition.instance_id})", flush=True)

    def watch_stop():
        srv._stop_requested.wait()
        http.stop()

    # pio: lint-ok[context-loss] deliberate detach: shutdown watcher
    # waits for the /stop signal for the process lifetime; no request
    # context applies
    threading.Thread(target=watch_stop, daemon=True).start()
    try:
        http.wait()
    except KeyboardInterrupt:
        http.stop()
    return 0
