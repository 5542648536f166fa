"""Shard plan: deterministic partition of factor tables by entity id.

The plan is a pure function of (model entity ids, n_shards): entity e
lives on shard ``crc32c(e) % n_shards`` (utils/durable.py's CRC32C — the
stdlib ``hash()`` is salted per process and MUST NOT be used here; the
router and every shard have to agree across processes and restarts).

At deploy time ``persist_fleet_artifacts`` computes the plan from the
persisted model blob and records, in the MODELDATA repository alongside
the EngineInstance's own blob:

  * ``<instance>:shardplan``  — the plan JSON (counts per shard, the
    popularity fallback list the router serves when a whole shard group
    is down, and a plan hash), CRC32C-framed;
  * ``<instance>:shard<i>``   — shard i's partition: its user rows, its
    item rows + their GLOBAL dense indices (the merge key that keeps
    fleet top-k bit-identical to the single-host oracle), pickled and
    CRC32C-framed so every backend detects truncation/bit-rot at load.

Partitions carry entity ids in dense-index order, so per-shard local
order preserves global order and the serving top-k's lowest-index-first
tie break (ops/topk.py) survives the merge.

Elastic resharding (docs/serving.md "Elastic resharding"): entities hash
into ``N_PARTITIONS`` fixed virtual partitions (``partition_of``) and a
plan's ``owners`` map assigns each partition to a shard. A fresh deploy
uses ``default_owners(n)`` — for the power-of-two topologies the fleet
ships with this is byte-identical to the historical direct
``crc32c(e) % n`` placement — and a reshard only rewrites the owners
map: ``compute_reshard_owners`` keeps every partition whose owner
survives under the new target loads, so ``plan_diff`` (the move set) is
minimal and deterministic. Resharded plans carry ``plan_version > 1``
and their partition blobs live under ``<iid>:plan<v>:shard<i>`` —
writing the plan JSON is the single durable cutover point: a crash
before it leaves the old plan + old blobs fully intact.
"""

from __future__ import annotations

import io
import json
import logging
import pickle
from dataclasses import asdict, dataclass
from typing import Any

import numpy as np

from pio_tpu_torch.utils.durable import ModelIntegrityError, crc32c, frame, unframe

log = logging.getLogger("pio_tpu_torch.fleet")

PLAN_STRATEGY = "crc32c"
PLAN_VERSION = 1
FALLBACK_ITEMS = 50  # popularity list length recorded in the plan

# Multi-tenant RPC contract (serving_fleet/tenancy.py): every internal
# scoring/fold-in/rollout RPC in a multi-tenant fleet carries the tenant
# triple in this header — the client ALWAYS sends it, the shard ALWAYS
# validates it against its placement (pio lint --deep enforces both
# sides; see analysis/deep/rules_routes.py tenant-header).
TENANT_HEADER = "X-Pio-Tenant"

# Virtual partitions: the fixed unit of placement AND of migration. An
# entity's partition never changes; only the partition->shard owners map
# does, so a reshard moves whole partitions instead of re-hashing every
# entity. 32 keeps per-partition blobs big enough to stream efficiently
# while still dividing evenly across every fleet size the tests run.
N_PARTITIONS = 32

_DEFAULT_OWNERS_CACHE: dict[int, tuple[int, ...]] = {}


def partition_of(entity_id: str) -> int:
    """The entity's fixed virtual partition — stable across processes,
    restarts, and reshards (crc32c, never the salted stdlib hash)."""
    return crc32c(str(entity_id).encode("utf-8")) % N_PARTITIONS


def default_owners(n_shards: int) -> tuple[int, ...]:
    """The deploy-time partition->shard map: partition p on shard
    ``p % n_shards``. When ``n_shards`` divides N_PARTITIONS this places
    every entity exactly where the pre-resharding direct
    ``crc32c(e) % n_shards`` did."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    owners = _DEFAULT_OWNERS_CACHE.get(n_shards)
    if owners is None:
        owners = tuple(p % n_shards for p in range(N_PARTITIONS))
        _DEFAULT_OWNERS_CACHE[n_shards] = owners
    return owners


def shard_of(entity_id: str, n_shards: int) -> int:
    """Owning shard for an entity id under the DEFAULT owners map —
    stable across processes/hosts. Plan-aware callers (router, shard
    ownership checks) go through ``ShardPlan.owner_of`` instead so a
    resharded owners map is honoured."""
    return default_owners(n_shards)[partition_of(entity_id)]


def plan_model_id(instance_id: str) -> str:
    return f"{instance_id}:shardplan"


def shard_model_id(instance_id: str, shard_index: int,
                   plan_version: int = 1) -> str:
    """Partition-blob key. Version 1 keeps the legacy unversioned key so
    pre-resharding fleets keep resolving their blobs; resharded plans
    (version > 1) get distinct keys so commit can write the new
    topology's blobs BEFORE the plan JSON flips — the old generation
    stays readable until the cutover point."""
    if plan_version <= 1:
        return f"{instance_id}:shard{shard_index}"
    return f"{instance_id}:plan{plan_version}:shard{shard_index}"


@dataclass(frozen=True)
class ShardPlan:
    """The deploy-time partition record (see module docstring)."""

    instance_id: str
    n_shards: int
    n_replicas: int
    strategy: str
    version: int
    user_counts: tuple[int, ...]   # users per shard
    item_counts: tuple[int, ...]   # items per shard
    fallback: tuple[dict, ...]     # [{"item": id, "score": s}, ...]
    plan_hash: str                 # crc32c of the partition content
    # empty owners means default_owners(n_shards) — deploy-time plans
    # stay byte-compatible with pre-resharding readers
    owners: tuple[int, ...] = ()
    plan_version: int = 1          # bumped by every committed reshard

    def effective_owners(self) -> tuple[int, ...]:
        return self.owners or default_owners(self.n_shards)

    def owner_of(self, entity_id: str) -> int:
        """Owning shard under THIS plan's (possibly resharded) map."""
        return self.effective_owners()[partition_of(entity_id)]

    def to_json(self) -> str:
        return json.dumps(asdict(self), sort_keys=True)

    @staticmethod
    def from_json(text: str) -> "ShardPlan":
        d = json.loads(text)
        return ShardPlan(
            instance_id=d["instance_id"], n_shards=int(d["n_shards"]),
            n_replicas=int(d["n_replicas"]), strategy=d["strategy"],
            version=int(d["version"]),
            user_counts=tuple(d["user_counts"]),
            item_counts=tuple(d["item_counts"]),
            fallback=tuple(d["fallback"]),
            plan_hash=d["plan_hash"],
            owners=tuple(int(o) for o in d.get("owners") or ()),
            plan_version=int(d.get("plan_version", 1)),
        )


@dataclass
class ShardPartition:
    """One shard's slice of the factor tables.

    ``item_gidx`` holds each local item's index in the FULL item table:
    the router merges per-shard top-k by ``(-score, global_index)``,
    which reproduces the serving top-k's (``ops/topk.py``)
    descending-score, lowest-index tie order exactly.
    """

    shard_index: int
    n_shards: int
    instance_id: str
    user_ids: list[str]
    user_rows: np.ndarray      # (n_local_users, k) float32
    item_ids: list[str]
    item_gidx: np.ndarray      # (n_local_items,) int32 global dense index
    item_rows: np.ndarray      # (n_local_items, k) float32

    def nbytes(self) -> int:
        return int(self.user_rows.nbytes + self.item_rows.nbytes)


def _factor_tables(model: Any) -> tuple[np.ndarray, np.ndarray, Any, Any]:
    """Extract (user_factors, item_factors, users_index, items_index)
    from a factor-table model (the RecommendationModel shape: ``factors``
    with ``user_factors``/``item_factors`` numpy arrays or tensors plus
    ``users``/``items`` EntityIdIndex). Raises for model families the
    fleet cannot partition yet."""
    factors = getattr(model, "factors", None)
    users = getattr(model, "users", None)
    items = getattr(model, "items", None)
    uf = getattr(factors, "user_factors", None)
    itf = getattr(factors, "item_factors", None)
    if uf is None or itf is None or users is None or items is None:
        raise ValueError(
            f"fleet serving needs a factor-table model (factors.user_factors"
            f"/factors.item_factors + users/items indexes); got "
            f"{type(model).__name__}"
        )
    return _host(uf), _host(itf), users, items


def _host(table) -> np.ndarray:
    """A factor table as host numpy: the blobs are built from host bytes,
    whether the model's leaves are numpy or tensors on any device."""
    if hasattr(table, "detach"):
        table = table.detach().cpu().numpy()
    return np.asarray(table)


def model_nbytes(model: Any) -> int:
    """Total factor-table bytes of a model — what ONE host would have to
    hold to serve it unsharded (the memory-budget comparisons in tests
    and ``pio doctor --fleet`` use this)."""
    uf, itf, _, _ = _factor_tables(model)
    return int(uf.nbytes + itf.nbytes)


def _assignments(ids: list[str], n_shards: int,
                 owners: tuple[int, ...] | None = None) -> np.ndarray:
    own = owners or default_owners(n_shards)
    return np.fromiter(
        (own[partition_of(i)] for i in ids), dtype=np.int32, count=len(ids)
    )


def partition_model(model: Any, instance_id: str, n_shards: int,
                    owners: tuple[int, ...] | None = None,
                    ) -> list[ShardPartition]:
    """Split a factor-table model into ``n_shards`` partitions, each
    holding only its users' and items' rows (in dense-index order).
    ``owners`` overrides the default partition->shard map (the reshard
    controller's storage-rebuild fallback re-cuts under the NEW map)."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    uf, itf, users, items = _factor_tables(model)
    user_ids = users.ids()
    item_ids = items.ids()
    ua = _assignments(user_ids, n_shards, owners)
    ia = _assignments(item_ids, n_shards, owners)
    out = []
    for s in range(n_shards):
        usel = np.flatnonzero(ua == s)
        isel = np.flatnonzero(ia == s)
        out.append(ShardPartition(
            shard_index=s,
            n_shards=n_shards,
            instance_id=instance_id,
            user_ids=[user_ids[i] for i in usel],
            user_rows=np.ascontiguousarray(uf[usel]),
            item_ids=[item_ids[i] for i in isel],
            item_gidx=isel.astype(np.int32),
            item_rows=np.ascontiguousarray(itf[isel]),
        ))
    return out


# -- elastic resharding: owners-map rebalance + partition slices -------------

def compute_reshard_owners(old_owners: tuple[int, ...],
                           n_new: int) -> tuple[int, ...]:
    """The new partition->shard map for an N->N' reshard, minimising
    movement: a partition keeps its owner whenever that shard survives
    the resize and is still under its new target load; only the
    overflow (and partitions on removed shards) move, to under-target
    shards in ascending order. Pure function of (old_owners, n_new) —
    the determinism the move-set tests pin down."""
    if n_new < 1:
        raise ValueError(f"n_new must be >= 1, got {n_new}")
    n_parts = len(old_owners)
    base, rem = divmod(n_parts, n_new)
    targets = [base + (1 if s < rem else 0) for s in range(n_new)]
    new = [-1] * n_parts
    counts = [0] * n_new
    for p, o in enumerate(old_owners):
        if 0 <= o < n_new and counts[o] < targets[o]:
            new[p] = o
            counts[o] += 1
    for p in range(n_parts):
        if new[p] >= 0:
            continue
        for s in range(n_new):
            if counts[s] < targets[s]:
                new[p] = s
                counts[s] += 1
                break
    return tuple(new)


def plan_diff(old_owners: tuple[int, ...], new_owners: tuple[int, ...],
              ) -> tuple[tuple[int, int, int], ...]:
    """The move set: ``(partition, old_owner, new_owner)`` for exactly
    the partitions whose owner changes. Minimal by construction —
    an unmoved partition can never appear — and deterministic."""
    if len(old_owners) != len(new_owners):
        raise ValueError(
            f"owner maps disagree on partition count: "
            f"{len(old_owners)} vs {len(new_owners)}")
    return tuple(
        (p, o, n)
        for p, (o, n) in enumerate(zip(old_owners, new_owners))
        if o != n
    )


@dataclass
class PartitionSlice:
    """One virtual partition's entities + factor rows — the unit a
    reshard streams from old owner to new owner. ``item_gidx`` keeps the
    GLOBAL dense indices so the destination can re-sort its merged item
    table into dense-index order and preserve the top-k tie-break."""

    partition: int
    instance_id: str
    k: int                     # factor dimension
    user_ids: list[str]
    user_rows: np.ndarray      # (n_users, k) float32
    item_ids: list[str]
    item_gidx: np.ndarray      # (n_items,) int32
    item_rows: np.ndarray      # (n_items, k) float32
    # Optional quantized sidecar rows (two-stage retrieval). The source
    # shard attaches its already-encoded rows so the destination can
    # verify carried == re-encoded (encode_rows is deterministic) instead
    # of trusting the wire blindly. ``None`` on exact-mode fleets and on
    # slices cut before the retrieval tier existed.
    qdtype: str | None = None             # "bf16" | "int8"
    item_qrows: np.ndarray | None = None  # (n_items, k) uint16|int8
    item_qscales: np.ndarray | None = None  # (n_items,) float32

    def nbytes(self) -> int:
        n = int(self.user_rows.nbytes + self.item_rows.nbytes)
        if self.item_qrows is not None:
            n += int(self.item_qrows.nbytes)
        if self.item_qscales is not None:
            n += int(self.item_qscales.nbytes)
        return n


def slice_partition(part: ShardPartition, p: int) -> PartitionSlice:
    """Extract virtual partition ``p``'s entities from a shard's
    partition (row order preserved, so dense-index order survives)."""
    usel = [i for i, u in enumerate(part.user_ids) if partition_of(u) == p]
    isel = [i for i, it in enumerate(part.item_ids) if partition_of(it) == p]
    k = int(part.user_rows.shape[1]) if part.user_rows.ndim == 2 else (
        int(part.item_rows.shape[1]) if part.item_rows.ndim == 2 else 0)
    return PartitionSlice(
        partition=p,
        instance_id=part.instance_id,
        k=k,
        user_ids=[part.user_ids[i] for i in usel],
        user_rows=np.ascontiguousarray(part.user_rows[usel], dtype=np.float32),
        item_ids=[part.item_ids[i] for i in isel],
        item_gidx=np.ascontiguousarray(part.item_gidx[isel], dtype=np.int32),
        item_rows=np.ascontiguousarray(part.item_rows[isel], dtype=np.float32),
    )


def merge_reshard(part: ShardPartition, staged: dict[int, PartitionSlice],
                  new_owners: tuple[int, ...], shard_index: int,
                  n_new: int) -> ShardPartition:
    """Commit-time rebuild of one shard's partition under the NEW owners
    map: keep every resident entity the shard still owns, graft in the
    staged slices it gained, drop what moved away — then re-sort the
    merged item table by global dense index, which restores the
    lowest-index-first tie order (``ops/topk.py``) the router merge depends
    on for oracle bit-parity."""
    user_ids: list[str] = []
    user_rows: list[np.ndarray] = []
    for i, u in enumerate(part.user_ids):
        if new_owners[partition_of(u)] == shard_index:
            user_ids.append(u)
            user_rows.append(part.user_rows[i])
    item_ids: list[str] = []
    item_gidx: list[int] = []
    item_rows: list[np.ndarray] = []
    for i, it in enumerate(part.item_ids):
        if new_owners[partition_of(it)] == shard_index:
            item_ids.append(it)
            item_gidx.append(int(part.item_gidx[i]))
            item_rows.append(part.item_rows[i])
    for p in sorted(staged):
        sl = staged[p]
        if new_owners[p] != shard_index:
            continue
        user_ids.extend(sl.user_ids)
        user_rows.extend(np.asarray(sl.user_rows))
        item_ids.extend(sl.item_ids)
        item_gidx.extend(int(g) for g in sl.item_gidx)
        item_rows.extend(np.asarray(sl.item_rows))
    k = 0
    if part.user_rows.ndim == 2 and part.user_rows.shape[1]:
        k = int(part.user_rows.shape[1])
    elif part.item_rows.ndim == 2 and part.item_rows.shape[1]:
        k = int(part.item_rows.shape[1])
    else:
        # empty join-boot partition: the rank comes from what arrived
        for p in sorted(staged):
            if staged[p].k:
                k = int(staged[p].k)
                break
    order = sorted(range(len(item_ids)), key=lambda i: item_gidx[i])
    return ShardPartition(
        shard_index=shard_index,
        n_shards=n_new,
        instance_id=part.instance_id,
        user_ids=user_ids,
        user_rows=(np.stack(user_rows).astype(np.float32, copy=False)
                   if user_rows else np.zeros((0, k), dtype=np.float32)),
        item_ids=[item_ids[i] for i in order],
        item_gidx=np.asarray([item_gidx[i] for i in order], dtype=np.int32),
        item_rows=(np.stack([item_rows[i] for i in order])
                   .astype(np.float32, copy=False)
                   if item_rows else np.zeros((0, k), dtype=np.float32)),
    )


def resharded_plan(old: ShardPlan, new_owners: tuple[int, ...], n_new: int,
                   user_counts: tuple[int, ...],
                   item_counts: tuple[int, ...]) -> ShardPlan:
    """The successor plan record: same instance + fallback list, new
    owners map, plan_version bumped, hash chained from the old plan's so
    plan identity still covers the full placement history."""
    h = crc32c(json.dumps([old.plan_hash, list(new_owners)],
                          separators=(",", ":")).encode("utf-8"))
    return ShardPlan(
        instance_id=old.instance_id,
        n_shards=n_new,
        n_replicas=old.n_replicas,
        strategy=old.strategy,
        version=old.version,
        user_counts=tuple(user_counts),
        item_counts=tuple(item_counts),
        fallback=old.fallback,
        plan_hash=f"{h:#010x}",
        owners=tuple(new_owners),
        plan_version=old.plan_version + 1,
    )


def _popularity_fallback(model: Any, k: int = FALLBACK_ITEMS) -> list[dict]:
    """The degraded-mode item list: score every item against the MEAN
    user factor — a cheap global-popularity proxy that needs nothing but
    the model. Served flagged (``"degraded": true``) when a whole shard
    group is unreachable, so availability never depends on the fleet."""
    uf, itf, _, items = _factor_tables(model)
    if uf.shape[0] == 0 or itf.shape[0] == 0:
        return []
    mean_user = uf.mean(axis=0, dtype=np.float64).astype(np.float32)
    scores = itf @ mean_user
    order = np.argsort(-scores, kind="stable")[:k]
    ids = items.ids()
    return [
        {"item": ids[i], "score": float(scores[i])} for i in order
    ]


def build_plan(model: Any, instance_id: str, n_shards: int,
               n_replicas: int) -> ShardPlan:
    """Compute the plan WITHOUT persisting anything (the determinism
    tests and doctor use this). Same model -> same plan (plan_hash
    covers the full per-entity assignment, not just the counts)."""
    parts = partition_model(model, instance_id, n_shards)
    return _plan_from_partitions(model, parts, instance_id, n_shards,
                                 n_replicas)


def _plan_from_partitions(model: Any, parts: list[ShardPartition],
                          instance_id: str, n_shards: int,
                          n_replicas: int) -> ShardPlan:
    h = 0
    for p in parts:
        h = crc32c("\x00".join(p.user_ids).encode("utf-8"), h)
        h = crc32c("\x00".join(p.item_ids).encode("utf-8"), h)
    return ShardPlan(
        instance_id=instance_id,
        n_shards=n_shards,
        n_replicas=n_replicas,
        strategy=PLAN_STRATEGY,
        version=PLAN_VERSION,
        user_counts=tuple(len(p.user_ids) for p in parts),
        item_counts=tuple(len(p.item_ids) for p in parts),
        fallback=tuple(_popularity_fallback(model)),
        plan_hash=f"{h:#010x}",
    )


# -- persistence (MODELDATA repository, CRC32C-framed) -----------------------

def partition_to_bytes(part: ShardPartition) -> bytes:
    buf = io.BytesIO()
    pickle.dump(part, buf, protocol=5)
    return frame(buf.getvalue())


def partition_from_bytes(blob: bytes, source: str = "") -> ShardPartition:
    """Verify + unpickle a partition blob. Raises ModelIntegrityError on
    a framed blob whose checksum fails — the shard server's last-good
    fallback catches it and tries the previous COMPLETED instance."""
    part = pickle.loads(unframe(blob, source=source or "shard partition"))
    if not isinstance(part, ShardPartition):
        raise ModelIntegrityError(
            f"blob {source or '?'} is not a shard partition "
            f"(got {type(part).__name__})"
        )
    return part


def persist_fleet_artifacts(storage, instance_id: str, model: Any,
                            n_shards: int, n_replicas: int) -> ShardPlan:
    """Partition `model` and write plan + per-shard blobs next to the
    instance's own model blob. Idempotent: re-running overwrites with
    identical content (the plan is deterministic)."""
    from pio_tpu_torch.data.dao import Model

    parts = partition_model(model, instance_id, n_shards)
    plan = _plan_from_partitions(model, parts, instance_id, n_shards,
                                 n_replicas)
    models = storage.get_model_data_models()
    for p in parts:
        models.insert(Model(shard_model_id(instance_id, p.shard_index),
                            partition_to_bytes(p)))
    models.insert(Model(plan_model_id(instance_id),
                        frame(plan.to_json().encode("utf-8"))))
    log.info("fleet artifacts persisted for %s: %d shards x %d replicas "
             "(users %s, items %s)", instance_id, n_shards, n_replicas,
             plan.user_counts, plan.item_counts)
    return plan


def save_plan(storage, plan: ShardPlan) -> None:
    """Overwrite the instance's plan JSON — THE durable reshard cutover
    point. Partition blobs for ``plan.plan_version`` must already be
    persisted: a crash one instruction before this write leaves the old
    plan (and its still-present blobs) fully in charge."""
    from pio_tpu_torch.data.dao import Model

    storage.get_model_data_models().insert(Model(
        plan_model_id(plan.instance_id),
        frame(plan.to_json().encode("utf-8"))))


def load_plan(storage, instance_id: str) -> ShardPlan | None:
    """The recorded plan for an instance, or None when it was never
    partitioned. Raises ModelIntegrityError on a corrupt plan blob."""
    rec = storage.get_model_data_models().get(plan_model_id(instance_id))
    if rec is None:
        return None
    return ShardPlan.from_json(
        unframe(rec.models, source=plan_model_id(instance_id))
        .decode("utf-8"))


def load_partition(storage, instance_id: str, shard_index: int,
                   plan_version: int = 1) -> ShardPartition | None:
    """One shard's partition blob, or None when absent. Raises
    ModelIntegrityError on corruption (callers fall back last-good)."""
    mid = shard_model_id(instance_id, shard_index, plan_version)
    rec = storage.get_model_data_models().get(mid)
    if rec is None:
        return None
    return partition_from_bytes(rec.models, source=mid)


def partitioned_instances(storage, engine_id: str, engine_version: str,
                          engine_variant: str,
                          n_shards: int) -> list:
    """COMPLETED instances of the engine that were partitioned with this
    topology AND are rollout-eligible, most recent first — the shard/
    router resolution order (the fleet analogue of deploy's
    get_latest_completed contract). Rollout verdicts gate the list the
    same way they gate single-host serve: an instance the guards
    ROLLED_BACK (or whose canary is still in flight) is skipped, so a
    fleet /reload can never auto-advance onto a rejected model."""
    from pio_tpu_torch.rollout.state import is_auto_advance_eligible

    instances = storage.get_metadata_engine_instances()
    out = []
    for inst in instances.get_completed(engine_id, engine_version,
                                        engine_variant):
        if not is_auto_advance_eligible(storage, inst.id):
            continue
        try:
            plan = load_plan(storage, inst.id)
        except ModelIntegrityError as e:
            log.error("shard plan for instance %s is corrupt (%s); "
                      "skipping", inst.id, e)
            continue
        if plan is not None and plan.n_shards == n_shards:
            out.append(inst)
    return out
