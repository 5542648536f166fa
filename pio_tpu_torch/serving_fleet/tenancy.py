"""Multi-tenant serving fleet: many engines bin-packed on one pool of
shard servers, with noisy-neighbor isolation (docs/serving.md
"Multi-tenant fleet").

Placement — plan v2. A ``FleetPlan`` names a pool (``n_shards`` x
``n_replicas`` shard hosts, one ``memory_budget_bytes`` per host) and
records, per tenant (an engine triple), the partition->shard owners map
its partitions were packed under. Packing is deterministic first-fit-
decreasing over virtual-partition blob sizes: partitions sorted by
(size desc, tenant, partition index) land on the least-loaded shard
that still fits under the budget (ties -> lowest shard index), and the
packer raises ``FleetCapacityError`` with the full per-shard load table
when the pool cannot fit — never a silent overcommit. Each tenant's
per-shard partition blobs and ShardPlan are persisted through the
EXISTING plan.py machinery (``<iid>:shard<i>`` + ``<iid>:shardplan``
with the packed owners recorded), so last-good fallback, fold-in,
rollout, and the binary RPC wire all work per tenant unchanged.

Runtime. Every pool slot runs a ``MultiTenantShardHost``: one HTTP
transport multiplexing one single-tenant ``ShardServer`` per placed
tenant, routed by the ``X-Pio-Tenant`` header (plan.py TENANT_HEADER).
The front of the plane is a ``MultiFleetRouter``: one single-tenant
``FleetRouter`` per tenant — so breakers, deadlines, probers, degraded
fallbacks, and chaos points are PER TENANT — behind one HTTP app that
resolves the tenant, applies admission, and delegates. One tenant's
corrupt blob, open breaker, or chaos injection degrades only that
tenant's router state.

Fairness. ``TenantAdmission`` (resilience/quota.py) rides the existing
429 + Retry-After discipline on the router (contract quotas: rate,
concurrency cap, weighted-fair share) AND on every shard host (backstop
buckets at ``SHARD_QUOTA_HEADROOM`` x the contract rate, so router-
admitted traffic never sheds at the shard but a router-bypassing
flooder still does).

Resharding: a multi-tenant plan REFUSES ``/reshard/begin`` with 409 in
v1 — the reshard epoch machinery moves one instance's partitions and
knows nothing of co-residents; growing a multi-tenant pool is a
re-pack + redeploy (documented in docs/serving.md).

The device. Every tenant's shard servers keep their item slices on one
device, and each tenant's router ranks whiteLists there: CUDA unless the
caller asks for the CPU (``deploy_multi_fleet(device=...)`` resolves it
once; without CUDA it raises). A tenant's ``ShardConfig`` carries no
``retrieval`` block, as in the JAX package's pool, so every tenant
serves EXACT: its partial top-k is ``ops/als.recommend_topk`` on its own
item slice, and the quantized-scan kernel never runs in a pool. The
host's ``/host/info`` and ``/metrics.json`` name the device; the latter
also counts each tenant's scoring dispatches by route.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import threading
from dataclasses import dataclass, field

from pio_tpu_torch.resilience.quota import TenantAdmission, TenantQuota
from pio_tpu_torch.serving_fleet.plan import (
    N_PARTITIONS, TENANT_HEADER, ShardPlan, _factor_tables,
    _plan_from_partitions, load_plan, partition_model, partition_of,
    partition_to_bytes, shard_model_id,
)
from pio_tpu_torch.utils.durable import frame, unframe
from pio_tpu_torch.workflow.context import resolve_device

log = logging.getLogger("pio_tpu_torch.fleet")

FLEET_DEFAULT = "default"
# shard-side quota backstop: hosts admit at this multiple of a tenant's
# contract rate — one router-admitted query costs several shard RPCs,
# so the backstop must never shed router traffic, only direct flooders
SHARD_QUOTA_HEADROOM = 8.0
# scoring RPCs gated by shard-host admission; control/health/fold-in
# paths are not (fold-in is already budgeted upstream, health must
# never shed)
ADMITTED_SHARD_PATHS = ("/shard/user_row", "/shard/topk",
                        "/shard/item_rows")


def tenant_key(engine_id: str, engine_version: str = "1",
               engine_variant: str = "default") -> str:
    """The tenant identity: the engine triple, one canonical string —
    the same key the compile-cache bucket registry uses, so co-resident
    engines share warm programs exactly when their triples match."""
    return f"{engine_id}/{engine_version}/{engine_variant}"


def tenant_label(key: str) -> str:
    """The tenant key with '/' -> '.' — safe inside chaos point names
    (``fleet.<label>.shard<i>.<op>``) and Prometheus label values."""
    return key.replace("/", ".")


class FleetCapacityError(RuntimeError):
    """The pool cannot fit a tenant's partitions under the per-shard
    memory budget. Carries the load table so the operator sees exactly
    which shard overflowed on which partition."""


@dataclass(frozen=True)
class TenantSpec:
    """What an operator asks to place: an engine triple + quota knobs.
    (``pio deploy --fleet-join`` builds one of these.)"""

    engine_id: str
    engine_version: str = "1"
    engine_variant: str = "default"
    instance_id: str = ""        # pin; "" = latest eligible COMPLETED
    quota_qps: float = 0.0       # 0 = unlimited
    quota_burst: float = 0.0     # 0 = max(rate, 1)
    weight: float = 1.0
    max_concurrency: int = 0     # 0 = unlimited

    @property
    def key(self) -> str:
        return tenant_key(self.engine_id, self.engine_version,
                          self.engine_variant)


@dataclass(frozen=True)
class TenantPlacement:
    """One tenant's recorded placement inside a FleetPlan."""

    tenant: str                       # tenant_key(...)
    engine_id: str
    engine_version: str
    engine_variant: str
    instance_id: str                  # the instance that was packed
    owners: tuple[int, ...]           # partition -> pool shard
    partition_bytes: tuple[int, ...]  # blob bytes per virtual partition
    quota_qps: float = 0.0
    quota_burst: float = 0.0
    weight: float = 1.0
    max_concurrency: int = 0

    def total_bytes(self) -> int:
        return int(sum(self.partition_bytes))

    def shard_bytes(self, n_shards: int) -> list[int]:
        out = [0] * n_shards
        for p, s in enumerate(self.owners):
            out[s] += self.partition_bytes[p]
        return out

    def quota(self) -> TenantQuota:
        return TenantQuota(rate=self.quota_qps, burst=self.quota_burst,
                           weight=self.weight,
                           max_concurrency=self.max_concurrency)


@dataclass(frozen=True)
class FleetPlan:
    """The pool-level placement record (plan v2): which tenants live on
    the pool and where every one of their partitions sits. Persisted
    CRC32C-framed in MODELDATA under ``fleet:<name>:plan`` — the same
    durability story as the per-instance ShardPlan."""

    name: str
    n_shards: int
    n_replicas: int
    memory_budget_bytes: int
    tenants: tuple[TenantPlacement, ...] = ()
    version: int = 1

    def tenant(self, key: str) -> TenantPlacement | None:
        for t in self.tenants:
            if t.tenant == key:
                return t
        return None

    def shard_loads(self) -> list[int]:
        """Bytes already packed per pool shard, across every tenant."""
        loads = [0] * self.n_shards
        for t in self.tenants:
            for p, s in enumerate(t.owners):
                loads[s] += t.partition_bytes[p]
        return loads

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @staticmethod
    def from_json(text: str) -> "FleetPlan":
        d = json.loads(text)
        return FleetPlan(
            name=d["name"], n_shards=int(d["n_shards"]),
            n_replicas=int(d["n_replicas"]),
            memory_budget_bytes=int(d["memory_budget_bytes"]),
            tenants=tuple(
                TenantPlacement(
                    tenant=t["tenant"], engine_id=t["engine_id"],
                    engine_version=t["engine_version"],
                    engine_variant=t["engine_variant"],
                    instance_id=t["instance_id"],
                    owners=tuple(int(o) for o in t["owners"]),
                    partition_bytes=tuple(
                        int(b) for b in t["partition_bytes"]),
                    quota_qps=float(t.get("quota_qps", 0.0)),
                    quota_burst=float(t.get("quota_burst", 0.0)),
                    weight=float(t.get("weight", 1.0)),
                    max_concurrency=int(t.get("max_concurrency", 0)),
                )
                for t in d.get("tenants", ())
            ),
            version=int(d.get("version", 1)),
        )


def fleet_plan_model_id(name: str) -> str:
    return f"fleet:{name}:plan"


def save_fleet_plan(storage, plan: FleetPlan) -> None:
    from pio_tpu_torch.data.dao import Model

    storage.get_model_data_models().insert(Model(
        fleet_plan_model_id(plan.name),
        frame(plan.to_json().encode("utf-8"))))


def load_fleet_plan(storage, name: str = FLEET_DEFAULT) -> FleetPlan | None:
    rec = storage.get_model_data_models().get(fleet_plan_model_id(name))
    if rec is None:
        return None
    return FleetPlan.from_json(
        unframe(rec.models, source=fleet_plan_model_id(name))
        .decode("utf-8"))


# -- placement: deterministic first-fit-decreasing bin packing ---------------

def partition_sizes(model) -> list[int]:
    """Blob bytes per virtual partition for one model: the row bytes of
    every user and item hashing into that partition — the packer's unit
    of placement (same f32 accounting as ShardPartition.nbytes)."""
    uf, itf, users, items = _factor_tables(model)
    sizes = [0] * N_PARTITIONS
    row_u = int(uf.itemsize * uf.shape[1]) if uf.ndim == 2 else 0
    row_i = int(itf.itemsize * itf.shape[1]) if itf.ndim == 2 else 0
    for uid in users.ids():
        sizes[partition_of(uid)] += row_u
    for iid in items.ids():
        sizes[partition_of(iid)] += row_i
    return sizes


def pack_partitions(
    sizes_by_tenant: dict[str, list[int]],
    n_shards: int,
    memory_budget_bytes: int = 0,
    base_loads: list[int] | None = None,
) -> dict[str, tuple[int, ...]]:
    """First-fit-decreasing over every tenant's partition blob sizes.

    Deterministic: partitions sorted by (size desc, tenant key,
    partition index), each placed on the least-loaded shard that still
    fits under the budget (ties -> lowest shard index). ``base_loads``
    seeds shard occupancy with already-placed tenants — the incremental
    join path, which never moves a resident tenant's partitions.

    Raises FleetCapacityError (with the load table) when any partition
    fits on no shard; budget 0 = unbounded (pure balancing).
    """
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    loads = list(base_loads) if base_loads else [0] * n_shards
    if len(loads) != n_shards:
        raise ValueError(
            f"base_loads covers {len(loads)} shards, pool has {n_shards}")
    items = sorted(
        ((sizes[p], t, p)
         for t, sizes in sizes_by_tenant.items()
         for p in range(N_PARTITIONS)),
        key=lambda it: (-it[0], it[1], it[2]))
    owners = {t: [-1] * N_PARTITIONS for t in sizes_by_tenant}
    for size, t, p in items:
        fitting = [s for s in range(n_shards)
                   if memory_budget_bytes <= 0
                   or loads[s] + size <= memory_budget_bytes]
        if not fitting:
            raise FleetCapacityError(
                f"cannot place partition {p} of tenant {t!r} "
                f"({size} bytes): every shard is over the "
                f"{memory_budget_bytes}-byte budget (loads="
                f"{[f'shard{s}:{b}' for s, b in enumerate(loads)]}); "
                f"grow the pool or raise --shard-memory-budget-mb")
        s = min(fitting, key=lambda s: (loads[s], s))
        owners[t][p] = s
        loads[s] += size
    return {t: tuple(o) for t, o in owners.items()}


def persist_tenant_artifacts(storage, instance_id: str, model,
                             n_shards: int, n_replicas: int,
                             owners: tuple[int, ...]) -> ShardPlan:
    """persist_fleet_artifacts with a PACKED owners map: the tenant's
    per-shard blobs + ShardPlan (owners recorded) land under the same
    ``<iid>:shard<i>`` / ``<iid>:shardplan`` keys, so shard-side
    resolution, last-good fallback, and fold-in need no tenant path."""
    from pio_tpu_torch.data.dao import Model
    from pio_tpu_torch.serving_fleet.plan import plan_model_id

    parts = partition_model(model, instance_id, n_shards, owners=owners)
    plan = _plan_from_partitions(model, parts, instance_id, n_shards,
                                 n_replicas)
    plan = dataclasses.replace(plan, owners=tuple(owners))
    models = storage.get_model_data_models()
    for p in parts:
        models.insert(Model(shard_model_id(instance_id, p.shard_index),
                            partition_to_bytes(p)))
    models.insert(Model(plan_model_id(instance_id),
                        frame(plan.to_json().encode("utf-8"))))
    return plan


def _resolve_spec(storage, spec: TenantSpec):
    from pio_tpu_torch.serving_fleet.fleet import resolve_fleet_model

    return resolve_fleet_model(
        storage, spec.engine_id, spec.engine_version, spec.engine_variant,
        spec.instance_id or None)


def _placement_for(spec: TenantSpec, instance_id: str, sizes: list[int],
                   owners: tuple[int, ...]) -> TenantPlacement:
    return TenantPlacement(
        tenant=spec.key, engine_id=spec.engine_id,
        engine_version=spec.engine_version,
        engine_variant=spec.engine_variant, instance_id=instance_id,
        owners=tuple(owners), partition_bytes=tuple(sizes),
        quota_qps=spec.quota_qps, quota_burst=spec.quota_burst,
        weight=spec.weight, max_concurrency=spec.max_concurrency)


def build_fleet_plan(storage, name: str, specs: list[TenantSpec],
                     n_shards: int, n_replicas: int,
                     memory_budget_bytes: int = 0) -> FleetPlan:
    """Pack every tenant from scratch (a fresh pool deploy): resolve
    each engine's instance, FFD-pack all partitions globally, persist
    every tenant's artifacts under its packed owners, then the plan.
    Deterministic end to end: same instances -> byte-identical plan."""
    resolved = []
    seen: set[str] = set()
    for spec in sorted(specs, key=lambda s: s.key):
        if spec.key in seen:
            raise ValueError(f"tenant {spec.key!r} listed twice")
        seen.add(spec.key)
        instance, model = _resolve_spec(storage, spec)
        resolved.append((spec, instance, model, partition_sizes(model)))
    owners = pack_partitions(
        {spec.key: sizes for spec, _i, _m, sizes in resolved},
        n_shards, memory_budget_bytes)
    placements = []
    for spec, instance, model, sizes in resolved:
        persist_tenant_artifacts(storage, instance.id, model, n_shards,
                                 n_replicas, owners[spec.key])
        placements.append(
            _placement_for(spec, instance.id, sizes, owners[spec.key]))
    plan = FleetPlan(name=name, n_shards=n_shards, n_replicas=n_replicas,
                     memory_budget_bytes=memory_budget_bytes,
                     tenants=tuple(placements))
    save_fleet_plan(storage, plan)
    log.info("fleet plan %r: %d tenants packed on %d shards (loads %s)",
             name, len(placements), n_shards, plan.shard_loads())
    return plan


def join_fleet_plan(storage, name: str, spec: TenantSpec,
                    n_shards: int = 2, n_replicas: int = 2,
                    memory_budget_bytes: int = 0,
                    ) -> tuple[FleetPlan, TenantPlacement]:
    """Incremental join (``pio deploy --fleet-join``): pack ONLY the
    joining tenant's partitions into the pool's remaining capacity —
    resident tenants' placements never move (moving them live is the
    reshard problem, refused for multi-tenant plans in v1). Re-joining
    an existing tenant re-places it (a retrained instance), against the
    OTHER tenants' loads. Creates the plan when the pool is new."""
    plan = load_fleet_plan(storage, name)
    if plan is None:
        plan = FleetPlan(name=name, n_shards=n_shards,
                         n_replicas=n_replicas,
                         memory_budget_bytes=memory_budget_bytes)
    instance, model = _resolve_spec(storage, spec)
    sizes = partition_sizes(model)
    others = tuple(t for t in plan.tenants if t.tenant != spec.key)
    base = FleetPlan(name=plan.name, n_shards=plan.n_shards,
                     n_replicas=plan.n_replicas,
                     memory_budget_bytes=plan.memory_budget_bytes,
                     tenants=others, version=plan.version)
    owners = pack_partitions(
        {spec.key: sizes}, plan.n_shards, plan.memory_budget_bytes,
        base_loads=base.shard_loads())[spec.key]
    persist_tenant_artifacts(storage, instance.id, model, plan.n_shards,
                             plan.n_replicas, owners)
    placement = _placement_for(spec, instance.id, sizes, owners)
    plan = dataclasses.replace(
        base, tenants=tuple(sorted(others + (placement,),
                                   key=lambda t: t.tenant)))
    save_fleet_plan(storage, plan)
    log.info("tenant %s joined fleet %r: %d bytes over shards %s",
             spec.key, name, placement.total_bytes(),
             sorted(set(owners)))
    return plan, placement


def remove_tenant(storage, name: str, key: str) -> FleetPlan:
    """``pio undeploy --tenant``: drop a tenant from the plan (its
    partition blobs stay with the instance — they are the instance's
    artifacts, reusable by a solo redeploy)."""
    plan = load_fleet_plan(storage, name)
    if plan is None:
        raise ValueError(f"fleet {name!r} has no recorded plan")
    if plan.tenant(key) is None:
        raise ValueError(
            f"tenant {key!r} is not on fleet {name!r} "
            f"(tenants: {[t.tenant for t in plan.tenants]})")
    plan = dataclasses.replace(
        plan, tenants=tuple(t for t in plan.tenants if t.tenant != key))
    save_fleet_plan(storage, plan)
    return plan


# -- runtime: tenant-mux shard host ------------------------------------------

class MultiTenantShardHost:
    """One pool slot: a single-tenant ShardServer per placed tenant
    behind one transport, routed by X-Pio-Tenant. Per-tenant admission
    (backstop buckets + concurrency caps) rides the same 429 +
    Retry-After discipline as the transport LoadShedder."""

    def __init__(self, storage, fleet_plan: FleetPlan, shard_index: int,
                 ip: str = "127.0.0.1", server_key: str = "",
                 backend: str = "threaded", device=None):
        from pio_tpu_torch.utils.time import utcnow

        # every tenant's partition lives on this device (CUDA unless the
        # caller asks for the CPU; raises without CUDA)
        self.device = str(resolve_device(device))
        self.storage = storage
        self.fleet_name = fleet_plan.name
        self.fleet_plan = fleet_plan
        self.shard_index = shard_index
        self.ip = ip
        self.server_key = server_key
        self.backend = backend
        self.start_time = utcnow()
        self.admission = TenantAdmission()
        self._lock = threading.Lock()
        self._stop_requested = threading.Event()
        self.servers: dict[str, object] = {}
        self.apps: dict[str, object] = {}
        for placement in fleet_plan.tenants:
            self.attach(placement)

    def _backstop_quota(self, placement: TenantPlacement) -> TenantQuota:
        q = placement.quota()
        rate = q.rate * SHARD_QUOTA_HEADROOM if q.rate > 0 else 0.0
        burst = q.burst * SHARD_QUOTA_HEADROOM if q.burst > 0 else 0.0
        return TenantQuota(rate=rate, burst=burst, weight=q.weight,
                           max_concurrency=q.max_concurrency)

    def attach(self, placement: TenantPlacement) -> None:
        """Load one tenant's ShardServer (idempotent per tenant key:
        re-attach swaps in a fresh server for a re-placed tenant)."""
        from pio_tpu_torch.serving_fleet.shard import (
            ShardConfig, ShardServer, build_shard_app,
        )

        cfg = ShardConfig(
            ip=self.ip, port=0, shard_index=self.shard_index,
            n_shards=self.fleet_plan.n_shards,
            engine_id=placement.engine_id,
            engine_version=placement.engine_version,
            engine_variant=placement.engine_variant,
            # unpinned: a corrupt partition blob falls back to the
            # previous COMPLETED partitioned instance (last-good),
            # exactly like a single-tenant shard
            instance_id="",
            server_key=self.server_key,
            # the PACKER enforced the pool budget; a per-server budget
            # here would double-count co-residents
            memory_budget_bytes=0,
            backend=self.backend,
            tenant=placement.tenant,
            # no retrieval block: a pool tenant serves exact (module
            # docstring)
            device=self.device,
        )
        # built (its partition loaded onto the device and its warm
        # dispatch run) OUTSIDE the host lock: co-tenants keep scoring
        # through a live attach
        srv = ShardServer(self.storage, cfg)
        with self._lock:
            old = self.servers.get(placement.tenant)
            self.servers[placement.tenant] = srv
            self.apps[placement.tenant] = build_shard_app(srv)
        if old is not None:
            old.release()
        self.admission.configure(placement.tenant,
                                 self._backstop_quota(placement))

    def detach(self, key: str) -> bool:
        with self._lock:
            srv = self.servers.pop(key, None)
            found = self.apps.pop(key, None) is not None
        # pio: lint-ok[attr-no-lock] TenantAdmission.remove takes
        # its own lock; called outside ours to keep lock order flat
        self.admission.remove(key)
        if srv is not None:
            # the tenant's item slices leave the device with it
            srv.release()
        return found

    def refresh_plan(self) -> FleetPlan:
        plan = load_fleet_plan(self.storage, self.fleet_name)
        if plan is None:
            raise ValueError(f"fleet {self.fleet_name!r} has no plan")
        self.fleet_plan = plan
        return plan

    def info(self) -> dict:
        from pio_tpu_torch.utils.time import format_time

        with self._lock:
            servers = dict(self.servers)
        return {
            "role": "shard-host",
            "fleet": self.fleet_name,
            "shardIndex": self.shard_index,
            "nShards": self.fleet_plan.n_shards,
            "device": self.device,
            "startTime": format_time(self.start_time),
            "tenants": {key: srv.info() for key, srv in
                        sorted(servers.items())},
        }


class _HostMuxApp:
    """The tenant mux in front of a MultiTenantShardHost: a request
    carrying X-Pio-Tenant is admission-checked (scoring paths) and
    delegated to that tenant's single-tenant shard app — which re-
    validates the header against its own config (both halves of the
    header contract stay enforced). Headerless requests hit the host's
    own surface (info, health, metrics, attach/detach)."""

    def __init__(self, host: MultiTenantShardHost):
        from pio_tpu_torch.server.http import HttpApp

        self.host = host
        self._own = HttpApp(f"shard-host{host.shard_index}")
        self.name = self._own.name
        self.routes = self._own.routes   # transports introspect this
        _install_host_routes(self._own, host)
        self.tracer = None

    def dispatch(self, req):
        from pio_tpu_torch.server.http import json_response

        host = self.host
        key = req.header(TENANT_HEADER.lower())
        if not key:
            return self._own.dispatch(req)
        with host._lock:
            app = host.apps.get(key)
        if app is None:
            return 404, {
                "message": f"tenant-unknown: {key!r} is not placed on "
                           f"host shard{host.shard_index} of fleet "
                           f"{host.fleet_name!r}"}
        if req.method == "POST" and req.path in ADMITTED_SHARD_PATHS:
            ok, retry_after, reason = host.admission.admit(key)
            if not ok:
                return 429, json_response(
                    {"message": f"tenant {key} shed at shard host "
                                f"({reason})"},
                    {"Retry-After": f"{max(1, round(retry_after))}",
                     TENANT_HEADER: key})
            try:
                return app.dispatch(req)
            finally:
                host.admission.release(key)
        return app.dispatch(req)


def _install_host_routes(app, host: MultiTenantShardHost) -> None:
    from pio_tpu_torch.server.http import Request, server_key_ok

    def check_server_key(req: Request) -> bool:
        return server_key_ok(req, host.server_key)

    @app.route("GET", r"/")
    def root(req: Request):
        return 200, host.info()

    @app.route("GET", r"/host/info")
    def host_info(req: Request):
        return 200, host.info()

    @app.route("GET", r"/healthz")
    def healthz(req: Request):
        return 200, {"status": "ok"}

    @app.route("GET", r"/readyz")
    def readyz(req: Request):
        """Host-level readiness: every attached tenant has a serving
        partition. Per-tenant probers use the tenant-scoped /readyz
        (through the mux), so ONE broken tenant fails ITS probes, not
        this aggregate-but-informational surface."""
        with host._lock:
            servers = dict(host.servers)
        tenants = {}
        ok = True
        for key, srv in sorted(servers.items()):
            with srv._lock:
                part = srv.partition
            t_ok = part is not None
            ok = ok and t_ok
            tenants[key] = {
                "ok": t_ok,
                "engineInstanceId": part.instance_id if part else None,
            }
        return (200 if ok else 503), {"ok": ok, "tenants": tenants}

    @app.route("GET", r"/metrics\.json")
    def metrics_json(req: Request):
        """The pool slot's device, the process's kernel launches (every
        host and tenant of one process share them) and each tenant's
        scoring dispatches by route and RPCs by codec."""
        from pio_tpu_torch.ops.kernels import launch_counts

        with host._lock:
            servers = dict(host.servers)
        tenants = {}
        for key, srv in sorted(servers.items()):
            with srv._lock:
                tenants[key] = {
                    "scoringDispatches": dict(srv.scoring_dispatches),
                    "rpcCodecCounts": dict(srv.rpc_codec_counts),
                }
        return 200, {"role": "shard-host", "fleet": host.fleet_name,
                     "shardIndex": host.shard_index,
                     "device": host.device,
                     "kernelLaunches": launch_counts(),
                     "admission": host.admission.snapshot(),
                     "tenants": tenants}

    @app.route("GET", r"/metrics")
    def metrics_prometheus(req: Request):
        """Pool-slot exposition with the `tenant=` label on every
        per-tenant sample (docs/observability.md)."""
        from pio_tpu_torch.server.http import RawResponse
        from pio_tpu_torch.utils.tracing import (
            PROMETHEUS_CONTENT_TYPE, prometheus_labeled_counter,
        )

        base = {"surface": "shard-host",
                "shard": str(host.shard_index)}
        with host._lock:
            servers = dict(host.servers)
        rows_bytes, rows_shed, rows_inflight = [], [], []
        snap = host.admission.snapshot()
        for key, srv in sorted(servers.items()):
            labels = {**base, "tenant": key}
            with srv._lock:
                part = srv.partition
            rows_bytes.append(
                (labels, float(part.nbytes() if part else 0)))
            t = snap.get(key, {})
            rows_shed.append((labels, float(t.get("shedTotal", 0))))
            rows_inflight.append((labels, float(t.get("inflight", 0))))
        text = ""
        text += "\n".join(prometheus_labeled_counter(
            "tenant_partition_bytes", rows_bytes, mtype="gauge")) + "\n"
        text += "\n".join(prometheus_labeled_counter(
            "tenant_shed_total", rows_shed)) + "\n"
        text += "\n".join(prometheus_labeled_counter(
            "tenant_inflight", rows_inflight, mtype="gauge")) + "\n"
        return 200, RawResponse(text, PROMETHEUS_CONTENT_TYPE)

    @app.route("POST", r"/host/attach_tenant")
    def attach_tenant(req: Request):
        """Fleet-join fan-in: re-read the stored FleetPlan and attach
        (or re-attach) the named tenant. Guarded — it loads a model for
        production traffic."""
        if not check_server_key(req):
            return 401, {"message": "Invalid accessKey."}
        body = req.json()
        if not isinstance(body, dict) or not body.get("tenant"):
            return 400, {"message": "body must be {\"tenant\": key}"}
        key = str(body["tenant"])
        try:
            plan = host.refresh_plan()
        except ValueError as e:
            return 409, {"message": str(e)}
        placement = plan.tenant(key)
        if placement is None:
            return 404, {"message": f"tenant {key!r} is not on fleet "
                                    f"{host.fleet_name!r}"}
        try:
            host.attach(placement)
        except Exception as e:  # noqa: BLE001 - missing/corrupt blobs
            return 503, {"message": f"{type(e).__name__}: {e}"}
        return 200, {"message": "tenant attached", "tenant": key}

    @app.route("POST", r"/host/detach_tenant")
    def detach_tenant(req: Request):
        if not check_server_key(req):
            return 401, {"message": "Invalid accessKey."}
        body = req.json()
        if not isinstance(body, dict) or not body.get("tenant"):
            return 400, {"message": "body must be {\"tenant\": key}"}
        found = host.detach(str(body["tenant"]))
        return 200, {"message": "tenant detached" if found
                     else "tenant was not attached",
                     "tenant": body["tenant"]}

    @app.route("POST", r"/stop")
    def stop(req: Request):
        if not check_server_key(req):
            return 401, {"message": "Invalid accessKey."}
        host._stop_requested.set()
        return 200, {"message": "Shutting down."}


def create_shard_host(storage, fleet_plan: FleetPlan, shard_index: int,
                      ip: str = "127.0.0.1", port: int = 0,
                      server_key: str = "", backend: str = "threaded",
                      device=None,
                      ) -> tuple[object, MultiTenantShardHost]:
    """-> (http transport, host); start() the transport yourself. The
    tenants' partitions live on ``device`` (CUDA unless the caller asks
    for the CPU)."""
    from pio_tpu_torch.server.http import AsyncHttpServer, HttpServer

    host = MultiTenantShardHost(storage, fleet_plan, shard_index, ip=ip,
                                server_key=server_key, backend=backend,
                                device=device)
    server_cls = AsyncHttpServer if backend == "async" else HttpServer
    http = server_cls(_HostMuxApp(host), host=ip, port=port)
    return http, host


# -- runtime: multi-tenant router front --------------------------------------

class MultiFleetRouter:
    """One single-tenant FleetRouter per tenant (per-tenant breakers,
    deadlines, probers, degraded state, chaos scope) + the shared
    admission stage, behind one front app."""

    def __init__(self, storage, fleet_plan: FleetPlan,
                 endpoints: list[list[str]], server_key: str = "",
                 router_config=None, admission_watermark: int = 0,
                 device=None):
        from pio_tpu_torch.serving_fleet.router import RouterConfig
        from pio_tpu_torch.utils.time import utcnow

        self.storage = storage
        self.fleet_plan = fleet_plan
        self.endpoints = endpoints
        self.server_key = server_key
        self.start_time = utcnow()
        # every tenant's router is a replace() of this one, so each
        # ranks its whiteLists on ``device`` (CUDA unless the caller
        # asks for the CPU)
        self.base_config = router_config or RouterConfig()
        if device is not None:
            self.base_config = dataclasses.replace(self.base_config,
                                                   device=str(device))
        self.device = str(resolve_device(self.base_config.device))
        self.admission = TenantAdmission(watermark=admission_watermark)
        self._lock = threading.Lock()
        self._stop_requested = threading.Event()
        self.routers: dict[str, object] = {}
        try:
            for placement in fleet_plan.tenants:
                self.attach(placement)
        except BaseException:
            self.close()
            raise

    def attach(self, placement: TenantPlacement) -> None:
        from pio_tpu_torch.serving_fleet.router import FleetRouter

        plan = load_plan(self.storage, placement.instance_id)
        if plan is None:
            raise ValueError(
                f"tenant {placement.tenant!r}: instance "
                f"{placement.instance_id} has no recorded shard plan")
        rc = dataclasses.replace(
            self.base_config,
            engine_id=placement.engine_id,
            engine_version=placement.engine_version,
            engine_variant=placement.engine_variant,
            server_key=self.base_config.server_key or self.server_key,
            tenant=placement.tenant,
            chaos_prefix=f"fleet.{tenant_label(placement.tenant)}",
        )
        router = FleetRouter(self.storage, rc, plan, self.endpoints)
        with self._lock:
            old = self.routers.get(placement.tenant)
            self.routers[placement.tenant] = router
        if old is not None:
            old.close()
        self.admission.configure(placement.tenant, placement.quota())

    def detach(self, key: str) -> bool:
        with self._lock:
            router = self.routers.pop(key, None)
        # pio: lint-ok[attr-no-lock] TenantAdmission.remove takes
        # its own lock; called outside ours to keep lock order flat
        self.admission.remove(key)
        if router is not None:
            router.close()
        return router is not None

    def router_for(self, key: str):
        with self._lock:
            return self.routers.get(key)

    def tenant_keys(self) -> list[str]:
        with self._lock:
            return sorted(self.routers)

    def refresh_plan(self) -> FleetPlan:
        plan = load_fleet_plan(self.storage, self.fleet_plan.name)
        if plan is None:
            raise ValueError(
                f"fleet {self.fleet_plan.name!r} has no plan")
        self.fleet_plan = plan
        return plan

    def fleet_status(self) -> dict:
        from pio_tpu_torch.utils.time import format_time

        with self._lock:
            routers = dict(self.routers)
        quota = self.admission.snapshot()
        tenants = {}
        for key in sorted(routers):
            placement = self.fleet_plan.tenant(key)
            tenants[key] = {
                "placement": {
                    "instanceId": placement.instance_id,
                    "owners": list(placement.owners),
                    "partitionBytes": placement.total_bytes(),
                    "shardBytes": placement.shard_bytes(
                        self.fleet_plan.n_shards),
                } if placement else None,
                "quota": quota.get(key),
                "status": routers[key].fleet_status(),
            }
        return {
            "fleet": self.fleet_plan.name,
            "multiTenant": True,
            "nShards": self.fleet_plan.n_shards,
            "nReplicas": self.fleet_plan.n_replicas,
            "memoryBudgetBytes": self.fleet_plan.memory_budget_bytes,
            "shardLoads": self.fleet_plan.shard_loads(),
            "startTime": format_time(self.start_time),
            "tenants": tenants,
        }

    def close(self) -> None:
        self._stop_requested.set()
        with self._lock:
            routers = list(self.routers.values())
            self.routers.clear()
        for r in routers:
            r.close()


def build_multi_router_app(mt: MultiFleetRouter):
    from pio_tpu_torch.resilience import (
        CircuitOpenError, Deadline, DeadlineExceeded,
    )
    from pio_tpu_torch.server.http import (
        HttpApp, Request, json_response, server_key_ok,
    )
    from pio_tpu_torch.utils.httpclient import HttpClientError, JsonHttpClient

    app = HttpApp("multi-fleet-router")

    def check_server_key(req: Request) -> bool:
        return server_key_ok(req, mt.server_key)

    def _resolve_tenant(req: Request):
        """-> (tenant key, error response). The X-Pio-Tenant header is
        authoritative; ?tenant= covers curl-style clients; a single-
        tenant pool routes headerless requests to its only tenant."""
        key = req.header(TENANT_HEADER.lower()) or req.params.get(
            "tenant", "")
        keys = mt.tenant_keys()
        if not key:
            if len(keys) == 1:
                return keys[0], None
            return None, (400, {
                "message": f"multi-tenant fleet: send {TENANT_HEADER} "
                           f"(or ?tenant=) naming one of {keys}"})
        if mt.router_for(key) is None:
            return None, (404, {
                "message": f"tenant-unknown: {key!r} is not on fleet "
                           f"{mt.fleet_plan.name!r} (tenants: {keys})"})
        return key, None

    def _admitted(key: str, fn):
        """Admission + the single-tenant _budgeted error policy, per
        tenant: quota/fairness sheds answer 429 + Retry-After with the
        tenant named, breaker/deadline failures 503 + Retry-After."""
        ok, retry_after, reason = mt.admission.admit(key)
        if not ok:
            return 429, json_response(
                {"message": f"tenant {key} over {reason} "
                            f"(Retry-After honors the refill)",
                 "tenant": key, "reason": reason},
                {"Retry-After": f"{max(1, round(retry_after))}",
                 TENANT_HEADER: key})
        try:
            cfg = mt.base_config
            if cfg.request_budget_s > 0:
                with Deadline.budget(cfg.request_budget_s):
                    return 200, fn()
            return 200, fn()
        except KeyError as e:
            return 400, {"message": f"query missing field {e}"}
        except DeadlineExceeded as e:
            return 503, json_response(
                {"message": f"request budget exhausted: {e}",
                 "tenant": key},
                {"Retry-After": "1"})
        except CircuitOpenError as e:
            return 503, json_response(
                {"message": str(e), "tenant": key},
                {"Retry-After": f"{max(1, round(e.retry_after_s))}"})
        finally:
            mt.admission.release(key)

    @app.route("GET", r"/")
    def root(req: Request):
        from pio_tpu_torch.utils.time import format_time

        return 200, {
            "status": "alive",
            "role": "multi-fleet-router",
            "fleet": mt.fleet_plan.name,
            "multiTenant": True,
            "tenants": mt.tenant_keys(),
            "nShards": mt.fleet_plan.n_shards,
            "nReplicas": mt.fleet_plan.n_replicas,
            "startTime": format_time(mt.start_time),
        }

    @app.route("POST", r"/queries\.json")
    def queries(req: Request):
        key, err = _resolve_tenant(req)
        if err:
            return err
        q = req.json()
        return _admitted(key, lambda: mt.router_for(key).query(q))

    @app.route("POST", r"/batch/queries\.json")
    def batch_queries(req: Request):
        key, err = _resolve_tenant(req)
        if err:
            return err
        body = req.json()
        if not isinstance(body, list):
            return 400, {"message": "batch body must be a JSON array"}
        return _admitted(
            key, lambda: mt.router_for(key).query_batch(body))

    @app.route("POST", r"/fleet/upsert_users")
    def fleet_upsert_users(req: Request):
        """Tenant-scoped fold-in fan (pio_tpu_torch/freshness/).
        Guarded like the single-tenant route — it mutates serving
        partitions."""
        if not check_server_key(req):
            return 401, {"message": "Invalid accessKey."}
        key, err = _resolve_tenant(req)
        if err:
            return err
        body = req.json()
        if not isinstance(body, dict) or not isinstance(
                body.get("users"), dict):
            return 400, {"message": "body must be {\"users\": {id: [row]}}"}
        out = mt.router_for(key).upsert_users(
            body["users"], body.get("stalenessSeconds"))
        return 200, out

    @app.route("GET", r"/fleet\.json")
    def fleet_json(req: Request):
        return 200, mt.fleet_status()

    @app.route("GET", r"/metrics\.json")
    def metrics_json(req: Request):
        with mt._lock:
            routers = dict(mt.routers)
        return 200, {
            "fleet": mt.fleet_plan.name,
            "admission": mt.admission.snapshot(),
            "tenants": {
                key: {"spans": r.tracer.snapshot(),
                      "rpcCodecCounts": dict(r.rpc_codec_counts)}
                for key, r in sorted(routers.items())
            },
        }

    @app.route("GET", r"/metrics")
    def metrics_prometheus(req: Request):
        """One scrape for the whole front: per-tenant admission
        counters + each tenant router's degraded/rerouted counts, all
        under the `tenant=` label (docs/observability.md)."""
        from pio_tpu_torch.server.http import RawResponse
        from pio_tpu_torch.utils.tracing import (
            PROMETHEUS_CONTENT_TYPE, prometheus_labeled_counter,
        )

        base = {"surface": "router", "fleet": mt.fleet_plan.name}
        snap = mt.admission.snapshot()
        with mt._lock:
            routers = dict(mt.routers)
        rows_admitted, rows_shed, rows_deg = [], [], []
        for key in sorted(routers):
            labels = {**base, "tenant": key}
            t = snap.get(key, {})
            rows_admitted.append(
                (labels, float(t.get("admitted", 0))))
            rows_shed.append((labels, float(t.get("shedTotal", 0))))
            with routers[key]._lock:
                rows_deg.append(
                    (labels, float(routers[key].degraded_count)))
        text = ""
        text += "\n".join(prometheus_labeled_counter(
            "tenant_requests_total", rows_admitted)) + "\n"
        text += "\n".join(prometheus_labeled_counter(
            "tenant_shed_total", rows_shed)) + "\n"
        text += "\n".join(prometheus_labeled_counter(
            "degraded_responses_total", rows_deg)) + "\n"
        return 200, RawResponse(text, PROMETHEUS_CONTENT_TYPE)

    def _fan_hosts(op_path: str, key: str) -> dict:
        results = {}
        for s, urls in enumerate(mt.endpoints):
            for r, url in enumerate(urls):
                client = JsonHttpClient(url, timeout=30.0)
                try:
                    client.request(
                        "POST", op_path, {"tenant": key},
                        params={"accessKey": mt.server_key}
                        if mt.server_key else None)
                    results[f"shard{s}/replica{r}"] = {"ok": True}
                except HttpClientError as e:
                    results[f"shard{s}/replica{r}"] = {
                        "ok": False, "error": e.message}
        return results

    @app.route("POST", r"/fleet/attach_tenant")
    def attach_tenant(req: Request):
        """Runtime fleet-join: after ``pio deploy --fleet-join`` wrote
        the new placement, fan attach to every pool host, then start
        the tenant's router. Guarded — it routes production traffic."""
        if not check_server_key(req):
            return 401, {"message": "Invalid accessKey."}
        body = req.json()
        if not isinstance(body, dict) or not body.get("tenant"):
            return 400, {"message": "body must be {\"tenant\": key}"}
        key = str(body["tenant"])
        try:
            plan = mt.refresh_plan()
        except ValueError as e:
            return 409, {"message": str(e)}
        placement = plan.tenant(key)
        if placement is None:
            return 404, {"message": f"tenant {key!r} is not on fleet "
                                    f"{plan.name!r} — run pio deploy "
                                    f"--fleet-join first"}
        hosts = _fan_hosts("/host/attach_tenant", key)
        if not all(h["ok"] for h in hosts.values()):
            return 503, {"message": "tenant attach failed on some "
                                    "hosts", "hosts": hosts}
        try:
            mt.attach(placement)
        except ValueError as e:
            return 409, {"message": str(e)}
        return 200, {"message": "tenant attached", "tenant": key,
                     "hosts": hosts}

    @app.route("POST", r"/fleet/detach_tenant")
    def detach_tenant(req: Request):
        if not check_server_key(req):
            return 401, {"message": "Invalid accessKey."}
        body = req.json()
        if not isinstance(body, dict) or not body.get("tenant"):
            return 400, {"message": "body must be {\"tenant\": key}"}
        key = str(body["tenant"])
        found = mt.detach(key)
        hosts = _fan_hosts("/host/detach_tenant", key)
        return 200, {"message": "tenant detached" if found
                     else "tenant was not attached",
                     "tenant": key, "hosts": hosts}

    @app.route("POST", r"/reshard/begin")
    def reshard_begin(req: Request):
        """v1 refusal (docs/serving.md "Resharding a multi-tenant
        fleet"): the epoch machinery migrates ONE instance's
        partitions; moving co-residents safely is a re-pack."""
        if not check_server_key(req):
            return 401, {"message": "Invalid accessKey."}
        return 409, {
            "message": "resharding a multi-tenant fleet is not "
                       "supported in v1: re-pack with pio deploy "
                       "--fleet-join onto a pool of the target size "
                       "and cut traffic over (docs/serving.md)"}

    @app.route("GET", r"/reshard/status")
    def reshard_status(req: Request):
        if not check_server_key(req):
            return 401, {"message": "Invalid accessKey."}
        return 200, {"inFlight": False, "multiTenant": True}

    @app.route("POST", r"/reload")
    def reload(req: Request):
        if not check_server_key(req):
            return 401, {"message": "Invalid accessKey."}
        with mt._lock:
            routers = dict(mt.routers)
        return 200, {"tenants": {key: r.reload()
                                 for key, r in sorted(routers.items())}}

    @app.route("GET", r"/healthz")
    def healthz(req: Request):
        return 200, {"status": "ok"}

    @app.route("GET", r"/readyz")
    def readyz(req: Request):
        """Ready while EVERY tenant has >= 1 routable replica per shard
        group — per-tenant detail included, so doctor attributes a
        failure to the affected tenant, not the plane."""
        with mt._lock:
            routers = dict(mt.routers)
        tenants = {}
        ok = True
        for key, r in sorted(routers.items()):
            health = r.shard_health()
            t_ok = all(g["ok"] for g in health.values())
            ok = ok and t_ok
            tenants[key] = {
                "ok": t_ok,
                "shards": {s: g["ok"] for s, g in health.items()},
            }
        return (200 if ok else 503), {"ok": ok, "tenants": tenants}

    @app.route("POST", r"/stop")
    def stop(req: Request):
        if not check_server_key(req):
            return 401, {"message": "Invalid accessKey."}
        mt._stop_requested.set()
        return 200, {"message": "Shutting down."}

    return app


# -- deploy ------------------------------------------------------------------

@dataclass
class MultiFleetHandle:
    """Everything deploy_multi_fleet started, with one close()."""

    fleet_plan: FleetPlan
    router: MultiFleetRouter
    router_http: object
    hosts: list[tuple[object, MultiTenantShardHost]] = field(
        default_factory=list)
    endpoints: list[list[str]] = field(default_factory=list)

    def close(self) -> None:
        self.router_http.stop()
        self.router.close()
        for http, _host in self.hosts:
            http.stop()

    def wait(self) -> None:
        self.router_http.wait()


def deploy_multi_fleet(
    storage,
    name: str = FLEET_DEFAULT,
    ip: str = "127.0.0.1",
    router_port: int = 0,
    server_key: str = "",
    fleet_plan: FleetPlan | None = None,
    router_config=None,
    host_backend: str = "threaded",
    router_backend: str = "async",
    admission_watermark: int = 0,
    device=None,
) -> MultiFleetHandle:
    """Boot a whole multi-tenant pool in this process from a recorded
    (or given) FleetPlan: n_shards x n_replicas tenant-mux hosts, then
    the multi-tenant router front. Unwinds everything on failure. Every
    tenant's shards and router run on ``device``: CUDA unless the caller
    asks for the CPU (raises without CUDA)."""
    from pio_tpu_torch.server.http import AsyncHttpServer, HttpServer

    device = str(resolve_device(device))
    plan = fleet_plan or load_fleet_plan(storage, name)
    if plan is None:
        raise ValueError(
            f"fleet {name!r} has no recorded plan — join at least one "
            f"tenant with pio deploy --fleet-join first")
    if not plan.tenants:
        raise ValueError(f"fleet {name!r} has no tenants")
    hosts: list[tuple[object, MultiTenantShardHost]] = []
    endpoints: list[list[str]] = []
    router = None
    router_http = None
    try:
        for s in range(plan.n_shards):
            urls = []
            for _r in range(plan.n_replicas):
                http, host = create_shard_host(
                    storage, plan, s, ip=ip, server_key=server_key,
                    backend=host_backend, device=device)
                http.start()
                hosts.append((http, host))
                urls.append(f"http://{ip}:{http.port}")
            endpoints.append(urls)
        router = MultiFleetRouter(
            storage, plan, endpoints, server_key=server_key,
            router_config=router_config,
            admission_watermark=admission_watermark, device=device)
        server_cls = (AsyncHttpServer if router_backend == "async"
                      else HttpServer)
        router_http = server_cls(build_multi_router_app(router),
                                 host=ip, port=router_port)
        router_http.start()
    except BaseException:
        if router is not None:
            router.close()
        for http, _host in hosts:
            http.stop()
        raise
    log.info("multi-tenant fleet %r up: router http://%s:%d, %d tenants "
             "on %d shards x %d replicas", plan.name, ip,
             router_http.port, len(plan.tenants), plan.n_shards,
             plan.n_replicas)
    return MultiFleetHandle(fleet_plan=plan, router=router,
                            router_http=router_http, hosts=hosts,
                            endpoints=endpoints)
