"""Sharded, replicated serving fleet.

The single-host ``QueryServer`` (workflow/serve.py) keeps one full model
copy per process — a ceiling on both model size and availability. This
package splits the serving tier into three roles:

  * **shard plan** (``plan.py``) — a deterministic crc32c partition of
    the user/item factor tables by entity id, computed at deploy time
    from the persisted model and recorded alongside the EngineInstance
    (a plan blob + one CRC32C-framed partition blob per shard in the
    MODELDATA repository).
  * **shard servers** (``shard.py``) — each loads ONLY its partition
    (enforced by an optional memory budget) and answers row-fetch /
    partial-top-k / pair-score RPCs. Reload keeps last-good semantics:
    a corrupt partition blob falls back to the previous COMPLETED
    instance's partition, per shard.
  * **router** (``router.py``) — the query front-end: fetches the user
    row from its owner shard, fans partial-score RPCs to every shard,
    and merges top-k bit-identically to the single-host path. Every
    shard call runs under the resilience stack (per-replica
    CircuitBreaker, Deadline checked before every attempt) with
    single-attempt replica failover in preference order; with a
    whole shard group down it serves a flagged degraded response
    (popularity fallback blend) instead of a 5xx.

The shards keep their item slices on the device (CUDA unless the caller
asks for the CPU), where a clustered shard's candidate scan is the
quantized-scan kernel (K7).

``fleet.py`` boots the whole thing (``python -m pio_tpu_torch deploy
--shards N --replicas R``); ``python -m pio_tpu_torch.serving_fleet shard
...`` runs one shard server as its own process. See docs/serving.md
"Sharded fleet".

``tenancy.py`` stacks MANY engines on one pool of shard hosts: a
deterministic first-fit-decreasing packer places every tenant's virtual
partitions under the per-shard memory budget (``FleetPlan``, plan v2),
tenant-mux shard hosts route by the ``X-Pio-Tenant`` header to
per-tenant ShardServers on the device, and a multi-tenant router front
keeps per-tenant breakers/deadlines/chaos scopes plus token-bucket +
weighted-fair admission so one noisy tenant cannot take the plane down
(``python -m pio_tpu_torch deploy --fleet-join NAME`` / ``--fleet
NAME``). Pool tenants serve exact, as the JAX package's do. See
docs/serving.md "Multi-tenant fleet".
"""

from pio_tpu_torch.serving_fleet.fleet import (
    FleetHandle,
    deploy_fleet,
    resolve_fleet_model,
)
from pio_tpu_torch.serving_fleet.plan import (
    N_PARTITIONS,
    ShardPlan,
    build_plan,
    compute_reshard_owners,
    partition_model,
    partition_of,
    persist_fleet_artifacts,
    plan_diff,
    resharded_plan,
    shard_of,
    slice_partition,
)
from pio_tpu_torch.serving_fleet.reshard import (
    ReshardController,
    ReshardRecord,
    load_reshard_record,
    reshard_model_id,
)
from pio_tpu_torch.serving_fleet.router import FleetRouter, RouterConfig
from pio_tpu_torch.serving_fleet.shard import ShardConfig, ShardServer
from pio_tpu_torch.serving_fleet.tenancy import (
    FleetCapacityError,
    FleetPlan,
    MultiFleetRouter,
    TenantPlacement,
    TenantSpec,
    build_fleet_plan,
    deploy_multi_fleet,
    join_fleet_plan,
    load_fleet_plan,
    pack_partitions,
    tenant_key,
    tenant_label,
)

__all__ = [
    "FleetCapacityError",
    "FleetHandle",
    "FleetPlan",
    "FleetRouter",
    "MultiFleetRouter",
    "N_PARTITIONS",
    "ReshardController",
    "ReshardRecord",
    "RouterConfig",
    "ShardConfig",
    "ShardPlan",
    "ShardServer",
    "TenantPlacement",
    "TenantSpec",
    "build_fleet_plan",
    "build_plan",
    "compute_reshard_owners",
    "deploy_fleet",
    "deploy_multi_fleet",
    "join_fleet_plan",
    "load_fleet_plan",
    "load_reshard_record",
    "pack_partitions",
    "partition_model",
    "partition_of",
    "persist_fleet_artifacts",
    "plan_diff",
    "reshard_model_id",
    "resharded_plan",
    "resolve_fleet_model",
    "shard_of",
    "slice_partition",
    "tenant_key",
    "tenant_label",
]
