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
"Sharded fleet". The JAX package's multi-tenant pool (``tenancy.py``)
is not ported.
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

__all__ = [
    "FleetHandle",
    "FleetRouter",
    "N_PARTITIONS",
    "ReshardController",
    "ReshardRecord",
    "RouterConfig",
    "ShardConfig",
    "ShardPlan",
    "ShardServer",
    "build_plan",
    "compute_reshard_owners",
    "deploy_fleet",
    "load_reshard_record",
    "partition_model",
    "partition_of",
    "persist_fleet_artifacts",
    "plan_diff",
    "reshard_model_id",
    "resharded_plan",
    "resolve_fleet_model",
    "shard_of",
    "slice_partition",
]
