"""Fleet bootstrap: partition at deploy time, spawn shards + router.

``deploy_fleet`` is what ``python -m pio_tpu_torch deploy --shards N
--replicas R`` runs:

  1. resolve the engine's latest COMPLETED instance (or a pinned one),
  2. partition its persisted model into N shard blobs + a plan blob
     (plan.py — recorded in MODELDATA alongside the instance),
  3. start N x R shard servers (each loading ONLY its partition onto
     the device: CUDA unless the caller asks for the CPU), and
  4. start the router front-end over their endpoints.

In-process spawning (threads, one HTTP server each) is the single-host
development/test shape; production runs each shard via
``python -m pio_tpu_torch.serving_fleet shard`` on its own host against
the shared storage — the subprocess chaos drill in
tests/test_torch_fleet.py exercises exactly that shape.
"""

from __future__ import annotations

import dataclasses
import logging
from dataclasses import dataclass, field

import torch

from pio_tpu_torch.serving_fleet.plan import (
    ShardPlan, load_plan, persist_fleet_artifacts,
)
from pio_tpu_torch.serving_fleet.router import (
    FleetRouter, RouterConfig, create_fleet_router,
)
from pio_tpu_torch.serving_fleet.shard import (
    ShardConfig, ShardServer, create_shard_server,
)
from pio_tpu_torch.workflow.checkpoint import models_from_bytes
from pio_tpu_torch.workflow.context import resolve_device

log = logging.getLogger("pio_tpu_torch.fleet")


def resolve_fleet_model(storage, engine_id: str, engine_version: str = "1",
                        engine_variant: str = "default",
                        instance_id: str | None = None, device=None):
    """-> (EngineInstance, factor model) from the persisted blob — the
    RAW persisted model (host numpy), with no algorithm deploy-prep. With
    ``device``, the model's factor tables come back as f32 tensors on
    that device (the blob's leaves may be numpy or tensors of any
    device)."""
    from pio_tpu_torch.rollout.state import latest_eligible_completed

    instances = storage.get_metadata_engine_instances()
    if instance_id:
        instance = instances.get(instance_id)
        if instance is None:
            raise ValueError(f"Engine instance {instance_id} not found")
    else:
        # rollout-eligibility gates auto-resolution (rolled-back /
        # in-flight canaries are skipped); explicit pins don't fall
        # under it — the operator asked for THAT instance
        instance = latest_eligible_completed(
            storage, engine_id, engine_version, engine_variant)
        if instance is None:
            raise ValueError(
                f"No COMPLETED engine instance found for engine "
                f"{engine_id} {engine_version} {engine_variant}. "
                "Run train first."
            )
    record = storage.get_model_data_models().get(instance.id)
    if record is None:
        raise ValueError(f"no models stored for engine instance "
                         f"{instance.id}")
    models = models_from_bytes(record.models)
    if len(models) != 1:
        raise ValueError(
            f"fleet serving supports single-algorithm factor engines; "
            f"instance {instance.id} has {len(models)} models"
        )
    model = models[0]
    if getattr(model, "factors", None) is None:
        # the other templates' models (similarproduct, classification)
        # have no factor tables to partition or fold into
        raise ValueError(
            f"fleet serving and fold-in need a factor-table model (the "
            f"recommendation template's); instance {instance.id} holds a "
            f"{type(model).__name__}")
    if device is not None:
        factors = model.factors
        model = dataclasses.replace(model, factors=dataclasses.replace(
            factors,
            user_factors=_on(factors.user_factors, device),
            item_factors=_on(factors.item_factors, device)))
    return instance, model


def _on(table, device) -> torch.Tensor:
    return torch.as_tensor(table).to(device, torch.float32)


@dataclass
class FleetHandle:
    """Everything deploy_fleet started, with one close()."""

    plan: ShardPlan
    router: FleetRouter
    router_http: object
    shards: list[tuple[object, ShardServer]] = field(default_factory=list)
    endpoints: list[list[str]] = field(default_factory=list)

    def close(self) -> None:
        self.router_http.stop()
        self.router.close()
        for http, _srv in self.shards:
            http.stop()

    def wait(self) -> None:
        self.router_http.wait()


def deploy_fleet(
    storage,
    engine_id: str,
    engine_version: str = "1",
    engine_variant: str = "default",
    n_shards: int = 2,
    n_replicas: int = 2,
    ip: str = "127.0.0.1",
    router_port: int = 0,
    instance_id: str | None = None,
    server_key: str = "",
    memory_budget_bytes: int = 0,
    repartition: bool = True,
    router_config: RouterConfig | None = None,
    shard_backend: str = "threaded",
    retrieval: dict | None = None,
    device=None,
) -> FleetHandle:
    """Partition (unless already recorded and ``repartition`` is False)
    and boot the whole fleet in this process. Returns once everything is
    bound; with port 0 everywhere, real ports live on the handle. The
    shards and the router's whiteList ranking run on ``device``: CUDA
    unless the caller asks for the CPU (raises without CUDA)."""
    if n_shards < 1 or n_replicas < 1:
        raise ValueError("need n_shards >= 1 and n_replicas >= 1")
    device = str(resolve_device(device))
    # two-stage retrieval (ops/retrieval.py): validate the engine.json
    # block ONCE before any shard boots — a typo'd knob fails the whole
    # deploy here, not shard-by-shard
    from pio_tpu_torch.ops.retrieval import RetrievalParams

    rparams = RetrievalParams.from_config(retrieval)
    instance, model = resolve_fleet_model(
        storage, engine_id, engine_version, engine_variant, instance_id)
    plan = None if repartition else load_plan(storage, instance.id)
    if plan is None or plan.n_shards != n_shards:
        plan = persist_fleet_artifacts(
            storage, instance.id, model, n_shards, n_replicas)
    # shards stay UNPINNED unless the operator pinned an instance: an
    # unpinned shard that hits a corrupt partition blob falls back to
    # the previous COMPLETED partitioned instance (last-good semantics);
    # a pin means "THAT instance", which must fail loudly instead
    shard_instance = instance_id or ""
    shards: list[tuple[object, ShardServer]] = []
    endpoints: list[list[str]] = []
    router = None
    try:
        for s in range(n_shards):
            urls = []
            for _r in range(n_replicas):
                http, srv = create_shard_server(storage, ShardConfig(
                    ip=ip, port=0, shard_index=s, n_shards=n_shards,
                    engine_id=engine_id, engine_version=engine_version,
                    engine_variant=engine_variant,
                    instance_id=shard_instance, server_key=server_key,
                    memory_budget_bytes=memory_budget_bytes,
                    backend=shard_backend,
                    retrieval=retrieval, device=device,
                ))
                http.start()
                shards.append((http, srv))
                urls.append(f"http://{ip}:{http.port}")
            endpoints.append(urls)
        base = router_config or RouterConfig()
        # replace(), not in-place mutation: the caller's config object
        # must not be silently rewritten with the fleet's internals
        rc = dataclasses.replace(
            base, ip=ip, port=router_port, engine_id=engine_id,
            engine_version=engine_version, engine_variant=engine_variant,
            server_key=base.server_key or server_key,
            retrieval_mode=rparams.mode, device=device,
        )
        router_http, router = create_fleet_router(
            storage, rc, plan, endpoints)
        router_http.start()
    except BaseException:
        # unwind everything already running: the router's prober/pool
        # threads (close()) and every shard transport — a failed deploy
        # must not leave probes hammering stopped ports
        if router is not None:
            router.close()
        for http, _srv in shards:
            http.stop()
        raise
    log.info("fleet up: router http://%s:%d, %d shards x %d replicas "
             "(instance %s)", ip, router_http.port, n_shards, n_replicas,
             instance.id)
    return FleetHandle(plan=plan, router=router, router_http=router_http,
                       shards=shards, endpoints=endpoints)
