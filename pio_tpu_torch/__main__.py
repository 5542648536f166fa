"""`python -m pio_tpu_torch <verb>` — the port's command line.

Verbs ported so far:

  train    read the engine's events, train it and store a COMPLETED engine
           instance (printing its id), on the CUDA device unless --device
           cpu. The engine.json's engineFactory picks the template
           (recommendation or sequence). The run is supervised: under
           the sequence template SIGTERM or SIGINT stops it at the next
           step with a checkpoint and exit code 75 (the instance
           INTERRUPTED); the recommendation (ALS) template does not check
           for the signal, so its run goes on to COMPLETED (exit 0)
           unless a second SIGINT aborts it. --resume ID or
           --auto-resume continues an INTERRUPTED or FAILED instance from
           its step checkpoints (under --checkpoint-root, else
           $PIO_TPU_CKPT_ROOT, else $PIO_TPU_HOME/checkpoints);
           --stop-after-read and --stop-after-prepare stop early.
           --from-eval ID|latest trains with the winning algorithm
           params a sweep persisted, the instance batch-tagged
           from-eval:<id>. PIO_TPU_CHAOS injects faults
           (resilience/chaos.py).
  deploy   serve the latest COMPLETED engine instance (or
           --engine-instance-id) of the engine in --engine-dir over
           REST, on the CUDA device unless --device cpu. Storage comes
           from the PIO_STORAGE_* environment, as for `pio deploy`.
           The async transport serves unless --server-backend threaded;
           --cert/--key serve HTTPS. --coalesce-window-ms puts the
           continuous batcher in front of the device, --batch-window-ms
           the micro-batcher; --warm-query JSON runs a query (and with
           a batcher one warm batch of batch_max) before the server binds.
           --server-key (or PIO_SERVER_KEY) guards /stop, /reload,
           /batcher/window, /model/upsert_users, /rollout/* and
           /profile/*. --from-eval ID|latest serves with a sweep's
           winning algorithm params. --feedback records every answer as
           a pio_pr `predict` event in --feedback-app. With --canary
           PCT|auto, deploy is a client verb instead: it tells the
           RUNNING deploy server at --ip/--port to stage the latest
           eligible instance (or --engine-instance-id) as a guarded
           canary at PCT percent of the users, or to ramp 1 -> 5 -> 25
           -> 100 while the live guards stay green (auto, with
           --canary-min-stage-seconds and --canary-min-stage-samples).
           With --shards N [--replicas R] deploy boots the sharded
           fleet instead (serving_fleet/): the persisted model
           partitioned into N shard blobs, N x R shard servers (each
           holding its partition on the device) and the merging router
           on --ip/--port, with --shard-memory-budget-mb and
           --coalesce-window-ms (one batched RPC a shard group); TLS,
           --feedback, --warm-query and --batch-window-ms are refused
           there. The canary verbs work against the router too.
  promote  conclude a green canary on the deploy server (or fleet
           router) at --ip/--port: the candidate serves 100% and the
           PROMOTED verdict persists.
  rollback [--reason]: revert 100% of the traffic to the last-good
           instance and persist ROLLED_BACK (no reload auto-advances
           onto it again); also concludes a canary record a crashed
           server left IN_FLIGHT.
  undeploy POST /stop (with --server-key) to the deploy server at
           --ip/--port.
  reshard  --shards N: grow or shrink the RUNNING fleet behind the
           router at --ip/--port to N shard groups with no downtime
           (--endpoint for new groups, --status, --abort, --no-wait).
  eval     evaluate on the engine's evaluation folds (docs/evaluation.md),
           on the CUDA device unless --device cpu: either
           `eval <Evaluation> <ParamsGenerator>` (class mode: every
           EngineParams of the generator through Engine.eval and the
           Evaluation's metrics, the best written to --output), or
           `eval --sweep --grid JSON|--params-generator CLS` (the
           batched sweep: deterministic k-fold or time splits,
           shape-compatible ALS candidates trained as one stacked
           program, per-fold results stored durably and resumable with
           --resume-eval, the winner stored for --from-eval; other
           engines run candidate by candidate through their read_eval).
  batchpredict  JSON-lines queries in (--input), {query, prediction}
           JSON-lines out (--output), through the serving composition of
           the latest COMPLETED instance (or --engine-instance-id), in
           --batch-size device batches; no HTTP server.
  foldin   the streaming fold-in worker (docs/freshness.md): tail the
           engine's events (in the store, or over an event server's
           GET /tail/events.json long-poll with --event-server-url,
           --access-key and --tail-wait), solve refreshed user rows
           against the deployed model's item factors (on the CUDA
           device unless --device cpu) and hot-swap them into the
           deploy server at --serving-url (or the fleet through its
           router at --router-url). --once runs one cycle and
           prints its stats as JSON; otherwise it loops, with its health
           surface on --ip/--port.
  app      new | list | show | delete | trim | cleanup | data-delete |
           channel-new | channel-delete: the apps, their event data and
           channels in the PIO_STORAGE_* store.
  accesskey  new | list | delete: an app's access keys (with an
           optional event whitelist).
  eventserver  the REST ingest API (POST /events.json, the JSON and
           binary columnar /batch/events.json, the tail long-poll,
           webhooks, /stats.json, /metrics) on the async transport
           unless --server-backend threaded, with TLS options; the
           spill queue and the per-app quota at EventServerConfig's
           defaults.
  import / export  JSON-lines (optionally .gz) or Parquet files into and
           out of an app's events.
  storageserver  this host's PIO_STORAGE_* store over HTTP (/rpc,
           /rpc/columnar) for `remote`, `sharded` and `replicated`
           clients on other hosts, loopback unless --ip (then
           --server-key is required), with TLS options.

The ingest, storage, rollout, reshard and undeploy verbs touch no
tensor and take no --device.
Counterparts of ``cmd_train``, ``cmd_deploy``, ``cmd_promote``,
``cmd_rollback``, ``cmd_reshard``, ``cmd_undeploy``, ``cmd_eval``,
``cmd_batchpredict``, ``cmd_foldin``, ``cmd_app``, ``cmd_accesskey``,
``cmd_eventserver``, ``cmd_import``, ``cmd_export`` and
``cmd_storageserver`` in
``pio_tpu.tools.cli``, with the same flags, output lines and exit codes.
Not ported yet: the mesh options (--no-mesh: the port holds one device);
the multi-tenant fleet pool: deploy's --fleet, --fleet-join and
--tenant-quota-* and undeploy's --tenant.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys

from pio_tpu_torch.data.dao import AccessKey, Channel
from pio_tpu_torch.data.storage import get_storage
from pio_tpu_torch.tools import appops


def _fail(msg: str) -> int:
    print(f"[ERROR] {msg}", file=sys.stderr)
    return 1


def _load_variant(engine_dir: str) -> dict:
    path = os.path.join(engine_dir, "engine.json")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} not found. Run inside an engine directory or pass "
            "--engine-dir."
        )
    with open(path) as f:
        return json.load(f)


def _load_factory(class_path: str, engine_dir: str | None = None):
    """'pkg.module.ClassName' -> class. With engine_dir, the directory
    joins sys.path first so user-code engines next to engine.json
    resolve."""
    module_name, _, cls_name = class_path.rpartition(".")
    if not module_name:
        raise ValueError(f"invalid class path {class_path!r}")
    if engine_dir:
        d = os.path.abspath(engine_dir)
        if d not in sys.path:
            sys.path.insert(0, d)
    mod = importlib.import_module(module_name)
    return getattr(mod, cls_name)


def _engine_from_variant(variant: dict, engine_dir: str | None = None):
    factory = _load_factory(variant["engineFactory"], engine_dir)
    engine = factory.apply()
    return engine, engine.engine_params_from_variant(variant)


def _engine_ids(variant: dict, engine_dir: str) -> tuple[str, str, str]:
    engine_id = variant.get("id") or os.path.basename(
        os.path.abspath(engine_dir)
    )
    return engine_id, variant.get("engineVersion", "1"), "default"


def cmd_train(args) -> int:
    from pio_tpu_torch.controller.base import TrainingInterruption
    from pio_tpu_torch.workflow.context import create_workflow_context
    from pio_tpu_torch.workflow.lifecycle import (
        EXIT_PREEMPTED,
        TrainingPreempted,
    )
    from pio_tpu_torch.workflow.train import run_train

    if args.resume and args.auto_resume:
        return _fail("--resume and --auto-resume are mutually exclusive")
    variant = _load_variant(args.engine_dir)
    engine, ep = _engine_from_variant(variant, args.engine_dir)
    engine_id, engine_version, engine_variant = _engine_ids(
        variant, args.engine_dir)
    storage = get_storage()
    batch = args.batch or ""
    if args.from_eval:
        ep, eval_id = _apply_from_eval(engine, ep, storage, args.from_eval)
        # the batch marker says production runs the sweep's winner:
        # APPENDED to an operator-supplied batch label, never displacing
        # it (the reference's doctor matches by substring)
        batch = f"{batch} from-eval:{eval_id}".strip()
        print(f"Training with best params from evaluation {eval_id}",
              flush=True)
    ctx = create_workflow_context(storage, device=args.device)
    try:
        instance_id = run_train(
            engine, ep, storage, engine_id=engine_id,
            engine_version=engine_version, engine_variant=engine_variant,
            engine_factory=variant["engineFactory"], batch=batch,
            ctx=ctx,
            stop_after_read=args.stop_after_read,
            stop_after_prepare=args.stop_after_prepare,
            resume_instance_id=args.resume or None,
            auto_resume=args.auto_resume,
            checkpoint_root=args.checkpoint_root or None,
        )
    except TrainingPreempted as e:
        # preemption honored: checkpoint on disk, instance INTERRUPTED.
        # EXIT_PREEMPTED (75, EX_TEMPFAIL) tells supervisors this run
        # wants --resume (or --auto-resume), not a bug report.
        print(f"Training preempted ({e}); resume with: python -m "
              "pio_tpu_torch train --auto-resume", flush=True)
        return EXIT_PREEMPTED
    except TrainingInterruption as e:
        # controlled debug stop (--stop-after-read/-prepare)
        print(f"Training interrupted: {e}", flush=True)
        return 0
    print(f"Training completed. Engine instance: {instance_id}", flush=True)
    return 0


def cmd_deploy(args) -> int:
    if args.canary:
        # canary mode is a CLIENT verb: it tells the ALREADY-RUNNING
        # deploy server to stage a candidate, rather than booting one
        # (and so imports nothing of the serving stack or torch)
        if args.from_eval:
            return _fail("--from-eval does not combine with --canary: "
                         "the canary stages an already-TRAINED "
                         "instance — run `train --from-eval` "
                         "first, then canary that instance")
        return _deploy_canary_cmd(args)
    import threading

    from pio_tpu_torch.workflow.context import create_workflow_context
    from pio_tpu_torch.workflow.serve import ServingConfig, create_query_server

    variant = _load_variant(args.engine_dir)
    engine, ep = _engine_from_variant(variant, args.engine_dir)
    engine_id, engine_version, engine_variant = _engine_ids(
        variant, args.engine_dir)
    storage = get_storage()
    if args.from_eval:
        if args.shards > 0:
            return _fail("--from-eval is not supported with --shards "
                         "yet: fleet shards serve already-partitioned "
                         "model blobs; train the winner "
                         "(`train --from-eval`) and fleet-deploy "
                         "that instance")
        ep, eval_id = _apply_from_eval(engine, ep, storage, args.from_eval)
        print(f"Deploying with best params from evaluation {eval_id}",
              flush=True)
    if args.shards > 0:
        # fleet path: partition the persisted model at deploy time, boot
        # N x R shard servers + the router front-end (serving_fleet/)
        return _deploy_fleet_cmd(args, storage, engine_id, engine_version,
                                 engine_variant,
                                 retrieval=_retrieval_block(ep))
    ctx = create_workflow_context(storage, device=args.device)
    config = ServingConfig(
        ip=args.ip, port=args.port, engine_id=engine_id,
        engine_version=engine_version, engine_variant=engine_variant,
        feedback=args.feedback,
        feedback_app_name=args.feedback_app or "",
        server_key=args.server_key or os.environ.get("PIO_SERVER_KEY", ""),
        warm_query=json.loads(args.warm_query) if args.warm_query else None,
        certfile=args.cert, keyfile=args.key,
        backend=args.server_backend,
        batch_window_ms=args.batch_window_ms,
        coalesce_window_ms=args.coalesce_window_ms,
    )
    http, qs = create_query_server(
        engine, ep, storage, config, ctx=ctx,
        instance_id=args.engine_instance_id,
    )
    http.start()  # bind first: with --port 0 the real port is only known now
    scheme = "https" if http.tls else "http"
    print(f"Engine instance {qs.instance.id} deployed on "
          f"{scheme}://{args.ip}:{http.port} ({ctx.device})", flush=True)

    def watch_stop():
        qs._stop_requested.wait()
        http.stop()

    # pio: lint-ok[context-loss] deliberate detach: shutdown watcher
    # waits for /stop for the process lifetime; no request context
    threading.Thread(target=watch_stop, daemon=True).start()
    try:
        http.wait()
    except KeyboardInterrupt:
        http.stop()
    finally:
        qs.close()
    print("Server stopped.")
    return 0


def _retrieval_block(ep) -> dict | None:
    """The engine's two-stage retrieval block (ops/retrieval.py). Fleet
    shards score partitions themselves rather than through the algorithm
    instance, so `deploy --shards` must lift the block out of the
    algorithm params and hand it to the shard servers explicitly —
    otherwise an engine.json that asks for clustered retrieval would
    silently serve exact in fleet mode."""
    for _name, p in (ep.algorithms or []):
        block = p.get("retrieval") if isinstance(p, dict) \
            else getattr(p, "retrieval", None)
        if block:
            return block
    return None


def _deploy_fleet_cmd(args, storage, engine_id: str, engine_version: str,
                      engine_variant: str,
                      retrieval: dict | None = None) -> int:
    """`deploy --shards N [--replicas R]`: sharded, replicated serving
    (docs/serving.md "Sharded fleet"), the shards and the router's
    whiteList ranking on the CUDA device unless --device cpu. The router
    binds --ip/--port; shard servers take ephemeral ports (printed, and
    always discoverable via the router's /fleet.json)."""
    import threading

    from pio_tpu_torch.serving_fleet.fleet import deploy_fleet
    from pio_tpu_torch.serving_fleet.router import RouterConfig

    # fail loudly on single-host-only options rather than silently
    # ignoring them — --cert/--key especially: an operator asking for
    # TLS must never get plaintext without an error
    if args.cert or args.key:
        return _fail("TLS termination is not supported in fleet mode yet "
                     "(--shards with --cert/--key); front the router with "
                     "a TLS-terminating proxy instead")
    unsupported = [flag for flag, on in (
        ("--feedback", args.feedback),
        ("--warm-query", bool(args.warm_query)),
        ("--batch-window-ms", args.batch_window_ms > 0),
    ) if on]
    if unsupported:
        return _fail(f"{', '.join(unsupported)} not supported in fleet "
                     "mode (--shards); they configure the single-host "
                     "QueryServer")
    if args.replicas < 1:
        return _fail("--replicas must be >= 1")

    # shard endpoints must be dialable by the router, so a wildcard bind
    # resolves to loopback for the in-process fleet shape
    ip = args.ip if args.ip != "0.0.0.0" else "127.0.0.1"
    handle = deploy_fleet(
        storage,
        engine_id=engine_id, engine_version=engine_version,
        engine_variant=engine_variant,
        n_shards=args.shards, n_replicas=args.replicas,
        ip=ip,
        router_port=args.port,
        instance_id=args.engine_instance_id,
        server_key=args.server_key or os.environ.get("PIO_SERVER_KEY", ""),
        memory_budget_bytes=args.shard_memory_budget_mb * 1024 * 1024,
        shard_backend=args.server_backend,
        retrieval=retrieval,
        # continuous batching: coalesce concurrent fan-outs per shard
        # group into one batched binary frame (docs/serving.md)
        router_config=(RouterConfig(
            coalesce_window_ms=args.coalesce_window_ms)
            if args.coalesce_window_ms > 0 else None),
        device=args.device,
    )
    mode = (retrieval or {}).get("mode", "exact")
    print(f"Fleet router for instance {handle.plan.instance_id} on "
          f"http://{ip}:{handle.router_http.port} "
          f"({args.shards} shards x {args.replicas} replicas, "
          f"retrieval: {mode}, {handle.router.device})", flush=True)
    for s, urls in enumerate(handle.endpoints):
        print(f"  shard {s}: {' '.join(urls)}", flush=True)

    def watch_stop():
        handle.router._stop_requested.wait()
        handle.router_http.stop()

    # pio: lint-ok[context-loss] deliberate detach: shutdown watcher
    # waits for /stop for the process lifetime; no request context
    threading.Thread(target=watch_stop, daemon=True).start()
    try:
        handle.wait()
    except KeyboardInterrupt:
        pass
    handle.close()
    print("Fleet stopped.")
    return 0


def _rollout_call(args, method: str, path: str, body=None) -> int:
    """Shared client for the rollout verbs: a call to the running deploy
    server's /rollout surface, its JSON answer printed."""
    from pio_tpu_torch.utils.httpclient import HttpClientError, JsonHttpClient

    ip = args.ip if args.ip != "0.0.0.0" else "127.0.0.1"
    url = f"http://{ip}:{args.port}"
    key = args.server_key or os.environ.get("PIO_SERVER_KEY", "")
    client = JsonHttpClient(url, timeout=getattr(args, "timeout", 30.0))
    try:
        out = client.request(method, path, body,
                             params={"accessKey": key} if key else None)
    except HttpClientError as e:
        if e.status == 0:
            return _fail(f"no serving process at {url}: {e.message}")
        return _fail(f"{path} answered HTTP {e.status}: {e.message}")
    print(json.dumps(out, indent=2))
    return 0


def _deploy_canary_cmd(args) -> int:
    """`deploy --canary <pct|auto>` — begin a guarded rollout of the
    latest eligible COMPLETED instance (or --engine-instance-id) on the
    running server. `auto` ramps 1% -> 5% -> 25% -> 100% while guards
    stay green; a fixed pct holds there until `promote` / `rollback`."""
    spec = args.canary.strip().lower()
    body: dict = {}
    if spec == "auto":
        body["auto"] = True
    else:
        try:
            body["pct"] = int(spec)
        except ValueError:
            return _fail(f"--canary takes a percentage or 'auto', "
                         f"got {args.canary!r}")
    if args.engine_instance_id:
        body["instanceId"] = args.engine_instance_id
    if args.canary_min_stage_seconds is not None:
        body["minStageSeconds"] = args.canary_min_stage_seconds
    if args.canary_min_stage_samples is not None:
        body["minStageSamples"] = args.canary_min_stage_samples
    return _rollout_call(args, "POST", "/rollout/deploy", body)


def cmd_promote(args) -> int:
    """`promote` — conclude a green canary: the candidate becomes the
    active instance at 100% and the PROMOTED verdict is persisted (it
    survives restarts)."""
    return _rollout_call(args, "POST", "/rollout/promote", {})


def cmd_rollback(args) -> int:
    """`rollback` — one-command instant rollback: 100% of traffic
    reverts to the last-good instance atomically and the ROLLED_BACK
    verdict is persisted, so no reload ever auto-advances onto the
    rejected instance again."""
    return _rollout_call(args, "POST", "/rollout/rollback",
                         {"reason": args.reason or "operator rollback"})


def cmd_reshard(args) -> int:
    """`reshard --shards N'` — live elastic resharding: grow or shrink
    the RUNNING fleet to N' shard groups with zero downtime
    (docs/serving.md "Elastic resharding"). The router streams moved
    partitions to their new owners, double-routes affected partitions
    during the move, and flips the durable plan atomically; `--status`
    follows an in-flight migration, `--abort` restores the old plan
    bit-identical."""
    import time

    from pio_tpu_torch.utils.httpclient import HttpClientError, JsonHttpClient

    ip = args.ip if args.ip != "0.0.0.0" else "127.0.0.1"
    url = f"http://{ip}:{args.port}"
    key = args.server_key or os.environ.get("PIO_SERVER_KEY", "")
    params = {"accessKey": key} if key else None
    client = JsonHttpClient(url, timeout=args.timeout)

    def call(method, path, body=None):
        return client.request(method, path, body, params=params)

    try:
        if args.status:
            print(json.dumps(call("GET", "/reshard/status"), indent=2))
            return 0
        if args.abort:
            out = call("POST", "/reshard/abort")
            print(json.dumps(out, indent=2))
            return 0 if out.get("verdict") == "ABORTED" else 1
        if args.shards is None or args.shards < 1:
            return _fail("reshard needs --shards N' (or --status / "
                         "--abort)")
        body: dict = {"nShards": args.shards}
        if args.endpoint:
            # each --endpoint is ONE new shard group; commas separate
            # its replicas: --endpoint http://h1:9107,http://h2:9107
            body["endpoints"] = [
                [u.strip() for u in e.split(",") if u.strip()]
                for e in args.endpoint]
        out = call("POST", "/reshard/begin", body)
        if out.get("noop"):
            print(out.get("message", "nothing to do"))
            return 0
        print(f"resharding {out.get('nShardsOld')} -> "
              f"{out.get('nShardsNew')} shard(s): "
              f"{out.get('partitionsMoving')} partition(s) to move "
              f"(plan v{out.get('planVersionOld')} -> "
              f"v{out.get('planVersionNew')})", flush=True)
        if args.no_wait:
            print("migration running; follow with `reshard --status`")
            return 0
        last = -1
        while True:
            st = call("GET", "/reshard/status")
            staged = st.get("partitionsStaged", 0)
            if staged != last:
                print(f"  staged {staged}/"
                      f"{st.get('partitionsMoving', 0)} partition(s)",
                      flush=True)
                last = staged
            if not st.get("inFlight"):
                verdict = st.get("verdict")
                print(f"reshard {verdict}: "
                      f"{st.get('reason') or 'no reason recorded'}")
                return 0 if verdict == "COMMITTED" else 1
            time.sleep(0.2)
    except HttpClientError as e:
        if e.status == 0:
            return _fail(f"no fleet router at {url}: {e.message}")
        return _fail(f"HTTP {e.status}: {e.message}")


def cmd_undeploy(args) -> int:
    """POST /stop to a running deploy server (reference Console.undeploy),
    through utils/httpclient like every other outbound call."""
    from pio_tpu_torch.utils.httpclient import JsonHttpClient

    key = args.server_key or os.environ.get("PIO_SERVER_KEY", "")
    try:
        out = JsonHttpClient(f"http://{args.ip}:{args.port}",
                             timeout=10).request(
            "POST", "/stop", params={"accessKey": key} if key else None)
        print(json.dumps(out) if out is not None else "")
        return 0
    except Exception as e:  # noqa: BLE001
        return _fail(f"undeploy failed: {e}")


def _apply_from_eval(engine, ep, storage, from_eval: str):
    """Merge a sweep's winning ALGORITHM params into engine.json's
    EngineParams (datasource/preparator/serving stay the operator's —
    the sweep tuned the model, not the read). -> (merged ep, eval id)."""
    import dataclasses

    from pio_tpu_torch.tuning.records import resolve_from_eval

    eval_id, payload = resolve_from_eval(storage, from_eval)
    tuned = engine.engine_params_from_variant(
        {"algorithms": payload["variant"]["algorithms"]})
    return dataclasses.replace(ep, algorithms=tuned.algorithms), eval_id


def cmd_eval(args) -> int:
    if args.sweep:
        return _eval_sweep(args)
    if not args.evaluation_class or not args.params_generator_class:
        return _fail("eval takes either --sweep (grid mode) or "
                     "<EvaluationClass> <ParamsGeneratorClass>")
    from pio_tpu_torch.workflow.context import create_workflow_context
    from pio_tpu_torch.workflow.evaluate import run_evaluation_class

    evaluation = _load_factory(args.evaluation_class, args.engine_dir)
    generator = _load_factory(args.params_generator_class, args.engine_dir)
    storage = get_storage()
    instance_id, result = run_evaluation_class(
        evaluation, generator, storage,
        output_path=args.output or None,
        ctx=create_workflow_context(storage, device=args.device),
        workers=args.workers,
    )
    print(f"Evaluation completed. Instance: {instance_id}")
    print(f"Best score: [{result.best_score.score}]")
    print(f"Best params: {result.best_engine_params.to_json()}",
          flush=True)
    return 0


def _sweep_candidates(engine, base_ep, args) -> list:
    """The candidate grid: either an EngineParamsGenerator class (full
    EngineParams control) or a --grid JSON over the FIRST algorithm's
    params — {"lambda_": [0.01, 0.1], "rank": [8, 16]} expands to the
    cartesian product, each candidate overriding engine.json's params."""
    import dataclasses
    import itertools

    if args.params_generator:
        gen = _load_factory(args.params_generator, args.engine_dir)
        return gen.params_list()
    if not args.grid:
        raise ValueError(
            "--sweep needs --grid '{\"param\": [values...]}' (or "
            "@file.json) or --params-generator pkg.Class")
    spec = args.grid
    if spec.startswith("@"):
        with open(spec[1:]) as f:
            grid = json.load(f)
    else:
        grid = json.loads(spec)
    if not isinstance(grid, dict) or not grid:
        raise ValueError("--grid must be a non-empty JSON object of "
                         "param name -> list of values")
    base_algos = base_ep.algorithms or [("", None)]
    algo_name, algo_params = base_algos[0]
    keys = sorted(grid)           # deterministic candidate order
    values = []
    for k in keys:
        v = grid[k]
        values.append(v if isinstance(v, list) else [v])
    candidates = []
    for combo in itertools.product(*values):
        overrides = dict(zip(keys, combo))
        if dataclasses.is_dataclass(algo_params):
            try:
                p = dataclasses.replace(algo_params, **overrides)
            except TypeError:
                valid = sorted(
                    f.name for f in dataclasses.fields(algo_params))
                bad = sorted(set(overrides) - set(valid))
                raise ValueError(
                    f"--grid key(s) {bad} are not params of "
                    f"{type(algo_params).__name__} (valid: "
                    f"{', '.join(valid)})") from None
        else:
            p = {**(algo_params or {}), **overrides}
        # vary ONLY the first algorithm; a multi-algo engine keeps its
        # trailing algorithms in every candidate (and in the persisted
        # winner --from-eval deploys)
        candidates.append(dataclasses.replace(
            base_ep, algorithms=[(algo_name, p), *base_algos[1:]]))
    return candidates


def _eval_sweep(args) -> int:
    """`eval --sweep` — the batched hyperparameter sweep: grid/generator
    candidates over deterministic k-fold or event-time splits,
    shape-compatible candidates trained as ONE stacked program,
    per-fold results checkpointed durably (resume with --resume-eval),
    winner persisted as `<eval-iid>:best_params` for `train/deploy
    --from-eval`."""
    from pio_tpu_torch.obs import make_recorder
    from pio_tpu_torch.tuning import SweepConfig, parse_metric
    from pio_tpu_torch.utils.tracing import Tracer
    from pio_tpu_torch.workflow.context import create_workflow_context
    from pio_tpu_torch.workflow.evaluate import run_sweep_evaluation

    engine_dir = args.engine_dir or "."
    variant = _load_variant(engine_dir)
    engine, ep = _engine_from_variant(variant, engine_dir)
    engine_id, engine_version, engine_variant = _engine_ids(
        variant, engine_dir)
    try:
        candidates = _sweep_candidates(engine, ep, args)
        metric = parse_metric(args.metric)
        others = [parse_metric(s)
                  for s in (args.other_metrics or "").split(",")
                  if s.strip()]
    except (ValueError, OSError) as e:
        # OSError: --grid @file.json that does not exist/read — the
        # same one-line error every other argument mistake gets
        return _fail(str(e))
    config = SweepConfig(
        metric=metric, other_metrics=others,
        split=args.split, folds=args.folds, seed=args.seed,
    )
    storage = get_storage()
    ctx = create_workflow_context(storage, device=args.device)
    recorder = make_recorder("eval")
    tracer = Tracer(recorder=recorder)
    http = status = None
    if args.metrics_port is not None:
        from pio_tpu_torch.tuning.server import EvalStatus, create_eval_server

        status = EvalStatus(tracer, recorder)
        http = create_eval_server(
            status, ip=args.ip, port=args.metrics_port,
            server_key=args.server_key
            or os.environ.get("PIO_SERVER_KEY", ""))
        http.start()
        print(f"sweep metrics on http://{args.ip}:{http.port} "
              "(/healthz, /metrics, /debug/spans.json)", flush=True)
    try:
        instance_id, result = run_sweep_evaluation(
            engine, candidates, storage, config,
            engine_id=engine_id, engine_version=engine_version,
            engine_variant=engine_variant,
            batch=args.batch or "",
            output_path=args.output or None,
            resume_eval_id=args.resume_eval or None,
            ctx=ctx, tracer=tracer,
            status=status,
        )
    finally:
        if http is not None:
            http.stop()
    print(f"Sweep completed. Evaluation instance: {instance_id} "
          f"({len(candidates)} candidate(s), {args.split} x "
          f"{args.folds})")
    print(f"Best {result.metric_header}: [{result.best_score.score}] "
          f"(candidate #{result.best_idx})")
    print(f"Best params: {result.best_engine_params.to_json()}")
    print(f"Deploy the winner: python -m pio_tpu_torch train --from-eval "
          f"{instance_id} && python -m pio_tpu_torch deploy --from-eval "
          f"{instance_id}", flush=True)
    return 0


def cmd_batchpredict(args) -> int:
    """Offline bulk scoring through the full serving composition
    (workflow/batchpredict.py); no HTTP server involved."""
    import contextlib

    from pio_tpu_torch.workflow.batchpredict import run_batch_predict
    from pio_tpu_torch.workflow.context import create_workflow_context

    variant = _load_variant(args.engine_dir)
    engine, ep = _engine_from_variant(variant, args.engine_dir)
    engine_id, engine_version, engine_variant = _engine_ids(
        variant, args.engine_dir)
    storage = get_storage()
    ctx = create_workflow_context(storage, device=args.device)
    with contextlib.ExitStack() as stack:
        inp = (sys.stdin if args.input == "-"
               else stack.enter_context(open(args.input)))
        out = (sys.stdout if args.output == "-"
               else stack.enter_context(open(args.output, "w")))
        report = run_batch_predict(
            engine, ep, storage, inp, out,
            engine_id=engine_id, engine_version=engine_version,
            engine_variant=engine_variant,
            instance_id=args.engine_instance_id,
            batch_size=args.batch_size, ctx=ctx,
        )
    print(f"Batch predict done: {report.n_queries} queries"
          + (f", {report.n_errors} failed (malformed or engine-rejected; "
             "see the output's error records)" if report.n_errors else ""),
          file=sys.stderr)
    return 0


def cmd_foldin(args) -> int:
    """Training-read semantics and solver params come from the SAME
    engine.json train and deploy read, so they cannot drift from the
    model being refreshed."""
    import threading

    from pio_tpu_torch.freshness import (
        FoldInConfig,
        FoldInWorker,
        RouterFleetApplier,
        ServingHttpApplier,
        create_foldin_server,
    )
    from pio_tpu_torch.freshness.tail import HttpEventSource
    from pio_tpu_torch.ops import als

    variant = _load_variant(args.engine_dir)
    engine, ep = _engine_from_variant(variant, args.engine_dir)
    engine_id, engine_version, engine_variant = _engine_ids(
        variant, args.engine_dir)
    _, ds = ep.datasource
    _, ap = (ep.algorithms or [(None, None)])[0]
    rank = getattr(ap, "rank", None)
    if rank is None:
        return _fail("fold-in needs a factor-model engine (algorithm params "
                     "with rank/lambda_/alpha/implicit_prefs); got "
                     f"{type(ap).__name__}")
    app_name = getattr(ds, "app_name", "")
    if not app_name:
        return _fail("engine.json datasource params carry no appName")
    state_path = args.state_path or os.path.join(
        os.path.expanduser(os.environ.get("PIO_TPU_HOME", "~/.pio_tpu")),
        "foldin", f"{engine_id}-{engine_variant}.cursor")
    key = args.server_key or os.environ.get("PIO_SERVER_KEY", "")
    config = FoldInConfig(
        app_name=app_name,
        channel_name=getattr(ds, "channel_name", None),
        engine_id=engine_id, engine_version=engine_version,
        engine_variant=engine_variant,
        event_names=tuple(getattr(ds, "event_names", ("rate", "buy"))),
        value_event=getattr(ds, "rating_event", "rate"),
        default_value=getattr(ds, "implicit_value", 4.0),
        als_params=als.ALSParams(
            rank=rank,
            reg=getattr(ap, "lambda_", 0.1),
            alpha=getattr(ap, "alpha", 1.0),
            implicit=getattr(ap, "implicit_prefs", False),
        ),
        state_path=state_path,
        replay=args.replay,
        poll_interval_s=args.interval,
        max_batch_users=args.max_batch_users,
        staleness_budget_s=args.staleness_budget,
        ip=args.ip, port=args.port,
        # the key that authenticates the applies also guards the
        # folder's own /debug trace routes
        server_key=key,
    )
    if args.router_url:
        applier = RouterFleetApplier(args.router_url, key)
        target = args.router_url
    else:
        applier = ServingHttpApplier(args.serving_url, key)
        target = args.serving_url
    source = None
    if args.event_server_url:
        source = HttpEventSource(
            args.event_server_url, args.access_key,
            channel_name=config.channel_name,
            event_names=config.event_names,
            wait_s=args.tail_wait,
        )
    worker = FoldInWorker(get_storage(), config, applier, source=source,
                          device=args.device)
    if args.once:
        try:
            stats = worker.run_once()
        except Exception as e:  # noqa: BLE001 - --once reports, not loops
            print(json.dumps({"error": f"{type(e).__name__}: {e}",
                              **worker.snapshot()}))
            return 1
        print(json.dumps({**stats, **worker.snapshot()}), flush=True)
        return 0
    http = create_foldin_server(worker)
    http.start()
    worker.start()
    print(f"fold-in worker for engine {engine_id} -> {target} "
          f"(health on http://{args.ip}:{http.port}, cursor {state_path}, "
          f"{worker.device})", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    worker.stop()
    http.stop()
    print("fold-in worker stopped.")
    return 0


def cmd_app(args) -> int:
    storage = get_storage()
    apps = storage.get_metadata_apps()
    keys = storage.get_metadata_access_keys()
    channels = storage.get_metadata_channels()
    sub = args.subcommand
    if sub == "new":
        created = appops.create_app(
            storage, args.name, args.description,
            app_id=args.id or 0, access_key=args.access_key or "",
        )
        if created is None:
            return _fail(f"App {args.name} already exists.")
        app_id, key = created
        print(f"App '{args.name}' created (id {app_id}).")
        print(f"Access key: {key}")
        return 0
    if sub == "list":
        for a in sorted(apps.get_all(), key=lambda a: a.id):
            ks = keys.get_by_appid(a.id)
            print(f"{a.id:>6}  {a.name:<24} keys={len(ks)}")
        return 0
    if sub == "show":
        a = apps.get_by_name(args.name)
        if a is None:
            return _fail(f"App {args.name} does not exist.")
        print(f"App: {a.name} (id {a.id})")
        print(f"Description: {a.description or ''}")
        for k in keys.get_by_appid(a.id):
            events = ",".join(k.events) or "(all)"
            print(f"  key {k.key} events={events}")
        for c in channels.get_by_appid(a.id):
            print(f"  channel {c.id}: {c.name}")
        return 0
    if sub == "delete":
        a = apps.get_by_name(args.name)
        if a is None:
            return _fail(f"App {args.name} does not exist.")
        appops.delete_app(storage, a)
        print(f"App '{args.name}' deleted.")
        return 0
    if sub == "data-delete":
        a = apps.get_by_name(args.name)
        if a is None:
            return _fail(f"App {args.name} does not exist.")
        channel_id = None
        if args.channel:
            ch = next((c for c in channels.get_by_appid(a.id)
                       if c.name == args.channel), None)
            if ch is None:
                return _fail(f"Channel {args.channel} does not exist.")
            channel_id = ch.id
        appops.delete_app_data(storage, a, channel_id)
        print(f"Data of app '{args.name}' deleted.")
        return 0
    if sub == "trim":
        from pio_tpu_torch.utils.time import parse_time

        a = apps.get_by_name(args.name)
        if a is None:
            return _fail(f"App {args.name} does not exist.")
        dst = apps.get_by_name(args.dst)
        if dst is None:
            return _fail(f"Destination app {args.dst} does not exist "
                         "(create it with `pio app new` first).")
        try:
            counts = appops.trim_copy(
                storage, a, dst,
                start_time=parse_time(args.start) if args.start else None,
                until_time=parse_time(args.until) if args.until else None,
                channel_name=args.channel or None,
            )
        except ValueError as e:
            return _fail(str(e))
        total = sum(counts.values())
        detail = ", ".join(f"{k}: {v}" for k, v in counts.items())
        print(f"Copied {total} events from '{a.name}' to '{dst.name}' "
              f"({detail}).")
        return 0
    if sub == "cleanup":
        from pio_tpu_torch.utils.time import parse_time

        a = apps.get_by_name(args.name)
        if a is None:
            return _fail(f"App {args.name} does not exist.")
        try:
            counts = appops.cleanup_events(
                storage, a,
                until_time=parse_time(args.until),  # --until is required
                channel_name=args.channel or None,
            )
        except ValueError as e:
            return _fail(str(e))
        total = sum(counts.values())
        detail = ", ".join(f"{k}: {v}" for k, v in counts.items())
        print(f"Deleted {total} events from '{a.name}' ({detail}).")
        return 0
    if sub == "channel-new":
        a = apps.get_by_name(args.name)
        if a is None:
            return _fail(f"App {args.name} does not exist.")
        if not Channel.is_valid_name(args.channel):
            return _fail(
                f"Channel name {args.channel} is invalid "
                "(1-16 alphanumeric/dash characters)."
            )
        cid = channels.insert(Channel(0, args.channel, a.id))
        if cid is None:
            return _fail(f"Channel {args.channel} could not be created.")
        storage.get_events().init(a.id, cid)
        print(f"Channel '{args.channel}' (id {cid}) created for app "
              f"'{args.name}'.")
        return 0
    if sub == "channel-delete":
        a = apps.get_by_name(args.name)
        if a is None:
            return _fail(f"App {args.name} does not exist.")
        ch = next((c for c in channels.get_by_appid(a.id)
                   if c.name == args.channel), None)
        if ch is None:
            return _fail(f"Channel {args.channel} does not exist.")
        storage.get_events().remove(a.id, ch.id)
        channels.delete(ch.id)
        print(f"Channel '{args.channel}' deleted.")
        return 0
    return _fail(f"unknown app subcommand {sub}")


def cmd_accesskey(args) -> int:
    storage = get_storage()
    keys = storage.get_metadata_access_keys()
    if args.subcommand == "new":
        a = storage.get_metadata_apps().get_by_name(args.app_name)
        if a is None:
            return _fail(f"App {args.app_name} does not exist.")
        key = keys.insert(
            AccessKey("", a.id, tuple(args.event or ()))
        )
        print(f"Access key: {key}")
        return 0
    if args.subcommand == "list":
        app_filter = None
        if args.app_name:
            a = storage.get_metadata_apps().get_by_name(args.app_name)
            if a is None:
                return _fail(f"App {args.app_name} does not exist.")
            app_filter = a.id
        for k in keys.get_all():
            if app_filter is not None and k.appid != app_filter:
                continue
            events = ",".join(k.events) or "(all)"
            print(f"{k.key} app={k.appid} events={events}")
        return 0
    if args.subcommand == "delete":
        keys.delete(args.key)
        print(f"Access key {args.key} deleted.")
        return 0
    return _fail(f"unknown accesskey subcommand {args.subcommand}")


def cmd_eventserver(args) -> int:
    from pio_tpu_torch.server.eventserver import EventServerConfig, create_event_server

    srv = create_event_server(
        get_storage(),
        EventServerConfig(ip=args.ip, port=args.port, stats=args.stats,
                          metrics_key=args.metrics_key or "",
                          certfile=args.cert, keyfile=args.key,
                          backend=args.server_backend),
    )
    srv.start()  # bind first: with --port 0 the real port is only known now
    scheme = "https" if srv.tls else "http"
    print(f"Event Server on {scheme}://{args.ip}:{srv.port}")
    try:
        srv.wait()
    except KeyboardInterrupt:
        srv.stop()
    return 0


def cmd_storageserver(args) -> int:
    """Serve this host's configured storage to other hosts (the networked
    shared store; reference analogue: pointing every host's PIO_STORAGE_*
    at one Postgres/HBase — here one host owns the store and the rest mount
    it with the `remote` backend)."""
    from pio_tpu_torch.server.storageserver import (
        StorageServerConfig, create_storage_server,
    )

    srv = create_storage_server(
        get_storage(),
        StorageServerConfig(ip=args.ip, port=args.port,
                            server_key=args.server_key or "",
                            certfile=args.cert, keyfile=args.key),
    )
    scheme = "https" if srv.tls else "http"
    print(f"Storage Server on {scheme}://{args.ip}:{srv.port}")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


def _io_format(explicit: str | None, path: str) -> str:
    if explicit:
        return explicit
    return "parquet" if path.endswith(".parquet") else "json"


def cmd_export(args) -> int:
    from pio_tpu_torch.tools.export_import import export_events, export_events_parquet

    storage = get_storage()
    a = storage.get_metadata_apps().get(args.appid)
    if a is None:
        return _fail(f"App id {args.appid} does not exist.")
    channel_id = None
    if args.channel:
        ch = next((c for c in storage.get_metadata_channels()
                   .get_by_appid(a.id) if c.name == args.channel), None)
        if ch is None:
            return _fail(f"Channel {args.channel} does not exist.")
        channel_id = ch.id
    if _io_format(getattr(args, "format", None), args.output) == "parquet":
        n = export_events_parquet(
            storage, args.appid, args.output, channel_id=channel_id
        )
    else:
        with _open_text(args.output, "wt") as f:
            n = export_events(storage, args.appid, f, channel_id=channel_id)
    print(f"Exported {n} events to {args.output}")
    return 0


def _open_text(path: str, mode: str):
    """open() with transparent .gz (committed datasets ship gzipped)."""
    if path.endswith(".gz"):
        import gzip

        return gzip.open(path, mode, encoding="utf-8")
    return open(path, mode.rstrip("t"), encoding="utf-8")


def cmd_import(args) -> int:
    from pio_tpu_torch.tools.export_import import import_events, import_events_parquet

    if _io_format(getattr(args, "format", None), args.input) == "parquet":
        ok, failed = import_events_parquet(get_storage(), args.appid, args.input)
    else:
        with _open_text(args.input, "rt") as f:
            ok, failed = import_events(get_storage(), args.appid, f)
    print(f"Imported {ok} events ({failed} failed).")
    return 0 if failed == 0 else 1


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m pio_tpu_torch")
    sub = p.add_subparsers(dest="verb", required=True)
    x = sub.add_parser("train", help="train an engine instance")
    x.add_argument("--engine-dir", default=".")
    x.add_argument("--batch", default="")
    x.add_argument("--device", choices=["cuda", "cpu"], default=None,
                   help="training device (default cuda; cpu must be asked "
                        "for)")
    x.add_argument("--stop-after-read", action="store_true")
    x.add_argument("--stop-after-prepare", action="store_true")
    x.add_argument("--resume", default="", metavar="INSTANCE_ID",
                   help="resume an INTERRUPTED/FAILED engine instance "
                        "from its step checkpoints")
    x.add_argument("--auto-resume", action="store_true",
                   help="resume the most recent resumable instance of "
                        "this engine (fresh run when none has "
                        "checkpoints)")
    x.add_argument("--checkpoint-root", default="",
                   help="root for per-instance step-checkpoint dirs "
                        "(default $PIO_TPU_CKPT_ROOT or "
                        "$PIO_TPU_HOME/checkpoints)")
    x.add_argument("--from-eval", default="", metavar="EVAL_ID|latest",
                   help="train with the winning algorithm params an "
                        "`eval --sweep` persisted (the "
                        "<eval-iid>:best_params record); the instance "
                        "is batch-tagged from-eval:<id>")
    x.set_defaults(fn=cmd_train)
    x = sub.add_parser("deploy", help="serve an engine instance over REST")
    x.add_argument("--engine-dir", default=".")
    x.add_argument("--ip", default="0.0.0.0")
    x.add_argument("--port", type=int, default=8000)
    x.add_argument("--engine-instance-id")
    x.add_argument("--device", choices=["cuda", "cpu"], default=None,
                   help="serving device (default cuda; cpu must be asked "
                        "for)")
    x.add_argument("--feedback", action="store_true")
    x.add_argument("--feedback-app")
    x.add_argument("--server-key", default="",
                   help="guards /stop, /reload, /batcher/window, "
                        "/model/upsert_users, /rollout/* and /profile/* "
                        "(or PIO_SERVER_KEY)")
    x.add_argument("--warm-query",
                   help="a JSON query run at startup (and, with a "
                        "batcher, one warm batch of batch_max)")
    x.add_argument("--cert", help="TLS certificate (PEM) -> serve HTTPS")
    x.add_argument("--key", help="TLS private key (PEM)")
    x.add_argument("--server-backend", choices=["async", "threaded"],
                   default="async")
    x.add_argument("--batch-window-ms", type=float, default=0.0,
                   help="micro-batching: > 0 coalesces concurrent queries "
                        "within this fixed window (ms); < 0 = adaptive "
                        "continuous batching (no added wait; batch = "
                        "whatever queued during the previous execution); "
                        "0 = off")
    x.add_argument("--coalesce-window-ms", type=float, default=0.0,
                   help="continuous batching: > 0 admits queries through "
                        "a coalescing stage that merges concurrent "
                        "requests into one device dispatch; ~2 ms is the "
                        "recommended starting window. Deadline-doomed "
                        "requests dispatch solo or shed 503. 0 = off")
    x.add_argument("--shards", type=int, default=0,
                   help="> 0 deploys a SHARDED fleet: partition the "
                        "model's factor tables across this many shard "
                        "servers behind a top-k-merging router "
                        "(docs/serving.md); 0 = single-host serve")
    x.add_argument("--replicas", type=int, default=2,
                   help="replicas per shard (fleet mode; >= 2 gives warm "
                        "failover)")
    x.add_argument("--shard-memory-budget-mb", type=int, default=0,
                   help="hard cap (MB) each shard may hold; a partition "
                        "over budget fails deploy instead of lying about "
                        "capacity. 0 = unlimited")
    x.add_argument("--canary", default="", metavar="PCT|auto",
                   help="guarded rollout: tell the RUNNING deploy server "
                        "at --ip/--port to stage the latest eligible "
                        "instance (or --engine-instance-id) as a canary "
                        "at PCT percent of traffic, or 'auto' to ramp "
                        "1->5->25->100 while live guards stay green. "
                        "Conclude with `promote` / `rollback`")
    x.add_argument("--canary-min-stage-seconds", type=float, default=None,
                   help="with --canary auto: minimum seconds per stage")
    x.add_argument("--canary-min-stage-samples", type=int, default=None,
                   help="with --canary auto: minimum candidate-arm "
                        "requests per stage")
    x.add_argument("--from-eval", default="", metavar="EVAL_ID|latest",
                   help="serve with the winning algorithm params an "
                        "`eval --sweep` persisted")
    x.set_defaults(fn=cmd_deploy)
    for verb, fn, descr in (
        ("promote", cmd_promote,
         "conclude a green canary: candidate becomes the active "
         "instance at 100% (verdict persisted; survives restart)"),
        ("rollback", cmd_rollback,
         "instant rollback: revert 100% of traffic to the last-good "
         "instance and persist ROLLED_BACK (reloads never auto-advance "
         "onto it again)"),
    ):
        x = sub.add_parser(verb, help=descr)
        x.add_argument("--ip", default="127.0.0.1")
        x.add_argument("--port", type=int, default=8000,
                       help="serving server or fleet router port")
        x.add_argument("--server-key")
        if verb == "rollback":
            x.add_argument("--reason", default="",
                           help="recorded on the rollout verdict")
        x.set_defaults(fn=fn)
    x = sub.add_parser(
        "reshard",
        help="live elastic resharding: grow/shrink the RUNNING fleet "
             "to --shards N' with zero downtime (streams moved "
             "partitions, double-routes during the move, flips the "
             "plan atomically; docs/serving.md)")
    x.add_argument("--shards", type=int, default=None, metavar="N",
                   help="target shard-group count (1..32 virtual "
                        "partitions bound the range)")
    x.add_argument("--endpoint", action="append", default=None,
                   metavar="URL[,URL...]",
                   help="one NEW shard group per flag (repeatable), "
                        "commas separating its replica URLs — required "
                        "when growing past the groups the router "
                        "already knows")
    x.add_argument("--status", action="store_true",
                   help="report the in-flight (or last) migration and "
                        "exit")
    x.add_argument("--abort", action="store_true",
                   help="abort the in-flight migration: the old plan "
                        "was never touched, serving reverts "
                        "bit-identical")
    x.add_argument("--no-wait", action="store_true",
                   help="start the migration and return immediately "
                        "instead of following progress")
    x.add_argument("--ip", default="127.0.0.1")
    x.add_argument("--port", type=int, default=8000,
                   help="fleet router port")
    x.add_argument("--server-key")
    x.add_argument("--timeout", type=float, default=30.0)
    x.set_defaults(fn=cmd_reshard)
    x = sub.add_parser("undeploy", help="stop a running deploy server")
    x.add_argument("--ip", default="127.0.0.1")
    x.add_argument("--port", type=int, default=8000)
    x.add_argument("--server-key")
    x.set_defaults(fn=cmd_undeploy)
    x = sub.add_parser("eval", help="evaluate and tune an engine")
    x.add_argument("evaluation_class", nargs="?", default="")
    x.add_argument("params_generator_class", nargs="?", default="")
    x.add_argument("--engine-dir", default=None,
                   help="directory holding the user-code engine.py the "
                        "classes live in (joins sys.path); with --sweep "
                        "also where engine.json lives")
    x.add_argument("--output", default="best.json")
    x.add_argument("--workers", type=int, default=1,
                   help="params-grid parallelism (reference runs .par)")
    x.add_argument("--device", choices=["cuda", "cpu"], default=None,
                   help="evaluation device (default cuda; cpu must be "
                        "asked for)")
    x.add_argument("--sweep", action="store_true",
                   help="batched hyperparameter sweep over engine.json's "
                        "engine: shape-compatible candidates train as "
                        "ONE stacked program; per-fold results persist "
                        "durably and the winner lands in "
                        "<eval-iid>:best_params for `train/deploy "
                        "--from-eval`")
    x.add_argument("--grid", default="",
                   help="with --sweep: JSON object (or @file.json) of "
                        "algorithm-param name -> list of values; the "
                        "cartesian product is the candidate grid, e.g. "
                        "'{\"lambda_\": [0.01, 0.1], \"rank\": [8, 16]}'")
    x.add_argument("--params-generator", default="",
                   help="with --sweep: EngineParamsGenerator class path "
                        "instead of --grid (full EngineParams control)")
    x.add_argument("--metric", default="map@10",
                   help="primary metric: map@K, ndcg@K, precision@K, "
                        "recall@K, or auc (batched path only)")
    x.add_argument("--other-metrics", default="",
                   help="comma-separated supplementary metric columns")
    x.add_argument("--split", choices=["kfold", "time"], default="kfold",
                   help="kfold: seeded balanced folds over deduped "
                        "interactions; time: event-time rolling splits "
                        "(train on the past, test on the next window)")
    x.add_argument("--folds", type=int, default=3)
    x.add_argument("--seed", type=int, default=42,
                   help="kfold assignment seed (bit-reproducible)")
    x.add_argument("--resume-eval", default="", metavar="EVAL_ID",
                   help="resume a killed/failed sweep: completed folds "
                        "are read from the durable record, only the "
                        "remaining units run (result identical to an "
                        "uninterrupted sweep)")
    x.add_argument("--batch", default="",
                   help="batch label recorded on the EvaluationInstance")
    x.add_argument("--metrics-port", type=int, default=None,
                   help="with --sweep: serve /healthz /metrics "
                        "/debug/spans.json during the sweep (0 = "
                        "ephemeral port)")
    x.add_argument("--ip", default="127.0.0.1",
                   help="bind address for --metrics-port")
    x.add_argument("--server-key", default="",
                   help="guards the sweep's /debug trace routes")
    x.set_defaults(fn=cmd_eval)
    x = sub.add_parser(
        "batchpredict",
        help="offline bulk scoring: JSON-lines queries in, "
             "{query, prediction} JSON-lines out")
    x.add_argument("--engine-dir", default=".")
    x.add_argument("--input", required=True,
                   help="queries file, one JSON object per line "
                        "('-' = stdin)")
    x.add_argument("--output", required=True,
                   help="predictions file ('-' = stdout)")
    x.add_argument("--engine-instance-id")
    x.add_argument("--batch-size", type=int, default=256,
                   help="queries per device batch")
    x.add_argument("--device", choices=["cuda", "cpu"], default=None,
                   help="prediction device (default cuda; cpu must be "
                        "asked for)")
    x.set_defaults(fn=cmd_batchpredict)
    x = sub.add_parser(
        "foldin",
        help="streaming fold-in worker: tail the event stream, solve "
             "refreshed user rows against the deployed item factors, "
             "hot-swap them into serving (docs/freshness.md)")
    x.add_argument("--engine-dir", default=".")
    x.add_argument("--serving-url", default="http://127.0.0.1:8000",
                   help="single-host deploy server to apply rows to")
    x.add_argument("--router-url", default="",
                   help="fleet router base URL — apply rows through the "
                        "sharded fleet instead of --serving-url")
    x.add_argument("--event-server-url", default="",
                   help="tail a remote event server's GET /tail/events.json"
                        " (default: read the event store directly)")
    x.add_argument("--access-key", default="",
                   help="event-server app access key "
                        "(with --event-server-url)")
    x.add_argument("--server-key", default="",
                   help="serving server key (or PIO_SERVER_KEY)")
    x.add_argument("--state-path", default="",
                   help="durable cursor file (default $PIO_TPU_HOME/foldin/"
                        "<engine>-<variant>.cursor)")
    x.add_argument("--replay", action="store_true",
                   help="a FRESH cursor replays the whole event log "
                        "(re-fold every historical user) instead of "
                        "starting at now")
    x.add_argument("--interval", type=float, default=0.5,
                   help="tail poll interval (seconds)")
    x.add_argument("--tail-wait", type=float, default=10.0,
                   help="with --event-server-url: long-poll push "
                        "subscription — an idle tail blocks server-side "
                        "this many seconds for new events before "
                        "answering (0 = plain polling; pre-long-poll "
                        "servers degrade to polling automatically)")
    x.add_argument("--max-batch-users", type=int, default=1024,
                   help="fold batch cap per cycle")
    x.add_argument("--staleness-budget", type=float, default=60.0,
                   help="the folder's /readyz flips once event->servable "
                        "staleness exceeds this many seconds")
    x.add_argument("--once", action="store_true",
                   help="run exactly one tail->solve->apply cycle, print "
                        "its stats as JSON, and exit (cron-style fold-in)")
    x.add_argument("--ip", default="127.0.0.1")
    x.add_argument("--port", type=int, default=8100,
                   help="health port (/healthz /readyz /metrics.json)")
    x.add_argument("--device", choices=["cuda", "cpu"], default=None,
                   help="solve device (default cuda; cpu must be asked "
                        "for)")
    x.set_defaults(fn=cmd_foldin)
    pa = sub.add_parser("app")
    pas = pa.add_subparsers(dest="subcommand", required=True)
    x = pas.add_parser("new")
    x.add_argument("name")
    x.add_argument("--id", type=int, default=0)
    x.add_argument("--description")
    x.add_argument("--access-key", default="")
    pas.add_parser("list")
    x = pas.add_parser("show")
    x.add_argument("name")
    x = pas.add_parser("delete")
    x.add_argument("name")
    x = pas.add_parser(
        "trim", help="copy a time window of events into an EMPTY "
        "destination app (reference experimental trim-app)")
    x.add_argument("name")
    x.add_argument("dst")
    x.add_argument("--start", default="", help="ISO-8601 inclusive start")
    x.add_argument("--until", default="", help="ISO-8601 exclusive end")
    x.add_argument("--channel", default="",
                   help="copy only this named channel (all namespaces — "
                        "default + every channel — are copied otherwise)")
    x.set_defaults(fn=cmd_app, subcommand="trim")

    x = pas.add_parser(
        "cleanup", help="delete events OLDER than --until in place "
        "(reference experimental cleanup-app)")
    x.add_argument("name")
    x.add_argument("--until", required=True,
                   help="ISO-8601 exclusive cutoff: events before it go")
    x.add_argument("--channel", default="",
                   help="clean only this channel (all namespaces otherwise)")
    x.set_defaults(fn=cmd_app, subcommand="cleanup")

    x = pas.add_parser("data-delete")
    x.add_argument("name")
    x.add_argument("--channel")
    x = pas.add_parser("channel-new")
    x.add_argument("name")
    x.add_argument("channel")
    x = pas.add_parser("channel-delete")
    x.add_argument("name")
    x.add_argument("channel")
    pa.set_defaults(fn=cmd_app)

    pk = sub.add_parser("accesskey")
    pks = pk.add_subparsers(dest="subcommand", required=True)
    x = pks.add_parser("new")
    x.add_argument("app_name")
    x.add_argument("--event", action="append")
    x = pks.add_parser("list")
    x.add_argument("app_name", nargs="?")
    x = pks.add_parser("delete")
    x.add_argument("key")
    pk.set_defaults(fn=cmd_accesskey)
    x = sub.add_parser("eventserver")
    x.add_argument("--ip", default="0.0.0.0")
    x.add_argument("--port", type=int, default=7070)
    x.add_argument("--stats", action="store_true")
    x.add_argument("--metrics-key",
                   help="with --stats: enable GET /metrics (Prometheus "
                        "ingest counters, cross-app) guarded by this key")
    x.add_argument("--cert", help="TLS certificate (PEM) -> serve HTTPS")
    x.add_argument("--key", help="TLS private key (PEM)")
    x.add_argument("--server-backend", choices=["async", "threaded"],
                   default="async")
    x.set_defaults(fn=cmd_eventserver)

    x = sub.add_parser("storageserver")
    # loopback default: a non-loopback bind requires --server-key (the RPC
    # surface includes access keys and model blobs)
    x.add_argument("--ip", default="127.0.0.1")
    x.add_argument("--port", type=int, default=7072)
    x.add_argument("--server-key", help="shared secret required on every call")
    x.add_argument("--cert", help="TLS certificate (PEM) -> serve HTTPS")
    x.add_argument("--key", help="TLS private key (PEM)")
    x.set_defaults(fn=cmd_storageserver)

    x = sub.add_parser("export")
    x.add_argument("--appid", type=int, required=True)
    x.add_argument("--output", required=True)
    x.add_argument("--channel")
    x.add_argument("--format", choices=["json", "parquet"],
                   help="default: by --output extension (.parquet), else json")
    x.set_defaults(fn=cmd_export)

    x = sub.add_parser("import")
    x.add_argument("--appid", type=int, required=True)
    x.add_argument("--input", required=True)
    x.add_argument("--format", choices=["json", "parquet"],
                   help="default: by --input extension (.parquet), else json")
    x.set_defaults(fn=cmd_import)
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
