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
           PIO_TPU_CHAOS injects faults (resilience/chaos.py).
  deploy   serve the latest COMPLETED engine instance (or
           --engine-instance-id) of the engine in --engine-dir over
           REST, on the CUDA device unless --device cpu. Storage comes
           from the PIO_STORAGE_* environment, as for `pio deploy`.
           --server-key (or PIO_SERVER_KEY) guards /model/upsert_users.
  foldin   the streaming fold-in worker (docs/freshness.md): tail the
           engine's events in the store, solve refreshed user rows
           against the deployed model's item factors (on the CUDA
           device unless --device cpu) and hot-swap them into the
           deploy server at --serving-url. --once runs one cycle and
           prints its stats as JSON; otherwise it loops, with its health
           surface on --ip/--port.

Counterparts of ``cmd_train``, ``cmd_deploy`` and ``cmd_foldin`` in
``pio_tpu.tools.cli``. Not ported yet: train's --from-eval and mesh
options; deploy's fleet, canary, TLS, feedback, batching and warm-query
options; foldin's --router-url (the fleet), --event-server-url,
--access-key and --tail-wait (the event server's tail route).
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys

from pio_tpu_torch.data.storage import get_storage


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
        print("[ERROR] --resume and --auto-resume are mutually exclusive",
              file=sys.stderr)
        return 1
    variant = _load_variant(args.engine_dir)
    engine, ep = _engine_from_variant(variant, args.engine_dir)
    engine_id, engine_version, engine_variant = _engine_ids(
        variant, args.engine_dir)
    storage = get_storage()
    ctx = create_workflow_context(storage, device=args.device)
    try:
        instance_id = run_train(
            engine, ep, storage, engine_id=engine_id,
            engine_version=engine_version, engine_variant=engine_variant,
            engine_factory=variant["engineFactory"], batch=args.batch or "",
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
    from pio_tpu_torch.workflow.context import create_workflow_context
    from pio_tpu_torch.workflow.serve import ServingConfig, create_query_server

    variant = _load_variant(args.engine_dir)
    engine, ep = _engine_from_variant(variant, args.engine_dir)
    engine_id, engine_version, engine_variant = _engine_ids(
        variant, args.engine_dir)
    storage = get_storage()
    ctx = create_workflow_context(storage, device=args.device)
    config = ServingConfig(
        ip=args.ip, port=args.port, engine_id=engine_id,
        engine_version=engine_version, engine_variant=engine_variant,
        server_key=args.server_key or os.environ.get("PIO_SERVER_KEY", ""),
    )
    http, qs = create_query_server(
        engine, ep, storage, config, ctx=ctx,
        instance_id=args.engine_instance_id,
    )
    http.start()
    print(f"Engine instance {qs.instance.id} deployed on "
          f"http://{args.ip}:{http.port} ({ctx.device})", flush=True)
    try:
        http.wait()
    except KeyboardInterrupt:
        http.stop()
    finally:
        qs.close()
    print("Server stopped.")
    return 0


def cmd_foldin(args) -> int:
    """Training-read semantics and solver params come from the SAME
    engine.json train and deploy read, so they cannot drift from the
    model being refreshed."""
    import threading

    from pio_tpu_torch.freshness import (
        FoldInConfig,
        FoldInWorker,
        ServingHttpApplier,
        create_foldin_server,
    )
    from pio_tpu_torch.ops import als

    variant = _load_variant(args.engine_dir)
    engine, ep = _engine_from_variant(variant, args.engine_dir)
    engine_id, engine_version, engine_variant = _engine_ids(
        variant, args.engine_dir)
    _, ds = ep.datasource
    _, ap = (ep.algorithms or [(None, None)])[0]
    rank = getattr(ap, "rank", None)
    if rank is None:
        print("[ERROR] fold-in needs a factor-model engine (algorithm "
              "params with rank/lambda_/alpha/implicit_prefs); got "
              f"{type(ap).__name__}", file=sys.stderr)
        return 1
    app_name = getattr(ds, "app_name", "")
    if not app_name:
        print("[ERROR] engine.json datasource params carry no appName",
              file=sys.stderr)
        return 1
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
    applier = ServingHttpApplier(args.serving_url, key)
    worker = FoldInWorker(get_storage(), config, applier,
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
    print(f"fold-in worker for engine {engine_id} -> {args.serving_url} "
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
    x.set_defaults(fn=cmd_train)
    x = sub.add_parser("deploy", help="serve an engine instance over REST")
    x.add_argument("--engine-dir", default=".")
    x.add_argument("--ip", default="0.0.0.0")
    x.add_argument("--port", type=int, default=8000)
    x.add_argument("--engine-instance-id")
    x.add_argument("--device", choices=["cuda", "cpu"], default=None,
                   help="serving device (default cuda; cpu must be asked "
                        "for)")
    x.add_argument("--server-key", default="",
                   help="guards /model/upsert_users (or PIO_SERVER_KEY)")
    x.set_defaults(fn=cmd_deploy)
    x = sub.add_parser(
        "foldin",
        help="streaming fold-in worker: tail the event stream, solve "
             "refreshed user rows against the deployed item factors, "
             "hot-swap them into serving (docs/freshness.md)")
    x.add_argument("--engine-dir", default=".")
    x.add_argument("--serving-url", default="http://127.0.0.1:8000",
                   help="single-host deploy server to apply rows to")
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
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
