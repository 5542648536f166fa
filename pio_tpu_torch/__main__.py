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

Counterparts of ``cmd_train`` and ``cmd_deploy`` in ``pio_tpu.tools.cli``.
Not ported yet: train's --from-eval and mesh options; deploy's fleet,
canary, TLS, feedback, batching and warm-query options.
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
    x.set_defaults(fn=cmd_deploy)
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
