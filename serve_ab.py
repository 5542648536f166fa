"""The deploy's in-process query path, two trees of this repo in turns on
one card.

    python3 serve_ab.py --parent DIR [--queries N]

``DIR`` holds another checkout of the repo (``git archive <commit> | tar
-x -C DIR``); the tree this script sits in is the change. Each arm is a
process of its own that imports ``pio_tpu_torch`` and ``chip_smoke`` from
its tree, persists chip_smoke's seeded ML-20M model (138,493 x 26,744,
rank 64, clustered int8 retrieval on the scan kernel) into a sqlite
store, loads it into a ``QueryServer`` on the card and times N solo
queries with ``chip_smoke.profile_queries``: the host's ms per query,
and the device's under ``torch.profiler``, and the torch ops that take
the most host time. The arms run in the order
parent, change, change with one dispatch row, change with one dispatch
row, change, parent; an arm "rows1" sets ``ops.bucketing.DISPATCH_ROWS``
to 1, so every product runs at the batch's own rows, as the parent's do
for a solo query. Prints one JSON line an arm and a summary line; needs
one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent
ORDER = (("parent", None), ("change", None), ("change", 1), ("change", 1),
         ("change", None), ("parent", None))
ARM_TIMEOUT_S = 600


def arm(tree: str, rows: int | None, n_queries: int,
        device: str = "cuda") -> dict:
    """One arm, in this process: ``tree``'s package on ``device``."""
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import chip_smoke as cs
    from pio_tpu_torch.convert import recommendation_model_from_numpy
    from pio_tpu_torch.data.storage import Storage
    from pio_tpu_torch.models import recommendation as rec
    from pio_tpu_torch.ops import bucketing
    from pio_tpu_torch.workflow.context import create_workflow_context
    from pio_tpu_torch.workflow.serve import QueryServer, ServingConfig
    from pio_tpu_torch.workflow.train import persist_models

    assert Path(cs.__file__).resolve().parent == Path(tree).resolve()
    if rows is not None:
        bucketing.DISPATCH_ROWS = rows
    dev = torch.device(device)
    users, items = cs.make_factors()
    user_ids = [f"u{i}" for i in range(cs.N_USERS)]
    item_ids = [f"i{i}" for i in range(cs.N_ITEMS)]
    picked = np.random.default_rng(cs.SEED + 2).choice(
        cs.N_USERS, n_queries + 1, replace=False)
    queries = [{"user": user_ids[i], "num": 10} for i in picked]
    with tempfile.TemporaryDirectory(prefix="serve_ab_") as tmp:
        storage = Storage(env=cs.sqlite_env(tmp))
        engine = rec.RecommendationEngine.apply()
        ep = engine.engine_params_from_variant({
            "id": "serve-ab", "engineFactory": cs.FACTORY,
            "algorithms": [{"name": "als", "params": {
                "rank": cs.RANK, "retrieval": cs.RETRIEVAL}}]})
        persist_models([recommendation_model_from_numpy(
            users, items, user_ids, item_ids, device=dev)], ep, storage,
            "serve-ab", engine_factory=cs.FACTORY)
        qs = QueryServer(engine, ep, storage,
                         ServingConfig(engine_id="serve-ab"),
                         ctx=create_workflow_context(storage, device=dev))
        try:
            qs.query(queries[-1])      # builds the retrieval index
            reps = [cs.profile_queries(qs, queries[:-1]) for _ in range(3)]
            host = host_ops(qs, queries[:-1])
        finally:
            qs.close()
            storage.close()
    return {"wall_ms_per_query": [r["wall_ms_per_query"] for r in reps],
            "device_ms_per_query": [r["device_ms_per_query"] for r in reps],
            "top_kernels_ms_per_query": reps[-1]["top_kernels_ms_per_query"],
            "top_host_ops_ms_per_query": host}


def host_ops(qs, queries: list) -> dict:
    """The ten torch ops with the most host time of their own (ms a
    query, under ``torch.profiler``'s CPU activity; its own overhead
    included)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for q in queries:
            qs.query(q)
    ops = sorted(((e.key, e.self_cpu_time_total / 1e3 / len(queries))
                  for e in prof.key_averages()), key=lambda kv: -kv[1])
    return dict(ops[:10])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--queries", type=int, default=200)
    ap.add_argument("--arm", help=argparse.SUPPRESS)
    ap.add_argument("--rows", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.arm:
        print(json.dumps(arm(args.arm, args.rows, args.queries)))
        return 0
    trees = {"parent": str(Path(args.parent).resolve()), "change": str(HERE)}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip())
    runs: dict = {}
    for name, rows in ORDER:
        cmd = [sys.executable, str(HERE / "serve_ab.py"), "--parent",
               args.parent, "--queries", str(args.queries), "--arm",
               trees[name]]
        if rows is not None:
            cmd += ["--rows", str(rows)]
        # each arm runs from its own tree, so its kernels build there
        p = subprocess.run(cmd, cwd=trees[name], capture_output=True,
                           text=True, timeout=ARM_TIMEOUT_S)
        if p.returncode:
            print(p.stderr[-4000:], file=sys.stderr)
            return p.returncode
        res = json.loads(p.stdout.strip().splitlines()[-1])
        key = name if rows is None else f"{name}_rows{rows}"
        print(json.dumps({"arm": key, **res}))
        runs.setdefault(key, []).append(res)
    summary = {key: {m: statistics.median(
        v for r in rs for v in r[m]) for m in (
            "wall_ms_per_query", "device_ms_per_query")}
        for key, rs in runs.items()}
    print(json.dumps({"summary": summary, "card": card.strip()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
