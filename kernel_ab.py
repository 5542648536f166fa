#!/usr/bin/env python3
"""Time two checkouts' redesigned kernels on one card, in turns.

    python3 kernel_ab.py OTHER_CHECKOUT      # from the repository root

Runs the candidate scan (K7, ``quantized_scan``) and the fused normal
equations (K1, ``normal_equations_fused``) of OTHER_CHECKOUT and of this
checkout on the same seeded inputs at the main path's shapes, each in a
process of its own that imports that checkout's ``pio_tpu_torch`` and
builds its kernels: other, this, this, other. K7: the MovieLens-20M
catalog (26,744 items, rank 64, 256 clusters, ``nprobe`` 32) in int8 and
bf16 at B 1, 16 and 128. K1: both halves of ``bench.py``'s synthetic
20,000,263 ratings, Y in bf16, as ``chip_smoke.py``'s ``fused_kernel``
phase runs them. Times are CUDA-event medians of the wrapper's call (the
wrapper's own allocations and fills included), as ``chip_smoke.py`` times
them. Prints one JSON line per process, then a summary line with the
median of each checkout's two runs. Needs one CUDA card.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
from dataclasses import replace

SEED = 0
N_USERS, N_ITEMS, RANK = 138_493, 26_744, 64
CENTRES = 256
NNZ = 20_000_263
SCAN_BATCHES = (1, 16, 128)
SLEEP_CYCLES = 20_000_000


def gpu_ms(fn, reps: int = 25, inner: int = 10) -> float:
    """Median device time of one call, from CUDA events around ``reps``
    windows of ``inner`` calls queued behind a device-side sleep."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def scan_cases(dev) -> dict:
    import numpy as np
    import torch

    from pio_tpu_torch.ops import retrieval as rt
    from pio_tpu_torch.ops.kernels import quantized_scan as qscan

    rng = np.random.default_rng(SEED)
    centres = rng.standard_normal((CENTRES, RANK)).astype(np.float32)
    assign = rng.integers(0, CENTRES, N_ITEMS)
    items = (centres[assign] + 0.25 * rng.standard_normal(
        (N_ITEMS, RANK))).astype(np.float32)
    users = rng.standard_normal((N_USERS, RANK), dtype=np.float32)
    params = rt.RetrievalParams(mode="clustered", dtype="int8",
                                impl="pallas")
    index_i8 = rt.build_index(items, params)
    index_bf = rt.RetrievalIndex(
        replace(params, dtype="bf16"), rt.quantize_table(items, "bf16"),
        index_i8.centroids, index_i8.assign)
    pick = np.random.default_rng(SEED + 1)
    out = {}
    for index in (index_i8, index_bf):
        didx = rt.build_device_index(index, dev)
        nprobe = min(params.nprobe, didx.n_clusters)
        for b in SCAN_BATCHES:
            u = torch.from_numpy(
                users[pick.choice(N_USERS, b, replace=False)]).to(dev)
            _, top_c = torch.topk(u @ didx.centroids.T, nprobe)
            args = (didx.table, didx.scales, didx.gidx,
                    top_c.to(torch.int32), u)
            out[f"{index.params.dtype}_B{b}"] = gpu_ms(
                lambda: qscan.quantized_scan(*args))
    return out


def fused_cases(dev) -> dict:
    import numpy as np
    import torch

    from pio_tpu_torch.ops import als
    from pio_tpu_torch.ops.kernels import segment_flush as sf

    rng = np.random.default_rng(SEED)
    users = (rng.zipf(1.2, NNZ) % N_USERS).astype(np.int32)
    items = (rng.zipf(1.2, NNZ) % N_ITEMS).astype(np.int32)
    vals = rng.integers(1, 6, NNZ).astype(np.float32)
    p = als.ALSParams(rank=RANK, iterations=10, reg=0.05, alpha=10.0,
                      implicit=True, chunk=8192, accum="pallas")
    u, i, v = als._prep_coo(users, items, vals, N_USERS, N_ITEMS, p, dev)
    by_user, by_item, _ = als._build_layouts(u, i, v, N_USERS, N_ITEMS, p)
    del u, i, v
    users0, items0 = als._init_or(None, N_USERS, N_ITEMS, p, dev)
    out = {}
    for name, lay, other, n in (("users_half", by_user, items0, N_USERS),
                                ("items_half", by_item, users0, N_ITEMS)):
        src = other.to(torch.bfloat16)
        out[name] = gpu_ms(lambda: sf.normal_equations_fused(
            *lay, src, n, p.implicit, p.alpha), 10, 3)
        torch.cuda.empty_cache()
    return out


def child(root: str) -> None:
    sys.path.insert(0, root)
    import torch

    import pio_tpu_torch
    from pio_tpu_torch.ops.kernels import build

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    build.build_all(("quantized_scan", "segment_flush"))
    print(json.dumps({
        "package": os.path.dirname(pio_tpu_torch.__file__),
        "card": torch.cuda.get_device_name(0),
        "quantized_scan_ms": scan_cases(dev),
        "normal_equations_fused_ms": fused_cases(dev)}), flush=True)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        child(sys.argv[2])
        return 0
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    other = os.path.abspath(sys.argv[1])
    here = os.path.dirname(os.path.abspath(__file__))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    runs = {"other": [], "this": []}
    for who, root in (("other", other), ("this", here), ("this", here),
                      ("other", other)):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", root],
            capture_output=True, text=True, check=True, cwd=root)
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs[who].append(json.loads(line))

    def med(who, key):
        cases = runs[who][0][key]
        return {c: statistics.median(r[key][c] for r in runs[who])
                for c in cases}

    print(json.dumps({key: {"other": med("other", key),
                            "this": med("this", key)}
                      for key in ("quantized_scan_ms",
                                  "normal_equations_fused_ms")}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
