#!/usr/bin/env python3
"""Time two checkouts' redesigned kernels on one card, in turns.

    python3 kernel_ab.py OTHER_CHECKOUT [GROUP ...]   # from the repo root

Runs kernels of OTHER_CHECKOUT and of this checkout on the same seeded
inputs at the main path's shapes, each in a process of its own that
imports that checkout's ``pio_tpu_torch`` and builds its kernels: other,
this, this, other. GROUPs (all when none is named):

- ``k7``: the candidate scan (``quantized_scan``) over the MovieLens-20M
  catalog (26,744 items, rank 64, 256 clusters, ``nprobe`` 32) in int8
  and bf16 at B 1, 16 and 128;
- ``k1``: the fused normal equations (``normal_equations_fused``) on both
  halves of ``bench.py``'s synthetic 20,000,263 ratings, Y in bf16, as
  ``chip_smoke.py``'s ``fused_kernel`` phase runs them;
- ``k8``: f32 flash attention (``flash_attention``, causal) on q, k, v
  views of one projection at the sequence template's serving call (B 1,
  S 63, H 2, D 32), a training step at ``eval/neural_throughput.py``'s
  sequence cell (B 256, S 127, H 4, D 32) and a step of its long-context
  training cell (B 16, S 2047, H 4, D 32);
- ``k4``: the resident gather's ``take`` and ``copy`` variants
  (``gather_rows_resident``) on the users half's first chunk of the same
  ratings, items' bf16 factors, as ``chip_smoke.py``'s ``stream_kernels``
  phase runs them;
- ``seq``: ``train_sequence_model`` with ``attention="flash"`` at
  ``eval/neural_throughput.py``'s sequence cell, tokens per second of
  120 steps on the host clock;
- ``seqverb``: the sequence template's train verb (``python -m
  pio_tpu_torch train``, called in process) as ``chip_smoke.py``'s
  ``sequence_entry`` phase runs it: its seeded events in a sqlite store,
  its engine.json, a warm-up train of 3 steps, then the timed train on
  the host clock, with the seconds spent in step-checkpoint saves where
  the checkout has them.

Kernel times are CUDA-event medians of the wrapper's call (the wrapper's
own allocations and fills included), as ``chip_smoke.py`` times them.
Prints the card's name and power limit, one JSON line per process, then a
summary line with the median of each checkout's two runs. Needs one CUDA
card.
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
HERE = os.path.dirname(os.path.abspath(__file__))
SCAN_BATCHES = (1, 16, 128)
SLEEP_CYCLES = 20_000_000
# (B, S, H, D) of the f32 attention cases
ATTN_CASES = {"serving": (1, 63, 2, 32), "training_step": (256, 127, 4, 32),
              "long_rows": (16, 2047, 4, 32)}
# eval/neural_throughput.py's sequence cell
SEQ_DATA = dict(n_seqs=8_192, max_len=128, n_items=20_000)
SEQ_TRAIN = dict(max_len=128, embed_dim=128, num_heads=4, num_layers=2,
                 ffn_dim=256, batch_size=256, steps=120, seed=0)


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


def attention_cases(dev) -> dict:
    import torch

    from pio_tpu_torch.ops.kernels import flash_attention as k8

    out = {}
    for i, (name, (b, s, h, d)) in enumerate(ATTN_CASES.items()):
        g = torch.Generator(device=dev)
        g.manual_seed(SEED + i)
        qkv = torch.randn((b, s, 3, h, d), generator=g, device=dev)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        out[name] = gpu_ms(lambda: k8.flash_attention(q, k, v, causal=True))
    return out


def gather_cases(dev) -> dict:
    import numpy as np
    import torch

    from pio_tpu_torch.ops import als
    from pio_tpu_torch.ops.kernels import gather_rows as gr

    rng = np.random.default_rng(SEED)
    users = (rng.zipf(1.2, NNZ) % N_USERS).astype(np.int32)
    items = (rng.zipf(1.2, NNZ) % N_ITEMS).astype(np.int32)
    vals = rng.integers(1, 6, NNZ).astype(np.float32)
    p = als.ALSParams(rank=RANK, iterations=10, reg=0.05, alpha=10.0,
                      implicit=True, chunk=8192)
    u, i, v = als._prep_coo(users, items, vals, N_USERS, N_ITEMS, p, dev)
    by_user, _, cs = als._build_layouts(u, i, v, N_USERS, N_ITEMS, p)
    _, items0 = als._init_or(None, N_USERS, N_ITEMS, p, dev)
    table = items0.to(torch.bfloat16)
    flat = by_user[1][:cs].reshape(-1)
    return {variant: gpu_ms(lambda: gr.gather_rows_resident(table, flat,
                                                            variant))
            for variant in ("take", "copy")}


def sequence_cases(dev) -> dict:
    import time
    from dataclasses import replace as dc_replace

    import numpy as np
    import torch

    from pio_tpu_torch.data.bimap import EntityIdIndex
    from pio_tpu_torch.models import sequence as seq

    rng = np.random.default_rng(SEED)
    seqs = (rng.zipf(1.3, (SEQ_DATA["n_seqs"], SEQ_DATA["max_len"]))
            % (SEQ_DATA["n_items"] - 1) + 1).astype(np.int32)
    data = seq.SequenceData(
        seqs, EntityIdIndex([f"u{j}" for j in range(SEQ_DATA["n_seqs"])]),
        EntityIdIndex([f"i{j}" for j in range(SEQ_DATA["n_items"])]))
    p = seq.SequenceParams(**SEQ_TRAIN, attention="flash")
    seq.train_sequence_model(data, dc_replace(p, steps=3), device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seq.train_sequence_model(data, p, device=dev)   # ends in float(loss)
    wall = time.perf_counter() - t0
    tokens = p.steps * p.batch_size * (p.max_len - 1)
    return {"flash_tokens_per_s": tokens / wall}


def sequence_verb_cases(dev) -> dict:
    import contextlib
    import importlib.util
    import io
    import tempfile
    import time
    from datetime import datetime, timezone
    from pathlib import Path

    from pio_tpu_torch.__main__ import main as cli_main
    from pio_tpu_torch.data.storage import Storage, set_storage

    # the events, widths and store of this checkout's chip_smoke.py, for
    # either checkout
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_defs", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    saves = []
    try:
        from pio_tpu_torch.workflow.step_checkpoint import StepCheckpointer
    except ImportError:     # a checkout without step checkpoints
        StepCheckpointer = None
    if StepCheckpointer is not None:
        save = StepCheckpointer.save

        def timed_save(self, *args, **kwargs):
            t0 = time.perf_counter()
            try:
                return save(self, *args, **kwargs)
            finally:
                saves.append(time.perf_counter() - t0)

        StepCheckpointer.save = timed_save
    with tempfile.TemporaryDirectory(prefix="kernel_ab_seq") as tmp:
        os.environ["PIO_TPU_CKPT_ROOT"] = os.path.join(tmp, "ckpt")
        storage = Storage(env=smoke.sqlite_env(tmp))
        smoke.write_sequence_events(
            storage, smoke.SEQ_ALGO["app_name"],
            datetime(2024, 1, 1, tzinfo=timezone.utc))
        set_storage(storage)
        try:
            for steps in (3, smoke.SEQ_ALGO["steps"]):  # warm-up, timed
                engine_dir = Path(tmp) / f"engine{steps}"
                engine_dir.mkdir()
                (engine_dir / "engine.json").write_text(json.dumps({
                    "id": "kernel-ab-seq",
                    "engineFactory": smoke.SEQ_FACTORY,
                    "datasource": {"params": {
                        "app_name": smoke.SEQ_ALGO["app_name"],
                        "event_names": ["view", "buy"],
                        "max_len": smoke.SEQ_ALGO["max_len"]}},
                    "algorithms": [{"name": "sasrec", "params": {
                        **smoke.SEQ_ALGO, "steps": steps}}],
                }))
                saves.clear()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(io.StringIO()):
                    rc = cli_main(["train", "--engine-dir", str(engine_dir)])
                train_s = time.perf_counter() - t0
                if rc != 0:
                    raise SystemExit(f"kernel_ab: train verb rc {rc}")
        finally:
            set_storage(None)
            storage.close()
    return {"train_s": train_s, "checkpoint_saves": len(saves),
            "checkpoint_s": sum(saves)}


GROUPS = {"k7": ("quantized_scan_ms", ("quantized_scan",), scan_cases),
          "k1": ("normal_equations_fused_ms", ("segment_flush",),
                 fused_cases),
          "k8": ("flash_attention_f32_ms", ("flash_attention",),
                 attention_cases),
          "k4": ("gather_rows_resident_ms", ("gather_rows",), gather_cases),
          "seq": ("sequence_train", ("flash_attention",), sequence_cases),
          "seqverb": ("sequence_verb", (), sequence_verb_cases)}


def child(root: str, groups: list[str]) -> None:
    sys.path.insert(0, root)
    import torch

    import pio_tpu_torch
    from pio_tpu_torch.ops.kernels import build

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    build.build_all(tuple({name for g in groups for name in GROUPS[g][1]}))
    line = {"package": os.path.dirname(pio_tpu_torch.__file__),
            "card": torch.cuda.get_device_name(0)}
    for g in groups:
        key, _, cases = GROUPS[g]
        line[key] = cases(dev)
        torch.cuda.empty_cache()
    print(json.dumps(line), flush=True)


def main() -> int:
    if len(sys.argv) >= 3 and sys.argv[1] == "--child":
        child(sys.argv[2], sys.argv[3:])
        return 0
    if len(sys.argv) < 2 or not set(sys.argv[2:]) <= set(GROUPS):
        raise SystemExit(__doc__)
    groups = sys.argv[2:] or list(GROUPS)
    other = os.path.abspath(sys.argv[1])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    runs = {"other": [], "this": []}
    for who, root in (("other", other), ("this", HERE), ("this", HERE),
                      ("other", other)):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", root,
             *groups],
            capture_output=True, text=True, check=True, cwd=root)
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs[who].append(json.loads(line))

    def med(who, key):
        cases = runs[who][0][key]
        return {c: statistics.median(r[key][c] for r in runs[who])
                for c in cases}

    print(json.dumps({GROUPS[g][0]: {"other": med("other", GROUPS[g][0]),
                                     "this": med("this", GROUPS[g][0])}
                      for g in groups}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
