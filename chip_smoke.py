#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pio_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one card

It builds the port's CUDA kernels from the sources in the checkout, holds
each against its plain PyTorch version on the card, and then drives the
port's main paths once at the full width of the model the repository
benchmarks: the ALS recommendation engine at the MovieLens-20M shape
(138,493 users x 26,744 items, rank 64, ``bench.py``).

- serve: factors made from a seed, stored as a finished training run
  stores them, and served by ``create_query_server`` (what ``python -m
  pio_tpu_torch deploy`` calls) with two-stage clustered retrieval and
  ``"impl": "pallas"`` (the K7 scan kernel), over loopback HTTP;
- foldin: on the same seeded factors in a fresh sqlite store, served
  behind a server key: a tail of rate/buy events of 4,096 users (a
  quarter new, up to 512 items each) folded in by ``FoldInWorker`` (what
  ``python -m pio_tpu_torch foldin`` runs) in four batches of 1,024 and
  applied through ``/model/upsert_users`` over loopback HTTP; every
  multi-slot user's served row (and a sample of the rest) equal bit for
  bit to the user folded alone, in both modes, and to a second worker's,
  and within the stated bound of an f64 solve; new users' queries
  through K7 held to the recall floor; an item upsert re-encoding K7's
  table, held against a fresh encoding and the plain scan; the sqlite
  history read, the fold's parts and the model loads timed;
- train: ``als_train`` on ``bench.py``'s synthetic ratings (zipf 1.2,
  seed 0, 20,000,263 ratings, implicit, reg 0.05, alpha 10) with
  ``accum`` auto, which on the card is the segment-flush kernel (K2) on
  every solve, held against the plain ``index_add_`` accumulation;
- stream_kernels: the overlapped/packed flush (K3), the streaming and
  resident row gathers (K5, K4 copy and take) and the packed matvec (K6)
  against their plain versions at the users half of the same layout;
- train_stream: ``als_train`` on the same ratings in the streaming
  configuration (``accum="stream"``, ``gather="stream"``,
  ``packed_a=True``: K3, K5, K6 on every sweep), each half held against
  the hybrid path and f64, then one sweep each with ``gather`` "stream",
  "pallas-copy" and "pallas-take" held bit for bit against "xla";
- fused_kernel: the fused normal-equation kernel (K1) against its plain
  version (and f64) on each half of the same layout, timed beside what it
  replaces there, the hybrid path's block build plus K2, with its device
  time by part (the kernel, its zero-fill of rows without entries, the
  fold);
- train_fused: ``als_train`` on the same ratings with ``accum="pallas"``
  (K1 on every solve), each half held against the hybrid path and f64;
- train_validated: ``als_train_validated`` on the same ratings with a
  tenth held out (the template's seeded split), K2 on every sweep, timed
  against ``als_train`` on the same triples; its factors bit for bit
  those of a run stopped at the best sweep; then one
  ``als_build_layouts`` and two trainings on it, the build's share of
  the time;
- train_entry: seeded rate/buy events for every user and item in sqlite,
  ``python -m pio_tpu_torch train`` (its ``main``, in process, so the
  launch counters can be read), then the trained instance deployed and
  queried over HTTP; then the verb's parts timed one by one on the same
  store: the sqlite read plus the columnar fold, the row path it
  replaced (``find`` + ``to_interactions``, held equal element for
  element), the layout build, the sweeps and the persist;
- attention_kernel: the flash-attention kernel (K8) against its plain
  version at the shapes the repository runs, each case with the kernel
  it took (f32 inputs: 3xTF32 ``wgmma``; bf16: ``wgmma``): the
  sequence template's serving call, the serving call at
  ``eval/neural_throughput.py``'s sequence widths, that file's
  long-context cases (B 4, H 8, D 64, causal, bf16, S 2048 to 32768),
  the same at D 32 and 128, and a step of its long-context training
  cell in f32, timed beside one ``scaled_dot_product_attention`` call;
  the masks' corners and strided views in both types;
- sequence_train: ``train_sequence_model`` at ``eval/neural_throughput
  .py``'s sequence cell (8,192 sequences of 128, 20,000 items, embed
  128), with ``attention="flash"`` (K8 forward) and ``"auto"``;
- sequence_entry: the sequence template end to end at
  ``examples/sequence/engine.json``'s widths: seeded view/buy events in
  sqlite, ``python -m pio_tpu_torch train``, ``create_query_server``
  answering over HTTP from live histories, K8 in every scored batch;
- train_resume: on the same events, the template with ``"attention":
  "flash"`` and a step checkpoint every 50 steps through ``python -m
  pio_tpu_torch train`` uninterrupted, killed by ``PIO_TPU_CHAOS`` at
  step 150 in a subprocess then ``--resume ID``, and SIGTERM'd in a
  subprocess (exit 75) then ``--auto-resume``: the resumed models equal
  the uninterrupted one bit for bit, K8 runs in every training forward,
  and the resumed instance is deployed and answers with K8; the time of
  a checkpoint save and of the heartbeat.

Each phase prints one JSON line. Any failure raises, so the exit code is
not 0 and no result line is printed; without CUDA, or outside a checkout
of the repository, it fails before any phase. The last two lines are the
``kernels`` summary and ``{"ok": true, "device": {...}}``.

Numbers it prints are this card's own. Kernel times are CUDA-event times
of a window of back-to-back launches queued behind a device-side sleep,
so they are device time, not host launch overhead; the quantized table
is resident in L2 between queries, as in serving, and is not flushed.
"""

from __future__ import annotations

import contextlib
import io
import json
import logging
import os
import signal
import statistics
import subprocess
import sys
import tempfile
import time
import types
import urllib.error
import urllib.request
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

SEED = 0
# the ALS cell of bench.py: MovieLens-20M shape, rank 64
N_USERS, N_ITEMS, RANK = 138_493, 26_744, 64
CENTRES = 256             # seeded Gaussian mixture (tests/test_retrieval.py)
FACTORY = "pio_tpu_torch.models.recommendation.RecommendationEngine"
RETRIEVAL = {"mode": "clustered", "dtype": "int8", "impl": "pallas"}
NNZ = 20_000_263          # MovieLens-20M's rating count
ITERS = 10                # bench.py's sweeps (the template's default)
N_EVENTS = 1_000_000      # events written for the train entry point
SCAN_BATCHES = (1, 16, 128)
N_PLAIN_QUERIES = 40
BATCH_QUERIES = 16

# kernel vs plain version: both sum k=64 f32 products of the same
# dequantized values, in different orders
RTOL = 1e-5
ATOL_OF_MAX = 1e-5        # atol = ATOL_OF_MAX * max |score|
# a sanity floor: the repository's gate (recall@10 >= 0.95) is stated at
# nprobe 32 of C=64 clusters; this model has C=256, so nprobe 32 expands
# an eighth of the catalog
RECALL_FLOOR = 0.9
# segment flush vs its plain version: both sum the same f32 blocks in
# other orders (the plain version with atomics); held per row of A
# against the plain version evaluated in f64, relative to the row's max.
# The fused kernel (K1) is held to the same bound: it sums at most 32
# products, each f32-accurate (3xTF32), before they join the row, as a
# slot's block sums 128
FLUSH_RTOL = 1e-5
# packed matvec vs the f64 product: k f32 products summed in another
# order; each output within MATVEC_RTOL of the sum of its terms' magnitudes
MATVEC_RTOL = 1e-6
# hybrid vs carry (the plain accumulation), each half from the same
# inputs. The users half: A agrees to ~1e-6 (summation order), and CG's 16
# iterations from the same start keep that close (relative to the norm and
# to the max of the factors). The items half's systems are far worse
# conditioned (item 1 holds 3.6M ratings): 16 CG iterations amplify A's
# rounding into the factors, so both f32 paths are held against the same
# half evaluated in f64, and the kernel's path must be no farther from it
# than HALF_F64_RATIO times the plain path (plus HALF_F64_FLOOR).
USERS_RTOL_NORM = 1e-4
USERS_RTOL_MAX = 2e-3
HALF_F64_RATIO = 2.0
HALF_F64_FLOOR = 1e-6

# NVIDIA H100 SXM data sheet (dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12         # the scan's FMAs run on the f32 CUDA cores
TF32_FLOPS = 495e12       # tensor cores; an f32-accurate product takes 3
BF16_FLOPS = 989e12
# exponentials a second on the SFUs: 132 SMs x 16 a clock x 1.83 GHz boost
# (the Hopper architecture white paper's per-SM rate)
SFU_EXPS_PER_S = 132 * 16 * 1.83e9

# flash attention (K8) vs its plain version. f32: f32-accurate products
# (3xTF32) summed in another order than the plain version in f64, within
# the reference's own bound for its flash kernel (tests/test_attention.py:
# 2e-5). bf16: the output is rounded to bf16 (8 significant bits, half an
# ulp = 2^-9 of it; 2^-8 allowed) against the plain version in f32 on the
# same bf16 inputs
ATTN_F32_ATOL = 2e-5
ATTN_BF16_RTOL = 2 ** -8
ATTN_BF16_ATOL = 1e-5
# (B, S, H, D, dtype, timing windows; None: gpu_ms's default) of each
# case: the template's serving call (examples/sequence/engine.json:
# max_len 64, embed 64, 2 heads), the serving call and a training step at
# eval/neural_throughput.py's sequence widths (max_len 128, embed 128, 4
# heads), that file's long-context kernel cases (bf16, D 64), the same at
# D 32 and 128 (the bf16 kernel's other widths), and a step of its
# long-context training cell (max_len 2048, embed 128, 4 heads, batch 16;
# f32, as the trainer runs)
ATTN_CASES = (
    (1, 63, 2, 32, torch.float32, None),
    (16, 63, 2, 32, torch.float32, None),
    (1, 127, 4, 32, torch.float32, None),
    (16, 127, 4, 32, torch.float32, None),
    (256, 127, 4, 32, torch.float32, None),
    (4, 2048, 8, 64, torch.bfloat16, 10),
    (4, 8192, 8, 64, torch.bfloat16, 5),
    (4, 32768, 8, 64, torch.bfloat16, 3),
    (4, 2048, 8, 32, torch.bfloat16, 10),
    (4, 2048, 8, 128, torch.bfloat16, 10),
    (16, 2047, 4, 32, torch.float32, 5),
)
# eval/neural_throughput.py's sequence cell, unchanged
SEQ_TRAIN_DATA = dict(n_seqs=8_192, max_len=128, n_items=20_000)
SEQ_TRAIN = dict(max_len=128, embed_dim=128, num_heads=4, num_layers=2,
                 ffn_dim=256, batch_size=256, steps=120, seed=0)
# final losses of attention "flash" and "auto" (the plain attention at
# this length): the same init and batches, attention forwards that differ
# by f32 rounding, carried through 120 Adam steps
SEQ_LOSS_RTOL = 1e-3
SEQ_FACTORY = "pio_tpu_torch.models.sequence.SequenceEngine"
# examples/sequence/engine.json's widths; the app name turns on the
# serve-time live history read
SEQ_ALGO = {"max_len": 64, "embed_dim": 64, "num_heads": 2, "num_layers": 2,
            "ffn_dim": 128, "steps": 300, "batch_size": 128,
            "learning_rate": 0.001, "app_name": "ChipSeq"}
SEQ_USERS, SEQ_ITEMS, SEQ_MAX_EVENTS = 2_000, 3_000, 64
# the resumed runs: the same widths, K8 in every training forward, a step
# checkpoint every 50 steps; the chaos kill lands at step 150 (after the
# step-100 save), the SIGTERM'd run stalls at step 120 (a chaos delay)
# while the signal is sent, once its step-100 checkpoint is on disk
SEQ_RESUME = {**SEQ_ALGO, "attention": "flash", "checkpoint_every": 50}
RESUME_KILL_STEP = 150
RESUME_SIGNAL_AFTER = 100
RESUME_STALL_STEP, RESUME_STALL_S = 120, 5.0
RESUME_QUERIES = 8
# a train subprocess: the interpreter and the card come up in ~10 s
SUBPROCESS_TIMEOUT_S = 600
# served scores of the sequence model with K8 against the same model with
# the plain attention: f32 rounding of the attention, carried through two
# layers and the tied head
SEQ_SCORE_RTOL = 1e-4

# device-side sleep ahead of each timing window, long enough for the host
# to queue the whole window (about 10 ms at H100 clocks)
SLEEP_CYCLES = 20_000_000
TIMING_REPS = 25
TIMING_INNER = 10


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def counters() -> dict:
    """Every kernel's launch counter, by kernel name."""
    from pio_tpu_torch.ops.kernels import flash_attention as k8
    from pio_tpu_torch.ops.kernels import gather_rows as gr
    from pio_tpu_torch.ops.kernels import packed_matvec as pm
    from pio_tpu_torch.ops.kernels import quantized_scan as qscan
    from pio_tpu_torch.ops.kernels import segment_flush as sf

    return {"quantized_scan": qscan.launches, "segment_flush": sf.launches,
            "segment_flush_stream": sf.launches_stream,
            "normal_equations_fused": sf.launches_fused,
            "gather_rows_stream": gr.launches_stream,
            "gather_rows_resident": gr.launches_resident,
            "packed_matvec": pm.launches,
            "flash_attention": k8.launches}


def reset_counts() -> None:
    """Every count to 0, just before a path is driven."""
    for c in counters().values():
        c.reset()


def read_counts() -> dict:
    return {name: c.value for name, c in counters().items()}


def sqlite_env(tmp) -> dict:
    """The PIO_STORAGE_* settings of a sqlite store in directory tmp."""
    return {
        "PIO_STORAGE_SOURCES_SQL_TYPE": "sqlite",
        "PIO_STORAGE_SOURCES_SQL_PATH": str(Path(tmp) / "pio.db"),
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "SQL",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "SQL",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "SQL",
    }


def gpu_ms(fn, reps: int = TIMING_REPS, inner: int = TIMING_INNER) -> float:
    """Median device time of one call, from CUDA events around ``reps``
    windows of ``inner`` back-to-back calls."""
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


# -- phase 1: the card --------------------------------------------------------

def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script "
                         "runs on an NVIDIA GPU only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    # plain versions and the exact tier in full f32, stated and set
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    emit("device", nvidia_smi=card, torch=torch.__version__,
         cuda=torch.version.cuda, numpy=np.__version__,
         python=sys.version.split()[0], **device)
    return device


# -- phase 2: build -----------------------------------------------------------

def phase_build() -> None:
    from pio_tpu_torch.ops.kernels import build

    t0 = time.perf_counter()
    seconds = build.build_all()
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in build.BUILD_LOG.items()}
    emit("build", seconds=seconds, wall_s=time.perf_counter() - t0,
         ptxas=ptxas, arch="sm_90a")


# -- the seeded model ---------------------------------------------------------

def make_factors():
    rng = np.random.default_rng(SEED)
    centres = rng.standard_normal((CENTRES, RANK)).astype(np.float32)
    assign = rng.integers(0, CENTRES, N_ITEMS)
    items = (centres[assign] + 0.25 * rng.standard_normal(
        (N_ITEMS, RANK))).astype(np.float32)
    users = rng.standard_normal((N_USERS, RANK), dtype=np.float32)
    return users, items


# -- phase 3: each kernel against its plain version ---------------------------

def scan_bound(didx, top_c: torch.Tensor, b: int) -> tuple[float, str]:
    """Least time for one scan. Bytes: each probed cluster block read
    once, of which a real row's data, scale and gidx and a pad slot's
    gidx alone (a pad needs no dot); top_c and u read; the output
    written once. Operations: 2*k flops for each real row of each
    (query, probe)."""
    real = (didx.gidx >= 0).sum(dim=1)                 # (C,)
    c_used = torch.unique(top_c)
    lmax, k = didx.pad_width, RANK
    row_bytes = k * didx.table.element_size() + 4 + 4
    n_real = int(real[c_used].sum())
    nbytes = (n_real * row_bytes + (c_used.numel() * lmax - n_real) * 4
              + top_c.numel() * 4 + b * k * 4 + top_c.numel() * lmax * 4)
    dot_rows = int(real[top_c.long()].sum())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * k * dot_rows / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_scan_kernel(users: np.ndarray, items: np.ndarray,
                      dev: torch.device) -> dict:
    from pio_tpu_torch.ops import retrieval as rt
    from pio_tpu_torch.ops.kernels import quantized_scan as qscan

    params = rt.RetrievalParams(**RETRIEVAL)
    t0 = time.perf_counter()
    index_i8 = rt.build_index(items, params)
    # the same clustering, bf16-coded: only the table differs
    index_bf = rt.RetrievalIndex(
        replace(params, dtype="bf16"), rt.quantize_table(items, "bf16"),
        index_i8.centroids, index_i8.assign)
    index_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + 1)
    cases = []
    for index in (index_i8, index_bf):
        didx = rt.build_device_index(index, dev)
        nprobe = min(params.nprobe, didx.n_clusters)
        for b in SCAN_BATCHES:
            rows = rng.choice(N_USERS, b, replace=False)
            u = torch.from_numpy(users[rows]).to(dev)
            _, top_c = torch.topk(u @ didx.centroids.T, nprobe)
            args = (didx.table, didx.scales, didx.gidx,
                    top_c.to(torch.int32), u)
            got = qscan.quantized_scan(*args)
            torch.cuda.synchronize()
            want = qscan.quantized_scan_reference(*args)
            if not torch.equal(torch.isneginf(got), torch.isneginf(want)):
                raise AssertionError(
                    f"{index.params.dtype} B={b}: the -inf pattern differs")
            fin = torch.isfinite(want)
            if not bool(torch.isfinite(got[fin]).all()):
                raise AssertionError(
                    f"{index.params.dtype} B={b}: non-finite kernel scores")
            err = (got[fin] - want[fin]).abs()
            scale = float(want[fin].abs().max())
            tol = RTOL * want[fin].abs() + ATOL_OF_MAX * scale
            if bool((err > tol).any()):
                raise AssertionError(
                    f"{index.params.dtype} B={b}: kernel disagrees with the "
                    f"plain version, max abs err {float(err.max())}")
            gathered = didx.table[top_c].float()
            bound_ms, bound_by = scan_bound(didx, top_c, b)
            cases.append({
                "dtype": index.params.dtype, "B": b, "P": nprobe,
                "C": didx.n_clusters, "Lmax": didx.pad_width, "k": RANK,
                "max_abs_err": float(err.max()),
                "max_rel_err": float((err / want[fin].abs().clamp_min(
                    1e-30)).max()),
                "max_abs_score": scale,
                "ms": gpu_ms(lambda: qscan.quantized_scan(*args)),
                "plain_ms": gpu_ms(
                    lambda: qscan.quantized_scan_reference(*args)),
                # one library call over blocks gathered beforehand (the
                # gather and the pad mask are outside it)
                "library_ms": gpu_ms(lambda: torch.einsum(
                    "bplk,bk->bpl", gathered, u)),
                "bound_ms": bound_ms, "bound_by": bound_by,
                # an empty kernel on the scan's grid: the practical floor
                # of a launch of this shape, beside the byte bound
                "empty_launch_ms": gpu_ms(lambda: qscan.empty_launch(
                    b, nprobe, didx.pad_width, dev)),
            })
            emit("scan_kernel", **cases[-1])
    emit("scan_index", build_s=index_s, n_clusters=cases[0]["C"],
         Lmax=cases[0]["Lmax"], tolerance={"rtol": RTOL,
                                           "atol_of_max": ATOL_OF_MAX})
    return {"cases": cases}


# -- phase 4: the slice end to end --------------------------------------------

def _post(port: int, path: str, body) -> tuple[int, object, float]:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            status, payload = r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        status, payload = e.code, json.loads(e.read())
    return status, payload, time.perf_counter() - t0


def _ranking(result: dict) -> tuple[list, list]:
    return ([s["item"] for s in result["itemScores"]],
            [s["score"] for s in result["itemScores"]])


def _check_same(got: dict, want: dict, what: str) -> None:
    """Scores within the tolerance, and item ids equal wherever the plain
    scan's score gap to a neighbour exceeds it (near-tied items may swap;
    the last place may also tie with the first item left out)."""
    gi, gs = _ranking(got)
    wi, ws = _ranking(want)
    if len(gi) != len(wi):
        raise AssertionError(f"{what}: {len(gi)} items, plain scan {len(wi)}")
    atol = ATOL_OF_MAX * max([abs(s) for s in ws] or [1.0])
    for i, (a, b, x, y) in enumerate(zip(gi, wi, gs, ws)):
        if abs(x - y) > RTOL * abs(y) + atol:
            raise AssertionError(f"{what}: score {x} where the plain scan "
                                 f"gives {y}")
        gaps = [abs(y - ws[j]) for j in (i - 1, i + 1) if 0 <= j < len(ws)]
        tied = i == len(ws) - 1 or min(gaps) <= RTOL * abs(y) + atol
        if a != b and not tied:
            raise AssertionError(f"{what}: item {a} where the plain scan "
                                 f"gives {b}")


def profile_queries(qs, queries: list) -> dict:
    """``QueryServer.query`` in process, without HTTP: its host-clock
    time per query, and under ``torch.profiler`` the device time per
    query and the kernels that take it. A query ends in a copy of its
    answer to the host, so its wall time covers its device work."""
    from torch.profiler import ProfilerActivity, profile

    for q in queries[:3]:
        qs.query(q)
    t0 = time.perf_counter()
    for q in queries:
        qs.query(q)
    wall_ms = 1e3 * (time.perf_counter() - t0) / len(queries)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for q in queries:
            qs.query(q)
    torch.cuda.synchronize()
    device_ms, top = device_ms_by_kernel(prof, len(queries))
    return {
        "wall_ms_per_query": wall_ms,
        "device_ms_per_query": device_ms,
        "device_busy_share": (device_ms / wall_ms) if device_ms else None,
        "top_kernels_ms_per_query": top,
    }


def device_ms_by_kernel(prof, n: int) -> tuple:
    """(device ms, the eight largest kernels' ms) per one of the ``n``
    units a ``torch.profiler`` window covered."""
    per_kernel = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        if us > 0 and str(getattr(e, "device_type", "")).endswith("CUDA"):
            per_kernel[e.key] = us / 1e3 / n
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    return (sum(per_kernel.values()) if per_kernel else None), dict(top)


def tie_order_ab(port: int, qs, queries: list) -> dict:
    """The serving top-k with ``torch.topk`` (no order among ties, as
    before the tie-order repair) and with ``topk_lowest_index`` (the
    reference's order), in turns on the same warm server: p50 of the
    queries over HTTP and the in-process ms per query, each measured
    twice. ``torch.topk`` is swapped in here for the measurement only."""
    from pio_tpu_torch.ops import topk

    ordered = topk.topk_lowest_index
    out = {"torch_topk": [], "lowest_index": []}
    for name in ("torch_topk", "lowest_index", "lowest_index",
                 "torch_topk"):
        if name == "torch_topk":
            topk.topk_lowest_index = torch.topk
        try:
            lat = sorted(1e3 * _post(port, "/queries.json", q)[2]
                         for q in queries)
            t0 = time.perf_counter()
            for q in queries:
                qs.query(q)
            inproc_ms = 1e3 * (time.perf_counter() - t0) / len(queries)
        finally:
            topk.topk_lowest_index = ordered
        out[name].append({"p50_ms": statistics.median(lat),
                          "in_process_ms_per_query": inproc_ms})
    return out


def phase_serve(users: np.ndarray, items: np.ndarray,
                dev: torch.device) -> dict:
    from pio_tpu_torch.__main__ import (
        _engine_from_variant,
        _engine_ids,
        _load_variant,
    )
    from pio_tpu_torch.convert import recommendation_model_from_numpy
    from pio_tpu_torch.data.storage import Storage
    from pio_tpu_torch.models import recommendation as rec
    from pio_tpu_torch.ops import als
    from pio_tpu_torch.ops import retrieval as rt
    from pio_tpu_torch.workflow.context import create_workflow_context
    from pio_tpu_torch.workflow.serve import ServingConfig, create_query_server
    from pio_tpu_torch.workflow.train import persist_models

    user_ids = [f"u{i}" for i in range(N_USERS)]
    item_ids = [f"i{i}" for i in range(N_ITEMS)]
    rng = np.random.default_rng(SEED + 2)
    picked = rng.choice(N_USERS, N_PLAIN_QUERIES + BATCH_QUERIES + 3,
                        replace=False)
    with tempfile.TemporaryDirectory(prefix="pio_chip_smoke_") as tmp:
        env = sqlite_env(tmp)
        engine_dir = Path(tmp) / "engine"
        engine_dir.mkdir()
        (engine_dir / "engine.json").write_text(json.dumps({
            "id": "chip-smoke-rec", "engineFactory": FACTORY,
            "algorithms": [{"name": "als", "params": {
                "rank": RANK, "retrieval": RETRIEVAL}}],
        }))
        # what `python -m pio_tpu_torch deploy --engine-dir` reads
        variant = _load_variant(str(engine_dir))
        engine, ep = _engine_from_variant(variant, str(engine_dir))
        engine_id, version, variant_name = _engine_ids(
            variant, str(engine_dir))
        storage = Storage(env=env)
        t0 = time.perf_counter()
        model = recommendation_model_from_numpy(
            users, items, user_ids, item_ids, device=dev)
        iid = persist_models([model], ep, storage, engine_id, version,
                             variant_name, engine_factory=FACTORY)
        persist_s = time.perf_counter() - t0
        del model
        ctx = create_workflow_context(storage, device=dev)
        t0 = time.perf_counter()
        http, qs = create_query_server(
            engine, ep, storage,
            ServingConfig(ip="127.0.0.1", port=0, engine_id=engine_id,
                          engine_version=version,
                          engine_variant=variant_name),
            ctx=ctx)
        http.start()
        load_s = time.perf_counter() - t0
        try:
            port = http.port
            # first query: builds the retrieval index (k-means) once
            warm_user = user_ids[picked[-1]]
            status, warm, first_s = _post(port, "/queries.json",
                                          {"user": warm_user, "num": 10})
            assert status == 200, warm
            plain_q = [{"user": user_ids[i], "num": 10}
                       for i in picked[:N_PLAIN_QUERIES]]
            black = [s["item"] for s in warm["itemScores"][:3]]
            black_q = {"user": warm_user, "num": 10,
                       "blackList": black + ["no-such-item"]}
            white_items = [item_ids[i] for i in rng.choice(N_ITEMS, 24,
                                                           replace=False)]
            white_q = {"user": user_ids[picked[-2]], "num": 5,
                       "whiteList": white_items + ["no-such-item"],
                       "blackList": white_items[:2]}
            ghost_q = {"user": "no-such-user", "num": 10}
            batch_q = ([{"user": user_ids[i], "num": 10} for i in
                        picked[N_PLAIN_QUERIES:
                               N_PLAIN_QUERIES + BATCH_QUERIES - 2]]
                       + [black_q, ghost_q])

            # -- the main path: counts from 0, read right after --------
            reset_counts()
            answers, latencies = [], []
            for q in plain_q:
                status, body, dt = _post(port, "/queries.json", q)
                assert status == 200, body
                answers.append(body)
                latencies.append(dt)
            singles = {}
            for name, q in (("blackList", black_q), ("whiteList", white_q),
                            ("unknownUser", ghost_q)):
                status, singles[name], _ = _post(port, "/queries.json", q)
                assert status == 200, singles[name]
            status, batch_body, batch_s = _post(port, "/batch/queries.json",
                                                batch_q)
            assert status == 200, batch_body
            launches = read_counts()
            # ------------------------------------------------------------

            with urllib.request.urlopen(f"http://127.0.0.1:{port}/",
                                        timeout=60) as r:
                server_status = json.loads(r.read())
            model = qs.models[0]
            inproc = profile_queries(qs, plain_q[:20])
            tie_ab = tie_order_ab(port, qs, plain_q)
        finally:
            http.stop()
            qs.close()
            storage.close()

    # one launch per known-user, non-whiteList /queries.json and one per
    # /batch/queries.json dispatch
    want_launches = len(plain_q) + 1 + 1
    if launches != {**dict.fromkeys(launches, 0),
                    "quantized_scan": want_launches}:
        raise AssertionError(f"kernel launches {launches}, expected "
                             f"{want_launches} on the main path")
    if not server_status["device"].startswith(dev.type):
        raise AssertionError(f"server runs on {server_status['device']}")
    if server_status["engineInstance"]["id"] != iid:
        raise AssertionError("server did not load the persisted instance")

    # the same queries through the port's plain scan on the same index
    plain_algo = rec.ALSAlgorithm(rec.ALSAlgorithmParams(
        rank=RANK, retrieval={**RETRIEVAL, "impl": "xla"}))
    plain_model = rec.RecommendationModel(model.factors, model.users,
                                          model.items)
    for q, got in zip(plain_q, answers):
        if len(got["itemScores"]) != q["num"]:
            raise AssertionError(f"{q}: {len(got['itemScores'])} items")
        _check_same(got, plain_algo.predict(plain_model, q), f"{q['user']}")
    for name, q in (("blackList", black_q), ("whiteList", white_q),
                    ("unknownUser", ghost_q)):
        _check_same(singles[name], plain_algo.predict(plain_model, q), name)
    got_black = set(_ranking(singles["blackList"])[0])
    if got_black & set(black) or len(got_black) != 10:
        raise AssertionError("blackList not honoured")
    got_white = _ranking(singles["whiteList"])[0]
    if not set(got_white) <= set(white_items[2:]) or len(got_white) != 5:
        raise AssertionError("whiteList not honoured")
    if singles["unknownUser"] != {"itemScores": []}:
        raise AssertionError("unknown user got items")
    want_batch = plain_algo.batch_predict(plain_model, batch_q)
    if len(batch_body) != len(batch_q):
        raise AssertionError("batch answer has the wrong length")
    for i, (got, want) in enumerate(zip(batch_body, want_batch)):
        _check_same(got, want, f"batch[{i}]")
    # a query answers the same alone and inside the batch
    _check_same(batch_body[-2], singles["blackList"], "batch blackList")

    # recall@10 of the served answers against the exact oracle
    uidx = np.array([model.users.index_of(q["user"]) for q in plain_q])
    _, exact = als.recommend_topk(model.factors, uidx, 10)
    got_idx = np.array([model.items.encode(_ranking(a)[0]) for a in answers])
    recall = rt.recall_at_k(got_idx, exact.cpu().numpy())
    lat_ms = sorted(1e3 * t for t in latencies)
    result = {
        "users": N_USERS, "items": N_ITEMS, "rank": RANK,
        "retrieval": RETRIEVAL, "launches": launches,
        "queries": len(plain_q) + 3, "batch": len(batch_q),
        "recall_at_10": recall,
        "p50_ms": statistics.median(lat_ms),
        "p90_ms": lat_ms[int(0.9 * (len(lat_ms) - 1))],
        "max_ms": lat_ms[-1], "batch_ms": 1e3 * batch_s,
        "first_query_s": first_s, "persist_s": persist_s, "load_s": load_s,
        "in_process": inproc, "tie_order_ab": tie_ab,
    }
    emit("serve", **result)
    if recall < RECALL_FLOOR:
        raise AssertionError(f"recall@10 {recall} < {RECALL_FLOOR}")
    return result

# -- phase 4b: streaming fold-in on the serve phase's model ---------------

SERVER_KEY = "chip-smoke-key"
FOLDIN_USERS = 4_096       # users in the tail, a quarter of them new
FOLDIN_NEW_SHARE = 0.25
FOLDIN_BATCH = 1_024       # max_batch_users: four batches
FOLDIN_MAX_LEN = 512       # history cap: up to four 128-wide slots
FOLDIN_REG, FOLDIN_ALPHA = 0.05, 10.0   # bench.py's reg and alpha
FOLDIN_SAMPLE = 64         # single-slot users checked beside every multi
FOLDIN_QUERIES = 64        # /queries.json of new users after the cycle
FOLDIN_ITEM_UPSERTS = 64
FOLDIN_HISTORY_SAMPLE = 32  # history reads timed on the store as written
# the f64 check: an f32 Cholesky solve's forward error is bounded by
# cond(A) times its backward error, about (k + 1) unit roundoffs of |A|,
# and A's entries are f32 sums of up to `width` products plus one add per
# further slot; so each row is held within
# (k + width + slots) * 2^-24 * cond(A) of its norm
F32_UNIT = 2.0 ** -24


def tail_events(users_known: int, rng) -> tuple[list, dict, int]:
    """The fold-in tail: FOLDIN_USERS users (a quarter with new ids), each
    a lognormal history length capped at FOLDIN_MAX_LEN of distinct items
    drawn zipf-1.3 over the catalog, as rate (1..5 stars) and buy events;
    then a re-rating of one item for a fifth of the users, written later
    (the later value wins). Returns the events in write order, each as
    (user, item, kind, stars), each user's final {item: value} (rate:
    stars, buy: the template's 4.0) and the count before the re-ratings."""
    n_new = int(FOLDIN_USERS * FOLDIN_NEW_SHARE)
    old = rng.choice(users_known, FOLDIN_USERS - n_new, replace=False)
    ids = [f"u{j}" for j in old] + [f"new{j}" for j in range(n_new)]
    lens = np.minimum(FOLDIN_MAX_LEN, 1 + np.floor(np.exp(
        rng.normal(3.3, 1.2, FOLDIN_USERS)))).astype(int)
    zipf = 1.0 / np.arange(1, N_ITEMS + 1) ** 1.3
    zipf /= zipf.sum()
    first, later, truth = [], [], {}
    for uid, n in zip(ids, lens):
        items = rng.choice(N_ITEMS, min(n, N_ITEMS), replace=False, p=zipf)
        final = truth[uid] = {}
        for it in items:
            kind = "rate" if rng.random() < 0.7 else "buy"
            stars = float(rng.integers(1, 6)) if kind == "rate" else None
            first.append((uid, f"i{it}", kind, stars))
            final[f"i{it}"] = stars if kind == "rate" else 4.0
        if rng.random() < 0.2:
            it = f"i{items[0]}"
            stars = float(rng.integers(1, 6))
            later.append((uid, it, "rate", stars))
            final[it] = stars
    return first + later, truth, len(first)


def write_tail(storage, app_id: int, events: list, n_first: int) -> None:
    """The events in batches, each stamped with the time it is written
    (real time: staleness is measured from it); the re-ratings go in
    after the rest, in a later millisecond."""
    from pio_tpu_torch.data.event import Event
    from pio_tpu_torch.utils.time import utcnow

    ev = storage.get_events()
    step = 20_000
    for lo, hi in [(lo, min(n_first, lo + step))
                   for lo in range(0, n_first, step)] + [
            (n_first, len(events))]:
        time.sleep(0.002)
        now = utcnow()
        ev.insert_batch([
            Event(kind, "user", uid, "item", it,
                  {"rating": stars} if stars is not None else {}, now)
            for uid, it, kind, stars in events[lo:hi]], app_id)


def history_reads(store_path: str, source, user_ids) -> dict:
    """LocalEventSource.history timed over a sample of users, and the
    plan sqlite picks for its query."""
    import sqlite3

    t0 = time.perf_counter()
    for uid in user_ids:
        source.history(uid)
    ms = 1e3 * (time.perf_counter() - t0) / len(user_ids)
    con = sqlite3.connect(store_path)
    try:
        plan = con.execute(
            "EXPLAIN QUERY PLAN SELECT * FROM events WHERE app_id = ? AND "
            "channel_id IS NULL AND entity_type = ? AND entity_id = ? "
            "ORDER BY event_time_ms ASC",
            (source.app_id, "user", user_ids[0])).fetchall()
    finally:
        con.close()
    detail = " | ".join(str(r[-1]) for r in plan)
    return {"ms_per_user": ms, "plan": detail,
            "walks_the_app": "idx_events_app_time" in detail}


def foldin_parts(itf, u, i, v, n_users: int, p) -> tuple[dict, object]:
    """``als_fold_in``'s pipeline piece by piece, each piece's device time
    from CUDA events: the layout (COO to the card, pow2 padding, the slot
    layout), the blocks (``_chunk_blocks`` over the fixed chunks), the
    accumulation (``_add_blocks``), the solve (YᵀY, reg and
    ``_solve_rows_invariant``). Returns (ms by part, rows)."""
    from pio_tpu_torch.ops import als
    from pio_tpu_torch.ops.bucketing import pow2_bucket

    fp = als.fold_in_params(p)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    torch.cuda.synchronize()
    ev[0].record()
    n_bucket = pow2_bucket(n_users)
    pad = pow2_bucket(len(v)) - len(v)
    uu = np.concatenate([u, np.full(pad, n_bucket, np.int32)])
    ii = np.concatenate([i, np.zeros(pad, np.int32)])
    vv = np.concatenate([v, np.zeros(pad, np.float32)])
    ut, it, vt = (torch.from_numpy(x).to(itf.device) for x in (uu, ii, vv))
    cs = als.FOLD_IN_CHUNK_SLOTS
    s = als._slots_for(len(vv), n_bucket, fp.width, cs)
    rows, idx, val, lens = als._device_slot_layout(ut, it, vt, n_bucket,
                                                   fp.width, s)
    ev[1].record()
    blocks = [als._chunk_blocks(itf, idx[c:c + cs], val[c:c + cs],
                                lens[c:c + cs], fp.implicit, fp.alpha)
              for c in range(0, s, cs)]
    ev[2].record()
    k = itf.shape[1]
    A = torch.zeros((n_bucket + 1, k, k), device=itf.device)
    b = torch.zeros((n_bucket + 1, k), device=itf.device)
    for c, (a_blk, b_blk) in zip(range(0, s, cs), blocks):
        als._add_blocks(A, b, rows[c:c + cs], a_blk, b_blk, n_bucket)
    ev[3].record()
    A, b = A[:n_users], b[:n_users]
    if fp.implicit:
        A += als._shared_yty(itf, None)[None, :, :]
    A.diagonal(dim1=1, dim2=2).add_(fp.reg)
    out = als._solve_rows_invariant(A, b)
    ev[4].record()
    ev[4].synchronize()
    names = ("layout", "blocks", "accumulation", "solve")
    return {n: ev[j].elapsed_time(ev[j + 1])
            for j, n in enumerate(names)}, out


def hazards(itf, batch: tuple, p) -> dict:
    """What each design choice of the fold-in guards against, observed on
    this card with one recorded batch: whether ``index_add_`` (the CPU's
    carry) gives other bits on a second run, whether a slot's block
    changes with the chunk size of the batched matmul, and whether a
    batched Cholesky solves a row to other bits alone than in the batch.
    Recorded, not required: the fold-in takes none of these paths."""
    from pio_tpu_torch.ops import als

    u, i, v, n = batch
    dev = itf.device
    fp = als.fold_in_params(p)
    s = als._slots_for(len(v), n, fp.width, 1)
    ut, it, vt = (torch.from_numpy(x).to(dev) for x in (u, i, v))
    rows, idx, val, lens = als._device_slot_layout(ut, it, vt, n, fp.width,
                                                   s)
    a_blk, b_blk = als._chunk_blocks(itf, idx, val, lens, fp.implicit,
                                     fp.alpha)
    k = itf.shape[1]
    runs = []
    for _ in range(3):
        A = torch.zeros((n + 1, k, k), device=dev)
        A.index_add_(0, rows.long(), a_blk)
        runs.append(A)
    atomics_differ = not all(torch.equal(runs[0], r) for r in runs[1:])
    by_c = {}
    # every chunk size the reference's rule, min(chunk_slots, nnz // width
    # + 1) over the pow2 event buckets, gives up to this batch's slots
    sizes = {min(fp.chunk_slots, (1 << e) // fp.width + 1)
             for e in range(24)} | {als.FOLD_IN_CHUNK_SLOTS}
    for c in sorted(sizes):
        c = min(c, s)
        parts = [als._chunk_blocks(itf, idx[lo:lo + c], val[lo:lo + c],
                                   lens[lo:lo + c], fp.implicit, fp.alpha)[0]
                 for lo in range(0, s, c)]
        by_c[c] = torch.cat(parts)
    base = by_c[min(als.FOLD_IN_CHUNK_SLOTS, s)]
    blocks_differ = {str(c): not torch.equal(t, base)
                     for c, t in by_c.items()}
    A = runs[0][:n] + 0.05 * torch.eye(k, device=dev)
    A = A + als._shared_yty(itf, None)[None] if fp.implicit else A
    batched = torch.linalg.cholesky(A)
    alone = torch.stack([torch.linalg.cholesky(A[j:j + 1])[0]
                         for j in range(min(n, 64))])
    return {"index_add_differs_run_to_run": atomics_differ,
            "blocks_differ_by_chunk_size": blocks_differ,
            "batched_cholesky_differs_from_alone":
                not torch.equal(batched[:len(alone)], alone)}


def f64_check(itf64: np.ndarray, pairs: dict, rows: dict, p,
              width: int) -> dict:
    """Each row against the same system solved in f64 on the CPU, within
    (k + width + slots) * 2^-24 * cond(A) of the f64 row's norm."""
    k = itf64.shape[1]
    yty = itf64.T @ itf64 if p.implicit else None
    worst, worst_tol, max_tol = 0.0, 0.0, 0.0
    for uid, (idx, val) in pairs.items():
        y = itf64[idx]
        val = val.astype(np.float64)
        if p.implicit:
            A = yty + (y * (p.alpha * val)[:, None]).T @ y
            b = y.T @ (1.0 + p.alpha * val)
        else:
            A = y.T @ y
            b = y.T @ val
        A = A + p.reg * np.eye(k)
        x = np.linalg.solve(A, b)
        slots = -(-len(idx) // width)
        tol = (k + width + slots) * F32_UNIT * np.linalg.cond(A)
        err = np.linalg.norm(rows[uid].astype(np.float64) - x) / max(
            np.linalg.norm(x), 1e-300)
        if err / tol > worst:
            worst, worst_tol = err / tol, tol
        max_tol = max(max_tol, tol)
    return {"rows": len(pairs), "worst_err_over_tol": worst,
            "tol_of_worst_row": worst_tol, "max_tol": max_tol,
            "tolerance": "(k + width + slots) * 2^-24 * cond(A), relative "
                         "to the f64 row's norm"}


def phase_foldin(users: np.ndarray, items: np.ndarray,
                 dev: torch.device) -> dict:
    """Streaming fold-in at the serve phase's width: the seeded factors
    persisted in a fresh sqlite store and served by ``create_query_server``
    behind a server key with clustered int8 retrieval (K7); a tail of
    interaction events; ``FoldInWorker`` with ``ServingHttpApplier`` over
    loopback HTTP (the worker ``python -m pio_tpu_torch foldin`` runs),
    replaying the log in four batches; the served rows held bit for bit
    to each user's solo fold, to a second worker's, and to f64; queries
    of new users through K7; an item upsert re-encoding K7's table."""
    import sqlite3

    from pio_tpu_torch.__main__ import (
        _engine_from_variant,
        _engine_ids,
        _load_variant,
    )
    from pio_tpu_torch.convert import recommendation_model_from_numpy
    from pio_tpu_torch.data.dao import App
    from pio_tpu_torch.data.storage import Storage
    from pio_tpu_torch.freshness import (
        FoldInConfig,
        FoldInWorker,
        ServingHttpApplier,
        user_pairs,
    )
    from pio_tpu_torch.freshness.tail import LocalEventSource
    from pio_tpu_torch.ops import als
    from pio_tpu_torch.ops import retrieval as rt
    from pio_tpu_torch.ops.kernels import quantized_scan as qscan
    from pio_tpu_torch.utils import durable
    from pio_tpu_torch.workflow.context import create_workflow_context
    from pio_tpu_torch.workflow.serve import ServingConfig, create_query_server
    from pio_tpu_torch.workflow.train import persist_models

    rng = np.random.default_rng(SEED + 11)
    user_ids = [f"u{i}" for i in range(N_USERS)]
    item_ids = [f"i{i}" for i in range(N_ITEMS)]
    events, truth, n_first = tail_events(N_USERS, rng)
    params = als.ALSParams(rank=RANK, reg=FOLDIN_REG, alpha=FOLDIN_ALPHA)
    out: dict = {"users": FOLDIN_USERS, "events": len(events),
                 "multi_slot_users": int(sum(
                     len(t) > 128 for t in truth.values()))}
    with tempfile.TemporaryDirectory(prefix="pio_chip_foldin_") as tmp:
        env = sqlite_env(tmp)
        db_path = env["PIO_STORAGE_SOURCES_SQL_PATH"]
        engine_dir = Path(tmp) / "engine"
        engine_dir.mkdir()
        (engine_dir / "engine.json").write_text(json.dumps({
            "id": "chip-smoke-foldin", "engineFactory": FACTORY,
            "datasource": {"params": {"app_name": "foldin"}},
            "algorithms": [{"name": "als", "params": {
                "rank": RANK, "lambda_": FOLDIN_REG, "alpha": FOLDIN_ALPHA,
                "retrieval": RETRIEVAL}}],
        }))
        variant = _load_variant(str(engine_dir))
        engine, ep = _engine_from_variant(variant, str(engine_dir))
        engine_id, version, variant_name = _engine_ids(
            variant, str(engine_dir))

        # -- the store: factors, then the tail as written --------------
        storage = Storage(env=env)
        t0 = time.perf_counter()
        model = recommendation_model_from_numpy(
            users, items, user_ids, item_ids, device=dev)
        iid = persist_models([model], ep, storage, engine_id, version,
                             variant_name, engine_factory=FACTORY)
        persist_s = time.perf_counter() - t0
        del model
        blob = storage.get_model_data_models().get(iid).models
        t0 = time.perf_counter()
        durable.crc32c(blob)
        crc_s = time.perf_counter() - t0
        app_id = storage.get_metadata_apps().insert(App(0, "foldin"))
        storage.get_events().init(app_id)
        t0 = time.perf_counter()
        write_tail(storage, app_id, events, n_first)
        out["write_s"] = time.perf_counter() - t0
        sample = sorted(truth)[:FOLDIN_HISTORY_SAMPLE]
        out["history_read_as_written"] = history_reads(
            db_path, LocalEventSource(storage, "foldin"), sample)
        storage.close()
        # the planner's statistics, as an operator's ANALYZE writes them
        con = sqlite3.connect(db_path)
        try:
            con.execute("ANALYZE")
            con.commit()
        finally:
            con.close()
        storage = Storage(env=env)
        out["history_read_analyzed"] = history_reads(
            db_path, LocalEventSource(storage, "foldin"), sample)

        ctx = create_workflow_context(storage, device=dev)
        t0 = time.perf_counter()
        http, qs = create_query_server(
            engine, ep, storage,
            ServingConfig(ip="127.0.0.1", port=0, engine_id=engine_id,
                          engine_version=version,
                          engine_variant=variant_name,
                          server_key=SERVER_KEY), ctx=ctx)
        http.start()
        deploy_load_s = time.perf_counter() - t0
        try:
            port = http.port
            url = f"http://127.0.0.1:{port}"
            # the first query builds the retrieval index (k-means) once
            status, _, index_s = _post(port, "/queries.json",
                                       {"user": "u0", "num": 10})
            assert status == 200
            status, body, _ = _post(port, "/model/upsert_users",
                                    {"users": {"x": [0.0] * RANK}})
            if status != 401:
                raise AssertionError(f"upsert without the key: {status}")

            config = FoldInConfig(
                app_name="foldin", engine_id=engine_id,
                engine_version=version, engine_variant=variant_name,
                als_params=params, replay=True,
                max_batch_users=FOLDIN_BATCH,
                state_path=str(Path(tmp) / "cursor-1.bin"),
                cycle_budget_s=0)
            applier = ServingHttpApplier(url, SERVER_KEY, timeout=120)
            applied = []

            class Timed:
                """The applier, each apply's host time and staleness kept."""

                def apply(self, rows, staleness_s=None):
                    t0 = time.perf_counter()
                    res = applier.apply(rows, staleness_s)
                    applied.append((1e3 * (time.perf_counter() - t0),
                                    staleness_s, len(rows)))
                    return res

            solved = []
            fold_in = als.als_fold_in

            def recorded(itf, u, i, v, n, p):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                rows = fold_in(itf, u, i, v, n, p)
                end.record()
                end.synchronize()
                solved.append(((u, i, v, n), rows,
                               start.elapsed_time(end)))
                return rows

            t0 = time.perf_counter()
            worker = FoldInWorker(storage, config, Timed(), device=dev)
            worker._refresh_model()
            folder_load_s = time.perf_counter() - t0
            itf = worker._model.factors.item_factors
            if itf.device != dev:
                raise AssertionError(f"item factors on {itf.device}")

            # -- the main path: counts from 0, read right after --------
            als.als_fold_in = recorded
            try:
                reset_counts()
                t0 = time.perf_counter()
                stats = worker.run_once()
                cycle_s = time.perf_counter() - t0
                new_users = [f"new{j}" for j in range(FOLDIN_QUERIES)]
                answers = []
                for uid in new_users:
                    status, body, _ = _post(port, "/queries.json",
                                            {"user": uid, "num": 10})
                    assert status == 200, body
                    answers.append(body)
                launches_queries = read_counts()
                queried = qs.models[0]     # the model those queries saw
                # an item upsert: 64 existing items pointed hard at 64
                # users, each item the unit direction of its user's row
                # times 1000: the user scores its own item highest of all
                # (Cauchy-Schwarz against the other upserted items), and
                # the item's nearest centroid is one the user probes first
                model = qs.models[0]
                q_users = [user_ids[j] for j in rng.choice(
                    N_USERS, FOLDIN_ITEM_UPSERTS, replace=False)]
                up_items = [item_ids[j] for j in rng.choice(
                    N_ITEMS, FOLDIN_ITEM_UPSERTS, replace=False)]
                urows = model.factors.user_factors[torch.as_tensor(
                    [model.users.index_of(x) for x in q_users],
                    device=dev)].cpu().numpy()
                new_rows = (1000.0 * urows / np.linalg.norm(
                    urows, axis=1, keepdims=True)).astype(np.float32)
                t0 = time.perf_counter()
                status, body, _ = _post(
                    port, f"/model/upsert_users?accessKey={SERVER_KEY}",
                    {"items": {it: [float(x) for x in r]
                               for it, r in zip(up_items, new_rows)}})
                item_upsert_ms = 1e3 * (time.perf_counter() - t0)
                assert status == 200 and body["itemsApplied"] == len(
                    up_items), body
                item_answers = []
                for uid in q_users:
                    status, body, _ = _post(port, "/queries.json",
                                            {"user": uid, "num": 10})
                    assert status == 200, body
                    item_answers.append(body)
                launches = read_counts()
            finally:
                als.als_fold_in = fold_in
            # ------------------------------------------------------------

            model = qs.models[0]
            snap = worker.snapshot()
            spans = worker.tracer.snapshot()
        finally:
            http.stop()
            qs.close()

        # -- checks -------------------------------------------------------
        folded = {u for u in truth
                  if any(it in model.items for it in truth[u])}
        if stats["folded"] != len(folded) or snap["queueDepth"]:
            raise AssertionError(f"cycle {stats}, expected {len(folded)}")
        if len(solved) != -(-len(folded) // FOLDIN_BATCH):
            raise AssertionError(f"{len(solved)} solve batches")
        want_k7 = len(new_users) + len(q_users)
        if launches != {**dict.fromkeys(launches, 0),
                        "quantized_scan": want_k7}:
            raise AssertionError(f"kernel launches {launches}, expected "
                                 f"{want_k7} K7 launches")
        uf = model.factors.user_factors
        served = {u: uf[model.users.index_of(u)].cpu().numpy()
                  for u in folded}
        # each checked user's pairs, read as the worker reads them
        source = LocalEventSource(storage, "foldin")
        multi = sorted(u for u in folded if len(truth[u]) > 128)
        rest = sorted(set(folded) - set(multi))
        checked = multi + [rest[j] for j in rng.choice(
            len(rest), min(FOLDIN_SAMPLE, len(rest)), replace=False)]
        pairs = {}
        for uid in checked:
            known = [(model.items.index_of(it), val) for it, val in
                     user_pairs(source.history(uid), worker.value_fn)
                     if it in model.items]
            pairs[uid] = (np.asarray([k for k, _ in known], np.int32),
                          np.asarray([x for _, x in known], np.float32))
            got = {model.items.id_of(k): x for k, x in known}
            want = {it: x for it, x in truth[uid].items()
                    if it in model.items}
            if got != want:
                raise AssertionError(f"{uid}: pairs differ from the tail")
        for uid, (idx, val) in pairs.items():
            alone = als.als_fold_in(itf, np.zeros(len(idx), np.int32), idx,
                                    val, 1, params)[0].cpu().numpy()
            if not np.array_equal(alone, served[uid]):
                raise AssertionError(f"{uid}: served row is not its solo "
                                     "fold bit for bit")
        # the other mode, on the card: each recorded batch twice, and the
        # same users alone
        implicit = replace(params, implicit=True)
        other = {"batches": len(solved), "solo_users": 0}
        for (u, i, v, n), _, _ in solved:
            first_run = als.als_fold_in(itf, u, i, v, n, implicit)
            if not torch.equal(first_run,
                               als.als_fold_in(itf, u, i, v, n, implicit)):
                raise AssertionError("implicit fold-in: two runs differ")
            counts = np.bincount(u, minlength=n)
            pick = [j for j in range(n) if counts[j] > 128][:32] + list(
                rng.choice(n, 8, replace=False))
            for j in pick:
                m = u == j
                alone = als.als_fold_in(itf, np.zeros(int(m.sum()),
                                                      np.int32),
                                        i[m], v[m], 1, implicit)[0]
                if not torch.equal(alone, first_run[j]):
                    raise AssertionError(f"implicit: batch row {j} is not "
                                         "its solo fold bit for bit")
                other["solo_users"] += 1
        # a second worker over a fresh cursor gives the same rows
        again = {}

        class Keep:
            def apply(self, rows, staleness_s=None):
                again.update(rows)
                return {"applied": len(rows)}

        t0 = time.perf_counter()
        second = FoldInWorker(storage, replace(
            config, state_path=str(Path(tmp) / "cursor-2.bin")), Keep(),
            device=dev)
        second.run_once()
        second_s = time.perf_counter() - t0
        if set(again) != folded or any(
                not np.array_equal(np.asarray(again[u], np.float32),
                                   served[u]) for u in folded):
            raise AssertionError("a second worker's rows differ")
        storage.close()

    # against f64 on the CPU
    itf64 = itf.double().cpu().numpy()
    f64 = f64_check(itf64, pairs, served, params, params.width)
    if f64["worst_err_over_tol"] > 1.0:
        raise AssertionError(f"fold-in vs f64: {f64}")
    # the new users' answers against the exact top-k on the table they
    # were answered from (the folded rows, before the item upsert)
    uidx = np.array([queried.users.index_of(x) for x in new_users])
    _, exact = als.recommend_topk(queried.factors, uidx, 10)
    got_idx = np.array([model.items.encode(_ranking(a)[0])
                        for a in answers])
    recall = rt.recall_at_k(got_idx, exact.cpu().numpy())
    if recall < RECALL_FLOOR:
        raise AssertionError(f"fold-in recall@10 {recall} < {RECALL_FLOOR}")
    # the item upsert: re-encoded rows, retrievable, K7 = its plain version
    idx, didx = model._retrieval_cache[1]
    pos = np.array([model.items.index_of(x) for x in up_items])
    fresh = rt.quantize_table(new_rows, RETRIEVAL["dtype"])
    if not (np.array_equal(idx.table.data[pos], fresh.data)
            and np.array_equal(idx.table.scales[pos], fresh.scales)):
        raise AssertionError("upserted items' quantized rows are stale")
    _, best = als.recommend_topk(model.factors, np.array(
        [model.users.index_of(x) for x in q_users]), 1)
    for uid, own, want_item, body in zip(q_users, up_items,
                                         best[:, 0].cpu().numpy(),
                                         item_answers):
        want_id = model.items.id_of(int(want_item))
        if want_id != own or _ranking(body)[0][0] != want_id:
            raise AssertionError(f"{uid}: best item {want_id} not served "
                                 f"first ({_ranking(body)[0][:3]})")
    u = uf[torch.as_tensor(uidx[:16], device=dev)]
    _, top_c = torch.topk(u @ didx.centroids.T,
                          min(didx.params.nprobe, didx.n_clusters))
    args = (didx.table, didx.scales, didx.gidx, top_c.to(torch.int32), u)
    got = qscan.quantized_scan(*args)
    want = qscan.quantized_scan_reference(*args)
    fin = torch.isfinite(want)
    if not torch.equal(torch.isneginf(got), torch.isneginf(want)) or bool(
            ((got[fin] - want[fin]).abs() > RTOL * want[fin].abs()
             + ATOL_OF_MAX * want[fin].abs().max()).any()):
        raise AssertionError("K7 on the re-encoded table disagrees with "
                             "its plain version")

    # -- numbers ----------------------------------------------------------
    parts = []
    for (u, i, v, n), rows, _ in solved:
        by_part, rows2 = foldin_parts(itf, u, i, v, n, params)
        if not torch.equal(rows2, rows):
            raise AssertionError("the timed pieces differ from als_fold_in")
        parts.append(by_part)
    out.update({
        "launches": launches, "launches_queries": launches_queries,
        "cycle": stats, "cycle_s": cycle_s,
        "rows_folded_per_s": stats["folded"] / cycle_s,
        "solve_ms_per_batch": [ms for _, _, ms in solved],
        "solve_parts_ms_per_batch": parts,
        "batch_users": [n for (_, _, _, n), _, _ in solved],
        "batch_events": [len(v) for (_, _, v, _), _, _ in solved],
        "apply_ms_per_batch": [ms for ms, _, _ in applied],
        "staleness_s_per_batch": [s for _, s, _ in applied],
        "spans": {k: spans[k] for k in ("tail", "solve", "apply")
                  if k in spans},
        "checked_users": len(pairs), "checked_multi_slot": len(multi),
        "implicit": other, "second_worker_s": second_s,
        "f64": f64, "recall_at_10": recall, "index_build_s": index_s,
        "item_upsert_ms": item_upsert_ms,
        "model_bytes": len(blob), "persist_s": persist_s,
        "deploy_load_s": deploy_load_s, "folder_load_s": folder_load_s,
        "crc32c_s": crc_s, "hazards": hazards(itf, solved[0][0], params),
    })
    emit("foldin", **out)
    return out


# -- phase 5: the segment flush kernel (K2) at the users half of ML-20M ------

def synth_ratings():
    """bench.py's ``synth``: zipf-1.2 users and items, ratings 1..5."""
    rng = np.random.default_rng(SEED)
    users = (rng.zipf(1.2, NNZ) % N_USERS).astype(np.int32)
    items = (rng.zipf(1.2, NNZ) % N_ITEMS).astype(np.int32)
    vals = rng.integers(1, 6, NNZ).astype(np.float32)
    return users, items, vals


def train_params(accum: str = "auto"):
    from pio_tpu_torch.ops import als

    # bench.py's bench_params at the full shape (cg_iters auto -> 16)
    return als.ALSParams(rank=RANK, iterations=ITERS, reg=0.05, alpha=10.0,
                         implicit=True, chunk=8192, accum=accum)


def flush_bound(s_real: int, n_self: int, k: int) -> tuple[float, str]:
    """Least time for one flush. Bytes: each real slot's block, rhs and
    row id read once, A and b written once. Operations: one add per
    element of each real block and rhs, on the f32 CUDA cores."""
    nbytes = s_real * (k * k + k + 1) * 4 + n_self * (k * k + k) * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = s_real * (k * k + k) / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_flush_kernel(ratings, dev: torch.device) -> dict:
    from pio_tpu_torch.ops import als
    from pio_tpu_torch.ops.kernels import segment_flush as sf

    p = train_params()
    u, i, v = als._prep_coo(*ratings, N_USERS, N_ITEMS, p, dev)
    by_user, _, cs = als._build_layouts(u, i, v, N_USERS, N_ITEMS, p)
    del u, i, v
    users0, items0 = als._init_or(None, N_USERS, N_ITEMS, p, dev)
    rows, idx, val, lens = by_user
    S = rows.shape[0]
    s_real = int((rows < N_USERS).sum())
    # the layout holds every rating, in ceil(count / width) slots a row
    counts = np.bincount(ratings[0], minlength=N_USERS)
    want_real = int(np.ceil(counts / p.width).sum())
    if int(lens.sum()) != NNZ or s_real != want_real:
        raise AssertionError(f"users layout: {int(lens.sum())} ratings in "
                             f"{s_real} slots, want {NNZ} in {want_real}")
    # real blocks: the first sweep's users half, built as the hybrid path
    # builds them (bf16 gather of the item factors, f32 products)
    a_blk, b_blk = als._group_blocks(items0.to(torch.bfloat16), idx, val,
                                     lens, 0, S, cs, True, p.alpha)
    del by_user, idx, val, lens
    got = sf.segment_flush(rows, a_blk, b_blk, N_USERS)
    again = sf.segment_flush(rows, a_blk, b_blk, N_USERS)
    torch.cuda.synchronize()
    identical = (torch.equal(got[0], again[0])
                 and torch.equal(got[1], again[1]))
    del again
    plain = sf.segment_flush_reference(rows, a_blk, b_blk, N_USERS)
    max_abs_err = max(float((got[0] - plain[0]).abs().max()),
                      float((got[1] - plain[1]).abs().max()))
    want = sf.segment_flush_reference(rows, a_blk.double(), b_blk.double(),
                                      N_USERS)
    rel = {}
    for name, g, w, pl in (("A", got[0], want[0], plain[0]),
                           ("b", got[1], want[1], plain[1])):
        scale = w.reshape(N_USERS, -1).abs().amax(1).clamp_min(1e-30)
        rel[name] = float(((g.double() - w).reshape(N_USERS, -1).abs()
                           .amax(1) / scale).max())
        rel[name + "_plain"] = float(((pl.double() - w).reshape(
            N_USERS, -1).abs().amax(1) / scale).max())
    del want, plain
    if not identical:
        raise AssertionError("segment_flush: two launches differ")
    if max(rel["A"], rel["b"]) > FLUSH_RTOL:
        raise AssertionError(f"segment_flush disagrees with its plain "
                             f"version: {rel}")
    A_buf, b_buf = got
    rows_long = rows.long()
    A_lib = torch.zeros((N_USERS + 1, RANK, RANK), device=dev)
    bound_ms, bound_by = flush_bound(s_real, N_USERS, RANK)
    result = {
        "S": S, "S_real": s_real, "n_self": N_USERS, "k": RANK,
        "max_abs_err": max_abs_err, "max_row_rel_err": rel,
        "bit_identical": identical,
        "tolerance": {"rtol_of_row_max": FLUSH_RTOL},
        # the call as the contract has it: A and b allocated zeroed
        "ms": gpu_ms(lambda: sf.segment_flush(rows, a_blk, b_blk, N_USERS)),
        # the same flush into buffers zeroed once (the hybrid path's form)
        "ms_into_buffers": gpu_ms(lambda: sf.segment_flush(
            rows, a_blk, b_blk, N_USERS, out=(A_buf, b_buf))),
        "plain_ms": gpu_ms(lambda: sf.segment_flush_reference(
            rows, a_blk, b_blk, N_USERS)),
        "library_ms": gpu_ms(lambda: A_lib.index_add_(0, rows_long, a_blk)),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "blocks_gb": a_blk.numel() * 4 / 1e9,
    }
    emit("segment_flush_kernel", **result)
    return result


# -- phase 6: ALS training at the ML-20M shape --------------------------------

def expected_flush_launches(nnz: int, n_users: int, n_items: int,
                            p) -> int:
    """K2 launches of als_train: one per group of each half, both halves
    every sweep, from the layout's slot counts and the group split."""
    from pio_tpu_torch.ops import als

    nnz_pad = nnz + (-nnz % p.chunk)
    cs = min(p.chunk_slots, als._slots_for(nnz_pad, 0, p.width, 1))
    groups = sum(len(als._group_bounds(
        als._slots_for(nnz_pad, n, p.width, cs), p.rank, cs, p.group_slots))
        for n in (n_users, n_items))
    return groups * p.iterations


def assert_f32_matmul() -> None:
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise AssertionError("TF32 is on during training")


def profile_sweep(sweep, carry) -> dict:
    """One sweep under torch.profiler: its wall time, the device time of
    its kernels, and the kernels that take it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sweep(carry)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    per_kernel = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        if us > 0 and str(getattr(e, "device_type", "")).endswith("CUDA"):
            per_kernel[e.key] = (us / 1e3, e.count)
    device_ms = sum(ms for ms, _ in per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:10]
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "device_busy_share": device_ms / wall_ms if wall_ms else None,
            "top_kernels_ms_calls": {k: list(v) for k, v in top}}


def time_sweeps(by_user, by_item, cs: int, p, init) -> tuple:
    """The schedule's sweeps one by one from ``init`` (host-clock seconds
    of each), then one warm and one cold sweep under the profiler."""
    from pio_tpu_torch.ops import als

    cg_u, cg_i = p.resolved_cg_iters(N_USERS), p.resolved_cg_iters(N_ITEMS)
    n_full, _, w_u, w_i = als._cg_schedule(p, cg_u, cg_i)
    sweep_with = als._sweep_factory(by_user, by_item, N_USERS, N_ITEMS, cs, p)
    carry, sweep_s = init, []
    for n in range(ITERS):
        sweep = sweep_with(cg_u, cg_i) if n < n_full else sweep_with(w_u, w_i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        carry = sweep(carry)
        torch.cuda.synchronize()
        sweep_s.append(time.perf_counter() - t0)
    warm = profile_sweep(sweep_with(w_u, w_i), carry)
    cold = profile_sweep(sweep_with(cg_u, cg_i), init)
    return sweep_s, warm, cold


def _rel(g: torch.Tensor, w: torch.Tensor) -> dict:
    g, w = g.double(), w.double()
    return {"rel_norm": float((g - w).norm() / w.norm()),
            "rel_max": float((g - w).abs().max() / w.abs().max())}


def items_half_f64(by_item, users, x0, cg_iters: int):
    """The items half of a sweep in f64 from the same users (the same
    bf16 gather): blocks, index_add_ sums, YᵀY, reg and CG all in f64."""
    from pio_tpu_torch.ops import als
    from pio_tpu_torch.ops.kernels import segment_flush as sf

    p = train_params()
    A, b = sf.normal_equations_fused_reference(
        *by_item, users.to(torch.bfloat16).double(), N_ITEMS, p.implicit,
        p.alpha)
    u64 = users.double()
    A += (u64.T @ u64)[None, :, :]
    A.diagonal(dim1=1, dim2=2).add_(p.reg)
    if cg_iters > 0:
        return als._cg_solve(A, b, x0.double(), cg_iters)
    return torch.cholesky_solve(b[:, :, None],
                                torch.linalg.cholesky(A))[:, :, 0]


def hybrid_vs_carry(by_user, by_item, cs: int, init, cg_u: int,
                    cg_i: int) -> dict:
    """The kernel's accumulation against the plain one, one half at a
    time from the same inputs (see USERS_RTOL_NORM)."""
    from pio_tpu_torch.ops import als

    p = train_params()

    def half(layout, other, n, x0, cg, accum):
        return als._solve_factors(
            layout, other, n, p.reg, p.implicit, p.alpha, cs, x0=x0,
            cg_iters=cg, bf16_gather=p.bf16_gather, accum=accum,
            group_slots=p.group_slots)

    users = {a: half(by_user, init[1], N_USERS, init[0], cg_u, a)
             for a in ("hybrid", "carry")}
    out = {"users": _rel(users["hybrid"], users["carry"])}
    if (out["users"]["rel_norm"] > USERS_RTOL_NORM
            or out["users"]["rel_max"] > USERS_RTOL_MAX):
        raise AssertionError(f"users half: hybrid disagrees with carry: "
                             f"{out}")
    items = {a: half(by_item, users["carry"], N_ITEMS, init[1], cg_i, a)
             for a in ("hybrid", "carry")}
    exact = items_half_f64(by_item, users["carry"], init[1], cg_i)
    out["items"] = _rel(items["hybrid"], items["carry"])
    out["items_hybrid_vs_f64"] = _rel(items["hybrid"], exact)
    out["items_carry_vs_f64"] = _rel(items["carry"], exact)
    for key in ("rel_norm", "rel_max"):
        if (out["items_hybrid_vs_f64"][key] > HALF_F64_RATIO
                * out["items_carry_vs_f64"][key] + HALF_F64_FLOOR):
            raise AssertionError(f"items half: hybrid is farther from f64 "
                                 f"than carry: {out}")
    return out


def phase_train(ratings, dev: torch.device) -> dict:
    from pio_tpu_torch.ops import als

    p = train_params()
    if p.resolved_accum(dev) != "hybrid":
        raise AssertionError(f"accum auto resolved to "
                             f"{p.resolved_accum(dev)} on {dev}")
    assert_f32_matmul()
    want_launches = expected_flush_launches(NNZ, N_USERS, N_ITEMS, p)

    # the entry point, twice: the first call also builds cuBLAS state
    als.als_train(*ratings, N_USERS, N_ITEMS, p, device=dev)
    torch.cuda.synchronize()
    # -- the main path: counts from 0, read right after ------------------
    reset_counts()
    t0 = time.perf_counter()
    model = als.als_train(*ratings, N_USERS, N_ITEMS, p, device=dev)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    counts = read_counts()
    launches = counts["segment_flush"]
    # ---------------------------------------------------------------------
    assert_f32_matmul()
    for name, f, n in (("users", model.user_factors, N_USERS),
                       ("items", model.item_factors, N_ITEMS)):
        if f.shape != (n, RANK) or not bool(torch.isfinite(f).all()):
            raise AssertionError(f"{name} factors {tuple(f.shape)} not "
                                 f"finite of shape ({n}, {RANK})")
    if counts != {**dict.fromkeys(counts, 0), "segment_flush": want_launches}:
        raise AssertionError(f"launches {counts}: the layout predicts "
                             f"{want_launches} of segment_flush, no other")
    del model

    # the sweeps one by one, from the layout als_train builds
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    u, i, v = als._prep_coo(*ratings, N_USERS, N_ITEMS, p, dev)
    by_user, by_item, cs = als._build_layouts(u, i, v, N_USERS, N_ITEMS, p)
    del u, i, v
    torch.cuda.synchronize()
    layout_s = time.perf_counter() - t0
    s_real = {"users": int((by_user[0] < N_USERS).sum()),
              "items": int((by_item[0] < N_ITEMS).sum())}
    init = als._init_or(None, N_USERS, N_ITEMS, p, dev)
    cg_u, cg_i = p.resolved_cg_iters(N_USERS), p.resolved_cg_iters(N_ITEMS)
    n_full, _, w_u, w_i = als._cg_schedule(p, cg_u, cg_i)
    sweep_s, warm, cold = time_sweeps(by_user, by_item, cs, p, init)

    agree = hybrid_vs_carry(by_user, by_item, cs, init, cg_u, cg_i)
    assert_f32_matmul()
    result = {
        "nnz": NNZ, "users": N_USERS, "items": N_ITEMS, "rank": RANK,
        "iterations": ITERS, "cg_iters": [cg_u, cg_i],
        "cg_warm": [w_u, w_i, n_full], "accum": p.resolved_accum(dev),
        "tf32": False,
        "train_s": train_s, "ratings_per_s": NNZ * ITERS / train_s,
        "layout_s": layout_s, "sweep_s": sweep_s,
        "sweeps_ratings_per_s": NNZ * ITERS / sum(sweep_s),
        "slots": {"users": by_user[0].shape[0], "items": by_item[0].shape[0],
                  "real": s_real},
        "segment_flush_launches": launches,
        "segment_flush_launches_expected": want_launches,
        "profile_warm_sweep": warm, "profile_cold_sweep": cold,
        "hybrid_vs_carry": agree,
        "tolerance": {"users_rel_norm": USERS_RTOL_NORM,
                      "users_rel_max": USERS_RTOL_MAX,
                      "items_f64_ratio": HALF_F64_RATIO,
                      "items_f64_floor": HALF_F64_FLOOR},
    }
    emit("train", **result)
    return result


# -- phase 6b: validated training and reusable layouts at the ML-20M shape --

VALIDATION_FRACTION = 0.1   # the heldout share, split as the template does


def phase_train_validated(ratings, dev: torch.device) -> dict:
    """``als_train_validated`` on the ML-20M shape with a tenth held out
    (the recommendation template's seeded split), against ``als_train``
    on the same training triples in the same call; the returned factors
    bit for bit those of a run that stops at the best sweep; then one
    ``als_build_layouts`` and two trainings on it."""
    from pio_tpu_torch.ops import als

    p = train_params()
    if p.resolved_accum(dev) != "hybrid":
        raise AssertionError("accum auto is not hybrid on the card")
    assert_f32_matmul()
    users, items, vals = ratings
    perm = np.random.default_rng(p.seed).permutation(NNZ)
    n_val = max(1, int(NNZ * VALIDATION_FRACTION))
    va, tr = perm[:n_val], perm[n_val:]
    train = (users[tr], items[tr], vals[tr])
    val = (users[va], items[va], vals[va])
    del perm, va, tr
    nnz = len(train[0])
    want = expected_flush_launches(nnz, N_USERS, N_ITEMS, p)
    init = als.ALSModel(*als._init_or(None, N_USERS, N_ITEMS, p, dev))

    def timed_train(fn, *args, **kw):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, read_counts()

    # -- the main path: counts from 0, read right after ------------------
    (best, curve), val_s, launches = timed_train(
        als.als_train_validated, *train, N_USERS, N_ITEMS, p, *val,
        init=init, device=dev)
    # ---------------------------------------------------------------------
    if launches != {**dict.fromkeys(launches, 0), "segment_flush": want}:
        raise AssertionError(f"validated: launches {launches}, the layout "
                             f"predicts {want} of segment_flush")
    plain, train_s, _ = timed_train(als.als_train, *train, N_USERS, N_ITEMS,
                                    p, init=init, device=dev)
    short, _, short_launches = timed_train(
        als.als_train, *train, N_USERS, N_ITEMS,
        replace(p, iterations=curve.best_sweep), init=init, device=dev)
    best_is_short = (torch.equal(best.user_factors, short.user_factors)
                     and torch.equal(best.item_factors, short.item_factors))
    if not best_is_short:
        raise AssertionError(
            f"the best sweep's factors ({curve.best_sweep}) differ from a "
            "run that stops there")
    final_is_plain = None
    if curve.best_sweep == ITERS:
        final_is_plain = (
            torch.equal(best.user_factors, plain.user_factors)
            and torch.equal(best.item_factors, plain.item_factors))
    del short, best
    for f in (plain.user_factors, plain.item_factors):
        if not bool(torch.isfinite(f).all()):
            raise AssertionError("als_train factors are not finite")

    layouts, layout_s, _ = timed_train(als.als_build_layouts, *train,
                                       N_USERS, N_ITEMS, p, device=dev)
    on_layouts = []
    for _ in range(2):
        got, sweeps_s, counts = timed_train(
            als.als_train, *train, N_USERS, N_ITEMS, p, init=init,
            device=dev, layouts=layouts)
        same = (torch.equal(got.user_factors, plain.user_factors)
                and torch.equal(got.item_factors, plain.item_factors))
        if not same or counts["segment_flush"] != want:
            raise AssertionError(f"training on prebuilt layouts: bit-equal "
                                 f"{same}, launches {counts}")
        on_layouts.append(sweeps_s)
    del layouts, plain, got
    result = {
        "nnz_train": nnz, "nnz_heldout": n_val, "users": N_USERS,
        "items": N_ITEMS, "rank": RANK, "iterations": ITERS,
        "accum": p.resolved_accum(dev), "implicit": p.implicit,
        "validation_fraction": VALIDATION_FRACTION,
        "curve": list(curve.curve), "best_sweep": curve.best_sweep,
        "best_rmse": curve.best_rmse, "final_rmse": curve.final_rmse,
        "validated_s": val_s, "als_train_s": train_s,
        "validated_ratings_per_s": nnz * ITERS / val_s,
        "als_train_ratings_per_s": nnz * ITERS / train_s,
        "launches": launches, "segment_flush_launches_expected": want,
        "short_run_launches": short_launches["segment_flush"],
        "best_equals_run_stopped_there": best_is_short,
        "final_equals_als_train": final_is_plain,
        "layout_build_s": layout_s, "sweeps_on_layouts_s": on_layouts,
        "layout_share": layout_s / (layout_s + min(on_layouts)),
        "on_layouts_bit_equal_als_train": True,
    }
    emit("train_validated", **result)
    return result


# -- phase 7: the streaming configuration's kernels (K3, K4, K5, K6) ---------

def gather_bound(m: int, n: int, k: int, esize: int) -> tuple[float, str]:
    """Least time for one gather: M rows written, M indices and the
    table read once; no arithmetic."""
    nbytes = m * k * esize + m * 4 + n * k * esize
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes"


def matvec_bound(n: int, k: int) -> tuple[float, str]:
    """Least time for one packed matvec: A, x read once, out written
    once; 2 flops per element of A on the f32 CUDA cores."""
    t_bytes = (n * k * k + 2 * n * k) * 4 / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * n * k * k / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _gather_cases(table, i_c) -> dict:
    """K5 and both K4 variants on one chunk's indices: equal to
    ``table[idx]`` bit for bit, and timed beside ``src[i_c]`` (the xla
    gather's call)."""
    from pio_tpu_torch.ops.kernels import gather_rows as gr

    flat = i_c.reshape(-1)
    want = gr.gather_rows_reference(table, flat)
    bound_ms, bound_by = gather_bound(flat.numel(), table.shape[0],
                                      table.shape[1], table.element_size())
    out = {}
    for name, fn in (
            ("stream", lambda: gr.gather_rows_stream(table, flat)),
            ("copy", lambda: gr.gather_rows_resident(table, flat, "copy")),
            ("take", lambda: gr.gather_rows_resident(table, flat, "take"))):
        got = fn()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"gather {name}: differs from table[idx]")
        out[name] = {"equal": True, "max_abs_err": 0.0, "ms": gpu_ms(fn)}
    plain_ms = gpu_ms(lambda: gr.gather_rows_reference(table, flat))
    library_ms = gpu_ms(lambda: table[i_c])
    for case in out.values():
        case.update(plain_ms=plain_ms, library_ms=library_ms,
                    bound_ms=bound_ms, bound_by=bound_by)
    return {"M": flat.numel(), "N": table.shape[0], "k": table.shape[1],
            "dtype": str(table.dtype).split(".")[-1], "cases": out}


def phase_stream_kernels(ratings, dev: torch.device) -> dict:
    from pio_tpu_torch.ops import als
    from pio_tpu_torch.ops.kernels import packed_matvec as pm
    from pio_tpu_torch.ops.kernels import segment_flush as sf

    p = train_params()
    u, i, v = als._prep_coo(*ratings, N_USERS, N_ITEMS, p, dev)
    by_user, by_item, cs = als._build_layouts(u, i, v, N_USERS, N_ITEMS, p)
    del u, i, v
    users0, items0 = als._init_or(None, N_USERS, N_ITEMS, p, dev)

    # K5, K4: one chunk of each half, as _chunk_blocks gathers it
    gathers = {
        "users_half": _gather_cases(items0.to(torch.bfloat16),
                                    by_user[1][:cs]),
        "items_half": _gather_cases(users0.to(torch.bfloat16),
                                    by_item[1][:cs]),
    }
    del by_item

    # K3 against K2 on the first sweep's users-half blocks
    rows, idx, val, lens = by_user
    S = rows.shape[0]
    s_real = int((rows < N_USERS).sum())
    a_blk, b_blk = als._group_blocks(items0.to(torch.bfloat16), idx, val,
                                     lens, 0, S, cs, True, p.alpha)
    del by_user, idx, val, lens
    k2 = sf.segment_flush(rows, a_blk, b_blk, N_USERS)
    k3 = sf.segment_flush_stream(rows, a_blk, b_blk, N_USERS)
    k3p = sf.segment_flush_stream(rows, a_blk, b_blk, N_USERS, packed=True)
    torch.cuda.synchronize()
    k3_is_k2 = torch.equal(k3[0], k2[0]) and torch.equal(k3[1], k2[1])
    packed_is_unpacked = (k3p[0].shape == (N_USERS, RANK * RANK)
                          and torch.equal(k3p[0], k3[0].reshape(N_USERS, -1))
                          and torch.equal(k3p[1], k3[1]))
    del k3
    plain = sf.segment_flush_reference(rows, a_blk, b_blk, N_USERS)
    flush_err = max(float((k2[0] - plain[0]).abs().max()),
                    float((k2[1] - plain[1]).abs().max()))
    del plain
    if not (k3_is_k2 and packed_is_unpacked):
        raise AssertionError(f"segment_flush_stream: bit-identical to K2 "
                             f"{k3_is_k2}, packed == unpacked "
                             f"{packed_is_unpacked}")
    A_buf, b_buf = k3p
    rows_long = rows.long()
    A_lib = torch.zeros((N_USERS + 1, RANK, RANK), device=dev)
    bound_ms, bound_by = flush_bound(s_real, N_USERS, RANK)
    flush = {
        "S": S, "S_real": s_real, "n_self": N_USERS, "k": RANK,
        "bit_identical_to_k2": k3_is_k2,
        "packed_equals_unpacked": packed_is_unpacked,
        "max_abs_err": flush_err,
        "ms": gpu_ms(lambda: sf.segment_flush_stream(
            rows, a_blk, b_blk, N_USERS, packed=True)),
        "ms_into_buffers": gpu_ms(lambda: sf.segment_flush_stream(
            rows, a_blk, b_blk, N_USERS, out=(A_buf, b_buf), packed=True)),
        "k2_ms": gpu_ms(lambda: sf.segment_flush(rows, a_blk, b_blk,
                                                 N_USERS)),
        "plain_ms": gpu_ms(lambda: sf.segment_flush_reference(
            rows, a_blk, b_blk, N_USERS)),
        "library_ms": gpu_ms(lambda: A_lib.index_add_(0, rows_long, a_blk)),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    del k2, A_lib, a_blk, b_blk, rows_long, b_buf

    # K6 on the packed users-half A, x the users' init factors
    a_packed, x = A_buf, users0
    got = pm.packed_block_matvec(a_packed, x)
    torch.cuda.synchronize()
    a3 = a_packed.double().view(N_USERS, RANK, RANK)
    want = torch.bmm(a3, x.double()[:, :, None])[:, :, 0]
    scale = torch.bmm(a3.abs(), x.double().abs()[:, :, None])[:, :, 0]
    del a3
    plain = pm.packed_block_matvec_reference(a_packed, x)
    err = (got.double() - want).abs()
    rel = float((err / scale.clamp_min(1e-300)).max())
    rel_plain = float(((plain.double() - want).abs()
                       / scale.clamp_min(1e-300)).max())
    if rel > MATVEC_RTOL:
        raise AssertionError(f"packed_matvec: {rel} of the terms' magnitude "
                             f"from the f64 product (limit {MATVEC_RTOL})")
    a3f = a_packed.view(N_USERS, RANK, RANK)
    a_items = a_packed[:N_ITEMS]
    x_items = items0
    bound_ms, bound_by = matvec_bound(N_USERS, RANK)
    matvec = {
        "n": N_USERS, "k": RANK, "max_abs_err": float(err.max()),
        "max_rel_err_of_terms": rel, "plain_max_rel_err_of_terms": rel_plain,
        "ms": gpu_ms(lambda: pm.packed_block_matvec(a_packed, x)),
        "plain_ms": gpu_ms(lambda: pm.packed_block_matvec_reference(
            a_packed, x)),
        "library_ms": gpu_ms(lambda: torch.bmm(a3f, x[:, :, None])),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "items_side": {
            "n": N_ITEMS,
            "ms": gpu_ms(lambda: pm.packed_block_matvec(a_items, x_items)),
            "library_ms": gpu_ms(lambda: torch.bmm(
                a_items.view(N_ITEMS, RANK, RANK), x_items[:, :, None])),
            "bound_ms": matvec_bound(N_ITEMS, RANK)[0]},
    }
    result = {"gathers": gathers, "segment_flush_stream": flush,
              "packed_matvec": matvec,
              "tolerance": {"gather": "bitwise", "flush": "bitwise vs K2",
                            "matvec_rtol_of_terms": MATVEC_RTOL}}
    emit("stream_kernels", **result)
    return result


# -- phase 8: ALS training in the streaming configuration -----------------------

def stream_params(**over):
    return replace(train_params(), accum="stream", gather="stream",
                   packed_a=True, **over)


def expected_stream_launches(nnz: int, p) -> dict:
    """K3, K5 and K6 launches of als_train in the streaming
    configuration, from the layout: K3 one per group of each half, K5
    one per chunk of each half, K6 one per CG iteration plus one for
    the first residual, on each side that runs CG."""
    from pio_tpu_torch.ops import als

    nnz_pad = nnz + (-nnz % p.chunk)
    cs = min(p.chunk_slots, als._slots_for(nnz_pad, 0, p.width, 1))
    chunks = sum(als._slots_for(nnz_pad, n, p.width, cs) // cs
                 for n in (N_USERS, N_ITEMS))
    cg_u, cg_i = p.resolved_cg_iters(N_USERS), p.resolved_cg_iters(N_ITEMS)
    n_full, n_warm, w_u, w_i = als._cg_schedule(p, cg_u, cg_i)

    def matvecs(*cgs):
        return sum(c + 1 for c in cgs if c > 0)

    return {"segment_flush_stream": expected_flush_launches(
                nnz, N_USERS, N_ITEMS, p),
            "gather_rows_stream": chunks * p.iterations,
            "packed_matvec": (n_full * matvecs(cg_u, cg_i)
                              + n_warm * matvecs(w_u, w_i))}


def one_sweep(by_user, by_item, cs: int, init, p, cg_u: int,
              cg_i: int) -> tuple[tuple, dict]:
    """One sweep from ``init`` with params ``p``; its launches."""
    from pio_tpu_torch.ops import als

    sweep = als._sweep_factory(by_user, by_item, N_USERS, N_ITEMS, cs,
                               p)(cg_u, cg_i)
    torch.cuda.synchronize()
    reset_counts()
    out = sweep(init)
    torch.cuda.synchronize()
    return out, read_counts()


def halves_vs_hybrid(by_user, by_item, cs: int, init, cg_u: int, cg_i: int,
                     p, name: str) -> dict:
    """One sweep's halves with params ``p`` against the hybrid path (K2,
    cuBLAS CG) from the same inputs: the users half within USERS_RTOL_NORM
    / USERS_RTOL_MAX of hybrid, the items half no farther from its f64
    evaluation than HALF_F64_RATIO times hybrid's distance."""
    from pio_tpu_torch.ops import als

    base = train_params()

    def half(layout, other, n, x0, cg, q):
        return als._solve_factors(
            layout, other, n, q.reg, q.implicit, q.alpha, cs, x0=x0,
            cg_iters=cg, bf16_gather=q.bf16_gather, accum=q.accum,
            group_slots=q.group_slots, gather=q.gather, packed=q.packed_a)

    users = {name: half(by_user, init[1], N_USERS, init[0], cg_u, p),
             "hybrid": half(by_user, init[1], N_USERS, init[0], cg_u, base)}
    agree = {"users": _rel(users[name], users["hybrid"])}
    if (agree["users"]["rel_norm"] > USERS_RTOL_NORM
            or agree["users"]["rel_max"] > USERS_RTOL_MAX):
        raise AssertionError(f"users half: {name} disagrees with hybrid: "
                             f"{agree}")
    other = users["hybrid"]
    items = {name: half(by_item, other, N_ITEMS, init[1], cg_i, p),
             "hybrid": half(by_item, other, N_ITEMS, init[1], cg_i, base)}
    exact = items_half_f64(by_item, other, init[1], cg_i)
    agree["items"] = _rel(items[name], items["hybrid"])
    agree[f"items_{name}_vs_f64"] = _rel(items[name], exact)
    agree["items_hybrid_vs_f64"] = _rel(items["hybrid"], exact)
    del users, items, exact, other
    for key in ("rel_norm", "rel_max"):
        if (agree[f"items_{name}_vs_f64"][key] > HALF_F64_RATIO
                * agree["items_hybrid_vs_f64"][key] + HALF_F64_FLOOR):
            raise AssertionError(f"items half: {name} is farther from f64 "
                                 f"than hybrid: {agree}")
    return agree


def phase_train_stream(ratings, dev: torch.device) -> dict:
    from pio_tpu_torch.ops import als
    from pio_tpu_torch.ops.kernels import gather_rows as gr

    p = stream_params()
    if p.resolved_accum(dev) != "stream" or not p.resolved_packed(dev):
        raise AssertionError(f"stream config resolved to "
                             f"{p.resolved_accum(dev)}, packed "
                             f"{p.resolved_packed(dev)}")
    assert_f32_matmul()
    want = expected_stream_launches(NNZ, p)

    als.als_train(*ratings, N_USERS, N_ITEMS, p, device=dev)
    torch.cuda.synchronize()
    # -- the main path: counts from 0, read right after ------------------
    reset_counts()
    t0 = time.perf_counter()
    model = als.als_train(*ratings, N_USERS, N_ITEMS, p, device=dev)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = read_counts()
    # ---------------------------------------------------------------------
    assert_f32_matmul()
    for name, f, n in (("users", model.user_factors, N_USERS),
                       ("items", model.item_factors, N_ITEMS)):
        if f.shape != (n, RANK) or not bool(torch.isfinite(f).all()):
            raise AssertionError(f"{name} factors {tuple(f.shape)} not "
                                 f"finite of shape ({n}, {RANK})")
    if launches != {**dict.fromkeys(launches, 0), **want}:
        raise AssertionError(f"launches {launches}; the layout predicts "
                             f"{want} and no other kernel")
    del model

    u, i, v = als._prep_coo(*ratings, N_USERS, N_ITEMS, p, dev)
    by_user, by_item, cs = als._build_layouts(u, i, v, N_USERS, N_ITEMS, p)
    del u, i, v
    init = als._init_or(None, N_USERS, N_ITEMS, p, dev)
    cg_u, cg_i = p.resolved_cg_iters(N_USERS), p.resolved_cg_iters(N_ITEMS)
    n_full, _, w_u, w_i = als._cg_schedule(p, cg_u, cg_i)
    sweep_s, warm, cold = time_sweeps(by_user, by_item, cs, p, init)

    agree = halves_vs_hybrid(by_user, by_item, cs, init, cg_u, cg_i, p,
                             "stream")
    base = train_params()

    # one cold sweep with each kernel gather against the xla gather, from
    # the same init on the hybrid path: the same bytes feed the same
    # deterministic products, so the factors must be equal bit for bit
    xla, _ = one_sweep(by_user, by_item, cs, init,
                       replace(base, gather="xla"), cg_u, cg_i)
    chunks_u = by_user[0].shape[0] // cs
    gathers = {}
    for g in ("stream", "pallas-copy", "pallas-take"):
        got, counts = one_sweep(by_user, by_item, cs, init,
                                replace(base, gather=g), cg_u, cg_i)
        equal = (torch.equal(got[0], xla[0]) and torch.equal(got[1], xla[1]))
        gathers[g] = {"equal_to_xla": equal, "launches": counts}
        if not equal:
            raise AssertionError(f"gather={g}: one sweep differs from "
                                 f"gather='xla'")
    chunks_i = by_item[0].shape[0] // cs
    if gathers["stream"]["launches"]["gather_rows_stream"] != (
            chunks_u + chunks_i):
        raise AssertionError(f"gather=stream: {gathers['stream']}")
    # the reference's table-size rule: at ML-20M the items table fits the
    # budget (the users half launches), the users table does not (the
    # items half takes src[i_c])
    fits = {n: gr.gather_table_bytes(n, RANK, base.bf16_gather)
            <= gr.GATHER_VMEM_TABLE_BUDGET for n in (N_ITEMS, N_USERS)}
    want_resident = chunks_u * fits[N_ITEMS] + chunks_i * fits[N_USERS]
    for g in ("pallas-copy", "pallas-take"):
        if gathers[g]["launches"]["gather_rows_resident"] != want_resident:
            raise AssertionError(f"gather={g}: {gathers[g]}, want "
                                 f"{want_resident} resident launches")
    assert_f32_matmul()
    result = {
        "nnz": NNZ, "users": N_USERS, "items": N_ITEMS, "rank": RANK,
        "iterations": ITERS, "cg_iters": [cg_u, cg_i],
        "cg_warm": [w_u, w_i, n_full], "accum": p.resolved_accum(dev),
        "gather": p.gather, "packed": p.resolved_packed(dev), "tf32": False,
        "train_s": train_s, "ratings_per_s": NNZ * ITERS / train_s,
        "sweep_s": sweep_s,
        "sweeps_ratings_per_s": NNZ * ITERS / sum(sweep_s),
        "launches": launches, "launches_expected": want,
        "profile_warm_sweep": warm, "profile_cold_sweep": cold,
        "stream_vs_hybrid": agree, "gather_vs_xla": gathers,
        "chunks": {"users": chunks_u, "items": chunks_i},
        "resident_gather_table_fits": {"users_half": fits[N_ITEMS],
                                       "items_half": fits[N_USERS]},
        "tolerance": {"users_rel_norm": USERS_RTOL_NORM,
                      "users_rel_max": USERS_RTOL_MAX,
                      "items_f64_ratio": HALF_F64_RATIO,
                      "items_f64_floor": HALF_F64_FLOOR,
                      "gather_vs_xla": "bitwise"},
    }
    emit("train_stream", **result)
    return result


# -- phase 9: the fused normal-equation kernel (K1) ----------------------------

def fused_bound(nnz: int, s_real: int, n_self: int, n_other: int,
                k: int) -> dict:
    """Least time for K1 on one half. Bytes: each real entry's index and
    value and each real slot's row id and length read once, the bf16 table
    read once, A and b written once. Operations: what the function needs,
    not what K1 does: A is symmetric, so per entry the k(k+1)/2 products of
    its upper triangle and the k of b, 2 flops each, as f32 FMAs on the
    CUDA cores, or as 3xTF32 on the tensor cores (three passes for an
    f32-accurate product; the kernel's route). The bound is the least
    over the two routes."""
    nbytes = (nnz * 8 + s_real * 8 + n_other * k * 2
              + n_self * (k * k + k) * 4)
    flops = float(k * (k + 1) + 2 * k) * nnz
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    out = {"bytes_ms": t_bytes}
    for name, t_ops in (("f32", flops / F32_FLOPS * 1e3),
                        ("3xtf32", 3 * flops / TF32_FLOPS * 1e3)):
        out[name] = {"bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops
                     else "operations", "operations_ms": t_ops}
    out["least"] = min((out["f32"], out["3xtf32"]),
                       key=lambda r: r["bound_ms"])
    return out


# K1's launches by part: the profiler's kernel names (a substring each)
FUSED_PARTS = {"k1": "normal_equations_kernel",
               "zero_fill": "zero_unwritten_kernel",
               "fold": "segment_fold_kernel"}


def _row_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest error of a row relative to that row's largest magnitude."""
    n = want.shape[0]
    g, w = got.double().reshape(n, -1), want.reshape(n, -1)
    return float(((g - w).abs().amax(1)
                  / w.abs().amax(1).clamp_min(1e-30)).max())


def _fused_case(lay, other, n: int, cs: int, p) -> dict:
    """K1 on one half of the layout: bit-identical repeats, against the
    plain version and f64, and timed beside the plain version and the
    hybrid path's block build plus K2 for the same half."""
    from pio_tpu_torch.ops import als
    from pio_tpu_torch.ops.kernels import segment_flush as sf

    src = other.to(torch.bfloat16)
    rows, idx, val, lens = lay
    s_real = int((rows < n).sum())
    nnz = int(lens.sum())

    def k1():
        return sf.normal_equations_fused(rows, idx, val, lens, src, n,
                                         p.implicit, p.alpha)

    got = k1()
    again = k1()
    torch.cuda.synchronize()
    identical = (torch.equal(got[0], again[0])
                 and torch.equal(got[1], again[1]))
    del again
    # every buffer fenced by poison: the fences hold and A, b are unchanged
    fenced = sf.normal_equations_fused_fenced(rows, idx, val, lens, src, n,
                                              p.implicit, p.alpha)
    inside = (fenced[2] and torch.equal(got[0], fenced[0])
              and torch.equal(got[1], fenced[1]))
    del fenced
    plain = sf.normal_equations_fused_reference(rows, idx, val, lens, src, n,
                                                p.implicit, p.alpha)
    max_abs_err = max(float((got[0] - plain[0]).abs().max()),
                      float((got[1] - plain[1]).abs().max()))
    want = sf.normal_equations_fused_reference(rows, idx, val, lens,
                                               src.double(), n, p.implicit,
                                               p.alpha)
    rel = {"A": _row_rel(got[0], want[0]), "b": _row_rel(got[1], want[1]),
           "A_plain": _row_rel(plain[0], want[0]),
           "b_plain": _row_rel(plain[1], want[1])}
    del got, plain, want
    if not identical:
        raise AssertionError("normal_equations_fused: two launches differ")
    if not inside:
        raise AssertionError("normal_equations_fused: the fenced launch "
                             "touched a fence or changed A or b")
    if max(rel["A"], rel["b"]) > FLUSH_RTOL:
        raise AssertionError(f"normal_equations_fused disagrees with its "
                             f"plain version in f64: {rel}")
    bound = fused_bound(nnz, s_real, n, other.shape[0], RANK)
    # each kernel's mean ms per launch over three calls (the profiler can
    # miss the first kernels of a profile); each launches once a call
    by_kernel = {name: ms / calls for name, (ms, calls) in profile_sweep(
        lambda _: [k1() for _ in range(3)], None)[
            "top_kernels_ms_calls"].items()}
    # the zero-fill apart: K1's own zero kernel; "other" is the wrapper's
    # fill of the row flags
    parts = {part: sum(ms for name, ms in by_kernel.items() if key in name)
             for part, key in FUSED_PARTS.items()}
    parts["other"] = sum(by_kernel.values()) - sum(parts.values())
    return {
        "S": rows.shape[0], "S_real": s_real, "nnz": nnz, "n_self": n,
        "k": RANK, "W": idx.shape[1], "src": "bf16",
        "bit_identical": identical, "fenced_launch_clean": inside,
        "max_abs_err": max_abs_err,
        "max_row_rel_err": rel,
        "ms": gpu_ms(k1),
        "ms_by_kernel": by_kernel,
        "ms_by_part": parts,
        "plain_ms": gpu_ms(lambda: sf.normal_equations_fused_reference(
            rows, idx, val, lens, src, n, p.implicit, p.alpha), 5, 1),
        # no single library call computes K1's function: its yardstick is
        # what it replaces on the card, hybrid's block build plus K2
        "library_ms": gpu_ms(lambda: als._normal_equations(
            lay, other, n, p.implicit, p.alpha, cs, bf16_gather=True,
            accum="hybrid", group_slots=p.group_slots), 5, 1),
        "library_is": "hybrid block build (gather, cast, weights, bmm) + K2",
        "bound_ms": bound["least"]["bound_ms"],
        "bound_by": bound["least"]["bound_by"],
        "bound_f32_fma_ms": bound["f32"]["bound_ms"],
        "bound_3xtf32_ms": bound["3xtf32"]["bound_ms"],
        "bound_3xtf32_by": bound["3xtf32"]["bound_by"],
        "bound_parts_ms": {"bytes": bound["bytes_ms"],
                           "f32_fma": bound["f32"]["operations_ms"],
                           "3xtf32": bound["3xtf32"]["operations_ms"]},
    }


def phase_fused_kernel(ratings, dev: torch.device) -> dict:
    from pio_tpu_torch.ops import als

    p = train_params()
    u, i, v = als._prep_coo(*ratings, N_USERS, N_ITEMS, p, dev)
    by_user, by_item, cs = als._build_layouts(u, i, v, N_USERS, N_ITEMS, p)
    del u, i, v
    users0, items0 = als._init_or(None, N_USERS, N_ITEMS, p, dev)
    result = {
        "users_half": _fused_case(by_user, items0, N_USERS, cs, p),
        # item 1 holds 3.6M ratings: its slots span hundreds of tiles,
        # whose partials the fold adds one after another
        "items_half": _fused_case(by_item, users0, N_ITEMS, cs, p),
        "tolerance": {"rtol_of_row_max_vs_f64": FLUSH_RTOL},
    }
    emit("fused_kernel", **result)
    return result


# -- phase 10: ALS training with the fused accumulation -------------------------

def phase_train_fused(ratings, dev: torch.device) -> dict:
    from pio_tpu_torch.ops import als

    p = train_params(accum="pallas")
    if p.resolved_accum(dev) != "pallas" or p.resolved_packed(dev):
        raise AssertionError(f"fused config resolved to "
                             f"{p.resolved_accum(dev)}, packed "
                             f"{p.resolved_packed(dev)}")
    assert_f32_matmul()
    # one launch per half per sweep: K1 takes the whole layout
    want = {"normal_equations_fused": 2 * p.iterations}

    als.als_train(*ratings, N_USERS, N_ITEMS, p, device=dev)
    torch.cuda.synchronize()
    # -- the main path: counts from 0, read right after ------------------
    reset_counts()
    t0 = time.perf_counter()
    model = als.als_train(*ratings, N_USERS, N_ITEMS, p, device=dev)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = read_counts()
    # ---------------------------------------------------------------------
    assert_f32_matmul()
    for name, f, n in (("users", model.user_factors, N_USERS),
                       ("items", model.item_factors, N_ITEMS)):
        if f.shape != (n, RANK) or not bool(torch.isfinite(f).all()):
            raise AssertionError(f"{name} factors {tuple(f.shape)} not "
                                 f"finite of shape ({n}, {RANK})")
    if launches != {**dict.fromkeys(launches, 0), **want}:
        raise AssertionError(f"launches {launches}; the layout predicts "
                             f"{want} and no other kernel")
    del model

    u, i, v = als._prep_coo(*ratings, N_USERS, N_ITEMS, p, dev)
    by_user, by_item, cs = als._build_layouts(u, i, v, N_USERS, N_ITEMS, p)
    del u, i, v
    init = als._init_or(None, N_USERS, N_ITEMS, p, dev)
    cg_u, cg_i = p.resolved_cg_iters(N_USERS), p.resolved_cg_iters(N_ITEMS)
    n_full, _, w_u, w_i = als._cg_schedule(p, cg_u, cg_i)
    sweep_s, warm, cold = time_sweeps(by_user, by_item, cs, p, init)
    agree = halves_vs_hybrid(by_user, by_item, cs, init, cg_u, cg_i, p,
                             "fused")
    assert_f32_matmul()
    result = {
        "nnz": NNZ, "users": N_USERS, "items": N_ITEMS, "rank": RANK,
        "iterations": ITERS, "cg_iters": [cg_u, cg_i],
        "cg_warm": [w_u, w_i, n_full], "accum": p.resolved_accum(dev),
        "packed": p.resolved_packed(dev), "tf32": False,
        "train_s": train_s, "ratings_per_s": NNZ * ITERS / train_s,
        "sweep_s": sweep_s,
        "sweeps_ratings_per_s": NNZ * ITERS / sum(sweep_s),
        "launches": launches, "launches_expected": want,
        "profile_warm_sweep": warm, "profile_cold_sweep": cold,
        "fused_vs_hybrid": agree,
        "tolerance": {"users_rel_norm": USERS_RTOL_NORM,
                      "users_rel_max": USERS_RTOL_MAX,
                      "items_f64_ratio": HALF_F64_RATIO,
                      "items_f64_floor": HALF_F64_FLOOR},
    }
    emit("train_fused", **result)
    return result


# -- phase 11: the train entry point, then deploy -----------------------------

def write_events(storage, app_name: str) -> tuple[int, int]:
    """Seeded rate (80 %, rating 1..5) and buy events: every user and
    every item in at least one, the rest zipf-1.2 as bench.py draws.
    Returns the events written and the (user, item) pairs among them
    (the ratings training keeps: the later event of a pair wins)."""
    from datetime import datetime, timedelta, timezone

    from pio_tpu_torch.data.dao import App
    from pio_tpu_torch.data.event import Event

    app_id = storage.get_metadata_apps().insert(App(0, app_name))
    events = storage.get_events()
    events.init(app_id)
    rng = np.random.default_rng(SEED + 3)
    u = (rng.zipf(1.2, N_EVENTS) % N_USERS).astype(np.int64)
    i = (rng.zipf(1.2, N_EVENTS) % N_ITEMS).astype(np.int64)
    u[:N_USERS] = np.arange(N_USERS)
    i[:N_ITEMS] = np.arange(N_ITEMS)
    rate = rng.random(N_EVENTS) < 0.8
    stars = rng.integers(1, 6, N_EVENTS)
    t0 = datetime(2024, 1, 1, tzinfo=timezone.utc)
    step = 50_000
    for lo in range(0, N_EVENTS, step):
        events.insert_batch([
            Event("rate" if rate[j] else "buy", "user", f"u{u[j]}", "item",
                  f"i{i[j]}",
                  {"rating": float(stars[j])} if rate[j] else {},
                  t0 + timedelta(seconds=j))
            for j in range(lo, min(N_EVENTS, lo + step))], app_id)
    return N_EVENTS, int(np.unique(u * N_ITEMS + i).size)


def split_train_verb(storage, engine, ep, dev: torch.device,
                     want_launches: int) -> dict:
    """The train verb's parts, each timed alone on the same store: the
    sqlite read plus the columnar fold (what the verb reads through),
    the row path it replaced (``find`` + ``to_interactions``, held equal
    element for element), the layout build, the sweeps and the persist."""
    from pio_tpu_torch.data.columnar import columnar_interactions
    from pio_tpu_torch.data.dao import Model
    from pio_tpu_torch.data.eventstore import (
        EventStore,
        make_value_fn,
        to_interactions,
    )
    from pio_tpu_torch.models.recommendation import RecommendationModel
    from pio_tpu_torch.ops import als
    from pio_tpu_torch.workflow.checkpoint import models_to_bytes

    ds = ep.datasource[1]
    fold = dict(value_key="rating", default_value=ds.implicit_value,
                value_event=ds.rating_event, dedup="last")
    where = dict(entity_type="user", target_entity_type="item",
                 event_names=list(ds.event_names))
    store = EventStore(storage)
    app_id, channel_id = store._resolve(ds.app_name, ds.channel_name)
    dao = storage.get_events()
    out = {}
    t0 = time.perf_counter()
    cols = dao.find_columnar(app_id, channel_id, **where)
    out["columnar_sqlite_read_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    columnar_interactions(cols, **fold)
    out["columnar_fold_s"] = time.perf_counter() - t0
    del cols
    t0 = time.perf_counter()
    inter = store.interactions(ds.app_name, ds.channel_name, **where, **fold)
    out["read_columnar_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    events = list(store.find(ds.app_name, ds.channel_name, **where))
    out["row_sqlite_read_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows = to_interactions(events, value_fn=make_value_fn(
        fold["value_key"], fold["default_value"], fold["value_event"]),
        dedup="last")
    out["row_fold_s"] = time.perf_counter() - t0
    out["read_row_s"] = out["row_sqlite_read_s"] + out["row_fold_s"]
    del events
    if (inter.users.ids() != rows.users.ids()
            or inter.items.ids() != rows.items.ids()
            or any(not np.array_equal(getattr(inter, f), getattr(rows, f))
                   or getattr(inter, f).dtype != getattr(rows, f).dtype
                   for f in ("user_idx", "item_idx", "values"))):
        raise AssertionError("the columnar read differs from find + fold")
    out["reads_equal"] = True
    del rows

    algo = engine.algorithm_classes["als"](ep.algorithms[0][1])
    p = algo._als_params()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    layouts = als.als_build_layouts(inter.user_idx, inter.item_idx,
                                    inter.values, inter.n_users,
                                    inter.n_items, p, device=dev)
    torch.cuda.synchronize()
    out["layout_s"] = time.perf_counter() - t0
    reset_counts()
    t0 = time.perf_counter()
    factors = als.als_train(inter.user_idx, inter.item_idx, inter.values,
                            inter.n_users, inter.n_items, p, device=dev,
                            layouts=layouts)
    torch.cuda.synchronize()
    out["sweeps_s"] = time.perf_counter() - t0
    launches = read_counts()
    if launches != {**dict.fromkeys(launches, 0),
                    "segment_flush": want_launches}:
        raise AssertionError(f"sweeps: launches {launches}, want "
                             f"{want_launches} of segment_flush")
    out["sweeps_launches"] = launches
    del layouts
    t0 = time.perf_counter()
    blob = models_to_bytes([RecommendationModel(factors, inter.users,
                                                inter.items)])
    storage.get_model_data_models().insert(Model("split-persist", blob))
    out["persist_s"] = time.perf_counter() - t0
    out["persist_bytes"] = len(blob)
    out["parts_s"] = sum(out[k] for k in ("read_columnar_s", "layout_s",
                                          "sweeps_s", "persist_s"))
    return out


def phase_train_entry(dev: torch.device) -> dict:
    from pio_tpu_torch.__main__ import (
        _engine_from_variant,
        _load_variant,
        main as cli_main,
    )
    from pio_tpu_torch.data.storage import Storage, set_storage
    from pio_tpu_torch.ops import als
    from pio_tpu_torch.workflow.context import create_workflow_context
    from pio_tpu_torch.workflow.serve import ServingConfig, create_query_server

    with tempfile.TemporaryDirectory(prefix="pio_chip_train_") as tmp:
        env = sqlite_env(tmp)
        storage = Storage(env=env)
        t0 = time.perf_counter()
        n_events, n_pairs = write_events(storage, "ChipSmoke")
        write_s = time.perf_counter() - t0
        engine_dir = Path(tmp) / "engine"
        engine_dir.mkdir()
        (engine_dir / "engine.json").write_text(json.dumps({
            "id": "chip-smoke-train", "engineFactory": FACTORY,
            "datasource": {"params": {"app_name": "ChipSmoke"}},
            "algorithms": [{"name": "als", "params": {
                "rank": RANK, "num_iterations": ITERS, "lambda_": 0.05,
                "alpha": 10.0, "implicit_prefs": True}}],
        }))
        variant = _load_variant(str(engine_dir))
        engine, ep = _engine_from_variant(variant, str(engine_dir))
        want_launches = expected_flush_launches(
            n_pairs, N_USERS, N_ITEMS,
            engine.algorithm_classes["als"](ep.algorithms[0][1])
            ._als_params())
        set_storage(storage)
        out = io.StringIO()
        try:
            # -- the main path: counts from 0, read right after ------------
            reset_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = cli_main(["train", "--engine-dir", str(engine_dir)])
            train_s = time.perf_counter() - t0
            train_launches = read_counts()
            # -----------------------------------------------------------------
        finally:
            set_storage(None)
        printed = out.getvalue().strip()
        print(printed, flush=True)
        if rc != 0 or train_launches != {**dict.fromkeys(train_launches, 0),
                                         "segment_flush": want_launches}:
            raise AssertionError(f"train: rc {rc}, launches {train_launches}"
                                 f", the layout predicts {want_launches}")
        iid = printed.rsplit(" ", 1)[-1]
        latest = storage.get_metadata_engine_instances().get_latest_completed(
            "chip-smoke-train", "1", "default")
        if latest is None or latest.id != iid:
            raise AssertionError(f"train printed {iid}, latest completed is "
                                 f"{latest and latest.id}")

        http, qs = create_query_server(
            engine, ep, storage,
            ServingConfig(ip="127.0.0.1", port=0,
                          engine_id="chip-smoke-train"),
            ctx=create_workflow_context(storage, device=dev))
        http.start()
        try:
            model = qs.models[0]
            picked = np.random.default_rng(SEED + 4).choice(
                len(model.users), 8, replace=False)
            latencies = []
            for r in picked:
                user = model.users.ids()[r]
                status, body, dt = _post(http.port, "/queries.json",
                                         {"user": user, "num": 10})
                assert status == 200, body
                latencies.append(dt)
                scores, idx = als.recommend_topk(model.factors, [r], 10)
                want = {"itemScores": [
                    {"item": it, "score": float(sc)} for it, sc in zip(
                        model.items.decode(idx[0].cpu().numpy()),
                        scores[0].cpu().numpy())]}
                _check_same(body, want, f"trained {user}")
            uf = model.factors.user_factors
            if uf.shape != (N_USERS, RANK) or model.factors.item_factors \
                    .shape != (N_ITEMS, RANK):
                raise AssertionError(f"trained model {tuple(uf.shape)}")
            if not bool(torch.isfinite(uf).all()):
                raise AssertionError("trained factors are not finite")
            served_iid = qs.instance.id
        finally:
            http.stop()
            qs.close()
        try:
            split = split_train_verb(storage, engine, ep, dev, want_launches)
        finally:
            storage.close()
    if served_iid != iid:
        raise AssertionError("deploy did not load the trained instance")
    result = {
        "events": n_events, "ratings": n_pairs, "write_s": write_s,
        "train_s": train_s, "instance": iid, "launches": train_launches,
        "segment_flush_launches_expected": want_launches,
        "query_ms": [1e3 * t for t in latencies], "split": split,
    }
    emit("train_entry", **result)
    return result

# -- phase 12: the flash-attention kernel (K8) ---------------------------------

def attn_pairs(b: int, sq: int, sk: int, h: int, causal: bool) -> int:
    """(q, k) pairs the masks keep."""
    return (sum(min(i + 1, sk) for i in range(sq)) if causal
            else sq * sk) * b * h


def attn_bound(b: int, sq: int, sk: int, h: int, d: int, causal: bool,
               dtype: torch.dtype) -> dict:
    """Least time for one attention forward. Operations: the (q, k) pairs
    the masks keep, 4*d flops each (q.k and p*v), at the rate of the
    kernel's route for the input type: for f32 the TF32 tensor cores at a
    third of their rate (an f32-accurate product takes three), with the
    f32 FMA route's bound beside it as ``bound_f32_fma_ms``; for bf16 the
    dense bf16 rate (the bf16 kernel's split of p into two bf16 parts is
    its design, not more work), with one exp2 a pair on the SFUs beside
    it as ``bound_exp_ms``. Bytes: q, k, v read once, o written once."""
    pairs = attn_pairs(b, sq, sk, h, causal)
    flops = 4.0 * d * pairs
    esize = torch.empty((), dtype=dtype).element_size()
    nbytes = (2 * b * sq * h * d + 2 * b * sk * h * d) * esize
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    rate = TF32_FLOPS / 3 if dtype == torch.float32 else BF16_FLOPS
    t_ops = flops / rate * 1e3
    out = ({"bound_ms": t_bytes, "bound_by": "bytes"} if t_bytes >= t_ops
           else {"bound_ms": t_ops, "bound_by": "operations"})
    if dtype == torch.float32:
        out["bound_f32_fma_ms"] = max(flops / F32_FLOPS * 1e3, t_bytes)
    else:
        out["bound_exp_ms"] = pairs / SFU_EXPS_PER_S * 1e3
    return out


def _qkv_views(b: int, s: int, h: int, d: int, dtype: torch.dtype,
               dev: torch.device, seed: int):
    """q, k, v as the transformer block hands them to attention: views of
    one (B, S, 3, H, D) projection."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    qkv = torch.randn((b, s, 3, h, d), generator=g, device=dev).to(dtype)
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


def _attn_want(q, k, v, causal: bool, scale=None):
    """The plain version K8 is held to: f64 for f32 inputs, f32 for
    bf16 (on the same bf16 inputs), as f64."""
    from pio_tpu_torch.ops.kernels import flash_attention as k8

    ct = torch.float64 if q.dtype == torch.float32 else torch.float32
    return k8.flash_attention_reference(q.to(ct), k.to(ct), v.to(ct), causal,
                                        scale).double()


def _attn_tol(want, dtype: torch.dtype):
    """The stated tolerance on each output: f32 ATTN_F32_ATOL; bf16 2^-8
    of the value + ATTN_BF16_ATOL."""
    if dtype == torch.float32:
        return torch.full_like(want, ATTN_F32_ATOL)
    return ATTN_BF16_RTOL * want.abs() + ATTN_BF16_ATOL


def _attn_err(got, q, k, v, causal: bool, scale=None, want=None) -> float:
    """Max abs error of K8's output against the plain version, raising
    past the stated tolerance."""
    if want is None:
        want = _attn_want(q, k, v, causal, scale)
    tol = _attn_tol(want, got.dtype)
    err = (got.double() - want).abs()
    if not bool(torch.isfinite(got).all()) or bool((err > tol).any()):
        raise AssertionError(
            f"flash_attention {tuple(q.shape)} {q.dtype} causal={causal}: "
            f"max abs err {float(err.max())} past the tolerance")
    return float(err.max())


def _twice(q, k, v, causal: bool, scale=None):
    """K8's output, and whether a second launch gave the same bits."""
    from pio_tpu_torch.ops.kernels import flash_attention as k8

    got = k8.flash_attention(q, k, v, causal=causal, scale=scale)
    again = k8.flash_attention(q, k, v, causal=causal, scale=scale)
    torch.cuda.synchronize()
    return got, torch.equal(got, again)


def phase_attention_kernel(dev: torch.device) -> dict:
    from pio_tpu_torch.ops.kernels import flash_attention as k8

    cases = []
    for i, (b, s, h, d, dtype, reps) in enumerate(ATTN_CASES):
        q, k, v = _qkv_views(b, s, h, d, dtype, dev, SEED + 10 + i)
        got, identical = _twice(q, k, v, True)
        want = _attn_want(q, k, v, True)
        err = _attn_err(got, q, k, v, True, want=want)
        tol = _attn_tol(want, dtype)
        tol_ratio = float(((got.double() - want).abs() / tol).max())
        del got
        timing = {} if reps is None else {"reps": reps, "inner": 1}
        # SDPA takes (B, H, S, D): the same tensors, transposed views
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        lib_dev = (lib.transpose(1, 2).double() - want).abs()
        lib_err = float(lib_dev.max())
        lib_outside = float((lib_dev > tol).double().mean())
        del lib, lib_dev, want, tol
        pairs = attn_pairs(b, s, s, h, True)
        ms = gpu_ms(lambda: k8.flash_attention(q, k, v, causal=True),
                    **timing)
        cases.append({
            "B": b, "S": s, "H": h, "D": d, "dtype": str(dtype)[6:],
            "causal": True, "path": k8.KERNELS[dtype], "max_abs_err": err,
            # the largest error as a share of its tolerance
            "tol_ratio": tol_ratio,
            "bit_identical_launches": identical,
            "ms": ms, "tflops_4d": 4.0 * d * pairs / (ms * 1e-3) / 1e12,
            "plain_ms": gpu_ms(lambda: k8.flash_attention_reference(
                q, k, v, True), **({"reps": 1, "inner": 1}
                                   if s > 4096 else timing)),
            "library_ms": gpu_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True), **timing),
            # SDPA's error against the same plain version, and the share
            # of its outputs past K8's tolerance: recorded, not checked
            "library_max_abs_err": lib_err,
            "library_outside_tol": lib_outside,
            **attn_bound(b, s, s, h, d, True, dtype),
        })
        if not identical:
            raise AssertionError(f"two K8 launches differ at {cases[-1]}")
        emit("attention_kernel", **cases[-1])
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()

    # the masks' corners in both types: no keys at all (every row fully
    # masked: zeros), Sq != Sk under each mask (top-left causal alignment;
    # ragged Sk 77 and 300, Sq 300 over Sk 77), and the block's strided
    # qkv views with an explicit scale at each D the kernels take
    edges = {}
    for dtype in (torch.float32, torch.bfloat16):
        pre = "" if dtype == torch.float32 else "bf16_"
        path = {"path": k8.KERNELS[dtype], "bit_identical_launches": True}
        q, k, v = _qkv_views(2, 70, 2, 64, dtype, dev, SEED + 20)
        empty, identical = _twice(q, k[:, :0], v[:, :0], True)
        if not bool((empty == 0).all()) or not identical:
            raise AssertionError(f"{dtype} rows without keys are not zeros")
        edges[pre + "no_keys"] = {"Sq": 70, "Sk": 0, "all_zero": True, **path}
        for sq, sk, causal in ((200, 77, True), (50, 300, False),
                               (200, 77, False), (50, 300, True),
                               (300, 77, True), (300, 77, False)):
            q, _, _ = _qkv_views(2, sq, 2, 64, dtype, dev, SEED + sq)
            _, k, v = _qkv_views(2, sk, 2, 64, dtype, dev, SEED + sk + 1)
            got, identical = _twice(q, k, v, causal)
            if not identical:
                raise AssertionError(f"two K8 launches differ at {dtype} "
                                     f"Sq {sq} Sk {sk}")
            edges[f"{pre}Sq{sq}_Sk{sk}_{'causal' if causal else 'full'}"] = {
                "max_abs_err": _attn_err(got, q, k, v, causal), **path}
        for d in (32, 64, 128):
            q, k, v = _qkv_views(3, 300, 4, d, dtype, dev, SEED + d)
            got, identical = _twice(q, k, v, True, 0.2)
            if not identical:
                raise AssertionError(f"two K8 launches differ at {dtype} D "
                                     f"{d} scale 0.2")
            edges[f"{pre}strided_D{d}_scale0.2"] = {
                "max_abs_err": _attn_err(got, q, k, v, True, 0.2), **path}
    emit("attention_kernel_edges", cases=edges,
         tolerance={"f32_atol_vs_f64": ATTN_F32_ATOL,
                    "bf16_rtol_vs_f32": ATTN_BF16_RTOL,
                    "bf16_atol_vs_f32": ATTN_BF16_ATOL})
    return {"cases": cases, "edges": edges}


# -- phase 13: sequence training at eval/neural_throughput.py's cell ------------

def _ids(prefix: str, n: int):
    from pio_tpu_torch.data.bimap import EntityIdIndex

    return EntityIdIndex([f"{prefix}{j}" for j in range(n)])


def phase_sequence_train(dev: torch.device) -> dict:
    from pio_tpu_torch.models import sequence as seq

    cell = SEQ_TRAIN_DATA
    rng = np.random.default_rng(SEED)
    seqs = (rng.zipf(1.3, (cell["n_seqs"], cell["max_len"]))
            % (cell["n_items"] - 1) + 1).astype(np.int32)
    data = seq.SequenceData(seqs, _ids("u", cell["n_seqs"]),
                            _ids("i", cell["n_items"]))
    tokens = SEQ_TRAIN["steps"] * SEQ_TRAIN["batch_size"] * (
        SEQ_TRAIN["max_len"] - 1)
    runs = {}
    for attention in ("flash", "auto"):
        p = seq.SequenceParams(**SEQ_TRAIN, attention=attention)
        # three steps first: cuBLAS handles, the allocator, K8's build
        seq.train_sequence_model(data, replace(p, steps=3), device=dev)
        torch.cuda.synchronize()
        # -- the main path: counts from 0, read right after ----------------
        reset_counts()
        t0 = time.perf_counter()
        _, _, loss = seq.train_sequence_model(data, p, device=dev)
        wall = time.perf_counter() - t0      # float(loss) synchronized
        launches = read_counts()
        # ---------------------------------------------------------------------
        # device time of three steps (and the model's set-up) by kernel
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            seq.train_sequence_model(data, replace(p, steps=3), device=dev)
            torch.cuda.synchronize()
        device_ms, top = device_ms_by_kernel(prof, 3)
        runs[attention] = {"loss": loss, "train_s": wall,
                           "tokens_per_s": tokens / wall,
                           "ms_per_step": 1e3 * wall / p.steps,
                           "device_ms_per_step": device_ms,
                           "top_kernels_ms_per_step": top,
                           "launches": launches}
        torch.cuda.empty_cache()
    want = {"flash": SEQ_TRAIN["num_layers"] * SEQ_TRAIN["steps"], "auto": 0}
    for attention, run in runs.items():
        n = {**dict.fromkeys(run["launches"], 0),
             "flash_attention": want[attention]}
        if run["launches"] != n or not np.isfinite(run["loss"]):
            raise AssertionError(f"{attention}: launches {run['launches']} "
                                 f"(want {want[attention]} of K8), loss "
                                 f"{run['loss']}")
    rel = abs(runs["flash"]["loss"] - runs["auto"]["loss"]) / abs(
        runs["auto"]["loss"])
    result = {**cell, **SEQ_TRAIN, "tokens": tokens, "runs": runs,
              "loss_rel_diff": rel, "loss_rtol": SEQ_LOSS_RTOL}
    emit("sequence_train", **result)
    if rel > SEQ_LOSS_RTOL:
        raise AssertionError(f"flash and auto losses differ by {rel}")
    return result


# -- phase 14: the sequence template end to end ---------------------------------

def write_sequence_events(storage, app_name: str, t0) -> int:
    """Seeded view (80 %) and buy events: each of SEQ_USERS users has 1 to
    SEQ_MAX_EVENTS time-ordered events over SEQ_ITEMS items (zipf 1.3).
    Returns the number written."""
    from datetime import timedelta

    from pio_tpu_torch.data.dao import App
    from pio_tpu_torch.data.event import Event

    app_id = storage.get_metadata_apps().insert(App(0, app_name))
    events = storage.get_events()
    events.init(app_id)
    rng = np.random.default_rng(SEED + 5)
    lens = rng.integers(1, SEQ_MAX_EVENTS + 1, SEQ_USERS)
    batch = []
    for u, n in enumerate(lens):
        items = rng.zipf(1.3, n) % SEQ_ITEMS
        views = rng.random(n) < 0.8
        batch += [Event("view" if views[t] else "buy", "user", f"u{u}",
                        "item", f"i{items[t]}", {},
                        t0 + timedelta(seconds=int(u) * 100 + t))
                  for t in range(n)]
    for lo in range(0, len(batch), 50_000):
        events.insert_batch(batch[lo:lo + 50_000], app_id)
    return len(batch)


def phase_sequence_entry(store, dev: torch.device) -> dict:
    from datetime import timedelta
    from functools import partial

    from pio_tpu_torch.__main__ import (
        _engine_from_variant,
        _load_variant,
        main as cli_main,
    )
    from pio_tpu_torch.data.event import Event
    from pio_tpu_torch.data.storage import set_storage
    from pio_tpu_torch.ops.attention import (
        attention_reference,
        flash_attention,
    )
    from pio_tpu_torch.workflow.context import create_workflow_context
    from pio_tpu_torch.workflow.serve import ServingConfig, create_query_server

    t_events = store.t_events
    tmp, storage = store.tmp, store.storage
    t0 = time.perf_counter()
    n_events = write_sequence_events(storage, SEQ_ALGO["app_name"],
                                     t_events)
    write_s = time.perf_counter() - t0
    engine_dir = Path(tmp) / "engine"
    engine_dir.mkdir()
    (engine_dir / "engine.json").write_text(json.dumps({
        "id": "chip-smoke-seq", "engineFactory": SEQ_FACTORY,
        "datasource": {"params": {"app_name": SEQ_ALGO["app_name"],
                                  "event_names": ["view", "buy"],
                                  "max_len": SEQ_ALGO["max_len"]}},
        "algorithms": [{"name": "sasrec", "params": SEQ_ALGO}],
    }))
    variant = _load_variant(str(engine_dir))
    engine, ep = _engine_from_variant(variant, str(engine_dir))
    set_storage(storage)
    out = io.StringIO()
    try:
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli_main(["train", "--engine-dir", str(engine_dir),
                           "--checkpoint-root", str(Path(tmp) / "ckpt")])
        train_s = time.perf_counter() - t0
        train_launches = read_counts()
    finally:
        set_storage(None)
    printed = out.getvalue().strip()
    print(printed, flush=True)
    # attention "auto" at max_len 64 trains with the plain attention
    if rc != 0 or any(train_launches.values()):
        raise AssertionError(f"train: rc {rc}, launches {train_launches}")
    iid = printed.rsplit(" ", 1)[-1]

    http, qs = create_query_server(
        engine, ep, storage,
        ServingConfig(ip="127.0.0.1", port=0,
                      engine_id="chip-smoke-seq"),
        ctx=create_workflow_context(storage, device=dev))
    http.start()
    try:
        port = http.port
        model = qs.models[0]
        algo = qs.algorithms[0]
        users = model.users.ids()
        picked = np.random.default_rng(SEED + 6).choice(
            len(users), N_PLAIN_QUERIES + BATCH_QUERIES, replace=False)
        status, warm, first_s = _post(port, "/queries.json",
                                      {"user": users[picked[0]],
                                       "num": 10})
        assert status == 200, warm
        plain_q = [{"user": users[i], "num": 10}
                   for i in picked[:N_PLAIN_QUERIES - 4]]
        plain_q += [{"user": users[i], "num": 10, "blackList": [
            s["item"] for s in algo.predict(
                model, {"user": users[i], "num": 3})["itemScores"]]}
            for i in picked[N_PLAIN_QUERIES - 4:N_PLAIN_QUERIES - 1]]
        plain_q.append({"user": "no-such-user", "num": 10})
        batch_q = [{"user": users[i], "num": 10}
                   for i in picked[N_PLAIN_QUERIES:]]
        # a user unseen in training, with events written after it
        storage.get_events().insert_batch(
            [Event("view", "user", "fresh-user", "item", f"i{j}", {},
                   t_events + timedelta(days=30, seconds=n))
             for n, j in enumerate((5, 1, 9, 2))],
            storage.get_metadata_apps().get_by_name(
                SEQ_ALGO["app_name"]).id)
        live_q = {"user": "fresh-user", "num": 10}

        # -- the main path: counts from 0, read right after --------
        reset_counts()
        answers, latencies = [], []
        for q in plain_q:
            status, body, dt = _post(port, "/queries.json", q)
            assert status == 200, body
            answers.append(body)
            latencies.append(dt)
        status, batch_body, batch_s = _post(port, "/batch/queries.json",
                                            batch_q)
        assert status == 200, batch_body
        status, live_body, _ = _post(port, "/queries.json", live_q)
        assert status == 200, live_body
        launches = read_counts()
        # ------------------------------------------------------------

        # the same queries in process, on the same model
        for q, got in zip(plain_q, answers):
            _check_same(got, algo.predict(model, q), q["user"])
        for i, (got, want) in enumerate(zip(
                batch_body, algo.batch_predict(model, batch_q))):
            _check_same(got, want, f"batch[{i}]")
        _check_same(live_body, algo.predict(model, live_q), "live")
        live_row = algo.history_row(model, live_q)
        # K8 against the plain attention on the batch's histories
        rows = np.stack([algo.history_row(model, q) for q in batch_q])
        enc = algo._encoder(model)
        inp = torch.as_tensor(rows[:, 1:], dtype=torch.long, device=dev)
        with torch.inference_mode():
            s_k8 = enc(inp, partial(flash_attention, causal=True))[1]
            s_plain = enc(inp, partial(attention_reference,
                                       causal=True))[1]
        score_err = float((s_k8 - s_plain).abs().max())
        score_max = float(s_plain.abs().max())
        # in process: a query's whole time, its device time, and the
        # live-history read alone
        inproc = profile_queries(qs, plain_q[:20])
        t0 = time.perf_counter()
        for q in plain_q[:20]:
            algo.history_row(model, q)
        inproc["history_read_ms_per_query"] = 1e3 * (
            time.perf_counter() - t0) / 20
        served_iid = qs.instance.id
    finally:
        http.stop()
        qs.close()
    if served_iid != iid:
        raise AssertionError("deploy did not load the trained instance")
    ghost = answers[-1]
    scored = len(plain_q) - 1 + 1 + 1       # known users, the batch, live
    if ghost != {"itemScores": []}:
        raise AssertionError("unknown user got items")
    for q, got in zip(plain_q[:-1], answers[:-1]):
        items = [s["item"] for s in got["itemScores"]]
        if len(items) != q["num"] or set(items) & set(q.get("blackList",
                                                             ())):
            raise AssertionError(f"{q}: {items}")
    fresh = [model.items.decode([i - 1])[0] for i in live_row if i]
    if fresh != ["i5", "i1", "i9", "i2"] or not live_body["itemScores"]:
        raise AssertionError(f"live history {fresh}: {live_body}")
    if score_err > SEQ_SCORE_RTOL * score_max:
        raise AssertionError(f"K8 scores {score_err} from the plain "
                             f"attention's (max {score_max})")
    want = {**dict.fromkeys(launches, 0),
            "flash_attention": SEQ_ALGO["num_layers"] * scored}
    if launches != want:
        raise AssertionError(f"serving launches {launches}, want {want}")
    lat_ms = sorted(1e3 * t for t in latencies)
    result = {
        "users": len(model.users), "items": len(model.items),
        "events": n_events, "write_s": write_s, "train_s": train_s,
        "instance": iid, "train_launches": train_launches,
        "launches": launches, "scored_batches": scored,
        "queries": len(plain_q) + 1, "batch": len(batch_q),
        "p50_ms": statistics.median(lat_ms),
        "p90_ms": lat_ms[int(0.9 * (len(lat_ms) - 1))],
        "max_ms": lat_ms[-1], "batch_ms": 1e3 * batch_s,
        "first_query_s": first_s,
        "score_max_abs_err_vs_plain_attention": score_err,
        "score_max_abs": score_max, "score_rtol": SEQ_SCORE_RTOL,
        "in_process": inproc,
    }
    emit("sequence_entry", **result)
    return result


# -- phase 15: the supervised train verb, killed and resumed -----------------

REPO_ROOT = Path(__file__).resolve().parent


@contextlib.contextmanager
def sqlite_store(prefix: str):
    """A sqlite store in a temporary directory, shared by the phases
    that run inside the block."""
    from datetime import datetime, timezone

    from pio_tpu_torch.data.storage import Storage

    with tempfile.TemporaryDirectory(prefix=prefix) as tmp:
        env = sqlite_env(tmp)
        storage = Storage(env=env)
        try:
            yield types.SimpleNamespace(
                tmp=Path(tmp), env=env, storage=storage,
                t_events=datetime(2024, 1, 1, tzinfo=timezone.utc))
        finally:
            storage.close()


class _Records(logging.Handler):
    """The port's log records of a run, kept to read what they carry."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.records: list[logging.LogRecord] = []

    def emit(self, record):
        self.records.append(record)

    def take(self, prefix: str) -> list[tuple]:
        got = [r.args for r in self.records if r.msg.startswith(prefix)]
        self.records = [r for r in self.records
                        if not r.msg.startswith(prefix)]
        return got


def phase_train_resume(store, dev: torch.device) -> dict:
    """The sequence template through ``python -m pio_tpu_torch train``
    three times on ``sequence_entry``'s events: uninterrupted (in
    process); killed by a ``train.step`` chaos fault in a subprocess,
    then ``--resume ID`` (in process); SIGTERM'd in a subprocess (exit
    75), then ``--auto-resume`` (in process). The resumed models must be
    the uninterrupted one bit for bit, with the same final loss; K8 runs
    in every training forward; the resumed instance is deployed and
    answers with K8."""
    from pio_tpu_torch.__main__ import (
        _engine_from_variant,
        _load_variant,
        main as cli_main,
    )
    from pio_tpu_torch.data.dao import EngineInstance
    from pio_tpu_torch.data.storage import set_storage
    from pio_tpu_torch.utils.time import utcnow
    from pio_tpu_torch.workflow.checkpoint import models_from_bytes
    from pio_tpu_torch.workflow.context import create_workflow_context
    from pio_tpu_torch.workflow.lifecycle import (
        EXIT_PREEMPTED,
        RESUMABLE_STATUSES,
        TrainLifecycle,
        find_resumable,
        has_checkpoint,
    )
    from pio_tpu_torch.workflow.serve import ServingConfig, create_query_server

    storage, tmp = store.storage, store.tmp
    engine_id, steps = "chip-smoke-resume", SEQ_RESUME["steps"]
    every, layers = SEQ_RESUME["checkpoint_every"], SEQ_RESUME["num_layers"]
    engine_dir = tmp / "resume_engine"
    engine_dir.mkdir()
    (engine_dir / "engine.json").write_text(json.dumps({
        "id": engine_id, "engineFactory": SEQ_FACTORY,
        "datasource": {"params": {"app_name": SEQ_ALGO["app_name"],
                                  "event_names": ["view", "buy"],
                                  "max_len": SEQ_ALGO["max_len"]}},
        "algorithms": [{"name": "sasrec", "params": SEQ_RESUME}],
    }))
    ckpt_root = tmp / "resume_ckpt"
    argv = ["train", "--engine-dir", str(engine_dir), "--checkpoint-root",
            str(ckpt_root)]
    instances = storage.get_metadata_engine_instances()
    records = _Records()
    port_log = logging.getLogger("pio_tpu_torch")
    port_log.addHandler(records)
    port_log.setLevel(logging.INFO)

    def in_process(*extra) -> dict:
        """One train verb in this process, the counts from 0."""
        out = io.StringIO()
        set_storage(storage)
        try:
            reset_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = cli_main(argv + list(extra))
            wall = time.perf_counter() - t0
            launches = read_counts()
        finally:
            set_storage(None)
        printed = out.getvalue().strip()
        print(printed, flush=True)
        if rc != 0:
            raise AssertionError(f"train {extra}: rc {rc}: {printed}")
        [(_, loss)] = records.take("sequence model trained")
        saves = records.take("step checkpoint")
        return {"instance": printed.rsplit(" ", 1)[-1], "train_s": wall,
                "launches": launches, "final_loss": loss,
                "saves": [{"step": st, "ms": ms, "bytes": n}
                          for st, ms, n in saves]}

    def subprocess_run(env_extra: dict):
        return subprocess.Popen(
            [sys.executable, "-m", "pio_tpu_torch", *argv], cwd=REPO_ROOT,
            env={**os.environ, **store.env, **env_extra},
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def new_instance(known: set) -> EngineInstance:
        [inst] = [i for i in instances.get_all()
                  if i.engine_id == engine_id and i.id not in known]
        return inst

    def k8_only(launches: dict, n: int) -> None:
        want = {**dict.fromkeys(launches, 0), "flash_attention": n}
        if launches != want:
            raise AssertionError(f"launches {launches}, want {want}")

    runs = {}
    try:
        # 1. uninterrupted
        runs["uninterrupted"] = whole = in_process()
        k8_only(whole["launches"], layers * steps)
        known = {whole["instance"]}

        # 2. a chaos fault at step RESUME_KILL_STEP, then --resume ID
        proc = subprocess_run(
            {"PIO_TPU_CHAOS": f"train.step.{RESUME_KILL_STEP}:error=1"})
        out, err = proc.communicate(timeout=SUBPROCESS_TIMEOUT_S)
        killed = new_instance(known)
        ckpt_dir = killed.progress.get("checkpoint_dir", "")
        saved = (sorted(int(n) for n in os.listdir(ckpt_dir) if n.isdigit())
                 if has_checkpoint(ckpt_dir) else [])
        # the fault fires before step RESUME_KILL_STEP's own save
        want_step = (RESUME_KILL_STEP - 1) // every * every
        if (proc.returncode in (0, EXIT_PREEMPTED)
                or "ChaosError" not in err
                or killed.status not in RESUMABLE_STATUSES
                or killed.status != "FAILED"
                or not saved or saved[-1] != want_step):
            raise AssertionError(
                f"chaos kill: rc {proc.returncode}, {killed.status}, steps "
                f"saved {saved}: {err[-2000:]}")
        resumed = in_process("--resume", killed.id)
        k8_only(resumed["launches"], layers * (steps - saved[-1] - 1))
        if resumed["instance"] != killed.id or \
                instances.get(killed.id).status != "COMPLETED":
            raise AssertionError(f"--resume {killed.id}: {resumed}")
        runs["chaos_then_resume"] = {
            **resumed, "killed_rc": proc.returncode,
            "killed_status": killed.status, "resumed_from_step": saved[-1]}
        known.add(killed.id)

        # 3. SIGTERM mid-run (exit 75), then --auto-resume
        proc = subprocess_run({"PIO_TPU_CHAOS": (
            f"train.step.{RESUME_STALL_STEP}:slow=1,"
            f"slow_s={RESUME_STALL_S}")})
        t0 = time.perf_counter()
        try:
            while proc.poll() is None and \
                    time.perf_counter() - t0 < SUBPROCESS_TIMEOUT_S:
                dirs = [ckpt_root / n for n in os.listdir(ckpt_root)
                        if n not in known]
                if any((d / str(RESUME_SIGNAL_AFTER)).exists()
                       for d in dirs):
                    break
                time.sleep(0.01)
            running = proc.poll() is None
            if running:
                proc.send_signal(signal.SIGTERM)
            out, err = proc.communicate(timeout=SUBPROCESS_TIMEOUT_S)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        stopped = new_instance(known)
        at = stopped.progress.get("preempted_at_step")
        if (not running or proc.returncode != EXIT_PREEMPTED
                or stopped.status != "INTERRUPTED"
                or not stopped.progress.get("resumable")
                or not RESUME_SIGNAL_AFTER <= (at or -1) <= RESUME_STALL_STEP
                or find_resumable(instances, engine_id, "1",
                                  "default").id != stopped.id):
            raise AssertionError(
                f"SIGTERM: running {running}, rc {proc.returncode}, "
                f"{stopped.status} at {at}: {out[-1000:]} {err[-2000:]}")
        auto = in_process("--auto-resume")
        k8_only(auto["launches"], layers * (steps - at - 1))
        if auto["instance"] != stopped.id or \
                instances.get(stopped.id).status != "COMPLETED":
            raise AssertionError(f"--auto-resume: {auto}")
        runs["sigterm_then_auto_resume"] = {
            **auto, "sigterm_rc": proc.returncode, "preempted_at_step": at,
            "resume_hint_printed": "resume with" in out}
    finally:
        port_log.removeHandler(records)

    # the resumed models against the uninterrupted one, bit for bit
    def params(iid):
        [m] = models_from_bytes(
            storage.get_model_data_models().get(iid).models)
        return m.params

    want = params(whole["instance"])
    for name in ("chaos_then_resume", "sigterm_then_auto_resume"):
        got = params(runs[name]["instance"])
        same = set(got) == set(want) and all(
            got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])
            for k in want)
        runs[name]["params_bit_equal"] = same
        runs[name]["final_loss_equal"] = (
            runs[name]["final_loss"] == whole["final_loss"])
        if not same or not runs[name]["final_loss_equal"]:
            raise AssertionError(
                f"{name}: params equal {same}, final loss "
                f"{runs[name]['final_loss']} vs {whole['final_loss']}")

    # deploy the --resume'd instance; K8 in every scored batch
    variant = _load_variant(str(engine_dir))
    engine, ep = _engine_from_variant(variant, str(engine_dir))
    http, qs = create_query_server(
        engine, ep, storage,
        ServingConfig(ip="127.0.0.1", port=0, engine_id=engine_id),
        ctx=create_workflow_context(storage, device=dev),
        instance_id=runs["chaos_then_resume"]["instance"])
    http.start()
    try:
        model, algo = qs.models[0], qs.algorithms[0]
        users = model.users.ids()
        picked = np.random.default_rng(SEED + 7).choice(
            len(users), 2 * RESUME_QUERIES, replace=False)
        plain_q = [{"user": users[i], "num": 10}
                   for i in picked[:RESUME_QUERIES]]
        batch_q = [{"user": users[i], "num": 10}
                   for i in picked[RESUME_QUERIES:]]
        # -- the main path: counts from 0, read right after --------------
        reset_counts()
        answers = []
        for q in plain_q:
            status, body, _ = _post(http.port, "/queries.json", q)
            assert status == 200, body
            answers.append(body)
        status, batch_body, _ = _post(http.port, "/batch/queries.json",
                                      batch_q)
        assert status == 200, batch_body
        serve_launches = read_counts()
        # ----------------------------------------------------------------
        for q, got in zip(plain_q, answers):
            _check_same(got, algo.predict(model, q), q["user"])
            if len(got["itemScores"]) != q["num"]:
                raise AssertionError(f"{q}: {got}")
        for i, (got, want_b) in enumerate(zip(
                batch_body, algo.batch_predict(model, batch_q))):
            _check_same(got, want_b, f"batch[{i}]")
        served = qs.instance.id
    finally:
        http.stop()
        qs.close()
    if served != runs["chaos_then_resume"]["instance"]:
        raise AssertionError("deploy did not load the resumed instance")
    k8_only(serve_launches, layers * (RESUME_QUERIES + 1))

    # the heartbeat's cost: a throttled call (most steps) and a store write
    t = utcnow()
    iid = instances.insert(EngineInstance(
        id="", status="TRAINING", start_time=t, end_time=t,
        engine_id="heartbeat-probe", engine_version="1",
        engine_variant="default", engine_factory=""))
    life = TrainLifecycle(instances, instances.get(iid),
                          checkpoint_dir=str(ckpt_root / iid))
    life.heartbeat(0, force=True)
    n_calls = 2000
    t0 = time.perf_counter()
    wrote = sum(life.heartbeat(st, n_calls) for st in range(1, n_calls + 1))
    throttled_us = 1e6 * (time.perf_counter() - t0) / n_calls
    t0 = time.perf_counter()
    for st in range(50):
        life.heartbeat(st, force=True)
    write_ms = 1e3 * (time.perf_counter() - t0) / 50
    step_s = whole["train_s"] / steps
    # a run writes at most once every 10 steps and every 2 s
    writes_per_step = min(1 / 10, step_s / 2.0)
    save_ms = [sv["ms"] for sv in whole["saves"]]
    result = {
        "widths": SEQ_RESUME, "runs": runs,
        "serve_launches": serve_launches,
        "scored_batches": RESUME_QUERIES + 1,
        "checkpoint_save_ms": save_ms,
        "checkpoint_save_ms_median": statistics.median(save_ms),
        "checkpoint_bytes": whole["saves"][0]["bytes"],
        "checkpoint_ms_per_step": sum(save_ms) / steps,
        "heartbeat_throttled_us": throttled_us,
        "heartbeat_writes_in_throttled_calls": wrote,
        "heartbeat_write_ms": write_ms,
        "heartbeat_ms_per_step": throttled_us / 1e3
        + writes_per_step * write_ms,
        "ms_per_step_uninterrupted": 1e3 * step_s,
    }
    emit("train_resume", **result)
    return result


def _kernel_entry(name: str, source: str, replaces: str, launches: int,
                  case: dict, **extra) -> dict:
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": case["max_abs_err"], "ms": case["ms"],
            "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
            "bound_by": case["bound_by"], "library_ms": case["library_ms"],
            **extra, "ok": True}


def main() -> int:
    device = phase_device()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    wall = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.empty_cache()
        wall[name] = time.perf_counter() - t0
        return out

    timed("build", phase_build)
    users, items = make_factors()
    scan = timed("scan_kernel", phase_scan_kernel, users, items, dev)
    serve = timed("serve", phase_serve, users, items, dev)
    foldin = timed("foldin", phase_foldin, users, items, dev)
    del users, items
    ratings = synth_ratings()
    flush = timed("segment_flush_kernel", phase_flush_kernel, ratings, dev)
    train = timed("train", phase_train, ratings, dev)
    stream = timed("stream_kernels", phase_stream_kernels, ratings, dev)
    tstream = timed("train_stream", phase_train_stream, ratings, dev)
    fused = timed("fused_kernel", phase_fused_kernel, ratings, dev)
    tfused = timed("train_fused", phase_train_fused, ratings, dev)
    validated = timed("train_validated", phase_train_validated, ratings, dev)
    del ratings
    entry = timed("train_entry", phase_train_entry, dev)
    attn = timed("attention_kernel", phase_attention_kernel, dev)
    timed("sequence_train", phase_sequence_train, dev)
    with sqlite_store("pio_chip_seq_") as store:
        seq_entry = timed("sequence_entry", phase_sequence_entry, store, dev)
        resume = timed("train_resume", phase_train_resume, store, dev)
    emit("wall", seconds=wall, total_s=sum(wall.values()))

    cases = scan["cases"]
    # headline: the shape a single /queries.json gives the kernel
    head = next(c for c in cases
                if c["dtype"] == RETRIEVAL["dtype"] and c["B"] == 1)
    src = "pio_tpu_torch/ops/kernels/"
    users_half = stream["gathers"]["users_half"]
    flush3 = stream["segment_flush_stream"]
    stream_launches = tstream["launches"]
    resident = {g: tstream["gather_vs_xla"][g]["launches"][
        "gather_rows_resident"] for g in ("pallas-copy", "pallas-take")}
    kernels = [
        _kernel_entry(
            "quantized_scan", src + "quantized_scan.cu",
            "pio_tpu/ops/retrieval.py:550",
            serve["launches"]["quantized_scan"], head,
            launches_foldin=foldin["launches"]["quantized_scan"],
            empty_launch_ms=head["empty_launch_ms"],
            shape={k: head[k] for k in ("dtype", "B", "P", "C", "Lmax",
                                        "k")},
            cases=cases),
        _kernel_entry(
            # the main path: python -m pio_tpu_torch train
            "segment_flush", src + "segment_flush.cu",
            "pio_tpu/ops/als_pallas.py:369",
            entry["launches"]["segment_flush"], flush,
            launches_als_train=train["segment_flush_launches"],
            launches_als_train_expected=train[
                "segment_flush_launches_expected"],
            launches_train_validated=validated["launches"]["segment_flush"],
            launches_train_validated_expected=validated[
                "segment_flush_launches_expected"],
            launches_train_entry_sweeps=entry["split"][
                "sweeps_launches"]["segment_flush"],
            shape={k: flush[k] for k in ("S", "S_real", "n_self", "k")}),
        _kernel_entry(
            # the main path of this and the next two: als_train in the
            # streaming configuration
            "segment_flush_stream", src + "segment_flush.cu",
            "pio_tpu/ops/als_pallas.py:369",
            stream_launches["segment_flush_stream"], flush3,
            bit_identical_to_segment_flush=flush3["bit_identical_to_k2"],
            shape={k: flush3[k] for k in ("S", "S_real", "n_self", "k")}),
        _kernel_entry(
            "gather_rows_stream", src + "gather_rows.cu",
            "pio_tpu/ops/als_pallas.py:865",
            stream_launches["gather_rows_stream"],
            users_half["cases"]["stream"],
            shape={k: users_half[k] for k in ("M", "N", "k", "dtype")}),
        _kernel_entry(
            "packed_matvec", src + "packed_matvec.cu",
            "pio_tpu/ops/als_pallas.py:953",
            stream_launches["packed_matvec"], stream["packed_matvec"],
            shape={"n": N_USERS, "k": RANK}),
        _kernel_entry(
            # the main path: one sweep each with gather="pallas-copy" and
            # "pallas-take"; the headline numbers are the copy variant's
            "gather_rows_resident", src + "gather_rows.cu",
            "pio_tpu/ops/als_pallas.py:731", sum(resident.values()),
            users_half["cases"]["copy"],
            shape={k: users_half[k] for k in ("M", "N", "k", "dtype")},
            variants={v: {**users_half["cases"][v],
                          "launches": resident[f"pallas-{v}"]}
                      for v in ("copy", "take")}),
        _kernel_entry(
            # the main path: als_train with accum="pallas"; the headline
            # numbers are the users half's
            "normal_equations_fused", src + "segment_flush.cu",
            "pio_tpu/ops/als_pallas.py:369",
            tfused["launches"]["normal_equations_fused"],
            fused["users_half"],
            library_is=fused["users_half"]["library_is"],
            bound_f32_fma_ms=fused["users_half"]["bound_f32_fma_ms"],
            ms_by_part=fused["users_half"]["ms_by_part"],
            shape={k: fused["users_half"][k]
                   for k in ("S", "S_real", "nnz", "n_self", "k", "W",
                             "src")},
            items_half={k: fused["items_half"][k]
                        for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                  "max_abs_err")}),
        _kernel_entry(
            # the main path: the sequence template's deploy answering
            # queries; the headline numbers are its B = 1 serving call
            "flash_attention", src + "flash_attention.cu",
            "pio_tpu/ops/attention.py:219",
            seq_entry["launches"]["flash_attention"], attn["cases"][0],
            library_is="torch.nn.functional.scaled_dot_product_attention",
            bound_f32_fma_ms=attn["cases"][0]["bound_f32_fma_ms"],
            path=attn["cases"][0]["path"],
            shape={k: attn["cases"][0][k]
                   for k in ("B", "S", "H", "D", "dtype", "causal")},
            cases=attn["cases"], edges=attn["edges"],
            launches_train_resume={
                name: run["launches"]["flash_attention"]
                for name, run in resume["runs"].items()},
            launches_train_resume_deploy=resume["serve_launches"][
                "flash_attention"]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
