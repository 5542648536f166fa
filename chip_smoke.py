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
- serve_batching: the same factors persisted in a fresh sqlite store and
  deployed by three ``python -m pio_tpu_torch deploy`` processes on the
  async transport (the continuous batcher with a warm query, the micro
  batcher, none), 512 queries each from 16 client threads; every
  batched body equal byte for byte to the solo deploy's, K7 launched
  once a device dispatch (the deploy's own counts, before and after);
  batches of 1, 2, 16 and 64 in process equal to the solo answers on the
  exact and the clustered route, and the padding's cost at B 1; a
  second instance taken by ``/reload`` under load (every answer 200);
  ``python -m pio_tpu_torch undeploy`` stopping the server;
- serve_rollout: in that store, a second instance B (the factors plus
  seeded noise) beside the serve phase's A, and one ``python -m
  pio_tpu_torch deploy`` of A (continuous batcher, a warm query):
  ``deploy --canary 25`` of B under 512 queries from 16 threads, each
  user on the arm ``canary_bucket`` names and each body byte for byte
  its arm's instance's answer alone (in-process ``QueryServer``s), each
  arm's requests its users, K7 once a device dispatch of either arm and
  once a shadow sample; a fold-in of 64 new users and 64 items on both
  arms; ``promote`` and ``/reload`` keeping B; a third instance C (B's
  item rows permuted) canaried until the divergence guard rolls it back
  by itself, ``/reload`` keeping B; A canaried with shadow scoring on
  every 10th query and with none, in three alternated pairs, each ended
  by a rollback; ``deploy --canary auto`` under load, climbing every
  stage to 100 %; a second deploy with ``--feedback`` (32
  queries, 32 ``predict`` events) and ``/profile/start``/``stop``
  writing a trace that names K7's kernel;
- serve_fleet: the same factors in a sqlite store of their own, deployed
  by ``python -m pio_tpu_torch deploy --shards 2 --replicas 2
  --coalesce-window-ms 2`` in exact mode and then clustered (C 256 on
  each shard's slice, nprobe 32, K7), each under 512 queries of distinct
  users from 16 threads through its router and through a router without
  coalescing over the same shards: exact bodies byte for byte the
  single-host deploy's, clustered recall@10 against the exact oracle and
  coalesced bodies the solo ones, K7 launched once a shard's scan
  dispatch (the shards' counts, before and after); the exact route's
  column bits at narrow and shard widths; 2 x 2 shard processes behind a
  router with a replica and then a whole group SIGKILLed and restarted
  under load (no 5xx, degraded answers flagged); ``reshard --shards 3``
  under load (every answer the single host's); ``foldin --router-url``
  of 64 new users; ``deploy --canary 25`` and ``promote`` against the
  router;
- foldin: on the same seeded factors in a fresh sqlite store, served
  behind a server key: a tail of rate/buy events of 2,048 users (a
  quarter new, up to 512 items each) folded in by ``FoldInWorker`` (what
  ``python -m pio_tpu_torch foldin`` runs) in two batches of 1,024 and
  applied through ``/model/upsert_users`` over loopback HTTP; every
  multi-slot user's served row (and a sample of the rest) equal bit for
  bit to the user folded alone, in both modes, and to a second worker's,
  and within the stated bound of an f64 solve; new users' queries
  through K7 held to the recall floor; an item upsert re-encoding K7's
  table, held against a fresh encoding and the plain scan; the sqlite
  history read, the fold's parts and the model loads timed; then the
  HTTP arm: ``python -m pio_tpu_torch foldin --event-server-url ...
  --tail-wait 10`` as a process tailing an ``eventserver`` process on
  the same store, one event for each of 256 users posted through the
  SDK, every served row equal bit for bit to a ``LocalEventSource``
  worker's fold of the same events, the staleness from the 201 and the
  long-poll's wake timed, K7 answering those users;
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
- ingest: ``app new`` and an ``eventserver`` process (async transport)
  over a sqlite store, 3 x 10^5 seeded rate/buy events (every user and item
  in one at least) posted through ``sdk.EventClient`` in binary frames
  of 10,000 by 4 threads; every slot 201, every event stored, the first
  100,000 read back as a direct ``insert_batch`` of them reads, a JSON
  batch and an ``/events.json`` event stored as their binary twins, a
  corrupt frame refused with nothing stored; the wire, the server's
  decode, CRC32C on both sides and the sqlite insert timed;
- eventlog: the same 3 x 10^5 events through an ``eventserver`` process
  into the native event log (metadata on sqlite, models on localfs);
  read after the server stopped: the log holds every event, its C++
  ``columnarize`` equals ``find`` + the columnar fold and the sqlite
  store's (user, item, value) triples, the train verb on it launches K2
  as predicted and stores the factors of ``als_train`` on that read, and
  JSON batches of 50 through ``create_event_server`` take the native
  fast path (one ``EventLog.ingest_batch`` a batch) and store what the
  binary frames stored; the wire, the server's busy counters and CPU,
  both reads and the train verb timed;
- train_entry: on the ingest phase's store,
  ``python -m pio_tpu_torch train`` (its ``main``, in process, so the
  launch counters can be read), then the trained instance deployed and
  queried over HTTP; then the verb's parts timed one by one on the same
  store: the sqlite read plus the columnar fold, the row path it
  replaced (``find`` + ``to_interactions``, held equal element for
  element), the layout build, the sweeps and the persist;
- shared_store: one store over the wire. (a) a ``storageserver``
  process over the ingest phase's store, the train verb with every
  repository on ``remote`` (its read one server-side ``columnarize``
  RPC, K2 as predicted, the factors ``train_entry``'s bit for bit), the
  model's persist and load over the wire, and a deploy from the remote
  store answering 64 queries over HTTP (K7 once a query, each answer
  the in-process one, recall@10 at the floor); (b) two
  ``storageserver`` processes, each on its own event log, behind
  ``sharded`` (metadata and models on shard 0): an ``eventserver``
  takes the first 100,000 events, the sharded ``find_columnar`` holds
  the ingest phase's direct-insert store's rows and its
  ``columnarize`` that store's triples, a train verb launches K2 as
  predicted; (c) three on sqlite behind ``replicated`` (R 3, W 2): the
  same 100,000 events with replica 3 SIGKILLed after half the frames,
  every slot 201 and every later event in its hint log, replica 3
  restarted on its store until its hints drain, a scrub finding
  nothing to repair, the replicas' columnar reads equal, and a train
  verb launching K2 as predicted;
- evaluate: on the same store (the events are written once), ``python
  -m pio_tpu_torch eval --sweep`` of 2 ALS candidates (lambda at alpha 10)
  trained as one stacked group on 3 seeded k-folds, map@10 with ndcg,
  precision, recall and AUC beside it, its time by part and its peak
  memory; fold 0 again outside the verb, each candidate's factors and
  map@10 held to a sequential ``als_train`` and the fold's stored sums,
  256 test users' batched metrics held to the scalar oracles; the grid
  on 2 time folds, then again killed by a chaos fault at fold 1 and
  resumed (``--resume-eval``) to the uninterrupted result bit for bit;
  ``eval <Evaluation> <ParamsGenerator>`` (class mode,
  2 candidates x 3 folds, the serve phase's retrieval block: K2 in the
  trainings, K7 in every ``batch_predict``); ``train --from-eval`` and
  ``deploy --from-eval`` of the winner, answering over HTTP; and
  ``batchpredict`` of 4,096 queries (K7 a batch), held to the deploy's
  answers;
- quickstart: the README Quickstart through the port's verbs on a
  fresh sqlite store: ``app new``, ``import`` of
  ``examples/quickstart/events.jsonl.gz`` (100,000 events), an
  ``eventserver`` process taking one ``POST /events.json`` and one
  segment.io webhook, ``train`` with the committed engine.json's params
  (K2 in every flush), the instance deployed answering 8 queries through
  ``sdk.EngineClient`` held to the exact top-k, and ``export`` (the
  re-import of the export is cut for time);
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
  a checkpoint save and of the heartbeat;
- evaluate_sequence: on the same events, ``eval --sweep`` of the
  sequence template (2 learning rates, 2 rolling folds) through the
  sequential fallback, K8 in every training forward and scoring batch.

The phases run one at a time, in the order above but for
attention_kernel and sequence_train, which follow train_validated, so
that every kernel's timing and training throughput is taken with the
card to itself. Then sequence_entry, train_resume and evaluate_sequence
run in a second process of this script (``--sequence-lane``: its own
store and launch counts) beside ingest to quickstart, so the host times
of both groups are taken under each other's load.

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
import functools
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
# events written for the train entry point: every user and item in one,
# the rest zipf; cut from 10^6 after the script outran its 1,200 s on a
# slow host (PERF.md section 4)
N_EVENTS = 300_000
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
    from pio_tpu_torch.ops.kernels import launch_counters

    return launch_counters()


def reset_counts() -> None:
    """Every count to 0, just before a path is driven."""
    for c in counters().values():
        c.reset()


def read_counts() -> dict:
    return {name: c.value for name, c in counters().items()}


def check_serving_launches(launches: dict, kernel: str, want: int,
                           hedged: int, per_dispatch: int) -> None:
    """Only ``kernel`` launched on a deploy's path, ``want`` times, and
    at most ``per_dispatch`` more for each hedged duplicate dispatch (a
    batch that outlived three times the median predict is issued again,
    and the duplicate launches its kernels once it starts)."""
    got = launches.get(kernel, 0)
    others = {k: v for k, v in launches.items() if k != kernel and v}
    if others or not want <= got <= want + per_dispatch * hedged:
        raise AssertionError(
            f"serving launches {launches}: want {want} of {kernel}"
            + (f" (+ up to {per_dispatch} for each of {hedged} hedged "
               "dispatches)" if hedged else ""))


@contextlib.contextmanager
def guarded_calls():
    """Counts the storage DAO calls that pass the resilience guard: each
    enters ``chaos.maybe_inject`` at its ``storage.<source>`` point."""
    from pio_tpu_torch.resilience import chaos

    plain = chaos.maybe_inject
    seen = {"calls": 0}

    def counted(point: str) -> None:
        if point.startswith("storage."):
            seen["calls"] += 1
        plain(point)

    chaos.maybe_inject = counted
    try:
        yield seen
    finally:
        chaos.maybe_inject = plain


GUARD_PROBE_CALLS = 20_000  # metadata reads timed with and without the guard


def guard_cost(storage, calls: int) -> dict:
    """What the resilience guard adds to ``calls`` DAO calls: one app
    read through the guarded DAO and through the DAO it wraps,
    GUARD_PROBE_CALLS times each (the least of three rounds), the
    difference a call times ``calls``."""
    apps = storage.get_metadata_apps()
    raw = apps._dao
    app_id = apps.get_all()[0].id
    best = {}
    for name, dao in (("guarded", apps), ("raw", raw)):
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(GUARD_PROBE_CALLS):
                dao.get(app_id)
            times.append(time.perf_counter() - t0)
        best[name] = 1e6 * min(times) / GUARD_PROBE_CALLS
    extra_us = best["guarded"] - best["raw"]
    return {"dao_calls": calls, "guarded_us_a_call": best["guarded"],
            "raw_us_a_call": best["raw"], "guard_us_a_call": extra_us,
            "guard_ms": calls * extra_us / 1e3}


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

def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def cuda_settings() -> None:
    # plain versions and the exact tier in full f32, stated and set
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script "
                         "runs on an NVIDIA GPU only")
    card = card_line()
    print(card, flush=True)
    cuda_settings()
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    emit("device", nvidia_smi=card, torch=torch.__version__,
         cuda=torch.version.cuda, numpy=np.__version__,
         python=sys.version.split()[0], **device)
    return device


# -- phase 2: build -----------------------------------------------------------

def phase_build() -> None:
    from concurrent.futures import ThreadPoolExecutor

    from pio_tpu_torch import native
    from pio_tpu_torch.ops.kernels import build

    def build_eventlog() -> float:
        t = time.perf_counter()
        native.load_library("eventlog")
        return time.perf_counter() - t

    t0 = time.perf_counter()
    # the native event log is host code (g++), built beside the kernels
    with ThreadPoolExecutor(1) as pool:
        eventlog = pool.submit(build_eventlog)
        seconds = build.build_all()
        seconds["eventlog (g++)"] = eventlog.result()
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


def scan_case(didx, u: torch.Tensor, nprobe: int) -> dict:
    """K7 on ``didx`` for the users ``u`` probing their ``nprobe`` best
    clusters, held to its plain version on the same card tensors (the
    -inf pattern, finite scores, RTOL and ATOL_OF_MAX), with both times,
    one library call's and the bound."""
    from pio_tpu_torch.ops.kernels import quantized_scan as qscan

    b = u.shape[0]
    dtype = didx.params.dtype
    _, top_c = torch.topk(u @ didx.centroids.T, nprobe)
    args = (didx.table, didx.scales, didx.gidx, top_c.to(torch.int32), u)
    got = qscan.quantized_scan(*args)
    torch.cuda.synchronize()
    want = qscan.quantized_scan_reference(*args)
    if not torch.equal(torch.isneginf(got), torch.isneginf(want)):
        raise AssertionError(f"{dtype} B={b}: the -inf pattern differs")
    fin = torch.isfinite(want)
    if not bool(torch.isfinite(got[fin]).all()):
        raise AssertionError(f"{dtype} B={b}: non-finite kernel scores")
    err = (got[fin] - want[fin]).abs()
    scale = float(want[fin].abs().max())
    tol = RTOL * want[fin].abs() + ATOL_OF_MAX * scale
    if bool((err > tol).any()):
        raise AssertionError(
            f"{dtype} B={b}: kernel disagrees with the plain version, max "
            f"abs err {float(err.max())}")
    gathered = didx.table[top_c].float()
    bound_ms, bound_by = scan_bound(didx, top_c, b)
    return {
        "dtype": dtype, "B": b, "P": nprobe, "C": didx.n_clusters,
        "Lmax": didx.pad_width, "k": u.shape[1],
        "max_abs_err": float(err.max()),
        "max_rel_err": float((err / want[fin].abs().clamp_min(
            1e-30)).max()),
        "max_abs_score": scale,
        "ms": gpu_ms(lambda: qscan.quantized_scan(*args)),
        "plain_ms": gpu_ms(lambda: qscan.quantized_scan_reference(*args)),
        # one library call over blocks gathered beforehand (the gather
        # and the pad mask are outside it)
        "library_ms": gpu_ms(lambda: torch.einsum("bplk,bk->bpl", gathered,
                                                  u)),
        "bound_ms": bound_ms, "bound_by": bound_by,
        # an empty kernel on the scan's grid: the practical floor of a
        # launch of this shape, beside the byte bound
        "empty_launch_ms": gpu_ms(lambda: qscan.empty_launch(
            b, nprobe, didx.pad_width, u.device)),
    }


def phase_scan_kernel(users: np.ndarray, items: np.ndarray,
                      dev: torch.device) -> dict:
    from pio_tpu_torch.ops import retrieval as rt

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
        for b in SCAN_BATCHES:
            rows = rng.choice(N_USERS, b, replace=False)
            cases.append(scan_case(didx, torch.from_numpy(users[rows]).to(
                dev), min(params.nprobe, didx.n_clusters)))
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


def phase_serve(users: np.ndarray, items: np.ndarray, dev: torch.device,
                store_dir: Path) -> dict:
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
    # the store stays in store_dir: serve_batching deploys its instance
    tmp = str(store_dir)
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
        hedged = qs.hedged_dispatches
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
        hedged = qs.hedged_dispatches - hedged
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
    check_serving_launches(launches, "quantized_scan", len(plain_q) + 1 + 1,
                           hedged, 1)
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
        "instance": iid, "retrieval": RETRIEVAL, "launches": launches,
        "hedged_dispatches": hedged,
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

# -- phase 3b: the deploy's admission stage and lifecycle ---------------------

SB_QUERIES = 512           # /queries.json a deploy mode
SB_CLIENTS = 16            # client threads posting them at once
SB_RELOAD_CLIENTS = 4      # threads querying through the /reload
SB_BATCHES = (1, 2, 16, 64)  # in-process batch sizes held to the solo answer
SB_PROFILED_CALLS = 50     # calls a side of the padded/unpadded timing
SB_KEY = "chip-smoke-batching-key"
SB_MODES = ("coalesced", "micro", "solo")
SB_BOOT_TIMEOUT_S = 300


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(port: int, path: str) -> tuple[int, object]:
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _post_raw(port: int, path: str, body) -> tuple[int, bytes, float]:
    """(status, the raw body bytes, seconds) of one POST."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            status, raw = r.status, r.read()
    except urllib.error.HTTPError as e:
        status, raw = e.code, e.read()
    return status, raw, time.perf_counter() - t0


def deploy_proc(env: dict, engine_dir: Path, port: int, iid: str,
                log: Path, flags: list) -> subprocess.Popen:
    """``python -m pio_tpu_torch deploy`` of instance ``iid`` on ``port``,
    its output (stdout and the log records) into ``log``."""
    with open(log, "w") as out:
        return subprocess.Popen(
            [sys.executable, "-m", "pio_tpu_torch", "deploy", "--engine-dir",
             str(engine_dir), "--ip", "127.0.0.1", "--port", str(port),
             "--engine-instance-id", iid, "--server-key", SB_KEY, *flags],
            cwd=REPO_ROOT, env=env, stdout=out, stderr=subprocess.STDOUT,
            text=True)


def wait_deployed(proc, log: Path, t0_wall: float) -> float:
    """Seconds from ``t0_wall`` (``time.time()``) until the deploy printed
    its bound address: the log's modification time once it holds that
    line (the deploy writes nothing after it unless something fails)."""
    while time.time() - t0_wall < SB_BOOT_TIMEOUT_S:
        if "deployed on http://" in log.read_text():
            return log.stat().st_mtime - t0_wall
        if proc.poll() is not None:
            raise AssertionError(f"deploy exited {proc.returncode}: "
                                 f"{log.read_text()[-3000:]}")
        time.sleep(0.05)
    raise AssertionError(f"deploy not up in {SB_BOOT_TIMEOUT_S} s")


def load(port: int, queries: list, clients: int) -> dict:
    """Every query posted once, ``clients`` threads at a time: the raw
    bodies in query order, their statuses and the latencies."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with ThreadPoolExecutor(clients) as pool:
        out = list(pool.map(
            lambda q: _post_raw(port, "/queries.json", q), queries))
    wall = time.perf_counter() - t0
    lat = sorted(1e3 * dt for _, _, dt in out)
    return {"bodies": [raw for _, raw, _ in out],
            "statuses": [s for s, _, _ in out],
            "p50_ms": statistics.median(lat),
            "p99_ms": lat[int(0.99 * (len(lat) - 1))],
            "queries_per_s": len(queries) / wall, "wall_s": wall}


def server_counts(port: int) -> dict:
    """The deploy's own counters: K7's launches, the recorded predict
    dispatches and the hedged duplicates."""
    _, m = _get(port, "/metrics.json")
    return {"k7": m["kernelLaunches"]["quantized_scan"],
            "dispatches": m["spans"].get("predict", {}).get("count", 0),
            "hedged": m["hedgedDispatches"]}


def batch_invariance(model, retrieval: dict, users: list) -> dict:
    """In process on the card: at each of SB_BATCHES, the answers of a
    batch_predict of that many known users against each user's solo
    predict, on the exact and the clustered route (0 must differ); and
    the same with the dispatch floor at 1 row (products at the batch's
    own rows), which shows what the padding is for."""
    from pio_tpu_torch.models import recommendation as rec
    from pio_tpu_torch.ops import bucketing

    routes = {"exact": rec.ALSAlgorithm(rec.ALSAlgorithmParams(rank=RANK)),
              "clustered": rec.ALSAlgorithm(rec.ALSAlgorithmParams(
                  rank=RANK, retrieval=retrieval))}
    out: dict = {}
    floor = bucketing.DISPATCH_ROWS
    for name, algo in routes.items():
        out[name] = {}
        for rows in (floor, 1):
            bucketing.DISPATCH_ROWS = rows
            try:
                solo = [algo.predict(model, {"user": u, "num": 10})
                        for u in users]
                for b in SB_BATCHES:
                    got = algo.batch_predict(
                        model, [{"user": u, "num": 10} for u in users[:b]])
                    differ = sum(g != s for g, s in zip(got, solo))
                    key = str(b) if rows == floor else f"{b}_unpadded"
                    out[name][key] = differ
            finally:
                bucketing.DISPATCH_ROWS = floor
    return out


def padding_cost_b1(model, retrieval: dict, user: str) -> dict:
    """One solo predict's device ms under ``torch.profiler`` over
    SB_PROFILED_CALLS calls, with the products at the dispatch rows and
    at one row."""
    from torch.profiler import ProfilerActivity, profile

    from pio_tpu_torch.models import recommendation as rec
    from pio_tpu_torch.ops import bucketing

    floor = bucketing.DISPATCH_ROWS
    out = {}
    for name, params in (("exact", {}), ("clustered",
                                         {"retrieval": retrieval})):
        algo = rec.ALSAlgorithm(rec.ALSAlgorithmParams(rank=RANK, **params))
        q = {"user": user, "num": 10}
        dev_ms = {}
        for side, rows in (("padded", floor), ("unpadded", 1)):
            bucketing.DISPATCH_ROWS = rows
            try:
                for _ in range(5):
                    algo.predict(model, q)
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    for _ in range(SB_PROFILED_CALLS):
                        algo.predict(model, q)
                torch.cuda.synchronize()
            finally:
                bucketing.DISPATCH_ROWS = floor
            dev_ms[side] = device_ms_by_kernel(prof, SB_PROFILED_CALLS)[0]
        out[name] = {"device_ms": dev_ms,
                     "extra_device_ms": dev_ms["padded"]
                     - dev_ms["unpadded"]}
    return out


def reload_under_load(port: int, users: list, want_iid: str) -> dict:
    """POST /reload while SB_RELOAD_CLIENTS threads keep querying."""
    import threading

    stop = threading.Event()
    seen = {"statuses": {}, "queries": 0}
    lock = threading.Lock()

    def hammer(w: int) -> None:
        i = w
        while not stop.is_set():
            status, _, _ = _post_raw(port, "/queries.json",
                                     {"user": users[i % len(users)],
                                      "num": 10})
            i += SB_RELOAD_CLIENTS
            with lock:
                seen["queries"] += 1
                seen["statuses"][status] = seen["statuses"].get(status, 0) + 1

    threads = [threading.Thread(target=hammer, args=(w,))
               for w in range(SB_RELOAD_CLIENTS)]
    for t in threads:
        t.start()
    try:
        time.sleep(0.2)
        status, body, reload_s = _post(
            port, f"/reload?accessKey={SB_KEY}", {})
        time.sleep(0.2)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=120)
    _, st = _get(port, "/")
    out = {"reload_status": status, "reload_s": reload_s,
           "queries": seen["queries"],
           "non_200": sum(n for s, n in seen["statuses"].items()
                          if s != 200),
           "served_after": st["engineInstance"]["id"]}
    if status != 200 or body.get("engineInstanceId") != want_iid:
        raise AssertionError(f"/reload: {status} {body}")
    if out["non_200"] or out["served_after"] != want_iid:
        raise AssertionError(f"reload under load: {out}")
    return out


def phase_serve_batching(users: np.ndarray, items: np.ndarray,
                         dev: torch.device, store_dir: Path,
                         iid: str) -> dict:
    """The deploy verb's admission stage on the serve phase's store and
    instance ``iid`` (its seeded model): three ``python -m pio_tpu_torch
    deploy`` processes on the async transport (the continuous batcher
    with a warm query, the micro batcher, none), SB_QUERIES queries each
    from SB_CLIENTS threads, every batched body held byte for byte to the
    solo deploy's, K7's launches to the deploy's device dispatches;
    batches of 1, 2, 16 and 64 in process on both routes; /reload of a
    second instance under load; ``undeploy``."""
    from pio_tpu_torch.__main__ import _engine_from_variant, _load_variant
    from pio_tpu_torch.convert import recommendation_model_from_numpy
    from pio_tpu_torch.data.storage import Storage
    from pio_tpu_torch.workflow.train import persist_models

    user_ids = [f"u{i}" for i in range(N_USERS)]
    item_ids = [f"i{i}" for i in range(N_ITEMS)]
    rng = np.random.default_rng(SEED + 21)
    picked = [user_ids[i] for i in rng.choice(N_USERS, SB_QUERIES + 1,
                                              replace=False)]
    warm_user, picked = picked[-1], picked[:-1]
    queries = [{"user": u, "num": 10} for u in picked]
    out: dict = {"card": card_line(), "queries": SB_QUERIES,
                 "clients": SB_CLIENTS}
    seconds: dict = {}
    with tempfile.TemporaryDirectory(prefix="pio_chip_batching_") as tmp:
        tmp = Path(tmp)
        env = sqlite_env(store_dir)
        engine_dir = store_dir / "engine"
        variant = _load_variant(str(engine_dir))
        engine, ep = _engine_from_variant(variant, str(engine_dir))
        storage = Storage(env=env)
        model = recommendation_model_from_numpy(
            users, items, user_ids, item_ids, device=dev)
        # the deploys' home (checkpoints, default stores) stays in here
        proc_env = {**os.environ, **env, "PIO_TPU_HOME": str(tmp / "home")}
        flags = {"coalesced": ["--coalesce-window-ms", "2", "--warm-query",
                               json.dumps({"user": warm_user, "num": 10})],
                 "micro": ["--batch-window-ms", "2"], "solo": []}
        ports = {m: free_port() for m in SB_MODES}
        logs = {m: tmp / f"deploy_{m}.log" for m in SB_MODES}
        procs: dict = {}
        try:
            t0, t0_wall = time.perf_counter(), time.time()
            for m in SB_MODES:
                procs[m] = deploy_proc(proc_env, engine_dir, ports[m], iid,
                                       logs[m], flags[m])
            # while the deploys load the first instance (pinned by id):
            # the second is persisted (/reload then takes it as the
            # latest), and the in-process checks run on the card
            t1 = time.perf_counter()
            iid2 = persist_models([model], ep, storage, variant["id"],
                                  engine_factory=FACTORY)
            out["persist_second_s"] = time.perf_counter() - t1
            t1 = time.perf_counter()
            out["batch_invariance"] = batch_invariance(
                model, RETRIEVAL, picked[:max(SB_BATCHES)])
            seconds["batch_invariance"] = time.perf_counter() - t1
            t1 = time.perf_counter()
            out["padding_cost_b1"] = padding_cost_b1(model, RETRIEVAL,
                                                     warm_user)
            seconds["padding_cost_b1"] = time.perf_counter() - t1
            out["boot_s"] = {m: wait_deployed(procs[m], logs[m], t0_wall)
                             for m in SB_MODES}
            seconds["boot"] = time.perf_counter() - t0

            t0 = time.perf_counter()
            modes: dict = {}
            for m in SB_MODES:
                port = ports[m]
                info: dict = {}
                if m != "coalesced":
                    # no warm query: the first query builds the retrieval
                    # index (k-means) and, with the micro batcher, starts
                    # the sweep in the background; /readyz drops while
                    # the sweep runs
                    status, _, first_s = _post_raw(
                        port, "/queries.json", {"user": warm_user,
                                                "num": 10})
                    info["first_query_ms"] = 1e3 * first_s
                if m == "micro":
                    t1 = time.perf_counter()
                    status, ready = _get(port, "/readyz")
                    info["readyz_during_sweep"] = status
                    while not ready["checks"]["buckets"]["ok"]:
                        if time.perf_counter() - t1 > 60:
                            raise AssertionError(f"sweep: {ready}")
                        time.sleep(0.01)
                        status, ready = _get(port, "/readyz")
                status, ready = _get(port, "/readyz")
                if status != 200:
                    raise AssertionError(f"{m}: /readyz {status} {ready}")
                info["sweep"] = ready["checks"].get("buckets", {}).get(
                    "sweep")
                # -- the main path: the deploy's counts just before ----
                before = server_counts(port)
                res = load(port, queries, SB_CLIENTS)
                after = server_counts(port)
                # ----------------------------------------------------------
                _, batcher = _get(port, "/batcher.json")
                counts = {k: after[k] - before[k] for k in after}
                if set(res["statuses"]) != {200}:
                    raise AssertionError(f"{m}: statuses {res['statuses']}")
                # K7 once a device dispatch: each recorded predict launches
                # it once, a hedged duplicate at most once more
                if not (counts["dispatches"] <= counts["k7"]
                        <= counts["dispatches"] + counts["hedged"]):
                    raise AssertionError(f"{m}: K7 {counts['k7']} for "
                                         f"{counts} dispatches")
                info.update({k: v for k, v in res.items()
                             if k not in ("bodies", "statuses")})
                info.update({"dispatches": counts["dispatches"],
                             "mean_batch": SB_QUERIES / counts["dispatches"],
                             "hedged_dispatches": counts["hedged"],
                             "k7_launches": counts["k7"],
                             "batcher": {k: batcher.get(k) for k in (
                                 "mode", "dispatches", "coalescedQueries",
                                 "bypassSolo", "shed", "meanOccupancy",
                                 "coalesceWaitMs", "windowMs")
                                 if k in batcher}})
                if m == "coalesced" and batcher.get("mode") != "continuous":
                    raise AssertionError(f"{m}: /batcher.json {batcher}")
                if m == "micro" and batcher.get("mode") != "micro":
                    raise AssertionError(f"{m}: /batcher.json {batcher}")
                if m == "solo" and batcher.get("enabled"):
                    raise AssertionError(f"{m}: /batcher.json {batcher}")
                info["bodies"] = res["bodies"]
                modes[m] = info
            solo_bodies = modes["solo"].pop("bodies")
            for m in ("coalesced", "micro"):
                modes[m]["bodies_differ"] = sum(
                    a != b for a, b in zip(modes[m].pop("bodies"),
                                           solo_bodies))
            out["modes"] = modes
            seconds["modes"] = time.perf_counter() - t0

            t0 = time.perf_counter()
            out["reload"] = reload_under_load(ports["coalesced"], picked,
                                              iid2)
            seconds["reload"] = time.perf_counter() - t0

            # undeploy: the verb with the server key; the server exits
            t0 = time.perf_counter()
            und = subprocess.run(
                [sys.executable, "-m", "pio_tpu_torch", "undeploy",
                 "--port", str(ports["coalesced"]), "--server-key", SB_KEY],
                cwd=REPO_ROOT, env=proc_env, capture_output=True, text=True,
                timeout=120)
            out["undeploy"] = {"rc": und.returncode,
                               "s": time.perf_counter() - t0}
            try:
                out["undeploy"]["server_exit"] = procs["coalesced"].wait(
                    timeout=30)
            except subprocess.TimeoutExpired:
                out["undeploy"]["server_exit"] = None
            out["undeploy"]["server_exit_s"] = time.perf_counter() - t0
            out["seconds"] = seconds
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    stop_process(proc)
            storage.close()
        warm_failed = {m: [ln for ln in logs[m].read_text().splitlines()
                           if "warm" in ln and "failed" in ln]
                       for m in SB_MODES}
    emit("serve_batching", **out)
    if any(warm_failed.values()):
        raise AssertionError(f"warm-up failed: {warm_failed}")
    for m in ("coalesced", "micro"):
        if out["modes"][m]["bodies_differ"]:
            raise AssertionError(f"{m}: {out['modes'][m]['bodies_differ']} "
                                 "bodies differ from the solo deploy's")
        if out["modes"][m]["dispatches"] >= SB_QUERIES:
            raise AssertionError(f"{m}: nothing was batched")
    for route, differ in out["batch_invariance"].items():
        if any(differ[str(b)] for b in SB_BATCHES):
            raise AssertionError(f"{route}: batched answers differ {differ}")
    if out["undeploy"]["rc"] != 0 or out["undeploy"]["server_exit"] != 0:
        raise AssertionError(f"undeploy: {out['undeploy']} {und.stderr}")
    return out


# -- phase 3c: the deploy's guarded rollout --------------------------------

SR_QUERIES = 512           # /queries.json of distinct users a canary load
SR_CLIENTS = 16            # client threads posting them at once
SR_PCT = 25                # the fixed canary share
SR_NOISE = 1e-3            # B = A + SR_NOISE x N(0, 1) on every factor
SR_FOLDIN_USERS = 64       # new users upserted during the canary
SR_FOLDIN_ITEMS = 64       # existing items upserted with them
SR_CHECK_USERS = 64        # users re-queried after promote, reload, rollback
SR_BREACH_PCT = 50         # C's canary share
SR_BREACH_MAX_QUERIES = 2_048
SR_RAMP = {"min_stage_seconds": 1, "min_stage_samples": 20}
SR_RAMP_USERS = 20_000     # distinct users cycled through during the ramp
SR_RAMP_WAIT_S = 20
SR_RAMP_STAGES = (1, 5, 25, 100)   # the rollout's default ladder
# shadowEvery of A's 25 % canaries, in alternated pairs in one deploy
SR_SHADOW_ORDER = (0, 10, 10, 0, 0, 10)
SR_FEEDBACK_QUERIES = 32
SR_PROFILED_QUERIES = 16
SR_APP = "chip-smoke-feedback"


def pio_cli(env: dict, *argv) -> tuple[dict, float]:
    """``python -m pio_tpu_torch <argv>`` as a process: its JSON answer
    and seconds; a non-zero exit raises."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "pio_tpu_torch", *argv],
                         cwd=REPO_ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    if out.returncode != 0:
        raise AssertionError(f"{argv[0]}: rc {out.returncode} "
                             f"{out.stderr[-2000:]}")
    return json.loads(out.stdout), time.perf_counter() - t0


def rollout_counts(port: int) -> dict:
    """The deploy's K7 launches, each arm's recorded device dispatches
    and hedged duplicates (``/metrics.json``), and the rollout's shadow
    samples and per-arm requests (``/rollout/status``)."""
    _, m = _get(port, "/metrics.json")
    _, st = _get(port, "/rollout/status")
    arms = st.get("arms", {})
    shadow_span = m["spans"].get("shadow", {})
    return {"k7": m["kernelLaunches"]["quantized_scan"],
            # the shadow thread's seconds in shadow_predict, and the
            # longest sample since the deploy started
            "shadow_s": shadow_span.get("total", 0.0),
            "shadow_max_s": shadow_span.get("max", 0.0),
            "active": m["armDispatches"]["active"],
            "candidate": m["armDispatches"]["candidate"],
            "hedged": m["hedgedDispatches"],
            "shadow": st.get("shadow", {}).get("samples", 0),
            "requests_active": arms.get("active", {}).get("requests", 0),
            "requests_candidate": arms.get("candidate", {}).get(
                "requests", 0)}


def quiet_counts(port: int, quiet_s: float) -> dict:
    """``rollout_counts`` once they held still for ``quiet_s``: a shadow
    sample scores on the deploy's shadow thread after its query
    answered, and the first query after a /reload builds the retrieval
    index (k-means), which the deploy's hedge may race with a duplicate
    that launches K7 after the query answered."""
    last, t_last = rollout_counts(port), time.perf_counter()
    t0 = t_last
    while time.perf_counter() - t_last < quiet_s:
        if time.perf_counter() - t0 > 30:
            raise AssertionError(f"counts still moving: {last}")
        time.sleep(0.1)
        now = rollout_counts(port)
        if now != last:
            last, t_last = now, time.perf_counter()
    return last


def arm_load(port: int, queries: list, expect: dict) -> dict:
    """SR_CLIENTS threads post ``queries`` once each; every status 200
    and every body byte for byte ``expect[user]``. K7's launches against
    the arms' dispatches and the shadow samples, from the deploy's own
    counts just before and just after."""
    before = rollout_counts(port)
    res = load(port, queries, SR_CLIENTS)
    after = quiet_counts(port, 0.1)
    d = {k: after[k] - before[k] for k in after}
    dispatches = d["active"] + d["candidate"]
    out = {k: res[k] for k in ("p50_ms", "p99_ms", "queries_per_s",
                               "wall_s")}
    out.update({"dispatches": {"active": d["active"],
                               "candidate": d["candidate"]},
                "requests": {"active": d["requests_active"],
                             "candidate": d["requests_candidate"]},
                "shadow_samples": d["shadow"], "hedged": d["hedged"],
                "shadow_busy_s": d["shadow_s"],
                "shadow_max_s_so_far": after["shadow_max_s"],
                "k7_launches": d["k7"],
                "non_200": sum(s != 200 for s in res["statuses"]),
                "bodies_differ": sum(
                    raw != expect[q["user"]]
                    for q, raw in zip(queries, res["bodies"]))})
    # K7 once a device dispatch of either arm and once a shadow sample
    # (a solo score on the other arm); a hedged duplicate at most once
    if not (dispatches + d["shadow"] <= d["k7"]
            <= dispatches + d["shadow"] + d["hedged"]):
        raise AssertionError(f"K7 {d['k7']} for {d}")
    if out["non_200"] or out["bodies_differ"]:
        raise AssertionError(f"load: {out}")
    return out


def phase_serve_rollout(users: np.ndarray, items: np.ndarray,
                        dev: torch.device, store_dir: Path,
                        iid_a: str) -> dict:
    """The deploy's guarded rollout on the serve phase's store, its
    instance ``iid_a`` as A: B (A's factors plus seeded noise) and later
    C (B's item rows permuted) persisted beside it. One ``python -m
    pio_tpu_torch deploy`` of A with the continuous batcher and a warm
    query; ``deploy --canary 25`` of B under SR_QUERIES queries from
    SR_CLIENTS threads, each user on the arm ``canary_bucket`` names and
    its body byte for byte that arm's instance alone (in-process
    ``QueryServer``s on the card); fold-in on both arms; ``promote`` and
    ``/reload``; C's divergence breach rolling it back by itself and
    ``/reload`` keeping B; A canaried with shadow scoring every 10th
    query and with none, in alternated pairs (SR_SHADOW_ORDER), each
    ended by a rollback; the ``auto`` ramp under load, which must climb
    every stage; a second deploy of B with ``--feedback`` and
    ``/profile/*``."""
    from pio_tpu_torch.__main__ import (
        _engine_from_variant,
        _engine_ids,
        _load_variant,
    )
    from pio_tpu_torch.convert import recommendation_model_from_numpy
    from pio_tpu_torch.data.dao import App
    from pio_tpu_torch.data.storage import Storage
    from pio_tpu_torch.rollout import (
        VERDICT_PROMOTED,
        VERDICT_ROLLED_BACK,
        canary_bucket,
        load_record,
    )
    from pio_tpu_torch.workflow.context import create_workflow_context
    from pio_tpu_torch.workflow.serve import QueryServer, ServingConfig
    from pio_tpu_torch.workflow.train import persist_models

    user_ids = [f"u{i}" for i in range(N_USERS)]
    item_ids = [f"i{i}" for i in range(N_ITEMS)]
    rng = np.random.default_rng(SEED + 41)
    order = rng.permutation(N_USERS)
    picked = [user_ids[i] for i in order[:SR_QUERIES]]
    warm_user = user_ids[order[SR_QUERIES]]
    queries = [{"user": u, "num": 10} for u in picked]
    check_q = queries[:SR_CHECK_USERS]
    warm = {"user": warm_user, "num": 10}
    out: dict = {"card": card_line(), "queries": SR_QUERIES,
                 "clients": SR_CLIENTS, "pct": SR_PCT}
    seconds: dict = {}
    procs: list = []
    storage = None
    oracles: dict = {}
    t_phase = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory(prefix="pio_chip_rollout_") as tmp:
            tmp = Path(tmp)
            env = sqlite_env(store_dir)
            engine_dir = store_dir / "engine"
            variant = _load_variant(str(engine_dir))
            engine, ep = _engine_from_variant(variant, str(engine_dir))
            engine_id, version, vname = _engine_ids(variant,
                                                    str(engine_dir))
            storage = Storage(env=env)
            app_id = storage.get_metadata_apps().insert(App(0, SR_APP))
            storage.get_events().init(app_id)
            proc_env = {**os.environ, **env,
                        "PIO_TPU_HOME": str(tmp / "home")}
            key = f"?accessKey={SB_KEY}"

            # -- B persisted; both deploys boot while the oracles load ----
            t0 = time.perf_counter()
            noise = np.random.default_rng(SEED + 43)
            users_b = users + np.float32(SR_NOISE) * noise.standard_normal(
                users.shape, np.float32)
            items_b = items + np.float32(SR_NOISE) * noise.standard_normal(
                items.shape, np.float32)
            iid_b = persist_models([recommendation_model_from_numpy(
                users_b, items_b, user_ids, item_ids, device=dev)], ep,
                storage, engine_id, version, vname, engine_factory=FACTORY)
            seconds["persist_b"] = time.perf_counter() - t0
            t0, t0_wall = time.perf_counter(), time.time()
            port, fport = free_port(), free_port()
            logs = [tmp / "deploy.log", tmp / "deploy_feedback.log"]
            procs.append(deploy_proc(
                proc_env, engine_dir, port, iid_a, logs[0],
                ["--coalesce-window-ms", "2", "--warm-query",
                 json.dumps(warm)]))
            procs.append(deploy_proc(
                proc_env, engine_dir, fport, iid_b, logs[1],
                ["--feedback", "--feedback-app", SR_APP, "--warm-query",
                 json.dumps(warm)]))
            ctx = create_workflow_context(storage, device=dev)
            for name, iid in (("A", iid_a), ("B", iid_b)):
                oracles[name] = QueryServer(
                    engine, ep, storage, ServingConfig(
                        engine_id=engine_id, engine_version=version,
                        engine_variant=vname, warm_query=warm),
                    ctx=ctx, instance_id=iid)

            def answers(name: str, qs: list) -> dict:
                return {q["user"]: json.dumps(oracles[name].query(
                    dict(q), record=False)).encode() for q in qs}

            fresh = {name: answers(name, queries) for name in oracles}
            out["arms_differ"] = sum(fresh["A"][u] != fresh["B"][u]
                                     for u in picked)
            seconds["oracles"] = time.perf_counter() - t0
            out["boot_s"] = [wait_deployed(p, lg, t0_wall)
                             for p, lg in zip(procs, logs)]
            seconds["boot"] = time.perf_counter() - t0
            if out["arms_differ"] != SR_QUERIES:
                raise AssertionError(
                    f"A and B answer alike for "
                    f"{SR_QUERIES - out['arms_differ']} users")

            def canary(user: str, pct: int) -> bool:
                return canary_bucket(user) < pct

            def expect(pct: int, cand: dict, active: dict) -> dict:
                return {u: (cand if canary(u, pct) else active)[u]
                        for u in active}

            # -- deploy --canary 25 of B (the latest eligible instance) ---
            t0 = time.perf_counter()
            res, cli_s = pio_cli(proc_env, "deploy", "--canary",
                                 str(SR_PCT), "--ip", "127.0.0.1",
                                 "--port", str(port), "--server-key",
                                 SB_KEY)
            st = res["rollout"]
            if (st["candidateInstanceId"] != iid_b
                    or st["stagePct"] != SR_PCT):
                raise AssertionError(f"canary: {st}")
            main = arm_load(port, queries,
                            expect(SR_PCT, fresh["B"], fresh["A"]))
            n_cand = sum(canary(u, SR_PCT) for u in picked)
            main.update({"canary_cli_s": cli_s, "canary_users": n_cand,
                         "guard_evaluations": main["requests"][
                             "candidate"] // 5})
            _, st = _get(port, "/rollout/status")
            main["status"] = {k: st[k] for k in (
                "stagePct", "verdict", "reason", "arms", "shadow",
                "guards")}
            out["canary"] = main
            if main["requests"] != {"active": SR_QUERIES - n_cand,
                                    "candidate": n_cand}:
                raise AssertionError(f"requests {main['requests']} for "
                                     f"{n_cand} canary users")
            if st["verdict"] is not None:
                raise AssertionError(f"canary concluded: {st['reason']}")
            seconds["canary"] = time.perf_counter() - t0

            # -- fold-in during the canary ---------------------------------
            t0 = time.perf_counter()
            frng = np.random.default_rng(SEED + 47)
            new_q = [{"user": f"sr-new-{i}", "num": 10}
                     for i in range(SR_FOLDIN_USERS)]
            rows = {q["user"]: frng.standard_normal(RANK).astype(
                np.float32).tolist() for q in new_q}
            sel = frng.choice(N_ITEMS, SR_FOLDIN_ITEMS, replace=False)
            item_rows = {item_ids[i]: (items[i] + np.float32(0.01)
                                       * frng.standard_normal(
                                           RANK, np.float32)).tolist()
                         for i in sel}
            status, body, apply_s = _post(
                port, f"/model/upsert_users{key}",
                {"users": rows, "items": item_rows, "stalenessSeconds": 0})
            out["foldin"] = {"status": status, "apply_s": apply_s,
                             **{k: body.get(k) for k in (
                                 "applied", "new", "itemsApplied",
                                 "candidateQueued")}}
            if (status != 200 or body.get("candidateQueued") != 0
                    or body.get("itemsApplied") != SR_FOLDIN_ITEMS):
                raise AssertionError(f"upsert: {status} {body}")
            for o in oracles.values():
                o.foldin_upsert(rows, items=item_rows)
            folded = {name: answers(name, new_q + check_q)
                      for name in oracles}
            new_cand = sum(canary(q["user"], SR_PCT) for q in new_q)
            out["foldin"]["new_users_by_arm"] = {
                "active": SR_FOLDIN_USERS - new_cand, "candidate": new_cand}
            if not 0 < new_cand < SR_FOLDIN_USERS:
                raise AssertionError("new users ride one arm only")
            out["foldin"]["load"] = arm_load(
                port, new_q, expect(SR_PCT, folded["B"], folded["A"]))
            seconds["foldin"] = time.perf_counter() - t0

            # -- promote, then /reload --------------------------------------
            t0 = time.perf_counter()
            res, cli_s = pio_cli(proc_env, "promote", "--port", str(port),
                                 "--server-key", SB_KEY)
            st = res["rollout"]
            rec = load_record(storage, iid_b)
            out["promote"] = {"cli_s": cli_s, "verdict": st["verdict"],
                              "stagePct": st["stagePct"],
                              "record": rec.verdict if rec else None}
            if (st["verdict"] != VERDICT_PROMOTED or st["stagePct"] != 100
                    or out["promote"]["record"] != VERDICT_PROMOTED):
                raise AssertionError(f"promote: {out['promote']}")
            out["promote"]["load"] = arm_load(
                port, check_q, {q["user"]: folded["B"][q["user"]]
                                for q in check_q})
            status, body, reload_s = _post(port, f"/reload{key}", {})
            out["promote"]["reload"] = {"status": status, "s": reload_s,
                                        "instance": body.get(
                                            "engineInstanceId")}
            if status != 200 or body.get("engineInstanceId") != iid_b:
                raise AssertionError(f"/reload after promote: {body}")
            # the index, once; then B alone as the baseline of the split
            _post_raw(port, "/queries.json", warm)
            quiet_counts(port, 1.5)
            out["promote"]["after_reload"] = arm_load(
                port, queries, fresh["B"])
            seconds["promote"] = time.perf_counter() - t0

            # -- C: a diverging candidate rolls back by itself -------------
            t0 = time.perf_counter()
            perm = np.random.default_rng(SEED + 53).permutation(N_ITEMS)
            iid_c = persist_models([recommendation_model_from_numpy(
                users_b, items_b[perm], user_ids, item_ids, device=dev)],
                ep, storage, engine_id, version, vname,
                engine_factory=FACTORY)
            seconds["persist_c"] = time.perf_counter() - t0
            status, body, _ = _post(
                port, f"/rollout/deploy{key}",
                {"instanceId": iid_c, "pct": SR_BREACH_PCT,
                 "shadowEvery": 1, "checkEvery": 1})
            if status != 200:
                raise AssertionError(f"C's canary: {status} {body}")
            pool = [u for u in user_ids[:SR_BREACH_MAX_QUERIES * 4]
                    if canary(u, SR_BREACH_PCT)][:SR_BREACH_MAX_QUERIES]
            sent, statuses = 0, []
            while sent < len(pool):
                res = load(port, [{"user": u, "num": 10}
                                  for u in pool[sent:sent + SR_CLIENTS]],
                           SR_CLIENTS)
                statuses += res["statuses"]
                sent += SR_CLIENTS
                _, st = _get(port, "/rollout/status")
                if st["verdict"] is not None:
                    break
            rec = load_record(storage, iid_c)
            out["breach"] = {"queries": sent,
                             "non_200": sum(s != 200 for s in statuses),
                             "verdict": st["verdict"],
                             "reason": st["reason"],
                             "shadow": st["shadow"], "arms": st["arms"],
                             "record": rec.verdict if rec else None}
            if (st["verdict"] != VERDICT_ROLLED_BACK
                    or "divergence" not in st["reason"]
                    or out["breach"]["record"] != VERDICT_ROLLED_BACK
                    or out["breach"]["non_200"]):
                raise AssertionError(f"breach: {out['breach']}")
            status, body, reload_s = _post(port, f"/reload{key}", {})
            out["breach"]["reload"] = {"status": status, "s": reload_s,
                                       "instance": body.get(
                                           "engineInstanceId")}
            if status != 200 or body.get("engineInstanceId") != iid_b:
                raise AssertionError(f"/reload after the breach: {body}")
            _post_raw(port, "/queries.json", warm)
            quiet_counts(port, 1.5)
            out["breach"]["after_reload"] = arm_load(
                port, check_q, fresh["B"])
            seconds["breach"] = time.perf_counter() - t0

            # -- A canaried again at 25 % with shadow scoring every 10th
            # query and with none, in alternated pairs, each canary ended
            # by a rollback (the last by the verb) ------------------------
            t0 = time.perf_counter()
            runs = []
            for n, every in enumerate(SR_SHADOW_ORDER):
                status, body, _ = _post(
                    port, f"/rollout/deploy{key}",
                    {"instanceId": iid_a, "pct": SR_PCT,
                     "shadowEvery": every})
                if status != 200:
                    raise AssertionError(f"A's canary: {status} {body}")
                run = arm_load(port, queries,
                               expect(SR_PCT, fresh["A"], fresh["B"]))
                if n == len(SR_SHADOW_ORDER) - 1:
                    res, cli_s = pio_cli(proc_env, "rollback", "--port",
                                         str(port), "--server-key", SB_KEY,
                                         "--reason", "smoke")
                    st = res["rollout"]
                    run["rollback_cli_s"] = cli_s
                else:
                    status, body, _ = _post(port, f"/rollout/rollback{key}",
                                            {"reason": "smoke"})
                    st = body["rollout"]
                run.update({"shadow_every": every, "verdict": st["verdict"],
                            "reason": st["reason"]})
                runs.append(run)
                if (st["verdict"] != VERDICT_ROLLED_BACK
                        or st["reason"] != "smoke"):
                    raise AssertionError(f"rollback: {st}")
                if (run["shadow_samples"] == 0) != (every == 0):
                    raise AssertionError(f"shadow samples: {run}")
            out["shadow_cost"] = shadow_cost(runs)
            out["after_rollback"] = arm_load(port, check_q, fresh["B"])
            seconds["shadow_cost"] = time.perf_counter() - t0

            # -- the auto ramp under load ------------------------------------
            t0 = time.perf_counter()
            out["auto_ramp"] = auto_ramp(proc_env, port, iid_a, user_ids)
            seconds["auto_ramp"] = time.perf_counter() - t0

            # -- the second deploy: feedback events, /profile/* ----------
            t0 = time.perf_counter()
            fb = queries[:SR_FEEDBACK_QUERIES]
            res = load(fport, fb, SR_CLIENTS)
            events: list = []
            t1 = time.perf_counter()
            while time.perf_counter() - t1 < 30:
                events = list(storage.get_events().find(
                    app_id, entity_type="pio_pr", limit=-1))
                if len(events) >= SR_FEEDBACK_QUERIES:
                    break
                time.sleep(0.05)
            out["feedback"] = {
                "queries": len(fb), "events": len(events),
                "event_wait_s": time.perf_counter() - t1,
                "predict_events": sum(e.event == "predict"
                                      for e in events),
                "non_200": sum(s != 200 for s in res["statuses"])}
            if (out["feedback"]["predict_events"] != SR_FEEDBACK_QUERIES
                    or len(events) != SR_FEEDBACK_QUERIES
                    or out["feedback"]["non_200"]):
                raise AssertionError(f"feedback: {out['feedback']}")
            logdir = tmp / "profile"
            status, body, start_s = _post(
                fport, f"/profile/start{key}&logdir={logdir}", {})
            again, _, _ = _post(fport, f"/profile/start{key}", {})
            profiled = load(fport, queries[:SR_PROFILED_QUERIES], SR_CLIENTS)
            stop_status, _, stop_s = _post(fport, f"/profile/stop{key}", {})
            traces = sorted(logdir.glob("*.pt.trace.json"))
            text = traces[0].read_text() if traces else ""
            out["profile"] = {"start": status, "second_start": again,
                              "stop": stop_status, "start_s": start_s,
                              "queries_s": profiled["wall_s"],
                              "stop_s": stop_s, "trace_bytes": len(text),
                              "names_k7": "quantized_scan_kernel" in text}
            if (status, again, stop_status) != (200, 409, 200) or \
                    not out["profile"]["names_k7"]:
                raise AssertionError(f"profile: {out['profile']}")
            seconds["feedback_profile"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            for p in (port, fport):
                _post(p, f"/stop{key}", {})
            exits = []
            for proc in procs:
                try:
                    exits.append(proc.wait(timeout=30))
                except subprocess.TimeoutExpired:
                    exits.append(None)
            seconds["stop"] = time.perf_counter() - t0
            logs_text = [lg.read_text() for lg in logs]
            out["deploy_exits"] = exits
            out["shadow_failures"] = sum(
                t.count("shadow scoring failed") for t in logs_text)
            if out["shadow_failures"] or exits != [0, 0]:
                raise AssertionError(
                    f"deploys: exits {exits}, shadow failures "
                    f"{out['shadow_failures']}")
    except BaseException as e:
        out["failed"] = f"{type(e).__name__}: {e}"[:2000]
        raise
    finally:
        for proc in procs:
            if proc.poll() is None:
                stop_process(proc)
        for o in oracles.values():
            o.close()
        if storage is not None:
            storage.close()
        out["seconds"] = {**seconds,
                          "phase": time.perf_counter() - t_phase}
        emit("serve_rollout", **out)
    return out


def shadow_cost(runs: list) -> dict:
    """A's canary loads by their ``shadowEvery``: each load, and for each
    setting the median and the range of queries/s, p50 and p99, the
    shadow samples and the shadow thread's busy seconds; and the loss of
    queries/s with shadow scoring on (one minus the ratio of medians)."""
    keys = ("queries_per_s", "p50_ms", "p99_ms", "shadow_samples",
            "shadow_busy_s")
    by: dict = {}
    for run in runs:
        by.setdefault(run["shadow_every"], []).append(run)
    out: dict = {"order": [r["shadow_every"] for r in runs],
                 "runs": [{k: r[k] for k in ("shadow_every", *keys,
                                             "shadow_max_s_so_far",
                                             "dispatches", "hedged")}
                          for r in runs]}
    for every, rs in sorted(by.items()):
        out[f"shadow_every_{every}"] = {
            k: {"median": float(np.median([r[k] for r in rs])),
                "min": min(r[k] for r in rs), "max": max(r[k] for r in rs)}
            for k in keys}
    on, off = (out[f"shadow_every_{e}"]["queries_per_s"]["median"]
               for e in (10, 0))
    out["queries_per_s_loss"] = 1.0 - on / off
    return out


def auto_ramp(env: dict, port: int, iid: str, user_ids: list) -> dict:
    """``deploy --canary auto`` of ``iid`` while SR_CLIENTS threads query
    distinct seeded users: the stages it passes through within
    SR_RAMP_WAIT_S, which must be every stage of SR_RAMP_STAGES with no
    verdict, then ``rollback``."""
    import threading

    pool = [user_ids[i] for i in np.random.default_rng(SEED + 59)
            .permutation(len(user_ids))[:SR_RAMP_USERS]]
    stop = threading.Event()
    sent = {"n": 0, "non_200": 0}
    lock = threading.Lock()

    def hammer(w: int) -> None:
        i = w
        while not stop.is_set():
            status, _, _ = _post_raw(port, "/queries.json",
                                     {"user": pool[i % len(pool)],
                                      "num": 10})
            i += SR_CLIENTS
            with lock:
                sent["n"] += 1
                sent["non_200"] += status != 200

    threads = [threading.Thread(target=hammer, args=(w,))
               for w in range(SR_CLIENTS)]
    for t in threads:
        t.start()
    stages: list = []
    try:
        res, cli_s = pio_cli(
            env, "deploy", "--canary", "auto", "--engine-instance-id", iid,
            "--canary-min-stage-seconds", str(SR_RAMP["min_stage_seconds"]),
            "--canary-min-stage-samples", str(SR_RAMP["min_stage_samples"]),
            "--port", str(port), "--server-key", SB_KEY)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < SR_RAMP_WAIT_S:
            _, st = _get(port, "/rollout/status")
            if not stages or stages[-1]["pct"] != st["stagePct"]:
                stages.append({"pct": st["stagePct"],
                               "at_s": time.perf_counter() - t0})
            if st["verdict"] is not None or st["stagePct"] == 100:
                break
            time.sleep(0.05)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=120)
    _, before = _get(port, "/rollout/status")
    res, rb_s = pio_cli(env, "rollback", "--port", str(port),
                        "--server-key", SB_KEY, "--reason", "smoke ramp")
    out = {"cli_s": cli_s, "stages": stages, "queries": sent["n"],
           "non_200": sent["non_200"],
           "verdict_before_rollback": before["verdict"],
           "reason_before_rollback": before["reason"],
           "guards": before["guards"], "rollback_cli_s": rb_s,
           "verdict": res["rollout"]["verdict"]}
    # a healthy candidate climbs every stage of the ladder with no verdict
    if (sent["non_200"] or res["rollout"]["verdict"] is None
            or [s["pct"] for s in stages] != list(SR_RAMP_STAGES)
            or before["verdict"] is not None):
        raise AssertionError(f"auto ramp: {out}")
    return out


# -- phase 3d: the sharded, replicated fleet ----------------------------------

SF_QUERIES = 512           # /queries.json of distinct users a load
SF_CLIENTS = 16            # client threads posting them at once
SF_SHARDS, SF_REPLICAS = 2, 2
SF_ENGINE = "chip-smoke-fleet"
SF_APP = "chip-smoke-fleet"
# the serve cell's clustered block, with C 256 on each shard's slice
SF_RETRIEVAL = {**RETRIEVAL, "n_clusters": 256, "nprobe": 32,
                "rerank_k": 1024}
SF_RESHARD_CLIENTS = 4     # threads querying through the reshard
SF_DRILL_CLIENTS = 4       # threads querying through the shard kills
SF_FOLDIN_USERS = 64       # new users folded in through the router
SF_FOLDIN_EVENTS = 16      # rate events each
SF_CANARY_PCT = 25
SF_CANARY_QUERIES = 128
SF_NOISE = 1e-3            # the canary: A + SF_NOISE x N(0, 1)
# item-table widths whose exact-route scores are held to the whole
# table's: a shard's slice at 2 and 3 shards, and narrow ones
SF_COLUMN_WIDTHS = (1, 100, 333, 8_915, 13_372)
SF_BOOT_TIMEOUT_S = 300
# K7 held to its plain version on each shard's own index, at the rows a
# shard's scan dispatch takes (solo, and coalesced groups)
SF_SHARD_SCAN_BATCHES = (1, 2, 3, 4)
# the standalone clustered shard process (``--retrieval-impl pallas``;
# the shard command sets no cluster count, so the auto one)
SF_STANDALONE_QUERIES = 64
SF_STANDALONE = {"mode": "clustered", "dtype": "int8",
                 "nprobe": SF_RETRIEVAL["nprobe"],
                 "rerank_k": SF_RETRIEVAL["rerank_k"], "impl": "pallas"}


def wait_fleet(proc, log: Path, t0_wall: float) -> tuple[float, list]:
    """(seconds from ``t0_wall`` until the fleet verb printed its shard
    endpoints, the endpoints by shard)."""
    while time.time() - t0_wall < SF_BOOT_TIMEOUT_S:
        lines = log.read_text().splitlines()
        shards = [ln.split(":", 1)[1].split() for ln in lines
                  if ln.startswith("  shard ")]
        if len(shards) == SF_SHARDS:
            return log.stat().st_mtime - t0_wall, shards
        if proc.poll() is not None:
            raise AssertionError(f"fleet exited {proc.returncode}: "
                                 f"{log.read_text()[-3000:]}")
        time.sleep(0.05)
    raise AssertionError(f"fleet not up in {SF_BOOT_TIMEOUT_S} s")


def shard_proc(env: dict, log: Path, shard_index: int, n_shards: int,
               port: int, iid: str, join: bool = False,
               flags: tuple = ()) -> subprocess.Popen:
    """``python -m pio_tpu_torch.serving_fleet shard`` as a process."""
    argv = [sys.executable, "-m", "pio_tpu_torch.serving_fleet", "shard",
            "--shard-index", str(shard_index), "--n-shards", str(n_shards),
            "--engine-id", SF_ENGINE, "--instance-id", iid, "--port",
            str(port), "--server-key", SB_KEY, *flags]
    if join:
        argv.append("--join-reshard")
    with open(log, "w") as out:
        return subprocess.Popen(argv, cwd=REPO_ROOT, env=env, stdout=out,
                                stderr=subprocess.STDOUT, text=True)


def wait_ready(port: int, proc, timeout: float = SF_BOOT_TIMEOUT_S) -> float:
    """Seconds until the server on ``port`` answers /readyz 200."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        try:
            if _get(port, "/readyz")[0] == 200:
                return time.perf_counter() - t0
        except OSError:
            pass
        if proc is not None and proc.poll() is not None:
            raise AssertionError(f"server on {port} exited "
                                 f"{proc.returncode}")
        time.sleep(0.1)
    raise AssertionError(f"server on {port} not ready in {timeout} s")


def _port_of(url: str) -> int:
    return int(url.rsplit(":", 1)[1])


def fleet_counts(endpoints: list) -> dict:
    """The fleet process's K7 launches (the shards of one process share
    the count, so it is read from one of them) and every shard's scoring
    dispatches by route, summed."""
    k7, scan, exact = None, 0, 0
    for group in endpoints:
        for url in group:
            _, m = _get(_port_of(url), "/metrics.json")
            k7 = m["kernelLaunches"]["quantized_scan"]
            scan += m["scoringDispatches"]["scan"]
            exact += m["scoringDispatches"]["exact"]
    return {"k7": k7, "scan": scan, "exact": exact}


def column_bits(model, dev: torch.device) -> dict:
    """The exact route's scores of an item-table slice of each width in
    SF_COLUMN_WIDTHS against the whole table's for the same items, for
    64 users: columns whose bits differ, with the route's column floor
    (``ops.bucketing.MIN_SCORING_COLUMNS``) and without it."""
    from pio_tpu_torch.ops import als

    rng = np.random.default_rng(SEED + 47)
    uidx = rng.choice(N_USERS, 64, replace=False)
    itf = model.factors.item_factors
    full = (model.factors.user_factors[torch.as_tensor(uidx, device=dev)]
            @ itf.T)
    floor = als.MIN_SCORING_COLUMNS
    out: dict = {}
    for width in SF_COLUMN_WIDTHS:
        cols = torch.as_tensor(np.sort(rng.choice(N_ITEMS, width,
                                                  replace=False)),
                               device=dev)
        for name, cols_floor in (("floor", floor), ("no_floor", 0)):
            als.MIN_SCORING_COLUMNS = cols_floor
            try:
                s, i = als.recommend_topk(
                    als.ALSModel(model.factors.user_factors, itf[cols]),
                    uidx, width)
            finally:
                als.MIN_SCORING_COLUMNS = floor
            want = torch.gather(full[:, cols], 1, i)
            out.setdefault(name, {})[str(width)] = int((s != want).sum())
    return out


def shard_scan_kernel(parts: list, users: np.ndarray, rows: np.ndarray,
                      dev: torch.device) -> dict:
    """K7 held to its plain version at the fleet's shapes: each shard's
    index built as its process builds it (``_prepare_arm`` on its
    partition with SF_RETRIEVAL), at SF_SHARD_SCAN_BATCHES users; and the
    fleet's top 10 of the users ``rows`` through the plain scan on the
    same indexes, merged by score as the router merges."""
    from pio_tpu_torch.ops.retrieval import RetrievalParams, candidate_topk
    from pio_tpu_torch.serving_fleet.shard import _prepare_arm

    params = RetrievalParams.from_config(SF_RETRIEVAL)
    cases = []
    merged: list = [[] for _ in rows]
    for s, part in enumerate(parts):
        arm = _prepare_arm(part, params, dev)
        didx = arm.retrieval[1]
        for b in SF_SHARD_SCAN_BATCHES:
            u = torch.from_numpy(users[rows[:b]]).to(dev)
            cases.append({"shard": s, "items": len(part.item_ids),
                          **scan_case(didx, u, min(params.nprobe,
                                                   didx.n_clusters))})
            emit("scan_kernel", **cases[-1])
        plain = replace(didx, params=replace(didx.params, impl="xla"))
        scores, gidx = candidate_topk(plain, arm.item_factors_dev,
                                      users[rows], 10)
        for m, sc, gi in zip(merged, scores, gidx):
            m += [(float(x), part.item_ids[g]) for x, g in zip(sc, gi)
                  if g >= 0]
        del arm, didx, plain
    top = [[i for _, i in sorted(m, key=lambda t: -t[0])[:10]]
           for m in merged]
    return {"cases": cases, "plain_top10": top}


def standalone_flags(block: dict) -> list:
    """The shard command's flags for a retrieval block."""
    return ["--retrieval-mode", block["mode"], "--retrieval-dtype",
            block["dtype"], "--retrieval-nprobe", str(block["nprobe"]),
            "--retrieval-rerank-k", str(block["rerank_k"]),
            "--retrieval-impl", block["impl"]]


def standalone_shard(port: int, proc, part, users: np.ndarray,
                     rows: np.ndarray, dev: torch.device) -> dict:
    """The clustered shard process started with SF_STANDALONE's flags
    (its own k-means, at the auto cluster count): SF_STANDALONE_QUERIES
    users' ``/shard/candidates``, each answered, each the answer of K7 in
    this process on the index built from the same block, K7 launched
    once a scan dispatch of the process (its warm one included), and
    recall@10 against the exact top 10 of its partition."""
    from pio_tpu_torch.ops.retrieval import RetrievalParams, candidate_topk
    from pio_tpu_torch.serving_fleet.shard import _prepare_arm

    out = {"ready_wait_s": wait_ready(port, proc)}
    _, info = _get(port, "/shard/info")
    out["retrieval"] = {k: info["retrieval"][k]
                        for k in ("mode", "dtype", "nprobe", "impl")}
    _, before = _get(port, "/metrics.json")
    rows = rows[:SF_STANDALONE_QUERIES]
    answers = [_post(port, "/shard/candidates",
                     {"row": users[r].tolist(), "k": 10}) for r in rows]
    _, after = _get(port, "/metrics.json")
    stop_process(proc)
    arm = _prepare_arm(part, RetrievalParams.from_config(SF_STANDALONE), dev)
    here = []
    for r in rows:
        scores, lidx = candidate_topk(arm.retrieval[1], arm.item_factors_dev,
                                      users[r][None, :], 10)
        keep = lidx[0] >= 0
        here.append(([part.item_ids[int(i)] for i in lidx[0][keep]],
                     [float(x) for x in scores[0][keep]]))
    out["n_clusters"] = arm.retrieval[1].n_clusters
    del arm
    item_rows = torch.from_numpy(part.item_rows).to(dev)
    best = torch.topk(torch.from_numpy(users[rows]).to(dev) @ item_rows.T,
                      10).indices.cpu().numpy()
    exact = [{part.item_ids[i] for i in row} for row in best]
    out.update({
        "queries": len(rows),
        "non_200": sum(st != 200 for st, _, _ in answers),
        "k7_launches": after["kernelLaunches"]["quantized_scan"],
        "scan_dispatches": after["scoringDispatches"]["scan"],
        "exact_dispatches": after["scoringDispatches"]["exact"],
        "scans_of_the_queries": (after["scoringDispatches"]["scan"]
                                 - before["scoringDispatches"]["scan"]),
        "differ_from_in_process": sum(
            st != 200 or (b["items"], b["scores"]) != h
            for (st, b, _), h in zip(answers, here)),
        "recall_at_10": sum(len(set(b.get("items", ())) & e) for (_, b, _), e
                            in zip(answers, exact)) / (10 * len(rows)),
        "p50_ms": statistics.median(1e3 * dt for _, _, dt in answers)})
    return out


def drill_group(env: dict, tmp: Path, iid: str) -> tuple[list, dict]:
    """(ports by shard, processes by (shard, replica)) of the drill's
    2 x 2 shard processes, started."""
    ports = [[free_port() for _ in range(SF_REPLICAS)]
             for _ in range(SF_SHARDS)]
    return ports, {(s, r): shard_proc(env, tmp / f"drill_{s}{r}.log", s,
                                      SF_SHARDS, ports[s][r], iid)
                   for s in range(SF_SHARDS) for r in range(SF_REPLICAS)}


def fleet_drill(env: dict, tmp: Path, storage, dev: torch.device, iid: str,
                plan, ports: list, procs: dict, users: list,
                want: dict) -> dict:
    """The 2 x 2 shard processes on ``ports`` behind a router in this
    process, SF_DRILL_CLIENTS threads querying throughout: SIGKILL shard
    0's first replica (every answer 200, none degraded, each the single
    host's), then both of shard 1's, restarting one at once (no 5xx,
    degraded answers flagged until it is back), then full service."""
    import threading

    from pio_tpu_torch.serving_fleet.router import (
        RouterConfig,
        create_fleet_router,
    )

    # the router logs each failed replica call: thousands in a drill
    quiet = logging.getLogger("pio_tpu_torch.fleet.router")
    level = quiet.level
    quiet.setLevel(logging.ERROR)
    router = router_http = None
    stop = threading.Event()
    stage = {"name": "healthy"}
    seen: list = []
    lock = threading.Lock()
    out: dict = {}
    try:
        out["boot_left_s"] = max(wait_ready(ports[s][r], procs[(s, r)])
                                 for s in range(SF_SHARDS)
                                 for r in range(SF_REPLICAS))
        router_http, router = create_fleet_router(
            storage, RouterConfig(
                engine_id=SF_ENGINE, breaker_min_calls=2,
                breaker_open_s=0.5, probe_interval_s=0.2, device=str(dev)),
            plan,
            [[f"http://127.0.0.1:{p}" for p in group] for group in ports])
        router_http.start()
        rport = router_http.port

        def hammer(w: int) -> None:
            i = w
            while not stop.is_set():
                u = users[i % len(users)]
                try:
                    status, raw, _ = _post_raw(rport, "/queries.json",
                                               {"user": u, "num": 10})
                except OSError:        # a reset or refused connection
                    status, raw = 0, b""
                i += SF_DRILL_CLIENTS
                body = json.loads(raw) if status == 200 else {}
                with lock:
                    seen.append((stage["name"], status,
                                 bool(body.get("degraded")),
                                 raw == want[u], w))

        threads = [threading.Thread(target=hammer, args=(w,))
                   for w in range(SF_DRILL_CLIENTS)]
        for t in threads:
            t.start()
        time.sleep(0.5)
        stage["name"] = "replica_killed"
        procs[(0, 0)].kill()
        time.sleep(1.5)
        stage["name"] = "shard_down"
        t0 = time.perf_counter()
        for r in range(SF_REPLICAS):
            procs[(1, r)].kill()
        for r in range(SF_REPLICAS):
            procs[(1, r)].wait(timeout=60)
        procs[(1, 0)] = shard_proc(env, tmp / "drill_10b.log", 1, SF_SHARDS,
                                   ports[1][0], iid)
        out["restart_ready_s"] = wait_ready(ports[1][0], procs[(1, 0)])
        stage["name"] = "recovering"
        while time.perf_counter() - t0 < 120:
            status, raw, _ = _post_raw(rport, "/queries.json",
                                       {"user": users[0], "num": 10})
            if status == 200 and not json.loads(raw).get("degraded"):
                break
            time.sleep(0.05)
        out["recovered_s"] = time.perf_counter() - t0
        stage["name"] = "recovered"
        time.sleep(1.0)
        stop.set()
        for t in threads:
            t.join(timeout=120)
    finally:
        stop.set()
        quiet.setLevel(level)
        if router_http is not None:
            router_http.stop()
            router.close()
        for p in procs.values():
            if p.poll() is None:
                stop_process(p)
    for name in ("healthy", "replica_killed", "shard_down", "recovering",
                 "recovered"):
        rows = [r for r in seen if r[0] == name]
        out[name] = {
            "queries": len(rows),
            "workers": len({w for *_, w in rows}),
            "non_200": sum(s != 200 for _, s, *_ in rows),
            "server_errors": sum(s >= 500 for _, s, *_ in rows),
            "connection_errors": sum(s == 0 for _, s, *_ in rows),
            "degraded": sum(d for _, _, d, *_ in rows),
            "differ_from_single_host": sum(
                not same for _, s, d, same, _ in rows
                if s == 200 and not d)}
    return out


def join_group(env: dict, tmp: Path, iid: str) -> tuple[list, list]:
    """(ports, processes) of the shard group a grow to SF_SHARDS + 1
    adds: join-reshard shard processes, empty until slices are staged."""
    ports = [free_port() for _ in range(SF_REPLICAS)]
    return ports, [shard_proc(env, tmp / f"join_{r}.log", SF_SHARDS,
                              SF_SHARDS + 1, p, iid, join=True)
                   for r, p in enumerate(ports)]


def reshard_under_load(env: dict, port: int, join_ports: list, procs: list,
                       users: list, want: dict) -> dict:
    """``python -m pio_tpu_torch reshard --shards 3`` of the fleet on
    ``port`` onto the join group on ``join_ports``, with
    SF_RESHARD_CLIENTS threads querying throughout: every answer 200 and
    the single host's byte for byte, before, during and after."""
    import threading

    stop = threading.Event()
    stage = {"name": "before"}
    seen: list = []
    lock = threading.Lock()
    out: dict = {}
    try:
        # what is left of the join group's boot after the drill
        out["join_ready_wait_s"] = max(wait_ready(p, proc)
                                       for p, proc in zip(join_ports, procs))

        def hammer(w: int) -> None:
            i = w
            while not stop.is_set():
                u = users[i % len(users)]
                try:
                    status, raw, _ = _post_raw(port, "/queries.json",
                                               {"user": u, "num": 10})
                except OSError:        # a reset or refused connection
                    status, raw = 0, b""
                i += SF_RESHARD_CLIENTS
                with lock:
                    seen.append((stage["name"], status, raw == want[u], w))

        threads = [threading.Thread(target=hammer, args=(w,))
                   for w in range(SF_RESHARD_CLIENTS)]
        for t in threads:
            t.start()
        try:
            time.sleep(0.5)
            stage["name"] = "during"
            t0 = time.perf_counter()
            res = subprocess.run(
                [sys.executable, "-m", "pio_tpu_torch", "reshard",
                 "--shards", str(SF_SHARDS + 1), "--endpoint",
                 ",".join(f"http://127.0.0.1:{p}" for p in join_ports),
                 "--port", str(port), "--server-key", SB_KEY],
                cwd=REPO_ROOT, env=env, capture_output=True, text=True,
                timeout=300)
            out["reshard_s"] = time.perf_counter() - t0
            stage["name"] = "after"
            time.sleep(0.5)
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=120)
        out["verb_rc"] = res.returncode
        out["verb_tail"] = res.stdout.strip().splitlines()[-1:]
        _, fs = _get(port, "/fleet.json")
        out["plan"] = {k: fs["plan"][k] for k in ("nShards", "planVersion")}
        _, st = _get(port, f"/reshard/status?accessKey={SB_KEY}")
        out["partitions_moved"] = st.get("partitionsMoving")
        out["verdict"] = st.get("verdict")
        # after the cutover, every picked user again
        after = [(_post_raw(port, "/queries.json", {"user": u, "num": 10}),
                  u) for u in users[:128]]
        out["after_differ"] = sum(r[1] != want[u] or r[0] != 200
                                  for r, u in after)
    finally:
        for proc in procs:
            if proc.poll() is None:
                stop_process(proc)
    out["queries"] = len(seen)
    out["non_200"] = sum(s != 200 for _, s, _, _ in seen)
    out["server_errors"] = sum(s >= 500 for _, s, _, _ in seen)
    out["connection_errors"] = sum(s == 0 for _, s, _, _ in seen)
    out["differ_from_single_host"] = sum(not same for _, s, same, _ in seen
                                         if s == 200)
    # every worker answered before, during and after the verb
    out["workers"] = {name: len({w for n, *_, w in seen if n == name})
                      for name in ("before", "during", "after")}
    if res.returncode != 0:
        raise AssertionError(f"reshard: rc {res.returncode} {res.stderr}")
    return out


def start_fleet_foldin(env: dict, tmp: Path, storage, engine_dir: Path,
                       port: int) -> dict:
    """SF_FOLDIN_USERS new users' rate events in the store (none of them
    known to the fleet on ``port``), then ``python -m pio_tpu_torch
    foldin --router-url --once --replay`` started on them; finished by
    ``finish_fleet_foldin``."""
    from pio_tpu_torch.data.dao import App
    from pio_tpu_torch.data.event import Event
    from pio_tpu_torch.utils.time import utcnow

    rng = np.random.default_rng(SEED + 45)
    app_id = storage.get_metadata_apps().insert(App(0, SF_APP))
    ev = storage.get_events()
    ev.init(app_id)
    new_users = [f"fleet-new-{i}" for i in range(SF_FOLDIN_USERS)]
    now = utcnow()
    ev.insert_batch([
        Event("rate", "user", u, "item", f"i{it}",
              {"rating": float(rng.integers(1, 6))}, now)
        for u in new_users
        for it in rng.choice(N_ITEMS, SF_FOLDIN_EVENTS, replace=False)],
        app_id)
    before = [_post(port, "/queries.json", {"user": u, "num": 10})[1]
              for u in new_users[:4]]
    log = tmp / "foldin.log"
    with open(log, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "pio_tpu_torch", "foldin",
             "--engine-dir", str(engine_dir), "--router-url",
             f"http://127.0.0.1:{port}", "--server-key", SB_KEY, "--once",
             "--replay", "--state-path", str(tmp / "foldin.cursor")],
            cwd=REPO_ROOT, env=env, stdout=out, stderr=subprocess.DEVNULL,
            text=True)
    return {"proc": proc, "log": log, "t0": time.perf_counter(),
            "users": new_users, "before": before, "port": port}


def finish_fleet_foldin(started: dict, endpoints: list) -> dict:
    """The fold-in verb's stats once it exits; each new user then served
    through the router, its row the same on both replicas of its owner
    group."""
    from pio_tpu_torch.serving_fleet.plan import shard_of

    proc, port = started["proc"], started["port"]
    rc = proc.wait(timeout=300)
    verb_s = time.perf_counter() - started["t0"]
    printed = started["log"].read_text().strip().splitlines()
    if rc != 0:
        raise AssertionError(f"foldin: rc {rc} {printed[-5:]}")
    stats = json.loads(printed[-1])
    new_users = started["users"]
    served = [_post(port, "/queries.json", {"user": u, "num": 10})
              for u in new_users]
    rows_differ = 0
    for u in new_users:
        rows = [_post(_port_of(url), "/shard/user_row", {"user": u})[1]
                for url in endpoints[shard_of(u, SF_SHARDS)]]
        rows_differ += any(not r.get("found") or r["row"] != rows[0]["row"]
                           for r in rows)
    out = {"users": SF_FOLDIN_USERS,
           "events": SF_FOLDIN_USERS * SF_FOLDIN_EVENTS, "verb_s": verb_s,
           "folded": stats.get("folded"),
           "stats": {k: stats.get(k) for k in (
               "windowRows", "touched", "folded", "skipped", "queueDepth",
               "appliedBatches", "lastFoldStalenessSeconds")},
           "answered_before": sum(bool(b["itemScores"])
                                  for b in started["before"]),
           "answered_after": sum(s == 200 and len(b["itemScores"]) == 10
                                 for s, b, _ in served),
           "replica_rows_differ": rows_differ}
    if (out["folded"] != SF_FOLDIN_USERS or out["answered_before"]
            or out["answered_after"] != SF_FOLDIN_USERS or rows_differ):
        raise AssertionError(f"fleet fold-in: {out}")
    return out


def fleet_canary(env: dict, storage, engine, ep, users: np.ndarray,
                 items: np.ndarray, dev: torch.device, port: int,
                 picked: list) -> dict:
    """A canary instance D (A plus seeded noise) at SF_CANARY_PCT % of the
    users through ``deploy --canary`` against the router, SF_CANARY_QUERIES
    queries through it, then ``promote``: the fleet's plan is D's."""
    from pio_tpu_torch.convert import recommendation_model_from_numpy
    from pio_tpu_torch.rollout import in_canary
    from pio_tpu_torch.workflow.train import persist_models

    out: dict = {}
    noise = np.random.default_rng(SEED + 49)
    t0 = time.perf_counter()
    iid_d = persist_models([recommendation_model_from_numpy(
        users + np.float32(SF_NOISE) * noise.standard_normal(
            users.shape, dtype=np.float32),
        items + np.float32(SF_NOISE) * noise.standard_normal(
            items.shape, dtype=np.float32),
        [f"u{i}" for i in range(N_USERS)], [f"i{i}" for i in range(N_ITEMS)],
        device=dev)], ep, storage, SF_ENGINE, engine_factory=FACTORY)
    out["persist_s"] = time.perf_counter() - t0
    st, out["canary_verb_s"] = pio_cli(
        env, "deploy", "--canary", str(SF_CANARY_PCT),
        "--engine-instance-id", iid_d, "--ip", "127.0.0.1", "--port",
        str(port), "--server-key", SB_KEY)
    out["stage_pct"] = st["rollout"]["stagePct"]
    qs = [{"user": u, "num": 10} for u in picked[:SF_CANARY_QUERIES]]
    res = load(port, qs, SF_CLIENTS)
    _, status = _get(port, "/rollout/status")
    out.update({k: v for k, v in res.items()
                if k not in ("bodies", "statuses")})
    out["non_200"] = sum(s != 200 for s in res["statuses"])
    out["requests"] = {arm: status["arms"][arm]["requests"]
                       for arm in ("active", "candidate")}
    out["canary_users"] = sum(in_canary(q["user"], SF_CANARY_PCT)
                              for q in qs)
    st, out["promote_verb_s"] = pio_cli(
        env, "promote", "--ip", "127.0.0.1", "--port", str(port),
        "--server-key", SB_KEY)
    out["verdict"] = st["rollout"]["verdict"]
    _, fs = _get(port, "/fleet.json")
    out["plan_instance_is_candidate"] = fs["plan"]["instanceId"] == iid_d
    after = load(port, qs[:32], SF_CLIENTS)
    out["non_200_after_promote"] = sum(s != 200 for s in after["statuses"])
    if (out["stage_pct"] != SF_CANARY_PCT or out["non_200"]
            or out["requests"]["candidate"] != out["canary_users"]
            or out["verdict"] != "PROMOTED"
            or not out["plan_instance_is_candidate"]
            or out["non_200_after_promote"]):
        raise AssertionError(f"fleet canary: {out}")
    return out


def _fleet_loads(storage, dev: torch.device, mode: str, port: int, plan,
                 endpoints: list, queries: list) -> tuple[dict, dict,
                                                          dict]:
    """SF_QUERIES queries from SF_CLIENTS threads through the fleet's
    own router on ``port`` (coalescing) and through a router without
    coalescing over the same shards, in this process: (each side's
    numbers and raw bodies, the fleet's counts across both loads, the
    coalescer's stats)."""
    from pio_tpu_torch.serving_fleet.router import (
        RouterConfig,
        create_fleet_router,
    )

    plain_http, plain = create_fleet_router(
        storage, RouterConfig(engine_id=SF_ENGINE, server_key=SB_KEY,
                              retrieval_mode=mode, device=str(dev)),
        plan, endpoints)
    plain_http.start()
    ports = {"coalesced": port, "solo": plain_http.port}
    try:
        for side in ("solo", "coalesced"):
            for q in queries[:3]:              # the binary wire, confirmed
                _post_raw(ports[side], "/queries.json", q)
        # -- the main path: the fleet's counts just before ----------------
        before = fleet_counts(endpoints)
        res = {side: load(ports[side], queries, SF_CLIENTS)
               for side in ("solo", "coalesced")}
        after = fleet_counts(endpoints)
        # ------------------------------------------------------------------
        _, fs = _get(port, "/fleet.json")
        _, rm = _get(port, "/metrics.json")
        codecs = {"coalesced": rm["rpcCodecCounts"],
                  "solo": dict(plain.rpc_codec_counts)}
    finally:
        plain_http.stop()
        plain.close()
    for side, r in res.items():
        if set(r["statuses"]) != {200}:
            raise AssertionError(f"{mode} {side}: statuses "
                                 f"{set(r['statuses'])}")
        r["rpc_codecs"] = codecs[side]
    return res, {k: after[k] - before[k] for k in after}, fs["batching"]


def phase_serve_fleet(users: np.ndarray, items: np.ndarray,
                      dev: torch.device) -> dict:
    """The sharded, replicated fleet at the serve cell's shape, in a sqlite
    store of its own holding the seeded model as instance A: ``python -m
    pio_tpu_torch deploy --shards 2 --replicas 2 --coalesce-window-ms 2``
    in exact mode, then clustered (C 256 a shard, nprobe 32, K7), each
    under SF_QUERIES queries of distinct users from SF_CLIENTS threads
    through its router and through a router without coalescing over the
    same shards; exact bodies byte for byte the single-host deploy's,
    clustered recall@10 against the exact oracle, K7 launched once a
    shard's scan dispatch; shard processes killed and restarted under
    load; ``reshard --shards 3`` under load; ``foldin --router-url``; a
    canary and ``promote``. Both fleets, the drill's processes and the
    join group boot at once; the fold-in runs beside the reshard."""
    from pio_tpu_torch.__main__ import _engine_from_variant, _load_variant
    from pio_tpu_torch.convert import recommendation_model_from_numpy
    from pio_tpu_torch.data.storage import Storage
    from pio_tpu_torch.serving_fleet.plan import (
        load_partition,
        persist_fleet_artifacts,
    )
    from pio_tpu_torch.workflow.context import create_workflow_context
    from pio_tpu_torch.workflow.serve import ServingConfig, create_query_server
    from pio_tpu_torch.workflow.train import persist_models

    user_ids = [f"u{i}" for i in range(N_USERS)]
    item_ids = [f"i{i}" for i in range(N_ITEMS)]
    rng = np.random.default_rng(SEED + 41)
    picked_rows = rng.choice(N_USERS, SF_QUERIES, replace=False)
    picked = [user_ids[i] for i in picked_rows]
    queries = [{"user": u, "num": 10} for u in picked]
    out: dict = {"card": card_line(), "queries": SF_QUERIES,
                 "clients": SF_CLIENTS, "shards": SF_SHARDS,
                 "replicas": SF_REPLICAS, "retrieval": SF_RETRIEVAL}
    seconds: dict = {}
    loads: dict = {}
    counts: dict = {}
    with tempfile.TemporaryDirectory(prefix="pio_chip_fleet_") as tmp:
        tmp = Path(tmp)
        env = sqlite_env(tmp)
        proc_env = {**os.environ, **env, "PIO_TPU_HOME": str(tmp / "home")}
        dirs = {}
        for mode, block in (("exact", None), ("clustered", SF_RETRIEVAL)):
            params = {"rank": RANK, **({"retrieval": block} if block
                                       else {})}
            dirs[mode] = tmp / f"engine_{mode}"
            dirs[mode].mkdir()
            (dirs[mode] / "engine.json").write_text(json.dumps({
                "id": SF_ENGINE, "engineFactory": FACTORY,
                "datasource": {"params": {"app_name": SF_APP}},
                "algorithms": [{"name": "als", "params": params}]}))
        variant = _load_variant(str(dirs["exact"]))
        engine, ep = _engine_from_variant(variant, str(dirs["exact"]))
        storage = Storage(env=env)
        procs: dict = {}
        closers: list = []
        try:
            t0 = time.perf_counter()
            model = recommendation_model_from_numpy(
                users, items, user_ids, item_ids, device=dev)
            iid = persist_models([model], ep, storage, SF_ENGINE,
                                 engine_factory=FACTORY)
            seconds["persist"] = time.perf_counter() - t0
            # the plan and the partitions the verbs write too (the same
            # bytes), so the drill's shard processes can boot at once
            t0 = time.perf_counter()
            plan = persist_fleet_artifacts(storage, iid, model, SF_SHARDS,
                                           SF_REPLICAS)
            parts = [load_partition(storage, iid, s)
                     for s in range(SF_SHARDS)]
            seconds["partition"] = time.perf_counter() - t0

            # the single-host deploy: the exact bodies every fleet answer
            # is held to
            t0 = time.perf_counter()
            single_http, single = create_query_server(
                engine, ep, storage,
                ServingConfig(ip="127.0.0.1", port=0, engine_id=SF_ENGINE),
                ctx=create_workflow_context(storage, device=dev),
                instance_id=iid)
            single_http.start()
            closers += [single_http.stop, single.close]
            _post_raw(single_http.port, "/queries.json", queries[0])
            res = load(single_http.port, queries, SF_CLIENTS)
            if set(res["statuses"]) != {200}:
                raise AssertionError(f"single host: {res['statuses']}")
            want = dict(zip(picked, res["bodies"]))
            out["single_host"] = {k: v for k, v in res.items()
                                  if k not in ("bodies", "statuses")}
            out["column_bits"] = column_bits(model, dev)
            del model
            seconds["single_host"] = time.perf_counter() - t0

            # -- both verbs' fleets (each writes the plan and partitions
            # above again, the same bytes), the drill's 2 x 2 processes, the
            # grow's join group and a clustered shard process of its own
            # boot at once; K7 is held to its plain version meanwhile
            t0, t0_wall = time.perf_counter(), time.time()
            ports = {"exact": free_port(), "clustered": free_port()}
            for mode in ("exact", "clustered"):
                procs[mode] = deploy_proc(
                    proc_env, dirs[mode], ports[mode], iid,
                    tmp / f"fleet_{mode}.log",
                    ["--shards", str(SF_SHARDS), "--replicas",
                     str(SF_REPLICAS), "--coalesce-window-ms", "2"])
            drill_ports, drill_procs = drill_group(proc_env, tmp, iid)
            join_ports, join_procs = join_group(proc_env, tmp, iid)
            procs.update({f"drill{s}{r}": p
                          for (s, r), p in drill_procs.items()})
            procs.update({f"join{r}": p for r, p in enumerate(join_procs)})
            standalone_port = free_port()
            procs["standalone"] = shard_proc(
                proc_env, tmp / "standalone.log", 0, SF_SHARDS,
                standalone_port, iid, flags=standalone_flags(SF_STANDALONE))
            t1 = time.perf_counter()
            shard_scan = shard_scan_kernel(parts, users, picked_rows, dev)
            out["shard_scan"] = shard_scan["cases"]
            seconds["shard_scan"] = time.perf_counter() - t1
            out["exact_boot_s"], endpoints = wait_fleet(
                procs["exact"], tmp / "fleet_exact.log", t0_wall)
            seconds["exact_boot"] = time.perf_counter() - t0

            t0 = time.perf_counter()
            res, counts["exact"], batching = _fleet_loads(
                storage, dev, "exact", ports["exact"], plan, endpoints,
                queries)
            loads["exact"] = {"batching": batching}
            for side, r in res.items():
                loads["exact"][side] = {
                    **{k: v for k, v in r.items()
                       if k not in ("bodies", "statuses")},
                    "differ_from_single_host": sum(
                        b != want[u] for b, u in zip(r["bodies"], picked))}
            seconds["exact_loads"] = time.perf_counter() - t0

            t0 = time.perf_counter()
            out["drill"] = fleet_drill(proc_env, tmp, storage, dev, iid,
                                       plan, drill_ports, drill_procs,
                                       picked, want)
            seconds["drill"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            out["standalone"] = standalone_shard(
                standalone_port, procs["standalone"], parts[0], users,
                picked_rows, dev)
            del parts
            seconds["standalone"] = time.perf_counter() - t0
            # the clustered fleet is up before the reshard replaces the
            # stored plan its shards load
            out["clustered_boot_s"], clustered_endpoints = wait_fleet(
                procs["clustered"], tmp / "fleet_clustered.log", t0_wall)

            # the reshard of the exact fleet, and beside it the fold-in
            # through the clustered fleet's router (new users only)
            t0 = time.perf_counter()
            foldin = start_fleet_foldin(proc_env, tmp, storage,
                                        dirs["clustered"],
                                        ports["clustered"])
            procs["foldin"] = foldin["proc"]
            out["reshard"] = reshard_under_load(
                proc_env, ports["exact"], join_ports, join_procs, picked,
                want)
            seconds["reshard"] = time.perf_counter() - t0
            out["foldin"] = finish_fleet_foldin(foldin, clustered_endpoints)
            seconds["reshard_and_foldin"] = time.perf_counter() - t0
            stop_process(procs.pop("exact"))

            # -- clustered: K7 on every shard's own clusters
            t0 = time.perf_counter()
            res, counts["clustered"], batching = _fleet_loads(
                storage, dev, "clustered", ports["clustered"], plan,
                clustered_endpoints, queries)
            loads["clustered"] = {"batching": batching}
            for side, r in res.items():
                loads["clustered"][side] = {
                    k: v for k, v in r.items()
                    if k not in ("bodies", "statuses")}
            loads["clustered"]["coalesced"]["differ_from_solo"] = sum(
                a != b for a, b in zip(res["coalesced"]["bodies"],
                                       res["solo"]["bodies"]))
            got = [[s["item"] for s in json.loads(b)["itemScores"]]
                   for b in res["coalesced"]["bodies"]]
            exact = [[s["item"] for s in json.loads(want[u])["itemScores"]]
                     for u in picked]
            loads["clustered"]["recall_at_10"] = sum(
                len(set(g) & set(e)) for g, e in zip(got, exact)
            ) / sum(len(e) for e in exact)
            # the same shard indexes through the plain scan, in process
            loads["clustered"]["plain_scan_recall_at_10"] = sum(
                len(set(g) & set(e))
                for g, e in zip(shard_scan["plain_top10"], exact)
            ) / sum(len(e) for e in exact)
            seconds["clustered_loads"] = time.perf_counter() - t0

            t0 = time.perf_counter()
            out["canary"] = fleet_canary(
                proc_env, storage, engine, ep, users, items, dev,
                ports["clustered"], picked)
            seconds["canary"] = time.perf_counter() - t0
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    stop_process(proc)
            for close in closers:
                close()
            storage.close()
    out["loads"] = loads
    out["counts"] = counts
    out["seconds"] = seconds
    out["k7_launches"] = counts["clustered"]["k7"]
    out["scan_dispatches"] = counts["clustered"]["scan"]
    emit("serve_fleet", **out)
    failures = []
    for side in ("solo", "coalesced"):
        if loads["exact"][side]["differ_from_single_host"]:
            failures.append(f"exact {side}: bodies differ from the single "
                            "host's")
    if loads["clustered"]["coalesced"]["differ_from_solo"]:
        failures.append("clustered: coalesced bodies differ from solo")
    if loads["clustered"]["recall_at_10"] < RECALL_FLOOR:
        failures.append(f"clustered recall@10 "
                        f"{loads['clustered']['recall_at_10']}")
    if counts["clustered"]["k7"] != counts["clustered"]["scan"] or not \
            counts["clustered"]["scan"] or counts["clustered"]["exact"]:
        failures.append(f"K7 launches against dispatches: {counts}")
    if counts["exact"]["k7"] or counts["exact"]["scan"]:
        failures.append(f"exact mode launched the scan: {counts['exact']}")
    if any(loads[m][side]["rpc_codecs"].get("json") for m in loads
           for side in ("solo", "coalesced")):
        failures.append("the router fell back to the JSON wire")
    if any(not loads[m]["batching"]["coalescedCalls"] for m in loads):
        failures.append("the coalescing router batched nothing")
    if any(out["column_bits"]["floor"].values()):
        failures.append(f"column bits: {out['column_bits']}")
    st = out["standalone"]
    if (st["non_200"] or st["retrieval"]["impl"] != "pallas"
            or st["k7_launches"] != st["scan_dispatches"]
            or st["scans_of_the_queries"] != st["queries"]
            or st["exact_dispatches"] or st["differ_from_in_process"]):
        failures.append(f"standalone clustered shard: {st}")
    d = out["drill"]
    if (any(d[s]["server_errors"] or d[s]["connection_errors"]
            for s in d if isinstance(d[s], dict))
            or any(d[s]["workers"] != SF_DRILL_CLIENTS for s in (
                "healthy", "replica_killed", "shard_down", "recovered"))
            or d["replica_killed"]["degraded"]
            or d["replica_killed"]["non_200"]
            or d["replica_killed"]["differ_from_single_host"]
            or not d["shard_down"]["degraded"]
            or d["recovered"]["degraded"] or not d["recovered"]["queries"]):
        failures.append(f"drill: {d}")
    r = out["reshard"]
    if (r["non_200"] or r["differ_from_single_host"] or r["after_differ"]
            or any(n != SF_RESHARD_CLIENTS for n in r["workers"].values())
            or r["verdict"] != "COMMITTED"
            or r["plan"] != {"nShards": SF_SHARDS + 1, "planVersion": 2}):
        failures.append(f"reshard: {r}")
    if failures:
        raise AssertionError("; ".join(failures))
    return out


# -- phase 4b: streaming fold-in on the serve phase's model ---------------

SERVER_KEY = "chip-smoke-key"
# users in the tail, a quarter of them new: cut from 4,096 when the script
# took 1,126.3 s of its 1,200 with serve_rollout (PERF.md section 4)
FOLDIN_USERS = 2_048
FOLDIN_NEW_SHARE = 0.25
FOLDIN_BATCH = 1_024       # max_batch_users: two batches
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


FOLDIN_HTTP_USERS = 256    # users with one new event each, over the SDK
FOLDIN_TAIL_WAIT = 10      # the worker's --tail-wait (long-poll seconds)


def foldin_http_arm(env: dict, tmp: Path, engine_dir: Path, storage, qs,
                    port: int, config, exclude: set,
                    dev: torch.device) -> dict:
    """The fold-in worker as a process, ``python -m pio_tpu_torch foldin
    --event-server-url ... --access-key ... --tail-wait 10``, tailing an
    event server process on the same store and applying to the running
    deploy; once it holds its model, one new rate event for each of
    FOLDIN_HTTP_USERS users (none in the tail) is posted through the SDK.
    Every served row equals, bit for bit, the row a ``LocalEventSource``
    worker folds from the same events. Times the staleness from the 201
    to the last row served and the wake of a long-poll parked before the
    post; counts K7's launches answering those users. Returns the
    numbers and the users."""
    import threading

    from pio_tpu_torch import sdk
    from pio_tpu_torch.data.columnar import _micros
    from pio_tpu_torch.freshness import FoldInWorker
    from pio_tpu_torch.freshness.cursor import CursorStore, FoldCursor
    from pio_tpu_torch.freshness.tail import HttpEventSource
    from pio_tpu_torch.utils.time import utcnow

    rc, printed, _ = _cli(["accesskey", "new", "foldin"], storage)
    assert rc == 0, printed
    key = printed.rsplit("Access key: ", 1)[1].split()[0]
    rng = np.random.default_rng(SEED + 13)
    users = [u for u in (f"u{j}" for j in rng.choice(
        N_USERS, 4 * FOLDIN_HTTP_USERS, replace=False))
        if u not in exclude][:FOLDIN_HTTP_USERS]
    events = [{"event": "rate", "entityType": "user", "entityId": u,
               "targetEntityType": "item", "targetEntityId": f"i{it}",
               "properties": {"rating": float(s)}}
              for u, it, s in zip(users, rng.integers(0, N_ITEMS, len(users)),
                                  rng.integers(1, 6, len(users)))]

    def rows_of(model) -> np.ndarray:
        idx = torch.as_tensor([model.users.index_of(u) for u in users],
                              device=dev)
        return model.factors.user_factors[idx].cpu().numpy()

    before = rows_of(qs.models[0])
    out: dict = {"users": len(users)}
    with event_server(env) as es_url, \
            open(tmp / "foldin-http.err", "w+") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "pio_tpu_torch", "foldin", "--engine-dir",
             str(engine_dir), "--serving-url", f"http://127.0.0.1:{port}",
             "--server-key", SERVER_KEY, "--event-server-url", es_url,
             "--access-key", key, "--tail-wait", str(FOLDIN_TAIL_WAIT),
             "--state-path", str(tmp / "cursor-http.bin"), "--ip",
             "127.0.0.1", "--port", "0"],
            cwd=REPO_ROOT, env={**os.environ, **env},
            stdout=subprocess.PIPE, stderr=err, text=True)
        try:
            t0 = time.perf_counter()
            line = proc.stdout.readline()
            if "health on http://127.0.0.1:" not in line:
                err.seek(0)
                raise AssertionError(f"foldin: {line!r} {err.read()}")
            health = ("http://127.0.0.1:"
                      + line.split("health on http://127.0.0.1:")[1]
                      .split(",")[0] + "/")
            while True:
                with urllib.request.urlopen(health, timeout=60) as r:
                    if json.loads(r.read())["modelInstanceId"]:
                        break
                if time.perf_counter() - t0 > SUBPROCESS_TIMEOUT_S:
                    raise AssertionError("foldin: the model never loaded")
                time.sleep(0.05)
            out["worker_ready_s"] = time.perf_counter() - t0
            time.sleep(0.002)
            since = _micros(utcnow())
            time.sleep(0.002)
            woke: dict = {}
            source = HttpEventSource(es_url, key, wait_s=FOLDIN_TAIL_WAIT)

            def park():
                window = source.window(FoldCursor(time_us=since))
                woke["t"] = time.perf_counter()
                woke["rows"] = window.n_rows

            parked = threading.Thread(target=park)
            parked.start()
            time.sleep(0.5)
            # -- the main path: counts from 0, read right after ------------
            reset_counts()
            client = sdk.EventClient(key, es_url)
            t_post = time.perf_counter()
            statuses = [r["status"] for r in
                        client.create_events_batch(events)]
            t_201 = time.perf_counter()
            if statuses != [201] * len(events):
                raise AssertionError(f"foldin posts: {statuses}")
            while True:
                served = rows_of(qs.models[0])
                if all(not np.array_equal(a, b)
                       for a, b in zip(served, before)):
                    break
                if time.perf_counter() - t_201 > 120:
                    raise AssertionError("fold-in over HTTP: rows never "
                                         "served")
                time.sleep(0.005)
            t_served = time.perf_counter()
            parked.join(timeout=60)
            for u in users:
                status, body, _ = _post(port, "/queries.json",
                                        {"user": u, "num": 10})
                assert status == 200, body
            launches = read_counts()
            # ---------------------------------------------------------------
            with urllib.request.urlopen(health, timeout=60) as r:
                snap = json.loads(r.read())
        finally:
            stop_process(proc)
    if launches != {**dict.fromkeys(launches, 0),
                    "quantized_scan": len(users)}:
        raise AssertionError(f"fold-in over HTTP: launches {launches}")
    if woke.get("rows") != len(users):
        raise AssertionError(f"the parked long-poll saw {woke}")
    # the same events folded by a worker that reads the store
    path = tmp / "cursor-local.bin"
    CursorStore(str(path)).save(FoldCursor(time_us=since))
    got: dict = {}

    class Keep:
        def apply(self, rows, staleness_s=None):
            got.update(rows)
            return {"applied": len(rows)}

    local = FoldInWorker(storage, replace(config, state_path=str(path),
                                          replay=False), Keep(), device=dev)
    local_stats = local.run_once()
    if set(got) != set(users) or any(
            not np.array_equal(np.asarray(got[u], np.float32), served[j])
            for j, u in enumerate(users)):
        raise AssertionError("rows folded over the event server differ "
                             "from the LocalEventSource worker's")
    out.update({
        "rows_equal_local": True, "launches": launches,
        "post_ms": 1e3 * (t_201 - t_post),
        "staleness_s": t_served - t_201,
        "long_poll_wake_ms": 1e3 * (woke["t"] - t_201),
        "worker_snapshot": {k: snap[k] for k in (
            "foldedTotal", "appliedBatches", "lastFoldStalenessSeconds",
            "failures", "lastError")},
        "local_cycle": local_stats,
    })
    return out, users


def phase_foldin(users: np.ndarray, items: np.ndarray,
                 dev: torch.device) -> dict:
    """Streaming fold-in at the serve phase's width: the seeded factors
    persisted in a fresh sqlite store and served by ``create_query_server``
    behind a server key with clustered int8 retrieval (K7); a tail of
    interaction events; ``FoldInWorker`` with ``ServingHttpApplier`` over
    loopback HTTP (the worker ``python -m pio_tpu_torch foldin`` runs),
    replaying the log in two batches; the served rows held bit for bit
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
                with guarded_calls() as cycle_dao:
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
            http_arm, http_users = foldin_http_arm(
                env, Path(tmp), engine_dir, storage, qs, port, config,
                set(truth), dev)
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
        # (with the HTTP arm's users, whose rows were held above)
        if set(again) != folded | set(http_users) or any(
                not np.array_equal(np.asarray(again[u], np.float32),
                                   served[u]) for u in folded):
            raise AssertionError("a second worker's rows differ")
        cycle_guard = guard_cost(storage, cycle_dao["calls"])
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
        "guard": cycle_guard,
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
        "http_arm": http_arm,
    })
    emit("foldin", card=card_line(), **out)
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


# -- phase 11: ingest over the event server, the train entry point, deploy ---

INGEST_FRAME = 10_000      # events a binary frame (the route's ceiling)
INGEST_CLIENTS = 4         # SDK client threads posting frames at once
INGEST_PREFIX = 100_000    # the prefix held to a direct insert_batch
INGEST_CRC_SAMPLE = 10     # frames whose server-side CRC32C is timed again
INGEST_TWINS = 50          # the JSON batch held to its binary twin
METRICS_KEY = "chip-smoke-metrics"


def seeded_events() -> types.SimpleNamespace:
    """Seeded rate (80 %, rating 1..5) and buy events: every user and
    every item in at least one, the rest zipf-1.2 as bench.py draws,
    event j at 2024-01-01 plus j seconds. ``pairs`` counts the (user,
    item) pairs among them (the ratings training keeps: the later event
    of a pair wins)."""
    rng = np.random.default_rng(SEED + 3)
    u = (rng.zipf(1.2, N_EVENTS) % N_USERS).astype(np.int64)
    i = (rng.zipf(1.2, N_EVENTS) % N_ITEMS).astype(np.int64)
    u[:N_USERS] = np.arange(N_USERS)
    i[:N_ITEMS] = np.arange(N_ITEMS)
    rate = rng.random(N_EVENTS) < 0.8
    stars = rng.integers(1, 6, N_EVENTS)
    times = np.datetime_as_string(
        np.datetime64("2024-01-01T00:00:00", "s")
        + np.arange(N_EVENTS).astype("timedelta64[s]"), unit="ms")
    return types.SimpleNamespace(
        u=u, i=i, rate=rate, stars=stars, times=times, n=N_EVENTS,
        pairs=int(np.unique(u * N_ITEMS + i).size))


def api_events(ev, lo: int, hi: int) -> list:
    """Events lo..hi as the event server's API dicts."""
    return [{"event": "rate" if ev.rate[j] else "buy", "entityType": "user",
             "entityId": f"u{ev.u[j]}", "targetEntityType": "item",
             "targetEntityId": f"i{ev.i[j]}",
             "properties": ({"rating": float(ev.stars[j])} if ev.rate[j]
                            else {}),
             "eventTime": f"{ev.times[j]}Z"} for j in range(lo, hi)]


def stored_events(ev, lo: int, hi: int) -> list:
    """The same events as ``Event`` records, for a direct insert."""
    from datetime import datetime, timedelta, timezone

    from pio_tpu_torch.data.event import Event

    t0 = datetime(2024, 1, 1, tzinfo=timezone.utc)
    return [Event("rate" if ev.rate[j] else "buy", "user", f"u{ev.u[j]}",
                  "item", f"i{ev.i[j]}",
                  {"rating": float(ev.stars[j])} if ev.rate[j] else {},
                  t0 + timedelta(seconds=int(j)))
            for j in range(lo, hi)]


@contextlib.contextmanager
def event_server(env: dict, started: list | None = None):
    """``python -m pio_tpu_torch eventserver`` (async transport) on a
    free port over the store ``env`` names; yields its base URL and
    appends its process to ``started`` when one is given."""
    with tempfile.TemporaryFile("w+") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "pio_tpu_torch", "eventserver", "--ip",
             "127.0.0.1", "--port", "0", "--metrics-key", METRICS_KEY],
            cwd=REPO_ROOT, env={**os.environ, **env},
            stdout=subprocess.PIPE, stderr=err, text=True)
        if started is not None:
            started.append(proc)
        try:
            line = proc.stdout.readline()
            if "Event Server on http://127.0.0.1:" not in line:
                err.seek(0)
                raise AssertionError(f"eventserver: {line!r} {err.read()}")
            yield line.split()[-1]
        finally:
            stop_process(proc)


def stop_process(proc) -> None:
    proc.terminate()
    try:
        proc.communicate(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()


def process_cpu_s(pid: int) -> float:
    """User plus system CPU seconds of process ``pid``, all its threads."""
    fields = Path(f"/proc/{pid}/stat").read_text().rsplit(")", 1)[1].split()
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


def new_app(storage, name: str) -> tuple[int, str]:
    """``app new NAME``: (app id, its access key)."""
    rc, printed, _ = _cli(["app", "new", name], storage)
    if rc != 0:
        raise AssertionError(f"app new {name}: rc {rc}")
    app_id = int(printed.split("(id ")[1].split(")")[0])
    return app_id, printed.rsplit("Access key: ", 1)[1].split()[0]


def wire_counters(url: str) -> dict:
    """The event server's per-codec ingest counters, from /metrics."""
    with urllib.request.urlopen(
            f"{url}/metrics?accessKey={METRICS_KEY}", timeout=60) as r:
        text = r.read().decode()
    out: dict = {}
    for line in text.splitlines():
        if line.startswith("pio_ingest_wire_") and "{" in line:
            name = line.split("{")[0][len("pio_ingest_wire_"):-len("_total")]
            codec = line.split('codec="')[1].split('"')[0]
            out.setdefault(codec, {})[name] = float(line.rsplit(" ", 1)[1])
    return out


def post_raw(url: str, path: str, body: bytes, ctype: str) -> int:
    req = urllib.request.Request(f"{url}{path}", data=body, method="POST",
                                 headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status
    except urllib.error.HTTPError as e:
        return e.code


def wire_twins(storage, url: str) -> dict:
    """One JSON batch of INGEST_TWINS events and one ``/events.json``
    event, each beside its binary twin in another channel of a second
    app: the stored ``Event`` fields are equal but for the minted id
    and creation time. Then a corrupt frame: 400, nothing stored."""
    from pio_tpu_torch import sdk
    from pio_tpu_torch.data.columnar import (
        COLUMNAR_CONTENT_TYPE,
        encode_api_batch,
    )

    app_id, _ = new_app(storage, "ChipSmokeWire")
    channels = {}
    for name in ("bin", "json"):
        rc, printed, _ = _cli(["app", "channel-new", "ChipSmokeWire", name],
                              storage)
        assert rc == 0, printed
        channels[name] = int(printed.split("(id ")[1].split(")")[0])
    rc, printed, _ = _cli(["accesskey", "new", "ChipSmokeWire"], storage)
    assert rc == 0, printed
    key = printed.rsplit("Access key: ", 1)[1].split()[0]
    ev = seeded_events()
    batch = api_events(ev, 0, INGEST_TWINS)
    one = api_events(ev, INGEST_TWINS, INGEST_TWINS + 1)[0]
    binary = sdk.EventClient(key, url, channel="bin")
    as_json = sdk.EventClient(key, url, channel="json", wire="json")
    statuses = [r["status"] for r in binary.create_events_batch(batch)
                + binary.create_events_batch([one])
                + as_json.create_events_batch(batch)]
    as_json.create_event(one["event"], one["entityType"], one["entityId"],
                         one["targetEntityType"], one["targetEntityId"],
                         one["properties"], one["eventTime"])
    if statuses != [201] * len(statuses):
        raise AssertionError(f"wire twins: statuses {statuses}")

    def read(channel: str) -> list:
        rows = [e.to_api_dict() for e in storage.get_events().find(
            app_id, channel_id=channels[channel], limit=-1)]
        for r in rows:
            del r["eventId"], r["creationTime"]
        return sorted(rows, key=lambda r: json.dumps(r, sort_keys=True))

    got = read("bin")
    if len(got) != INGEST_TWINS + 1 or got != read("json"):
        raise AssertionError("JSON and binary twins stored differently")
    frame = bytearray(encode_api_batch(api_events(ev, 0, 100)))
    frame[len(frame) // 2] ^= 0x01
    status = post_raw(url, f"/batch/events.json?accessKey={key}",
                      bytes(frame), COLUMNAR_CONTENT_TYPE)
    left = len(list(storage.get_events().find(app_id, limit=-1)))
    if status != 400 or left:
        raise AssertionError(f"corrupt frame: {status}, {left} stored")
    return {"twins_equal": True, "twin_events": len(got),
            "corrupt_frame_status": status, "corrupt_frame_stored": left}


def post_frames(url: str, key: str, ev, spans: list) -> dict:
    """Frames (lo, hi) posted by INGEST_CLIENTS SDK clients at once, each
    frame's events built and encoded in the posting thread; returns the
    wall time, the statuses and each thread's CPU seconds."""
    import threading

    from pio_tpu_torch import sdk

    todo = list(spans)
    lock = threading.Lock()
    statuses: dict = {}
    cpu = []
    errors = []

    def run():
        client = sdk.EventClient(key, url, timeout=600)
        t_cpu = 0.0
        while True:
            with lock:
                if not todo:
                    break
                lo, hi = todo.pop(0)
            t = time.thread_time()
            try:
                out = client.create_events_batch(api_events(ev, lo, hi))
            except Exception as e:  # noqa: BLE001 - raised below
                errors.append(e)
                return
            t_cpu += time.thread_time() - t
            for r in out:
                statuses[r["status"]] = statuses.get(r["status"], 0) + 1
        cpu.append(t_cpu)

    threads = [threading.Thread(target=run) for _ in range(INGEST_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return {"wall_s": wall, "statuses": statuses, "client_cpu_s": sum(cpu)}


def phase_ingest(store) -> dict:
    """``train_entry``'s store written the way a deployment writes it:
    ``app new`` and an event server process (``python -m pio_tpu_torch
    eventserver``, async transport) on a free port, the seeded N_EVENTS
    events posted through ``sdk.EventClient.create_events_batch`` in
    binary frames of INGEST_FRAME by INGEST_CLIENTS threads. Checks that
    every slot answers 201, that the store holds every event, that the
    columnar read of the first INGEST_PREFIX events equals a direct
    ``insert_batch`` of them into a second store, the JSON and binary
    twins, and a corrupt frame's 400. Times the wire; on the server's
    own clock (its /metrics counters) its decode and the time its batch
    route and its sqlite insert were busy; the server process's CPU
    seconds; CRC32C on the client as it runs, and the server's CRC32C
    share of its decode by timing the same frames again here."""
    import sqlite3
    import threading

    from pio_tpu_torch.data.columnar import encode_api_batch
    from pio_tpu_torch.data.dao import App
    from pio_tpu_torch.data.storage import Storage
    from pio_tpu_torch.utils import durable

    storage = store.storage
    app_id, key = new_app(storage, "ChipSmoke")
    ev = seeded_events()
    spans = [(lo, min(ev.n, lo + INGEST_FRAME))
             for lo in range(0, ev.n, INGEST_FRAME)]
    n_prefix = INGEST_PREFIX // INGEST_FRAME
    crc = {"s": 0.0, "bytes": 0}
    crc_lock = threading.Lock()
    plain_crc = durable.crc32c

    def timed_crc(data) -> int:
        t = time.thread_time()
        out = plain_crc(data)
        dt = time.thread_time() - t
        with crc_lock:
            crc["s"] += dt
            crc["bytes"] += len(data)
        return out

    out: dict = {"events": ev.n, "ratings": ev.pairs, "frame": INGEST_FRAME,
                 "clients": INGEST_CLIENTS}
    server: list = []
    with event_server(store.env, server) as url:
        durable.crc32c = timed_crc
        try:
            cpu0 = process_cpu_s(server[0].pid)
            first = post_frames(url, key, ev, spans[:n_prefix])
            cpu1 = process_cpu_s(server[0].pid)
            # the prefix, read back, against a direct insert of it (kept
            # in the store's folder: shared_store holds its shards to it)
            (store.tmp / "direct").mkdir()
            direct_env = sqlite_env(store.tmp / "direct")
            direct = Storage(env=direct_env)
            try:
                did = direct.get_metadata_apps().insert(App(0, "direct"))
                direct.get_events().init(did)
                t0 = time.perf_counter()
                for lo in range(0, INGEST_PREFIX, 50_000):
                    direct.get_events().insert_batch(stored_events(
                        ev, lo, min(INGEST_PREFIX, lo + 50_000)), did)
                out["direct_insert_prefix_s"] = time.perf_counter() - t0
                want = direct.get_events().columnarize(did)
            finally:
                direct.close()
            got = storage.get_events().columnarize(app_id)
            if (got.users != want.users or got.items != want.items
                    or any(not np.array_equal(getattr(got, f),
                                              getattr(want, f))
                           for f in ("user_idx", "item_idx", "values",
                                     "times_us"))):
                raise AssertionError("the prefix posted through the event "
                                     "server reads back unlike a direct "
                                     "insert_batch")
            out["prefix_coo_equal"] = True
            cpu2 = process_cpu_s(server[0].pid)
            rest = post_frames(url, key, ev, spans[n_prefix:])
            cpu3 = process_cpu_s(server[0].pid)
        finally:
            durable.crc32c = plain_crc
        wire = wire_counters(url)
        out.update(wire_twins(storage, url))
    statuses = dict(first["statuses"])
    for s, n in rest["statuses"].items():
        statuses[s] = statuses.get(s, 0) + n
    if statuses != {201: ev.n}:
        raise AssertionError(f"ingest statuses {statuses}")
    con = sqlite3.connect(store.env["PIO_STORAGE_SOURCES_SQL_PATH"])
    try:
        [(n_stored,)] = con.execute(
            "SELECT COUNT(*) FROM events WHERE app_id = ?", (app_id,))
    finally:
        con.close()
    if n_stored != ev.n:
        raise AssertionError(f"{n_stored} events stored, {ev.n} posted")
    # the server checks the same frames' CRC32C with the same function on
    # the same host: a sample of them timed again, scaled by the bytes,
    # an estimate of the CRC32C's share in the server's decode seconds
    sample_s, sample_bytes = 0.0, 0
    for lo, hi in spans[::len(spans) // INGEST_CRC_SAMPLE][:INGEST_CRC_SAMPLE]:
        payload = encode_api_batch(api_events(ev, lo, hi))[
            durable._HEADER.size:]
        t = time.thread_time()
        plain_crc(payload)
        sample_s += time.thread_time() - t
        sample_bytes += len(payload)
    binary = wire["binary"]
    if binary["events"] != ev.n:
        raise AssertionError(f"the server counted {binary['events']} "
                             f"binary events, {ev.n} posted")
    wall = first["wall_s"] + rest["wall_s"]
    server_cpu = (cpu1 - cpu0) + (cpu3 - cpu2)
    out.update({
        "stored": n_stored, "statuses": {str(k): v for k, v in
                                         statuses.items()},
        "wall_s": wall, "events_per_s": ev.n / wall,
        "client_cpu_s": first["client_cpu_s"] + rest["client_cpu_s"],
        "client_crc_s": crc["s"], "frame_bytes": crc["bytes"],
        # on the server's clock: the decode summed over the frames, and
        # the wall seconds during which the batch route, and the store's
        # insert_batch, held at least one frame (the 4 clients' frames
        # overlap in the route)
        "server_decode_s": binary["decode_seconds"],
        "server_route_busy_s": binary["handle_busy_seconds"],
        "server_insert_busy_s": binary["insert_busy_seconds"],
        "wall_outside_route_s": wall - binary["handle_busy_seconds"],
        "server_cpu_s": server_cpu, "server_cpu_per_wall": server_cpu / wall,
        "server_crc_s_est": sample_s * crc["bytes"] / sample_bytes,
        "direct_insert_s_scaled": (out["direct_insert_prefix_s"] * ev.n
                                   / INGEST_PREFIX),
        "wire_binary": binary,
    })
    emit("ingest", card=card_line(), **out)
    return {**out, "prefix_env": direct_env}


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
    where, fold = template_read(ep)
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


def phase_train_entry(store, dev: torch.device, ingest: dict) -> dict:
    """Trains the events ``ingest`` wrote into ``store`` (shared with the
    ``evaluate`` phase) through the train verb, deploys the instance and
    times the verb's parts."""
    from pio_tpu_torch.__main__ import (
        _engine_from_variant,
        _load_variant,
        main as cli_main,
    )
    from pio_tpu_torch.data.storage import set_storage
    from pio_tpu_torch.ops import als
    from pio_tpu_torch.workflow.context import create_workflow_context
    from pio_tpu_torch.workflow.serve import ServingConfig, create_query_server

    tmp, storage = store.tmp, store.storage
    n_events, n_pairs = ingest["events"], ingest["ratings"]
    engine_dir = train_engine_dir(tmp, "chip-smoke-train", "ChipSmoke")
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
        with contextlib.redirect_stdout(out), guarded_calls() as dao:
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
    split = split_train_verb(storage, engine, ep, dev, want_launches)
    if served_iid != iid:
        raise AssertionError("deploy did not load the trained instance")
    result = {
        "events": n_events, "ratings": n_pairs,
        "train_s": train_s, "instance": iid, "launches": train_launches,
        "guard": guard_cost(storage, dao["calls"]),
        "segment_flush_launches_expected": want_launches,
        "query_ms": [1e3 * t for t in latencies], "split": split,
    }
    emit("train_entry", **result)
    return result

# -- phase 11a: the native event log behind the event server ------------------

LOG_JSON_BATCH = 50        # events a JSON batch of the fast-path arm
LOG_JSON_EVENTS = 10_000   # the fast-path arm: the first events, as JSON
# the row path (find + the columnar fold) decodes every event in Python:
# its oracle covers the first events only, cut for time (PERF.md)
LOG_ORACLE_EVENTS = 100_000


def eventlog_env(tmp) -> dict:
    """METADATA on sqlite, EVENTDATA on the native event log, MODELDATA
    on localfs: the reference's HBase + JDBC + HDFS pairing."""
    tmp = Path(tmp)
    return {
        "PIO_STORAGE_SOURCES_SQL_TYPE": "sqlite",
        "PIO_STORAGE_SOURCES_SQL_PATH": str(tmp / "meta.db"),
        "PIO_STORAGE_SOURCES_LOG_TYPE": "eventlog",
        "PIO_STORAGE_SOURCES_LOG_PATH": str(tmp / "eventlog"),
        "PIO_STORAGE_SOURCES_FS_TYPE": "localfs",
        "PIO_STORAGE_SOURCES_FS_PATH": str(tmp / "models"),
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "SQL",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "LOG",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "FS",
    }


def train_engine_dir(root: Path, engine_id: str, app_name: str,
                     **extra) -> Path:
    """An engine.json with ``train_entry``'s ALS params."""
    engine_dir = root / f"engine-{engine_id}"
    engine_dir.mkdir()
    (engine_dir / "engine.json").write_text(json.dumps({
        "id": engine_id, "engineFactory": FACTORY,
        "datasource": {"params": {"app_name": app_name}},
        "algorithms": [{"name": "als", "params": {
            "rank": RANK, "num_iterations": ITERS, "lambda_": 0.05,
            "alpha": 10.0, "implicit_prefs": True, **extra}}],
    }))
    return engine_dir


def template_read(ep) -> tuple[dict, dict]:
    """The recommendation template's training read as columnarize
    keywords: (the where clause, the value fold)."""
    ds = ep.datasource[1]
    return (dict(entity_type="user", target_entity_type="item",
                 event_names=list(ds.event_names)),
            dict(value_key="rating", default_value=ds.implicit_value,
                 value_event=ds.rating_event, dedup="last"))


def sorted_triples(cols) -> tuple:
    """(user id, item id, value) rows in (user, item) order, whatever
    the store's code order."""
    users = np.asarray(cols.users)[cols.user_idx]
    items = np.asarray(cols.items)[cols.item_idx]
    order = np.lexsort((items, users))
    return users[order], items[order], cols.values[order]


def triples_equal(a, b) -> bool:
    return all(np.array_equal(x, y) for x, y in zip(a, b)) and (
        a[2].dtype == b[2].dtype)


def stored_factors(storage, instance_id: str):
    """The ALS factors an instance's model blob holds, on the host. The
    blob's CRC32C is left to the deploys, which check it (pure Python on
    the card's machine: seconds for 47 MB); this only compares."""
    import pickle

    from pio_tpu_torch.utils import durable

    blob = storage.get_model_data_models().get(instance_id).models
    _, _, n = durable._HEADER.unpack_from(blob)
    if len(blob) != durable._HEADER.size + n:
        raise AssertionError(f"instance {instance_id}: truncated model blob")
    model = pickle.loads(blob[durable._HEADER.size:])[0]
    return (np.asarray(model.factors.user_factors),
            np.asarray(model.factors.item_factors))


def bits_equal(a, b) -> bool:
    return all(x.dtype == y.dtype and x.shape == y.shape
               and x.tobytes() == y.tobytes() for x, y in zip(a, b))


@contextlib.contextmanager
def watched(cls, name: str):
    """Each call of the method ``cls.name`` while the block runs, as
    (wall seconds, what it returned)."""
    seen: list = []
    plain = getattr(cls, name)

    def call(self, *a, **kw):
        t0 = time.perf_counter()
        got = plain(self, *a, **kw)
        seen.append((time.perf_counter() - t0, got))
        return got

    setattr(cls, name, call)
    try:
        yield seen
    finally:
        setattr(cls, name, plain)


def train_verb(storage, engine_dir: Path, read_cls, what: str):
    """``python -m pio_tpu_torch train`` in process on ``storage`` (the
    main path: counts from 0, read right after), its one training read
    (``read_cls.columnarize``) kept: ``(result, the read's columns)``.
    K2 must launch exactly as the layout of that read predicts, and no
    other kernel."""
    engine, ep = _engine_from_dir(engine_dir)
    with watched(read_cls, "columnarize") as reads:
        reset_counts()
        rc, printed, seconds = _cli(
            ["train", "--engine-dir", str(engine_dir)], storage)
        launches = read_counts()
    if rc != 0 or len(reads) != 1:
        raise AssertionError(f"{what}: train rc {rc}, {len(reads)} reads")
    read_s, cols = reads[0]
    want = expected_flush_launches(
        len(cols.values), len(cols.users), len(cols.items),
        engine.algorithm_classes["als"](ep.algorithms[0][1])._als_params())
    if launches != {**dict.fromkeys(launches, 0), "segment_flush": want}:
        raise AssertionError(f"{what}: launches {launches}, the layout "
                             f"predicts {want}")
    return {"instance": printed.rsplit(" ", 1)[-1], "train_s": seconds,
            "read_s": read_s, "ratings": len(cols.values),
            "launches": launches,
            "segment_flush_launches_expected": want}, cols


def _engine_from_dir(engine_dir: Path):
    from pio_tpu_torch.__main__ import _engine_from_variant, _load_variant

    return _engine_from_variant(_load_variant(str(engine_dir)),
                                str(engine_dir))


def phase_eventlog(sqlite, dev: torch.device) -> dict:
    """The ingest phase's events again, into the native event log (the
    reference's HBase + JDBC + HDFS deployment): an ``eventserver``
    process (async transport) takes the seeded N_EVENTS events through
    ``sdk.EventClient`` in binary frames of INGEST_FRAME from
    INGEST_CLIENTS threads; the log is read only after the server
    stopped. The train verb on the log (its read the C++
    ``columnarize``) launches K2 as that read's layout predicts and
    stores the factors of ``als_train`` on the same read, whose triples
    equal the ingest phase's sqlite store's; the C++ sweep of the first
    LOG_ORACLE_EVENTS events equals the same store's Python path
    (``find`` + the columnar fold); then JSON batches of LOG_JSON_BATCH
    through ``create_event_server`` in process take the native fast path
    (one ``EventLog.ingest_batch`` a batch) and store what the binary
    frames stored."""
    from datetime import datetime, timedelta, timezone

    from pio_tpu_torch.data.backends.eventlog import _EventLogEvents
    from pio_tpu_torch.data.columnar import columnar_interactions
    from pio_tpu_torch.data.storage import Storage
    from pio_tpu_torch.native import eventlog as native_log
    from pio_tpu_torch.ops import als
    from pio_tpu_torch.server.eventserver import (
        EventServerConfig,
        create_event_server,
    )

    ev = seeded_events()
    spans = [(lo, min(ev.n, lo + INGEST_FRAME))
             for lo in range(0, ev.n, INGEST_FRAME)]
    out: dict = {"events": ev.n, "frame": INGEST_FRAME,
                 "clients": INGEST_CLIENTS}
    with tempfile.TemporaryDirectory(prefix="pio_chip_eventlog_") as tmp:
        tmp = Path(tmp)
        env = eventlog_env(tmp)
        setup = Storage(env=env)
        try:
            app_id, key = new_app(setup, "ChipSmokeLog")
            json_app, json_key = new_app(setup, "ChipSmokeLogJson")
        finally:
            setup.close()
        server: list = []
        with event_server(env, server) as url:
            cpu0 = process_cpu_s(server[0].pid)
            posted = post_frames(url, key, ev, spans)
            cpu1 = process_cpu_s(server[0].pid)
            wire = wire_counters(url)["binary"]
        if posted["statuses"] != {201: ev.n}:
            raise AssertionError(f"eventlog ingest statuses "
                                 f"{posted['statuses']}")
        # the writer has stopped: the log's end is known to this reader
        log_path = str(tmp / "eventlog" / f"app_{app_id}" / "events.log")
        log = native_log.EventLog(log_path, create=False)
        try:
            log_bytes, records = log.stats()
        finally:
            log.close()
        if records != ev.n:
            raise AssertionError(f"the log holds {records} records, "
                                 f"{ev.n} posted")
        out.update({
            "wall_s": posted["wall_s"],
            "events_per_s": ev.n / posted["wall_s"],
            "client_cpu_s": posted["client_cpu_s"],
            "server_cpu_s": cpu1 - cpu0,
            "server_cpu_per_wall": (cpu1 - cpu0) / posted["wall_s"],
            "server_decode_s": wire["decode_seconds"],
            "server_route_busy_s": wire["handle_busy_seconds"],
            "server_insert_busy_s": wire["insert_busy_seconds"],
            "log_records": records, "log_bytes": log_bytes,
        })

        engine_dir = train_engine_dir(tmp, "chip-smoke-eventlog",
                                      "ChipSmokeLog")
        engine, ep = _engine_from_dir(engine_dir)
        where, fold = template_read(ep)
        storage = Storage(env=env)
        try:
            dao = storage.get_events()
            # the train verb on the log; its read is the C++ columnarize
            out["train"], cxx = train_verb(storage, engine_dir,
                                           _EventLogEvents, "eventlog")
            p = engine.algorithm_classes["als"](
                ep.algorithms[0][1])._als_params()
            # what the verb trains on: EventStore.interactions' codes of
            # that read
            direct = als.als_train(cxx.user_idx.astype(np.int32),
                                   cxx.item_idx.astype(np.int32),
                                   cxx.values, len(cxx.users),
                                   len(cxx.items), p, device=dev)
            if not bits_equal(
                    stored_factors(storage, out["train"]["instance"]),
                    (direct.user_factors.cpu().numpy(),
                     direct.item_factors.cpu().numpy())):
                raise AssertionError("the train verb on the log differs "
                                     "from als_train on its columnarize")
            out["factors_equal_als_train"] = True
            del direct
            sql_app = sqlite.storage.get_metadata_apps().get_by_name(
                "ChipSmoke").id
            t0 = time.perf_counter()
            sql = sqlite.storage.get_events().columnarize(
                sql_app, **where, **fold)
            out["sqlite_read_s"] = time.perf_counter() - t0
            if not triples_equal(sorted_triples(cxx), sorted_triples(sql)):
                raise AssertionError("the log's triples differ from the "
                                     "ingest phase's sqlite store's")
            out["sqlite_code_order_equal"] = bool(
                cxx.users == sql.users and cxx.items == sql.items
                and np.array_equal(cxx.user_idx, sql.user_idx))
            del sql, cxx

            # the row path on the first LOG_ORACLE_EVENTS events, beside
            # the C++ sweep of the same window
            until = datetime(2024, 1, 1, tzinfo=timezone.utc) + timedelta(
                seconds=LOG_ORACLE_EVENTS)
            t0 = time.perf_counter()
            window = dao.columnarize(app_id, until_time=until, **where,
                                     **fold)
            out["oracle_window_cxx_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            rows = dao.find_columnar(app_id, until_time=until, **where)
            out["oracle_window_find_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            python = columnar_interactions(rows, **fold)
            out["oracle_window_fold_s"] = time.perf_counter() - t0
            out["oracle_events"] = len(rows)
            del rows
            if not triples_equal(sorted_triples(window),
                                 sorted_triples(python)):
                raise AssertionError("the C++ columnarize differs from "
                                     "find + the columnar fold")
            out["python_code_order_equal"] = bool(
                window.users == python.users and window.items == python.items
                and np.array_equal(window.user_idx, python.user_idx)
                and np.array_equal(window.item_idx, python.item_idx))
            del python, window

            # JSON batches through the native fast path, in process
            srv = create_event_server(storage, EventServerConfig(
                ip="127.0.0.1", port=0)).start()
            try:
                with watched(native_log.EventLog, "ingest_batch") as calls:
                    t0 = time.perf_counter()
                    slots = []
                    for lo in range(0, LOG_JSON_EVENTS, LOG_JSON_BATCH):
                        status, body, _ = _post(
                            srv.port,
                            f"/batch/events.json?accessKey={json_key}",
                            api_events(ev, lo, lo + LOG_JSON_BATCH))
                        if status != 200:
                            raise AssertionError(
                                f"JSON batch: {status} {body}")
                        slots += [r["status"] for r in body]
                    out["json_arm_s"] = time.perf_counter() - t0
            finally:
                srv.stop()
            n_batches = LOG_JSON_EVENTS // LOG_JSON_BATCH
            if slots != [201] * LOG_JSON_EVENTS or len(calls) != n_batches:
                raise AssertionError(
                    f"JSON arm: {len(calls)} native calls for {n_batches} "
                    f"batches, statuses {set(slots)}")

            def stored(app: int) -> list:
                last = datetime(2024, 1, 1, tzinfo=timezone.utc) + \
                    timedelta(seconds=LOG_JSON_EVENTS)
                rows = [e.to_api_dict() for e in dao.find(
                    app, until_time=last, limit=-1)]
                for r in rows:
                    del r["eventId"], r["creationTime"]
                return rows

            twins = stored(app_id)
            if len(twins) != LOG_JSON_EVENTS or stored(json_app) != twins:
                raise AssertionError("the fast path's JSON events differ "
                                     "from their binary twins")
            out.update({"json_batches": n_batches,
                        "native_ingest_calls": len(calls),
                        "json_twins_equal": True})
        finally:
            storage.close()
    emit("eventlog", card=card_line(), **out)
    return out


# -- phase 11c: one store shared over the wire --------------------------------

SHARED_QUERIES = 64        # /queries.json of the deploy from the remote store
# trained factors need more probes than the serve phase's seeded ones: on
# the train verb's model of 10^6 events recall@10 was 0.895 at RETRIEVAL's
# nprobe 32 of 256 clusters and 0.945 at 64; on N_EVENTS (most users with
# one or two) 0.755, 0.823, 0.880 and 0.919 at 32, 64, 128 and 192
SHARED_RETRIEVAL = {**RETRIEVAL, "nprobe": 192}
SHARED_EVENTS = 50_000     # the sharded and replicated arms' events, cut
SHARED_FRAME = 5_000       # from the ingest prefix's 100,000 for time
SHARED_KILL_AFTER = 5      # frames posted before replica 3 is SIGKILLed
DRAIN_TIMEOUT_S = 300


def shared_until():
    """The end of the first SHARED_EVENTS seeded events (event j is at
    2024-01-01 plus j seconds)."""
    from datetime import datetime, timedelta, timezone

    return datetime(2024, 1, 1, tzinfo=timezone.utc) + timedelta(
        seconds=SHARED_EVENTS)


def storage_server_proc(env: dict, log: Path, port: int = 0,
                        key: str = ""):
    """``python -m pio_tpu_torch storageserver`` over the store ``env``
    names, on loopback and ``port`` (0: a free one): (process, base URL).
    Its standard error goes to ``log``."""
    argv = [sys.executable, "-m", "pio_tpu_torch", "storageserver",
            "--ip", "127.0.0.1", "--port", str(port)]
    if key:
        argv += ["--server-key", key]
    with open(log, "w") as err:
        proc = subprocess.Popen(
            argv, cwd=REPO_ROOT, stdout=subprocess.PIPE, stderr=err,
            text=True, env={**os.environ, **env, "PYTHONUNBUFFERED": "1"})
    line = proc.stdout.readline()
    if "Storage Server on http://127.0.0.1:" not in line:
        stop_process(proc)
        raise AssertionError(f"storageserver: {line!r} {log.read_text()}")
    return proc, line.split()[-1]


def remote_source(name: str, url: str, key: str = "") -> dict:
    env = {f"PIO_STORAGE_SOURCES_{name}_TYPE": "remote",
           f"PIO_STORAGE_SOURCES_{name}_URL": url}
    if key:
        env[f"PIO_STORAGE_SOURCES_{name}_KEY"] = key
    return env


def storage_spans(url: str) -> dict:
    """The storage server's per-RPC spans (count, total seconds)."""
    with urllib.request.urlopen(f"{url}/metrics.json", timeout=60) as r:
        return json.loads(r.read())["spans"]


def column_rows(cols) -> list:
    """A columnar read's rows decoded: event, entity, target, µs, zone
    and properties, whatever the read's dictionary layout."""
    ev = np.asarray(cols.event_names, dtype=object)[cols.event_code]
    en = np.asarray(cols.entity_ids, dtype=object)[cols.entity_code]
    tg = np.asarray(list(cols.target_ids) + [None], dtype=object)[
        cols.target_code]
    return list(zip(ev.tolist(), en.tolist(), tg.tolist(),
                    cols.time_us.tolist(), cols.tz_min.tolist(),
                    [cols.props(j) for j in range(len(cols))]))


def shared_remote(sqlite, dev: torch.device, entry: dict, tmp: Path) -> dict:
    """(a) A ``storageserver`` process over the ingest phase's sqlite
    store, every repository of the trainer on ``remote``: the train verb
    (its read the server-side ``columnarize`` RPC, K2 as predicted, the
    factors ``train_entry``'s bit for bit), the model's persist and load
    over the wire, and a deploy from the remote store answering
    SHARED_QUERIES queries over HTTP with K7 once a query."""
    from pio_tpu_torch.data.backends import remote as remote_backend
    from pio_tpu_torch.data.storage import Storage
    from pio_tpu_torch.ops import als
    from pio_tpu_torch.ops import retrieval as rt
    from pio_tpu_torch.workflow.context import create_workflow_context
    from pio_tpu_torch.workflow.serve import ServingConfig, create_query_server

    out: dict = {}
    proc, url = storage_server_proc(sqlite.env, tmp / "remote.log",
                                    key=SERVER_KEY)
    remote = None
    try:
        remote = Storage(env={
            **remote_source("NET", url, SERVER_KEY),
            **{f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE": "NET"
               for r in ("METADATA", "EVENTDATA", "MODELDATA")}})
        engine_dir = train_engine_dir(tmp, "chip-smoke-remote", "ChipSmoke",
                                      retrieval=SHARED_RETRIEVAL)
        engine, ep = _engine_from_dir(engine_dir)
        # the read (the verb's RPC) and the persist on this client's clock
        with watched(remote_backend._RemoteModels, "insert") as persists:
            out["train"], cols = train_verb(remote, engine_dir,
                                            remote_backend._RemoteEvents,
                                            "remote")
        del cols
        iid = out["train"]["instance"]
        if (out["train"]["segment_flush_launches_expected"]
                != entry["segment_flush_launches_expected"]):
            raise AssertionError("the remote read's layout differs from "
                                 "train_entry's")
        out["model_persist_s"] = [t for t, _ in persists]
        spans = storage_spans(url)
        if (spans.get("events.columnarize", {}).get("count") != 1
                or "events.find" in spans):
            raise AssertionError(f"the remote read was not one server-side "
                                 f"columnarize: {sorted(spans)}")
        out["server_columnarize_s"] = spans["events.columnarize"]["total"]
        out["server_models_insert_s"] = spans["models.insert"]["total"]
        if not bits_equal(stored_factors(remote, iid),
                          stored_factors(sqlite.storage, entry["instance"])):
            raise AssertionError("the remote train differs from "
                                 "train_entry's instance")
        out["factors_equal_train_entry"] = True

        t0 = time.perf_counter()
        with watched(remote_backend._RemoteModels, "get") as loads:
            http, qs = create_query_server(
                engine, ep, remote,
                ServingConfig(ip="127.0.0.1", port=0,
                              engine_id="chip-smoke-remote"),
                ctx=create_workflow_context(remote, device=dev))
        http.start()
        out["deploy_load_s"] = time.perf_counter() - t0
        # the deploy reads each candidate instance's rollout record (none
        # here) before it loads the model blob
        blobs = [(t, m) for t, m in loads if m is not None]
        out["model_load_s"] = [t for t, _ in blobs]
        out["rollout_record_reads"] = len(loads) - len(blobs)
        out["model_bytes"] = len(blobs[0][1].models)
        del loads, blobs
        try:
            if qs.instance.id != iid:
                raise AssertionError("the deploy did not load the remote "
                                     "instance")
            model = qs.models[0]
            ids = model.users.ids()
            picked = np.random.default_rng(SEED + 5).choice(
                len(ids), SHARED_QUERIES + 1, replace=False)
            queries = [{"user": ids[r], "num": 10} for r in picked]
            # the first query builds the retrieval index (k-means) once
            status, warm, out["first_query_s"] = _post(
                http.port, "/queries.json", queries.pop())
            assert status == 200, warm
            # -- the main path: counts from 0, read right after --------
            reset_counts()
            answers, latencies = [], []
            for q in queries:
                status, body, dt = _post(http.port, "/queries.json", q)
                assert status == 200, body
                answers.append(body)
                latencies.append(dt)
            launches = read_counts()
            # ------------------------------------------------------------
            if launches != {**dict.fromkeys(launches, 0),
                            "quantized_scan": SHARED_QUERIES}:
                raise AssertionError(f"remote deploy: launches {launches}")
            for q, got in zip(queries, answers):
                if got != qs.query(q):
                    raise AssertionError(f"{q}: the HTTP answer differs from "
                                         "candidate_topk in process")
            uidx = np.array([model.users.index_of(q["user"])
                             for q in queries])
            _, exact = als.recommend_topk(model.factors, uidx, 10)
            exact = exact.cpu().numpy()
            got_idx = np.array([model.items.encode(_ranking(a)[0])
                                for a in answers])
            recall = rt.recall_at_k(got_idx, exact)
            # the same queries in process at other probe counts
            _, didx = qs.algorithms[0]._retrieval_index(model)
            rows = model.factors.user_factors[torch.as_tensor(
                uidx, device=dev)]
            recall_by_nprobe = {}
            for nprobe in (32, 64, 128):
                probe = replace(didx, params=replace(didx.params,
                                                     nprobe=nprobe))
                _, got = rt.candidate_topk(probe,
                                           model.factors.item_factors,
                                           rows, 10)
                recall_by_nprobe[nprobe] = rt.recall_at_k(got, exact)
        finally:
            http.stop()
            qs.close()
        lat_ms = sorted(1e3 * t for t in latencies)
        out.update({"queries": SHARED_QUERIES, "serve_launches": launches,
                    "retrieval": SHARED_RETRIEVAL, "recall_at_10": recall,
                    "recall_at_10_by_nprobe": recall_by_nprobe,
                    "n_clusters": didx.n_clusters,
                    "p50_ms": statistics.median(lat_ms),
                    "max_ms": lat_ms[-1]})
        if recall < RECALL_FLOOR:
            raise AssertionError(f"recall@10 {recall} < {RECALL_FLOOR} "
                                 f"(by nprobe: {recall_by_nprobe})")
    finally:
        if remote is not None:
            remote.close()
        stop_process(proc)
    return out


def shared_sharded(prefix_env: dict, tmp: Path) -> dict:
    """(b) Two ``storageserver`` processes, each over its own event log,
    metadata and models on shard 0; an ``eventserver`` over ``sharded``
    takes the first SHARED_EVENTS seeded events in binary frames. The
    sharded ``find_columnar`` (per-shard ``/rpc/columnar`` frames and
    ``concat_columnar``) holds the ingest phase's direct-insert prefix
    store's rows, its ``columnarize`` that store's triples, and a train
    verb through it launches K2 as predicted."""
    from pio_tpu_torch.data.backends.sharded import ShardedEventsDAO
    from pio_tpu_torch.data.columnar import encode_columnar_events
    from pio_tpu_torch.data.storage import Storage

    ev = seeded_events()
    spans = [(lo, min(SHARED_EVENTS, lo + SHARED_FRAME))
             for lo in range(0, SHARED_EVENTS, SHARED_FRAME)]
    out: dict = {"events": SHARED_EVENTS, "shards": 2}
    procs = []
    client = None
    try:
        for k in range(2):
            (tmp / f"shard{k}").mkdir()
            procs.append(storage_server_proc(
                eventlog_env(tmp / f"shard{k}"), tmp / f"shard{k}.log"))
        urls = [u for _, u in procs]
        env = {**remote_source("SHARED", urls[0]),
               "PIO_STORAGE_SOURCES_EV_TYPE": "sharded",
               "PIO_STORAGE_SOURCES_EV_URLS": ",".join(urls),
               "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "SHARED",
               "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "EV",
               "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "SHARED"}
        client = Storage(env=env)
        app_id, key = new_app(client, "ChipSmokeShard")
        with event_server(env) as url:
            posted = post_frames(url, key, ev, spans)
        if posted["statuses"] != {201: SHARED_EVENTS}:
            raise AssertionError(f"sharded statuses {posted['statuses']}")
        out["ingest_s"] = posted["wall_s"]
        dao = client.get_events()
        engine_dir = train_engine_dir(tmp, "chip-smoke-sharded",
                                      "ChipSmokeShard")
        # the train verb; its read is the region-parallel columnarize
        out["train"], cols = train_verb(client, engine_dir,
                                        ShardedEventsDAO, "sharded")
        where, fold = template_read(_engine_from_dir(engine_dir)[1])
        direct = Storage(env=prefix_env)
        try:
            d_app = direct.get_metadata_apps().get_by_name("direct").id
            if not triples_equal(sorted_triples(cols), sorted_triples(
                    direct.get_events().columnarize(
                        d_app, until_time=shared_until(), **where,
                        **fold))):
                raise AssertionError("the sharded columnarize differs "
                                     "from the prefix store's")
            out["columnarize_triples_equal"] = True
            t0 = time.perf_counter()
            got = dao.find_columnar(app_id)
            out["find_columnar_s"] = time.perf_counter() - t0
            if column_rows(got) != column_rows(
                    direct.get_events().find_columnar(
                        d_app, until_time=shared_until())):
                raise AssertionError("the sharded find_columnar differs "
                                     "from the prefix store's")
            out["find_columnar_rows_equal"] = True
        finally:
            direct.close()
        # the frames' CRC32C (each shard's frame is checked on the server
        # as it is framed and here as it is read): the same rows framed
        # once, timed on this host
        frame = encode_columnar_events(got)
        out["columnar_frame_bytes"] = len(frame)
        out["columnar_frame_crc_s"] = crc_seconds(frame)
        out["per_shard_events"] = [len(s.find_columnar(app_id))
                                   for s in dao._dao.shards]
    finally:
        if client is not None:
            client.close()
        for proc, _ in procs:
            stop_process(proc)
    return out


def metric_value(url: str, line_start: str) -> float:
    """A sample of the event server's /metrics, by its name and labels."""
    with urllib.request.urlopen(
            f"{url}/metrics?accessKey={METRICS_KEY}", timeout=60) as r:
        for line in r.read().decode().splitlines():
            if line.startswith(line_start):
                return float(line.rsplit(" ", 1)[1])
    raise AssertionError(f"no {line_start} on {url}/metrics")


def crc_seconds(data: bytes) -> float:
    """Thread CPU seconds of one ``utils/durable.crc32c`` over ``data``."""
    from pio_tpu_torch.utils import durable

    t = time.thread_time()
    durable.crc32c(data)
    return time.thread_time() - t


def hinted_events(path: Path) -> int:
    """Events in the insert records of a replica's hint log."""
    from pio_tpu_torch.utils.durable import FrameLog

    payloads, corrupt, _ = FrameLog(str(path)).scan()
    if corrupt:
        raise AssertionError(f"{corrupt} corrupt hint records")
    return sum(len(rec.get("events", ())) for rec in map(json.loads, payloads)
               if rec.get("op") == "insert_batch")


def shared_replicated(prefix_env: dict, tmp: Path) -> dict:
    """(c) Three ``storageserver`` processes on sqlite, R 3, W 2; an
    ``eventserver`` over ``replicated`` takes the first SHARED_EVENTS
    seeded events, replica 3 SIGKILLed after SHARED_KILL_AFTER frames.
    Every slot answers 201 and every event acked after the kill is in
    its hint log; replica 3 restarted on its store drains them, a scrub
    finds nothing to repair, the three replicas' ``find_columnar`` are
    equal bit for bit (and hold the prefix store's rows), and a train
    verb through ``replicated`` launches K2 as predicted."""
    from pio_tpu_torch.data.backends.replicated import ReplicatedEventsDAO
    from pio_tpu_torch.data.columnar import encode_columnar_events
    from pio_tpu_torch.data.storage import Storage

    ev = seeded_events()
    spans = [(lo, min(SHARED_EVENTS, lo + SHARED_FRAME))
             for lo in range(0, SHARED_EVENTS, SHARED_FRAME)]
    out: dict = {"events": SHARED_EVENTS, "replicas": 3, "write_quorum": 2}
    envs = []
    for k in range(3):
        (tmp / f"replica{k}").mkdir()
        envs.append(sqlite_env(tmp / f"replica{k}"))
    procs = []
    client = None
    try:
        for k in range(3):
            procs.append(storage_server_proc(envs[k], tmp / f"replica{k}.log"))
        urls = [u for _, u in procs]

        def replicated_env(hints: Path) -> dict:
            return {"PIO_STORAGE_SOURCES_META_TYPE": "sqlite",
                    "PIO_STORAGE_SOURCES_META_PATH": str(tmp / "meta.db"),
                    "PIO_STORAGE_SOURCES_R_TYPE": "replicated",
                    "PIO_STORAGE_SOURCES_R_URLS": ",".join(urls),
                    "PIO_STORAGE_SOURCES_R_WRITE_QUORUM": "2",
                    "PIO_STORAGE_SOURCES_R_HINT_DIR": str(hints),
                    "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "META",
                    "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "R",
                    "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "META"}

        # this process's reader keeps its own hint log: the server's
        # hints are the event server's alone
        client = Storage(env=replicated_env(tmp / "hints-reader"))
        app_id, key = new_app(client, "ChipSmokeRepl")
        hints = tmp / "hints"
        with event_server(replicated_env(hints)) as url:
            first = post_frames(url, key, ev, spans[:SHARED_KILL_AFTER])
            killed, _ = procs[2]
            killed.send_signal(signal.SIGKILL)
            killed.wait(timeout=60)
            rest = post_frames(url, key, ev, spans[SHARED_KILL_AFTER:])
            statuses = dict(first["statuses"])
            for s, n in rest["statuses"].items():
                statuses[s] = statuses.get(s, 0) + n
            if statuses != {201: SHARED_EVENTS}:
                raise AssertionError(f"replicated statuses {statuses}")
            after_kill = SHARED_EVENTS - SHARED_KILL_AFTER * SHARED_FRAME
            # every acked write is on replica 3 or in its hint log: with
            # it down, in the log, written before the 201s came back
            hinted = hinted_events(hints / "replica2.hints")
            if hinted != after_kill:
                raise AssertionError(f"{hinted} events hinted for the "
                                     f"killed replica, {after_kill} acked")
            hint_log = (hints / "replica2.hints").read_bytes()
            out.update({"ingest_s": first["wall_s"] + rest["wall_s"],
                        "acked_after_kill": after_kill,
                        "hinted_before_ack": hinted,
                        # written with a CRC32C a record, checked again
                        # by the drain: the same bytes timed on this host
                        "hint_log_bytes": len(hint_log),
                        "hint_log_crc_s": crc_seconds(hint_log)})
            del hint_log
            port = int(urls[2].rsplit(":", 1)[1])
            t0 = time.perf_counter()
            procs[2] = storage_server_proc(envs[2], tmp / "replica2b.log",
                                           port=port)
            gauge = ('pio_replica_hint_depth{surface="eventserver",'
                     'replica="2"}')
            while metric_value(url, gauge):
                if time.perf_counter() - t0 > DRAIN_TIMEOUT_S:
                    raise AssertionError("replica 3's hints never drained")
                time.sleep(0.5)
            out["rejoin_drain_s"] = time.perf_counter() - t0
        inner = client.get_events()._dao
        t0 = time.perf_counter()
        scrub = inner.scrub(app_id, repair=False)
        out["scrub_s"] = time.perf_counter() - t0
        if scrub["divergentBuckets"]:
            raise AssertionError(f"scrub after the drain: {scrub}")
        out["scrub"] = scrub
        reads = [r.find_columnar(app_id) for r in inner.replicas]
        frames = [encode_columnar_events(c) for c in reads]
        if frames[1] != frames[0] or frames[2] != frames[0]:
            raise AssertionError("the replicas' columnar reads differ")
        direct = Storage(env=prefix_env)
        try:
            d_app = direct.get_metadata_apps().get_by_name("direct").id
            if column_rows(reads[0]) != column_rows(
                    direct.get_events().find_columnar(
                        d_app, until_time=shared_until())):
                raise AssertionError("the replicas differ from the prefix "
                                     "store")
        finally:
            direct.close()
        out["replicas_equal"] = True
        del reads, frames
        engine_dir = train_engine_dir(tmp, "chip-smoke-replicated",
                                      "ChipSmokeRepl")
        out["train"], _ = train_verb(client, engine_dir,
                                     ReplicatedEventsDAO, "replicated")
    finally:
        if client is not None:
            client.close()
        for proc, _ in procs:
            if proc.poll() is None:
                stop_process(proc)
    return out


def phase_shared_store(sqlite, dev: torch.device, ingest: dict,
                       entry: dict) -> dict:
    """One store shared over the wire: (a) ``remote``, (b) ``sharded``,
    (c) ``replicated``, each arm's wall seconds beside it."""
    out: dict = {}
    with tempfile.TemporaryDirectory(prefix="pio_chip_shared_") as tmp:
        tmp = Path(tmp)
        for name, arm, args in (
                ("remote", shared_remote, (sqlite, dev, entry)),
                ("sharded", shared_sharded, (ingest["prefix_env"],)),
                ("replicated", shared_replicated, (ingest["prefix_env"],))):
            (tmp / name).mkdir()
            t0 = time.perf_counter()
            out[name] = arm(*args, tmp / name)
            out[name]["wall_s"] = time.perf_counter() - t0
    emit("shared_store", card=card_line(), **out)
    return out


# -- phase 11b: the README quickstart through the port's verbs ----------------

QUICKSTART_QUERIES = 8


def phase_quickstart(dev: torch.device) -> dict:
    """The README quickstart on a fresh sqlite store: ``app new
    quickstart``, ``import`` of ``examples/quickstart/events.jsonl.gz``
    (100,000 events, read in place), an event server process taking one
    ``POST /events.json`` and one segment.io webhook, ``train`` with the
    committed engine.json's params (K2 in every flush), the instance
    deployed (what ``deploy`` serves) answering QUICKSTART_QUERIES
    queries through ``sdk.EngineClient``, held to the exact top-k, then
    ``export``."""
    from pio_tpu_torch import sdk
    from pio_tpu_torch.__main__ import _engine_from_variant, _load_variant
    from pio_tpu_torch.data.eventstore import EventStore
    from pio_tpu_torch.ops import als
    from pio_tpu_torch.workflow.context import create_workflow_context
    from pio_tpu_torch.workflow.serve import ServingConfig, create_query_server

    src = REPO_ROOT / "examples" / "quickstart"
    secs: dict = {}
    out: dict = {}
    with sqlite_store("pio_chip_quickstart_") as store:
        storage = store.storage
        t0 = time.perf_counter()
        app_id, key = new_app(storage, "quickstart")
        secs["app_new"] = time.perf_counter() - t0
        rc, printed, secs["import"] = _cli(
            ["import", "--appid", str(app_id), "--input",
             str(src / "events.jsonl.gz")], storage)
        if rc != 0 or "Imported 100000 events (0 failed)" not in printed:
            raise AssertionError(f"import: rc {rc}: {printed}")
        with event_server(store.env) as url:
            t0 = time.perf_counter()
            sdk.EventClient(key, url).create_event(
                "rate", "user", "u_quickstart", "item", "i_1", {"rating": 5})
            secs["post_event"] = time.perf_counter() - t0
            hook = json.dumps({
                "version": "2", "type": "track", "userId": "u_quickstart",
                "event": "signup", "properties": {"plan": "pro"},
                "timestamp": "2024-06-01T00:00:00.000Z"}).encode()
            t0 = time.perf_counter()
            status = post_raw(url, f"/webhooks/segmentio.json?accessKey={key}",
                              hook, "application/json")
            secs["webhook"] = time.perf_counter() - t0
            if status != 201:
                raise AssertionError(f"segment.io webhook: {status}")

        engine_dir = store.tmp / "engine"
        engine_dir.mkdir()
        variant = json.loads((src / "engine.json").read_text())
        variant["engineFactory"] = FACTORY
        (engine_dir / "engine.json").write_text(json.dumps(variant))
        variant = _load_variant(str(engine_dir))
        engine, ep = _engine_from_variant(variant, str(engine_dir))
        ds = ep.datasource[1]
        inter = EventStore(storage).interactions(
            ds.app_name, entity_type="user", target_entity_type="item",
            event_names=list(ds.event_names), value_key="rating",
            default_value=ds.implicit_value, value_event=ds.rating_event,
            dedup="last")
        want_k2 = expected_flush_launches(
            len(inter.values), inter.n_users, inter.n_items,
            engine.algorithm_classes["als"](ep.algorithms[0][1])
            ._als_params())
        # -- the main path: counts from 0, read right after ----------------
        reset_counts()
        rc, printed, secs["train"] = _cli(
            ["train", "--engine-dir", str(engine_dir)], storage)
        launches = read_counts()
        # -----------------------------------------------------------------
        if rc != 0 or launches != {**dict.fromkeys(launches, 0),
                                   "segment_flush": want_k2}:
            raise AssertionError(f"quickstart train: rc {rc}, launches "
                                 f"{launches}, want {want_k2} of K2")

        t0 = time.perf_counter()
        http, qs = create_query_server(
            engine, ep, storage,
            ServingConfig(ip="127.0.0.1", port=0, engine_id=variant["id"]),
            ctx=create_workflow_context(storage, device=dev))
        http.start()
        secs["deploy_load"] = time.perf_counter() - t0
        try:
            client = sdk.EngineClient(f"http://127.0.0.1:{http.port}")
            model = qs.models[0]
            picked = np.random.default_rng(SEED + 12).choice(
                len(model.users), QUICKSTART_QUERIES, replace=False)
            query_ms = []
            for r in picked:
                t0 = time.perf_counter()
                body = client.send_query({"user": model.users.ids()[r],
                                          "num": 10})
                query_ms.append(1e3 * (time.perf_counter() - t0))
                scores, idx = als.recommend_topk(model.factors, [r], 10)
                _check_same(body, {"itemScores": [
                    {"item": it, "score": float(sc)} for it, sc in zip(
                        model.items.decode(idx[0].cpu().numpy()),
                        scores[0].cpu().numpy())]},
                    f"quickstart {model.users.ids()[r]}")
        finally:
            http.stop()
            qs.close()

        path = store.tmp / "export.jsonl"
        rc, printed, secs["export"] = _cli(
            ["export", "--appid", str(app_id), "--output", str(path)],
            storage)
        if rc != 0 or f"Exported 100002 events to {path}" not in printed:
            raise AssertionError(f"export: rc {rc}: {printed}")
        # the re-import of the export is cut for time (PERF.md section 4)
        out.update({"launches": launches, "segment_flush_expected": want_k2,
                    "ratings": len(inter.values), "users": inter.n_users,
                    "items": inter.n_items, "verb_s": secs,
                    "query_ms": query_ms})
    emit("quickstart", card=card_line(), **out)
    return out

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
        hedged = qs.hedged_dispatches
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
        hedged = qs.hedged_dispatches - hedged
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
    check_serving_launches(launches, "flash_attention",
                           SEQ_ALGO["num_layers"] * scored, hedged,
                           SEQ_ALGO["num_layers"])
    lat_ms = sorted(1e3 * t for t in latencies)
    result = {
        "users": len(model.users), "items": len(model.items),
        "events": n_events, "write_s": write_s, "train_s": train_s,
        "instance": iid, "train_launches": train_launches,
        "launches": launches, "hedged_dispatches": hedged,
        "scored_batches": scored,
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


# -- phase 16: evaluation and tuning --------------------------------------------

# the ALS sweep on train_entry's events: one shape group of 2 candidates
# (the batched path), map@10 first, every other metric beside it; the
# grid's alpha 1.0 was cut, as the foldin users above
EVAL_GRID = '{"lambda_": [0.01, 0.05], "alpha": [10.0]}'
EVAL_OTHERS = "ndcg@10,precision@10,recall@10,auc"
EVAL_FOLDS, EVAL_TIME_FOLDS, EVAL_SEED = 3, 2, 42
# the serve phase's retrieval block, its cluster count and probe stated
EVAL_RETRIEVAL = {**RETRIEVAL, "n_clusters": 256, "nprobe": 32}
EVAL_ORACLE_USERS = 256     # fold-0 test users held to the scalar oracles
# candidate c of the stacked trainer against the sequential trainer (the
# CPU test's tolerances): factors within 1e-5 relative, map@10 within the
# reference's own stacked-vs-sequential abs 0.02; batched metrics (f32)
# against the float64 oracles within 1e-5
STACKED_RTOL, EVAL_SCORE_ABS, ORACLE_ABS = 1e-5, 0.02, 1e-5
# class mode scores a seeded sample of each fold's test queries: the
# template's batch_predict answers a fold in one call, whose two-stage
# retrieval at ~10^5 users would hold (B, rerank, k) = 131,072 x 1,024 x
# 64 f32 (34 GB); without the seen-item blackLists (the zipf head user has
# seen most of the catalog, and the batch's top-k depth is its largest
# blackList)
CLASS_SAMPLE = 4_096
BATCHPREDICT_QUERIES, BATCHPREDICT_BATCH = 4_096, 256
FROM_EVAL_QUERIES, BATCHPREDICT_CHECK = 8, 64
# the sequence template's sweep: examples/sequence/engine.json's widths
# with K8 in the training forward, through the sequential fallback
SEQ_SWEEP_GRID = '{"learning_rate": [0.001, 0.002]}'
SEQ_SWEEP_FOLDS = 2
SEQ_SWEEP_ALGO = {k: v for k, v in SEQ_ALGO.items() if k != "app_name"} | {
    "attention": "flash"}

EVAL_CLASSES = '''"""Class-mode evaluation of the recommendation template (user code)."""
from dataclasses import dataclass

import numpy as np

from pio_tpu_torch.controller import (
    EngineParams, EngineParamsGenerator, Evaluation, FastEvalEngine,
    FirstServing, IdentityPreparator)
from pio_tpu_torch.models.recommendation import (
    ALSAlgorithm, ALSAlgorithmParams, DataSourceParams,
    RecommendationDataSource)
from pio_tpu_torch.tuning.metrics import MAPAtK, NDCGAtK


@dataclass(frozen=True)
class SampledParams(DataSourceParams):
    sample: int = 0
    sample_seed: int = 0


class SampledDataSource(RecommendationDataSource):
    """The template's index-mod-k folds, each scored on a seeded sample
    of its test queries."""

    params_class = SampledParams

    def read_eval(self, ctx):
        out = []
        for f, (train, info, qa) in enumerate(super().read_eval(ctx)):
            keep = np.random.default_rng(self.params.sample_seed + f).choice(
                len(qa), min(self.params.sample, len(qa)), replace=False)
            out.append((train, info, [qa[j] for j in sorted(keep)]))
        return out


class ChipEval(Evaluation):
    engine = FastEvalEngine(SampledDataSource, IdentityPreparator,
                            {{"als": ALSAlgorithm}}, FirstServing)
    metric = MAPAtK(10)
    metrics = [NDCGAtK(10)]


class ChipGrid(EngineParamsGenerator):
    engine_params_list = [
        EngineParams(
            datasource=("", SampledParams(
                app_name="{app}", eval_k={folds}, eval_exclude_seen=False,
                sample={sample})),
            algorithms=[("als", ALSAlgorithmParams(
                rank={rank}, num_iterations={iters}, lambda_=lam,
                alpha=10.0, implicit_prefs=True, retrieval={retrieval!r}))])
        for lam in (0.01, 0.05)
    ]
'''


def _cli(argv: list, storage) -> tuple[int, str, float]:
    """``python -m pio_tpu_torch <argv>`` in process on ``storage``:
    (exit code, what it printed, seconds)."""
    from pio_tpu_torch.__main__ import main as cli_main
    from pio_tpu_torch.data.storage import set_storage

    set_storage(storage)
    out = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            rc = cli_main(argv)
    finally:
        set_storage(None)
    printed = out.getvalue().strip()
    print(printed, flush=True)
    return rc, printed, time.perf_counter() - t0


def _eval_scores(storage, eval_id: str) -> dict:
    inst = storage.get_metadata_evaluation_instances().get(eval_id)
    if inst is None or inst.status != "EVALCOMPLETED":
        raise AssertionError(f"evaluation {eval_id}: "
                             f"{inst and inst.status}")
    res = json.loads(inst.evaluator_results_json)
    scores = [[s["score"], *s["otherScores"]] for s in res["allScores"]]
    if not all(isinstance(x, float) and np.isfinite(x)
               for row in scores for x in row):
        raise AssertionError(f"evaluation {eval_id}: scores {scores}")
    return {"headers": [res["metricHeader"], *res["otherMetricHeaders"]],
            "scores": scores, "best_index": res["bestIndex"],
            "best_score": res["bestScore"]}


def sweep_fold0_check(storage, engine, ep, dev: torch.device, eval_id: str,
                      args) -> dict:
    """Fold 0 of the batched sweep again, outside the verb: the stacked
    trainer's candidate c against a sequential ``als_train(
    sweep_safe_params(...))`` with c's (reg, alpha) from the same seeded
    init (factors and map@10), the fold's stored map@10 sums against this
    run's, and a sample of test users' batched metrics against the scalar
    oracles."""
    from pio_tpu_torch.__main__ import _sweep_candidates
    from pio_tpu_torch.ops import als
    from pio_tpu_torch.tuning import metrics as tm
    from pio_tpu_torch.tuning.records import load_sweep_state
    from pio_tpu_torch.tuning.splits import folds_for
    from pio_tpu_torch.tuning.sweep import (
        _score_stacked,
        _stacked_topk,
        stacked_base_params,
    )
    from pio_tpu_torch.workflow.context import create_workflow_context

    cands = _sweep_candidates(engine, ep, args)
    params = [c.algorithms[0][1] for c in cands]
    ctx = create_workflow_context(storage, device=dev)
    ds = engine._doers(cands[0])[0]
    data = ds.read_training(ctx)
    fold = folds_for(data, "kfold", EVAL_FOLDS, seed=EVAL_SEED)[0]
    t = fold.train
    base = stacked_base_params(params[0])
    regs = np.array([p.lambda_ for p in params], np.float32)
    alphas = np.array([p.alpha for p in params], np.float32)
    reset_counts()
    t0 = time.perf_counter()
    st = als.als_train_stacked(t.user_idx, t.item_idx, t.values, t.n_users,
                               t.n_items, base, regs, alphas, device=dev)
    torch.cuda.synchronize()
    stacked_s = time.perf_counter() - t0
    launches = read_counts()
    if any(launches.values()):
        raise AssertionError(f"the stacked trainer launched {launches}")
    m10 = tm.MAPAtK(10)
    stacked_map = _score_stacked(st, fold, [m10], 512)
    stored = load_sweep_state(storage, eval_id).completed["fold0"][
        "candidates"]
    out = {"test_users": fold.n_test_users, "train_ratings": len(t),
           "stacked_s": stacked_s, "candidates": []}
    for c, p in enumerate(params):
        t0 = time.perf_counter()
        seq = als.als_train(
            t.user_idx, t.item_idx, t.values, t.n_users, t.n_items,
            als.sweep_safe_params(replace(base, reg=p.lambda_,
                                          alpha=p.alpha), dev),
            device=dev)
        torch.cuda.synchronize()
        seq_s = time.perf_counter() - t0
        rel = max(float((got - want).abs().max() / want.abs().max())
                  for got, want in ((st.user_factors[c], seq.user_factors),
                                    (st.item_factors[c],
                                     seq.item_factors)))
        single = als.StackedALSModel(seq.user_factors[None],
                                     seq.item_factors[None])
        (s_seq, n_seq), = _score_stacked(single, fold, [m10], 512)[0]
        s_st, n_st = stacked_map[c][0]
        row = {"lambda_": p.lambda_, "alpha": p.alpha, "sequential_s": seq_s,
               "factors_max_rel_diff": rel,
               "map10_stacked": s_st / n_st, "map10_sequential": s_seq / n_seq,
               "map10_stored": stored[c]["MAP@10"]}
        out["candidates"].append(row)
        if rel > STACKED_RTOL or n_st != n_seq or abs(
                s_st / n_st - s_seq / n_seq) > EVAL_SCORE_ABS:
            raise AssertionError(f"fold 0, candidate {c}: {row}")
        if stored[c]["MAP@10"] != [s_st, n_st]:
            raise AssertionError(f"fold 0, candidate {c}: the sweep stored "
                                 f"{stored[c]['MAP@10']}, this run gives "
                                 f"{[s_st, n_st]}")
        del seq, single
    # what a candidate costs trained alone through K2 (accum "auto" on
    # the card), beside the stacked group's share
    t0 = time.perf_counter()
    als.als_train(t.user_idx, t.item_idx, t.values, t.n_users, t.n_items,
                  replace(base, reg=params[0].lambda_,
                          alpha=params[0].alpha), device=dev)
    torch.cuda.synchronize()
    out["hybrid_one_candidate_s"] = time.perf_counter() - t0
    # a sample of the fold's test users: batched metrics vs the oracles
    sel = np.sort(np.random.default_rng(SEED + 6).choice(
        fold.n_test_users, EVAL_ORACLE_USERS, replace=False))
    actual = [fold.actual_idx[j] for j in sel]
    seen = tm.pad_actuals([fold.seen_idx[j] for j in sel])
    actual_p = tm.pad_actuals(actual)
    scores, top = _stacked_topk(st.user_factors, st.item_factors,
                                fold.test_user_idx[sel], seen, 16)
    worst = {}
    for name, metric, oracle in (
            ("map@10", m10, tm.map_at_k_scalar),
            ("ndcg@10", tm.NDCGAtK(10), tm.ndcg_at_k_scalar),
            ("precision@10", tm.PrecisionAtK(10), tm.precision_at_k_scalar),
            ("recall@10", tm.RecallAtK(10), tm.recall_at_k_scalar)):
        got = metric.score_ranked(top, actual_p[None])
        ranked = top.cpu().numpy()
        err = 0.0
        for c in range(len(params)):
            for j, a in enumerate(actual):
                want = oracle(list(ranked[c, j]), list(a), 10)
                err = max(err, abs(float(got[c, j]) - want))
        worst[name] = err
    n_items = int(st.item_factors.shape[1])
    pos = np.zeros((len(sel), n_items), bool)
    valid = np.ones((len(sel), n_items), bool)
    for j, jj in enumerate(sel):
        pos[j, fold.actual_idx[jj]] = True
        valid[j, fold.seen_idx[jj]] = False
        valid[j, fold.actual_idx[jj]] = True
    best = int(np.argmax([r["map10_stacked"] for r in out["candidates"]]))
    got = tm.AUC().score_full(scores[best], pos, valid)
    row_scores = scores[best].cpu().numpy().tolist()
    worst["auc"] = max(abs(float(got[j]) - tm.auc_scalar(
        row_scores[j], list(np.flatnonzero(pos[j])),
        list(np.flatnonzero(valid[j])))) for j in range(len(sel)))
    out["oracle_users"] = len(sel)
    out["oracle_max_abs_diff"] = worst
    if max(worst.values()) > ORACLE_ABS:
        raise AssertionError(f"batched metrics vs the oracles: {worst}")
    return out


def sweep_resume_drill(storage, engine_dir: Path, tmp: Path,
                       uninterrupted: dict) -> dict:
    """The time-split sweep killed at ``eval.fold.1`` (a chaos fault,
    after fold 0 is stored), then ``--resume-eval``: the resumed result
    must be the uninterrupted run's, every score bit for bit."""
    from pio_tpu_torch.resilience import chaos
    from pio_tpu_torch.tuning.records import load_sweep_state

    argv = ["eval", "--sweep", "--engine-dir", str(engine_dir), "--grid",
            EVAL_GRID, "--metric", "map@10", "--other-metrics", EVAL_OTHERS,
            "--folds", str(EVAL_TIME_FOLDS), "--split", "time", "--seed",
            str(EVAL_SEED), "--output", str(tmp / "best_resumed.json")]
    dao = storage.get_metadata_evaluation_instances()
    before = {i.id for i in dao.get_all()}
    t0 = time.perf_counter()
    try:
        with chaos.inject("eval.fold.1", error=1.0):
            _cli(argv, storage)
        raise AssertionError("the chaos fault at eval.fold.1 did not fire")
    except chaos.ChaosError:
        pass
    killed_s = time.perf_counter() - t0
    [failed] = [i for i in dao.get_all() if i.id not in before]
    done = sorted(load_sweep_state(storage, failed.id).completed)
    if failed.status != "EVALFAILED" or done != ["fold0"]:
        raise AssertionError(f"killed sweep: {failed.status}, {done}")
    rc, printed, resumed_s = _cli([*argv, "--resume-eval", failed.id],
                                  storage)
    got = _eval_scores(storage, failed.id)
    want = {k: uninterrupted[k] for k in got}
    if rc != 0 or got != want:
        raise AssertionError(f"resumed sweep {got} differs from the "
                             f"uninterrupted {want}")
    return {"eval_id": failed.id, "killed_s": killed_s,
            "resumed_s": resumed_s, "identical": True}


def phase_evaluate(store, dev: torch.device, entry: dict) -> dict:
    """Evaluation and tuning on train_entry's events (the ML-20M
    catalog, rank 64, 10 sweeps, implicit): ``eval --sweep`` with 2
    candidates as one stacked group on 3 seeded k-folds (fold 0 checked
    again outside the verb), the same grid on 2 time folds (killed at
    fold 1 and resumed as well), ``eval
    <Evaluation> <ParamsGenerator>`` (K2 in its 6 trainings, K7 in its 6
    ``batch_predict`` calls), ``train --from-eval`` and ``deploy
    --from-eval`` of the winner, and ``batchpredict`` of 4,096 queries
    (K7) checked against the deploy."""
    from types import SimpleNamespace

    from pio_tpu_torch.__main__ import _engine_from_variant, _load_variant
    from pio_tpu_torch.models.recommendation import ALSAlgorithm
    from pio_tpu_torch.tuning.records import load_best_params

    tmp, storage = store.tmp, store.storage
    engine_dir = tmp / "engine_eval"
    engine_dir.mkdir()
    (engine_dir / "engine.json").write_text(json.dumps({
        "id": "chip-smoke-eval", "engineFactory": FACTORY,
        "datasource": {"params": {"app_name": "ChipSmoke"}},
        "algorithms": [{"name": "als", "params": {
            "rank": RANK, "num_iterations": ITERS, "lambda_": 0.05,
            "alpha": 10.0, "implicit_prefs": True,
            "retrieval": EVAL_RETRIEVAL}}],
    }))
    variant = _load_variant(str(engine_dir))
    engine, ep = _engine_from_variant(variant, str(engine_dir))
    records = _Records()
    tuning_log = logging.getLogger("pio_tpu_torch.tuning")
    tuning_log.addHandler(records)
    tuning_log.setLevel(logging.INFO)
    result = {}
    try:
        # -- 1. the batched sweep: counts from 0, read right after -------
        sweeps = {}
        for split, folds in (("kfold", EVAL_FOLDS),
                             ("time", EVAL_TIME_FOLDS)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            rc, printed, wall_s = _cli([
                "eval", "--sweep", "--engine-dir", str(engine_dir),
                "--grid", EVAL_GRID, "--metric", "map@10",
                "--other-metrics", EVAL_OTHERS, "--folds", str(folds),
                "--split", split, "--seed", str(EVAL_SEED),
                "--output", str(tmp / f"best_{split}.json")], storage)
            launches = read_counts()
            peak = torch.cuda.max_memory_allocated()
            if rc != 0:
                raise AssertionError(f"eval --sweep --split {split}: rc {rc}")
            eval_id = printed.split("Evaluation instance: ")[1].split()[0]
            [(_, timings)] = records.take("sweep %s timings")
            timings = json.loads(timings)
            if timings["mode"] != "batched" or any(launches.values()):
                raise AssertionError(f"sweep {split}: mode "
                                     f"{timings['mode']}, launches "
                                     f"{launches}")
            sweeps[split] = {"eval_id": eval_id, "wall_s": wall_s,
                             "peak_bytes": peak, "timings": timings,
                             "launches": launches,
                             **_eval_scores(storage, eval_id)}
        result["sweep"] = sweeps
        result["time_resume"] = sweep_resume_drill(
            storage, engine_dir, tmp, sweeps["time"])
        kfold_id = sweeps["kfold"]["eval_id"]
        result["fold0_check"] = sweep_fold0_check(
            storage, engine, ep, dev, kfold_id,
            SimpleNamespace(params_generator="", grid=EVAL_GRID,
                            engine_dir=str(engine_dir)))
        torch.cuda.empty_cache()

        # -- 2. class mode ----------------------------------------------
        (engine_dir / "chip_eval_classes.py").write_text(
            EVAL_CLASSES.format(app="ChipSmoke", folds=EVAL_FOLDS,
                                sample=CLASS_SAMPLE, rank=RANK,
                                iters=ITERS, retrieval=EVAL_RETRIEVAL))
        n = entry["ratings"]
        p = ALSAlgorithm(ep.algorithms[0][1])._als_params()
        want_k2 = 2 * sum(expected_flush_launches(
            n - (n - f + EVAL_FOLDS - 1) // EVAL_FOLDS, N_USERS, N_ITEMS, p)
            for f in range(EVAL_FOLDS))
        want_k7 = 2 * EVAL_FOLDS
        reset_counts()
        rc, printed, wall_s = _cli([
            "eval", "chip_eval_classes.ChipEval",
            "chip_eval_classes.ChipGrid", "--engine-dir", str(engine_dir),
            "--output", str(tmp / "best_class.json")], storage)
        launches = read_counts()
        class_id = printed.split("Instance: ")[1].split()[0]
        if rc != 0 or launches != {**dict.fromkeys(launches, 0),
                                   "segment_flush": want_k2,
                                   "quantized_scan": want_k7}:
            raise AssertionError(f"class mode: rc {rc}, launches "
                                 f"{launches}, want K2 {want_k2}, K7 "
                                 f"{want_k7}")
        result["class_mode"] = {
            "eval_id": class_id, "wall_s": wall_s, "launches": launches,
            "segment_flush_launches_expected": want_k2,
            "quantized_scan_launches_expected": want_k7,
            "queries_per_fold": CLASS_SAMPLE,
            **_eval_scores(storage, class_id)}

        # -- 3. train and deploy the winner --------------------------------
        best = load_best_params(storage, kfold_id)
        reset_counts()
        rc, printed, train_s = _cli([
            "train", "--engine-dir", str(engine_dir), "--from-eval",
            kfold_id], storage)
        launches = read_counts()
        iid = printed.rsplit(" ", 1)[-1]
        inst = storage.get_metadata_engine_instances().get(iid)
        winner = engine.engine_params_from_variant(
            {"algorithms": best["variant"]["algorithms"]}).algorithms
        want_k2 = expected_flush_launches(n, N_USERS, N_ITEMS,
                                          ALSAlgorithm(winner[0][1])
                                          ._als_params())
        if (rc != 0 or inst.status != "COMPLETED"
                or inst.batch != f"from-eval:{kfold_id}"
                or inst.algorithms_params != f"{winner}"
                or launches != {**dict.fromkeys(launches, 0),
                                "segment_flush": want_k2}):
            raise AssertionError(f"train --from-eval: rc {rc}, {inst}, "
                                 f"launches {launches}")
        rng = np.random.default_rng(SEED + 7)
        users = rng.choice(N_USERS, BATCHPREDICT_QUERIES, replace=False)
        queries = [{"user": f"u{u}", "num": 10} for u in users]
        check = sorted(rng.choice(BATCHPREDICT_QUERIES, BATCHPREDICT_CHECK,
                                  replace=False).tolist())
        proc = subprocess.Popen(
            [sys.executable, "-m", "pio_tpu_torch", "deploy",
             "--engine-dir", str(engine_dir), "--port", "0", "--ip",
             "127.0.0.1", "--from-eval", kfold_id],
            cwd=REPO_ROOT, env={**os.environ, **store.env},
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            first = proc.stdout.readline()
            line = proc.stdout.readline()
            if kfold_id not in first or f"{iid} deployed" not in line:
                raise AssertionError(
                    f"deploy --from-eval: {first!r} {line!r} "
                    + (proc.stderr.read() if proc.poll() is not None
                       else ""))
            port = int(line.split("127.0.0.1:")[1].split()[0])
            deploy_ms, deployed = [], {}
            for j in range(FROM_EVAL_QUERIES):
                status, body, dt = _post(port, "/queries.json", queries[j])
                if status != 200 or len(body["itemScores"]) != 10:
                    raise AssertionError(f"deploy --from-eval: {body}")
                deploy_ms.append(1e3 * dt)
            for j in check:
                status, deployed[j], _ = _post(port, "/queries.json",
                                               queries[j])
                assert status == 200, deployed[j]
        finally:
            proc.terminate()
            try:
                proc.communicate(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.communicate()
        result["from_eval"] = {"eval_id": kfold_id, "instance": iid,
                               "train_s": train_s, "launches": launches,
                               "segment_flush_launches_expected": want_k2,
                               "deploy_query_ms": deploy_ms}

        # -- 4. batchpredict of the winner's instance ----------------------
        inp = tmp / "queries.jsonl"
        outp = tmp / "predictions.jsonl"
        inp.write_text("".join(json.dumps(q) + "\n" for q in queries))
        want_k7 = -(-BATCHPREDICT_QUERIES // BATCHPREDICT_BATCH)
        reset_counts()
        rc, _, wall_s = _cli([
            "batchpredict", "--engine-dir", str(engine_dir), "--input",
            str(inp), "--output", str(outp), "--batch-size",
            str(BATCHPREDICT_BATCH)], storage)
        launches = read_counts()
        lines = [json.loads(x) for x in outp.read_text().splitlines()]
        if rc != 0 or launches != {**dict.fromkeys(launches, 0),
                                   "quantized_scan": want_k7}:
            raise AssertionError(f"batchpredict: rc {rc}, launches "
                                 f"{launches}, want K7 {want_k7}")
        if [x["query"] for x in lines] != queries or any(
                len(x["prediction"]["itemScores"]) != 10 for x in lines):
            raise AssertionError("batchpredict: lines out of order or short")
        # the deploy answers a query alone, batchpredict in batches of
        # 256: scores within the scan's tolerance, ids equal but where
        # near-tied
        for j in check:
            _check_same(lines[j]["prediction"], deployed[j],
                        f"batchpredict line {j} against the deploy")
        same_ids = sum(_ranking(lines[j]["prediction"])[0]
                       == _ranking(deployed[j])[0] for j in check)
        result["batchpredict"] = {
            "queries": len(lines), "wall_s": wall_s,
            "queries_per_s": len(lines) / wall_s, "launches": launches,
            "quantized_scan_launches_expected": want_k7,
            "checked_against_deploy": len(check),
            "ids_equal_to_deploy": same_ids}
    finally:
        tuning_log.removeHandler(records)
    emit("evaluate", **result)
    return result


def phase_evaluate_sequence(store, dev: torch.device) -> dict:
    """``eval --sweep`` of the sequence template on sequence_entry's
    events: its grid is not ALS-shaped, so it runs candidate by candidate
    through the rolling read_eval (2 folds), K8 in every training forward
    and in each fold's scoring batch."""
    tmp, storage = store.tmp, store.storage
    engine_dir = tmp / "engine_seq_eval"
    engine_dir.mkdir()
    (engine_dir / "engine.json").write_text(json.dumps({
        "id": "chip-smoke-seq-eval", "engineFactory": SEQ_FACTORY,
        "datasource": {"params": {"app_name": SEQ_ALGO["app_name"],
                                  "event_names": ["view", "buy"],
                                  "max_len": SEQ_ALGO["max_len"]}},
        "algorithms": [{"name": "sasrec", "params": SEQ_SWEEP_ALGO}],
    }))
    n_cand = len(json.loads(SEQ_SWEEP_GRID)["learning_rate"])
    layers = SEQ_SWEEP_ALGO["num_layers"]
    # a forward per training step, one scoring batch per fold
    want_k8 = n_cand * SEQ_SWEEP_FOLDS * layers * (SEQ_SWEEP_ALGO["steps"]
                                                   + 1)
    records = _Records()
    tuning_log = logging.getLogger("pio_tpu_torch.tuning")
    tuning_log.addHandler(records)
    tuning_log.setLevel(logging.INFO)
    try:
        reset_counts()
        rc, printed, wall_s = _cli([
            "eval", "--sweep", "--engine-dir", str(engine_dir), "--grid",
            SEQ_SWEEP_GRID, "--metric", "map@10", "--folds",
            str(SEQ_SWEEP_FOLDS), "--output", str(tmp / "best_seq.json")],
            storage)
        launches = read_counts()
        [(_, timings)] = records.take("sweep %s timings")
    finally:
        tuning_log.removeHandler(records)
    timings = json.loads(timings)
    if rc != 0 or timings["mode"] != "sequential" or launches != {
            **dict.fromkeys(launches, 0), "flash_attention": want_k8}:
        raise AssertionError(f"sequence sweep: rc {rc}, mode "
                             f"{timings['mode']}, launches {launches}, "
                             f"want K8 {want_k8}")
    eval_id = printed.split("Evaluation instance: ")[1].split()[0]
    result = {"eval_id": eval_id, "wall_s": wall_s, "launches": launches,
              "flash_attention_launches_expected": want_k8,
              "seconds_per_candidate": [c["s"]
                                        for c in timings["candidates"]],
              **_eval_scores(storage, eval_id)}
    emit("evaluate_sequence", **result)
    return result


def _kernel_entry(name: str, source: str, replaces: str, launches: int,
                  case: dict, **extra) -> dict:
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": case["max_abs_err"], "ms": case["ms"],
            "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
            "bound_by": case["bound_by"], "library_ms": case["library_ms"],
            **extra, "ok": True}


def run_timed(wall: dict, start: float, name: str, fn, *args):
    """``fn(*args)``, its seconds into ``wall[name]``."""
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.empty_cache()
    wall[name] = time.perf_counter() - t0
    # on stderr, so a run cut at its time limit shows where it was
    print(f"chip_smoke: {name} {wall[name]:.1f} s, "
          f"{time.perf_counter() - start:.1f} s in all",
          file=sys.stderr, flush=True)
    return out


SEQUENCE_LANE = "--sequence-lane"


def sequence_lane(out: Path) -> int:
    """The sequence template's end-to-end phases (sequence_entry,
    train_resume, evaluate_sequence) in a process of their own, which
    ``main`` starts beside the ALS event phases: their seconds and K8's
    launches on their paths are written to ``out`` as JSON."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    # a SIGTERM from main unwinds the phases, whose cleanup stops the
    # processes they started
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    cuda_settings()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    wall: dict = {}
    timed = functools.partial(run_timed, wall, time.perf_counter())
    with sqlite_store("pio_chip_seq_") as store:
        seq_entry = timed("sequence_entry", phase_sequence_entry, store, dev)
        resume = timed("train_resume", phase_train_resume, store, dev)
        seq_eval = timed("evaluate_sequence", phase_evaluate_sequence,
                         store, dev)
    out.write_text(json.dumps({"wall": wall, "flash_attention": {
        "sequence_entry": seq_entry["launches"]["flash_attention"],
        "train_resume": {name: run["launches"]["flash_attention"]
                         for name, run in resume["runs"].items()},
        "train_resume_deploy": resume["serve_launches"]["flash_attention"],
        "evaluate_sequence": seq_eval["launches"]["flash_attention"]}}))
    return 0


@contextlib.contextmanager
def sequence_lane_process(tmp: Path):
    """Runs ``sequence_lane`` in a child process while the block runs;
    yields a function that waits for it, replays its JSON lines on this
    process's output and returns what it wrote. The child is killed if
    the block raises: SIGTERM first, on which it stops the processes it
    started, as a failed phase does."""
    lines, result = tmp / "sequence_lane.out", tmp / "sequence_lane.json"
    with open(lines, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), SEQUENCE_LANE,
             str(result)], cwd=REPO_ROOT, stdout=out)

    def join() -> dict:
        rc = proc.wait()
        sys.stdout.write(lines.read_text())
        sys.stdout.flush()
        if rc != 0:
            raise AssertionError(f"the sequence lane exited with rc {rc}")
        return json.loads(result.read_text())

    try:
        yield join
    finally:
        if proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()


def main() -> int:
    device = phase_device()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    wall = {}
    start = time.perf_counter()
    timed = functools.partial(run_timed, wall, start)

    timed("build", phase_build)
    users, items = make_factors()
    scan = timed("scan_kernel", phase_scan_kernel, users, items, dev)
    # serve persists the seeded model once; serve_batching deploys it and
    # serve_rollout canaries others against it
    with tempfile.TemporaryDirectory(prefix="pio_chip_serve_") as tmp:
        serve = timed("serve", phase_serve, users, items, dev, Path(tmp))
        batching = timed("serve_batching", phase_serve_batching, users,
                         items, dev, Path(tmp), serve["instance"])
        rollout = timed("serve_rollout", phase_serve_rollout, users, items,
                        dev, Path(tmp), serve["instance"])
    fleet = timed("serve_fleet", phase_serve_fleet, users, items, dev)
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
    attn = timed("attention_kernel", phase_attention_kernel, dev)
    timed("sequence_train", phase_sequence_train, dev)
    # every kernel's timing and training throughput is taken above, the
    # card to itself; the sequence template's end-to-end phases then run
    # in a second process beside the ALS event phases below (their host
    # times are taken under each other's load)
    with tempfile.TemporaryDirectory(prefix="pio_chip_lane_") as tmp, \
            sequence_lane_process(Path(tmp)) as join_sequence_lane:
        # the N_EVENTS seeded events are written once, for both phases
        with sqlite_store("pio_chip_train_") as store:
            ingest = timed("ingest", phase_ingest, store)
            log = timed("eventlog", phase_eventlog, store, dev)
            entry = timed("train_entry", phase_train_entry, store, dev,
                          ingest)
            shared = timed("shared_store", phase_shared_store, store, dev,
                           ingest, entry)
            evaluate = timed("evaluate", phase_evaluate, store, dev, entry)
        quickstart = timed("quickstart", phase_quickstart, dev)
        t0 = time.perf_counter()
        lane = join_sequence_lane()
        wall["sequence_lane_wait"] = time.perf_counter() - t0
    wall.update(lane["wall"])
    k8 = lane["flash_attention"]
    # the sequence lane's phases overlap the ALS event phases: the total
    # is the elapsed time, not the sum
    emit("wall", seconds=wall, total_s=time.perf_counter() - start)

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
            launches_foldin_http=foldin["http_arm"]["launches"][
                "quantized_scan"],
            launches_evaluate_class_mode=evaluate["class_mode"]["launches"][
                "quantized_scan"],
            launches_evaluate_batchpredict=evaluate["batchpredict"][
                "launches"]["quantized_scan"],
            launches_shared_store_remote=shared["remote"]["serve_launches"][
                "quantized_scan"],
            launches_serve_batching={
                m: batching["modes"][m]["k7_launches"] for m in SB_MODES},
            dispatches_serve_batching={
                m: batching["modes"][m]["dispatches"] for m in SB_MODES},
            # the fixed canary's load: one a device dispatch of either
            # arm, one a shadow sample
            launches_serve_rollout=rollout["canary"]["k7_launches"],
            dispatches_serve_rollout=rollout["canary"]["dispatches"],
            shadow_samples_serve_rollout=rollout["canary"][
                "shadow_samples"],
            # the clustered fleet's two loads: one a shard's scan dispatch
            launches_serve_fleet=fleet["k7_launches"],
            dispatches_serve_fleet=fleet["scan_dispatches"],
            # a clustered shard process with --retrieval-impl pallas
            launches_serve_fleet_standalone=fleet["standalone"][
                "k7_launches"],
            dispatches_serve_fleet_standalone=fleet["standalone"][
                "scan_dispatches"],
            # K7 against its plain version on each shard's own index
            shard_cases=fleet["shard_scan"],
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
            launches_evaluate_class_mode=evaluate["class_mode"]["launches"][
                "segment_flush"],
            launches_evaluate_class_mode_expected=evaluate["class_mode"][
                "segment_flush_launches_expected"],
            launches_evaluate_train_from_eval=evaluate["from_eval"][
                "launches"]["segment_flush"],
            **{f"launches_{name}": train["launches"]["segment_flush"]
               for name, train in (
                   ("eventlog", log["train"]),
                   ("shared_store_remote", shared["remote"]["train"]),
                   ("shared_store_sharded", shared["sharded"]["train"]),
                   ("shared_store_replicated",
                    shared["replicated"]["train"]))},
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
            k8["sequence_entry"], attn["cases"][0],
            library_is="torch.nn.functional.scaled_dot_product_attention",
            bound_f32_fma_ms=attn["cases"][0]["bound_f32_fma_ms"],
            path=attn["cases"][0]["path"],
            shape={k: attn["cases"][0][k]
                   for k in ("B", "S", "H", "D", "dtype", "causal")},
            cases=attn["cases"], edges=attn["edges"],
            launches_train_resume=k8["train_resume"],
            launches_train_resume_deploy=k8["train_resume_deploy"],
            launches_evaluate_sequence_sweep=k8["evaluate_sequence"]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == SEQUENCE_LANE:
        sys.exit(sequence_lane(Path(sys.argv[2])))
    sys.exit(main())
