#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pio_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one card

It builds the port's CUDA kernels from the sources in the checkout, holds
each against its plain PyTorch version on the card, and then drives the
port's main path once at the full width of the model the repository
benchmarks: the ALS recommendation engine at the MovieLens-20M shape
(138,493 users x 26,744 items, rank 64, ``bench.py``), with factors made
from a seed, stored as a finished training run stores them, and served by
``create_query_server`` (what ``python -m pio_tpu_torch deploy`` calls)
with two-stage clustered retrieval and ``"impl": "pallas"``, over
loopback HTTP.

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

import json
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

SEED = 0
# the ALS cell of bench.py: MovieLens-20M shape, rank 64
N_USERS, N_ITEMS, RANK = 138_493, 26_744, 64
CENTRES = 256             # seeded Gaussian mixture (tests/test_retrieval.py)
FACTORY = "pio_tpu_torch.models.recommendation.RecommendationEngine"
RETRIEVAL = {"mode": "clustered", "dtype": "int8", "impl": "pallas"}
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

# NVIDIA H100 SXM data sheet (dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12         # the scan's FMAs run on the f32 CUDA cores

# device-side sleep ahead of each timing window, long enough for the host
# to queue the whole window (about 10 ms at H100 clocks)
SLEEP_CYCLES = 20_000_000
TIMING_REPS = 25
TIMING_INNER = 10


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def gpu_ms(fn) -> float:
    """Median device time of one call, from CUDA events around windows of
    TIMING_INNER back-to-back calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(TIMING_REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(TIMING_INNER):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / TIMING_INNER)
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
         cuda=torch.version.cuda, python=sys.version.split()[0], **device)
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
    per_kernel = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        if us > 0 and str(getattr(e, "device_type", "")).endswith("CUDA"):
            per_kernel[e.key] = us / 1e3 / len(queries)
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    device_ms = sum(per_kernel.values()) if per_kernel else None
    return {
        "wall_ms_per_query": wall_ms,
        "device_ms_per_query": device_ms,
        "device_busy_share": (device_ms / wall_ms) if device_ms else None,
        "top_kernels_ms_per_query": dict(top),
    }


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
    from pio_tpu_torch.ops.kernels import quantized_scan as qscan
    from pio_tpu_torch.workflow.context import create_workflow_context
    from pio_tpu_torch.workflow.serve import ServingConfig, create_query_server
    from pio_tpu_torch.workflow.train import persist_models

    counters = {"quantized_scan": qscan.launches}
    user_ids = [f"u{i}" for i in range(N_USERS)]
    item_ids = [f"i{i}" for i in range(N_ITEMS)]
    rng = np.random.default_rng(SEED + 2)
    picked = rng.choice(N_USERS, N_PLAIN_QUERIES + BATCH_QUERIES + 3,
                        replace=False)
    with tempfile.TemporaryDirectory(prefix="pio_chip_smoke_") as tmp:
        env = {
            "PIO_STORAGE_SOURCES_SQL_TYPE": "sqlite",
            "PIO_STORAGE_SOURCES_SQL_PATH": str(Path(tmp) / "pio.db"),
            "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "SQL",
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "SQL",
            "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "SQL",
        }
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
            for c in counters.values():
                c.reset()
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
            launches = {name: c.value for name, c in counters.items()}
            # ------------------------------------------------------------

            with urllib.request.urlopen(f"http://127.0.0.1:{port}/",
                                        timeout=60) as r:
                server_status = json.loads(r.read())
            model = qs.models[0]
            inproc = profile_queries(qs, plain_q[:20])
        finally:
            http.stop()
            qs.close()
            storage.close()

    # one launch per known-user, non-whiteList /queries.json and one per
    # /batch/queries.json dispatch
    want_launches = len(plain_q) + 1 + 1
    if launches["quantized_scan"] != want_launches:
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
        "in_process": inproc,
    }
    emit("serve", **result)
    if recall < RECALL_FLOOR:
        raise AssertionError(f"recall@10 {recall} < {RECALL_FLOOR}")
    return result


def main() -> int:
    device = phase_device()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    users, items = make_factors()
    scan = phase_scan_kernel(users, items, dev)
    serve = phase_serve(users, items, dev)

    cases = scan["cases"]
    # headline: the shape a single /queries.json gives the kernel
    head = next(c for c in cases
                if c["dtype"] == RETRIEVAL["dtype"] and c["B"] == 1)
    kernels = [{
        "name": "quantized_scan", "route": "cuda",
        "source": "pio_tpu_torch/ops/kernels/quantized_scan.cu",
        "replaces": "pio_tpu/ops/retrieval.py:550",
        "launches": serve["launches"]["quantized_scan"],
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "shape": {k: head[k] for k in ("dtype", "B", "P", "C", "Lmax",
                                       "k")},
        "ok": True,
        "cases": cases,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
