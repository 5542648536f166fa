"""Batched hyperparameter sweep — train and score N candidates as one
stacked device program instead of N sequential trains.

Counterpart of ``pio_tpu.tuning.sweep``: candidates that share array
shapes — same rank / iteration count / implicitness, differing only in
the continuous hyperparams (lambda, alpha) — are STACKED into one ALS
train (``ops.als.als_train_stacked``, the candidate axis folded into the
rows) and one batched scoring pass, so a sweep's cost is one layout
build + batched work, not N of each. The lever is Chiu et al.
(1612.01437): factorization is dominated by data movement, so batch the
work that shares data. Shape-incompatible candidates fall into per-shape
groups (each still batched); candidates the batched path cannot express
at all (the sequence template, any non-ALS engine) fall back to
sequential runs through the engine's own eval path — NEVER an error.
The JAX parts are rewritten in torch: the stacked scoring's product is
one ``torch.matmul`` and its top-k ``ops.topk.topk_lowest_index``, which
orders ties as ``lax.top_k`` does (every masked seen item ties).

Crash safety rides the training lifecycle's pattern: the sweep's unit of
work (a fold on the batched path, a candidate on the sequential path)
checkpoints its results into the durable ``<eval-iid>:sweep`` record
after completion; a killed sweep resumed with the same EvaluationInstance
id skips completed units and — because splits, inits and metrics are all
seeded/deterministic — produces a result identical to the uninterrupted
run. ``eval.fold`` / ``eval.candidate`` chaos points make that drill
scriptable, and the same names are the span labels on the obs plane.

``SweepRunner.timings`` keeps where a batched sweep's time went (the
read, the splits, and per fold the stacked train, the scoring and the
host-side AUC masks); the runner logs it when the sweep ends.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import time
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np
import torch

from pio_tpu_torch.controller.engine import Engine, EngineParams
from pio_tpu_torch.controller.evaluation import (
    Metric,
    MetricEvaluatorResult,
    MetricScores,
)
from pio_tpu_torch.ops import als
from pio_tpu_torch.ops.bucketing import pow2_bucket
from pio_tpu_torch.ops.topk import topk_lowest_index
from pio_tpu_torch.resilience import chaos
from pio_tpu_torch.tuning.metrics import (
    AUC,
    MASKED_SCORE,
    RankingMetric,
    nanmean_sum_count,
    pad_actuals,
)
from pio_tpu_torch.tuning.records import (
    SweepState,
    load_sweep_state,
    save_sweep_state,
)
from pio_tpu_torch.tuning.splits import EvalFold, folds_for

log = logging.getLogger("pio_tpu_torch.tuning")


@dataclass
class SweepConfig:
    metric: Metric
    other_metrics: list[Metric] = field(default_factory=list)
    split: str = "kfold"            # kfold | time
    folds: int = 3
    seed: int = 42
    exclude_seen: bool = True
    # eval-user batch per scoring dispatch: bounds the (C, B, I) score
    # block; pow2-bucketed as in the reference
    batch_users: int = 512

    def all_metrics(self) -> list[Metric]:
        return [self.metric, *self.other_metrics]


# ---------------------------------------------------------------------------
# candidate shape grouping
# ---------------------------------------------------------------------------

_ALS_CONTINUOUS = ("lambda_", "alpha")
# algo-param fields the stacked trainer actually maps into ALSParams
# (see _train_group); a grid varying anything OUTSIDE this set — e.g.
# validation_fraction — cannot be expressed batched and must fall back
# to the sequential path, or the sweep would silently not vary it
_ALS_BATCHED_FIELDS = frozenset({
    "rank", "num_iterations", "lambda_", "alpha", "implicit_prefs",
    "seed", "chunk", "cg_iters", "cg_warm_iters", "cg_warm_sweeps",
})


def _als_algo_params(ep: EngineParams):
    """The (name, params) of an ALS-shaped first algorithm, or None —
    the batched path's eligibility test. 'ALS-shaped' = carries the
    rank/lambda_/alpha/implicit_prefs factor-model surface."""
    algos = ep.algorithms or []
    if len(algos) != 1:
        return None
    name, p = algos[0]
    for f in ("rank", "lambda_", "alpha", "implicit_prefs",
              "num_iterations"):
        if not hasattr(p, f):
            return None
    return name, p


def stacked_base_params(p) -> als.ALSParams:
    """The ALSParams a shape group trains under, from its first
    candidate's algorithm params (the fields _ALS_BATCHED_FIELDS names);
    each candidate then brings its own (lambda_, alpha)."""
    return als.ALSParams(
        rank=p.rank,
        iterations=p.num_iterations,
        reg=p.lambda_,
        alpha=p.alpha,
        implicit=p.implicit_prefs,
        seed=p.seed if getattr(p, "seed", None) is not None else 3,
        chunk=getattr(p, "chunk", 65536),
        cg_iters=getattr(p, "cg_iters", -1),
        cg_warm_iters=getattr(p, "cg_warm_iters", 6),
        cg_warm_sweeps=getattr(p, "cg_warm_sweeps", 2),
    )


def _shape_key(p) -> tuple:
    """Everything about the algo params EXCEPT the vmapped continuous
    hyperparams: candidates sharing this key train as one stacked
    program."""
    d = {f.name: getattr(p, f.name) for f in dataclasses.fields(p)}
    for cont in _ALS_CONTINUOUS:
        d.pop(cont, None)
    return tuple(sorted((k, repr(v)) for k, v in d.items()))


def group_candidates(
    candidates: Sequence[EngineParams],
) -> tuple[dict[tuple, list[int]], bool]:
    """-> ({shape key: candidate indices}, batchable). batchable is
    False when ANY candidate is not ALS-shaped or datasource/serving
    params differ across candidates (the batched path reads the data
    once — a grid that varies the read is a different experiment)."""
    if not candidates:
        raise ValueError("sweep needs at least one candidate")
    base = candidates[0]
    groups: dict[tuple, list[int]] = {}
    field_values: dict[str, set] = {}
    for i, ep in enumerate(candidates):
        algo = _als_algo_params(ep)
        if algo is None:
            return {}, False
        if (ep.datasource != base.datasource
                or ep.preparator != base.preparator
                or ep.serving != base.serving):
            return {}, False
        p = algo[1]
        if dataclasses.is_dataclass(p):
            for f in dataclasses.fields(p):
                field_values.setdefault(f.name, set()).add(
                    repr(getattr(p, f.name)))
            # best-sweep validation selection is a different training
            # program than the stacked trainer runs: candidates asking
            # for it must train through the real ALSAlgorithm.train
            if getattr(p, "validation_fraction", 0.0):
                return {}, False
        groups.setdefault(_shape_key(p), []).append(i)
    # a grid axis the stacked trainer cannot express (it maps only
    # _ALS_BATCHED_FIELDS into ALSParams) would otherwise be a silent
    # no-op: identical scores, arbitrary "winner"
    for name, vals in field_values.items():
        if len(vals) > 1 and name not in _ALS_BATCHED_FIELDS:
            log.info("sweep falls back to sequential: grid varies %r, "
                     "which the stacked trainer does not map", name)
            return {}, False
    return groups, True


# ---------------------------------------------------------------------------
# batched scoring
# ---------------------------------------------------------------------------

def _stacked_topk(user_f, item_f, uidx, seen_pad, k: int):
    """(C,U,r) x (C,I,r) factors -> per-candidate top-k over the eval
    users, with seen-in-train items masked below any real score.
    Returns (scores (C,B,I), top_idx (C,B,k)) — scores feed AUC, the
    ranking feeds the top-k metrics. ``uidx`` and ``seen_pad`` are
    int tensors or arrays, moved to the factors' device. The top-k
    orders ties by the lower index, as ``lax.top_k`` does: every
    masked item ties at MASKED_SCORE, and for a user with few unseen
    items that order reaches the ranking."""
    dev = user_f.device
    uidx = torch.as_tensor(uidx, device=dev).long()
    seen_pad = torch.as_tensor(seen_pad, device=dev).long()
    uf = user_f[:, uidx]                                 # (C, B, r)
    scores = torch.matmul(uf, item_f.transpose(1, 2))    # (C, B, I) f32
    n_items = item_f.shape[1]
    b = uidx.shape[0]
    # scatter the -1-padded seen ids into a (B, I) mask via an overflow
    # column that the pad rows land in
    seen_cols = torch.where(seen_pad >= 0, seen_pad, n_items)
    seen_mask = torch.zeros((b, n_items + 1), dtype=torch.bool, device=dev)
    seen_mask.scatter_(1, seen_cols, True)
    masked = scores.masked_fill(seen_mask[None, :, :n_items], MASKED_SCORE)
    _, top_idx = topk_lowest_index(masked, k)
    return masked, top_idx


def _score_stacked(
    stacked: als.StackedALSModel,
    fold: EvalFold,
    metrics: Sequence[Metric],
    batch_users: int,
    timings: dict | None = None,
) -> list[list[tuple[float, int]]]:
    """-> per candidate, per metric: (sum, count) over the fold's test
    users. Users stream in pow2-bucketed batches so the (C, B, I) score
    block stays bounded. ``timings`` (a dict) gains ``auc_host_s``, the
    seconds spent building the AUC masks on the host."""
    n_cand = len(stacked)
    n_items = int(stacked.item_factors.shape[1])
    k_rank = max((m.k for m in metrics if isinstance(m, RankingMetric)),
                 default=0)
    k_top = pow2_bucket(max(k_rank, 1), cap=max(n_items, 1))
    want_full = any(isinstance(m, AUC) for m in metrics)
    sums = [[0.0] * len(metrics) for _ in range(n_cand)]
    counts = [[0] * len(metrics) for _ in range(n_cand)]
    b_total = fold.n_test_users
    pos = 0
    while pos < b_total:
        hi = min(pos + batch_users, b_total)
        b = hi - pos
        bb = pow2_bucket(b)
        uidx = np.zeros(bb, np.int32)
        uidx[:b] = fold.test_user_idx[pos:hi]
        actual = pad_actuals(fold.actual_idx[pos:hi])
        seen = pad_actuals(fold.seen_idx[pos:hi])
        # pad the user tail AND bucket the ragged widths, as the
        # reference does (the same shapes reach the top-k and metrics)
        aw = pow2_bucket(actual.shape[1])
        sw = pow2_bucket(seen.shape[1])
        actual_p = np.full((bb, aw), -1, np.int32)
        actual_p[:b, :actual.shape[1]] = actual
        seen_p = np.full((bb, sw), -1, np.int32)
        seen_p[:b, :seen.shape[1]] = seen
        scores, top_idx = _stacked_topk(
            stacked.user_factors, stacked.item_factors, uidx, seen_p,
            k_top)
        top_b = top_idx[:, :b]
        actual_b = torch.as_tensor(actual_p[None, :b], device=top_b.device)
        pos_mask = valid_mask = None
        if want_full:
            t_host = time.perf_counter()
            pos_mask = np.zeros((bb, n_items), bool)
            valid_mask = np.ones((bb, n_items), bool)
            for j in range(b):
                pos_mask[j, fold.actual_idx[pos + j]] = True
                s = fold.seen_idx[pos + j]
                if len(s):
                    valid_mask[j, s] = False
                valid_mask[j, fold.actual_idx[pos + j]] = True
            if timings is not None:
                timings["auc_host_s"] = (timings.get("auc_host_s", 0.0)
                                         + time.perf_counter() - t_host)
        for mi, metric in enumerate(metrics):
            if isinstance(metric, AUC):
                shape = (n_cand,) + pos_mask.shape
                dev = scores.device
                per_user = metric.score_full(
                    scores,
                    torch.from_numpy(pos_mask).to(dev).expand(shape),
                    torch.from_numpy(valid_mask).to(dev).expand(shape),
                )[:, :b]
            else:
                per_user = metric.score_ranked(top_b, actual_b)
            for c in range(n_cand):
                s, n = nanmean_sum_count(per_user[c])
                sums[c][mi] += s
                counts[c][mi] += n
        pos = hi
    return [
        [(sums[c][m], counts[c][m]) for m in range(len(metrics))]
        for c in range(n_cand)
    ]


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------

class SweepRunner:
    """Drives one sweep against a persisted EvaluationInstance id.

    ``run(ctx)`` returns a MetricEvaluatorResult (the exact shape the
    classic MetricEvaluator produces, so the dashboard/instance-record
    rendering is shared)."""

    def __init__(
        self,
        engine: Engine,
        candidates: Sequence[EngineParams],
        storage,
        config: SweepConfig,
        eval_id: str,
        tracer=None,
    ):
        from pio_tpu_torch.utils.tracing import Tracer

        self.engine = engine
        self.candidates = list(candidates)
        self.storage = storage
        self.config = config
        self.eval_id = eval_id
        self.tracer = tracer or Tracer()
        self.groups, self.batchable = group_candidates(self.candidates)
        self.mode = "batched" if self.batchable else "sequential"
        self.last_sweep_seconds: float | None = None
        # where the sweep's time went: on the batched path read_s,
        # splits_s, and per run fold train_s (synchronized with the
        # device), score_s, auc_host_s (inside score_s) and testUsers; on
        # the sequential path the seconds of each run candidate
        self.timings: dict = {"folds": []}
        # optional progress hook: on_unit(done, total) after every
        # persisted unit (the eval server's /healthz progress)
        self.on_unit = None

    # -- durable unit bookkeeping -------------------------------------------
    def _load_or_init_state(self, units: list[str]) -> SweepState:
        state = load_sweep_state(self.storage, self.eval_id)
        spec = {
            "mode": self.mode,
            "split": self.config.split,
            "folds": self.config.folds,
            "seed": self.config.seed,
            # the FULL metric list and candidate grid, not just counts:
            # resuming with a same-cardinality but different grid (or an
            # added metric column) would otherwise pass the check and
            # aggregate fold results computed from different params —
            # the corrupted average would pick the deployed winner
            "metrics": [m.header for m in self.config.all_metrics()],
            "candidates": [ep.to_json() for ep in self.candidates],
        }
        if state is not None:
            if state.units != units or state.spec != spec:
                raise ValueError(
                    f"evaluation {self.eval_id} has a persisted sweep "
                    "state with a different plan (grid/split/seed "
                    "changed?) — start a fresh eval instead of resuming")
            done = [u for u in units if u in state.completed]
            if done:
                log.info("sweep %s resume: %d/%d unit(s) already "
                         "completed (%s)", self.eval_id, len(done),
                         len(units), ", ".join(done))
        else:
            state = SweepState(eval_id=self.eval_id, spec=spec,
                               units=units)
            save_sweep_state(self.storage, state)
        if self.on_unit is not None:
            # progress surfaces show done/TOTAL from the first poll, not
            # only after the first unit completes
            self.on_unit(len(state.completed), len(state.units))
        return state

    def _complete_unit(self, state: SweepState, unit: str,
                       payload: dict) -> None:
        state.completed[unit] = payload
        save_sweep_state(self.storage, state)
        if self.on_unit is not None:
            self.on_unit(len(state.completed), len(state.units))

    # -- entry ---------------------------------------------------------------
    def run(self, ctx) -> MetricEvaluatorResult:
        t0 = time.perf_counter()
        recorder = getattr(self.tracer, "recorder", None)
        if recorder is not None:
            # the whole sweep is ONE root trace (the folder's cycle
            # idiom): eval.fold / eval.candidate spans land in the
            # recorder, so `pio top --url <metrics-port>` shows them
            # live and a failed sweep's tree is always retained
            with recorder.trace("eval.sweep"):
                result = self._run_traced(ctx)
        else:
            result = self._run_traced(ctx)
        dt = time.perf_counter() - t0
        self.last_sweep_seconds = dt
        self.tracer.record("eval_sweep_seconds", dt)
        log.info("sweep %s timings %s", self.eval_id,
                 json.dumps({**self.timings, "sweep_s": dt,
                             "mode": self.mode}))
        return result

    def _run_traced(self, ctx) -> MetricEvaluatorResult:
        with self.tracer.span("eval.sweep", mode=self.mode):
            if self.batchable:
                return self._run_batched(ctx)
            return self._run_sequential(ctx)

    # -- batched ALS path ----------------------------------------------------
    def _read_folds(self, ctx) -> list[EvalFold]:
        _, ds_params = self.candidates[0].datasource
        c = self.config
        # EXACTLY the recommendation datasource's training-read value
        # semantics (value_key="rating" unconditionally; value_event
        # restricts the property read to that one event name) — the
        # time split must score candidates on the same values the
        # winner later trains on
        common = dict(
            value_key="rating",
            default_value=getattr(ds_params, "implicit_value", 1.0),
            value_event=getattr(ds_params, "rating_event", None),
            dedup="last",
        )
        t0 = time.perf_counter()
        if c.split == "time":
            store = ctx.event_store
            app_id, channel_id = store._resolve(
                ds_params.app_name,
                getattr(ds_params, "channel_name", None))
            cols = self.storage.get_events().find_columnar(
                app_id=app_id, channel_id=channel_id,
                entity_type="user", target_entity_type="item",
                event_names=list(getattr(ds_params, "event_names",
                                         ("rate", "buy"))),
            )
            t1 = time.perf_counter()
            folds = folds_for(cols, "time", c.folds,
                              exclude_seen=c.exclude_seen, **common)
        else:
            ds, _prep, _algos, _serv = self.engine._doers(
                self.candidates[0])
            data = ds.read_training(ctx)
            t1 = time.perf_counter()
            folds = folds_for(data, "kfold", c.folds, seed=c.seed,
                              exclude_seen=c.exclude_seen)
        self.timings["read_s"] = t1 - t0
        self.timings["splits_s"] = time.perf_counter() - t1
        return folds

    def _train_group(self, ctx, fold: EvalFold,
                     cand_idx: list[int]) -> als.StackedALSModel:
        algos = [_als_algo_params(self.candidates[i]) for i in cand_idx]
        base = stacked_base_params(algos[0][1])
        regs = np.array([p.lambda_ for _, p in algos], np.float32)
        alphas = np.array([p.alpha for _, p in algos], np.float32)
        t = fold.train
        return als.als_train_stacked(
            t.user_idx, t.item_idx, t.values, t.n_users, t.n_items,
            base, regs, alphas, device=ctx.device)

    def _run_batched(self, ctx) -> MetricEvaluatorResult:
        c = self.config
        metrics = c.all_metrics()
        units = [f"fold{f}" for f in range(c.folds)]
        state = self._load_or_init_state(units)
        folds: list[EvalFold] | None = None
        group_list = sorted(self.groups.items())   # deterministic order
        for f, unit in enumerate(units):
            if unit in state.completed:
                continue
            chaos.maybe_inject(f"eval.fold.{f}")
            if folds is None:
                folds = self._read_folds(ctx)      # read once, lazily:
                # a fully-resumed sweep re-reads nothing
            fold = folds[f]
            per_cand: list[dict | None] = [None] * len(self.candidates)
            ft = {"fold": f, "testUsers": fold.n_test_users,
                  "train_s": 0.0, "score_s": 0.0, "auc_host_s": 0.0}
            with self.tracer.span("eval.fold", fold=f,
                                  testUsers=fold.n_test_users):
                for gi, (_key, cand_idx) in enumerate(group_list):
                    chaos.maybe_inject(f"eval.candidate.{gi}")
                    with self.tracer.span(
                            "eval.candidate", group=gi,
                            candidates=len(cand_idx), fold=f):
                        t0 = time.perf_counter()
                        stacked = self._train_group(ctx, fold, cand_idx)
                        _sync(ctx.device)
                        t1 = time.perf_counter()
                        scored = _score_stacked(
                            stacked, fold, metrics, c.batch_users, ft)
                        ft["train_s"] += t1 - t0
                        ft["score_s"] += time.perf_counter() - t1
                        del stacked
                    for local, ci in enumerate(cand_idx):
                        per_cand[ci] = {
                            m.header: list(scored[local][mi])
                            for mi, m in enumerate(metrics)
                        }
            self.timings["folds"].append(ft)
            self._complete_unit(state, unit, {"candidates": per_cand})
        return self._result_from_fold_state(state, metrics)

    def _result_from_fold_state(
            self, state: SweepState,
            metrics: list[Metric]) -> MetricEvaluatorResult:
        n = len(self.candidates)
        agg = [[(0.0, 0)] * len(metrics) for _ in range(n)]
        for unit in state.units:
            payload = state.completed[unit]["candidates"]
            for ci in range(n):
                for mi, m in enumerate(metrics):
                    s0, c0 = agg[ci][mi]
                    s1, c1 = payload[ci][m.header]
                    agg[ci][mi] = (s0 + s1, c0 + c1)
        scores = []
        for ci, ep in enumerate(self.candidates):
            means = [
                (s / c if c else float("nan")) for s, c in agg[ci]
            ]
            scores.append((ep, MetricScores(
                score=means[0], other_scores=means[1:])))
        return _pick_best(scores, self.config.metric, metrics)

    # -- grouped sequential fallback ----------------------------------------
    def _run_sequential(self, ctx) -> MetricEvaluatorResult:
        c = self.config
        if c.split == "time":
            raise ValueError(
                "--split time is not supported on the sequential "
                "fallback: the engine's own read_eval defines its "
                "folds (the sequence engine's rolling read_eval is "
                "already time-respecting; others use index-mod-k) — "
                "use --split kfold here")
        metrics = c.all_metrics()
        full_scorable = [m for m in metrics
                         if not getattr(m, "needs_full_scores", False)]
        if len(full_scorable) != len(metrics):
            dropped = [m.header for m in metrics
                       if getattr(m, "needs_full_scores", False)]
            if self.config.metric.header in dropped:
                raise ValueError(
                    f"primary metric {self.config.metric.header} needs "
                    "full score rows, which the sequential fallback "
                    "(non-ALS engines) cannot provide — pick a top-k "
                    "metric (map@K / ndcg@K / precision@K)")
            log.warning("sequential fallback drops full-score "
                        "metric(s): %s", ", ".join(dropped))
            metrics = full_scorable
        units = [f"cand{i}" for i in range(len(self.candidates))]
        state = self._load_or_init_state(units)
        fast = _fast_engine(self.engine)
        # rankings must be at least as deep as the deepest metric k:
        # read_eval queries default num=10, which would force ranks
        # k+1..K to misses and silently cap e.g. recall@20 at recall@10
        k_need = max((m.k for m in metrics if isinstance(m, RankingMetric)),
                     default=0)
        for i, unit in enumerate(units):
            if unit in state.completed:
                continue
            chaos.maybe_inject(f"eval.candidate.{i}")
            ep = _with_eval_folds(self.candidates[i], c.folds, k_need)
            t0 = time.perf_counter()
            with self.tracer.span("eval.candidate", idx=i):
                eval_set = fast.eval(ctx, ep)
                payload = {
                    m.header: m.calculate(ctx, eval_set)
                    for m in metrics
                }
            self.timings.setdefault("candidates", []).append(
                {"candidate": i, "s": time.perf_counter() - t0})
            self._complete_unit(state, unit, {"scores": payload})
        scores = []
        for i, ep in enumerate(self.candidates):
            payload = state.completed[units[i]]["scores"]
            scores.append((ep, MetricScores(
                score=payload[metrics[0].header],
                other_scores=[payload[m.header] for m in metrics[1:]],
            )))
        return _pick_best(scores, metrics[0], metrics)


def _sync(device) -> None:
    """Wait for the device, so a host clock read after it counts the
    work queued before it."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _fast_engine(engine: Engine) -> Engine:
    """Wrap the engine's class maps in a FastEvalEngine so candidates
    sharing a datasource/preparator prefix run those stages once."""
    from pio_tpu_torch.controller.fasteval import FastEvalEngine

    return FastEvalEngine(
        engine.datasource_classes, engine.preparator_classes,
        engine.algorithm_classes, engine.serving_classes)


def _with_eval_folds(ep: EngineParams, folds: int,
                     k_need: int = 0) -> EngineParams:
    """The sequential path scores through the engine's own read_eval;
    a datasource that gates fold production on an eval_k param gets the
    sweep's fold count when it was left unset, and an eval_num
    shallower than the deepest metric k is raised to it (a 10-item
    ranking cannot score recall@20)."""
    name, p = ep.datasource
    if p is None:
        return ep
    updates: dict = {}
    if hasattr(p, "eval_k") and getattr(p, "eval_k", 0) in (0, None):
        updates["eval_k"] = folds
    if k_need and hasattr(p, "eval_num") \
            and getattr(p, "eval_num", 0) < k_need:
        updates["eval_num"] = k_need
    if not updates:
        return ep
    try:
        return dataclasses.replace(
            ep, datasource=(name, dataclasses.replace(p, **updates)))
    except TypeError:
        return ep


def _pick_best(scores, primary: Metric,
               metrics: list[Metric]) -> MetricEvaluatorResult:
    """Result assembly around the SHARED best-candidate selection
    (controller.evaluation.pick_best_index — the classic evaluator's
    NaN-never-wins policy, one implementation)."""
    from pio_tpu_torch.controller.evaluation import pick_best_index

    best_idx = pick_best_index(scores, primary)
    return MetricEvaluatorResult(
        best_score=scores[best_idx][1],
        best_engine_params=scores[best_idx][0],
        best_idx=best_idx,
        metric_header=primary.header,
        other_metric_headers=[m.header for m in metrics[1:]],
        engine_params_scores=list(scores),
    )
