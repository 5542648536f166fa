"""FastEvalEngine — hyperparameter-search accelerator.

Mirrors reference controller/FastEvalEngine.scala:50-343: during tuning,
consecutive EngineParams usually share pipeline prefixes (same datasource,
same preparator, ...). FastEvalEngine memoizes each prefix so shared stages
run once across the whole params grid:

  datasource prefix  (ds name+params)                -> read_eval folds
  preparator prefix  (ds + prep)                     -> prepared data / fold
  algorithms prefix  (ds + prep + algo list)         -> batch predictions
  serving            (never cached — cheap)

Cache keys are canonical JSON of the stage params (the reference's
*PrefixParams case classes). Hit counters are exposed for tests — the
reference's FastEvalEngineTest asserts exact hit counts."""

from __future__ import annotations

import json
import threading
from collections import Counter
from concurrent.futures import Future
from typing import Any

from pio_tpu_torch.controller.base import params_to_dict
from pio_tpu_torch.controller.engine import Engine, EngineParams


def _key(*parts) -> str:
    def enc(p):
        if isinstance(p, tuple):
            return [p[0], params_to_dict(p[1])]
        if isinstance(p, list):
            return [enc(x) for x in p]
        return p

    return json.dumps([enc(p) for p in parts], sort_keys=True)


class FastEvalEngine(Engine):
    """Drop-in Engine whose eval() memoizes pipeline prefixes."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        # caches hold per-key Futures so a parallel params sweep
        # (MetricEvaluator workers>1) computes each shared prefix ONCE:
        # the first thread in owns the Future, later threads block on it
        self._ds_cache: dict[str, Future] = {}
        self._prep_cache: dict[str, Future] = {}
        self._algo_cache: dict[str, Future] = {}
        self._lock = threading.Lock()
        self.cache_hits = Counter()
        self.cache_misses = Counter()

    def _memo(self, cache: dict[str, Future], stage: str, key: str, compute):
        with self._lock:
            fut = cache.get(key)
            if fut is None:
                fut = cache[key] = Future()
                self.cache_misses[stage] += 1
                owner = True
            else:
                self.cache_hits[stage] += 1
                owner = False
        if owner:
            try:
                fut.set_result(compute())
            except BaseException as e:
                with self._lock:
                    cache.pop(key, None)  # a failed stage may be retried
                fut.set_exception(e)
                raise
        return fut.result()

    @classmethod
    def from_engine(cls, engine: Engine) -> "FastEvalEngine":
        return cls(
            engine.datasource_classes,
            engine.preparator_classes,
            engine.algorithm_classes,
            engine.serving_classes,
        )

    # -- prefix stages (reference getDataSourceResult etc.,
    # FastEvalEngine.scala:50-264) ------------------------------------------
    def _datasource_result(self, ctx, engine_params: EngineParams):
        def compute():
            ds = self._stage(
                self.datasource_classes, *engine_params.datasource,
                "datasource",
            )
            return ds.read_eval(ctx)

        return self._memo(
            self._ds_cache, "datasource", _key(engine_params.datasource),
            compute,
        )

    def _preparator_result(self, ctx, engine_params: EngineParams):
        def compute():
            prep = self._stage(
                self.preparator_classes, *engine_params.preparator,
                "preparator",
            )
            folds = self._datasource_result(ctx, engine_params)
            return [(prep.prepare(ctx, td), ei, qa) for td, ei, qa in folds]

        return self._memo(
            self._prep_cache, "preparator",
            _key(engine_params.datasource, engine_params.preparator),
            compute,
        )

    def _algorithms_result(self, ctx, engine_params: EngineParams):
        """-> per fold: list over algos of batch predictions (aligned with
        the fold's supplemented queries)."""
        k = _key(
            engine_params.datasource,
            engine_params.preparator,
            list(engine_params.algorithms or [("", None)]),
            engine_params.serving,  # supplement affects queries
        )

        def compute():
            algo_list = engine_params.algorithms or [("", None)]
            algos = [
                self._stage(self.algorithm_classes, n, p, "algorithm")
                for n, p in algo_list
            ]
            serving = self._stage(
                self.serving_classes, *engine_params.serving, "serving"
            )
            folds = self._preparator_result(ctx, engine_params)
            out = []
            for pd, ei, qa in folds:
                models = [a.train(ctx, pd) for a in algos]
                queries = [serving.supplement(q) for q, _ in qa]
                per_algo = [
                    a.batch_predict(m, queries)
                    for a, m in zip(algos, models)
                ]
                out.append((per_algo, ei, qa))
            return out

        return self._memo(self._algo_cache, "algorithms", k, compute)

    # -- eval override (reference FastEvalEngine.scala:310-343) -------------
    def eval(self, ctx, engine_params: EngineParams):
        serving = self._stage(
            self.serving_classes, *engine_params.serving, "serving"
        )
        results = []
        for per_algo, ei, qa in self._algorithms_result(ctx, engine_params):
            qpa = [
                (q, serving.serve(q, [preds[i] for preds in per_algo]), a)
                for i, (q, a) in enumerate(qa)
            ]
            results.append((ei, qpa))
        return results

    def clear_cache(self):
        # under the memo lock: a worker mid-_memo must not observe a
        # half-cleared cache
        with self._lock:
            self._ds_cache.clear()
            self._prep_cache.clear()
            self._algo_cache.clear()
            self.cache_hits.clear()
            self.cache_misses.clear()
