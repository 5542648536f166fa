"""Recommendation engine template — ALS collaborative filtering.

Counterpart of ``pio_tpu.models.recommendation``: the same params, query
and result shapes (query {"user", "num", "whiteList"?, "blackList"?} ->
{"itemScores": [...]}) and the same filtering semantics, with the factors
held as f32 torch tensors on the context's device. Training reads rate/buy
events into interactions and runs ``ops/als.py``'s ``als_train`` on one
device, or ``als_train_sharded`` when the context's mesh holds more than
one rank (the train verb on several processes). Two-stage clustered
retrieval (the engine.json ``retrieval`` block) runs the candidate scan
of ``ops/retrieval.py``.

With ``validation_fraction > 0`` a seeded share of the interactions is
held out and ``als_train_validated`` returns the best sweep's factors,
with the heldout curve in ``RecommendationModel.validation`` (on one
device only: the sharded path keeps the last sweep, as the reference's).

``read_eval`` gives the reference's index-mod-k folds
(``e2/crossvalidation.split_interactions``) for ``pio eval``'s class
mode.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from pio_tpu_torch.controller.base import (
    DataSource,
    FirstServing,
    IdentityPreparator,
    PAlgorithm,
    Params,
)
from pio_tpu_torch.controller.engine import Engine, EngineFactory
from pio_tpu_torch.data.bimap import EntityIdIndex
from pio_tpu_torch.data.eventstore import Interactions
from pio_tpu_torch.ops import als
from pio_tpu_torch.ops import retrieval as rt


@dataclass(frozen=True)
class DataSourceParams(Params):
    app_name: str = ""
    channel_name: str | None = None
    event_names: tuple[str, ...] = ("rate", "buy")
    rating_event: str = "rate"      # events carrying an explicit rating
    implicit_value: float = 4.0     # value assigned to non-rating events
    eval_k: int = 0                 # >0 -> read_eval produces k folds
    eval_num: int = 10              # ranking depth of each fold query
    eval_exclude_seen: bool = True


class RecommendationDataSource(DataSource):
    """Reads rate/buy events into Interactions: `rate` events use
    properties.rating, other events a fixed implicit value."""

    params_class = DataSourceParams

    def __init__(self, params: DataSourceParams):
        self.params = params

    def _read(self, ctx) -> Interactions:
        p = self.params
        return ctx.event_store.interactions(
            app_name=p.app_name,
            channel_name=p.channel_name,
            entity_type="user",
            target_entity_type="item",
            event_names=list(p.event_names),
            value_key="rating",
            default_value=p.implicit_value,
            value_event=p.rating_event,
            dedup="last",
        )

    def read_training(self, ctx) -> Interactions:
        return self._read(ctx)

    def read_eval(self, ctx):
        """Index-mod-k folds (reference e2 CrossValidation.splitData)."""
        from pio_tpu_torch.e2.crossvalidation import split_interactions

        data = self._read(ctx)
        return split_interactions(
            data, self.params.eval_k, num=self.params.eval_num,
            exclude_seen=self.params.eval_exclude_seen,
        )


def _rank_candidates(cand: list, scores, num: int) -> dict:
    """Candidate ids + their scores -> top-`num` PredictedResult shape
    (shared by the single-query and batched whitelist paths)."""
    order = np.argsort(-np.asarray(scores))[:num]
    return {
        "itemScores": [
            {"item": cand[i], "score": float(scores[i])} for i in order
        ]
    }


@dataclass(frozen=True)
class ALSAlgorithmParams(Params):
    rank: int = 10
    num_iterations: int = 10
    lambda_: float = 0.01
    alpha: float = 1.0
    implicit_prefs: bool = False
    seed: int | None = None
    chunk: int = 65536
    cg_iters: int = -1
    cg_warm_iters: int = 6
    cg_warm_sweeps: int = 2
    validation_fraction: float = 0.0
    # two-stage retrieval: the engine.json `retrieval` block. None/absent
    # = exact mode. whiteList queries always stay on predict_pairs.
    retrieval: dict | None = None


@dataclass
class RecommendationModel:
    """ALS factors + id indexes. ``validation`` carries the
    ALSValidation trajectory when a model was trained with
    validation_fraction > 0 (through the model blob too); serving never
    reads it."""

    factors: als.ALSModel
    users: EntityIdIndex
    items: EntityIdIndex
    validation: Any = None


class ALSAlgorithm(PAlgorithm):
    params_class = ALSAlgorithmParams

    def __init__(self, params: ALSAlgorithmParams):
        self.params = params
        # parse the retrieval block NOW so a typo'd knob fails engine
        # construction (deploy time), never silently serves exact
        self._rparams = rt.RetrievalParams.from_config(params.retrieval)

    def _retrieval_index(self, model: RecommendationModel):
        """The (RetrievalIndex, DeviceRetrievalIndex) pair for this
        model's current item factors, cached on the model object and
        keyed by item-table identity, so the k-means runs once per item
        table."""
        itf = model.factors.item_factors
        cached = getattr(model, "_retrieval_cache", None)
        if cached is not None and cached[0] is itf:
            return cached[1]
        idx = rt.build_index(itf.detach().cpu().numpy(), self._rparams)
        pair = (idx, rt.build_device_index(idx, itf.device))
        model._retrieval_cache = (itf, pair)
        return pair

    def _clustered(self, n_items: int) -> bool:
        rp = self._rparams
        return rp.mode == "clustered" and not rp.is_exhaustive(n_items)

    def _als_params(self) -> als.ALSParams:
        p = self.params
        return als.ALSParams(
            rank=p.rank,
            iterations=p.num_iterations,
            reg=p.lambda_,
            alpha=p.alpha,
            implicit=p.implicit_prefs,
            seed=p.seed if p.seed is not None else 3,
            chunk=p.chunk,
            cg_iters=p.cg_iters,
            cg_warm_iters=p.cg_warm_iters,
            cg_warm_sweeps=p.cg_warm_sweeps,
        )

    def train(self, ctx, data: Interactions) -> RecommendationModel:
        """ALS on ``ctx.device``. Without validation the last sweep's
        factors are the model, as in the reference; with
        ``validation_fraction > 0`` the reference's seeded split holds
        out that share and the best sweep's factors are the model. On a
        mesh of several ranks ``als_train_sharded`` trains on all of them
        and keeps the last sweep's factors, validation or not, as the
        reference does."""
        data.sanity_check()
        ap = self._als_params()
        vf = self.params.validation_fraction
        mesh = getattr(ctx, "mesh", None)  # absent or None: one device
        if mesh is not None and mesh.size > 1:
            factors = als.als_train_sharded(
                data.user_idx, data.item_idx, data.values,
                data.n_users, data.n_items, ap, mesh,
            )
            return RecommendationModel(factors, data.users, data.items)
        if vf > 0.0:
            nnz = len(data.values)
            n_val = max(1, int(nnz * vf))
            if nnz < 10:
                raise ValueError(
                    "validation_fraction needs >=10 interactions")
            rng = np.random.default_rng(ap.seed)
            perm = rng.permutation(nnz)
            va, tr = perm[:n_val], perm[n_val:]
            factors, validation = als.als_train_validated(
                data.user_idx[tr], data.item_idx[tr], data.values[tr],
                data.n_users, data.n_items, ap,
                data.user_idx[va], data.item_idx[va], data.values[va],
                device=ctx.device,
            )
            return RecommendationModel(
                factors, data.users, data.items, validation)
        factors = als.als_train(
            data.user_idx, data.item_idx, data.values,
            data.n_users, data.n_items, ap, device=ctx.device,
        )
        return RecommendationModel(factors, data.users, data.items)

    def predict(self, model: RecommendationModel, query: dict) -> dict:
        """query {"user": id, "num": k, "whiteList"?: [...], "blackList"?: [...]}
        -> {"itemScores": [{"item": id, "score": s}]}."""
        user = query["user"]
        num = int(query.get("num", 10))
        if user not in model.users:
            return {"itemScores": []}
        uidx = model.users.index_of(user)
        white = query.get("whiteList")
        black = set(query.get("blackList") or ())
        if white:
            cand = [i for i in white if i in model.items and i not in black]
            if not cand:
                return {"itemScores": []}
            cidx = model.items.encode(cand)
            scores = als.predict_pairs(
                model.factors, np.full(len(cidx), uidx, dtype=np.int32),
                cidx).cpu().numpy()
            return _rank_candidates(cand, scores, num)
        n_items = model.factors.item_factors.shape[0]
        k = min(num + len(black), n_items)
        if self._clustered(n_items):
            _, didx = self._retrieval_index(model)
            urow = model.factors.user_factors[uidx]
            scores, idx = rt.candidate_topk(
                didx, model.factors.item_factors, urow, k)
            scores, idx = scores[0], idx[0]
            keep = idx >= 0   # fewer real survivors than k: drop pads
            scores, idx = scores[keep], idx[keep]
        else:
            scores, idx = als.recommend_topk(
                model.factors, np.array([uidx]), k)
            scores, idx = scores[0].cpu().numpy(), idx[0].cpu().numpy()
        out = []
        for item, score in zip(model.items.decode(idx), scores):
            if item in black:
                continue
            out.append({"item": item, "score": float(score)})
            if len(out) >= num:
                break
        return {"itemScores": out}

    def batch_predict(self, model: RecommendationModel, queries) -> list:
        """One top-k dispatch for all known-user queries (blackList
        over-fetch k = num + max blacklist, filtered per row on the host);
        whiteList queries flatten into one predict_pairs call."""
        results: list[dict] = [{"itemScores": []} for _ in queries]
        known = []
        white_q = []   # (query_index, uidx, [candidate ids])
        for i, q in enumerate(queries):
            if q["user"] not in model.users:
                continue
            if q.get("whiteList"):
                black = set(q.get("blackList") or ())
                cand = [c for c in q["whiteList"]
                        if c in model.items and c not in black]
                if cand:
                    white_q.append(
                        (i, model.users.index_of(q["user"]), cand))
            else:
                known.append((i, model.users.index_of(q["user"])))
        if white_q:
            flat_u = np.concatenate([
                np.full(len(cand), u, np.int32) for _, u, cand in white_q
            ])
            flat_i = np.concatenate([
                model.items.encode(cand) for _, _, cand in white_q
            ]).astype(np.int32)
            flat_s = als.predict_pairs(
                model.factors, flat_u, flat_i).cpu().numpy()
            off = 0
            for qi, _, cand in white_q:
                s = flat_s[off:off + len(cand)]
                off += len(cand)
                results[qi] = _rank_candidates(
                    cand, s, int(queries[qi].get("num", 10)))
        if not known:
            return results
        n_items = model.factors.item_factors.shape[0]
        rows = np.array([u for _, u in known], dtype=np.int64)
        k = min(
            max(int(queries[qi].get("num", 10))
                + len(queries[qi].get("blackList") or ())
                for qi, _ in known),
            n_items,
        )
        if self._clustered(n_items):
            _, didx = self._retrieval_index(model)
            urows = model.factors.user_factors[
                torch.as_tensor(rows, device=didx.device)]
            scores, idx = rt.candidate_topk(
                didx, model.factors.item_factors, urows, k)
        else:
            scores, idx = als.recommend_topk(model.factors, rows, k)
            scores, idx = scores.cpu().numpy(), idx.cpu().numpy()
        for row, (qi, _) in enumerate(known):
            q = queries[qi]
            n = int(q.get("num", 10))
            black = set(q.get("blackList") or ())
            keep = idx[row] >= 0
            out = []
            for it, s in zip(model.items.decode(idx[row][keep]),
                             scores[row][keep]):
                if it in black:
                    continue
                out.append({"item": it, "score": float(s)})
                if len(out) >= n:
                    break
            results[qi] = {"itemScores": out}
        return results

    def prepare_model_for_deploy(self, ctx, model: RecommendationModel):
        """Move the restored factors onto the serving device as f32."""
        factors = als.ALSModel(
            torch.as_tensor(model.factors.user_factors,
                            dtype=torch.float32).to(ctx.device),
            torch.as_tensor(model.factors.item_factors,
                            dtype=torch.float32).to(ctx.device),
        )
        return RecommendationModel(
            factors, model.users, model.items, model.validation)


class RecommendationEngine(EngineFactory):
    """engine.json engineFactory target."""

    @classmethod
    def apply(cls) -> Engine:
        return Engine(
            RecommendationDataSource,
            IdentityPreparator,
            {"als": ALSAlgorithm},
            FirstServing,
        )
