"""Similar-product engine template — item-to-item similarity over ALS
factors, or over raw co-occurrence (DIMSUM).

Counterpart of ``pio_tpu.models.similarproduct``: the same params, data,
query {"items": [...], "num": N, "categories"?, "whiteList"?,
"blackList"?} and result {"itemScores": [...]} (reference
examples/scala-parallel-similarproduct/*; ALSAlgorithm.scala cosine loop;
multi/LikeAlgorithm.scala:21-86). ``ALSSimilarityAlgorithm`` trains
``ops/als.py``'s ``als_train`` on the context's device (K2 on the card,
``accum="auto"``), or ``als_train_sharded`` when the context's mesh holds
more than one rank, and serves the cosine top-k of ``ops/similarity.py``;
``SimilarProductModel`` is a plain dataclass holding the f32 item factors
as a tensor. ``DIMSUMAlgorithm`` computes the exact column cosine
(``ops/similarity.column_cosine_topk``) on the device and serves its
top-k table on the host, as the reference does.

A query's answer has the same bits alone or in a batch: ``batch_predict``
averages each query's item rows with ``ops/similarity.group_means``, as
``predict`` does through ``mean_vector``, and ``cosine_topk`` runs its
product at the dispatch rows.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from pio_tpu_torch.controller.base import (
    DataSource,
    FirstServing,
    IdentityPreparator,
    P2LAlgorithm,
    PAlgorithm,
    Params,
)
from pio_tpu_torch.controller.engine import Engine, EngineFactory
from pio_tpu_torch.data.bimap import EntityIdIndex
from pio_tpu_torch.data.eventstore import Interactions
from pio_tpu_torch.models.filtering import (
    candidate_ids,
    invert_categories,
    rank_candidates,
)
from pio_tpu_torch.ops import als
from pio_tpu_torch.ops.similarity import (
    column_cosine_topk,
    cosine_topk,
    group_means,
    mean_vector,
)


@dataclass(frozen=True)
class DataSourceParams(Params):
    app_name: str = ""
    event_names: tuple[str, ...] = ("view", "like")


@dataclass
class SimilarProductData:
    interactions: Interactions
    item_categories: dict[str, list[str]]  # item id -> categories

    def sanity_check(self):
        self.interactions.sanity_check()


class SimilarProductDataSource(DataSource):
    params_class = DataSourceParams

    def __init__(self, params: DataSourceParams):
        self.params = params

    def read_training(self, ctx) -> SimilarProductData:
        p = self.params
        inter = ctx.event_store.interactions(
            app_name=p.app_name,
            entity_type="user",
            target_entity_type="item",
            event_names=list(p.event_names),
            value_key=None,
            default_value=1.0,
            dedup="sum",
        )
        item_props = ctx.event_store.aggregate_properties(
            app_name=p.app_name, entity_type="item"
        )
        cats = {
            iid: pm.get_or_else("categories", [])
            for iid, pm in item_props.items()
        }
        return SimilarProductData(inter, cats)


@dataclass(frozen=True)
class ALSAlgorithmParams(Params):
    rank: int = 10
    num_iterations: int = 10
    lambda_: float = 0.01
    alpha: float = 1.0
    seed: int | None = None
    chunk: int = 65536


@dataclass
class SimilarProductModel:
    """Item factors (f32, on the serving device once deployed) + id index
    + categories (reference ALSModel with productFeatures + items map)."""

    item_factors: torch.Tensor
    items: EntityIdIndex
    item_categories: dict

    def cat_index(self) -> dict:
        return _cached_cat_index(self)


def _parse_similar_query(items_index, query: dict):
    """Shared query parsing for the similarproduct algorithms (reference
    predict() preamble: item->index map, white/black lists, query items
    always excluded from results)."""
    items = query.get("items") or []
    num = int(query.get("num", 10))
    known = [i for i in items if i in items_index]
    exclude = set(items) | set(query.get("blackList") or ())
    white = set(query.get("whiteList") or ()) or None
    categories = set(query.get("categories") or ()) or None
    return num, known, exclude, white, categories


def _cached_cat_index(model) -> dict:
    """category -> [item ids], built lazily once per model instance."""
    if not hasattr(model, "_cat_index"):
        model._cat_index = invert_categories(model.item_categories)
    return model._cat_index


class ALSSimilarityAlgorithm(PAlgorithm):
    params_class = ALSAlgorithmParams

    def __init__(self, params: ALSAlgorithmParams):
        self.params = params

    def train(self, ctx, data: SimilarProductData) -> SimilarProductModel:
        """``als_train`` on ``ctx.device``, or ``als_train_sharded``
        when the context's mesh holds more than one rank."""
        data.sanity_check()
        inter = data.interactions
        p = self.params
        ap = als.ALSParams(
            rank=p.rank, iterations=p.num_iterations, reg=p.lambda_,
            alpha=p.alpha, implicit=True,
            seed=p.seed if p.seed is not None else 3, chunk=p.chunk,
        )
        mesh = getattr(ctx, "mesh", None)  # absent or None: one device
        if mesh is not None and mesh.size > 1:
            factors = als.als_train_sharded(
                inter.user_idx, inter.item_idx, inter.values,
                inter.n_users, inter.n_items, ap, mesh,
            )
        else:
            factors = als.als_train(
                inter.user_idx, inter.item_idx, inter.values,
                inter.n_users, inter.n_items, ap, device=ctx.device,
            )
        return SimilarProductModel(
            factors.item_factors, inter.items, data.item_categories
        )

    def prepare_model_for_deploy(self, ctx, model: SimilarProductModel):
        """Move the restored item factors onto the serving device as
        f32."""
        return SimilarProductModel(
            torch.as_tensor(model.item_factors,
                            dtype=torch.float32).to(ctx.device),
            model.items, model.item_categories)

    def predict(self, model: SimilarProductModel, query: dict) -> dict:
        """Reference ALSAlgorithm.predict: average query-item vectors,
        cosine top-k over the catalog, filter query items / categories /
        white / black lists."""
        num, known, exclude, white, categories = \
            _parse_similar_query(model.items, query)
        if not known:
            return {"itemScores": []}
        q_idx = model.items.encode(known)
        qv = mean_vector(model.item_factors, q_idx)
        candidates = candidate_ids(
            model.items, model.item_categories, white, categories, exclude,
            cat_index=model.cat_index,
        )
        if candidates is not None:
            # selective filters: rank WITHIN the candidate set (reference
            # ALSAlgorithm.scala filters candidates before its cosine loop);
            # scoring is one gather + product + top-k on the device
            if not candidates:
                return {"itemScores": []}
            cidx = model.items.encode(candidates)
            pos, scores = rank_candidates(
                model.item_factors, qv, cidx, num, normalize=True
            )
            return {"itemScores": [
                {"item": candidates[p], "score": float(s)}
                for p, s in zip(pos, scores)
            ]}
        k = min(num + len(exclude), model.item_factors.shape[0])
        scores, idx = cosine_topk(model.item_factors, qv, k)
        return self._format_topk(
            model, scores[0].cpu().numpy(), idx[0].cpu().numpy(), exclude,
            num)

    @staticmethod
    def _format_topk(model, scores, idx, exclude, num) -> dict:
        out = []
        for i, s in zip(model.items.decode(idx), scores):
            if i in exclude:
                continue
            out.append({"item": i, "score": float(s)})
            if len(out) >= num:
                break
        return {"itemScores": out}

    def batch_predict(self, model: SimilarProductModel, queries) -> list:
        """Vectorized batch scoring (the micro-batcher's path): plain
        queries (no whiteList/categories filters) share ONE gather of all
        query-item vectors and their means (``group_means``), and ONE
        cosine top-k over the batch (over-fetch k = num + max excluded,
        host filter). Selectively-filtered queries keep full
        candidate-set semantics via the single-query path."""
        results: list[dict] = [{"itemScores": []} for _ in queries]
        plain = []   # (query_index, q_idx array, exclude set, num)
        for i, q in enumerate(queries):
            num, known, exclude, white, categories = \
                _parse_similar_query(model.items, q)
            if not known:
                continue
            if white or categories:
                results[i] = self.predict(model, q)
            else:
                plain.append(
                    (i, model.items.encode(known), exclude, num))
        if not plain:
            return results
        qv = group_means(model.item_factors, [qi for _, qi, _, _ in plain])
        k = min(
            max(num + len(exclude) for _, _, exclude, num in plain),
            model.item_factors.shape[0],
        )
        scores, idx = cosine_topk(model.item_factors, qv, k)
        scores, idx = scores.cpu().numpy(), idx.cpu().numpy()
        for r, (qi_out, _, exclude, num) in enumerate(plain):
            results[qi_out] = self._format_topk(
                model, scores[r], idx[r], exclude, num)
        return results


@dataclass(frozen=True)
class DIMSUMParams(Params):
    """Reference DIMSUMAlgorithmParams(threshold)
    (examples/experimental/scala-parallel-similarproduct-dimsum/src/main/
    scala/DIMSUMAlgorithm.scala:22). `k_sim` bounds the neighbor table
    kept per item (the reference keeps full sparse similarity rows; a
    top-k table is the fixed-shape equivalent)."""

    threshold: float = 0.0
    k_sim: int = 50
    user_batch: int = 4096


@dataclass
class DIMSUMModel:
    """Top-k item-to-item cosine table over the RAW interaction matrix
    (reference DIMSUMModel.similarities sparse rows)."""

    sim_scores: np.ndarray      # (n_items, k_sim) cosine scores
    sim_idx: np.ndarray         # (n_items, k_sim) neighbor item indices
    items: EntityIdIndex
    item_categories: dict

    def cat_index(self) -> dict:
        return _cached_cat_index(self)


class DIMSUMAlgorithm(P2LAlgorithm):
    """Exact all-pairs column cosine (ops/similarity.column_cosine_topk) —
    the redesign of MLlib RowMatrix.columnSimilarities(threshold)
    (DIMSUMAlgorithm.scala:125-132). Unlike the ALS algorithm this scores
    items by raw co-occurrence, no factorization. P2L: device-heavy train
    (on ``ctx.device``), small host model (the reference persists its RDD
    rows; the top-k table checkpoints whole)."""

    params_class = DIMSUMParams

    def __init__(self, params: DIMSUMParams = DIMSUMParams()):
        self.params = params

    def train(self, ctx, data: SimilarProductData) -> DIMSUMModel:
        data.sanity_check()
        inter = data.interactions
        p = self.params
        scores, idx = column_cosine_topk(
            inter.user_idx, inter.item_idx, inter.values,
            inter.n_users, inter.n_items,
            k=p.k_sim, threshold=p.threshold, user_batch=p.user_batch,
            device=None if ctx is None else ctx.device,
        )
        return DIMSUMModel(scores, idx, inter.items, data.item_categories)

    def predict(self, model: DIMSUMModel, query: dict) -> dict:
        """Reference DIMSUMAlgorithm.predict: union the query items'
        similarity rows, sum scores per candidate, filter query items /
        white / black lists, top num."""
        num, known, exclude, white, categories = \
            _parse_similar_query(model.items, query)
        if not known:
            return {"itemScores": []}
        q_idx = model.items.encode(known)
        agg: dict[int, float] = {}
        for qi in q_idx:
            for j, s in zip(model.sim_idx[qi], model.sim_scores[qi]):
                if s > 0:
                    agg[int(j)] = agg.get(int(j), 0.0) + float(s)
        # filter semantics shared with the ALS path (filtering.py): when a
        # selective filter is present, membership comes from candidate_ids
        allowed = candidate_ids(
            model.items, model.item_categories, white, categories, exclude,
            cat_index=model.cat_index,
        )
        allowed = None if allowed is None else set(allowed)
        out = []
        for j, s in sorted(agg.items(), key=lambda kv: (-kv[1], kv[0])):
            iid = model.items.id_of(j)
            if iid in exclude:
                continue
            if allowed is not None and iid not in allowed:
                continue
            out.append({"item": iid, "score": s})
            if len(out) >= num:
                break
        return {"itemScores": out}


class SimilarProductEngine(EngineFactory):
    @classmethod
    def apply(cls) -> Engine:
        return Engine(
            SimilarProductDataSource,
            IdentityPreparator,
            {"als": ALSSimilarityAlgorithm, "dimsum": DIMSUMAlgorithm},
            FirstServing,
        )
