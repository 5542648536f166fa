"""E-commerce recommendation template — ALS + serve-time business rules.

Counterpart of ``pio_tpu.models.ecommerce`` (reference examples/
scala-parallel-ecommercerecommendation/train-with-rate-event/src/main/
scala/ALSAlgorithm.scala:148-341), with the same params, queries and
results:
 * implicit ALS over view/buy events, ``ops/als.py``'s ``als_train`` on
   the context's device (K2 on the card, ``accum="auto"``), or
   ``als_train_sharded`` when the context's mesh holds more than one
   rank;
 * serve-time filtering: seen items (live read of the user's view/buy
   events), the "unavailableItems" constraint entity (TTL-cached, its last
   good set served through a storage outage), whiteList / blackList,
   category filter;
 * cold start: unknown users are served from their recent view events —
   the viewed items' factors averaged and ranked by cosine similarity.

Scoring is ``ops/als.recommend_topk`` for known users and
``ops/similarity.cosine_topk`` for cold ones, both with their products at
the dispatch rows, so a query's answer has the same bits alone or in a
batch. The serve-time store is bound in ``prepare_model_for_deploy``, on
the algorithm instance that then serves (the deploy serves with the
instances it prepared). The training read goes through ``find``, a row
read, as the reference's does.
"""

from __future__ import annotations

import time
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
from pio_tpu_torch.data.eventstore import Interactions, to_interactions
from pio_tpu_torch.models.filtering import (
    candidate_ids,
    invert_categories,
    rank_candidates,
)
from pio_tpu_torch.ops import als
from pio_tpu_torch.ops.similarity import cosine_topk, mean_vector


@dataclass(frozen=True)
class DataSourceParams(Params):
    app_name: str = ""
    event_names: tuple[str, ...] = ("view", "buy")


@dataclass
class ECommerceData:
    interactions: Interactions
    item_categories: dict[str, list[str]]

    def sanity_check(self):
        self.interactions.sanity_check()


class ECommerceDataSource(DataSource):
    params_class = DataSourceParams

    def __init__(self, params: DataSourceParams):
        self.params = params

    def read_training(self, ctx) -> ECommerceData:
        p = self.params
        events = ctx.event_store.find(
            app_name=p.app_name,
            entity_type="user",
            target_entity_type="item",
            event_names=list(p.event_names),
        )
        # buy weighs heavier than view (reference train-with-rate-event
        # maps buy to a stronger implicit signal)
        inter = to_interactions(
            events,
            value_fn=lambda e: 4.0 if e.event == "buy" else 1.0,
            dedup="sum",
        )
        item_props = ctx.event_store.aggregate_properties(
            app_name=p.app_name, entity_type="item"
        )
        cats = {
            iid: pm.get_or_else("categories", [])
            for iid, pm in item_props.items()
        }
        return ECommerceData(inter, cats)


@dataclass(frozen=True)
class ECommAlgorithmParams(Params):
    app_name: str = ""            # serve-time event reads
    rank: int = 10
    num_iterations: int = 10
    lambda_: float = 0.01
    alpha: float = 1.0
    seed: int | None = None
    chunk: int = 65536
    unseen_only: bool = True      # filter items the user has seen
    seen_events: tuple[str, ...] = ("view", "buy")
    recent_events: tuple[str, ...] = ("view",)   # cold-start signal
    recent_count: int = 10
    # TTL (seconds) for the serve-time "unavailableItems" constraint read
    # — a GLOBAL aggregate that otherwise runs once per query, the
    # "DB query inside the predict path" hazard SURVEY §7 flags. Default
    # 0 = live read per query (reference behavior,
    # ALSAlgorithm.scala:232-260 — except that on a storage outage the
    # last successfully-read set serves instead of the reference's
    # empty set, which would UN-filter unavailable items mid-outage);
    # production deployments set e.g. 1-5 s
    # to keep the hot predict path off storage, trading bounded
    # staleness of the unavailable-items set. The per-user seen-items
    # read stays live either way: a just-bought item must drop out of
    # the very next recommendation.
    constraint_cache_ttl_s: float = 0.0


@dataclass
class ECommerceModel:
    factors: als.ALSModel
    users: Any
    items: Any
    item_categories: dict

    def cat_index(self) -> dict:
        """category -> [item ids], built lazily once per model."""
        if not hasattr(self, "_cat_index"):
            self._cat_index = invert_categories(self.item_categories)
        return self._cat_index


class ECommAlgorithm(PAlgorithm):
    params_class = ECommAlgorithmParams

    def __init__(self, params: ECommAlgorithmParams):
        self.params = params
        self._event_store = None  # bound at train / deploy prep
        # (expiry_monotonic, frozenset) for _unavailable_items
        self._constraint_cache: tuple[float, set[str]] | None = None

    def train(self, ctx, data: ECommerceData) -> ECommerceModel:
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
        self._event_store = ctx.event_store
        return ECommerceModel(
            factors, inter.users, inter.items, data.item_categories
        )

    # -- serve-time storage access ------------------------------------------
    def _bind_store(self):
        if self._event_store is None:
            from pio_tpu_torch.data.eventstore import EventStore

            self._event_store = EventStore()

    def prepare_model_for_deploy(self, ctx, model: ECommerceModel):
        """Bind the serve-time event store to THIS instance and move the
        restored factors onto the serving device as f32."""
        self._event_store = ctx.event_store
        factors = als.ALSModel(
            torch.as_tensor(model.factors.user_factors,
                            dtype=torch.float32).to(ctx.device),
            torch.as_tensor(model.factors.item_factors,
                            dtype=torch.float32).to(ctx.device),
        )
        return ECommerceModel(factors, model.users, model.items,
                              model.item_categories)

    def _seen_items(self, user: str) -> set[str]:
        """Live read of the user's seen items (reference
        LEventStore.findByEntity with seenEvents, ALSAlgorithm.scala:200-230)."""
        if not self.params.unseen_only or self._event_store is None:
            return set()
        try:
            events = self._event_store.find_by_entity(
                app_name=self.params.app_name,
                entity_type="user",
                entity_id=user,
                event_names=list(self.params.seen_events),
                limit=-1,
            )
            return {
                e.target_entity_id for e in events if e.target_entity_id
            }
        except Exception:  # noqa: BLE001 - storage outage must not kill serving
            return set()

    def _unavailable_items(self) -> set[str]:
        """Constraint entity 'unavailableItems' (reference
        ALSAlgorithm.scala:232-260: latest $set on constraint entity),
        TTL-cached per ECommAlgorithmParams.constraint_cache_ttl_s so the
        hot predict path is not gated on a storage aggregate per query."""
        if self._event_store is None:
            return set()
        ttl = self.params.constraint_cache_ttl_s
        now = time.monotonic()
        cached = self._constraint_cache
        if ttl > 0 and cached is not None and now < cached[0]:
            return cached[1]
        try:
            props = self._event_store.aggregate_properties(
                app_name=self.params.app_name, entity_type="constraint"
            )
            pm = props.get("unavailableItems")
            out = set(pm.get_or_else("items", [])) if pm else set()
        except Exception:  # noqa: BLE001
            # storage outage must not kill serving: serve the stale set
            # if we have one (bounded by the outage, not the TTL) and
            # RE-ARM a short expiry so a hanging backend gates one query
            # per second, not every query for the whole outage
            stale = cached[1] if cached is not None else set()
            if ttl > 0:
                self._constraint_cache = (now + min(ttl, 1.0), stale)
            return stale
        self._constraint_cache = (now + ttl, out)
        return out

    def _recent_item_vector(self, model: ECommerceModel, user: str):
        """Cold start: average factors of recently-viewed items (reference
        ALSAlgorithm.scala:262-300), (1, d) on the factors' device."""
        if self._event_store is None:
            return None
        try:
            events = self._event_store.find_by_entity(
                app_name=self.params.app_name,
                entity_type="user",
                entity_id=user,
                event_names=list(self.params.recent_events),
                limit=self.params.recent_count,
                latest=True,
            )
        except Exception:  # noqa: BLE001
            return None
        idx = [
            model.items.index_of(e.target_entity_id)
            for e in events
            if e.target_entity_id and e.target_entity_id in model.items
        ]
        if not idx:
            return None
        return mean_vector(model.factors.item_factors, np.array(idx))

    def predict(self, model: ECommerceModel, query: dict) -> dict:
        self._bind_store()
        return self._predict_impl(model, query, self._unavailable_items())

    def _predict_impl(self, model: ECommerceModel, query: dict,
                      unavailable: set) -> dict:
        """predict with the query-independent unavailable-items read done
        by the caller (batch_predict reads it once per batch)."""
        user = query.get("user", "")
        num = int(query.get("num", 10))
        exclude = set(query.get("blackList") or ())
        exclude |= self._seen_items(user)
        exclude |= unavailable
        white = set(query.get("whiteList") or ()) or None
        categories = set(query.get("categories") or ()) or None
        candidates = candidate_ids(
            model.items, model.item_categories, white, categories, exclude,
            cat_index=model.cat_index,
        )
        n_items = model.factors.item_factors.shape[0]

        known_user = user in model.users
        if not known_user:
            qv = self._recent_item_vector(model, user)
            if qv is None:
                return {"itemScores": []}

        if candidates is not None:
            # selective filters: score the candidate set directly (reference
            # isCandidateItem filters before ranking, ALSAlgorithm.scala);
            # one gather + product + top-k on the device
            if not candidates:
                return {"itemScores": []}
            cidx = model.items.encode(candidates)
            if known_user:
                uidx = model.users.index_of(user)
                qv = model.factors.user_factors[uidx]
            pos, scores = rank_candidates(
                model.factors.item_factors, qv, cidx, num,
                normalize=not known_user,
            )
            return {"itemScores": [
                {"item": candidates[p], "score": float(s)}
                for p, s in zip(pos, scores)
            ]}

        k = min(num + len(exclude), n_items)
        if known_user:
            uidx = model.users.index_of(user)
            scores, idx = als.recommend_topk(
                model.factors, np.array([uidx]), k
            )
        else:
            scores, idx = cosine_topk(model.factors.item_factors, qv, k)
        return self._format_topk(
            model, scores[0].cpu().numpy(), idx[0].cpu().numpy(), exclude,
            num)

    @staticmethod
    def _format_topk(model, scores, idx, exclude, num) -> dict:
        out = []
        for item, s in zip(model.items.decode(idx), scores):
            if item in exclude:
                continue
            out.append({"item": item, "score": float(s)})
            if len(out) >= num:
                break
        return {"itemScores": out}

    def batch_predict(self, model: ECommerceModel, queries) -> list:
        """Vectorized batch scoring (the micro-batcher's path): the
        query-independent unavailable-items constraint is read ONCE per
        batch; plain known-user queries share one top-k product and plain
        cold-start queries one cosine top-k (per-user seen/recent reads
        stay live, as the reference's serve-time semantics require).
        whiteList/categories queries keep candidate-set semantics via the
        single-query path."""
        self._bind_store()
        unavailable = self._unavailable_items()
        results: list[dict] = [{"itemScores": []} for _ in queries]
        known_plain = []   # (i, uidx, exclude, num)
        cold_plain = []    # (i, qv, exclude, num)
        for i, q in enumerate(queries):
            white = set(q.get("whiteList") or ()) or None
            categories = set(q.get("categories") or ()) or None
            if white or categories:
                results[i] = self._predict_impl(model, q, unavailable)
                continue
            user = q.get("user", "")
            exclude = (
                set(q.get("blackList") or ())
                | self._seen_items(user) | unavailable
            )
            num = int(q.get("num", 10))
            if user in model.users:
                known_plain.append(
                    (i, model.users.index_of(user), exclude, num))
            else:
                qv = self._recent_item_vector(model, user)
                if qv is not None:
                    cold_plain.append((i, qv, exclude, num))
        n_items = model.factors.item_factors.shape[0]
        if known_plain:
            k = min(
                max(num + len(ex) for _, _, ex, num in known_plain),
                n_items,
            )
            rows = np.array([u for _, u, _, _ in known_plain], np.int64)
            scores, idx = als.recommend_topk(model.factors, rows, k)
            scores, idx = scores.cpu().numpy(), idx.cpu().numpy()
            for r, (qi, _, exclude, num) in enumerate(known_plain):
                results[qi] = self._format_topk(
                    model, scores[r], idx[r], exclude, num)
        if cold_plain:
            k = min(
                max(num + len(ex) for _, _, ex, num in cold_plain),
                n_items,
            )
            qv = torch.cat([v for _, v, _, _ in cold_plain])
            scores, idx = cosine_topk(model.factors.item_factors, qv, k)
            scores, idx = scores.cpu().numpy(), idx.cpu().numpy()
            for r, (qi, _, exclude, num) in enumerate(cold_plain):
                results[qi] = self._format_topk(
                    model, scores[r], idx[r], exclude, num)
        return results


class ECommerceEngine(EngineFactory):
    @classmethod
    def apply(cls) -> Engine:
        return Engine(
            ECommerceDataSource,
            IdentityPreparator,
            {"ecomm": ECommAlgorithm},
            FirstServing,
        )
