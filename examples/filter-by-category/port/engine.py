"""User-code engine: recommendation filtered by item category.

The reference pattern is examples/scala-parallel-similarproduct/
filterbycategory (DataSource additionally reads item `$set` events carrying
`categories`; predict restricts results to the query's categories). Here the
same extension is applied to the plain recommendation engine, whose built-in
stages know nothing about categories — every piece of category handling
below is user code on the public API:

 * CategoryDataSource wraps the built-in DataSource and ALSO aggregates item
   properties from the event store;
 * CategoryALSAlgorithm keeps the item->categories map in its model and
   filters predictions to the query's categories.

The PyTorch port's counterpart of ``../engine.py``: the same user code on
``pio_tpu_torch``, run through ``python -m pio_tpu_torch`` with
``--engine-dir`` this directory. The wrapper is pickled whole; at deploy
the built-in algorithm's ``prepare_model_for_deploy`` puts the restored
factors on the serving device.
"""

from __future__ import annotations

from dataclasses import dataclass

from pio_tpu_torch.controller import (
    Engine,
    EngineFactory,
    FirstServing,
    IdentityPreparator,
)
from pio_tpu_torch.models.recommendation import (
    ALSAlgorithm,
    ALSAlgorithmParams,
    DataSourceParams,
    RecommendationDataSource,
)


@dataclass
class CategoryData:
    interactions: object          # Interactions
    item_categories: dict         # item id -> [category, ...]

    def sanity_check(self):
        self.interactions.sanity_check()


class CategoryDataSource(RecommendationDataSource):
    """Built-in ratings read + an item-property aggregation pass
    (reference filterbycategory DataSource.scala: items eventsDb.aggregate
    Properties with `categories`)."""

    params_class = DataSourceParams

    def read_training(self, ctx) -> CategoryData:
        inter = super().read_training(ctx)
        props = ctx.event_store.aggregate_properties(
            app_name=self.params.app_name, entity_type="item"
        )
        cats = {
            iid: pm.get_or_else("categories", []) for iid, pm in props.items()
        }
        return CategoryData(inter, cats)


@dataclass
class CategoryModel:
    base: object                  # RecommendationModel
    item_categories: dict


class CategoryALSAlgorithm(ALSAlgorithm):
    params_class = ALSAlgorithmParams
    # the base model holds device tensors; wrapping it in a host
    # dataclass makes this an ordinary pickled model (L/P2L shape), its
    # tensors saved as numpy
    model_kind = "local"

    def train(self, ctx, data: CategoryData) -> CategoryModel:
        base = super().train(ctx, data.interactions)
        return CategoryModel(base, data.item_categories)

    def prepare_model_for_deploy(self, ctx, model: CategoryModel):
        base = super().prepare_model_for_deploy(ctx, model.base)
        return CategoryModel(base, model.item_categories)

    def predict(self, model: CategoryModel, query: dict) -> dict:
        want = set(query.get("categories") or ())
        if not want:
            return super().predict(model.base, query)
        # over-fetch, then keep items tagged with any requested category
        num = int(query.get("num", 10))
        inner = dict(query, num=num * 10)
        result = super().predict(model.base, inner)
        kept = [
            s for s in result["itemScores"]
            if want & set(model.item_categories.get(s["item"], ()))
        ]
        return {"itemScores": kept[:num]}


class FilterByCategoryEngine(EngineFactory):
    @classmethod
    def apply(cls) -> Engine:
        return Engine(
            CategoryDataSource,
            IdentityPreparator,
            {"als": CategoryALSAlgorithm},
            FirstServing,
        )
