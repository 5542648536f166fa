"""User-code engine: recommendation with a custom DataSource.

The DASE extensibility demo the reference ships as
examples/experimental/scala-parallel-recommendation-custom-datasource/
src/main/scala/DataSource.scala: instead of reading the event store, the
DataSource parses a `user::item::rate` text file (the MovieLens raw
format) — swap one DASE stage, keep the rest of the engine untouched.

The PyTorch port's counterpart of ``../engine.py``: the same user code on
``pio_tpu_torch``, run through ``python -m pio_tpu_torch`` with
``--engine-dir`` this directory; the ratings file is the example's own
(``../data/ratings.txt``, engine-dir-relative).

Only public framework API is used: this file's DataSource yields the same
`Interactions` the built-in event-store DataSource does, so the built-in
ALS algorithm and serving stages compose with it unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from pio_tpu_torch.controller import (
    DataSource,
    Engine,
    EngineFactory,
    FirstServing,
    IdentityPreparator,
    Params,
)
from pio_tpu_torch.data.bimap import EntityIdIndex
from pio_tpu_torch.data.eventstore import Interactions
from pio_tpu_torch.models.recommendation import ALSAlgorithm


@dataclass(frozen=True)
class DataSourceParams(Params):
    path_fields = ("filepath",)  # engine-dir-relative (CLI absolutizes)

    filepath: str = "../data/ratings.txt"
    separator: str = "::"        # reference DataSource.scala:28 split("::")


class FileRatingsDataSource(DataSource):
    """`user::item::rate` lines -> Interactions (reference
    DataSource.scala:24-33 sc.textFile + split match)."""

    params_class = DataSourceParams

    def __init__(self, params: DataSourceParams):
        self.params = params

    def read_training(self, ctx) -> Interactions:
        users_raw, items_raw, vals = [], [], []
        with open(self.params.filepath) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                user, item, rate = line.split(self.params.separator)
                users_raw.append(user)
                items_raw.append(item)
                vals.append(float(rate))
        users = EntityIdIndex(users_raw)
        items = EntityIdIndex(items_raw)
        return Interactions(
            user_idx=users.encode(users_raw).astype(np.int32),
            item_idx=items.encode(items_raw).astype(np.int32),
            values=np.asarray(vals, np.float32),
            users=users,
            items=items,
        )


class CustomDataSourceEngine(EngineFactory):
    @classmethod
    def apply(cls) -> Engine:
        return Engine(
            FileRatingsDataSource,
            IdentityPreparator,
            {"als": ALSAlgorithm},
            FirstServing,
        )
