"""User-code engine: recommendation with a custom Preparator.

The reference's examples/scala-parallel-recommendation/custom-prepartor/
src/main/scala/Preparator.scala: a CustomPreparatorParams(filepath) names a
text file of excluded item ids; prepare() drops those items' ratings before
ALS ever sees them (vs custom-serving, which filters at query time — this
variant removes them from the learned model entirely).

The exclusion is a vectorized mask over the COO columns — the TPU-native
Interactions replaces the reference's RDD[Rating].filter.

The PyTorch port's counterpart of ``../engine.py``: the same user code on
``pio_tpu_torch``, run through ``python -m pio_tpu_torch`` with
``--engine-dir`` this directory. The exclusion file's path is
engine-dir-relative here (``path_fields``); a missing file excludes
nothing.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from pio_tpu_torch.controller import (
    Engine,
    EngineFactory,
    FirstServing,
    Params,
    Preparator,
)
from pio_tpu_torch.data.bimap import EntityIdIndex
from pio_tpu_torch.data.eventstore import Interactions
from pio_tpu_torch.models.recommendation import (
    ALSAlgorithm,
    RecommendationDataSource,
)


@dataclass(frozen=True)
class PreparatorParams(Params):
    path_fields = ("exclude_items_file",)  # engine-dir-relative

    exclude_items_file: str = "../data/excluded_items.txt"


class ExcludeItemsPreparator(Preparator):
    params_class = PreparatorParams

    def __init__(self, params: PreparatorParams):
        self.params = params

    def _excluded(self) -> set[str]:
        path = self.params.exclude_items_file
        if not os.path.exists(path):
            return set()
        with open(path) as f:
            return {line.strip() for line in f if line.strip()}

    def prepare(self, ctx, td: Interactions) -> Interactions:
        excluded = self._excluded()
        if not excluded:
            return td
        # re-index items so the model's item table contains no excluded ids
        keep_ids = [i for i in td.items.ids() if i not in excluded]
        items = EntityIdIndex(keep_ids)
        old_to_new = np.full(td.n_items, -1, np.int32)
        for new, iid in enumerate(keep_ids):
            old_to_new[td.items.index_of(iid)] = new
        mask = old_to_new[td.item_idx] >= 0
        return Interactions(
            user_idx=td.user_idx[mask],
            item_idx=old_to_new[td.item_idx[mask]],
            values=td.values[mask],
            users=td.users,
            items=items,
        )


class CustomPreparatorEngine(EngineFactory):
    @classmethod
    def apply(cls) -> Engine:
        return Engine(
            RecommendationDataSource,
            ExcludeItemsPreparator,
            {"als": ALSAlgorithm},
            FirstServing,
        )
