"""User-code engine: recommendation with a custom Serving layer.

The DASE extensibility demo the reference ships as
examples/scala-parallel-recommendation/custom-serving/src/main/scala/Serving.scala:
the Serving stage re-reads a plain-text list of disabled items ON EVERY
QUERY (so ops can blacklist a product by editing a file, no redeploy) and
filters them out of the algorithm's predictions.

Only public framework API is used: the built-in recommendation DataSource +
ALS algorithm are composed with this file's Serving subclass — the
user-code surface is exactly the reference's (swap one DASE stage, keep the
rest).

The PyTorch port's counterpart of ``../engine.py``: the same user code on
``pio_tpu_torch``, run through ``python -m pio_tpu_torch`` with
``--engine-dir`` this directory. The disabled-items file's path is
engine-dir-relative here (``path_fields``); a missing file disables
nothing.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from pio_tpu_torch.controller import (
    Engine,
    EngineFactory,
    IdentityPreparator,
    Params,
    Serving,
)
from pio_tpu_torch.models.recommendation import (
    ALSAlgorithm,
    RecommendationDataSource,
)


@dataclass(frozen=True)
class ServingParams(Params):
    path_fields = ("disabled_items_file",)  # engine-dir-relative

    # newline-separated item ids; missing file means nothing is disabled
    disabled_items_file: str = "../data/disabled_items.txt"


class DisabledItemsServing(Serving):
    """Reference Serving.scala: `Source.fromFile(...).getLines` per serve
    call — intentionally re-read every time so edits take effect live."""

    params_class = ServingParams

    def __init__(self, params: ServingParams):
        self.params = params

    def _disabled(self) -> set[str]:
        path = self.params.disabled_items_file
        if not os.path.exists(path):
            return set()
        with open(path) as f:
            return {line.strip() for line in f if line.strip()}

    def serve(self, query, predictions):
        disabled = self._disabled()
        first = predictions[0]
        return {
            "itemScores": [
                s for s in first["itemScores"] if s["item"] not in disabled
            ]
        }


class CustomServingEngine(EngineFactory):
    @classmethod
    def apply(cls) -> Engine:
        return Engine(
            RecommendationDataSource,
            IdentityPreparator,
            {"als": ALSAlgorithm},
            DisabledItemsServing,
        )
