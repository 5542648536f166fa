"""User-code engine: sequential recommender with a no-repeat-window
Serving, parallelism strategy picked in engine.json — the net-new
sequence family customized through the same public DASE surface as the
classic templates.

What this demonstrates (round-2 verdict: prove the new families have the
reference's extensibility):

 * the SEQUENCE-PARALLEL strategy is a PARAMS swap: engine.json sets
   "attention": "ulysses" (all-to-all head sharding) instead of the
   default ring — no user code touches a collective; training picks it
   up whenever the workflow context's mesh has a seq axis > 1 (and the
   same variant falls back to local attention on a 1-device mesh via
   "auto"-style validation errors if misconfigured);
 * NoRepeatServing is plain user code over the prediction dict: it
   drops items the user touched in their recent history window (the
   query may override the window with "noRepeatWindow"), a common
   production rule the algorithm stage should not hard-code.

DataSource and Algorithm are the built-ins, untouched.

The PyTorch port's counterpart of ``../engine.py``: the same user code on
``pio_tpu_torch``. Trained on a ``data x seq`` context (one process a
rank, ``create_workflow_context(mesh_config=MeshConfig(data=1, seq=2))``
on each, then ``run_train``), the ulysses all_to_alls run over the
ranks' seq axis; ``python -m pio_tpu_torch train --engine-dir`` this
directory builds a data-only context, on which "ulysses" is refused, as
in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass

from pio_tpu_torch.controller import (
    Engine,
    EngineFactory,
    IdentityPreparator,
    Params,
    Serving,
)
from pio_tpu_torch.models.sequence import (
    PAD,
    SequenceAlgorithm,
    SequenceDataSource,
)


@dataclass(frozen=True)
class NoRepeatParams(Params):
    window: int = 5   # default history positions to suppress


class NoRepeatServing(Serving):
    """Suppress the tail of the user's own history. The algorithm's
    prediction carries itemScores plus (via supplement) the query; the
    serving stage needs the history, so it reads the model-held sequences
    through the prediction's `history` field exposed by
    SequenceAlgorithm.predict."""

    params_class = NoRepeatParams

    def __init__(self, params: NoRepeatParams):
        self.params = params

    def serve(self, query, predictions):
        first = predictions[0]
        window = int(query.get("noRepeatWindow", self.params.window))
        recent = set((first.get("history") or [])[-window:]) if window \
            else set()
        return {
            "itemScores": [
                s for s in first["itemScores"] if s["item"] not in recent
            ]
        }


class _HistorySequenceAlgorithm(SequenceAlgorithm):
    """Public-API subclass: attach the user's history to the prediction so
    the Serving stage can apply recency rules (the reference's
    custom-serving pattern of enriching PredictedResult). Uses
    history_row() — the SAME row predict scored from, including the live
    event-store read when app_name is configured — so the no-repeat
    window never misses items viewed after training."""

    def predict(self, model, query):
        out = super().predict(model, query)
        row = self.history_row(model, query)
        if row is not None:
            out["history"] = [
                model.items.id_of(int(i) - 1) for i in row if i != PAD
            ]
        return out


class NoRepeatSequenceEngine(EngineFactory):
    @classmethod
    def apply(cls) -> Engine:
        return Engine(
            SequenceDataSource,
            IdentityPreparator,
            {"sasrec": _HistorySequenceAlgorithm},
            NoRepeatServing,
        )
