"""DASE controller API — the developer-facing pipeline contracts.

Mirrors the reference controller layer (core/.../controller/): DataSource,
Preparator, Algorithm, Serving, plus the `Doer` instantiation helper
(core/AbstractDoer.scala:43-65). The reference distinguishes execution shapes
L / P2L / P by where data lives (local object vs RDD); the TPU-native
equivalents are about where the *model* lives:

 * LAlgorithm   — host-object model (reference LAlgorithm.scala:12-57);
 * P2LAlgorithm — mesh-trained, host-serializable model
                  (reference P2LAlgorithm.scala:13-49);
 * PAlgorithm   — device-resident (sharded jax.Array pytree) model
                  (reference PAlgorithm.scala:10-47). Unlike the reference —
                  which persists Unit and *retrains at deploy*
                  (Engine.scala:208-230) — these checkpoint their sharded
                  arrays and restore straight into serving HBM.

Queries/predictions are JSON-compatible dicts (the reference's typed Q/P via
gson/json4s collapses to plain dicts + optional dataclass params).
"""

from __future__ import annotations

import abc
import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Sequence


class TrainingInterruption(Exception):
    """Controlled stop (reference WorkflowUtils.scala:379-384
    StopAfterReadInterruption / StopAfterPrepareInterruption)."""

    def __init__(self, stage: str):
        super().__init__(f"stopped after {stage}")
        self.stage = stage


@dataclass(frozen=True)
class Params:
    """Base for per-stage parameter dataclasses (reference controller
    Params). Subclass with @dataclass(frozen=True)."""


@dataclass(frozen=True)
class EmptyParams(Params):
    pass


def params_from_dict(params_class: type | None, d: dict | None) -> Any:
    if params_class is None:
        return EmptyParams() if not d else d
    if d is None:
        return params_class()
    field_names = {f.name for f in dataclasses.fields(params_class)}
    unknown = set(d) - field_names
    if unknown:
        raise ValueError(
            f"unknown params {sorted(unknown)} for {params_class.__name__} "
            f"(expected subset of {sorted(field_names)})"
        )
    return params_class(**d)


def params_to_dict(p: Any) -> dict:
    if p is None:
        return {}
    if dataclasses.is_dataclass(p):
        return dataclasses.asdict(p)
    if isinstance(p, dict):
        return dict(p)
    raise TypeError(f"cannot serialize params of type {type(p)}")


def Doer(cls: type, params: Any = None):
    """Instantiate a DASE class with its params (reference
    AbstractDoer.scala Doer.apply: params-ctor first, zero-arg fallback).
    Accepts params as a dataclass instance or a raw dict (converted via the
    class's `params_class`)."""
    params_class = getattr(cls, "params_class", None)
    if isinstance(params, dict):
        params = params_from_dict(params_class, params)
    if params is None or isinstance(params, EmptyParams):
        try:
            return cls()
        except TypeError:
            return cls(params or EmptyParams())
    return cls(params)


class DataSource(abc.ABC):
    """Reads training (and evaluation) data from the event store
    (reference core/BaseDataSource.scala:31-52, controller/PDataSource.scala).
    """

    params_class: type | None = None

    @abc.abstractmethod
    def read_training(self, ctx) -> Any:
        """-> training data (TD): typically host numpy / columnar arrays."""

    def read_eval(self, ctx) -> Sequence[tuple[Any, Any, list[tuple[dict, Any]]]]:
        """-> [(TD, evaluation-info, [(query, actual)])] — one element per
        fold (reference readEvalBase)."""
        return []


class Preparator(abc.ABC):
    """TD -> PD (reference core/BasePreparator.scala:30-42)."""

    params_class: type | None = None

    @abc.abstractmethod
    def prepare(self, ctx, training_data) -> Any: ...


class IdentityPreparator(Preparator):
    """Reference controller/IdentityPreparator."""

    def prepare(self, ctx, training_data):
        return training_data


class Algorithm(abc.ABC):
    """Train on prepared data; answer queries (reference
    core/BaseAlgorithm.scala:55-123)."""

    params_class: type | None = None
    #: "local"  -> model pickled whole (L / P2L);
    #: "device" -> model is a jax pytree checkpointed with shardings (P)
    model_kind: str = "local"

    @abc.abstractmethod
    def train(self, ctx, prepared_data) -> Any: ...

    @abc.abstractmethod
    def predict(self, model, query: dict) -> Any: ...

    def batch_predict(self, model, queries: Sequence[dict]) -> list:
        """Bulk prediction for evaluation (reference batchPredictBase).
        Algorithms override with a vectorized/jit path; default loops."""
        return [self.predict(model, q) for q in queries]

    def prepare_model_for_deploy(self, ctx, model) -> Any:
        """Hook run at deploy after restore (e.g. device_put to the serving
        mesh). Reference analogue: Engine.prepareDeploy re-hydration."""
        return model


class LAlgorithm(Algorithm):
    model_kind = "local"


class P2LAlgorithm(Algorithm):
    model_kind = "local"


class PAlgorithm(Algorithm):
    model_kind = "device"


class Serving(abc.ABC):
    """Query pre/post-processing around algorithms (reference
    core/BaseServing.scala:28-51, controller/LServing.scala)."""

    params_class: type | None = None

    def supplement(self, query: dict) -> dict:
        return query

    @abc.abstractmethod
    def serve(self, query: dict, predictions: Sequence[Any]) -> Any:
        """Combine per-algorithm predictions into the served result."""


class FirstServing(Serving):
    """Reference controller/LFirstServing."""

    def serve(self, query, predictions):
        return predictions[0]


class AverageServing(Serving):
    """Reference controller/LAverageServing: numeric mean of predictions."""

    def serve(self, query, predictions):
        return sum(predictions) / len(predictions)


def sanity_check(data: Any) -> None:
    """Run the data's own sanityCheck hook if present (reference
    SanityCheck trait, Engine.scala:649-661)."""
    hook: Callable | None = getattr(data, "sanity_check", None)
    if callable(hook):
        hook()
