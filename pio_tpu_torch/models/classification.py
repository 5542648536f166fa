"""Classification engine template — Naive Bayes + Random Forest.

Parity target: reference examples/scala-parallel-classification/
{add-algorithm, custom-attributes}: DataSource aggregates user entity
properties into labeled feature vectors (custom-attributes/.../DataSource.scala:30-60
maps categorical attrs through value maps and requires a `plan` label);
algorithms are MLlib NaiveBayes (NaiveBayesAlgorithm.scala:15-27) and
RandomForest (add-algorithm/.../RandomForestAlgorithm.scala:28-43); query =
attribute dict -> {"label": ...}.

Counterpart of ``pio_tpu.models.classification``, with the same params,
data, queries and results. Naive Bayes trains and scores in torch on the
context's device (``ops/naive_bayes.py``; the model's tensors go back to
the serving device in ``prepare_model_for_deploy``); forest GROWTH is
host-side histogram induction, and ``batch_predict`` of 2,048 queries or
more traverses the trees on the device the algorithm trained or deploys
on (``ops/forest.py``), fewer on the host, as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Sequence

import numpy as np
import torch

from pio_tpu_torch.controller.base import (
    DataSource,
    FirstServing,
    IdentityPreparator,
    LAlgorithm,
    P2LAlgorithm,
    Params,
)
from pio_tpu_torch.controller.engine import Engine, EngineFactory
from pio_tpu_torch.e2.crossvalidation import split_data
from pio_tpu_torch.e2.vectorizer import BinaryVectorizer
from pio_tpu_torch.ops import forest as rf
from pio_tpu_torch.ops import naive_bayes as nb


@dataclass(frozen=True)
class DataSourceParams(Params):
    app_name: str = ""
    attributes: tuple[str, ...] = ("gender", "age", "education")
    label: str = "plan"
    eval_k: int = 0


@dataclass
class ClassificationData:
    """Feature rows (one-hot categorical + numeric passthrough) + labels."""

    x: np.ndarray                    # (N, D) float32
    y: np.ndarray                    # (N,) int labels
    vectorizer: BinaryVectorizer
    numeric_fields: tuple[str, ...]
    labels: "Any"                    # BiMap label-value -> index

    def sanity_check(self):
        if len(self.y) == 0:
            raise ValueError(
                "ClassificationData is empty; check that entities define the "
                "required label/attribute properties."
            )

    def encode_query(self, attrs: dict) -> np.ndarray:
        cat = {k: v for k, v in attrs.items() if isinstance(v, str)}
        row = self.vectorizer.transform(cat)
        nums = np.array(
            [float(attrs.get(f, 0.0)) for f in self.numeric_fields],
            np.float32,
        )
        return np.concatenate([row, nums])


class ClassificationDataSource(DataSource):
    """aggregateProperties(entityType='user', required=[label]+attrs) ->
    labeled vectors (reference DataSource.scala:30-60). Categorical string
    attributes one-hot encode; numeric attributes pass through."""

    params_class = DataSourceParams

    def __init__(self, params: DataSourceParams):
        self.params = params

    def _read(self, ctx) -> ClassificationData:
        from pio_tpu_torch.data.bimap import BiMap

        p = self.params
        props = ctx.event_store.aggregate_properties(
            app_name=p.app_name,
            entity_type="user",
            required=[p.label, *p.attributes],
        )
        rows = []
        for entity_id, pm in sorted(props.items()):
            attrs = {a: pm.get(a) for a in p.attributes}
            rows.append((str(pm.get(p.label)), attrs))
        if not rows:
            return ClassificationData(
                x=np.zeros((0, 0), np.float32),
                y=np.zeros(0, np.int64),
                vectorizer=BinaryVectorizer.fit([], []),
                numeric_fields=(),
                labels=BiMap({}),
            )
        categorical = tuple(
            a for a in p.attributes
            if isinstance(rows[0][1][a], str)
        )
        numeric = tuple(a for a in p.attributes if a not in categorical)
        vec = BinaryVectorizer.fit(
            ({k: v for k, v in attrs.items() if k in categorical}
             for _, attrs in rows),
            categorical,
        )
        labels = BiMap.string_int(lbl for lbl, _ in rows)
        x = np.stack([
            np.concatenate([
                vec.transform({k: v for k, v in attrs.items()
                               if k in categorical}),
                np.array([float(attrs[f]) for f in numeric], np.float32),
            ])
            for _, attrs in rows
        ])
        y = np.array([labels[lbl] for lbl, _ in rows], np.int64)
        return ClassificationData(
            x=x, y=y, vectorizer=vec, numeric_fields=numeric, labels=labels
        )

    def read_training(self, ctx) -> ClassificationData:
        return self._read(ctx)

    def read_eval(self, ctx):
        data = self._read(ctx)
        if self.params.eval_k <= 1:
            return []
        rows = list(range(len(data.y)))
        folds = []
        for train_rows, info, test_rows in split_data(rows, self.params.eval_k):
            tr = ClassificationData(
                x=data.x[train_rows], y=data.y[train_rows],
                vectorizer=data.vectorizer,
                numeric_fields=data.numeric_fields, labels=data.labels,
            )
            qa = [
                ({"_vector": data.x[i].tolist()},
                 data.labels.inverse()[int(data.y[i])])
                for i in test_rows
            ]
            folds.append((tr, info, qa))
        return folds


@dataclass(frozen=True)
class NaiveBayesParams(Params):
    lambda_: float = 1.0  # reference NaiveBayesAlgorithm "lambda"


@dataclass
class NBClassifierModel:
    nb_model: nb.MultinomialNBModel
    data_schema: ClassificationData  # vectorizer/labels (x,y stripped)


def _schema_only(data: ClassificationData) -> ClassificationData:
    return ClassificationData(
        x=np.zeros((0, 0), np.float32), y=np.zeros(0, np.int64),
        vectorizer=data.vectorizer, numeric_fields=data.numeric_fields,
        labels=data.labels,
    )


def _query_vector(model_schema: ClassificationData, query: dict) -> np.ndarray:
    if "_vector" in query:  # eval path: pre-encoded
        return np.asarray(query["_vector"], np.float32)
    return model_schema.encode_query(query)


class NaiveBayesAlgorithm(P2LAlgorithm):
    """Reference NaiveBayesAlgorithm.scala:15-27 (MLlib NaiveBayes(lambda)).

    Note: multinomial NB treats numeric attributes as event counts, so
    threshold rules on raw numerics (e.g. age > 50) are poorly captured —
    same limitation as MLlib NB. Use the randomforest algorithm (the
    add-algorithm variant's point) when such rules matter."""

    params_class = NaiveBayesParams

    def __init__(self, params: NaiveBayesParams = NaiveBayesParams()):
        self.params = params

    def train(self, ctx, data: ClassificationData) -> NBClassifierModel:
        data.sanity_check()
        model = nb.multinomial_nb_train(
            data.x, data.y, n_classes=len(data.labels),
            smoothing=self.params.lambda_, device=ctx.device,
        )
        return NBClassifierModel(model, _schema_only(data))

    def prepare_model_for_deploy(self, ctx, model: NBClassifierModel):
        """Put the restored log-probabilities back on the serving
        device."""
        nbm = model.nb_model
        return NBClassifierModel(
            nb.MultinomialNBModel(
                torch.as_tensor(nbm.log_prior).to(ctx.device),
                torch.as_tensor(nbm.log_theta).to(ctx.device)),
            model.data_schema)

    def predict(self, model: NBClassifierModel, query: dict) -> dict:
        v = _query_vector(model.data_schema, query)
        label_idx = int(nb.multinomial_nb_predict(model.nb_model, v[None, :])[0])
        return {"label": model.data_schema.labels.inverse()[label_idx]}

    def batch_predict(self, model: NBClassifierModel, queries) -> list:
        if not queries:
            return []
        x = np.stack([_query_vector(model.data_schema, q) for q in queries])
        preds = nb.multinomial_nb_predict(model.nb_model, x)
        inv = model.data_schema.labels.inverse()
        return [{"label": inv[int(i)]} for i in preds]


@dataclass(frozen=True)
class RandomForestParams(Params):
    num_trees: int = 10
    max_depth: int = 5
    feature_subset_strategy: str = "auto"
    max_bins: int = 32  # MLlib Strategy.maxBins; 0 = exact threshold search
    seed: int = 0


@dataclass
class RFClassifierModel:
    forest: rf.RandomForestModel
    data_schema: ClassificationData


class RandomForestAlgorithm(LAlgorithm):
    """Reference RandomForestAlgorithm.scala:28-43."""

    params_class = RandomForestParams

    def __init__(self, params: RandomForestParams = RandomForestParams()):
        self.params = params
        # where batch_predict traverses large batches: the device of the
        # context this instance trained or deploys on
        self._device = None

    def train(self, ctx, data: ClassificationData) -> RFClassifierModel:
        data.sanity_check()
        self._device = ctx.device
        model = rf.random_forest_train(
            data.x, data.y, n_classes=len(data.labels),
            num_trees=self.params.num_trees,
            max_depth=self.params.max_depth,
            feature_subset=self.params.feature_subset_strategy,
            max_bins=self.params.max_bins,
            seed=self.params.seed,
        )
        return RFClassifierModel(model, _schema_only(data))

    def prepare_model_for_deploy(self, ctx, model: RFClassifierModel):
        self._device = ctx.device
        return model

    def predict(self, model: RFClassifierModel, query: dict) -> dict:
        v = _query_vector(model.data_schema, query)
        label_idx = int(model.forest.predict(v[None, :])[0])
        return {"label": model.data_schema.labels.inverse()[label_idx]}

    def batch_predict(self, model: RFClassifierModel, queries) -> list:
        if not queries:
            return []
        x = np.stack([_query_vector(model.data_schema, q) for q in queries])
        if len(x) >= 2048:  # big catalogs: the gather loop on the device
            preds = model.forest.predict_device(
                x, device=self._device).cpu().numpy()
        else:
            preds = model.forest.predict(x)
        inv = model.data_schema.labels.inverse()
        return [{"label": inv[int(i)]} for i in preds]


class ClassificationEngine(EngineFactory):
    """Multi-algorithm engine (the add-algorithm variant's point: register
    both NB and RF, select via engine.json)."""

    @classmethod
    def apply(cls) -> Engine:
        return Engine(
            ClassificationDataSource,
            IdentityPreparator,
            {"naive": NaiveBayesAlgorithm, "randomforest": RandomForestAlgorithm},
            FirstServing,
        )
