"""The classification template of the port and the ops under it against
the JAX package, on the CPU.

- naive Bayes: the multinomial model's train and scores (torch) against
  ``pio_tpu.ops.naive_bayes`` on the same seeded counts, labels exact,
  equal scores resolved to the lowest label as ``jnp.argmax`` does; the
  categorical model (host numpy in both) table for table;
- random forest: both packages grow the same trees from one seed (the
  induction is host numpy in both); the port's traversal in torch on the
  CPU equals the reference's jitted ``predict_device`` and the host
  ``predict``, label for label, tied votes included;
- the markov chain's top-n and the binary vectorizer;
- the template on one sqlite store: both packages read the same labelled
  vectors, the reference's models carried across by ``convert.py`` answer
  as the reference's do, ``batch_predict`` equals ``predict`` (2,048
  queries and more go through the device traversal), ``MetricEvaluator``
  scores its folds as the reference's does, and ``python -m pio_tpu_torch
  train`` → ``create_query_server`` (what ``deploy`` serves) → ``eval``
  in class mode → ``batchpredict`` run with ``--device cpu``.

Tolerances: naive Bayes log-probabilities and scores within 1e-6 (f32
sums in another order); everything else exact.
"""

import _torch_cpu  # noqa: F401  (one CPU thread: see the module)
import json
import sys
import urllib.request
from datetime import datetime, timedelta, timezone

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pio_tpu.controller import AverageMetric as RefAverageMetric
from pio_tpu.controller import MetricEvaluator as RefMetricEvaluator
from pio_tpu.controller.engine import EngineParams as RefEngineParams
from pio_tpu.data.storage import Storage as RefStorage
from pio_tpu.e2 import engine as ref_e2
from pio_tpu.models import classification as ref_cls
from pio_tpu.ops import forest as ref_forest
from pio_tpu.ops import markov as ref_markov
from pio_tpu.ops import naive_bayes as ref_nb
from pio_tpu.workflow.context import create_workflow_context as ref_context
from pio_tpu_torch import convert
from pio_tpu_torch.__main__ import main as port_main
from pio_tpu_torch.controller import AverageMetric, MetricEvaluator
from pio_tpu_torch.controller.engine import EngineParams
from pio_tpu_torch.data.dao import App
from pio_tpu_torch.data.event import Event
from pio_tpu_torch.data.storage import Storage
from pio_tpu_torch.e2 import engine as e2
from pio_tpu_torch.models import classification as cls
from pio_tpu_torch.ops import forest
from pio_tpu_torch.ops import markov
from pio_tpu_torch.ops import naive_bayes as nb
from pio_tpu_torch.workflow.context import create_workflow_context
from pio_tpu_torch.workflow.serve import ServingConfig, create_query_server

NB_TOL = 1e-6
T0 = datetime(2026, 1, 1, tzinfo=timezone.utc)
APP = "clsapp"
ATTRS = ("gender", "education", "age")
FACTORY = "pio_tpu_torch.models.classification.ClassificationEngine"


# -- naive Bayes ------------------------------------------------------------

def _counts(seed=0, n=300, d=12, classes=4):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, classes, n)
    rates = rng.uniform(0.1, 4.0, size=(classes, d))
    return rng.poisson(rates[y]).astype(np.float32), y


@pytest.mark.parametrize("smoothing", [1.0, 0.25])
def test_multinomial_nb_matches_reference(smoothing):
    x, y = _counts()
    got = nb.multinomial_nb_train(x, y, 4, smoothing, device="cpu")
    want = ref_nb.multinomial_nb_train(x, y, 4, smoothing)
    np.testing.assert_allclose(got.log_prior.numpy(),
                               np.asarray(want.log_prior), rtol=0,
                               atol=NB_TOL)
    np.testing.assert_allclose(got.log_theta.numpy(),
                               np.asarray(want.log_theta), rtol=0,
                               atol=NB_TOL)
    xq, _ = _counts(seed=1, n=70)
    ws = np.asarray(ref_nb.multinomial_nb_scores(want, jnp.asarray(xq)))
    np.testing.assert_allclose(nb.multinomial_nb_scores(got, xq).numpy(),
                               ws, rtol=NB_TOL, atol=NB_TOL)
    np.testing.assert_array_equal(nb.multinomial_nb_predict(got, xq),
                                  ref_nb.multinomial_nb_predict(want, xq))
    # the converter carries the reference's model across
    carried = convert.multinomial_nb_from_numpy(
        np.asarray(want.log_prior), np.asarray(want.log_theta),
        device="cpu")
    np.testing.assert_array_equal(nb.multinomial_nb_predict(carried, xq),
                                  ref_nb.multinomial_nb_predict(want, xq))


def test_multinomial_nb_ties_take_the_lowest_label():
    # classes 1 and 3 learn identical rows: every score ties between them
    x = np.array([[1, 2], [3, 1], [1, 2], [3, 1], [0, 5]], np.float32)
    y = np.array([1, 0, 3, 2, 2])
    got = nb.multinomial_nb_train(x, y, 4, device="cpu")
    want = ref_nb.multinomial_nb_train(x, y, 4)
    q = np.array([[1, 2], [2, 4], [0, 0]], np.float32)
    np.testing.assert_array_equal(nb.multinomial_nb_predict(got, q),
                                  ref_nb.multinomial_nb_predict(want, q))


def test_categorical_nb_equals_reference():
    points = [("spam", ["free", "win", "now"]),
              ("spam", ["free", "cash", "now"]),
              ("spam", ["win", "cash", "prize"]),
              ("ham", ["meeting", "tomorrow", "now"]),
              ("ham", ["lunch", "tomorrow", "noon"])]
    got = e2.categorical_nb_train(points)
    want = ref_e2.categorical_nb_train(points)
    for name in ("log_prior", "log_likelihood", "log_floor"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name))
    carried = convert.categorical_nb_from_numpy(
        want.labels.to_dict(), [c.to_dict() for c in want.categories],
        want.log_prior, want.log_likelihood, want.log_floor)
    for feats in (["free", "win", "now"], ["meeting", "tomorrow", "noon"],
                  ["UNSEEN", "win", "now"]):
        for m in (got, carried):
            assert m.predict(feats) == want.predict(feats)
            for label in ("spam", "ham", "nolabel"):
                assert m.log_score(feats, label) == want.log_score(feats,
                                                                   label)
    with pytest.raises(ValueError):
        e2.categorical_nb_train([])


# -- random forest ----------------------------------------------------------

@pytest.mark.parametrize("num_trees, max_bins", [(8, 32), (6, 0)])
def test_forest_device_traversal_equals_reference(num_trees, max_bins):
    """Even tree counts make tied votes; both packages give the lowest
    class."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(600, 5)).astype(np.float32)
    y = (x[:, 0] + x[:, 3] > 0).astype(np.int64) + 2 * (x[:, 1] > 0.5)
    kw = dict(n_classes=4, num_trees=num_trees, max_depth=5,
              max_bins=max_bins, seed=3)
    got = forest.random_forest_train(x, y, **kw)
    want = ref_forest.random_forest_train(x, y, **kw)
    for name in ("feature", "threshold", "left", "right", "prediction"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    xq = rng.normal(size=(2_500, 5)).astype(np.float32)
    dev = got.predict_device(xq, device="cpu")
    assert dev.dtype == torch.int64 and dev.device.type == "cpu"
    np.testing.assert_array_equal(dev.numpy(),
                                  np.asarray(want.predict_device(xq)))
    np.testing.assert_array_equal(dev.numpy(), got.predict(xq))
    carried = convert.random_forest_from_numpy(
        want.feature, want.threshold, want.left, want.right,
        want.prediction, want.n_classes, want.max_depth)
    np.testing.assert_array_equal(
        carried.predict_device(xq, device="cpu").numpy(), dev.numpy())


def test_markov_top_n_equals_reference():
    rng = np.random.default_rng(4)
    t = rng.integers(0, 9, size=(400, 2))
    for top_n in (1, 3, 20):
        got = markov.markov_chain_train(t, 9, top_n)
        want = ref_markov.markov_chain_train(t, 9, top_n)
        np.testing.assert_array_equal(got.indices, want.indices)
        np.testing.assert_array_equal(got.probs, want.probs)
        for s in range(9):
            assert got.predict(s) == want.predict(s)
            assert got.transition_probs(s) == want.transition_probs(s)
    # tied probabilities keep the lower state first; unseen states stay -1
    got = e2.markov_chain_train([(0, 2), (0, 1), (1, 0)], 4, 3)
    want = ref_e2.markov_chain_train([(0, 2), (0, 1), (1, 0)], 4, 3)
    np.testing.assert_array_equal(got.indices, want.indices)
    assert got.predict(3) is None


def test_binary_vectorizer_equals_reference():
    maps = [{"a": "x", "b": "y"}, {"a": "z"}, {"b": "y", "c": "q"}]
    got = e2.BinaryVectorizer.fit(maps, ["a", "b"])
    want = ref_e2.BinaryVectorizer.fit(maps, ["a", "b"])
    assert got.index.to_dict() == want.index.to_dict()
    np.testing.assert_array_equal(got.transform_batch(maps),
                                  want.transform_batch(maps))


# -- the template -----------------------------------------------------------

def _env(path):
    return {
        "PIO_STORAGE_SOURCES_SQL_TYPE": "sqlite",
        "PIO_STORAGE_SOURCES_SQL_PATH": str(path / "pio.db"),
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "SQL",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "SQL",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "SQL",
    }


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """The reference's classification fixture (tests/test_templates.py):
    the plan follows gender + education, or age over 50."""
    env = _env(tmp_path_factory.mktemp("cls"))
    storage = Storage(env=env)
    app_id = storage.get_metadata_apps().insert(App(0, APP))
    ev = storage.get_events()
    ev.init(app_id)
    rng = np.random.default_rng(0)
    batch = []
    for i in range(120):
        gender = "m" if rng.random() < 0.5 else "f"
        edu = str(rng.choice(["hs", "college"]))
        age = float(rng.integers(20, 60))
        plan = ("premium" if (gender == "m" and edu == "college") or age > 50
                else "basic")
        batch.append(Event(
            event="$set", entity_type="user", entity_id=f"u{i}",
            properties={"gender": gender, "education": edu, "age": age,
                        "plan": plan},
            event_time=T0 + timedelta(minutes=i)))
    ev.insert_batch(batch, app_id)
    ref = RefStorage(env=env)
    yield storage, ref, env
    storage.close()
    ref.close()


QUERIES = [{"gender": "m", "education": "college", "age": 30.0},
           {"gender": "f", "education": "hs", "age": 25.0},
           {"gender": "f", "education": "college", "age": 58.0},
           {"gender": "x", "education": "hs", "age": 40.0}]


def _params(pkg, **ds):
    return dict(datasource=("", pkg.DataSourceParams(
        app_name=APP, attributes=ATTRS, **ds)),
        algorithms=[("naive", pkg.NaiveBayesParams(lambda_=1.0)),
                    ("randomforest", pkg.RandomForestParams(num_trees=8))])


def test_classification_template_as_reference(store):
    storage, ref, _ = store
    engine = cls.ClassificationEngine.apply()
    ep = EngineParams(**_params(cls))
    ctx = create_workflow_context(storage, device="cpu")
    nb_model, rf_model = engine.train(ctx, ep)
    ref_engine = ref_cls.ClassificationEngine.apply()
    ref_ep = RefEngineParams(**_params(ref_cls))
    ref_nb_model, ref_rf_model = ref_engine.train(
        ref_context(ref, use_mesh=False), ref_ep)
    # the same labelled vectors, hence the same forest and NB tables
    for name in ("feature", "threshold", "prediction"):
        np.testing.assert_array_equal(getattr(rf_model.forest, name),
                                      getattr(ref_rf_model.forest, name))
    np.testing.assert_allclose(nb_model.nb_model.log_theta.numpy(),
                               np.asarray(ref_nb_model.nb_model.log_theta),
                               rtol=0, atol=NB_TOL)
    schema = ref_nb_model.data_schema
    carried_schema = convert.classification_schema_from_numpy(
        schema.vectorizer.index.to_dict(), schema.numeric_fields,
        schema.labels.to_dict())
    carried_nb = cls.NBClassifierModel(convert.multinomial_nb_from_numpy(
        np.asarray(ref_nb_model.nb_model.log_prior),
        np.asarray(ref_nb_model.nb_model.log_theta), device="cpu"),
        carried_schema)
    f = ref_rf_model.forest
    carried_rf = cls.RFClassifierModel(convert.random_forest_from_numpy(
        f.feature, f.threshold, f.left, f.right, f.prediction, f.n_classes,
        f.max_depth), carried_schema)
    algos, ref_algos = engine._doers(ep)[2], ref_engine._doers(ref_ep)[2]
    for algo, model, carried, ref_algo, ref_model in (
            (algos[0], nb_model, carried_nb, ref_algos[0], ref_nb_model),
            (algos[1], rf_model, carried_rf, ref_algos[1], ref_rf_model)):
        for q in QUERIES:
            want = ref_algo.predict(ref_model, q)
            assert algo.predict(model, q) == want
            assert algo.predict(carried, q) == want
        assert algo.batch_predict(model, QUERIES) == [
            algo.predict(model, q) for q in QUERIES]
    # the reference's cases
    assert algos[0].predict(nb_model, QUERIES[0])["label"] == "premium"
    assert algos[1].predict(rf_model, QUERIES[1])["label"] == "basic"
    # 2,048 queries and more: the forest's device traversal
    algos[1].train(ctx, cls.ClassificationDataSource(
        ep.datasource[1]).read_training(ctx))
    many = [QUERIES[i % 4] | {"age": float(20 + i % 40)}
            for i in range(2_048)]
    assert algos[1].batch_predict(rf_model, many) == \
        ref_algos[1].batch_predict(ref_rf_model, many) == \
        [algos[1].predict(rf_model, q) for q in many]


def test_classification_eval_scores_as_reference(store):
    storage, ref, _ = store

    class Accuracy(AverageMetric):
        def calculate_one(self, q, p, a):
            return 1.0 if p["label"] == a else 0.0

    class RefAccuracy(RefAverageMetric):
        def calculate_one(self, q, p, a):
            return 1.0 if p["label"] == a else 0.0

    kw = dict(datasource=("", cls.DataSourceParams(
        app_name=APP, attributes=ATTRS, eval_k=3)),
        algorithms=[("naive", cls.NaiveBayesParams())])
    got = MetricEvaluator(Accuracy()).evaluate_base(
        create_workflow_context(storage, device="cpu"),
        cls.ClassificationEngine.apply(), [EngineParams(**kw)])
    want = RefMetricEvaluator(RefAccuracy()).evaluate_base(
        ref_context(ref, use_mesh=False), ref_cls.ClassificationEngine.apply(),
        [RefEngineParams(datasource=("", ref_cls.DataSourceParams(
            app_name=APP, attributes=ATTRS, eval_k=3)),
            algorithms=[("naive", ref_cls.NaiveBayesParams())])])
    assert got.best_score.score == want.best_score.score > 0.7


def test_classification_empty_app(tmp_path):
    storage = Storage(env=_env(tmp_path))
    app_id = storage.get_metadata_apps().insert(App(0, "empty"))
    storage.get_events().init(app_id)
    engine = cls.ClassificationEngine.apply()
    ep = EngineParams(datasource=("", cls.DataSourceParams(app_name="empty")),
                      algorithms=[("naive", None)])
    try:
        with pytest.raises(ValueError, match="empty"):
            engine.train(create_workflow_context(storage, device="cpu"), ep)
    finally:
        storage.close()


_CLASSES = '''
from pio_tpu_torch.controller import (
    AverageMetric, EngineParams, EngineParamsGenerator, Evaluation)
from pio_tpu_torch.models.classification import (
    ClassificationEngine, DataSourceParams, NaiveBayesParams)


class Accuracy(AverageMetric):
    def calculate_one(self, q, p, a):
        return 1.0 if p["label"] == a else 0.0


class ClsEval(Evaluation):
    engine = ClassificationEngine.apply()
    metric = Accuracy()


class Grid(EngineParamsGenerator):
    engine_params_list = [
        EngineParams(
            datasource=("", DataSourceParams(
                app_name="{app}", attributes={attrs}, eval_k=3)),
            algorithms=[("naive", NaiveBayesParams(lambda_=lam))])
        for lam in (1.0, 0.5)
    ]
'''


def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/queries.json",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.status, json.loads(r.read())


@pytest.mark.parametrize("algo", ["naive", "randomforest"])
def test_classification_verbs(store, tmp_path, monkeypatch, capsys, algo):
    """train → deploy over HTTP (bodies = in-process predict) → eval in
    class mode → batchpredict (lines = the deploy's answers)."""
    from pio_tpu_torch.__main__ import _engine_from_variant

    storage, _, _ = store
    d = tmp_path / "engine"
    d.mkdir()
    variant = {"id": f"cls-{algo}", "engineFactory": FACTORY,
               "datasource": {"params": {"app_name": APP,
                                         "attributes": list(ATTRS)}},
               "algorithms": [{"name": algo, "params": {}}]}
    (d / "engine.json").write_text(json.dumps(variant))
    monkeypatch.setattr("pio_tpu_torch.__main__.get_storage",
                        lambda: storage)
    assert port_main(["train", "--engine-dir", str(d), "--device",
                      "cpu"]) == 0
    engine, ep = _engine_from_variant(variant, str(d))
    http, qs = create_query_server(
        engine, ep, storage,
        ServingConfig(ip="127.0.0.1", port=0, engine_id=variant["id"]),
        ctx=create_workflow_context(storage, device="cpu"))
    http.start()
    try:
        answers = []
        for q in QUERIES:
            status, body = _post(http.port, q)
            assert status == 200
            assert body == qs.algorithms[0].predict(qs.models[0], q)
            answers.append(body)
    finally:
        http.stop()
        qs.close()
    inp, out = tmp_path / "q.jsonl", tmp_path / "p.jsonl"
    inp.write_text("".join(json.dumps(q) + "\n" for q in QUERIES))
    assert port_main(["batchpredict", "--engine-dir", str(d), "--input",
                      str(inp), "--output", str(out), "--device",
                      "cpu"]) == 0
    lines = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["prediction"] for r in lines] == answers
    if algo != "naive":
        return
    module = "torch_cls_eval_classes"
    (d / f"{module}.py").write_text(
        _CLASSES.format(app=APP, attrs=repr(ATTRS)))
    monkeypatch.syspath_prepend(str(d))
    capsys.readouterr()
    try:
        assert port_main(["eval", f"{module}.ClsEval", f"{module}.Grid",
                          "--engine-dir", str(d), "--device", "cpu",
                          "--output", str(tmp_path / "best.json")]) == 0
    finally:
        sys.modules.pop(module, None)
    iid = capsys.readouterr().out.split("Instance: ")[1].split()[0]
    inst = storage.get_metadata_evaluation_instances().get(iid)
    assert inst.status == "EVALCOMPLETED"
    res = json.loads(inst.evaluator_results_json)
    assert len(res["allScores"]) == 2 and res["bestScore"] > 0.7
