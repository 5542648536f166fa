"""The port's evaluation pillar against the JAX package, on the CPU.

- the metric contracts, ``MetricEvaluator`` (sequential and with
  ``workers=2``), ``FastEvalEngine``'s prefix caching and the
  EvaluationInstance lifecycle (``run_evaluation``, ``fake_run``), each
  beside the reference's on the same stub engine;
- the templates' evaluation folds: the recommendation template's
  index-mod-k ``read_eval`` (``e2/crossvalidation``) and the sequence
  template's rolling next-item folds, fold for fold against the
  reference's on one sqlite db;
- class mode: ``python -m pio_tpu_torch eval <Evaluation>
  <ParamsGenerator> --device cpu`` against the reference's
  ``run_evaluation_class`` on the same events and the same initial
  factors: the best candidate and every score within abs 0.02 (the
  reference's own stacked-vs-sequential tolerance, tests/test_tuning.py:
  the two packages' ALS factors differ by up to 2e-3 of the largest,
  which can move a near-tied item across the top-k cut).
"""

import _torch_cpu  # noqa: F401  (one CPU thread: see the module)
import json
import math
import sys
import types
from dataclasses import dataclass
from datetime import datetime, timedelta, timezone

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pio_tpu.controller as ref_c
from pio_tpu.data.bimap import EntityIdIndex as RefIndex
from pio_tpu.data.eventstore import Interactions as RefInteractions
from pio_tpu.data.storage import Storage as RefStorage
from pio_tpu.e2 import crossvalidation as ref_cv
from pio_tpu.e2 import metrics as ref_e2m
from pio_tpu.models import recommendation as ref_rec
from pio_tpu.models import sequence as ref_seq
from pio_tpu.ops import als as ref_als
from pio_tpu.tuning import metrics as ref_tm
from pio_tpu.workflow.context import (
    create_workflow_context as ref_context,
)
from pio_tpu.workflow.evaluate import (
    run_evaluation as ref_run_evaluation,
    run_evaluation_class as ref_run_class,
)
import pio_tpu_torch.controller as port_c
from pio_tpu_torch.__main__ import main as port_main
from pio_tpu_torch.data.bimap import EntityIdIndex
from pio_tpu_torch.data.dao import App
from pio_tpu_torch.data.event import Event
from pio_tpu_torch.data.eventstore import Interactions
from pio_tpu_torch.data.storage import Storage
from pio_tpu_torch.e2 import crossvalidation as port_cv
from pio_tpu_torch.e2 import metrics as port_e2m
from pio_tpu_torch.models import recommendation as port_rec
from pio_tpu_torch.models import sequence as port_seq
from pio_tpu_torch.ops import als as port_als
from pio_tpu_torch.workflow.context import create_workflow_context
from pio_tpu_torch.workflow.evaluate import run_evaluation
from pio_tpu_torch.workflow.fake import fake_run

T0 = datetime(2026, 1, 1, tzinfo=timezone.utc)
APP = "evalapp"
SCORE_ABS = 0.02
PKGS = {"port": port_c, "ref": ref_c}


def _storage_env(path):
    return {
        "PIO_STORAGE_SOURCES_SQL_TYPE": "sqlite",
        "PIO_STORAGE_SOURCES_SQL_PATH": str(path / "pio.db"),
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "SQL",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "SQL",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "SQL",
    }


@pytest.fixture()
def store(tmp_path):
    """One sqlite db, open in both packages: seeded rate/buy events of
    40 users x 30 items (app ``evalapp``) and view/buy histories of 12
    users (app ``seqapp``), each event at its own minute."""
    env = _storage_env(tmp_path)
    storage = Storage(env=env)
    rng = np.random.default_rng(5)
    for app, kinds, n_events, n_users in ((APP, ("rate", "buy"), 900, 40),
                                          ("seqapp", ("view", "buy"), 150,
                                           12)):
        app_id = storage.get_metadata_apps().insert(App(0, app))
        ev = storage.get_events()
        ev.init(app_id)
        ev.insert_batch([
            Event(event=kinds[int(rng.integers(0, 2))], entity_type="user",
                  entity_id=f"u{rng.integers(0, n_users)}",
                  target_entity_type="item",
                  target_entity_id=f"i{rng.integers(0, 30)}",
                  properties={"rating": float(rng.integers(1, 6))},
                  event_time=T0 + timedelta(minutes=j))
            for j in range(n_events)], app_id)
    ref = RefStorage(env=env)
    yield storage, ref, env
    storage.close()
    ref.close()


# ---------------------------------------------------------------------------
# the metric contracts and the evaluator, beside the reference's
# ---------------------------------------------------------------------------

DATA = [
    (None, [({}, 1.0, 2.0), ({}, 3.0, 3.0)]),
    (None, [({}, 5.0, 1.0), ({}, 2.0, None)]),
]


def _metric(pkg, kind):
    """A QPA metric of each helper shape, built from ``pkg``'s bases."""
    if kind == "average":
        class M(pkg.AverageMetric):
            def calculate_one(self, q, p, a):
                return abs(p - (a or 0.0))
    elif kind == "option_average":
        class M(pkg.OptionAverageMetric):
            def calculate_one(self, q, p, a):
                return None if a is None else abs(p - a)
    elif kind == "stdev":
        class M(pkg.StdevMetric):
            def calculate_one(self, q, p, a):
                return p
    elif kind == "option_stdev":
        class M(pkg.OptionStdevMetric):
            def calculate_one(self, q, p, a):
                return None if a is None else p
    elif kind == "sum":
        class M(pkg.SumMetric):
            def calculate_one(self, q, p, a):
                return p
    elif kind == "mse":
        return pkg.MeanSquareError()
    else:
        return pkg.ZeroMetric()
    return M()


@pytest.mark.parametrize("kind", ["average", "option_average", "stdev",
                                  "option_stdev", "sum", "zero"])
def test_metric_helpers_equal_reference(kind):
    got = _metric(port_c, kind).calculate(None, DATA)
    want = _metric(ref_c, kind).calculate(None, DATA)
    assert got == want
    empty = [(None, [({}, 1.0, None)])]
    if kind.startswith("option"):
        assert math.isnan(_metric(port_c, kind).calculate(None, empty))


def test_plain_average_raises_on_none_and_mse():
    with pytest.raises(ValueError, match="returned None"):
        _metric(port_c, "average").__class__.__mro__[1].calculate(
            type("Sloppy", (port_c.AverageMetric,),
                 {"calculate_one": lambda self, q, p, a: None})(),
            None, DATA)
    mse = [(None, [({}, 1.0, 2.0), ({}, 3.0, 5.0)])]
    assert port_c.MeanSquareError().calculate(None, mse) == \
        ref_c.MeanSquareError().calculate(None, mse) == 2.5
    assert not port_c.MeanSquareError().higher_is_better


@pytest.mark.parametrize("k", [1, 2, 3])
def test_e2_precision_recall_equal_reference(k):
    data = [(None, [
        ({}, {"itemScores": [{"item": "a", "score": 1},
                             {"item": "b", "score": 0.5}]}, ["a", "c"]),
        ({}, {"itemScores": []}, ["a"]),
        ({}, {"itemScores": [{"item": "z", "score": 1}]}, []),
    ])]
    for port_m, ref_m in ((port_e2m.PrecisionAtK, ref_e2m.PrecisionAtK),
                          (port_e2m.RecallAtK, ref_e2m.RecallAtK)):
        assert port_m(k).calculate(None, data) == \
            ref_m(k).calculate(None, data)
        assert port_m(k).header == ref_m(k).header


def _stub_engine(pkg, fast=False):
    """The reference tests' stub engine (tests/test_evaluation.py) built
    from ``pkg``'s classes, with per-stage run counters."""
    counts = {"read": 0, "prepare": 0, "train": 0}

    @dataclass(frozen=True)
    class DSP(pkg.Params):
        n: int = 4

    class DS(pkg.DataSource):
        params_class = DSP

        def __init__(self, params=DSP()):
            self.params = params

        def read_training(self, ctx):
            return list(range(self.params.n))

        def read_eval(self, ctx):
            counts["read"] += 1
            return [(list(range(self.params.n)), {"fold": f},
                     [({"q": i}, float(i)) for i in range(4)])
                    for f in range(2)]

    class Prep(pkg.IdentityPreparator):
        def prepare(self, ctx, td):
            counts["prepare"] += 1
            return td

    @dataclass(frozen=True)
    class AP(pkg.Params):
        w: float = 1.0

    class Algo(pkg.LAlgorithm):
        params_class = AP

        def __init__(self, params=AP()):
            self.params = params

        def train(self, ctx, pd):
            counts["train"] += 1
            return {"w": self.params.w}

        def predict(self, model, query):
            return model["w"] * query["q"]

    class Err(pkg.AverageMetric):
        higher_is_better = False

        def calculate_one(self, q, p, a):
            return abs(p - a)

    cls = pkg.FastEvalEngine if fast else pkg.Engine
    engine = cls(DS, Prep, {"algo": Algo}, pkg.FirstServing)

    def grid(ws):
        return [pkg.EngineParams(datasource=("", DSP()),
                                 algorithms=[("algo", AP(w))]) for w in ws]
    return types.SimpleNamespace(engine=engine, grid=grid, err=Err,
                                 counts=counts, DSP=DSP, AP=AP)


def _scores(result):
    return [(ms.score, ms.other_scores)
            for _, ms in result.engine_params_scores]


@pytest.mark.parametrize("workers", [1, 2])
@pytest.mark.parametrize("fast", [False, True])
def test_metric_evaluator_equals_reference(workers, fast):
    """The best candidate, every score and the stage run counts (prefix
    caching) equal the reference's, sequential and on two workers."""
    out = {}
    for name, pkg in PKGS.items():
        s = _stub_engine(pkg, fast=fast)
        result = pkg.MetricEvaluator(
            s.err(), other_metrics=[pkg.ZeroMetric()],
            workers=workers).evaluate_base(None, s.engine,
                                           s.grid([0.5, 1.0, 2.0, 4.0]))
        out[name] = (result.best_idx, _scores(result),
                     result.metric_header, result.other_metric_headers,
                     s.counts)
        assert result.best_engine_params.algorithms[0][1].w == 1.0
    assert out["port"] == out["ref"]


def test_fasteval_counts_equal_reference():
    out = {}
    for name, pkg in PKGS.items():
        s = _stub_engine(pkg, fast=True)
        ep = s.grid([1.0])[0]
        r1 = s.engine.eval(None, ep)
        r2 = s.engine.eval(None, ep)
        assert [q for _, q in r1] == [q for _, q in r2]
        s.engine.eval(None, pkg.EngineParams(
            datasource=("", s.DSP(n=5)), algorithms=[("algo", s.AP())]))
        out[name] = (dict(s.engine.cache_hits), dict(s.engine.cache_misses),
                     s.counts)
    assert out["port"] == out["ref"]


def test_nan_never_best_and_best_json(tmp_path):
    s = _stub_engine(port_c)
    out = tmp_path / "best.json"

    class NanErr(port_c.OptionAverageMetric):
        higher_is_better = False

        def calculate_one(self, q, p, a):
            # every triple of w=4 is None: its score is NaN
            return None if p >= 2 * a else abs(p - a)

    r = port_c.MetricEvaluator(NanErr(), output_path=str(out)) \
        .evaluate_base(None, s.engine, s.grid([4.0, 1.0]))
    assert math.isnan(r.engine_params_scores[0][1].score)
    assert r.best_engine_params.algorithms[0][1].w == 1.0
    assert json.loads(out.read_text())["algorithmParamsList"][0][
        "params"]["w"] == 1.0
    with pytest.raises(ValueError, match="must not be empty"):
        port_c.MetricEvaluator(NanErr()).evaluate_base(None, s.engine, [])


def test_run_evaluation_lifecycle_equals_reference(store, tmp_path):
    """The EvaluationInstance goes INIT -> EVALCOMPLETED with the same
    rendered results as the reference's (ids aside); a failing metric
    marks it EVALFAILED; ``fake_run`` rides the same path."""
    storage, ref, _ = store
    out = {}
    for name, pkg, run, st in (("port", port_c, run_evaluation, storage),
                               ("ref", ref_c, ref_run_evaluation, ref)):
        s = _stub_engine(pkg, fast=True)
        iid, result = run(
            engine=s.engine, metric=s.err(),
            engine_params_list=s.grid([0.5, 1.0]), storage=st,
            other_metrics=[pkg.ZeroMetric()], evaluation_class="TestEval",
            output_path=str(tmp_path / f"{name}.json"),
            ctx=(create_workflow_context(storage, device="cpu")
                 if name == "port" else ref_context(ref, use_mesh=False)))
        inst = st.get_metadata_evaluation_instances().get(iid)
        assert inst.status == "EVALCOMPLETED"
        out[name] = (inst.evaluator_results, inst.evaluator_results_json,
                     inst.evaluator_results_html, inst.evaluation_class)
    assert out["port"] == out["ref"]

    s = _stub_engine(port_c)

    class Boom(port_c.AverageMetric):
        def calculate_one(self, q, p, a):
            raise RuntimeError("boom")

    with pytest.raises(RuntimeError):
        run_evaluation(engine=s.engine, metric=Boom(),
                       engine_params_list=s.grid([1.0]), storage=storage,
                       ctx=create_workflow_context(storage, device="cpu"))
    dao = storage.get_metadata_evaluation_instances()
    assert any(i.status == "EVALFAILED" for i in dao.get_all())

    seen = []
    iid = fake_run(lambda ctx: seen.append(ctx.device.type), storage,
                   ctx=create_workflow_context(storage, device="cpu"))
    assert seen == ["cpu"]
    assert dao.get(iid).status == "EVALCOMPLETED"
    assert dao.get(iid).evaluation_class == "FakeRun"


# ---------------------------------------------------------------------------
# the templates' evaluation folds
# ---------------------------------------------------------------------------

def _assert_interactions_equal(got, want):
    for f in ("user_idx", "item_idx", "values"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got.users.ids() == want.users.ids()
    assert got.items.ids() == want.items.ids()


@pytest.mark.parametrize("k, exclude_seen", [(1, True), (2, True),
                                             (3, True), (3, False)])
def test_split_interactions_equals_reference(k, exclude_seen):
    rng = np.random.default_rng(k)
    u = rng.integers(0, 25, 400).astype(np.int32)
    i = rng.integers(0, 20, 400).astype(np.int32)
    v = rng.uniform(1, 5, 400).astype(np.float32)
    names = ([f"u{x}" for x in range(25)], [f"i{x}" for x in range(20)])
    got = port_cv.split_interactions(
        Interactions(u, i, v, EntityIdIndex(names[0]),
                     EntityIdIndex(names[1])), k, num=7,
        exclude_seen=exclude_seen)
    want = ref_cv.split_interactions(
        RefInteractions(u, i, v, RefIndex(names[0]), RefIndex(names[1])),
        k, num=7, exclude_seen=exclude_seen)
    assert len(got) == len(want) == (k if k > 1 else 0)
    for (gt, gi, gq), (wt, wi, wq) in zip(got, want):
        _assert_interactions_equal(gt, wt)
        assert (gi.fold, gi.k) == (wi.fold, wi.k)
        assert gq == wq
    assert [(tr, (f.fold, f.k), te)
            for tr, f, te in port_cv.split_data(list("abcdefg"), 3)] == [
        (tr, (f.fold, f.k), te)
        for tr, f, te in ref_cv.split_data(list("abcdefg"), 3)]


@pytest.mark.parametrize("eval_k, exclude_seen", [(0, True), (2, True),
                                                  (3, False)])
def test_recommendation_read_eval_equals_reference(store, eval_k,
                                                   exclude_seen):
    storage, ref, _ = store
    kw = dict(app_name=APP, eval_k=eval_k, eval_num=6,
              eval_exclude_seen=exclude_seen)
    got = port_rec.RecommendationDataSource(
        port_rec.DataSourceParams(**kw)).read_eval(
            create_workflow_context(storage, device="cpu"))
    want = ref_rec.RecommendationDataSource(
        ref_rec.DataSourceParams(**kw)).read_eval(
            ref_context(ref, use_mesh=False))
    assert len(got) == len(want) == (eval_k if eval_k > 1 else 0)
    for (gt, gi, gq), (wt, wi, wq) in zip(got, want):
        _assert_interactions_equal(gt, wt)
        assert (gi.fold, gi.k) == (wi.fold, wi.k)
        assert gq == wq


@pytest.mark.parametrize("eval_k, max_len", [(1, 8), (3, 8), (2, 3)])
def test_sequence_read_eval_equals_reference(store, eval_k, max_len):
    storage, ref, _ = store
    kw = dict(app_name="seqapp", eval_k=eval_k, max_len=max_len,
              eval_num=5)
    got = port_seq.SequenceDataSource(
        port_seq.SequenceDataSourceParams(**kw)).read_eval(
            create_workflow_context(storage, device="cpu"))
    want = ref_seq.SequenceDataSource(
        ref_seq.SequenceDataSourceParams(**kw)).read_eval(
            ref_context(ref, use_mesh=False))
    assert len(got) == len(want) > 0
    for (gt, gi, gq), (wt, wi, wq) in zip(got, want):
        assert gi == wi
        assert gq == wq
        assert gt.seqs.dtype == wt.seqs.dtype
        np.testing.assert_array_equal(gt.seqs, wt.seqs)
        assert gt.users.ids() == wt.users.ids()
        assert gt.items.ids() == wt.items.ids()


# ---------------------------------------------------------------------------
# class mode through the command line
# ---------------------------------------------------------------------------

_CLASSES = '''
from {pkg}.controller import EngineParams, EngineParamsGenerator, Evaluation
from {pkg}.models.recommendation import (
    ALSAlgorithmParams, DataSourceParams, RecommendationEngine)
from {pkg}.tuning.metrics import MAPAtK, NDCGAtK, PrecisionAtK


class RecEval(Evaluation):
    engine = RecommendationEngine.apply()
    metric = PrecisionAtK(5)
    metrics = [MAPAtK(5), NDCGAtK(5)]


class Grid(EngineParamsGenerator):
    engine_params_list = [
        EngineParams(
            datasource=("", DataSourceParams(app_name="{app}", eval_k=3)),
            algorithms=[("als", ALSAlgorithmParams(
                rank=8, num_iterations=3, lambda_=reg, chunk=256,
                implicit_prefs=implicit, alpha=4.0))])
        for reg, implicit in ((0.01, False), (100.0, False), (0.1, True))
    ]
'''


def _write_classes(path, pkg, module):
    path.mkdir(exist_ok=True)
    (path / f"{module}.py").write_text(_CLASSES.format(pkg=pkg, app=APP))


@pytest.mark.parametrize("workers", [1, 2])
def test_class_mode_cli_equals_reference(store, tmp_path, monkeypatch,
                                         capsys, workers):
    """``eval <Evaluation> <ParamsGenerator> --device cpu`` against the
    reference's ``run_evaluation_class`` from the same initial factors:
    the same best candidate, scores within abs 0.02, the best params
    written to --output and the instance EVALCOMPLETED."""
    storage, ref, _ = store

    def init_or(init, n_users, n_items, params):
        if init is not None:
            return init.user_factors, init.item_factors
        u0, i0 = port_als._init_or(None, n_users, n_items, params,
                                   torch.device("cpu"))
        return jnp.asarray(u0.numpy()), jnp.asarray(i0.numpy())

    monkeypatch.setattr(ref_als, "_init_or", init_or)
    module = f"torch_eval_classes_{workers}"
    ref_module = f"ref_eval_classes_{workers}"
    d = tmp_path / "engine"
    _write_classes(d, "pio_tpu_torch", module)
    _write_classes(d, "pio_tpu", ref_module)
    monkeypatch.setattr("pio_tpu_torch.__main__.get_storage",
                        lambda: storage)
    monkeypatch.syspath_prepend(str(d))
    best = tmp_path / "best.json"
    try:
        assert port_main([
            "eval", f"{module}.RecEval", f"{module}.Grid", "--engine-dir",
            str(d), "--device", "cpu", "--output", str(best),
            "--workers", str(workers)]) == 0
        printed = capsys.readouterr().out
        iid = printed.split("Instance: ")[1].split()[0]
        import importlib

        ref_classes = importlib.import_module(ref_module)
        _, want = ref_run_class(
            ref_classes.RecEval, ref_classes.Grid, ref,
            ctx=ref_context(ref, use_mesh=False), workers=workers)
    finally:
        for m in (module, ref_module):
            sys.modules.pop(m, None)
    inst = storage.get_metadata_evaluation_instances().get(iid)
    assert inst.status == "EVALCOMPLETED"
    assert inst.evaluation_class == "RecEval"
    assert inst.engine_params_generator_class == "Grid"
    got = json.loads(inst.evaluator_results_json)
    assert got["bestIndex"] == want.best_idx
    assert got["metricHeader"] == want.metric_header == "Precision@5"
    assert got["otherMetricHeaders"] == ["MAP@5", "NDCG@5"]
    for g, (_, w) in zip(got["allScores"], want.engine_params_scores):
        assert g["score"] == pytest.approx(w.score, abs=SCORE_ABS)
        assert g["otherScores"] == pytest.approx(w.other_scores,
                                                 abs=SCORE_ABS)
    assert json.loads(best.read_text())["algorithmParamsList"][0][
        "params"]["lambda_"] == [0.01, 100.0, 0.1][want.best_idx]


def test_class_mode_needs_both_classes_and_cuda(store, tmp_path,
                                                monkeypatch, capsys):
    storage, _, _ = store
    monkeypatch.setattr("pio_tpu_torch.__main__.get_storage",
                        lambda: storage)
    assert port_main(["eval", "only.One"]) == 1
    assert "either --sweep" in capsys.readouterr().err
    module = "torch_eval_classes_nocuda"
    d = tmp_path / "engine"
    _write_classes(d, "pio_tpu_torch", module)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    try:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port_main(["eval", f"{module}.RecEval", f"{module}.Grid",
                       "--engine-dir", str(d)])
    finally:
        sys.modules.pop(module, None)
