"""The examples' user-code engines on the PyTorch port against the JAX
package's, on the CPU.

Each ``examples/<name>/port/`` counterpart (its ``engine.py`` or
``eval_def.py`` imports ``pio_tpu_torch`` only) goes through the port's
verbs with ``--device cpu``: ``train`` in process, then the trained
instance served as ``deploy`` serves it (``deploy`` as a process for
custom-datasource), each HTTP body held to the serving composition's
answer in process; the two evaluations through ``eval --output``. The
reference's example (``examples/<name>``, through the JAX package) reads
the same sqlite store and trains in process; its serving's answer to
every query is the one the port's body is held to. The assertions
``tests/test_examples.py`` makes of the reference's examples are made
too, on stores seeded as that file seeds them, but for two: multi-algo's
and the evaluation's stores add events across the parity blocks, without
which their models are not determined by the data (see their tests).
An example that needs a file of its own (custom-serving,
custom-preparator) runs from a copy of its ``port/`` directory whose
engine.json names a file under the test's temporary directory, and the
reference reads the same file.

Both packages' ALS trainings start from one initial factor draw: the
port's seeded init is handed to the reference's trainer, as
``test_torch_evaluation.py`` does. Tolerances: the two packages' trained
factors differ by up to 2e-3 of the largest (``test_torch_als_train.py``),
so scores agree within SCORE_RTOL of the answer's largest score (measured
here: at most 2.0e-3), and ids must be equal wherever the reference's
neighbouring scores are further apart than that; an evaluation's scores
within abs 0.02 (measured here: at most 0.012) and the same best
candidate (``test_torch_evaluation.py``'s class-mode tolerance: a
near-tied item may cross a top-k cut).

twotower-weighted cannot be compared end to end: the reference's initial
weights are flax's draws, which torch cannot make. Its user DataSource's
weighted read is held to the reference's row for row, and its Serving to
the reference's on the same predictions.
"""

import _torch_cpu  # noqa: F401  (one CPU thread: see the module)
import contextlib
import gzip
import json
import os
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_verbs import (
    EXAMPLES,
    REPO,
    deployed,
    post,
    served_as_in_process,
    sqlite_env,
)
from pio_tpu.data.storage import Storage as RefStorage
from pio_tpu.ops import als as ref_als
from pio_tpu.tools.cli import _engine_from_variant as ref_engine_from_variant
from pio_tpu.tools.cli import _load_factory as ref_load_factory
from pio_tpu.workflow.context import create_workflow_context as ref_context
from pio_tpu.workflow.evaluate import run_evaluation_class as ref_run_class
from pio_tpu_torch.__main__ import main as port_main
from pio_tpu_torch.data.dao import App
from pio_tpu_torch.data.datamap import DataMap
from pio_tpu_torch.data.event import Event
from pio_tpu_torch.data.storage import Storage
from pio_tpu_torch.ops import als as port_als

QUICKSTART_EVENTS = 5_000   # the committed dataset's first events
SCORE_RTOL = 1e-2
SCORE_ABS = 0.02
CPU = torch.device("cpu")


@pytest.fixture
def store(tmp_path, monkeypatch):
    """A sqlite store the verbs use; every example's module is called
    ``engine``, so a test starts with none loaded and leaves ``sys.path``
    as it found it (the verbs put the engine dir on it)."""
    sys.modules.pop("engine", None)
    monkeypatch.setattr(sys, "path", list(sys.path))
    monkeypatch.setenv("PIO_TPU_CKPT_ROOT", str(tmp_path / "ckpt"))
    storage = Storage(env=sqlite_env(tmp_path / "pio.db"))
    monkeypatch.setattr("pio_tpu_torch.__main__.get_storage",
                        lambda: storage)
    yield storage
    storage.close()
    sys.modules.pop("engine", None)


@pytest.fixture
def ref_store(store, tmp_path, monkeypatch):
    """The reference's view of ``store``'s sqlite file, its ALS trainer
    drawing the port's seeded init."""
    def init_or(init, n_users, n_items, params):
        if init is not None:
            return init.user_factors, init.item_factors
        u0, i0 = port_als._init_or(None, n_users, n_items, params, CPU)
        return jnp.asarray(u0.numpy()), jnp.asarray(i0.numpy())

    monkeypatch.setattr(ref_als, "_init_or", init_or)
    storage = RefStorage(env=sqlite_env(tmp_path / "pio.db"))
    yield storage
    storage.close()


@contextlib.contextmanager
def _reference_module():
    """The reference's example module is called ``engine`` too: none is
    loaded while the block runs, and after it neither the module nor the
    reference's directory is left for the port's verbs to find."""
    path = list(sys.path)
    sys.modules.pop("engine", None)
    try:
        yield
    finally:
        sys.path[:] = path
        sys.modules.pop("engine", None)


class _Reference:
    """The reference's examples/<name> (engine.json ``section`` params
    updated) trained in process on ``storage``: ``answer(q)`` is its
    serving's answer over every algorithm's predict."""

    def __init__(self, storage, name: str, section: str = "", **params):
        d = os.path.join(EXAMPLES, name)
        with open(os.path.join(d, "engine.json")) as f:
            variant = json.load(f)
        if section:
            variant[section]["params"].update(params)
        with _reference_module():
            self.engine, self.ep = ref_engine_from_variant(variant, d)
            self.ctx = ref_context(storage, use_mesh=False)
            self.models = self.engine.train(self.ctx, self.ep)
        (self.datasource, self.preparator, self.algorithms,
         self.serving) = self.engine._doers(self.ep)

    def answer(self, q) -> dict:
        return self.serving.serve(q, [a.predict(m, q) for a, m in
                                      zip(self.algorithms, self.models)])


def _same_answer(got: dict, want: dict, what=""):
    """Scores within SCORE_RTOL of the largest; equal ids wherever the
    reference's neighbouring scores are further apart than that."""
    g, w = got["itemScores"], want["itemScores"]
    assert len(g) == len(w) > 0, (what, got, want)
    ws = np.array([float(x["score"]) for x in w])
    tol = SCORE_RTOL * max(np.abs(ws).max(), 1e-30)
    np.testing.assert_allclose([x["score"] for x in g], ws, rtol=0,
                               atol=tol, err_msg=str((what, got, want)))
    for j in range(len(w)):
        left = j == 0 or abs(ws[j] - ws[j - 1]) > tol
        right = j == len(w) - 1 or abs(ws[j + 1] - ws[j]) > tol
        if left and right:
            assert g[j]["item"] == w[j]["item"], (what, got, want)


def _port_dir(name: str) -> str:
    return os.path.join(EXAMPLES, name, "port")


def _copied(name: str, dest, section: str, **params) -> str:
    """The counterpart's directory copied to ``dest`` with its engine.json
    ``section`` params updated."""
    shutil.copytree(_port_dir(name), dest)
    path = os.path.join(dest, "engine.json")
    with open(path) as f:
        variant = json.load(f)
    variant[section]["params"].update(params)
    with open(path, "w") as f:
        json.dump(variant, f)
    return str(dest)


def _app(storage, name: str) -> int:
    app_id = storage.get_metadata_apps().insert(App(0, name))
    storage.get_events().init(app_id)
    return app_id


def _seed_ratings(storage, app_name, n_users=30, n_items=12):
    """tests/test_examples.py's ratings: users rate the items of their
    own parity 5."""
    app_id = _app(storage, app_name)
    storage.get_events().insert_batch([
        Event("rate", "user", f"u{u}", "item", f"i{i}",
              DataMap({"rating": 5}))
        for u in range(n_users) for i in range(n_items)
        if (u + i) % 2 == 0], app_id)
    return app_id


def _train(engine_dir) -> None:
    assert port_main(["train", "--engine-dir", str(engine_dir),
                      "--device", "cpu"]) == 0


def _items(body) -> list:
    return [s["item"] for s in body["itemScores"]]


def test_custom_serving_live_disable(store, ref_store, tmp_path):
    """The Serving stage reads the disabled list at every query: disabling
    the current top item removes it without a retrain or redeploy. Both
    answers are the reference's."""
    _seed_ratings(store, "CustomServingApp")
    disabled = tmp_path / "disabled.txt"
    ref = _Reference(ref_store, "custom-serving", "serving",
                     disabled_items_file=str(disabled))
    d = _copied("custom-serving", tmp_path / "engine", "serving",
                disabled_items_file=str(disabled))
    _train(d)
    q = {"user": "u0", "num": 3}
    with deployed(d, store, "custom-serving") as (port, qs):
        [r] = served_as_in_process(port, qs, [q])
        _same_answer(r, ref.answer(q), q)
        top = r["itemScores"][0]["item"]
        disabled.write_text(top + "\n")
        [r2] = served_as_in_process(port, qs, [q])
        _same_answer(r2, ref.answer(q), (q, top))
    assert r2["itemScores"] and top not in _items(r2), (top, r2)


def test_custom_preparator_excludes_items_from_model(store, ref_store,
                                                     tmp_path):
    _seed_ratings(store, "CustomPreparatorApp")
    excluded = tmp_path / "excluded.txt"
    excluded.write_text("i0\ni2\n")
    ref = _Reference(ref_store, "custom-preparator", "preparator",
                     exclude_items_file=str(excluded))
    d = _copied("custom-preparator", tmp_path / "engine", "preparator",
                exclude_items_file=str(excluded))
    _train(d)
    queries = [{"user": f"u{u}", "num": 6} for u in (0, 1, 7)]
    with deployed(d, store, "custom-preparator") as (port, qs):
        # u0 likes even items; i0/i2 are its strongest but are excluded
        # from the model itself, so they can never be served
        bodies = served_as_in_process(port, qs, queries)
        model = qs.models[0]
    for q, r in zip(queries, bodies):
        _same_answer(r, ref.answer(q), q)
    r = bodies[0]
    assert "i0" not in _items(r) and "i2" not in _items(r)
    # the same reindexed item table, and the same users
    assert model.items.ids() == ref.models[0].items.ids()
    assert model.users.ids() == ref.models[0].users.ids()
    assert "i0" not in model.items.ids() and len(model.items.ids()) == 10


def test_filter_by_category(store, ref_store):
    app_id = _seed_ratings(store, "FilterByCategoryApp")
    store.get_events().insert_batch([
        Event("$set", "item", f"i{i}", properties=DataMap(
            {"categories": ["electronics" if i < 6 else "books"]}))
        for i in range(12)], app_id)
    ref = _Reference(ref_store, "filter-by-category")
    d = _port_dir("filter-by-category")
    _train(d)
    queries = [{"user": "u1", "num": 4, "categories": ["books"]},
               {"user": "u1", "num": 4},
               {"user": "u4", "num": 3, "categories": ["electronics"]}]
    with deployed(d, store, "filter-by-category") as (port, qs):
        bodies = served_as_in_process(port, qs, queries)
        model = qs.models[0]
    for q, r in zip(queries, bodies):
        _same_answer(r, ref.answer(q), q)
    assert all(int(i[1:]) >= 6 for i in _items(bodies[0])), bodies[0]
    # the pickled wrapper's factors were put back on the serving device
    assert model.base.factors.item_factors.device.type == "cpu"
    assert model.item_categories == ref.models[0].item_categories
    assert model.item_categories["i7"] == ["books"]


def test_multi_algo_combines_two_algorithms(store, ref_store):
    app_id = _app(store, "MultiAlgoApp")
    # tests/test_examples.py's views of the parity blocks, and views
    # across them wherever (7u + i) % 5 is 0: on the blocks alone the
    # implicit objective has rank 2, the rest of ALS's 8 factors is left
    # to rounding, and the two packages' factors from one init part far
    # beyond SCORE_RTOL
    evs = [Event("view", "user", f"u{u}", "item", f"i{i}")
           for u in range(24) for i in range(10)
           if (u + i) % 2 == 0 or (7 * u + i) % 5 == 0]
    # likes follow the same parity blocks; u0 dislikes i8
    evs += [Event("like", "user", f"u{u}", "item", f"i{i}")
            for u in range(24) for i in range(10)
            if (u + i) % 2 == 0 and i % 4 == 0]
    evs.append(Event("dislike", "user", "u0", "item", "i8"))
    store.get_events().insert_batch(evs, app_id)
    ref = _Reference(ref_store, "multi-algo")
    d = _port_dir("multi-algo")
    _train(d)
    queries = [{"items": ["i0"], "num": 5}, {"items": ["i4", "i1"],
                                              "num": 4}]
    with deployed(d, store, "multi-algo") as (port, qs):
        bodies = served_as_in_process(port, qs, queries)
        per_algo = [[a.predict(m, q) for a, m in zip(qs.algorithms,
                                                     qs.models)]
                    for q in queries]
        names = [type(a).__name__ for a in qs.algorithms]
        port_serving = qs.serving
    assert names == ["ALSSimilarityAlgorithm", "LikeAlgorithm"]
    for q, r, preds in zip(queries, bodies, per_algo):
        # each algorithm's list against the reference's; the z-score merge
        # of the reference's lists against the reference's merge (merged
        # bodies differ more: a list of near-equal cosines standardizes by
        # a small deviation, which magnifies the lists' differences)
        want = [a.predict(m, q) for a, m in zip(ref.algorithms,
                                                ref.models)]
        for p, w, a in zip(preds, want, ref.algorithms):
            _same_answer(p, w, (q, type(a).__name__))
        merged, ref_merged = port_serving.serve(q, want), \
            ref.serving.serve(q, want)
        assert _items(merged) == _items(ref_merged), (q, merged)
        np.testing.assert_allclose(
            [s["score"] for s in merged["itemScores"]],
            [s["score"] for s in ref_merged["itemScores"]], rtol=1e-12)
        assert set(_items(r)) <= {i for p in preds for i in _items(p)}
    assert all(p["itemScores"] for preds in per_algo for p in preds)
    assert "i0" not in _items(bodies[0]), "query item must be excluded"


def _seed_eval_ratings(storage, app_name, n_users=30, n_items=12, seed=0):
    """Seeded ratings of _seed_ratings' parity blocks: a user rates 60 %
    of its own parity's items 4 or 5 and 25 % of the others 1 or 2. On
    the blocks alone every user holds out the same items in a fold (index
    mod k of the read order), which no fold's model has seen, and explicit
    ALS on ratings that are all 5 cannot rank one parity above the other:
    every candidate would score near 0, or all alike."""
    rng = np.random.default_rng(seed)
    rows = []
    for u in range(n_users):
        for i in range(n_items):
            same = (u + i) % 2 == 0
            if rng.random() < (0.6 if same else 0.25):
                rows.append((u, i, int(rng.integers(4, 6) if same
                                       else rng.integers(1, 3))))
    app_id = _app(storage, app_name)
    storage.get_events().insert_batch([
        Event("rate", "user", f"u{u}", "item", f"i{i}",
              DataMap({"rating": r})) for u, i, r in rows], app_id)
    return app_id


def _eval_scores(storage, capsys) -> dict:
    iid = capsys.readouterr().out.split("Instance: ")[1].split()[0]
    inst = storage.get_metadata_evaluation_instances().get(iid)
    assert inst.status == "EVALCOMPLETED"
    return json.loads(inst.evaluator_results_json)


def _same_scores(got: dict, want) -> None:
    """The port's evaluator results against the reference's: the same
    best candidate, every score within SCORE_ABS, scores that are not all
    zero and rank the candidates apart."""
    assert got["bestIndex"] == want.best_idx
    assert got["metricHeader"] == want.metric_header
    for g, (_, w) in zip(got["allScores"], want.engine_params_scores,
                         strict=True):
        assert g["score"] == pytest.approx(w.score, abs=SCORE_ABS)
        assert g["otherScores"] == pytest.approx(w.other_scores,
                                                 abs=SCORE_ABS)
    scores = [g["score"] for g in got["allScores"]]
    assert scores[got["bestIndex"]] == max(scores) > 0, scores
    assert len(set(scores)) > 1, scores


def test_evaluation_example_tunes_params(store, ref_store, tmp_path,
                                         capsys):
    """examples/evaluation/port: the user-code Evaluation and
    EngineParamsGenerator through ``eval --output``: every candidate's
    scores and the winner are the reference example's on the same store,
    best.json is written and the instance is recorded."""
    _seed_eval_ratings(store, "EvalApp")
    out = tmp_path / "best.json"
    assert port_main(["eval", "engine.RecEvaluation",
                      "engine.RecParamsGenerator", "--engine-dir",
                      _port_dir("evaluation"), "--device", "cpu",
                      "--output", str(out), "--workers", "2"]) == 0
    got = _eval_scores(store, capsys)
    generator = sys.modules.pop("engine").RecParamsGenerator
    d = os.path.join(EXAMPLES, "evaluation")
    with _reference_module():
        _, want = ref_run_class(
            ref_load_factory("engine.RecEvaluation", d),
            ref_load_factory("engine.RecParamsGenerator", d), ref_store,
            ctx=ref_context(ref_store, use_mesh=False), workers=2)
    _same_scores(got, want)
    [algo] = json.loads(out.read_text())["algorithmParamsList"]
    best = generator.params_list()[got["bestIndex"]].algorithms[0][1]
    assert (algo["params"]["rank"], algo["params"]["lambda_"]) == (
        best.rank, best.lambda_)


def test_custom_datasource_through_the_deploy_verb(store, ref_store,
                                                   tmp_path):
    """examples/custom-datasource/port: the DataSource reads the example's
    own user::item::rate file (engine-dir-relative ``../data``), no event
    store; ``deploy --device cpu``, a process, serves the instance, and
    its answers are the reference example's."""
    from pio_tpu_torch.__main__ import _engine_from_variant, _load_variant

    d = _port_dir("custom-datasource")
    _, ep = _engine_from_variant(_load_variant(d), d)
    assert ep.datasource[1].filepath == os.path.join(
        d, "../data/ratings.txt")
    ref = _Reference(ref_store, "custom-datasource")
    assert os.path.samefile(ep.datasource[1].filepath,
                            ref.ep.datasource[1].filepath)
    _train(d)
    queries = [{"user": f"u{u}", "num": 3} for u in range(4)]
    proc = subprocess.Popen(
        [sys.executable, "-m", "pio_tpu_torch", "deploy", "--engine-dir",
         d, "--device", "cpu", "--port", "0", "--ip", "127.0.0.1"],
        cwd=str(tmp_path), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        | sqlite_env(tmp_path / "pio.db") | {"PYTHONPATH": REPO})
    try:
        line = proc.stdout.readline()
        assert "deployed" in line, (
            line + proc.stderr.read() if proc.poll() is not None else line)
        port = int(line.split("127.0.0.1:")[1].split()[0])
        answers = [post(port, q) for q in queries]
    finally:
        proc.terminate()
        try:
            proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
    for q, (status, r) in zip(queries, answers):
        assert status == 200, r
        _same_answer(r, ref.answer(q), q)
    # u0 rates even items 5 (odd items occasionally 1)
    r = answers[0][1]
    assert all(int(i[1:]) % 2 == 0 for i in _items(r)), r


def test_twotower_weighted_example(store, ref_store):
    """examples/twotower-weighted/port: buys repeated 4x by the user
    DataSource, the built-in one-device two-tower, the min-score
    Serving. The weighted read and the Serving are the reference's."""
    from pio_tpu_torch.__main__ import _engine_from_variant, _load_variant
    from pio_tpu_torch.workflow.context import create_workflow_context

    app_id = _app(store, "MyApp")
    evs = []
    # the parity-block structure comes only through buys; views are noise
    for u in range(24):
        for i in range(12):
            if (u + i) % 2 == 0:
                evs.append(Event("buy", "user", f"u{u}", "item", f"i{i}"))
            elif (u * 7 + i) % 5 == 0:
                evs.append(Event("view", "user", f"u{u}", "item", f"i{i}"))
    store.get_events().insert_batch(evs, app_id)
    n_buys = sum(e.event == "buy" for e in evs)
    d = _port_dir("twotower-weighted")
    engine, ep = _engine_from_variant(_load_variant(d), d)
    ds_cls = next(iter(engine.datasource_classes.values()))
    inter = ds_cls(ep.datasource[1]).read_training(
        create_workflow_context(store, device="cpu"))
    assert len(inter) == 4 * n_buys + (len(evs) - n_buys)
    ref_dir = os.path.join(EXAMPLES, "twotower-weighted")
    with _reference_module(), open(os.path.join(ref_dir,
                                                "engine.json")) as f:
        ref_engine, ref_ep = ref_engine_from_variant(json.load(f), ref_dir)
    ref_ds, _, _, ref_serving = ref_engine._doers(ref_ep)
    want = ref_ds.read_training(ref_context(ref_store, use_mesh=False))
    assert inter.users.ids() == want.users.ids()
    assert inter.items.ids() == want.items.ids()
    for f in ("user_idx", "item_idx", "values"):
        np.testing.assert_array_equal(getattr(inter, f),
                                      np.asarray(getattr(want, f)))
    _train(d)
    with deployed(d, store, "twotower-weighted") as (port, qs):
        [r] = served_as_in_process(port, qs, [{"user": "u0", "num": 6}])
        preds = [{"itemScores": [{"item": f"i{j}", "score": s} for j, s in
                                 enumerate((0.9, 0.05, 0.049, -0.2))]}]
        q = {"user": "u0", "num": 4}
        assert qs.serving.serve(q, preds) == ref_serving.serve(q, preds)
    assert r["itemScores"], r
    assert all(s["score"] >= 0.05 for s in r["itemScores"])
    # buys carried the parity signal: recommended items lean even
    even = sum(1 for i in _items(r) if int(i[1:]) % 2 == 0)
    assert even >= len(r["itemScores"]) - 1, r


def test_quickstart_eval_through_the_verb(store, ref_store, tmp_path,
                                          monkeypatch, capsys):
    """The README's step 5 on the port: ``eval
    examples.quickstart.port.eval_def.QuickstartEval ... --output
    best.json`` from the repository's root, on the committed dataset's
    first events imported by the ``import`` verb; every candidate's scores
    and the winner are the reference's ``eval_def`` on the same store."""
    app_id = _app(store, "quickstart")
    subset = tmp_path / "events.jsonl"
    with gzip.open(os.path.join(EXAMPLES, "quickstart",
                                "events.jsonl.gz"), "rt") as f, \
            open(subset, "w") as out:
        for _ in range(QUICKSTART_EVENTS):
            out.write(next(f))
    assert port_main(["import", "--appid", str(app_id), "--input",
                      str(subset)]) == 0
    capsys.readouterr()
    monkeypatch.chdir(REPO)
    best = tmp_path / "best.json"
    mod = "examples.quickstart.port.eval_def"
    assert port_main(["eval", f"{mod}.QuickstartEval",
                      f"{mod}.QuickstartParams", "--device", "cpu",
                      "--output", str(best)]) == 0
    got = _eval_scores(store, capsys)
    ref_mod = "examples.quickstart.eval_def"
    try:
        _, want = ref_run_class(
            ref_load_factory(f"{ref_mod}.QuickstartEval"),
            ref_load_factory(f"{ref_mod}.QuickstartParams"), ref_store,
            ctx=ref_context(ref_store, use_mesh=False))
    finally:
        sys.modules.pop(ref_mod, None)
    _same_scores(got, want)
    [algo] = json.loads(best.read_text())["algorithmParamsList"]
    grid = sys.modules[mod].GRID
    assert (algo["params"]["rank"], algo["params"]["lambda_"]) == \
        grid[got["bestIndex"]][:2]


def test_sequence_custom_on_a_data_by_seq_context(store, ref_store,
                                                  tmp_path, monkeypatch):
    """examples/sequence-custom/port: engine.json picks ulysses attention,
    trained by ``run_train`` on a data 1 x seq 2 context (two gloo ranks,
    ``tests/_torch_mesh_worker.py example``, process 0 persisting the
    instance), then served in process: u0's body leaves out the last 4
    items of its history (the user Serving's window), ``noRepeatWindow: 0``
    lifts that (tests/test_examples.py:355-397), and every answer is the
    reference example's, trained on a mesh of the same shape from the
    port's seeded init."""
    from _torch_dist import TESTS, run_ranks
    from pio_tpu.models import sequence as ref_seq
    from pio_tpu.parallel.mesh import MeshConfig as RefMeshConfig
    from pio_tpu_torch.models import sequence as port_seq
    from test_torch_mesh_sequence import _ref_init, _to_ref_tree

    app_id = _app(store, "MyApp")
    # deterministic cycles: u's history is i_(u%3), i_(u%3+1), ...
    store.get_events().insert_batch([
        Event("view", "user", f"u{u}", "item", f"i{(u % 3 + t) % 10}",
              DataMap({}))
        for u in range(30) for t in range(8)], app_id)
    d = _port_dir("sequence-custom")
    job = tmp_path / "job"
    job.mkdir()
    np.savez(job / "in.npz")
    (job / "in.json").write_text(json.dumps({
        "mesh": [1, 2, 1], "engine_dir": d,
        "engine_id": "sequence-custom"}))
    outs = run_ranks(
        lambda r: [os.path.join(TESTS, "_torch_mesh_worker.py"), "example",
                   str(job)], 2,
        env_of=lambda r: sqlite_env(tmp_path / "pio.db")
        | {"PIO_TPU_RUN_ID": "seq-custom-run",
           "PIO_TPU_CKPT_ROOT": str(tmp_path / "ckpt")})
    for rc, _, err in outs:
        assert rc == 0, err[-3000:]
    for r in range(2):
        got = np.load(job / f"rank{r}.npz")
        assert str(got["instance"]) == "seq-custom-run"
        assert got["mesh"].tolist() == [1, 2, 1]
    assert [(i.id, i.status) for i in
            store.get_metadata_engine_instances().get_all()] == [
        ("seq-custom-run", "COMPLETED")]

    # the reference example on a data 1 x seq 2 mesh, from the port's init
    with open(os.path.join(EXAMPLES, "sequence-custom", "engine.json")) as f:
        variant = json.load(f)
    with _reference_module():
        engine, ep = ref_engine_from_variant(
            variant, os.path.join(EXAMPLES, "sequence-custom"))
        p = ep.algorithms[0][1]
        assert p.attention == "ulysses"
        data = engine._doers(ep)[0].read_training(ref_context(
            ref_store, use_mesh=False))
        enc = port_seq.init_encoder_(port_seq.make_encoder(
            len(data.items), port_seq.SequenceParams(**{
                f: getattr(p, f) for f in p.__dataclass_fields__})), p.seed)
        init = _to_ref_tree(enc.state_dict(),
                            _ref_init(len(data.items), p))
        monkeypatch.setattr(ref_seq.SeqEncoder, "init",
                            lambda self, *a, **kw: {"params": init})
        ctx = ref_context(ref_store, mesh_config=RefMeshConfig(
            data=1, seq=2), use_mesh=True)
        assert ctx.mesh.devices.shape == (1, 2, 1)
        models = engine.train(ctx, ep)
        (_, _, algorithms, serving) = engine._doers(ep)

    queries = [{"user": "u0", "num": 8},
               {"user": "u0", "num": 8, "noRepeatWindow": 0},
               {"user": "u1", "num": 5}, {"user": "u2", "num": 5}]
    with deployed(d, store, "sequence-custom") as (port, qs):
        bodies = served_as_in_process(port, qs, queries)
    for q, body in zip(queries, bodies):
        want = serving.serve(q, [a.predict(m, q)
                                 for a, m in zip(algorithms, models)])
        _same_answer(body, want, q)
    # u0's last 4 items (t = 4..7 of the cycle (0 + t) % 10)
    recent = {f"i{t}" for t in range(4, 8)}
    assert not recent & set(_items(bodies[0])), bodies[0]
    assert len(bodies[1]["itemScores"]) >= len(bodies[0]["itemScores"])
    assert recent & set(_items(bodies[1])), bodies[1]
