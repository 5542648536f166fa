"""The port's tuning package (``pio_tpu_torch.tuning``) against the JAX
package, on the CPU at small sizes: metrics, splits, stacked scoring and
top-k, the sequential fallback and the verbs.

- metrics: the torch batched functions against ``pio_tpu.tuning.metrics``'
  JAX ones and the scalar oracles on the same seeded numpy inputs, ties
  and users without actuals included;
- splits: ``seeded_kfold`` and ``time_rolling_folds`` bit for bit;
- the batched scorer's map@10 of a stacked candidate against a sequential
  model; ``sweep_safe_params``; stacked top-k ids equal to the
  reference's where masked seen items tie;
- the sequential fallback's two errors word for word, the sequence
  template's sweep, spans, the metrics server;
- the CLI: ``eval --sweep``, ``train --from-eval``, ``deploy
  --from-eval`` and ``batchpredict``, with ``--device cpu``; without CUDA
  and without it they raise.

The stacked trainer's tests are in ``test_torch_tuning_stacked.py`` and
``test_torch_tuning_reference.py``, the whole sweeps against the
reference in ``test_torch_tuning_sweep.py`` (one file each so that no
file holds a test worker for long).

Tolerances: the ALS factors of the two packages agree within 2e-3 of the
largest factor after 3 sweeps from the same init (test_torch_train.py),
within 1e-4 with f32 gathers (measured: 3e-5);
scores that rank on such factors within the reference's own stacked-vs-
sequential tolerance, abs 0.02 (tests/test_tuning.py); batched metrics on
equal rankings within 1e-6 of the JAX values (f32 sums in another order)
and 1e-5 of the oracles (f32 against float64).
"""

import _torch_cpu  # noqa: F401  (one CPU thread: see the module)
import dataclasses
import json
import os
import subprocess
import sys
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pio_tpu.controller.engine import EngineParams as RefEngineParams
from pio_tpu.data.bimap import EntityIdIndex as RefIndex
from pio_tpu.data.eventstore import Interactions as RefInteractions
from pio_tpu.models import sequence as ref_seq
from pio_tpu.tuning import SweepConfig as RefSweepConfig
from pio_tpu.tuning import metrics as ref_tm
from pio_tpu.tuning import splits as ref_splits
from pio_tpu.tuning import sweep as ref_sweep
from pio_tpu.workflow.context import create_workflow_context as ref_context
from pio_tpu.workflow.evaluate import run_sweep_evaluation as ref_run_sweep
from pio_tpu_torch.__main__ import main as port_main
from pio_tpu_torch.controller.engine import EngineParams
from pio_tpu_torch.data.bimap import EntityIdIndex
from pio_tpu_torch.data.eventstore import Interactions
from pio_tpu_torch.models import recommendation as port_rec
from pio_tpu_torch.models import sequence as port_seq
from pio_tpu_torch.ops import als as port_als
from pio_tpu_torch.tuning import (
    SweepConfig,
    load_best_params,
    parse_metric,
    resolve_from_eval,
)
from pio_tpu_torch.tuning import metrics as tm
from pio_tpu_torch.tuning import splits as port_splits
from pio_tpu_torch.tuning import sweep as port_sweep
from pio_tpu_torch.tuning.records import load_sweep_state
from pio_tpu_torch.workflow.context import create_workflow_context
from pio_tpu_torch.workflow.evaluate import run_sweep_evaluation
from _torch_tuning_common import (
    APP,
    METRIC_ABS,
    ORACLE_ABS,
    REPO,
    SCORE_ABS,
    _RANKED,
    _arrays,
    _assert_folds_equal,
    _candidates,
    _config,
    _engine_dir,
    _fuzz_cases,
    _interactions,
    _post,
    _seed_events,
    _seq_candidates,
    store,
)


@pytest.mark.parametrize("name", sorted(_RANKED))
def test_ranked_metric_matches_jax_and_oracle(name):
    port_fn, ref_fn, oracle = _RANKED[name]
    for k, topk, actuals, topk_m, act_m, *_ in _fuzz_cases():
        got = port_fn(topk_m, act_m, k)
        assert got.dtype == torch.float32
        got = got.numpy()
        want = np.asarray(ref_fn(topk_m, act_m, k))
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, rtol=0, atol=METRIC_ABS)
        for j in range(len(topk)):
            o = oracle(list(topk[j]), list(actuals[j]), k)
            if o is None:
                assert np.isnan(got[j])
            else:
                assert got[j] == pytest.approx(o, abs=ORACLE_ABS)


def test_auc_matches_jax_and_oracle_with_ties():
    """Integer scores force ties between positives and negatives: each
    counts half, as the pairwise oracle counts it."""
    for *_, scores, pos, valid in _fuzz_cases():
        got = tm.auc_batch(scores, pos, valid).numpy()
        want = np.asarray(ref_tm.auc_batch(scores, pos, valid))
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, rtol=0, atol=METRIC_ABS)
        for j in range(len(scores)):
            o = tm.auc_scalar(list(scores[j]), list(np.flatnonzero(pos[j])),
                              list(np.flatnonzero(valid[j])))
            if o is None:
                assert np.isnan(got[j])
            else:
                assert got[j] == pytest.approx(o, abs=ORACLE_ABS)
    # leading batch axes, as the stacked sweep passes (C, B, I)
    s = np.random.default_rng(3).standard_normal((2, 3, 9)).astype(
        np.float32)
    pos = np.zeros((2, 3, 9), bool)
    pos[..., :2] = True
    valid = np.ones((2, 3, 9), bool)
    np.testing.assert_allclose(
        tm.auc_batch(s, pos, valid).numpy(),
        np.asarray(ref_tm.auc_batch(s, pos, valid)), rtol=0,
        atol=METRIC_ABS)


@pytest.mark.parametrize("spec", ["map@3", "ndcg@4", "precision@2",
                                  "recall@5"])
def test_qpa_adapter_matches_reference(spec):
    """The Metric-contract path over (query, prediction, actual) triples:
    short rankings, empty predictions and users without actuals."""
    data = [(None, [
        ({}, {"itemScores": [{"item": "a", "score": 1},
                             {"item": "b", "score": 0.5}]}, ["a", "c"]),
        ({}, {"itemScores": []}, ["a"]),
        ({}, {"itemScores": [{"item": "z", "score": 1}]}, []),
        ({}, {"itemScores": [{"item": x, "score": 1} for x in "cdba"]},
         ["b", "d", "q"]),
    ])]
    got = tm.parse_metric(spec)
    assert got.header == ref_tm.parse_metric(spec).header
    assert got.calculate(None, data) == pytest.approx(
        ref_tm.parse_metric(spec).calculate(None, data), abs=METRIC_ABS)


def test_qpa_precision_matches_legacy_and_auc_refuses():
    from pio_tpu_torch.e2.metrics import PrecisionAtK as Legacy

    data = [(None, [
        ({}, {"itemScores": [{"item": "a", "score": 1},
                             {"item": "b", "score": 0.5}]}, ["a", "c"]),
        ({}, {"itemScores": []}, ["a"]),
        ({}, {"itemScores": [{"item": "z", "score": 1}]}, []),
    ])]
    assert tm.PrecisionAtK(2).calculate(None, data) == pytest.approx(
        Legacy(2).calculate(None, data))
    with pytest.raises(ValueError, match="full per-item score rows"):
        tm.AUC().calculate(None, data)
    assert tm.parse_metric("auc").header == "AUC"
    with pytest.raises(ValueError):
        tm.parse_metric("bogus@3")


@pytest.mark.parametrize("k, seed, exclude_seen", [
    (2, 42, True), (3, 42, True), (3, 7, False)])
def test_seeded_kfold_equals_reference(k, seed, exclude_seen):
    got = port_splits.seeded_kfold(
        _interactions(Interactions, EntityIdIndex), k, seed=seed,
        exclude_seen=exclude_seen)
    want = ref_splits.seeded_kfold(
        _interactions(RefInteractions, RefIndex), k, seed=seed,
        exclude_seen=exclude_seen)
    _assert_folds_equal(got, want)


@pytest.mark.parametrize("n_folds", [1, 2, 3])
def test_time_rolling_folds_equal_reference(store, n_folds):
    storage, ref, _ = store
    app_id = storage.get_metadata_apps().get_by_name(APP).id
    where = dict(app_id=app_id, entity_type="user",
                 target_entity_type="item", event_names=["rate", "buy"])
    kw = dict(value_key="rating", default_value=4.0, value_event="rate")
    got = port_splits.folds_for(storage.get_events().find_columnar(**where),
                                "time", n_folds, **kw)
    want = ref_splits.folds_for(ref.get_events().find_columnar(**where),
                                "time", n_folds, **kw)
    _assert_folds_equal(got, want)
    # the same events through kfold from columns
    got = port_splits.folds_for(storage.get_events().find_columnar(**where),
                                "kfold", 2, **kw)
    want = ref_splits.folds_for(ref.get_events().find_columnar(**where),
                                "kfold", 2, **kw)
    _assert_folds_equal(got, want)


def test_stacked_map_matches_sequential():
    """The reference's own stacked-vs-sequential check on the port: the
    batched scorer gives candidate c and a sequential model of c the
    same map@10 within abs 0.02 over the same users."""
    data = _interactions(Interactions, EntityIdIndex, nnz=800)
    fold = port_splits.seeded_kfold(data, 2, seed=42)[0]
    t = fold.train
    base = port_als.ALSParams(rank=8, iterations=3, chunk=256)
    regs = np.array([0.01, 0.1, 1.0], np.float32)
    stacked = port_als.als_train_stacked(
        t.user_idx, t.item_idx, t.values, t.n_users, t.n_items, base, regs,
        np.ones(3, np.float32), device="cpu")
    metric = tm.MAPAtK(10)
    batched = port_sweep._score_stacked(stacked, fold, [metric], 512)
    for c, reg in enumerate(regs):
        seq = port_als.als_train(
            t.user_idx, t.item_idx, t.values, t.n_users, t.n_items,
            port_als.sweep_safe_params(
                dataclasses.replace(base, reg=float(reg)), "cpu"),
            device="cpu")
        single = port_als.StackedALSModel(seq.user_factors[None],
                                          seq.item_factors[None])
        sum_b, n_b = batched[c][0]
        sum_s, n_s = port_sweep._score_stacked(single, fold, [metric],
                                               512)[0][0]
        assert n_b == n_s
        assert sum_b / n_b == pytest.approx(sum_s / n_s, abs=SCORE_ABS)


def test_sweep_safe_params_as_the_reference(monkeypatch):
    p = port_als.ALSParams(accum="hybrid", gather="stream", packed_a=True)
    cpu = port_als.sweep_safe_params(p, "cpu")
    assert (cpu.accum, cpu.gather, cpu.packed_a) == ("carry", "xla", False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    card = port_als.sweep_safe_params(p, "cuda")
    assert (card.accum, card.gather, card.packed_a) == (
        "stacked", "xla", False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_als.als_train_stacked(*_arrays(nnz=100), p,
                                   np.ones(2, np.float32),
                                   np.ones(2, np.float32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stacked_topk_ids_equal_reference_under_ties(seed):
    """Small-integer factors make exact score ties, and users who have
    seen most of the catalog put masked items (all tied at MASKED_SCORE)
    into the top-k: the ids must be the reference's, lowest index first
    among ties."""
    rng = np.random.default_rng(seed)
    n_cand, n_users, n_items, rank, b, k = 2, 10, 12, 3, 6, 8
    uf = rng.integers(-1, 2, (n_cand, n_users, rank)).astype(np.float32)
    itf = rng.integers(-1, 2, (n_cand, n_items, rank)).astype(np.float32)
    uidx = rng.choice(n_users, b, replace=False).astype(np.int32)
    seen = [rng.choice(n_items, int(rng.integers(0, n_items)),
                       replace=False) for _ in range(b)]
    seen_pad = np.full((b, 16), -1, np.int32)
    for j, s in enumerate(seen):
        seen_pad[j, :len(s)] = s
    got_s, got_i = port_sweep._stacked_topk(
        torch.from_numpy(uf), torch.from_numpy(itf), uidx, seen_pad, k)
    want_s, want_i = ref_sweep._stacked_topk(
        jnp.asarray(uf), jnp.asarray(itf), jnp.asarray(uidx),
        jnp.asarray(seen_pad), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert (got_s.numpy() == tm.MASKED_SCORE).any()


@pytest.mark.parametrize("split, metric", [("time", "map@5"),
                                           ("kfold", "auc")])
def test_sequential_fallback_errors_as_the_reference(store, split, metric):
    """The sequence template is not ALS-shaped, so its grid runs through
    the sequential fallback, which rejects the time split and an AUC
    primary metric with the reference's words."""
    storage, ref, _ = store
    with pytest.raises(ValueError) as got:
        run_sweep_evaluation(
            port_seq.SequenceEngine.apply(),
            _seq_candidates(EngineParams, port_seq), storage,
            _config(SweepConfig, parse_metric, split, metric=metric,
                    others=()),
            ctx=create_workflow_context(storage, device="cpu"))
    with pytest.raises(ValueError) as want:
        ref_run_sweep(
            ref_seq.SequenceEngine.apply(),
            _seq_candidates(RefEngineParams, ref_seq), ref,
            _config(RefSweepConfig, ref_tm.parse_metric, split,
                    metric=metric, others=()),
            ctx=ref_context(ref, use_mesh=False))
    assert str(got.value) == str(want.value)


def test_sequence_sweep_runs_sequentially(store):
    """The sequence grid sweeps candidate by candidate through the
    template's rolling read_eval (eval_k filled in from --folds), with
    the full-score metric dropped from the columns."""
    storage, _, _ = store
    _seed_events(storage, app_name="seqapp", n_users=20, n_items=15,
                 n_events=300, kinds=("view", "buy"))
    cands = _seq_candidates(EngineParams, port_seq, app_name="seqapp")
    assert not port_sweep.group_candidates(cands)[1]
    eval_id, result = run_sweep_evaluation(
        port_seq.SequenceEngine.apply(), cands, storage,
        _config(SweepConfig, parse_metric, others=("ndcg@5", "auc")),
        ctx=create_workflow_context(storage, device="cpu"))
    assert set(load_sweep_state(storage, eval_id).completed) == {
        "cand0", "cand1"}
    assert result.other_metric_headers == ["NDCG@5"]
    assert all(0.0 <= ms.score <= 1.0 for _, ms in
               result.engine_params_scores)


def test_sweep_spans_reach_recorder(store):
    from pio_tpu_torch.obs.recorder import TraceRecorder
    from pio_tpu_torch.utils.tracing import Tracer

    storage, _, _ = store
    recorder = TraceRecorder("eval")
    run_sweep_evaluation(
        port_rec.RecommendationEngine.apply(),
        _candidates(EngineParams, port_rec, regs=(0.01, 0.1)), storage,
        _config(SweepConfig, parse_metric),
        ctx=create_workflow_context(storage, device="cpu"),
        tracer=Tracer(recorder=recorder))
    names = {r["span"] for r in recorder.span_table()}
    assert {"eval.sweep", "eval.fold", "eval.candidate"} <= names


def test_resolve_from_eval_errors(store):
    storage, _, _ = store
    with pytest.raises(ValueError, match="no best-params record"):
        resolve_from_eval(storage, "nope")
    with pytest.raises(ValueError, match="no completed evaluation"):
        resolve_from_eval(storage, "latest")


def test_eval_metrics_server_surface():
    from pio_tpu_torch.tuning.server import EvalStatus, create_eval_server
    from pio_tpu_torch.utils.httpclient import JsonHttpClient
    from pio_tpu_torch.utils.tracing import Tracer

    tracer = Tracer()
    with tracer.span("eval.fold", fold=0):
        pass
    status = EvalStatus(tracer)
    status.update(phase="running", evalId="e1", mode="batched",
                  unitsDone=1, unitsTotal=2, bestScore=0.5,
                  metric="MAP@5")
    status.observe_sweep_seconds(2.5)
    http = create_eval_server(status)
    http.start()
    try:
        client = JsonHttpClient(f"http://127.0.0.1:{http.port}",
                                timeout=10)
        health = client.request("GET", "/healthz")
        assert health["unitsDone"] == 1 and health["unitsTotal"] == 2
        with urllib.request.urlopen(
                f"http://127.0.0.1:{http.port}/metrics",
                timeout=10) as resp:
            text = resp.read().decode()
        assert 'pio_eval_best_score{surface="eval"} 0.5' in text
        assert '# TYPE pio_eval_sweep_seconds histogram' in text
        assert 'pio_eval_sweep_seconds_count{surface="eval"} 1' in text
        assert 'span="eval.fold"' in text
    finally:
        http.stop()


def test_cli_sweep_then_train_and_deploy_from_eval(store, tmp_path,
                                                   monkeypatch, capsys):
    """``eval --sweep --device cpu`` stores the winner; ``train
    --from-eval`` trains it (batch-tagged ``from-eval:<id>``, its params
    the winner's); ``deploy --from-eval``, a real process, serves it."""
    storage, _, env = store
    d = _engine_dir(tmp_path)
    monkeypatch.setattr("pio_tpu_torch.__main__.get_storage",
                        lambda: storage)
    best = tmp_path / "best.json"
    assert port_main([
        "eval", "--sweep", "--engine-dir", str(d), "--grid",
        '{"lambda_": [0.01, 100.0]}', "--metric", "map@5",
        "--other-metrics", "ndcg@5,auc", "--folds", "2", "--device", "cpu",
        "--output", str(best), "--metrics-port", "0"]) == 0
    out = capsys.readouterr().out
    eval_id = out.split("Evaluation instance: ")[1].split()[0]
    payload = load_best_params(storage, eval_id)
    winner = payload["variant"]["algorithms"][0]["params"]["lambda_"]
    assert json.loads(best.read_text())["algorithmParamsList"][0][
        "params"]["lambda_"] == winner

    assert port_main(["train", "--engine-dir", str(d), "--device", "cpu",
                      "--from-eval", eval_id, "--batch", "nightly"]) == 0
    inst = storage.get_metadata_engine_instances().get_latest_completed(
        "tune-cli", "1", "default")
    assert inst.batch == f"nightly from-eval:{eval_id}"
    # the instance records its algorithm params as their repr
    assert f"lambda_={winner!r}" in inst.algorithms_params
    # `latest` resolves to the same sweep
    assert port_main(["train", "--engine-dir", str(d), "--device", "cpu",
                      "--from-eval", "latest"]) == 0
    assert storage.get_metadata_engine_instances().get_latest_completed(
        "tune-cli", "1", "default").batch == f"from-eval:{eval_id}"

    proc = subprocess.Popen(
        [sys.executable, "-m", "pio_tpu_torch", "deploy", "--engine-dir",
         str(d), "--device", "cpu", "--port", "0", "--ip", "127.0.0.1",
         "--from-eval", eval_id],
        cwd=REPO, env={**os.environ, **env}, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        first = proc.stdout.readline()
        assert f"best params from evaluation {eval_id}" in first, first
        line = proc.stdout.readline()
        assert "deployed" in line, (
            line + proc.stderr.read() if proc.poll() is not None else line)
        port = int(line.split("127.0.0.1:")[1].split()[0])
        status, body = _post(port, {"user": "u1", "num": 3})
        assert status == 200 and len(body["itemScores"]) == 3
    finally:
        proc.terminate()
        try:
            proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()


@pytest.mark.parametrize("retrieval", [
    None, {"mode": "clustered", "dtype": "int8", "n_clusters": 4,
           "nprobe": 2, "impl": "pallas"}])
def test_batchpredict_lines_equal_query_batch(store, tmp_path, monkeypatch,
                                              retrieval):
    """``batchpredict --device cpu`` writes one {query, prediction} line
    per query, in input order, each the port's own ``query_batch``
    answer; a malformed line becomes an error record."""
    from pio_tpu_torch.workflow.serve import QueryServer, ServingConfig

    storage, _, _ = store
    d = _engine_dir(tmp_path, retrieval)
    monkeypatch.setattr("pio_tpu_torch.__main__.get_storage",
                        lambda: storage)
    assert port_main(["train", "--engine-dir", str(d), "--device",
                      "cpu"]) == 0
    queries = [{"user": f"u{j}", "num": 1 + j % 5} for j in range(40)]
    queries[7]["blackList"] = ["i1", "i2"]
    queries.append({"user": "nobody", "num": 3})
    inp = tmp_path / "q.jsonl"
    inp.write_text("\n".join(json.dumps(q) for q in queries[:20])
                   + "\nnot json\n"
                   + "\n".join(json.dumps(q) for q in queries[20:]) + "\n")
    out = tmp_path / "p.jsonl"
    assert port_main(["batchpredict", "--engine-dir", str(d), "--input",
                      str(inp), "--output", str(out), "--batch-size", "16",
                      "--device", "cpu"]) == 0
    lines = [json.loads(x) for x in out.read_text().splitlines()]
    assert len(lines) == len(queries) + 1
    assert lines[20] == {"query": "not json", "error": lines[20]["error"]}
    del lines[20]
    engine = port_rec.RecommendationEngine.apply()
    ep = engine.engine_params_from_variant(
        json.loads((d / "engine.json").read_text()))
    qs = QueryServer(engine, ep, storage,
                     ServingConfig(engine_id="tune-cli"),
                     ctx=create_workflow_context(storage, device="cpu"))
    try:
        want = qs.query_batch(queries)
    finally:
        qs.close()
    assert [x["query"] for x in lines] == queries
    assert [x["prediction"] for x in lines] == want


def test_entry_points_raise_without_cuda(store, tmp_path, monkeypatch):
    storage, _, _ = store
    d = _engine_dir(tmp_path)
    (tmp_path / "q.jsonl").write_text('{"user": "u1"}\n')
    monkeypatch.setattr("pio_tpu_torch.__main__.get_storage",
                        lambda: storage)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (
            ["eval", "--sweep", "--engine-dir", str(d), "--grid",
             '{"lambda_": [0.1]}'],
            ["batchpredict", "--engine-dir", str(d), "--input",
             str(tmp_path / "q.jsonl"), "--output",
             str(tmp_path / "p.jsonl")]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port_main(argv)

