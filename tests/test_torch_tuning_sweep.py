"""The port's whole sweep (``run_sweep_evaluation``) against the
reference's on the same sqlite events from the same init (winner, scores,
the ``:best_params`` record), and a sweep killed by a chaos fault then
resumed to the uninterrupted result, on the CPU.

Tolerance: scores within the reference's own stacked-vs-sequential
tolerance, abs 0.02 (tests/test_tuning.py).
"""

import _torch_cpu  # noqa: F401  (one CPU thread: see the module)
import pytest

from pio_tpu.controller.engine import EngineParams as RefEngineParams
from pio_tpu.models import recommendation as ref_rec
from pio_tpu.tuning import SweepConfig as RefSweepConfig
from pio_tpu.tuning import metrics as ref_tm
from pio_tpu.workflow.context import create_workflow_context as ref_context
from pio_tpu.workflow.evaluate import run_sweep_evaluation as ref_run_sweep
from pio_tpu_torch.controller.engine import EngineParams
from pio_tpu_torch.data.storage import Storage
from pio_tpu_torch.models import recommendation as port_rec
from pio_tpu_torch.resilience import chaos
from pio_tpu_torch.tuning import load_best_params, resolve_from_eval
from pio_tpu_torch.tuning.records import load_sweep_state
from _torch_tuning_common import (
    SCORE_ABS,
    _candidates,
    _config,
    _port_sweep,
    _seed_events,
    _storage_env,
    same_init,
    store,
)


@pytest.mark.parametrize("split", ["kfold", "time"])
def test_sweep_matches_reference(store, same_init, split):
    """The port's sweep and the reference's on the same events, from the
    same init: the winner, every score within abs 0.02, and the
    ``:best_params`` record naming the winner's params."""
    storage, ref, _ = store
    _, want = ref_run_sweep(
        ref_rec.RecommendationEngine.apply(),
        _candidates(RefEngineParams, ref_rec), ref,
        _config(RefSweepConfig, ref_tm.parse_metric, split),
        engine_id="tune-e", ctx=ref_context(ref, use_mesh=False))
    # the port's sweep runs second, so it is the store's latest
    eval_id, got = _port_sweep(
        storage, _candidates(EngineParams, port_rec), split=split)
    assert got.best_idx == want.best_idx
    assert got.metric_header == want.metric_header == "MAP@5"
    assert got.other_metric_headers == want.other_metric_headers
    for (_, g), (_, w) in zip(got.engine_params_scores,
                              want.engine_params_scores):
        assert g.score == pytest.approx(w.score, abs=SCORE_ABS)
        assert g.other_scores == pytest.approx(w.other_scores,
                                               abs=SCORE_ABS)
    inst = storage.get_metadata_evaluation_instances().get(eval_id)
    assert inst.status == "EVALCOMPLETED"
    assert "bestScore" in inst.evaluator_results_json
    payload = load_best_params(storage, eval_id)
    assert payload["metric"] == "MAP@5"
    assert payload["score"] == got.best_score.score
    assert payload["variant"]["algorithms"][0]["params"]["lambda_"] == \
        got.best_engine_params.algorithms[0][1].lambda_
    assert set(load_sweep_state(storage, eval_id).completed) == {
        "fold0", "fold1"}
    assert resolve_from_eval(storage, "latest")[0] == eval_id


def test_sweep_chaos_kill_then_resume_identical(store, tmp_path):
    """Killed at ``eval.fold.1`` -> EVALFAILED with fold 0 persisted;
    resumed with the same plan -> only fold 1 runs and the result is
    identical to an uninterrupted sweep on a second store of the same
    events."""
    storage, _, _ = store
    cands = _candidates(EngineParams, port_rec)
    (tmp_path / "oracle").mkdir()
    oracle_storage = Storage(env=_storage_env(tmp_path / "oracle"))
    try:
        _seed_events(oracle_storage)
        _, oracle = _port_sweep(oracle_storage, cands)
    finally:
        oracle_storage.close()

    with pytest.raises(chaos.ChaosError):
        with chaos.inject("eval.fold.1", error=1.0):
            _port_sweep(storage, cands)
    dao = storage.get_metadata_evaluation_instances()
    failed = [i for i in dao.get_all() if i.status == "EVALFAILED"]
    assert len(failed) == 1
    eval_id = failed[0].id
    assert set(load_sweep_state(storage, eval_id).completed) == {"fold0"}
    resumed_id, result = _port_sweep(storage, cands, resume=eval_id)
    assert resumed_id == eval_id
    assert dao.get(eval_id).status == "EVALCOMPLETED"
    assert result.best_idx == oracle.best_idx
    for (_, got), (_, want) in zip(result.engine_params_scores,
                                   oracle.engine_params_scores):
        assert got.score == want.score
        assert got.other_scores == want.other_scores

