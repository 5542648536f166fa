"""The two-tower template of the port against the JAX package, on the CPU.

Torch cannot draw flax's ``init_params``, so both packages start from the
reference's params, carried across by ``convert.twotower_params_from_numpy``.
On them the towers' forward agrees to FWD_ATOL (1e-6: f32 products in
another order, then the normalization). Twenty Adam steps on the same
batch stream (``default_rng((seed, step))``) leave every param within
PARAM_ATOL (1e-5 absolute; measured 1.4e-6 at lr 5e-3) and the item
embeddings within 1e-5. The reference's trained model, carried across by
``twotower_model_from_numpy``, answers the reference's queries with the
reference's ids (scores to 1e-5, ids equal where neighbouring scores are
more than 1e-5 apart). On the port's own model, batched answers equal solo
ones bit for bit at B 1 to 64, blackList and unknown users as in
``tests/test_twotower.py``; a run resumed from a step checkpoint, in
process or through the train verb after a chaos kill, equals the
uninterrupted run bit for bit; the sweep through the sequential fallback
and ``--from-eval`` (``tests/test_tuning.py``'s two-tower cases) run on
the port; and the committed engine.json trains through the verb and
deploys over HTTP.
"""

import _torch_cpu  # noqa: F401  (one CPU thread: see the module)
import json
import os

import jax
import numpy as np
import pytest
import torch

from pio_tpu.data.bimap import EntityIdIndex as RefIndex
from pio_tpu.data.eventstore import Interactions as RefInteractions
from pio_tpu.models import twotower as ref_tt
from pio_tpu_torch import convert
from pio_tpu_torch.__main__ import _apply_from_eval
from pio_tpu_torch.controller.engine import EngineParams
from pio_tpu_torch.data.bimap import EntityIdIndex
from pio_tpu_torch.data.eventstore import Interactions
from pio_tpu_torch.data.storage import Storage
from pio_tpu_torch.models import twotower as tt
from pio_tpu_torch.resilience import chaos
from pio_tpu_torch.tuning import SweepConfig, parse_metric
from pio_tpu_torch.tuning.records import load_sweep_state
from pio_tpu_torch.tuning.sweep import group_candidates
from pio_tpu_torch.workflow.context import create_workflow_context
from pio_tpu_torch.workflow.evaluate import run_sweep_evaluation
from pio_tpu_torch.workflow.serve import ServingConfig, create_query_server
from pio_tpu_torch.workflow.step_checkpoint import (
    StepCheckpointConfig,
    StepCheckpointer,
)
from pio_tpu_torch.workflow.train import load_models, run_train

import _torch_verbs as verbs
from _torch_tuning_common import _seed_events

FWD_ATOL = 1e-6
PARAM_ATOL = 1e-5
SCORE_TOL = 1e-5
FACTORY = "pio_tpu_torch.models.twotower.TwoTowerEngine"
SMALL = dict(embed_dim=16, hidden_dim=32, out_dim=8, steps=300,
             batch_size=256, learning_rate=5e-3, temperature=0.1)
PARITY = {**SMALL, "steps": 20, "batch_size": 64}


def _clustered(pkg_inter, pkg_index, n_users=40, n_items=24, seed=0):
    """tests/test_twotower.py's two clusters of users and items."""
    rng = np.random.default_rng(seed)
    us, its = [], []
    for u in range(n_users):
        for i in range(n_items):
            if rng.random() < (0.6 if (i % 2) == (u % 2) else 0.05):
                us.append(u)
                its.append(i)
    return pkg_inter(
        user_idx=np.array(us, np.int32), item_idx=np.array(its, np.int32),
        values=np.ones(len(us), np.float32),
        users=pkg_index(f"u{i}" for i in range(n_users)),
        items=pkg_index(f"i{i}" for i in range(n_items)))


def _ctx(storage=None):
    return create_workflow_context(storage or Storage(env={
        "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM"}), device="cpu")


@pytest.fixture(scope="module")
def trained():
    """The port's own model on the clustered data (SMALL, 300 steps)."""
    algo = tt.TwoTowerAlgorithm(tt.TwoTowerParams(**SMALL))
    return algo, algo.train(_ctx(), _clustered(Interactions, EntityIdIndex))


@pytest.fixture(scope="module")
def parity():
    """Both packages' 20 steps from the reference's init on one stream."""
    inter = _clustered(Interactions, EntityIdIndex)
    ref_inter = _clustered(RefInteractions, RefIndex)
    rp = ref_tt.TwoTowerParams(**PARITY)
    init = jax.device_get(ref_tt.init_params(inter.n_users, inter.n_items,
                                             rp))
    ref_params, ref_emb, _ = ref_tt.train_two_tower(ref_inter, rp)
    params, emb, _, losses = tt.train_two_tower(
        inter, tt.TwoTowerParams(**PARITY), device="cpu",
        init=convert.twotower_params_from_numpy(init, device="cpu"))
    return dict(init=init, ref_params=jax.device_get(ref_params),
                ref_emb=np.asarray(ref_emb), params=params, emb=emb,
                losses=losses, inter=inter)


def test_forward_from_converted_params_matches_reference(parity):
    init = parity["init"]
    towers = tt.make_towers(40, 24, tt.TwoTowerParams(**PARITY))
    towers.load_state_dict(convert.twotower_params_from_numpy(
        init, device="cpu"))
    for side, n in (("user", 40), ("item", 24)):
        ids = np.arange(n, dtype=np.int32)
        want = np.asarray(ref_tt.Tower(n, 16, 32, 8).apply(
            {"params": init[side]}, ids))
        with torch.no_grad():
            got = getattr(towers, side)(torch.arange(n)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=FWD_ATOL)
        np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0,
                                   atol=1e-5)


def test_twenty_steps_match_reference(parity):
    want = convert.twotower_params_from_numpy(parity["ref_params"],
                                              device="cpu")
    got = parity["params"]
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)
    np.testing.assert_allclose(parity["emb"].numpy(), parity["ref_emb"],
                               rtol=0, atol=PARAM_ATOL)
    losses = parity["losses"]
    assert losses.shape == (20,) and losses[-1] < losses[0]


def _same_answer(got, want, what=""):
    g, w = got["itemScores"], want["itemScores"]
    assert len(g) == len(w), (what, got, want)
    ws = np.array([x["score"] for x in w])
    np.testing.assert_allclose([x["score"] for x in g], ws, rtol=SCORE_TOL,
                               atol=SCORE_TOL, err_msg=str(what))
    for j in range(len(w)):
        if ((j == 0 or ws[j - 1] - ws[j] > SCORE_TOL)
                and (j == len(w) - 1 or ws[j] - ws[j + 1] > SCORE_TOL)):
            assert g[j]["item"] == w[j]["item"], (what, got, want)


QUERIES = [{"user": "u0", "num": 3}, {"user": "u1", "num": 5,
                                        "blackList": ["i0", "i2"]},
           {"user": "nope", "num": 3}, {"user": "u2", "num": 1},
           {"user": "u7", "num": 24}, {"user": "u3", "num": 4,
                                        "blackList": ["i1"]}]


def test_converted_reference_model_answers_as_reference(parity):
    ref_p, ref_emb = parity["ref_params"], parity["ref_emb"]
    inter = parity["inter"]
    config = tt.TwoTowerParams(**PARITY)
    model = convert.twotower_model_from_numpy(
        ref_p, ref_emb, inter.users.ids(), inter.items.ids(), config,
        device="cpu")
    ref_inter = _clustered(RefInteractions, RefIndex)
    ref_model = ref_tt.TwoTowerModel(ref_p, ref_emb, ref_inter.users,
                                     ref_inter.items,
                                     ref_tt.TwoTowerParams(**PARITY))
    algo = tt.TwoTowerAlgorithm(config)
    ref_algo = ref_tt.TwoTowerAlgorithm(ref_tt.TwoTowerParams(**PARITY))
    for q in QUERIES:
        _same_answer(algo.predict(model, q), ref_algo.predict(ref_model, q),
                     q)
    with pytest.raises(ValueError, match="item embeddings"):
        convert.twotower_model_from_numpy(
            ref_p, ref_emb[:5], inter.users.ids(), inter.items.ids(),
            config, device="cpu")


def test_learns_clusters_and_reference_cases(trained):
    """tests/test_twotower.py's cluster recovery, blackList and unknown
    user cases on the port's own model."""
    algo, model = trained
    r = algo.predict(model, {"user": "u0", "num": 6})
    assert len(r["itemScores"]) == 6
    hits = [sum(1 for s in algo.predict(model, {"user": f"u{u}", "num": 6})[
        "itemScores"] if int(s["item"][1:]) % 2 == u % 2) for u in range(16)]
    assert float(np.mean(hits)) >= 4.5
    assert algo.predict(model, {"user": "nope", "num": 3}) == {
        "itemScores": []}
    r = algo.predict(model, {"user": "u0", "num": 4, "blackList": ["i0"]})
    assert all(s["item"] != "i0" for s in r["itemScores"])
    assert model.item_embeddings.shape == (24, 8)


@pytest.mark.parametrize("b", [1, 2, 7, 16, 33, 64])
def test_batched_equals_solo_bit_for_bit(trained, b):
    algo, model = trained
    rng = np.random.default_rng(b)
    queries = [{"user": f"u{rng.integers(0, 44)}",
                "num": int(rng.integers(1, 12))}
               | ({"blackList": [f"i{j}" for j in rng.integers(0, 24, 3)]}
                  if r % 3 == 1 else {}) for r in range(b)]
    assert algo.batch_predict(model, queries) == [
        algo.predict(model, q) for q in queries]


def test_resumed_run_equals_uninterrupted_bit_for_bit(tmp_path):
    inter = _clustered(Interactions, EntityIdIndex)
    p = tt.TwoTowerParams(**{**PARITY, "steps": 21})
    want, want_emb, _, _ = tt.train_two_tower(inter, p, device="cpu")
    ck = StepCheckpointer(StepCheckpointConfig(str(tmp_path / "ck"),
                                               save_every=5))
    first = tt.TwoTowerParams(**{**PARITY, "steps": 12})
    _, _, _, losses = tt.train_two_tower(inter, first, device="cpu",
                                         checkpoint=ck)
    assert ck.latest_step() == 10 and len(losses) == 12
    got, got_emb, _, losses = tt.train_two_tower(inter, p, device="cpu",
                                                 checkpoint=ck)
    assert len(losses) == 10              # steps 11 .. 20
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(got_emb, want_emb)


def _engine_dir(tmp_path, name, app, **algo):
    d = tmp_path / name
    verbs.copy_example("twotower", d, FACTORY, **algo)
    variant = json.loads((d / "engine.json").read_text())
    variant["datasource"]["params"]["app_name"] = app
    variant["id"] = name
    (d / "engine.json").write_text(json.dumps(variant))
    return d


@pytest.fixture
def tt_store(tmp_path, monkeypatch):
    storage = Storage(env=verbs.sqlite_env(tmp_path / "pio.db"))
    _seed_events(storage, app_name="ttapp", n_users=30, n_items=20,
                 n_events=400, kinds=("view", "buy", "rate"))
    monkeypatch.setenv("PIO_TPU_CKPT_ROOT", str(tmp_path / "ckpt"))
    yield storage
    storage.close()


SMALL_VERB = dict(embed_dim=8, hidden_dim=16, out_dim=8, steps=12,
                  batch_size=64, checkpoint_every=5)


def test_train_verb_then_deploy(tt_store, tmp_path, monkeypatch):
    """The committed engine.json (the port's factory, fewer steps) through
    the train verb, then its instance over HTTP: every body equals the
    in-process answer."""
    d = _engine_dir(tmp_path, "twotower", "ttapp", **SMALL_VERB)
    assert verbs.train_in_process(d, tt_store, monkeypatch, tmp_path) == 0
    with verbs.deployed(d, tt_store, "twotower") as (port, qs):
        assert isinstance(qs.models[0].item_embeddings, torch.Tensor)
        queries = [{"user": "u1", "num": 3},
                   {"user": "u2", "num": 5, "blackList": ["i3"]},
                   {"user": "nobody", "num": 2}, {"user": "u4", "num": 20}]
        bodies = verbs.served_as_in_process(port, qs, queries)
        assert bodies[0]["itemScores"] and bodies[2] == {"itemScores": []}
        assert verbs.batchpredict(d, tt_store, monkeypatch, queries,
                                  tmp_path) == bodies


def test_chaos_kill_then_resume_through_the_verb(tt_store, tmp_path,
                                                 monkeypatch):
    """A run killed at step 8 by a chaos fault (FAILED, steps 0 and 5 on
    disk) resumed with --resume gives the uninterrupted run's params."""
    from pio_tpu_torch.__main__ import main

    monkeypatch.setattr("pio_tpu_torch.__main__.get_storage",
                        lambda: tt_store)
    d = _engine_dir(tmp_path, "twotower", "ttapp", **SMALL_VERB)
    cmd = ["train", "--engine-dir", str(d), "--device", "cpu"]
    assert main(cmd) == 0
    [done] = tt_store.get_metadata_engine_instances().get_all()
    with chaos.inject("train.step.8", error=1.0):
        with pytest.raises(chaos.ChaosError):
            main(cmd)
    [failed] = [i for i in tt_store.get_metadata_engine_instances().get_all()
                if i.status == "FAILED"]
    assert sorted(os.listdir(failed.progress["checkpoint_dir"]),
                  key=int) == ["0", "5"]
    assert main(cmd + ["--resume", failed.id]) == 0
    engine = tt.TwoTowerEngine.apply()
    ep = engine.engine_params_from_variant(
        json.loads((d / "engine.json").read_text()))
    ctx = _ctx(tt_store)
    [want] = load_models(tt_store, engine, ep, done.id, ctx)
    [got] = load_models(tt_store, engine, ep, failed.id, ctx)
    for k in want.params:
        assert torch.equal(got.params[k], want.params[k]), k
    assert torch.equal(got.item_embeddings, want.item_embeddings)


def _candidates(app_name="ttapp"):
    """tests/test_tuning.py's two-tower grid."""
    ds = tt.TwoTowerDataSourceParams(app_name=app_name, eval_k=2)
    return [EngineParams(
        datasource=("", ds),
        algorithms=[("twotower", tt.TwoTowerParams(
            embed_dim=8, hidden_dim=16, out_dim=8, steps=30, batch_size=64,
            learning_rate=lr, temperature=0.1))])
        for lr in (5e-3, 1e-2)]


def test_sequential_sweep_and_from_eval_deploy(tt_store):
    """The two-tower grid sweeps through the sequential fallback, the
    winner persists, --from-eval rebuilds its typed params, and the tuned
    engine trains and serves."""
    ctx = _ctx(tt_store)
    engine = tt.TwoTowerEngine.apply()
    cands = _candidates()
    _, batchable = group_candidates(cands)
    assert not batchable
    eval_id, result = run_sweep_evaluation(
        engine, cands, tt_store,
        SweepConfig(metric=parse_metric("precision@5"), folds=2),
        engine_id="tt-e", ctx=ctx)
    assert set(load_sweep_state(tt_store, eval_id).completed) == {
        "cand0", "cand1"}
    tuned_ep, got_id = _apply_from_eval(engine, cands[0], tt_store, eval_id)
    assert got_id == eval_id
    tuned = tuned_ep.algorithms[0][1]
    assert isinstance(tuned, tt.TwoTowerParams)
    assert tuned.learning_rate == \
        result.best_engine_params.algorithms[0][1].learning_rate
    run_train(engine, tuned_ep, tt_store, engine_id="tt-e", ctx=ctx,
              batch=f"from-eval:{eval_id}")
    http, qs = create_query_server(
        engine, tuned_ep, tt_store,
        ServingConfig(ip="127.0.0.1", port=0, engine_id="tt-e"), ctx=ctx)
    http.start()
    try:
        _, body = verbs.post(http.port, {"user": "u1", "num": 3})
        assert body["itemScores"] and len(body["itemScores"]) <= 3
    finally:
        http.stop()
        qs.close()


def test_sequential_fallback_rejects_auc_primary(tt_store):
    with pytest.raises(ValueError, match="full score rows"):
        run_sweep_evaluation(
            tt.TwoTowerEngine.apply(), _candidates(), tt_store,
            SweepConfig(metric=parse_metric("auc"), folds=2),
            ctx=_ctx(tt_store))


def test_fold_in_and_fleet_refuse_a_two_tower_model(tt_store, trained):
    from pio_tpu_torch.serving_fleet.fleet import resolve_fleet_model
    from pio_tpu_torch.workflow.train import persist_models

    _, model = trained
    ep = EngineParams(
        datasource=("", tt.TwoTowerDataSourceParams(app_name="ttapp")),
        algorithms=[("twotower", tt.TwoTowerParams(**SMALL))])
    iid = persist_models([model], ep, tt_store, engine_id="tt-foldin")
    with pytest.raises(ValueError, match="factor-table model"):
        resolve_fleet_model(tt_store, "tt-foldin", instance_id=iid,
                            device="cpu")


def test_train_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tt.TwoTowerAlgorithm(tt.TwoTowerParams(**PARITY)).train(
            None, _clustered(Interactions, EntityIdIndex))
