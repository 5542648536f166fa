"""The port's sharded ALS (``ops/als.als_train_sharded``) across ranks on
the CPU, against ``pio_tpu.ops.als.als_train_sharded``.

The port's ranks are processes joined over gloo
(``tests/_torch_sharded_worker.py``, one a rank); the reference shards
over a mesh of the 8 virtual CPU devices that tests/conftest.py gives
JAX. Both start from the reference's init, drawn from
``init_factors`` on ``jax.random.split(PRNGKey(seed))`` and handed to the
port through ``init=``. Cases: explicit and implicit ratings, row counts
that do not divide by the ranks, and the warm-CG schedule (the
counterparts of tests/test_als.py's and tests/test_als_pallas.py's
sharded tests), each in every accumulation mode the port runs on the CPU
(whose kernels run their plain versions here), against the reference's
carry. Every rank must return the same bits. Then the recommendation
template on a two-rank context, and ``python -m pio_tpu_torch train
--device cpu`` as two processes on one sqlite store.
"""

import _torch_cpu  # noqa: F401  (one CPU thread: see the module)
import json
import os

import jax
import numpy as np
import pytest
import torch

from _torch_dist import REPO, TESTS, run_ranks
from pio_tpu.ops import als as ref
from pio_tpu.parallel.mesh import MeshConfig, create_mesh as ref_mesh
from pio_tpu_torch.ops import als as port
from pio_tpu_torch.parallel import create_mesh

# factors after a few sweeps from the same init, relative to the largest
# magnitude (tests/test_torch_als_train.py's RTOL_TRAIN)
RTOL_TRAIN = 2e-3

# f32 gathers, as tests/test_torch_als_train.py's parity cases: with the
# default bf16 gather, f32 noise between the packages flips the rounding
# of some gathered factors, and after 5 sweeps the two trainers' factors
# part by up to 7e-3 (the reference's own single-device and sharded
# trainers by as much; predictions stay close)
BASE = dict(rank=8, reg=0.1, chunk=256, width=8, chunk_slots=64,
            bf16_gather=False)
CASES = {
    # tests/test_als.py:124 — explicit ratings, divisible row counts
    "explicit": dict(n_users=64, n_items=40, nnz=900, seed=0,
                     params=dict(BASE, iterations=4)),
    # tests/test_als.py:137 — implicit, rows not divisible by 2 or 4: the
    # phantom rows must stay out of the shared YᵀY
    "implicit_ragged": dict(n_users=63, n_items=29, nnz=800, seed=4,
                            params=dict(BASE, iterations=4, implicit=True,
                                        alpha=5.0)),
    # tests/test_als.py:331 — the two-phase warm-CG schedule, its
    # reference's iteration counts
    "warm_cg": dict(n_users=64, n_items=48, nnz=1100, seed=2,
                    params=dict(BASE, iterations=5, reg=0.05, cg_iters=12,
                                cg_warm_iters=6, cg_warm_sweeps=2)),
}
# the accumulation modes the port runs on the CPU; tests/test_als_pallas.py
# :147 (pallas, hybrid) and :465 (the streaming configuration)
ACCUMS = {
    "carry": {"accum": "carry"},
    "stacked": {"accum": "stacked"},
    "hybrid": {"accum": "hybrid"},
    "pallas": {"accum": "pallas"},
    "stream": {"accum": "stream", "gather": "stream", "packed_a": True},
}
# the recommendation template's case: its ALS params as the template
# derives them (seed 11, chunk 256) from these engine params
TEMPLATE = {"rank": 8, "num_iterations": 3, "lambda_": 0.05, "alpha": 4.0,
            "implicit_prefs": True, "seed": 11, "chunk": 256}
TEMPLATE_ALS = dict(rank=8, iterations=3, reg=0.05, alpha=4.0,
                    implicit=True, seed=11, chunk=256)


def _coo(n_users, n_items, nnz, seed):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n_users, nnz).astype(np.int32)
    i = rng.integers(0, n_items, nnz).astype(np.int32)
    v = rng.integers(1, 6, nnz).astype(np.float32)
    return u, i, v


def _ref_init(n_users, n_items, params):
    ku, ki = jax.random.split(jax.random.PRNGKey(params.get("seed", 3)))
    rank = params["rank"]
    return (np.asarray(ref.init_factors(n_users, rank, ku)),
            np.asarray(ref.init_factors(n_items, rank, ki)))


def _run_world(tmp_path, world: int) -> list:
    """Every case in every mode on ``world`` gloo ranks -> each rank's
    factors, by rank."""
    arrays, cases = {}, []
    for name, c in CASES.items():
        u, i, v = _coo(c["n_users"], c["n_items"], c["nnz"], c["seed"])
        users0, items0 = _ref_init(c["n_users"], c["n_items"], c["params"])
        arrays |= {f"{name}/u": u, f"{name}/i": i, f"{name}/v": v,
                   f"{name}/users0": users0, f"{name}/items0": items0}
        cases.append({"name": name, "n_users": c["n_users"],
                      "n_items": c["n_items"], "init": True,
                      "params": c["params"],
                      "accums": [{"name": a, "params": p}
                                 for a, p in ACCUMS.items()]})
    if world == 2:
        u, i, v = _coo(50, 30, 600, 9)
        arrays |= {"template/u": u, "template/i": i, "template/v": v}
        cases.append({"name": "template", "n_users": 50, "n_items": 30,
                      "init": False, "params": TEMPLATE_ALS,
                      "accums": [{"name": "auto", "params": {}}],
                      "template": TEMPLATE})
    d = tmp_path / f"world{world}"
    d.mkdir()
    np.savez(d / "cases.npz", **arrays)
    (d / "cases.json").write_text(json.dumps(cases))
    outs = run_ranks(lambda r: [os.path.join(TESTS,
                                             "_torch_sharded_worker.py"),
                                str(d), str(d / f"rank{r}.npz")], world)
    for rc, _, err in outs:
        assert rc == 0, err[-3000:]
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded")
    return {w: _run_world(tmp, w) for w in (2, 4)}


@pytest.fixture(scope="module")
def reference():
    """The reference's sharded trainer (carry) on 2 and 4 of the CPU
    devices, each case from its own init draw."""
    out = {}
    for w in (2, 4):
        mesh = ref_mesh(MeshConfig(data=w))
        for name, c in CASES.items():
            u, i, v = _coo(c["n_users"], c["n_items"], c["nnz"], c["seed"])
            m = ref.als_train_sharded(
                u, i, v, c["n_users"], c["n_items"],
                ref.ALSParams(**c["params"], accum="carry"), mesh)
            out[w, name] = (np.asarray(m.user_factors),
                            np.asarray(m.item_factors))
    return out


def _close(got, want, rtol):
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


@pytest.mark.parametrize("accum", list(ACCUMS))
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("world", [2, 4])
def test_sharded_matches_reference_sharded(worlds, reference, world, case,
                                           accum):
    got = worlds[world][0]
    want_u, want_i = reference[world, case]
    _close(got[f"{case}/{accum}/users"], want_u, RTOL_TRAIN)
    _close(got[f"{case}/{accum}/items"], want_i, RTOL_TRAIN)


@pytest.mark.parametrize("world", [2, 4])
def test_every_rank_returns_the_same_bits(worlds, world):
    ranks = worlds[world]
    assert [int(r["rank"]) for r in ranks] == list(range(world))
    assert {int(r["size"]) for r in ranks} == {world}
    assert {str(r["backend"]) for r in ranks} == {"gloo"}
    keys = [k for k in ranks[0] if "/" in k]
    assert len(keys) == 2 * len(CASES) * len(ACCUMS) + 4 * (world == 2)
    for other in ranks[1:]:
        for k in keys:
            np.testing.assert_array_equal(other[k], ranks[0][k], err_msg=k)


def test_template_takes_the_sharded_branch_on_two_ranks(worlds):
    """The worker makes als_train raise, so the template's factors can
    only come from its sharded branch: those of als_train_sharded with
    the ALS params the template derives, bit for bit."""
    got = worlds[2][0]
    for side in ("users", "items"):
        np.testing.assert_array_equal(got[f"template/template/{side}"],
                                      got[f"template/auto/{side}"])


@pytest.mark.parametrize("accum", list(ACCUMS))
@pytest.mark.parametrize("case", list(CASES))
def test_one_rank_is_als_train_bit_for_bit(case, accum):
    """At world size 1 the sharded trainer is als_train: the same layout,
    the same YᵀY product and no collective."""
    c = CASES[case]
    u, i, v = _coo(c["n_users"], c["n_items"], c["nnz"], c["seed"])
    p = port.ALSParams(**c["params"], **ACCUMS[accum])
    mesh = create_mesh(device="cpu")
    assert mesh.size == 1
    got = port.als_train_sharded(u, i, v, c["n_users"], c["n_items"], p,
                                 mesh)
    want = port.als_train(u, i, v, c["n_users"], c["n_items"], p,
                          device="cpu")
    assert torch.equal(got.user_factors, want.user_factors)
    assert torch.equal(got.item_factors, want.item_factors)


# -- the train verb on two processes ----------------------------------------

APP = "ShardApp"
FACTORY = "pio_tpu_torch.models.recommendation.RecommendationEngine"
VERB_ALGO = {"rank": 6, "num_iterations": 3, "lambda_": 0.05, "alpha": 4.0,
             "implicit_prefs": True, "seed": 7, "chunk": 512}
RUN_ID = "sharded-run-0001"


def _sqlite_env(d) -> dict:
    return {"PIO_STORAGE_SOURCES_SQL_TYPE": "sqlite",
            "PIO_STORAGE_SOURCES_SQL_PATH": str(d / "pio.db"),
            "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "SQL",
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "SQL",
            "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "SQL"}


def _seeded_store(d):
    """A sqlite store of rate and buy events of 64 users on 40 items, and
    an engine directory whose engine.json trains the recommendation
    template on it."""
    from datetime import datetime, timedelta, timezone

    from pio_tpu_torch.data.dao import App
    from pio_tpu_torch.data.event import Event
    from pio_tpu_torch.data.storage import Storage

    d.mkdir()
    storage = Storage(env=_sqlite_env(d))
    app_id = storage.get_metadata_apps().insert(App(0, APP))
    events = storage.get_events()
    events.init(app_id)
    rng = np.random.default_rng(5)
    t0 = datetime(2024, 1, 1, tzinfo=timezone.utc)
    batch = []
    for n in range(1_200):
        kind = "rate" if rng.random() < 0.7 else "buy"
        batch.append(Event(
            event=kind, entity_type="user",
            entity_id=f"u{int(rng.integers(0, 64))}",
            target_entity_type="item",
            target_entity_id=f"i{int(rng.integers(0, 40))}",
            properties={"rating": float(rng.integers(1, 6))}
            if kind == "rate" else {},
            event_time=t0 + timedelta(seconds=n)))
    events.insert_batch(batch, app_id)
    engine = d / "engine"
    engine.mkdir()
    (engine / "engine.json").write_text(json.dumps({
        "id": "rec", "engineFactory": FACTORY,
        "datasource": {"params": {"app_name": APP}},
        "algorithms": [{"name": "als", "params": VERB_ALGO}]}))
    return storage, engine


def _train_verb(d, engine, **env):
    return run_ranks(lambda r: ["-m", "pio_tpu_torch", "train",
                                "--engine-dir", str(engine), "--device",
                                "cpu"], 2,
                     env_of=lambda r: _sqlite_env(d) | env)


def test_train_verb_on_two_processes_leaves_one_instance(tmp_path):
    """Two `python -m pio_tpu_torch train --device cpu` processes with the
    PIO_TPU_* variables and one run id: process 0 alone writes the
    instance and its model, which holds the factors of als_train_sharded
    at world size 2 on the same read, bit for bit."""
    from pio_tpu_torch.models import recommendation as rec
    from pio_tpu_torch.workflow.context import create_workflow_context
    from pio_tpu_torch.workflow.train import load_models

    storage, engine = _seeded_store(tmp_path / "store")
    try:
        outs = _train_verb(tmp_path / "store", engine,
                           PIO_TPU_RUN_ID=RUN_ID)
        for r, (rc, out, err) in enumerate(outs):
            assert rc == 0, err[-3000:]
            assert f"Training on rank {r} of 2 (cpu, gloo)" in out
            assert f"Training completed. Engine instance: {RUN_ID}" in out
        instances = storage.get_metadata_engine_instances().get_all()
        assert [(i.id, i.status) for i in instances] == [
            (RUN_ID, "COMPLETED")]
        eng = rec.RecommendationEngine.apply()
        ep = eng.engine_params_from_variant(
            json.loads((engine / "engine.json").read_text()))
        ctx = create_workflow_context(storage, device="cpu")
        (model,) = load_models(storage, eng, ep, RUN_ID, ctx)
        data = rec.RecommendationDataSource(
            rec.DataSourceParams(app_name=APP)).read_training(ctx)
    finally:
        storage.close()

    # als_train_sharded at world size 2 on the read the verb made
    algo = rec.ALSAlgorithm(rec.ALSAlgorithmParams(**VERB_ALGO))
    p = algo._als_params()
    d = tmp_path / "direct"
    d.mkdir()
    np.savez(d / "cases.npz", **{"verb/u": data.user_idx,
                                 "verb/i": data.item_idx,
                                 "verb/v": data.values})
    (d / "cases.json").write_text(json.dumps([{
        "name": "verb", "n_users": data.n_users, "n_items": data.n_items,
        "init": False,
        "params": {f: getattr(p, f) for f in p.__dataclass_fields__},
        "accums": [{"name": "auto", "params": {}}]}]))
    outs = run_ranks(lambda r: [os.path.join(TESTS,
                                             "_torch_sharded_worker.py"),
                                str(d), str(d / f"rank{r}.npz")], 2)
    assert all(rc == 0 for rc, _, _ in outs), outs[0][2][-3000:]
    want = np.load(d / "rank0.npz")
    assert model.users.ids() == data.users.ids()
    np.testing.assert_array_equal(model.factors.user_factors.numpy(),
                                  want["verb/auto/users"])
    np.testing.assert_array_equal(model.factors.item_factors.numpy(),
                                  want["verb/auto/items"])


def test_non_primary_without_run_id_fails_with_the_reference_message(
        tmp_path, monkeypatch):
    from pio_tpu.controller.engine import EngineParams as RefParams
    from pio_tpu.workflow import train as ref_train

    monkeypatch.delenv("PIO_TPU_RUN_ID", raising=False)
    with pytest.raises(ValueError) as want:
        ref_train._resolve_instance(None, False, None, False, "rec", "1",
                                    "default", FACTORY, "", RefParams(),
                                    None)
    storage, engine = _seeded_store(tmp_path / "store")
    storage.close()
    (rc0, _, _), (rc1, _, err1) = _train_verb(tmp_path / "store", engine)
    assert rc1 != 0 and str(want.value) in err1
    assert rc0 != 0   # its peer left the group: the primary's run fails
