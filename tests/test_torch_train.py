"""The port's training slice end to end, against the JAX package.

Events are written to one sqlite database; both packages read them into
interactions, which must be equal exactly. ``python -m pio_tpu_torch
train --device cpu`` then trains the recommendation engine and stores a
COMPLETED instance whose factors match the JAX package's ``als_train``
import _torch_cpu  # noqa: F401  (one CPU thread: see the module)
from the same initial factors, and ``python -m pio_tpu_torch deploy
--device cpu`` serves it. Without CUDA and without ``--device cpu`` the
train verb raises.
"""

import json
import os
import subprocess
import sys
import urllib.request
from datetime import datetime, timedelta, timezone

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pio_tpu.data.eventstore import EventStore as RefEventStore
from pio_tpu.data.storage import Storage as RefStorage
from pio_tpu.ops import als as ref_als
from pio_tpu_torch.__main__ import main as port_main
from pio_tpu_torch.data.dao import App
from pio_tpu_torch.data.event import Event
from pio_tpu_torch.data.eventstore import EventStore
from pio_tpu_torch.data.storage import Storage
from pio_tpu_torch.models import recommendation as port_rec
from pio_tpu_torch.ops import als as port_als
from pio_tpu_torch.workflow.context import create_workflow_context
from pio_tpu_torch.workflow.train import load_models

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FACTORY = "pio_tpu_torch.models.recommendation.RecommendationEngine"
APP = "MyApp"
N_USERS, N_ITEMS, RANK = 40, 30, 6
ALGO = {"rank": RANK, "num_iterations": 3, "lambda_": 0.05, "alpha": 4.0,
        "implicit_prefs": True, "seed": 7, "chunk": 512,
        "cg_warm_iters": -1}
# factors after 3 sweeps from the same init (see test_torch_als_train.py)
RTOL_TRAIN = 2e-3


def _storage_env(tmp_path):
    return {
        "PIO_STORAGE_SOURCES_SQL_TYPE": "sqlite",
        "PIO_STORAGE_SOURCES_SQL_PATH": str(tmp_path / "pio.db"),
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "SQL",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "SQL",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "SQL",
    }


def _write_events(storage, seed=0, n=900):
    """rate events with a rating, buy events without, a few `view`
    events the data source must skip, and re-rated pairs (the later
    rating wins); every event at its own time, so both packages see one
    order."""
    app_id = storage.get_metadata_apps().insert(App(0, APP))
    events = storage.get_events()
    events.init(app_id)
    rng = np.random.default_rng(seed)
    t0 = datetime(2024, 1, 1, tzinfo=timezone.utc)
    batch = []
    for n_ev in range(n):
        u = int(rng.integers(0, N_USERS))
        i = int(rng.integers(0, N_ITEMS))
        kind = rng.choice(["rate", "buy", "view"], p=[0.6, 0.3, 0.1])
        props = {"rating": float(rng.integers(1, 6))} if kind == "rate" \
            else {}
        batch.append(Event(
            event=str(kind), entity_type="user", entity_id=f"u{u}",
            target_entity_type="item", target_entity_id=f"i{i}",
            properties=props, event_time=t0 + timedelta(seconds=n_ev)))
    events.insert_batch(batch, app_id)
    return app_id


def _variant(**algo):
    return {"id": "rec", "engineFactory": FACTORY,
            "datasource": {"params": {"app_name": APP}},
            "algorithms": [{"name": "als", "params": {**ALGO, **algo}}]}


def _engine_dir(tmp_path, variant):
    d = tmp_path / "engine"
    d.mkdir(exist_ok=True)
    (d / "engine.json").write_text(json.dumps(variant))
    return d


def _read_kwargs():
    return dict(app_name=APP, entity_type="user", target_entity_type="item",
                event_names=["rate", "buy"], value_key="rating",
                default_value=4.0, value_event="rate", dedup="last")


def test_interactions_equal_the_reference_on_one_db(tmp_path):
    env = _storage_env(tmp_path)
    storage = Storage(env=env)
    ref_storage = RefStorage(env=env)
    try:
        _write_events(storage)
        got = EventStore(storage).interactions(**_read_kwargs())
        want = RefEventStore(ref_storage).interactions(**_read_kwargs())
        assert got.users.ids() == want.users.ids()
        assert got.items.ids() == want.items.ids()
        for name in ("user_idx", "item_idx", "values"):
            g, w = getattr(got, name), getattr(want, name)
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        assert len(got) < 900     # views skipped, re-rated pairs deduped
    finally:
        storage.close()
        ref_storage.close()


def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/queries.json",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.status, json.loads(r.read())


def test_train_then_deploy_on_cpu(tmp_path, monkeypatch):
    """`train --device cpu` stores a COMPLETED instance whose factors are
    the JAX package's from the same init; `deploy --device cpu`, a real
    process, answers with the trained model's top-k."""
    env = _storage_env(tmp_path)
    storage = Storage(env=env)
    _write_events(storage)
    engine_dir = _engine_dir(tmp_path, _variant())
    monkeypatch.setattr("pio_tpu_torch.__main__.get_storage",
                        lambda: storage)
    try:
        assert port_main(["train", "--engine-dir", str(engine_dir),
                          "--device", "cpu"]) == 0
        inst = storage.get_metadata_engine_instances() \
            .get_latest_completed("rec", "1", "default")
        assert inst is not None and inst.status == "COMPLETED"
        engine = port_rec.RecommendationEngine.apply()
        ep = engine.engine_params_from_variant(_variant())
        model = load_models(storage, engine, ep, inst.id,
                            create_workflow_context(storage, device="cpu"))[0]
        data = EventStore(storage).interactions(**_read_kwargs())
    finally:
        storage.close()

    # the port's seeded init, handed to the JAX package's trainer
    algo = port_rec.ALSAlgorithm(port_rec.ALSAlgorithmParams(**ALGO))
    p = algo._als_params()
    u0, i0 = port_als._init_or(None, data.n_users, data.n_items, p,
                               torch.device("cpu"))
    ref_p = ref_als.ALSParams(**{f: getattr(p, f)
                                 for f in p.__dataclass_fields__})
    want = ref_als.als_train(
        data.user_idx, data.item_idx, data.values, data.n_users,
        data.n_items, ref_p,
        init=ref_als.ALSModel(jnp.asarray(u0.numpy()),
                              jnp.asarray(i0.numpy())))
    assert model.users.ids() == data.users.ids()
    for got_f, want_f in ((model.factors.user_factors, want.user_factors),
                          (model.factors.item_factors, want.item_factors)):
        w = np.asarray(want_f)
        np.testing.assert_allclose(got_f.numpy(), w, rtol=0,
                                   atol=RTOL_TRAIN * np.abs(w).max())

    proc = subprocess.Popen(
        [sys.executable, "-m", "pio_tpu_torch", "deploy", "--engine-dir",
         str(engine_dir), "--device", "cpu", "--port", "0",
         "--ip", "127.0.0.1"],
        cwd=REPO, env={**os.environ, **env}, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert f"Engine instance {inst.id} deployed" in line, (
            line + proc.stderr.read() if proc.poll() is not None else line)
        port = int(line.split("127.0.0.1:")[1].split()[0])
        for user in ("u0", "u3", data.users.ids()[-1]):
            status, body = _post(port, {"user": user, "num": 4})
            assert status == 200
            _, idx = port_als.recommend_topk(
                model.factors, [model.users.index_of(user)], 4)
            assert [s["item"] for s in body["itemScores"]] == \
                list(model.items.decode(idx[0].numpy()))
    finally:
        proc.terminate()
        try:
            proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()


@pytest.mark.parametrize("variant, error", [
    # a part not ported yet (the sequence template's ring attention,
    # which needs a mesh with a sequence axis)
    ({"id": "rec", "engineFactory":
      "pio_tpu_torch.models.sequence.SequenceEngine",
      "datasource": {"params": {"app_name": APP}},
      "algorithms": [{"name": "sasrec", "params": {
          "max_len": 8, "embed_dim": 8, "num_heads": 2, "num_layers": 1,
          "ffn_dim": 8, "steps": 2, "attention": "ring"}}]},
     ValueError),
    ({**_variant(), "datasource": {"params": {"app_name": "NoSuchApp"}}},
     RuntimeError),
])
def test_failed_training_marks_instance_failed(tmp_path, monkeypatch,
                                               variant, error):
    monkeypatch.setenv("PIO_TPU_CKPT_ROOT", str(tmp_path / "ckpt"))
    storage = Storage(env=_storage_env(tmp_path))
    _write_events(storage, n=200)
    monkeypatch.setattr("pio_tpu_torch.__main__.get_storage",
                        lambda: storage)
    try:
        with pytest.raises(error):
            port_main(["train", "--engine-dir",
                       str(_engine_dir(tmp_path, variant)), "--device",
                       "cpu"])
        [inst] = storage.get_metadata_engine_instances().get_all()
        assert inst.status == "FAILED"
        assert storage.get_model_data_models().get(inst.id) is None
    finally:
        storage.close()


def test_train_without_cuda_raises(tmp_path, monkeypatch):
    """No card and no --device cpu: refuse rather than train on the
    CPU, before any instance is recorded."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    storage = Storage(env=_storage_env(tmp_path))
    _write_events(storage, n=100)
    monkeypatch.setattr("pio_tpu_torch.__main__.get_storage",
                        lambda: storage)
    try:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port_main(["train", "--engine-dir",
                       str(_engine_dir(tmp_path, _variant()))])
        assert storage.get_metadata_engine_instances().get_all() == []
    finally:
        storage.close()
