"""The port's recommendation deploy/query path against the JAX package.

The same seeded factors are carried into both packages (``convert.py``
takes the JAX model's fields after ``host_copy``). ``ALSAlgorithm``
predict/batch_predict, in exact and clustered mode, must give the JAX
package's item ids with blackList, whiteList and unknown users; the
port's server must answer ``/queries.json`` and ``/batch/queries.json``
with the same ids over HTTP; ``python -m pio_tpu_torch deploy`` must
serve; a corrupt blob must be refused; and without CUDA the entry
points must raise unless the CPU is asked for.
"""

import _torch_cpu  # noqa: F401  (one CPU thread: see the module)
import json
import os
import subprocess
import sys
import time
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_retrieval import mixture_rows

from pio_tpu.data.bimap import EntityIdIndex as RefIdIndex
from pio_tpu.models import recommendation as ref_rec
from pio_tpu.ops import als as ref_als
from pio_tpu.workflow.checkpoint import host_copy as ref_host_copy
from pio_tpu_torch.__main__ import main as port_main
from pio_tpu_torch.convert import recommendation_model_from_numpy
from pio_tpu_torch.data.dao import Model
from pio_tpu_torch.data.storage import Storage
from pio_tpu_torch.models import recommendation as port_rec
from pio_tpu_torch.utils.durable import ModelIntegrityError
from pio_tpu_torch.workflow.checkpoint import models_from_bytes, models_to_bytes
from pio_tpu_torch.workflow.context import create_workflow_context
from pio_tpu_torch.workflow.serve import (
    QueryServer,
    ServingConfig,
    create_query_server,
)
from pio_tpu_torch.workflow.train import persist_models

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_USERS, N_ITEMS, RANK = 40, 600, 16
# exact scores: the same f32 dot summed in another order
RTOL = 1e-5
ATOL = 1e-5
FACTORY = "pio_tpu_torch.models.recommendation.RecommendationEngine"
CLUSTERED = {"mode": "clustered", "dtype": "int8", "nprobe": 8,
             "impl": "pallas"}

QUERIES = [
    {"user": "u0", "num": 5},
    {"user": "u1"},
    {"user": "u2", "num": 7, "blackList": ["i3", "i10", "i11", "i12"]},
    {"user": "u3", "num": 4,
     "whiteList": ["i1", "i2", "i9", "i40", "nope", "i300"]},
    {"user": "u4", "num": 2, "whiteList": ["i1", "i2", "i9"],
     "blackList": ["i2"]},
    {"user": "u5", "num": 3, "whiteList": ["nope"]},
    {"user": "ghost", "num": 5},
    {"user": "u6", "num": 25},
]


@pytest.fixture(scope="module")
def factors():
    rng = np.random.default_rng(11)
    uf = rng.standard_normal((N_USERS, RANK)).astype(np.float32)
    itf = mixture_rows(N_ITEMS, RANK, 24, rng)
    users = [f"u{i}" for i in range(N_USERS)]
    items = [f"i{i}" for i in range(N_ITEMS)]
    ref_model = ref_rec.RecommendationModel(
        ref_als.ALSModel(jnp.asarray(uf), jnp.asarray(itf)),
        RefIdIndex(users), RefIdIndex(items))
    return ref_model


def _carry(ref_model, device="cpu"):
    h = ref_host_copy(ref_model)
    return recommendation_model_from_numpy(
        h.factors.user_factors, h.factors.item_factors, h.users.ids(),
        h.items.ids(), device=device)


def _ids(result):
    return [s["item"] for s in result["itemScores"]]


def _assert_same(got, want):
    assert _ids(got) == _ids(want)
    np.testing.assert_allclose(
        [s["score"] for s in got["itemScores"]],
        [s["score"] for s in want["itemScores"]], rtol=RTOL, atol=ATOL)


def _algos(retrieval):
    return (ref_rec.ALSAlgorithm(ref_rec.ALSAlgorithmParams(
                retrieval=retrieval)),
            port_rec.ALSAlgorithm(port_rec.ALSAlgorithmParams(
                retrieval=retrieval)))


RETRIEVALS = [
    None,
    {"mode": "clustered", "dtype": "int8", "nprobe": 8, "impl": "pallas"},
    {"mode": "clustered", "dtype": "bf16", "nprobe": 8, "impl": "xla"},
    # exhaustive knobs take the exact branch in both packages
    {"mode": "clustered", "dtype": "int8", "nprobe": 64},
]


@pytest.mark.parametrize("retrieval", RETRIEVALS)
def test_predict_and_batch_predict_match_reference(factors, retrieval):
    a_ref, a_port = _algos(retrieval)
    m_port = _carry(factors)
    for q in QUERIES:
        _assert_same(a_port.predict(m_port, q), a_ref.predict(factors, q))
    got = a_port.batch_predict(m_port, QUERIES)
    want = a_ref.batch_predict(factors, QUERIES)
    assert len(got) == len(want) == len(QUERIES)
    for g, w in zip(got, want):
        _assert_same(g, w)


def test_retrieval_index_cached_by_item_table(factors):
    _, a_port = _algos(CLUSTERED)
    m_port = _carry(factors)
    pair = a_port._retrieval_index(m_port)
    assert a_port._retrieval_index(m_port) is pair
    m_port.factors.item_factors = m_port.factors.item_factors.clone()
    assert a_port._retrieval_index(m_port) is not pair


def test_training_waits_for_its_slice():
    """Training and evaluation folds are ported: read_eval gives eval_k
    index-mod-k folds of the training read (none at eval_k 0; the fold
    contents are held to the reference in test_torch_evaluation.py).
    Validated training, as the reference's, refuses fewer than 10
    interactions."""
    import types

    from pio_tpu_torch.data.eventstore import to_interactions
    from pio_tpu_torch.data.event import Event

    data = to_interactions([Event("rate", "user", f"u{j % 3}", "item",
                                  f"i{j}", {"rating": 3.0})
                            for j in range(12)])
    ctx = types.SimpleNamespace(event_store=types.SimpleNamespace(
        interactions=lambda **kw: data))
    ds = port_rec.RecommendationDataSource(port_rec.DataSourceParams())
    assert ds.read_eval(ctx) == []
    ds = port_rec.RecommendationDataSource(
        port_rec.DataSourceParams(eval_k=3))
    folds = ds.read_eval(ctx)
    assert [info.fold for _, info, _ in folds] == [0, 1, 2]
    assert sum(len(train) for train, _, _ in folds) == 2 * len(data)
    data = to_interactions([Event("rate", "user", f"u{j}", "item", "i0",
                                  {"rating": 3.0}) for j in range(9)])
    algo = port_rec.ALSAlgorithm(port_rec.ALSAlgorithmParams(
        validation_fraction=0.1))
    with pytest.raises(ValueError, match=">=10 interactions"):
        algo.train(types.SimpleNamespace(device=torch.device("cpu")), data)


def _storage_env(tmp_path):
    return {
        "PIO_STORAGE_SOURCES_SQL_TYPE": "sqlite",
        "PIO_STORAGE_SOURCES_SQL_PATH": str(tmp_path / "pio.db"),
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "SQL",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "SQL",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "SQL",
    }


def _variant(retrieval):
    algo = {"name": "als", "params": {"rank": RANK}}
    if retrieval is not None:
        algo["params"]["retrieval"] = retrieval
    return {"id": "rec", "engineFactory": FACTORY, "algorithms": [algo]}


def _persist(storage, ref_model, retrieval):
    engine = port_rec.RecommendationEngine.apply()
    ep = engine.engine_params_from_variant(_variant(retrieval))
    iid = persist_models([_carry(ref_model)], ep, storage, "rec",
                         engine_factory=FACTORY)
    return engine, ep, iid


def _post(port, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.mark.parametrize("retrieval", [None, CLUSTERED])
def test_server_answers_with_reference_ids(tmp_path, factors, retrieval):
    storage = Storage(env=_storage_env(tmp_path))
    engine, ep, iid = _persist(storage, factors, retrieval)
    ctx = create_workflow_context(storage, device="cpu")
    http, qs = create_query_server(
        engine, ep, storage,
        ServingConfig(ip="127.0.0.1", port=0, engine_id="rec"), ctx=ctx)
    http.start()
    a_ref, _ = _algos(retrieval)
    try:
        assert qs.instance.id == iid
        for q in QUERIES:
            status, body = _post(http.port, "/queries.json", q)
            assert status == 200
            _assert_same(body, a_ref.predict(factors, q))
        status, body = _post(http.port, "/batch/queries.json", QUERIES)
        assert status == 200 and len(body) == len(QUERIES)
        for got, want in zip(body, a_ref.batch_predict(factors, QUERIES)):
            _assert_same(got, want)
        assert _post(http.port, "/batch/queries.json", []) == (200, [])
        assert _post(http.port, "/queries.json", {"num": 3})[0] == 400
        assert _post(http.port, "/queries.json", [1, 2])[0] == 400
        assert _post(http.port, "/batch/queries.json", {"user": "u0"})[0] \
            == 400
        with urllib.request.urlopen(
                f"http://127.0.0.1:{http.port}/", timeout=30) as r:
            status = json.loads(r.read())
        assert status["engineInstance"]["id"] == iid
        # every query counts, a batch's too (the reference's "query"
        # span is recorded once a query)
        assert status["requestCount"] == 2 * len(QUERIES)
        assert status["device"] == "cpu"
    finally:
        http.stop()
        qs.close()
        storage.close()


def test_models_from_bytes_rejects_flipped_byte(factors):
    blob = models_to_bytes([_carry(factors)])
    back = models_from_bytes(blob)[0]
    np.testing.assert_array_equal(back.factors.user_factors,
                                  np.asarray(factors.factors.user_factors))
    for pos in (len(blob) // 2, len(blob) - 1):
        bad = bytearray(blob)
        bad[pos] ^= 0x10
        with pytest.raises(ModelIntegrityError):
            models_from_bytes(bytes(bad))


def test_load_falls_back_past_corrupt_blob(tmp_path, factors):
    storage = Storage(env=_storage_env(tmp_path))
    try:
        engine, ep, good = _persist(storage, factors, None)
        time.sleep(0.01)   # instances order by start time
        _, _, latest = _persist(storage, factors, None)
        blob = storage.get_model_data_models().get(latest).models
        storage.get_model_data_models().insert(
            Model(latest, blob[:-1] + bytes([blob[-1] ^ 1])))
        ctx = create_workflow_context(storage, device="cpu")
        config = ServingConfig(port=0, engine_id="rec")
        qs = QueryServer(engine, ep, storage, config, ctx=ctx)
        assert qs.instance.id == good
        with pytest.raises(ModelIntegrityError):   # a pinned id never falls back
            QueryServer(engine, ep, storage, config, ctx=ctx,
                        instance_id=latest)
    finally:
        storage.close()


def test_deploy_verb_serves_a_query(tmp_path, factors):
    """`python -m pio_tpu_torch deploy --device cpu --port 0` as a real
    process answers /queries.json like the JAX package."""
    env = _storage_env(tmp_path)
    storage = Storage(env=env)
    _persist(storage, factors, CLUSTERED)
    storage.close()
    engine_dir = tmp_path / "engine"
    engine_dir.mkdir()
    (engine_dir / "engine.json").write_text(json.dumps(_variant(CLUSTERED)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "pio_tpu_torch", "deploy", "--engine-dir",
         str(engine_dir), "--device", "cpu", "--port", "0",
         "--ip", "127.0.0.1"],
        cwd=REPO, env={**os.environ, **env}, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert "deployed on http://127.0.0.1:" in line, (
            line + proc.stderr.read() if proc.poll() is not None else line)
        port = int(line.split("127.0.0.1:")[1].split()[0])
        q = QUERIES[2]
        status, body = _post(port, "/queries.json", q)
        assert status == 200
        a_ref, _ = _algos(CLUSTERED)
        _assert_same(body, a_ref.predict(factors, q))
    finally:
        proc.terminate()
        try:
            proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
    assert proc.returncode is not None


def test_entry_points_raise_without_cuda(tmp_path, monkeypatch, factors):
    """No card and no request for the CPU: refuse rather than serve on
    the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    storage = Storage(env=_storage_env(tmp_path))
    try:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            create_workflow_context(storage)
        engine, ep, _ = _persist(storage, factors, None)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            QueryServer(engine, ep, storage,
                        ServingConfig(port=0, engine_id="rec"))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            _carry(factors, device=None)
    finally:
        storage.close()
    engine_dir = tmp_path / "engine"
    engine_dir.mkdir()
    (engine_dir / "engine.json").write_text(json.dumps(_variant(None)))
    for k, v in _storage_env(tmp_path).items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr("pio_tpu_torch.__main__.get_storage",
                        lambda: Storage(env=_storage_env(tmp_path)))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_main(["deploy", "--engine-dir", str(engine_dir), "--port", "0"])
