"""SimRank and the friend-recommendation template of the port against the
JAX package, on the CPU.

The recurrence's products take bf16 operands and accumulate in f32 in
both packages (the port's CPU path multiplies the bf16-rounded operands
in f32), so on the same seeded graphs the two S matrices agree to 1e-6
absolute: the same exact products summed in another order, where an
entry pushed across a bf16 rounding boundary would move by 2^-9 relative
(these inputs do not). Against the naive per-definition SimRank in f64
(``tests/test_simrank.py``'s) the tolerance is the reference's own, 2e-2
(bf16 operands). Node and forest-fire sampling are the reference's numpy
and give the same subgraph; pairwise and retrieval queries answer as the
reference's (scores to 1e-6, ids equal where neighbouring scores are more
than 1e-6 apart); the committed example trains through the verb from
another working directory, its relative ``graph_edgelist_path`` resolved
against ``--engine-dir``, and serves both query shapes over HTTP.
"""

import _torch_cpu  # noqa: F401  (one CPU thread: see the module)
from datetime import datetime, timedelta, timezone

import numpy as np
import pytest
import torch

from pio_tpu.data.bimap import EntityIdIndex as RefIndex
from pio_tpu.models import friendrecommendation as ref_fr
from pio_tpu.ops.simrank import simrank_scores as ref_simrank
from pio_tpu_torch.data.bimap import EntityIdIndex
from pio_tpu_torch.data.dao import App
from pio_tpu_torch.data.event import Event
from pio_tpu_torch.data.storage import Storage
from pio_tpu_torch.models import friendrecommendation as fr
from pio_tpu_torch.ops.simrank import (
    padded_nodes,
    simrank_device,
    simrank_scores,
    simrank_topk,
)
from pio_tpu_torch.workflow.context import create_workflow_context

import _torch_verbs as verbs

ATOL = 1e-6
NAIVE_ATOL = 2e-2
FACTORY = ("pio_tpu_torch.models.friendrecommendation."
           "FriendRecommendationEngine")


def _ctx(storage=None):
    return create_workflow_context(storage or Storage(env={
        "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM"}), device="cpu")


def _graph(n, e, seed):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    keep = src != dst
    return src[keep], dst[keep]


def naive_simrank(src, dst, n, decay, iterations):
    """Direct per-definition SimRank in float64 (tests/test_simrank.py)."""
    in_nbrs = [[] for _ in range(n)]
    for s, d in zip(src, dst):
        if s not in in_nbrs[d]:
            in_nbrs[d].append(s)
    S = np.eye(n)
    for _ in range(iterations):
        S2 = np.zeros_like(S)
        for a in range(n):
            for b in range(n):
                if a == b:
                    S2[a, b] = 1.0
                    continue
                Ia, Ib = in_nbrs[a], in_nbrs[b]
                if not Ia or not Ib:
                    continue
                acc = sum(S[i, j] for i in Ia for j in Ib)
                S2[a, b] = decay * acc / (len(Ia) * len(Ib))
        S = S2
    return S


@pytest.mark.parametrize("n, e, seed, decay, iterations", [
    (25, 80, 0, 0.8, 5), (130, 600, 1, 0.8, 5), (300, 2000, 2, 0.6, 3),
    (5, 6, 3, 0.8, 1)])
def test_simrank_matches_reference(n, e, seed, decay, iterations):
    src, dst = _graph(n, e, seed)
    got = simrank_scores(src, dst, n, decay, iterations, device="cpu")
    want = ref_simrank(src, dst, n, decay, iterations)
    assert got.shape == want.shape == (n, n) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_simrank_matches_naive_definition():
    src, dst = _graph(25, 80, 0)
    got = simrank_scores(src, dst, 25, decay=0.8, iterations=5, device="cpu")
    np.testing.assert_allclose(got, naive_simrank(src, dst, 25, 0.8, 5),
                               atol=NAIVE_ATOL)


def test_simrank_state_is_padded_and_bf16_accumulates_in_f32(monkeypatch):
    """The state is (n_pad, n_pad) f32 with n_pad a multiple of 128 (at
    least 128); every product's operands are bf16 and its result f32."""
    assert [padded_nodes(n) for n in (1, 128, 129, 300)] == [128, 128, 256,
                                                             384]
    from pio_tpu_torch.ops import simrank as mod

    seen = []
    real = mod.bf16_mm_f32

    def spy(a, b):
        out = real(a, b)
        seen.append((a.dtype, b.dtype, out.dtype, a.is_contiguous()))
        return out

    monkeypatch.setattr(mod, "bf16_mm_f32", spy)
    S = simrank_device(*_graph(130, 600, 1), 130, 0.8, 2, device="cpu")
    assert S.shape == (256, 256) and S.dtype == torch.float32
    assert seen == [(torch.bfloat16, torch.bfloat16, torch.float32, False),
                    (torch.bfloat16, torch.bfloat16, torch.float32,
                     True)] * 2
    assert torch.equal(S.diagonal(), torch.ones(256))


def test_simrank_reference_structure_cases():
    """tests/test_simrank.py's shared-in-neighbour, no-in-neighbour and
    top-k cases."""
    src, dst = np.array([2, 3, 4, 2, 3, 4]), np.array([0, 0, 0, 1, 1, 1])
    S = simrank_scores(src, dst, 5, decay=0.8, iterations=5, device="cpu")
    assert S[0, 1] == pytest.approx(0.8 / 3, abs=2e-2)
    assert S[0, 1] == pytest.approx(S[1, 0], abs=1e-3)
    assert S[0, 2] == pytest.approx(0.0, abs=1e-3)
    S = simrank_scores(np.array([0]), np.array([1]), 3, iterations=3,
                       device="cpu")
    assert S[1, 2] == 0.0 and S[0, 2] == 0.0 and S[0, 0] == 1.0
    S = simrank_scores(np.array([2, 3, 2, 3, 4]), np.array([0, 0, 1, 1, 1]),
                       5, iterations=4, device="cpu")
    _, idx = simrank_topk(S, 3)
    assert all(i not in idx[i] for i in range(5))
    assert simrank_scores([], [], 0, device="cpu").shape == (0, 0)


def test_simrank_needs_a_device():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        simrank_scores(np.array([0]), np.array([1]), 2)


@pytest.mark.parametrize("method", ["node", "forestfire"])
def test_sampling_as_reference(tmp_path, method):
    rng = np.random.default_rng(4)
    src, dst = rng.integers(0, 200, 1200), rng.integers(0, 200, 1200)
    if method == "node":
        got = fr.node_sample(src, dst, 200, 0.4, seed=7)
        want = ref_fr.node_sample(src, dst, 200, 0.4, seed=7)
    else:
        got = fr.forest_fire_sample(src, dst, 200, 0.3, 0.3, seed=3)
        want = ref_fr.forest_fire_sample(src, dst, 200, 0.3, 0.3, seed=3)
    assert len(got[0]) < len(src)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    path = tmp_path / "edges.txt"
    path.write_text("\n".join(f"{rng.integers(0, 500)} {rng.integers(0, 500)}"
                              for _ in range(2000)))
    p = dict(graph_edgelist_path=str(path), sample_method=method,
             sample_fraction=0.2, seed=1)
    g = fr.FriendGraphDataSource(fr.DataSourceParams(**p)).read_training(None)
    w = ref_fr.FriendGraphDataSource(ref_fr.DataSourceParams(
        **p)).read_training(None)
    assert 0 < len(g.nodes) < 250 and g.nodes.ids() == w.nodes.ids()
    np.testing.assert_array_equal(g.src, w.src)
    np.testing.assert_array_equal(g.dst, w.dst)
    model = fr.SimRankAlgorithm(fr.SimRankParams(num_iterations=2)).train(
        _ctx(), g)
    assert model.pair_scores.shape == (len(g.nodes), len(g.nodes))


def _same_answer(got, want):
    if "score" in want:
        assert got["score"] == pytest.approx(want["score"], abs=ATOL)
        return
    g, w = got["friendScores"], want["friendScores"]
    assert len(g) == len(w)
    ws = np.array([x["score"] for x in w])
    np.testing.assert_allclose([x["score"] for x in g], ws, rtol=0, atol=ATOL)
    for j in range(len(w)):
        if ((j == 0 or ws[j - 1] - ws[j] > ATOL)
                and (j == len(w) - 1 or ws[j] - ws[j + 1] > ATOL)):
            assert g[j]["friend"] == w[j]["friend"]


QUERIES = [{"item1": "0", "item2": "1"}, {"item1": "0", "item2": "zz"},
           {"user": "0", "num": 3}, {"user": "5", "num": 10},
           {"user": "zz"}, {"item1": "7", "item2": "9"},
           {"user": "12", "num": 4}]


def test_engine_queries_as_reference(tmp_path):
    """Both query shapes through the algorithm on an edge-list file with
    comments (tests/test_simrank.py's engine case, plus a random graph)."""
    rng = np.random.default_rng(6)
    extra = "\n".join(f"{rng.integers(6, 40)} {rng.integers(0, 40)}"
                      for _ in range(150))
    path = tmp_path / "edges.txt"
    path.write_text("# comment line\n2 0\n3 0\n4 0\n2 1\n3 1\n4 1\n"
                    "0 5\n1 5\n" + extra + "\n")
    p = dict(graph_edgelist_path=str(path))
    graph = fr.FriendGraphDataSource(fr.DataSourceParams(**p)).read_training(
        None)
    ref_graph = ref_fr.FriendGraphDataSource(ref_fr.DataSourceParams(
        **p)).read_training(None)
    algo = fr.SimRankAlgorithm(fr.SimRankParams(num_iterations=5, decay=0.8,
                                                k_top=10))
    model = algo.train(_ctx(), graph)
    ref_algo = ref_fr.SimRankAlgorithm(ref_fr.SimRankParams(
        num_iterations=5, decay=0.8, k_top=10))
    ref_model = ref_algo.train(None, ref_graph)
    np.testing.assert_allclose(model.pair_scores, ref_model.pair_scores,
                               rtol=0, atol=ATOL)
    for q in QUERIES:
        _same_answer(algo.predict(model, q), ref_algo.predict(ref_model, q))
    assert algo.predict(model, {"user": "0", "num": 3})[
        "friendScores"][0]["friend"] == "1"
    assert algo.predict(model, {"user": "zz"}) == {"friendScores": []}
    with pytest.raises(ValueError, match="no edges"):
        algo.train(_ctx(), fr.FriendGraph(np.zeros(0, np.int64),
                                          np.zeros(0, np.int64),
                                          EntityIdIndex([])))
    with pytest.raises(ValueError, match="no edges"):
        ref_algo.train(None, ref_fr.FriendGraph(
            np.zeros(0, np.int64), np.zeros(0, np.int64), RefIndex([])))


def test_follow_events_datasource(tmp_path):
    """Event mode: user -> user `follow` events give the same graph as
    the reference's read of the same store."""
    from pio_tpu.data.storage import Storage as RefStorage
    from pio_tpu.workflow.context import create_workflow_context as ref_ctx

    env = verbs.sqlite_env(tmp_path / "pio.db")
    storage = Storage(env=env)
    app_id = storage.get_metadata_apps().insert(App(0, "Social"))
    events = storage.get_events()
    events.init(app_id)
    t0 = datetime(2026, 1, 1, tzinfo=timezone.utc)
    rng = np.random.default_rng(8)
    events.insert_batch([
        Event("follow", "user", f"u{rng.integers(0, 30)}", "user",
              f"u{rng.integers(0, 30)}", {}, t0 + timedelta(seconds=n))
        for n in range(200)] + [
        Event("view", "user", "u1", "item", "i1", {}, t0)], app_id)
    p = dict(app_name="Social")
    g = fr.FriendGraphDataSource(fr.DataSourceParams(**p)).read_training(
        _ctx(storage))
    ref = RefStorage(env=env)
    w = ref_fr.FriendGraphDataSource(ref_fr.DataSourceParams(
        **p)).read_training(ref_ctx(ref, use_mesh=False))
    assert len(g.src) == 200 and g.nodes.ids() == w.nodes.ids()
    np.testing.assert_array_equal(g.src, w.src)
    np.testing.assert_array_equal(g.dst, w.dst)
    storage.close()
    ref.close()


def test_engine_dir_relative_edgelist_train_and_deploy(tmp_path,
                                                       monkeypatch):
    d = tmp_path / "friends"
    verbs.copy_example("friend-recommendation", d, FACTORY)
    elsewhere = tmp_path / "elsewhere"
    elsewhere.mkdir()
    storage = Storage(env=verbs.sqlite_env(tmp_path / "pio.db"))
    assert verbs.train_in_process(d, storage, monkeypatch, elsewhere) == 0
    with verbs.deployed(d, storage, "friend-recommendation") as (port, qs):
        nodes = qs.models[0].nodes.ids()
        queries = [{"item1": nodes[0], "item2": nodes[1]},
                   {"user": nodes[0], "num": 5}, {"user": nodes[3], "num": 2},
                   {"user": "nobody"}]
        bodies = verbs.served_as_in_process(port, qs, queries)
        assert bodies[1]["friendScores"] and bodies[3] == {
            "friendScores": []}
        assert verbs.batchpredict(d, storage, monkeypatch, queries,
                                  tmp_path) == bodies
    storage.close()
