"""The port's similarity ops against the JAX package, on the CPU.

``ops/similarity.py`` (``cosine_topk``, ``mean_vector``,
``column_cosine_topk``) and ``models/filtering.py`` (``rank_candidates``)
run on the same seeded numpy inputs as ``pio_tpu.ops.similarity`` and
``pio_tpu.models.filtering``. The column cosine is held on the reference's
own ``tests/test_dimsum.py`` cases: duplicates summed before normalising,
the threshold, empty columns, ids inside the catalog, identical columns
scoring one. Batched answers must equal solo ones bit for bit.

Tolerances: ids exact wherever the gap to the next score exceeds 1e-5;
scores within 1e-5 relative (f32 products summed in another order; the
reference's mean is a reduction tree, the port's a row-by-row sum). The
column cosine of both packages rounds the same entries to bf16 and sums
them in f32, so its scores agree within 1e-5 and its ids exactly where
neighbouring scores differ by more than that.
"""

import _torch_cpu  # noqa: F401  (one CPU thread: see the module)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pio_tpu.models import filtering as ref_filtering
from pio_tpu.ops import similarity as ref_sim
from pio_tpu_torch.models import filtering
from pio_tpu_torch.ops import similarity as sim

RTOL = 1e-5
GAP = 1e-5


def _assert_topk(got_s, got_i, want_s, want_i):
    got_s, got_i = np.asarray(got_s), np.asarray(got_i)
    want_s, want_i = np.asarray(want_s), np.asarray(want_i)
    np.testing.assert_allclose(got_s, want_s, rtol=RTOL, atol=RTOL)
    for r in range(want_s.shape[0]):
        s = want_s[r]
        gap = np.abs(np.diff(s)) > GAP
        for j in range(len(s)):
            # an id is fixed when its score is apart from both neighbours
            left = j == 0 or gap[j - 1]
            right = j == len(s) - 1 or gap[j]
            if left and right:
                assert got_i[r, j] == want_i[r, j], (r, j)


def _factors(n=300, d=16, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


@pytest.mark.parametrize("b, k", [(1, 5), (3, 17), (70, 8)])
def test_cosine_topk_matches_reference(b, k):
    m = _factors()
    q = np.random.default_rng(1).normal(size=(b, m.shape[1])).astype(
        np.float32)
    gs, gi = sim.cosine_topk(torch.from_numpy(m), torch.from_numpy(q), k)
    ws, wi = ref_sim.cosine_topk(jnp.asarray(m), jnp.asarray(q), k)
    assert gs.shape == (b, k) and gi.shape == (b, k)
    _assert_topk(gs.numpy(), gi.numpy(), ws, wi)


def test_mean_vector_matches_reference():
    m = _factors()
    idx = np.array([3, 17, 17, 250, 9])
    got = sim.mean_vector(torch.from_numpy(m), idx)
    want = ref_sim.mean_vector(jnp.asarray(m), idx)
    assert got.shape == (1, m.shape[1])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=RTOL)


def test_group_means_and_cosine_are_batch_invariant():
    """A query's mean and its cosine scores have the same bits alone and
    in batches of 2, 16 and 64 (the batchers' sizes)."""
    m = torch.from_numpy(_factors())
    rng = np.random.default_rng(3)
    groups = [rng.integers(0, 300, rng.integers(1, 9)) for _ in range(64)]
    solo = [sim.cosine_topk(m, sim.mean_vector(m, g), 12) for g in groups]
    for b in (2, 16, 64):
        qv = sim.group_means(m, groups[:b])
        for r, g in enumerate(groups[:b]):
            assert torch.equal(qv[r:r + 1], sim.mean_vector(m, g))
        s, i = sim.cosine_topk(m, qv, 12)
        for r in range(b):
            assert torch.equal(s[r], solo[r][0][0])
            assert torch.equal(i[r], solo[r][1][0])


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("n_cand, num", [(1, 3), (5, 5), (37, 10)])
def test_rank_candidates_matches_reference(normalize, n_cand, num):
    m = _factors()
    rng = np.random.default_rng(n_cand)
    cidx = rng.choice(300, n_cand, replace=False)
    qv = rng.normal(size=m.shape[1]).astype(np.float32)
    gp, gs = filtering.rank_candidates(torch.from_numpy(m), qv, cidx, num,
                                       normalize=normalize)
    wp, ws = ref_filtering.rank_candidates(jnp.asarray(m), qv, cidx, num,
                                           normalize=normalize)
    assert len(gp) == len(wp) == min(num, n_cand)
    _assert_topk(gs[None], gp[None], ws[None], wp[None])
    e = filtering.rank_candidates(torch.from_numpy(m), qv, [], num)
    assert len(e[0]) == 0 and len(e[1]) == 0


def test_candidate_ids_and_invert_categories_as_reference():
    from pio_tpu.data.bimap import EntityIdIndex as RefIndex
    from pio_tpu_torch.data.bimap import EntityIdIndex

    ids = [f"i{i}" for i in range(12)]
    cats = {f"i{i}": ["a" if i % 2 else "b", "c" if i % 3 else "d"]
            for i in range(12)}
    assert filtering.invert_categories(cats) == \
        ref_filtering.invert_categories(cats)
    for white, categories, exclude in (
            (None, None, set()), ({"i1", "i2", "zz"}, None, {"i2"}),
            (None, {"a"}, {"i3"}), ({"i4", "i5", "i6"}, {"d"}, set())):
        assert filtering.candidate_ids(
            EntityIdIndex(ids), cats, white, categories, exclude) == \
            ref_filtering.candidate_ids(
                RefIndex(ids), cats, white, categories, exclude)


# -- column cosine (DIMSUM): the reference's test_dimsum.py cases ----------

def _both(u, i, v, n_u, n_i, k, **kw):
    got = sim.column_cosine_topk(u, i, v, n_u, n_i, k=k, device="cpu", **kw)
    want = ref_sim.column_cosine_topk(u, i, v, n_u, n_i, k=k, **kw)
    assert got[0].shape == want[0].shape == (n_i, min(k, n_i - 1))
    _assert_topk(*got, *want)
    return got


def test_column_cosine_matches_reference_dense():
    rng = np.random.default_rng(0)
    n_u, n_i = 200, 37
    dense = np.zeros((n_u, n_i), np.float32)
    mask = rng.random((n_u, n_i)) < 0.15
    dense[mask] = rng.integers(1, 5, mask.sum())
    u, i = np.nonzero(dense)
    _both(u, i, dense[u, i], n_u, n_i, 5)


def test_column_cosine_duplicates_sum_before_normalizing():
    rng = np.random.default_rng(2)
    n_u, n_i, nnz = 9000, 60, 20_000  # >1 user batch of 4096; many dups
    u = rng.integers(0, n_u, nnz)
    i = (rng.zipf(1.2, nnz) % n_i).astype(np.int64)
    v = np.ones(nnz, np.float32)
    scores, _ = _both(u, i, v, n_u, n_i, 3)
    assert (scores <= 1.0 + 1e-5).all()


@pytest.mark.parametrize("threshold", [0.0, 0.5])
def test_column_cosine_threshold(threshold):
    rng = np.random.default_rng(1)
    u = rng.integers(0, 100, 500)
    i = rng.integers(0, 20, 500)
    scores, _ = _both(u, i, np.ones(500, np.float32), 100, 20, 10,
                      threshold=threshold)
    assert (scores[scores > 0] >= threshold).all()


def test_column_cosine_edge_cases_as_reference():
    # item 3 has no interactions: never a positive neighbour
    u = np.array([0, 0, 1, 1, 2], np.int32)
    i = np.array([0, 1, 0, 1, 2], np.int32)
    scores, idx = _both(u, i, np.ones(5, np.float32), 3, 4, 3)
    assert (scores[3] <= 0).all()
    for col in range(3):
        assert not (idx[col][scores[col] > 0] == 3).any()
    # padded Gram columns never leak into idx
    scores, idx = _both(np.array([0, 1]), np.array([0, 1]),
                        np.ones(2, np.float32), 2, 3, 2)
    assert (idx < 3).all()
    # identical columns score one
    u = np.array([0, 0, 1, 1, 2, 2], np.int32)
    i = np.array([0, 1, 0, 1, 0, 1], np.int32)
    scores, idx = _both(u, i, np.ones(6, np.float32), 3, 2, 1)
    assert idx[0, 0] == 1 and idx[1, 0] == 0
    np.testing.assert_allclose(scores[:, 0], 1.0, rtol=RTOL)


def test_column_cosine_needs_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sim.column_cosine_topk([0], [0], [1.0], 1, 2, k=1)
