"""ALS serving functions of the PyTorch port against ``pio_tpu.ops.als``.

The same seeded factors go into both packages. Ids must match exactly;
scores within a tolerance, never bit-for-bit: the two frameworks sum the
k products in different orders (and the reference itself drifts between
batch 1 and batch 2+ on the CPU).
"""

import _torch_cpu  # noqa: F401  (one CPU thread: see the module)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pio_tpu.ops import als as ref
from pio_tpu_torch.ops import als as port

RTOL = 1e-5
ATOL = 1e-5


def _factors(seed, n_users=48, n_items=300, k=16):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n_users, k)).astype(np.float32),
            rng.standard_normal((n_items, k)).astype(np.float32))


def _models(uf, itf):
    return (ref.ALSModel(jnp.asarray(uf), jnp.asarray(itf)),
            port.ALSModel(torch.from_numpy(uf), torch.from_numpy(itf)))


def test_predict_pairs_matches_reference():
    uf, itf = _factors(0)
    m_ref, m_port = _models(uf, itf)
    rng = np.random.default_rng(1)
    u = rng.integers(0, uf.shape[0], 200).astype(np.int32)
    i = rng.integers(0, itf.shape[0], 200).astype(np.int32)
    got = port.predict_pairs(m_port, u, i)
    assert got.dtype == torch.float32 and got.shape == (200,)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(ref.predict_pairs(m_ref, u, i)),
        rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("b,k", [(1, 1), (1, 10), (3, 7), (5, 64),
                                 (16, 300), (2, 1000)])
def test_recommend_topk_matches_reference(b, k):
    uf, itf = _factors(2)
    m_ref, m_port = _models(uf, itf)
    users = np.random.default_rng(3).integers(0, uf.shape[0], b)
    s_ref, i_ref = ref.recommend_topk(m_ref, users, k)
    s_port, i_port = port.recommend_topk(m_port, users, k)
    assert tuple(s_port.shape) == tuple(s_ref.shape)
    np.testing.assert_array_equal(i_port.numpy(), np.asarray(i_ref))
    np.testing.assert_allclose(s_port.numpy(), np.asarray(s_ref),
                               rtol=RTOL, atol=ATOL)


def test_recommend_topk_solo_equals_batched_row():
    """The port's own solo-vs-batched contract: a user's answer alone
    and as a row of a batch agree (same ids, scores within f32
    rounding of a k=16 dot)."""
    uf, itf = _factors(4)
    _, m_port = _models(uf, itf)
    users = np.arange(9)
    s_all, i_all = port.recommend_topk(m_port, users, 20)
    for r, u in enumerate(users):
        s1, i1 = port.recommend_topk(m_port, np.array([u]), 20)
        assert torch.equal(i1[0], i_all[r])
        torch.testing.assert_close(s1[0], s_all[r], rtol=RTOL, atol=ATOL)


def test_rmse_matches_reference():
    uf, itf = _factors(5)
    m_ref, m_port = _models(uf, itf)
    rng = np.random.default_rng(6)
    u = rng.integers(0, uf.shape[0], 500).astype(np.int32)
    i = rng.integers(0, itf.shape[0], 500).astype(np.int32)
    v = rng.uniform(1, 5, 500).astype(np.float32)
    got = port.rmse(m_port, u, i, v)
    assert isinstance(got, float)
    assert got == pytest.approx(ref.rmse(m_ref, u, i, v), rel=RTOL)
