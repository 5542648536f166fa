"""Tie order of the port's serving top-k against the JAX package.

``jax.lax.top_k`` puts the lower index first among equal scores, and that
rule also picks which tied entries make the cut at k. ALS gives identical
factors to items with identical rating sets, so exact ties reach
``/queries.json``. Here 100 of 300 items share one factor row that
outscores every other item for every user: the top 10 is a cut inside
that tie, and the port's ids must equal the reference's element for
element, in exact mode and in clustered mode (``impl`` "xla" and the plain
version of the scan kernel). The same inputs on the card are in
``tests/test_torch_kernels.py``.
"""

import _torch_cpu  # noqa: F401  (one CPU thread: see the module)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pio_tpu.ops import als as ref_als
from pio_tpu.ops import retrieval as ref_rt
from pio_tpu_torch.ops import als as port_als
from pio_tpu_torch.ops import retrieval as port_rt
from pio_tpu_torch.ops import topk

N_USERS, N_ITEMS, RANK = 16, 300, 8
TIED = np.arange(200, 300)


def tied_factors(seed=0):
    """Users with positive factors; items 200-299 one shared row of 4s,
    which outscores every other item, the rest N(0, 1)."""
    rng = np.random.default_rng(seed)
    users = np.abs(rng.standard_normal((N_USERS, RANK))).astype(np.float32)
    items = rng.standard_normal((N_ITEMS, RANK)).astype(np.float32)
    items[TIED] = 4.0
    return users, items


def test_helper_orders_by_score_then_index():
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0, -np.inf, -np.inf]])
    vals, idx = topk.topk_lowest_index(x, 6)
    assert idx.tolist() == [[1, 2, 4, 3, 0, 5]]
    assert vals.tolist() == [[3.0, 3.0, 3.0, 2.0, 1.0, -np.inf]]
    vals, idx = topk.topk_lowest_index(x, 2)
    assert idx.tolist() == [[1, 2]]


@pytest.mark.parametrize("k", [1, 10, 37, 128])
def test_exact_topk_ids_equal_reference_under_ties(k):
    users, items = tied_factors()
    uidx = np.arange(N_USERS)
    _, want = ref_als.recommend_topk(
        ref_als.ALSModel(jnp.asarray(users), jnp.asarray(items)), uidx, k)
    _, got = port_als.recommend_topk(
        port_als.ALSModel(torch.from_numpy(users), torch.from_numpy(items)),
        uidx, k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[0, :min(k, 100)].tolist() == list(TIED[:min(k, 100)])


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("dtype", ["int8", "bf16"])
@pytest.mark.parametrize("rerank_k", [64, 1024])
def test_clustered_topk_ids_equal_reference_under_ties(impl, dtype,
                                                       rerank_k):
    """rerank_k 64 puts the candidate cut inside the 100 tied quantized
    scores; 1024 lets all of them through to the exact tier."""
    users, items = tied_factors()
    params = dict(mode="clustered", dtype=dtype, n_clusters=16, nprobe=4,
                  rerank_k=rerank_k, impl=impl)
    d_ref = ref_rt.build_device_index(
        ref_rt.build_index(items, ref_rt.RetrievalParams(**params)))
    d_port = port_rt.build_device_index(
        port_rt.build_index(items, port_rt.RetrievalParams(**params)), "cpu")
    for k in (1, 10, 37):
        _, want = ref_rt.candidate_topk(d_ref, jnp.asarray(items), users, k)
        _, got = port_rt.candidate_topk(d_port, torch.from_numpy(items),
                                        users, k)
        np.testing.assert_array_equal(got, np.asarray(want))
        assert got[0, :k].tolist() == list(TIED[:k])
