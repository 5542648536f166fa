"""The port's stacked ALS trainer (``als_train_stacked``) on the CPU:
candidate c against the port's sequential
``als_train(sweep_safe_params(...))`` from the same seeded init, and the
power-of-two candidate padding trimmed.

Tolerance: a stacked candidate's factors within 1e-5 relative of the
sequential run's.
"""

import _torch_cpu  # noqa: F401  (one CPU thread: see the module)
import dataclasses

import numpy as np
import pytest
import torch

from pio_tpu_torch.ops import als as port_als
from _torch_tuning_common import (
    STACKED_RTOL,
    _arrays,
)


@pytest.mark.parametrize("implicit, auto_cg_rows", [
    (False, 8192), (True, 8192), (True, 16)])
def test_stacked_candidate_equals_sequential(implicit, auto_cg_rows):
    """Candidate c of the stacked trainer against a sequential
    ``als_train`` with c's (reg, alpha) from the same seeded init: the
    Cholesky sides and, with auto_cg_rows 16, warm-started CG."""
    u, i, v, n_users, n_items = _arrays()
    base = port_als.ALSParams(rank=8, iterations=3, chunk=256,
                              implicit=implicit, auto_cg_rows=auto_cg_rows)
    regs = np.array([0.01, 0.1, 1.0], np.float32)
    alphas = np.array([1.0, 4.0, 10.0], np.float32)
    st = port_als.als_train_stacked(u, i, v, n_users, n_items, base, regs,
                                    alphas, device="cpu")
    for c in range(3):
        seq = port_als.als_train(
            u, i, v, n_users, n_items,
            port_als.sweep_safe_params(dataclasses.replace(
                base, reg=float(regs[c]), alpha=float(alphas[c])), "cpu"),
            device="cpu")
        for got, want in ((st.user_factors[c], seq.user_factors),
                          (st.item_factors[c], seq.item_factors)):
            torch.testing.assert_close(got, want, rtol=STACKED_RTOL,
                                       atol=0)


@pytest.mark.parametrize("n_cand", [1, 3, 5])
def test_stacked_pow2_padding_trims(n_cand):
    """3 -> bucket 4, 5 -> bucket 8: the padding repeats the last
    candidate and is trimmed; the last candidate is unchanged by it."""
    u, i, v, n_users, n_items = _arrays(nnz=400)
    p = port_als.ALSParams(rank=4, iterations=2, chunk=256)
    regs = np.linspace(0.1, 0.5, n_cand).astype(np.float32)
    st = port_als.als_train_stacked(u, i, v, n_users, n_items, p, regs,
                                    np.ones(n_cand, np.float32),
                                    device="cpu")
    assert len(st) == n_cand
    assert st.user_factors.shape == (n_cand, n_users, 4)
    assert st.item_factors.shape == (n_cand, n_items, 4)
    last = port_als.als_train_stacked(u, i, v, n_users, n_items, p,
                                      regs[-1:], np.ones(1, np.float32),
                                      device="cpu")
    assert torch.equal(st.user_factors[-1], last.user_factors[0])
    with pytest.raises(ValueError, match="equal-length"):
        port_als.als_train_stacked(u, i, v, n_users, n_items, p, regs,
                                   np.ones(n_cand + 1, np.float32),
                                   device="cpu")

