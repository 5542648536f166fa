"""The port's stacked ALS trainer and sweep runner against the JAX
package, on the CPU: the stacked factors against the reference's stacked
trainer from the same init (f32 gathers), a sweep whose candidates differ
in shape batched per group, and a resumed sweep refusing a changed plan.

Tolerance: factors within 1e-4 of the largest factor with f32 gathers
(measured: 3e-5).
"""

import _torch_cpu  # noqa: F401  (one CPU thread: see the module)
import numpy as np
import pytest

from pio_tpu.controller.engine import EngineParams as RefEngineParams
from pio_tpu.models import recommendation as ref_rec
from pio_tpu.ops import als as ref_als
from pio_tpu.tuning import sweep as ref_sweep
from pio_tpu_torch.controller.engine import EngineParams
from pio_tpu_torch.models import recommendation as port_rec
from pio_tpu_torch.ops import als as port_als
from pio_tpu_torch.resilience import chaos
from pio_tpu_torch.tuning import sweep as port_sweep
from _torch_tuning_common import (
    F32_GATHER_RTOL,
    _arrays,
    _candidates,
    _port_sweep,
    same_init,
    store,
)


@pytest.mark.parametrize("implicit", [False, True])
def test_stacked_matches_reference_stacked(same_init, implicit):
    """The port's stacked factors against the reference's stacked
    factors from the same init (the reference trains its candidates
    vmapped, the port with the candidate axis folded into the rows), in
    f32 gathers. With the default bf16 gather the two packages'
    sequential trainers already differ by up to 2e-3 of the largest
    factor (a one-ulp f32 difference flips a bf16 rounding of a factor),
    which the stacked trainers inherit; the port's stacked trainer is
    held to its own sequential one there (above)."""
    u, i, v, n_users, n_items = _arrays(nnz=700)
    kw = dict(rank=8, iterations=3, chunk=256, implicit=implicit,
              bf16_gather=False)
    regs = np.array([0.05, 0.5, 5.0], np.float32)
    alphas = np.array([1.0, 2.0, 8.0], np.float32)
    got = port_als.als_train_stacked(u, i, v, n_users, n_items,
                                     port_als.ALSParams(**kw), regs, alphas,
                                     device="cpu")
    want = ref_als.als_train_stacked(u, i, v, n_users, n_items,
                                     ref_als.ALSParams(**kw), regs, alphas)
    assert len(got) == len(want) == 3
    for g, w in ((got.user_factors, want.user_factors),
                 (got.item_factors, want.item_factors)):
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=F32_GATHER_RTOL * np.abs(w).max())


def test_sweep_mixed_shapes_batch_per_group(store):
    storage, _, _ = store
    cands = (_candidates(EngineParams, port_rec, regs=(0.01, 0.1), rank=4)
             + _candidates(EngineParams, port_rec, regs=(0.01, 0.1)))
    groups, batchable = port_sweep.group_candidates(cands)
    want_groups, want_batchable = ref_sweep.group_candidates(
        _candidates(RefEngineParams, ref_rec, regs=(0.01, 0.1), rank=4)
        + _candidates(RefEngineParams, ref_rec, regs=(0.01, 0.1)))
    assert batchable and want_batchable
    assert sorted(groups.values()) == sorted(want_groups.values())
    _, result = _port_sweep(storage, cands)
    assert len(result.engine_params_scores) == 4


def test_sweep_resume_rejects_changed_plan(store):
    storage, _, _ = store
    cands = _candidates(EngineParams, port_rec)
    with pytest.raises(chaos.ChaosError):
        with chaos.inject("eval.fold.1", error=1.0):
            _port_sweep(storage, cands)
    dao = storage.get_metadata_evaluation_instances()
    eval_id = [i for i in dao.get_all() if i.status == "EVALFAILED"][0].id
    with pytest.raises(ValueError, match="different plan"):
        _port_sweep(storage, cands, folds=3, resume=eval_id)
    # same cardinality, other values: fold 0's persisted scores came
    # from the old params
    with pytest.raises(ValueError, match="different plan"):
        _port_sweep(storage,
                    _candidates(EngineParams, port_rec, regs=(0.5, 2, 5)),
                    resume=eval_id)
    with pytest.raises(ValueError, match="different plan"):
        _port_sweep(storage, cands, resume=eval_id,
                    others=("ndcg@5", "auc", "precision@5"))
    with pytest.raises(ValueError, match="not found"):
        _port_sweep(storage, cands, resume="nope")

