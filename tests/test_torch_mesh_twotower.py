"""The two-tower template's dp x tp training across four gloo ranks on the
CPU (``train_two_tower(..., mesh=)`` on data 2 x model 2), against the
JAX package's ``train_two_tower`` on a mesh of the same shape over the 8
CPU devices that tests/conftest.py gives it.

The reference reaches that layout through GSPMD, which does not change
the arithmetic, so both packages start from the reference's init
(``convert.twotower_params_from_numpy``), see the same batch stream and
end at tests/test_torch_twotower.py's PARAM_ATOL of each other; the
batch size (66) is rounded to the data axis as the reference rounds it.
The port's run is also stopped after a step checkpoint and resumed from
the gathered state, to the uninterrupted run's bits.
"""

import _torch_cpu  # noqa: F401  (one CPU thread: see the module)
import json
import os

import jax
import numpy as np
import pytest

from _torch_dist import TESTS, run_ranks
from pio_tpu.data.bimap import EntityIdIndex as RefIndex
from pio_tpu.data.eventstore import Interactions as RefInteractions
from pio_tpu.models import twotower as ref_tt
from pio_tpu.parallel.mesh import MeshConfig, create_mesh as ref_mesh
from pio_tpu_torch import convert

# tests/test_torch_twotower.py's parity tolerance, params and items
PARAM_ATOL = 1e-5
PARAMS = dict(embed_dim=16, hidden_dim=32, out_dim=8, steps=20,
              batch_size=66, learning_rate=5e-3, temperature=0.1)
N_USERS, N_ITEMS = 40, 24
MESH = (2, 1, 2)


def _pairs(seed=0):
    """tests/test_twotower.py's two clusters of users and items."""
    rng = np.random.default_rng(seed)
    us, its = [], []
    for u in range(N_USERS):
        for i in range(N_ITEMS):
            if rng.random() < (0.6 if (i % 2) == (u % 2) else 0.05):
                us.append(u)
                its.append(i)
    return np.array(us, np.int32), np.array(its, np.int32)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_twotower")
    u, i = _pairs()
    rp = ref_tt.TwoTowerParams(**PARAMS)
    init = jax.device_get(ref_tt.init_params(N_USERS, N_ITEMS, rp))
    arrays = {"u": u, "i": i} | {
        f"init/{k}": v.numpy() for k, v in
        convert.twotower_params_from_numpy(init, device="cpu").items()}
    np.savez(d / "in.npz", **arrays)
    (d / "in.json").write_text(json.dumps({
        "mesh": MESH, "n_users": N_USERS, "n_items": N_ITEMS,
        "params": PARAMS,
        "checkpoint": {"dir": str(d / "ckpt"), "every": 4, "stop": 10}}))
    outs = run_ranks(lambda r: [os.path.join(TESTS, "_torch_mesh_worker.py"),
                                "twotower", str(d)], 4)
    for rc, _, err in outs:
        assert rc == 0, err[-3000:]
    ranks = [dict(np.load(d / f"rank{r}.npz")) for r in range(4)]

    inter = RefInteractions(
        user_idx=u, item_idx=i, values=np.ones(len(u), np.float32),
        users=RefIndex(f"u{n}" for n in range(N_USERS)),
        items=RefIndex(f"i{n}" for n in range(N_ITEMS)))
    mesh = ref_mesh(MeshConfig(*MESH), jax.devices()[:4])
    params, emb, _ = ref_tt.train_two_tower(inter, rp, mesh)
    want = {k: v.numpy() for k, v in convert.twotower_params_from_numpy(
        jax.device_get(params), device="cpu").items()}
    return ranks, want, np.asarray(emb)


def test_dp_tp_training_equals_reference(runs):
    ranks, want, _ = runs
    for r in ranks:
        got = {k[len("params/"):]: v for k, v in r.items()
               if k.startswith("params/")}
        assert set(got) == set(want)
        for k, w in want.items():
            assert got[k].shape == w.shape, k
            np.testing.assert_allclose(got[k], w, rtol=0, atol=PARAM_ATOL,
                                       err_msg=k)
        losses = r["losses"]
        assert losses.shape == (PARAMS["steps"],)
        assert losses[-1] < losses[0]
    for r in ranks[1:]:
        for k in want:
            np.testing.assert_array_equal(r[f"params/{k}"],
                                          ranks[0][f"params/{k}"])


def test_item_embeddings_come_from_the_gathered_params(runs):
    ranks, _, emb = runs
    for r in ranks:
        np.testing.assert_allclose(r["item_emb"], emb, rtol=0,
                                   atol=PARAM_ATOL)
        np.testing.assert_allclose(np.linalg.norm(r["item_emb"], axis=1),
                                   1.0, atol=1e-3)


def test_resume_from_the_gathered_checkpoint_is_bit_equal(runs):
    """Stopped after 10 steps (saves at 0, 4 and 8), resumed from step 8's
    gathered state: every rank ends at the uninterrupted run's bits."""
    ranks, want, _ = runs
    for r in ranks:
        assert sorted(map(int, r["resumed/files"])) == [8, 12, 16]
        for k in want:
            np.testing.assert_array_equal(r[f"resumed/params/{k}"],
                                          r[f"params/{k}"], err_msg=k)
