"""The port's fold-in solve (``pio_tpu_torch.ops.als.als_fold_in``) against
the JAX package's, and its batch-composition invariance.

  * the same seeded inputs through ``pio_tpu.ops.als.als_fold_in`` and the
    port's, explicit and implicit, with users of one to several 128-wide
    slots and users without events (the zero row in both);
  * a user's row is bit-identical folded alone or in any batch, on the
    CPU, with users whose slots straddle block-chunk edges;
  * the accumulation CUDA runs (``_add_blocks``' rounds of one ordered
    add per row) emulated on the CPU: the same bits as ``index_add_``;
  * on a card (skipped here): the invariance and two runs' agreement at
    batch sizes 1, 2, 7 and 1024 across the pow2 event buckets, with
    multi-slot users, and each slot's block the same bits wherever it
    sits in a chunk. The JAX package is imported inside the one test that
    needs it, so the card's cases run where JAX is absent:

    python -m pytest tests/test_torch_foldin.py --noconftest -k on_card
"""

import _torch_cpu  # noqa: F401  (one CPU thread: see the module)
import numpy as np
import pytest
import torch

from pio_tpu_torch.ops import als

# two f32 solves of one ridge system, summed and factored in other
# orders: relative to each row's norm
ROW_RTOL = 1e-4


def batch(seed, n_users, k=6, n_items=300, max_len=300, empty=()):
    """COO of n_users users with 1..max_len distinct items each (users in
    ``empty`` get none), values in [1, 5), and an item table."""
    rng = np.random.default_rng(seed)
    itf = rng.standard_normal((n_items, k)).astype(np.float32)
    u, i = [], []
    for j in range(n_users):
        if j in empty:
            continue
        n = int(rng.integers(1, max_len + 1))
        u.append(np.full(n, j, np.int32))
        i.append(rng.choice(n_items, n, replace=False).astype(np.int32))
    u, i = np.concatenate(u), np.concatenate(i)
    v = rng.uniform(1, 5, len(u)).astype(np.float32)
    return itf, u, i, v


def params(implicit, k=6):
    return dict(rank=k, reg=0.05, alpha=0.9, implicit=implicit)


def solo(itf, u, i, v, uid, p):
    m = u == uid
    return als.als_fold_in(itf, np.zeros(int(m.sum()), np.int32), i[m],
                           v[m], 1, p)[0]


@pytest.mark.parametrize("implicit", [False, True])
@pytest.mark.parametrize("n_users,max_len", [(4, 3), (9, 300), (33, 40)])
def test_fold_in_matches_the_reference(implicit, n_users, max_len):
    from pio_tpu.ops import als as ref_als

    itf, u, i, v = batch(n_users, n_users, max_len=max_len, empty={1})
    n = n_users + 2                     # two more users without events
    got = als.als_fold_in(itf, u, i, v, n, als.ALSParams(**params(implicit)))
    want = np.asarray(ref_als.als_fold_in(
        itf, u, i, v, n, ref_als.ALSParams(**params(implicit))))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    got = got.numpy()
    norm = np.linalg.norm(want, axis=1, keepdims=True)
    assert (np.abs(got - want) <= ROW_RTOL * norm).all()
    for empty in (1, n_users, n_users + 1):
        assert (got[empty] == 0).all() and (want[empty] == 0).all()


def test_fold_in_of_nothing_is_zeros_on_the_table_device():
    itf = torch.ones((5, 3))
    out = als.als_fold_in(itf, [], [], [], 4, als.ALSParams(rank=3))
    assert out.shape == (4, 3) and out.device == itf.device
    assert (out == 0).all()
    assert als.als_fold_in(itf, [0], [1], [2.0], 0,
                           als.ALSParams(rank=3)).shape == (0, 3)


def test_fold_in_params_pin_the_conservative_variant():
    p = als.fold_in_params(als.ALSParams(
        rank=8, reg=0.2, alpha=3.0, implicit=True, accum="pallas",
        gather="stream", packed_a=True, bf16_gather=True))
    assert (p.accum, p.gather, p.packed_a, p.bf16_gather) == (
        "carry", "xla", False, False)
    assert (p.rank, p.reg, p.alpha, p.implicit) == (8, 0.2, 3.0, True)


@pytest.mark.parametrize("implicit", [False, True])
@pytest.mark.parametrize("chunk_slots", [4, als.FOLD_IN_CHUNK_SLOTS])
def test_fold_in_batch_composition_invariant(monkeypatch, implicit,
                                             chunk_slots):
    """A user's row is BIT-identical folded alone or among any batch
    mates; with 4-slot chunks many users' slots straddle a chunk edge."""
    monkeypatch.setattr(als, "FOLD_IN_CHUNK_SLOTS", chunk_slots)
    p = als.ALSParams(**params(implicit))
    itf, u, i, v = batch(7, 12, max_len=300)
    full = als.als_fold_in(itf, u, i, v, 12, p)
    for uid in range(12):
        assert torch.equal(solo(itf, u, i, v, uid, p), full[uid]), uid
    # any sub-batch, in another order and with other mates
    pick = [9, 2, 5]
    m = np.isin(u, pick)
    remap = {old: new for new, old in enumerate(pick)}
    sub = als.als_fold_in(itf, np.asarray([remap[x] for x in u[m]],
                                          np.int32), i[m], v[m], 3, p)
    for new, old in enumerate(pick):
        assert torch.equal(sub[new], full[old])


def test_ordered_rounds_equal_index_add_on_the_cpu(monkeypatch):
    """The accumulation CUDA runs, emulated on the CPU by taking the CPU
    for an accelerator: each row's slots in rounds of one add per row
    give the bits of the sequential ``index_add_``, for the fold-in and
    for training in the carry and stacked modes."""
    itf, u, i, v = batch(3, 20, n_items=500, max_len=400)
    p = als.ALSParams(**params(True))
    plain = als.als_fold_in(itf, u, i, v, 20, p)
    lay = als._device_slot_layout(
        *(torch.from_numpy(x) for x in (u, i, v)), 20, 128,
        als._slots_for(len(u), 20, 128, 8))
    y = torch.from_numpy(itf)
    want = {m: als._normal_equations(lay, y, 20, True, 0.9, 8, accum=m,
                                     group_slots=16)
            for m in ("carry", "stacked")}
    monkeypatch.setattr(als, "_accelerator_backend", lambda d: True)
    assert torch.equal(als.als_fold_in(itf, u, i, v, 20, p), plain)
    for mode, (a, b) in want.items():
        a2, b2 = als._normal_equations(lay, y, 20, True, 0.9, 8,
                                       accum=mode, group_slots=16)
        assert torch.equal(a2, a) and torch.equal(b2, b), mode


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fold-in's card path")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.parametrize("implicit", [False, True])
@pytest.mark.parametrize("n_users", [1, 2, 7, 1024])
def test_fold_in_invariant_and_reproducible_on_card(implicit, n_users):
    """On the card: every user folded alone equals the same user in the
    batch, bit for bit, and a second run gives the same bits. Users hold
    up to 512 events (up to four 128-wide slots), so the event count
    crosses several pow2 buckets and slots straddle chunk edges."""
    _card()
    itf, u, i, v = batch(n_users, n_users, k=64, n_items=4000,
                         max_len=512)
    itf = torch.from_numpy(itf).cuda()
    p = als.ALSParams(**params(implicit, k=64))
    full = als.als_fold_in(itf, u, i, v, n_users, p)
    assert full.device.type == "cuda"
    assert torch.equal(als.als_fold_in(itf, u, i, v, n_users, p), full)
    counts = np.bincount(u, minlength=n_users)
    multi = [j for j in range(n_users) if counts[j] > 128]
    rng = np.random.default_rng(n_users)
    check = sorted(set(multi[:48]) | set(
        rng.choice(n_users, min(n_users, 16), replace=False).tolist()))
    for uid in check:
        assert torch.equal(solo(itf, u, i, v, uid, p), full[uid]), uid


def test_slot_blocks_do_not_depend_on_their_place_on_card():
    """A slot's block from ``_chunk_blocks`` at the fold-in's fixed chunk
    size is the same bits wherever the slot sits in the chunk."""
    _card()
    rng = np.random.default_rng(4)
    cs, w, k = als.FOLD_IN_CHUNK_SLOTS, 128, 64
    src = torch.from_numpy(rng.standard_normal((5000, k))
                           .astype(np.float32)).cuda()
    idx = torch.from_numpy(rng.integers(0, 5000, (cs, w))
                           .astype(np.int32)).cuda()
    val = torch.from_numpy(rng.uniform(1, 5, (cs, w))
                           .astype(np.float32)).cuda()
    lens = torch.from_numpy(rng.integers(1, w + 1, cs)
                            .astype(np.int32)).cuda()
    a, b = als._chunk_blocks(src, idx.long(), val, lens, True, 0.9)
    perm = torch.randperm(cs, device="cuda")
    a2, b2 = als._chunk_blocks(src, idx[perm].long(), val[perm],
                               lens[perm], True, 0.9)
    assert torch.equal(a2, a[perm]) and torch.equal(b2, b[perm])
