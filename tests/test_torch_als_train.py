"""ALS training of the PyTorch port against ``pio_tpu.ops.als``.

The same seeded numpy inputs go through both packages on the CPU. The
slot layout must be equal element for element. Blocks, normal equations
and solves agree within f32 rounding: both sum the same f32 products in
other orders (and the reference's hybrid path runs its Pallas
segment-flush kernel in interpret mode, as tests/test_als_pallas.py
does). Trained factors agree within a looser tolerance, since each sweep
feeds the last one's rounding into a CG solve; top-k ids must match
wherever the score gap exceeds it.
"""

import _torch_cpu  # noqa: F401  (one CPU thread: see the module)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pio_tpu.ops import als as ref
from pio_tpu_torch.convert import als_model_from_numpy
from pio_tpu_torch.ops import als as port
from pio_tpu_torch.ops.kernels import segment_flush as sf

# blocks and A/b: f32 sums of the same products in another order, relative
# to the largest magnitude of the compared array
RTOL_BLOCKS = 2e-6
# one solve from the same A/b
RTOL_SOLVE = 1e-4
# factors after 2-3 sweeps: CG amplifies each sweep's rounding a little
RTOL_TRAIN = 2e-3


def _close(got, want, rtol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def _coo(seed, nnz, n_users, n_items, heavy=True):
    """Seeded COO with a few rows far wider than a slot (so rows span
    slots, chunks and groups) and rows left empty."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n_users - 2, nnz).astype(np.int32)  # 2 empty rows
    i = rng.integers(0, n_items, nnz).astype(np.int32)
    if heavy:
        u[: nnz // 3] = 1
        i[: nnz // 4] = 2
    v = rng.integers(1, 6, nnz).astype(np.float32)
    return u, i, v


# -- params ---------------------------------------------------------------

@pytest.mark.parametrize("kw", [{"gather": "bogus"}, {"accum": "strem"},
                                {"accum": "pallas "}])
def test_params_reject_unknown_modes_like_reference(kw):
    with pytest.raises(ValueError):
        ref.ALSParams(**kw)
    with pytest.raises(ValueError):
        port.ALSParams(**kw)


@pytest.mark.parametrize("kw", [
    {"accum": "pallas"}, {"accum": "stream"}, {"packed_a": True},
    {"gather": "pallas-copy"}, {"gather": "pallas-take"},
    {"gather": "stream"},
])
def test_unported_modes_raise_not_run_another(kw):
    """Every mode the reference takes, the fused accum="pallas" (K1)
    included, resolves as the reference resolves it and trains like it
    from a shared init. No mode runs another in its place."""
    r = ref.ALSParams(**kw)    # the reference takes them
    p = port.ALSParams(**kw)
    assert p.resolved_accum("cpu") == r.resolved_accum()
    assert p.resolved_packed("cpu") == r.resolved_packed()
    n_users, n_items = 30, 25
    u, i, v = _coo(18, 500, n_users, n_items)
    train = dict(rank=4, iterations=2, implicit=True, alpha=5.0, chunk=64,
                 width=8, chunk_slots=16, group_slots=32, cg_iters=8,
                 bf16_gather=False, **kw)
    uf0, if0 = _shared_init(19, n_users, n_items, 4)
    want = ref.als_train(u, i, v, n_users, n_items, ref.ALSParams(**train),
                         init=ref.ALSModel(jnp.asarray(uf0),
                                           jnp.asarray(if0)))
    got = port.als_train(u, i, v, n_users, n_items, port.ALSParams(**train),
                         init=als_model_from_numpy(uf0, if0, device="cpu"),
                         device="cpu")
    _close(got.user_factors, want.user_factors, RTOL_TRAIN)
    _close(got.item_factors, want.item_factors, RTOL_TRAIN)


def test_params_have_reference_fields_and_defaults():
    fields = lambda cls: {f: getattr(cls(), f) for f in  # noqa: E731
                          cls.__dataclass_fields__}
    assert fields(port.ALSParams) == fields(ref.ALSParams)


@pytest.mark.parametrize("cg_iters,rank,n_self", [
    (-1, 16, None), (-1, 16, 100), (-1, 16, 8192), (-1, 16, 8193),
    (-1, 128, 20000), (0, 64, 20000), (7, 64, 10),
])
def test_resolved_cg_iters_matches_reference(cg_iters, rank, n_self):
    kw = dict(cg_iters=cg_iters, rank=rank)
    assert (port.ALSParams(**kw).resolved_cg_iters(n_self)
            == ref.ALSParams(**kw).resolved_cg_iters(n_self))


@pytest.mark.parametrize("accum", ["auto", "carry", "stacked", "hybrid"])
@pytest.mark.parametrize("rank", [16, 300])
def test_resolved_accum(accum, rank):
    p = port.ALSParams(accum=accum, rank=rank)
    # on the CPU both packages pick the same mode
    assert p.resolved_accum("cpu") == ref.ALSParams(
        accum=accum, rank=rank).resolved_accum()
    # the card is the port's accelerator: auto is the TPU's hybrid
    want = {"auto": "hybrid"}.get(accum, accum)
    if want == "hybrid" and rank > 256:
        want = "stacked"
    assert p.resolved_accum("cuda") == want


@pytest.mark.parametrize("args", [(16,), (64,), (128,), (256,), (300,)])
def test_blocks_group_budget_matches_reference(args):
    assert port.blocks_group_budget_slots(*args) == \
        ref.blocks_group_budget_slots(*args)


@pytest.mark.parametrize("args", [(0, 5, 128, 8), (1000, 50, 16, 8),
                                  (20_004_864, 138_493, 128, 8192),
                                  (20_004_864, 26_744, 128, 8192)])
def test_slots_for_matches_reference(args):
    assert port._slots_for(*args) == ref._slots_for(*args)


# -- layout ---------------------------------------------------------------

@pytest.mark.parametrize("seed,width", [(0, 4), (1, 8), (2, 16)])
def test_device_slot_layout_is_exactly_the_reference(seed, width):
    u, i, v = _coo(seed, 700, 30, 25)
    pad = 37   # a sentinel tail, as _prep_coo pads
    u = np.concatenate([u, np.full(pad, 30, np.int32)])
    i = np.concatenate([i, np.full(pad, 25, np.int32)])
    v = np.concatenate([v, np.zeros(pad, np.float32)])
    for rows_of, opp_of, n_self in ((u, i, 30), (i, u, 25)):
        slots = ref._slots_for(len(u), n_self, width, 8)
        want = ref._device_slot_layout(
            jnp.asarray(rows_of), jnp.asarray(opp_of), jnp.asarray(v),
            n_self, width, slots)
        got = port._device_slot_layout(
            torch.from_numpy(rows_of), torch.from_numpy(opp_of),
            torch.from_numpy(v), n_self, width, slots)
        for g, w in zip(got, want):
            assert g.dtype == getattr(torch, str(w.dtype))
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        rows = got[0].numpy()
        assert (np.diff(rows) >= 0).all() and rows[-1] == n_self


# -- blocks and normal equations --------------------------------------------

def _layout(seed, width=8, n_users=30, n_items=25, nnz=700, chunk=16):
    u, i, v = _coo(seed, nnz, n_users, n_items)
    slots = ref._slots_for(nnz, n_users, width, chunk)
    want = ref._device_slot_layout(jnp.asarray(u), jnp.asarray(i),
                                   jnp.asarray(v), n_users, width, slots)
    got = port._device_slot_layout(torch.from_numpy(u), torch.from_numpy(i),
                                   torch.from_numpy(v), n_users, width,
                                   slots)
    return want, got


@pytest.mark.parametrize("implicit", [False, True])
@pytest.mark.parametrize("bf16", [False, True])
def test_chunk_blocks_match_reference(implicit, bf16):
    want_l, got_l = _layout(3)
    y = np.random.default_rng(4).standard_normal((25, 8)).astype(np.float32)
    src_r = jnp.asarray(y).astype(jnp.bfloat16 if bf16 else jnp.float32)
    src_p = torch.from_numpy(y).to(torch.bfloat16 if bf16 else torch.float32)
    sl = slice(16, 48)
    a_r, b_r = ref._chunk_blocks(src_r, want_l[1][sl], want_l[2][sl],
                                 want_l[3][sl], implicit, 2.5)
    a_p, b_p = port._chunk_blocks(src_p, got_l[1][sl], got_l[2][sl],
                                  got_l[3][sl], implicit, 2.5)
    _close(a_p, a_r, RTOL_BLOCKS)
    _close(b_p, b_r, RTOL_BLOCKS)


@pytest.mark.parametrize("accum", ["carry", "stacked", "hybrid"])
@pytest.mark.parametrize("implicit", [False, True])
def test_normal_equations_match_reference(accum, implicit):
    """chunk_slots 16 and groups of 32 slots: the heavy rows (row 1 holds
    a third of the ratings, 30 slots) span chunk and group boundaries.
    The reference's hybrid runs its Pallas K2 in interpret mode; the
    port's runs the segment flush's plain version on the CPU."""
    want_l, got_l = _layout(5)
    y = np.random.default_rng(6).standard_normal((25, 8)).astype(np.float32)
    kw = dict(bf16_gather=False, accum=accum, group_slots=32)
    A_r, b_r = ref._normal_equations(want_l, jnp.asarray(y), 30, implicit,
                                     2.0, 16, **kw)
    A_p, b_p = port._normal_equations(got_l, torch.from_numpy(y), 30,
                                      implicit, 2.0, 16, **kw)
    _close(A_p, A_r, RTOL_BLOCKS)
    _close(b_p, b_r, RTOL_BLOCKS)
    assert not A_p[28:].any()          # the two empty rows stay zero


def test_normal_equations_modes_agree_within_port():
    _, got_l = _layout(7)
    y = torch.from_numpy(
        np.random.default_rng(8).standard_normal((25, 8)).astype(np.float32))
    out = {a: port._normal_equations(got_l, y, 30, True, 1.5, 16, accum=a,
                                     group_slots=32)
           for a in ("carry", "stacked", "hybrid")}
    for a in ("stacked", "hybrid"):
        _close(out[a][0], out["carry"][0], RTOL_BLOCKS)
        _close(out[a][1], out["carry"][1], RTOL_BLOCKS)


@pytest.mark.parametrize("kw", [{"accum": "pallas"}, {"accum": "stream"},
                                {"packed": True}, {"gather": "stream"}])
def test_normal_equations_refuse_unported_modes(kw):
    """The fused accum="pallas" (K1, the reference's kernel in interpret
    mode) and the modes of the streaming configuration give the
    reference's A and b, in its shape."""
    want_l, got_l = _layout(9)
    y = np.random.default_rng(20).standard_normal((25, 8)).astype(np.float32)
    opts = dict(bf16_gather=False, group_slots=32, **kw)
    A_r, b_r = ref._normal_equations(want_l, jnp.asarray(y), 30, False, 1.0,
                                     16, **opts)
    A_p, b_p = port._normal_equations(got_l, torch.from_numpy(y), 30, False,
                                      1.0, 16, **opts)
    _close(A_p, A_r, RTOL_BLOCKS)
    _close(b_p, b_r, RTOL_BLOCKS)


def test_group_bounds_match_reference_grouping():
    """The hybrid and stacked groups: whole chunks, bytes-capped (k=128
    caps 73,728 at 19,200 slots), last group ragged."""
    assert port._group_bounds(294_912, 64, 8192, 73_728) == [
        (0, 73_728), (73_728, 147_456), (147_456, 221_184),
        (221_184, 294_912)]
    assert port._group_bounds(188_416, 64, 8192, 73_728)[-1] == (
        147_456, 188_416)
    assert port._group_bounds(40_960, 128, 8192, 73_728) == [
        (0, 16_384), (16_384, 32_768), (32_768, 40_960)]


def test_segment_flush_runs_chain_like_one_call():
    """The out= contract: consecutive slot runs flushed in order into one
    zeroed (A, b) give the one-call sums, on the plain version."""
    rng = np.random.default_rng(10)
    rows = np.sort(rng.integers(0, 12, 90)).astype(np.int32)
    rows[-9:] = 12
    a = torch.from_numpy(rng.standard_normal((90, 5, 5)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((90, 5)).astype(np.float32))
    r = torch.from_numpy(rows)
    A1, b1 = sf.segment_flush(r, a, b, 12)
    A2, b2 = torch.zeros(12, 5, 5), torch.zeros(12, 5)
    for lo, hi in ((0, 31), (31, 32), (32, 90)):
        sf.segment_flush(r[lo:hi], a[lo:hi], b[lo:hi], 12, out=(A2, b2))
    _close(A2, A1, RTOL_BLOCKS)
    _close(b2, b1, RTOL_BLOCKS)
    want = np.zeros((12, 5, 5), np.float32)
    np.add.at(want, rows[:-9], a.numpy()[:-9])
    _close(A1, want, RTOL_BLOCKS)


# -- solves ---------------------------------------------------------------

def _spd(seed, n=20, k=8):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((n, k, k)).astype(np.float32)
    A = (np.einsum("nij,nkj->nik", m, m) + 0.5 * np.eye(k)).astype(np.float32)
    b = rng.standard_normal((n, k)).astype(np.float32)
    x0 = rng.standard_normal((n, k)).astype(np.float32)
    return A, b, x0


@pytest.mark.parametrize("n_iter", [1, 4, 16])
def test_cg_solve_matches_reference(n_iter):
    A, b, x0 = _spd(11)
    want = ref._cg_solve(jnp.asarray(A), jnp.asarray(b), jnp.asarray(x0),
                         n_iter)
    got = port._cg_solve(torch.from_numpy(A), torch.from_numpy(b),
                         torch.from_numpy(x0), n_iter)
    _close(got, want, RTOL_SOLVE)


@pytest.mark.parametrize("cg_iters", [0, 16])
@pytest.mark.parametrize("implicit", [False, True])
def test_solve_factors_matches_reference(cg_iters, implicit):
    """One solved side, Cholesky (cg_iters 0) and CG, with YᵀY and reg
    added to A."""
    want_l, got_l = _layout(12)
    rng = np.random.default_rng(13)
    y = np.abs(rng.standard_normal((25, 8))).astype(np.float32) / 3
    x0 = np.abs(rng.standard_normal((30, 8))).astype(np.float32) / 3
    kw = dict(x0=None, cg_iters=cg_iters, bf16_gather=False, accum="carry")
    want = ref._solve_factors(want_l, jnp.asarray(y), 30, 0.1, implicit,
                              3.0, 16, **{**kw, "x0": jnp.asarray(x0)})
    got = port._solve_factors(got_l, torch.from_numpy(y), 30, 0.1, implicit,
                              3.0, 16, **{**kw, "x0": torch.from_numpy(x0)})
    _close(got, want, RTOL_SOLVE)


def test_init_factors_are_seeded():
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    a, b = port.init_factors(50, 8, g1), port.init_factors(50, 8, g2)
    assert torch.equal(a, b) and a.shape == (50, 8) and bool((a >= 0).all())


@pytest.mark.parametrize("params", [[16, 3, 8], [40, 2, 0], [1, 2, 6]])
def test_cg_schedule_matches_reference(params):
    cg_u, cg_i, warm = params
    p = dict(iterations=5, cg_warm_iters=warm, cg_warm_sweeps=2)
    assert port._cg_schedule(port.ALSParams(**p), cg_u, cg_i) == \
        ref._cg_schedule(ref.ALSParams(**p), cg_u, cg_i)


# -- training ---------------------------------------------------------------

# CG runs at least `rank` iterations in every case: short of that, CG's
# iterate is sensitive to the rounding of A (one sweep at rank 64 and 16
# iterations moves by 4e-4 of the factors' norm between the packages),
# and this test is about the algorithm, not that sensitivity
TRAIN_CASES = [
    # explicit, both sides Cholesky (auto: few rows)
    dict(implicit=False, iterations=3, reg=0.1, rank=8, bf16_gather=False),
    # implicit, both sides CG with the warm schedule
    dict(implicit=True, iterations=3, reg=0.05, alpha=10.0, rank=4,
         auto_cg_rows=10, cg_warm_sweeps=1, cg_warm_iters=6,
         bf16_gather=False),
    # users on CG, items on Cholesky, bf16 gather
    dict(implicit=True, iterations=2, reg=0.1, alpha=2.0, rank=12,
         auto_cg_rows=40, bf16_gather=True),
]


def _shared_init(seed, n_users, n_items, k):
    rng = np.random.default_rng(seed)
    uf0 = np.abs(rng.standard_normal((n_users, k))).astype(np.float32) / 3
    if0 = np.abs(rng.standard_normal((n_items, k))).astype(np.float32) / 3
    return uf0, if0


def _train_both(case, n_users=60, n_items=35, **modes):
    u, i, v = _coo(14, 1500, n_users, n_items)
    kw = dict(chunk=256, width=16, chunk_slots=32, group_slots=64, **case,
              **modes)
    uf0, if0 = _shared_init(15, n_users, n_items, case["rank"])
    want = ref.als_train(u, i, v, n_users, n_items, ref.ALSParams(**kw),
                         init=ref.ALSModel(jnp.asarray(uf0),
                                           jnp.asarray(if0)))
    got = port.als_train(u, i, v, n_users, n_items, port.ALSParams(**kw),
                         init=als_model_from_numpy(uf0, if0, device="cpu"),
                         device="cpu")
    return got, want


@pytest.mark.parametrize("case", TRAIN_CASES)
@pytest.mark.parametrize("accum", ["carry", "hybrid"])
def test_als_train_matches_reference_from_shared_init(case, accum):
    n_users = 60
    got, want = _train_both(case, n_users=n_users, accum=accum)
    _assert_same_model(got, want, n_users)


# the streaming configuration (the reference's "round 6": overlapped flush,
# streaming gather, packed A and packed CG) and the resident gathers
STREAM_CONFIGS = [
    dict(accum="stream", gather="stream", packed_a=True),
    dict(accum="hybrid", gather="pallas-copy"),
    dict(accum="hybrid", gather="pallas-take"),
]


@pytest.mark.parametrize("case", TRAIN_CASES)
@pytest.mark.parametrize("config", STREAM_CONFIGS)
def test_als_train_stream_config_matches_reference_from_shared_init(
        case, config):
    got, want = _train_both(case, **config)
    _assert_same_model(got, want, 60)


def _assert_same_model(got, want, n_users):
    _close(got.user_factors, want.user_factors, RTOL_TRAIN)
    _close(got.item_factors, want.item_factors, RTOL_TRAIN)

    # top-k ids equal wherever the reference's score gaps exceed the
    # tolerance the scores were compared with
    users = np.arange(n_users - 2)
    s_r, i_r = ref.recommend_topk(want, users, 10)
    s_p, i_p = port.recommend_topk(got, users, 10)
    s_r, i_r = np.asarray(s_r), np.asarray(i_r)
    tol = 4 * RTOL_TRAIN * np.abs(s_r).max()
    _close(s_p, s_r, 4 * RTOL_TRAIN)
    for row in range(len(users)):
        gaps = np.abs(np.diff(s_r[row]))
        for j in range(10):
            near = [gaps[j - 1]] if j else []
            near += [gaps[j]] if j < 9 else []
            if j < 9 and min(near) > tol:
                assert i_p[row, j] == i_r[row, j]


def test_als_train_seeded_init_is_reproducible():
    u, i, v = _coo(16, 400, 20, 15)
    p = port.ALSParams(rank=4, iterations=2, chunk=64, width=8,
                       chunk_slots=16)
    a = port.als_train(u, i, v, 20, 15, p, device="cpu")
    b = port.als_train(torch.from_numpy(u), torch.from_numpy(i),
                       torch.from_numpy(v), 20, 15, p, device="cpu")
    assert torch.equal(a.user_factors, b.user_factors)
    assert torch.equal(a.item_factors, b.item_factors)
    assert a.user_factors.shape == (20, 4) and a.user_factors.dtype == \
        torch.float32


def test_als_train_refuses_tf32_on_cuda():
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(RuntimeError, match="TF32"):
            port._require_f32_matmul(torch.device("cuda"))
        port._require_f32_matmul(torch.device("cpu"))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    port._require_f32_matmul(torch.device("cuda"))


def test_als_train_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    u, i, v = _coo(17, 100, 10, 10)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.als_train(u, i, v, 10, 10, port.ALSParams(rank=4))
