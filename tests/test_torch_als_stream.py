"""ALS training's streaming configuration in the PyTorch port against
``pio_tpu``: the row gathers (K5 stream, K4 resident copy/take), the
overlapped and packed segment flush (K3), the packed CG matvec (K6), the
mode resolution, and the solve on packed A.

The same seeded numpy inputs go through both packages on the CPU. The
reference's Pallas kernels run in interpret mode, as
``tests/test_als_pallas.py`` runs them; the port's wrappers run their
plain versions, since the tensors lie on the CPU. A gather moves bytes, so
it must be exact; sums of the same f32 products in another order agree to
1e-6 of the largest magnitude, as the reference's own tests hold them.
"""

import _torch_cpu  # noqa: F401  (one CPU thread: see the module)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pio_tpu.ops import als as ref
from pio_tpu.ops import als_pallas as ref_k
from pio_tpu_torch.ops import als as port
from pio_tpu_torch.ops.kernels import gather_rows as gr
from pio_tpu_torch.ops.kernels import packed_matvec as pm
from pio_tpu_torch.ops.kernels import segment_flush as sf

# the reference's own bound for its streaming kernels (test_als_pallas.py)
RTOL_KERNEL = 1e-6
# one solve from the same A/b (as tests/test_torch_als_train.py)
RTOL_SOLVE = 1e-4


def _relerr(got, want) -> float:
    got = np.asarray(got.numpy() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    return float(np.abs(got - want).max() / (scale if scale else 1.0))


def _f32(t) -> np.ndarray:
    """A torch or JAX array as f32 numpy (bf16 widened exactly)."""
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _table(seed, n, k, bf16):
    rng = np.random.default_rng(seed)
    t = rng.standard_normal((n, k)).astype(np.float32)
    if bf16:
        return (jnp.asarray(t, jnp.bfloat16),
                torch.from_numpy(t).to(torch.bfloat16))
    return jnp.asarray(t), torch.from_numpy(t)


# -- K5: the streaming gather -------------------------------------------------

@pytest.mark.parametrize("k", [64, 128])
@pytest.mark.parametrize("bf16", [False, True])
def test_gather_stream_matches_reference_exactly(k, bf16):
    """An odd index count (not a multiple of the reference's step or
    group), f32 and bf16: the bytes of the rows, exactly."""
    t_r, t_p = _table(0, 37, k, bf16)
    idx = np.random.default_rng(1).integers(0, 37, 421).astype(np.int32)
    want = ref_k.gather_rows_stream(t_r, jnp.asarray(idx), rows_per_step=64,
                                    group=16, interpret=True)
    got = gr.gather_rows_stream(t_p, torch.from_numpy(idx))
    assert got.dtype == t_p.dtype and got.shape == (421, k)
    np.testing.assert_array_equal(_f32(got), _f32(want))


def test_gather_stream_odd_width_on_cpu_is_table_rows():
    """k = 5 bf16 (10-byte rows, which the kernel moves as scalars)."""
    _, t_p = _table(2, 9, 5, True)
    idx = torch.tensor([8, 0, 3, 3, 8], dtype=torch.int32)
    got = gr.gather_rows_stream(t_p, idx)
    assert torch.equal(got, t_p[idx.long()])


# -- K4: the table-resident gather ----------------------------------------------

@pytest.mark.parametrize("variant", ["copy", "take"])
@pytest.mark.parametrize("bf16", [False, True])
def test_gather_resident_matches_reference_exactly(variant, bf16):
    t_r, t_p = _table(3, 41, 64, bf16)
    idx = np.random.default_rng(4).integers(0, 41, 448).astype(np.int32)
    want = ref_k.gather_rows_pallas(t_r, jnp.asarray(idx), rows_per_step=64,
                                    variant=variant, interpret=True)
    got = gr.gather_rows_resident(t_p, torch.from_numpy(idx),
                                  variant=variant)
    np.testing.assert_array_equal(_f32(got), _f32(want))


@pytest.mark.parametrize("args", [(26_744, 64, True), (138_493, 64, True),
                                  (1000, 192, False), (5, 5, True),
                                  (40_000, 128, True), (10_000, 256, False)])
def test_gather_table_rule_is_the_reference_rule(args):
    """The size rule that sends a table to the resident kernel or to
    ``src[i_c]``: at ML-20M the items table (users half) fits, the users
    table (items half) does not."""
    assert gr.gather_table_bytes(*args) == ref_k.gather_table_bytes(*args)
    assert gr.GATHER_VMEM_TABLE_BUDGET == ref_k.GATHER_VMEM_TABLE_BUDGET
    fits = gr.gather_table_bytes(*args) <= gr.GATHER_VMEM_TABLE_BUDGET
    assert fits == (ref_k.gather_table_bytes(*args)
                    <= ref_k.GATHER_VMEM_TABLE_BUDGET)


@pytest.mark.parametrize("gather,table_rows", [
    ("pallas-copy", 25), ("pallas-take", 25), ("pallas-copy", 60_000)])
def test_chunk_blocks_gathers_match_reference(gather, table_rows):
    """_chunk_blocks with each gather mode, small table (the kernel) and
    a table over the budget (``src[i_c]``), against the reference."""
    rng = np.random.default_rng(5)
    y = rng.standard_normal((table_rows, 8)).astype(np.float32)
    i_c = rng.integers(0, table_rows, (16, 8)).astype(np.int32)
    v_c = rng.integers(1, 6, (16, 8)).astype(np.float32)
    l_c = rng.integers(0, 9, 16).astype(np.int32)
    a_r, b_r = ref._chunk_blocks(jnp.asarray(y, jnp.bfloat16),
                                 jnp.asarray(i_c), jnp.asarray(v_c),
                                 jnp.asarray(l_c), True, 2.0, gather=gather)
    a_p, b_p = port._chunk_blocks(torch.from_numpy(y).to(torch.bfloat16),
                                  torch.from_numpy(i_c), torch.from_numpy(v_c),
                                  torch.from_numpy(l_c), True, 2.0,
                                  gather=gather)
    assert _relerr(a_p, a_r) < 2e-6 and _relerr(b_p, b_r) < 2e-6


# -- K6: the packed matvec ------------------------------------------------------

@pytest.mark.parametrize("k", [8, 64])
def test_packed_matvec_matches_reference(k):
    rng = np.random.default_rng(6)
    n = 24
    A = rng.standard_normal((n, k, k)).astype(np.float32)
    A = A + np.swapaxes(A, 1, 2)          # symmetric, like a normal equation
    x = rng.standard_normal((n, k)).astype(np.float32)
    want = ref_k.packed_block_matvec(jnp.asarray(A.reshape(n, k * k)),
                                     jnp.asarray(x), block_rows=8,
                                     interpret=True)
    got = pm.packed_block_matvec(torch.from_numpy(A.reshape(n, k * k)),
                                 torch.from_numpy(x))
    exact = np.einsum("bij,bj->bi", A.astype(np.float64), x)
    assert _relerr(got, want) < RTOL_KERNEL
    assert _relerr(got, exact) < RTOL_KERNEL


def test_packed_matvec_takes_any_row_count():
    """No pad to a row block: n = 7 rows, k = 5."""
    rng = np.random.default_rng(7)
    A = torch.from_numpy(rng.standard_normal((7, 25)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((7, 5)).astype(np.float32))
    got = pm.packed_block_matvec(A, x)
    want = np.einsum("bij,bj->bi", A.double().numpy().reshape(7, 5, 5),
                     x.double().numpy())
    assert _relerr(got, want) < RTOL_KERNEL


@pytest.mark.parametrize("change, error", [
    (lambda a, x: (a.double(), x), TypeError),
    (lambda a, x: (a, x.double()), TypeError),
    (lambda a, x: (a[:, :-1].contiguous(), x), ValueError),
    (lambda a, x: (a, x[:-1]), ValueError),
    (lambda a, x: (a, x.t().contiguous().t()), ValueError),
])
def test_packed_matvec_checks_refuse_what_the_kernel_does_not_take(change,
                                                                    error):
    args = change(torch.zeros(6, 16), torch.zeros(6, 4))
    with pytest.raises(error):
        pm._check(*args)


# -- K3: the overlapped, packed flush ---------------------------------------------

def _zipf_layout(seed=7, nu=70, ni=30, nnz=4000, width=8, cs=64, k=16):
    rng = np.random.default_rng(seed)
    u = (rng.zipf(1.2, nnz) % nu).astype(np.int32)
    i = (rng.zipf(1.2, nnz) % ni).astype(np.int32)
    v = rng.integers(1, 6, nnz).astype(np.float32)
    su = ref._slots_for(nnz, nu, width, cs)
    lay_r = ref._device_slot_layout(jnp.asarray(u), jnp.asarray(i),
                                    jnp.asarray(v), nu, width, su)
    lay_p = port._device_slot_layout(torch.from_numpy(u), torch.from_numpy(i),
                                     torch.from_numpy(v), nu, width, su)
    fac = (rng.standard_normal((ni, k)) * 0.3).astype(np.float32)
    return lay_r, lay_p, fac, u


@pytest.mark.parametrize("packed", [False, True])
def test_stream_flush_matches_reference_across_groups(packed):
    """The reference's overlapped (and packed) flush in interpret mode
    against the port's accum="stream": zipf-heavy rows run across chunks
    and groups of 128 slots, so group trails and the out= chaining both
    run."""
    lay_r, lay_p, fac, _ = _zipf_layout()
    A_r, b_r = ref_k.normal_equations_hybrid(
        lay_r, jnp.asarray(fac), 70, True, 5.0, chunk_slots=64,
        group_slots=128, bf16_gather=False, interpret=True, overlap=True,
        packed=packed)
    A_p, b_p = port._normal_equations(
        lay_p, torch.from_numpy(fac), 70, True, 5.0, 64, accum="stream",
        group_slots=128, bf16_gather=False, packed=packed)
    assert A_p.shape == ((70, 256) if packed else (70, 16, 16))
    assert _relerr(A_p, A_r) < RTOL_KERNEL
    assert _relerr(b_p, b_r) < RTOL_KERNEL


def test_stream_flush_is_the_hybrid_flush_and_packing_is_a_shape():
    """K3 sums what K2 sums, add for add: on the plain versions the
    stream, packed and hybrid accumulations are equal, bit for bit, and
    empty rows stay zero."""
    _, lay_p, fac, u = _zipf_layout(seed=8, nu=400, k=8)
    y = torch.from_numpy(fac)
    kw = dict(group_slots=128, bf16_gather=False)
    A_h, b_h = port._normal_equations(lay_p, y, 400, True, 2.5, 64,
                                      accum="hybrid", **kw)
    A_s, b_s = port._normal_equations(lay_p, y, 400, True, 2.5, 64,
                                      accum="stream", **kw)
    A_p, b_p = port._normal_equations(lay_p, y, 400, True, 2.5, 64,
                                      accum="hybrid", packed=True, **kw)
    assert torch.equal(A_s, A_h) and torch.equal(b_s, b_h)
    assert A_p.shape == (400, 64)
    assert torch.equal(A_p, A_h.reshape(400, 64)) and torch.equal(b_p, b_h)
    empty = sorted(set(range(400)) - set(u.tolist()))
    assert empty and not A_p[empty].any()


def test_stream_flush_wrapper_chains_runs_into_packed_buffers():
    rng = np.random.default_rng(9)
    rows = np.sort(rng.integers(0, 12, 90)).astype(np.int32)
    rows[-9:] = 12
    r = torch.from_numpy(rows)
    a = torch.from_numpy(rng.standard_normal((90, 5, 5)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((90, 5)).astype(np.float32))
    A1, b1 = sf.segment_flush(r, a, b, 12)
    A2, b2 = torch.zeros(12, 25), torch.zeros(12, 5)
    before = sf.launches_stream.value
    for lo, hi in ((0, 31), (31, 32), (32, 90)):
        got = sf.segment_flush_stream(r[lo:hi], a[lo:hi], b[lo:hi], 12,
                                      out=(A2, b2), packed=True)
        assert got[0].data_ptr() == A2.data_ptr()
    assert sf.launches_stream.value == before   # the CPU launches nothing
    assert _relerr(A2, A1.reshape(12, 25).numpy()) < RTOL_KERNEL
    assert _relerr(b2, b1.numpy()) < RTOL_KERNEL


# -- mode resolution ----------------------------------------------------------------

@pytest.mark.parametrize("accum", ["auto", "carry", "stacked", "hybrid",
                                   "stream"])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("rank", [16, 300])
def test_resolved_accum_and_packed_match_reference(accum, packed, rank):
    kw = dict(accum=accum, packed_a=packed, rank=rank)
    p, r = port.ALSParams(**kw), ref.ALSParams(**kw)
    # on the CPU both packages pick the same modes
    assert p.resolved_accum("cpu") == r.resolved_accum()
    assert p.resolved_packed("cpu") == r.resolved_packed()
    # the card is the port's accelerator: the reference's TPU rules
    want = {"auto": "hybrid"}.get(accum, accum)
    if packed and want == "hybrid":
        want = "stream"
    if want in ("hybrid", "stream") and rank > 256:
        want = "stacked"
    assert p.resolved_accum("cuda") == want
    assert p.resolved_packed("cuda") == (packed and want == "stream")


def test_pallas_accum_still_raises():
    """accum="pallas" with the streaming configuration's packed_a and
    gather="stream": the fused path (K1) ignores both, as the reference's
    does, and gives the reference's unpacked A."""
    kw = dict(accum="pallas", gather="stream", packed_a=True)
    p, r = port.ALSParams(**kw), ref.ALSParams(**kw)
    assert p.resolved_accum("cuda") == p.resolved_accum("cpu") == \
        r.resolved_accum() == "pallas"
    assert not p.resolved_packed("cuda") and not r.resolved_packed()
    lay_r, lay_p, fac, _ = _zipf_layout(seed=12, nu=40, nnz=900, k=8)
    opts = dict(accum="pallas", gather="stream", packed=True,
                group_slots=128, bf16_gather=False)
    A_r, b_r = ref._normal_equations(lay_r, jnp.asarray(fac), 40, True, 5.0,
                                     64, **opts)
    A_p, b_p = port._normal_equations(lay_p, torch.from_numpy(fac), 40,
                                      True, 5.0, 64, **opts)
    assert A_p.shape == (40, 8, 8)
    assert _relerr(A_p, A_r) < RTOL_KERNEL
    assert _relerr(b_p, b_r) < RTOL_KERNEL


# -- the solve on packed A ----------------------------------------------------------

@pytest.mark.parametrize("cg_iters", [0, 12])
def test_solve_factors_packed_matches_reference(cg_iters):
    """One side solved on packed A (YᵀY and reg added in packed space,
    then CG on the packed matvec, or Cholesky on a view) against the
    reference's _solve_packed, which pads n to its matvec's row block."""
    lay_r, lay_p, fac, _ = _zipf_layout(seed=10, nu=37, k=8)
    fac = np.abs(fac)
    x0 = np.abs(np.random.default_rng(11).standard_normal(
        (37, 8))).astype(np.float32) / 3
    kw = dict(cg_iters=cg_iters, bf16_gather=False, accum="stream",
              packed=True, group_slots=128)
    want = ref._solve_factors(lay_r, jnp.asarray(fac), 37, 0.1, True, 3.0,
                              64, x0=jnp.asarray(x0), **kw)
    got = port._solve_factors(lay_p, torch.from_numpy(fac), 37, 0.1, True,
                              3.0, 64, x0=torch.from_numpy(x0), **kw)
    assert _relerr(got, want) < RTOL_SOLVE
