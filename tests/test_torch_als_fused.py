"""ALS training's fused accumulation (``accum="pallas"``, K1) in the
PyTorch port against ``pio_tpu``.

The same seeded numpy inputs go through the reference's
``normal_equations_pallas`` in interpret mode (as ``tests/test_als_pallas.py``
runs it) and the port's ``normal_equations_fused``, whose wrapper computes
its plain version for CPU tensors. Both sum the same f32 products in other
orders, so A and b agree within ``RTOL_BLOCKS`` and trained factors within
``RTOL_TRAIN`` (the bounds of ``tests/test_torch_als_train.py``). The
interpret-mode kernel loops over slots one by one, so the shapes are tiny.
"""

import _torch_cpu  # noqa: F401  (one CPU thread: see the module)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pio_tpu.ops import als as ref
from pio_tpu.ops import als_pallas as ref_k
from pio_tpu_torch.ops import als as port
from pio_tpu_torch.ops.kernels import segment_flush as sf
from tests.test_torch_als_train import (
    RTOL_BLOCKS,
    TRAIN_CASES,
    _assert_same_model,
    _close,
    _layout,
    _train_both,
)


def _skewed_layout(seed, n_self=20, n_other=17, nnz=300, width=8,
                   chunk_slots=16):
    """Rows of skewed length (some many slots long), rows 5 and 6 empty,
    and a sentinel tail, in both packages' layouts, plus factors."""
    rng = np.random.default_rng(seed)
    probs = rng.dirichlet(np.full(n_self, 0.3))
    probs[5] = probs[6] = 0.0
    probs /= probs.sum()
    u = rng.choice(n_self, size=nnz, p=probs).astype(np.int32)
    o = rng.integers(0, n_other, nnz).astype(np.int32)
    v = (rng.random(nnz) * 4 + 1).astype(np.float32)
    slots = ref._slots_for(nnz, n_self, width, chunk_slots)
    lay_r = ref._device_slot_layout(jnp.asarray(u), jnp.asarray(o),
                                    jnp.asarray(v), n_self, width, slots)
    lay_p = port._device_slot_layout(torch.from_numpy(u), torch.from_numpy(o),
                                     torch.from_numpy(v), n_self, width,
                                     slots)
    fac = rng.standard_normal((n_other, 8)).astype(np.float32)
    return lay_r, lay_p, fac, u


@pytest.mark.parametrize("implicit,bf16,group_slots", [
    (False, False, 16), (True, True, 16),       # rows span groups
    (True, False, 65536), (False, True, 65536),
])
def test_plain_k1_matches_reference_kernel(implicit, bf16, group_slots):
    """K1's plain version against the reference's kernel in interpret
    mode: chunks of 8 slots, and groups of 16 where asked, so the long
    rows run across chunks and groups and their trails fold."""
    lay_r, lay_p, fac, u = _skewed_layout(seed=int(implicit) + 2 * int(bf16))
    assert int((lay_p[0] == 20).sum()) > 0           # a sentinel tail
    A_r, b_r = ref_k.normal_equations_pallas(
        lay_r, jnp.asarray(fac), 20, implicit, 2.5, chunk_slots=8,
        group_slots=group_slots, bf16_gather=bf16, interpret=True)
    src = torch.from_numpy(fac).to(torch.bfloat16 if bf16 else torch.float32)
    before = sf.launches_fused.value
    A_p, b_p = sf.normal_equations_fused(*lay_p, src, 20, implicit, 2.5)
    assert sf.launches_fused.value == before         # the CPU launches nothing
    assert A_p.shape == (20, 8, 8) and b_p.shape == (20, 8)
    _close(A_p, A_r, RTOL_BLOCKS)
    _close(b_p, b_r, RTOL_BLOCKS)
    for empty in (5, 6):
        assert empty not in set(u.tolist())
        assert not A_p[empty].any() and not b_p[empty].any()


@pytest.mark.parametrize("implicit", [False, True])
def test_normal_equations_pallas_match_reference(implicit):
    """``_normal_equations(accum="pallas")``: the layout of
    tests/test_torch_als_train.py (row 1 holds a third of the ratings),
    with the reference's chunk cap of 128 slots."""
    want_l, got_l = _layout(5)
    y = np.random.default_rng(6).standard_normal((25, 8)).astype(np.float32)
    kw = dict(bf16_gather=True, accum="pallas", group_slots=32)
    A_r, b_r = ref._normal_equations(want_l, jnp.asarray(y), 30, implicit,
                                     2.0, 16, **kw)
    A_p, b_p = port._normal_equations(got_l, torch.from_numpy(y), 30,
                                      implicit, 2.0, 16, **kw)
    _close(A_p, A_r, RTOL_BLOCKS)
    _close(b_p, b_r, RTOL_BLOCKS)
    assert not A_p[28:].any()          # the two empty rows stay zero


@pytest.mark.parametrize("case", TRAIN_CASES)
def test_als_train_pallas_matches_reference_from_shared_init(case):
    got, want = _train_both(case, accum="pallas")
    _assert_same_model(got, want, 60)


@pytest.mark.parametrize("rank", [16, 300])
@pytest.mark.parametrize("packed", [False, True])
def test_pallas_resolves_as_the_reference(rank, packed):
    """No rank fallback and no packed promotion: "pallas" at every rank,
    A unpacked, on the card as on the CPU."""
    kw = dict(accum="pallas", rank=rank, packed_a=packed)
    p, r = port.ALSParams(**kw), ref.ALSParams(**kw)
    assert r.resolved_accum() == "pallas" and not r.resolved_packed()
    for dev in ("cpu", "cuda"):
        assert p.resolved_accum(dev) == r.resolved_accum()
        assert p.resolved_packed(dev) == r.resolved_packed()


def test_pallas_with_gather_stream_launches_no_gather(monkeypatch):
    """K1 gathers itself: with gather="stream" (and the other knobs the
    fused path ignores) no gather runs, the fused wrapper runs once per
    half and sweep, and A and b are those of gather="xla"."""
    def no_gather(*args, **kwargs):
        raise AssertionError("a gather ran on the fused path")

    calls = []

    def counted(*args, **kwargs):
        calls.append(args[5])                   # n_self
        return sf.normal_equations_fused(*args, **kwargs)

    _, got_l = _layout(9)
    y = torch.from_numpy(
        np.random.default_rng(20).standard_normal((25, 8)).astype(np.float32))
    want = port._normal_equations(got_l, y, 30, True, 1.5, 16,
                                  accum="pallas", gather="xla")
    for name in ("gather_rows_stream", "gather_rows_resident", "_gather"):
        monkeypatch.setattr(port, name, no_gather)
    monkeypatch.setattr(port, "normal_equations_fused", counted)
    got = port._normal_equations(got_l, y, 30, True, 1.5, 16, accum="pallas",
                                 gather="stream", packed=True, group_slots=16)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert calls == [30]
    rng = np.random.default_rng(21)
    u = rng.integers(0, 12, 200).astype(np.int32)
    i = rng.integers(0, 9, 200).astype(np.int32)
    v = rng.integers(1, 6, 200).astype(np.float32)
    calls.clear()
    port.als_train(u, i, v, 12, 9, port.ALSParams(
        rank=4, iterations=2, chunk=64, width=8, chunk_slots=16,
        accum="pallas", gather="stream", packed_a=True), device="cpu")
    assert calls == [12, 9, 12, 9]


# -- K1's arithmetic on the tensor cores, emulated on the CPU -----------------

_TF32_HI = -(1 << 13)          # as int32: sign, exponent, 10 mantissa bits


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """TF32 as the tensor cores read an f32 operand: the low 13 mantissa
    bits cleared."""
    return (x.view(torch.int32) & _TF32_HI).view(torch.float32)


def _split(x: torch.Tensor):
    hi = _tf32(x)
    return hi, _tf32(x - hi)        # x - hi is exact in f32


def _k1_emulation(lay, src, n_self, implicit, alpha, route):
    """A and b as K1 computes them, with the tensor cores' products
    emulated exactly and their f32 sum idealized. The tile's entry stream
    (64 slots a tile) is cut into steps of 32 entries and runs of one row;
    each run's products are summed exactly and rounded to f32, runs join
    their row's sum in f32, and tiles' sums join in tile order (the fold).
    route: "3xtf32" (f32 Y: lo*hi + hi*lo + hi*hi), "2xtf32" (bf16 Y,
    exact in TF32: y*lo + y*hi of the weighted operand), "1xtf32" (one
    pass, which the kernel must not use). b: the products of one run in
    f32 FMAs, idealized the same way."""
    rows, idx, val, lens = lay
    s, w = idx.shape
    k = src.shape[1]
    live = (torch.arange(w)[None, :] < lens[:, None]) & (rows < n_self)[:, None]
    slot = torch.arange(s)[:, None].expand(s, w)[live]
    row = rows[slot].long()
    y = src[idx[live].long()].float()                    # (E, k)
    v = val[live]
    wo = alpha * v if implicit else torch.ones_like(v)
    wr = 1.0 + alpha * v if implicit else v
    yw = y * wo[:, None]                                 # f32, as staged
    tile = slot // 64
    pos = torch.arange(slot.numel()) - torch.searchsorted(slot, tile * 64)
    step = pos // 32
    key = torch.stack([tile, step, row], 1)
    new = torch.ones(key.shape[0], dtype=torch.bool)
    new[1:] = (key[1:] != key[:-1]).any(1)
    piece = torch.cumsum(new.long(), 0) - 1               # run of each entry
    n_pieces = int(piece[-1]) + 1
    first = torch.nonzero(new)[:, 0]
    at = torch.arange(piece.numel()) - first[piece]
    if route == "3xtf32":
        (ah, al), (bh, bl) = _split(y), _split(yw)
        terms = [(al, bh), (ah, bl), (ah, bh)]
    elif route == "2xtf32":
        assert torch.equal(_tf32(y), y)                  # bf16 is exact
        bh, bl = _split(yw)
        terms = [(y, bl), (y, bh)]
    else:
        terms = [(_tf32(y), _tf32(yw))]
    blk_a = torch.zeros((n_pieces, k, k), dtype=torch.float64)
    for a, bb in terms:
        pa = torch.zeros((n_pieces, 32, k), dtype=torch.float64)
        pb = torch.zeros((n_pieces, 32, k), dtype=torch.float64)
        pa[piece, at] = a.double()
        pb[piece, at] = bb.double()
        blk_a += pa.transpose(1, 2) @ pb
    blk_b = torch.zeros((n_pieces, k), dtype=torch.float64)
    blk_b.index_add_(0, piece, y.double() * wr.double()[:, None])
    blk_a, blk_b = blk_a.float(), blk_b.float()
    # runs into their (tile, row) sum, then tiles into the row, in f32
    p_tile, p_row = tile[first], row[first]
    A = torch.zeros((n_self, k, k))
    b = torch.zeros((n_self, k))
    seg_a, seg_b, seg_key = None, None, None
    for i in range(n_pieces):
        cur = (int(p_tile[i]), int(p_row[i]))
        if cur != seg_key:
            if seg_key is not None:
                A[seg_key[1]] += seg_a
                b[seg_key[1]] += seg_b
            seg_a, seg_b, seg_key = blk_a[i].clone(), blk_b[i].clone(), cur
        else:
            seg_a += blk_a[i]
            seg_b += blk_b[i]
    A[seg_key[1]] += seg_a
    b[seg_key[1]] += seg_b
    return A, b


def _ml20m_like_layout(seed):
    """ML-20M-like statistics at a small size: rank 64, slots of 128,
    zipf-popular opposing rows, ratings 1..5 with alpha 10, one heavy row
    of 20,000 entries (about three tiles of slots) among short ones; the
    factors as ``init_factors`` draws them."""
    rng = np.random.default_rng(seed)
    n_self, n_other, k = 40, 2000, 64
    counts = np.minimum(rng.zipf(1.3, n_self) * 20, 3000)
    counts[7] = 20_000
    u = np.repeat(np.arange(n_self), counts).astype(np.int32)
    o = ((rng.zipf(1.2, u.size) - 1) % n_other).astype(np.int32)
    v = rng.integers(1, 6, u.size).astype(np.float32)
    slots = port._slots_for(u.size, n_self, 128, 16)
    lay = port._device_slot_layout(torch.from_numpy(u), torch.from_numpy(o),
                                   torch.from_numpy(v), n_self, 128, slots)
    y = np.abs(rng.standard_normal((n_other, k))) / np.sqrt(k)
    return lay, torch.from_numpy(y.astype(np.float32)), n_self


def _row_rel(got, want) -> float:
    n = want.shape[0]
    g, w = got.double().reshape(n, -1), want.reshape(n, -1)
    return float(((g - w).abs().amax(1) / w.abs().amax(1).clamp_min(1e-30))
                 .max())


# chip_smoke.py's and tests/test_torch_kernels.py's bound for K1 against f64
FLUSH_RTOL = 1e-5


@pytest.mark.parametrize("bf16", [False, True])
def test_k1_split_products_hold_the_flush_tolerance(bf16):
    """The kernel's route for each Y type (3xTF32 for f32, 2xTF32 for bf16)
    keeps A and b within FLUSH_RTOL of f64, row by row."""
    lay, y, n_self = _ml20m_like_layout(seed=int(bf16))
    src = y.bfloat16() if bf16 else y
    A, b = _k1_emulation(lay, src, n_self, True, 10.0,
                         "2xtf32" if bf16 else "3xtf32")
    wa, wb = sf.normal_equations_fused_reference(*lay, src.double(), n_self,
                                                 True, 10.0)
    assert _row_rel(A, wa) <= FLUSH_RTOL
    assert _row_rel(b, wb) <= FLUSH_RTOL


@pytest.mark.parametrize("bf16", [False, True])
def test_k1_single_tf32_pass_breaks_the_flush_tolerance(bf16):
    """One TF32 pass, the route the kernel must not take, puts A far
    outside FLUSH_RTOL on the same inputs."""
    lay, y, n_self = _ml20m_like_layout(seed=int(bf16))
    src = y.bfloat16() if bf16 else y
    A, _ = _k1_emulation(lay, src, n_self, True, 10.0, "1xtf32")
    wa, _ = sf.normal_equations_fused_reference(*lay, src.double(), n_self,
                                                True, 10.0)
    assert _row_rel(A, wa) > 10 * FLUSH_RTOL
