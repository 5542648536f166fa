"""The port's CUDA kernel wrappers, without JAX: the quantized scan (K7),
the segment flush (K2) and its overlapped, packed form (K3), the fused
normal equations (K1), the row gathers (K5 stream, K4 resident copy/take),
the packed matvec (K6) and flash attention (K8); and the serving top-k's
tie order on the card.

On the CPU a wrapper computes its kernel's plain version and launches
nothing; it refuses inputs its kernel does not take. On a card the kernel
must agree with the plain version. This file imports neither JAX nor
``pio_tpu``, so it also runs on a machine with a card and no JAX:

    python -m pytest tests/test_torch_kernels.py --noconftest -q
"""

import _torch_cpu  # noqa: F401  (one CPU thread: see the module)
import numpy as np
import pytest
import torch

from pio_tpu_torch.ops import als
from pio_tpu_torch.ops import retrieval as rt
from pio_tpu_torch.ops.kernels import flash_attention as k8
from pio_tpu_torch.ops.kernels import gather_rows as gr
from pio_tpu_torch.ops.kernels import packed_matvec as pm
from pio_tpu_torch.ops.kernels import quantized_scan as qscan
from pio_tpu_torch.ops.kernels import segment_flush as sf

# the kernel and the plain version sum k=16 f32 products of the same
# dequantized values in different orders
RTOL = 1e-5
ATOL = 1e-5


def _scan_args(dtype, seed, b=3, p=4, device="cpu"):
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((24, 16)).astype(np.float32)
    rows = (centres[rng.integers(0, 24, 600)]
            + 0.25 * rng.standard_normal((600, 16))).astype(np.float32)
    index = rt.build_index(rows, rt.RetrievalParams(
        mode="clustered", dtype=dtype, nprobe=p))
    didx = rt.build_device_index(index, device)
    top_c = rng.choice(didx.n_clusters, size=(b, p)).astype(np.int32)
    u = rng.standard_normal((b, 16)).astype(np.float32)
    return (didx.table, didx.scales, didx.gidx,
            torch.from_numpy(top_c).to(device), torch.from_numpy(u).to(device))


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_scan_wrapper_on_cpu_is_the_plain_version(dtype):
    """On CPU tensors the wrapper computes the plain version and launches
    nothing, so the launch count stays put."""
    args = _scan_args(dtype, seed=4)
    before = qscan.launches.value
    got = qscan.quantized_scan(*args)
    assert qscan.launches.value == before
    assert torch.equal(got, qscan.quantized_scan_reference(*args))


def test_plain_version_masks_pads_and_scales_after_the_dot():
    table = torch.tensor([[[1, 2], [3, 4]], [[-5, 6], [0, 0]]],
                         dtype=torch.int8)
    scales = torch.tensor([[0.5, 2.0], [0.25, 1.0]])
    gidx = torch.tensor([[7, 3], [1, -1]], dtype=torch.int32)
    top_c = torch.tensor([[1, 0]], dtype=torch.int32)
    u = torch.tensor([[1.0, -1.0]])
    got = qscan.quantized_scan_reference(table, scales, gidx, top_c, u)
    # cluster 1 then cluster 0; its pad slot (gidx -1) scores -inf
    assert got.tolist() == [[(-5 - 6) * 0.25, float("-inf"),
                             (1 - 2) * 0.5, (3 - 4) * 2.0]]


@pytest.mark.parametrize("change, error", [
    (lambda a: (a[0].float(), *a[1:]), TypeError),
    (lambda a: (a[0], a[1].double(), *a[2:]), TypeError),
    (lambda a: (*a[:3], a[3].long(), a[4]), TypeError),
    (lambda a: (a[0], a[1][:, :-1].contiguous(), *a[2:]), ValueError),
    (lambda a: (*a[:4], a[4][:, :-1].contiguous()), ValueError),
    (lambda a: (a[0].transpose(0, 1), *a[1:]), ValueError),
])
def test_wrapper_checks_refuse_what_the_kernel_does_not_take(change, error):
    args = change(_scan_args("int8", seed=5))
    with pytest.raises(error):
        qscan._check(*args)


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_scan_kernel_matches_plain_version_on_card(dtype):
    """The CUDA kernel against its plain version on the card (chip_smoke.py
    runs the same check at the main path's full width)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    args = _scan_args(dtype, seed=7, b=16, p=8, device="cuda")
    before = qscan.launches.value
    got = qscan.quantized_scan(*args)
    torch.cuda.synchronize()
    assert qscan.launches.value == before + 1
    want = qscan.quantized_scan_reference(*args)
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    fin = torch.isfinite(want)
    torch.testing.assert_close(got[fin], want[fin], rtol=RTOL, atol=ATOL)


def _scan_layout(dtype, k, b, p, seed, c=48, lmax=256, front=False,
                 device="cpu"):
    """A scan index made directly: each cluster holds a random number of
    real rows (cluster 0 none), at random slots among the pads unless
    ``front``; the probes include cluster 0 in every query."""
    rng = np.random.default_rng(seed)
    n_real = rng.integers(0, lmax + 1, c)
    n_real[0] = 0
    n_real[1] = lmax
    gidx = np.full((c, lmax), -1, np.int32)
    for ci in range(c):
        pos = (np.arange(n_real[ci]) if front
               else rng.choice(lmax, n_real[ci], replace=False))
        gidx[ci, pos] = rng.integers(0, 10 ** 6, n_real[ci])
    if dtype == "int8":
        table = torch.from_numpy(
            rng.integers(-127, 128, (c, lmax, k)).astype(np.int8))
        scales = rng.uniform(0.5, 1.5, (c, lmax)) / 127
    else:
        table = torch.from_numpy(
            rng.standard_normal((c, lmax, k)).astype(np.float32)).bfloat16()
        scales = rng.uniform(0.5, 1.5, (c, lmax))
    top_c = np.stack([np.concatenate([[0], rng.choice(
        np.arange(1, c), p - 1, replace=False)]) for _ in range(b)])
    u = rng.standard_normal((b, k)).astype(np.float32)
    return (table.to(device),
            torch.from_numpy(scales.astype(np.float32)).to(device),
            torch.from_numpy(gidx).to(device),
            torch.from_numpy(top_c.astype(np.int32)).to(device),
            torch.from_numpy(u).to(device))


def _assert_scan_close(got, want):
    """The -inf pattern exactly; finite scores within RTOL of themselves
    plus ATOL of the largest score (k f32 products in another order)."""
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    fin = torch.isfinite(want)
    assert bool(torch.isfinite(got[fin]).all())
    err = (got[fin] - want[fin]).abs()
    tol = RTOL * want[fin].abs() + ATOL * want[fin].abs().max()
    assert bool((err <= tol).all())


def test_scan_layout_puts_pads_between_real_rows():
    """The card tests' index: pads inside clusters, cluster 0 all pads
    and probed by every query, and the plain version masks them all."""
    table, scales, gidx, top_c, u = _scan_layout("int8", 24, 3, 32, seed=1)
    real = gidx >= 0
    first_pad = (~real).int().argmax(dim=1)
    assert any(bool(real[ci, int(first_pad[ci]):].any())
               for ci in range(gidx.shape[0]))
    assert not real[0].any() and bool((top_c[:, 0] == 0).all())
    want = qscan.quantized_scan_reference(table, scales, gidx, top_c, u)
    assert torch.equal(torch.isneginf(want).reshape(3, 32, -1),
                       ~real[top_c.long()])


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("k", [5, 24, 64, 72])
@pytest.mark.parametrize("b", [1, 16, 128])
def test_scan_kernel_pads_anywhere_on_card(dtype, k, b):
    """K7 at the main path's nprobe 32, B 1, 16 and 128: pads between real
    rows and an all-pad cluster give the plain version's -inf pattern, k
    off the 16-byte vector width (5, 24, 72 in int8; 5 in bf16) reads
    rows element by element, and two launches are bit-identical."""
    dev = _cuda()
    args = _scan_layout(dtype, k, b, 32, seed=k + b, device=dev)
    before = qscan.launches.value
    got = qscan.quantized_scan(*args)
    again = qscan.quantized_scan(*args)
    torch.cuda.synchronize()
    assert qscan.launches.value == before + 2
    assert torch.equal(got, again)
    _assert_scan_close(got, qscan.quantized_scan_reference(*args))


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_scan_kernel_front_packed_and_misaligned_table_on_card(dtype):
    """Real rows packed first, as ``build_device_index`` packs them; and
    the same table at an offset that breaks 16-byte alignment, which the
    kernel reads element by element."""
    dev = _cuda()
    table, scales, gidx, top_c, u = _scan_layout(
        dtype, 64, 16, 32, seed=3, front=True, device=dev)
    want = qscan.quantized_scan_reference(table, scales, gidx, top_c, u)
    _assert_scan_close(qscan.quantized_scan(table, scales, gidx, top_c, u),
                       want)
    flat = torch.empty(table.numel() + 1, dtype=table.dtype, device=dev)
    shifted = flat[1:].view(table.shape)
    shifted.copy_(table)
    assert shifted.data_ptr() % 16 != 0
    _assert_scan_close(qscan.quantized_scan(shifted, scales, gidx, top_c, u),
                       want)


def test_scan_empty_launch_on_card():
    """The launch floor: an empty kernel on the scan's grid, not counted."""
    dev = _cuda()
    before = qscan.launches.value
    qscan.empty_launch(128, 32, 1024, dev)
    torch.cuda.synchronize()
    assert qscan.launches.value == before


# -- segment flush (K2) -------------------------------------------------------

# the kernel and the plain version sum the same f32 blocks in other
# orders; held against the plain version evaluated in f64, per row of A
# relative to that row's largest magnitude
FLUSH_RTOL = 1e-5


def _flush_args(s, k, n_self, seed, heavy=0, pad=0, device="cpu"):
    """Sorted rows over [0, n_self) (some rows empty, one row `heavy`
    slots long) with `pad` sentinel slots at the end."""
    rng = np.random.default_rng(seed)
    rows = np.sort(rng.integers(0, n_self, s - pad - heavy))
    rows = np.sort(np.concatenate([rows, np.full(heavy, n_self // 2)]))
    rows = np.concatenate([rows, np.full(pad, n_self)]).astype(np.int32)
    a = rng.standard_normal((s, k, k)).astype(np.float32)
    b = rng.standard_normal((s, k)).astype(np.float32)
    return (torch.from_numpy(rows).to(device), torch.from_numpy(a).to(device),
            torch.from_numpy(b).to(device))


def _assert_rows_close(got, want):
    got = got.double().reshape(got.shape[0], -1)
    want = want.reshape(want.shape[0], -1)
    tol = FLUSH_RTOL * want.abs().amax(dim=1, keepdim=True)
    assert bool(((got - want).abs() <= tol).all())


def test_flush_wrapper_on_cpu_is_the_plain_version():
    rows, a, b = _flush_args(300, 6, 40, seed=1, heavy=80, pad=17)
    before = sf.launches.value
    A, bb = sf.segment_flush(rows, a, b, 40)
    assert sf.launches.value == before
    want = sf.segment_flush_reference(rows, a, b, 40)
    assert torch.equal(A, want[0]) and torch.equal(bb, want[1])


def test_flush_plain_version_sums_rows_and_drops_pads():
    rows = torch.tensor([0, 0, 2, 3, 3], dtype=torch.int32)
    a = torch.arange(5.0).reshape(5, 1, 1)
    b = torch.arange(5.0).reshape(5, 1) * 10
    A, bb = sf.segment_flush_reference(rows, a, b, 3)
    assert A.flatten().tolist() == [1.0, 0.0, 2.0]
    assert bb.flatten().tolist() == [10.0, 0.0, 20.0]


@pytest.mark.parametrize("change, error", [
    (lambda r, a, b, A, B: (r.long(), a, b, A, B), TypeError),
    (lambda r, a, b, A, B: (r, a.double(), b, A, B), TypeError),
    (lambda r, a, b, A, B: (r, a, b[:-1], A, B), ValueError),
    (lambda r, a, b, A, B: (r, a, b, A[:-1], B), ValueError),
    (lambda r, a, b, A, B: (r, a.transpose(1, 2), b, A, B), ValueError),
])
def test_flush_checks_refuse_what_the_kernel_does_not_take(change, error):
    rows, a, b = _flush_args(50, 4, 9, seed=2)
    args = change(rows, a, b, torch.zeros(9, 4, 4), torch.zeros(9, 4))
    with pytest.raises(error):
        sf._check(args[0], args[1], args[2], 9, args[3], args[4])


def test_flush_refuses_rank_above_256():
    rows = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="256"):
        sf._check(rows, torch.zeros(1, 257, 257), torch.zeros(1, 257), 1,
                  torch.zeros(1, 257, 257), torch.zeros(1, 257))


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("k", [16, 64, 128, 256, 5])
@pytest.mark.parametrize("s,heavy,pad", [
    (1, 0, 0),         # one slot
    (999, 0, 0),       # odd S, no pads
    (777, 500, 0),     # one row across many 64-slot tiles
    (1001, 200, 333),  # a sentinel tail after a long row
    (130, 0, 130),     # all sentinels
])
def test_flush_kernel_matches_plain_version_on_card(k, s, heavy, pad):
    dev = _cuda()
    if k == 256 and s > 500:
        s, heavy, pad = s // 3, heavy // 3, pad // 3
    rows, a, b = _flush_args(s, k, 61, seed=k + s, heavy=heavy, pad=pad,
                             device=dev)
    before = sf.launches.value
    A1, b1 = sf.segment_flush(rows, a, b, 61)
    A2, b2 = sf.segment_flush(rows, a, b, 61)
    torch.cuda.synchronize()
    assert sf.launches.value == before + 2
    # no float atomics: two launches are bit-identical
    assert torch.equal(A1, A2) and torch.equal(b1, b2)
    wa, wb = sf.segment_flush_reference(rows, a.double(), b.double(), 61)
    _assert_rows_close(A1, wa)
    _assert_rows_close(b1, wb)


def test_flush_kernel_runs_chain_into_one_buffer_on_card():
    """out=: consecutive slot runs, split inside a long row, flushed in
    order into one zeroed (A, b), give the sums over all of them."""
    dev = _cuda()
    rows, a, b = _flush_args(1500, 64, 50, seed=3, heavy=700, pad=100,
                             device=dev)
    A = torch.zeros(50, 64, 64, device=dev)
    bb = torch.zeros(50, 64, device=dev)
    cut = int(torch.searchsorted(rows, 25)) + 3   # inside the long row
    for lo, hi in ((0, 100), (100, cut), (cut, 1500)):
        sf.segment_flush(rows[lo:hi], a[lo:hi], b[lo:hi], 50, out=(A, bb))
    torch.cuda.synchronize()
    wa, wb = sf.segment_flush_reference(rows, a.double(), b.double(), 50)
    _assert_rows_close(A, wa)
    _assert_rows_close(bb, wb)


# -- the overlapped, packed flush (K3) ----------------------------------------

def test_stream_flush_wrapper_on_cpu_is_the_plain_version():
    rows, a, b = _flush_args(300, 6, 40, seed=4, heavy=80, pad=17)
    before = sf.launches_stream.value
    A, bb = sf.segment_flush_stream(rows, a, b, 40, packed=True)
    assert sf.launches_stream.value == before
    want = sf.segment_flush_reference(rows, a, b, 40)
    assert A.shape == (40, 36)
    assert torch.equal(A, want[0].reshape(40, 36)) and torch.equal(bb,
                                                                   want[1])


@pytest.mark.parametrize("k", [5, 16, 64, 128])
@pytest.mark.parametrize("s,heavy,pad", [
    (1, 0, 0), (999, 0, 0), (777, 500, 0), (1001, 200, 333), (130, 0, 130),
])
def test_stream_flush_kernel_is_bitwise_k2_on_card(k, s, heavy, pad):
    """K3 adds what K2 adds in the same order: A and b bit-identical to
    K2's, packed equal to unpacked reshaped, and both within the flush
    tolerance of the f64 sums."""
    dev = _cuda()
    rows, a, b = _flush_args(s, k, 61, seed=k + s + 1, heavy=heavy, pad=pad,
                             device=dev)
    before = sf.launches_stream.value
    A2, b2 = sf.segment_flush(rows, a, b, 61)
    A3, b3 = sf.segment_flush_stream(rows, a, b, 61)
    Ap, bp = sf.segment_flush_stream(rows, a, b, 61, packed=True)
    torch.cuda.synchronize()
    assert sf.launches_stream.value == before + 2
    assert torch.equal(A3, A2) and torch.equal(b3, b2)
    assert Ap.shape == (61, k * k)
    assert torch.equal(Ap, A2.reshape(61, k * k)) and torch.equal(bp, b2)
    wa, wb = sf.segment_flush_reference(rows, a.double(), b.double(), 61)
    _assert_rows_close(A3, wa)
    _assert_rows_close(b3, wb)


def test_stream_flush_kernel_runs_chain_into_packed_buffer_on_card():
    dev = _cuda()
    rows, a, b = _flush_args(1500, 64, 50, seed=5, heavy=700, pad=100,
                             device=dev)
    A = torch.zeros(50, 64 * 64, device=dev)
    bb = torch.zeros(50, 64, device=dev)
    cut = int(torch.searchsorted(rows, 25)) + 3   # inside the long row
    for lo, hi in ((0, 100), (100, cut), (cut, 1500)):
        sf.segment_flush_stream(rows[lo:hi], a[lo:hi], b[lo:hi], 50,
                                out=(A, bb), packed=True)
    A2, b2 = torch.zeros(50, 64, 64, device=dev), torch.zeros(50, 64,
                                                               device=dev)
    for lo, hi in ((0, 100), (100, cut), (cut, 1500)):
        sf.segment_flush(rows[lo:hi], a[lo:hi], b[lo:hi], 50, out=(A2, b2))
    torch.cuda.synchronize()
    assert torch.equal(A, A2.reshape(50, -1)) and torch.equal(bb, b2)


# -- the row gathers (K5, K4) ------------------------------------------------

def _gather_args(n, k, m, dtype, seed, device="cpu"):
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(
        rng.standard_normal((n, k)).astype(np.float32)).to(dtype)
    idx = torch.from_numpy(rng.integers(0, n, m).astype(np.int32))
    return table.to(device), idx.to(device)


def test_gather_wrappers_on_cpu_are_the_plain_version():
    table, idx = _gather_args(20, 6, 77, torch.bfloat16, seed=1)
    before = (gr.launches_stream.value, gr.launches_resident.value)
    want = table[idx.long()]
    assert torch.equal(gr.gather_rows_stream(table, idx), want)
    for variant in gr.VARIANTS:
        assert torch.equal(gr.gather_rows_resident(table, idx, variant), want)
    assert (gr.launches_stream.value, gr.launches_resident.value) == before


@pytest.mark.parametrize("change, error", [
    (lambda t, i: (t.half(), i), TypeError),
    (lambda t, i: (t, i.long()), TypeError),
    (lambda t, i: (t[None], i), ValueError),
    (lambda t, i: (t.t(), i), ValueError),
])
def test_gather_checks_refuse_what_the_kernel_does_not_take(change, error):
    table, idx = _gather_args(8, 4, 10, torch.float32, seed=2)
    with pytest.raises(error):
        gr._check(*change(table, idx))


def test_gather_resident_refuses_unknown_variant():
    table, idx = _gather_args(8, 4, 10, torch.float32, seed=3)
    with pytest.raises(ValueError, match="variant"):
        gr.gather_rows_resident(table, idx, "scan")


@pytest.mark.parametrize("k", [5, 16, 64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [1, 511, 70_001])
def test_gather_kernels_match_plain_version_on_card(k, dtype, m):
    """K5 and both K4 variants move exactly the table's rows: equal to
    ``table[idx]`` bit for bit, the ragged tail included."""
    dev = _cuda()
    table, idx = _gather_args(3000, k, m, dtype, seed=k + m, device=dev)
    want = gr.gather_rows_reference(table, idx)
    before = (gr.launches_stream.value, gr.launches_resident.value)
    got = [gr.gather_rows_stream(table, idx)] + [
        gr.gather_rows_resident(table, idx, v) for v in gr.VARIANTS]
    torch.cuda.synchronize()
    assert (gr.launches_stream.value, gr.launches_resident.value) == (
        before[0] + 1, before[1] + 2)
    for g in got:
        assert g.dtype == dtype and torch.equal(g, want)


# K4's take variant: the output as one run of 16-byte vectors, 1024 a CTA.
# Rows of 1 to 125 vectors, widths that are not a power of two (so rows
# straddle the CTAs' runs), M off a multiple of anything; and rows that
# are not whole vectors (k 5 bf16, 10 B; k 6 f32, 24 B) or a table whose
# start is not 16-byte aligned, which take the element kernel.
@pytest.mark.parametrize("k,dtype", [
    (8, torch.bfloat16), (24, torch.bfloat16), (64, torch.bfloat16),
    (1000, torch.bfloat16), (4, torch.float32), (12, torch.float32),
    (5, torch.bfloat16), (6, torch.float32)])
@pytest.mark.parametrize("m", [1, 1023, 4097, 70_001])
def test_gather_take_is_bitwise_table_rows_on_card(k, dtype, m):
    dev = _cuda()
    table, idx = _gather_args(3000, k, m, dtype, seed=k * m, device=dev)
    before = gr.launches_resident.value
    got = gr.gather_rows_resident(table, idx, "take")
    torch.cuda.synchronize()
    assert gr.launches_resident.value == before + 1
    assert got.dtype == dtype and torch.equal(got, table[idx.long()])
    flat = torch.empty(3000 * k + 1, dtype=dtype, device=dev)
    shifted = flat[1:].view(3000, k)          # start 2 or 4 bytes off 16
    shifted.copy_(table)
    assert torch.equal(gr.gather_rows_resident(shifted, idx, "take"),
                       table[idx.long()])


# -- the packed matvec (K6) ----------------------------------------------------

# the kernel and the plain version sum k f32 products in other orders;
# each output is held against the f64 product, relative to the sum of the
# magnitudes of its terms
MATVEC_RTOL = 1e-6


def _matvec_args(n, k, seed, device="cpu"):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, k, k)).astype(np.float32)
    a = a + np.swapaxes(a, 1, 2)
    x = rng.standard_normal((n, k)).astype(np.float32)
    return (torch.from_numpy(a.reshape(n, k * k)).to(device),
            torch.from_numpy(x).to(device))


def _assert_matvec_close(got, a, x):
    n, k = x.shape
    a3 = a.double().view(n, k, k)
    want = torch.bmm(a3, x.double()[:, :, None])[:, :, 0]
    scale = torch.bmm(a3.abs(), x.double().abs()[:, :, None])[:, :, 0]
    assert bool(((got.double() - want).abs() <= MATVEC_RTOL * scale).all())


def test_matvec_wrapper_on_cpu_is_the_plain_version():
    a, x = _matvec_args(9, 6, seed=1)
    before = pm.launches.value
    got = pm.packed_block_matvec(a, x)
    assert pm.launches.value == before
    assert torch.equal(got, pm.packed_block_matvec_reference(a, x))
    _assert_matvec_close(got, a, x)


def test_matvec_refuses_rank_above_256():
    with pytest.raises(ValueError, match="256"):
        pm._check(torch.zeros(1, 257 * 257), torch.zeros(1, 257))


@pytest.mark.parametrize("k", [5, 16, 64, 128])
@pytest.mark.parametrize("n", [1, 9, 4099])
def test_matvec_kernel_matches_plain_version_on_card(k, n):
    dev = _cuda()
    a, x = _matvec_args(n, k, seed=k + n, device=dev)
    before = pm.launches.value
    got = pm.packed_block_matvec(a, x)
    torch.cuda.synchronize()
    assert pm.launches.value == before + 1
    _assert_matvec_close(got, a, x)
    _assert_matvec_close(pm.packed_block_matvec_reference(a, x), a, x)


# -- the fused normal equations (K1) --------------------------------------------

def _ne_args(s, w, k, n_self, seed, heavy=0, pad=0, dtype=torch.float32,
             n_other=37, device="cpu"):
    """A slot layout: sorted rows over [0, n_self) (the last two and
    others empty, one row `heavy` slots long), `pad` sentinel slots at the
    end, lens from 0 to w (pads 0), and valid indices and values past each
    slot's lens too, which the kernel must not read and the plain version
    masks."""
    rng = np.random.default_rng(seed)
    rows = np.sort(np.concatenate([rng.integers(0, n_self - 2,
                                                s - pad - heavy),
                                   np.full(heavy, n_self // 2)]))
    rows = np.concatenate([rows, np.full(pad, n_self)]).astype(np.int32)
    lens = rng.integers(1, w + 1, s).astype(np.int32)
    lens[rng.random(s) < 0.3] = w
    lens[rng.random(s) < 0.05] = 0      # empty slots, which K1 must skip
    lens[s - pad:] = 0
    idx = rng.integers(0, n_other, (s, w)).astype(np.int32)
    val = rng.integers(1, 6, (s, w)).astype(np.float32)
    src = (0.5 * rng.standard_normal((n_other, k))).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (
        rows, idx, val, lens)) + (torch.from_numpy(src).to(dtype).to(device),)


def _ne_f64(args, n_self, implicit, alpha):
    rows, idx, val, lens, src = args
    return sf.normal_equations_fused_reference(rows, idx, val, lens,
                                               src.double(), n_self,
                                               implicit, alpha)


def test_fused_wrapper_on_cpu_is_the_plain_version():
    args = _ne_args(90, 8, 6, 12, seed=1, heavy=30, pad=7)
    before = sf.launches_fused.value
    A, b = sf.normal_equations_fused(*args, 12, True, 2.5)
    assert sf.launches_fused.value == before
    want = sf.normal_equations_fused_reference(*args, 12, True, 2.5)
    assert torch.equal(A, want[0]) and torch.equal(b, want[1])
    _assert_rows_close(A, _ne_f64(args, 12, True, 2.5)[0])


@pytest.mark.parametrize("implicit", [False, True])
def test_fused_plain_version_weighs_masks_and_drops_pads(implicit):
    """Two slots of row 0 (the second one entry long), one pad slot."""
    rows = torch.tensor([0, 0, 2], dtype=torch.int32)
    idx = torch.tensor([[0, 1], [1, 0], [0, 1]], dtype=torch.int32)
    val = torch.tensor([[2.0, 3.0], [4.0, 9.0], [5.0, 5.0]])
    lens = torch.tensor([2, 1, 2], dtype=torch.int32)
    src = torch.tensor([[1.0, 2.0], [3.0, -1.0]])
    A, b = sf.normal_equations_fused_reference(rows, idx, val, lens, src, 2,
                                               implicit, 0.5)
    y = src[[0, 1, 1]]
    v = torch.tensor([2.0, 3.0, 4.0])
    wo, wr = (0.5 * v, 1 + 0.5 * v) if implicit else (torch.ones(3), v)
    assert torch.allclose(A[0], (y.T * wo) @ y)
    assert torch.allclose(b[0], y.T @ wr)
    assert not A[1].any() and not b[1].any()


@pytest.mark.parametrize("change, error", [
    (lambda r, i, v, l, s: (r.long(), i, v, l, s), TypeError),
    (lambda r, i, v, l, s: (r, i.long(), v, l, s), TypeError),
    (lambda r, i, v, l, s: (r, i, v.double(), l, s), TypeError),
    (lambda r, i, v, l, s: (r, i, v, l.long(), s), TypeError),
    (lambda r, i, v, l, s: (r, i, v, l, s.half()), TypeError),
    (lambda r, i, v, l, s: (r[:-1], i, v, l, s), ValueError),
    (lambda r, i, v, l, s: (r, i, v[:, :-1], l, s), ValueError),
    (lambda r, i, v, l, s: (r, i.t().contiguous().t(), v, l, s), ValueError),
    (lambda r, i, v, l, s: (r, i[:, :0], v[:, :0], l, s), ValueError),
    (lambda r, i, v, l, s: (r, i, v, l, torch.zeros(37, 1025)), ValueError),
    (lambda r, i, v, l, s: (r, i, v, l, s[:, :0]), ValueError),
])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_fused_refuses_what_the_kernel_does_not_take(change, error, device):
    """On the CPU and on the card alike: wrong types, shapes, strides,
    W = 0, and k outside 1..MAX_K_FUSED (1025 here)."""
    if device == "cuda":
        _cuda()
    args = change(*_ne_args(20, 4, 6, 9, seed=2, device=device))
    before = sf.launches_fused.value
    with pytest.raises(error):
        sf.normal_equations_fused(*[a.to(device) for a in args], 9, True,
                                  1.0)
    assert sf.launches_fused.value == before


@pytest.mark.parametrize("k", [5, 16, 64, 128, 256, 300])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("w", [8, 128])
@pytest.mark.parametrize("implicit", [False, True])
def test_fused_kernel_matches_plain_version_on_card(k, dtype, w, implicit):
    """K1 against the plain version evaluated in f64, per row of A and b
    relative to the row's largest magnitude (the flush tolerance: each
    slot's block sums at most W products, then slots and tiles add as in
    K2); two launches bit-identical."""
    dev = _cuda()
    s = 150 if k < 256 else 70
    args = _ne_args(s, w, k, 23, seed=k + w, heavy=s // 3, pad=11,
                    dtype=dtype, device=dev)
    before = sf.launches_fused.value
    A1, b1 = sf.normal_equations_fused(*args, 23, implicit, 2.5)
    A2, b2 = sf.normal_equations_fused(*args, 23, implicit, 2.5)
    torch.cuda.synchronize()
    assert sf.launches_fused.value == before + 2
    assert torch.equal(A1, A2) and torch.equal(b1, b2)
    wa, wb = _ne_f64(args, 23, implicit, 2.5)
    _assert_rows_close(A1, wa)
    _assert_rows_close(b1, wb)
    plain = sf.normal_equations_fused_reference(*args, 23, implicit, 2.5)
    _assert_rows_close(plain[0], wa)


@pytest.mark.parametrize("k", [5, 64, 128])
def test_fused_kernel_heavy_row_odd_slots_pad_tail_on_card(k):
    """One row 1,500 slots long (across 24 tiles of 64, folded in tile
    order), an odd slot count and a pad tail; rows with no slot zero."""
    dev = _cuda()
    args = _ne_args(2001, 32, k, 40, seed=k, heavy=1500, pad=301,
                    dtype=torch.bfloat16, device=dev)
    A1, b1 = sf.normal_equations_fused(*args, 40, True, 10.0)
    A2, b2 = sf.normal_equations_fused(*args, 40, True, 10.0)
    torch.cuda.synchronize()
    assert torch.equal(A1, A2) and torch.equal(b1, b2)
    wa, wb = _ne_f64(args, 40, True, 10.0)
    _assert_rows_close(A1, wa)
    _assert_rows_close(b1, wb)
    empty = sorted(set(range(40)) - set(args[0].tolist()))
    assert empty and not A1[empty].any() and not b1[empty].any()


@pytest.mark.parametrize("k", [8, 64, 72])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_kernel_slot_lengths_off_the_fragment_width_on_card(k, dtype):
    """Slot lengths that are not multiples of 8 (the tensor cores'
    reduction step), so runs of one row start and end inside a fragment
    and its other entries must be masked: against f64, bit-identical."""
    dev = _cuda()
    args = list(_ne_args(400, 128, k, 60, seed=k, heavy=150, pad=9,
                         dtype=dtype, device=dev))
    rng = np.random.default_rng(k)
    odd = np.array([1, 3, 5, 7, 9, 13, 15, 31, 33, 63, 127])
    lens = odd[rng.integers(0, len(odd), 400)].astype(np.int32)
    lens[-9:] = 0
    args[3] = torch.from_numpy(lens).to(dev)
    A1, b1 = sf.normal_equations_fused(*args, 60, True, 10.0)
    A2, b2 = sf.normal_equations_fused(*args, 60, True, 10.0)
    torch.cuda.synchronize()
    assert torch.equal(A1, A2) and torch.equal(b1, b2)
    wa, wb = _ne_f64(args, 60, True, 10.0)
    _assert_rows_close(A1, wa)
    _assert_rows_close(b1, wb)
    # A comes out exactly symmetric: each product is computed once
    assert torch.equal(A1, A1.transpose(1, 2))


@pytest.mark.parametrize("k", [5, 64, 130])
def test_fused_kernel_owns_the_zero_fill_on_card(k):
    """K1 writes every row of A and b: rows with no slot, and a row whose
    slots in its first tile are all empty but whose entries come in the
    next tile (its partial folds onto a row the kernel zeroed), come back
    exactly zero, or the sum, from memory that held NaN before."""
    dev = _cuda()
    rows = np.sort(np.r_[np.arange(0, 40, 2).repeat(3), np.full(30, 41),
                         np.arange(44, 60, 3).repeat(2)]).astype(np.int32)
    s = rows.shape[0]
    rng = np.random.default_rng(k)
    lens = rng.integers(1, 17, s).astype(np.int32)
    first41 = int(np.argmax(rows == 41))
    assert first41 < 64 < first41 + 30       # row 41 crosses a tile
    lens[first41:64] = 0                     # none in its first tile
    idx = rng.integers(0, 37, (s, 16)).astype(np.int32)
    val = rng.integers(1, 6, (s, 16)).astype(np.float32)
    src = (0.5 * rng.standard_normal((37, k))).astype(np.float32)
    args = [torch.from_numpy(a).to(dev) for a in (rows, idx, val, lens)]
    args.append(torch.from_numpy(src).to(dev))
    n_self = 70
    # leave NaN in the memory the caching allocator hands out next
    junk = torch.full((n_self * k * k + n_self * k + 4096,), float("nan"),
                      device=dev)
    del junk
    A, b = sf.normal_equations_fused(*args, n_self, True, 3.0)
    A2, b2, intact = sf.normal_equations_fused_fenced(*args, n_self, True,
                                                      3.0)
    torch.cuda.synchronize()
    assert intact and torch.equal(A, A2) and torch.equal(b, b2)
    empty = sorted(set(range(n_self)) - set(rows.tolist()))
    assert not A[empty].any() and not b[empty].any()
    wa, wb = _ne_f64(args, n_self, True, 3.0)
    _assert_rows_close(A, wa)
    _assert_rows_close(b, wb)
    assert A[41].any()


def test_fused_fenced_launch_refuses_cpu_tensors():
    args = _ne_args(20, 4, 6, 9, seed=2)
    before = sf.launches_fused.value
    with pytest.raises(ValueError, match="CUDA"):
        sf.normal_equations_fused_fenced(*args, 9, True, 1.0)
    assert sf.launches_fused.value == before


@pytest.mark.parametrize("k", [5, 64, 300])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("w", [8, 128])
def test_fused_kernel_stays_inside_its_buffers_on_card(k, dtype, w):
    """K1 with every buffer fenced by poison and every entry past its
    slot's lens poisoned: the fences hold, and A and b equal the unfenced
    launch's bit for bit, so no read strayed (a memory check that needs no
    sanitizer)."""
    dev = _cuda()
    args = _ne_args(1001, w, k, 40, seed=k + w, heavy=600, pad=101,
                    dtype=dtype, device=dev)
    A1, b1 = sf.normal_equations_fused(*args, 40, True, 10.0)
    A2, b2, intact = sf.normal_equations_fused_fenced(*args, 40, True, 10.0)
    torch.cuda.synchronize()
    assert intact
    assert torch.equal(A1, A2) and torch.equal(b1, b2)


def test_fused_kernel_empty_layout_on_card():
    dev = _cuda()
    rows, idx, val, lens, src = _ne_args(10, 4, 8, 5, seed=3, device=dev)
    before = sf.launches_fused.value
    A, b = sf.normal_equations_fused(rows[:0], idx[:0], val[:0], lens[:0],
                                     src, 5, True, 1.0)
    assert sf.launches_fused.value == before
    assert A.shape == (5, 8, 8) and not A.any() and not b.any()


# -- flash attention (K8) -----------------------------------------------------

# f32: the kernel's f32 FMAs against the plain version in f64 (the
# reference holds its flash kernel within 2e-5 of the plain attention);
# bf16: the output rounded to bf16 (2^-8 of it) against the plain version
# in f32 on the same bf16 inputs
K8_F32_ATOL = 2e-5
K8_BF16_RTOL = 2 ** -8
K8_BF16_ATOL = 1e-5


def _k8_args(b, sq, sk, h, d, seed, dtype=torch.float32, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn((b, s, h, d), generator=g).to(device, dtype)
                 for s in (sq, sk, sk))


def _k8_assert_close(got, q, k, v, causal, scale=None):
    if got.dtype == torch.float32:
        want = k8.flash_attention_reference(q.double(), k.double(),
                                            v.double(), causal, scale)
        torch.testing.assert_close(got.double(), want, rtol=0,
                                   atol=K8_F32_ATOL)
    else:
        want = k8.flash_attention_reference(q.float(), k.float(), v.float(),
                                            causal, scale)
        torch.testing.assert_close(got.float(), want, rtol=K8_BF16_RTOL,
                                   atol=K8_BF16_ATOL)


def test_flash_wrapper_on_cpu_is_the_plain_version():
    q, k, v = _k8_args(2, 9, 7, 2, 24, seed=1)    # D 24: no kernel for it
    before = k8.launches.value
    got = k8.flash_attention(q, k, v, causal=True)
    assert k8.launches.value == before
    assert torch.equal(got, k8.flash_attention_reference(q, k, v, True))


@pytest.mark.parametrize("change, error", [
    (lambda q, k, v: (q.double(), k.double(), v.double()), TypeError),
    (lambda q, k, v: (q.half(), k.half(), v.half()), TypeError),
    (lambda q, k, v: (q, k.bfloat16(), v), TypeError),
    (lambda q, k, v: (q[0], k[0], v[0]), ValueError),
    (lambda q, k, v: (q, k, v[:, :-1]), ValueError),
    (lambda q, k, v: (q, k[:, :, :1], v[:, :, :1]), ValueError),
    (lambda q, k, v: (q[..., :48], k[..., :48], v[..., :48]), ValueError),
    (lambda q, k, v: (q[..., :16], k[..., :16], v[..., :16]), ValueError),
])
def test_flash_checks_refuse_what_the_kernel_does_not_take(change, error):
    q, k, v = change(*_k8_args(2, 5, 6, 2, 64, seed=2))
    with pytest.raises(error):
        k8._check(q, k, v)


def test_flash_refuses_other_devices():
    q, k, v = (t.to("meta") for t in _k8_args(1, 4, 4, 1, 32, seed=3))
    with pytest.raises(ValueError, match="cuda or cpu"):
        k8.flash_attention(q, k, v)
    q, k, v = _k8_args(1, 4, 4, 1, 32, seed=3)
    with pytest.raises(ValueError, match="is on meta"):
        k8._check(q, k.to("meta"), v)


def test_flash_kernel_view_copies_only_what_it_cannot_stride():
    qkv = torch.zeros(2, 7, 3, 2, 32)
    q = qkv[:, :, 1]                           # a view into qkv: no copy
    assert k8._kernel_view(q).data_ptr() == q.data_ptr()
    odd = torch.zeros(2, 7, 2, 33)[..., 1:]    # stride 33: copied
    assert not k8._kernel_view(odd).data_ptr() == odd.data_ptr()
    assert k8._kernel_view(odd).is_contiguous()


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,sq,sk,h", [
    (1, 63, 63, 2),       # the template's serving call
    (3, 1, 1, 1),         # one row, one key
    (2, 130, 130, 3),     # ragged tiles
    (2, 200, 77, 2),      # Sq > Sk: later rows see every key
    (2, 50, 300, 2),      # Sq < Sk: causal skips the upper tiles
])
def test_flash_kernel_matches_plain_version_on_card(d, dtype, causal, b, sq,
                                                    sk, h):
    dev = _cuda()
    q, k, v = _k8_args(b, sq, sk, h, d, seed=d + sq, dtype=dtype, device=dev)
    before = k8.launches.value
    got = k8.flash_attention(q, k, v, causal=causal)
    again = k8.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert k8.launches.value == before + 2
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.equal(got, again)
    _k8_assert_close(got, q, k, v, causal)


@pytest.mark.parametrize("d", [8, 16, 48, 96])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_kernel_pads_narrower_heads_on_card(d, dtype, causal):
    """A head width between the kernel's runs zero-padded at the next one
    (one launch), the scale 1/sqrt of the real width."""
    dev = _cuda()
    q, k, v = _k8_args(2, 15, 15, 2, d, seed=d, dtype=dtype, device=dev)
    before = k8.launches.value
    got = k8.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert k8.launches.value == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    _k8_assert_close(got, q, k, v, causal)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_reads_strided_qkv_views_on_card(dtype):
    """q, k, v as the transformer block hands them over: views of one
    (B, S, 3, H, D) tensor; an explicit scale."""
    dev = _cuda()
    g = torch.Generator().manual_seed(8)
    qkv = torch.randn((4, 127, 3, 4, 32), generator=g).to(dev, dtype)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    got = k8.flash_attention(q, k, v, causal=True, scale=0.2)
    _k8_assert_close(got, q, k, v, True, 0.2)


def test_flash_kernel_without_keys_gives_zeros_on_card():
    dev = _cuda()
    q, k, v = _k8_args(2, 70, 0, 2, 64, seed=9, device=dev)
    before = k8.launches.value
    got = k8.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert k8.launches.value == before + 1
    assert bool((got == 0).all())


# the bf16 kernel (wgmma, TMA): key counts on both sides of a 64-key tile
# and of two, with Sq on both sides of the 128-row CTA; the tensor maps'
# swizzle must match the wgmma descriptors at every D, which a ragged edge
# would show as wrong numbers
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk", [(65, 65), (127, 127), (129, 129),
                                   (300, 65), (300, 129), (40, 127)])
def test_flash_bf16_kernel_ragged_key_tiles_on_card(d, causal, sq, sk):
    dev = _cuda()
    q, k, v = _k8_args(2, sq, sk, 3, d, seed=d + sk, dtype=torch.bfloat16,
                       device=dev)
    got = k8.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    _k8_assert_close(got, q, k, v, causal)


def test_flash_bf16_kernel_long_causal_rows_on_card():
    """S 4096: 64 key tiles through the three-stage ring, 32 CTAs of 128
    rows; two launches bit-identical."""
    dev = _cuda()
    q, k, v = _k8_args(1, 4096, 4096, 2, 64, seed=12, dtype=torch.bfloat16,
                       device=dev)
    got = k8.flash_attention(q, k, v, causal=True)
    again = k8.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _k8_assert_close(got, q, k, v, True)


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("scale", [-0.3, 0.05])
def test_flash_bf16_kernel_takes_any_scale_on_card(d, scale):
    """Tiles off the diagonal take the max of the raw scores (of their
    negation for a negative scale) and fold the scale into the exp2."""
    dev = _cuda()
    q, k, v = _k8_args(2, 300, 300, 2, d, seed=d, dtype=torch.bfloat16,
                       device=dev)
    for causal in (False, True):
        got = k8.flash_attention(q, k, v, causal=causal, scale=scale)
        _k8_assert_close(got, q, k, v, causal, scale)


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_bf16_kernel_without_keys_gives_zeros_on_card(d, causal):
    dev = _cuda()
    q, k, v = _k8_args(2, 70, 0, 2, d, seed=9, dtype=torch.bfloat16,
                       device=dev)
    before = k8.launches.value
    got = k8.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert k8.launches.value == before + 1
    assert bool((got == 0).all())


@pytest.mark.parametrize("d", [64, 128])
def test_flash_bf16_kernel_reads_strided_views_on_card(d):
    """Views of one (B, S, 3, H, D) projection with an explicit scale, as
    the transformer block hands them over; (B, H, S, D) tensors seen as
    (B, S, H, D); and a start 8 bytes off 16, which is copied first."""
    dev = _cuda()
    g = torch.Generator().manual_seed(d)
    qkv = torch.randn((3, 200, 3, 4, d), generator=g).to(dev, torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert k8._kernel_view(q).data_ptr() == q.data_ptr()
    got = k8.flash_attention(q, k, v, causal=True, scale=0.2)
    _k8_assert_close(got, q, k, v, True, 0.2)
    bhsd = [torch.randn((2, 3, 150, d), generator=g).to(dev, torch.bfloat16)
            for _ in range(3)]
    q, k, v = (t.transpose(1, 2) for t in bhsd)
    assert k8._kernel_view(q).data_ptr() == q.data_ptr()
    got = k8.flash_attention(q, k, v, causal=False)
    _k8_assert_close(got, q, k, v, False)
    flat = torch.randn(2 * 90 * 2 * d + 4, generator=g).to(dev,
                                                          torch.bfloat16)
    q = flat[4:].view(2, 90, 2, d)
    assert k8._kernel_view(q).data_ptr() != q.data_ptr()
    got = k8.flash_attention(q, q, q, causal=True)
    _k8_assert_close(got, q, q, q, True)


def test_flash_kernels_name_each_type():
    """``KERNELS`` names the kernel each input type takes, which
    ``chip_smoke.py`` reports beside each case."""
    assert set(k8.KERNELS) == set(k8._DTYPES)
    assert k8.KERNELS[torch.float32] == "f32_3xtf32_wgmma"


# the f32 kernel (3xTF32 mma.sync, TMA): the bf16 kernel's cases. Key
# counts on both sides of a 64-key tile and of two, Sq on both sides of
# the 64-row CTA and Sq != Sk; the tensor maps' swizzle must match the
# fragment loads at every D, which a ragged edge would show as wrong
# numbers. Every case twice: the launches must be bit-identical.
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk", [(65, 65), (127, 127), (129, 129),
                                   (300, 65), (300, 129), (40, 127),
                                   (300, 77)])
def test_flash_f32_kernel_ragged_key_tiles_on_card(d, causal, sq, sk):
    dev = _cuda()
    q, k, v = _k8_args(2, sq, sk, 3, d, seed=d + sk, device=dev)
    got = k8.flash_attention(q, k, v, causal=causal)
    again = k8.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == q.shape
    assert torch.equal(got, again)
    _k8_assert_close(got, q, k, v, causal)


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("s", [2047, 4096])
def test_flash_f32_kernel_long_causal_rows_on_card(d, s):
    """S 2047 (the long-context training cell) and 4096: 32 and 64 key
    tiles through the two-stage ring; two launches bit-identical."""
    dev = _cuda()
    q, k, v = _k8_args(1, s, s, 2, d, seed=12, device=dev)
    got = k8.flash_attention(q, k, v, causal=True)
    again = k8.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _k8_assert_close(got, q, k, v, True)


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("scale", [-0.3, 0.05])
def test_flash_f32_kernel_takes_any_scale_on_card(d, scale):
    """Tiles off the diagonal take the max of the raw scores (of their
    negation for a negative scale) and fold the scale into the exp2."""
    dev = _cuda()
    q, k, v = _k8_args(2, 300, 300, 2, d, seed=d, device=dev)
    for causal in (False, True):
        got = k8.flash_attention(q, k, v, causal=causal, scale=scale)
        _k8_assert_close(got, q, k, v, causal, scale)


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_f32_kernel_without_keys_gives_zeros_on_card(d, causal):
    dev = _cuda()
    q, k, v = _k8_args(2, 70, 0, 2, d, seed=9, device=dev)
    before = k8.launches.value
    got = k8.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert k8.launches.value == before + 1
    assert bool((got == 0).all())


@pytest.mark.parametrize("d", [32, 64, 128])
def test_flash_f32_kernel_reads_strided_views_on_card(d):
    """Views of one (B, S, 3, H, D) projection with an explicit scale, as
    the transformer block hands them over; (B, H, S, D) tensors seen as
    (B, S, H, D); and a start 8 bytes off 16, which is copied first."""
    dev = _cuda()
    g = torch.Generator().manual_seed(d)
    qkv = torch.randn((3, 200, 3, 4, d), generator=g).to(dev)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert k8._kernel_view(q).data_ptr() == q.data_ptr()
    got = k8.flash_attention(q, k, v, causal=True, scale=0.2)
    _k8_assert_close(got, q, k, v, True, 0.2)
    bhsd = [torch.randn((2, 3, 150, d), generator=g).to(dev)
            for _ in range(3)]
    q, k, v = (t.transpose(1, 2) for t in bhsd)
    assert k8._kernel_view(q).data_ptr() == q.data_ptr()
    got = k8.flash_attention(q, k, v, causal=False)
    _k8_assert_close(got, q, k, v, False)
    flat = torch.randn(2 * 90 * 2 * d + 2, generator=g).to(dev)
    q = flat[2:].view(2, 90, 2, d)
    assert k8._kernel_view(q).data_ptr() != q.data_ptr()
    got = k8.flash_attention(q, q, q, causal=True)
    _k8_assert_close(got, q, q, q, True)


# -- the serving top-k's tie order on the card ---------------------------------

def test_topk_tie_order_on_card():
    """tests/test_torch_topk_ties.py's inputs on the card: 100 items
    share the best factor row, so the top 10 is a cut inside a tie, and
    the lowest indices must win it, in order, in exact mode and in
    clustered mode with the plain scan and with K7."""
    dev = _cuda()
    rng = np.random.default_rng(0)
    users = np.abs(rng.standard_normal((16, 8))).astype(np.float32)
    items = rng.standard_normal((300, 8)).astype(np.float32)
    items[200:] = 4.0
    want = list(range(200, 210))
    model = als.ALSModel(torch.from_numpy(users).to(dev),
                         torch.from_numpy(items).to(dev))
    _, idx = als.recommend_topk(model, np.arange(16), 10)
    assert idx.cpu().tolist() == [want] * 16
    for impl in ("xla", "pallas"):
        for dtype in ("int8", "bf16"):
            params = rt.RetrievalParams(mode="clustered", dtype=dtype,
                                        n_clusters=16, nprobe=4,
                                        rerank_k=64, impl=impl)
            didx = rt.build_device_index(rt.build_index(items, params), dev)
            _, got = rt.candidate_topk(didx, model.item_factors, users, 10)
            assert got.tolist() == [want] * 16, (impl, dtype)


# -- the supervised train workflow's paths on the card -------------------------

def _expected_flush_launches(nnz: int, n_users: int, n_items: int, p) -> int:
    """K2 launches of a training run: one per group of each half, both
    halves every sweep (chip_smoke.py's expected_flush_launches)."""
    nnz_pad = nnz + (-nnz % p.chunk)
    cs = min(p.chunk_slots, als._slots_for(nnz_pad, 0, p.width, 1))
    groups = sum(len(als._group_bounds(
        als._slots_for(nnz_pad, n, p.width, cs), p.rank, cs, p.group_slots))
        for n in (n_users, n_items))
    return groups * p.iterations


def test_validated_training_with_k2_matches_plain_path_on_card():
    """``als_train_validated`` with ``accum`` auto (K2 on the card) against
    the plain accumulation (``carry``) from the same init: the curve and
    the best sweep's factors within FLUSH_RTOL of their max, the same best
    sweep, and K2 launched once per group of each half every sweep."""
    from dataclasses import replace

    dev = _cuda()
    rng = np.random.default_rng(0)
    n_users, n_items = 300, 200
    u_true = rng.standard_normal((n_users, 3))
    i_true = rng.standard_normal((n_items, 3))
    u, i = np.nonzero(rng.random((n_users, n_items)) < 0.3)
    r = ((u_true[u] * i_true[i]).sum(1)
         + 0.5 * rng.standard_normal(len(u))).astype(np.float32)
    perm = rng.permutation(len(u))
    va, tr = perm[:len(u) // 5], perm[len(u) // 5:]
    p = als.ALSParams(rank=8, iterations=6, reg=0.1, implicit=False,
                      seed=1, chunk=512, cg_warm_iters=-1,
                      bf16_gather=False)
    assert p.resolved_accum(dev) == "hybrid"
    init = als.ALSModel(*als._init_or(None, n_users, n_items, p, dev))
    args = (u[tr], i[tr], r[tr], n_users, n_items)
    val = (u[va], i[va], r[va])
    before = sf.launches.value
    got, got_v = als.als_train_validated(*args, p, *val, init=init,
                                         device=dev)
    torch.cuda.synchronize()
    assert sf.launches.value - before == _expected_flush_launches(
        len(tr), n_users, n_items, p)
    before = sf.launches.value
    want, want_v = als.als_train_validated(*args, replace(p, accum="carry"),
                                           *val, init=init, device=dev)
    assert sf.launches.value == before
    assert got_v.best_sweep == want_v.best_sweep
    np.testing.assert_allclose(got_v.curve, want_v.curve, rtol=0,
                               atol=FLUSH_RTOL * max(want_v.curve))
    for g, w in ((got.user_factors, want.user_factors),
                 (got.item_factors, want.item_factors)):
        torch.testing.assert_close(g, w, rtol=0,
                                   atol=FLUSH_RTOL * float(w.abs().max()))


def test_resumed_sequence_run_equals_uninterrupted_on_card(tmp_path):
    """The sequence template with K8 in its forward (``attention="flash"``)
    on the card: a run stopped after 7 steps and resumed from its step-5
    checkpoint ends with the uninterrupted run's params and loss, bit for
    bit."""
    from dataclasses import replace

    from pio_tpu_torch.models import sequence as seq
    from pio_tpu_torch.workflow.step_checkpoint import (
        StepCheckpointConfig,
        StepCheckpointer,
    )

    dev = _cuda()
    rng = np.random.default_rng(0)
    seqs = (rng.zipf(1.3, (64, 16)) % 99 + 1).astype(np.int32)
    ids = [f"u{j}" for j in range(64)]
    from pio_tpu_torch.data.bimap import EntityIdIndex

    data = seq.SequenceData(seqs, EntityIdIndex(ids),
                            EntityIdIndex(f"i{j}" for j in range(100)))
    p = seq.SequenceParams(max_len=16, embed_dim=64, num_heads=2,
                           num_layers=2, ffn_dim=64, batch_size=16,
                           steps=12, attention="flash")
    before = k8.launches.value
    whole, _, whole_loss = seq.train_sequence_model(data, p, device=dev)
    assert k8.launches.value - before == p.num_layers * p.steps

    def ckpt():
        return StepCheckpointer(StepCheckpointConfig(str(tmp_path),
                                                     save_every=5))

    seq.train_sequence_model(data, replace(p, steps=7), device=dev,
                             checkpoint=ckpt())
    before = k8.launches.value
    params, _, loss = seq.train_sequence_model(data, p, device=dev,
                                               checkpoint=ckpt())
    assert k8.launches.value - before == p.num_layers * (p.steps - 6)
    assert loss == whole_loss
    for k, v in whole.items():
        assert params[k].device.type == "cuda"
        assert torch.equal(params[k], v), k


# -- the stacked sweep (tuning/) on the card ----------------------------------

def _sweep_data(seed=0, n_users=300, n_items=200, nnz=6000):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n_users, nnz).astype(np.int32),
            rng.integers(0, n_items, nnz).astype(np.int32),
            rng.uniform(1, 5, nnz).astype(np.float32), n_users, n_items)


# candidate c of the stacked trainer against the sequential trainer: the
# same blocks, slot-ordered sums and per-candidate solves on the same
# shapes (CPU: bit for bit); a batched library call may still choose
# another routine for another batch count
STACKED_RTOL = 1e-5


def test_stacked_training_repeats_bit_for_bit_on_card():
    """``als_train_stacked`` on the card (``accum="stacked"``: the ordered
    rounds, no atomics) gives the same bits run to run, and launches no
    kernel of the repository."""
    dev = _cuda()
    u, i, v, n_users, n_items = _sweep_data()
    p = als.ALSParams(rank=16, iterations=3, chunk=1024, implicit=True,
                      auto_cg_rows=64)
    regs = np.array([0.01, 0.1, 1.0], np.float32)
    alphas = np.array([1.0, 4.0, 10.0], np.float32)
    before = sf.launches.value
    a = als.als_train_stacked(u, i, v, n_users, n_items, p, regs, alphas,
                              device=dev)
    b = als.als_train_stacked(u, i, v, n_users, n_items, p, regs, alphas,
                              device=dev)
    torch.cuda.synchronize()
    assert sf.launches.value == before
    assert torch.equal(a.user_factors, b.user_factors)
    assert torch.equal(a.item_factors, b.item_factors)
    assert bool(torch.isfinite(a.user_factors).all())


@pytest.mark.parametrize("implicit", [False, True])
def test_stacked_candidate_matches_sequential_on_card(implicit):
    from dataclasses import replace

    dev = _cuda()
    u, i, v, n_users, n_items = _sweep_data(seed=1)
    p = als.ALSParams(rank=16, iterations=3, chunk=1024, implicit=implicit,
                      auto_cg_rows=64)
    regs = np.array([0.01, 0.1, 1.0, 5.0], np.float32)
    alphas = np.array([1.0, 4.0, 10.0, 2.0], np.float32)
    st = als.als_train_stacked(u, i, v, n_users, n_items, p, regs, alphas,
                               device=dev)
    for c in range(len(regs)):
        seq = als.als_train(
            u, i, v, n_users, n_items,
            als.sweep_safe_params(replace(p, reg=float(regs[c]),
                                          alpha=float(alphas[c])), dev),
            device=dev)
        for got, want in ((st.user_factors[c], seq.user_factors),
                          (st.item_factors[c], seq.item_factors)):
            torch.testing.assert_close(got, want, rtol=STACKED_RTOL, atol=0)


def test_stacked_topk_on_card_equals_cpu():
    """The sweep's stacked scoring and top-k on the card give the CPU's
    ids, with seen items masked (all tied at MASKED_SCORE) reaching the
    top-k and exact ties among small-integer scores."""
    from pio_tpu_torch.tuning.sweep import _stacked_topk

    dev = _cuda()
    rng = np.random.default_rng(4)
    uf = torch.from_numpy(rng.integers(-2, 3, (4, 50, 8)).astype(np.float32))
    itf = torch.from_numpy(rng.integers(-2, 3, (4, 300, 8)).astype(
        np.float32))
    uidx = rng.choice(50, 32, replace=False).astype(np.int32)
    seen = np.full((32, 512), -1, np.int32)
    for j in range(32):
        s = rng.choice(300, int(rng.integers(0, 300)), replace=False)
        seen[j, :len(s)] = s
    want_s, want_i = _stacked_topk(uf, itf, uidx, seen, 64)
    got_s, got_i = _stacked_topk(uf.to(dev), itf.to(dev), uidx, seen, 64)
    assert torch.equal(got_i.cpu(), want_i)
    assert torch.equal(got_s.cpu(), want_s)
