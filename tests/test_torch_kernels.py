"""The port's CUDA kernel wrappers, without JAX: the quantized scan (K7)
and the segment flush (K2).

On the CPU a wrapper computes its kernel's plain version and launches
nothing; it refuses inputs its kernel does not take. On a card the kernel
must agree with the plain version. This file imports neither JAX nor
``pio_tpu``, so it also runs on a machine with a card and no JAX:

    python -m pytest tests/test_torch_kernels.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from pio_tpu_torch.ops import retrieval as rt
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
