"""The port's CUDA kernel wrappers, without JAX.

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
