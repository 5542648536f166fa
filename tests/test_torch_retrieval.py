"""Two-stage retrieval in the PyTorch port against the JAX package.

The host half (params, codec, k-means, index) must be byte-identical to
``pio_tpu.ops.retrieval``; the device layout element-identical; the
scan's plain torch version must agree with the Pallas kernel (interpret
mode) and the XLA scan per probed block; ``candidate_topk`` must return
the reference's ids under both ``impl`` values. Inputs are made with
numpy from a seed and handed to both packages.
"""

import _torch_cpu  # noqa: F401  (one CPU thread: see the module)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pio_tpu.ops import retrieval as ref
from pio_tpu_torch.ops import retrieval as port
from pio_tpu_torch.ops.kernels import quantized_scan as qscan

# the scan sums k products in another order than XLA/Pallas: f32
# rounding of a k=16 dot stays far inside these
SCAN_RTOL = 1e-5
SCAN_ATOL = 1e-5
# exact tier-2 scores: same f32 einsum, different summation order
SCORE_RTOL = 1e-5
SCORE_ATOL = 1e-5


def mixture_rows(n, k, centers, rng):
    """Clustered synthetic factors (as tests/test_retrieval.py makes
    them), so recall and cluster structure mean something."""
    c = rng.standard_normal((centers, k)).astype(np.float32)
    assign = rng.integers(0, centers, n)
    return (c[assign]
            + 0.25 * rng.standard_normal((n, k))).astype(np.float32)


def _ref_device_arrays(didx):
    """The reference's device layout as numpy (bf16 as its uint16 bits)."""
    table = didx.table
    if table.dtype == jnp.bfloat16:
        table = jax.lax.bitcast_convert_type(table, jnp.uint16)
    return (np.asarray(table), np.asarray(didx.scales),
            np.asarray(didx.gidx), np.asarray(didx.centroids))


def _port_table_bits(didx):
    t = didx.table.cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


@pytest.mark.parametrize("n_items", [1, 2, 12, 500, 600, 4096, 26744])
def test_params_resolution_matches_reference(n_items):
    for kw in ({}, {"n_clusters": 8}, {"nprobe": 4}, {"nprobe": 64}):
        a = ref.RetrievalParams(mode="clustered", **kw)
        b = port.RetrievalParams(mode="clustered", **kw)
        assert b.resolved_n_clusters(n_items) == a.resolved_n_clusters(n_items)
        assert b.is_exhaustive(n_items) == a.is_exhaustive(n_items)


@pytest.mark.parametrize("bad", [
    {"mode": "fuzzy"}, {"dtype": "int4"}, {"impl": "cuda"}, {"nprobe": 0},
    {"rerank_k": 0}, {"n_clusters": -1}, {"kmeans_iters": 0},
    {"nprobes": 4},
])
def test_params_validation_matches_reference(bad):
    with pytest.raises(ValueError) as want:
        ref.RetrievalParams.from_config(bad)
    with pytest.raises(ValueError) as got:
        port.RetrievalParams.from_config(bad)
    assert str(got.value) == str(want.value)
    assert port.resolved_impl("auto") == ref.resolved_impl("auto") == "xla"


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_codec_byte_identical(dtype):
    rng = np.random.default_rng(0)
    rows = rng.standard_normal((37, 12)).astype(np.float32)
    rows *= rng.uniform(0.01, 100.0, (37, 1)).astype(np.float32)
    rows[3] = 0.0   # the all-zero row takes the scale-1 branch
    d_ref, s_ref = ref.encode_rows(rows, dtype)
    d_port, s_port = port.encode_rows(rows, dtype)
    assert d_port.dtype == d_ref.dtype and s_port.dtype == s_ref.dtype
    assert d_port.tobytes() == d_ref.tobytes()
    assert s_port.tobytes() == s_ref.tobytes()
    blob = port.table_to_bytes(port.quantize_table(rows, dtype))
    assert blob == ref.table_to_bytes(ref.quantize_table(rows, dtype))
    back = port.table_from_bytes(blob)
    assert back.decode().tobytes() == ref.table_from_bytes(
        blob).decode().tobytes()
    with pytest.raises(port.RetrievalCodecError):
        port.table_from_bytes(blob[:-1])


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_kmeans_and_index_byte_identical(dtype):
    rng = np.random.default_rng(1)
    rows = mixture_rows(600, 16, 24, rng)
    a_ref, c_ref = ref.kmeans_cluster(rows, 32, seed=3, iters=5)
    a_port, c_port = port.kmeans_cluster(rows, 32, seed=3, iters=5)
    assert a_port.tobytes() == a_ref.tobytes()
    assert c_port.tobytes() == c_ref.tobytes()
    params = dict(mode="clustered", dtype=dtype, nprobe=8)
    i_ref = ref.build_index(rows, ref.RetrievalParams(**params))
    i_port = port.build_index(rows, port.RetrievalParams(**params))
    assert i_port.assign.tobytes() == i_ref.assign.tobytes()
    assert i_port.centroids.tobytes() == i_ref.centroids.tobytes()
    assert i_port.table.data.tobytes() == i_ref.table.data.tobytes()
    assert i_port.table.scales.tobytes() == i_ref.table.scales.tobytes()
    assert i_port.nbytes() == i_ref.nbytes()
    # fold-in update: re-encode + reassign against frozen centroids
    pos = np.array([0, 5, 77])
    new = rng.standard_normal((3, 16)).astype(np.float32)
    u_ref, u_port = i_ref.updated(pos, new), i_port.updated(pos, new)
    assert u_port.assign.tobytes() == u_ref.assign.tobytes()
    assert u_port.table.data.tobytes() == u_ref.table.data.tobytes()
    assert u_port.table.scales.tobytes() == u_ref.table.scales.tobytes()


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_device_layout_identical(dtype):
    rng = np.random.default_rng(2)
    rows = mixture_rows(600, 16, 24, rng)
    params = dict(mode="clustered", dtype=dtype, nprobe=8)
    d_ref = ref.build_device_index(
        ref.build_index(rows, ref.RetrievalParams(**params)))
    d_port = port.build_device_index(
        port.build_index(rows, port.RetrievalParams(**params)), "cpu")
    table, scales, gidx, cent = _ref_device_arrays(d_ref)
    assert d_port.table.dtype == (torch.bfloat16 if dtype == "bf16"
                                  else torch.int8)
    assert d_port.pad_width == d_ref.pad_width
    assert (d_port.pad_width & (d_port.pad_width - 1)) == 0   # pow2 Lmax
    assert _port_table_bits(d_port).tobytes() == table.tobytes()
    assert d_port.scales.numpy().tobytes() == scales.tobytes()
    assert d_port.gidx.numpy().tobytes() == gidx.tobytes()
    assert d_port.centroids.numpy().tobytes() == cent.tobytes()
    assert d_port.nbytes() == d_ref.nbytes()
    assert (d_port.gidx.numpy() == -1).sum() == (
        d_port.n_clusters * d_port.pad_width - rows.shape[0])


def _scan_inputs(dtype, seed, b=3, p=4):
    rng = np.random.default_rng(seed)
    rows = mixture_rows(600, 16, 24, rng)
    params = dict(mode="clustered", dtype=dtype, nprobe=p)
    d_ref = ref.build_device_index(
        ref.build_index(rows, ref.RetrievalParams(**params)))
    d_port = port.build_device_index(
        port.build_index(rows, port.RetrievalParams(**params)), "cpu")
    top_c = rng.choice(d_port.n_clusters, size=(b, p)).astype(np.int32)
    u = rng.standard_normal((b, 16)).astype(np.float32)
    return d_ref, d_port, top_c, u


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_scan_reference_matches_pallas_interpret_and_xla(dtype):
    """The port's plain scan == the reference's Pallas kernel (interpret
    mode) and XLA scan on every probed block, with the pad mask."""
    d_ref, d_port, top_c, u = _scan_inputs(dtype, seed=3)
    got = qscan.quantized_scan_reference(
        d_port.table, d_port.scales, d_port.gidx, torch.from_numpy(top_c),
        torch.from_numpy(u)).numpy()
    lmax = d_port.pad_width
    gidx = np.asarray(d_ref.gidx)
    for b in range(top_c.shape[0]):
        for p in range(top_c.shape[1]):
            c = int(top_c[b, p])
            args = (d_ref.table[c], d_ref.scales[c], jnp.asarray(u[b]))
            mask = gidx[c] >= 0
            blk = got[b, p * lmax:(p + 1) * lmax]
            assert np.all(np.isneginf(blk[~mask]))
            for want in (ref.quantized_scores_pallas(*args, interpret=True),
                         ref.quantized_scores_xla(*args)):
                np.testing.assert_allclose(
                    blk[mask], np.asarray(want)[mask],
                    rtol=SCAN_RTOL, atol=SCAN_ATOL)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_candidate_topk_matches_reference(impl, dtype):
    rng = np.random.default_rng(5)
    rows = mixture_rows(600, 16, 24, rng)
    params = dict(mode="clustered", dtype=dtype, nprobe=8, rerank_k=64,
                  impl=impl)
    d_ref = ref.build_device_index(
        ref.build_index(rows, ref.RetrievalParams(**params)))
    d_port = port.build_device_index(
        port.build_index(rows, port.RetrievalParams(**params)), "cpu")
    users = rng.standard_normal((5, 16)).astype(np.float32)
    for k in (1, 10, 37):
        s_ref, g_ref = ref.candidate_topk(d_ref, jnp.asarray(rows), users, k)
        s_port, g_port = port.candidate_topk(
            d_port, torch.from_numpy(rows), users, k)
        assert s_port.shape == s_ref.shape == (5, k)
        np.testing.assert_array_equal(g_port, g_ref)
        np.testing.assert_allclose(s_port, s_ref, rtol=SCORE_RTOL,
                                   atol=SCORE_ATOL)


def test_recall_at_k_matches_reference():
    rng = np.random.default_rng(6)
    got = rng.integers(0, 50, (4, 10))
    want = rng.integers(0, 50, (4, 10))
    assert port.recall_at_k(got, want) == ref.recall_at_k(got, want)
    ids = rng.permutation(50)[:10]
    assert port.recall_at_k(ids, ids[::-1]) == 1.0
