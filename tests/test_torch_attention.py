"""Attention in the PyTorch port against the JAX package, on the CPU.

The plain version of the flash kernel (K8) is held against the
reference's Pallas ``flash_attention`` run in interpret mode, at the cases
of ``tests/test_attention.py``: causal and not, ragged Sq > Sk and
Sq < Sk under both masks, K/V in several segments, and a row whose causal
view holds one key. ``chunked_attention`` and
``flash_attention_trainable`` are held against the reference's, forward
and gradients. Inputs are numpy arrays from a seed, handed to both.

The bf16 kernel's arithmetic (the kernel itself runs only on a card) is
held here through an emulation of its rounding: bf16 products summed in
f32, the scale applied to the scores, an f32 online softmax over 128-key
tiles, p split into bf16 hi and lo parts for P V, the output rounded to
bf16. It must stay within 2^-8 of the value + 1e-5 of the reference on
the same bf16 inputs; a single bf16 rounding of p does not.

The f32 kernel's arithmetic is held the same way: TF32 emulated by
clearing 13 mantissa bits, each operand of both products split into hi
and lo = tf32(x - hi), each product summed as lo hi + hi lo + hi hi (lo lo
dropped) in f32, the scale applied to the scores, an f32 online softmax
over 64-key tiles. It must stay within FWD_ATOL of the f64 plain attention
at the sequence template's widths; one TF32 pass does not.
"""

import _torch_cpu  # noqa: F401  (one CPU thread: see the module)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pio_tpu.ops import attention as ref
from pio_tpu_torch.ops import attention as port
from pio_tpu_torch.ops.kernels import flash_attention as k8

# the reference's own tolerances (tests/test_attention.py): f32 sums in
# other orders for forwards, and through a softmax's Jacobian for
# gradients
FWD_ATOL = 2e-5
GRAD_ATOL = 2e-4
# the bf16 kernel's output against f32 attention on the same bf16 inputs:
# the rounding of the output to bf16 alone reaches 2^-8 of it
# (tests/test_torch_kernels.py and chip_smoke.py hold the kernel to this)
BF16_RTOL = 2 ** -8
BF16_ATOL = 1e-5


def _qkv(seed, b, sq, sk, h, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, s, h, d)).astype(np.float32)
                 for s in (sq, sk, sk))


def _t(arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _j(arrays):
    return tuple(jnp.asarray(a) for a in arrays)


@pytest.mark.parametrize("sq, sk", [(64, 64), (50, 37), (23, 50), (1, 9),
                                    (63, 63)])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_plain_version_matches_pallas_interpret(sq, sk, causal):
    q, k, v = _qkv(0, 2, sq, sk, 4, 16)
    want = ref.flash_attention(*_j((q, k, v)), causal=causal, block_q=16,
                               block_k=16, interpret=True)
    got = port.flash_attention(*_t((q, k, v)), causal=causal)
    assert got.dtype == torch.float32 and got.shape == (2, sq, 4, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=FWD_ATOL)
    oracle = ref.attention_reference(*_j((q, k, v)), causal=causal)
    np.testing.assert_allclose(
        port.attention_reference(*_t((q, k, v)), causal=causal).numpy(),
        np.asarray(oracle), rtol=0, atol=FWD_ATOL)


@pytest.mark.parametrize("sq, sk", [(128, 128), (128, 100)])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_plain_version_matches_multi_segment_pallas(sq, sk, causal):
    """The reference's segmented K/V path (4 KB segments: 4 of 32 keys)."""
    q, k, v = _qkv(3, 2, sq, sk, 2, 32)
    want = ref.flash_attention(*_j((q, k, v)), causal=causal, block_q=32,
                               block_k=32, max_seg_bytes=4096,
                               interpret=True)
    got = port.flash_attention(*_t((q, k, v)), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=FWD_ATOL)


def test_flash_plain_version_scale_and_single_key_rows():
    """Row 0 of a causal block sees one key (the reference's "fully
    masked" block case): finite, and equal to v's row 0; an explicit
    scale is honoured."""
    q, k, v = _qkv(1, 1, 8, 8, 1, 8)
    want = ref.flash_attention(*_j((q, k, v)), causal=True, scale=0.3,
                               block_q=8, block_k=8, interpret=True)
    got = port.flash_attention(*_t((q, k, v)), causal=True, scale=0.3)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=FWD_ATOL)
    np.testing.assert_allclose(got[0, 0].numpy(), v[0, 0], atol=1e-6)


def test_flash_plain_version_with_no_keys_is_zeros():
    """Every row fully masked (no keys at all) gives zeros, not NaN."""
    q, k, v = _t(_qkv(2, 2, 5, 0, 2, 32))
    for causal in (False, True):
        got = k8.flash_attention_reference(q, k, v, causal=causal)
        assert got.shape == (2, 5, 2, 32)
        assert bool((got == 0).all())


def test_flash_plain_version_in_row_blocks(monkeypatch):
    """Scoring q in blocks of rows gives the single-block answer."""
    q, k, v = _t(_qkv(4, 2, 70, 70, 2, 16))
    whole = k8.flash_attention_reference(q, k, v, causal=True)
    monkeypatch.setattr(k8, "_SCORE_BLOCK_BYTES", 2 * 2 * 70 * 4 * 9)
    blocked = k8.flash_attention_reference(q, k, v, causal=True)
    np.testing.assert_allclose(blocked.numpy(), whole.numpy(), rtol=0,
                               atol=1e-6)


def test_flash_plain_version_bf16_keeps_the_type():
    q, k, v = (t.to(torch.bfloat16) for t in _t(_qkv(5, 1, 16, 16, 2, 32)))
    got = port.flash_attention(q, k, v, causal=True)
    assert got.dtype == torch.bfloat16
    want = port.attention_reference(q.float(), k.float(), v.float(),
                                    causal=True)
    # the output rounded to bf16 (8 significant bits)
    np.testing.assert_allclose(got.float().numpy(), want.numpy(),
                               rtol=2 ** -8, atol=1e-6)


def _grads(fn, arrays):
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = fn(*ts)
    (out ** 2).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _ref_grads(fn, arrays):
    out = fn(*_j(arrays))
    g = jax.grad(lambda a, b, c: jnp.sum(fn(a, b, c) ** 2),
                 argnums=(0, 1, 2))(*_j(arrays))
    return np.asarray(out), [np.asarray(x) for x in g]


@pytest.mark.parametrize("sq, sk", [(96, 96), (96, 70)])
@pytest.mark.parametrize("causal", [False, True])
def test_chunked_attention_matches_reference_fwd_and_grad(sq, sk, causal):
    arrays = _qkv(5, 2, sq, sk, 2, 16)
    got, g_got = _grads(
        lambda a, b, c: port.chunked_attention(a, b, c, causal=causal,
                                               chunk=32), arrays)
    want, g_want = _ref_grads(
        lambda a, b, c: ref.chunked_attention(a, b, c, causal=causal,
                                              chunk=32), arrays)
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_ATOL)
    for a, b in zip(g_got, g_want):
        np.testing.assert_allclose(a, b, rtol=0, atol=GRAD_ATOL)


def test_chunked_attention_checkpoints_each_chunk(monkeypatch):
    """The backward recomputes every chunk's statistics: 2 forward calls
    of each chunk in all."""
    calls = []
    real = port._chunk_stats
    monkeypatch.setattr(port, "_chunk_stats",
                        lambda *a: calls.append(a[3]) or real(*a))
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _qkv(6, 1, 40, 40, 2, 8))
    port.chunked_attention(q, k, v, causal=True, chunk=16).sum().backward()
    assert sorted(calls) == [0, 0, 16, 16, 32, 32]


def test_flash_trainable_matches_reference_fwd_and_grad():
    arrays = _qkv(9, 2, 64, 64, 2, 16)
    got, g_got = _grads(
        lambda a, b, c: port.flash_attention_trainable(a, b, c, True, None,
                                                       32), arrays)
    want, g_want = _ref_grads(
        lambda a, b, c: ref.flash_attention_trainable(a, b, c, True, None,
                                                      32), arrays)
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_ATOL)
    for a, b in zip(g_got, g_want):
        np.testing.assert_allclose(a, b, rtol=0, atol=GRAD_ATOL)
    # and its gradients are chunked attention's
    _, g_chunk = _grads(
        lambda a, b, c: port.chunked_attention(a, b, c, causal=True,
                                               chunk=32), arrays)
    for a, b in zip(g_got, g_chunk):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


# -- the bf16 kernel's arithmetic ---------------------------------------------

def _bf16_kernel_emulation(q, k, v, causal, scale=None, split=True,
                           tile=128):
    """The bf16 kernel (flash_attention.cu) as the CPU can compute it: q,
    k, v hold bf16 values; each 128-key tile's scores are bf16 products
    (exact in f32) summed in f32, times the scale; the online softmax runs
    in f32 with l summed from the f32 p; P V takes p as bf16 hi and
    lo = bf16(p - hi), accumulated in f32 (``split=False``: p rounded once
    to bf16); the output is rounded to bf16."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = scale if scale is not None else 1.0 / np.sqrt(d)
    qf, kf, vf = (t.float() for t in (q, k, v))
    m = torch.full((b, h, sq, 1), port.NEG_INF)
    l = torch.zeros((b, h, sq, 1))
    acc = torch.zeros((b, h, sq, d))
    rows = torch.arange(sq)[:, None]
    for k0 in range(0, sk, tile):
        kt, vt = kf[:, k0:k0 + tile], vf[:, k0:k0 + tile]
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kt) * np.float32(scale)
        keep = torch.ones((sq, kt.shape[1]), dtype=torch.bool)
        if causal:
            keep = torch.arange(k0, k0 + kt.shape[1])[None, :] <= rows
        s = s.masked_fill(~keep, port.NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new).masked_fill(~keep, 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        hi = p.to(torch.bfloat16).float()
        pv = torch.einsum("bhqk,bkhd->bhqd", hi, vt)
        if split:
            lo = (p - hi).to(torch.bfloat16).float()
            pv = pv + torch.einsum("bhqk,bkhd->bhqd", lo, vt)
        acc = acc * alpha + pv
        m = m_new
    out = acc / l.clamp_min(1e-30)
    return out.permute(0, 2, 1, 3).to(torch.bfloat16)


def _bf16_qkv(seed, b, sq, sk, h, d):
    """Inputs with bf16 values, as f32 numpy arrays."""
    return tuple(torch.from_numpy(a).to(torch.bfloat16).float().numpy()
                 for a in _qkv(seed, b, sq, sk, h, d))


def _outside(got, want):
    """Share of outputs past 2^-8 of the value + 1e-5."""
    err = (got.double() - want.double()).abs()
    return float((err > BF16_RTOL * want.double().abs() + BF16_ATOL)
                 .double().mean())


@pytest.mark.parametrize("sq, sk", [(64, 64), (50, 37), (23, 50), (1, 9),
                                    (63, 63)])
@pytest.mark.parametrize("causal", [False, True])
def test_bf16_kernel_arithmetic_matches_pallas_interpret(sq, sk, causal):
    q, k, v = _bf16_qkv(0, 2, sq, sk, 4, 16)
    want = ref.flash_attention(*_j((q, k, v)), causal=causal, block_q=16,
                               block_k=16, interpret=True)
    got = _bf16_kernel_emulation(*_t((q, k, v)), causal=causal)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               rtol=BF16_RTOL, atol=BF16_ATOL)


@pytest.mark.parametrize("s", [512, 1024, 2048])
def test_bf16_kernel_arithmetic_matches_plain_version_at_long_rows(s):
    q, k, v = _t(_bf16_qkv(s, 1, s, s, 2, 64))
    want = k8.flash_attention_reference(q, k, v, causal=True)
    got = _bf16_kernel_emulation(q, k, v, causal=True)
    assert got.dtype == torch.bfloat16
    assert _outside(got, want) == 0.0
    torch.testing.assert_close(got.float(), want, rtol=BF16_RTOL,
                               atol=BF16_ATOL)


def test_bf16_single_rounding_of_p_breaks_the_tolerance():
    """Why the kernel splits p: rounded once to bf16, as a plain bf16
    P V would take it, p puts many outputs outside the tolerance at
    S 512, where the split keeps every one inside."""
    q, k, v = _t(_bf16_qkv(7, 1, 512, 512, 2, 64))
    want = k8.flash_attention_reference(q, k, v, causal=True)
    once = _bf16_kernel_emulation(q, k, v, causal=True, split=False)
    split = _bf16_kernel_emulation(q, k, v, causal=True)
    assert _outside(once, want) > 0.05
    assert _outside(split, want) == 0.0


def test_kernel_view_16_byte_rule_for_bf16():
    """A bf16 view of one qkv projection is read as it is; a view whose
    start is 4 elements (8 bytes) off 16 is copied to an aligned tensor;
    in f32 the same 4 elements are 16 bytes, and no copy is made."""
    qkv = torch.zeros(2, 7, 3, 2, 32, dtype=torch.bfloat16)
    q = qkv[:, :, 1]
    assert k8._kernel_view(q).data_ptr() == q.data_ptr()
    flat = torch.zeros(2 * 7 * 2 * 32 + 4, dtype=torch.bfloat16)
    off = flat[4:].view(2, 7, 2, 32)
    copied = k8._kernel_view(off)
    assert copied.data_ptr() != off.data_ptr()
    assert copied.data_ptr() % 16 == 0 and torch.equal(copied, off)
    f32 = torch.zeros(2 * 7 * 2 * 32 + 4)[4:].view(2, 7, 2, 32)
    assert k8._kernel_view(f32).data_ptr() == f32.data_ptr()


# -- the f32 kernel's arithmetic ----------------------------------------------

_TF32_HI = -8192          # 0xffffe000: sign, exponent, 10 mantissa bits


def _tf32(x):
    """x with its low 13 mantissa bits cleared, as the tensor core reads
    an f32 operand."""
    return (x.view(torch.int32) & _TF32_HI).view(torch.float32)


def _tf32_product(eq, a, b, split):
    """einsum of TF32 operands summed in f32: three products of hi and lo
    parts (lo = tf32(x - hi), lo lo dropped) with ``split``, else one."""
    if not split:
        return torch.einsum(eq, _tf32(a), _tf32(b))
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)
            + torch.einsum(eq, ah, bh))


def _f32_kernel_emulation(q, k, v, causal, scale=None, split=True,
                          tile=64):
    """The f32 kernel (flash_attention.cu) as the CPU can compute it: each
    64-key tile's scores are q k^T on the TF32 tensor cores (split: three
    products, f32-accurate; else one pass), times the scale; the online
    softmax runs in f32 with l summed from the f32 p; P V takes p and v
    through the same products, accumulated in f32."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = scale if scale is not None else 1.0 / np.sqrt(d)
    m = torch.full((b, h, sq, 1), port.NEG_INF)
    l = torch.zeros((b, h, sq, 1))
    acc = torch.zeros((b, h, sq, d))
    rows = torch.arange(sq)[:, None]
    for k0 in range(0, sk, tile):
        kt, vt = k[:, k0:k0 + tile], v[:, k0:k0 + tile]
        s = _tf32_product("bqhd,bkhd->bhqk", q, kt, split) * np.float32(scale)
        keep = torch.ones((sq, kt.shape[1]), dtype=torch.bool)
        if causal:
            keep = torch.arange(k0, k0 + kt.shape[1])[None, :] <= rows
        s = s.masked_fill(~keep, port.NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new).masked_fill(~keep, 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + _tf32_product("bhqk,bkhd->bhqd", p, vt, split)
        m = m_new
    return (acc / l.clamp_min(1e-30)).permute(0, 2, 1, 3)


@pytest.mark.parametrize("sq, sk", [(64, 64), (50, 37), (23, 50), (1, 9),
                                    (63, 63)])
@pytest.mark.parametrize("causal", [False, True])
def test_f32_kernel_arithmetic_matches_pallas_interpret(sq, sk, causal):
    q, k, v = _qkv(0, 2, sq, sk, 4, 16)
    want = ref.flash_attention(*_j((q, k, v)), causal=causal, block_q=16,
                               block_k=16, interpret=True)
    got = _f32_kernel_emulation(*_t((q, k, v)), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=FWD_ATOL)


# the sequence template's rows: eval/neural_throughput.py's training step
# (S 127) and its long-context cell (S 2047), D 32
@pytest.mark.parametrize("s, b, h", [(127, 2, 4), (2047, 1, 2)])
@pytest.mark.parametrize("causal", [False, True])
def test_f32_kernel_arithmetic_matches_plain_version_in_f64(s, b, h, causal):
    q, k, v = _t(_qkv(s, b, s, s, h, 32))
    want = k8.flash_attention_reference(q.double(), k.double(), v.double(),
                                        causal)
    got = _f32_kernel_emulation(q, k, v, causal)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.double().numpy(), want.numpy(), rtol=0,
                               atol=FWD_ATOL)


@pytest.mark.parametrize("s, b, h", [(127, 2, 4), (2047, 1, 2)])
def test_f32_single_tf32_pass_breaks_the_tolerance(s, b, h):
    """Why the kernel splits every operand: one TF32 pass (10 mantissa
    bits) puts most outputs outside FWD_ATOL of the f64 attention, where
    the split keeps every one inside."""
    q, k, v = _t(_qkv(s + 1, b, s, s, h, 32))
    want = k8.flash_attention_reference(q.double(), k.double(), v.double(),
                                        True)
    once = _f32_kernel_emulation(q, k, v, True, split=False)
    split = _f32_kernel_emulation(q, k, v, True)
    err_once = (once.double() - want).abs()
    err_split = (split.double() - want).abs()
    assert float((err_once > FWD_ATOL).double().mean()) > 0.5
    assert float(err_once.max()) > 10 * FWD_ATOL
    assert float(err_split.max()) <= FWD_ATOL
