"""Flash attention forward: CUDA kernel wrapper and its plain version.

Replaces the Pallas TPU kernel ``flash_attention`` -> ``_flash_kernel``
(``pio_tpu/ops/attention.py``), blockwise attention with an online
softmax:

    o[b, i, h] = softmax_j(scale * q[b, i, h] . k[b, j, h]) @ v[b, :, h]

q (B, Sq, H, D), k and v (B, Sk, H, D), f32 or bf16; the output has q's
shape and type. The scale defaults to 1/sqrt(D). ``causal`` lets row i see
keys 0..i (aligned top-left, also when Sq != Sk); a row that sees no key is
zeros, not NaN.

``flash_attention`` launches ``flash_attention.cu`` for CUDA tensors and
raises if it cannot; only for tensors on the CPU does it compute the plain
version, ``flash_attention_reference``. Each type has its own kernel
(``KERNELS``), both on the tensor cores and fed by TMA: f32 runs
``mma.sync`` in 3xTF32 (each operand split into TF32 hi and lo parts,
lo*lo dropped), so every product is f32-accurate; bf16 runs ``wgmma``, the
products of bf16 q and k exact in f32, P split into bf16 hi and lo parts
for P V, the output rounded to bf16. Both scale the scores after the
products. The kernels read q, k and v through their strides: the
transformer block hands them views of one qkv tensor, which are not
copied. Only a view whose last dim is not contiguous, or whose strides or
start are not a multiple of 16 bytes (as TMA reads them), is copied
first. The kernels are instantiated at D 32, 64 and 128 (``HEAD_DIMS``);
a narrower head (the sequence-custom example's D 16) runs at the next
of them, q, k and v zero-padded along D and the output cut back: the
padded columns add exact zeros to every product, and the scale stays
1/sqrt of the real D.
"""

from __future__ import annotations

import ctypes
import math

import torch

from pio_tpu_torch.ops.kernels.build import LaunchCounter, load_library

#: launches of the CUDA kernel (the CPU path does not count)
launches = LaunchCounter()

#: head widths the kernel is instantiated for
HEAD_DIMS = (32, 64, 128)

NEG_INF = -1e30
# the plain version scores q in row blocks of at most this many bytes of
# (B, H, rows, Sk) scores, so a 32k-long causal sequence fits the card
_SCORE_BLOCK_BYTES = 1 << 30

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the kernel of ``flash_attention.cu`` that each input type takes
KERNELS = {torch.float32: "f32_3xtf32_wgmma", torch.bfloat16: "bf16_wgmma"}
# strides and starts the kernels take as they are (their TMA tensor maps)
_ALIGN_BYTES = 16
_lib: "ctypes.CDLL | None" = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = load_library("flash_attention")
        lib.pio_flash_attention.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
            + [ctypes.c_longlong] * 9
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.pio_flash_attention.restype = ctypes.c_int
        lib.pio_cuda_error_string.argtypes = [ctypes.c_int]
        lib.pio_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = False,
                              scale: float | None = None) -> torch.Tensor:
    """Plain torch version, in f32 (f64 for f64 inputs): scores, masks,
    a max-shifted softmax with l clamped at 1e-30, and P V, computed for
    blocks of query rows so the scores never exceed about 1 GiB; under
    the causal mask a block scores only the keys its last row sees."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    ct = torch.promote_types(q.dtype, torch.float32)
    out = torch.zeros((b, sq, h, d), dtype=ct, device=q.device)
    if sq == 0 or sk == 0:
        return out.to(q.dtype)
    kf, vf = k.to(ct), v.to(ct)
    itemsize = torch.empty((), dtype=ct).element_size()
    rows = max(1, _SCORE_BLOCK_BYTES // (b * h * sk * itemsize))
    for r0 in range(0, sq, rows):
        r1 = min(sq, r0 + rows)
        hi = min(sk, r1) if causal else sk
        s = torch.einsum("bqhd,bkhd->bhqk", q[:, r0:r1].to(ct) * scale,
                         kf[:, :hi])
        keep = None
        if causal:
            keep = (torch.arange(r0, r1, device=q.device)[:, None]
                    >= torch.arange(hi, device=q.device)[None, :])
            s = s.masked_fill(~keep, NEG_INF)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        if keep is not None:
            p = p.masked_fill(~keep, 0.0)
        l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        out[:, r0:r1] = (torch.einsum("bhqk,bkhd->bqhd", p, vf[:, :hi])
                         / l.permute(0, 2, 1, 3))
    return out.to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} dtype {t.dtype}, q dtype {q.dtype}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"dtype {q.dtype}; want float32 or bfloat16")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.ndim != 4:
            raise ValueError(f"{name} has shape {tuple(t.shape)}; want "
                             "(B, S, H, D)")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    b, _, h, d = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, h, d):
        raise ValueError(f"k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)} in B, H or D")
    if d not in HEAD_DIMS:
        raise ValueError(f"head width {d}; the kernel takes {HEAD_DIMS}")


def _kernel_view(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where the kernel can read it through its strides (the
    last dim contiguous, every stride and the start a multiple of 16
    bytes), else a contiguous copy."""
    esize = t.element_size()
    if (t.stride(-1) == 1
            and all(s * esize % _ALIGN_BYTES == 0 for s in t.stride()[:3])
            and t.data_ptr() % _ALIGN_BYTES == 0):
        return t
    # a fresh allocation: contiguous() would hand back a contiguous tensor
    # whose start is misaligned as it is
    return t.clone(memory_format=torch.contiguous_format)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False,
                    scale: float | None = None) -> torch.Tensor:
    """Attention forward; same contract as ``flash_attention_reference``.
    On a CUDA device it launches the kernel (a build or launch failure
    raises)."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    d = q.shape[-1]
    if d < HEAD_DIMS[-1] and d not in HEAD_DIMS:
        width = next(w for w in HEAD_DIMS if w > d)
        pad = [torch.nn.functional.pad(t, (0, width - t.shape[-1]))
               for t in (q, k, v)]
        scale = scale if scale is not None else 1.0 / math.sqrt(d)
        return flash_attention(*pad, causal=causal, scale=scale)[..., :d]
    _check(q, k, v)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    q, k, v = (_kernel_view(t) for t in (q, k, v))
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.pio_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], b, h, sq, sk, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            float(scale), int(bool(causal)), stream)
    if err:
        raise RuntimeError(f"flash_attention launch failed: "
                           f"{lib.pio_cuda_error_string(err).decode()}")
    launches.add()
    return out
