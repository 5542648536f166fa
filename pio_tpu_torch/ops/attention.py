"""Attention: the plain oracle, chunked (trainable) attention and flash.

Counterpart of ``pio_tpu.ops.attention``, single device:

 * ``attention_reference`` — plain softmax attention, the oracle;
 * ``chunked_attention`` — online softmax over key chunks, with each
   chunk's statistics recomputed in the backward pass
   (``torch.utils.checkpoint``, where the reference uses
   ``jax.checkpoint``), so training memory is O(Sq * chunk), not
   O(Sq * Sk);
 * ``flash_attention`` — the forward kernel (K8,
   ``ops/kernels/flash_attention.cu``), re-exported;
 * ``flash_attention_trainable`` — K8's forward with the gradients of
   ``chunked_attention`` at the same point, as the reference's custom VJP.

Layouts are the reference's: q (B, Sq, H, D), k and v (B, Sk, H, D).
Masks add -1e30 and zero the masked probabilities, so a row that sees no
key is zeros, not NaN. ``ring_attention`` and ``ulysses_attention`` (the
sequence-parallel variants) are not ported yet.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from pio_tpu_torch.ops.kernels.flash_attention import (
    NEG_INF,
    flash_attention,
)

__all__ = ["NEG_INF", "attention_reference", "chunked_attention",
           "flash_attention", "flash_attention_trainable"]


def attention_reference(q, k, v, causal: bool = False,
                        scale: float | None = None):
    """Plain softmax attention; the correctness oracle for the kernels.
    q: (B, Sq, H, D); k/v: (B, Sk, H, D) -> (B, Sq, H, D)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def _chunk_stats(q, k_c, v_c, off: int, sk: int, causal: bool,
                 scale: float):
    """Un-normalized attention of q over one key chunk starting at
    position ``off``: (o (B,Sq,H,D), m (B,H,Sq,1), l (B,H,Sq,1))."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k_c) * scale
    k_pos = off + torch.arange(k_c.shape[1], device=q.device)
    keep = (k_pos < sk)[None, :]                     # padded keys drop
    if causal:
        q_pos = torch.arange(q.shape[1], device=q.device)
        keep = keep & (q_pos[:, None] >= k_pos[None, :])
    s = s.masked_fill(~keep, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m).masked_fill(~keep, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bkhd->bqhd", p, v_c), m, l


def chunked_attention(q, k, v, causal: bool = False,
                      scale: float | None = None, chunk: int = 1024):
    """Online-softmax attention over key/value chunks, differentiable.
    Each chunk's statistics are checkpointed: the backward recomputes
    them instead of storing one (B, H, Sq, chunk) residual per chunk."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    chunk = min(chunk, sk)
    pad = (chunk - sk % chunk) % chunk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    o = torch.zeros((b, sq, h, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, sq, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, sq, 1), dtype=torch.float32, device=q.device)
    for off in range(0, sk + pad, chunk):
        o_i, m_i, l_i = checkpoint(
            _chunk_stats, q, k[:, off:off + chunk], v[:, off:off + chunk],
            off, sk, causal, scale, use_reentrant=False)
        m_new = torch.maximum(m, m_i)
        a_prev = torch.exp(m - m_new)
        a_i = torch.exp(m_i - m_new)
        l = l * a_prev + l_i * a_i
        o = o * a_prev.transpose(1, 2) + o_i * a_i.transpose(1, 2)
        m = m_new
    o = o / l.transpose(1, 2).clamp_min(1e-30)
    return o.to(q.dtype)


class _FlashTrainable(torch.autograd.Function):
    """Forward: K8 (its plain version on the CPU). Backward: the
    vector-Jacobian product of ``chunked_attention`` at the same inputs,
    the same function, so the gradients are exact up to the two forwards'
    rounding."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, chunk):
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, scale, chunk)
        return flash_attention(q, k, v, causal=causal, scale=scale)

    @staticmethod
    def backward(ctx, g):
        causal, scale, chunk = ctx.args
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            o = chunked_attention(q, k, v, causal=causal, scale=scale,
                                  chunk=chunk)
            dq, dk, dv = torch.autograd.grad(o, (q, k, v), g)
        return dq, dk, dv, None, None, None


def flash_attention_trainable(q, k, v, causal: bool = False,
                              scale: float | None = None,
                              chunk: int = 1024):
    """``flash_attention`` with gradients (through ``chunked_attention``)."""
    return _FlashTrainable.apply(q, k, v, causal, scale, chunk)
