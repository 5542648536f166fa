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
key is zeros, not NaN.

The sequence-parallel variants run over the seq axis of a
``parallel.mesh.Mesh``, each rank holding a contiguous slice of the
sequence, with the differentiable collectives of
``parallel/collectives.py``; like the reference's, they are plain tensor
code, no kernel:

 * ``ring_attention`` — n steps, each folding the k/v shard this rank
   holds into its queries' online softmax, then passing k and v one
   rank along the axis (``ppermute``);
 * ``ring_attention_sharded`` — the caller-facing form over whole
   (B, S, H, D) tensors: each rank attends its slice;
 * ``ulysses_attention`` — a tiled all_to_all from sequence to head
   sharding, the plain attention on the whole sequence for H/n heads,
   and the reverse all_to_all.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from pio_tpu_torch.ops.kernels.flash_attention import (
    NEG_INF,
    flash_attention,
)
from pio_tpu_torch.parallel.collectives import all_to_all, ppermute

__all__ = ["NEG_INF", "attention_reference", "chunked_attention",
           "flash_attention", "flash_attention_trainable",
           "ring_attention", "ring_attention_sharded", "ulysses_attention"]


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


# ---------------------------------------------------------------------------
# Sequence parallelism over the mesh's seq axis
# ---------------------------------------------------------------------------

def _block_attn_stats(q, k, v, scale: float, q_offset: int, k_offset: int,
                      causal: bool):
    """Un-normalized attention of the local queries (at global offset
    ``q_offset``) over one k/v shard (at ``k_offset``): (o (B,Sq,H,D),
    m (B,H,Sq,1), l (B,H,Sq,1)); the causal mask by global positions."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    keep = None
    if causal:
        q_pos = q_offset + torch.arange(q.shape[1], device=q.device)
        k_pos = k_offset + torch.arange(k.shape[1], device=q.device)
        keep = q_pos[:, None] >= k_pos[None, :]
        s = s.masked_fill(~keep, NEG_INF)
    # rows fully masked stay at NEG_INF
    m = s.amax(dim=-1, keepdim=True).clamp_min(NEG_INF)
    p = torch.exp(s - m)
    if causal:
        p = p.masked_fill(~keep, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bkhd->bqhd", p, v), m, l


def ring_attention(q, k, v, mesh, axis: str = "seq", causal: bool = False,
                   scale: float | None = None):
    """Sequence-parallel attention: q, k, v (B, S/n, H, D) are this
    rank's slice of the sequence along ``axis`` of ``mesh``. Each of the
    n steps folds the shard held (which started on rank (i - step) % n)
    into the online softmax, then passes k and v to the next rank; the
    backward sends their cotangents back the same way. The result is in
    q's dtype."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    n = mesh.axis_size(axis)
    my = mesh.axis_index(axis)
    s_local = q.shape[1]
    b, sq, h, d = q.shape
    o = torch.zeros((b, sq, h, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, sq, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, sq, 1), dtype=torch.float32, device=q.device)
    k_cur, v_cur = k, v
    for step in range(n):
        o_i, m_i, l_i = _block_attn_stats(
            q, k_cur, v_cur, scale, my * s_local,
            ((my - step) % n) * s_local, causal)
        m_new = torch.maximum(m, m_i)
        a_prev = torch.exp(m - m_new)
        a_i = torch.exp(m_i - m_new)
        l = l * a_prev + l_i * a_i
        o = o * a_prev.transpose(1, 2) + o_i * a_i.transpose(1, 2)
        m = m_new
        # the reference rotates after every step, the last included
        k_cur = ppermute(k_cur, mesh, axis)
        v_cur = ppermute(v_cur, mesh, axis)
    o = o / l.transpose(1, 2).clamp_min(1e-30)
    return o.to(q.dtype)


def _seq_slice(x, mesh, axis: str):
    n, i = mesh.axis_size(axis), mesh.axis_index(axis)
    if x.shape[1] % n:
        raise ValueError(f"sequence length {x.shape[1]} does not divide "
                         f"over the {axis} axis ({n})")
    s = x.shape[1] // n
    return x[:, i * s:(i + 1) * s]


def ring_attention_sharded(q, k, v, mesh, axis: str = "seq",
                           causal: bool = False):
    """The caller-facing ring: q, k, v whole (B, S, H, D) on every rank
    of the line; each rank attends its slice of the sequence along
    ``axis`` and returns it, (B, S/n, H, D). Batch is replicated over
    the axis here, as in the reference; a trainer composes it with the
    data axis by handing each data rank its own rows."""
    return ring_attention(*(_seq_slice(x, mesh, axis) for x in (q, k, v)),
                          mesh, axis, causal=causal)


def ulysses_attention(q, k, v, mesh, axis: str = "seq",
                      causal: bool = False, scale: float | None = None):
    """All-to-all sequence parallelism: q, k, v (B, S/n, H, D) are this
    rank's slice of the sequence along ``axis``, H divisible by n. A
    tiled all_to_all gives each rank the whole sequence for H/n heads,
    the plain attention runs on it, and the reverse all_to_all returns
    this rank's slice of every head."""
    qh, kh, vh = (all_to_all(x, mesh, axis, split_axis=2, concat_axis=1)
                  for x in (q, k, v))
    o = attention_reference(qh, kh, vh, causal=causal, scale=scale)
    return all_to_all(o, mesh, axis, split_axis=1,
                      concat_axis=2).to(q.dtype)
