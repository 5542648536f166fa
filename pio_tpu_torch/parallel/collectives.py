"""Differentiable collectives over a named axis of the mesh.

The reference's sequence-parallel attention, expert-parallel MoE and
tensor-parallel layers call ``jax.lax`` primitives inside ``shard_map``
and let JAX transpose them. The port writes each as a
``torch.autograd.Function`` whose backward is stated:

 * ``ppermute(x, mesh, axis, shift)`` — rank i along ``axis`` sends to
   rank (i + shift) % n and receives from (i - shift) % n; backward: the
   inverse permutation (shift -> -shift);
 * ``all_to_all(x, mesh, axis, split_axis, concat_axis)`` — the tiled
   ``jax.lax.all_to_all``: ``x`` is cut into n blocks along
   ``split_axis``, block j goes to rank j, and the blocks received are
   concatenated along ``concat_axis`` in source order; backward: the
   reverse all_to_all (split along ``concat_axis``, concatenate along
   ``split_axis``);
 * ``copy_to_axis`` (forward identity, backward all-reduce) and
   ``reduce_from_axis`` (forward all-reduce, backward identity) — the
   pair Megatron-style tensor parallelism puts around a column- and a
   row-parallel layer;
 * ``gather_from_axis`` — a tiled all_gather along dim 0 whose backward
   sums the cotangents over the axis and keeps this rank's block;

and ``sum_grads``, the data-parallel step's gradient sum (no autograd).

Each degenerates to the identity on a line of one rank. Gloo on the
CPU runs every one of these. Where a group is gloo and the tensor is on
the card, ``all_to_all`` and the point-to-point sends go through pinned
host copies (``_host``), as gloo itself stages its all-reduce and
all_gather: handed a CUDA tensor to send, gloo's TCP pairs write device
memory with ``writev`` and abort the process (``gloo::IoException``,
"Bad address"). The computation stays on the card.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from pio_tpu_torch.parallel import distributed


def _host(x: torch.Tensor) -> bool:
    """True when ``x`` must cross a gloo group through host memory."""
    return x.is_cuda and distributed.backend() != "nccl"


def _to_host(x: torch.Tensor) -> torch.Tensor:
    out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    out.copy_(x)
    return out


def _all_to_all_blocks(blocks: list, mesh, axis) -> list:
    """Block j of ``blocks`` (all of one shape) to rank j of this rank's
    line along ``axis``; -> the blocks received, by source rank. One
    ``all_to_all_single`` of the blocks stacked (gloo has no list
    form in every torch release)."""
    _, group = mesh.line(axis)
    dev = blocks[0].device
    send = torch.stack(blocks).contiguous()
    if _host(send):
        send = _to_host(send)
    recv = torch.empty_like(send, memory_format=torch.contiguous_format)
    dist.all_to_all_single(recv, send, group=group)
    return list(recv.to(dev).unbind(0))


def _all_to_all(x, mesh, axis, split_axis: int, concat_axis: int):
    n = mesh.axis_size(axis)
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dim {split_axis} of {tuple(x.shape)} "
                         f"does not divide over {n} ranks")
    got = _all_to_all_blocks(list(x.chunk(n, dim=split_axis)), mesh, axis)
    return torch.cat(got, dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split_axis, concat_axis):
        ctx.args = (mesh, axis, split_axis, concat_axis)
        return _all_to_all(x, mesh, axis, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, split_axis, concat_axis = ctx.args
        return (_all_to_all(g, mesh, axis, concat_axis, split_axis),
                None, None, None, None)


def all_to_all(x: torch.Tensor, mesh, axis, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """The tiled all_to_all of ``x`` along ``axis`` (see the module)."""
    if mesh.axis_size(axis) == 1:
        return x
    return _AllToAll.apply(x, mesh, axis, split_axis, concat_axis)


def _ppermute(x, mesh, axis, shift: int):
    ranks, group = mesh.line(axis)
    n = len(ranks)
    i = ranks.index(mesh.rank)
    dst, src = ranks[(i + shift) % n], ranks[(i - shift) % n]
    dev = x.device
    send = _to_host(x) if _host(x) else x.contiguous()
    recv = torch.empty_like(send)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, dst, group),
        dist.P2POp(dist.irecv, recv, src, group)])
    for req in reqs:
        req.wait()
    return recv.to(dev)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, shift):
        ctx.args = (mesh, axis, shift)
        return _ppermute(x, mesh, axis, shift)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, shift = ctx.args
        return _ppermute(g, mesh, axis, -shift), None, None, None


def ppermute(x: torch.Tensor, mesh, axis, shift: int = 1) -> torch.Tensor:
    """``x`` from rank (i - shift) % n of this rank's line along
    ``axis`` (``jax.lax.ppermute`` with perm [(i, (i + shift) % n)])."""
    if mesh.axis_size(axis) == 1 or shift % mesh.axis_size(axis) == 0:
        return x
    return _PPermute.apply(x, mesh, axis, shift)


class _CopyToAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.args = (mesh, axis)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, axis = ctx.args
        return mesh.psum(g.contiguous(), axis), None, None


class _ReduceFromAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh.psum(x.contiguous(), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def copy_to_axis(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    """Forward the identity, backward the sum over ``axis``: the input
    of a column-parallel layer, replicated over the axis."""
    if mesh.axis_size(axis) == 1:
        return x
    return _CopyToAxis.apply(x, mesh, axis)


def reduce_from_axis(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    """Forward the sum over ``axis``, backward the identity: the output
    of a row-parallel layer (or a vocab-parallel lookup)."""
    if mesh.axis_size(axis) == 1:
        return x
    return _ReduceFromAxis.apply(x, mesh, axis)


class _GatherFromAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.args = (mesh, axis, x.shape[0])
        return mesh.all_gather(x, axis)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, rows = ctx.args
        ranks, _ = mesh.line(axis)
        i = ranks.index(mesh.rank)
        total = mesh.psum(g.contiguous(), axis)
        return total[i * rows:(i + 1) * rows], None, None


def gather_from_axis(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    """Every rank's ``x`` along ``axis`` stacked on dim 0 in axis order;
    the gradient of this rank's block is the sum of every rank's
    cotangent of it."""
    if mesh.axis_size(axis) == 1:
        return x
    return _GatherFromAxis.apply(x, mesh, axis)


def sum_grads(params: list, mesh, axis) -> None:
    """Every param's gradient summed over ``axis``, in one all-reduce of
    the gradients laid end to end (a param without one counts zeros);
    nothing on a line of one rank."""
    if mesh.axis_size(axis) == 1:
        return
    grads = [q.grad if q.grad is not None else torch.zeros_like(q)
             for q in params]
    flat = mesh.psum(torch.cat([g.reshape(-1) for g in grads]), axis)
    off = 0
    for q, g in zip(params, grads):
        q.grad = flat[off:off + g.numel()].view_as(g)
        off += g.numel()
