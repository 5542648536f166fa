"""Mixture-of-experts FFN on one device: top-1 routing with a per-expert
capacity, a ReLU FFN per expert, and the Switch-Transformer load-balance
loss.

Counterpart of ``pio_tpu.ops.moe``'s single-device path (``moe_ffn``),
the drop-in FFN of the sequence template's transformer blocks
(``SequenceParams.moe_experts > 0``). Plain functions on tensors: the
device is the input's, and ``init_moe_params`` draws from an explicit
``torch.Generator``.

Routing is the reference's to the slot: probs = softmax(x @ router), each
token goes to its argmax expert (the first maximum on ties), weighted by
that probability (the gate), at its rank among the earlier tokens (in
row-major token order) routed to the same expert; a token whose rank
reaches the capacity C = ceil(cf * T / E) is dropped and comes out as
exact zeros (it rides the block's residual path).

``moe_ffn`` works in index form: the kept tokens are copied into an
(E, C, D) slot tensor at (expert, rank), the experts run as one batched
matmul pair, and each kept token reads its slot's output back, scaled by
its gate. The reference writes the same dispatch and return as one-hot
einsums over a (T, E, C) tensor (``moe_ffn_onehot`` here, the plain
version the tests hold ``moe_ffn`` against); each of those einsums sums
exactly one nonzero term (``x * 1`` or ``gate * out``) and zeros, so the
two forms give the same values and, by autograd, the same gradients, bar
NaN/Inf propagation through the zero terms. The one-hot tensor is T*E*C
floats: 8.5 GB a tensor at 32,512 tokens and 4 experts at cf 2.0, where
the index form moves only the (E, C, D) slots.

``moe_ffn_ep`` is the reference's expert-parallel form over an axis of a
``parallel.mesh.Mesh``: tokens and the experts' params are split over the
axis's ranks, the router is replicated, and two tiled all_to_alls
(``parallel/collectives.py``) move the capacity slots to their experts'
ranks and back. Each rank budgets ceil(cf * t_local / E) slots an expert
from its own tokens, so it equals ``moe_ffn`` when no expert overflows.
No trainer calls it, in either package.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from pio_tpu_torch.parallel.collectives import (
    all_to_all,
    gather_from_axis,
    reduce_from_axis,
)

__all__ = ["MoEConfig", "init_moe_", "init_moe_params", "moe_ffn",
           "moe_ffn_ep", "moe_ffn_onehot", "route"]


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 4
    d_model: int = 64
    d_ff: int = 128
    capacity_factor: float = 1.25  # slots per expert = cf * tokens/experts


def _capacity(n_tokens: int, n_experts: int, cf: float) -> int:
    return max(1, int(np.ceil(cf * n_tokens / n_experts)))


def init_moe_(name: str, p: torch.Tensor,
              generator: torch.Generator) -> torch.Tensor:
    """Draw the MoE param ``name`` in place with the reference's
    distribution: the router (d, E), w_in (E, d, f) and w_out (E, f, d)
    normal(0, 1/sqrt(fan_in)), plain, their fan-in the second-last axis
    (d, d, f); the biases b_in and b_out zero."""
    if name in ("router", "w_in", "w_out"):
        return p.normal_(0.0, 1.0 / math.sqrt(p.shape[-2]),
                         generator=generator)
    return p.zero_()


def init_moe_params(cfg: MoEConfig, generator: torch.Generator,
                    device) -> dict[str, torch.Tensor]:
    """The params of one MoE FFN, drawn by ``init_moe_`` on the host from
    ``generator``, then moved to ``device``."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    shapes = {"router": (d, e), "w_in": (e, d, f), "b_in": (e, f),
              "w_out": (e, f, d), "b_out": (e, d)}
    return {k: init_moe_(k, torch.empty(shape), generator).to(device)
            for k, shape in shapes.items()}


def route(x: torch.Tensor, router: torch.Tensor, n_experts: int,
          capacity: int, with_aux: bool = True):
    """Top-1 routing of x (T, D) -> (expert (T,) int64, pos (T,) int64,
    gate (T,), keep (T,) bool, aux scalar or None).

    ``pos`` is the token's rank among the earlier tokens routed to the
    same expert (the exclusive cumsum); ``keep`` is ``pos < capacity``;
    ``aux`` is E * sum_e frac_e * mean_prob_e, frac_e the share of tokens
    routed to e (before the capacity cut) and mean_prob_e the mean router
    probability of e."""
    probs = torch.softmax(x @ router, dim=-1)                  # (T, E)
    expert = torch.argmax(probs, dim=-1)                       # (T,)
    gate = probs.gather(1, expert[:, None])[:, 0]
    one_hot = F.one_hot(expert, n_experts)                     # (T, E)
    # the running count of each expert's tokens, scanned along rows of an
    # (E, T) copy: a scan down the T rows of E columns runs nearly
    # serially on the card; at the token's own expert the inclusive count
    # less one is the exclusive one
    count = torch.cumsum(one_hot.t().contiguous(), 1)          # (E, T)
    pos = count.gather(0, expert[None])[0] - 1
    keep = pos < capacity
    aux = None
    if with_aux:
        frac = one_hot.to(probs.dtype).mean(0)
        aux = n_experts * torch.sum(frac * probs.mean(0))
    return expert, pos, gate, keep, aux


def _expert_ffn(params: dict, xs: torch.Tensor) -> torch.Tensor:
    """xs: (E, C, D) slots -> (E, C, D); one ReLU FFN per expert."""
    h = torch.relu(torch.bmm(xs, params["w_in"]) + params["b_in"][:, None])
    return torch.bmm(h, params["w_out"]) + params["b_out"][:, None]


def moe_ffn(params: dict, x: torch.Tensor, cfg: MoEConfig,
            with_aux: bool = True):
    """Single-device MoE FFN in index form. x: (T, D) -> (y (T, D), aux),
    aux None when ``with_aux`` is false (serving)."""
    t, d = x.shape
    e = cfg.n_experts
    cap = _capacity(t, e, cfg.capacity_factor)
    expert, pos, gate, keep, aux = route(x, params["router"], e, cap,
                                         with_aux)
    # the flat slot of each token; a dropped token points at slot E*C,
    # one past the last: kept tokens own distinct slots, and the spare
    # row the dropped ones share is cut off before the experts and reads
    # back as zeros. index_copy and index_select, whose gradients are a
    # gather and an index_add: an indexed read's gradient accumulates
    # duplicate indices one after another, and an empty slot's would
    # repeat one index for every empty slot
    slot = torch.where(keep, expert * cap + pos, e * cap)
    slots = x.new_zeros(e * cap + 1, d).index_copy(0, slot, x)[:-1]
    outs = _expert_ffn(params, slots.reshape(e, cap, d))
    out_pad = torch.cat([outs.reshape(e * cap, d), outs.new_zeros(1, d)])
    return gate[:, None] * out_pad.index_select(0, slot), aux


def moe_ffn_onehot(params: dict, x: torch.Tensor, cfg: MoEConfig):
    """The reference's one-hot form, literally (``pio_tpu.ops.moe.
    moe_ffn``): (T, E, C) dispatch and combine tensors and three einsums.
    The plain version ``moe_ffn`` is held against; memory T*E*C."""
    t = x.shape[0]
    e = cfg.n_experts
    cap = _capacity(t, e, cfg.capacity_factor)
    expert, pos, gate, keep, aux = route(x, params["router"], e, cap)
    one_hot = F.one_hot(expert, e).to(x.dtype)                 # (T, E)
    # a rank at or past C gives an all-zero row, as jax.nn.one_hot does
    pos_oh = (pos[:, None] == torch.arange(cap, device=x.device)).to(
        x.dtype)                                               # (T, C)
    dispatch = one_hot[:, :, None] * pos_oh[:, None, :]
    dispatch = dispatch * keep[:, None, None].to(x.dtype)
    combine = dispatch * gate[:, None, None]
    slots = torch.einsum("tec,td->ecd", dispatch, x)
    outs = _expert_ffn(params, slots)
    return torch.einsum("tec,ecd->td", combine, outs), aux


EXPERT_PARAMS = ("w_in", "b_in", "w_out", "b_out")


def moe_ffn_ep(params: dict, x: torch.Tensor, cfg: MoEConfig, mesh,
               axis: str = "data"):
    """The reference's caller-facing ``moe_ffn_ep``: ``x`` (T, D) every
    token and ``params`` the whole MoE FFN, alike on every rank of the
    line along ``axis``; each rank takes its T/n tokens and E/n experts
    and moves the capacity slots to their experts' ranks and back. ->
    (y (T, D) gathered over the axis, the aux averaged over it). Raises
    when the ranks do not divide the experts or the tokens."""
    n = mesh.axis_size(axis)
    if cfg.n_experts % n != 0:
        raise ValueError(
            f"n_experts ({cfg.n_experts}) must divide over {n} devices"
        )
    t = x.shape[0]
    if t % n != 0:
        raise ValueError(f"token count ({t}) must divide over {n} devices")
    i, e, d = mesh.axis_index(axis), cfg.n_experts, x.shape[1]
    e_loc, t_loc = e // n, t // n
    p = {k: params[k][i * e_loc:(i + 1) * e_loc] for k in EXPERT_PARAMS}
    x = x[i * t_loc:(i + 1) * t_loc]
    # the body of the reference's shard_map: this rank's tokens routed
    # against every expert, its slots budgeted from its own tokens
    cap = _capacity(t_loc, e, cfg.capacity_factor)
    expert, pos, gate, keep, aux = route(x, params["router"], e, cap)
    slot = torch.where(keep, expert * cap + pos, e * cap)
    slots = x.new_zeros(e * cap + 1, d).index_copy(0, slot, x)[:-1]
    # slot block j holds experts j*e_loc..: it goes to rank j, which gets
    # (n, e_loc, cap, D) back, by source rank
    shuffled = all_to_all(slots.reshape(n, e_loc, cap, d), mesh, axis,
                          split_axis=0, concat_axis=0)
    shuffled = shuffled.transpose(0, 1).reshape(e_loc, n * cap, d)
    outs = _expert_ffn(p, shuffled)                        # (e_loc, n*cap, D)
    back = outs.reshape(e_loc, n, cap, d).transpose(0, 1).contiguous()
    returned = all_to_all(back, mesh, axis, split_axis=0,
                          concat_axis=0).reshape(e * cap, d)
    out_pad = torch.cat([returned, returned.new_zeros(1, d)])
    y = gate[:, None] * out_pad.index_select(0, slot)
    return (gather_from_axis(y, mesh, axis),
            reduce_from_axis(aux, mesh, axis) / n)
