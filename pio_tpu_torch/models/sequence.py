"""Sequential recommendation template (SASRec): self-attentive next-item
prediction over user event histories.

Counterpart of ``pio_tpu.models.sequence`` on one device: the same params,
sequences, model and query/result shapes. Training runs a causal
transformer over time-ordered per-user item sequences (next-item
cross-entropy, output head tied to the item embedding) with
``torch.optim.Adam``; serving encodes the user's recent history (a live
event-store read when ``app_name`` is set) with the flash-attention kernel
(K8, ``ops/kernels/flash_attention.cu``) on the card, the plain attention
on the CPU, as the reference does, then ranks on the host.

Two flax defaults are kept where torch's differ: LayerNorm's epsilon is
1e-6, and the FFN's GELU is the tanh approximation.

Training is supervised as the reference's is: with ``checkpoint_dir``
(or, under ``run_train``, the instance's checkpoint directory) the trainer
saves a step checkpoint every ``checkpoint_every`` steps
(``workflow/step_checkpoint.py``), resumes from the latest one, and after
every step runs the ``train.step.<n>`` chaos point, the preemption check
and the heartbeat (``workflow/spans.py``).

With ``moe_experts > 0`` each block's FFN is the mixture of experts of
``ops/moe.py`` (top-1 routing with a capacity, ReLU experts), and the
training loss adds ``moe_aux_weight`` times the blocks' mean load-balance
loss, as the reference's does. Capacity is counted over every token of a
forward, PAD rows and positions included, so once an expert overflows a
query's answer can depend on the other queries of its batch, in both
packages.

``read_eval`` gives the reference's rolling next-item folds, which
``eval --sweep`` scores through its sequential path.

Over a mesh (``parallel.mesh``; the template passes its context's mesh
when it holds more than one rank) training is the reference's dp x sp
step: each step's batch, rounded down to a multiple of the data axis, is
drawn alike on every rank, and each rank takes its rows (data axis) and
its slice of the sequence (seq axis, the sequence right-padded to a
multiple of it within POS_HEADROOM, positions offset by the slice's
start). Under seq > 1 attention is ``ring`` (``auto``) or ``ulysses``
(``ops/attention.py``); at seq 1 any local mode runs on each rank's rows,
``flash`` through K8. The loss sums its numerator and count over (data,
seq) and averages the MoE aux over both; the gradients are summed over
both axes, so every rank takes the same Adam step. They come out
n_data * n_seq times the single-device gradient, as the reference's do
under ``shard_map(check_vma=False)`` (its ``psum`` inside the loss is
transposed to another ``psum``); Adam's update all but ignores a constant
factor. With experts, a MoE FFN's capacity counts each rank's own
tokens. One device is a mesh of one rank (``local_mesh``), where every
collective is the identity and the step is the one-device step.
"""

from __future__ import annotations

import logging
import math
from dataclasses import dataclass
from functools import partial
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pio_tpu_torch.controller.base import (
    DataSource,
    FirstServing,
    IdentityPreparator,
    PAlgorithm,
    Params,
)
from pio_tpu_torch.controller.engine import Engine, EngineFactory
from pio_tpu_torch.data.bimap import EntityIdIndex
from pio_tpu_torch.ops.attention import (
    attention_reference,
    chunked_attention,
    flash_attention,
    flash_attention_trainable,
    ring_attention,
    ulysses_attention,
)
from pio_tpu_torch.ops.bucketing import pow2_bucket
from pio_tpu_torch.ops.moe import MoEConfig, init_moe_, moe_ffn
from pio_tpu_torch.parallel.collectives import sum_grads
from pio_tpu_torch.parallel.mesh import DATA_AXIS, SEQ_AXIS, local_mesh
from pio_tpu_torch.workflow.context import resolve_device
from pio_tpu_torch.workflow.spans import after_span, step_chaos_active
from pio_tpu_torch.workflow.step_checkpoint import (
    StepCheckpointConfig,
    StepCheckpointer,
    resume_or_init,
)

PAD = 0  # item index 0 is reserved as padding; real items start at 1
POS_HEADROOM = 16
LN_EPS = 1e-6  # flax's LayerNorm default (torch's is 1e-5)

log = logging.getLogger("pio_tpu_torch.models.sequence")


@dataclass(frozen=True)
class SequenceParams(Params):
    max_len: int = 64          # sequence length (pad/truncate buckets)
    embed_dim: int = 64
    num_heads: int = 2
    num_layers: int = 2
    ffn_dim: int = 128
    dropout: float = 0.0       # kept 0; eval-mode determinism
    learning_rate: float = 1e-3
    batch_size: int = 128
    steps: int = 300
    seed: int = 0
    # "auto" | "reference" | "chunked" | "flash" | "ring" | "ulysses" —
    # "flash" trains with K8's forward and chunked attention's backward;
    # on one device "auto" is chunked at max_len >= chunked_threshold and
    # the plain attention below it, and ring when the mesh shards the
    # sequence. "ring"/"ulysses" need a mesh with a seq axis > 1;
    # ulysses needs num_heads divisible by it.
    attention: str = "auto"
    chunked_threshold: int = 1024
    moe_experts: int = 0
    moe_capacity_factor: float = 2.0
    moe_aux_weight: float = 0.01
    unseen_only: bool = True   # serve-time: drop items already in history
    # serve-time live history read (empty app_name = training snapshot only)
    app_name: str = ""
    event_names: tuple[str, ...] = ("view", "buy")
    checkpoint_dir: str = ""
    checkpoint_every: int = 100


class Block(nn.Module):
    """Pre-LN transformer block: a bias-free qkv projection, attention
    through ``attn_fn``, a bias-free output projection, and a dense GELU
    FFN with biases or, with ``moe_experts > 0``, the MoE FFN of
    ``ops/moe.py`` (its params ``moe_router``, ``moe_w_in``, ``moe_b_in``,
    ``moe_w_out``, ``moe_b_out``, named and shaped as the reference's)."""

    def __init__(self, embed_dim: int, num_heads: int, head_dim: int,
                 ffn_dim: int, moe_experts: int = 0,
                 moe_capacity_factor: float = 2.0):
        super().__init__()
        self.num_heads, self.head_dim = num_heads, head_dim
        hd = num_heads * head_dim
        self.ln1 = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.qkv = nn.Linear(embed_dim, 3 * hd, bias=False)
        self.out = nn.Linear(hd, embed_dim, bias=False)
        self.ln2 = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.moe = None
        if moe_experts > 0:
            e, f = moe_experts, ffn_dim
            self.moe = MoEConfig(e, embed_dim, f, moe_capacity_factor)
            self.moe_router = nn.Parameter(torch.empty(embed_dim, e))
            self.moe_w_in = nn.Parameter(torch.empty(e, embed_dim, f))
            self.moe_b_in = nn.Parameter(torch.empty(e, f))
            self.moe_w_out = nn.Parameter(torch.empty(e, f, embed_dim))
            self.moe_b_out = nn.Parameter(torch.empty(e, embed_dim))
        else:
            self.ffn_in = nn.Linear(embed_dim, ffn_dim)
            self.ffn_out = nn.Linear(ffn_dim, embed_dim)

    def forward(self, x, attn_fn, aux: list | None = None):
        """``aux``, when given, gets the MoE FFN's load-balance loss."""
        b, s, e = x.shape
        h, d = self.num_heads, self.head_dim
        qkv = self.qkv(self.ln1(x)).reshape(b, s, 3, h, d)
        o = attn_fn(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
        x = x + self.out(o.reshape(b, s, h * d))
        y = self.ln2(x)
        if self.moe is not None:
            params = {"router": self.moe_router, "w_in": self.moe_w_in,
                      "b_in": self.moe_b_in, "w_out": self.moe_w_out,
                      "b_out": self.moe_b_out}
            y2, a = moe_ffn(params, y.reshape(b * s, e), self.moe,
                            with_aux=aux is not None)
            if aux is not None:
                aux.append(a)
            return x + y2.reshape(b, s, e)
        y = F.gelu(self.ffn_in(y), approximate="tanh")
        return x + self.ffn_out(y)


class SeqEncoder(nn.Module):
    """Item-id sequence -> per-position hidden states; logits are tied to
    the item embedding table (SASRec-style)."""

    def __init__(self, vocab: int, max_len: int, embed_dim: int,
                 num_heads: int, num_layers: int, ffn_dim: int,
                 moe_experts: int = 0, moe_capacity_factor: float = 2.0):
        super().__init__()
        self.embed_dim = embed_dim
        self.item_emb = nn.Parameter(torch.empty(vocab, embed_dim))
        self.pos_emb = nn.Parameter(torch.empty(max_len, embed_dim))
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, embed_dim // num_heads, ffn_dim,
                  moe_experts, moe_capacity_factor)
            for _ in range(num_layers))
        self.ln_f = nn.LayerNorm(embed_dim, eps=LN_EPS)

    def hidden(self, ids, attn_fn, pos_offset: int = 0,
               aux: list | None = None):
        """(B, S) item ids -> (B, S, E) states after the final LayerNorm;
        ``aux``, when given, gets each MoE block's load-balance loss."""
        s = ids.shape[1]
        # F.embedding, not item_emb[ids]: the indexing's backward
        # (index_put_ with accumulate) sums duplicate ids in a thread-
        # dependent order on the CPU, so a run would not reproduce itself
        # bit for bit (and a resumed run could not reproduce it)
        x = F.embedding(ids, self.item_emb) * math.sqrt(self.embed_dim)
        x = x + self.pos_emb[pos_offset:pos_offset + s][None]
        for block in self.blocks:
            x = block(x, attn_fn, aux)
        return self.ln_f(x)

    def forward(self, ids, attn_fn, pos_offset: int = 0,
                aux: list | None = None):
        x = self.hidden(ids, attn_fn, pos_offset, aux)
        return x, x @ self.item_emb.T                  # weight-tied head


def init_encoder_(encoder: SeqEncoder, seed: int) -> SeqEncoder:
    """Draw the encoder's params in place from ``seed`` with flax's
    initializers (torch cannot draw flax's numbers, only its
    distributions): normal(0.02) for both embedding tables, truncated
    lecun-normal for the dense kernels, zero biases, LayerNorm ones and
    zeros; a MoE block's params by ``ops/moe.py``'s ``init_moe_``."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in encoder.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if name in ("item_emb", "pos_emb"):
                p.normal_(0.0, 0.02, generator=g)
            elif leaf.startswith("moe_"):
                init_moe_(leaf[len("moe_"):], p, g)
            elif p.ndim == 2:
                # variance 1/fan_in after truncation at two std devs
                std = math.sqrt(1.0 / p.shape[1]) / .87962566103423978
                nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std,
                                      generator=g)
            elif name.endswith("weight"):               # LayerNorm scale
                p.fill_(1.0)
            else:
                p.zero_()
    return encoder


def user_histories(events):
    """-> ({user id: time-ordered item-id list}, items EntityIdIndex
    over EVERY item seen). The ONE event-grouping/ordering
    implementation behind read_training (build_sequences) and
    read_eval's rolling folds — so the two reads cannot drift on event
    filtering or ordering."""
    by_user: dict[str, list[tuple[Any, str]]] = {}
    item_ids: dict[str, None] = {}
    for e in events:
        if not e.target_entity_id:
            continue
        by_user.setdefault(e.entity_id, []).append(
            (e.event_time, e.target_entity_id)
        )
        item_ids.setdefault(e.target_entity_id, None)
    items = EntityIdIndex(item_ids.keys())
    hists = {}
    for uid, evs in by_user.items():
        evs.sort(key=lambda t: t[0])
        hists[uid] = [i for _, i in evs]
    return hists, items


def build_sequences(events, max_len: int):
    """Time-ordered per-user item sequences from user->item events.

    Returns (seqs int32 (N, max_len) right-aligned & PAD-left-padded,
    users EntityIdIndex over sequence owners, items EntityIdIndex with ids
    offset by 1 for PAD). Users with < 2 interactions are dropped (no
    next-item target exists)."""
    hists, items = user_histories(events)
    users, rows = [], []
    for uid, ids in hists.items():
        if len(ids) < 2:
            continue
        seq = [items.index_of(i) + 1 for i in ids][-max_len:]  # +1: PAD=0
        rows.append(np.pad(seq, (max_len - len(seq), 0)))
        users.append(uid)
    if not rows:
        raise ValueError("no user has >= 2 interactions; cannot train")
    return (
        np.stack(rows).astype(np.int32),
        EntityIdIndex(users),
        items,
    )


@dataclass
class SequenceData:
    seqs: np.ndarray            # (N, max_len) int32, PAD-left
    users: EntityIdIndex
    items: EntityIdIndex

    def sanity_check(self):
        assert self.seqs.ndim == 2 and self.seqs.shape[0] > 0


def make_encoder(n_items: int, p: SequenceParams) -> SeqEncoder:
    """The encoder for ``n_items`` items (plus PAD) under ``p``, its
    params not yet drawn. The position table has POS_HEADROOM rows beyond
    max_len, as the reference's, so either package's params fit it."""
    return SeqEncoder(
        vocab=n_items + 1, max_len=p.max_len + POS_HEADROOM,
        embed_dim=p.embed_dim, num_heads=p.num_heads,
        num_layers=p.num_layers, ffn_dim=p.ffn_dim,
        moe_experts=p.moe_experts,
        moe_capacity_factor=p.moe_capacity_factor,
    )


def training_attention(p: SequenceParams, mesh):
    """The training attention ``p.attention`` names over ``mesh`` (one
    rank's for one device), validated as the reference validates it."""
    if p.attention not in ("auto", "reference", "chunked", "flash",
                           "ring", "ulysses"):
        raise ValueError(
            f"unknown attention mode {p.attention!r}: expected "
            "'auto' | 'reference' | 'chunked' | 'flash' | 'ring' | "
            "'ulysses'"
        )
    # once the sequence is sharded, attention MUST be sequence-parallel
    # (ring or ulysses): a local-only attention would silently drop
    # cross-shard interactions
    use_sp = mesh.shape[SEQ_AXIS] > 1
    if use_sp and p.attention in ("reference", "chunked", "flash"):
        raise ValueError(
            f"attention={p.attention!r} is a local-only path and cannot "
            "run with the sequence sharded over the mesh seq axis; use "
            "'auto'/'ring'/'ulysses' or a seq=1 mesh"
        )
    if not use_sp and p.attention in ("ring", "ulysses"):
        raise ValueError(
            f"attention={p.attention!r} requires a mesh with a seq axis > 1"
        )
    if use_sp and p.attention == "ulysses":
        n_seq = mesh.shape[SEQ_AXIS]
        if p.num_heads % n_seq:
            raise ValueError(
                f"attention='ulysses' needs num_heads ({p.num_heads}) "
                f"divisible by the seq axis ({n_seq})"
            )
        return partial(ulysses_attention, mesh=mesh, axis=SEQ_AXIS,
                       causal=True)
    if use_sp:
        return partial(ring_attention, mesh=mesh, axis=SEQ_AXIS, causal=True)
    if p.attention == "flash":
        return partial(flash_attention_trainable, causal=True)
    use_chunked = p.attention == "chunked" or (
        p.attention == "auto" and p.max_len >= p.chunked_threshold
    )
    return partial(chunked_attention if use_chunked else attention_reference,
                   causal=True)


def _loss(encoder, attn, inp, tgt, p: SequenceParams, mesh,
          pos_offset: int):
    """(the loss, the objective to differentiate) of one rank's block
    over ``mesh``: the next-item cross-entropy over the non-PAD targets,
    summed over (data, seq) and divided by the count summed alike, plus,
    with experts, ``moe_aux_weight`` times the MoE blocks' mean
    load-balance loss (the reference's ``_apply_with_aux``) averaged
    over both axes. The objective gives n = n_data * n_seq times the
    loss's gradient on every rank once the gradients are summed over
    both axes, the reference's factor (see the module docstring); on a
    mesh of one rank both are the one-device loss, to the bit."""
    axes = (DATA_AXIS, SEQ_AXIS)
    n = mesh.axis_size(axes)
    aux = [] if p.moe_experts > 0 else None
    _, logits = encoder(inp, attn, pos_offset=pos_offset, aux=aux)
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                         tgt.reshape(-1), reduction="none")
    mask = (tgt.reshape(-1) != PAD).to(ce.dtype)
    local = (ce * mask).sum()
    a = (p.moe_aux_weight * sum(aux) / len(aux) if aux
         else local.new_zeros(()))
    # one all-reduce for the numerator, the count and the aux
    total, count, a_sum = mesh.psum(
        torch.stack([local.detach(), mask.sum(), a.detach()]), axes)
    count = count.clamp_min(1.0)
    return total / count + a_sum / n, n * local / count + a


def train_sequence_model(data: SequenceData, p: SequenceParams, *,
                         device, init: dict | None = None,
                         checkpoint: StepCheckpointer | None = None,
                         lifecycle=None, mesh=None):
    """Train loop: Adam on the masked next-item loss, one batch per step
    drawn as the reference draws it (``default_rng((seed, step))``), so
    both packages see the same batch stream. ``init`` (a state dict,
    e.g. ``convert.sequence_params_from_numpy`` of the reference's
    initial params) replaces the seeded draw.

    ``mesh`` (a ``parallel.mesh.Mesh``; None is this process alone,
    ``local_mesh``) runs the reference's dp x sp step on this rank's
    block (see the module docstring); every rank calls it alike and ends
    with the same params.

    ``checkpoint`` (a StepCheckpointer, or None) saves every save_every
    steps and resumes from the latest saved step, so a resumed run takes
    the same steps on the same batches as an uninterrupted one.
    ``lifecycle`` (a workflow.lifecycle.TrainLifecycle, or None) gets a
    heartbeat after every step; a preemption request force-saves, then
    raises TrainingPreempted.

    Returns (params state dict on ``device``, encoder, the last step's
    loss before its update; when no step is left to run, the loss at the
    restored params on the last step's batch)."""
    dev = resolve_device(device)
    mesh = mesh if mesh is not None else local_mesh(dev)
    attn = training_attention(p, mesh)
    encoder = make_encoder(len(data.items), p)
    if init is None:
        init_encoder_(encoder, p.seed)
    else:
        encoder.load_state_dict({k: torch.as_tensor(v)
                                 for k, v in init.items()})
    encoder.to(dev)
    optimizer = torch.optim.Adam(encoder.parameters(), lr=p.learning_rate)

    seqs = data.seqs
    inp_all = np.ascontiguousarray(seqs[:, :-1], np.int64)
    tgt_all = np.ascontiguousarray(seqs[:, 1:], np.int64)
    n = inp_all.shape[0]
    n_data, n_seq = mesh.shape[DATA_AXIS], mesh.shape[SEQ_AXIS]
    d_idx, s_idx = mesh.axis_index(DATA_AXIS), mesh.axis_index(SEQ_AXIS)
    # the sequence must split evenly over the seq axis
    s_global = inp_all.shape[1]
    if s_global % n_seq:
        pad = n_seq - s_global % n_seq
        if s_global + pad > p.max_len + POS_HEADROOM:
            raise ValueError(
                f"seq-axis padding ({pad}) overflows the position table "
                f"({p.max_len} + {POS_HEADROOM} headroom); raise max_len "
                f"or use a smaller seq mesh axis (n_seq={n_seq})"
            )
        inp_all = np.pad(inp_all, ((0, 0), (0, pad)))
        tgt_all = np.pad(tgt_all, ((0, 0), (0, pad)))
    # the sampled batch must split evenly over the data mesh axis
    size = min(p.batch_size, max(8, n))
    size = max(n_data, size - size % n_data)
    rows = size // n_data
    s_local = inp_all.shape[1] // n_seq
    pos_offset = s_idx * s_local

    def batch(step: int):
        idx = np.random.default_rng((p.seed, step)).integers(0, n,
                                                             size=size)
        idx = idx[d_idx * rows:(d_idx + 1) * rows]
        cols = slice(pos_offset, pos_offset + s_local)
        return (torch.from_numpy(inp_all[idx, cols]).to(dev),
                torch.from_numpy(tgt_all[idx, cols]).to(dev))

    start = resume_or_init(checkpoint, encoder, optimizer)
    every = (max(1, checkpoint.config.save_every) if checkpoint is not None
             else None)
    params = list(encoder.parameters())
    step_chaos = step_chaos_active()
    loss = None
    for step in range(start, p.steps):
        step_loss, objective = _loss(encoder, attn, *batch(step), p, mesh,
                                     pos_offset)
        optimizer.zero_grad(set_to_none=True)
        objective.backward()
        sum_grads(params, mesh, (DATA_AXIS, SEQ_AXIS))
        optimizer.step()
        loss = step_loss.detach()
        after_span(step + 1, p.steps, encoder, optimizer,
                   checkpoint=checkpoint, lifecycle=lifecycle,
                   save_after=every is not None and step % every == 0,
                   step_chaos=step_chaos)
    if loss is None:
        # no step left (steps == 0, or the final step already
        # checkpointed): the loss at the current params on the batch of
        # the last step taken, as the reference reports it
        with torch.no_grad():
            loss, _ = _loss(encoder, attn, *batch(max(start - 1, 0)), p,
                            mesh, pos_offset)
    params = {k: v.detach() for k, v in encoder.state_dict().items()}
    return params, encoder, float(loss)


# ---------------------------------------------------------------------------
# DASE wrapper
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SequenceDataSourceParams(Params):
    app_name: str = ""
    event_names: tuple[str, ...] = ("view", "buy")
    max_len: int = 64
    # >0 -> read_eval produces k ROLLING next-item folds: fold f holds
    # out each user's (f+1)-th-from-last item and trains on the strict
    # prefix — the time-respecting split for sequence models, and what
    # lets `eval --sweep` tune this engine through the sequential fallback
    eval_k: int = 0
    eval_num: int = 10              # ranking depth of each fold query


class SequenceDataSource(DataSource):
    params_class = SequenceDataSourceParams

    def __init__(self, params: SequenceDataSourceParams):
        self.params = params

    def _events(self, ctx):
        return ctx.event_store.find(
            app_name=self.params.app_name,
            entity_type="user",
            target_entity_type="item",
            event_names=list(self.params.event_names),
        )

    def read_training(self, ctx) -> SequenceData:
        seqs, users, items = build_sequences(self._events(ctx),
                                             self.params.max_len)
        return SequenceData(seqs, users, items)

    def read_eval(self, ctx):
        """k rolling next-item folds of (train, info, [(query, actual)]):
        fold f trains each user on their history minus the last f+1
        items and is scored on predicting the held-out item — strictly
        past-only, like the tuning subsystem's time split. The items
        index spans every fold (the same ``user_histories`` grouping
        read_training uses), so vocab and embedding shapes stay the same
        across the sweep's candidates."""
        k = self.params.eval_k
        max_len = self.params.max_len
        hists, items = user_histories(self._events(ctx))
        folds = []
        for f in range(k):
            cut = f + 1
            users, rows, qa = [], [], []
            for uid, ids in hists.items():
                # >= 2 training items must remain (next-item training
                # needs a target inside the train split)
                if len(ids) < cut + 2:
                    continue
                train_ids = ids[:-cut]
                seq = [items.index_of(i) + 1
                       for i in train_ids][-max_len:]
                rows.append(np.pad(seq, (max_len - len(seq), 0)))
                users.append(uid)
                qa.append(({"user": uid, "num": self.params.eval_num},
                           [ids[-cut]]))
            if not rows:
                continue
            train = SequenceData(
                np.stack(rows).astype(np.int32),
                EntityIdIndex(users), items)
            folds.append((train, {"fold": f, "holdout": cut}, qa))
        return folds


@dataclass
class SequenceModel:
    """Encoder params (a state dict: tensors on the device, numpy after
    ``host_copy``), the training-time sequences for serve lookup, and the
    id indexes."""

    params: dict
    seqs: np.ndarray
    users: EntityIdIndex
    items: EntityIdIndex
    config: SequenceParams


class SequenceAlgorithm(PAlgorithm):
    params_class = SequenceParams

    def __init__(self, params: SequenceParams = SequenceParams()):
        self.params = params
        self._event_store = None

    def train(self, ctx, data: SequenceData) -> SequenceModel:
        data.sanity_check()
        # max_len lives in BOTH the datasource and the algorithm params;
        # adapt rather than explode on a mismatch: right-aligned truncate
        # (keep the most recent items) or left-pad
        s = data.seqs
        if s.shape[1] != self.params.max_len:
            if s.shape[1] > self.params.max_len:
                s = s[:, -self.params.max_len:]
            else:
                s = np.pad(s, ((0, 0), (self.params.max_len - s.shape[1], 0)))
            data = SequenceData(
                seqs=np.ascontiguousarray(s), users=data.users,
                items=data.items,
            )
        device = ctx.device if ctx is not None else resolve_device(None)
        # the context's mesh: every rank trains its block of each step
        # (a mesh of one rank is the one-device step)
        mesh = getattr(ctx, "mesh", None)
        lifecycle = getattr(ctx, "lifecycle", None)
        # explicit params win; otherwise run_train's per-instance dir
        ckpt_dir = self.params.checkpoint_dir or (
            lifecycle.checkpoint_dir if lifecycle is not None else "")
        ckpt = None
        if ckpt_dir:
            ckpt = StepCheckpointer(StepCheckpointConfig(
                ckpt_dir, save_every=self.params.checkpoint_every))
        try:
            params, _, loss = train_sequence_model(
                data, self.params, device=device, checkpoint=ckpt,
                lifecycle=lifecycle, mesh=mesh)
        finally:
            if ckpt is not None:
                ckpt.close()
        log.info("sequence model trained: %d steps, final loss %r",
                 self.params.steps, loss)
        if ctx is not None:
            self._event_store = getattr(ctx, "event_store", None)
        return SequenceModel(
            params=params, seqs=data.seqs, users=data.users,
            items=data.items, config=self.params,
        )

    def prepare_model_for_deploy(self, ctx, model: SequenceModel):
        """Put the restored params back on the serving device."""
        self._event_store = ctx.event_store
        return SequenceModel(
            params={k: torch.as_tensor(v).to(ctx.device)
                    for k, v in model.params.items()},
            seqs=model.seqs, users=model.users, items=model.items,
            config=model.config,
        )

    def _live_history(self, model: SequenceModel, user: str):
        """The user's recent item sequence from a live event-store read
        (the ecommerce template's serve-time pattern) — catches events that
        happened after training and users unseen at training time. Returns
        a PAD-left (max_len,) int32 row, or None when unavailable."""
        p = model.config
        if not p.app_name or self._event_store is None:
            return None
        try:
            events = self._event_store.find_by_entity(
                app_name=p.app_name,
                entity_type="user",
                entity_id=user,
                event_names=list(p.event_names),
                target_entity_type="item",
                limit=p.max_len,
                latest=True,
            )
        except Exception:  # noqa: BLE001 - storage outage must not kill serving
            return None
        seq = [
            model.items.index_of(e.target_entity_id) + 1
            for e in reversed(events)  # newest-first -> time order
            if e.target_entity_id in model.items
        ][-p.max_len:]
        if not seq:
            return None
        return np.pad(
            np.asarray(seq, np.int32), (p.max_len - len(seq), 0)
        )

    @staticmethod
    def _encoder(model: SequenceModel) -> SeqEncoder:
        """The model's encoder over its params (no copy), built once per
        model object and cached on it."""
        enc = getattr(model, "_encoder_cache", None)
        if enc is None:
            with torch.device("meta"):
                enc = make_encoder(len(model.items), model.config)
            enc.load_state_dict(model.params, assign=True)
            model._encoder_cache = enc.eval()
        return enc

    def _score_last_batch(self, model: SequenceModel, rows: np.ndarray):
        """Forward the last max_len-1 items of a (B, max_len) batch of
        history rows; return next-item scores (B, vocab) from the tied
        head at the final position. Training consumes inputs of length
        max_len-1, so serving must too. The batch dim is bucketed to a
        power of two, as in the reference. Attention: K8 on the card, the
        plain attention on the CPU."""
        p = model.config
        encoder = self._encoder(model)
        dev = encoder.item_emb.device
        attn = partial(attention_reference if dev.type == "cpu"
                       else flash_attention, causal=True)
        b = rows.shape[0]
        bucket = pow2_bucket(b)
        inp = rows[:, -(p.max_len - 1):]
        if bucket != b:
            inp = np.concatenate(
                [inp, np.zeros((bucket - b, inp.shape[1]), inp.dtype)])
        with torch.inference_mode():
            x = encoder.hidden(torch.as_tensor(inp, dtype=torch.long,
                                               device=dev), attn)
            # the head at the last position only: the same logits as
            # (x @ emb.T)[:, -1]
            return x[:b, -1] @ encoder.item_emb.T

    def history_row(self, model: SequenceModel, query: dict):
        """The (max_len,) PAD-left row predict actually scores from: the
        live event-store history when app_name is configured (including
        post-training events), else the training snapshot; None for an
        unknown user with no live history."""
        user = query.get("user", "")
        row = self._live_history(model, user)
        if row is None and user in model.users:
            row = model.seqs[model.users.index_of(user)]
        return row

    def predict(self, model: SequenceModel, query: dict) -> dict:
        return self.batch_predict(model, [query])[0]

    def batch_predict(self, model: SequenceModel, queries) -> list:
        """The history rows of every resolvable user in the batch encode in
        ONE transformer forward; per-query seen/blackList masking and
        ranking happen on host over the (B, vocab) score matrix."""
        results: list[dict] = [{"itemScores": []} for _ in queries]
        resolved = []
        for i, q in enumerate(queries):
            row = self.history_row(model, q)
            if row is not None:
                resolved.append((i, row))
        if not resolved:
            return results
        rows = np.stack([r for _, r in resolved])
        all_scores = self._score_last_batch(model, rows).float().cpu().numpy()
        for b, (qi, row) in enumerate(resolved):
            q = queries[qi]
            num = int(q.get("num", 10))
            scores = all_scores[b]   # view into all_scores: masked IN
            # PLACE — each row is consumed exactly once, here
            scores[PAD] = -np.inf
            seen = (
                set(int(i) for i in row if i != PAD)
                if model.config.unseen_only else set()
            )
            black = {
                model.items.index_of(x) + 1
                for x in (q.get("blackList") or ())
                if x in model.items
            }
            for i in seen | black:
                scores[i] = -np.inf
            order = np.argsort(-scores)[:num]
            results[qi] = {"itemScores": [
                {"item": model.items.decode([i - 1])[0],
                 "score": float(scores[i])}
                for i in order if np.isfinite(scores[i])
            ]}
        return results


class SequenceEngine(EngineFactory):
    @classmethod
    def apply(cls) -> Engine:
        return Engine(
            SequenceDataSource,
            IdentityPreparator,
            {"sasrec": SequenceAlgorithm},
            FirstServing,
        )
