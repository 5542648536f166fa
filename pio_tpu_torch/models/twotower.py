"""Two-tower neural retrieval template.

Counterpart of ``pio_tpu.models.twotower`` (the reference's flagship
model): the same params, data source (with ``read_eval``'s k folds),
query {"user", "num", "blackList"?} and result {"itemScores": [...]}.
User and item towers (embedding, Linear, ReLU, Linear, then
z / (||z|| + 1e-8)) train with the symmetric in-batch softmax over
(user, item) interaction pairs and ``torch.optim.Adam`` (optax.adam's
defaults and update). Every embedding gradient is dense, so each row's
moments decay every step as optax's do. A step's batch is drawn as the
reference draws it, from ``default_rng((seed, step))``; the steps run
one at a time with ``workflow/spans.after_span``'s bookkeeping, so step
checkpoints, resume and preemption work as in the sequence template
(``workflow/step_checkpoint.py``, ``workflow/lifecycle.py``). At train
end every item's embedding is materialised for serving.

Serving is one user-tower forward at the batch's dispatch rows
(``ops.bucketing.dispatch_rows``) and ``ops/similarity.cosine_topk``, so
a query answers the same bits alone or in a batch; the blackList is
handled by over-fetch and a host filter.

Over a mesh (``parallel.mesh``; the template passes its context's mesh
when it holds more than one rank) training is the reference's dp x tp
layout, written out where the reference lets GSPMD place it
(``ShardedTowers``): each step's batch, rounded down to a multiple of the
data axis, is split over it, and the in-batch softmax runs over the
whole batch (each rank gathers the other ranks' embeddings); over the
model axis the embedding tables are split by rows (a masked lookup and
an all-reduce), ``Dense_0`` by its output columns and ``Dense_1`` by its
input rows, its bias added once after the all-reduce. Adam's moments live with their
shards. The gradients are summed over the data axis, so the update is
the one-device update on the whole batch. Checkpoints hold the gathered
state, as a one-device run's; the item embeddings for serving come from
the gathered params. One device is a mesh of one rank (``local_mesh``):
the lookup is ``Tower``'s, every collective the identity, and the loss
the mean over the batch.
"""

from __future__ import annotations

import logging
import math
from dataclasses import dataclass
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
from pio_tpu_torch.data.eventstore import Interactions
from pio_tpu_torch.ops.bucketing import dispatch_rows
from pio_tpu_torch.ops.similarity import cosine_topk
from pio_tpu_torch.parallel.collectives import (
    copy_to_axis,
    gather_from_axis,
    reduce_from_axis,
    sum_grads,
)
from pio_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, local_mesh
from pio_tpu_torch.workflow.context import resolve_device
from pio_tpu_torch.workflow.spans import after_span, step_chaos_active
from pio_tpu_torch.workflow.step_checkpoint import (
    StepCheckpointConfig,
    StepCheckpointer,
    resume_or_init,
)

log = logging.getLogger("pio_tpu_torch.models.twotower")

#: steps whose batch indices cross to the device in one copy
BATCH_CHUNK = 256


class Tower(nn.Module):
    """Embedding + 2-layer MLP -> L2-normalized embedding."""

    def __init__(self, vocab: int, embed_dim: int, hidden_dim: int,
                 out_dim: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(vocab, embed_dim))
        self.dense_0 = nn.Linear(embed_dim, hidden_dim)
        self.dense_1 = nn.Linear(hidden_dim, out_dim)

    def forward(self, ids):  # (B,) int64
        # F.embedding: a dense gradient, summed in a fixed order (see
        # models/sequence.py), so a resumed run reproduces its bits
        h = F.relu(self.dense_0(F.embedding(ids, self.embedding)))
        z = self.dense_1(h)
        # not F.normalize, which clamps the norm instead of adding 1e-8
        return z / (torch.linalg.vector_norm(z, dim=-1, keepdim=True) + 1e-8)


class TwoTowers(nn.Module):
    def __init__(self, user: Tower, item: Tower):
        super().__init__()
        self.user = user
        self.item = item


@dataclass(frozen=True)
class TwoTowerParams(Params):
    embed_dim: int = 64
    hidden_dim: int = 128
    out_dim: int = 32
    temperature: float = 0.05
    learning_rate: float = 1e-3
    batch_size: int = 1024
    steps: int = 200
    seed: int = 0
    # mid-train step checkpoints (workflow/step_checkpoint.py); "" = off
    checkpoint_dir: str = ""
    checkpoint_every: int = 100


def make_towers(n_users: int, n_items: int, p: TwoTowerParams) -> TwoTowers:
    """Both towers under ``p``, their params not yet drawn."""
    return TwoTowers(Tower(n_users, p.embed_dim, p.hidden_dim, p.out_dim),
                     Tower(n_items, p.embed_dim, p.hidden_dim, p.out_dim))


def init_towers_(towers: TwoTowers, seed: int) -> TwoTowers:
    """Draw the towers' params in place from ``seed`` with flax's
    initializers (torch cannot draw flax's numbers, only its
    distributions): normal(0.02) for the embedding tables, truncated
    lecun-normal for the Linear weights, zero biases."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in towers.named_parameters():
            if name.endswith("embedding"):
                p.normal_(0.0, 0.02, generator=g)
            elif p.ndim == 2:
                # variance 1/fan_in after truncation at two std devs
                std = math.sqrt(1.0 / p.shape[1]) / .87962566103423978
                nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std,
                                      generator=g)
            else:
                p.zero_()
    return towers


class ShardedTower(nn.Module):
    """This rank's shard of a ``Tower`` over the model axis of ``mesh``:
    block m (m the rank's model index) of the embedding's rows, of
    ``dense_0``'s output columns and of ``dense_1``'s input rows;
    ``dense_1``'s bias whole, on ``full``'s device. Its params carry a
    ``Tower``'s names; on a model axis of one it is a ``Tower``. The axis
    must divide the vocabulary and the hidden width, as the reference's
    shardings must."""

    def __init__(self, full: Tower, mesh):
        super().__init__()
        self.mesh = mesh
        self.n_model = mesh.shape[MODEL_AXIS]
        vocab, hidden = full.embedding.shape[0], full.dense_0.weight.shape[0]
        for what, size in (("vocabulary", vocab), ("hidden_dim", hidden)):
            if size % self.n_model:
                raise ValueError(
                    f"the {what} ({size}) must divide over the model axis "
                    f"({self.n_model})")
        self.rows = vocab // self.n_model
        dev = full.embedding.device
        self.embedding = nn.Parameter(torch.empty(
            self.rows, full.embedding.shape[1], device=dev))
        self.dense_0 = nn.Linear(full.dense_0.weight.shape[1],
                                 hidden // self.n_model, device=dev)
        self.dense_1 = nn.Linear(hidden // self.n_model,
                                 full.dense_1.weight.shape[0], device=dev)
        self.load_state_dict({k: self.shard(k, v)
                              for k, v in full.state_dict().items()})

    #: the dim each param is split along over the model axis
    SPLIT = {"embedding": 0, "dense_0.weight": 0, "dense_0.bias": 0,
             "dense_1.weight": 1, "dense_1.bias": None}

    def shard(self, name: str, t) -> torch.Tensor:
        """The whole of param ``name`` (or of a moment of it) -> this
        rank's shard."""
        dim, t = self.SPLIT[name], torch.as_tensor(t)
        if dim is not None:
            t = t.chunk(self.n_model, dim=dim)[self.mesh.axis_index(
                MODEL_AXIS)]
        return t.contiguous()

    def gather(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's shard ``t`` of param ``name`` (or of a moment of
        it) -> the whole, gathered over the model axis (a collective)."""
        dim = self.SPLIT[name]
        if dim is None or self.n_model == 1:
            return t
        return self.mesh.all_gather(t.transpose(0, dim).contiguous(),
                                    MODEL_AXIS).transpose(0, dim).contiguous()

    def forward(self, ids):  # (B,) int64
        if self.n_model == 1:
            return Tower.forward(self, ids)
        # the vocab-parallel lookup (the rows of other shards count zeros
        # here) and its sum, then the column-parallel input
        local = ids - self.mesh.axis_index(MODEL_AXIS) * self.rows
        inside = (local >= 0) & (local < self.rows)
        e = F.embedding(local.clamp(0, self.rows - 1), self.embedding)
        e = e * inside[:, None].to(e.dtype)
        e = copy_to_axis(reduce_from_axis(e, self.mesh, MODEL_AXIS),
                         self.mesh, MODEL_AXIS)
        h = F.relu(self.dense_0(e))
        z = reduce_from_axis(F.linear(h, self.dense_1.weight), self.mesh,
                             MODEL_AXIS) + self.dense_1.bias
        return z / (torch.linalg.vector_norm(z, dim=-1, keepdim=True) + 1e-8)


class ShardedTowers(nn.Module):
    """Both towers' shards over ``mesh`` (``ShardedTower``), their params
    named and ordered as ``TwoTowers``'s, so a checkpoint of the gathered
    state is a one-device run's."""

    def __init__(self, full: TwoTowers, mesh):
        super().__init__()
        self.user = ShardedTower(full.user, mesh)
        self.item = ShardedTower(full.item, mesh)

    def _each(self, how: str, name: str, t):
        """``ShardedTower.shard`` or ``gather`` of ``name`` ("user.x")."""
        side, _, leaf = name.partition(".")
        return getattr(getattr(self, side), how)(leaf, t)

    def _moments(self, how: str, opt_state: dict) -> dict:
        """An Adam state dict with each moment sharded or gathered as
        its param (the step counts as they are)."""
        names = [n for n, _ in self.named_parameters()]
        return {"param_groups": opt_state["param_groups"], "state": {
            i: {k: self._each(how, names[int(i)], v)
                if torch.is_tensor(v) and v.dim() > 0 else v
                for k, v in st.items()}
            for i, st in opt_state["state"].items()}}

    def gathered(self) -> dict:
        """The whole state dict, gathered (a collective every rank
        calls)."""
        return {k: self._each("gather", k, t.detach())
                for k, t in self.state_dict().items()}

    def gathered_state(self, optimizer) -> tuple[dict, dict]:
        """(model, optimizer) state dicts of the whole, for a step
        checkpoint: Adam's moments gathered as their params."""
        return self.gathered(), self._moments("gather",
                                              optimizer.state_dict())

    def load_gathered_state(self, model_state: dict, opt_state: dict,
                            optimizer) -> None:
        """Take this rank's shards of a whole state (``gathered_state``'s,
        or a one-device run's)."""
        self.load_state_dict({k: self._each("shard", k, v)
                              for k, v in model_state.items()})
        optimizer.load_state_dict(self._moments("shard", opt_state))


def in_batch_loss(towers: ShardedTowers, u_ids, i_ids,
                  temperature: float, mesh, batch: int):
    """(the loss, this rank's part of it to differentiate): the symmetric
    in-batch softmax (user->item and item->user) over the whole batch's
    (B, B) logits / temperature, each rank's embeddings gathered over the
    data axis, of which this rank takes its rows of the logits and of
    their transpose. On a data axis of one both are the one-device
    loss."""
    n = mesh.shape[DATA_AXIS]
    u = gather_from_axis(towers.user(u_ids), mesh, DATA_AXIS)  # (B, d)
    v = gather_from_axis(towers.item(i_ids), mesh, DATA_AXIS)
    logits = (u @ v.T) / temperature                           # (B, B)
    lo = mesh.axis_index(DATA_AXIS) * (batch // n)
    mine = slice(lo, lo + batch // n)
    labels = torch.arange(lo, lo + batch // n, device=logits.device)
    part = (F.cross_entropy(logits[mine], labels)
            + F.cross_entropy(logits[:, mine].T, labels)) / (2 * n)
    return mesh.psum(part.detach(), DATA_AXIS), part


def train_two_tower(inter: Interactions, p: TwoTowerParams, *, device,
                    init: dict | None = None,
                    checkpoint: StepCheckpointer | None = None,
                    lifecycle=None, mesh=None):
    """Train loop on ``device``. ``init`` (a state dict, e.g.
    ``convert.twotower_params_from_numpy`` of the reference's
    ``init_params``) replaces the seeded draw. ``checkpoint`` saves every
    save_every steps and resumes from the latest saved step, on the same
    batch stream; ``lifecycle`` gets a heartbeat after every step, and a
    preemption request force-saves, then raises TrainingPreempted.
    ``mesh`` (a ``parallel.mesh.Mesh``; None is this process alone,
    ``local_mesh``) trains this rank's shard of the reference's dp x tp
    layout (see the module docstring); every rank calls it alike.

    Returns (the gathered params state dict on ``device``, the
    (n_items, out_dim) item embeddings, the towers, the losses of the
    steps this call ran as a host array)."""
    dev = resolve_device(device)
    towers = make_towers(inter.n_users, inter.n_items, p)
    if init is None:
        init_towers_(towers, p.seed)
    else:
        towers.load_state_dict({k: torch.as_tensor(v)
                                for k, v in init.items()})
    mesh = mesh if mesh is not None else local_mesh(dev)
    n = len(inter)
    batch = min(p.batch_size, max(8, n))
    n_data = mesh.shape[DATA_AXIS]
    batch = max(n_data, batch - batch % n_data)  # divisible by dp
    rows, d_idx = batch // n_data, mesh.axis_index(DATA_AXIS)
    model = ShardedTowers(towers.to(dev), mesh)
    params = list(model.parameters())
    optimizer = torch.optim.Adam(params, lr=p.learning_rate)
    start = resume_or_init(checkpoint, model, optimizer)

    every = (max(1, checkpoint.config.save_every) if checkpoint is not None
             else None)
    step_chaos = step_chaos_active()
    losses = []
    lo = uu = ii = None
    for step in range(start, p.steps):
        if lo is None or step - lo >= BATCH_CHUNK:
            # (seed, step)-keyed sampling: the same stream fresh or resumed
            lo = step
            idx = np.stack([
                np.random.default_rng((p.seed, s)).integers(0, n, size=batch)
                for s in range(lo, min(lo + BATCH_CHUNK, p.steps))])
            idx = idx[:, d_idx * rows:(d_idx + 1) * rows]
            uu = torch.from_numpy(inter.user_idx[idx].astype(np.int64)).to(dev)
            ii = torch.from_numpy(inter.item_idx[idx].astype(np.int64)).to(dev)
        loss, part = in_batch_loss(model, uu[step - lo], ii[step - lo],
                                   p.temperature, mesh, batch)
        optimizer.zero_grad(set_to_none=True)
        part.backward()
        sum_grads(params, mesh, DATA_AXIS)
        optimizer.step()
        losses.append(loss.detach())
        after_span(step + 1, p.steps, model, optimizer,
                   checkpoint=checkpoint, lifecycle=lifecycle,
                   save_after=every is not None and step % every == 0,
                   step_chaos=step_chaos)
    # the whole params on every rank; the item embeddings from them
    towers.load_state_dict(model.gathered())
    with torch.no_grad():
        item_emb = towers.item(torch.arange(inter.n_items, device=dev))
    params = {k: v.detach() for k, v in towers.state_dict().items()}
    losses = (torch.stack(losses).cpu().numpy() if losses
              else np.zeros(0, np.float32))
    return params, item_emb, towers, losses


# ---------------------------------------------------------------------------
# DASE wrapper
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TwoTowerDataSourceParams(Params):
    app_name: str = ""
    event_names: tuple[str, ...] = ("view", "buy", "rate")
    # >0 -> read_eval produces k index-mod-k folds: the tuning sweep's
    # sequential path (eval --sweep on this engine) scores the
    # two-tower grid through the same fold contract the ALS templates use
    eval_k: int = 0
    eval_num: int = 10              # ranking depth of each fold query
    eval_exclude_seen: bool = True


class TwoTowerDataSource(DataSource):
    params_class = TwoTowerDataSourceParams

    def __init__(self, params: TwoTowerDataSourceParams):
        self.params = params

    def read_training(self, ctx) -> Interactions:
        return ctx.event_store.interactions(
            app_name=self.params.app_name,
            entity_type="user",
            target_entity_type="item",
            event_names=list(self.params.event_names),
            value_key=None,
            default_value=1.0,
            dedup="sum",
        )

    def read_eval(self, ctx):
        """k folds of (train, info, [(query, heldout items)]) — the
        recommendation-template eval contract over the two-tower read."""
        from pio_tpu_torch.e2.crossvalidation import split_interactions

        data = self.read_training(ctx)
        return split_interactions(
            data, self.params.eval_k, num=self.params.eval_num,
            exclude_seen=self.params.eval_exclude_seen,
        )


@dataclass
class TwoTowerModel:
    """The towers' state dict and the item embeddings (tensors on the
    device, numpy after ``host_copy``), the id indexes and the params."""

    params: dict
    item_embeddings: Any
    users: Any
    items: Any
    config: TwoTowerParams


class TwoTowerAlgorithm(PAlgorithm):
    params_class = TwoTowerParams

    def __init__(self, params: TwoTowerParams = TwoTowerParams()):
        self.params = params

    def train(self, ctx, inter: Interactions) -> TwoTowerModel:
        inter.sanity_check()
        device = ctx.device if ctx is not None else resolve_device(None)
        # the context's mesh: every rank trains its shard of each step
        # (a mesh of one rank is the one-device step)
        mesh = getattr(ctx, "mesh", None)
        lifecycle = getattr(ctx, "lifecycle", None)
        # explicit params win; otherwise run_train's per-instance dir
        # (lifecycle.checkpoint_dir) makes every supervised run resumable
        ckpt_dir = self.params.checkpoint_dir or (
            lifecycle.checkpoint_dir if lifecycle is not None else "")
        ckpt = None
        if ckpt_dir:
            ckpt = StepCheckpointer(StepCheckpointConfig(
                ckpt_dir, save_every=self.params.checkpoint_every))
        try:
            params, item_emb, _, losses = train_two_tower(
                inter, self.params, device=device, checkpoint=ckpt,
                lifecycle=lifecycle, mesh=mesh)
        finally:
            if ckpt is not None:
                ckpt.close()
        log.info("two-tower trained: %d steps, last loss %r",
                 self.params.steps,
                 float(losses[-1]) if len(losses) else None)
        return TwoTowerModel(
            params=params, item_embeddings=item_emb,
            users=inter.users, items=inter.items, config=self.params,
        )

    def prepare_model_for_deploy(self, ctx, model: TwoTowerModel):
        """Put the restored towers and item matrix on the serving
        device."""
        return TwoTowerModel(
            params={k: torch.as_tensor(v).to(ctx.device)
                    for k, v in model.params.items()},
            item_embeddings=torch.as_tensor(
                model.item_embeddings, dtype=torch.float32).to(ctx.device),
            users=model.users, items=model.items, config=model.config,
        )

    @staticmethod
    def _user_tower(model: TwoTowerModel) -> Tower:
        """The model's user tower over its params (no copy), built once
        per model object and cached on it."""
        tower = getattr(model, "_user_tower_cache", None)
        if tower is None:
            c = model.config
            with torch.device("meta"):
                tower = Tower(len(model.users), c.embed_dim, c.hidden_dim,
                              c.out_dim)
            tower.load_state_dict(
                {k[len("user."):]: torch.as_tensor(v)
                 for k, v in model.params.items() if k.startswith("user.")},
                assign=True)
            model._user_tower_cache = tower.eval()
        return tower

    def predict(self, model: TwoTowerModel, query: dict) -> dict:
        return self.batch_predict(model, [query])[0]

    def batch_predict(self, model: TwoTowerModel, queries) -> list:
        """ONE user-tower forward + ONE cosine top-k for every known user
        in the batch (blackList handled by over-fetch + host filter, like
        the recommendation template's batched path). The forward runs at
        the batch's dispatch rows, so each query's embedding, and with it
        its answer, has the bits it has alone."""
        results: list[dict] = [{"itemScores": []} for _ in queries]
        known = [
            (i, model.users.index_of(q["user"]))
            for i, q in enumerate(queries)
            if q.get("user", "") in model.users
        ]
        if not known:
            return results
        tower = self._user_tower(model)
        b = len(known)
        uidx = np.zeros(dispatch_rows(b), np.int64)
        uidx[:b] = [u for _, u in known]
        with torch.inference_mode():
            uv = tower(torch.as_tensor(uidx, device=tower.embedding.device))
        n_items = model.item_embeddings.shape[0]
        k = min(
            max(int(queries[qi].get("num", 10))
                + len(queries[qi].get("blackList") or ())
                for qi, _ in known),
            n_items,
        )
        scores, idx = cosine_topk(model.item_embeddings, uv[:b], k)
        scores, idx = scores.cpu().numpy(), idx.cpu().numpy()
        for row, (qi, _) in enumerate(known):
            q = queries[qi]
            num = int(q.get("num", 10))
            black = set(q.get("blackList") or ())
            out = []
            for item, s in zip(model.items.decode(idx[row]), scores[row]):
                if item in black:
                    continue
                out.append({"item": item, "score": float(s)})
                if len(out) >= num:
                    break
            results[qi] = {"itemScores": out}
        return results


class TwoTowerEngine(EngineFactory):
    @classmethod
    def apply(cls) -> Engine:
        return Engine(
            TwoTowerDataSource,
            IdentityPreparator,
            {"twotower": TwoTowerAlgorithm},
            FirstServing,
        )
