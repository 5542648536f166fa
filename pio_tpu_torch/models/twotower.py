"""Two-tower neural retrieval template on one device.

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
handled by over-fetch and a host filter. Not ported yet: the reference's
data x model (dp x tp) mesh path (the port's context holds one device).
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


def in_batch_loss(towers: TwoTowers, u_ids, i_ids, temperature: float):
    """The symmetric in-batch softmax (user->item and item->user) over
    the (B, B) logits / temperature."""
    u = towers.user(u_ids)                                    # (B, d)
    v = towers.item(i_ids)                                    # (B, d)
    logits = (u @ v.T) / temperature                          # (B, B)
    labels = torch.arange(u_ids.shape[0], device=logits.device)
    return (F.cross_entropy(logits, labels)
            + F.cross_entropy(logits.T, labels)) / 2


def train_two_tower(inter: Interactions, p: TwoTowerParams, *, device,
                    init: dict | None = None,
                    checkpoint: StepCheckpointer | None = None,
                    lifecycle=None):
    """Single-device train loop on ``device``. ``init`` (a state dict,
    e.g. ``convert.twotower_params_from_numpy`` of the reference's
    ``init_params``) replaces the seeded draw. ``checkpoint`` saves every
    save_every steps and resumes from the latest saved step, on the same
    batch stream; ``lifecycle`` gets a heartbeat after every step, and a
    preemption request force-saves, then raises TrainingPreempted.

    Returns (params state dict on ``device``, the (n_items, out_dim) item
    embeddings, the towers, the losses of the steps this call ran as a
    host array)."""
    dev = resolve_device(device)
    towers = make_towers(inter.n_users, inter.n_items, p)
    if init is None:
        init_towers_(towers, p.seed)
    else:
        towers.load_state_dict({k: torch.as_tensor(v)
                                for k, v in init.items()})
    towers.to(dev)
    optimizer = torch.optim.Adam(towers.parameters(), lr=p.learning_rate)
    start = resume_or_init(checkpoint, towers, optimizer)

    n = len(inter)
    batch = min(p.batch_size, max(8, n))
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
            uu = torch.from_numpy(inter.user_idx[idx].astype(np.int64)).to(dev)
            ii = torch.from_numpy(inter.item_idx[idx].astype(np.int64)).to(dev)
        loss = in_batch_loss(towers, uu[step - lo], ii[step - lo],
                             p.temperature)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        losses.append(loss.detach())
        after_span(step + 1, p.steps, towers, optimizer,
                   checkpoint=checkpoint, lifecycle=lifecycle,
                   save_after=every is not None and step % every == 0,
                   step_chaos=step_chaos)
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
                lifecycle=lifecycle)
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
