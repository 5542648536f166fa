"""Friend-recommendation engine template — SimRank over a social graph.

Counterpart of ``pio_tpu.models.friendrecommendation`` (reference
examples/experimental/scala-parallel-friend-recommendation: the edge-list
PDataSource with its node and forest-fire sampling variants,
DataSource.scala:29-41 and Sampling.scala; Delta-SimRank,
DeltaSimRankRDD.scala; the pairwise Query(item1, item2) -> score,
Engine.scala:6-9, SimRankAlgorithm.scala:35-41). The datasource and the
sampling are the reference's numpy. ``SimRankAlgorithm`` computes the
dense SimRank recurrence on the context's device (``ops/simrank.py``) and
keeps the model on the host: the full score matrix for pairwise
{"item1", "item2"} -> {"score"} queries and a top-k table for retrieval
{"user", "num"} -> {"friendScores": [...]} queries.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from pio_tpu_torch.controller.base import (
    DataSource,
    FirstServing,
    IdentityPreparator,
    P2LAlgorithm,
    Params,
)
from pio_tpu_torch.controller.engine import Engine, EngineFactory
from pio_tpu_torch.data.bimap import EntityIdIndex
from pio_tpu_torch.ops.simrank import simrank_scores, simrank_topk


@dataclass(frozen=True)
class DataSourceParams(Params):
    """graph_edgelist_path: whitespace-separated `src dst` lines (the
    reference GraphLoader.edgeListFile contract). Event mode instead reads
    user->user events (e.g. `follow`). Sampling mirrors the reference's
    NodeSamplingDataSource / ForestFireSamplingDataSource params."""

    path_fields = ("graph_edgelist_path",)

    graph_edgelist_path: str = ""
    app_name: str = ""
    event_names: tuple[str, ...] = ("follow",)
    sample_method: str = "none"       # none | node | forestfire
    sample_fraction: float = 1.0
    geo_param: float = 0.3            # forest-fire geometric(p) burst size
    seed: int = 9


@dataclass
class FriendGraph:
    src: np.ndarray                   # (E,) int node indices
    dst: np.ndarray
    nodes: EntityIdIndex

    def sanity_check(self):
        if len(self.src) == 0:
            raise ValueError("FriendGraph has no edges.")


def node_sample(src, dst, n_nodes: int, fraction: float, seed: int):
    """Uniform node sampling (reference Sampling.nodeSampling): keep a
    fraction of nodes, induce the subgraph."""
    rng = np.random.default_rng(seed)
    keep = rng.random(n_nodes) < fraction
    mask = keep[src] & keep[dst]
    return src[mask], dst[mask]


def forest_fire_sample(src, dst, n_nodes: int, fraction: float,
                       geo_param: float, seed: int):
    """Forest-fire sampling (reference Sampling.forestFireSamplingInduced):
    BFS burns from random seeds, burning a geometric(p) number of
    out-neighbors per node, until ~fraction of nodes are burned; the
    induced subgraph is returned."""
    rng = np.random.default_rng(seed)
    target = max(1, int(n_nodes * fraction))
    out_adj: dict[int, list[int]] = {}
    for s, d in zip(src, dst):
        out_adj.setdefault(int(s), []).append(int(d))
    burned: set[int] = set()
    frontier: list[int] = []
    while len(burned) < target:
        if not frontier:
            fresh = int(rng.integers(0, n_nodes))
            if fresh in burned:
                continue
            burned.add(fresh)
            frontier.append(fresh)
            continue
        node = frontier.pop(0)
        # geometric burst size (reference geometricSample)
        n_burn = 1
        while rng.random() <= geo_param:
            n_burn += 1
        nbrs = [x for x in out_adj.get(node, ()) if x not in burned]
        rng.shuffle(nbrs)
        for x in nbrs[:n_burn]:
            burned.add(x)
            frontier.append(x)
            if len(burned) >= target:
                break
    keep = np.zeros(n_nodes, bool)
    keep[list(burned)] = True
    mask = keep[src] & keep[dst]
    return src[mask], dst[mask]


class FriendGraphDataSource(DataSource):
    """All three reference datasource variants behind one params switch
    (the reference registers them as named datasources 'default'/'node'/
    'forest', Engine.scala:21-26)."""

    params_class = DataSourceParams

    def __init__(self, params: DataSourceParams):
        self.params = params

    def _edges(self, ctx) -> tuple[list[str], list[str]]:
        p = self.params
        if p.graph_edgelist_path:
            srcs, dsts = [], []
            with open(p.graph_edgelist_path) as f:
                for line in f:
                    parts = line.split()
                    if len(parts) >= 2 and not parts[0].startswith("#"):
                        srcs.append(parts[0])
                        dsts.append(parts[1])
            return srcs, dsts
        events = ctx.event_store.find(
            app_name=p.app_name, event_names=list(p.event_names)
        )
        pairs = [
            (e.entity_id, e.target_entity_id)
            for e in events if e.target_entity_id
        ]
        return [a for a, _ in pairs], [b for _, b in pairs]

    def read_training(self, ctx) -> FriendGraph:
        p = self.params
        srcs, dsts = self._edges(ctx)
        nodes = EntityIdIndex(list(srcs) + list(dsts))
        src = nodes.encode(srcs) if srcs else np.zeros(0, np.int64)
        dst = nodes.encode(dsts) if dsts else np.zeros(0, np.int64)
        n = len(nodes)
        sampled = False
        if p.sample_method == "node" and p.sample_fraction < 1.0:
            src, dst = node_sample(src, dst, n, p.sample_fraction, p.seed)
            sampled = True
        elif p.sample_method == "forestfire" and p.sample_fraction < 1.0:
            src, dst = forest_fire_sample(
                src, dst, n, p.sample_fraction, p.geo_param, p.seed
            )
            sampled = True
        if sampled:
            # re-index over the SURVIVING nodes: sampling exists so the
            # n^2 SimRank state fits the chip, which only works if the
            # dead nodes leave the index too
            ids = nodes.decode(np.concatenate([src, dst])) \
                if len(src) else []
            nodes = EntityIdIndex(ids)
            if len(src):
                src = nodes.encode(ids[: len(src)])
                dst = nodes.encode(ids[len(src):])
        return FriendGraph(src=src, dst=dst, nodes=nodes)


@dataclass(frozen=True)
class SimRankParams(Params):
    """Reference SimRankParams (SimRankAlgorithm.scala:10-12)."""

    num_iterations: int = 5
    decay: float = 0.8
    k_top: int = 50               # neighbor table width for retrieval


@dataclass
class SimRankModel:
    top_scores: np.ndarray        # (n, k_top)
    top_idx: np.ndarray           # (n, k_top)
    pair_scores: np.ndarray       # (n, n) full matrix (pairwise queries)
    nodes: EntityIdIndex


class SimRankAlgorithm(P2LAlgorithm):
    params_class = SimRankParams

    def __init__(self, params: SimRankParams = SimRankParams()):
        self.params = params

    def train(self, ctx, data: FriendGraph) -> SimRankModel:
        """SimRank on ``ctx.device``; the top-k table on the host."""
        data.sanity_check()
        p = self.params
        S = simrank_scores(
            data.src, data.dst, len(data.nodes),
            decay=p.decay, iterations=p.num_iterations,
            device=ctx.device if ctx is not None else None,
        )
        scores, idx = simrank_topk(S, p.k_top)
        return SimRankModel(scores, idx, S, data.nodes)

    def predict(self, model: SimRankModel, query: dict) -> dict:
        # pairwise shape (reference Query(item1, item2) -> Double)
        if "item1" in query and "item2" in query:
            a, b = str(query["item1"]), str(query["item2"])
            if a not in model.nodes or b not in model.nodes:
                return {"score": 0.0}
            ia = int(model.nodes.encode([a])[0])
            ib = int(model.nodes.encode([b])[0])
            return {"score": float(model.pair_scores[ia, ib])}
        # retrieval shape: top-num friends for a user
        user = str(query.get("user", ""))
        num = int(query.get("num", 10))
        if user not in model.nodes:
            return {"friendScores": []}
        iu = int(model.nodes.encode([user])[0])
        out = []
        for j, s in zip(model.top_idx[iu][:num], model.top_scores[iu][:num]):
            if s > 0:
                out.append({"friend": model.nodes.id_of(int(j)),
                            "score": float(s)})
        return {"friendScores": out}


class FriendRecommendationEngine(EngineFactory):
    """Reference PSimRankEngineFactory (Engine.scala:20-30)."""

    @classmethod
    def apply(cls) -> Engine:
        return Engine(
            FriendGraphDataSource,
            IdentityPreparator,
            {"simrank": SimRankAlgorithm},
            FirstServing,
        )
