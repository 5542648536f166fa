"""Carry model parameters across from the JAX package.

A ``pio_tpu`` recommendation model, after ``host_copy``, is numpy factor
matrices plus two id indexes. ``recommendation_model_from_numpy`` builds
the port's model from exactly those fields, so both packages can serve
the same factors (the parity tests do), or a model made from a seed can
be stored with ``workflow.train.persist_models``. ``als_model_from_numpy``
builds the bare factor model, e.g. the ``init=`` that lets both packages'
``als_train`` start from the same factors.

A ``pio_tpu`` sequence model's params are a flax tree (after
``jax.device_get``, nested dicts of numpy arrays).
``sequence_params_from_numpy`` turns it into the port's encoder state
dict, leaf by leaf, so both packages can start training from, or serve,
the same params; ``sequence_model_from_numpy`` builds the port's
``SequenceModel`` around them.

The other templates' models (after ``host_copy``) are numpy arrays, id
lists, category maps and, for classification, plain mappings:
``similarproduct_model_from_numpy`` (the ALS similarity's item factors),
``dimsum_model_from_numpy`` (the top-k table passes through),
``ecommerce_model_from_numpy`` (through ``als_model_from_numpy``),
``multinomial_nb_from_numpy`` and ``categorical_nb_from_numpy`` (naive
Bayes), ``random_forest_from_numpy`` (the flattened trees) and
``classification_schema_from_numpy`` (the query encoder the classifier
models carry).

A ``pio_tpu`` two-tower model's params are a flax tree {"user": ...,
"item": ...} of one ``Embed`` and two ``Dense`` each.
``twotower_params_from_numpy`` turns it into the port's ``TwoTowers``
state dict (torch cannot draw flax's ``init_params``, so parity tests
start both packages from the same converted params);
``twotower_model_from_numpy`` builds the port's ``TwoTowerModel``. The
regression, stock and SimRank models are numpy in both packages.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from pio_tpu_torch.data.bimap import BiMap, EntityIdIndex
from pio_tpu_torch.e2.vectorizer import BinaryVectorizer
from pio_tpu_torch.ops.als import ALSModel
from pio_tpu_torch.ops.forest import RandomForestModel
from pio_tpu_torch.ops.naive_bayes import CategoricalNBModel, MultinomialNBModel
from pio_tpu_torch.models.classification import ClassificationData
from pio_tpu_torch.models.ecommerce import ECommerceModel
from pio_tpu_torch.models.recommendation import RecommendationModel
from pio_tpu_torch.models.similarproduct import DIMSUMModel, SimilarProductModel
from pio_tpu_torch.models.sequence import SequenceModel, SequenceParams
from pio_tpu_torch.models.twotower import TwoTowerModel, TwoTowerParams
from pio_tpu_torch.workflow.context import resolve_device


def als_model_from_numpy(user_factors, item_factors, *,
                         device) -> ALSModel:
    """(n_users, k) and (n_items, k) factors -> the port's ALSModel, f32
    on ``device``."""
    uf = np.ascontiguousarray(user_factors, np.float32)
    itf = np.ascontiguousarray(item_factors, np.float32)
    if uf.ndim != 2 or itf.ndim != 2 or uf.shape[1] != itf.shape[1]:
        raise ValueError(
            f"factor shapes {uf.shape} and {itf.shape} do not form a model")
    dev = resolve_device(device)
    return ALSModel(torch.tensor(uf, device=dev),
                    torch.tensor(itf, device=dev))


def recommendation_model_from_numpy(
    user_factors, item_factors, user_ids: Sequence[str],
    item_ids: Sequence[str], *, device,
) -> RecommendationModel:
    """(n_users, k) and (n_items, k) factors with their ids, in dense-index
    order -> the port's model, factors f32 on ``device``."""
    factors = als_model_from_numpy(user_factors, item_factors,
                                   device=device)
    if (len(user_ids) != factors.user_factors.shape[0]
            or len(item_ids) != factors.item_factors.shape[0]):
        raise ValueError(
            f"{len(user_ids)} user ids / {len(item_ids)} item ids for "
            f"factors {tuple(factors.user_factors.shape)} / "
            f"{tuple(factors.item_factors.shape)}")
    return RecommendationModel(factors, EntityIdIndex(user_ids),
                               EntityIdIndex(item_ids))


# flax module names inside a Block -> the port's Block attributes (a MoE
# block has no Dense_2/Dense_3: its FFN's params are its own, named as the
# port names them, and used in products, not in Linear, so not transposed)
_BLOCK_DENSE = (("Dense_0", "qkv"), ("Dense_1", "out"), ("Dense_2", "ffn_in"),
                ("Dense_3", "ffn_out"))
_BLOCK_NORM = (("LayerNorm_0", "ln1"), ("LayerNorm_1", "ln2"))
_BLOCK_MOE = ("moe_router", "moe_w_in", "moe_b_in", "moe_w_out", "moe_b_out")


def sequence_params_from_numpy(tree, *, device) -> dict[str, torch.Tensor]:
    """The reference's ``SeqEncoder`` params -> the port's ``SeqEncoder``
    state dict, f32 on ``device``. A ``Dense`` kernel (in, out) becomes a
    ``Linear`` weight (out, in); LayerNorm scale/bias become weight/bias;
    the two embedding tables and a MoE block's five params are copied as
    they are."""
    def norm(node, name):
        return {f"{name}.weight": node["scale"], f"{name}.bias": node["bias"]}

    flat = {"item_emb": tree["item_emb"], "pos_emb": tree["pos_emb"],
            **norm(tree["LayerNorm_0"], "ln_f")}
    i = 0
    while f"Block_{i}" in tree:
        block = tree[f"Block_{i}"]
        for flax_name, name in _BLOCK_DENSE:
            if flax_name not in block:      # Dense_2/3 of a MoE block
                continue
            flat[f"blocks.{i}.{name}.weight"] = np.asarray(
                block[flax_name]["kernel"]).T
            if "bias" in block[flax_name]:
                flat[f"blocks.{i}.{name}.bias"] = block[flax_name]["bias"]
        for name in _BLOCK_MOE:
            if name in block:
                flat[f"blocks.{i}.{name}"] = block[name]
        for flax_name, name in _BLOCK_NORM:
            flat.update(norm(block[flax_name], f"blocks.{i}.{name}"))
        i += 1
    dev = resolve_device(device)
    return {k: torch.tensor(np.ascontiguousarray(v, np.float32), device=dev)
            for k, v in flat.items()}


def sequence_model_from_numpy(
    tree, seqs, user_ids: Sequence[str], item_ids: Sequence[str],
    config: SequenceParams, *, device,
) -> SequenceModel:
    """The reference's params (see ``sequence_params_from_numpy``) with
    the training sequences (N, max_len), their owners' ids and the item
    ids (item i is row i + 1 of the embedding; row 0 is PAD) -> the port's
    model, params f32 on ``device``."""
    params = sequence_params_from_numpy(tree, device=device)
    seqs = np.ascontiguousarray(seqs, np.int32)
    if seqs.ndim != 2 or len(user_ids) != seqs.shape[0]:
        raise ValueError(f"{len(user_ids)} user ids for sequences "
                         f"{seqs.shape}")
    if params["item_emb"].shape[0] != len(item_ids) + 1:
        raise ValueError(f"{len(item_ids)} item ids for an embedding of "
                         f"{params['item_emb'].shape[0]} rows (PAD + items)")
    return SequenceModel(params, seqs, EntityIdIndex(user_ids),
                         EntityIdIndex(item_ids), config)


def _ids_for(ids: Sequence[str], rows: int, what: str) -> EntityIdIndex:
    if len(ids) != rows:
        raise ValueError(f"{len(ids)} {what} ids for {rows} rows")
    return EntityIdIndex(ids)


def similarproduct_model_from_numpy(
    item_factors, item_ids: Sequence[str], item_categories: dict, *,
    device,
) -> SimilarProductModel:
    """(n_items, k) item factors with their ids in dense-index order and
    the item -> categories map -> the ALS similarity's model, factors f32
    on ``device``."""
    itf = np.ascontiguousarray(item_factors, np.float32)
    if itf.ndim != 2:
        raise ValueError(f"item factors of shape {itf.shape}")
    items = _ids_for(item_ids, itf.shape[0], "item")
    return SimilarProductModel(
        torch.tensor(itf, device=resolve_device(device)), items,
        dict(item_categories))


def dimsum_model_from_numpy(sim_scores, sim_idx, item_ids: Sequence[str],
                            item_categories: dict) -> DIMSUMModel:
    """The (n_items, k_sim) score and neighbour tables, passed through as
    host arrays, with the ids and categories -> the DIMSUM model."""
    scores = np.ascontiguousarray(sim_scores, np.float32)
    idx = np.ascontiguousarray(sim_idx)
    if scores.shape != idx.shape or scores.ndim != 2:
        raise ValueError(f"tables of shapes {scores.shape}, {idx.shape}")
    items = _ids_for(item_ids, scores.shape[0], "item")
    return DIMSUMModel(scores, idx, items, dict(item_categories))


def ecommerce_model_from_numpy(
    user_factors, item_factors, user_ids: Sequence[str],
    item_ids: Sequence[str], item_categories: dict, *, device,
) -> ECommerceModel:
    """Factors with their ids in dense-index order and the categories ->
    the ecommerce model, factors f32 on ``device``."""
    factors = als_model_from_numpy(user_factors, item_factors,
                                   device=device)
    users = _ids_for(user_ids, factors.user_factors.shape[0], "user")
    items = _ids_for(item_ids, factors.item_factors.shape[0], "item")
    return ECommerceModel(factors, users, items, dict(item_categories))


def multinomial_nb_from_numpy(log_prior, log_theta, *,
                              device) -> MultinomialNBModel:
    """(L,) log-priors and (L, D) log-likelihoods -> the multinomial naive
    Bayes model, f32 on ``device``."""
    lp = np.ascontiguousarray(log_prior, np.float32)
    lt = np.ascontiguousarray(log_theta, np.float32)
    if lp.ndim != 1 or lt.ndim != 2 or lt.shape[0] != lp.shape[0]:
        raise ValueError(f"log_prior {lp.shape}, log_theta {lt.shape}")
    dev = resolve_device(device)
    return MultinomialNBModel(torch.tensor(lp, device=dev),
                              torch.tensor(lt, device=dev))


def categorical_nb_from_numpy(labels: dict, categories: Sequence[dict],
                              log_prior, log_likelihood,
                              log_floor) -> CategoricalNBModel:
    """label -> index, one value -> index map a feature position, and the
    model's log tables -> the categorical naive Bayes model (host numpy,
    as in both packages)."""
    lp = np.asarray(log_prior)
    ll = np.asarray(log_likelihood)
    lf = np.asarray(log_floor)
    if ll.shape[:2] != (len(labels), len(categories)) or (
            lf.shape != ll.shape[:2]) or lp.shape != (len(labels),):
        raise ValueError(
            f"{len(labels)} labels, {len(categories)} positions for tables "
            f"{lp.shape}, {ll.shape}, {lf.shape}")
    return CategoricalNBModel(BiMap(dict(labels)),
                              [BiMap(dict(c)) for c in categories],
                              lp, ll, lf)


def random_forest_from_numpy(feature, threshold, left, right, prediction,
                             n_classes: int,
                             max_depth: int) -> RandomForestModel:
    """The flattened (num_trees, max_nodes) tables -> the forest."""
    tables = (np.ascontiguousarray(feature, np.int32),
              np.ascontiguousarray(threshold, np.float32),
              np.ascontiguousarray(left, np.int32),
              np.ascontiguousarray(right, np.int32),
              np.ascontiguousarray(prediction, np.int32))
    if len({t.shape for t in tables}) != 1 or tables[0].ndim != 2:
        raise ValueError(f"tree tables of shapes {[t.shape for t in tables]}")
    return RandomForestModel(*tables, n_classes=int(n_classes),
                             max_depth=int(max_depth))


def classification_schema_from_numpy(
    vectorizer_index: dict, numeric_fields: Sequence[str], labels: dict,
) -> ClassificationData:
    """The (field, value) -> dimension map of the one-hot encoder, the
    numeric fields and label -> index -> the data schema a classifier
    model carries to encode queries (its rows stripped, as both packages
    store it)."""
    return ClassificationData(
        x=np.zeros((0, 0), np.float32), y=np.zeros(0, np.int64),
        vectorizer=BinaryVectorizer(BiMap(dict(vectorizer_index))),
        numeric_fields=tuple(numeric_fields), labels=BiMap(dict(labels)),
    )


def twotower_params_from_numpy(tree, *, device) -> dict[str, torch.Tensor]:
    """The reference's two-tower params -> the port's ``TwoTowers`` state
    dict, f32 on ``device``. Each tower's ``Embed`` table is copied as it
    is; a ``Dense`` kernel (in, out) becomes a ``Linear`` weight (out, in),
    its bias copied."""
    flat = {}
    for side in ("user", "item"):
        node = tree[side]
        flat[f"{side}.embedding"] = node["Embed_0"]["embedding"]
        for i in (0, 1):
            dense = node[f"Dense_{i}"]
            flat[f"{side}.dense_{i}.weight"] = np.asarray(dense["kernel"]).T
            flat[f"{side}.dense_{i}.bias"] = dense["bias"]
    dev = resolve_device(device)
    return {k: torch.tensor(np.ascontiguousarray(v, np.float32), device=dev)
            for k, v in flat.items()}


def twotower_model_from_numpy(
    tree, item_embeddings, user_ids: Sequence[str],
    item_ids: Sequence[str], config: TwoTowerParams, *, device,
) -> TwoTowerModel:
    """The reference's params (see ``twotower_params_from_numpy``), its
    (n_items, out_dim) item embeddings and the ids in dense-index order ->
    the port's model, f32 on ``device``."""
    params = twotower_params_from_numpy(tree, device=device)
    emb = np.ascontiguousarray(item_embeddings, np.float32)
    users = _ids_for(user_ids, params["user.embedding"].shape[0], "user")
    items = _ids_for(item_ids, params["item.embedding"].shape[0], "item")
    if emb.shape != (len(item_ids), config.out_dim):
        raise ValueError(f"item embeddings of shape {emb.shape} for "
                         f"{len(item_ids)} items of width {config.out_dim}")
    return TwoTowerModel(params, torch.tensor(emb, device=params[
        "user.embedding"].device), users, items, config)
