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
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from pio_tpu_torch.data.bimap import EntityIdIndex
from pio_tpu_torch.ops.als import ALSModel
from pio_tpu_torch.models.recommendation import RecommendationModel
from pio_tpu_torch.models.sequence import SequenceModel, SequenceParams
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


# flax module names inside a Block -> the port's Block attributes
_BLOCK_DENSE = (("Dense_0", "qkv"), ("Dense_1", "out"), ("Dense_2", "ffn_in"),
                ("Dense_3", "ffn_out"))
_BLOCK_NORM = (("LayerNorm_0", "ln1"), ("LayerNorm_1", "ln2"))


def sequence_params_from_numpy(tree, *, device) -> dict[str, torch.Tensor]:
    """The reference's ``SeqEncoder`` params -> the port's ``SeqEncoder``
    state dict, f32 on ``device``. A ``Dense`` kernel (in, out) becomes a
    ``Linear`` weight (out, in); LayerNorm scale/bias become weight/bias;
    the two embedding tables are copied as they are."""
    def norm(node, name):
        return {f"{name}.weight": node["scale"], f"{name}.bias": node["bias"]}

    flat = {"item_emb": tree["item_emb"], "pos_emb": tree["pos_emb"],
            **norm(tree["LayerNorm_0"], "ln_f")}
    i = 0
    while f"Block_{i}" in tree:
        block = tree[f"Block_{i}"]
        if "moe_router" in block:
            raise NotImplementedError(
                "MoE blocks are ported in a later slice")
        for flax_name, name in _BLOCK_DENSE:
            flat[f"blocks.{i}.{name}.weight"] = np.asarray(
                block[flax_name]["kernel"]).T
            if "bias" in block[flax_name]:
                flat[f"blocks.{i}.{name}.bias"] = block[flax_name]["bias"]
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
