"""Carry model parameters across from the JAX package.

A ``pio_tpu`` recommendation model, after ``host_copy``, is numpy factor
matrices plus two id indexes. ``recommendation_model_from_numpy`` builds
the port's model from exactly those fields, so both packages can serve
the same factors (the parity tests do), or a model made from a seed can
be stored with ``workflow.train.persist_models``. ``als_model_from_numpy``
builds the bare factor model, e.g. the ``init=`` that lets both packages'
``als_train`` start from the same factors.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from pio_tpu_torch.data.bimap import EntityIdIndex
from pio_tpu_torch.ops.als import ALSModel
from pio_tpu_torch.models.recommendation import RecommendationModel
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
