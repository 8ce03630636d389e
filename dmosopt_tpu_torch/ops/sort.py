"""Multi-objective population ordering: rank + diversity lexsort, truncation.

Port of ``dmosopt_tpu/ops/sort.py`` (``order_mo`` / ``sort_mo`` /
``remove_worst`` / ``top_k_mo``), after reference dmosopt/MOEA.py:242-423.
Torch has no lexsort; `lexsort` below emulates ``jnp.lexsort`` with
stable argsort passes from the least significant key to the most
significant one. Every function accepts a leading batch axis ((S, n, d)
objectives, (S, n) masks) and orders each set on its own, as the JAX
package's ``vmap`` over SMPSO's swarms does.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from dmosopt_tpu_torch.ops.distances import (
    crowding_distance,
    euclidean_distance_metric,
)
from dmosopt_tpu_torch.ops.dominance import non_dominated_rank

_METRICS = {
    "crowding": crowding_distance,
    "euclidean": euclidean_distance_metric,
}


def lexsort(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """``np.lexsort`` semantics along the last axis: the LAST key is the
    primary one; ties keep index order. Each pass is a stable sort of
    the current order by one key, least significant first."""
    perm = torch.argsort(keys[0], dim=-1, stable=True)
    for k in keys[1:]:
        key = torch.take_along_dim(k, perm, dim=-1)
        perm = torch.take_along_dim(perm, torch.argsort(key, dim=-1, stable=True), dim=-1)
    return perm


def _take(a: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Rows of ``a`` (..., n[, k]) in the order ``perm`` (..., n)."""
    if a.dim() == perm.dim():
        return torch.take_along_dim(a, perm, dim=-1)
    return torch.take_along_dim(a, perm[..., None], dim=-2)


def resolve_metric(metric) -> Callable:
    if callable(metric):
        return metric
    try:
        return _METRICS[metric]
    except KeyError:
        raise RuntimeError(f"unknown distance metric {metric!r}") from None


def _accepts_mask(fn: Callable) -> bool:
    # built-in metrics take (Y, mask); user metrics take a single array
    return fn in (crowding_distance, euclidean_distance_metric)


def order_mo(
    x: torch.Tensor,
    y: torch.Tensor,
    x_distance_metrics: Optional[Sequence] = None,
    y_distance_metrics: Optional[Sequence] = ("crowding",),
    mask=None,
    need: Optional[int] = None,
):
    """Permutation ordering the population best-first: primary key =
    non-dominated rank, then each y-distance (descending), then each
    x-distance (descending) — reference ``orderMO`` (dmosopt/MOEA.py:300-347).
    ``need``: only the best ``need`` positions must be right (the JAX
    package's contract, ``dmosopt_tpu/ops/sort.py:31-83``); the exact
    ranks used here order every position, a legal refinement.
    Returns (perm, rank_sorted, y_dists_sorted)."""
    rank = non_dominated_rank(y, mask=mask, stop_count=need)
    y_fns = [resolve_metric(m) for m in (y_distance_metrics or [])]
    x_fns = [resolve_metric(m) for m in (x_distance_metrics or [])]
    y_dists = [fn(y, mask) if _accepts_mask(fn) else fn(y) for fn in y_fns]
    x_dists = [fn(x, mask) if _accepts_mask(fn) else fn(x) for fn in x_fns]
    # np.lexsort key order ([-xd...], [-yd...], rank): rank primary, then
    # y-dists descending, then x-dists descending
    keys = [-d for d in x_dists] + [-d for d in y_dists] + [rank]
    perm = lexsort(keys)
    y_dists_sorted = tuple(_take(d, perm) for d in y_dists)
    return perm, _take(rank, perm), y_dists_sorted


def sort_mo(
    x: torch.Tensor,
    y: torch.Tensor,
    x_distance_metrics=None,
    y_distance_metrics=("crowding",),
    mask=None,
    need: Optional[int] = None,
):
    """Sorted copies of (x, y) best-first plus ranks — reference ``sortMO``
    (dmosopt/MOEA.py:242-297). ``need`` as in `order_mo`."""
    perm, rank_sorted, y_dists_sorted = order_mo(
        x, y, x_distance_metrics, y_distance_metrics, mask=mask, need=need
    )
    return _take(x, perm), _take(y, perm), rank_sorted, y_dists_sorted, perm


def remove_worst(
    population_parm: torch.Tensor,
    population_obj: torch.Tensor,
    pop: int,
    x_distance_metrics=None,
    y_distance_metrics=("crowding",),
    mask=None,
):
    """Keep the best ``pop`` individuals (reference dmosopt/MOEA.py:398-423)."""
    xs, ys, rank, _, perm = sort_mo(
        population_parm, population_obj,
        x_distance_metrics=x_distance_metrics,
        y_distance_metrics=y_distance_metrics,
        mask=mask, need=pop,
    )
    return xs[..., :pop, :], ys[..., :pop, :], rank[..., :pop], perm[..., :pop]


def top_k_mo(x, y, top_k: Optional[int] = None):
    """Top-k by non-dominated sort (reference dmosopt/MOEA.py:350-372);
    host-side helper used to truncate surrogate training sets."""
    if not isinstance(top_k, int) or x.shape[0] <= top_k:
        return x, y
    xs, ys, *_ = sort_mo(torch.as_tensor(x), torch.as_tensor(y))
    return np.asarray(xs[:top_k]), np.asarray(ys[:top_k])
