"""Adaptive population sizing — the alive-mask, fixed-capacity pattern.

Port of ``dmosopt_tpu/optimizers/adaptive.py``. After each survival step
the optimizer measures population diversity (the fraction of the live
population on front 0) and the coefficient of variation of the front's
crowding distances, then grows the live size 1.2x when diversity is low
or shrinks it 0.9x when high, within ``[min_population_size,
max_population_size]`` (reference dmosopt/NSGA2.py:223-265). The live
size is a 0-d device tensor, so the update needs no host sync; the host
grows the capacity between generation chunks.
"""

from __future__ import annotations

import torch

from dmosopt_tpu_torch.ops.distances import crowding_distance


def population_diversity(y, rank, active_mask, n_active):
    """PopulationDiversity (reference indicators.py:316-335): fraction of
    live points on front 0 and std/mean of their crowding distances (0
    when fewer than 2 finite values or zero mean)."""
    front0 = active_mask & (rank == 0)
    diversity = front0.sum() / torch.clamp(n_active, min=1)
    cd = crowding_distance(y, active_mask)
    finite = front0 & torch.isfinite(cd)
    cnt = finite.sum()
    zero = torch.zeros_like(cd)
    mean = torch.where(finite, cd, zero).sum() / torch.clamp(cnt, min=1)
    var = torch.where(finite, (cd - mean) ** 2, zero).sum() / torch.clamp(cnt, min=1)
    spread = torch.where(
        (cnt > 1) & (mean != 0.0), torch.sqrt(var) / mean, torch.zeros_like(mean)
    )
    return diversity, spread


def adapt_population_size(
    y_sorted, rank_sorted, n_active, *, min_size: int, max_size: int,
    capacity: int
):
    """New live size per the reference update rule (NSGA2.py:245-266):
    low diversity + tight spread -> grow 1.2x (toward ``max_size``), high
    diversity or wide spread -> shrink 0.9x (toward ``min_size``), then
    clamped to the current ``capacity``."""
    active = torch.arange(rank_sorted.shape[0], device=rank_sorted.device) < n_active
    diversity, spread = population_diversity(
        y_sorted, rank_sorted, active, n_active
    )
    cur = n_active.to(torch.float32)
    grow = (diversity < 0.5) & (spread < 2.0)
    shrink = (diversity > 0.9) | (spread > 1.0)
    grown = torch.clamp((cur * 1.2).to(torch.int32), max=max_size)
    shrunk = torch.clamp((cur * 0.9).to(torch.int32), min=min_size)
    new = torch.where(grow, grown, torch.where(shrink, shrunk, n_active))
    return torch.clamp(new, 1, capacity).to(torch.int32)
