"""Front-fill survival selection with crowding-distance mid-front breaking.

Port of ``dmosopt_tpu/optimizers/survival.py`` (`front_fill_selection`,
:50-101), shared by MO-CMA-ES and TRS (reference dmosopt/CMAES.py:167-230
and dmosopt/TRS.py:199-266): whole non-dominated fronts are taken while
they fit, the first front that overflows is broken by crowding distance
computed within that front, and the pick is one stable argsort on
(rank - scaled crowding). Front sizes come from a scatter-add over the
ranks and ``chosen`` is one scatter, so the selection makes no host sync
of its own (the rank relaxation checks convergence, `ops.dominance`).
"""

from __future__ import annotations

from typing import Tuple

import torch

from dmosopt_tpu_torch.ops import crowding_distance, non_dominated_rank


def front_fill_selection(
    candidates_y: torch.Tensor,
    popsize: int,
    rank: torch.Tensor | None = None,
    crowding: torch.Tensor | None = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Select exactly ``popsize`` of the N > popsize rows of
    ``candidates_y``.

    ``rank`` (N,) and ``crowding`` (N,), when given, are used instead of
    being computed: any legal ``non_dominated_rank(..., stop_count=
    popsize)`` result, and the raw crowding distances within the first
    front that overflows ``popsize`` (zero elsewhere), i.e. the fourth
    return value of an earlier call on the same candidates.

    Returns (sel_idx, chosen, rank, crowding): ``sel_idx`` (popsize,)
    indices ordered by (rank, -crowding), ``chosen`` (N,) bool, the
    ranks, and the raw mid-front crowding.
    """
    y = candidates_y.to(torch.float32)
    n = y.shape[0]
    if rank is None:
        rank = non_dominated_rank(y, stop_count=popsize)
    idx = rank.long()

    sizes = torch.zeros(n, dtype=torch.int64, device=y.device).index_add_(
        0, idx, torch.ones(n, dtype=torch.int64, device=y.device)
    )
    starts = torch.cumsum(sizes, 0) - sizes
    front_start = starts[idx]
    front_end = front_start + sizes[idx]

    fully_chosen = front_end <= popsize  # the whole front fits
    in_mid = (front_start < popsize) & ~fully_chosen

    if crowding is None:
        crowding = crowding_distance(y, mask=in_mid)
    # the tie-break stays strictly inside one rank unit
    scores = crowding / (crowding.max() + 1e-9) * 0.999

    order = torch.argsort(rank.to(torch.float32) - scores, stable=True)
    sel_idx = order[:popsize]
    chosen = torch.zeros(n, dtype=torch.bool, device=y.device).index_fill_(
        0, sel_idx, True
    )
    return sel_idx, chosen, rank, crowding
