"""Non-dominated sorting.

Port of ``dmosopt_tpu/ops/dominance.py`` `non_dominated_rank` (:265). The
reference has two live routes, a d == 2 patience-sort `lax.scan` over all
n points (`_rank_biobjective_sweep`, :79) and a tiled sweep for d >= 3
(`_rank_tiled`, :202), both pinned bitwise-equal to the dense
dominance-degree matrix peel (`_rank_matrix_peel`, :309). In eager torch
the sequential sweep would be n dependent tiny launches per call, so the
port computes the same ranks from the dense dominance matrix instead: a
point's front index is the length of its longest dominator chain, found
by relaxing ``r[j] = max_{i dominates j} r[i] + 1`` to its fixed point.
The relaxation runs `CHECK_EVERY` steps between convergence checks, so
a call costs ceil(fronts / CHECK_EVERY) host syncs, never one per front.

Semantics kept from the matrix peel: identical rows do not dominate each
other (they share a front), rows containing NaN neither dominate nor are
dominated (rank 0), masked rows get rank ``n`` and never dominate.
Memory is O(n²) (an (n, n) bool and an (n, n) int32), fine at the
populations of this path (n <= a few thousand).
"""

from __future__ import annotations

import torch

# relaxation steps between convergence checks (each check is one host sync)
CHECK_EVERY = 8


def dominance_degree_matrix(Y: torch.Tensor) -> torch.Tensor:
    """``D[i, j]`` = number of objectives on which ``Y[i] <= Y[j]``,
    accumulated one objective at a time (no (n, n, d) tensor). NaN
    comparisons count as False (reference dmosopt/dda.py:37-47)."""
    n, d = Y.shape
    D = torch.zeros((n, n), dtype=torch.int32, device=Y.device)
    for k in range(d):
        D += (Y[:, k, None] <= Y[None, :, k]).to(torch.int32)
    return D


def dominance_matrix(Y: torch.Tensor, mask=None) -> torch.Tensor:
    """Boolean Pareto-dominance matrix: ``dom[i, j]`` iff i dominates j
    (identical vectors excluded, reference dmosopt/dda.py:109-115); masked
    rows neither dominate nor are dominated."""
    d = Y.shape[1]
    D = dominance_degree_matrix(Y)
    dom = (D == d) & (D.T < d)
    if mask is not None:
        valid = mask.to(torch.bool)
        dom = dom & valid[:, None] & valid[None, :]
    return dom


def non_dominated_rank(Y: torch.Tensor, mask=None, stop_count=None) -> torch.Tensor:
    """Rank points into non-dominated fronts (0 = best).

    Y: (n, d) objective matrix (minimization).
    mask: optional (n,) bool; invalid rows get rank ``n`` and never dominate.
    stop_count: the reference's contract (``dmosopt_tpu/ops/dominance.py``
        :279-285) asks only that the fronts covering the best
        ``stop_count`` points be exact; the ranks here are exact
        everywhere, a legal refinement, so it is accepted and not used.
    Returns (n,) int32 ranks.
    """
    n = Y.shape[0]
    r = torch.zeros(n, dtype=torch.int32, device=Y.device)
    if n == 0:
        return r
    dom = dominance_matrix(Y, mask)
    zero = torch.zeros((), dtype=torch.int32, device=Y.device)
    for _ in range(-(-(n + 1) // CHECK_EVERY)):
        for _ in range(CHECK_EVERY):
            prev = r
            r = torch.where(dom, prev[:, None] + 1, zero).amax(dim=0)
        if torch.equal(r, prev):
            break
    if mask is not None:
        r = torch.where(mask.to(torch.bool), r, torch.full_like(r, n))
    return r
