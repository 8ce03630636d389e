"""Non-dominated sorting, memory-bounded.

Port of ``dmosopt_tpu/ops/dominance.py`` `non_dominated_rank` (:265). The
reference has two live routes, a d == 2 patience-sort `lax.scan` over all
n points (`_rank_biobjective_sweep`, :79) and a tiled sweep for d >= 3
(`_rank_tiled`, :202), both pinned bitwise-equal to the dense
dominance-degree matrix peel (`_rank_matrix_peel`, :309). In eager torch
the sequential sweep would be n dependent tiny launches per call, so the
port computes the same ranks by relaxation instead: a point's front
index is the length of its longest dominator chain, the fixed point of
``r[j] = max_{i dominates j} r[i] + 1`` from ``r = 0``.

Memory stays bounded at large n (SMPSO's archive reaches 45 056 rows):

- the rows are put in lexicographic order of their objective vectors,
  a topological order of the dominance relation (a dominator is
  lexicographically smaller than what it dominates), so only the upper
  triangle of the boolean dominance matrix can be set; it is built in
  row blocks, one objective at a time, and no (n, n) integer matrix
  exists;
- a relaxation step sweeps the columns in blocks of ``block``, in
  order, each block reading the rows before it as already updated in
  this step (Gauss-Seidel), then relaxing its own diagonal block
  `INNER` more times. Chains that cross blocks resolve in one step,
  chains inside a block 1 + `INNER` links a step; the only
  temporaries are (rows, block) ones.

A leading batch axis (S, n, d) ranks S independent sets in one call.
With one block (n up to several thousand) a step is one plain
relaxation and `CHECK_EVERY` steps run between convergence checks, so
a call costs ceil(fronts / CHECK_EVERY) host syncs, never one per
front; with several blocks each step is checked.

Semantics kept from the matrix peel: identical rows do not dominate each
other (they share a front), rows containing NaN neither dominate nor are
dominated (rank 0), masked rows get rank ``n`` and never dominate.

Telemetry (`set_rank_telemetry`): with a run's telemetry attached, a
call with d >= 3 outside the generation loop (`telemetry.hooks`; the
JAX package counts eager calls only) adds the relaxation steps it ran
to ``rank_peel_iterations_total`` and the column-block sweeps (steps ×
blocks) to ``rank_tile_sweeps_total``, and sets ``rank_tile_size`` to
the block width. The names are the JAX package's; what they count is
this relaxation's steps and blocks, not the JAX tiled sweep's peels and
tile pairs.
"""

from __future__ import annotations

import contextlib
import threading

import torch

# relaxation steps between convergence checks (each check is one host sync)
CHECK_EVERY = 8
# extra relaxations of each diagonal block per step
INNER = 32
# default column block: about this many (rows x block) elements per temporary
_BLOCK_ELEMENTS = 1 << 26

# the run's telemetry, set by `run()` for its duration (None: no calls)
_TELEMETRY = None


# a thread's rank route (`rank_route`): a mesh run's sharded rank
_ROUTE = threading.local()


@contextlib.contextmanager
def rank_route(fn):
    """Inside, `non_dominated_rank` of one set (Y of shape (n, d)) on
    this thread is ``fn(Y, mask=mask)``: a mesh run's generation loop routes
    its survival ranks to `parallel.mesh.non_dominated_rank_sharded`,
    whose ranks equal this module's bit for bit."""
    prev = getattr(_ROUTE, "fn", None)
    _ROUTE.fn = fn
    try:
        yield
    finally:
        _ROUTE.fn = prev


def set_rank_telemetry(tel) -> None:
    """Attach a `telemetry.Telemetry` (or None) to the rank
    (``dmosopt_tpu/ops/dominance.py:51``). Process-wide; `run()` sets it
    for the run and clears it after."""
    global _TELEMETRY
    _TELEMETRY = tel


def default_block(n: int, batch: int = 1) -> int:
    """Column-block width of the relaxation: all n columns while one
    (batch, n, n) temporary stays under `_BLOCK_ELEMENTS` elements, else
    the widest block that keeps (batch, n, block) under it."""
    return max(1, min(n, _BLOCK_ELEMENTS // max(1, batch * n)))


def _dominates(Ya: torch.Tensor, Yb: torch.Tensor) -> torch.Tensor:
    """``out[..., i, j]`` iff ``Ya[..., i, :]`` dominates ``Yb[..., j, :]``:
    no worse on every objective and better on one. Equal to the degree
    form ``(D == d) & (D.T < d)`` of the matrix peel (NaN comparisons are
    False, so a row with NaN neither dominates nor is dominated), built
    one objective at a time from boolean temporaries."""
    le = lt = None
    for k in range(Ya.shape[-1]):
        a, b = Ya[..., :, k, None], Yb[..., None, :, k]
        le = (a <= b) if le is None else le & (a <= b)
        lt = (a < b) if lt is None else lt | (a < b)
    return le & lt


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
    """Boolean Pareto-dominance matrix: ``dom[..., i, j]`` iff i dominates
    j (identical vectors excluded, reference dmosopt/dda.py:109-115);
    masked rows neither dominate nor are dominated. Built in row blocks
    (`default_block`); accepts a leading batch axis."""
    n = Y.shape[-2]
    B = default_block(n, _batch(Y))
    dom = torch.empty(Y.shape[:-1] + (n,), dtype=torch.bool, device=Y.device)
    for r0 in range(0, n, B):
        dom[..., r0:r0 + B, :] = _dominates(Y[..., r0:r0 + B, :], Y)
    if mask is not None:
        valid = mask.to(torch.bool)
        dom &= valid[..., :, None] & valid[..., None, :]
    return dom


def _batch(Y: torch.Tensor) -> int:
    return Y[..., 0, 0].numel()


def _lex_order(Y: torch.Tensor) -> torch.Tensor:
    """Per set, the permutation sorting rows lexicographically by
    objective vector (NaN sorts last; rows with NaN have no dominance
    relation, so their place is free)."""
    d = Y.shape[-1]
    # stable passes from the least significant objective to the first
    perm = torch.argsort(Y[..., d - 1], dim=-1, stable=True)
    for k in range(d - 2, -1, -1):
        key = torch.take_along_dim(Y[..., k], perm, dim=-1)
        perm = torch.take_along_dim(perm, torch.argsort(key, dim=-1, stable=True), dim=-1)
    return perm


def _sorted_dominance(Ys: torch.Tensor, valid, B: int) -> torch.Tensor:
    """The dominance matrix of lexicographically sorted rows: only the
    upper triangle can be set, so row block [r0, r0+B) is compared with
    columns from r0 on."""
    n = Ys.shape[-2]
    dom = torch.zeros(Ys.shape[:-1] + (n,), dtype=torch.bool, device=Ys.device)
    for r0 in range(0, n, B):
        blk = _dominates(Ys[..., r0:r0 + B, :], Ys[..., r0:, :])
        if valid is not None:
            blk &= valid[..., r0:r0 + B, None] & valid[..., None, r0:]
        dom[..., r0:r0 + B, r0:] = blk
    return dom


def _masked_max(dom: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """``max_i dom[..., i, j] ? r[..., i] + 1 : 0`` over the rows of
    ``dom`` (rows of ``r`` align with them)."""
    return torch.where(dom, (r + 1)[..., :, None], 0).amax(dim=-2)


def _relax_step(dom: torch.Tensor, r: torch.Tensor, B: int) -> torch.Tensor:
    """One Gauss-Seidel relaxation step over column blocks of width B, in
    the topological order of the rows; returns the updated ranks."""
    n = r.shape[-1]
    r = r.clone()
    for c0 in range(0, n, B):
        c1 = min(c0 + B, n)
        blk = r[..., c0:c1]
        if c0 > 0:
            # rows before the block are final for this step
            blk = torch.maximum(blk, _masked_max(dom[..., :c0, c0:c1], r[..., :c0]))
        # the diagonal block relaxed against the rows before it: column j
        # takes cross[j] from every row that does not dominate it (its
        # own row at least), so the max also covers cross
        cross = blk[..., None, :]
        diag = dom[..., c0:c1, c0:c1]
        for _ in range(1 + (INNER if c1 - c0 < n else 0)):
            blk = torch.where(diag, (blk + 1)[..., :, None], cross).amax(dim=-2)
        r[..., c0:c1] = blk
    return r


def non_dominated_rank(Y: torch.Tensor, mask=None, stop_count=None,
                       block=None) -> torch.Tensor:
    """Rank points into non-dominated fronts (0 = best).

    Y: (n, d) objective matrix (minimization), or (S, n, d) for S
        independent sets.
    mask: optional (n,) or (S, n) bool; invalid rows get rank ``n`` and
        never dominate.
    stop_count: the reference's contract (``dmosopt_tpu/ops/dominance.py``
        :279-285) asks only that the fronts covering the best
        ``stop_count`` points be exact; the ranks here are exact
        everywhere, a legal refinement, so it is accepted and not used.
    block: column-block width of the relaxation (default `default_block`).
    Returns int32 ranks of Y's leading shape. Inside `rank_route` one
    set is ranked by the route instead.
    """
    route = getattr(_ROUTE, "fn", None)
    if route is not None and Y.dim() == 2:
        return route(Y, mask=mask)
    n = Y.shape[-2]
    r = torch.zeros(Y.shape[:-1], dtype=torch.int32, device=Y.device)
    if n == 0:
        return r
    valid = None if mask is None else mask.to(torch.bool)
    B = int(block) if block is not None else default_block(n, _batch(Y))
    order = _lex_order(Y)
    Ys = torch.take_along_dim(Y, order[..., None], dim=-2)
    vs = None if valid is None else torch.take_along_dim(valid, order, dim=-1)
    dom = _sorted_dominance(Ys, vs, B)
    # a step of several blocks already relaxes each diagonal block
    # 1 + INNER times, so it is checked after every step
    check = CHECK_EVERY if B >= n else 1
    steps = 0
    for _ in range(-(-(n + 1) // check)):
        for _ in range(check):
            prev = r
            r = _relax_step(dom, prev, B)
        steps += check
        if torch.equal(r, prev):
            break
    tel = _TELEMETRY
    if tel is not None and Y.shape[-1] >= 3:
        from dmosopt_tpu_torch.telemetry.hooks import in_generation_loop

        if not in_generation_loop():
            tel.inc("rank_tile_sweeps_total", steps * -(-n // B))
            tel.inc("rank_peel_iterations_total", steps)
            tel.gauge("rank_tile_size", B)
    rank = torch.empty_like(r).scatter_(-1, order, r)
    if valid is not None:
        rank = torch.where(valid, rank, n)
    return rank.to(torch.int32)
