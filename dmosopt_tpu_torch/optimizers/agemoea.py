"""AGE-MOEA: adaptive geometry estimation for many-objective EA.

Port of ``dmosopt_tpu/optimizers/agemoea.py``. Semantics follow the
reference (dmosopt/AGEMOEA.py:29-501), after Panichella 2019: the first
non-dominated front is normalized by hyperplane intercepts through its
corner solutions, the front's geometry exponent p is estimated from the
point closest to the unit-simplex center, survival scores on front 1 are
built by a greedy max-min-Minkowski spread, and later fronts score by
proximity ``1 / minkowski(yn, ideal)``.

As in the JAX package, environmental selection runs over fixed-capacity
tensors with masks instead of data-dependent shapes, and the greedy loop
runs all N masked steps, so a generation makes no host sync of its own
(the rank relaxation in `ops.dominance` checks convergence once per
`CHECK_EVERY` steps). In eager torch each greedy step is about eleven
launches; the step is written to keep that count low without changing
its result (see `_greedy_scores`). The d x d intercept system is solved
with `torch.linalg.solve_ex`, which raises nothing and syncs nothing;
the JAX package's determinant and NaN guards choose the fallback.

A generation's offspring step is one call of `ops.offspring` (one
Triton kernel launch on a CUDA device), the same pair-slot scheme as
NSGA-II's, with the pool drawn by tournament on (rank, -survival score).

The state functions also take stacked states, as `optimizers.nsga2`'s
do: every tensor with a leading (T,) tenants axis (per-tenant scalars
(T,), bounds (T, n, 2)) and a sequence of T generators, each tenant's
Gumbels and uniforms drawn from its own generator in the sequential
order. Survival runs over the tenants axis with masks and no
per-tenant loop; the greedy loop runs its N steps for the whole bucket
(what ``jax.vmap`` of the JAX package's `fori_loop` does,
``dmosopt_tpu/tenants.py:433-467``), and the bucket's offspring step is
one launch. Reductions over the objectives are accumulated one
objective at a time (`_dot_last`, `_pow_sum`), so a stacked tenant
scores bit for bit as its own state does. Stacked states carry a fixed
population size (the batched core routes adaptive population sizes to
the sequential path).
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import Any, Dict

import torch

from dmosopt_tpu_torch.optimizers.adaptive import adapt_population_size
from dmosopt_tpu_torch.optimizers.base import MOEA
from dmosopt_tpu_torch.ops import (
    duplicate_mask,
    lexsort,
    non_dominated_rank,
    offspring,
    tournament_selection,
)
from dmosopt_tpu_torch.ops.variation import draw_uniform

_INF = float("inf")
_INT32_MAX = torch.iinfo(torch.int32).max

# Candidate-count ceiling for the dense (N, N) Minkowski matrix in the
# survival score; larger fronts switch to on-demand columns (see
# `_survival_score`). 2048 ~ 16 MB f32.
_DENSE_SURVIVAL_MAX = 2048


def _dot_last(a, b):
    """``sum_k a[..., k] * b[..., k]``, accumulated one objective at a
    time in index order: the same arithmetic whatever the leading shape,
    so a stacked state scores bit for bit as each tenant's own."""
    acc = a[..., 0] * b[..., 0]
    for k in range(1, a.shape[-1]):
        acc = acc + a[..., k] * b[..., k]
    return acc


def _point_to_line_distance(P, B):
    """Distance of each row of P (..., m, d) to the line through the
    origin along the constant B (d,) (reference AGEMOEA.py:344-353)."""
    t = _dot_last(P, B) / torch.dot(B, B)
    return torch.linalg.vector_norm(P - t[..., None] * B, dim=-1)


def _find_corner_solutions(front, mask):
    """Indices of the extreme (corner) points per objective axis
    (reference AGEMOEA.py:356-376), masked: only rows with mask True are
    eligible. ``front`` (..., m, d); returns (..., d) int64 indices."""
    m, d = front.shape[-2:]
    W = 1e-6 + torch.eye(d, dtype=front.dtype, device=front.device)
    eligible = mask.clone()
    ar = torch.arange(m, device=front.device)
    indexes = []
    for i in range(d):
        dists = _point_to_line_distance(front, W[i])
        dists = torch.where(eligible, dists, _INF)
        idx = torch.argmin(dists, dim=-1)
        indexes.append(idx)
        eligible = eligible & (ar != idx[..., None])
    return torch.stack(indexes, dim=-1)


def _rows(a, idx):
    """``a[..., idx, :]`` per leading index: rows ``idx`` (..., k) of
    ``a`` (..., m, c) -> (..., k, c). One ``gather`` (one launch;
    ``take_along_dim`` makes two on a CUDA device)."""
    return torch.gather(a, -2, idx[..., None].expand(idx.shape + a.shape[-1:]))


def _normalize(front, mask, extreme):
    """Hyperplane-intercept normalization of the first front with min-max
    fallback on degenerate systems (reference AGEMOEA.py:275-315)."""
    d = front.shape[-1]
    E = _rows(front, extreme)  # (..., d, d)
    fallback = torch.where(mask[..., None], front, -_INF).amax(dim=-2)
    # guard the solve against singular matrices
    ok_det = torch.abs(torch.linalg.det(E)) > 1e-12
    eye = torch.eye(d, dtype=front.dtype, device=front.device)
    E_safe = torch.where(ok_det[..., None, None], E, eye)
    ones = torch.ones(E.shape[:-1] + (1,), dtype=front.dtype, device=front.device)
    hyperplane = torch.linalg.solve_ex(E_safe, ones).result[..., 0]
    bad = (
        ~ok_det
        | torch.isnan(hyperplane).any(-1)
        | torch.isinf(hyperplane).any(-1)
        | (hyperplane < 0).any(-1)
    )
    normalization = torch.where(
        bad[..., None], fallback,
        1.0 / torch.where(hyperplane == 0, 1.0, hyperplane),
    )
    normalization = torch.where(
        torch.isnan(normalization) | torch.isinf(normalization), fallback,
        normalization,
    )
    return torch.where(
        torch.isclose(normalization, torch.zeros_like(normalization),
                      rtol=1e-4, atol=1e-4),
        1.0, normalization,
    )


def _get_geometry(front, mask, extreme):
    """Estimate the front geometry exponent p (reference AGEMOEA.py:324-341);
    (...,) for ``front`` (..., m, d)."""
    d = front.shape[-1]
    dist = _point_to_line_distance(
        front, torch.ones((d,), dtype=front.dtype, device=front.device)
    )
    dist = torch.where(mask, dist, _INF)
    dist = dist.scatter(-1, extreme, _INF)
    index = torch.argmin(dist, dim=-1)
    point = _rows(front, index[..., None])[..., 0, :]
    acc = point[..., 0]
    for k in range(1, d):
        acc = acc + point[..., k]
    mean_coord = acc / d
    p = torch.log(torch.full_like(mean_coord, d)) / torch.log(1.0 / mean_coord)
    p = torch.where(torch.isnan(p) | (p <= 0.1), 1.0, p)
    return torch.clamp(p, max=20.0)


def _pow_sum(diff, p):
    """``sum_k |diff[..., k]| ** p`` over the last axis, one objective at
    a time in index order (the order XLA reduces the JAX package's sum
    in; an ulp here can flip a greedy pick). ``p`` broadcasts against
    the result."""
    a = torch.abs(diff) ** p[..., None]
    acc = a[..., 0]
    for k in range(1, a.shape[-1]):
        acc = acc + a[..., k]
    return acc


def _minkowski_to_point(Y, point, p):
    """Minkowski-p distance of each row of Y (..., N, d) to ``point``
    (..., d), with p (...,)."""
    pe = p[..., None]
    return _pow_sum(Y - point[..., None, :], pe) ** (1.0 / pe)


def _greedy_scores(front_mask, selected, min1, min2, dist_col):
    """The greedy max-min spread (reference AGEMOEA.py:398-427) over N
    masked steps, as the JAX package's `fori_loop` runs it: each step
    picks the remaining front point with the largest sum of its two
    smallest distances to the selected set (one, while fewer than two
    are selected), records that sum as its score and folds its distance
    column into every point's two smallest.

    The step count equals the JAX package's (N); the step is lighter but
    gives the same picks and scores:
    - the remaining set is carried instead of the selected one. A step
      picks while any point remains, which is exactly while the step
      index is below the greedy count (the count is the remaining set's
      size, and each step takes one point), so no step reads the count;
    - the selected count reaches two after at most two steps (the corner
      solutions select at least one point of a non-empty front), so only
      the first two steps test it;
    - once no point remains, nothing the later steps change is read, so
      the fold of the picked column needs no guard;
    - ``min2' = min(min2, max(min1, dnew))`` is the JAX package's
      two-branch update written with one select less.

    Stacked fronts (a leading (T,) axis on every operand) run the same N
    steps together, as ``jax.vmap`` of the `fori_loop` does
    (``dmosopt_tpu/tenants.py:433-467``): a tenant whose remaining set
    empties early rides along, its steps picking nothing (every value
    -inf, so the pick mask is empty) and its later folds never read.
    Returns the (..., N) scores: inf on the corner solutions, the pick's
    sum on the greedy picks, 0 elsewhere."""
    N = front_mask.shape[-1]
    dev = front_mask.device
    ar = torch.arange(N, device=dev)
    crowd = torch.where(selected, _INF, 0.0).to(min1.dtype)
    remaining = front_mask & ~selected
    n_sel0 = selected.sum(-1, keepdim=True)
    for i in range(N):
        if i < 2:
            val = min1 + torch.where(n_sel0 + i >= 2, min2, 0.0)
        else:
            val = min1 + min2
        val = torch.where(remaining, val, -_INF)
        best = torch.argmax(val, dim=-1)
        pick = (ar == best[..., None]) & remaining
        crowd = torch.where(pick, val, crowd)
        remaining = remaining ^ pick
        dnew = dist_col(best)
        min2 = torch.minimum(min2, torch.maximum(min1, dnew))
        min1 = torch.minimum(min1, dnew)
    return crowd


def _survival_score(y, front_mask, ideal):
    """Masked survival scores of the first front
    (reference AGEMOEA.py:377-430), for ``y`` (..., N, d). Returns
    (normalization (..., d), p (...,), scores (..., N)) with scores zero
    outside the front."""
    N, d = y.shape[-2:]
    m = front_mask.sum(-1)
    yfront = y - ideal[..., None, :]

    extreme = _find_corner_solutions(yfront, front_mask)
    normalization = _normalize(yfront, front_mask, extreme)
    # min-max fallback when the front is smaller than the objective count
    small = m < d
    fallback_norm = torch.where(front_mask[..., None], yfront, -_INF).amax(dim=-2)
    fallback_norm = torch.where(
        torch.isclose(fallback_norm, torch.zeros_like(fallback_norm),
                      rtol=1e-4, atol=1e-4),
        1.0, fallback_norm,
    )
    normalization = torch.where(small[..., None], fallback_norm, normalization)

    ynfront = yfront / normalization[..., None, :]
    p = torch.where(small, 1.0, _get_geometry(ynfront, front_mask, extreme))
    pn = p[..., None]  # against (..., N)

    # Minkowski-p distances scaled by each point's norm, computed in the
    # JAX package's order (|diff| ** p summed over d, ** (1/p), divided by
    # the norm). Up to _DENSE_SURVIVAL_MAX candidates the (N, N) matrix
    # is built once; beyond it each greedy step computes the one column
    # it folds in, so neither (N, N) nor (N, N, d) exists.
    nn = _pow_sum(ynfront, pn) ** (1.0 / pn)
    nn_div = torch.where(nn == 0, 1.0, nn)
    dense = N <= _DENSE_SURVIVAL_MAX

    if dense:
        pnn = pn[..., None]
        D = _pow_sum(ynfront[..., :, None, :] - ynfront[..., None, :, :], pnn) ** (1.0 / pnn)
        D = D / nn_div[..., :, None]

        def dist_col(j):
            # D[..., :, j] for each leading index's j (...,)
            idx = j[..., None, None].expand(D.shape[:-1] + (1,))
            return torch.gather(D, -1, idx)[..., 0]

    else:

        def dist_col(j):
            # D[:, j]: each point's scaled Minkowski-p distance to point j
            row = _rows(ynfront, j[..., None])
            return _pow_sum(ynfront - row, pn) ** (1.0 / pn) / nn_div

    selected = torch.zeros(y.shape[:-1], dtype=torch.bool, device=y.device)
    selected = selected.scatter(-1, extreme, True) & front_mask

    # each point's two smallest distances to the selected set
    if dense:
        Dsel = torch.where(selected[..., None, :], D, _INF)
        top2 = torch.topk(Dsel, 2, dim=-1, largest=False).values
    else:
        # seed from the corner-solution columns (the initial selected
        # set), deduplicated: a corner index repeated by the degenerate
        # path contributes one column, as it holds one in the full matrix
        corner_cols = torch.stack(
            [dist_col(extreme[..., k]) for k in range(d)], dim=-2
        )  # (..., d, N)
        eq = extreme[..., :, None] == extreme[..., None, :]
        first_occurrence = ~torch.tril(eq, diagonal=-1).any(dim=-1)
        col_live = torch.gather(selected, -1, extreme) & first_occurrence
        cols = torch.where(col_live[..., None], corner_cols, _INF).mT  # (..., N, d)
        if d < 2:
            cols = torch.cat([cols, torch.full_like(cols, _INF)], dim=-1)
        top2 = torch.topk(cols, 2, dim=-1, largest=False).values
    min1, min2 = top2[..., 0], top2[..., 1]

    crowd = _greedy_scores(front_mask, selected, min1, min2, dist_col)
    crowd = torch.where(front_mask, crowd, 0.0)
    return normalization, p, crowd


def environmental_selection(x, y, pop: int, x_keys=None, mask=None):
    """AGE-MOEA environmental selection over fixed-capacity tensors
    (reference AGEMOEA.py:433-501). Duplicate rows are masked out instead
    of removed; `mask` marks additional dead rows (the adaptive-population
    alive mask, or a bucket's padding). Returns (perm, rank, crowd) where
    perm[..., :pop] are the survivors best-first. A leading (T,) axis on
    ``x``, ``y`` (and ``mask``) selects each tenant's survivors on its
    own, with no per-tenant loop."""
    dup = duplicate_mask(x, mask=mask)
    valid = ~dup if mask is None else (~dup & mask)
    rank = non_dominated_rank(y, mask=valid, stop_count=pop)

    front1 = (rank == 0) & valid
    ideal = torch.where(front1[..., None], y, _INF).amin(dim=-2)

    normalization, p, crowd = _survival_score(y, front1, ideal)
    yn = y / normalization[..., None, :]
    # later fronts: proximity to the ideal point (reference :469-471 —
    # the reference compares normalized yn against the unnormalized
    # ideal; kept for parity)
    prox = 1.0 / torch.clamp(_minkowski_to_point(yn, ideal, p), min=1e-30)
    crowd = torch.where(front1, crowd, prox)
    crowd = torch.where(valid, crowd, -_INF)

    keys = [torch.where(valid, rank, _INT32_MAX)]
    tiebreaks = [-crowd]
    if x_keys is not None:
        tiebreaks = [-k for k in x_keys] + tiebreaks
    # lexsort: the last key is primary -> (tiebreaks..., rank)
    perm = lexsort(list(reversed(keys + tiebreaks)))
    return perm, rank, crowd


@dataclass
class AGEMOEAState:
    population_parm: torch.Tensor  # (P, n)
    population_obj: torch.Tensor  # (P, d)
    rank: torch.Tensor  # (P,) int32
    crowd_dist: torch.Tensor  # (P,)
    bounds: torch.Tensor  # (n, 2)
    n_active: torch.Tensor  # () int32 — live size (== P unless adaptive)

    _replace = replace

    @classmethod
    def field_names(cls):
        return [f.name for f in fields(cls)]


class AGEMOEA(MOEA):
    def __init__(
        self,
        popsize: int,
        nInput: int,
        nOutput: int,
        model=None,
        distance_metric=None,
        optimize_mean_variance: bool = False,
        device=None,
        **kwargs,
    ):
        super().__init__(
            name="AGEMOEA", popsize=popsize, nInput=nInput, nOutput=nOutput,
            device=device, **kwargs,
        )
        # the EA ranks 2·nOutput columns [mean, variance] of the surrogate
        # while nOutput stays the objective count (moasmo.epoch)
        self.optimize_mean_variance = optimize_mean_variance
        self.model = model
        self.feasibility = getattr(model, "feasibility", None)
        if self.opt_params.mutation_rate is None:
            self.opt_params.mutation_rate = 1.0 / float(nInput)
        self.opt_params.poolsize = int(round(self.popsize / 2.0))
        self._consts = None

    @property
    def default_parameters(self) -> Dict[str, Any]:
        # Reference defaults: dmosopt/AGEMOEA.py:72-86.
        return {
            "crossover_prob": 0.9,
            "mutation_prob": 0.1,
            "mutation_rate": None,
            "nchildren": 1,
            "di_crossover": 1.0,
            "di_mutation": 20.0,
            "max_population_size": 2000,
            "min_population_size": 100,
            "adaptive_population_size": False,
        }

    def _device_consts(self, dev, lead=()):
        """The operator rates, per-gene distribution indices and fixed
        pool size as device tensors, made once per device: the offspring
        step reads them from the device. ``lead`` (T,) for stacked states
        broadcasts them over the tenants (stride-0 views, which the
        bucket launch takes)."""
        poolsize = self.opt_params.poolsize
        key = (dev, poolsize)
        if self._consts is None or self._consts[0] != key:
            n = self.nInput

            def scalar(v):
                return torch.tensor(float(v), dtype=torch.float32, device=dev)

            def per_gene(v):
                t = torch.as_tensor(v, dtype=torch.float32, device=dev)
                return torch.broadcast_to(t, (n,)).clone()

            self._consts = (key, dict(
                crossover_prob=scalar(self.opt_params.crossover_prob),
                mutation_prob=scalar(self.opt_params.mutation_prob),
                mutation_rate=scalar(self.opt_params.mutation_rate),
                di_crossover=per_gene(self.opt_params.di_crossover),
                di_mutation=per_gene(self.opt_params.di_mutation),
                pool_n=torch.tensor(poolsize, dtype=torch.int32, device=dev),
            ))
        c = self._consts[1]
        if not lead:
            return c
        return {k: v.expand(tuple(lead) + tuple(v.shape)) for k, v in c.items()}

    def _x_keys(self, x):
        """The feasibility rank as the within-front key before crowding
        (reference ``dmosopt_tpu/optimizers/agemoea.py:302-305``)."""
        if self.feasibility is None:
            return None
        return [self.feasibility.rank(x)]

    # ------------------------------------------------------ state functions

    def initialize_state(self, generator, x, y, bounds, mask=None) -> AGEMOEAState:
        """The initial survivors of (x, y); with a leading (T,) axis on
        ``x``, ``y``, ``bounds`` and ``mask`` each tenant's on its own
        (stacked states)."""
        P = self.capacity
        perm, rank, crowd = environmental_selection(
            x, y, P, x_keys=self._x_keys(x), mask=mask
        )
        keep = perm[..., :P]
        return AGEMOEAState(
            population_parm=_rows(x, keep),
            population_obj=_rows(y, keep),
            rank=torch.gather(rank, -1, keep),
            crowd_dist=torch.gather(crowd, -1, keep),
            bounds=bounds,
            n_active=torch.full(tuple(x.shape[:-2]), min(self.popsize, P),
                                dtype=torch.int32, device=x.device),
        )

    def generate_strategy(self, generator, state: AGEMOEAState):
        pop = self.capacity
        poolsize = self.opt_params.poolsize
        npairs = pop // 2
        xlb, xub = state.bounds[..., 0], state.bounds[..., 1]
        dev = state.population_parm.device
        lead = tuple(state.rank.shape[:-1])  # (T,) for stacked states
        c = self._device_consts(dev, lead)

        if self.adaptive_population_size:
            active = torch.arange(pop, device=dev) < state.n_active
            pool_idx = tournament_selection(
                generator, poolsize, state.rank, -state.crowd_dist, mask=active
            )
            pool_n = torch.clamp(state.n_active // 2, 2, poolsize)
            shift_hi = torch.clamp(pool_n, min=2)
        else:
            pool_idx = tournament_selection(
                generator, poolsize, state.rank, -state.crowd_dist
            )
            pool_n = shift_hi = c["pool_n"]

        # one draw for the whole step: per pair slot the first parent's
        # pick, the shift to the second and the operator draw (r); per
        # gene the SBX and the two mutation uniforms (u)
        n = state.population_parm.shape[-1]
        draws = draw_uniform(generator, (3 * npairs * (n + 1),), dev)
        r = draws[..., : 3 * npairs].view(*lead, 3, npairs)
        u = draws[..., 3 * npairs:].view(*lead, 3, npairs, n)
        x_gen, _ = offspring(
            state.population_parm, pool_idx, r, u, pool_n, shift_hi,
            c["crossover_prob"], c["mutation_prob"], c["mutation_rate"],
            c["di_crossover"], c["di_mutation"], xlb, xub,
        )  # (2*npairs, n): slot i's children in rows i and i+npairs
        return x_gen, state

    def update_strategy(self, state: AGEMOEAState, x_gen, y_gen) -> AGEMOEAState:
        P = self.capacity
        dev = x_gen.device
        x = torch.cat([state.population_parm, x_gen], dim=-2)
        y = torch.cat([state.population_obj, y_gen], dim=-2)
        mask = None
        if self.adaptive_population_size:
            mask = torch.cat([
                torch.arange(P, device=dev) < state.n_active,
                torch.ones(x_gen.shape[0], dtype=torch.bool, device=dev),
            ])
        perm, rank, crowd = environmental_selection(
            x, y, P, x_keys=self._x_keys(x), mask=mask
        )
        keep = perm[..., :P]
        state = state._replace(
            population_parm=_rows(x, keep),
            population_obj=_rows(y, keep),
            rank=torch.gather(rank, -1, keep),
            crowd_dist=torch.gather(crowd, -1, keep),
        )
        if self.adaptive_population_size:
            new_n = adapt_population_size(
                state.population_obj, state.rank, state.n_active,
                min_size=int(self.opt_params.min_population_size),
                max_size=int(self.opt_params.max_population_size),
                capacity=P,
            )
            state = state._replace(n_active=new_n)
        return state

    def get_population_strategy(self, state=None):
        state = state if state is not None else self.state
        if self.adaptive_population_size:
            n = int(state.n_active)  # host-side API: live rows only
            return state.population_parm[:n], state.population_obj[:n]
        return state.population_parm, state.population_obj

    def expand_capacity(self, state: AGEMOEAState, new_capacity: int) -> AGEMOEAState:
        """Pad the sorted population arrays to a larger capacity (rows
        beyond ``n_active`` are masked everywhere; padding repeats the
        worst sorted row so every slot holds a real point)."""
        extra = new_capacity - state.population_parm.shape[0]

        def pad(a):
            return torch.cat([a, a[-1:].repeat_interleave(extra, dim=0)], dim=0)

        dev = state.rank.device
        return state._replace(
            population_parm=pad(state.population_parm),
            population_obj=pad(state.population_obj),
            rank=torch.cat([
                state.rank,
                torch.full((extra,), new_capacity, dtype=state.rank.dtype, device=dev),
            ]),
            crowd_dist=torch.cat([
                state.crowd_dist,
                torch.zeros(extra, dtype=state.crowd_dist.dtype, device=dev),
            ]),
        )
