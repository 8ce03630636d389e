"""Batched variation operators: SBX crossover, polynomial mutation,
the fused NSGA-II offspring step, tournament selection.

Port of ``dmosopt_tpu/ops/variation.py``. As in the reference, the math
of SBX and mutation is split into plain cores over PRECOMPUTED uniforms
(`_mutation_core` / `_sbx_core`) and a hand-written kernel beside each
(`dmosopt_tpu_torch/ops/_variation_kernels.py`, Triton, replacing the
Pallas kernels `_mutation_pallas` :72 and `_sbx_pallas` :90). NSGA-II's
generation runs neither alone: `offspring` is its whole offspring step
(pair picks, parent gather, SBX, both mutations, the operator select;
``dmosopt_tpu/optimizers/nsga2.py:161-192``), with `_offspring_core` as
the plain version built from the two cores and one Triton kernel for the
card. The route is chosen by the tensor's device alone: CUDA tensors
launch the kernel, CPU tensors take the plain core. There is no switch
and no fall-back: a CUDA tensor the kernel cannot take raises.
`KERNEL_LAUNCHES` (the kernel module's own counts) tells how many times
each kernel was launched, so a run can show that its generations went
through them.

Weighted sampling without replacement is the Gumbel top-k trick, as in
the reference; the lexsort it runs over is `ops.sort.lexsort`.
"""

from __future__ import annotations

import torch

from dmosopt_tpu_torch.ops import _variation_kernels
from dmosopt_tpu_torch.ops.sort import lexsort

KERNEL_LAUNCHES = _variation_kernels.KERNEL_LAUNCHES


def reset_kernel_launches() -> None:
    for k in KERNEL_LAUNCHES:
        KERNEL_LAUNCHES[k] = 0


def _mutation_core(u, parents, di, xlb, xub, mutation_rate):
    """Polynomial-mutation math over precomputed uniforms ``u`` — the plain
    version of the mutation kernel (reference dmosopt/MOEA.py:191-212)."""
    pw = 1.0 / (di + 1.0)
    delta_lo = (2.0 * u) ** pw - 1.0
    delta_hi = 1.0 - (2.0 * (1.0 - u)) ** pw
    delta = torch.where(u < mutation_rate, delta_lo, delta_hi)
    return torch.minimum(torch.maximum(parents + (xub - xlb) * delta, xlb), xub)


def _sbx_core(u, parents1, parents2, di, xlb, xub):
    """SBX math over precomputed uniforms ``u`` — the plain version of the
    SBX kernel (reference dmosopt/MOEA.py:215-239)."""
    pw = 1.0 / (di + 1.0)
    beta = torch.where(
        u <= 0.5,
        (2.0 * u) ** pw,
        (1.0 / (2.0 * (1.0 - u))) ** pw,
    )
    c1 = 0.5 * ((1.0 - beta) * parents1 + (1.0 + beta) * parents2)
    c2 = 0.5 * ((1.0 + beta) * parents1 + (1.0 - beta) * parents2)
    clip = lambda c: torch.minimum(torch.maximum(c, xlb), xub)  # noqa: E731
    return clip(c1), clip(c2)


def mutation(u, parents, di, xlb, xub, mutation_rate):
    """Polynomial mutation over precomputed uniforms, routed by device:
    the Triton kernel for CUDA tensors, `_mutation_core` for CPU ones."""
    if parents.is_cuda:
        return _variation_kernels.launch_mutation(
            u, parents, di, xlb, xub, mutation_rate
        )
    return _mutation_core(u, parents, di, xlb, xub, mutation_rate)


def sbx(u, parents1, parents2, di, xlb, xub):
    """SBX crossover over precomputed uniforms, routed by device as
    `mutation` is."""
    if parents1.is_cuda:
        return _variation_kernels.launch_sbx(u, parents1, parents2, di, xlb, xub)
    return _sbx_core(u, parents1, parents2, di, xlb, xub)


def _pair_indices(r, pool_n, shift_hi):
    """Two distinct mating-pool slots per pair (when ``pool_n >= 2``):
    ``i1`` uniform on [0, pool_n) from ``r[..., 0, :]``, ``i2`` = ``i1``
    shifted by a uniform draw on [1, shift_hi) from ``r[..., 1, :]``,
    modulo ``pool_n``. The float32 product truncates below ``pool_n``
    because ``r < 1``. ``pool_n``/``shift_hi`` are 0-d, or (T,) for a
    leading tenants axis of ``r``."""
    pool_n, shift_hi = pool_n.unsqueeze(-1), shift_hi.unsqueeze(-1)
    i1 = (r[..., 0, :] * pool_n).long()
    shift = 1 + (r[..., 1, :] * (shift_hi - 1)).long()
    return i1, (i1 + shift) % pool_n


def _pool_rows(parm, pool_idx, i):
    """``parm[pool_idx[i]]``, per tenant under a leading axis."""
    rows = torch.gather(pool_idx, -1, i)
    return torch.gather(parm, -2, rows.unsqueeze(-1).expand(*rows.shape, parm.shape[-1]))


def _offspring_core(
    parm, pool_idx, r, u, pool_n, shift_hi, crossover_prob, mutation_prob,
    mutation_rate, di_crossover, di_mutation, xlb, xub,
):
    """One NSGA-II offspring step over precomputed uniforms — the plain
    version of the fused offspring kernel. Pair slot i takes parents
    ``parm[pool_idx[i1]]`` and ``parm[pool_idx[i2]]`` (`_pair_indices` on
    ``r[0]``, ``r[1]``) and is a crossover slot when ``r[2] < 2pc/(2pc+pm)``
    (a crossover event yields 2 children at rate pc, a mutation event 1
    at rate pm). A crossover slot emits the SBX pair (uniforms ``u[0]``),
    a mutation slot both parents mutated (``u[1]``, ``u[2]``). Returns the
    (2*npairs, n) offspring, slot i's children in rows i and i+npairs,
    and the (npairs,) bool operator tags. A bucket of T tenants (the
    problem-batched core) puts a leading (T,) axis on every operand and
    result, as `launch_offspring` takes it."""
    i1, i2 = _pair_indices(r, pool_n, shift_hi)
    p1, p2 = _pool_rows(parm, pool_idx, i1), _pool_rows(parm, pool_idx, i2)
    pc, pm = crossover_prob.unsqueeze(-1), mutation_prob.unsqueeze(-1)
    is_x = r[..., 2, :] < (2.0 * pc) / (2.0 * pc + pm)
    gene = lambda v: v.unsqueeze(-2)  # noqa: E731  (n,) or (T, n) -> rows
    lb, ub = gene(xlb), gene(xub)
    rate = mutation_rate.unsqueeze(-1).unsqueeze(-1)
    c1, c2 = _sbx_core(u[..., 0, :, :], p1, p2, gene(di_crossover), lb, ub)
    m1 = _mutation_core(u[..., 1, :, :], p1, gene(di_mutation), lb, ub, rate)
    m2 = _mutation_core(u[..., 2, :, :], p2, gene(di_mutation), lb, ub, rate)
    sel = is_x.unsqueeze(-1)
    return torch.cat([torch.where(sel, c1, m1), torch.where(sel, c2, m2)], dim=-2), is_x


def offspring(
    parm, pool_idx, r, u, pool_n, shift_hi, crossover_prob, mutation_prob,
    mutation_rate, di_crossover, di_mutation, xlb, xub,
):
    """The NSGA-II offspring step of `_offspring_core`, routed by device:
    the fused Triton kernel for CUDA tensors (one launch, for one
    population or a whole bucket of tenants), the plain core for CPU
    ones. ``pool_n``/``shift_hi`` are 0-d integer tensors (device state
    under an adaptive population size) and the rates 0-d float tensors,
    so AGE-MOEA and constrained sampling, which run the same slot, can
    call it with their own state; a bucket gives each a leading (T,)
    axis."""
    args = (parm, pool_idx, r, u, pool_n, shift_hi, crossover_prob,
            mutation_prob, mutation_rate, di_crossover, di_mutation, xlb, xub)
    if parm.is_cuda:
        return _variation_kernels.launch_offspring(*args)
    return _offspring_core(*args)


def draw_uniform(generator, shape, device, dtype=torch.float32) -> torch.Tensor:
    """U[0, 1) draws of ``shape`` from ``generator``; from a sequence of
    T generators, a (T, *shape) tensor whose row t comes from generator
    t, as that tenant's own sequential draw would (the problem-batched
    core keeps one stream a tenant)."""
    if isinstance(generator, torch.Generator):
        return torch.rand(shape, generator=generator, dtype=dtype, device=device)
    out = torch.empty((len(generator), *shape), dtype=dtype, device=device)
    for t, g in enumerate(generator):
        torch.rand(shape, generator=g, out=out[t])
    return out


def _per_gene(v, like: torch.Tensor, n: int) -> torch.Tensor:
    return torch.broadcast_to(
        torch.as_tensor(v, dtype=like.dtype, device=like.device), (n,)
    )


def polynomial_mutation(
    generator: torch.Generator,
    parents: torch.Tensor,
    di_mutation,
    xlb: torch.Tensor,
    xub: torch.Tensor,
    mutation_rate=0.5,
) -> torch.Tensor:
    """Polynomial mutation on a batch of parents (B, n).

    Per gene: draw u ~ U[0,1); genes with ``u < mutation_rate`` perturb
    toward the lower side with ``delta = (2u)^(1/(di+1)) - 1``, the rest
    toward the upper side with ``delta = 1 - (2(1-u))^(1/(di+1))``; the
    child is ``clip(parent + (xub - xlb) * delta)``. Matches reference
    dmosopt/MOEA.py:191-212.
    """
    B, n = parents.shape
    di = _per_gene(di_mutation, parents, n)
    rate = torch.as_tensor(mutation_rate, dtype=parents.dtype, device=parents.device)
    u = torch.rand(
        (B, n), generator=generator, dtype=parents.dtype, device=parents.device
    )
    return mutation(u, parents, di, xlb, xub, rate)


def sbx_crossover(
    generator: torch.Generator,
    parents1: torch.Tensor,
    parents2: torch.Tensor,
    di_crossover,
    xlb: torch.Tensor,
    xub: torch.Tensor,
):
    """Simulated Binary Crossover on batches of parent pairs (B, n), after
    reference dmosopt/MOEA.py:215-239: spread factor
    ``beta = (2u)^(1/(di+1))`` for u <= 0.5, ``(1/(2(1-u)))^(1/(di+1))``
    otherwise; symmetric children, clipped to bounds."""
    B, n = parents1.shape
    di = _per_gene(di_crossover, parents1, n)
    u = torch.rand(
        (B, n), generator=generator, dtype=parents1.dtype, device=parents1.device
    )
    return sbx(u, parents1, parents2, di, xlb, xub)


def tournament_probabilities(n: int, p: float = 0.5, device=None) -> torch.Tensor:
    """Geometric selection probabilities over rank positions
    (reference: dmosopt/MOEA.py:375-395): position i (best first) has
    unnormalized probability ``p * (1 - p)^i``."""
    i = torch.arange(n, device=device, dtype=torch.float32)
    raw = p * (1.0 - p) ** i
    return raw / raw.sum()


def _tournament_order(rank, *tiebreak_metrics, mask=None):
    """(order, prob): the population sorted best-first by (rank,
    *tiebreaks) and the geometric selection probability of each sorted
    position (zero for masked rows); a leading tenants axis of ``rank``
    orders each tenant's population on its own."""
    n = rank.shape[-1]
    keys = [rank.to(torch.float64 if rank.dtype == torch.float64 else torch.float32)]
    keys += [torch.as_tensor(m) for m in tiebreak_metrics]
    order = lexsort(keys[::-1])  # rank most significant
    prob = tournament_probabilities(n, device=rank.device)
    if mask is not None:
        valid_sorted = torch.gather(mask.to(torch.bool).expand(order.shape), -1, order)
        prob = torch.where(valid_sorted, prob, torch.zeros_like(prob))
        prob = prob / prob.sum(dim=-1, keepdim=True)
    return order, prob


def _gumbel_top_k(order, prob, gumbel, poolsize: int):
    """Plackett-Luce sampling without replacement: the ``poolsize`` largest
    ``log(prob) + gumbel`` scores, masked positions excluded."""
    scores = torch.log(torch.clamp(prob, min=1e-38)) + gumbel
    scores = torch.where(prob > 0, scores, torch.full_like(scores, -torch.inf))
    top = torch.topk(scores, poolsize).indices
    return torch.gather(order, -1, top)


def tournament_selection(
    generator,
    poolsize: int,
    rank: torch.Tensor,
    *tiebreak_metrics: torch.Tensor,
    mask=None,
) -> torch.Tensor:
    """Select ``poolsize`` distinct individuals with geometric probability
    on their sorted position. ``rank`` is the primary sort key
    (ascending); ``tiebreak_metrics`` apply in decreasing significance.
    Returns indices into the population (reference
    ``dmosopt_tpu/ops/variation.py:167``). With a leading tenants axis
    of ``rank`` (stacked states), ``generator`` is a sequence of T
    generators and tenant t's Gumbels come from generator t
    (`draw_uniform`)."""
    order, prob = _tournament_order(rank, *tiebreak_metrics, mask=mask)
    u = draw_uniform(generator, prob.shape[-1:], prob.device, prob.dtype)
    gumbel = -torch.log(-torch.log(u.clamp(min=torch.finfo(u.dtype).tiny)))
    return _gumbel_top_k(order, prob, gumbel, poolsize)
