"""NSGA-II.

Port of ``dmosopt_tpu/optimizers/nsga2.py``. Semantics follow the
reference (dmosopt/NSGA2.py:18-316): tournament selection on rank into a
half-size mating pool, SBX crossover + polynomial mutation, elitist
survival by non-dominated rank then crowding distance, optional
success-rate adaptation of the operator rates and of the population
size. As in the JAX package, each generation emits a fixed batch of
``popsize`` offspring — ``popsize/2`` slots each produce an SBX child
pair or two mutated parents — and the adaptive hyperparameters live in
the state as device tensors, so a generation makes no host sync of its
own (the rank relaxation in `ops.dominance` checks convergence once per
`CHECK_EVERY` steps). A generation's offspring step (pair picks, parent
gather, SBX, both mutations, operator select) is one call of
`ops.offspring`, one Triton kernel launch on a CUDA device.

The three state functions also take stacked states, every tensor with
a leading (T,) tenants axis (per-tenant scalars (T,), bounds (T, n, 2),
per-gene vectors (T, n)), and for them a sequence of T generators:
what the JAX package gets from ``jax.vmap`` over the generation
(``dmosopt_tpu/tenants.py:433-467``, ``:617-623``). Each tenant's
Gumbels and uniforms come from its own generator in the sequential
order, and the bucket's offspring step is one launch. The same code
serves both: a single state is the case without the leading axis.
Stacked states carry a fixed population size (the batched core routes
adaptive population sizes to the sequential path).
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import Any, Dict

import torch

from dmosopt_tpu_torch.optimizers.adaptive import adapt_population_size
from dmosopt_tpu_torch.optimizers.base import MOEA
from dmosopt_tpu_torch.ops import offspring, sort_mo, tournament_selection
from dmosopt_tpu_torch.ops.variation import draw_uniform


@dataclass
class NSGA2State:
    # shapes of one population; stacked states lead each with (T,)
    population_parm: torch.Tensor  # (cap, n)
    population_obj: torch.Tensor  # (cap, d)
    rank: torch.Tensor  # (cap,) int32
    bounds: torch.Tensor  # (n, 2)
    n_active: torch.Tensor  # () int32 — live size (== cap unless adaptive)
    di_crossover: torch.Tensor  # (n,)
    di_mutation: torch.Tensor  # (n,)
    crossover_prob: torch.Tensor  # ()
    mutation_prob: torch.Tensor  # ()
    mutation_rate: torch.Tensor  # ()
    successful_crossovers: torch.Tensor  # ()
    total_crossovers: torch.Tensor  # ()
    successful_mutations: torch.Tensor  # ()
    total_mutations: torch.Tensor  # ()
    last_is_crossover: torch.Tensor  # (2*(pop//2),) operator tag per slot

    _replace = replace

    @classmethod
    def field_names(cls):
        return [f.name for f in fields(cls)]


class NSGA2(MOEA):
    def __init__(
        self,
        popsize: int,
        nInput: int,
        nOutput: int,
        model=None,
        distance_metric="crowding",
        optimize_mean_variance: bool = False,
        device=None,
        **kwargs,
    ):
        super().__init__(
            name="NSGA2", popsize=popsize, nInput=nInput, nOutput=nOutput,
            device=device, **kwargs,
        )
        # the EA ranks 2·nOutput columns [mean, variance] of the surrogate
        # while nOutput stays the objective count (moasmo.epoch)
        self.optimize_mean_variance = optimize_mean_variance
        self.model = model
        self.distance_metric = distance_metric
        self.y_distance_metrics = [distance_metric] if distance_metric else None
        self.x_distance_metrics = None
        feasibility = getattr(model, "feasibility", None)
        if feasibility is not None:
            # each front ordered by mean feasible probability (reference
            # ``dmosopt_tpu/optimizers/nsga2.py:75-77``)
            self.x_distance_metrics = [feasibility.rank]
        if self.opt_params.mutation_rate is None:
            self.opt_params.mutation_rate = 1.0 / float(nInput)
        self.opt_params.poolsize = int(round(self.popsize / 2.0))

    @property
    def default_parameters(self) -> Dict[str, Any]:
        # Reference defaults: dmosopt/NSGA2.py:66-83.
        return {
            "crossover_prob": 0.9,
            "mutation_prob": 0.1,
            "mutation_rate": None,
            "nchildren": 1,
            "di_crossover": 1.0,
            "di_mutation": 20.0,
            "min_success_rate": 0.2,
            "max_success_rate": 0.75,
            "adaptive_operator_rates": False,
            "max_population_size": 2000,
            "min_population_size": 100,
            "adaptive_population_size": False,
        }

    # ------------------------------------------------------ state functions

    def initialize_state(self, generator, x, y, bounds, mask=None) -> NSGA2State:
        """The sorted initial population of (x, y); with a leading (T,)
        axis on ``x``, ``y``, ``bounds`` and ``mask`` each tenant's on its
        own (stacked states)."""
        n = self.nInput
        pop = self.capacity
        xs, ys, rank, _, _ = sort_mo(
            x, y,
            x_distance_metrics=self.x_distance_metrics,
            y_distance_metrics=self.y_distance_metrics,
            mask=mask,
        )
        dev = xs.device
        lead = tuple(x.shape[:-2])

        def scalar(v):
            return torch.full(lead, float(v), dtype=torch.float32, device=dev)

        def per_gene(v):
            t = torch.as_tensor(v, dtype=torch.float32, device=dev)
            return torch.broadcast_to(t, lead + (n,)).clone()

        zero = scalar(0.0)
        return NSGA2State(
            population_parm=xs[..., :pop, :],
            population_obj=ys[..., :pop, :],
            rank=rank[..., :pop],
            bounds=bounds,
            di_crossover=per_gene(self.opt_params.di_crossover),
            di_mutation=per_gene(self.opt_params.di_mutation),
            crossover_prob=scalar(self.opt_params.crossover_prob),
            mutation_prob=scalar(self.opt_params.mutation_prob),
            mutation_rate=scalar(self.opt_params.mutation_rate),
            successful_crossovers=zero,
            total_crossovers=zero,
            successful_mutations=zero,
            total_mutations=zero,
            last_is_crossover=torch.zeros(
                lead + (2 * (pop // 2),), dtype=torch.bool, device=dev
            ),
            n_active=torch.full(lead, min(self.popsize, pop), dtype=torch.int32,
                                device=dev),
        )

    def generate_strategy(self, generator, state: NSGA2State):
        pop = self.capacity
        poolsize = self.opt_params.poolsize
        npairs = pop // 2
        xlb, xub = state.bounds[..., 0], state.bounds[..., 1]
        dev = state.population_parm.device
        lead = tuple(state.rank.shape[:-1])  # (T,) for stacked states

        if self.adaptive_population_size:
            # only live rows enter the mating pool; pair sampling is
            # bounded by the live pool size (a device scalar)
            active = torch.arange(pop, device=dev) < state.n_active
            pool_idx = tournament_selection(
                generator, poolsize, state.rank, mask=active
            )
            pool_n = torch.minimum(
                torch.clamp(state.n_active // 2, 2, poolsize), state.n_active
            )
            shift_hi = torch.clamp(pool_n, min=2)
        else:
            pool_idx = tournament_selection(generator, poolsize, state.rank)
            pool_n = shift_hi = self._fixed_pool_n(poolsize, dev).expand(lead)

        # one draw for the whole step: per pair slot the first parent's
        # pick, the shift to the second and the operator draw (r); per
        # gene the SBX and the two mutation uniforms (u)
        n = state.population_parm.shape[-1]
        draws = draw_uniform(generator, (3 * npairs * (n + 1),), dev)
        r = draws[..., : 3 * npairs].view(*lead, 3, npairs)
        u = draws[..., 3 * npairs:].view(*lead, 3, npairs, n)
        x_gen, is_x = offspring(
            state.population_parm, pool_idx, r, u, pool_n, shift_hi,
            state.crossover_prob, state.mutation_prob, state.mutation_rate,
            state.di_crossover, state.di_mutation, xlb, xub,
        )  # (2*npairs, n): slot i's children in rows i and i+npairs

        # offspring slot i and i+npairs share one operator draw
        state = state._replace(
            total_crossovers=state.total_crossovers + is_x.sum(-1),
            total_mutations=state.total_mutations + 2.0 * (~is_x).sum(-1),
            last_is_crossover=torch.cat([is_x, is_x], dim=-1),
        )
        return x_gen, state

    def _fixed_pool_n(self, poolsize: int, dev) -> torch.Tensor:
        """The fixed pool size as a 0-d device tensor, made once: the
        offspring step reads the pool size from the device in both modes."""
        if getattr(self, "_pool_n_key", None) != (poolsize, dev):
            self._pool_n_key = (poolsize, dev)
            self._pool_n = torch.tensor(poolsize, dtype=torch.int32, device=dev)
        return self._pool_n

    def update_strategy(self, state: NSGA2State, x_gen, y_gen) -> NSGA2State:
        pop = self.capacity
        noff = x_gen.shape[-2]
        dev = x_gen.device

        parm = torch.cat([x_gen, state.population_parm], dim=-2)
        obj = torch.cat([y_gen, state.population_obj], dim=-2)

        mask = None
        if self.adaptive_population_size:
            # offspring are all live; parent rows beyond the live size
            # are masked out of survival
            mask = torch.cat([
                torch.ones(noff, dtype=torch.bool, device=dev),
                torch.arange(pop, device=dev) < state.n_active,
            ])
        xs, ys, rank, _, perm = sort_mo(
            parm, obj,
            x_distance_metrics=self.x_distance_metrics,
            y_distance_metrics=self.y_distance_metrics,
            mask=mask,
        )
        keep = perm[..., :pop]
        survived_off = keep < noff  # offspring that made it

        state = state._replace(
            population_parm=xs[..., :pop, :], population_obj=ys[..., :pop, :],
            rank=rank[..., :pop],
        )

        if self.adaptive_population_size:
            survived_off = survived_off & (
                torch.arange(pop, device=dev) < state.n_active
            )
            new_n = adapt_population_size(
                ys[:pop], rank[:pop], state.n_active,
                min_size=int(self.opt_params.min_population_size),
                max_size=int(self.opt_params.max_population_size),
                capacity=pop,
            )
            state = state._replace(n_active=new_n)

        if self.opt_params.adaptive_operator_rates:
            is_x = state.last_is_crossover
            surv_idx = torch.where(survived_off, keep, torch.full_like(keep, noff))
            is_x_pad = torch.cat(
                [is_x, torch.zeros(is_x.shape[:-1] + (1,), dtype=torch.bool, device=dev)],
                dim=-1,
            )
            surv_tag = torch.gather(is_x_pad, -1, surv_idx)
            n_surv_x = (surv_tag & survived_off).sum(-1) / 2.0
            n_surv_m = (survived_off & ~surv_tag).sum(-1)
            state = state._replace(
                successful_crossovers=state.successful_crossovers + n_surv_x,
                successful_mutations=state.successful_mutations + n_surv_m,
            )
            state = self._adapt_rates(state)
        return state

    def _adapt_rates(self, state: NSGA2State) -> NSGA2State:
        """Success-rate-driven operator adaptation
        (reference: dmosopt/NSGA2.py:267-316)."""
        lo = self.opt_params.min_success_rate
        hi = self.opt_params.max_success_rate
        w = torch.where

        def adapt(di, prob, rate, succ, total, is_mutation):
            sr = w(total > 0, succ / torch.clamp(total, min=1.0),
                   torch.full_like(total, 0.5))
            explore = (sr < lo) & (total > 0)
            exploit = (sr > hi) & (total > 0)
            di = w(explore, torch.clamp(di * 0.9, min=1.0),
                   w(exploit, torch.clamp(di * 1.1, max=100.0), di))
            if is_mutation:
                prob_up = torch.minimum(1.0 - state.crossover_prob, prob * 1.05)
                prob_dn = torch.clamp(prob * 0.9, min=0.1)
                rate_up = torch.clamp(rate * 1.1, max=0.95)
                rate_dn = torch.clamp(rate * 0.9, min=0.05 / self.nInput)
                rate = w(explore, rate_up, w(exploit, rate_dn, rate))
            else:
                prob_up = torch.clamp(prob * 1.1, max=0.95)
                prob_dn = torch.clamp(prob * 0.9, min=0.5)
            prob = w(explore, prob_up, w(exploit, prob_dn, prob))
            return di, prob, rate

        di_x, pc, _ = adapt(
            state.di_crossover, state.crossover_prob, state.mutation_rate,
            state.successful_crossovers, state.total_crossovers, False,
        )
        di_m, pm, mr = adapt(
            state.di_mutation, state.mutation_prob, state.mutation_rate,
            state.successful_mutations, state.total_mutations, True,
        )
        z = torch.zeros_like(state.crossover_prob)
        return state._replace(
            di_crossover=di_x, di_mutation=di_m,
            crossover_prob=pc, mutation_prob=pm, mutation_rate=mr,
            successful_crossovers=z, total_crossovers=z,
            successful_mutations=z, total_mutations=z,
        )

    def get_population_strategy(self, state=None):
        state = state if state is not None else self.state
        if self.adaptive_population_size:
            n = int(state.n_active)  # host-side API: live rows only
            return state.population_parm[:n], state.population_obj[:n]
        return state.population_parm, state.population_obj

    def expand_capacity(self, state: NSGA2State, new_capacity: int) -> NSGA2State:
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
            last_is_crossover=torch.zeros(
                2 * (new_capacity // 2), dtype=torch.bool, device=dev
            ),
        )
