"""TRS: trust-region search, multi-objective local optimization.

Port of ``dmosopt_tpu/optimizers/trs.py``. Semantics follow the reference
(dmosopt/TRS.py:19-322): per-center trust boxes of width ``tr_length``
scaled by normalized bound weights; Sobol perturbations applied through
a Bernoulli mask that perturbs min(20/dim, 1) of the dimensions on
average (Regis & Shoemaker 2013); survival by front fill
(`survival.front_fill_selection`); a sliding success window drives
trust-region expand, shrink and restart.

As in the JAX package, the state has fixed shapes: the Sobol direction
numbers are a state constant and a fresh digital shift per generation
stands in for re-scrambling (`sampling.sobol_block`), the success window
is a ring buffer, and every center emits one candidate. The restart of
a bottomed-out trust region (a ``lax.cond`` there) is a ``torch.where``
on the state here, so a generation makes no host sync of its own.
`_generate_core` takes the Sobol shift and the dimension mask as
tensors, so tests can hand it the JAX package's draws.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import Any, Dict

import torch

from dmosopt_tpu_torch.ops import non_dominated_rank
from dmosopt_tpu_torch.optimizers.base import MOEA
from dmosopt_tpu_torch.optimizers.survival import front_fill_selection
from dmosopt_tpu_torch.sampling import sobol_block, sobol_direction_numbers, sobol_shift


@dataclass
class TRSState:
    bounds: torch.Tensor  # (n, 2)
    population_parm: torch.Tensor  # (P, n)
    population_obj: torch.Tensor  # (P, d)
    rank: torch.Tensor  # (P,) int32
    tr_length: torch.Tensor  # () trust-region width
    restart: torch.Tensor  # () bool: shrink bottomed out; reset next update
    succ_buffer: torch.Tensor  # (W,) success-count ring buffer
    succ_count: torch.Tensor  # () int32 entries appended (capped at W)
    succ_ptr: torch.Tensor  # () int32 ring write position
    sobol_sv: torch.Tensor  # (n, bits) int64 direction numbers

    _replace = replace

    @classmethod
    def field_names(cls):
        return [f.name for f in fields(cls)]


class TRS(MOEA):
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
            name="TRS", popsize=popsize, nInput=nInput, nOutput=nOutput,
            device=device, **kwargs,
        )
        # the EA ranks 2·nOutput columns [mean, variance] of the surrogate
        # while nOutput stays the objective count (moasmo.epoch)
        self.optimize_mean_variance = optimize_mean_variance
        self.model = model

    @property
    def default_parameters(self) -> Dict[str, Any]:
        # Reference defaults: dmosopt/TRS.py:19-37,68-77.
        return {
            "nchildren": 1,
            "success_window_size": 64,
            "length_init": 0.1,
            "length_start": 0.05,
            "length_min": 0.00001,
            "length_max": 1.0,
            "success_tolerance": 0.51,
            "max_population_size": 600,
            "min_population_size": 100,
            "adaptive_population_size": False,
        }

    @property
    def failure_tolerance(self) -> float:
        # reference TrState.__post_init__ (TRS.py:51-53)
        return min(1.0 / self.nInput, self.opt_params.success_tolerance / 2.0)

    def n_offspring(self) -> int:
        """One candidate per center."""
        return self.popsize

    # ------------------------------------------------------ state functions

    def initialize_state(self, generator, x, y, bounds, mask=None) -> TRSState:
        P, W = self.popsize, self.opt_params.success_window_size
        dev = x.device
        rank = non_dominated_rank(y)
        order = torch.argsort(rank, stable=True)
        idx = order[torch.arange(P, device=dev) % x.shape[0]]
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        sv = sobol_direction_numbers(self.nInput).astype("int64")
        return TRSState(
            bounds=bounds,
            population_parm=x[idx],
            population_obj=y[idx],
            rank=rank[idx],
            tr_length=torch.tensor(self.opt_params.length_start, dtype=torch.float32, device=dev),
            restart=torch.zeros((), dtype=torch.bool, device=dev),
            succ_buffer=torch.zeros(W, dtype=torch.float32, device=dev),
            succ_count=zero,
            succ_ptr=zero.clone(),
            sobol_sv=torch.as_tensor(sv, device=dev),
        )

    def _generate_core(self, state: TRSState, shift, mask):
        """Candidates from the Sobol digital shift ``shift`` (n,) (32-bit
        words) and the bool dimension mask ``mask`` (n,): each center,
        with its masked dimensions replaced by a Sobol point of its trust
        box (reference TRS.py:118-126)."""
        P = self.popsize
        xlb, xub = state.bounds[:, 0], state.bounds[:, 1]
        weights = xub - xlb
        weights = weights / torch.mean(weights)
        weights = weights / torch.prod(torch.pow(weights, 1.0 / weights.shape[0]))
        centers = state.population_parm
        tr_lb = torch.clamp(centers - weights * state.tr_length / 2.0, xlb, xub)
        tr_ub = torch.clamp(centers + weights * state.tr_length / 2.0, xlb, xub)
        pert = tr_lb + (tr_ub - tr_lb) * sobol_block(state.sobol_sv, shift, P)
        return torch.where(mask[None, :], pert, centers)

    def generate_strategy(self, generator, state: TRSState):
        n = self.nInput
        dev = state.population_parm.device
        shift = sobol_shift(n, generator, device=dev)
        # perturbation mask: fewer dimensions at a time in high dimension
        mask = torch.rand(n, generator=generator, device=dev) < min(20.0 / n, 1.0)
        return self._generate_core(state, shift, mask), state

    def update_strategy(self, state: TRSState, x_gen, y_gen) -> TRSState:
        opt, P = self.opt_params, self.popsize
        C = x_gen.shape[0]
        W = opt.success_window_size
        w = torch.where

        # a bottomed-out trust region restarts at the top of the next
        # update (reference TRS.py:164-166, 192-199)
        rs = state.restart
        zero = torch.zeros_like(state.succ_ptr)
        tr_length = w(rs, torch.full_like(state.tr_length, opt.length_init), state.tr_length)
        buffer = w(rs, torch.zeros_like(state.succ_buffer), state.succ_buffer)
        count = w(rs, zero, state.succ_count)
        ptr = w(rs, zero, state.succ_ptr)

        cand_y = torch.cat([y_gen, state.population_obj])
        sel_idx, chosen, rank, _ = front_fill_selection(cand_y, P)

        # success-window trust-region control (reference TRS.py:268-292)
        succ = chosen[:C].to(torch.float32).sum()
        slot = torch.arange(W, device=buffer.device) == ptr
        buffer = w(slot, succ, buffer)
        ptr = (ptr + 1) % W
        count = torch.clamp(count + 1, max=W)
        success_mean = buffer.sum() / torch.clamp(count, min=1).to(torch.float32)
        success_frac = torch.clamp(success_mean / P, max=1.0)

        grow = success_frac > opt.success_tolerance
        shrink = success_frac <= self.failure_tolerance
        length = w(
            grow,
            torch.clamp((1.0 + (success_frac - opt.success_tolerance)) * tr_length,
                        max=opt.length_max),
            w(shrink, tr_length / 2.0, tr_length),
        )
        return state._replace(
            population_parm=torch.cat([x_gen, state.population_parm])[sel_idx],
            population_obj=cand_y[sel_idx],
            rank=rank[sel_idx],
            tr_length=length,
            restart=length < opt.length_min,
            succ_buffer=buffer,
            succ_count=count,
            succ_ptr=ptr,
        )

    def get_population_strategy(self, state=None):
        st = state if state is not None else self.state
        return st.population_parm, st.population_obj
