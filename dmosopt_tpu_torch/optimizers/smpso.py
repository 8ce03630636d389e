"""SMPSO: speed-constrained multi-objective particle swarm optimization.

Port of ``dmosopt_tpu/optimizers/smpso.py``. Semantics follow the
reference (dmosopt/SMPSO.py:19-348): ``swarm_size`` independent swarms of
``popsize`` particles; a generation emits each swarm's
constriction-clamped position updates plus ``popsize`` polynomially
mutated parents (turbulence); survival keeps each swarm's best
``popsize`` of offspring and parents (`ops.sort_mo`); optional
success-rate adaptation of the mutation parameters.

As in the JAX package, the swarms are a leading tensor axis: the state
is (S, P, ...) tensors, offspring rows are swarm-major (positions, then
mutants), and each swarm's survival sort is one batched call. The
turbulence mutants of all swarms are one (S·P, n) batch of polynomial
mutation over one draw of uniforms (`ops.variation.mutation`), so a
generation launches the mutation kernel once on a CUDA device; the mutation rate stays a 0-d
device tensor, which the kernel reads through a pointer.

The velocity update's draws (r1, r2, w, c1, c2 and the two leader picks
of each swarm) are the one place the random streams part: the JAX
package derives them inside ``update_strategy`` from a key folded from
the state (``smpso.py:177-190``); the port draws them from the run's
generator in ``generate_strategy`` and carries them in the state
(``draws``, ``leaders``). `_velocity_core` takes them as tensors, so
tests can hand it the JAX package's draws.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import Any, Dict

import torch

from dmosopt_tpu_torch.ops import crowding_distance, sort_mo
from dmosopt_tpu_torch.ops.variation import mutation
from dmosopt_tpu_torch.optimizers.base import MOEA


@dataclass
class SMPSOState:
    population_parm: torch.Tensor  # (S, P, n)
    population_obj: torch.Tensor  # (S, P, d)
    rank: torch.Tensor  # (S, P) int32
    velocity: torch.Tensor  # (S, P, n)
    bounds: torch.Tensor  # (n, 2)
    di_mutation: torch.Tensor  # (n,)
    mutation_rate: torch.Tensor  # ()
    successful_children: torch.Tensor  # ()
    draws: torch.Tensor  # (S, 5) r1, r2, w, c1, c2 of the next update
    leaders: torch.Tensor  # (S, 2) int64 leader candidates of the next update

    _replace = replace

    @classmethod
    def field_names(cls):
        return [f.name for f in fields(cls)]


def _velocity_core(pos, vel, archive, archive_y, draws, leaders, xlb, xub):
    """Constriction-factor velocity update with crowding-biased leader
    choice, every swarm at once (reference SMPSO.py:316-348): of the two
    candidate leaders the one with the larger crowding distance among
    the swarm's new positions leads. ``pos``/``vel`` (S, P, n) are the
    parents and their velocities, ``archive``/``archive_y`` the new
    positions and their objectives."""
    r1, r2, w, c1, c2 = (draws[:, k, None, None] for k in range(5))
    csum = c1 + c2
    phi = torch.where(csum > 4.0, csum, torch.zeros_like(csum))
    chi = 2.0 / (2.0 - phi - torch.sqrt(torch.clamp(phi * phi - 4.0 * phi, min=0.0)))

    D = crowding_distance(archive_y)  # (S, P)
    d1 = torch.gather(D, 1, leaders[:, :1])
    d2 = torch.gather(D, 1, leaders[:, 1:])
    lead = torch.where(d1 < d2, leaders[:, 1:], leaders[:, :1])  # (S, 1)
    lead_x = torch.take_along_dim(archive, lead[:, :, None], dim=1)  # (S, 1, n)
    delta = (xub - xlb) / 2.0
    out = (w * vel + c1 * r1 * (lead_x - pos) + c2 * r2 * (lead_x - pos)) * chi
    return torch.clamp(out, -delta, delta)


class SMPSO(MOEA):
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
        swarm_size = kwargs.get("swarm_size") or self.default_parameters["swarm_size"]
        kwargs["initial_size"] = popsize * swarm_size
        super().__init__(
            name="SMPSO", popsize=popsize, nInput=nInput, nOutput=nOutput,
            device=device, **kwargs,
        )
        # the EA ranks 2·nOutput columns [mean, variance] of the surrogate
        # while nOutput stays the objective count (moasmo.epoch)
        self.optimize_mean_variance = optimize_mean_variance
        self.model = model
        self.y_distance_metrics = [distance_metric] if distance_metric else None
        self.x_distance_metrics = None
        feasibility = getattr(model, "feasibility", None)
        if feasibility is not None:
            # reference ``dmosopt_tpu/optimizers/smpso.py:66-69``; `rank`
            # takes the swarms as a leading batch axis
            self.x_distance_metrics = [feasibility.rank]
        if self.opt_params.mutation_rate is None:
            self.opt_params.mutation_rate = 1.0 / float(nInput)
        if self.opt_params.adaptive_population_size:
            raise NotImplementedError(
                "adaptive_population_size requires dynamic shapes; "
                "use a fixed popsize (reference default is also off)"
            )

    @property
    def default_parameters(self) -> Dict[str, Any]:
        # Reference defaults: dmosopt/SMPSO.py:70-84.
        return {
            "mutation_rate": None,
            "nchildren": 1,
            "swarm_size": 5,
            "di_mutation": 20.0,
            "max_population_size": 2000,
            "min_population_size": 100,
            "min_success_rate": 0.2,
            "max_success_rate": 0.75,
            "adaptive_population_size": False,
            "adaptive_operator_rates": False,
        }

    @property
    def swarm_size(self) -> int:
        return int(self.opt_params.swarm_size)

    def n_offspring(self) -> int:
        """Positions and turbulence mutants of every swarm: 2·S·P."""
        return 2 * self.swarm_size * self.popsize

    # ------------------------------------------------------ state functions

    def _sort(self, x, y, need=None):
        return sort_mo(
            x, y, x_distance_metrics=self.x_distance_metrics,
            y_distance_metrics=self.y_distance_metrics, need=need,
        )

    def initialize_state(self, generator, x, y, bounds, mask=None) -> SMPSOState:
        S, P, n = self.swarm_size, self.popsize, self.nInput
        dev = x.device
        total = S * P
        # pad by tiling when there are fewer initial points than S*P
        reps = -(-total // x.shape[0])
        xs = x.repeat(reps, 1)[:total].reshape(S, P, n)
        ys = y.repeat(reps, 1)[:total].reshape(S, P, -1)
        xs, ys, rank, _, _ = self._sort(xs, ys)

        xlb, xub = bounds[:, 0], bounds[:, 1]
        velocity = torch.rand((S, P, n), generator=generator, device=dev) * (xub - xlb) + xlb

        def scalar(v):
            return torch.tensor(float(v), dtype=torch.float32, device=dev)

        di = torch.as_tensor(self.opt_params.di_mutation, dtype=torch.float32, device=dev)
        return SMPSOState(
            population_parm=xs,
            population_obj=ys,
            rank=rank,
            velocity=velocity,
            bounds=bounds,
            di_mutation=torch.broadcast_to(di, (n,)).clone(),
            mutation_rate=scalar(self.opt_params.mutation_rate),
            successful_children=scalar(0.0),
            draws=torch.zeros((S, 5), dtype=torch.float32, device=dev),
            leaders=torch.zeros((S, 2), dtype=torch.int64, device=dev),
        )

    def _generate_core(self, state: SMPSOState, pick, u):
        """Offspring from the turbulence parent picks ``pick`` (S, P) and
        the mutation uniforms ``u`` (S·P, n): each swarm's positions
        ``clip(x + v)`` (reference SMPSO.py:311-313), then its mutants,
        as (2·S·P, n) swarm-major rows."""
        S, P, n = self.swarm_size, self.popsize, self.nInput
        xlb, xub = state.bounds[:, 0], state.bounds[:, 1]
        positions = torch.clamp(state.population_parm + state.velocity, xlb, xub)
        parents = torch.take_along_dim(state.population_parm, pick[:, :, None], dim=1)
        mutants = mutation(
            u, parents.reshape(S * P, n), state.di_mutation, xlb, xub,
            state.mutation_rate,
        ).reshape(S, P, n)
        return torch.cat([positions, mutants], dim=1).reshape(2 * S * P, n)

    def generate_strategy(self, generator, state: SMPSOState):
        S, P, n = self.swarm_size, self.popsize, self.nInput
        dev = state.population_parm.device
        pick = torch.randint(0, P, (S, P), generator=generator, device=dev)
        u = torch.rand((S * P, n), generator=generator, device=dev)
        # the velocity update's draws, used by the next update_strategy:
        # r1, r2 on [0, 1), w on [0.1, 0.5), c1, c2 on [1.5, 2.5)
        v = torch.rand((S, 5), generator=generator, device=dev)
        draws = torch.stack(
            [v[:, 0], v[:, 1], v[:, 2] * 0.4 + 0.1, v[:, 3] + 1.5, v[:, 4] + 1.5], dim=1
        )
        leaders = torch.randint(0, P, (S, 2), generator=generator, device=dev)
        x_gen = self._generate_core(state, pick, u)
        return x_gen, state._replace(draws=draws, leaders=leaders)

    def update_strategy(self, state: SMPSOState, x_gen, y_gen) -> SMPSOState:
        S, P, n = self.swarm_size, self.popsize, self.nInput
        xlb, xub = state.bounds[:, 0], state.bounds[:, 1]
        x_gen = x_gen.reshape(S, 2 * P, n)
        y_gen = y_gen.reshape(S, 2 * P, -1)

        velocity = _velocity_core(
            state.population_parm, state.velocity, x_gen[:, :P], y_gen[:, :P],
            state.draws, state.leaders, xlb, xub,
        )

        # each swarm's elitist survival over its offspring and parents
        cand_x = torch.cat([x_gen, state.population_parm], dim=1)  # (S, 3P, n)
        cand_y = torch.cat([y_gen, state.population_obj], dim=1)
        xs, ys, rank, _, perm = self._sort(cand_x, cand_y, need=P)
        n_surv = (perm[:, :P] < 2 * P).sum()

        state = state._replace(
            population_parm=xs[:, :P],
            population_obj=ys[:, :P],
            rank=rank[:, :P],
            velocity=velocity,
            successful_children=state.successful_children + n_surv,
        )
        if self.opt_params.adaptive_operator_rates:
            state = self._adapt_rates(state)
        return state

    def _adapt_rates(self, state: SMPSOState) -> SMPSOState:
        """Success-rate mutation adaptation (reference SMPSO.py:287-309)."""
        w = torch.where
        sr = state.successful_children / (self.swarm_size * self.popsize)
        explore = sr < self.opt_params.min_success_rate
        exploit = sr > self.opt_params.max_success_rate
        di, mr = state.di_mutation, state.mutation_rate
        di = w(explore, torch.clamp(di * 0.9, min=1.0),
               w(exploit, torch.clamp(di * 1.1, max=100.0), di))
        mr = w(explore, torch.clamp(mr * 1.1, max=0.95),
               w(exploit, torch.clamp(mr * 0.9, min=0.05 / self.nInput), mr))
        return state._replace(
            di_mutation=di, mutation_rate=mr,
            successful_children=torch.zeros_like(state.successful_children),
        )

    def get_population_strategy(self, state=None):
        """Every swarm's population, best first (the reference returns the
        whole multi-swarm population, SMPSO.py:241-256)."""
        state = state if state is not None else self.state
        S, P = self.swarm_size, self.popsize
        x = state.population_parm.reshape(S * P, -1)
        y = state.population_obj.reshape(S * P, -1)
        xs, ys, _, _, _ = self._sort(x, y)
        return xs, ys
