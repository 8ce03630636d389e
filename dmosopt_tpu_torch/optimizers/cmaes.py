"""MO-CMA-ES: multi-objective covariance-matrix-adaptation ES.

Port of ``dmosopt_tpu/optimizers/cmaes.py``. Semantics follow the
reference (dmosopt/CMAES.py:23-537), after Suttorp/Hansen/Igel 2009 and
Voss/Hansen/Igel 2010: per-individual step sizes and Cholesky factors,
offspring ``parent + sigma * A @ z``, success-rate step-size adaptation,
survival by front fill (`survival.front_fill_selection`, the mid front
broken by crowding).

As in the JAX package, a generation is functions of an explicit state:
the per-parent success/failure bookkeeping is its closed form (m
successes then f failures with q = 1 - cp give psucc' = q^f (1 + q^m
(psucc - 1)) and a geometric sum for the log-sigma exponent), m and f
come from one scatter-add over the offspring, and the rank-1 Cholesky
updates of all offspring are one batched product program
(`_update_cholesky_batch`). Offspring are clipped to the bounds and the
step sizes capped at ``sigma_max_frac`` of the bound range, as there.
`_generate_core` takes the parent picks and normal draws as tensors, so
tests can hand it the JAX package's draws.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import Any, Dict

import numpy as np
import torch

from dmosopt_tpu_torch.moasmo import remove_duplicates
from dmosopt_tpu_torch.ops import non_dominated_rank, sort_mo
from dmosopt_tpu_torch.optimizers.base import MOEA
from dmosopt_tpu_torch.optimizers.survival import front_fill_selection


def _update_cholesky_batch(A, Ainv, z, psucc, pc, cc, ccov, pthresh):
    """Batched rank-1 Cholesky update (reference CMAES.py:489-537): keeps
    C = A A^T and Ainv = A^-1 under C_new = alpha C + beta pc pc^T.
    Shapes: A/Ainv (B, n, n), z/pc (B, n), psucc (B,)."""
    below = psucc < pthresh
    pc = torch.where(
        below[:, None],
        (1.0 - cc) * pc + np.sqrt(cc * (2.0 - cc)) * z,
        (1.0 - cc) * pc,
    )
    alpha = torch.where(
        below,
        torch.full_like(psucc, 1.0 - ccov),
        torch.full_like(psucc, (1.0 - ccov) + ccov * cc * (2.0 - cc)),
    )
    beta = ccov

    w = torch.einsum("bij,bj->bi", Ainv, pc)
    w_Ainv = torch.einsum("bi,bij->bj", w, Ainv)
    a = torch.sqrt(alpha)
    norm_w2 = torch.sum(w * w, dim=1)
    root = torch.sqrt(1.0 + beta / alpha * norm_w2)
    b = a / torch.clamp(norm_w2, min=1e-30) * (root - 1.0)
    A_new = a[:, None, None] * A + b[:, None, None] * torch.einsum("bi,bj->bij", pc, w)
    c = 1.0 / (a * torch.clamp(norm_w2, min=1e-30)) * (1.0 - 1.0 / root)
    Ainv_new = (1.0 / a)[:, None, None] * Ainv - c[:, None, None] * torch.einsum(
        "bi,bj->bij", w, w_Ainv
    )
    # under this threshold the update is mostly noise (reference :528)
    noise = (torch.amax(w, dim=1) <= 1e-20)[:, None, None]
    return torch.where(noise, A, A_new), torch.where(noise, Ainv, Ainv_new), pc


@dataclass
class CMAESState:
    bounds: torch.Tensor  # (n, 2)
    parents_x: torch.Tensor  # (P, n)
    parents_y: torch.Tensor  # (P, d)
    sigmas: torch.Tensor  # (P, n)
    A: torch.Tensor  # (P, n, n)
    Ainv: torch.Tensor  # (P, n, n)
    pc: torch.Tensor  # (P, n)
    psucc: torch.Tensor  # (P,)
    rank: torch.Tensor  # (P,) int32
    gen_pidx: torch.Tensor  # (C,) int64 parent index of each offspring

    _replace = replace

    @classmethod
    def field_names(cls):
        return [f.name for f in fields(cls)]


class CMAES(MOEA):
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
            name="CMAES", popsize=popsize, nInput=nInput, nOutput=nOutput,
            device=device, **kwargs,
        )
        # the EA ranks 2·nOutput columns [mean, variance] of the surrogate
        # while nOutput stays the objective count (moasmo.epoch)
        self.optimize_mean_variance = optimize_mean_variance
        # a feasibility model is accepted and not used: the JAX package's
        # survival orders by rank only (dmosopt_tpu/optimizers/cmaes.py:100-118)
        self.model = model
        di_mutation = self.opt_params.di_mutation
        if np.isscalar(di_mutation):
            self.opt_params.di_mutation = np.asarray([di_mutation] * nInput)

    @property
    def default_parameters(self) -> Dict[str, Any]:
        # Reference defaults: dmosopt/CMAES.py:85-120, plus the JAX
        # package's step-size cap (dmosopt_tpu/optimizers/cmaes.py:137-148).
        nInput, nOutput = self.nInput, self.nOutput
        return {
            "sigma": 0.001,
            "mu": self.popsize // 2,
            "lambda_": 1,
            "d": 1.0 + nOutput / 2.0,
            "ptarg": 1.0 / (5.0 + 0.5),
            "cp": (1.0 / 5.5) / (1.0 + 1.0 / 5.5),
            "cc": 2.0 / (nInput + 2.0),
            "ccov": 2.0 / (nInput**2 + 6.0),
            "pthresh": 0.44,
            "di_mutation": 30.0,
            "max_population_size": 600,
            "min_population_size": 100,
            "adaptive_population_size": False,
            "sigma_max_frac": 0.05,
        }

    def n_offspring(self) -> int:
        """``lambda_ * mu`` offspring a generation."""
        return int(self.opt_params.lambda_ * self.opt_params.mu)

    # ------------------------------------------------------ state functions

    def initialize_state(self, generator, x, y, bounds, mask=None) -> CMAESState:
        dim, P, opt = self.nInput, self.popsize, self.opt_params
        dev = x.device
        rank = non_dominated_rank(y)
        order = torch.argsort(rank, stable=True)
        idx = order[torch.arange(P, device=dev) % x.shape[0]]
        di = torch.as_tensor(np.asarray(opt.di_mutation), dtype=torch.float32, device=dev)
        sigmas = (opt.sigma * (1.0 / (di + 1.0)))[None, :].repeat(P, 1)
        eye = torch.eye(dim, dtype=torch.float32, device=dev)[None].repeat(P, 1, 1)
        return CMAESState(
            bounds=bounds,
            parents_x=x[idx],
            parents_y=y[idx],
            sigmas=sigmas,
            A=eye,
            Ainv=eye.clone(),
            pc=torch.zeros((P, dim), dtype=torch.float32, device=dev),
            psucc=torch.full((P,), opt.ptarg, dtype=torch.float32, device=dev),
            rank=rank[idx],
            gen_pidx=torch.zeros(self.n_offspring(), dtype=torch.int64, device=dev),
        )

    def _generate_core(self, state: CMAESState, js, z):
        """Offspring from the parent picks ``js`` (C,) on [0, mu) (into
        the front order of the parents) and standard normals ``z``
        (C, n): ``clip(parent + sigma * A @ z)`` (reference
        CMAES.py:246-270)."""
        order = torch.argsort(state.rank, stable=True)
        p_idx = order[js]
        steps = state.sigmas[p_idx] * torch.einsum("ijk,ik->ij", state.A[p_idx], z)
        x_new = state.parents_x[p_idx] + steps
        x_new = torch.clamp(x_new, state.bounds[:, 0], state.bounds[:, 1])
        return x_new, state._replace(gen_pidx=p_idx)

    def generate_strategy(self, generator, state: CMAESState):
        C, dev = self.n_offspring(), state.parents_x.device
        js = torch.randint(0, self.opt_params.mu, (C,), generator=generator, device=dev)
        z = torch.randn((C, self.nInput), generator=generator, device=dev)
        return self._generate_core(state, js, z)

    def update_strategy(self, state: CMAESState, x_gen, y_gen) -> CMAESState:
        opt, P = self.opt_params, self.popsize
        C = x_gen.shape[0]
        cp, cc, ccov = opt.cp, opt.cc, opt.ccov
        d, ptarg, pthresh = opt.d, opt.ptarg, opt.pthresh
        xlb, xub = state.bounds[:, 0], state.bounds[:, 1]
        pidx = state.gen_pidx

        cand_y = torch.cat([y_gen, state.parents_y])
        sel_idx, chosen, rank, _ = front_fill_selection(cand_y, P)
        chosen_off = chosen[:C]

        # offspring strategy parameters, as if chosen (unchosen ones are
        # never gathered): one success update on the parent's copies
        last = state.sigmas[pidx]
        psucc_off = (1.0 - cp) * state.psucc[pidx] + cp
        sig_off = last * torch.exp((psucc_off[:, None] - ptarg) / (d * (1.0 - ptarg)))
        z_eff = (x_gen - state.parents_x[pidx]) / (xub - xlb) / last
        A_off, Ainv_off, pc_off = _update_cholesky_batch(
            state.A[pidx], state.Ainv[pidx], z_eff, psucc_off, state.pc[pidx],
            cc, ccov, pthresh,
        )

        # parent bookkeeping in closed form: m successes then f failures
        # (reference CMAES.py:345-397 applies them one event at a time)
        zeros = torch.zeros(P, dtype=torch.float32, device=x_gen.device)
        m = zeros.index_add(0, pidx, chosen_off.to(torch.float32))
        f = zeros.index_add(0, pidx, (~chosen_off).to(torch.float32))
        q = 1.0 - cp
        qm, qf = q**m, q**f
        p0 = state.psucc
        p_s = 1.0 + qm * (p0 - 1.0)  # after the successes
        psucc_par = qf * p_s
        S1 = m + (p0 - 1.0) * q * (1.0 - qm) / cp
        S2 = p_s * q * (1.0 - qf) / cp
        sig_par = state.sigmas * torch.exp(
            ((S1 + S2 - (m + f) * ptarg) / (d * (1.0 - ptarg)))[:, None]
        )

        # gather the survivors (offspring rows first, parents after)
        def pick(off, par):
            return torch.cat([off, par])[sel_idx]

        sigma_cap = opt.sigma_max_frac * (xub - xlb)
        return state._replace(
            parents_x=pick(x_gen, state.parents_x),
            parents_y=cand_y[sel_idx],
            sigmas=torch.minimum(pick(sig_off, sig_par), sigma_cap[None, :]),
            A=pick(A_off, state.A),
            Ainv=pick(Ainv_off, state.Ainv),
            pc=pick(pc_off, state.pc),
            psucc=pick(psucc_off, psucc_par),
            rank=rank[sel_idx],
        )

    def get_population_strategy(self, state=None):
        """The parents, duplicates removed (on the host, as the JAX
        package does), best ``popsize`` first."""
        st = state if state is not None else self.state
        dev = st.parents_x.device
        x, y = remove_duplicates(
            st.parents_x.cpu().numpy(), st.parents_y.cpu().numpy(), device=dev
        )
        x = torch.as_tensor(x, device=dev)
        y = torch.as_tensor(y, device=dev)
        if len(x) > 0:
            x, y, _, _, _ = sort_mo(x, y, need=self.popsize)
        return x[: self.popsize], y[: self.popsize]
