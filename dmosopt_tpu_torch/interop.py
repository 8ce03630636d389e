"""State carried across from the JAX package, as plain numpy.

Builds the port's GP fit (with a mesh-sharded fit's ``whitened``
factor, or a problems axis), a Nyström predictor cache, a sparse variational fit, a
deep-kernel GP fit, NSGA-II (single and stacked, as the batched
tenant core steps them), AGE-MOEA (single and stacked), MO-CMA-ES, SMPSO and TRS states
and a fitted feasibility model from dicts of numpy arrays,
e.g. ``{k: np.asarray(v) for k, v in fit._asdict().items()}`` of a JAX
`GPFit` or `NSGA2State`, so the same numbers can go through both
packages. Only numpy crosses the boundary; nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from dmosopt_tpu_torch.feasibility import LogisticFeasibilityModel
from dmosopt_tpu_torch.models.deep_gp import DeepGPFit, DeepGPParams, MLPParams
from dmosopt_tpu_torch.models.gp import _KERNELS, GPFit, _Bounds
from dmosopt_tpu_torch.models.svgp import SVGPFit, SVGPParams, _kuu_factor
from dmosopt_tpu_torch.models.predictor import NystromCache
from dmosopt_tpu_torch.optimizers.agemoea import AGEMOEAState
from dmosopt_tpu_torch.optimizers.cmaes import CMAESState
from dmosopt_tpu_torch.optimizers.nsga2 import NSGA2State
from dmosopt_tpu_torch.optimizers.smpso import SMPSOState
from dmosopt_tpu_torch.optimizers.trs import TRSState


def _tensor(v, device):
    a = np.array(v)  # a writable copy
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.as_tensor(a, device=device)


def gp_fit_from_arrays(d: dict, device) -> GPFit:
    """A float32 `GPFit` on ``device`` from a dict of the JAX fit's
    fields, the mesh-sharded fit's whitening factor (``whitened``)
    included. A fit with a problems axis (``fit_gp_problems``: every
    field leads with (P,), ``n_steps`` one per problem) becomes the
    port's stacked fit, ``n_steps`` their maximum (the port's batched
    fit runs one step count for the bucket)."""
    d = {k: v for k, v in d.items() if v is not None and np.asarray(v).dtype != object}
    n_steps = d.pop("n_steps", None)
    fit = GPFit(**{k: _tensor(v, device) for k, v in d.items()})
    fit.n_steps = None if n_steps is None else int(np.max(n_steps))
    return fit


def _bounds(pair, device) -> _Bounds:
    return _Bounds(*(_tensor(v, device) for v in pair))


def svgp_fit_from_arrays(d: dict, device) -> SVGPFit:
    """A float32 `SVGPFit` on ``device`` from the JAX fit's parameter
    fields (``fit.params._asdict()``, ``W`` None without a
    coregionalization), its bounds as (lo, hi) pairs under
    ``bounds_amp``, ``bounds_ls`` and ``bounds_noise``, ``elbo`` and
    ``kernel``. The factor of K_uu at these parameters is made here, as
    `fit_svgp` makes it."""
    params = SVGPParams(**{
        k: None if d.get(k) is None else _tensor(d[k], device)
        for k in SVGPParams._fields
    })
    b_amp, b_ls, b_noise = (
        _bounds(d[k], device) for k in ("bounds_amp", "bounds_ls", "bounds_noise")
    )
    kernel = str(d.get("kernel", "matern52"))
    Luu = _kuu_factor(b_amp.forward(params.u_amp), b_ls.forward(params.u_ls),
                      params.Z, _KERNELS[kernel])
    return SVGPFit(params, b_amp, b_ls, b_noise, _tensor(d["elbo"], device), kernel, Luu)


def deep_gp_fit_from_arrays(d: dict, device) -> DeepGPFit:
    """A float32 `DeepGPFit` on ``device`` from the JAX fit's fields: the
    MLP's ``weights`` and ``biases`` (lists, one per layer), ``u_amp``,
    ``u_ls``, ``u_noise``, ``X``, ``F``, ``L``, ``alpha``, ``y_mean``,
    ``y_std``, ``nmll`` and the bounds as (lo, hi) pairs under
    ``bounds_amp``, ``bounds_ls`` and ``bounds_noise``."""
    t = lambda k: _tensor(d[k], device)  # noqa: E731
    mlp = MLPParams(tuple(_tensor(w, device) for w in d["weights"]),
                    tuple(_tensor(b, device) for b in d["biases"]))
    return DeepGPFit(
        params=DeepGPParams(mlp, t("u_amp"), t("u_ls"), t("u_noise")),
        X=t("X"), F=t("F"), L=t("L"), alpha=t("alpha"),
        y_mean=t("y_mean"), y_std=t("y_std"),
        bounds_amp=_bounds(d["bounds_amp"], device),
        bounds_ls=_bounds(d["bounds_ls"], device),
        bounds_noise=_bounds(d["bounds_noise"], device),
        nmll=t("nmll"), n_steps=int(d.get("n_steps", 0)),
    )


def nystrom_cache_from_arrays(d: dict, device) -> NystromCache:
    """A `NystromCache` on ``device`` from a dict of the JAX cache's
    fields (``cache._asdict()``)."""
    return NystromCache(**{k: _tensor(d[k], device) for k in NystromCache._fields})


def nsga2_state_from_arrays(d: dict, device) -> NSGA2State:
    """An `NSGA2State` on ``device`` from a dict of the JAX state's fields
    (the rank becomes int32, the operator tags bool)."""
    out = {k: _tensor(d[k], device) for k in NSGA2State.field_names()}
    out["rank"] = out["rank"].to(torch.int32)
    out["n_active"] = out["n_active"].to(torch.int32)
    out["last_is_crossover"] = out["last_is_crossover"].to(torch.bool)
    return NSGA2State(**out)


def stacked_nsga2_state_from_arrays(states, device) -> NSGA2State:
    """Stacked `NSGA2State` (every field with a leading (T,) tenants
    axis, as the port's batched core steps them) from a dict of a
    ``jax.vmap``-ed state's fields, or from a list of T per-tenant
    dicts."""
    if isinstance(states, dict):
        return nsga2_state_from_arrays(states, device)
    return nsga2_state_from_arrays(
        {k: np.stack([np.asarray(s[k]) for s in states]) for k in NSGA2State.field_names()},
        device,
    )


def agemoea_state_from_arrays(d: dict, device) -> AGEMOEAState:
    """An `AGEMOEAState` on ``device`` from a dict of the JAX state's
    fields (the rank and live size become int32)."""
    out = {k: _tensor(d[k], device) for k in AGEMOEAState.field_names()}
    out["rank"] = out["rank"].to(torch.int32)
    out["n_active"] = out["n_active"].to(torch.int32)
    return AGEMOEAState(**out)


def stacked_agemoea_state_from_arrays(states, device) -> AGEMOEAState:
    """Stacked `AGEMOEAState` (a leading (T,) tenants axis on every
    field) from a dict of a ``jax.vmap``-ed state's fields, or from a
    list of T per-tenant dicts."""
    if isinstance(states, dict):
        return agemoea_state_from_arrays(states, device)
    return agemoea_state_from_arrays(
        {k: np.stack([np.asarray(s[k]) for s in states])
         for k in AGEMOEAState.field_names()},
        device,
    )


def cmaes_state_from_arrays(d: dict, device) -> CMAESState:
    """A `CMAESState` on ``device`` from a dict of the JAX state's fields
    (the rank becomes int32, the offspring's parent indices int64)."""
    out = {k: _tensor(d[k], device) for k in CMAESState.field_names()}
    out["rank"] = out["rank"].to(torch.int32)
    out["gen_pidx"] = out["gen_pidx"].to(torch.int64)
    return CMAESState(**out)


def smpso_state_from_arrays(d: dict, device) -> SMPSOState:
    """An `SMPSOState` on ``device`` from a dict of the JAX state's
    fields. The JAX state has no velocity draws (it derives them from a
    key folded from the state); ``draws`` (S, 5) and ``leaders`` (S, 2)
    are taken from the dict when present, else zeros."""
    S = np.shape(d["population_parm"])[0]
    d = {"draws": np.zeros((S, 5), np.float32),
         "leaders": np.zeros((S, 2), np.int64), **d}
    out = {k: _tensor(d[k], device) for k in SMPSOState.field_names()}
    out["rank"] = out["rank"].to(torch.int32)
    out["leaders"] = out["leaders"].to(torch.int64)
    return SMPSOState(**out)


def trs_state_from_arrays(d: dict, device) -> TRSState:
    """A `TRSState` on ``device`` from a dict of the JAX state's fields
    (the rank and ring counters become int32, the restart flag bool, the
    uint32 Sobol direction numbers int64)."""
    d = dict(d, sobol_sv=np.asarray(d["sobol_sv"]).astype(np.int64))
    out = {k: _tensor(d[k], device) for k in TRSState.field_names()}
    for k in ("rank", "succ_count", "succ_ptr"):
        out[k] = out[k].to(torch.int32)
    out["restart"] = out["restart"].to(torch.bool)
    return TRSState(**out)


def feasibility_from_arrays(d: dict, device) -> LogisticFeasibilityModel:
    """A fitted `LogisticFeasibilityModel` on ``device`` from the JAX
    model's ``x_mean``, ``x_std``, ``rotation``, ``_W`` and ``_b``."""
    return LogisticFeasibilityModel.from_parameters(
        np.asarray(d["x_mean"]), np.asarray(d["x_std"]), np.asarray(d["rotation"]),
        np.asarray(d["_W"]), np.asarray(d["_b"]), device=device,
    )
