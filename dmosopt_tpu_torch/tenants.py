"""Problem-batched tenant core: one fit and one generation loop a bucket.

Port of ``dmosopt_tpu/tenants.py``. The driver runs several problems
(tenants) of one run; sequentially each pays its own GP fit and its own
inner-EA loop. Here the problems of a **bucket** — the same optimizer,
dimension, objective count, population size, fit configuration and
optimizer options — advance together:

- the surrogate fits run as ONE Adam loop with a leading problems axis
  (`models.gp.fit_gp_problems`), each tenant's training set padded to
  the bucket's common `_bucket_size` with masked rows;
- the inner EA runs ONE generation loop over stacked NSGA-II or
  AGE-MOEA states (`optimizers.nsga2`, `optimizers.agemoea`): per
  generation one batched surrogate predict
  and **one** launch of the fused offspring kernel for the whole
  bucket, whatever the number of tenants T;
- tenants with fewer generations left ride along as inactive rows: a
  per-generation (G, T) active mask freezes a finished tenant's state
  with `torch.where`.

Random streams: as in the sequential path, each tenant's host draws
(the loop generator, the initial design, the optimizer's generator) are
taken from its ``local_random`` in the sequential order, in tenant
order, before any bucket runs. Each tenant keeps its own
`torch.Generator`s; a batched generation draws each tenant's pool
Gumbels and offspring uniforms from that tenant's generator, in the
sequential order, and stacks them for the one offspring launch (about
2·T small draws a generation beside the one kernel launch). So a
tenant's batched epoch reproduces its sequential epoch, which the tests
hold tenant by tenant.

Routing: buckets smaller than ``min_bucket`` (every single-problem run)
and tenants whose configuration the batched core does not cover take
the sequential `DistOptStrategy.initialize_epoch`, with the JAX
package's reasons (`batch_eligibility`); ``_BATCHABLE_OPTIMIZERS`` is
the JAX package's, NSGA-II and AGE-MOEA.

Telemetry (``telemetry=``, the driver's): a bucket's fit, generation
loop and host tail run in ``gp_fit``, ``ea_scan`` and ``resample``
spans labelled with the bucket and ``n_tenants``; ``tenant_cost`` child
spans tile the fit and EA spans with each tenant's share, which also
counts in ``tenant_cost_seconds``; the bucket counts in
``tenant_bucket_epochs_total``, ``tenants_batched_total`` and the
``tenant_bucket_size`` gauge and emits a ``tenant_bucket`` event, and an
ineligible tenant counts in ``tenants_sequential_total``
(``dmosopt_tpu/tenants.py:549-825``). The spans close after the
device syncs the bucket already makes.

Left out on purpose:

- the JAX program cache and its AOT compile bookkeeping
  (``_PROGRAM_CACHE``, ``_BucketProgram``, ``_run_bucket_program``):
  they exist because XLA compiles a program per (bucket, T); eager torch
  compiles nothing, and the Triton kernel compiles once per process;
- the compile and retrace counters of the bucket programs
  (``tenant_bucket_compiles_total``, ``tenant_bucket_retraces_total``,
  ``:502-515``): there is no program to count;
- the JAX fit's ``FIT_CHUNK`` thread split (see `fit_gp_problems`);
- the fall-back of a failed bucket to the sequential path
  (``dmosopt_tpu/tenants.py:870-896``): it would hide a kernel that
  fails to launch. A bucket's exception propagates; with ``on_error``
  its tenants are reported failed and the other buckets go on, but a
  bucket never re-runs on another route.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field, fields
from types import SimpleNamespace
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from dmosopt_tpu_torch.config import default_optimizers, resolve
from dmosopt_tpu_torch.models import Model
from dmosopt_tpu_torch.models.gp import (
    _bucket_size,
    _default_rel_jitter,
    _pad_to_bucket,
    _prepare_training_data,
    fit_gp_problems,
    gp_predict_problems,
)
from dmosopt_tpu_torch.moasmo import (
    LARGE_N_THRESHOLD,
    _feasible_subset,
    _synchronize,
    get_duplicates,
    remove_duplicates,
)
from dmosopt_tpu_torch.ops import crowding_distance
from dmosopt_tpu_torch.telemetry import loop_parts, record_parts, span_scope
from dmosopt_tpu_torch.telemetry.hooks import generation_loop
from dmosopt_tpu_torch.utils.prng import as_torch_generator

# optimizers whose state functions take stacked states
_BATCHABLE_OPTIMIZERS = ("nsga2", "age")

# GPR_Matern kwargs the batched fit understands; any other routes the
# tenant to the sequential path rather than being dropped
_KNOWN_GP_KWARGS = frozenset({
    "seed", "n_starts", "n_iter", "learning_rate",
    "length_scale_bounds", "constant_kernel_bounds", "noise_level_bounds",
    "anisotropic", "nan", "top_k", "rel_jitter",
    "convergence_tol", "convergence_check_every",
    "predictor", "dtype", "large_n_threshold",
})


def bucket_label(dim: int, n_obj: int, pop: int) -> str:
    """Short label of a bucket's shape, for logs."""
    return f"d{dim}_o{n_obj}_p{pop}"


# ------------------------------------------------------------- eligibility


def batch_eligibility(strat) -> Optional[str]:
    """None when ``strat`` can join a bucket this epoch, else the reason:
    the archive gates (empty, past the dense-kernel threshold) around
    `_static_eligibility` (``dmosopt_tpu/tenants.py:102``)."""
    if strat.x is None:
        return "empty archive"
    reason = _static_eligibility(strat)
    if reason is not None:
        return reason
    kwargs = strat.surrogate_method_kwargs or {}
    threshold = kwargs.get("large_n_threshold", LARGE_N_THRESHOLD)
    if threshold and strat.x.shape[0] > threshold:
        return "archive beyond dense-kernel threshold"
    return None


def _static_eligibility(strat) -> Optional[str]:
    """The gates decidable from the tenant's configuration alone, with
    the JAX package's reasons (``dmosopt_tpu/tenants.py:119-160``)."""
    if len(strat.optimizer_name) != 1:
        return "cycled optimizers"
    name = strat.optimizer_name[0]
    if not isinstance(name, str) or name not in _BATCHABLE_OPTIMIZERS:
        return f"optimizer {name!r} not batchable"
    if strat.surrogate_method_name != "gpr":
        return f"surrogate {strat.surrogate_method_name!r} not batchable"
    if strat.surrogate_custom_training is not None:
        return "custom surrogate training"
    if strat.sensitivity_method_name is not None:
        return "sensitivity analysis"
    if strat.feasibility_method_name is not None:
        return "feasibility model"
    if strat.optimize_mean_variance:
        return "mean-variance mode"
    if strat.termination is not None:
        return "termination criterion"
    if getattr(strat, "refit_controller", None) is not None:
        return "surrogate refit controller"
    if getattr(strat, "mesh", None) is not None:
        return "mesh"
    if strat.distance_metric is not None:
        return "distance metric override"
    if int(strat.num_generations) < 1:
        return "num_generations < 1"
    kwargs = strat.surrogate_method_kwargs or {}
    unknown = sorted(set(kwargs) - _KNOWN_GP_KWARGS)
    if unknown:
        return f"surrogate kwargs {unknown} not batchable"
    if kwargs.get("predictor", "solve") != "solve":
        return "non-solve predictor"
    if str(kwargs.get("dtype", "float32")) != "float32":
        return "non-float32 surrogate dtype"
    okw = strat.optimizer_kwargs[0] or {}
    if okw.get("adaptive_population_size"):
        return "adaptive population size"
    if "distance_metric" in okw:
        return "distance metric override"
    return None


def static_bucket_signature(strat) -> Optional[Tuple]:
    """The tenant's bucket signature from its configuration alone, or None
    when a static gate rules it out."""
    if _static_eligibility(strat) is not None:
        return None
    return bucket_signature(strat, strat.optimizer_name[0], strat.optimizer_kwargs[0])


def _fit_config(strat) -> Dict[str, Any]:
    """The `fit_gp_batch` configuration the sequential `GPR_Matern`
    builds from the tenant's surrogate kwargs."""
    kw = strat.surrogate_method_kwargs or {}
    anisotropic = kw.get("anisotropic")
    if anisotropic is None:
        anisotropic = False  # GPR_Matern.anisotropic_default
    rel_jitter = kw.get("rel_jitter")
    if rel_jitter is None:
        rel_jitter = _default_rel_jitter(torch.float32)
    return dict(
        lengthscale_bounds=tuple(kw.get("length_scale_bounds", (1e-3, 100.0))),
        amplitude_bounds=tuple(kw.get("constant_kernel_bounds", (1e-4, 1e3))),
        noise_bounds=tuple(kw.get("noise_level_bounds", (1e-9, 1e-2))),
        kernel="matern52",
        n_starts=int(kw.get("n_starts", 8)),
        n_iter=int(kw.get("n_iter", 200)),
        learning_rate=float(kw.get("learning_rate", 0.1)),
        ard=bool(anisotropic),
        rel_jitter=rel_jitter,
        convergence_tol=kw.get("convergence_tol", "auto"),
        convergence_check_every=kw.get("convergence_check_every"),
    )


def bucket_signature(strat, optimizer_name: str, okw: Dict) -> Tuple:
    """Hashable key of the tenants that may share a bucket: the shapes
    (dim, n_obj, popsize) and every fit and optimizer option."""
    fitcfg = tuple(sorted((k, repr(v)) for k, v in _fit_config(strat).items()))
    okw_key = tuple(sorted((k, repr(v)) for k, v in (okw or {}).items()))
    return (
        optimizer_name, int(strat.prob.dim), int(strat.prob.n_objectives),
        int(strat.population_size), fitcfg, okw_key,
    )


# ------------------------------------------------------------------ plans


@dataclass
class _TenantPlan:
    """One tenant's host-side epoch preparation, its share of the run's
    random draws already taken in the sequential path's order."""

    pid: Any
    strat: Any
    optimizer: Any  # this tenant's optimizer (host bookkeeping, results)
    n_resample: int
    num_generations: int
    x0: np.ndarray  # feasible archive rows (float32): the EA's seed
    y0: np.ndarray
    x_init: np.ndarray  # the optimizer's initial design (pop, n) float32
    X_unit: np.ndarray  # (N_t, n) training inputs in the unit box, float64
    Yn: np.ndarray  # (N_t, d) standardized targets, float64
    y_mean: np.ndarray
    y_std: np.ndarray
    xlb32: np.ndarray  # (n,) float32: predict-time normalization
    xrg32: np.ndarray
    bounds: np.ndarray  # (n, 2) float32
    fit_gen: torch.Generator  # the surrogate fit's restarts
    loop_gen: torch.Generator  # the generation loop's draws
    stats: Dict[str, Any] = field(default_factory=dict)


def _build_plan(pid, strat, optimizer_name: str, okw: Dict) -> _TenantPlan:
    """Host-side epoch preparation of one tenant, taking its draws from
    ``strat.local_random`` as `moasmo.epoch` -> `train` -> `optimize`
    takes them: the loop generator, the initial design, then the
    optimizer's own generator (``dmosopt_tpu/tenants.py:254-321``)."""
    prob = strat.prob
    pop = int(strat.population_size)
    dev = strat.device
    stats: Dict[str, Any] = {}

    # training data, as moasmo.train prepares it: feasible subset, dedupe
    x = np.asarray(strat.x).copy()
    y = np.asarray(strat.y).copy()
    _, (x, y) = _feasible_subset(strat.c, x, y)
    n_before = x.shape[0]
    x, y = remove_duplicates(x, y, device=dev)
    stats["duplicates_removed"] = int(n_before - x.shape[0])
    kw = strat.surrogate_method_kwargs or {}
    holder = SimpleNamespace()
    X_unit, Yn, y_mean, y_std = _prepare_training_data(
        holder, x, y, prob.dim, prob.n_objectives, prob.lb, prob.ub,
        kw.get("nan", "remove"), kw.get("top_k"),
    )

    # the EA's seed: the archive's feasible rows, as moasmo.epoch takes them
    x0 = np.asarray(strat.x, dtype=np.float32).copy()
    y0 = np.asarray(strat.y, dtype=np.float32).copy()
    _, (x0, y0) = _feasible_subset(strat.c, x0, y0)

    okw_merged: Dict[str, Any] = {
        "sampling_method": "slh", "mutation_rate": None, "nchildren": 1,
    }
    okw_merged.update(okw or {})
    optimizer = resolve(optimizer_name, default_optimizers)(
        nInput=prob.dim, nOutput=prob.n_objectives, popsize=pop,
        model=Model(return_mean_variance=False), distance_metric=None,
        optimize_mean_variance=False, device=dev, **okw_merged,
    )

    # the run's draws, in the sequential path's order
    bounds = np.column_stack((np.asarray(prob.lb), np.asarray(prob.ub)))
    loop_gen = as_torch_generator(strat.local_random, dev)
    x_init = np.asarray(
        optimizer.generate_initial(bounds, strat.local_random), dtype=np.float32
    )
    optimizer.generator = as_torch_generator(strat.local_random, dev)
    optimizer.bounds = torch.as_tensor(bounds, dtype=torch.float32, device=dev)

    return _TenantPlan(
        pid=pid, strat=strat, optimizer=optimizer,
        n_resample=int(pop * strat.resample_fraction),
        num_generations=int(strat.num_generations),
        x0=x0, y0=y0, x_init=x_init,
        X_unit=X_unit, Yn=Yn, y_mean=y_mean, y_std=y_std,
        xlb32=np.asarray(holder.xlb, np.float32),
        xrg32=np.asarray(holder.xrg, np.float32),
        bounds=np.asarray(bounds, np.float32),
        fit_gen=as_torch_generator(kw.get("seed"), dev),
        loop_gen=loop_gen, stats=stats,
    )


# ------------------------------------------------------------- bucket run


def _slice_state(states, t):
    """Tenant ``t``'s state out of stacked states."""
    return type(states)(**{f.name: getattr(states, f.name)[t] for f in fields(states)})


def _freeze(act, new, old):
    """Stacked state taking ``new`` for the active tenants (``act`` (T,))
    and keeping ``old`` for the others."""
    out = {}
    for f in fields(new):
        a, b = getattr(new, f.name), getattr(old, f.name)
        out[f.name] = torch.where(act.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)
    return type(new)(**out)


def run_bucket_epoch(plans: List[_TenantPlan], telemetry=None, logger=None):
    """Advance every tenant of one bucket by one epoch: one batched GP
    fit, one batched predict of the initial designs, the stacked
    initialization, then one generation loop over the stacked states
    (per generation: the tenants' draws, one offspring launch, one
    batched predict, the stacked survival, the active-mask freeze), and
    each tenant's host tail (dedupe against its archive, the
    crowding-distance resample). Returns ``{pid: result}`` in
    `moasmo.epoch`'s surrogate-mode result shape. ``telemetry`` records
    the bucket's spans (``gp_fit``; ``ea_scan``, with the generations'
    ``ea_variation`` and ``ea_survival`` parts inside it, see
    `telemetry.loop_parts`; ``resample``), its tenants' cost shares and
    its counters."""
    T = len(plans)
    d = plans[0].Yn.shape[1]
    n = plans[0].X_unit.shape[1]
    optimizer = plans[0].optimizer  # every tenant's has the bucket's config
    pop = int(optimizer.popsize)
    dev = optimizer.device
    fitcfg = _fit_config(plans[0].strat)
    G_max = max(p.num_generations for p in plans)
    label = bucket_label(n, d, pop)

    # ---- the batched fit: a common bucket capacity, masked rows
    t_fit0 = time.perf_counter()
    cap = max(_bucket_size(p.X_unit.shape[0]) for p in plans)
    f32 = lambda a: torch.as_tensor(np.stack(a).astype(np.float32), device=dev)  # noqa: E731
    with span_scope(telemetry, "gp_fit", bucket=label, n_tenants=T) as fit_span:
        padded = [_pad_to_bucket(p.X_unit, p.Yn, cap=cap) for p in plans]
        fit = fit_gp_problems(
            [p.fit_gen for p in plans], f32([a[0] for a in padded]),
            f32([a[1] for a in padded]), f32([a[2] for a in padded]), **fitcfg,
        )
        fit.y_mean = f32([p.y_mean for p in plans])
        fit.y_std = f32([p.y_std for p in plans])
        _synchronize(dev)
    fit_wall = time.perf_counter() - t_fit0
    nmll = fit.nmll.detach().cpu().numpy().astype(np.float64)
    n_iter = int(fitcfg["n_iter"])
    n_steps = int(fit.n_steps) if fit.n_steps is not None else n_iter
    for t, p in enumerate(plans):
        p.stats["objective"] = {
            "loss": float(np.mean(nmll[t])),
            "nmll_per_objective": [float(v) for v in nmll[t]],
            "n_steps": n_steps,
            "n_iter_max": n_iter,
            "early_stopped": n_steps < n_iter,
        }

    xlb = torch.as_tensor(np.stack([p.xlb32 for p in plans]), device=dev)[:, None, :]
    xrg = torch.as_tensor(np.stack([p.xrg32 for p in plans]), device=dev)[:, None, :]
    bounds = torch.as_tensor(np.stack([p.bounds for p in plans]), device=dev)
    lb, ub = bounds[:, None, :, 0], bounds[:, None, :, 1]

    def batched_eval(x):  # (T, B, n) -> (T, B, d) surrogate means
        mean, _ = gp_predict_problems(fit, (x - xlb) / xrg, kernel=fitcfg["kernel"])
        return mean

    # ---- the initial populations: the designs' y from the fresh fits,
    # then each tenant's [archive ; design] rows at a common masked size
    t_ea0 = time.perf_counter()
    with span_scope(telemetry, "ea_scan", bucket=label, n_tenants=T) as ea_span:
        x_design = torch.as_tensor(np.stack([p.x_init for p in plans]), device=dev)
        y_init = batched_eval(x_design).cpu().numpy().astype(np.float32)
        n_cat = [p.x0.shape[0] + p.x_init.shape[0] for p in plans]
        P_init = max(n_cat)
        Xcat = np.zeros((T, P_init, n), np.float32)
        Ycat = np.zeros((T, P_init, d), np.float32)
        Mcat = np.zeros((T, P_init), bool)
        for t, p in enumerate(plans):
            Xcat[t, : n_cat[t]] = np.vstack([p.x0, p.x_init])
            Ycat[t, : n_cat[t]] = np.vstack([p.y0, y_init[t]])
            Mcat[t, : n_cat[t]] = True
        states = optimizer.initialize_state(
            None, torch.as_tensor(Xcat, device=dev), torch.as_tensor(Ycat, device=dev),
            bounds, mask=torch.as_tensor(Mcat, device=dev),
        )

        # ---- the generation loop; tenants past their budget stay frozen
        active = np.zeros((G_max, T), bool)
        for t, p in enumerate(plans):
            active[: p.num_generations, t] = True
        active = torch.as_tensor(active, device=dev)
        gens = [p.loop_gen for p in plans]
        xs, ys = [], []
        variation, survival = loop_parts(telemetry, "ea_variation", "ea_survival")
        with generation_loop():
            for g in range(G_max):
                with variation:
                    x_gen, new = optimizer.generate_strategy(gens, states)
                    x_gen = torch.clamp(x_gen, lb, ub)
                y_gen = batched_eval(x_gen)
                with survival:
                    new = optimizer.update_strategy(new, x_gen, y_gen)
                    states = _freeze(active[g], new, states)
                xs.append(x_gen)
                ys.append(y_gen)
        record_parts(telemetry, [variation, survival], "generations")
        x_traj = torch.stack(xs).cpu().numpy()  # (G, T, noff, n)
        y_traj = torch.stack(ys).cpu().numpy()
    ea_wall = time.perf_counter() - t_ea0
    noff = x_traj.shape[2]

    # ---- each tenant's share of the bucket's walls: the fit by its real
    # training rows, the EA by its generations (the shares sum to the walls)
    row_total = float(sum(p.X_unit.shape[0] for p in plans)) or float(T)
    gen_total = float(sum(p.num_generations for p in plans)) or float(T)
    for p in plans:
        p.stats["cost_fit_seconds"] = fit_wall * p.X_unit.shape[0] / row_total
        p.stats["cost_ea_seconds"] = ea_wall * p.num_generations / gen_total
    if telemetry:
        _record_costs(telemetry, plans, label, fit_span, ea_span)

    # ---- each tenant's host tail: trajectories, dedupe, resample
    results = {}
    with span_scope(telemetry, "resample", bucket=label, n_tenants=T):
        for t, p in enumerate(plans):
            G_t = p.num_generations
            gen_index = np.concatenate(
                [np.zeros((n_cat[t],), np.uint32)]
                + [np.full((noff,), g + 1, dtype=np.uint32) for g in range(G_t)]
            )
            x_all = np.vstack([Xcat[t, : n_cat[t]], x_traj[:G_t, t].reshape(-1, n)])
            y_all = np.vstack([Ycat[t, : n_cat[t]], y_traj[:G_t, t].reshape(-1, d)])
            p.optimizer.state = _slice_state(states, t)
            best_x, best_y = (a.detach().cpu().numpy() for a in p.optimizer.population_objectives)
            is_duplicate = get_duplicates(best_x, p.x0, device=dev)
            best_x, best_y = best_x[~is_duplicate], best_y[~is_duplicate]
            D = crowding_distance(torch.as_tensor(best_y)).numpy()
            idxr = D.argsort()[::-1][: p.n_resample]
            obj = p.stats["objective"]
            p.stats.update(
                train_s=p.stats["cost_fit_seconds"], optimize_s=p.stats["cost_ea_seconds"],
                n_generations=G_t, n_train=int(p.X_unit.shape[0]), surrogate="gpr",
                gp_predictor="solve", surrogate_loss=obj["loss"],
                fit_n_steps=obj["n_steps"], fit_early_stopped=obj["early_stopped"],
            )
            results[p.pid] = {
                "x_resample": best_x[idxr, :], "y_pred": best_y[idxr, :],
                "gen_index": gen_index, "x_sm": x_all, "y_sm": y_all,
                "optimizer": p.optimizer, "stats": dict(p.stats),
            }
    if telemetry:
        telemetry.inc("tenant_bucket_epochs_total", bucket=label)
        telemetry.inc("tenants_batched_total", T)
        telemetry.gauge("tenant_bucket_size", T, bucket=label)
        telemetry.observe("phase_duration_seconds", fit_wall, phase="train")
        telemetry.observe("phase_duration_seconds", ea_wall, phase="optimize")
        telemetry.event(
            "tenant_bucket", bucket=label, n_tenants=T,
            n_generations=G_max, train_cap=int(cap),
            fit_s=round(fit_wall, 4), ea_s=round(ea_wall, 4),
            gens_per_sec=(
                round(sum(p.num_generations for p in plans) / ea_wall, 3)
                if ea_wall > 0 else None
            ),
        )
    if logger is not None:
        logger.info(
            f"tenant bucket {label}: {T} tenants, fit "
            f"{fit_wall:.3f}s (cap {cap}), EA {ea_wall:.3f}s ({G_max} gens)"
        )
    return results


def _record_costs(telemetry, plans, label, fit_span, ea_span):
    """Each tenant's share of the bucket's fit and EA walls: the
    ``tenant_cost_seconds`` counter and ``tenant_cost`` child spans that
    tile the bucket's ``gp_fit`` and ``ea_scan`` spans in tenant order
    (``dmosopt_tpu/tenants.py:683-709``; the port has no compile share)."""
    for p in plans:
        for phase in ("fit", "ea"):
            telemetry.inc(
                "tenant_cost_seconds", p.stats[f"cost_{phase}_seconds"],
                tenant=str(p.pid), phase=phase,
            )
    tracer = telemetry.tracer
    if tracer is None:
        return
    for parent, phase in ((fit_span, "fit"), (ea_span, "ea")):
        if parent is None or parent.t_end is None:
            continue
        # the shares sum to walls clocked over a slightly larger interval
        # than the span: clamp so the tiling never overruns its parent
        t_cursor = parent.t_start
        for p in plans:
            share = p.stats[f"cost_{phase}_seconds"]
            t0 = min(t_cursor, parent.t_end)
            t_cursor += share
            tracer.record_span(
                "tenant_cost", t0, min(t_cursor, parent.t_end),
                parent=parent, tenant=str(p.pid), phase=phase,
                bucket=label, seconds=round(share, 6),
            )


# ------------------------------------------------------------ entry point


def initialize_epochs_batched(
    strategies: Dict[Any, Any], epoch, *, min_bucket: int = 2, telemetry=None,
    logger=None, on_error=None,
):
    """Open every strategy's epoch: bucket-mates through `run_bucket_epoch`,
    everyone else through the sequential `initialize_epoch`
    (``dmosopt_tpu/tenants.py:768``).

    ``epoch`` is the epoch index of every strategy, or ``{pid: index}``.
    Pass 1 folds each tenant's completed evaluations (`open_epoch`) and
    decides eligibility and buckets; pass 2, in tenant order, runs the
    sequential tenants' epochs and takes the batched tenants' host draws,
    so the run's shared generator advances as the sequential loop would
    advance it; then each bucket runs and its results are installed.
    Returns ``{pid: "batched" | "sequential" | "failed"}``.

    ``on_error``, a ``callable(pid, exception)``: when given, a tenant
    whose sequential epoch or plan raises, and every tenant of a bucket
    whose run raises, is reported to it and routed ``"failed"`` while the
    others go on; no bucket is re-run on the sequential path. When None
    (the driver's case) the exception propagates. ``telemetry`` goes to
    every bucket and times pass 1 and each batched tenant's plan in
    ``plan`` spans (the latter labelled ``tenant``; a sequential
    tenant's epoch opens its own spans); an ineligible tenant counts in
    ``tenants_sequential_total``."""
    epochs = epoch if isinstance(epoch, dict) else {pid: epoch for pid in strategies}
    sigs: Dict[Any, Optional[Tuple]] = {}
    with span_scope(telemetry, "plan"):
        for pid, strat in strategies.items():
            strat.open_epoch()
            reason = batch_eligibility(strat)
            if reason is None:
                sigs[pid] = bucket_signature(
                    strat, strat.optimizer_name[0], strat.optimizer_kwargs[0]
                )
            else:
                sigs[pid] = None
                if logger is not None:
                    logger.info(f"tenant {pid}: sequential path ({reason})")
                if telemetry:
                    telemetry.inc("tenants_sequential_total")
    counts: Dict[Tuple, int] = {}
    for sig in sigs.values():
        if sig is not None:
            counts[sig] = counts.get(sig, 0) + 1

    buckets: Dict[Tuple, List[_TenantPlan]] = {}
    routing: Dict[Any, str] = {}
    for pid, strat in strategies.items():
        sig = sigs[pid]
        try:
            if sig is None or counts[sig] < min_bucket:
                strat.initialize_epoch(epochs[pid])
                routing[pid] = "sequential"
                continue
            with span_scope(telemetry, "plan", tenant=str(pid)):
                name, okw = strat._cycled_optimizer()
                buckets.setdefault(sig, []).append(_build_plan(pid, strat, name, okw))
            routing[pid] = "batched"
        except Exception as e:
            if on_error is None:
                raise
            if logger is not None:
                logger.exception(f"tenant {pid}: epoch init failed; isolating")
            on_error(pid, e)
            routing[pid] = "failed"

    for sig, plans in buckets.items():
        try:
            results = run_bucket_epoch(plans, telemetry=telemetry, logger=logger)
        except Exception as e:
            if on_error is None:
                raise
            if logger is not None:
                logger.exception(f"bucket {sig[:4]} failed; isolating its tenants")
            for p in plans:
                on_error(p.pid, e)
                routing[p.pid] = "failed"
            continue
        for p in plans:
            p.strat.install_epoch_result(epochs[p.pid], results[p.pid])
    return routing
