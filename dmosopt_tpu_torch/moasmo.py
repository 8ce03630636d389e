"""MO-ASMO epoch engine.

Port of ``dmosopt_tpu/moasmo.py`` (`xinit`, `train`, `optimize` with both
branches, `_optimize_on_device` with termination criteria,
`analyze_sensitivity`, `epoch` with its feasibility and sensitivity
models, `get_best`, `get_feasible`, `epsilon_get_best`,
`get_duplicates`, `remove_duplicates`), after
reference `dmosopt/MOASMO.py`: initial design -> surrogate fit -> inner
EA against the surrogate -> crowding-distance resample selection.

When the objective is the surrogate, the inner loop runs on the
optimizer's device: generate -> surrogate predict -> update, one
generation after another, with the offspring of every generation kept on
the device and copied to the host once at the end (the JAX package
scans the same loop as one XLA program). Only the no-surrogate path
yields to the caller per generation, because there the host evaluates.
A termination criterion is checked on the host every
``termination_check_interval`` generations, as in the JAX package.
Epochs are still driven through the reference's suspended-generator
protocol (MOASMO.py:248,422). `train` takes a per-problem
`SurrogateRefitController` (warm and rank-k refits), builds the
surrogate's predictor inside the timed train phase, and past
``large_n_threshold`` training rows reroutes a dense-kernel surrogate to
``svgp`` (`_route_large_n`). With ``optimize_mean_variance`` the EA ranks
the surrogate's mean and variance, 2·d columns. A
``surrogate_custom_training`` hook (an import path) replaces the
optimizer class and the objective, feasibility and sensitivity models
of an epoch, as in the JAX engine. Its meshes and telemetry are not
ported.
"""

from __future__ import annotations

import inspect
import itertools
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from dmosopt_tpu_torch.config import (
    import_object_by_path,
    default_feasibility_methods,
    default_optimizers,
    default_sa_methods,
    default_sampling_methods,
    default_surrogate_methods,
    resolve,
)
from dmosopt_tpu_torch.datatypes import EpochResults, OptHistory
from dmosopt_tpu_torch.models import Model
from dmosopt_tpu_torch.ops import crowding_distance, sort_mo
from dmosopt_tpu_torch.utils.device import resolve_device
from dmosopt_tpu_torch.utils.prng import as_torch_generator


# ------------------------------------------------------------------ helpers


def get_duplicates(X, Y=None, eps: float = 1e-16, block=None,
                   device=None) -> np.ndarray:
    """Mark rows of X that duplicate a row of X (Y=None) or of Y, with
    reference dmosopt/MOEA.py:426-437 semantics, as the JAX package has
    them (``dmosopt_tpu/moasmo.py:56-72``): the upper triangle of the
    (X, Y) distance matrix, diagonal included, is masked, so row i of X
    meets only rows j < i of Y; NaN distances never match.

    The JAX package forms the dense (N, M) float64 distance matrix and
    its triangle's index arrays; here row blocks of ``block`` rows meet
    only the columns below them, with the same exact float64 differences
    summed over the columns in order, so no (N, M) array exists. The
    blocks run on ``device``, the run's device (an archive of 45 056 rows
    is about 10^9 distances; None means CUDA); the result comes back as a
    numpy bool array."""
    device = resolve_device(device)
    X = torch.as_tensor(np.asarray(X, dtype=np.float64), device=device)
    Y = X if Y is None else torch.as_tensor(np.asarray(Y, dtype=np.float64), device=device)
    nx, ny = X.shape[0], Y.shape[0]
    B = int(block) if block is not None else max(1, (1 << 25) // max(ny, 1))
    dup = torch.zeros(nx, dtype=torch.bool, device=device)
    col = torch.arange(ny, device=device)
    for i0 in range(0, nx, B):
        i1 = min(i0 + B, nx)
        m = min(i1 - 1, ny)  # the block's last row meets columns j < i1 - 1
        if m <= 0:
            continue
        Xi, Yj = X[i0:i1], Y[:m]
        s = torch.zeros((i1 - i0, m), dtype=torch.float64, device=device)
        for k in range(X.shape[1]):
            s += (Xi[:, k, None] - Yj[None, :, k]) ** 2
        row = torch.arange(i0, i1, device=device)[:, None]
        near = (torch.sqrt(s) <= eps) & (col[None, :m] < row)
        dup[i0:i1] = near.any(dim=1)
    return dup.cpu().numpy()


def remove_duplicates(x, y, eps: float = 1e-16, device=None):
    """Drop duplicate parameter rows (reference dmosopt/MOEA.py:439-443)."""
    dup = get_duplicates(x, eps=eps, device=device)
    return x[~dup], y[~dup]


def _feasible_subset(c, *arrays):
    """Subset companion arrays to rows where all constraints are positive;
    when no row is feasible everything passes through unchanged (the
    reference's `len(feasible) > 0` rule, MOASMO.py:501-508).
    Returns (feasible_idx, subset_arrays)."""
    if c is None:
        return None, arrays
    feasible = np.argwhere(np.all(np.asarray(c) > 0.0, axis=1)).ravel()
    if len(feasible) == 0:
        return feasible, arrays
    return feasible, tuple(a[feasible] if a is not None else None for a in arrays)


def _to_np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------- optimize


def _surrogate_eval_fn(mdl: Model):
    """A batch objective on device tensors from the fitted surrogate
    (``dmosopt_tpu/moasmo.py:197-212``): the mean, or with
    ``return_mean_variance`` the (N, 2·d) columns [mean, variance]."""
    obj = mdl.objective

    if mdl.return_mean_variance:

        def eval_fn(x):
            mean, var = obj.predict(x)
            return torch.cat([mean, var], dim=1).to(x.dtype)

    else:

        def eval_fn(x):
            out = obj.evaluate(x)
            out = out[0] if isinstance(out, tuple) else out
            # a float64 surrogate answers in float64; the EA stays in x's dtype
            return out.to(x.dtype)

    return eval_fn


def offspring_per_generation(optimizer) -> int:
    """Offspring batch size of one generation (reference
    ``dmosopt_tpu/moasmo.py:216``). The JAX package reads it off the
    traced shape of a generation; the port's optimizers state it
    (`MOEA.n_offspring`)."""
    return max(1, int(optimizer.n_offspring()))


def _optimize_on_device(
    optimizer,
    eval_fn,
    num_generations: int,
    generator: torch.Generator,
    termination=None,
    termination_check_interval: int = 10,
    logger=None,
    stats: Optional[Dict[str, Any]] = None,
):
    """The inner EA loop on the optimizer's device (reference
    `_optimize_on_device`, ``dmosopt_tpu/moasmo.py:288``, scanned XLA
    programs). Offspring stay on the device until the loop ends.

    Without a criterion and a fixed population the loop runs
    ``num_generations`` generations back to back. With a termination
    criterion, the criterion is the sole stopping rule (the reference
    switches to itertools.count, MOASMO.py:91-93): the host checks it
    every ``termination_check_interval`` generations, handing it a host
    copy of the population. An evaluation budget (`eval_budget()`) caps
    each chunk at the whole generations that fit under it. Under a plain
    `MaximumGenerationTermination` the loop stops at the first check
    past the cap, so it runs ``I * (n_max_gen // I + 1)`` generations,
    as the JAX package's fused scan does. An adaptive population size
    also pauses every interval, so the host can grow the capacity.

    ``stats``, when given, receives the generations run
    (``n_generations``), the criterion's ``stop_reasons``, the number of
    checks, the wall seconds spent in them (``termination_s``) and the
    part of it spent copying the population to the host, which waits
    for the device to finish the queued generations
    (``termination_wait_s``).

    Returns (x_new, y_new, gen_counts): the evaluated offspring flattened
    to (N, cols) numpy plus the per-generation offspring counts."""
    bounds = optimizer.bounds
    lb, ub = bounds[:, 0], bounds[:, 1]
    adaptive = optimizer.adaptive_population_size
    xs, ys, counts = [], [], []

    def run_chunk(n):
        """n generations; returns the offspring they evaluated."""
        state = optimizer.state
        first = len(counts)
        for _ in range(n):
            x_gen, state = optimizer.generate_strategy(generator, state)
            x_gen = torch.clamp(x_gen, lb, ub)
            y_gen = eval_fn(x_gen)
            state = optimizer.update_strategy(state, x_gen, y_gen)
            xs.append(x_gen)
            ys.append(y_gen)
            counts.append(x_gen.shape[0])
        optimizer.state = state
        return sum(counts[first:])

    gen = n_eval = n_checks = 0
    check_s = wait_s = 0.0
    if termination is None and not adaptive:
        run_chunk(num_generations)
        gen = num_generations
    else:
        noff = offspring_per_generation(optimizer)
        eval_budget = None
        if termination is not None:
            eval_budget = getattr(termination, "eval_budget", lambda: None)()

        def terminated():
            nonlocal n_checks, check_s, wait_s
            if termination is None:
                return gen >= num_generations
            t0 = time.perf_counter()
            pop_x, pop_y = optimizer.get_population_strategy(optimizer.state)
            opt = OptHistory(gen, n_eval, _to_np(pop_x), _to_np(pop_y), None)
            t1 = time.perf_counter()
            done = termination.has_terminated(opt)
            n_checks += 1
            check_s += time.perf_counter() - t0
            wait_s += t1 - t0
            return done

        while not terminated():
            n = termination_check_interval
            if termination is None:
                n = min(n, num_generations - gen)
            if eval_budget is not None:
                # the budget is a hard cap: run only whole generations
                # that fit under it; when none fits, stop short of it
                n = min(n, (eval_budget - n_eval) // noff)
                if n <= 0:
                    # no evaluation will reach the cap, so the criterion
                    # cannot trip on its own: attribute the stop to it
                    from dmosopt_tpu_torch.termination import mark_eval_budget_stop

                    mark_eval_budget_stop(termination)
                    if logger is not None:
                        logger.info(
                            f"{optimizer.name}: evaluation budget "
                            f"({eval_budget}) leaves no room for a full "
                            f"generation of {noff}; stopping at {n_eval}"
                        )
                    break
            n_eval += run_chunk(n)
            gen += n
            if adaptive and optimizer.maybe_grow_capacity():
                noff = offspring_per_generation(optimizer)
                if logger is not None:
                    logger.info(
                        f"{optimizer.name}: population capacity grown to "
                        f"{optimizer.capacity}"
                    )
    reasons = getattr(termination, "stop_reasons", lambda: [])()
    if termination is not None and logger is not None:
        logger.info(
            f"{optimizer.name}: stopped at generation {gen}"
            + (f" ({'+'.join(reasons)})" if reasons else "")
        )
    if stats is not None:
        stats.update(
            n_generations=gen, stop_reasons=list(reasons),
            termination_checks=n_checks, termination_s=check_s,
            termination_wait_s=wait_s,
        )
    if not xs:
        n_obj_cols = int(eval_fn(bounds[:, 0][None, :]).shape[1])
        return (
            np.zeros((0, optimizer.nInput), np.float32),
            np.zeros((0, n_obj_cols), np.float32),
            np.zeros((0,), np.int64),
        )
    return (
        _to_np(torch.cat(xs)),
        _to_np(torch.cat(ys)),
        np.asarray(counts, dtype=np.int64),
    )


def optimize(
    num_generations,
    optimizer,
    model: Model,
    nInput: int,
    nOutput: int,
    xlb,
    xub,
    popsize: int = 100,
    initial: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    termination=None,
    termination_check_interval: int = 10,
    local_random=None,
    logger=None,
    optimize_mean_variance: bool = False,
    stats: Optional[Dict[str, Any]] = None,
    **kwargs,
):
    """Inner multi-objective optimization against the (surrogate) model,
    with the reference's generator protocol (dmosopt/MOASMO.py:21-131):
    when `model.objective is None` each generation's candidates are
    yielded and the caller sends back real evaluations; otherwise the loop
    runs on the device and the `EpochResults` arrive via StopIteration.
    A ``termination`` criterion, when given, is the sole stopping rule on
    both branches (`_optimize_on_device`; per generation on the
    real-objective branch, reference ``dmosopt_tpu/moasmo.py:685-700``);
    ``stats`` receives the surrogate branch's loop statistics.

    The numpy stream of ``local_random`` is consumed in the reference's
    order: loop generator, initial design, optimizer state.
    ``optimize_mean_variance`` is the model's business here: its
    ``return_mean_variance`` surrogate answers 2·d columns, which the
    optimizer ranks (`_surrogate_eval_fn`)."""
    generator = as_torch_generator(local_random, optimizer.device)
    bounds = np.column_stack((np.asarray(xlb), np.asarray(xub)))

    x = np.asarray(optimizer.generate_initial(bounds, local_random), dtype=np.float32)
    eval_fn = None
    if model.objective is None:
        y = yield x
        y = np.asarray(y, dtype=np.float32)
    else:
        eval_fn = _surrogate_eval_fn(model)
        y = _to_np(eval_fn(torch.as_tensor(x, device=optimizer.device))).astype(np.float32)

    if initial is not None:
        x_initial, y_initial = initial
        if x_initial is not None:
            x = np.vstack((np.asarray(x_initial, dtype=np.float32), x))
        if y_initial is not None:
            y = np.vstack((np.asarray(y_initial, dtype=np.float32), y))

    optimizer.initialize_strategy(x, y, bounds, local_random, **kwargs)
    if logger is not None:
        logger.info(
            f"{optimizer.name}: optimizer parameters are {repr(optimizer.opt_params)}"
        )

    gen_indexes = [np.zeros((x.shape[0],), dtype=np.uint32)]
    x_new, y_new = [], []

    if model.objective is not None:
        x_dev, y_dev, gen_counts = _optimize_on_device(
            optimizer, eval_fn, num_generations, generator,
            termination=termination,
            termination_check_interval=termination_check_interval,
            logger=logger, stats=stats,
        )
        x_new, y_new = [x_dev], [y_dev]
        gen_indexes.extend(
            np.full((int(c),), i + 1, dtype=np.uint32)
            for i, c in enumerate(gen_counts)
        )
    else:
        it = (
            itertools.count(1)
            if termination is not None
            else range(1, num_generations + 1)
        )
        n_eval = 0
        for i in it:
            if termination is not None:
                pop_x, pop_y = optimizer.population_objectives
                opt = OptHistory(i, n_eval, _to_np(pop_x), _to_np(pop_y), None)
                if termination.has_terminated(opt):
                    break
            if logger is not None:
                logger.info(
                    f"{optimizer.name}: generation {i} of {num_generations}..."
                )
            x_gen_dev, state_gen = optimizer.generate()
            # the host copy goes out for evaluation; the update keeps the
            # device-resident offspring
            x_gen = _to_np(x_gen_dev)
            y_gen = yield x_gen
            y_gen = np.asarray(y_gen, dtype=np.float32)
            optimizer.update(x_gen_dev, y_gen, state_gen)
            n_eval += x_gen.shape[0]
            x_new.append(x_gen)
            y_new.append(y_gen)
            gen_indexes.append(np.full((x_gen.shape[0],), i, dtype=np.uint32))

    gen_index = np.concatenate(gen_indexes)
    x = np.vstack([x] + x_new)
    y = np.vstack([y] + y_new)
    bestx, besty = optimizer.population_objectives
    return EpochResults(_to_np(bestx), _to_np(besty), gen_index, x, y, optimizer)


# -------------------------------------------------------------------- xinit


def xinit(
    nEval: int,
    param_names,
    xlb,
    xub,
    nPrevious: Optional[int] = None,
    method="glp",
    maxiter: int = 5,
    local_random=None,
    logger=None,
):
    """Initial design of `nEval * nInput` points scaled to the bounds
    (reference: dmosopt/MOASMO.py:134-193)."""
    nInput = len(param_names)
    Ninit = nInput * nEval
    xlb = np.asarray(xlb)
    xub = np.asarray(xub)

    if nPrevious is None:
        nPrevious = 0
    if Ninit <= 0 or Ninit <= nPrevious:
        return None

    if isinstance(method, dict):
        # explicit per-parameter sample columns, validated against bounds
        Xinit = np.column_stack([method[k] for k in param_names])
        inside = (Xinit >= xlb) & (Xinit <= xub)
        if not inside.all():
            bad = [param_names[i] for i in np.nonzero(~inside.all(axis=0))[0]]
            raise ValueError(f"xinit: out of bounds values for parameter(s) {bad}")
        return Xinit

    if logger is not None:
        logger.info(f"xinit: generating {Ninit} initial parameters...")

    if callable(method):
        Xinit = method(Ninit, nInput, local_random)
    else:
        fn = resolve(method, default_sampling_methods)
        Xinit = fn(Ninit, nInput, local_random, maxiter=maxiter)

    return np.asarray(Xinit)[nPrevious:, :] * (xub - xlb) + xlb


# -------------------------------------------------------------------- train

# Surrogates that build a dense (N, N) training kernel (``vgp``: an
# inducing set of all N rows). Past ``LARGE_N_THRESHOLD`` training rows
# `train` reroutes these registry names to the sparse variational
# family, whose cost follows the inducing set instead of N, as the JAX
# package does (``dmosopt_tpu/moasmo.py:776-806``).
_DENSE_KERNEL_SURROGATES = {"gpr", "egp", "megp", "mdgp", "mdspp", "vgp"}
LARGE_N_THRESHOLD = 4096


def _route_large_n(surrogate_method_name, n_train, threshold, logger=None):
    """``svgp`` in place of a dense-kernel registry name when the training
    set has more than ``threshold`` rows, else the name as given
    (``dmosopt_tpu/moasmo.py:789-806``). An import path or a class is
    never rerouted; a ``threshold`` of None or 0 turns routing off."""
    if (
        threshold
        and isinstance(surrogate_method_name, str)
        and surrogate_method_name in _DENSE_KERNEL_SURROGATES
        and n_train > threshold
    ):
        if logger is not None:
            logger.info(
                f"train: N={n_train} exceeds the dense-kernel threshold "
                f"({threshold}); routing surrogate "
                f"'{surrogate_method_name}' -> 'svgp'"
            )
        return "svgp"
    return surrogate_method_name


def _sparse_kwargs(cls, kwargs, routed_name, logger=None):
    """The kwargs a rerouted fit keeps: only those that ``cls``'s
    constructor names (the others were tuned for the dense surrogate and
    would vanish into its ``**kwargs``), the dropped ones logged as a
    warning and the kept ones as an info line
    (``dmosopt_tpu/moasmo.py:879-905``)."""
    params = inspect.signature(cls.__init__).parameters
    named = {
        k for k, p in params.items()
        if p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)
    }
    dropped = sorted(k for k in kwargs if k not in named)
    kept = {k: v for k, v in kwargs.items() if k in named}
    if logger is not None and dropped:
        logger.warning(
            f"train: dropping surrogate kwargs not understood by "
            f"'{routed_name}': {dropped}"
        )
    if logger is not None and kept:
        logger.info(
            f"train: forwarding kwargs to '{routed_name}' "
            f"(reinterpreted under the sparse trainer): {sorted(kept)}"
        )
    return kept


def train(
    nInput: int,
    nOutput: int,
    xlb,
    xub,
    Xinit,
    Yinit,
    C,
    surrogate_method_name="gpr",
    surrogate_method_kwargs: Optional[Dict[str, Any]] = None,
    surrogate_return_mean_variance: bool = False,
    logger=None,
    info: Optional[Dict[str, Any]] = None,
    surrogate_refit=None,
    device=None,
):
    """Fit the objective surrogate on feasible, deduplicated data
    (reference: dmosopt/MOASMO.py:473-532; ``dmosopt_tpu/moasmo.py:905-945``).

    ``surrogate_refit`` is a per-problem
    `models.refit.SurrogateRefitController` or None (the plain
    constructor): for the exact-GP family it picks a cold, warm, audit or
    rank-k refit each epoch. The surrogate's predictor (``predictor=``) is
    built before this returns, so its cache build counts in the caller's
    timed train phase. ``info``, when given, receives the training-set
    accounting (``n_train``, ``duplicates_removed``,
    ``feasible_fraction``), the name of the surrogate fitted (``svgp`` on
    a rerouted epoch), the fit's loss and steps, ``refit_path`` and
    ``gp_predictor``. Past ``surrogate_method_kwargs["large_n_threshold"]``
    deduplicated rows (default ``LARGE_N_THRESHOLD``; None or 0 turns it
    off) a dense-kernel name is rerouted to ``svgp`` (`_route_large_n`),
    keeping only the kwargs the sparse constructor names
    (`_sparse_kwargs`: ``dtype`` and the exact-GP knobs go); ``device``
    goes in apart from them. ``surrogate_return_mean_variance`` makes the
    model's ``evaluate`` answer (mean, variance)."""
    x = np.asarray(Xinit).copy()
    y = np.asarray(Yinit).copy()
    n_total = x.shape[0]

    feasible, (x, y) = _feasible_subset(C, x, y)
    if logger is not None:
        if feasible is not None and len(feasible) > 0:
            logger.info(f"Found {len(feasible)} feasible solutions")
        else:
            logger.info(f"Found {len(x)} solutions")
    n_before_dedupe = x.shape[0]
    x, y = remove_duplicates(x, y, device=device)
    if info is not None:
        if feasible is not None:
            info["feasible_fraction"] = (
                round(len(feasible) / n_total, 4) if n_total else 0.0
            )
        info["duplicates_removed"] = int(n_before_dedupe - x.shape[0])

    kwargs = dict(surrogate_method_kwargs or {})
    threshold = kwargs.pop("large_n_threshold", LARGE_N_THRESHOLD)
    routed_name = _route_large_n(surrogate_method_name, len(x), threshold, logger)
    cls = resolve(routed_name, default_surrogate_methods)
    if routed_name != surrogate_method_name:
        kwargs = _sparse_kwargs(cls, kwargs, routed_name, logger)

    def builder(**overrides):
        return cls(
            x, y, nInput, nOutput, xlb, xub, **{**kwargs, **overrides},
            logger=logger,
            return_mean_variance=surrogate_return_mean_variance,
            device=device,
        )

    if surrogate_refit is not None and surrogate_refit.applies(cls):
        sm = surrogate_refit.fit(
            builder, x, y,
            nan=kwargs.get("nan", "remove"),
            top_k=kwargs.get("top_k"),
            info=info,
        )
    else:
        if surrogate_refit is not None:
            surrogate_refit.note_unsupported(cls)
        sm = builder()
    # the predictor's cache (a no-op for "solve"), built inside the timed
    # train phase rather than in the first EA generation
    build = getattr(sm, "build_predictor", None)
    if build is not None:
        build()
    if info is not None:
        if hasattr(sm, "predictor_regime"):
            info["gp_predictor"] = sm.predictor_regime
        info["n_train"] = int(x.shape[0])
        info["surrogate"] = (
            routed_name
            if isinstance(routed_name, str)
            else getattr(routed_name, "__name__", str(routed_name))
        )
        fit_info = getattr(sm, "fit_info", None) or {}
        for src, dst in (
            ("loss", "surrogate_loss"),
            ("n_steps", "fit_n_steps"),
            ("early_stopped", "fit_early_stopped"),
        ):
            if src in fit_info:
                info[dst] = fit_info[src]
    return sm


# -------------------------------------------------------------- sensitivity


def analyze_sensitivity(
    sm,
    xlb, xub,
    param_names, objective_names,
    sensitivity_method_name=None,
    sensitivity_method_kwargs: Optional[Dict[str, Any]] = None,
    di_min: float = 1.0,
    di_max: float = 20.0,
    logger=None,
):
    """Map first-order sensitivity indices of the surrogate to per-gene
    distribution indices (reference: dmosopt/MOASMO.py:535-578;
    ``dmosopt_tpu/moasmo.py:962-996``)."""
    di_mutation = None
    di_crossover = None
    if sensitivity_method_name is not None:
        sens_cls = resolve(sensitivity_method_name, default_sa_methods)
        sens = sens_cls(
            xlb, xub, param_names, objective_names,
            **(sensitivity_method_kwargs or {}),
        )
        sens_results = sens.analyze(sm)
        S1s = np.vstack(
            [sens_results["S1"][objective_name] for objective_name in objective_names]
        )
        S1s = np.nan_to_num(S1s, copy=False)
        S1max = np.max(S1s, axis=0)
        S1nmax = S1max / np.max(S1max)
        di_mutation = np.clip(S1nmax * di_max, di_min, None)
        di_crossover = np.clip(S1nmax * di_max, di_min, None)

    if logger is not None:
        logger.info(f"analyze_sensitivity: di_mutation = {di_mutation}")
        logger.info(f"analyze_sensitivity: di_crossover = {di_crossover}")
    return {"di_mutation": di_mutation, "di_crossover": di_crossover}


def _synchronize(device):
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize()


# -------------------------------------------------------------------- epoch


def epoch(
    num_generations,
    param_names,
    objective_names,
    xlb,
    xub,
    pct,
    Xinit,
    Yinit,
    C,
    pop: int = 100,
    optimizer_name="nsga2",
    optimizer_kwargs: Optional[Dict[str, Any]] = None,
    surrogate_method_name="gpr",
    surrogate_method_kwargs: Optional[Dict[str, Any]] = None,
    sensitivity_method_name=None,
    sensitivity_method_kwargs: Optional[Dict[str, Any]] = None,
    feasibility_method_name=None,
    feasibility_method_kwargs: Optional[Dict[str, Any]] = None,
    surrogate_refit=None,
    surrogate_custom_training=None,
    surrogate_custom_training_kwargs: Optional[Dict[str, Any]] = None,
    optimize_mean_variance: bool = False,
    termination=None,
    local_random=None,
    logger=None,
    file_path=None,
    device=None,
):
    """One MO-ASMO epoch as a host-side generator
    (reference: dmosopt/MOASMO.py:196-470).

    Protocol: if Xinit is None, the first `yield` receives
    `(Xinit, Yinit, C)`. In surrogate mode the epoch then runs on the
    device and the resample dict arrives via StopIteration. In
    no-surrogate mode the generator yields `(x_gen, True)` per generation
    and receives `(_, y_gen, c_gen)`. The result's ``stats`` hold the
    wall seconds of the surrogate fit (``train_s``, the device
    synchronized), the fit's summary (``objective``) and the wall
    seconds of the inner EA (``optimize_s``, over ``n_generations``
    generations) and, with a ``termination`` criterion, the reasons it
    gave (``stop_reasons``), its checks and the wall seconds spent in
    them (`_optimize_on_device`).

    With ``feasibility_method_name`` and constraints ``C`` a feasibility
    model is fitted on all rows (``feasibility_s``, its summary under
    ``feasibility``) and handed to the optimizer, whose survival orders
    each front by its `rank`; a fit that raises on its data is logged
    and the epoch goes on without one, as in the JAX package. With
    ``sensitivity_method_name`` the surrogate's sensitivity indices set
    the optimizer's per-gene ``di_mutation`` and ``di_crossover``
    (``sensitivity_s``, the vectors under ``di_mutation`` and
    ``di_crossover``). ``surrogate_refit`` is the problem's refit
    controller, handed to `train`, whose accounting (``refit_path``,
    ``gp_predictor``, ``n_train``, ...) lands in the stats. With
    ``optimize_mean_variance`` the surrogate answers (mean, variance) and
    the optimizer ranks those 2·d columns; the design's rows enter it
    with zero variances, and the resample's predictions are 2·d wide
    (``dmosopt_tpu/moasmo.py:1057-1065``).

    ``surrogate_custom_training``, an import path, is called as
    ``custom_training(optimizer_cls, Xinit, Yinit, C, xlb, xub,
    file_path, options=options, **surrogate_custom_training_kwargs)``,
    ``options`` holding every method-selection option under its public
    name (the ``*_kwargs`` as dicts) and ``return_mean_variance``; its four
    returns replace the optimizer class and the objective, feasibility
    and sensitivity models (``dmosopt_tpu/moasmo.py:1019-1095``), and the
    steps below fit only what it left None.
    """
    nInput = len(param_names)
    nOutput = len(objective_names)
    N_resample = int(pop * pct)
    xlb = np.asarray(xlb)
    xub = np.asarray(xub)
    stats: Dict[str, Any] = {}

    if Xinit is None:
        Xinit, Yinit, C = yield

    x_0 = np.asarray(Xinit, dtype=np.float32).copy()
    y_0 = np.asarray(Yinit, dtype=np.float32).copy()
    if optimize_mean_variance:
        y_0 = np.column_stack((y_0, np.zeros_like(y_0)))

    optimizer_cls = resolve(optimizer_name, default_optimizers)
    mdl = Model(return_mean_variance=optimize_mean_variance)
    if surrogate_custom_training is not None:
        custom_training = import_object_by_path(surrogate_custom_training)
        # the hook sees every method-selection option under its public name
        options = {
            name: (value if not name.endswith("_kwargs") else (value or {}))
            for name, value in (
                ("optimizer_name", optimizer_name),
                ("optimizer_kwargs", optimizer_kwargs),
                ("surrogate_method_name", surrogate_method_name),
                ("surrogate_method_kwargs", surrogate_method_kwargs),
                ("feasibility_method_name", feasibility_method_name),
                ("feasibility_method_kwargs", feasibility_method_kwargs),
                ("sensitivity_method_name", sensitivity_method_name),
                ("sensitivity_method_kwargs", sensitivity_method_kwargs),
                ("return_mean_variance", optimize_mean_variance),
            )
        }
        optimizer_cls, mdl.objective, mdl.feasibility, mdl.sensitivity = custom_training(
            optimizer_cls, Xinit, Yinit, C, xlb, xub, file_path,
            options=options, **(surrogate_custom_training_kwargs or {}),
        )
    if feasibility_method_name is not None and mdl.feasibility is None and C is not None:
        t0 = time.perf_counter()
        try:
            if logger is not None:
                logger.info("Constructing feasibility model...")
            feasibility_cls = resolve(
                feasibility_method_name, default_feasibility_methods
            )
            mdl.feasibility = feasibility_cls(
                x_0, np.asarray(C), device=device,
                **(feasibility_method_kwargs or {}),
            )
        except Exception as e:
            if logger is not None:
                logger.warning(f"Unable to fit feasibility model: {e}")
        _synchronize(device)
        stats["feasibility_s"] = time.perf_counter() - t0

    if surrogate_method_name is not None and mdl.objective is None:
        t0 = time.perf_counter()
        mdl.objective = train(
            nInput, nOutput, xlb, xub, Xinit, Yinit, C,
            surrogate_method_name=surrogate_method_name,
            surrogate_method_kwargs=surrogate_method_kwargs,
            surrogate_return_mean_variance=optimize_mean_variance,
            logger=logger, info=stats, surrogate_refit=surrogate_refit,
            device=device,
        )
        _synchronize(device)
        stats["train_s"] = time.perf_counter() - t0

    di_dict = {}
    if mdl.sensitivity is not None:
        # a custom-training hook's sensitivity model (``di_dict()``)
        di_dict = mdl.sensitivity.di_dict()
    elif sensitivity_method_name is not None:
        t0 = time.perf_counter()
        di_dict = analyze_sensitivity(
            mdl.objective, xlb, xub, param_names, objective_names,
            sensitivity_method_name=sensitivity_method_name,
            sensitivity_method_kwargs=sensitivity_method_kwargs,
            logger=logger,
        )
        stats["sensitivity_s"] = time.perf_counter() - t0
    stats.update(mdl.get_stats())

    optimizer_kwargs_: Dict[str, Any] = {
        "sampling_method": "slh",
        "mutation_rate": None,
        "nchildren": 1,
    }
    optimizer_kwargs_.update(optimizer_kwargs or {})

    for key in ("di_mutation", "di_crossover"):
        if di_dict.get(key) is not None:
            optimizer_kwargs_[key] = di_dict[key]
            stats[key] = np.asarray(di_dict[key])

    optimizer = optimizer_cls(
        nInput=nInput, nOutput=nOutput, popsize=pop, model=mdl,
        distance_metric=None, optimize_mean_variance=optimize_mean_variance,
        device=device, **optimizer_kwargs_,
    )

    # filter out infeasible solutions before seeding the optimizer
    _, (x_0, y_0) = _feasible_subset(C, x_0, y_0)

    # in evaluation mode the generator suspends while the driver
    # evaluates each generation; that time is excluded from optimize_s
    t_opt0 = time.perf_counter()
    t_suspended = 0.0
    opt_gen = optimize(
        num_generations, optimizer, mdl, nInput, nOutput, xlb, xub,
        initial=(x_0, y_0), popsize=pop, local_random=local_random,
        termination=termination, logger=logger, stats=stats,
        optimize_mean_variance=optimize_mean_variance,
        **optimizer_kwargs_,
    )
    try:
        x_gen = next(opt_gen)
    except StopIteration as ex:
        res = ex.value
    else:
        while True:
            t_yield0 = time.perf_counter()
            _, y_gen, _c_gen = yield x_gen, True
            t_suspended += time.perf_counter() - t_yield0
            try:
                x_gen = opt_gen.send(y_gen)
            except StopIteration as ex:
                res = ex.value
                break
    stats["optimize_s"] = time.perf_counter() - t_opt0 - t_suspended
    stats["n_generations"] = int(res.gen_index.max()) if len(res.gen_index) else 0
    if termination is not None:
        stats["stop_reasons"] = list(termination.stop_reasons())

    best_x, best_y = res.best_x, res.best_y
    gen_index, x, y = res.gen_index, res.x, res.y

    if mdl.objective is not None:
        # dedupe resample candidates against already-evaluated points
        # (reference MOASMO.py:441-448)
        is_duplicate = get_duplicates(best_x, x_0, device=device)
        best_x = best_x[~is_duplicate]
        best_y = best_y[~is_duplicate]
        D = _to_np(crowding_distance(torch.as_tensor(best_y)))
        idxr = D.argsort()[::-1][:N_resample]
        return {
            "x_resample": best_x[idxr, :], "y_pred": best_y[idxr, :],
            "gen_index": gen_index, "x_sm": x, "y_sm": y,
            "optimizer": optimizer, "stats": stats,
        }
    return {
        "best_x": best_x, "best_y": best_y, "gen_index": gen_index,
        "x": x, "y": y, "optimizer": optimizer, "stats": stats,
    }


# ----------------------------------------------------------------- analysis


def get_best(
    x, y, f, c,
    nInput: int,
    nOutput: int,
    epochs=None,
    feasible: bool = True,
    return_perm: bool = False,
    return_feasible: bool = False,
    delete_duplicates: bool = True,
    device=None,
):
    """Extract the non-dominated (rank-0) subset of evaluated points
    (reference: dmosopt/MOASMO.py:581-639): numpy in and out, the dedupe
    and the sort on ``device`` (None means CUDA)."""
    device = resolve_device(device)
    xtmp = np.asarray(x)
    ytmp = np.asarray(y)
    f = np.asarray(f) if f is not None else None
    c = np.asarray(c) if c is not None else None
    epochs = np.asarray(epochs) if epochs is not None else None
    feasible_idx = None

    if feasible and c is not None:
        feasible_idx, (xtmp, ytmp, f, epochs, c) = _feasible_subset(
            c, xtmp, ytmp, f, epochs, c
        )

    if delete_duplicates:
        keep = ~get_duplicates(ytmp, device=device)
        xtmp, ytmp = xtmp[keep], ytmp[keep]
        f = np.asarray(f)[keep] if f is not None else None
        c = np.asarray(c)[keep] if c is not None else None
        epochs = np.asarray(epochs)[keep] if epochs is not None else None

    xs, ys, rank, _, perm = sort_mo(
        torch.as_tensor(xtmp, device=device), torch.as_tensor(ytmp, device=device)
    )
    xs, ys, rank, perm = _to_np(xs), _to_np(ys), _to_np(rank), _to_np(perm)
    idxp = rank == 0
    best_x = xs[idxp, :]
    best_y = ys[idxp, :]
    best_f = np.asarray(f)[perm][idxp] if f is not None else None
    best_c = np.asarray(c)[perm, :][idxp, :] if c is not None else None
    best_epoch = np.asarray(epochs)[perm][idxp] if epochs is not None else None

    out_perm = perm if return_perm else None
    if return_feasible:
        return best_x, best_y, best_f, best_c, best_epoch, out_perm, feasible_idx
    return best_x, best_y, best_f, best_c, best_epoch, out_perm



def get_feasible(x, y, f, c, nInput: int, nOutput: int, epochs=None, device=None):
    """Group evaluated points by (rank, epoch) over the feasible subset
    (reference: dmosopt/MOASMO.py:642-700; ``dmosopt_tpu/moasmo.py:1324``):
    numpy in and out, the sort on ``device`` (None means CUDA)."""
    device = resolve_device(device)
    xtmp = np.asarray(x).copy()
    ytmp = np.asarray(y).copy()
    f = np.asarray(f) if f is not None else None
    c = np.asarray(c) if c is not None else None
    epochs = np.asarray(epochs) if epochs is not None else None

    feasible, (xtmp, ytmp, f, epochs, c) = _feasible_subset(
        c, xtmp, ytmp, f, epochs, c
    )

    perm_x, perm_y, rank, _, perm = sort_mo(
        torch.as_tensor(xtmp, device=device), torch.as_tensor(ytmp, device=device)
    )
    perm_x, perm_y, rank, perm = _to_np(perm_x), _to_np(perm_y), _to_np(rank), _to_np(perm)
    perm_f = f[perm] if f is not None else None
    perm_epoch = epochs[perm] if epochs is not None else None

    uniq_rank, rnk_inv, rnk_cnt = np.unique(
        rank, return_inverse=True, return_counts=True
    )
    rank_idx = np.empty((len(uniq_rank),), dtype=object)
    for i in range(len(uniq_rank)):
        rank_idx[i] = np.flatnonzero(rnk_inv == i)

    if perm_epoch is not None:
        uniq_epc, epc_inv, epc_cnt = np.unique(
            perm_epoch, return_inverse=True, return_counts=True
        )
    else:
        uniq_epc = np.zeros((1,), dtype=np.int64)
        epc_inv = np.zeros((len(rank),), dtype=np.int64)
        epc_cnt = np.array([len(rank)])
    epc_idx = np.empty((len(uniq_epc),), dtype=object)
    for i in range(len(uniq_epc)):
        epc_idx[i] = np.flatnonzero(epc_inv == i)

    rnk_epc_idx = np.empty((len(uniq_rank), len(uniq_epc)), dtype=object)
    for i in range(len(uniq_rank)):
        for j in range(len(uniq_epc)):
            rnk_epc_idx[i, j] = np.intersect1d(
                rank_idx[i], epc_idx[j], assume_unique=True
            )

    perm_arrs = (perm_x, perm_y, perm_f, perm_epoch, perm, feasible)
    rnk_arrs = (uniq_rank, rank_idx, rnk_cnt)
    epc_arrs = (uniq_epc, epc_idx, epc_cnt)
    return perm_arrs, rnk_arrs, epc_arrs, rnk_epc_idx


def epsilon_get_best(
    x,
    y,
    f,
    c,
    feasible: bool = True,
    delete_duplicates: bool = True,
    epsilons=None,
    device=None,
):
    """Epsilon-box non-dominated subset (reference: dmosopt/MOASMO.py:703-758;
    ``dmosopt_tpu/moasmo.py:1380``), numpy on the host as in the JAX
    package, the dedupe on ``device`` (None means CUDA): points are
    quantized to epsilon boxes, box-level Pareto dominance is one
    pairwise comparison, and a surviving box keeps the point closest to
    its corner."""
    x = np.asarray(x)
    y = np.asarray(y)
    f = np.asarray(f) if f is not None else None
    c = np.asarray(c) if c is not None else None

    if feasible and c is not None:
        _, (x, y, f, c) = _feasible_subset(c, x, y, f, c)

    if delete_duplicates:
        dup = get_duplicates(y, device=device)
        x, y = x[~dup], y[~dup]
        if f is not None:
            f = f[~dup]
        if c is not None:
            c = c[~dup]

    if epsilons is None:
        eps = np.full((y.shape[1],), 1e-9)
    elif isinstance(epsilons, str) and epsilons == "auto":
        from scipy import stats as _sstats

        eps = 0.05 * _sstats.iqr(y, axis=0)
    elif isinstance(epsilons, (int, float)):
        eps = np.full((y.shape[1],), float(epsilons))
    else:
        eps = np.asarray(epsilons, dtype=float)
    eps = np.where((eps == 0) | np.isnan(eps), 1e-8, eps)

    if y.shape[0] == 0:
        return x, y, f, c, eps

    yn = np.nan_to_num(y)
    boxes = np.floor(yn / eps)  # (N, d) epsilon-box coordinates

    # collapse to unique boxes, then Pareto-compare boxes: box b dominates
    # b' if <= in all coordinates and < in at least one
    uniq, inv = np.unique(boxes, axis=0, return_inverse=True)  # (B, d)
    inv = inv.reshape(-1)
    le = np.all(uniq[:, None, :] <= uniq[None, :, :], axis=2)
    lt = np.any(uniq[:, None, :] < uniq[None, :, :], axis=2)
    box_keep = ~np.any(le & lt, axis=0)  # (B,)

    # representative per surviving box: the point closest to the box
    # corner, lowest index breaking ties (archive-insertion semantics)
    corner_dist = np.sum((yn - boxes * eps) ** 2, axis=1)
    order = np.lexsort((np.arange(len(yn)), corner_dist))
    _, first = np.unique(inv[order], return_index=True)
    rep = order[first]  # representative point index per unique box
    m = np.sort(rep[box_keep[inv[rep]]])
    best_f = f[m] if f is not None else None
    best_c = c[m] if c is not None else None
    return x[m], y[m], best_f, best_c, eps
