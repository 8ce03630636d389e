"""Top-level driver: `run()`, `dopt_init` and `DistOptimizer`.

Port of ``dmosopt_tpu/driver.py`` (reference dmosopt/dmosopt.py:546-2571)
on this slice's path: one problem, the serial epoch pipeline, no
telemetry, no persistence. Evaluation goes to the inline host-function
evaluator, or, with ``torch_objective=True``, to one call of a batched
torch objective per round of requests on the run's device. ``device``
None means CUDA; a machine without one raises unless the caller passes
``device="cpu"``. The driver options of the JAX package that this port
does not carry yet (persistence and resume, multiple problems,
features, thread pools and pipelines, meshes, telemetry, termination
criteria, dynamic initial sampling, the other optimizers and
surrogates) raise `NotImplementedError` instead of being ignored.
"""

from __future__ import annotations

import logging
import time
from functools import partial
from typing import Dict

import numpy as np
import torch

from dmosopt_tpu_torch.config import as_tuple as _as_tuple, import_object_by_path
from dmosopt_tpu_torch.datatypes import (
    OptProblem,
    ParameterSpace,
    StrategyState,
    update_nested_dict,
)
from dmosopt_tpu_torch.parallel.evaluator import HostFunEvaluator, TorchBatchEvaluator
from dmosopt_tpu_torch.strategy import DistOptStrategy
from dmosopt_tpu_torch.utils.device import resolve_device
from dmosopt_tpu_torch.utils.prng import as_generator

logger = logging.getLogger(__name__)

dopt_dict: Dict[str, "DistOptimizer"] = {}


def _merge_eval_params(pp, param_space, vals, nested):
    """Combine the fixed problem parameters `pp` with one sampled point
    `vals` into the dict handed to the user's objective."""
    if nested:
        base = pp.unflatten() if pp is not None else {}
        return update_nested_dict(base, param_space.unflatten(vals))
    fixed = (
        {}
        if pp is None
        else {it.name: int(it.value) if it.is_integer else it.value for it in pp.items}
    )
    return {**fixed, **dict(zip(param_space.parameter_names, vals))}


def eval_obj_fun_sp(
    obj_fun, pp, param_space, nested_parameter_space, obj_fun_args, problem_id,
    space_vals,
):
    """Single-problem objective evaluation
    (reference: dmosopt/dmosopt.py:2327-2363)."""
    merged = _merge_eval_params(
        pp, param_space, space_vals[problem_id], nested_parameter_space
    )
    started = time.time()
    result = obj_fun(merged, *(obj_fun_args or ()))
    return {problem_id: result, "time": time.time() - started}


# driver options of the JAX package that are not ported, with the value
# that means "not used"
_UNPORTED_DEFAULTS = {
    "problem_ids": None, "feature_dtypes": None, "feature_class": None,
    "dynamic_initial_sampling": None, "termination_conditions": None,
    "surrogate_custom_training": None, "optimize_mean_variance": False,
    "sensitivity_method_name": None, "feasibility_method_name": None,
    "file_path": None, "save": False, "jax_objective": False,
    "evaluator": None, "n_eval_workers": 1, "mesh": None,
    "tenant_batching": False,
}


def _is_default(value, default) -> bool:
    return value is default or (type(value) is type(default) and value == default)


class DistOptimizer:
    def __init__(
        self,
        opt_id,
        obj_fun,
        *,
        space=None, nested_parameter_space=False, problem_parameters=None,
        objective_names=None, constraint_names=None,
        obj_fun_args=None, reduce_fun=None, reduce_fun_args=None,
        n_epochs=10, population_size=100, num_generations=200,
        resample_fraction=0.25,
        n_initial=10, initial_method="slh", initial_maxiter=5,
        distance_metric=None, time_limit=None,
        optimizer_name="nsga2", optimizer_kwargs=None,
        surrogate_method_name="gpr", surrogate_method_kwargs=None,
        surrogate_refit=None, pipeline=None, telemetry=None,
        random_seed=None, local_random=None,
        torch_objective=False, device=None,
        verbose=False,
        **kwargs,
    ) -> None:
        """MO-ASMO optimization driver (reference dmosopt/dmosopt.py:546-630).

        torch_objective: `obj_fun` maps a (B, n) float32 tensor of flat
          parameter vectors on ``device`` to objectives (B, d); each round
          of requests is one call.
        device: where the surrogate, the inner EA and a torch objective
          run; None means CUDA (and raises without one).
        """
        bad = sorted(
            k for k, default in _UNPORTED_DEFAULTS.items()
            if k in kwargs and not _is_default(kwargs[k], default)
        )
        if surrogate_refit not in (None, "cold"):
            bad.append("surrogate_refit")
        if pipeline not in (None, "serial"):
            bad.append("pipeline")
        if telemetry not in (None, False):
            bad.append("telemetry")
        if torch_objective and constraint_names is not None:
            bad.append("constraint_names with torch_objective")
        if bad:
            raise NotImplementedError(
                f"DistOptimizer options not ported to dmosopt_tpu_torch: {bad}"
            )
        if random_seed is not None:
            if local_random is not None:
                raise RuntimeError("pass either random_seed or local_random, not both")
            local_random = np.random.default_rng(seed=random_seed)
        if local_random is None:
            local_random = as_generator(random_seed)
        if space is None or problem_parameters is None:
            raise ValueError(
                "no problem definition: pass `space` and `problem_parameters`"
            )
        if objective_names is None:
            raise ValueError("objective_names is required")

        self.device = resolve_device(device)
        self.__dict__.update(
            opt_id=opt_id, verbose=verbose,
            population_size=population_size, num_generations=num_generations,
            distance_metric=distance_metric,
            surrogate_method_name=surrogate_method_name,
            local_random=local_random, random_seed=random_seed,
            time_limit=time_limit, n_initial=n_initial,
            initial_maxiter=initial_maxiter, initial_method=initial_method,
            n_epochs=n_epochs, obj_fun_args=obj_fun_args,
            reduce_fun=reduce_fun, reduce_fun_args=reduce_fun_args,
            constraint_names=constraint_names, objective_names=objective_names,
        )
        self.resample_fraction = min(float(resample_fraction), 1.0)
        self.surrogate_method_kwargs = surrogate_method_kwargs or {}
        self.optimizer_name = _as_tuple(optimizer_name)
        self.optimizer_kwargs = _as_tuple(
            optimizer_kwargs
            if optimizer_kwargs is not None
            else {"mutation_prob": 0.1, "crossover_prob": 0.9}
        )
        self.start_time = time.time()
        self.logger = logging.getLogger(opt_id)
        if self.verbose:
            self.logger.setLevel(logging.INFO)

        param_space = ParameterSpace.from_dict(space)
        if param_space.n_parameters == 0:
            raise ValueError("empty parameter space")
        problem_parameters = ParameterSpace.from_dict(
            problem_parameters, is_value_only=True
        )
        if not set(param_space.parameter_names).isdisjoint(
            problem_parameters.parameter_names
        ):
            raise ValueError(
                "problem_parameters and space must not share parameter names"
            )
        self.param_space = param_space
        self.param_names = param_space.parameter_names
        self.problem_parameters = problem_parameters
        for okw in self.optimizer_kwargs:
            # per-parameter distribution indices may come as nested dicts
            for di_key in ("di_crossover", "di_mutation"):
                if okw and isinstance(okw.get(di_key), dict):
                    okw[di_key] = param_space.flatten(okw[di_key])

        self.epoch_count = self.eval_count = 0
        self.optimizer_dict = {}
        self.epoch_stats = []  # per-epoch wall time and strategy stats

        self.eval_fun = partial(
            eval_obj_fun_sp, obj_fun, self.problem_parameters, self.param_space,
            nested_parameter_space, self.obj_fun_args, 0,
        )
        self.evaluator = (
            TorchBatchEvaluator(obj_fun, self.device)
            if torch_objective
            else HostFunEvaluator(self.eval_fun)
        )

    # ----------------------------------------------------- strategy setup

    def initialize_strategy(self):
        opt_prob = OptProblem(
            self.param_names, self.objective_names, self.constraint_names,
            self.param_space,
        )
        self.optimizer_dict[0] = DistOptStrategy(
            opt_prob, n_initial=self.n_initial,
            initial_method=self.initial_method,
            initial_maxiter=self.initial_maxiter,
            population_size=self.population_size,
            num_generations=self.num_generations,
            resample_fraction=self.resample_fraction,
            distance_metric=self.distance_metric,
            optimizer_name=self.optimizer_name,
            optimizer_kwargs=self.optimizer_kwargs,
            surrogate_method_name=self.surrogate_method_name,
            surrogate_method_kwargs=self.surrogate_method_kwargs,
            local_random=self.local_random, logger=self.logger,
            device=self.device,
        )

    # ------------------------------------------------------------ queries

    def get_best(self, feasible=True, return_constraints=False):
        """Current best (non-dominated) evaluations, as (name, column)
        pair lists, optionally with the named constraint columns."""

        def named_columns(names, arr):
            return None if arr is None else list(zip(names, list(arr.T)))

        bx, by, bc = self.optimizer_dict[0].get_best_evals(feasible=feasible)
        result = [
            named_columns(self.param_names, bx),
            named_columns(self.objective_names, by),
        ]
        if return_constraints:
            result.append(
                named_columns(self.constraint_names, bc)
                if self.constraint_names is not None
                else None
            )
        return tuple(result)

    def print_best(self, feasible=True):
        prms, res, *_ = self.get_best(feasible=feasible)
        if res is None:
            return
        prms_dict, res_dict = dict(prms), dict(res)
        n_res = next(iter(res_dict.values())).shape[0]
        for i in range(n_res):
            res_i = {k: res_dict[k][i] for k in res_dict}
            prms_i = {k: prms_dict[k][i] for k in prms_dict}
            self.logger.info(f"Best eval {i} so far: {res_i}@{prms_i}")

    # ---------------------------------------------------------- epoch loop

    def _time_exceeded(self) -> bool:
        return (
            self.time_limit is not None
            and (time.time() - self.start_time) >= self.time_limit
        )

    def _gather_rounds(self):
        """Pop every pending request into evaluation rounds."""
        task_args, task_reqs = [], []
        strat = self.optimizer_dict[0]
        while True:
            req = strat.get_next_request()
            if req is None:
                break
            task_args.append({0: req.parameters})
            task_reqs.append({0: req})
        return task_args, task_reqs

    def _fold_round(self, res, round_reqs):
        """Fold one completed evaluation round into the strategy."""
        if self.reduce_fun is not None:
            res = (
                self.reduce_fun(res)
                if self.reduce_fun_args is None
                else self.reduce_fun(res, *self.reduce_fun_args)
            )
        t = res.pop("time", -1.0)
        for problem_id, rres in res.items():
            eval_req = round_reqs[problem_id]
            c = None
            if self.constraint_names is not None:
                rres, c = rres[0], rres[1]
            self.optimizer_dict[problem_id].complete_request(
                eval_req.parameters, np.asarray(rres), pred=eval_req.prediction,
                epoch=eval_req.epoch, time=t, c=c,
            )
            if self.verbose:
                prms = list(zip(self.param_names, list(eval_req.parameters.T)))
                lres = list(zip(self.objective_names, np.asarray(rres).T))
                self.logger.info(
                    f"optimization epoch {eval_req.epoch}: parameters {prms}: {lres}"
                )
        self.eval_count += 1

    def _process_requests(self):
        """Drain pending evaluation requests through the evaluator, one
        blocking batch at a time (the serial pipeline)."""
        while self.optimizer_dict[0].has_requests() and not self._time_exceeded():
            task_args, task_reqs = self._gather_rounds()
            if not task_args:
                break
            results = self.evaluator.evaluate_batch(task_args)
            for res, round_reqs in zip(results, task_reqs):
                self._fold_round(res, round_reqs)
        return self.eval_count

    def run_epoch(self, completed_epoch: bool = False):
        """One full epoch: drain the pending requests, then run the epoch
        state machine to completion (reference dmosopt.py:1341-1470)."""
        epoch = self.epoch_count
        advance_epoch = (self.epoch_count + 1) < self.n_epochs
        strat = self.optimizer_dict[0]
        t0 = time.perf_counter()
        self._process_requests()
        strat.initialize_epoch(epoch)
        done = completed_epoch
        while not done:
            if self._time_exceeded():
                self.logger.warning("time limit exceeded; stopping epoch")
                break
            self._process_requests()
            state, _res, _completed = strat.update_epoch(resample=advance_epoch)
            done = state == StrategyState.CompletedEpoch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.epoch_stats.append(
            {"epoch": epoch, "epoch_s": time.perf_counter() - t0, **strat.stats}
        )
        self.epoch_count += 1
        return self.epoch_count


# -------------------------------------------------------------------- run


def _resolve_objective(params):
    """The objective arrives as a callable (`obj_fun`), an import path
    (`obj_fun_name`), or a factory path plus kwargs (`obj_fun_init_name`
    / `obj_fun_init_args`); the first present wins."""
    fn = params.pop("obj_fun", None)
    path = params.pop("obj_fun_name", None)
    factory_path = params.pop("obj_fun_init_name", None)
    factory_args = params.pop("obj_fun_init_args", None) or {}
    if fn is not None:
        return fn
    if path is not None:
        return import_object_by_path(path)
    if factory_path is not None:
        return import_object_by_path(factory_path)(**factory_args, worker=None)
    raise RuntimeError("dmosopt_tpu_torch.dopt_init: objfun is not provided")


def dopt_init(dopt_params, verbose=False, initialize_strategy=False):
    """Build a DistOptimizer from a parameter dict (reference
    dmosopt/dmosopt.py:2416-2465) and register it in `dopt_dict`."""
    dopt_params = dict(dopt_params)
    dopt_params["obj_fun"] = _resolve_objective(dopt_params)
    reducefun_name = dopt_params.pop("reduce_fun_name", None)
    if reducefun_name is not None:
        dopt_params["reduce_fun"] = import_object_by_path(reducefun_name)
    ctrl_path = dopt_params.pop("controller_init_fun_name", None)
    ctrl_args = dopt_params.pop("controller_init_fun_args", {})
    if ctrl_path is not None:
        import_object_by_path(ctrl_path)(**ctrl_args)
    dopt = DistOptimizer(**dopt_params, verbose=verbose)
    if initialize_strategy:
        dopt.initialize_strategy()
    dopt_dict[dopt.opt_id] = dopt
    return dopt


def run(
    dopt_params, time_limit=None, feasible=True, return_constraints=False,
    verbose=True, device=None, **kwargs,
):
    """Run a complete MO-ASMO optimization (reference
    dmosopt/dmosopt.py:2501-2571) and return the best evaluations.
    ``device`` (or ``dopt_params["device"]``) None means CUDA."""
    dopt_params = dict(dopt_params)
    if time_limit is not None:
        dopt_params["time_limit"] = time_limit
    if device is not None:
        dopt_params["device"] = device
    dopt = dopt_init(dopt_params, verbose=verbose, initialize_strategy=True)
    dopt.logger.info(f"Optimizing for {dopt.n_epochs} epochs...")
    if dopt.n_epochs <= 0:
        dopt.run_epoch(completed_epoch=True)
    else:
        while dopt.epoch_count < dopt.n_epochs and not dopt._time_exceeded():
            dopt.run_epoch()
    dopt.print_best()
    return dopt.get_best(feasible=feasible, return_constraints=return_constraints)
