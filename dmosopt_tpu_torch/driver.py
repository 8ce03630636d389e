"""Top-level driver: `run()`, `dopt_init` and `DistOptimizer`.

Port of ``dmosopt_tpu/driver.py`` (reference dmosopt/dmosopt.py:546-2571):
the epoch loop, the HDF5 store (save
every ``save_eval`` evaluations, the surrogate's evaluations, optimizer
parameters and stats per epoch) and resuming from it, and the three
pipeline modes (``serial``, ``overlap_io``, the default, and
``speculative``) with per-request timeouts, retries and failure
policies. Evaluation goes to the host-function evaluator, inline or on
a thread pool of ``n_eval_workers``, or, with ``torch_objective=True``,
to a batched torch objective on the run's device. ``device`` None means
CUDA; a machine without one raises unless the caller passes
``device="cpu"``.

``termination_conditions`` (a dict of `create_adaptive_termination`
options, a callable of the problem, or True) stops each epoch's inner
EA as the JAX package's does. Constraints (an objective returning
``(y, c)``, host or batched torch) feed the feasibility model named by
``feasibility_method_name``; ``sensitivity_method_name`` sets the
optimizer's per-gene distribution indices each epoch; a
``dynamic_initial_sampling`` hook (an import path) adds evaluation
rounds to the initial design until it returns None.
``surrogate_refit`` ("cold", "warm", or a dict of
`SurrogateRefitConfig` options) reuses the surrogate across epochs;
with ``save`` its warm state goes into the store after every epoch, in
the JAX package's format, and a resumed run starts from it.
``optimize_mean_variance`` makes the inner EA rank the surrogate's mean
and variance, with 2·d prediction columns in the archive and the store.
Each epoch after the first logs the surrogate's error on the rows it
resampled (`_log_surrogate_accuracy`, kept in ``epoch_stats``).

Several problems (``problem_ids``) get one strategy, one archive and
one store group each; every evaluation round holds one request per
problem, and a host objective then takes a dict of each problem's
parameters (`eval_obj_fun_mp`). ``feature_dtypes`` (or a
``feature_class`` import path) names the features an objective
returns beside its objectives; the archive and the store keep them as
float64 columns, and `get_best` / `run(return_features=True)` hand
each problem's best set back with its feature records. A
``surrogate_custom_training`` hook replaces each epoch's models, and an
external ``evaluator`` is used as given and never closed by `run()`.
With ``tenant_batching`` the problems of one bucket (same optimizer,
shapes and fit configuration) advance through one batched GP fit and
one generation loop over stacked NSGA-II states, one offspring launch
a generation for the whole bucket (`tenants.initialize_epochs_batched`);
buckets smaller than ``min_tenant_bucket`` take the sequential path.

Telemetry is on by default, as in the JAX package: ``telemetry`` None
or True builds a live `telemetry.Telemetry` and a `HealthEngine`, False
holds none (the run makes no telemetry call), a dict is `Telemetry`
keyword arguments and an instance passes through (`run()` closes only
one it built). Each epoch runs in an ``epoch`` span beside the
evaluation spans (``eval_dispatch``, ``eval_drain``) and the store's
(``h5_write``), refreshes the device memory gauges, and with
``profile_dir`` and ``profile_epochs`` runs under a ``torch.profiler``
capture joined into the device ledger; at its end the health rules are
evaluated and, with ``save``, the epoch's summary, spans and alert
transitions go into the store's ``telemetry``, ``telemetry_spans`` and
``telemetry_alerts`` groups in the JAX package's schema. The driver
options of the JAX package that this port does not carry raise
`NotImplementedError` instead of being ignored: ``jax_objective``.

With a ``mesh`` (`parallel.mesh`) the run is one process per device,
every rank running this same driver with the same seeds: the inner EA's
survival ranks, the surrogate's predicts and a torch objective's batch
rows split over the mesh's first axis, the GP fit's restarts over a
``"model"`` axis. Rank 0 decides whether to resume and broadcasts the
decision, every rank reads the store before any writes it (a barrier),
and only rank 0 writes (`parallel.mesh.is_primary_process`).
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import os
import time
from functools import partial
from typing import Dict

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from dmosopt_tpu_torch import moasmo as opt
from dmosopt_tpu_torch import storage
from dmosopt_tpu_torch.config import as_tuple as _as_tuple, import_object_by_path
from dmosopt_tpu_torch.datatypes import (
    EvalRequest,
    OptProblem,
    ParameterSpace,
    StrategyState,
    update_nested_dict,
)
from dmosopt_tpu_torch.ops.variation import KERNEL_LAUNCHES
from dmosopt_tpu_torch.parallel.evaluator import (
    EvalFailure,
    HostFunEvaluator,
    TorchBatchEvaluator,
)
from dmosopt_tpu_torch.models.gp_sharded import set_gp_shard_telemetry
from dmosopt_tpu_torch.models.predictor import set_predictor_telemetry
from dmosopt_tpu_torch.ops.dominance import set_rank_telemetry
from dmosopt_tpu_torch.parallel.mesh import is_primary_process, process_count
from dmosopt_tpu_torch.parallel.pipeline import BackgroundWriter, PipelineConfig
from dmosopt_tpu_torch.strategy import DistOptStrategy
from dmosopt_tpu_torch.telemetry import (
    HealthEngine,
    Telemetry,
    create_telemetry,
    record_device_memory,
    span_scope,
)
from dmosopt_tpu_torch.utils.device import resolve_device
from dmosopt_tpu_torch.utils.profiling import eval_time_stats
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


def eval_obj_fun_mp(
    obj_fun, pp, param_space, nested_parameter_space, obj_fun_args, problem_ids,
    space_vals,
):
    """Multi-problem objective evaluation (reference
    dmosopt/dmosopt.py:2366-2409; ``dmosopt_tpu/driver.py:116-131``): one
    call with every problem's parameters present in ``space_vals`` (a
    subset of ``problem_ids`` when the problems' queues differ in length)."""
    mpp = {
        pid: _merge_eval_params(pp, param_space, vals, nested_parameter_space)
        for pid, vals in space_vals.items()
    }
    started = time.time()
    results = obj_fun(mpp, *(obj_fun_args or ()))
    results["time"] = time.time() - started
    return results


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


def _to_records(dt, numeric, F):
    """Flat float feature columns as structured records of ``dt``; records
    already, or features of a non-numeric spec (kept raw in the archive),
    pass as they are."""
    if F is None:
        return None
    F = np.asarray(F)
    if F.dtype.names or not numeric:
        return F
    from numpy.lib.recfunctions import unstructured_to_structured

    return unstructured_to_structured(np.asarray(F, np.float64), dtype=dt)


class _InflightBatch:
    """One asynchronously submitted evaluation batch mid-collection.

    Results arrive in completion order, buffer here and fold in
    submission order (``next_fold`` is the first round not yet folded),
    so the archive's row order does not depend on which call finished
    first. ``blocked`` is the wall time the driver spent waiting in
    ``poll``; the rest of the handle's life overlapped driver work."""

    __slots__ = ("handle", "task_reqs", "buffered", "next_fold", "blocked")

    def __init__(self, handle, task_reqs):
        self.handle = handle
        self.task_reqs = task_reqs
        self.buffered = {}
        self.next_fold = 0
        self.blocked = 0.0

    @property
    def total(self) -> int:
        return len(self.task_reqs)


# driver options of the JAX package that are not ported, with the value
# that means "not used"
_UNPORTED_DEFAULTS = {"jax_objective": False}
# keyword arguments of the reference's distwq `run()` that the JAX
# package's `run()` accepts and ignores (dmosopt_tpu/driver.py:1600-1602)
_LEGACY_RUN_KWARGS = ("spawn_workers", "nprocs_per_worker")


def _is_default(value, default) -> bool:
    return value is default or (type(value) is type(default) and value == default)


class DistOptimizer:
    def __init__(
        self,
        opt_id,
        obj_fun,
        *,
        space=None, nested_parameter_space=False, problem_parameters=None,
        problem_ids=None, objective_names=None, constraint_names=None,
        feature_dtypes=None, feature_class=None,
        obj_fun_args=None, reduce_fun=None, reduce_fun_args=None,
        n_epochs=10, population_size=100, num_generations=200,
        resample_fraction=0.25,
        n_initial=10, initial_method="slh", initial_maxiter=5,
        distance_metric=None, termination_conditions=None, time_limit=None,
        optimizer_name="nsga2", optimizer_kwargs=None,
        surrogate_method_name="gpr", surrogate_method_kwargs=None,
        sensitivity_method_name=None, sensitivity_method_kwargs=None,
        feasibility_method_name=None, feasibility_method_kwargs=None,
        dynamic_initial_sampling=None, dynamic_initial_sampling_kwargs=None,
        surrogate_custom_training=None, surrogate_custom_training_kwargs=None,
        surrogate_refit=None, optimize_mean_variance=False, telemetry=None,
        random_seed=None, local_random=None,
        file_path=None, save=False, save_eval=10,
        save_surrogate_evals=False, save_optimizer_params=True,
        metadata=None,
        torch_objective=False, evaluator=None, n_eval_workers=1, pipeline=None,
        tenant_batching=False, min_tenant_bucket=2, stats_per_problem="auto",
        device=None, mesh=None, verbose=False,
        **kwargs,
    ) -> None:
        """MO-ASMO optimization driver (reference dmosopt/dmosopt.py:546-630).

        file_path, save, save_eval: the HDF5 store; when the file exists
          the run resumes from it (its seed, space and archive win).
        n_eval_workers: thread-pool width for host objectives.
        pipeline: ``"serial"``, ``"overlap_io"`` (None), ``"speculative"``,
          or a dict / `PipelineConfig` with ``quorum_fraction``,
          ``eval_timeout``, ``eval_retries``, ``on_eval_failure`` and
          ``torch_eval_chunks``.
        torch_objective: `obj_fun` maps a (B, n) float32 tensor of flat
          parameter vectors on ``device`` to objectives (B, d), or to a
          tuple (objectives, constraints (B, c)) with ``constraint_names``.
        feasibility_method_name, sensitivity_method_name: registry names
          (``"logreg"``; ``"fast"``, ``"dgsm"``) or import paths, with
          their ``*_kwargs``.
        surrogate_refit: ``"cold"`` (None: every epoch refits from
          scratch), ``"warm"`` (warm-started refits, rank-k posterior
          updates once the hyperparameters settle, restart pruning and
          audit fits), a dict of `SurrogateRefitConfig` options with
          ``"mode"``, or a config.
        optimize_mean_variance: the inner EA ranks the surrogate's mean and
          variance (2·d columns); the archive's and the store's prediction
          columns are then 2·d wide.
        problem_ids: a set of problem ids; each problem gets its own
          strategy, archive and store group, and a host objective takes
          ``{problem_id: parameters}`` and returns ``{problem_id: result}``.
        feature_dtypes, feature_class: the features an objective returns
          beside its objectives (a result is then ``(y, f)`` or ``(y, f,
          c)``): a list of numpy dtype tuples, shown as structured
          records, or the import path of a constructor of the flat
          float64 feature columns.
        surrogate_custom_training: import path of a hook that builds each
          epoch's optimizer class and models (`moasmo.epoch`), with
          ``surrogate_custom_training_kwargs``.
        evaluator: an evaluation backend built by the caller (with
          ``evaluate_batch`` and optionally ``submit_batch``); `run()`
          does not close it.
        tenant_batching, min_tenant_bucket: with several problems, run
          each bucket of at least ``min_tenant_bucket`` problems through
          the batched tenant core (`tenants.py`).
        stats_per_problem: how `get_stats` reports several problems:
          "auto" keeps each problem's keys up to
          `_STATS_PER_PROBLEM_LIMIT` problems and aggregates beyond,
          True always keeps them, False always aggregates.
        dynamic_initial_sampling: import path of an epoch-0 sampler,
          called with ``file_path``, ``iteration``, ``evaluated_samples``,
          ``next_samples``, ``sampler`` and ``dynamic_initial_sampling_kwargs``;
          the rows it returns are evaluated, until it returns None.
        device: where the surrogate, the inner EA and a torch objective
          run; None means CUDA (and raises without one).
        mesh: a `parallel.mesh.create_mesh` mesh (one process per device,
          every rank running this same run): the inner EA's survival
          ranks, the surrogate's predicts and a torch objective's batch
          rows are split over its first axis, the GP fit's restarts over
          a ``"model"`` axis (and with ``surrogate_method_kwargs=
          {"surrogate_mesh": ...}`` the fit's Cholesky over row slabs);
          rank 0 decides a resume and alone writes the store.
        telemetry: None/True for the on-by-default metrics, event log,
          spans and health engine; False for none at all (no telemetry
          call); a dict of `telemetry.Telemetry` keyword arguments
          (``ring_size``, ``jsonl_path``, ``profile_dir``,
          ``profile_epochs``, ...); or a `Telemetry`, which the caller
          keeps and closes.
        """
        bad = sorted(
            k for k, default in _UNPORTED_DEFAULTS.items()
            if k in kwargs and not _is_default(kwargs[k], default)
        )
        if bad:
            raise NotImplementedError(
                f"DistOptimizer options not ported to dmosopt_tpu_torch: {bad}"
            )
        self.pipeline = PipelineConfig.from_spec(pipeline)
        if self.pipeline.on_eval_failure == "skip" and surrogate_method_name is None:
            # without a surrogate each generation is evaluated for real and
            # sent back row-aligned; a dropped round would misalign it
            raise ValueError(
                "on_eval_failure='skip' requires a surrogate "
                "(surrogate_method_name=None evaluates whole generations "
                "whose results must stay row-aligned)"
            )
        if stats_per_problem not in ("auto", True, False):
            raise ValueError(
                f"stats_per_problem must be 'auto', True, or False; "
                f"got {stats_per_problem!r}"
            )
        self.stats_per_problem = stats_per_problem
        if random_seed is not None:
            if local_random is not None:
                raise RuntimeError("pass either random_seed or local_random, not both")
            local_random = np.random.default_rng(seed=random_seed)

        self.device = resolve_device(device)
        self.__dict__.update(
            opt_id=opt_id, verbose=verbose,
            population_size=population_size, num_generations=num_generations,
            distance_metric=distance_metric,
            termination_conditions=termination_conditions,
            surrogate_method_name=surrogate_method_name,
            surrogate_refit=surrogate_refit,
            optimize_mean_variance=bool(optimize_mean_variance),
            local_random=local_random, random_seed=random_seed,
            time_limit=time_limit, n_initial=n_initial,
            initial_maxiter=initial_maxiter, initial_method=initial_method,
            n_epochs=n_epochs, obj_fun_args=obj_fun_args,
            reduce_fun=reduce_fun, reduce_fun_args=reduce_fun_args,
            constraint_names=constraint_names, metadata=metadata,
            save_eval=save_eval,
            sensitivity_method_name=sensitivity_method_name,
            feasibility_method_name=feasibility_method_name,
            dynamic_initial_sampling=dynamic_initial_sampling,
            feature_dtypes=feature_dtypes,
            surrogate_custom_training=surrogate_custom_training,
            surrogate_custom_training_kwargs=surrogate_custom_training_kwargs,
            tenant_batching=bool(tenant_batching),
            min_tenant_bucket=max(int(min_tenant_bucket), 1),
        )
        self.sensitivity_method_kwargs = sensitivity_method_kwargs or {}
        self.feasibility_method_kwargs = feasibility_method_kwargs or {}
        self.dynamic_initial_sampling_kwargs = dynamic_initial_sampling_kwargs or {}
        self.resample_fraction = min(float(resample_fraction), 1.0)
        self.surrogate_method_kwargs = surrogate_method_kwargs or {}
        self.optimizer_name = _as_tuple(optimizer_name)
        self.optimizer_kwargs = _as_tuple(
            optimizer_kwargs
            if optimizer_kwargs is not None
            else {"mutation_prob": 0.1, "crossover_prob": 0.9}
        )
        self.save_surrogate_evals_ = save_surrogate_evals
        self.save_optimizer_params_ = save_optimizer_params
        self._writer = None  # lazy BackgroundWriter (overlap modes only)
        self._inflight = []  # _InflightBatch stragglers awaiting reconcile
        self._round_times = []  # per-round objective times of a drain
        self.telemetry = create_telemetry(telemetry)
        # a caller's instance may serve several runs: run() closes only
        # one built here
        self._owns_telemetry = not isinstance(telemetry, Telemetry)
        # health rules at every epoch boundary, only with live telemetry
        self.health = HealthEngine(telemetry=self.telemetry) if self.telemetry else None
        self.save_count = 0
        self.start_time = time.time()
        self.logger = logging.getLogger(opt_id)
        if self.verbose:
            self.logger.setLevel(logging.INFO)

        self._check_persistence_config(file_path, save, problem_parameters, space)
        param_space = ParameterSpace.from_dict(space) if space is not None else None
        if problem_parameters is not None:
            problem_parameters = ParameterSpace.from_dict(
                problem_parameters, is_value_only=True
            )
        if mesh is not None and not isinstance(mesh, DeviceMesh):
            raise TypeError(
                f"mesh must be a torch.distributed DeviceMesh "
                f"(parallel.mesh.create_mesh), not {type(mesh).__name__}"
            )
        self.mesh = mesh
        # every rank of a cluster takes the primary's resume decision,
        # made before the primary can create the file
        resuming = self._broadcast_resume_decision(file_path, self.device)
        self._resuming = resuming
        self.old_evals = {}
        self.start_epoch = 0
        if resuming:
            if not os.path.isfile(file_path):
                # a rank that fell through to a fresh start would leave the
                # primary's control flow and hang the cluster in a collective
                raise FileNotFoundError(
                    f"resume decided (primary sees {file_path!r}) but this "
                    f"process cannot read it: is the store on a shared "
                    f"filesystem?"
                )
            (seed, max_epoch, self.old_evals, param_space, objective_names,
             feature_dtypes, constraint_names, problem_parameters,
             problem_ids) = self._restore_from_file(file_path, param_space)
            # every rank has read the store before any rank appends to it
            self._barrier_after_restore()
            self.feature_dtypes = feature_dtypes
            self.constraint_names = constraint_names
            self.start_epoch = max(max_epoch, 0)
            if seed is not None:
                if self.local_random is not None:
                    self.logger.warning(
                        "checkpoint carries a random seed; it takes "
                        "precedence over the provided RNG"
                    )
                self.local_random = np.random.default_rng(seed=seed)
        if self.local_random is None:
            self.local_random = as_generator(random_seed)

        if param_space is None or param_space.n_parameters == 0:
            raise ValueError("empty parameter space")
        if objective_names is None:
            raise ValueError("objective_names is required")
        if problem_parameters is not None and not set(
            param_space.parameter_names
        ).isdisjoint(problem_parameters.parameter_names):
            raise ValueError(
                "problem_parameters and space must not share parameter names"
            )
        self.param_space = param_space
        self.param_names = param_space.parameter_names
        self.objective_names = objective_names
        self.problem_parameters = problem_parameters
        self.file_path, self.save = file_path, save
        self.has_problem_ids = problem_ids is not None
        self.problem_ids = set(problem_ids) if self.has_problem_ids else {0}
        for okw in self.optimizer_kwargs:
            # per-parameter distribution indices may come as nested dicts
            for di_key in ("di_crossover", "di_mutation"):
                if okw and isinstance(okw.get(di_key), dict):
                    okw[di_key] = param_space.flatten(okw[di_key])

        self.epoch_count = self.eval_count = self.saved_eval_count = 0
        self.optimizer_dict, self.storage_dict, self.stats = {}, {}, {}
        # per-epoch wall times, kernel launches and strategy stats
        self.epoch_stats = []
        # evaluation and persistence accounting: wall the driver spent
        # draining evaluations, the part of async evaluation that ran
        # behind other driver work, quorum returns and their stragglers,
        # and the count and wall of store writes
        self.pipeline_stats = {
            "eval_wait_s": 0.0, "eval_overlap_s": 0.0, "quorum_returns": 0,
            "stragglers": 0, "h5_writes": 0, "h5_write_s": 0.0,
        }

        self._init_features(feature_class)

        wrapper, target = (
            (eval_obj_fun_mp, self.problem_ids)
            if self.has_problem_ids
            else (eval_obj_fun_sp, 0)
        )
        self.eval_fun = partial(
            wrapper, obj_fun, self.problem_parameters, self.param_space,
            nested_parameter_space, self.obj_fun_args, target,
        )
        # only an evaluator built here is closed by run(): a caller's may
        # be shared across runs
        self._owns_evaluator = evaluator is None
        self.evaluator = evaluator if evaluator is not None else (
            TorchBatchEvaluator(obj_fun, self.device, problem_ids=sorted(self.problem_ids),
                                mesh=mesh)
            if torch_objective
            else HostFunEvaluator(self.eval_fun, n_workers=n_eval_workers)
        )
        if self.telemetry is not None:
            # a caller's evaluator may not take the attribute
            try:
                self.evaluator.telemetry = self.telemetry
            except AttributeError:
                pass

        if self.save and not resuming and is_primary_process():
            storage.init_h5(
                self.opt_id, self.problem_ids, self.has_problem_ids,
                self.param_space, self.param_names, self.objective_names,
                self.feature_dtypes, self.constraint_names,
                self.problem_parameters, self.metadata, self.random_seed,
                self.file_path,
                surrogate_mean_variance=self.optimize_mean_variance,
            )

    def _init_features(self, feature_class):
        """The archive keeps features as flat float columns; the
        constructor rebuilds the caller's view when results are handed
        back: ``feature_class``'s, or structured records named by
        ``feature_dtypes``. With ``save`` a non-numeric feature field
        fails here, before any evaluation (``dmosopt_tpu/driver.py:433-479``)."""
        self.persist_features = bool(self.save)
        dt = dt_numeric = None
        if self.feature_dtypes is not None:
            dt = np.dtype([tuple(d) for d in self.feature_dtypes])
            bad = storage.non_numeric_feature_fields(dt)
            dt_numeric = not bad
            if self.save and bad:
                raise ValueError(
                    f"feature fields {bad} are not numeric; persistence "
                    f"(save=True) requires numeric feature dtypes"
                )
        if feature_class is not None:
            self.feature_constructor = import_object_by_path(feature_class)
        elif dt is not None:
            self.feature_constructor = partial(_to_records, dt, dt_numeric)
        else:
            self.feature_constructor = lambda x: x
        self.feature_names = (
            [d[0] for d in self.feature_dtypes] if self.feature_dtypes is not None
            else None
        )

    # --------------------------------------------------------- init helpers

    @staticmethod
    def _broadcast_resume_decision(file_path, device) -> bool:
        """Whether this run restores from ``file_path``
        (``dmosopt_tpu/driver.py:535-560``): one process checks the file;
        in a cluster the primary's answer is broadcast, so every rank
        takes the same branch and no rank probes a file the primary may
        be creating. The paired `_barrier_after_restore` closes the
        read-against-append race."""
        exists = file_path is not None and os.path.isfile(file_path)
        if process_count() == 1:
            return exists
        import torch.distributed as dist

        flag = torch.tensor([int(exists)], dtype=torch.int32)
        if dist.get_backend() == "nccl":
            flag = flag.to(device)
        dist.broadcast(flag, src=0)
        return bool(flag.item())

    @staticmethod
    def _barrier_after_restore():
        """Every rank has finished reading the store before any appends
        to it (``dmosopt_tpu/driver.py:562-575``): h5py without SWMR
        gives a reader no consistency against a concurrent writer. No-op
        in one process."""
        if process_count() == 1:
            return
        import torch.distributed as dist

        dist.barrier()

    @staticmethod
    def _check_persistence_config(file_path, save, problem_parameters, space):
        """A run needs a problem definition from somewhere: inline
        (`space` + `problem_parameters`) or a checkpoint file."""
        definition_inline = problem_parameters is not None and space is not None
        if file_path is None:
            if not definition_inline:
                raise ValueError(
                    "no problem definition: pass `space` and "
                    "`problem_parameters`, or a checkpoint `file_path`"
                )
            if save:
                raise ValueError("save=True requires a `file_path`")
        elif not os.path.isfile(file_path) and not definition_inline:
            raise FileNotFoundError(file_path)

    def _restore_from_file(self, file_path, param_space):
        """The checkpoint tuple of `storage.init_from_h5`."""
        known_names = param_space.parameter_names if param_space is not None else None
        return storage.init_from_h5(file_path, known_names, self.opt_id, self.logger)

    # -------------------------------------------------------------- stats

    @staticmethod
    def _collapse_phase_pairs(stats):
        """Collapse paired `<phase>_start`/`<phase>_end` timestamps into
        a single `<phase>` duration; other keys pass through."""
        out = {}
        for key, value in stats.items():
            name, _, period = key.rpartition("_")
            if period == "start":
                end = stats.get(f"{name}_end")
                if end is not None:
                    out[name] = end - value
            elif period != "end":
                out[key] = value
        return out

    # each problem's stats keep their own key prefix up to this many
    # problems, and are averaged beyond (per-problem keys of 64 tenants
    # would be hundreds)
    _STATS_PER_PROBLEM_LIMIT = 16

    def get_stats(self):
        """The driver's and the strategies' stats, with paired
        `<phase>_start`/`<phase>_end` timestamps collapsed into one
        `<phase>` duration (``dmosopt_tpu/driver.py:643-689``). One
        problem keeps unprefixed keys; several prefix every problem's
        with its id, or, when ``stats_per_problem`` says to aggregate
        (False, or "auto" past `_STATS_PER_PROBLEM_LIMIT` problems), give
        each numeric key K as ``K_mean`` over the problems with
        ``stats_n_problems``."""
        multi = len(self.problem_ids) > 1
        per_problem = self.stats_per_problem
        if per_problem == "auto":
            per_problem = len(self.problem_ids) <= self._STATS_PER_PROBLEM_LIMIT
        if multi and not per_problem:
            sums, counts, n_reporting = {}, {}, 0
            for pid in self.problem_ids:
                strategy = self.optimizer_dict.get(pid)
                if strategy is None:
                    continue
                n_reporting += 1
                for k, v in self._collapse_phase_pairs(strategy.stats).items():
                    if isinstance(v, (int, float, np.integer, np.floating)):
                        sums[k] = sums.get(k, 0.0) + float(v)
                        counts[k] = counts.get(k, 0) + 1
            out = self._collapse_phase_pairs(self.stats)
            out.update((f"{k}_mean", sums[k] / counts[k]) for k in sums)
            out["stats_n_problems"] = n_reporting
            return out
        for pid in self.problem_ids:
            strategy = self.optimizer_dict.get(pid)
            if strategy is None:
                continue
            prefix = f"{pid}_" if (multi or pid > 0) else ""
            self.stats.update((prefix + k, v) for k, v in strategy.stats.items())
        return self._collapse_phase_pairs(self.stats)

    # ----------------------------------------------------- strategy setup

    def _restored_initial(self, problem_id):
        """Archive tuple (epochs, x, y, f, c) restored from the checkpoint,
        or None when this problem starts fresh. Non-finite objective rows
        are dropped: they must not re-enter GP training through a restart."""
        evals = self.old_evals.get(problem_id)
        if not evals:
            return None
        finite = [
            bool(np.all(np.isfinite(np.asarray(e.objectives, np.float64))))
            for e in evals
        ]
        if not all(finite):
            self.logger.warning(
                f"problem {problem_id}: dropped {len(finite) - sum(finite)} "
                f"non-finite objective row(s) from the restored archive"
            )
            evals = [e for e, ok in zip(evals, finite) if ok]
            if not evals:
                return None
        epochs = None
        if evals[0].epoch is not None:
            epochs = np.concatenate([e.epoch for e in evals], axis=None)
        x = np.vstack([e.parameters for e in evals])
        y = np.vstack([e.objectives for e in evals])
        f = None
        if self.feature_dtypes is not None:
            # flat float columns, as live rows are archived
            f = np.stack([storage.feature_columns(e.features).ravel() for e in evals])
        c = None
        if self.constraint_names is not None:
            c = np.vstack([e.constraints for e in evals])
        return (epochs, x, y, f, c)

    def initialize_strategy(self):
        opt_prob = OptProblem(
            self.param_names, self.objective_names, self.constraint_names,
            self.param_space, feature_dtypes=self.feature_dtypes,
            feature_constructor=self.feature_constructor,
        )
        initials = {pid: self._restored_initial(pid) for pid in sorted(self.problem_ids)}
        if any(
            init is not None
            and init[1].shape[0] >= self.n_initial * len(self.param_names)
            for init in initials.values()
        ):
            # a complete initial design means the restored max epoch is
            # done: new epochs continue after it (once for the run; the
            # problems share epoch labels)
            self.start_epoch += 1
        for problem_id, initial in initials.items():
            self.optimizer_dict[problem_id] = DistOptStrategy(
                opt_prob, n_initial=self.n_initial, initial=initial,
                initial_method=self.initial_method,
                initial_maxiter=self.initial_maxiter,
                population_size=self.population_size,
                num_generations=self.num_generations,
                resample_fraction=self.resample_fraction,
                distance_metric=self.distance_metric,
                termination_conditions=self.termination_conditions,
                optimizer_name=self.optimizer_name,
                optimizer_kwargs=self.optimizer_kwargs,
                surrogate_method_name=self.surrogate_method_name,
                surrogate_method_kwargs=self.surrogate_method_kwargs,
                surrogate_custom_training=self.surrogate_custom_training,
                surrogate_custom_training_kwargs=self.surrogate_custom_training_kwargs,
                surrogate_refit=self.surrogate_refit,
                surrogate_refit_state=self._restored_refit_state(problem_id),
                sensitivity_method_name=self.sensitivity_method_name,
                sensitivity_method_kwargs=self.sensitivity_method_kwargs,
                feasibility_method_name=self.feasibility_method_name,
                feasibility_method_kwargs=self.feasibility_method_kwargs,
                optimize_mean_variance=self.optimize_mean_variance,
                persist_features=self.persist_features, file_path=self.file_path,
                local_random=self.local_random, logger=self.logger,
                device=self.device, telemetry=self.telemetry, mesh=self.mesh,
                # the xinit phase is tagged with the run's first epoch, so a
                # resumed run's summary keeps it
                xinit_epoch=self.start_epoch,
            )
            self.storage_dict[problem_id] = []
        if any(init is not None for init in initials.values()):
            self.print_best()

    def _restored_refit_state(self, problem_id):
        """The stored surrogate warm state of a problem, or None (a fresh
        run, no refit mode, or a store without one); it seeds the
        strategy's controller so a resumed run's first fit is warm
        (``dmosopt_tpu/driver.py:736-758``)."""
        if not self._resuming or self.surrogate_refit is None:
            return None
        try:
            return storage.load_refit_state_from_h5(self.file_path, self.opt_id, problem_id)
        except (OSError, KeyError, ValueError) as e:
            self.logger.warning(
                f"could not restore surrogate refit state for problem {problem_id}: {e}"
            )
            return None

    # ------------------------------------------------------------ queries

    def get_best(self, feasible=True, return_features=False, return_constraints=False):
        """Current best (non-dominated) evaluations, as (name, column)
        pair lists, optionally with the feature records and the named
        constraint columns; with ``problem_ids`` a dict of them by
        problem."""

        def named_columns(names, arr):
            return None if arr is None else list(zip(names, list(arr.T)))

        best = {}
        for problem_id in sorted(self.problem_ids):
            bx, by, bf, bc = self.optimizer_dict[problem_id].get_best_evals(
                feasible=feasible
            )
            result = [
                named_columns(self.param_names, bx),
                named_columns(self.objective_names, by),
            ]
            if return_features:
                result.append(bf)
            if return_constraints:
                result.append(
                    named_columns(self.constraint_names, bc)
                    if self.constraint_names is not None
                    else None
                )
            best[problem_id] = tuple(result)
        return best if self.has_problem_ids else best[0]

    def print_best(self, feasible=True):
        best = self.get_best(feasible=feasible, return_features=True)
        items = best.items() if self.has_problem_ids else [(0, best)]
        for problem_id, (prms, res, ftrs) in items:
            if res is None:
                continue
            prms_dict, res_dict = dict(prms), dict(res)
            n_res = next(iter(res_dict.values())).shape[0]
            for i in range(n_res):
                res_i = {k: res_dict[k][i] for k in res_dict}
                prms_i = {k: prms_dict[k][i] for k in prms_dict}
                where = f" for id {problem_id}" if self.has_problem_ids else ""
                msg = f"Best eval {i} so far{where}: {res_i}@{prms_i}"
                if ftrs is not None:
                    msg += f" [{ftrs[i]}]"
                self.logger.info(msg)

    # -------------------------------------------------------- persistence

    def _timed_write(self, fn, *args, **kwargs):
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        self.pipeline_stats["h5_write_s"] += time.perf_counter() - t0
        self.pipeline_stats["h5_writes"] += 1

    def _submit_write(self, fn, *args, **kwargs):
        """One persistence write: inline in serial mode, queued to the
        ordered background writer in the overlap modes. The caller hands
        over host values only (numpy arrays, Python scalars), built
        before the call, so the writer thread never touches a device
        tensor or live driver state; the writer runs closures in
        submission order, so the file sees the serial loop's writes. In a
        cluster only the primary writes (``dmosopt_tpu/driver.py:909-968``)."""
        if not is_primary_process():
            return
        if not self.pipeline.overlaps_io:
            with span_scope(self.telemetry, "h5_write"):
                self._timed_write(fn, *args, **kwargs)
            return
        if self._writer is None:
            self._writer = BackgroundWriter(telemetry=self.telemetry)
        self._writer.submit(self._timed_write, fn, *args, **kwargs)

    def _flush_writes(self):
        """Block until every queued write is in the file (end of each
        epoch, run teardown)."""
        if self._writer is not None:
            self._writer.flush()

    def _close_evaluator(self):
        """Close the evaluator this driver built; a caller's is left open
        (it may serve several runs)."""
        if self._owns_evaluator and hasattr(self.evaluator, "close"):
            self.evaluator.close()

    def _close_writer(self):
        if self._writer is not None:
            self._writer.close()
            self._writer = None

    def save_evals(self):
        """Append the finished evaluations to the store, the predictions
        2·d wide with ``optimize_mean_variance``."""
        n = len(self.objective_names)
        n_pred = 2 * n if self.optimize_mean_variance else n
        finished = {}
        for problem_id in self.problem_ids:
            rows = self.storage_dict[problem_id]
            if rows:
                finished[problem_id] = (
                    [e.epoch for e in rows],
                    [e.parameters for e in rows],
                    [e.objectives for e in rows],
                    [e.features for e in rows]
                    if self.feature_names is not None
                    else None,
                    [e.constraints for e in rows]
                    if self.constraint_names is not None
                    else None,
                    [
                        [np.nan] * n_pred if e.prediction is None else e.prediction
                        for e in rows
                    ],
                )
                self.storage_dict[problem_id] = []
        if finished and is_primary_process():
            # `finished` is a snapshot (the live lists were reset above)
            self._submit_write(
                storage.save_to_h5,
                self.opt_id, self.problem_ids, self.has_problem_ids,
                self.objective_names, self.feature_dtypes,
                self.constraint_names, self.param_space, finished,
                self.problem_parameters, self.metadata, self.random_seed,
                self.file_path, self.logger,
                surrogate_mean_variance=self.optimize_mean_variance,
            )
            self.save_count += 1
            if self.telemetry:
                self.telemetry.inc("h5_saves_total")

    def save_surrogate_evals(self, problem_id, epoch, gen_index, x_sm, y_sm):
        if x_sm.shape[0] > 0:
            self._submit_write(
                storage.save_surrogate_evals_to_h5,
                self.opt_id, problem_id, self.param_names, self.objective_names,
                epoch, np.asarray(gen_index), np.asarray(x_sm), np.asarray(y_sm),
                self.file_path, self.logger,
            )

    def save_optimizer_params(self, problem_id, epoch, optimizer_name, optimizer_params):
        self._submit_write(
            storage.save_optimizer_params_to_h5,
            self.opt_id, problem_id, epoch, optimizer_name, dict(optimizer_params),
            self.file_path, self.logger,
        )

    def save_refit_state(self, problem_id):
        """Store one problem's surrogate warm state (hyperparameters and
        schedule counters), overwriting the previous epoch's."""
        ctrl = self.optimizer_dict[problem_id].refit_controller
        state = None if ctrl is None else ctrl.export_state()
        if state is not None:
            self._submit_write(
                storage.save_refit_state_to_h5,
                self.opt_id, problem_id, state, self.file_path, self.logger,
            )

    def save_stats(self, problem_id, epoch):
        # get_stats() runs now (snapshot); only the file write is deferred
        self._submit_write(
            storage.save_stats_to_h5,
            self.opt_id, problem_id, epoch, self.file_path, self.logger,
            self.get_stats(),
        )

    def save_telemetry(self, epoch):
        """Store the epoch's telemetry summary, the spans closed since the
        previous epoch's store and the epoch's health-alert transitions
        (``dmosopt_tpu/driver.py:961-990``); a writer span that closes
        after the drain lands with the next epoch."""
        if self.telemetry is None or not self.save:
            return
        self._submit_write(
            storage.save_telemetry_to_h5, self.opt_id, epoch,
            self.telemetry.epoch_summary(epoch), self.file_path, self.logger,
        )
        spans = self.telemetry.tracer.drain() if self.telemetry.tracer else []
        if spans:
            self._submit_write(
                storage.save_spans_to_h5, self.opt_id, epoch,
                [s.to_dict() for s in spans], self.file_path, self.logger,
            )
        alerts = self.health.transitions(epoch=epoch) if self.health else []
        if alerts:
            self._submit_write(
                storage.save_alerts_to_h5, self.opt_id, epoch, alerts,
                self.file_path, self.logger,
            )

    # ---------------------------------------------------------- epoch loop

    def _time_exceeded(self) -> bool:
        return (
            self.time_limit is not None
            and (time.time() - self.start_time) >= self.time_limit
        )

    def _gather_rounds(self):
        """Pop every pending request into evaluation rounds, one request
        per problem per round; a round may hold a subset of the problems
        when their queues differ in length."""
        task_args, task_reqs = [], []
        while True:
            round_reqs = {}
            for problem_id in sorted(self.problem_ids):
                req = self.optimizer_dict[problem_id].get_next_request()
                if req is not None:
                    round_reqs[problem_id] = req
            if not round_reqs:
                break
            task_args.append({pid: req.parameters for pid, req in round_reqs.items()})
            task_reqs.append(round_reqs)
        return task_args, task_reqs

    def _has_requests(self) -> bool:
        return any(self.optimizer_dict[pid].has_requests() for pid in self.problem_ids)

    def _fold_round(self, res, round_reqs):
        """Fold one completed evaluation round into the strategy and the
        save queue."""
        if self.reduce_fun is not None:
            res = (
                self.reduce_fun(res)
                if self.reduce_fun_args is None
                else self.reduce_fun(res, *self.reduce_fun_args)
            )
        t = res.pop("time", -1.0)
        self._round_times.append(t)
        for problem_id, rres in res.items():
            eval_req = round_reqs[problem_id]
            # (y, f, c), (y, f), (y, c) or y, by what the problem declares
            kwargs = {}
            parts = list(rres) if (
                self.feature_names is not None or self.constraint_names is not None
            ) else [rres]
            rres = parts.pop(0)
            if self.feature_names is not None:
                kwargs["f"] = parts.pop(0)
            if self.constraint_names is not None:
                kwargs["c"] = parts.pop(0)
            entry = self.optimizer_dict[problem_id].complete_request(
                eval_req.parameters, np.asarray(rres), pred=eval_req.prediction,
                epoch=eval_req.epoch, time=t, **kwargs,
            )
            if entry is not None:
                # a quarantined (non-finite) row stays out of the store too
                self.storage_dict[problem_id].append(entry)
            if self.verbose:
                prms = list(zip(self.param_names, list(eval_req.parameters.T)))
                lres = list(zip(self.objective_names, np.asarray(rres).T))
                self.logger.info(
                    f"optimization epoch {eval_req.epoch}: parameters {prms}: {lres}"
                )
        self.eval_count += 1

    def _handle_eval_failure(self, round_index, failure: EvalFailure):
        """A round exhausted its timeout/retry budget: policy "raise"
        aborts the run; "skip" drops only this round."""
        if self.pipeline.on_eval_failure == "raise":
            raise RuntimeError(
                f"evaluation round {round_index} failed terminally after "
                f"{failure.n_attempts} attempt(s) "
                f"({'timeout' if failure.timed_out else failure.error!r})"
            ) from failure.error
        self.logger.warning(
            f"evaluation round {round_index} skipped after "
            f"{failure.n_attempts} attempt(s): {failure!r}"
        )

    def _fold_ready(self, st: _InflightBatch):
        """Fold every buffered round that has become foldable, strictly
        in submission order."""
        while st.next_fold in st.buffered:
            res = st.buffered.pop(st.next_fold)
            round_reqs = st.task_reqs[st.next_fold]
            st.next_fold += 1
            if isinstance(res, EvalFailure):
                self._handle_eval_failure(st.next_fold - 1, res)
                continue
            self._fold_round(res, round_reqs)

    def _advance_inflight(self, st: _InflightBatch, until):
        """Block until at least `until` rounds of `st` are folded (or the
        time limit or handle exhaustion intervenes)."""
        self._fold_ready(st)
        while st.next_fold < until and not self._time_exceeded():
            t0 = time.perf_counter()
            item = st.handle.poll(timeout=1.0)
            st.blocked += time.perf_counter() - t0
            if item is None:
                if st.handle.done:
                    break  # exhausted (e.g. cancelled requests)
                continue
            index, res = item
            st.buffered[index] = res
            self._fold_ready(st)

    def _finish_inflight(self, st: _InflightBatch):
        """Overlap accounting once a batch is reconciled: of the handle's
        life (submit to its last result) the driver waited `st.blocked`."""
        t_end = st.handle.t_landed
        if t_end is None:
            t_end = time.perf_counter()
        wall = t_end - st.handle.t_submit
        overlap = max(wall - st.blocked, 0.0)
        self.pipeline_stats["eval_overlap_s"] += overlap
        tel = self.telemetry
        if tel:
            tel.observe("eval_wait_seconds", st.blocked)
            tel.observe("eval_overlap_seconds", overlap)
            if wall > 0:
                tel.gauge("pipeline_overlap_ratio", overlap / wall)
            tel.event(
                "pipeline", mode=self.pipeline.mode, n_rounds=st.total,
                wait_s=st.blocked, overlap_s=overlap,
            )

    def _abandon_inflight(self):
        """Soft-stop teardown: fold every result that has already landed
        (no waiting, no retry started), cancel what never started, drop
        the rest, and save what was folded."""
        for st in self._inflight:
            for index, res in st.handle.drain_completed():
                st.buffered[index] = res
            # fold past gaps: a still-running round must not discard
            # finished later ones; failures are dropped
            for index in sorted(st.buffered):
                res = st.buffered.pop(index)
                if not isinstance(res, EvalFailure):
                    self._fold_round(res, st.task_reqs[index])
            st.handle.cancel_pending()
        self._inflight = []
        if self.save and self.saved_eval_count < self.eval_count:
            self.save_evals()
            self.saved_eval_count = self.eval_count

    def _use_async(self) -> bool:
        """Stream results through ``submit_batch``: in the overlap modes,
        with an evaluator that has it (a caller's evaluator may offer
        ``evaluate_batch`` alone)."""
        return self.pipeline.overlaps_io and hasattr(self.evaluator, "submit_batch")

    def _process_requests(self, allow_quorum: bool = False):
        """Drain pending evaluation requests through the evaluator.

        Serial mode evaluates each gathered batch in one blocking call.
        The overlap modes submit it asynchronously and fold results as
        they stream back, in submission order. With ``allow_quorum`` in
        speculative mode the drain returns once the quorum fraction of
        rounds has folded; the stragglers stay in flight behind the
        surrogate fit and are reconciled at the start of the next drain.

        With telemetry, the reconcile and each batch's wait run in
        ``eval_drain`` spans, an asynchronous submission in an
        ``eval_dispatch`` span, and a drain that evaluated anything emits
        an ``eval`` phase with the rounds' time statistics."""
        tel = self.telemetry
        t_drain0 = time.perf_counter()
        evals_before = self.eval_count
        self._round_times = []
        still_inflight = []
        if self._inflight:
            with span_scope(tel, "eval_drain", stage="reconcile"):
                for st in self._inflight:
                    self._advance_inflight(st, st.total)
                    if st.next_fold < st.total:
                        still_inflight.append(st)  # time limit: teardown salvages it
                    else:
                        self._finish_inflight(st)
        self._inflight = still_inflight

        while self._has_requests() and not self._time_exceeded():
            task_args, task_reqs = self._gather_rounds()
            if not task_args:
                break
            if self._use_async():
                cfg = self.pipeline
                with span_scope(tel, "eval_dispatch", n_rounds=len(task_args)):
                    handle = self.evaluator.submit_batch(
                        task_args, timeout=cfg.eval_timeout, retries=cfg.eval_retries,
                        n_chunks=cfg.torch_eval_chunks,
                    )
                st = _InflightBatch(handle, task_reqs)
                quorum = st.total
                if allow_quorum and cfg.speculative and self.epoch_count > 0:
                    # never speculate on the initial design: the first
                    # surrogate fit sees all of it, as in serial mode
                    quorum = max(1, int(np.ceil(cfg.quorum_fraction * st.total)))
                with span_scope(tel, "eval_drain", n_rounds=st.total):
                    self._advance_inflight(st, quorum)
                if st.next_fold < st.total:
                    self._inflight.append(st)
                    if st.next_fold >= quorum:
                        self.pipeline_stats["quorum_returns"] += 1
                        self.pipeline_stats["stragglers"] += st.total - st.next_fold
                        if tel:
                            tel.inc("eval_quorum_returns_total")
                            tel.inc("eval_stragglers_total", st.total - st.next_fold)
                else:
                    self._finish_inflight(st)
            else:
                with span_scope(tel, "eval_drain", n_rounds=len(task_args)):
                    results = self.evaluator.evaluate_batch(task_args)
                    for res, round_reqs in zip(results, task_reqs):
                        self._fold_round(res, round_reqs)

            if self.save and (self.eval_count - self.saved_eval_count) >= self.save_eval:
                self.save_evals()
                self.saved_eval_count = self.eval_count
            if self._inflight:
                break  # quorum return: the caller proceeds to the fit

        if self.save and self.saved_eval_count < self.eval_count:
            self.save_evals()
            self.saved_eval_count = self.eval_count
        dt = time.perf_counter() - t_drain0
        self.pipeline_stats["eval_wait_s"] += dt
        if tel and self.eval_count > evals_before:
            n_new = self.eval_count - evals_before
            tel.inc("evals_total", n_new)
            tel.observe("phase_duration_seconds", dt, phase="eval")
            tel.event(
                "phase", phase="eval", duration_s=dt, n_evals=n_new,
                **eval_time_stats(self._round_times),
            )
        return self.eval_count, self.saved_eval_count

    def _drain_dynamic_initial_samples(self, distopt):
        """Epoch-0 hook (``dmosopt_tpu/driver.py:1358-1390``): a
        user-supplied sampler decides, round by round, whether the
        initial design needs more evaluated points (e.g. to reach a
        feasibility quota) before the first surrogate fit. Each round it
        gets a fresh `xinit` design as its proposal; the rows it returns
        are evaluated; None ends the rounds. The keyword names are the
        reference's public sampler interface (dmosopt.py:1357-1402)."""
        sampler_fn = import_object_by_path(self.dynamic_initial_sampling)
        design = dict(
            n_initial=self.n_initial,
            maxiter=self.initial_maxiter,
            method=self.initial_method,
            param_names=distopt.prob.param_names,
            xlb=distopt.prob.lb,
            xub=distopt.prob.ub,
        )
        for round_idx in itertools.count():
            proposal = opt.xinit(
                self.n_initial, distopt.prob.param_names, distopt.prob.lb,
                distopt.prob.ub, method=self.initial_method,
                maxiter=self.initial_maxiter, nPrevious=None,
                local_random=self.local_random, logger=self.logger,
            )
            batch = sampler_fn(
                file_path=self.file_path,
                iteration=round_idx,
                evaluated_samples=distopt.completed,
                next_samples=proposal,
                sampler=design,
                **self.dynamic_initial_sampling_kwargs,
            )
            if batch is None:
                return
            for row in np.atleast_2d(np.asarray(batch)):
                distopt.append_request(EvalRequest(row, None, 0))
            self._process_requests()

    def run_epoch(self, completed_epoch: bool = False):
        """One full epoch: drain the pending requests, then run every
        problem's epoch state machine to completion (reference
        dmosopt.py:1341-1470). Epochs are labelled from ``start_epoch``,
        so a resumed run continues the stored labels. With
        ``tenant_batching`` and several problems the epochs open through
        `tenants.initialize_epochs_batched`; ``epoch_stats`` then records
        each problem's route.

        With telemetry the epoch runs in an ``epoch`` span (closed after
        the epoch's device synchronize), the device memory gauges are
        refreshed, an epoch that ``profile_epochs`` names runs under a
        ``torch.profiler`` capture, and at its end come the ``epoch``
        event, the health rules and, with ``save``, the telemetry store
        (``dmosopt_tpu/driver.py:1423-1515``)."""
        epoch = self.start_epoch + self.epoch_count
        advance_epoch = (self.epoch_count + 1) < self.n_epochs
        t0 = time.perf_counter()
        wait0 = self.pipeline_stats["eval_wait_s"]
        launches0 = dict(KERNEL_LAUNCHES)
        tel = self.telemetry
        trace_ctx = contextlib.nullcontext()
        if tel:
            tel.set_epoch(epoch)
            record_device_memory(tel, self.device)
            if tel.should_trace(epoch):
                trace_ctx = tel.device_capture(epoch, device=self.device)
        strategies = {pid: self.optimizer_dict[pid] for pid in sorted(self.problem_ids)}
        with trace_ctx, span_scope(tel, "epoch", epoch=epoch):
            routing, accuracy = self._run_epoch_body(
                epoch, strategies, advance_epoch, completed_epoch
            )
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

        def problem_stats(pid):
            acc = accuracy.get(pid)
            return {**strategies[pid].stats,
                    **({} if acc is None else {"surrogate_accuracy": acc})}

        entry = {
            "epoch": epoch, "epoch_s": time.perf_counter() - t0,
            "eval_wait_s": self.pipeline_stats["eval_wait_s"] - wait0,
            "kernel_launches": {
                k: n - launches0.get(k, 0) for k, n in KERNEL_LAUNCHES.items()
            },
        }
        if self.has_problem_ids:
            entry["routing"] = routing
            entry["problems"] = {pid: problem_stats(pid) for pid in strategies}
        else:
            entry.update(problem_stats(0))
        self.epoch_stats.append(entry)
        if self.save:
            for pid in sorted(self.problem_ids):
                self.save_stats(pid, epoch)
                self.save_refit_state(pid)
        if tel:
            tel.inc("epochs_total")
            tel.event(
                "epoch", duration_s=time.perf_counter() - t0,
                eval_count=self.eval_count, save_count=self.save_count,
            )
            # the driver has no introspection source: the rules read the
            # metrics snapshot alone
            self.health.evaluate(tel.registry.snapshot(), epoch=epoch, step=epoch)
            self.save_telemetry(epoch)
        # every write queued this epoch is in the file before the epoch
        # counts as done
        self._flush_writes()
        self.epoch_count += 1
        return self.epoch_count

    def _run_epoch_body(self, epoch, strategies, advance_epoch, completed_epoch):
        """The epoch's evaluation drains and every problem's epoch state
        machine; returns (routing, surrogate accuracy by problem)."""
        self.stats["init_sampling_start"] = time.time()
        # the epoch-opening drain evaluates the previous epoch's resample
        # batch: the one place speculative mode may return at quorum
        self._process_requests(allow_quorum=True)
        if self.dynamic_initial_sampling is not None and self.epoch_count == 0:
            for pid in sorted(self.problem_ids):
                self._drain_dynamic_initial_samples(self.optimizer_dict[pid])
        if self.tenant_batching and len(strategies) > 1:
            from dmosopt_tpu_torch.tenants import initialize_epochs_batched

            routing = initialize_epochs_batched(
                strategies, epoch, min_bucket=self.min_tenant_bucket,
                telemetry=self.telemetry, logger=self.logger,
            )
        else:
            for strat in strategies.values():
                strat.initialize_epoch(epoch)
            routing = {pid: "sequential" for pid in strategies}
        accuracy = {}
        if self.epoch_count > 0:
            for pid, strat in strategies.items():
                if strat.folded_evals is not None:
                    # the rows the previous epoch's surrogate scheduled,
                    # folded into the archive as this epoch opened
                    accuracy[pid] = self._log_surrogate_accuracy(
                        pid, epoch - 1, strat.folded_evals
                    )
        self.stats["init_sampling_end"] = time.time()
        pending = set() if completed_epoch else set(strategies)
        while pending:
            if self._time_exceeded():
                self.logger.warning("time limit exceeded; stopping epoch")
                break
            self._process_requests()
            for pid in sorted(pending):
                state, res, _ = strategies[pid].update_epoch(resample=advance_epoch)
                if state == StrategyState.CompletedEpoch:
                    pending.discard(pid)
                    self._finish_problem_epoch(pid, epoch, advance_epoch, res)
        return routing, accuracy

    def _log_surrogate_accuracy(self, problem_id, fit_epoch, completed_evals):
        """Per-objective mean absolute error of the predictions that
        scheduled a batch of real evaluations (reference dmosopt.py:1420-1449;
        ``dmosopt_tpu/driver.py:1395-1417``): constrained runs keep the
        feasible rows when there are any, only the mean columns of a
        mean-variance prediction count, and a non-finite value leaves its
        cell out. Logged, and returned as ``{"fit_epoch", "n_rows",
        "mae"}`` for ``epoch_stats``; None for an empty batch.

        The JAX package calls it with the evaluations `update_epoch`
        returns, which are None on the surrogate path (the epoch's opening
        `initialize_epoch` has folded them), so it logs nothing there;
        here each epoch after the first logs the rows that opening folded."""
        _, y, pred, _, c = completed_evals
        if c is not None:
            keep = np.all(c > 0.0, axis=1)
            if keep.any():
                y, pred = y[keep], pred[keep]
        if y.shape[0] == 0:
            return None
        pred = pred[:, : y.shape[1]]  # mean columns in mean-variance mode
        valid = np.isfinite(y) & np.isfinite(pred)
        counts = valid.sum(axis=0)
        err = np.where(valid, np.abs(y - pred), 0.0).sum(axis=0)
        mae = [float(e / k) if k else float("nan") for e, k in zip(err, counts)]
        self.logger.info(
            f"surrogate accuracy at epoch {fit_epoch} for "
            f"problem {problem_id} was {mae}"
        )
        return {"fit_epoch": int(fit_epoch), "n_rows": int(y.shape[0]), "mae": mae}

    def _finish_problem_epoch(self, problem_id, epoch, advance_epoch, res):
        """Persist the surrogate's evaluations and the optimizer's
        parameters of a completed epoch that resamples."""
        if not (self.save and advance_epoch and epoch > 0):
            return
        if self.save_surrogate_evals_:
            self.save_surrogate_evals(problem_id, epoch, res.gen_index, res.x, res.y)
        if self.save_optimizer_params_:
            self.save_optimizer_params(
                problem_id, epoch, res.optimizer.name, res.optimizer.opt_parameters
            )


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
    dopt_params, time_limit=None, feasible=True, return_features=False,
    return_constraints=False, verbose=True, compile_cache_dir=None,
    device=None, **kwargs,
):
    """Run a complete MO-ASMO optimization (reference
    dmosopt/dmosopt.py:2501-2571) and return the best evaluations.
    ``device`` (or ``dopt_params["device"]``) None means CUDA.

    ``compile_cache_dir`` is accepted and does nothing: the JAX package
    keeps XLA's compiled programs there, and the port compiles no
    programs (its Triton kernels cache themselves under
    ``dmosopt_tpu_torch/_build``), so no ``compile_cache_*`` gauges are
    set. The rank's and the predictor's telemetry hooks are attached to
    the run's telemetry for the run and detached after it. ``return_features=True`` adds each
    best set's feature records. The reference's distwq keyword arguments
    (``_LEGACY_RUN_KWARGS``) are ignored, as the JAX package ignores
    them; any other keyword raises `TypeError`. An evaluator the caller
    passed in ``dopt_params["evaluator"]`` is left open."""
    unknown = sorted(k for k in kwargs if k not in _LEGACY_RUN_KWARGS)
    if unknown:
        raise TypeError(f"run() got unexpected keyword arguments {unknown}")
    dopt_params = dict(dopt_params)
    if time_limit is not None:
        dopt_params["time_limit"] = time_limit
    if device is not None:
        dopt_params["device"] = device
    dopt = dopt_init(dopt_params, verbose=verbose, initialize_strategy=True)
    # the rank's, the predictor's and the sharded fit's process-wide hooks
    # record into this run's telemetry for its duration only (None: no
    # calls; ``dmosopt_tpu/driver.py:1620-1626``)
    set_rank_telemetry(dopt.telemetry)
    set_predictor_telemetry(dopt.telemetry)
    set_gp_shard_telemetry(dopt.telemetry)
    dopt.logger.info(f"Optimizing for {dopt.n_epochs} epochs...")
    body_ok = False
    try:
        if dopt.n_epochs <= 0:
            dopt.run_epoch(completed_epoch=True)
        else:
            while dopt.epoch_count < dopt.n_epochs and not dopt._time_exceeded():
                dopt.run_epoch()
        dopt.print_best()
        record_device_memory(dopt.telemetry, dopt.device)
        body_ok = True
    finally:
        # salvage finished in-flight results, drain the evaluator (its
        # calls may hold files), then land every queued write; each step
        # isolated so one failure does not strand the others
        try:
            dopt._abandon_inflight()
        except Exception:
            dopt.logger.exception("discarding in-flight results failed")
        try:
            dopt._close_evaluator()
        except Exception:
            dopt.logger.exception("evaluator close failed")
        try:
            dopt._close_writer()
        except Exception:
            # a write failure at close fails a clean run, but must not
            # displace the exception that ended an aborted one
            if body_ok:
                raise
            dopt.logger.exception("background writer close failed")
        finally:
            set_rank_telemetry(None)
            set_predictor_telemetry(None)
            set_gp_shard_telemetry(None)
            # a caller's Telemetry may serve later runs: close only ours
            if dopt.telemetry is not None and dopt._owns_telemetry:
                dopt.telemetry.close()
    return dopt.get_best(
        feasible=feasible, return_features=return_features,
        return_constraints=return_constraints,
    )
