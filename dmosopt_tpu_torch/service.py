"""Ask/tell optimization service over the problem-batched core.

Port of ``dmosopt_tpu/service.py``. The driver runs a fixed set of
problems to completion; the service is the multi-tenant surface on top
of the same machinery: callers **submit** optimization problems at any
time, each submission joins a tenant **bucket at the next epoch
boundary**, every `step()` advances all active tenants by one epoch —
bucket-mates through one batched fit and one generation loop per bucket
(`dmosopt_tpu_torch.tenants`, one fused offspring launch a generation
for the whole bucket) — and each tenant's improving non-dominated front
**streams back** through its handle as epochs complete.

Phase staggering is first-class: tenants submitted at different times
(or with different epoch budgets) share buckets whenever their shapes
and configs match, each keeping its own epoch numbering; a tenant whose
configuration the batched core does not cover runs the sequential path
inside the same service loop.

Evaluation reuses the async evaluator API (`submit_batch`): each step
submits every tenant's pending requests before folding any of them, so
torch-objective device batches and host-objective thread pools overlap
across tenants. Per-tenant persistence rides the pipeline's ordered
`BackgroundWriter` (`storage.save_front_to_h5` per epoch), and the
service checkpoint (`storage.save_service_checkpoint_to_h5`) has the
JAX package's layout, so either package resumes the other's.

``scheduler=`` runs each step as a task graph
(`parallel.taskgraph.TaskGraph`) instead of the lockstep barrier chain.
In this port every node issues onto the device's default stream from
its worker thread; what overlaps is host work (evaluation drains,
folds, a bucket's host tail) with another bucket's launches.

Differences from the JAX package: objectives are batched torch
functions (``torch_objective=True``, where the JAX package takes
``jax_objective=True``), and a checkpoint's submit spec stores
``torch_objective``; the handles' ``cost_seconds`` have no
``compile`` share, since eager torch compiles no bucket program; and
the service runs on one explicit ``device`` (CUDA by default).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import logging
import os
import threading
import time
from collections import deque
from collections.abc import Iterator
from dataclasses import asdict, dataclass
from functools import partial
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

from dmosopt_tpu_torch.datatypes import EvalRequest, OptProblem, ParameterSpace
from dmosopt_tpu_torch.driver import eval_obj_fun_sp
from dmosopt_tpu_torch.parallel.evaluator import (
    EvalFailure,
    HostFunEvaluator,
    TorchBatchEvaluator,
)
from dmosopt_tpu_torch.parallel.pipeline import BackgroundWriter
from dmosopt_tpu_torch.strategy import DistOptStrategy
from dmosopt_tpu_torch.telemetry import Telemetry, create_telemetry, span_scope
from dmosopt_tpu_torch.utils import json_default
from dmosopt_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

# per-epoch attributed-cost keys the batched core leaves in a
# strategy's stats dict (`tenants` cost attribution); the service pops
# them after each epoch into the tenant's cumulative handle costs. The
# JAX package's third key, ``cost_compile_seconds``, has no counterpart:
# eager torch compiles no bucket program
_COST_KEYS = (
    ("cost_fit_seconds", "fit"),
    ("cost_ea_seconds", "ea"),
)

#: conservative per-attempt evaluation timeout applied when no
#: `EvalPolicy` names one — a wedged objective must not hang `step()`
#: forever even on an unconfigured service (docs/configuration.md)
DEFAULT_EVAL_TIMEOUT = 600.0


def _torch_flag(cfg: Dict[str, Any]) -> None:
    """Read a stored submit spec's objective flag as the port's: a JAX
    package checkpoint says ``jax_objective``, which the port reads as
    ``torch_objective`` (the caller supplies the objective again, as a
    torch one)."""
    jax_flag = cfg.pop("jax_objective", None)
    if "torch_objective" not in cfg and jax_flag is not None:
        cfg["torch_objective"] = bool(jax_flag)


@dataclass(frozen=True)
class EvalPolicy:
    """Per-tenant evaluation fault policy (docs/robustness.md).

    timeout: per-attempt wall-clock budget in seconds for one objective
        call; ``None`` uses the service's ``default_eval_timeout``
        (never "wait forever" — that is how a wedged objective used to
        hang `step()`).
    retries: resubmissions allowed per request after a timeout or an
        objective exception (threaded into the evaluators' existing
        ``submit_batch(timeout=, retries=)`` machinery).
    backoff / backoff_cap: capped exponential backoff (jittered) before
        each retry attempt executes — see
        `parallel.evaluator.HostFunEvaluator.submit_batch`.
    on_eval_failure: what a request that exhausts its budget does to
        its tenant —
        ``"retire"`` (default): the tenant fails immediately, matching
        the pre-policy service behavior; bucket-mates are unaffected.
        ``"skip"``: the failed point is dropped from the fold and the
        tenant continues (degraded); only an epoch with ZERO successful
        evaluations counts against ``max_failed_epochs``.
        ``"quorum"``: like skip, but an epoch whose success fraction
        falls below ``min_success_fraction`` counts as failed.
    min_success_fraction: the quorum threshold (``"quorum"`` only).
    max_failed_epochs: consecutive failed epochs before a degraded
        tenant is retired (state ``"degraded"``, error on its handle —
        never an exception out of `step()`).
    """

    timeout: Optional[float] = None
    retries: int = 0
    backoff: float = 0.0
    backoff_cap: float = 30.0
    on_eval_failure: str = "retire"
    min_success_fraction: float = 0.5
    max_failed_epochs: int = 3

    def __post_init__(self):
        if self.on_eval_failure not in ("retire", "skip", "quorum"):
            raise ValueError(
                f"on_eval_failure must be 'retire', 'skip' or 'quorum'; "
                f"got {self.on_eval_failure!r}"
            )
        if not (0.0 < self.min_success_fraction <= 1.0):
            raise ValueError(
                f"min_success_fraction must be in (0, 1]; "
                f"got {self.min_success_fraction}"
            )
        if self.retries < 0 or self.max_failed_epochs < 1:
            raise ValueError(
                "retries must be >= 0 and max_failed_epochs >= 1"
            )
        if self.timeout is not None and self.timeout <= 0:
            raise ValueError(f"timeout must be positive; got {self.timeout}")

    @classmethod
    def from_spec(
        cls, spec: Union[None, Dict, "EvalPolicy"]
    ) -> Optional["EvalPolicy"]:
        """None passes through (caller falls back to the service
        default); a dict becomes constructor kwargs."""
        if spec is None or isinstance(spec, cls):
            return spec
        if isinstance(spec, dict):
            return cls(**spec)
        raise TypeError(
            f"eval_policy must be None, dict, or EvalPolicy; "
            f"got {type(spec)!r}"
        )


@dataclass
class FrontUpdate:
    """One streamed front improvement: the tenant's non-dominated set
    after `epoch` completed."""

    epoch: int
    x: np.ndarray
    y: np.ndarray


class TenantHandle:
    """Caller-facing view of one submitted optimization: stream front
    updates as they land, read the latest front, await completion."""

    def __init__(self, tenant_id: int, opt_id: str):
        self.tenant_id = tenant_id
        self.opt_id = opt_id
        self.done = False
        self.error: Optional[BaseException] = None
        # cumulative attributed cost of this tenant's share of its
        # buckets' fits and generation loops (`tenants` attribution;
        # zero for tenants that only rode the sequential path)
        self.cost_seconds: Dict[str, float] = {"fit": 0.0, "ea": 0.0}
        self._updates: deque = deque()
        self._latest: Optional[FrontUpdate] = None
        self._lock = threading.Lock()

    # ---- service side
    def _push(self, update: FrontUpdate):
        with self._lock:
            self._updates.append(update)
            self._latest = update

    # ---- caller side
    def updates(self) -> List[FrontUpdate]:
        """Drain the queued front updates (oldest first)."""
        with self._lock:
            out = list(self._updates)
            self._updates.clear()
        return out

    def best(self) -> Optional[FrontUpdate]:
        """The most recent front, or None before the first epoch."""
        with self._lock:
            return self._latest

    def result(self) -> FrontUpdate:
        if self.error is not None:
            raise self.error
        if not self.done:
            raise RuntimeError(
                f"tenant {self.opt_id!r} still running; call "
                f"OptimizationService.run() or step() first"
            )
        if self._latest is None:
            raise RuntimeError(
                f"tenant {self.opt_id!r} finished without completing an "
                f"epoch (no front was produced)"
            )
        return self._latest


@dataclass
class _Tenant:
    handle: TenantHandle
    strat: DistOptStrategy
    evaluator: Any
    owns_evaluator: bool
    n_epochs: int
    file_path: Optional[str]
    param_names: Tuple[str, ...]
    objective_names: Tuple[str, ...]
    epochs_run: int = 0
    # fault-policy state (docs/robustness.md): the resolved policy,
    # whether the evaluator honors per-request timeouts (host backends
    # do; a jitted batch is all-or-nothing), and degradation accounting
    policy: Optional[EvalPolicy] = None
    host_like: bool = False
    eval_failures: int = 0  # cumulative failed evaluation requests
    failed_epochs: int = 0  # CONSECUTIVE sub-quorum evaluation rounds
    degraded: bool = False
    quarantined_seen: int = 0  # strategy n_quarantined already counted
    last_success_fraction: Optional[float] = None
    # checkpoint/resume: the JSON-able submit kwargs needed to rebuild
    # this tenant's strategy in a fresh process
    submit_spec: Optional[Dict[str, Any]] = None


class OptimizationService:
    """Multi-tenant ask/tell optimization: submit problems any time,
    `step()` advances every active tenant one epoch (bucket-batched),
    fronts stream back per tenant. Not thread-safe for concurrent
    `step()` calls; `submit()` may be called from any thread.

    ``device`` is where every tenant's surrogate, inner EA and torch
    objective run; None means CUDA, and raises without a CUDA device.
    The service hands this one device to every strategy, evaluator and
    capture it builds."""

    def __init__(
        self,
        *,
        min_bucket: int = 2,
        telemetry=None,
        logger=logger,
        status_path: Optional[str] = None,
        eval_policy: Union[None, Dict, EvalPolicy] = None,
        default_eval_timeout: float = DEFAULT_EVAL_TIMEOUT,
        checkpoint_path: Optional[str] = None,
        health_rules=None,
        exporter=None,
        owner: Optional[str] = None,
        placement_epoch: int = 0,
        scheduler=None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.min_bucket = int(min_bucket)
        # async task-graph epochs (docs/parallel.md "Async task-graph
        # epochs"): ``scheduler`` is None/False (the lockstep step,
        # default), True (auto worker count), an int concurrency
        # (1 = serial graph, the bitwise-parity mode), or a dict with a
        # ``concurrency`` key. When enabled, `step()` routes to
        # `_step_taskgraph`, which expresses the epoch as a per-tenant/
        # per-bucket task DAG executed by `parallel.taskgraph.TaskGraph`.
        from dmosopt_tpu_torch.parallel.taskgraph import resolve_concurrency

        self.scheduler_concurrency = resolve_concurrency(scheduler)
        self._last_graph: Dict[str, Any] = {}
        # ownership lease (fleet migration wire format): `owner` names
        # the worker process whose checkpoints these are; the
        # supervisor's monotonically increasing `placement_epoch` is
        # the fencing token a checkpoint claim must beat. Both are
        # stamped into every checkpoint and verified by
        # `adopt_checkpoint` so two workers can never own one tenant
        # (docs/robustness.md "Fleet failure model").
        self.owner = owner
        self.placement_epoch = int(placement_epoch)
        self.telemetry = create_telemetry(telemetry)
        self._owns_telemetry = not isinstance(telemetry, Telemetry)
        self.logger = logger
        self.status_path = status_path
        # active health tier (docs/observability.md "Run-health
        # engine"): declarative alert rules evaluated over the metrics
        # snapshot + introspect() at every step boundary, firing ->
        # resolved lifecycle, surfaced via introspect()["health"], the
        # status CLI, and /healthz. ``health_rules`` is None (seeded
        # default rulebook), a rule list, or False (no engine). Only
        # built with live telemetry: a telemetry=False service holds no
        # health object and makes zero health calls.
        self.health = None
        if self.telemetry and health_rules is not False:
            from dmosopt_tpu_torch.telemetry.health import HealthEngine

            self.health = HealthEngine(
                rules=health_rules, telemetry=self.telemetry
            )
        # opt-in OpenMetrics exposition (docs/observability.md
        # "OpenMetrics exposition"): ``exporter`` is None/False (off),
        # True (ephemeral port on 127.0.0.1), an int port, or a
        # MetricsExporter kwargs dict. The exporter thread is joined in
        # close().
        self.exporter = None
        if exporter:
            if self.telemetry is None:
                raise ValueError(
                    "exporter requires telemetry (the /metrics surface "
                    "IS the registry); got telemetry=False"
                )
            from dmosopt_tpu_torch.telemetry.exposition import MetricsExporter

            kwargs = (
                dict(exporter)
                if isinstance(exporter, dict)
                else ({} if exporter is True else {"port": int(exporter)})
            )
            self.exporter = MetricsExporter(
                snapshot_fn=self.telemetry.registry.snapshot,
                health_fn=(
                    self.health.summary if self.health is not None else None
                ),
                status_fn=self.introspect,
                logger=self.logger,
                **kwargs,
            ).start()
        # service-wide fault policy default (per-submit eval_policy
        # overrides it) and the conservative per-attempt timeout used
        # when neither names one — a wedged objective cannot hang a
        # step forever even on an unconfigured service
        self.eval_policy = EvalPolicy.from_spec(eval_policy)
        self.default_eval_timeout = float(default_eval_timeout)
        # crash-safe resume: full per-tenant state snapshot rewritten
        # atomically (write-temp-rename) at every epoch boundary;
        # `OptimizationService.resume(checkpoint_path, ...)` rebuilds
        self.checkpoint_path = checkpoint_path
        # deterministic fault injection, env-gated: one seeded plan per
        # service so `after`/`count` windows span the whole run
        self._fault_plan = None
        if os.environ.get("DMOSOPT_FAULT_PLAN"):
            from dmosopt_tpu_torch.testing.faults import FaultPlan

            self._fault_plan = FaultPlan.from_env()
        self._writer_error_logged = False
        self._pending: List[_Tenant] = []
        self._active: Dict[int, _Tenant] = {}
        self._ids = itertools.count()
        self._writer: Optional[BackgroundWriter] = None
        self._lock = threading.Lock()
        self._closed = False
        # introspection state: step/phase timings, the best
        # per-tenant-normalized step wall (the throughput baseline),
        # and retired-tenant bookkeeping. `_retired` keeps only the
        # most RECENT retirees (a long-lived service retires tenants
        # forever; an unbounded list would make every status snapshot
        # O(lifetime tenants)) while `_retired_counts` keeps the
        # accurate cumulative totals per state.
        self._steps_run = 0
        self._last_step: Dict[str, Any] = {}
        self._best_step_s_per_tenant: Optional[float] = None
        self._retired: deque = deque(maxlen=256)
        self._retired_counts: Dict[str, int] = {}

    # ------------------------------------------------------------ submit

    def submit(
        self,
        obj_fun,
        space: Dict[str, Any],
        objective_names,
        *,
        opt_id: Optional[str] = None,
        torch_objective: bool = True,
        jax_objective: Optional[bool] = None,
        n_epochs: int = 5,
        population_size: int = 64,
        num_generations: int = 50,
        n_initial: int = 8,
        initial_method: str = "slh",
        resample_fraction: float = 0.25,
        optimizer_name: str = "nsga2",
        optimizer_kwargs: Optional[Dict] = None,
        surrogate_method_name: str = "gpr",
        surrogate_method_kwargs: Optional[Dict] = None,
        random_seed: Optional[int] = None,
        file_path: Optional[str] = None,
        evaluator=None,
        eval_policy: Union[None, Dict, EvalPolicy] = None,
        surrogate_refit=None,
        objective_ref: Optional[str] = None,
        _restore: Optional[Dict[str, Any]] = None,
    ) -> TenantHandle:
        """Submit one optimization problem; it joins a bucket at the
        next epoch boundary (`step()`). ``obj_fun`` is a batched torch
        objective (``torch_objective=True``: a (B, n) float32 tensor on
        the service's device to (B, d) objectives, evaluated through
        `TorchBatchEvaluator`) or a per-point host function of a
        parameter dict. ``jax_objective=True`` raises, as it does in
        `run()`: the port evaluates no JAX objective. ``eval_policy``
        overrides the service-wide fault policy for this tenant
        (docs/robustness.md). Returns a `TenantHandle` streaming the
        tenant's fronts."""
        if self._closed:
            raise RuntimeError("service is closed")
        if jax_objective:
            raise NotImplementedError(
                "jax_objective is not ported to dmosopt_tpu_torch; pass a "
                "batched torch objective with torch_objective=True"
            )
        if surrogate_method_name is None:
            raise ValueError(
                "the service runs surrogate-mode epochs; "
                "surrogate_method_name=None is not supported"
            )
        if obj_fun is None and objective_ref:
            # the fleet wire format: a subprocess worker receives an
            # importable "module:attr" name instead of a closure
            from dmosopt_tpu_torch.utils import import_object

            obj_fun = import_object(objective_ref)
        policy = EvalPolicy.from_spec(eval_policy) or self.eval_policy
        tenant_id = next(self._ids)
        opt_id = opt_id or f"tenant_{tenant_id}"
        handle = TenantHandle(tenant_id, opt_id)

        param_space = ParameterSpace.from_dict(space)
        eval_fun = partial(
            eval_obj_fun_sp, obj_fun, None, param_space, False, None, 0
        )
        prob = OptProblem(
            param_space.parameter_names, list(objective_names), None,
            param_space,
        )
        owns_evaluator = evaluator is None
        if evaluator is None:
            evaluator = (
                TorchBatchEvaluator(obj_fun, self.device, problem_ids=[0])
                if torch_objective
                else HostFunEvaluator(eval_fun)
            )
            # owned evaluators report into the service's telemetry
            # (eval_timeouts/retries/failures_total — the degradation
            # accounting the policy layer is judged by)
            evaluator.telemetry = self.telemetry
        if self._fault_plan is not None:
            from dmosopt_tpu_torch.testing.faults import FaultyEvaluator

            evaluator = FaultyEvaluator(evaluator, self._fault_plan, opt_id)
        strat = DistOptStrategy(
            prob,
            n_initial=n_initial,
            initial_method=initial_method,
            population_size=int(population_size),
            num_generations=int(num_generations),
            resample_fraction=float(resample_fraction),
            optimizer_name=optimizer_name,
            optimizer_kwargs=optimizer_kwargs,
            surrogate_method_name=surrogate_method_name,
            surrogate_method_kwargs=surrogate_method_kwargs,
            surrogate_refit=surrogate_refit,
            surrogate_refit_state=(
                (_restore or {}).get("state", {}).get("refit")
            ),
            local_random=np.random.default_rng(random_seed),
            logger=self.logger,
            device=self.device,
            telemetry=None,  # per-bucket service telemetry only
        )
        # everything a fresh process needs to rebuild this tenant from a
        # checkpoint (the objective itself is re-supplied to `resume`)
        submit_spec = {
            "space": space,
            "objective_names": list(objective_names),
            "torch_objective": bool(torch_objective),
            "n_epochs": int(n_epochs),
            "population_size": int(population_size),
            "num_generations": int(num_generations),
            "n_initial": int(n_initial),
            "initial_method": initial_method,
            "resample_fraction": float(resample_fraction),
            "optimizer_name": optimizer_name,
            "optimizer_kwargs": optimizer_kwargs,
            "surrogate_method_name": surrogate_method_name,
            "surrogate_method_kwargs": surrogate_method_kwargs,
            "random_seed": random_seed,
            "file_path": file_path,
            "objective_ref": objective_ref,
            "eval_policy": asdict(policy) if policy is not None else None,
            "surrogate_refit": (
                surrogate_refit
                if isinstance(surrogate_refit, (str, dict, type(None)))
                else None  # controller/config objects are not JSON-able
            ),
        }
        tenant = _Tenant(
            handle=handle, strat=strat, evaluator=evaluator,
            owns_evaluator=owns_evaluator, n_epochs=int(n_epochs),
            file_path=file_path,
            param_names=tuple(param_space.parameter_names),
            objective_names=tuple(objective_names),
            policy=policy,
            host_like=hasattr(evaluator, "eval_fun"),
            submit_spec=submit_spec,
        )
        if _restore is not None:
            self._apply_restore(tenant, _restore)
        with self._lock:
            self._pending.append(tenant)
        if self.telemetry:
            if _restore is not None and _restore.get("adopted"):
                self.telemetry.inc("tenants_adopted_total")
            elif _restore is not None:
                self.telemetry.inc("tenants_resumed_total")
            else:
                self.telemetry.inc("tenants_submitted_total")
        return handle

    # -------------------------------------------------------------- step

    def _admit_pending(self):
        with self._lock:
            admitted, self._pending = self._pending, []
            for t in admitted:
                self._active[t.handle.tenant_id] = t
        return len(admitted)

    def _retire(self, tenant: _Tenant, state: str):
        """Record one tenant leaving the active set: bounded recent
        snapshot + cumulative per-state count, under the lock so a
        monitoring thread's `introspect()` never races the mutation."""
        with self._lock:
            self._active.pop(tenant.handle.tenant_id, None)
            self._retired.append(self._retire_summary(tenant, state))
            self._retired_counts[state] = (
                self._retired_counts.get(state, 0) + 1
            )

    def _gather_tenant_rounds(self, tenant: _Tenant):
        """Pop the tenant's pending requests into single-problem
        evaluation rounds (the driver's `_gather_rounds` for one pid)."""
        task_args, task_reqs = [], []
        while True:
            req = tenant.strat.get_next_request()
            if req is None:
                break
            task_args.append({0: req.parameters})
            task_reqs.append(req)
        return task_args, task_reqs

    def _effective_timeout(self, tenant: _Tenant) -> float:
        pol = tenant.policy
        if pol is not None and pol.timeout is not None:
            return float(pol.timeout)
        return self.default_eval_timeout

    def _drain_deadline(self, tenant: _Tenant, n_requests: int) -> float:
        """Whole-batch wall-clock backstop for one tenant's drain. Host
        backends enforce the per-attempt timeout internally and may run
        requests sequentially through a narrow pool, so their backstop
        scales with the batch; a jitted batch is one device program —
        the per-attempt budget IS the batch budget. Either way the
        backstop only fires on work the per-request machinery cannot
        bound (a wedged device program, a broken custom evaluator)."""
        pol = tenant.policy or EvalPolicy()
        budget = self._effective_timeout(tenant) * (pol.retries + 1)
        budget += (pol.backoff_cap if pol.backoff > 0 else 0.0) * pol.retries
        if tenant.host_like:
            budget *= max(n_requests, 1)
        return budget + 30.0

    def _collect_results(self, tenant, handle, task_args):
        """Drain one tenant's submitted batch into a submission-order
        result list (entries are result dicts, `EvalFailure`s, or None
        for requests lost to the deadline backstop). Returns
        ``(results, fatal_exception)``."""
        n = len(task_args)
        if handle is None:
            # custom evaluator without submit_batch: the synchronous
            # call runs on a helper thread bounded by the same deadline
            # backstop — a wedged evaluate_batch cannot hang step()
            # (the thread itself cannot be killed; it is daemonic and
            # its tenant is failed)
            box: Dict[str, Any] = {}

            def call():
                try:
                    box["res"] = list(
                        tenant.evaluator.evaluate_batch(task_args)
                    )
                except Exception as e:
                    box["err"] = e

            th = threading.Thread(
                target=call, daemon=True, name="dmosopt-eval-batch"
            )
            th.start()
            th.join(self._drain_deadline(tenant, n))
            if th.is_alive():
                if self.telemetry:
                    self.telemetry.inc("eval_deadline_exceeded_total")
                return None, RuntimeError(
                    f"tenant {tenant.handle.opt_id!r}: evaluate_batch "
                    f"exceeded the evaluation deadline backstop"
                )
            if "err" in box:
                return None, box["err"]
            return box["res"], None
        buffered: Dict[int, Any] = {}
        deadline = time.monotonic() + self._drain_deadline(tenant, n)
        try:
            while not handle.done:
                if time.monotonic() >= deadline:
                    # wedged evaluation the per-request machinery could
                    # not bound: abandon what is still in flight and
                    # mark the missing requests timed out — the step
                    # must not hang even with no policy configured
                    handle.cancel_pending()
                    if self.telemetry:
                        self.telemetry.inc("eval_deadline_exceeded_total")
                    self.logger.warning(
                        f"tenant {tenant.handle.opt_id!r}: evaluation "
                        f"drain exceeded its deadline backstop with "
                        f"{n - len(buffered)} request(s) undelivered"
                    )
                    for i in range(n):
                        buffered.setdefault(
                            i, EvalFailure(None, 1, timed_out=True)
                        )
                    break
                item = handle.poll(timeout=1.0)
                if item is None:
                    continue
                buffered[item[0]] = item[1]
        except Exception as e:
            return None, e
        return [buffered.get(i) for i in range(n)], None

    def _fold_tenant_results(self, tenant: _Tenant, results, task_reqs) -> int:
        """Fold one tenant's results in submission order under its
        fault policy: failed points are dropped from the fold (or, for
        the default ``"retire"`` policy, fail the tenant), non-finite
        rows are quarantined by `DistOptStrategy.complete_request`, and
        sub-quorum epochs advance the degradation state machine."""
        pol = tenant.policy or EvalPolicy()
        n_total = len(task_reqs)
        n_failed = 0
        # requests that produced nothing the archive can use — exhausted
        # failures AND quarantined (non-finite) returns — kept for the
        # no-archive re-issue below, so a tenant whose whole design was
        # lost keeps retrying (bounded by max_failed_epochs) instead of
        # idling forever with an empty queue
        unusable_reqs: List[EvalRequest] = []
        n_evals = 0
        try:
            for res, req in zip(results, task_reqs):
                if res is None or isinstance(res, EvalFailure):
                    n_failed += 1
                    unusable_reqs.append(req)
                    if pol.on_eval_failure == "retire":
                        cause = (
                            res.error
                            if isinstance(res, EvalFailure)
                            else None
                        )
                        attempts = (
                            res.n_attempts
                            if isinstance(res, EvalFailure)
                            else 1
                        )
                        raise RuntimeError(
                            f"tenant {tenant.handle.opt_id!r}: evaluation "
                            f"failed after {attempts} attempt(s)"
                        ) from cause
                    continue
                wall = (
                    res.pop("time", -1.0) if isinstance(res, dict)
                    else -1.0
                )
                nq_before = tenant.strat.n_quarantined
                tenant.strat.complete_request(
                    req.parameters, np.asarray(res[0]),
                    epoch=req.epoch, pred=req.prediction, time=wall,
                )
                if tenant.strat.n_quarantined > nq_before:
                    unusable_reqs.append(req)
                n_evals += 1
        except Exception as e:
            # per-tenant failure isolation: a broken objective takes
            # ITS tenant out (handle.error carries the cause), never
            # the service or its bucket-mates
            self._fail_tenant(tenant, e)
            return n_evals

        # quarantine accounting: complete_request diverted non-finite
        # rows; they count as unsuccessful toward the quorum below
        n_quarantined = tenant.strat.n_quarantined - tenant.quarantined_seen
        if n_quarantined > 0:
            tenant.quarantined_seen = tenant.strat.n_quarantined
            if self.telemetry:
                self.telemetry.inc(
                    "tenant_points_quarantined_total", n_quarantined,
                    tenant=tenant.handle.opt_id,
                )
        if n_failed > 0:
            tenant.eval_failures += n_failed
            tenant.degraded = True
            if self.telemetry:
                self.telemetry.inc(
                    "tenant_eval_failures_total", n_failed,
                    tenant=tenant.handle.opt_id,
                )
            self.logger.warning(
                f"tenant {tenant.handle.opt_id!r}: {n_failed}/{n_total} "
                f"evaluation(s) failed this epoch; continuing degraded "
                f"({tenant.eval_failures} failures total)"
            )

        # successes are requests that produced a finite archive row:
        # quarantined rows completed "successfully" but contributed
        # nothing the surrogate can train on
        n_ok = max(n_evals - n_quarantined, 0)
        frac = (n_ok / n_total) if n_total else 1.0
        tenant.last_success_fraction = frac
        sub_quorum = (
            frac < pol.min_success_fraction
            if pol.on_eval_failure == "quorum"
            else n_ok == 0
        ) if n_total else False
        if sub_quorum:
            tenant.failed_epochs += 1
            if tenant.failed_epochs >= pol.max_failed_epochs:
                self._fail_tenant(
                    tenant,
                    RuntimeError(
                        f"tenant {tenant.handle.opt_id!r}: retired after "
                        f"{tenant.failed_epochs} consecutive sub-quorum "
                        f"evaluation round(s) "
                        f"(last success fraction {frac:.2f}, policy "
                        f"{pol.on_eval_failure!r})"
                    ),
                    state="degraded",
                )
            elif (
                tenant.strat.x is None
                and not tenant.strat.has_completed()
                and not tenant.strat.has_requests()
            ):
                # nothing evaluable ever landed (the whole initial
                # design failed or was quarantined): without an archive
                # the tenant cannot fit or resample, so re-issue the
                # unusable requests — transient faults get another
                # epoch, bounded by max_failed_epochs
                for req in unusable_reqs:
                    tenant.strat.append_request(req)
        else:
            tenant.failed_epochs = 0
        return n_evals

    def _drain_evaluations(self):
        """Evaluate every tenant's pending requests: submit ALL batches
        asynchronously first (device batches and host pools overlap
        across tenants) with each tenant's policy timeout/retry budget
        threaded into `submit_batch`, then fold each tenant's results
        in submission order under its fault policy."""
        inflight = []
        with span_scope(self.telemetry, "eval_dispatch"):
            for t in self._active.values():
                task_args, task_reqs = self._gather_tenant_rounds(t)
                if not task_args:
                    continue
                pol = t.policy or EvalPolicy()
                if hasattr(t.evaluator, "submit_batch"):
                    handle = t.evaluator.submit_batch(
                        task_args,
                        timeout=self._effective_timeout(t),
                        retries=pol.retries,
                        backoff=pol.backoff,
                        backoff_cap=pol.backoff_cap,
                    )
                else:
                    handle = None
                inflight.append((t, handle, task_args, task_reqs))

        n_evals = 0
        for t, handle, task_args, task_reqs in inflight:
            results, fatal = self._collect_results(t, handle, task_args)
            if fatal is not None:
                self._fail_tenant(t, fatal)
                continue
            n_evals += self._fold_tenant_results(t, results, task_reqs)
        return n_evals

    def _fail_tenant(
        self, tenant: _Tenant, error: BaseException, state: str = "failed"
    ):
        tenant.handle.error = error
        tenant.handle.done = True
        self._retire(tenant, state)
        if tenant.owns_evaluator and hasattr(tenant.evaluator, "close"):
            try:
                tenant.evaluator.close()
            except Exception:
                self.logger.exception(
                    f"tenant {tenant.handle.opt_id!r}: evaluator close "
                    f"failed during failure teardown"
                )
        self.logger.warning(
            f"tenant {tenant.handle.opt_id!r} failed and was retired "
            f"({type(error).__name__}: {error}); "
            f"{len(self._active)} tenant(s) continue"
        )
        if self.telemetry:
            self.telemetry.inc("tenants_failed_total")

    def _submit_write(self, fn, *args, **kwargs):
        """Queue one persistence closure. A dead writer (terminal write
        failure after its retry budget) degrades persistence instead of
        crashing the service: the submission is dropped, the failure is
        logged ONCE with its cause, and `introspect()`/the `status` CLI
        surface ``writer_failed`` — optimization itself continues."""
        if self._writer is None:
            self._writer = BackgroundWriter(telemetry=self.telemetry)
        try:
            self._writer.submit(fn, *args, **kwargs)
        except RuntimeError:
            self._note_writer_dead()

    def _note_writer_dead(self):
        if not self._writer_error_logged:
            self._writer_error_logged = True
            self.logger.exception(
                "background persistence writer is dead (write failed "
                "after its retry budget); the service continues WITHOUT "
                "persistence — fronts and checkpoints are no longer "
                "written (see introspect()['writer'])"
            )

    def _flush_writer(self):
        if self._writer is None:
            return
        try:
            self._writer.flush()
        except RuntimeError:
            self._note_writer_dead()

    def _stream_front(self, tenant: _Tenant, epoch: int):
        bx, by, _, _ = tenant.strat.get_best_evals()
        if bx is None:
            return
        tenant.handle._push(FrontUpdate(epoch, bx, by))
        if self.telemetry:
            self.telemetry.inc("tenant_front_updates_total")
        if tenant.file_path is not None:
            from dmosopt_tpu_torch.storage import save_front_to_h5

            self._submit_write(
                save_front_to_h5,
                tenant.handle.opt_id, epoch, tenant.param_names,
                tenant.objective_names, bx, by, tenant.file_path,
                self.logger,
            )

    @contextlib.contextmanager
    def _step_phase(self, phases: Dict[str, float], name: str):
        """Time one sub-phase of `step()` into `phases` and
        `service_step_seconds{phase=}`. Tracing spans are composed at
        the call sites via `span_scope` so the span names stay
        string-literal-scannable by graftlint's metrics-catalog rule."""
        tel = self.telemetry
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            phases[name] = dt
            if tel:
                tel.observe("service_step_seconds", dt, phase=name)

    def _absorb_tenant_costs(self, tenant: _Tenant):
        """Move the epoch's attributed-cost keys from the strategy's
        stats into the handle's cumulative totals. Popping (not
        reading) matters: the stats dict persists across epochs, and a
        tenant that rides a bucket one epoch and the sequential path
        the next would otherwise re-count the stale share."""
        for key, phase in _COST_KEYS:
            v = tenant.strat.stats.pop(key, None)
            if v is not None:
                tenant.handle.cost_seconds[phase] += float(v)

    def step(self) -> int:
        """One epoch boundary: admit pending tenants, evaluate pending
        requests (initial designs and resample batches), advance every
        active tenant one epoch — bucket-mates batched — and stream
        fronts. Returns the number of tenants advanced.

        The step is decomposed into four timed phases — ``admit`` /
        ``eval`` / ``fit`` (the batched bucket advance, surrogate fit +
        inner EA) / ``fold`` (result installation + front streaming) —
        each observed into ``service_step_seconds{phase=}`` and, with
        tracing enabled, nested under one ``epoch`` span.

        With the task-graph scheduler enabled (``scheduler=`` knob) the
        same epoch runs as a task DAG instead — see `_step_taskgraph`;
        a scheduler concurrency of 1 executes the identical lockstep
        sequence and is bitwise-equal to this path."""
        if self._closed:
            raise RuntimeError("service is closed")
        if self.scheduler_concurrency:
            return self._step_taskgraph()
        from dmosopt_tpu_torch.tenants import initialize_epochs_batched
        from dmosopt_tpu_torch.datatypes import StrategyState

        t0 = time.perf_counter()
        phases: Dict[str, float] = {}
        n_advanced = 0
        # profiled steps (telemetry profile_dir/profile_epochs, keyed by
        # the service step index): the whole step body runs under a
        # torch.profiler capture that the device-time ledger ingests on
        # exit — per-program device times joined to this step's
        # gp_fit/ea_scan spans, per-tenant device seconds attributed
        # through the tenant_cost span shares (docs/observability.md
        # "Device-time ledger")
        trace_ctx = (
            self.telemetry.device_capture(self._steps_run, device=self.device)
            if self.telemetry and self.telemetry.should_trace(self._steps_run)
            else contextlib.nullcontext(None)
        )
        with trace_ctx, span_scope(self.telemetry, "epoch", step=self._steps_run):
            with self._step_phase(phases, "admit"), span_scope(
                self.telemetry, "admit"
            ):
                self._admit_pending()
            if not self._active:
                self._finish_step(t0, phases, 0)
                return 0
            with self._step_phase(phases, "eval"), span_scope(
                self.telemetry, "eval_drain"
            ):
                self._drain_evaluations()

            strategies, epochs = {}, {}
            for tid, t in self._active.items():
                if t.strat.x is None and not t.strat.has_completed():
                    # nothing evaluable has ever landed (a degraded
                    # tenant whose whole initial design failed): there
                    # is no archive to fit a surrogate on, so the
                    # tenant idles this step — its re-issued requests
                    # (or its retirement) are handled by the eval fold
                    continue
                strategies[tid] = t.strat
                epochs[tid] = t.epochs_run
            # no own span: the bucket runs open their gp_fit / ea_scan
            # spans (with tenant_cost children) directly under `epoch`
            with self._step_phase(phases, "fit"):
                initialize_epochs_batched(
                    strategies, epochs, min_bucket=self.min_bucket,
                    telemetry=self.telemetry, logger=self.logger,
                    # per-tenant epoch-init failures retire THAT tenant
                    # (handle.error carries the cause) instead of
                    # raising out of step() past its bucket-mates
                    on_error=lambda tid, e: self._fail_tenant(
                        self._active[tid], e
                    ),
                )

            with self._step_phase(phases, "fold"), span_scope(
                self.telemetry, "fold"
            ):
                finished = []
                for tid, t in list(self._active.items()):
                    if tid not in strategies:
                        continue  # idled (no archive) or failed at init
                    try:
                        resample = (t.epochs_run + 1) < t.n_epochs
                        state, _res, _evals = t.strat.update_epoch(
                            resample=resample
                        )
                        if state != StrategyState.CompletedEpoch:
                            raise RuntimeError(
                                f"tenant {t.handle.opt_id!r}: epoch did not "
                                f"complete in one update (state {state}); the "
                                f"service requires surrogate-mode tenants"
                            )
                        epoch = t.epochs_run
                        t.epochs_run += 1
                        self._absorb_tenant_costs(t)
                        self._stream_front(t, epoch)
                    except Exception as e:
                        self._fail_tenant(t, e)
                        continue
                    if t.epochs_run >= t.n_epochs:
                        finished.append(tid)

                for tid in finished:
                    t = self._active[tid]
                    t.handle.done = True
                    self._retire(t, "completed")
                    if t.owns_evaluator and hasattr(t.evaluator, "close"):
                        t.evaluator.close()
                    if self.telemetry:
                        self.telemetry.inc("tenants_completed_total")
            # epoch-boundary checkpoint BEFORE the flush: when step()
            # returns, the snapshot for this boundary is durable — a
            # kill -9 during the next epoch resumes from here
            self._checkpoint()
            self._flush_writer()
            n_advanced = len(strategies)
        if self.telemetry:
            self.telemetry.inc("service_epochs_total")
            self.telemetry.gauge("tenants_active", len(self._active))
            self.telemetry.observe(
                "phase_duration_seconds",
                time.perf_counter() - t0,
                phase="service_step",
            )
        self._finish_step(t0, phases, n_advanced)
        return n_advanced

    def _on_init_error(self, tid, e: BaseException):
        """Per-tenant epoch-init failure containment for graph bucket
        nodes: fail THAT tenant if it is still active (a concurrent
        eval-branch failure may already have retired it)."""
        with self._lock:
            t = self._active.get(tid)
        if t is not None:
            self._fail_tenant(t, e)

    def _step_taskgraph(self) -> int:
        """One epoch boundary as a task DAG (docs/parallel.md "Async
        task-graph epochs"): a ``dispatch`` node submits every tenant's
        pending evaluation batch, per-tenant ``eval`` nodes drain and
        fold results under each tenant's fault policy, per-provisional-
        bucket ``bucket`` nodes (grouped by `static_bucket_signature`,
        which needs no archive) and per-ineligible-tenant ``seq`` nodes
        run `initialize_epochs_batched` on their subset, per-tenant
        ``fold`` nodes install epochs and stream fronts through the
        BackgroundWriter, and a ``checkpoint`` node closes the step.

        A bucket node only waits on ITS members' eval nodes, so bucket
        B's fit/EA program launches while bucket A's host-side evals
        are still draining — the overlap the lockstep barrier forbids.
        Failures degrade per branch: a failed eval retires its tenant
        inside the eval node (never raising), so sibling branches keep
        running. At ``scheduler_concurrency == 1`` the nodes execute in
        creation order on the calling thread, which is exactly the
        lockstep sequence — bitwise parity with `step()`.

        Every node issues its device work onto the device's default
        stream from whichever thread runs it; the closures name the
        service's device explicitly and never rely on a thread's current
        device."""
        from dmosopt_tpu_torch.tenants import (
            initialize_epochs_batched,
            static_bucket_signature,
        )
        from dmosopt_tpu_torch.datatypes import StrategyState
        from dmosopt_tpu_torch.parallel.taskgraph import DONE, FAILED, TaskGraph

        t0 = time.perf_counter()
        phases: Dict[str, float] = {}
        trace_ctx = (
            self.telemetry.device_capture(self._steps_run, device=self.device)
            if self.telemetry and self.telemetry.should_trace(self._steps_run)
            else contextlib.nullcontext(None)
        )
        run = None
        with trace_ctx, span_scope(self.telemetry, "epoch", step=self._steps_run):
            with self._step_phase(phases, "admit"), span_scope(
                self.telemetry, "admit"
            ):
                self._admit_pending()
            if not self._active:
                self._finish_step(t0, phases, 0)
                return 0
            # fold nodes run concurrently: create the writer up front so
            # the lazy `_submit_write` init cannot race
            if self._writer is None:
                self._writer = BackgroundWriter(telemetry=self.telemetry)

            tenants = list(self._active.items())
            graph = TaskGraph(f"step{self._steps_run}")
            inflight: Dict[int, Tuple] = {}

            def dispatch():
                with span_scope(self.telemetry, "eval_dispatch"):
                    for tid, t in tenants:
                        task_args, task_reqs = self._gather_tenant_rounds(t)
                        if not task_args:
                            continue
                        pol = t.policy or EvalPolicy()
                        if hasattr(t.evaluator, "submit_batch"):
                            handle = t.evaluator.submit_batch(
                                task_args,
                                timeout=self._effective_timeout(t),
                                retries=pol.retries,
                                backoff=pol.backoff,
                                backoff_cap=pol.backoff_cap,
                            )
                        else:
                            handle = None
                        inflight[tid] = (handle, task_args, task_reqs)

            dispatch_node = graph.add("dispatch", dispatch, kind="dispatch")

            def make_eval(tid, t):
                def eval_node():
                    entry = inflight.get(tid)
                    if entry is None:
                        return 0
                    handle, task_args, task_reqs = entry
                    results, fatal = self._collect_results(
                        t, handle, task_args
                    )
                    if fatal is not None:
                        self._fail_tenant(t, fatal)
                        return 0
                    return self._fold_tenant_results(t, results, task_reqs)

                return eval_node

            eval_nodes: Dict[int, Any] = {}
            for tid, t in tenants:
                eval_nodes[tid] = graph.add(
                    f"eval:{t.handle.opt_id}", make_eval(tid, t),
                    deps=[dispatch_node], kind="eval",
                    tenant=t.handle.opt_id,
                )

            # provisional grouping by STATIC bucket signature (no
            # archive needed): members whose archive disqualifies them
            # are re-routed sequential by the full eligibility recheck
            # inside `initialize_epochs_batched`, reproducing lockstep
            # bucket membership exactly
            group_members: Dict[Any, List[int]] = {}
            for tid, t in tenants:
                sig = static_bucket_signature(t.strat)
                key = sig if sig is not None else ("__seq__", tid)
                group_members.setdefault(key, []).append(tid)

            def make_group(tids):
                def group_node():
                    strategies, epochs = {}, {}
                    with self._lock:
                        members = [
                            (tid, self._active.get(tid)) for tid in tids
                        ]
                    for tid, t in members:
                        if t is None:
                            continue  # retired by its eval branch
                        if t.strat.x is None and not t.strat.has_completed():
                            # no archive ever landed: nothing to fit on;
                            # re-issue/retirement is the eval fold's job
                            continue
                        strategies[tid] = t.strat
                        epochs[tid] = t.epochs_run
                    if strategies:
                        initialize_epochs_batched(
                            strategies, epochs, min_bucket=self.min_bucket,
                            telemetry=self.telemetry, logger=self.logger,
                            on_error=self._on_init_error,
                        )
                    return frozenset(strategies)

                return group_node

            group_nodes: Dict[int, Any] = {}  # tid -> its group node
            member_tids: Dict[int, List[int]] = {}  # node seq -> members
            for key, tids in group_members.items():
                kind = "seq" if key[0] == "__seq__" else "bucket"
                first = self._active[tids[0]]
                name = (
                    f"seq:{first.handle.opt_id}" if kind == "seq"
                    else f"bucket:{key[0]}_d{key[1]}_o{key[2]}_p{key[3]}"
                )
                node = graph.add(
                    name, make_group(tids),
                    deps=[eval_nodes[tid] for tid in tids], kind=kind,
                    tenant=first.handle.opt_id if kind == "seq" else None,
                )
                member_tids[node.seq] = list(tids)
                for tid in tids:
                    group_nodes[tid] = node

            def make_fold(tid, t, group):
                def fold_node():
                    advanced = group.result or frozenset()
                    if tid not in advanced:
                        return False
                    with self._lock:
                        live = self._active.get(tid)
                    if live is None:
                        return False
                    try:
                        resample = (t.epochs_run + 1) < t.n_epochs
                        state, _res, _evals = t.strat.update_epoch(
                            resample=resample
                        )
                        if state != StrategyState.CompletedEpoch:
                            raise RuntimeError(
                                f"tenant {t.handle.opt_id!r}: epoch did "
                                f"not complete in one update (state "
                                f"{state}); the service requires "
                                f"surrogate-mode tenants"
                            )
                        epoch = t.epochs_run
                        t.epochs_run += 1
                        self._absorb_tenant_costs(t)
                        self._stream_front(t, epoch)
                    except Exception as e:
                        self._fail_tenant(t, e)
                        return False
                    if t.epochs_run >= t.n_epochs:
                        t.handle.done = True
                        self._retire(t, "completed")
                        if t.owns_evaluator and hasattr(t.evaluator, "close"):
                            t.evaluator.close()
                        if self.telemetry:
                            self.telemetry.inc("tenants_completed_total")
                    return True

                return fold_node

            fold_nodes = []
            for tid, t in tenants:
                fold_nodes.append(
                    graph.add(
                        f"fold:{t.handle.opt_id}",
                        make_fold(tid, t, group_nodes[tid]),
                        deps=[group_nodes[tid]], kind="fold",
                        tenant=t.handle.opt_id,
                    )
                )

            def checkpoint_node():
                self._checkpoint()
                self._flush_writer()

            ckpt = graph.add(
                "checkpoint", checkpoint_node, deps=fold_nodes,
                kind="checkpoint",
            )

            run = graph.run(
                concurrency=self.scheduler_concurrency,
                telemetry=self.telemetry, logger=self.logger,
            )

            # a failed bucket/seq node (an exception even the batched
            # core's sequential fallback could not contain) fails its
            # still-active members — per-branch degradation, never a
            # half-stepped tenant
            for node in run.failed:
                for tid in member_tids.get(node.seq, ()):
                    self._on_init_error(tid, node.error)
            if ckpt.state != DONE:
                # the checkpoint must happen even when a failed branch
                # skipped its node (every boundary durable — the
                # lockstep contract)
                self._checkpoint()
                self._flush_writer()
            if dispatch_node.state == FAILED:
                # lockstep parity: a dispatch-time failure (broken
                # evaluator plumbing) raises out of step()
                raise dispatch_node.error

            n_advanced = sum(
                len(n.result)
                for n in run.nodes
                if n.kind in ("bucket", "seq") and n.state == DONE and n.result
            )
            # per-phase extents from node timestamps (the lockstep
            # phases, derived instead of measured around barriers)
            for phase, kinds in (
                ("eval", ("dispatch", "eval")),
                ("fit", ("bucket", "seq")),
                ("fold", ("fold",)),
            ):
                starts = [
                    n.t_start for n in run.nodes
                    if n.kind in kinds and n.t_start is not None
                ]
                ends = [
                    n.t_end for n in run.nodes
                    if n.kind in kinds and n.t_end is not None
                ]
                if starts and ends:
                    phases[phase] = max(ends) - min(starts)
                    if self.telemetry:
                        self.telemetry.observe(
                            "service_step_seconds", phases[phase],
                            phase=phase,
                        )
        if self.telemetry:
            self.telemetry.inc("service_epochs_total")
            self.telemetry.gauge("tenants_active", len(self._active))
            self.telemetry.observe(
                "phase_duration_seconds",
                time.perf_counter() - t0,
                phase="service_step",
            )
            ledger = self.telemetry.ledger
            if ledger is not None and ledger.last_capture is not None:
                # device truth for the scheduler-stall rule: seconds the
                # device sat idle inside the last profiled capture
                cap = ledger.last_capture
                self.telemetry.gauge(
                    "scheduler_device_idle_gap_seconds",
                    max(cap.window_s - cap.device_busy_s, 0.0),
                )
        self._last_graph = run.to_dict() if run is not None else {}
        self._finish_step(t0, phases, n_advanced)
        return n_advanced

    def _finish_step(self, t0: float, phases: Dict[str, float], n_advanced: int):
        """Step-end bookkeeping: the whole-step timing series, the
        per-tenant-normalized throughput baseline, and the status-file
        snapshot."""
        wall = time.perf_counter() - t0
        if self.telemetry:
            self.telemetry.observe("service_step_seconds", wall, phase="step")
        self._steps_run += 1
        self._last_step = {
            "wall_s": wall,
            "n_advanced": n_advanced,
            "phases": {k: round(v, 6) for k, v in phases.items()},
        }
        if n_advanced > 0:
            per_tenant = wall / n_advanced
            self._last_step["wall_s_per_tenant"] = per_tenant
            if (
                self._best_step_s_per_tenant is None
                or per_tenant < self._best_step_s_per_tenant
            ):
                self._best_step_s_per_tenant = per_tenant
        snap = None
        if self.health is not None:
            # the active tier: rules over (registry snapshot,
            # introspect snapshot) at this step boundary — transitions
            # become health_alert events + health_alerts_total counts
            snap = self.introspect()
            self.health.evaluate(
                self.telemetry.registry.snapshot(),
                snap,
                step=self._steps_run,
            )
            # reuse the snapshot for the status write (introspect is a
            # full per-tenant walk — once per step, not twice), with
            # only the health block refreshed to this evaluation
            snap["health"] = self.health.summary()
        self._write_status(snap)

    # ------------------------------------------------- checkpoint / resume

    def _tenant_checkpoint(self, t: _Tenant) -> Dict[str, Any]:
        """One tenant's full resumable state: archive columns, pending
        request queue (the in-flight work a crash would lose — resume
        re-issues it), RNG state, epoch counters, degradation
        accounting, and warm-refit state."""
        s = t.strat
        if isinstance(s.reqs, Iterator):
            s.reqs = deque(s.reqs)
        reqs = list(s.reqs)
        arrays: Dict[str, Any] = {
            "x": s.x, "y": s.y, "f": s.f, "c": s.c, "t": s.t,
        }
        pred_width = 0
        if reqs:
            arrays["pending_x"] = np.stack(
                [np.asarray(r.parameters) for r in reqs]
            )
            arrays["pending_epoch"] = np.asarray(
                [int(r.epoch) for r in reqs], dtype=np.int64
            )
            has_pred = np.asarray(
                [r.prediction is not None for r in reqs], dtype=bool
            )
            arrays["pending_has_pred"] = has_pred
            real = [r.prediction for r in reqs if r.prediction is not None]
            if real:
                pred_width = int(np.asarray(real[0]).ravel().shape[0])
                preds = np.full(
                    (len(reqs), pred_width), np.nan,
                    dtype=np.asarray(real[0]).dtype,
                )
                for i, r in enumerate(reqs):
                    if r.prediction is not None:
                        preds[i] = np.asarray(r.prediction).ravel()
                arrays["pending_pred"] = preds
        refit_state = (
            s.refit_controller.export_state()
            if s.refit_controller is not None
            else None
        )
        state = {
            "opt_id": t.handle.opt_id,
            "tenant_id": t.handle.tenant_id,
            "epochs_run": t.epochs_run,
            "n_epochs": t.n_epochs,
            "epoch_index": s.epoch_index,
            "optimizer_draws": s.optimizer_draws,
            "rng_state": s.local_random.bit_generator.state,
            "eval_failures": t.eval_failures,
            "failed_epochs": t.failed_epochs,
            "degraded": t.degraded,
            "quarantined": s.n_quarantined,
            "quarantined_seen": t.quarantined_seen,
            "cost_seconds": dict(t.handle.cost_seconds),
            "pred_width": pred_width,
            "refit": refit_state,
        }
        return {"config": t.submit_spec, "state": state, "arrays": arrays}

    def _checkpoint_payload(self) -> Dict[str, Any]:
        with self._lock:
            tenants = list(self._active.values()) + list(self._pending)
        return {
            "service": {
                "ts": time.time(),
                "steps": self._steps_run,
                "min_bucket": self.min_bucket,
                # ownership lease: who wrote this snapshot, and at which
                # placement epoch — what `claim_service_checkpoint`
                # verifies before a migration may adopt these tenants
                "owner": self.owner,
                "placement_epoch": self.placement_epoch,
            },
            "tenants": {
                str(t.handle.tenant_id): self._tenant_checkpoint(t)
                for t in tenants
            },
        }

    def _checkpoint(self):
        """Queue one epoch-boundary state snapshot (atomic
        write-temp-rename inside `save_service_checkpoint_to_h5`);
        `step()` flushes the writer right after, so the boundary is
        durable by the time the step returns."""
        if self.checkpoint_path is None:
            return
        from dmosopt_tpu_torch.storage import save_service_checkpoint_to_h5

        payload = self._checkpoint_payload()
        self._submit_write(
            save_service_checkpoint_to_h5, payload, self.checkpoint_path,
        )
        if self.telemetry:
            self.telemetry.inc("service_checkpoints_total")

    def _apply_restore(self, t: _Tenant, restore: Dict[str, Any]):
        """Overwrite a freshly constructed tenant with checkpointed
        state: archive, epoch counters, pending requests, RNG state.
        The construction-time xinit draw is irrelevant — the RNG state
        is restored wholesale AFTER it, and the request queue is
        replaced, so the resumed trajectory continues exactly where the
        checkpointed one stopped."""
        st = restore["state"]
        arrays = restore.get("arrays", {})
        s = t.strat
        s.x = arrays.get("x")
        s.y = arrays.get("y")
        s.f = arrays.get("f")
        s.c = arrays.get("c")
        s.t = arrays.get("t")
        s.epoch_index = int(st["epoch_index"])
        # replay the exact number of optimizer-cycle draws the
        # checkpointed run consumed (tracked, not derived: a
        # bucket-fallback epoch draws twice), so multi-optimizer
        # tenants resume on the right cycle position
        draws = int(st.get("optimizer_draws", s.epoch_index + 1))
        for _ in range(draws):
            next(s.optimizer_iter)
        s.optimizer_draws = draws
        s.local_random.bit_generator.state = st["rng_state"]
        s.n_quarantined = int(st.get("quarantined", 0))
        if s.n_quarantined:
            s.stats["n_quarantined"] = s.n_quarantined
        reqs: deque = deque()
        px = arrays.get("pending_x")
        if px is not None:
            eps = arrays.get("pending_epoch")
            has = arrays.get("pending_has_pred")
            preds = arrays.get("pending_pred")
            for i in range(px.shape[0]):
                pred = (
                    preds[i]
                    if preds is not None and has is not None and bool(has[i])
                    else None
                )
                reqs.append(EvalRequest(px[i], pred, int(eps[i])))
        s.reqs = reqs
        t.epochs_run = int(st["epochs_run"])
        t.eval_failures = int(st.get("eval_failures", 0))
        t.failed_epochs = int(st.get("failed_epochs", 0))
        t.degraded = bool(st.get("degraded", False))
        t.quarantined_seen = int(st.get("quarantined_seen", 0))
        stored_tid = int(st["tenant_id"])
        if not restore.get("adopted"):
            # resume in a fresh process keeps the stored ids; an
            # ADOPTING service already has its own tenants, so a
            # migrated tenant takes a fresh id (its opt_id is the
            # stable cross-worker identity)
            t.handle.tenant_id = stored_tid
        for k, v in (st.get("cost_seconds") or {}).items():
            t.handle.cost_seconds[k] = float(v)

    @classmethod
    def resume(
        cls,
        checkpoint_path: str,
        objectives: Dict[str, Any],
        *,
        evaluators: Optional[Dict[str, Any]] = None,
        min_bucket: Optional[int] = None,
        telemetry=None,
        logger=logger,
        status_path: Optional[str] = None,
        default_eval_timeout: float = DEFAULT_EVAL_TIMEOUT,
        checkpoint: bool = True,
        owner: Optional[str] = None,
        placement_epoch: Optional[int] = None,
        expected_owner: Optional[str] = None,
        scheduler=None,
        device=None,
    ) -> Tuple["OptimizationService", Dict[str, TenantHandle]]:
        """Reconstruct a service from its epoch-boundary checkpoint.

        Rebuilds every stored (incomplete) tenant — archive, epoch
        counters, degradation state, RNG state — re-issues its pending
        (in-flight at crash time) evaluation requests, and returns
        ``(service, {opt_id: handle})``. Objective functions are code,
        not state: supply them per tenant through ``objectives``
        (matching each stored ``opt_id``), or a ready evaluator through
        ``evaluators``. The resumed run is seeded-trajectory-equivalent
        to the uninterrupted one from the checkpointed boundary on
        (held by tests/test_torch_service.py); fronts streamed
        before the crash are in the tenants' own ``file_path`` stores,
        not replayed. With ``checkpoint=True`` (default) the resumed
        service keeps checkpointing to the same path.

        A checkpoint written by the JAX package resumes too: its
        ``jax_objective`` flag is read as ``torch_objective``, since the
        caller supplies the objective again.

        Lease handling (fleet migration, docs/robustness.md): with
        ``expected_owner`` set, resume refuses a checkpoint whose
        stored ``service.owner`` differs — the tenants were adopted by
        someone else. ``owner``/``placement_epoch`` default to the
        STORED lease, so a restarted worker resumes under its own
        identity; a tenant whose config carries an ``objective_ref``
        ("module:attr") needs no ``objectives`` entry."""
        from dmosopt_tpu_torch.storage import (
            CheckpointLeaseError,
            load_service_checkpoint_from_h5,
        )

        data = load_service_checkpoint_from_h5(checkpoint_path)
        svc_meta = data["service"]
        stored_owner = svc_meta.get("owner")
        stored_epoch = int(svc_meta.get("placement_epoch") or 0)
        if expected_owner is not None and stored_owner != expected_owner:
            raise CheckpointLeaseError(
                f"resume: checkpoint {checkpoint_path!r} is owned by "
                f"{stored_owner!r}, not {expected_owner!r} (placement "
                f"epoch {stored_epoch}) — its tenants live elsewhere now"
            )
        svc = cls(
            min_bucket=(
                int(min_bucket)
                if min_bucket is not None
                else int(svc_meta.get("min_bucket", 2))
            ),
            telemetry=telemetry,
            logger=logger,
            status_path=status_path,
            default_eval_timeout=default_eval_timeout,
            checkpoint_path=checkpoint_path if checkpoint else None,
            owner=owner if owner is not None else stored_owner,
            placement_epoch=(
                int(placement_epoch)
                if placement_epoch is not None
                else stored_epoch
            ),
            scheduler=scheduler,
            device=device,
        )
        evaluators = evaluators or {}
        objectives = objectives or {}
        handles: Dict[str, TenantHandle] = {}
        max_tid = -1
        for key in sorted(data["tenants"], key=int):
            tp = data["tenants"][key]
            cfg = dict(tp["config"] or {})
            st = tp["state"]
            opt_id = st["opt_id"]
            obj = objectives.get(opt_id)
            evaluator = evaluators.get(opt_id)
            if obj is None and evaluator is None and not cfg.get(
                "objective_ref"
            ):
                raise ValueError(
                    f"resume: no objective (or evaluator, or stored "
                    f"objective_ref) supplied for stored tenant {opt_id!r}"
                )
            _torch_flag(cfg)
            space = cfg.pop("space")
            objective_names = cfg.pop("objective_names")
            handles[opt_id] = svc.submit(
                obj, space, objective_names,
                opt_id=opt_id, evaluator=evaluator, _restore=tp, **cfg,
            )
            max_tid = max(max_tid, int(st["tenant_id"]))
        svc._ids = itertools.count(max_tid + 1)
        return svc, handles

    def adopt_checkpoint(
        self,
        checkpoint_path: str,
        objectives: Optional[Dict[str, Any]] = None,
        *,
        expected_owner: Optional[str],
        placement_epoch: int,
        evaluators: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, TenantHandle]:
        """Live tenant migration: adopt every incomplete tenant stored
        in ANOTHER worker's epoch-boundary checkpoint into this running
        service. The dead worker's tenants join this service's buckets
        at the next `step()` and continue seeded-trajectory-equivalent
        (the checkpoint restores archive, RNG state, epoch counters,
        pending requests and degradation accounting — the same contract
        `resume` pins bitwise).

        The adoption first CLAIMS the checkpoint's ownership lease
        (`storage.claim_service_checkpoint`): the stored owner must be
        ``expected_owner`` and the stored placement epoch must be older
        than ``placement_epoch``, and the claim rewrites the stored
        lease to this service's ``owner`` — so a second adopter raises
        `storage.CheckpointLeaseError` instead of double-owning the
        tenants. Objective functions resolve per tenant from
        ``objectives``/``evaluators`` or the stored ``objective_ref``.
        Returns ``{opt_id: TenantHandle}`` for the adopted tenants."""
        if self._closed:
            raise RuntimeError("service is closed")
        from dmosopt_tpu_torch.storage import (
            claim_service_checkpoint,
            load_service_checkpoint_from_h5,
        )

        data = load_service_checkpoint_from_h5(checkpoint_path)
        objectives = objectives or {}
        evaluators = evaluators or {}
        # validate EVERY stored tenant BEFORE claiming the lease: the
        # claim is consumed (owner rewritten) even if adoption then
        # fails, which would orphan the tenants — a validation error
        # must leave the checkpoint adoptable by someone else
        own_ids = {
            t.handle.opt_id
            for t in list(self._active.values()) + list(self._pending)
        }
        for key in data["tenants"]:
            tp = data["tenants"][key]
            cfg = tp["config"] or {}
            opt_id = tp["state"]["opt_id"]
            if opt_id in own_ids:
                raise ValueError(
                    f"adopt: tenant {opt_id!r} already lives in this "
                    f"service — opt_ids are the cross-worker identity "
                    f"and must be fleet-unique"
                )
            if (
                objectives.get(opt_id) is None
                and evaluators.get(opt_id) is None
                and not cfg.get("objective_ref")
            ):
                raise ValueError(
                    f"adopt: no objective (or evaluator, or stored "
                    f"objective_ref) available for tenant {opt_id!r}"
                )
        claim_service_checkpoint(
            checkpoint_path, expected_owner, self.owner,
            int(placement_epoch), logger=self.logger,
        )
        handles: Dict[str, TenantHandle] = {}
        for key in sorted(data["tenants"], key=int):
            tp = dict(data["tenants"][key])
            cfg = dict(tp["config"] or {})
            st = tp["state"]
            opt_id = st["opt_id"]
            obj = objectives.get(opt_id)
            evaluator = evaluators.get(opt_id)
            _torch_flag(cfg)
            space = cfg.pop("space")
            objective_names = cfg.pop("objective_names")
            tp["adopted"] = True
            handles[opt_id] = self.submit(
                obj, space, objective_names,
                opt_id=opt_id, evaluator=evaluator, _restore=tp, **cfg,
            )
        self.logger.info(
            f"adopted {len(handles)} tenant(s) from {checkpoint_path} "
            f"(previous owner {expected_owner!r}, placement epoch "
            f"{placement_epoch})"
        )
        return handles

    # ------------------------------------------------------ introspection

    @staticmethod
    def _tenant_snapshot(t: _Tenant, state: str) -> Dict[str, Any]:
        cost = dict(t.handle.cost_seconds)
        snap = {
            "opt_id": t.handle.opt_id,
            "tenant_id": t.handle.tenant_id,
            "state": state,
            "epoch": t.epochs_run,
            "n_epochs": t.n_epochs,
            "cost_seconds": {k: round(v, 6) for k, v in cost.items()},
        }
        # attributed throughput: the tenant's generation budget over its
        # attributed EA seconds per epoch — only meaningful once a
        # batched epoch has landed a cost share
        if cost.get("ea", 0.0) > 0 and t.epochs_run > 0:
            snap["gens_per_sec"] = round(
                t.strat.num_generations * t.epochs_run / cost["ea"], 3
            )
        # degradation state (docs/robustness.md): only surfaced once a
        # fault has actually touched the tenant, so healthy snapshots
        # stay exactly as small as before
        if t.degraded or t.eval_failures or t.failed_epochs:
            snap["degraded"] = t.degraded
            snap["eval_failures_total"] = t.eval_failures
            snap["failed_epochs_consecutive"] = t.failed_epochs
            if t.last_success_fraction is not None:
                snap["last_success_fraction"] = round(
                    t.last_success_fraction, 3
                )
        if t.quarantined_seen:
            snap["points_quarantined_total"] = t.quarantined_seen
        return snap

    def _retire_summary(self, t: _Tenant, state: str) -> Dict[str, Any]:
        return self._tenant_snapshot(t, state)

    def _throughput_check(self) -> Dict[str, Any]:
        """Loadavg-normalized step-throughput regression check: a
        contended host inflates wall clocks 3-9x, so a slow step on a loaded machine
        reads ``host_contended`` (re-measure idle before believing it),
        while a slow step on an idle machine is a genuine
        ``regression_suspect``. Baseline = the best per-tenant step
        wall this service has seen."""
        try:
            load1 = os.getloadavg()[0]
        except OSError:  # pragma: no cover - platform without loadavg
            load1 = None
        ncpu = os.cpu_count() or 1
        last = self._last_step.get("wall_s_per_tenant")
        best = self._best_step_s_per_tenant
        out: Dict[str, Any] = {
            "last_step_s_per_tenant": round(last, 6) if last else last,
            "best_step_s_per_tenant": round(best, 6) if best else best,
            "loadavg_1m": round(load1, 2) if load1 is not None else None,
            "cpu_count": ncpu,
            "load_ratio": (
                round(load1 / ncpu, 3) if load1 is not None else None
            ),
        }
        if last is None or best is None:
            out["status"] = "no_data"
        elif last <= 2.0 * best:
            out["status"] = "ok"
        elif load1 is not None and load1 > 1.5 * ncpu:
            out["status"] = "host_contended"
            out["note"] = (
                "step wall regressed but the host is contended "
                "(1-min loadavg above 1.5x cores) — walls can be 3-9x "
                "inflated; re-measure idle before trusting this"
            )
        else:
            out["status"] = "regression_suspect"
            out["note"] = (
                "step wall regressed more than 2x against this "
                "service's best on an apparently idle host"
            )
        return out

    def introspect(self) -> Dict[str, Any]:
        """Live service snapshot: every tenant's state/epoch/attributed
        cost, queue depths (pending submissions, writer backlog),
        telemetry series-overflow state, the last step's per-phase
        seconds, and the loadavg-normalized throughput check. Plain
        JSON-able dict — also written to ``status_path`` after every
        step and rendered by the ``status`` CLI subcommand. Safe to
        call from a monitoring thread while another thread steps.
        ``tenant_counts`` is cumulative and exact; the ``tenants`` list
        shows active/pending tenants plus the most recent retirees (the
        `_retired` bound), not the full lifetime history."""
        with self._lock:
            pending_tenants = list(self._pending)
            active_tenants = list(self._active.values())
            retired = list(self._retired)
            counts = dict(self._retired_counts)
        tenants = [
            self._tenant_snapshot(t, "active") for t in active_tenants
        ]
        tenants.extend(
            self._tenant_snapshot(t, "pending") for t in pending_tenants
        )
        tenants.extend(retired)
        if active_tenants:
            counts["active"] = len(active_tenants)
        if pending_tenants:
            counts["pending"] = len(pending_tenants)
        overflow = 0.0
        if self.telemetry:
            overflow = self.telemetry.registry.counter_value(
                "telemetry_series_overflow_total"
            )
        snap = {
            "ts": time.time(),
            "closed": self._closed,
            "steps": self._steps_run,
            "tenant_counts": counts,
            "tenants": sorted(tenants, key=lambda t: t["tenant_id"]),
            "queue_depths": {
                "pending_submissions": len(pending_tenants),
                "writer_backlog": (
                    self._writer.queue_depth if self._writer is not None else 0
                ),
            },
            # persistence health: a dead writer degrades the service
            # (fronts/checkpoints stop) instead of crashing it — this is
            # where that state is visible (plus the `status` CLI)
            "writer": {
                "failed": (
                    self._writer.writer_failed
                    if self._writer is not None
                    else False
                ),
                "retries_total": (
                    self._writer.retries_total
                    if self._writer is not None
                    else 0
                ),
            },
            "checkpoint_path": self.checkpoint_path,
            "lease": {
                "owner": self.owner,
                "placement_epoch": self.placement_epoch,
            },
            "series_overflow_total": overflow,
            "last_step": dict(self._last_step),
            "throughput": self._throughput_check(),
        }
        if self.health is not None:
            # alert state (docs/observability.md "Run-health engine"):
            # firing alerts with severities — what /healthz serves and
            # the status CLI renders as the health block
            snap["health"] = self.health.summary()
        if self.exporter is not None:
            snap["exporter"] = {
                "host": self.exporter.host,
                "port": self.exporter.port,
                "url": self.exporter.url,
            }
        if self.telemetry and self.telemetry.tracer is not None:
            snap["trace_path"] = self.telemetry.tracer.path
            # span-buffer pressure: evictions past `trace_max_spans`
            snap["spans_dropped"] = self.telemetry.tracer.spans_dropped
        if self.scheduler_concurrency:
            # task-graph scheduler state (docs/parallel.md "Async
            # task-graph epochs"): last step's per-node states and
            # wait/run seconds — the host-side view the scheduler_*
            # metrics aggregate
            snap["scheduler"] = {
                "concurrency": self.scheduler_concurrency,
                "last_graph": dict(self._last_graph),
            }
        ledger = self.telemetry.ledger if self.telemetry else None
        if ledger is not None and ledger.has_data:
            # device truth (profiled steps only): per-program device
            # times, trace-derived busy/overlap fractions, per-tenant
            # device seconds — the ground truth the host-clock
            # throughput check above only estimates
            snap["device_ledger"] = ledger.summary()
        return snap

    def _write_status(self, snap: Optional[Dict[str, Any]] = None):
        """Atomically publish the introspection snapshot to
        ``status_path`` (tmp + rename, so a concurrent `status` CLI
        reader never sees a torn file). ``snap`` lets `_finish_step`
        reuse the snapshot it already built for the health evaluation.
        Best-effort: a failing status write must never take the
        service down."""
        if self.status_path is None:
            return
        try:
            tmp = self.status_path + ".tmp"
            with open(tmp, "w") as fh:
                json.dump(
                    snap if snap is not None else self.introspect(),
                    fh, default=json_default,
                )
            os.replace(tmp, self.status_path)
        except OSError:
            self.logger.warning(
                f"status snapshot write to {self.status_path!r} failed",
                exc_info=True,
            )

    def run(self, max_steps: Optional[int] = None) -> int:
        """Step until every submitted tenant completes (or `max_steps`);
        returns the number of steps taken."""
        steps = 0
        while (self._active or self._pending) and (
            max_steps is None or steps < max_steps
        ):
            self.step()
            steps += 1
        return steps

    # ------------------------------------------------------------- close

    def close(self):
        if self._closed:
            return
        # graceful-shutdown checkpoint: still-running tenants' state
        # survives a deliberate close, so close() + resume() is a clean
        # migration (a tenant cancelled below is still incomplete in
        # the snapshot and resumes where it stopped)
        self._checkpoint()
        self._closed = True
        with self._lock:
            to_cancel = list(self._active.values()) + list(self._pending)
        for t in to_cancel:
            t.handle.done = True
            self._retire(t, "cancelled")
            if t.epochs_run < t.n_epochs and t.handle.error is None:
                # an interim (or absent) front must not read as a
                # completed optimization: result() re-raises this, while
                # best()/updates() still serve whatever was streamed
                t.handle.error = RuntimeError(
                    f"service closed before tenant {t.handle.opt_id!r} "
                    f"completed ({t.epochs_run}/{t.n_epochs} epochs)"
                )
            if t.owns_evaluator and hasattr(t.evaluator, "close"):
                try:
                    t.evaluator.close()
                except Exception:
                    self.logger.exception(
                        f"tenant {t.handle.opt_id!r}: evaluator close failed"
                    )
        with self._lock:
            self._active.clear()
            self._pending = []
        if self._writer is not None:
            try:
                self._writer.close()
            except RuntimeError:
                self._note_writer_dead()
            self._writer = None
        self._write_status()
        if self.exporter is not None:
            # after the final status write: the last scrape a prober
            # can land observes the closed-service snapshot, then the
            # exporter thread is joined
            self.exporter.close()
            self.exporter = None
        if self.telemetry is not None and self._owns_telemetry:
            # exports the Chrome trace when a trace_path is configured
            self.telemetry.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
