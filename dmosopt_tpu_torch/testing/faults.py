"""Deterministic fault injection for the service stack.

Port of ``dmosopt_tpu/testing/faults.py``, the same code over the
port's evaluators. The service replaces the reference's MPI environment
with threads and a device queue, so its failure modes are manufactured
to be tested, reproducibly:

- `FaultPlan`: a seeded, declarative list of `FaultRule`s. Every
  injection decision is a **stateless hash** of (plan seed, rule index,
  target, per-target call index), with no shared random stream, so the
  same plan fires the same faults on the same calls whatever the thread
  interleaving or evaluation order; both packages' plans decide alike.
- `FaultyEvaluator`: wraps any evaluator backend. For host evaluators
  (`parallel.evaluator.HostFunEvaluator`) the faults fire inside the
  objective call (``eval_fun``), so the real timeout, retry and
  abandonment machinery of `parallel.evaluator._HostEvalHandle` runs;
  for result-streaming backends (`parallel.evaluator.TorchBatchEvaluator`,
  where the JAX package wraps its jitted batch evaluator) faults apply
  at the result layer as each item is polled.
- `FaultyStore`: wraps persistence closures with transient IO errors,
  the `BackgroundWriter` retry path's test double.

Fault kinds: ``raise`` (objective exception), ``hang`` (sleep past the
eval timeout), ``delay`` (straggler: sleep, then succeed), ``nan``
(return non-finite objectives "successfully", the archive-poisoning
case the quarantine guard exists for), ``io_error`` (transient
`OSError` from a store write), ``kill`` (SIGKILL the process), and the
worker-level kinds ``heartbeat_hang`` / ``partition`` (op ``"worker"``,
for a fleet worker harness).

Env gating: `OptimizationService` reads ``DMOSOPT_FAULT_PLAN`` (a JSON
plan spec, or ``@/path/to/plan.json``) at construction and wraps every
tenant evaluator it builds. Unset, nothing is imported and nothing is
wrapped.
"""

from __future__ import annotations

import fnmatch
import hashlib
import json
import os
import signal
import threading
import time
from dataclasses import dataclass, fields
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

#: environment variable holding a JSON plan spec (or ``@path`` to one)
FAULT_PLAN_ENV = "DMOSOPT_FAULT_PLAN"

FAULT_KINDS = (
    "raise", "hang", "delay", "nan", "io_error", "kill",
    # worker-level kinds (op="worker"; interpreted by the fleet worker
    # harness once per supervision loop): "heartbeat_hang" suppresses
    # the status-file heartbeat while the rule keeps firing (the
    # wedged-but-alive worker the supervisor's deadline policy exists
    # for), "partition" additionally closes the worker's metrics
    # exporter so liveness probes blackhole (the network-partition
    # shape: the worker keeps computing, the supervisor sees nothing)
    "heartbeat_hang", "partition",
)

#: injection sites a rule can bind to ("worker" targets a fleet worker
#: id, consulted once per worker supervision loop)
FAULT_OPS = ("eval", "io", "worker")


class InjectedFault(RuntimeError):
    """The exception `raise`-kind eval faults throw — its own type so
    tests and logs can tell an injected failure from a real one."""


@dataclass(frozen=True)
class FaultRule:
    """One declarative injection rule.

    kind: one of `FAULT_KINDS`.
    target: fnmatch pattern over the injection target name (a tenant's
        ``opt_id`` for eval faults, the store label for io faults).
    op: injection site — ``"eval"`` (objective calls) or ``"io"``
        (persistence closures).
    p: per-call firing probability (seeded, stateless — see
        `FaultPlan._chance`); 1.0 fires on every matching call.
    after: skip the first `after` matching calls per target (calls are
        counted per (op, target), so "fail from epoch 2 on" is
        expressible as an initial-design + resample call count).
    count: stop after this many fires (None = unlimited) — transient
        faults are ``count=1``.
    delay_s: sleep seconds for ``hang`` / ``delay``.
    message: exception text for ``raise`` / ``io_error``.
    """

    kind: str
    target: str = "*"
    op: str = "eval"
    p: float = 1.0
    after: int = 0
    count: Optional[int] = None
    delay_s: float = 0.05
    message: str = "injected fault"

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"fault kind {self.kind!r} not in {FAULT_KINDS}")
        if self.op not in FAULT_OPS:
            raise ValueError(f"fault op {self.op!r} not in {FAULT_OPS}")
        if not (0.0 <= self.p <= 1.0):
            raise ValueError(f"fault p must be in [0, 1]; got {self.p}")


class FaultPlan:
    """A seeded set of fault rules with per-target call accounting.

    One plan instance is shared by every wrapper it drives (the service
    holds one per process run), so `after`/`count` windows are counted
    consistently across retries and epochs. `injected` logs every fire
    as ``(op, target, call_index, kind)`` for test assertions.
    """

    def __init__(
        self,
        rules: Sequence[Union[FaultRule, Dict[str, Any]]],
        seed: int = 0,
    ):
        self.seed = int(seed)
        self.rules: List[FaultRule] = [
            r if isinstance(r, FaultRule) else FaultRule(**r) for r in rules
        ]
        self._lock = threading.Lock()
        self._calls: Dict[Tuple[str, str], int] = {}
        self._fires: Dict[Tuple[int, str], int] = {}
        self.injected: List[Tuple[str, str, int, str]] = []

    # ------------------------------------------------------------ spec IO

    @classmethod
    def from_spec(cls, spec: Union[str, Dict[str, Any]]) -> "FaultPlan":
        """Build a plan from ``{"seed": int, "rules": [rule dicts]}`` (a
        dict or its JSON string)."""
        if isinstance(spec, str):
            spec = json.loads(spec)
        if not isinstance(spec, dict) or "rules" not in spec:
            raise ValueError(
                "fault plan spec must be a dict with a 'rules' list"
            )
        return cls(spec["rules"], seed=spec.get("seed", 0))

    @classmethod
    def from_env(cls, environ=None) -> Optional["FaultPlan"]:
        """The plan named by ``DMOSOPT_FAULT_PLAN`` (inline JSON, or
        ``@path`` to a JSON file), or None when the variable is unset —
        the zero-cost default."""
        environ = os.environ if environ is None else environ
        raw = environ.get(FAULT_PLAN_ENV)
        if not raw:
            return None
        if raw.startswith("@"):
            with open(raw[1:]) as fh:
                raw = fh.read()
        return cls.from_spec(raw)

    def to_spec(self) -> Dict[str, Any]:
        return {
            "seed": self.seed,
            "rules": [
                {f.name: getattr(r, f.name) for f in fields(r)}
                for r in self.rules
            ],
        }

    # ----------------------------------------------------------- decisions

    def _chance(self, rule_idx: int, target: str, call_index: int) -> float:
        """Stateless uniform draw in [0, 1): a hash of the full
        coordinate, so firing decisions are independent of thread
        interleaving and of every other rule's decisions."""
        h = hashlib.sha256(
            f"{self.seed}:{rule_idx}:{target}:{call_index}".encode()
        ).hexdigest()
        return int(h[:12], 16) / float(1 << 48)

    def next_fault(self, op: str, target: str) -> Optional[FaultRule]:
        """Record one call against (op, target) and return the rule that
        fires on it, if any (first matching rule wins)."""
        target = str(target)
        with self._lock:
            i = self._calls.get((op, target), 0)
            self._calls[(op, target)] = i + 1
            for ridx, rule in enumerate(self.rules):
                if rule.op != op or not fnmatch.fnmatch(target, rule.target):
                    continue
                if i < rule.after:
                    continue
                key = (ridx, target)
                if rule.count is not None and self._fires.get(key, 0) >= rule.count:
                    continue
                if rule.p < 1.0 and self._chance(ridx, target, i) >= rule.p:
                    continue
                self._fires[key] = self._fires.get(key, 0) + 1
                self.injected.append((op, target, i, rule.kind))
                return rule
        return None

    def calls(self, op: str, target: str) -> int:
        with self._lock:
            return self._calls.get((op, str(target)), 0)

    def fires(self, kind: Optional[str] = None, target: Optional[str] = None) -> int:
        with self._lock:
            return sum(
                1
                for (_op, tgt, _i, k) in self.injected
                if (kind is None or k == kind)
                and (target is None or tgt == target)
            )


# ----------------------------------------------------------- result nan-ify


def _nanify(result):
    """Replace every numeric payload of a worker-protocol result dict
    (``{problem_id: y | (y, f[, c]), "time": t}``) with NaNs of the
    same shape — the "successful" non-finite return the quarantine
    guard exists for."""

    def nan_like(v):
        if isinstance(v, tuple):
            return tuple(nan_like(o) for o in v)
        arr = np.asarray(v, dtype=np.float64)
        return np.full_like(arr, np.nan)

    if not isinstance(result, dict):
        return nan_like(result)
    return {
        k: (v if k == "time" else nan_like(v)) for k, v in result.items()
    }


def _perform_eval_fault(rule: FaultRule):
    """Side-effecting part of an eval fault (everything except nan,
    which needs the real result). Returns normally for delay/hang."""
    if rule.kind == "kill":
        os.kill(os.getpid(), signal.SIGKILL)
    if rule.kind == "raise":
        raise InjectedFault(rule.message)
    if rule.kind in ("hang", "delay"):
        time.sleep(rule.delay_s)


# --------------------------------------------------------------- evaluators


class _FaultyHandle:
    """Result-layer fault application for streaming evaluator handles
    (the torch batch backend, where per-call injection is impossible:
    the whole batch is one objective call on the device)."""

    def __init__(self, inner, plan: FaultPlan, target: str):
        self._inner = inner
        self._plan = plan
        self._target = target

    def _apply(self, item):
        if item is None:
            return None
        index, res = item
        rule = self._plan.next_fault("eval", self._target)
        if rule is None:
            return item
        if rule.kind in ("hang", "delay"):
            time.sleep(rule.delay_s)
            return item
        if rule.kind == "kill":
            os.kill(os.getpid(), signal.SIGKILL)
        if rule.kind == "raise":
            from dmosopt_tpu_torch.parallel.evaluator import EvalFailure

            return index, EvalFailure(InjectedFault(rule.message), 1)
        if rule.kind == "nan":
            return index, _nanify(res)
        return item

    def poll(self, timeout: Optional[float] = None):
        return self._apply(self._inner.poll(timeout))

    def drain_completed(self):
        return [self._apply(item) for item in self._inner.drain_completed()]

    def __getattr__(self, name):
        return getattr(self._inner, name)


class FaultyEvaluator:
    """Wrap an evaluator backend with a fault plan.

    Host evaluators (anything exposing ``eval_fun``) get faults injected
    *at the objective-call layer*, so timeouts, retries, backoff and
    pool-abandonment run exactly as they would against a real flaky
    objective: the wrapper presents its own faulty ``eval_fun`` and
    builds the REAL `_HostEvalHandle` over itself, delegating the pool
    and abandonment accounting to the inner evaluator. Other backends
    get result-layer injection through a wrapped handle.

    The inner evaluator is NEVER mutated: a caller-owned evaluator
    stays clean after the service closes, and the same inner instance
    wrapped for two tenants counts each tenant's fault-plan call
    windows independently. All other attributes delegate, so the
    wrapper is drop-in anywhere an evaluator goes.
    """

    def __init__(self, inner, plan: FaultPlan, target: str):
        self.inner = inner
        self.plan = plan
        self.target = str(target)
        self._host = hasattr(inner, "eval_fun")
        if self._host:
            # own attribute (not a patch on inner): the host-handle
            # machinery reads its evaluator's `eval_fun`, and the
            # service's host-likeness probe is hasattr-based
            self.eval_fun = self._faulty_eval_fun

    def _faulty_eval_fun(self, payload):
        rule = self.plan.next_fault("eval", self.target)
        if rule is not None:
            _perform_eval_fault(rule)
            if rule.kind == "nan":
                return _nanify(self.inner.eval_fun(payload))
        return self.inner.eval_fun(payload)

    def evaluate_batch(self, space_vals_list):
        if self._host:
            # mirror HostFunEvaluator.evaluate_batch over the faulty
            # objective (inner's pool when one exists, else inline)
            pool = getattr(self.inner, "_pool", None)
            if pool is not None:
                return list(pool.map(self._faulty_eval_fun, space_vals_list))
            return [self._faulty_eval_fun(sv) for sv in space_vals_list]
        out = []
        for res in self.inner.evaluate_batch(space_vals_list):
            rule = self.plan.next_fault("eval", self.target)
            if rule is None:
                out.append(res)
                continue
            _perform_eval_fault(rule)
            out.append(_nanify(res) if rule.kind == "nan" else res)
        return out

    def submit_batch(self, space_vals_list, **kwargs):
        if self._host:
            from dmosopt_tpu_torch.parallel.evaluator import _HostEvalHandle

            tel = getattr(self.inner, "telemetry", None)
            if tel:
                tel.inc("eval_batches_total", backend="host")
            # the REAL handle, with this wrapper as the evaluator: its
            # attempts call the faulty eval_fun while pool management
            # and abandonment accounting delegate to the inner instance
            return _HostEvalHandle(
                self, list(space_vals_list),
                kwargs.get("timeout"), kwargs.get("retries", 0),
                backoff=kwargs.get("backoff", 0.0),
                backoff_cap=kwargs.get("backoff_cap", 30.0),
            )
        handle = self.inner.submit_batch(space_vals_list, **kwargs)
        return _FaultyHandle(handle, self.plan, self.target)

    def close(self, *args, **kwargs):
        return self.inner.close(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self.inner, name)


# -------------------------------------------------------------------- store


class FaultyStore:
    """Inject transient IO faults into persistence closures.

    ``wrap(fn)`` returns a closure that consults the plan before every
    execution: ``io_error`` raises `OSError` (the `BackgroundWriter`'s
    retryable class), ``raise`` raises a non-retryable error, ``delay``
    sleeps first. Submit wrapped closures to a writer to drive its
    retry/backoff/death paths deterministically.
    """

    def __init__(self, plan: FaultPlan, target: str = "writer"):
        self.plan = plan
        self.target = str(target)

    def wrap(self, fn):
        def wrapped(*args, **kwargs):
            rule = self.plan.next_fault("io", self.target)
            if rule is not None:
                if rule.kind in ("hang", "delay"):
                    time.sleep(rule.delay_s)
                elif rule.kind == "io_error":
                    raise OSError(rule.message)
                elif rule.kind == "raise":
                    raise InjectedFault(rule.message)
                elif rule.kind == "kill":
                    os.kill(os.getpid(), signal.SIGKILL)
            return fn(*args, **kwargs)

        return wrapped
