"""Adaptive termination for high-dimensional multi-objective problems.

Port of ``dmosopt_tpu/adaptive_termination.py``, copied: that module imports no JAX,
and the port keeps its own copy, its imports pointed at the port.

Capability match: reference `dmosopt/adaptive_termination.py` —
`PerObjectiveConvergence` (:48), `MultiScaleStagnationTermination`
(:158), `AdaptiveWindowTermination` (:278), `CompositeAdaptiveTermination`
(:365), `ResourceAwareTermination` (:461), and the
`create_adaptive_termination` factory (:531) with strategies
comprehensive/fast/conservative/simple. Wired in by `DistOptStrategy`
when `termination_conditions` is truthy.

Structural redesign (not a port): the reference threads every criterion
through a _store/_metric/_decide sliding-window protocol holding lists
of dicts, with one `ConvergenceState` object (a deque + three scalars)
per objective updated in a Python loop. Here all criteria share one
`ObjectiveTrace` — a fixed-capacity ring buffer of per-generation
population statistics stored as dense `(capacity, d)` arrays — and
every per-objective computation (ideal-point deltas at arbitrary lags,
stagnation counters, convergence flags) is a vectorized array
operation over the objective axis. Decision cadence (`nth_gen`) and the
generation cap are handled uniformly in `_TracedTermination`.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from dmosopt_tpu_torch.hv_termination import HypervolumeProgressTermination
from dmosopt_tpu_torch.termination import (
    MaximumGenerationTermination,
    Termination,
    TerminationCollection,
)


class ObjectiveTrace:
    """Ring-buffer history of population statistics, one row per
    generation observed: ideal point and nadir point. Rows are dense
    arrays so queries over the objective axis vectorize; lagged lookups
    are O(1) index arithmetic.
    """

    def __init__(self, capacity: int, n_objectives: int):
        self.capacity = int(capacity)
        self.n_seen = 0
        self._ideal = np.full((self.capacity, n_objectives), np.nan)
        self._nadir = np.full((self.capacity, n_objectives), np.nan)

    def observe(self, F: np.ndarray) -> None:
        row = self.n_seen % self.capacity
        self._ideal[row] = F.min(axis=0)
        self._nadir[row] = F.max(axis=0)
        self.n_seen += 1

    def __len__(self) -> int:
        return min(self.n_seen, self.capacity)

    def _row(self, lag: int) -> int:
        # lag=0 is the latest observation
        return (self.n_seen - 1 - lag) % self.capacity

    def ideal(self, lag: int = 0) -> np.ndarray:
        return self._ideal[self._row(lag)]

    def span(self) -> np.ndarray:
        """Current nadir-ideal span, floored for safe division."""
        s = self._nadir[self._row(0)] - self._ideal[self._row(0)]
        return np.where(s < 1e-32, 1.0, s)

    def ideal_delta(self, lag: int) -> Optional[np.ndarray]:
        """Per-objective |ideal_now - ideal_lag| normalized by the current
        span; None until `lag+1` observations exist."""
        if len(self) < lag + 1:
            return None
        return np.abs(self.ideal(0) - self.ideal(lag)) / self.span()


class _TracedTermination(Termination):
    """Shared skeleton: feed the trace every call, decide every
    `nth_gen` generations, stop unconditionally past `n_max_gen`."""

    def __init__(
        self,
        problem,
        capacity: int,
        nth_gen: int = 1,
        n_max_gen: Optional[int] = None,
        **_ignored,
    ):
        super().__init__(problem)
        self.nth_gen = int(nth_gen)
        self.n_max_gen = np.inf if n_max_gen is None else n_max_gen
        self.trace = ObjectiveTrace(capacity, problem.n_objectives)

    def _do_continue(self, opt):
        if opt.n_gen > self.n_max_gen:
            self._log(
                f"Optimization terminated: maximum number of generations "
                f"({opt.n_gen}) has been reached"
            )
            return False
        self.trace.observe(np.asarray(opt.y))
        self._update()
        if opt.n_gen % self.nth_gen != 0:
            return True
        return self._continue_from_trace()

    def _update(self) -> None:
        """Per-observation bookkeeping (optional)."""

    def _continue_from_trace(self) -> bool:  # pragma: no cover - abstract
        return True


class PerObjectiveConvergence(_TracedTermination):
    """Track each objective's ideal-point progress independently;
    terminate when a fraction has converged.

    Same criterion as reference adaptive_termination.py:48-155, with the
    per-objective deque-of-deltas bookkeeping replaced by a single
    `(n_last, d)` delta ring and integer/bool arrays over the objective
    axis: an objective converges after `patience` consecutive checks
    whose windowed mean delta is below `obj_tol`.
    """

    def __init__(
        self,
        problem,
        obj_tol: float = 1e-4,
        min_converged_fraction: float = 0.8,
        n_last: int = 20,
        nth_gen: int = 5,
        n_max_gen: Optional[int] = None,
        patience: int = 3,
        **kwargs,
    ):
        super().__init__(
            problem, capacity=n_last + 1, nth_gen=nth_gen, n_max_gen=n_max_gen
        )
        d = problem.n_objectives
        self.obj_tol = obj_tol
        self.min_converged_fraction = min_converged_fraction
        self.n_last = int(n_last)
        self.patience = int(patience)
        self._deltas = np.full((self.n_last, d), np.nan)
        self._n_deltas = 0
        self.stagnation = np.zeros(d, dtype=int)
        self.converged = np.zeros(d, dtype=bool)

    def _update(self):
        delta = self.trace.ideal_delta(1)
        if delta is None:
            return
        self._deltas[self._n_deltas % self.n_last] = delta
        self._n_deltas += 1
        if self._n_deltas < self.n_last:
            return
        mean_change = self._deltas.mean(axis=0)  # (d,)
        self.improvement_rate = mean_change
        below = mean_change < self.obj_tol
        self.stagnation = np.where(below, self.stagnation + 1, 0)
        self.converged = self.stagnation >= self.patience

    def _continue_from_trace(self):
        d = self.converged.size
        n_conv = int(self.converged.sum())
        if n_conv / d >= self.min_converged_fraction:
            self._log(
                f"Optimization terminated: {n_conv}/{d} objectives "
                f"({n_conv / d:.1%}) have converged"
            )
            return False
        return True


class MultiScaleStagnationTermination(_TracedTermination):
    """Stagnation must show simultaneously at several timescales before
    stopping (same criterion as reference adaptive_termination.py:158-275:
    mean normalized ideal-point change over lags [5,10,20,40] by default).
    One trace query per scale; no per-scale history objects."""

    def __init__(
        self,
        problem,
        timescales: Sequence[int] = (5, 10, 20, 40),
        stagnation_tol: float = 1e-4,
        min_scales_stagnant: int = 3,
        n_max_gen: Optional[int] = None,
        nth_gen: int = 1,
        **kwargs,
    ):
        self.timescales = sorted(int(s) for s in timescales)
        super().__init__(
            problem,
            capacity=max(self.timescales) + 1,
            nth_gen=nth_gen,
            n_max_gen=n_max_gen,
        )
        self.stagnation_tol = stagnation_tol
        self.min_scales_stagnant = int(min_scales_stagnant)

    def stagnant_scales(self) -> List[int]:
        out = []
        for scale in self.timescales:
            delta = self.trace.ideal_delta(scale)
            if delta is not None and float(delta.mean()) < self.stagnation_tol:
                out.append(scale)
        return out

    def _continue_from_trace(self):
        # no decision until the longest horizon has actually been measured
        # (the reference's min_data_for_metric=max(timescales) gate)
        if len(self.trace) < max(self.timescales) + 1:
            return True
        stagnant = self.stagnant_scales()
        if len(stagnant) >= self.min_scales_stagnant:
            self._log(
                f"Optimization terminated: {len(stagnant)}/"
                f"{len(self.timescales)} timescales show stagnation "
                f"(scales: {stagnant})"
            )
            return False
        return True


class AdaptiveWindowTermination(_TracedTermination):
    """Mean ideal-point delta over a window whose size grows while the
    optimizer is still making progress (same criterion as reference
    adaptive_termination.py:278-362). The delta history lives in one
    ring sized for the maximum window, so growth never reallocates."""

    def __init__(
        self,
        problem,
        initial_window: int = 10,
        max_window: int = 50,
        expansion_rate: float = 1.2,
        tol: float = 1e-4,
        n_max_gen: Optional[int] = None,
        **kwargs,
    ):
        super().__init__(problem, capacity=2, nth_gen=1, n_max_gen=n_max_gen)
        self.window = int(initial_window)
        self.max_window = int(max_window)
        self.expansion_rate = expansion_rate
        self.tol = tol
        self._deltas = np.full((self.max_window,), np.nan)
        self._n_deltas = 0

    def _update(self):
        delta = self.trace.ideal_delta(1)
        if delta is not None:
            self._deltas[self._n_deltas % self.max_window] = float(delta.mean())
            self._n_deltas += 1

    def _continue_from_trace(self):
        if self._n_deltas < self.window:
            return True
        take = min(self._n_deltas, self.max_window)
        recent_rows = (
            np.arange(self._n_deltas - self.window, self._n_deltas)
            % self.max_window
        )
        mean_delta = float(self._deltas[recent_rows].mean())
        if mean_delta > self.tol * 10:
            # still moving: look over a longer horizon before concluding
            self.window = min(
                int(self.window * self.expansion_rate), self.max_window, take
            ) or self.window
        if mean_delta < self.tol:
            self._log(
                f"Optimization terminated: mean change {mean_delta:.2e} "
                f"below tolerance over {self.window} generations"
            )
            return False
        return True


class CompositeAdaptiveTermination(TerminationCollection):
    """OR-combination of the adaptive criteria plus a generation cap
    (same membership as reference adaptive_termination.py:365-458)."""

    def __init__(
        self,
        problem,
        n_max_gen: int = 2000,
        obj_tol: float = 1e-4,
        min_converged_fraction: float = 0.8,
        hv_tol: float = 1e-5,
        ref_point: Optional[np.ndarray] = None,
        timescales: Optional[Sequence[int]] = None,
        stagnation_tol: float = 1e-4,
        use_per_objective: bool = True,
        use_hypervolume: bool = True,
        use_multiscale: bool = True,
        device=None,
        **kwargs,
    ):
        members: List[Termination] = []
        if use_per_objective:
            members.append(
                PerObjectiveConvergence(
                    problem,
                    obj_tol=obj_tol,
                    min_converged_fraction=min_converged_fraction,
                    n_last=20,
                    nth_gen=5,
                    **kwargs,
                )
            )
        if use_hypervolume:
            members.append(
                HypervolumeProgressTermination(
                    problem=problem,
                    ref_point=ref_point,
                    hv_tol=hv_tol,
                    n_last=15,
                    nth_gen=5,
                    device=device,
                    **kwargs,
                )
            )
        if use_multiscale:
            if timescales is None:
                base = max(5, problem.n_objectives // 5)
                timescales = [base << i for i in range(4)]
            members.append(
                MultiScaleStagnationTermination(
                    problem,
                    timescales=timescales,
                    stagnation_tol=stagnation_tol,
                    min_scales_stagnant=3,
                    nth_gen=2,
                    **kwargs,
                )
            )
        # the cap lives in its own member so any criterion OR the budget stops
        super().__init__(
            problem,
            MaximumGenerationTermination(problem, n_max_gen=n_max_gen),
            *members,
        )


class ResourceAwareTermination(Termination):
    """Budget stop on wall-clock, evaluation count, or a quality metric
    (same criterion as reference adaptive_termination.py:461-528). Each
    enabled budget yields an independent (stop, message) rule checked in
    sequence; the evaluation budget is a hard cap the optimize loops can
    read via `eval_budget()` to clamp their scan chunks."""

    def __init__(
        self,
        problem,
        max_time_seconds: Optional[float] = None,
        max_function_evals: Optional[int] = None,
        target_quality_threshold: Optional[float] = None,
        **kwargs,
    ):
        super().__init__(problem)
        self._t0: Optional[float] = None
        self.max_time_seconds = max_time_seconds
        self.max_function_evals = max_function_evals
        self.target_quality_threshold = target_quality_threshold

    def _budget_rules(self, opt):
        """Yield (stop, message) per enabled budget."""
        if self.max_time_seconds is not None:
            elapsed = time.time() - self._t0
            yield (
                elapsed > self.max_time_seconds,
                f"time limit reached ({elapsed:.1f}s > {self.max_time_seconds}s)",
            )
        if self.max_function_evals is not None:
            n_eval = getattr(opt, "n_eval", None)
            if n_eval is None:
                raise ValueError(
                    "max_function_evals is set but the optimize state carries "
                    "no n_eval counter — refusing to silently count generations"
                )
            # a budget of K means "at most K evaluations": stop once consumed,
            # not once exceeded (the loops clamp chunk sizes to land exactly)
            yield (
                n_eval >= self.max_function_evals,
                f"evaluation limit reached ({n_eval} >= {self.max_function_evals})",
            )
        if self.target_quality_threshold is not None:
            quality = getattr(opt, "quality_metric", None)
            yield (
                quality is not None and quality > self.target_quality_threshold,
                "quality threshold reached",
            )

    def _do_continue(self, opt):
        if self._t0 is None:
            self._t0 = time.time()
        for stop, message in self._budget_rules(opt):
            if stop:
                self._log(f"Optimization terminated: {message}")
                return False
        return True

    def eval_budget(self):
        return self.max_function_evals


# strategy presets: which composite members to enable, plus overrides
_STRATEGY_PRESETS: Dict[str, Dict] = {
    "comprehensive": dict(
        use_per_objective=True,
        use_hypervolume=True,
        use_multiscale=True,
        hv_tol=1e-6,
    ),
    "fast": dict(
        use_per_objective=False, use_hypervolume=True, use_multiscale=True
    ),
    "conservative": dict(
        use_per_objective=True, use_hypervolume=False, use_multiscale=True
    ),
}


_RESOURCE_KEYS = (
    "max_time_seconds", "max_function_evals", "target_quality_threshold",
)


def create_adaptive_termination(
    problem, n_max_gen: int = 2000, strategy: str = "comprehensive",
    device=None, **kwargs
) -> Termination:
    """Factory with the reference's strategy menu
    (adaptive_termination.py:531-612): comprehensive | fast |
    conservative build the composite from a preset; simple is the plain
    hypervolume-progress criterion. Resource-budget keys
    (``max_time_seconds`` / ``max_function_evals`` /
    ``target_quality_threshold``) attach a ``ResourceAwareTermination``
    alongside whichever strategy is chosen. The hypervolume criterion's
    estimators run on ``device`` (None means CUDA)."""
    budgets = {
        k: kwargs.pop(k) for k in _RESOURCE_KEYS if k in kwargs
    }
    budgets = {k: v for k, v in budgets.items() if v is not None}

    if strategy == "simple":
        term: Termination = HypervolumeProgressTermination(
            problem=problem, n_last=20, nth_gen=5, n_max_gen=n_max_gen,
            device=device, **kwargs,
        )
    else:
        preset = _STRATEGY_PRESETS.get(strategy)
        if preset is None:
            raise ValueError(
                f"Unknown strategy {strategy!r}. Choose from: "
                f"{', '.join([*_STRATEGY_PRESETS, 'simple'])}"
            )
        merged = {**preset, **kwargs}
        term = CompositeAdaptiveTermination(
            problem, n_max_gen=n_max_gen, device=device, **merged
        )
    if budgets:
        term = TerminationCollection(
            problem, term, ResourceAwareTermination(problem, **budgets)
        )
    return term
