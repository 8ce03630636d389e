"""Classic termination criteria (capability parity with the reference's
pymoo-derived dmosopt/termination.py, redesigned around a pairwise
snapshot comparison).

Port of ``dmosopt_tpu/termination.py``, copied: that module imports no JAX,
and the port keeps its own copy, its imports pointed at the port.

These are host-side controllers reading population metrics; with the
on-device generation loop they are consulted every
`termination_check_interval` generations (see moasmo._optimize_on_device)
instead of every generation, amortizing the device->host sync.

Design note: the reference carries a general data-window protocol
(`_store`/`_metric`/`_decide` over arbitrary-size windows,
termination.py:90-190), but every criterion it ships instantiates that
machinery with a window of exactly two — each metric is a comparison of
the current population statistic against the previous one. This module
keeps only that pair (``_snapshot`` -> ``_compare``) plus a bounded
metric window, which is the whole behavior in a third of the moving
parts.
"""

from __future__ import annotations

from abc import abstractmethod
from collections import deque

import numpy as np

from dmosopt_tpu_torch.indicators import IGD
from dmosopt_tpu_torch.normalization import normalize


class Termination:
    """Base criterion (reference termination.py:14-59)."""

    def __init__(self, problem) -> None:
        self.problem = problem
        self.force_termination = False
        self.stopped = False  # set once this criterion fires

    def do_continue(self, opt):
        if self.force_termination:
            self.stopped = True
            return False
        cont = self._do_continue(opt)
        if not cont:
            self.stopped = True
        return cont

    def _do_continue(self, opt, **kwargs):  # pragma: no cover
        return True

    def has_terminated(self, opt):
        return not self.do_continue(opt)

    def _log(self, msg):
        logger = getattr(self.problem, "logger", None)
        if logger is not None:
            logger.info(msg)

    def eval_budget(self):
        """Hard cap on real-objective evaluations this criterion imposes,
        or None. The optimize loops use it to clamp scan-chunk sizes so an
        evaluation budget stops at the requested count instead of at
        check-interval granularity."""
        return None

    def stop_reasons(self):
        """Names of the criteria that actually fired (diagnostics)."""
        return [type(self).__name__] if self.stopped else []


def mark_eval_budget_stop(term) -> bool:
    """Mark the criterion owning an evaluation budget as fired. Used by
    the optimize loops when the remaining budget cannot fit one more full
    generation: no evaluation ever reaches the cap, so the criterion
    would otherwise never trip and the stop would go unattributed.
    Returns True when an owner was found."""
    if term is None:
        return False
    members = getattr(term, "terminations", None)
    if members is not None:
        return any([mark_eval_budget_stop(m) for m in members])
    if getattr(term, "max_function_evals", None) is not None:
        term.stopped = True
        return True
    return False


class TerminationCollection(Termination):
    """Terminate when ANY member terminates (reference termination.py:61-69)."""

    def __init__(self, problem, *args) -> None:
        super().__init__(problem)
        self.terminations = args

    def _do_continue(self, opt):
        return all(term.do_continue(opt) for term in self.terminations)

    def eval_budget(self):
        budgets = [
            b for b in (t.eval_budget() for t in self.terminations) if b is not None
        ]
        return min(budgets) if budgets else None

    def stop_reasons(self):
        return [r for t in self.terminations for r in t.stop_reasons()]


class MaximumGenerationTermination(Termination):
    def __init__(self, problem, n_max_gen) -> None:
        super().__init__(problem)
        self.n_max_gen = float("inf") if n_max_gen is None else n_max_gen

    def _do_continue(self, opt):
        if opt.n_gen > self.n_max_gen:
            self._log(
                f"Optimization terminated: maximum number of generations "
                f"({opt.n_gen}) has been reached"
            )
        return opt.n_gen <= self.n_max_gen


class SlidingWindowTermination(TerminationCollection):
    """Pairwise comparison over a bounded metric window.

    Each check takes a ``_snapshot`` of the population, compares it with
    the previous snapshot (``_compare``), and appends the comparison to
    a window holding the last ``window_size`` results; once the window
    is full, ``_decide`` rules every ``nth_gen`` generations. A
    ``_snapshot`` returning None leaves the previous snapshot in place
    (e.g. non-numeric populations). Also carries the reference's
    max-generation backstop.
    """

    def __init__(self, problem, window_size=10, nth_gen=1, n_max_gen=None):
        super().__init__(
            problem, MaximumGenerationTermination(problem, n_max_gen=n_max_gen)
        )
        self.window_size = window_size
        self.nth_gen = nth_gen
        self.reset()

    def reset(self):
        self._previous = None
        self.metrics = deque(maxlen=self.window_size)

    def _do_continue(self, opt):
        if not super()._do_continue(opt):
            return False
        snap = self._snapshot(opt)
        if snap is not None:
            if self._previous is not None:
                measured = self._compare(self._previous, snap)
                if measured is not None:
                    self.metrics.append(measured)
            self._previous = snap
        ready = len(self.metrics) == self.window_size
        if ready and opt.n_gen % self.nth_gen == 0:
            return self._decide(list(self.metrics))
        return True

    def _snapshot(self, opt):
        """Statistic of the current population to compare across
        generations; None to skip this generation."""
        return opt

    def stop_reasons(self):
        # the collection reports member criteria (the generation cap);
        # when the window criterion itself fired, report THIS class —
        # otherwise HV-progress/tolerance stops read as unexplained
        member = super().stop_reasons()
        if member:
            return member
        return [type(self).__name__] if self.stopped else []

    @abstractmethod
    def _compare(self, previous, current):  # pragma: no cover
        ...

    @abstractmethod
    def _decide(self, metrics):  # pragma: no cover
        ...

    def get_metric(self):
        return self.metrics[-1] if self.metrics else None


class ParameterToleranceTermination(SlidingWindowTermination):
    """Movement (IGD) of consecutive normalized parameter populations
    below tol (capability of reference termination.py:193-231)."""

    def __init__(self, problem, n_last=10, tol=1e-6, nth_gen=1, n_max_gen=None):
        super().__init__(
            problem, window_size=n_last, nth_gen=nth_gen, n_max_gen=n_max_gen
        )
        self.tol = tol

    def _snapshot(self, opt):
        X = np.asarray(opt.x)
        if X.dtype == object:  # non-numeric population: nothing to measure
            return None
        lb = getattr(self.problem, "lb", None)
        ub = getattr(self.problem, "ub", None)
        if lb is None or ub is None:
            return X
        return normalize(X, xl=lb, xu=ub)

    def _compare(self, previous, current):
        return IGD(current).do(previous)

    def _decide(self, metrics):
        mean_movement = float(np.mean(metrics))
        if mean_movement <= self.tol:
            self._log(
                f"Optimization terminated: mean parameter distance "
                f"{mean_movement} is below tolerance {self.tol}"
            )
        return mean_movement > self.tol


def calc_delta_norm(a, b, norm):
    return np.max(np.abs((a - b) / norm))


class MultiObjectiveToleranceTermination(SlidingWindowTermination):
    """Ideal-point drift + population IGD below tol (capability of
    reference termination.py:234-292)."""

    def __init__(self, problem, tol=0.0025, n_last=10, nth_gen=1, n_max_gen=None):
        super().__init__(
            problem, window_size=n_last, nth_gen=nth_gen, n_max_gen=n_max_gen
        )
        self.tol = tol

    def _snapshot(self, opt):
        F = np.asarray(opt.y)
        return {"ideal": F.min(axis=0), "nadir": F.max(axis=0), "F": F}

    def _compare(self, previous, current):
        ideal, nadir = current["ideal"], current["nadir"]
        span = nadir - ideal
        span = np.where(span < 1e-32, 1.0, span)
        moved_ideal = calc_delta_norm(ideal, previous["ideal"], span)
        # both fronts in the CURRENT normalization, then population IGD
        now_n = normalize(current["F"], ideal, nadir)
        before_n = normalize(previous["F"], ideal, nadir)
        return {"delta_ideal": moved_ideal, "delta_f": IGD(now_n).do(before_n)}

    def _decide(self, metrics):
        drift = np.mean([m["delta_ideal"] for m in metrics])
        movement = np.mean([m["delta_f"] for m in metrics])
        if max(drift, movement) <= self.tol:
            self._log(
                f"Optimization terminated: convergence of objective mean "
                f"delta {(drift, movement)} is below tolerance {self.tol}"
            )
        return max(drift, movement) > self.tol


class ConstraintViolationToleranceTermination(SlidingWindowTermination):
    """Constraint-violation change below tol while still infeasible
    (capability of reference termination.py:295-330)."""

    def __init__(self, problem, n_last=10, tol=1e-6, nth_gen=1, n_max_gen=None):
        super().__init__(
            problem, window_size=n_last, nth_gen=nth_gen, n_max_gen=n_max_gen
        )
        self.tol = tol

    def _snapshot(self, opt):
        return opt.c

    def _compare(self, previous, current):
        return {"cv": current, "delta_cv": abs(previous - current)}

    def _decide(self, metrics):
        cv = np.asarray([m["cv"] for m in metrics])
        feasible_count = int((cv > 0).sum())
        if feasible_count == len(metrics):
            return False  # feasible throughout the window: defer to others
        if feasible_count > 0:
            return True  # mixed window: still transitioning
        deltas = np.asarray([m["delta_cv"] for m in metrics])
        return deltas.max() > self.tol


class StandardTermination(TerminationCollection):
    """Default multi-criterion bundle: objective tolerance + parameter
    tolerance + max generations."""

    def __init__(self, problem, x_tol=1e-8, f_tol=0.0025, n_last=10, n_max_gen=None):
        super().__init__(
            problem,
            ParameterToleranceTermination(
                problem, tol=x_tol, n_last=n_last, n_max_gen=n_max_gen
            ),
            MultiObjectiveToleranceTermination(
                problem, tol=f_tol, n_last=n_last, n_max_gen=n_max_gen
            ),
        )
