"""Hypervolume-progress termination with multi-fidelity tracking.

Port of ``dmosopt_tpu/hv_termination.py``, copied: that module imports no JAX,
and the port keeps its own copy, its imports pointed at the port.

Capability match: reference `dmosopt/hv_termination.py` —
`ProgressivePrecisionScheduler` (:90, coarse->fine epsilon by
generation), `HVAlgorithmRouter` (:225, dimension-based algorithm
choice), `MultiFidelityHVTracker` (:446, coarse/medium/fine cadences
1/5/10), `ConvergenceDetector` (:684, stagnation + confidence), and
`HypervolumeProgressTermination` (:960) with adaptive reference point.

Every hypervolume evaluation goes through
`dmosopt_tpu_torch.hv.AdaptiveHyperVolume` — exact for low d; above the
dimension threshold the CI-target-driven FPRAS estimator, where the
fidelity epsilon is the adaptive stopping target (sampling grows in
batches until the 95% CI half-width is below epsilon * estimate, up to
a cap) instead of the reference's per-algorithm epsilon plumbing.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from dmosopt_tpu_torch.hv import AdaptiveHyperVolume
from dmosopt_tpu_torch.termination import SlidingWindowTermination


class ProgressivePrecisionScheduler:
    """Coarse-to-fine precision by generation phase
    (reference hv_termination.py:90-222)."""

    def __init__(
        self,
        early_threshold: int = 20, mid_threshold: int = 50,
        early_epsilon: float = 0.05, mid_epsilon: float = 0.02,
        late_epsilon: float = 0.01,
    ):
        self.early_threshold, self.mid_threshold = early_threshold, mid_threshold
        self.early_epsilon, self.mid_epsilon, self.late_epsilon = (
            early_epsilon, mid_epsilon, late_epsilon,
        )

    def get_epsilon(self, generation: int) -> float:
        if generation < self.early_threshold:
            return self.early_epsilon
        if generation < self.mid_threshold:
            return self.mid_epsilon
        return self.late_epsilon

    def get_phase(self, generation: int) -> str:
        if generation < self.early_threshold:
            return "early"
        if generation < self.mid_threshold:
            return "mid"
        return "late"


class HVAlgorithmRouter:
    """Dimension-based algorithm choice (reference hv_termination.py:225-443):
    exact below the dimension threshold; above it, the CI-target-driven
    FPRAS estimator — the requested epsilon becomes the adaptive
    stopping target instead of a static sample count. The estimator
    runs on ``device`` (None means CUDA)."""

    def __init__(self, exact_dim_threshold: int = 10, device=None):
        self.exact_dim_threshold = exact_dim_threshold
        self.device = device
        self.last_method = None
        self.last_n_samples = 0
        self._hv_cache: dict = {}

    def compute(self, F: np.ndarray, ref_point: np.ndarray, epsilon: float) -> float:
        # one facade per (ref, epsilon): repeated per-fidelity calls reuse
        # the same estimator (and its PRNG stream) instead of rebuilding
        cache_key = (tuple(np.asarray(ref_point).ravel()), float(epsilon))
        hv = self._hv_cache.get(cache_key)
        if hv is None:
            hv = self._hv_cache[cache_key] = AdaptiveHyperVolume(
                ref_point,
                exact_dim_threshold=self.exact_dim_threshold,
                epsilon=epsilon,
                device=self.device,
            )
        out = hv.compute_hypervolume(F)
        self.last_method = hv.last_method
        self.last_n_samples = hv.last_n_samples
        return out


@dataclass
class _Estimate:
    value: float
    generation: int
    fidelity: str


@dataclass
class _TrackerState:
    history_coarse: List[float] = field(default_factory=list)
    history_medium: List[float] = field(default_factory=list)
    history_fine: List[float] = field(default_factory=list)
    estimates: List[_Estimate] = field(default_factory=list)


class MultiFidelityHVTracker:
    """Coarse/medium/fine cadence HV tracking
    (reference hv_termination.py:446-681)."""

    def __init__(
        self,
        reference_point: np.ndarray,
        coarse_epsilon: float = 0.05, medium_epsilon: float = 0.02,
        fine_epsilon: float = 0.01,
        coarse_freq: int = 1, medium_freq: int = 5, fine_freq: int = 10,
        device=None,
    ):
        self.reference_point = np.asarray(reference_point, dtype=np.float64)
        self.epsilons = {
            "coarse": coarse_epsilon,
            "medium": medium_epsilon,
            "fine": fine_epsilon,
        }
        self.freqs = {
            "coarse": coarse_freq,
            "medium": medium_freq,
            "fine": fine_freq,
        }
        self.router = HVAlgorithmRouter(device=device)
        self.state = _TrackerState()

    def compute_and_update(
        self, F: np.ndarray, generation: int, minimize: bool = True, verbose=False
    ):
        for fidelity in ("coarse", "medium", "fine"):
            if generation % self.freqs[fidelity] == 0:
                value = self.router.compute(
                    F, self.reference_point, self.epsilons[fidelity]
                )
                getattr(self.state, f"history_{fidelity}").append(value)
                self.state.estimates.append(_Estimate(value, generation, fidelity))

    def get_best_estimate(
        self, generation: int, max_age: int = 10
    ) -> Optional[_Estimate]:
        """Freshest highest-fidelity estimate within `max_age` generations."""
        best = None
        order = {"fine": 2, "medium": 1, "coarse": 0}
        for est in reversed(self.state.estimates):
            if generation - est.generation > max_age:
                break
            if best is None or order[est.fidelity] > order[best.fidelity]:
                best = est
        return best


@dataclass
class ConvergenceResult:
    converged: bool
    confidence: float
    primary_reason: str


class ConvergenceDetector:
    """Stagnation + confidence scoring (reference hv_termination.py:684-957)."""

    def __init__(
        self,
        stagnation_threshold: float = 1e-5, stagnation_window: int = 5,
        relative_threshold: float = 1e-6, min_generations: int = 20,
    ):
        self.stagnation_threshold = stagnation_threshold
        self.stagnation_window, self.min_generations = (
            stagnation_window, min_generations,
        )
        self.relative_threshold = relative_threshold

    def check_convergence(
        self, tracker: MultiFidelityHVTracker, generation: int, F, verbose=False
    ) -> ConvergenceResult:
        history = tracker.state.history_coarse
        if generation < self.min_generations or len(history) < self.stagnation_window + 1:
            return ConvergenceResult(False, 0.0, "insufficient history")

        window = np.asarray(history[-(self.stagnation_window + 1) :])
        deltas = np.abs(np.diff(window))
        rel = deltas / (np.abs(window[:-1]) + 1e-10)

        checks = {
            "absolute stagnation": bool(np.all(deltas < self.stagnation_threshold)),
            "relative stagnation": bool(np.all(rel < self.relative_threshold * 10)),
            "monotone plateau": bool(np.max(window) - np.min(window)
                                     < self.stagnation_threshold * self.stagnation_window),
        }
        confidence = sum(checks.values()) / len(checks)
        converged = checks["absolute stagnation"] and confidence >= 2 / 3
        reason = (
            ", ".join(k for k, v in checks.items() if v) if converged else "progressing"
        )
        return ConvergenceResult(converged, confidence, reason)


class HypervolumeProgressTermination(SlidingWindowTermination):
    """Adaptive HV-progress termination
    (reference hv_termination.py:960-1160). Its hypervolume estimators,
    used above the exact path's dimension and size, run on ``device``
    (None means CUDA)."""

    def __init__(
        self,
        problem,
        ref_point: Optional[np.ndarray] = None,
        hv_tol: float = 1e-5,
        n_last: int = 15, nth_gen: int = 5,
        n_max_gen: Optional[int] = None,
        adaptive_ref_point: bool = True, min_generations: int = 20,
        verbose: bool = False,
        device=None,
        **kwargs,
    ):
        super().__init__(
            problem, window_size=n_last, nth_gen=nth_gen, n_max_gen=n_max_gen,
            **kwargs,
        )
        self.ref_point = np.copy(ref_point) if ref_point is not None else None
        self.hv_tol, self.adaptive_ref_point = hv_tol, adaptive_ref_point
        self.verbose = verbose
        self.device = device
        # built lazily on the first snapshot, once the objective count and
        # scale are known
        self._precision_scheduler = self._mf_tracker = None
        self._convergence_detector = None
        self._convergence_detector_config = {
            "stagnation_threshold": hv_tol,
            "stagnation_window": min(n_last, 5),
            "relative_threshold": hv_tol / 10,
            "min_generations": min_generations,
        }

    def _adapt_ref_point(self, F):
        margin = 0.1
        worst = F.max(axis=0)
        best = F.min(axis=0)
        return worst + margin * np.abs(worst - best)

    def _initialize_components(self, F):
        if self._mf_tracker is not None:
            return
        if self.ref_point is None or self.adaptive_ref_point:
            self.ref_point = self._adapt_ref_point(F)
        self._precision_scheduler = ProgressivePrecisionScheduler()
        self._mf_tracker = MultiFidelityHVTracker(
            reference_point=self.ref_point, device=self.device
        )
        self._convergence_detector = ConvergenceDetector(
            **self._convergence_detector_config
        )

    def _snapshot(self, opt):
        F = np.asarray(opt.y)
        self._initialize_components(F)
        if self.adaptive_ref_point:
            self.ref_point = self._adapt_ref_point(F)
            self._mf_tracker.reference_point = self.ref_point
        return {"F": F, "ref_point": self.ref_point.copy()}

    def _compare(self, previous, current):
        F_now = current["F"]
        tracker = self._mf_tracker
        generation = len(tracker.state.history_coarse)
        tracker.compute_and_update(
            F_now, generation, minimize=True, verbose=self.verbose
        )
        best_estimate = tracker.get_best_estimate(generation, max_age=10)
        history = tracker.state.history_coarse
        gained = history[-1] - history[-2] if len(history) >= 2 else 0.0
        rel_gain = gained / (history[-2] + 1e-10) if len(history) >= 2 else 0.0
        verdict = self._convergence_detector.check_convergence(
            tracker, generation, F_now, verbose=self.verbose
        )
        return {
            "hv": best_estimate.value if best_estimate else 0.0,
            "hv_improvement": gained,
            "relative_improvement": rel_gain,
            "converged": verdict.converged,
            "confidence": verdict.confidence,
            "reason": verdict.primary_reason,
        }

    def _decide(self, metrics):
        if len(metrics) < 3:
            return True
        latest = metrics[-1]
        if latest["converged"]:
            self._log(
                f"Hypervolume convergence detected: final HV {latest['hv']:.6f}, "
                f"confidence {latest['confidence']:.2%}, reason: {latest['reason']}"
            )
            return False
        self._log(
            f"HV progress - current: {latest['hv']:.6f}, "
            f"improvement: {latest['relative_improvement']:.2e}"
        )
        return True
