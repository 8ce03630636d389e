"""Adaptive early stopping for surrogate training loops.

A copy of ``dmosopt_tpu/models/early_stopping.py`` (numpy only; the port
imports nothing of the JAX package), after reference
`dmosopt/model_gpytorch.py:579-990`: `ModelType` (:579), per-model-type
`EarlyStoppingConfig` (:588), `AdaptiveEarlyStopping.should_stop`
combining percentage-change, absolute, relative, plateau and validation
criteria with a patience mechanism (:636-813), `analyze_loss_trajectory`
(:907) and `suggest_hyperparameters` (:958).

Training loops run in chunks of Adam steps; the stopping controller is
consulted between chunks with the accumulated loss history (one
device-to-host copy per chunk, not per step).
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Callable, Optional, Tuple

import numpy as np


class ModelType(Enum):
    EXACT_GP = "exact_gp"
    VARIATIONAL_GP = "variational_gp"
    DEEP_GP = "deep_gp"
    DEEP_STOCHASTIC = "deep_stochastic"


@dataclass
class EarlyStoppingConfig:
    """Stopping thresholds (reference model_gpytorch.py:588-633)."""

    min_iterations: int = 1000
    window_size: int = 500
    threshold_pct: float = 0.1
    patience: int = 3
    warmup_iterations: int = 100
    relative_tolerance: float = 1e-2
    absolute_tolerance: float = 1e-3

    @classmethod
    def for_model_type(cls, model_type: ModelType) -> "EarlyStoppingConfig":
        configs = {
            ModelType.EXACT_GP: cls(
                min_iterations=1000, window_size=200, threshold_pct=0.01,
                patience=2, warmup_iterations=50,
            ),
            ModelType.VARIATIONAL_GP: cls(
                min_iterations=1000, window_size=500, threshold_pct=0.5,
                patience=3, warmup_iterations=200,
            ),
            ModelType.DEEP_GP: cls(
                min_iterations=1500, window_size=500, threshold_pct=1.0,
                patience=3, warmup_iterations=200,
            ),
            ModelType.DEEP_STOCHASTIC: cls(
                min_iterations=2000, window_size=500, threshold_pct=1.0,
                patience=3, warmup_iterations=200,
            ),
        }
        return configs.get(model_type, cls())


class AdaptiveEarlyStopping:
    """Multi-criterion early stopping with patience
    (reference model_gpytorch.py:636-813)."""

    def __init__(self, config: EarlyStoppingConfig, logger=None):
        self.config = config
        self.best_loss = float("inf")
        self.patience_counter = 0
        self.logger = logger

    def should_stop(
        self,
        iteration: int,
        loss_history: np.ndarray,
        compute_validation: Optional[Callable[[], float]] = None,
    ) -> Tuple[bool, str]:
        # gate first: below warmup/min_iterations nothing is consulted, so
        # no window scans or validation evaluations are wasted
        if iteration < max(
            self.config.min_iterations, self.config.warmup_iterations
        ):
            return False, ""

        loss_history = np.asarray(loss_history)
        # each criterion yields a firing message or None
        fired = [
            msg
            for check in (
                self._check_percentage_change,
                self._check_absolute_convergence,
                self._check_relative_convergence,
                self._check_plateau,
            )
            if (msg := check(loss_history)) is not None
        ]
        if compute_validation is not None:
            msg = self._check_validation_loss(compute_validation)
            if msg is not None:
                fired.append(msg)

        if len(fired) >= 2:  # at least 2 criteria must agree
            self.patience_counter += 1
            if self.patience_counter >= self.config.patience:
                return True, "; ".join(fired)
        else:
            self.patience_counter = 0
        return False, ""

    # each _check_* returns a message when its criterion fires, else None

    def _check_percentage_change(self, h):
        if len(h) < self.config.window_size + 1:
            return None
        window = h[-self.config.window_size :]
        denom = np.maximum(np.abs(window[:-1]), self.config.absolute_tolerance)
        mean_pct = float(np.mean(np.abs(np.diff(window) / denom)) * 100)
        if mean_pct >= self.config.threshold_pct:
            return None
        return f"Mean % change ({mean_pct:.4f}%) < threshold"

    def _check_absolute_convergence(self, h):
        if len(h) < self.config.window_size:
            return None
        max_abs = float(np.max(np.abs(np.diff(h[-self.config.window_size :]))))
        if max_abs >= self.config.absolute_tolerance:
            return None
        return f"Max absolute change ({max_abs:.2e}) converged"

    def _check_relative_convergence(self, h):
        if len(h) < self.config.window_size:
            return None
        window = h[-self.config.window_size :]
        if abs(window[0]) < self.config.absolute_tolerance:
            return None
        rel = abs((window[-1] - window[0]) / window[0])
        if rel >= self.config.relative_tolerance:
            return None
        return f"Relative change ({rel:.2e}) converged"

    def _check_plateau(self, h):
        if len(h) < self.config.window_size * 2:
            return None
        mid = len(h) - self.config.window_size
        first = h[mid : mid + self.config.window_size // 2]
        second = h[-self.config.window_size // 2 :]
        mean_diff = abs(np.mean(first) - np.mean(second))
        mean_value = np.mean(h[-self.config.window_size :])
        rel = mean_diff / (abs(mean_value) + self.config.absolute_tolerance)
        if rel >= self.config.relative_tolerance * 2:
            return None
        return f"Loss plateau detected (relative difference: {rel:.2e})"

    def _check_validation_loss(self, compute_validation):
        try:
            val = compute_validation()
        except Exception:
            return None
        if val < self.best_loss - self.config.absolute_tolerance:
            self.best_loss = val
            return None
        return f"No validation improvement (best: {self.best_loss:.4f})"


def analyze_loss_trajectory(loss_history: np.ndarray) -> dict:
    """Loss-trajectory statistics (reference model_gpytorch.py:907-932)."""
    loss_history = np.asarray(loss_history)
    if len(loss_history) < 2:
        return {}
    changes = np.diff(loss_history)
    return {
        "mean_loss": float(np.mean(loss_history)),
        "std_loss": float(np.std(loss_history)),
        "min_loss": float(np.min(loss_history)),
        "max_loss": float(np.max(loss_history)),
        "final_loss": float(loss_history[-1]),
        "total_iterations": len(loss_history),
        "mean_improvement": float(np.mean(changes)),
        "monotonic_decrease": bool(np.all(changes <= 0)),
        "oscillating": bool(np.std(changes) > np.abs(np.mean(changes)) * 2),
        "convergence_iteration": _estimate_convergence_point(loss_history),
    }


def _estimate_convergence_point(
    loss_history: np.ndarray, threshold_pct: float = 0.1, window: int = 100
) -> Optional[int]:
    if len(loss_history) < window * 2:
        return None
    changes = np.diff(loss_history)
    denom = np.maximum(np.abs(loss_history[:-1]), 1e-8)
    pct = np.abs(changes / denom) * 100
    moving = np.convolve(pct, np.ones(window) / window, mode="valid")
    hits = np.where(moving < threshold_pct)[0]
    return int(hits[0] + window) if len(hits) else None


def suggest_hyperparameters(loss_trajectory: dict, model_type: ModelType) -> dict:
    """Hyperparameter recommendations (reference model_gpytorch.py:958-990)."""
    rec = {}
    if loss_trajectory.get("oscillating", False):
        rec["learning_rate"] = "decrease"
        rec["reason_lr"] = "Loss oscillating, reduce learning rate"
    if loss_trajectory.get("convergence_iteration") is None:
        rec["n_iter"] = "increase"
        rec["reason_n_iter"] = "Model has not converged"
    conv = loss_trajectory.get("convergence_iteration")
    if (
        conv is not None
        and conv < 500
        and loss_trajectory.get("final_loss", 0) > 1.0
        and "learning_rate" not in rec  # don't contradict the oscillation advice
    ):
        rec["learning_rate"] = "increase"
        rec["reason_lr"] = "Converged too early, try higher learning rate"
    if model_type in (ModelType.DEEP_GP, ModelType.DEEP_STOCHASTIC):
        if loss_trajectory.get("total_iterations", 0) < 1500:
            rec["n_iter"] = "increase"
            rec["reason_n_iter"] = "Deep models need more iterations"
    return rec
