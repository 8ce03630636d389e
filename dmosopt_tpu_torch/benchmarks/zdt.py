"""Zitzler-Deb-Thiele ZDT1-3, batched.

Port of ``dmosopt_tpu/benchmarks/zdt.py`` (`zdt1`, `zdt2`, `zdt3`, the
sampled fronts `zdt1_pareto`, `zdt2_pareto`, `zdt3_pareto`, and
`distance_to_front`): ``f(X) -> Y`` with X (B, n), Y (B, 2), on the
tensor's own device. The fronts are numpy copies of the JAX package's.
"""

import math

import numpy as np
import torch


def _f1_g(x: torch.Tensor):
    x = torch.atleast_2d(x)
    n = x.shape[1]
    f1 = x[:, 0]
    g = 1.0 + 9.0 / (n - 1) * torch.sum(x[:, 1:], dim=1)
    return f1, g


def zdt1(x: torch.Tensor) -> torch.Tensor:
    f1, g = _f1_g(x)
    h = 1.0 - torch.sqrt(f1 / g)
    return torch.stack([f1, g * h], dim=1)


def zdt2(x: torch.Tensor) -> torch.Tensor:
    f1, g = _f1_g(x)
    h = 1.0 - (f1 / g) ** 2
    return torch.stack([f1, g * h], dim=1)


def zdt3(x: torch.Tensor) -> torch.Tensor:
    f1, g = _f1_g(x)
    h = 1.0 - torch.sqrt(f1 / g) - (f1 / g) * torch.sin(10.0 * math.pi * f1)
    return torch.stack([f1, g * h], dim=1)


def zdt1_pareto(n_points: int = 100) -> np.ndarray:
    f1 = np.linspace(0, 1, n_points)
    return np.stack([f1, 1.0 - np.sqrt(f1)], axis=1)


def zdt2_pareto(n_points: int = 100) -> np.ndarray:
    f1 = np.linspace(0, 1, n_points)
    return np.stack([f1, 1.0 - f1**2], axis=1)


def zdt3_pareto(n_points: int = 100) -> np.ndarray:
    # disconnected front: keep only the non-dominated part of the g=1 curve
    f1 = np.linspace(0, 1, n_points * 10)
    f2 = 1.0 - np.sqrt(f1) - f1 * np.sin(10.0 * np.pi * f1)
    pts = np.stack([f1, f2], axis=1)
    keep = np.ones(len(pts), dtype=bool)
    for i in range(len(pts)):
        if keep[i]:
            dominated = (pts[:, 0] <= pts[i, 0]) & (pts[:, 1] <= pts[i, 1])
            dominated &= (pts[:, 0] < pts[i, 0]) | (pts[:, 1] < pts[i, 1])
            if dominated.any():
                keep[i] = False
    return pts[keep][:: max(1, len(pts[keep]) // n_points)]


def distance_to_front(Y, front: np.ndarray) -> np.ndarray:
    """Per-point euclidean distance to a sampled analytic Pareto front
    (oracle from reference tests/test_zdt1_nsga2_trs.py:39-72)."""
    Y = np.asarray(Y)
    d = np.sqrt(((Y[:, None, :] - front[None, :, :]) ** 2).sum(-1))
    return d.min(axis=1)
