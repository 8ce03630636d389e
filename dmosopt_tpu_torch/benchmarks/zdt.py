"""Zitzler-Deb-Thiele ZDT1, batched.

Port of ``dmosopt_tpu/benchmarks/zdt.py`` (`zdt1`, `zdt1_pareto`,
`distance_to_front`): ``zdt1(X) -> Y`` with X (B, n), Y (B, 2), on the
tensor's own device.
"""

import numpy as np
import torch


def zdt1(x: torch.Tensor) -> torch.Tensor:
    x = torch.atleast_2d(x)
    n = x.shape[1]
    f1 = x[:, 0]
    g = 1.0 + 9.0 / (n - 1) * torch.sum(x[:, 1:], dim=1)
    h = 1.0 - torch.sqrt(f1 / g)
    return torch.stack([f1, g * h], dim=1)


def zdt1_pareto(n_points: int = 100) -> np.ndarray:
    f1 = np.linspace(0, 1, n_points)
    return np.stack([f1, 1.0 - np.sqrt(f1)], axis=1)


def distance_to_front(Y, front: np.ndarray) -> np.ndarray:
    """Per-point euclidean distance to a sampled analytic Pareto front
    (oracle from reference tests/test_zdt1_nsga2_trs.py:39-72)."""
    Y = np.asarray(Y)
    d = np.sqrt(((Y[:, None, :] - front[None, :, :]) ** 2).sum(-1))
    return d.min(axis=1)
