"""Lorenz-system parameter estimation objectives, batched in torch.

References: ``examples/example_lorenz.py:23-75`` (the RK4 integrator and
the 3-objective `lorenz_objectives` of the large-population example)
and ``bench.py:448-486`` (the 2-objective variant of its Config 5 loop:
mean trajectory error and a prior). Both integrate the Lorenz ODE from
``X0`` with a fixed-step RK4 (dt 0.01, 4000 steps to t = 40), keep every
10th state from t = 8 on (320 samples) and compare them with the
trajectory of the true parameters (sigma, rho, beta) = (10, 28, 8/3).

Here the whole candidate batch integrates at once, one elementwise op
at a time, with the true parameters appended as the batch's last row:
its trajectory is the target, so every call integrates once and a row
at the true parameters reads exactly 0 (elementwise float32 arithmetic
does not depend on the batch). The horizon is an argument, so tests can
shorten it. The trajectories are chaotic: float32 runs of two programs
agree only over a short horizon.

This is an example objective in plain torch, not a port of a kernel.
"""

from __future__ import annotations

import torch

X0 = (-0.5, 1.0, 0.5)
DT = 0.01
N_STEPS = 4000  # T_MAX 40 / DT
SKIP = 800  # T_TARGET0 8 / DT
STRIDE = 10  # a sample every 0.1 s
TRUE_P = (10.0, 28.0, 8.0 / 3.0)  # (sigma, rho, beta)


def _rhs(X, s, r, b):
    x, y, z = X.unbind(-1)
    return torch.stack([s * (y - x), x * (r - z) - y, x * y - b * z], dim=-1)


def integrate_lorenz(P: torch.Tensor, n_steps: int = N_STEPS,
                     skip: int = SKIP, stride: int = STRIDE) -> torch.Tensor:
    """RK4 trajectories of (B, 3) parameter sets in (sigma, rho, beta)
    order: the states after steps skip+1, skip+1+stride, ... up to
    n_steps, as (B, samples, 3) (the example's ``traj[SKIP::STRIDE]``,
    where ``traj[i]`` is the state after step i + 1)."""
    s, r, b = P.unbind(-1)
    X = torch.tensor(X0, dtype=P.dtype, device=P.device).expand(P.shape[0], 3)
    half, sixth = 0.5 * DT, DT / 6.0
    out = []
    for i in range(n_steps):
        k1 = _rhs(X, s, r, b)
        k2 = _rhs(X + half * k1, s, r, b)
        k3 = _rhs(X + half * k2, s, r, b)
        k4 = _rhs(X + DT * k3, s, r, b)
        X = X + sixth * (k1 + 2 * k2 + 2 * k3 + k4)
        if i >= skip and (i - skip) % stride == 0:
            out.append(X)
    return torch.stack(out, dim=1)


def _with_target(P: torch.Tensor, n_steps: int, skip: int):
    """Trajectories of P's rows and, in the last row, of the true
    parameters: (trajectories (B, samples, 3), target (samples, 3))."""
    true = torch.tensor(TRUE_P, dtype=P.dtype, device=P.device)
    traj = integrate_lorenz(torch.cat([P, true[None]]), n_steps, skip)
    return traj[:-1], traj[-1]


def lorenz_objectives(P: torch.Tensor, n_steps: int = N_STEPS,
                      skip: int = SKIP) -> torch.Tensor:
    """The example's objective: (B, 3) parameter sets in the driver's
    sorted-key column order (b, r, s) -> (B, 3) per-axis mean absolute
    trajectory errors."""
    b, r, s = P.unbind(-1)
    traj, target = _with_target(torch.stack([s, r, b], dim=-1), n_steps, skip)
    return (traj - target).abs().mean(dim=1)


def lorenz_error_prior(P: torch.Tensor, n_steps: int = N_STEPS,
                       skip: int = SKIP) -> torch.Tensor:
    """The bench's Config 5 objective: (B, 3) parameter sets in (sigma,
    rho, beta) order -> (B, 2): the mean absolute trajectory error over
    all samples and axes, and the squared distance to the true
    parameters."""
    traj, target = _with_target(P, n_steps, skip)
    err = (traj - target).abs().mean(dim=(1, 2))
    true = torch.tensor(TRUE_P, dtype=P.dtype, device=P.device)
    prior = ((P - true) ** 2).sum(dim=1)
    return torch.stack([err, prior], dim=1)
