"""Traffic drivers, one module per ``driver`` name of a traffic file.

A driver's ``drive(run)`` sets up the cell from ``run`` (a
``harness.runner.Run``), warms up, measures for ``run.seconds`` and fills
``run``'s window record; the runner does the rest.
"""

from __future__ import annotations

import numpy as np

from h100bench import objectives


def space(config):
    """The calibration's parameter space, as the example names it."""
    lb, ub = config["parameter_bounds"]
    return {f"x{i + 1}": [float(lb), float(ub)] for i in range(int(config["n_parameters"]))}


def objective(config):
    fn = objectives.load(config["problem"])
    params = dict(config.get("problem_params") or {})
    return lambda x: fn(x, **params)


def seed_stream(seed: int, stream: int):
    """Calibration seeds: an endless, reproducible sequence of 31-bit
    seeds for ``--seed`` and a stream number (0 the window's, 1 the
    warm-up's)."""
    ss = np.random.SeedSequence([int(seed) % (2 ** 63), int(stream)])
    rng = np.random.default_rng(ss)
    while True:
        yield int(rng.integers(1, 2 ** 31 - 1))


def gp_kwargs(config, seed: int, traffic=None):
    """The GP surrogate's keyword arguments: the configuration's settings,
    the calibration's seed for the fit's restarts and, where the traffic
    names one, its ``fit_convergence_tol`` (null: every fit runs all its
    Adam steps)."""
    gp = config["gp"]
    extra = {}
    if traffic is not None and "fit_convergence_tol" in traffic:
        extra["convergence_tol"] = traffic["fit_convergence_tol"]
    return {
        "seed": int(seed),
        "n_starts": int(gp["n_starts"]),
        "n_iter": int(gp["n_iter"]),
        "learning_rate": float(gp["learning_rate"]),
        "length_scale_bounds": tuple(gp["length_scale_bounds"]),
        "constant_kernel_bounds": tuple(gp["constant_kernel_bounds"]),
        "noise_level_bounds": tuple(gp["noise_level_bounds"]),
        **extra,
    }
