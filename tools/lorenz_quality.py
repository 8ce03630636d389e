"""Quality of the Lorenz parameter estimation in both packages, on the CPU.

Runs ``examples/example_lorenz.py``'s configuration (estimate (b, r, s)
of the Lorenz system from a trajectory: 3 per-axis error objectives,
``["cmaes", "smpso"]`` cycled over 2 epochs, no surrogate, 100 initial
points per parameter, seed as given) through `dmosopt_tpu.run` and
`dmosopt_tpu_torch.run` at ``--pop`` and ``--generations`` per epoch,
for each seed, and prints per run: the least total error (the sum of the
three objectives) of the initial design and of the returned set, the
returned set's size, the median total error of the final archive (the
best ``pop`` rows kept before the last generation and that generation's
offspring) and, as the baseline an optimizer must beat, the median
total error of as many uniform random points in the box (``--draws``
seeded sets through the same package's objective; their least median),
and the wall time.

At the example's width an SMPSO archive reaches 45 056 rows, where the
JAX package's dense float64 dedupe needs over 32 GB of host memory; the
script hands the JAX package's strategy the port's blocked dedupe
(`dmosopt_tpu_torch.moasmo.get_duplicates`, which the CPU tests hold
equal to the JAX package's), so the JAX run fits in a few GB.

    JAX_PLATFORMS=cpu python tools/lorenz_quality.py \\
        --pop 4096 --generations 5 --seeds 0 1 2 --packages jax
"""

import argparse
import importlib.util
import os
import time

import numpy as np

SPACE = {"s": [5.0, 15.0], "r": [15.0, 35.0], "b": [1.0, 10.0]}
N_INITIAL = 100


def _example():
    path = os.path.join(os.path.dirname(__file__), "..", "examples", "example_lorenz.py")
    spec = importlib.util.spec_from_file_location("example_lorenz", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(package, pop, generations, seed):
    if package == "jax":
        import dmosopt_tpu as pkg
        from dmosopt_tpu import moasmo, strategy
        from dmosopt_tpu.driver import dopt_dict
        from functools import partial

        from dmosopt_tpu_torch.moasmo import get_duplicates

        moasmo.get_duplicates = strategy.get_duplicates = partial(
            get_duplicates, device="cpu"
        )
        obj = _example().lorenz_objectives
        extra, kwargs = {"jax_objective": True}, {}
    else:
        import dmosopt_tpu_torch as pkg
        from dmosopt_tpu_torch.benchmarks.lorenz import lorenz_objectives as obj
        from dmosopt_tpu_torch.driver import dopt_dict

        extra, kwargs = {"torch_objective": True}, {"device": "cpu"}
    opt_id = f"lorenz_quality_{package}_{seed}"
    t0 = time.perf_counter()
    best = pkg.run({
        "opt_id": opt_id, "obj_fun": obj, "problem_parameters": {}, "space": SPACE,
        "objective_names": ["x", "y", "z"], "population_size": pop,
        "num_generations": generations, "optimizer_name": ["cmaes", "smpso"],
        "surrogate_method_name": None, "n_initial": N_INITIAL, "n_epochs": 2,
        "resample_fraction": 0.25, "random_seed": seed, **extra,
    }, verbose=False, **kwargs)
    wall = time.perf_counter() - t0
    dopt = dopt_dict[opt_id]
    y_all = np.asarray(dopt.optimizer_dict[0].get_evals()[1])
    return wall, dopt.eval_count, np.column_stack([v for _, v in best[1]]), y_all


def _bounds():
    names = sorted(SPACE)
    return (np.array([SPACE[k][0] for k in names]), np.array([SPACE[k][1] for k in names]))


def total_errors(package, x):
    """Total errors of (n, 3) points in the sorted-key column order
    (b, r, s) through the package's own objective (the trajectories of
    the two packages part after a short horizon)."""
    x = x.astype(np.float32)
    if package == "jax":
        import jax.numpy as jnp

        y = np.asarray(_example().lorenz_objectives(jnp.asarray(x)))
    else:
        import torch

        from dmosopt_tpu_torch.benchmarks.lorenz import lorenz_objectives

        y = lorenz_objectives(torch.as_tensor(x)).numpy()
    return y.sum(axis=1)


def design_errors(package, seed):
    """Total errors of the run's initial design: the symmetric Latin
    hypercube the driver draws first from the seeded generator."""
    from dmosopt_tpu_torch import sampling

    lb, ub = _bounds()
    x = sampling.slh(N_INITIAL * 3, 3, np.random.default_rng(seed), maxiter=5)
    return total_errors(package, lb + x * (ub - lb))


def random_medians(package, n, draws, seed=0):
    """Median total error of ``draws`` seeded sets of n uniform points."""
    lb, ub = _bounds()
    rng = np.random.default_rng(seed)
    return np.array([
        np.median(total_errors(package, lb + rng.random((n, 3)) * (ub - lb)))
        for _ in range(draws)
    ])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pop", type=int, default=4096)
    ap.add_argument("--generations", type=int, default=5)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--packages", nargs="+", default=["jax"])
    ap.add_argument("--draws", type=int, default=3)
    args = ap.parse_args()

    for seed in args.seeds:
        for package in args.packages:
            design = design_errors(package, seed)
            wall, n_evals, y_best, y_all = _run(package, args.pop, args.generations, seed)
            total = y_best.sum(axis=1)
            rand = random_medians(package, len(y_all), args.draws)
            print(
                f"seed {seed} {package}: pop {args.pop}, {args.generations} "
                f"generations an epoch, {n_evals} evaluations in {wall:.1f} s; "
                f"least total error: design {design.min():.6f}, returned "
                f"{total.min():.6f} ({len(total)} points); median total error: "
                f"final archive {np.median(y_all.sum(axis=1)):.6f} "
                f"({len(y_all)} rows), as many random points {rand.min():.6f} "
                f"(least of {args.draws} draws)",
                flush=True,
            )


if __name__ == "__main__":
    main()
