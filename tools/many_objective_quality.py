"""Front quality of the many-objective run in both packages, on the CPU.

Runs ``examples/example_dtlz_many_objective.py``'s configuration (DTLZ2
with 5 objectives and 14 parameters, AGE-MOEA, the "fast" adaptive
termination, 5 initial points per parameter, 3 epochs, resample
fraction 0.5, `gpr` defaults) through `dmosopt_tpu.run` and
`dmosopt_tpu_torch.run`, for each seed, and prints per run the median
of ||f|| - 1 and the exact hypervolume (reference point 2.5 per
objective) of: the initial design, the returned set, the resampled rows
(the archive after the design) and, as the baseline an optimizer must
beat, the same number of uniform random points in the box (``--draws``
seeded draws; their median and largest value).

    JAX_PLATFORMS=cpu python tools/many_objective_quality.py \\
        --pop 100 --generations 100 --seeds 7 8 9
"""

import argparse
import time

import numpy as np


def _run(package, pop, generations, seed):
    if package == "jax":
        import dmosopt_tpu as pkg
        from dmosopt_tpu.benchmarks.moo_benchmarks import generate_problem_space, get_problem
        from dmosopt_tpu.driver import dopt_dict

        extra, kwargs = {"jax_objective": True}, {}
    else:
        import dmosopt_tpu_torch as pkg
        from dmosopt_tpu_torch.benchmarks.moo_benchmarks import (
            generate_problem_space, get_problem,
        )
        from dmosopt_tpu_torch.driver import dopt_dict

        extra, kwargs = {"torch_objective": True}, {"device": "cpu"}
    space = generate_problem_space("dtlz2", 5)
    opt_id = f"quality_{package}_{seed}"
    t0 = time.perf_counter()
    best = pkg.run({
        "opt_id": opt_id, "obj_fun": get_problem("dtlz2", 5), "problem_parameters": {},
        "space": space, "objective_names": [f"f{i + 1}" for i in range(5)],
        "population_size": pop, "num_generations": generations,
        "optimizer_name": "age", "surrogate_method_name": "gpr",
        "termination_conditions": {"strategy": "fast"}, "n_initial": 5,
        "n_epochs": 3, "resample_fraction": 0.5, "random_seed": seed, **extra,
    }, verbose=False, **kwargs)
    wall = time.perf_counter() - t0
    y_all = np.asarray(dopt_dict[opt_id].optimizer_dict[0].get_evals()[1])
    y_best = np.column_stack([v for _, v in best[1]])
    return wall, 5 * len(space), y_all, y_best


def random_baseline(n, draws, ref, seed=0):
    """Median ||f|| - 1 and hypervolume of ``draws`` seeded sets of n
    uniform random DTLZ2 points (5 objectives, 14 parameters)."""
    import torch

    from dmosopt_tpu_torch.benchmarks.moo_benchmarks import get_problem
    from dmosopt_tpu_torch.hv import hypervolume_exact

    f = get_problem("dtlz2", 5)
    rng = np.random.default_rng(seed)
    gaps, hvs = [], []
    for _ in range(draws):
        y = f(torch.as_tensor(rng.uniform(size=(n, 14)), dtype=torch.float32)).numpy()
        gaps.append(float(np.median(np.linalg.norm(y, axis=1) - 1)))
        hvs.append(hypervolume_exact(y, ref))
    return np.asarray(gaps), np.asarray(hvs)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pop", type=int, default=100)
    ap.add_argument("--generations", type=int, default=100)
    ap.add_argument("--seeds", type=int, nargs="+", default=[7, 8, 9])
    ap.add_argument("--packages", nargs="+", default=["jax", "torch"])
    ap.add_argument("--draws", type=int, default=20)
    args = ap.parse_args()

    from dmosopt_tpu_torch.hv import hypervolume_exact

    ref = np.full(5, 2.5)
    for seed in args.seeds:
        for package in args.packages:
            wall, n0, y_all, y_best = _run(package, args.pop, args.generations, seed)
            gap = np.linalg.norm(y_all, axis=1) - 1
            hv0 = hypervolume_exact(y_all[:n0], ref)
            hv = hypervolume_exact(y_best, ref)
            hv_res = hypervolume_exact(y_all[n0:], ref)
            r_gap, r_hv = random_baseline(len(y_all) - n0, args.draws, ref)
            print(
                f"seed {seed} {package}: {len(y_all)} archived rows in {wall:.1f} s; "
                f"median ||f|| - 1: design {np.median(gap[:n0]):.4f}, returned "
                f"{np.median(np.linalg.norm(y_best, axis=1) - 1):.4f} "
                f"({len(y_best)} points), resamples {np.median(gap[n0:]):.4f}, "
                f"random (median, least of {args.draws}) {np.median(r_gap):.4f} "
                f"{r_gap.min():.4f}; hypervolume design {hv0:.4f}, returned "
                f"{hv:.4f} (ratio {hv / hv0:.4f}), resamples {hv_res:.4f}, random "
                f"(median, largest) {np.median(r_hv):.4f} {r_hv.max():.4f}",
                flush=True,
            )


if __name__ == "__main__":
    main()
