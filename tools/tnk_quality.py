"""Quality of the constrained TNK run in both packages, on the CPU.

Runs ``examples/example_tnk.py``'s configuration (TNK as a host
objective returning ``(y, c)``, 2 parameters in [1e-6, pi], the
``logreg`` feasibility model, NSGA-II, pop 100, 50 generations,
``n_initial`` 20, 4 epochs, resample fraction 0.5, `gpr` defaults) with
the epoch-0 ``dynamic_initial_sampling`` hook of ``chip_smoke.py``
phase 9 (children of the feasible rows from `ParamSpacePoints` until 10
feasible rows exist) through `dmosopt_tpu.run` and
`dmosopt_tpu_torch.run`, for each seed, and prints per run the two
numbers phase 9 prints: the feasible share of the resampled rows (the
rows evaluated after the design and the hook's rounds) and the
hypervolume of the returned set against the reference point (1.2, 1.2).
``--noise-rank`` replaces the port's feasibility rank (the optimizers'
within-front key) with seeded uniform noise, as a mutated copy would.

    JAX_PLATFORMS=cpu python tools/tnk_quality.py --seeds 1 2 3
    JAX_PLATFORMS=cpu python tools/tnk_quality.py --packages torch --noise-rank
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

HOOK_ROUNDS = []


def jax_quota_sampler(file_path, iteration, evaluated_samples, next_samples, sampler,
                      quota=10, n_children=200, max_rounds=8, **_):
    """`chip_smoke.tnk_quota_sampler` with the JAX package's
    `ParamSpacePoints`."""
    from dmosopt_tpu.constrained_sampling import ParamSpacePoints

    parents = chip_smoke.quota_parents(evaluated_samples, quota, iteration, max_rounds)
    if parents is None:
        return None
    names = list(sampler["param_names"])
    ps = ParamSpacePoints(
        n_children, chip_smoke.tnk_space(sampler), seed=iteration,
        parents={"params": np.array(names), "values": parents},
    )
    HOOK_ROUNDS.append(ps.values.shape[0])
    return np.column_stack([ps.as_dict()[k] for k in names])


def run_tnk(package, seed, n_children=200):
    """One run; returns (wall, hook rows, evaluated (x, c), returned y)."""
    evaluated = []

    def objective(pp):
        y, c = chip_smoke.tnk_obj(pp)
        evaluated.append(np.concatenate([[pp["x1"], pp["x2"]], c]))
        return y, c

    if package == "jax":
        import dmosopt_tpu as pkg

        hook, rounds, kwargs = f"{__name__}.jax_quota_sampler", HOOK_ROUNDS, {}
        hook_kwargs = {"n_children": n_children}
    else:
        import dmosopt_tpu_torch as pkg

        hook, rounds = "chip_smoke.tnk_quota_sampler", chip_smoke.TNK_HOOK_ROUNDS
        kwargs = {"device": "cpu"}
        hook_kwargs = {"device": "cpu", "n_children": n_children}
    rounds.clear()
    params = chip_smoke.tnk_params(f"tnk_{package}_{seed}", objective, seed=seed)
    params.update(dynamic_initial_sampling=hook,
                  dynamic_initial_sampling_kwargs=hook_kwargs)
    t0 = time.perf_counter()
    best = pkg.run(params, verbose=False, **kwargs)
    wall = time.perf_counter() - t0
    y_best = np.column_stack([v for _, v in best[1]])
    return wall, sum(rounds), np.asarray(evaluated), y_best


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3])
    ap.add_argument("--packages", nargs="+", default=["jax", "torch"])
    ap.add_argument("--noise-rank", action="store_true")
    ap.add_argument("--children", type=int, default=200,
                    help="children the hook proposes a round")
    args = ap.parse_args()
    if args.noise_rank:
        import torch

        from dmosopt_tpu_torch.feasibility import LogisticFeasibilityModel

        gen = torch.Generator().manual_seed(0)

        def noise_rank(self, x):
            shape = torch.as_tensor(x).shape[:-1]
            return torch.rand(shape, generator=gen).to(self.device)

        LogisticFeasibilityModel.rank = noise_rank

    for seed in args.seeds:
        for package in args.packages:
            wall, n_hook, ev, y_best = run_tnk(package, seed, args.children)
            share, hv = chip_smoke.tnk_quality(ev, chip_smoke.TNK_N0 + n_hook, y_best)
            print(
                f"seed {seed} {package}{' (noise rank)' if args.noise_rank else ''}: "
                f"{len(ev)} evaluations ({n_hook} from the "
                f"hook) in {wall:.1f} s; resamples' feasible share {share:.4f}, "
                f"returned set {len(y_best)} points, hypervolume "
                f"{hv:.6f} (reference point {chip_smoke.TNK_REF})",
                flush=True,
            )


if __name__ == "__main__":
    main()
