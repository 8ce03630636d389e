"""Quality of ``bench.py``'s zdt1_agemoea_gpr run under the surrogate
reuse options, in both packages, on the CPU.

Runs the configuration of ``bench.py`` Configs 8 and 9 Part B (ZDT1
with 30 parameters as a batched objective, AGE-MOEA, pop 100, 100
generations, ``n_initial`` 8, 5 epochs, resample fraction 0.25, `gpr`
with 4 starts and 100 steps, seed 0, ``random_seed`` 42; the dict is
``chip_smoke.refit_params``) through `dmosopt_tpu.run` and
`dmosopt_tpu_torch.run` in each mode, and prints per run its wall, the
returned set's size and ``within_0.05`` (returned points within 0.05 of
the ZDT1 front, the bench's quality number). Modes: ``cold`` (the
default fit), ``warm`` (``surrogate_refit="warm"``), ``matmul``
(``predictor="matmul"``) and ``frozen``, where every epoch after the
first reuses the first epoch's surrogate, as a refit path that never
updated its predictor would.

    JAX_PLATFORMS=cpu python tools/refit_quality.py --modes cold warm matmul frozen
    JAX_PLATFORMS=cpu python tools/refit_quality.py --packages torch --seeds 42 43
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def frozen_train(moasmo):
    """Patch ``moasmo.train`` so that every call after the first returns
    the first call's surrogate; returns the original."""
    original = moasmo.train
    first = []

    def train(*args, **kwargs):
        if not first:
            first.append(original(*args, **kwargs))
        return first[0]

    moasmo.train = train
    return original


def run_mode(package, mode, seed):
    if package == "jax":
        import dmosopt_tpu as pkg
        from dmosopt_tpu import moasmo
        from dmosopt_tpu.benchmarks.zdt import zdt1

        params = chip_smoke.refit_params(f"q_{package}_{mode}_{seed}", zdt1, mode,
                                         jax_objective=True, random_seed=seed)
        kwargs = {}
    else:
        import dmosopt_tpu_torch as pkg
        from dmosopt_tpu_torch import moasmo
        from dmosopt_tpu_torch.benchmarks.zdt import zdt1

        params = chip_smoke.refit_params(f"q_{package}_{mode}_{seed}", zdt1, mode,
                                         torch_objective=True, random_seed=seed)
        kwargs = {"device": "cpu"}
    original = frozen_train(moasmo) if mode == "frozen" else None
    try:
        t0 = time.perf_counter()
        best = pkg.run(params, verbose=False, **kwargs)
        wall = time.perf_counter() - t0
    finally:
        if original is not None:
            moasmo.train = original
    y = np.column_stack([v for _, v in best[1]])
    return wall, y.shape[0], chip_smoke.within_front(y)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--packages", nargs="+", default=["jax", "torch"])
    ap.add_argument("--modes", nargs="+", default=["cold", "warm", "matmul", "frozen"])
    ap.add_argument("--seeds", nargs="+", type=int, default=[42])
    args = ap.parse_args(argv)
    if "torch" in args.packages:
        import torch

        torch.set_num_threads(1)
    for seed in args.seeds:
        for package in args.packages:
            for mode in args.modes:
                wall, n_best, within = run_mode(package, mode, seed)
                print(f"{package} {mode} seed {seed}: {wall:.1f} s, {n_best} returned, "
                      f"within_0.05 {within}", flush=True)


if __name__ == "__main__":
    main()
