"""Time an EA's offspring step, its survival, and one whole generation,
from one fixed state, so that two versions of the package compare on
the same work.

Run on a machine with one CUDA device:

    python3 dmosopt_tpu_torch/benchmarks/time_generate.py [--tree DIR] [--optimizer age]

``--tree`` is the root of the checkout whose `dmosopt_tpu_torch` is
timed (default: the one this file lies in); run the file by its path, so
that no other copy of the package is imported first. To compare two
commits, unpack the other with ``git archive`` and run the script from
this tree against both, in the order A, B, B, A, in one session.

The state is built from seeded numpy data that does not depend on the
package. ``--optimizer nsga2`` (the default): a ZDT1 population (dim
30) with the first gene uniform on [0, 1) and the others uniform on
[0, 0.05), i.e. near the front with several fronts, as in the middle of
a run. ``--optimizer age``: AGE-MOEA on DTLZ2 with 5 objectives and 14
parameters (the many-objective example's width), the first 4 genes
uniform on [0, 1) and the others within 0.025 of the front's 0.5. From
that state, each call of the offspring step (`generate_strategy`), of
the survival (`update_strategy` on one fixed set of offspring) and of a
generation (`generate_strategy`, the objective, `update_strategy`)
starts again, so both versions do the same work but for their random
draws. For each population size it prints one JSON line: the median
over rounds of the wall time per call (a batch of calls, synchronized
at its end) and of the host time to queue one call, the Triton kernel
launches per offspring step, and the CUDA kernel launches per
generation (``torch.profiler``'s count of the runtime's and the
driver's launch calls over one generation).
"""

import argparse
import json
import os
import sys
import time

import numpy as np


def _median_us(torch, fn, calls, rounds):
    """(wall us, host us) per call: medians over ``rounds`` batches of
    ``calls`` calls, the wall time synchronized at the batch's end."""
    fn()
    torch.cuda.synchronize()
    wall, host = [], []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        wall.append((t2 - t0) * 1e6 / calls)
        host.append((t1 - t0) * 1e6 / calls)
    return sorted(wall)[rounds // 2], sorted(host)[rounds // 2]


def _launches(torch, fn) -> int:
    """CUDA kernel launches of one call of ``fn`` (runtime and driver
    launch calls, as ``torch.profiler`` records them)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.key in ("cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx",
                            "cudaLaunchKernelExC"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.join(os.path.dirname(__file__), "..", ".."))
    ap.add_argument("--optimizer", choices=("nsga2", "age"), default="nsga2")
    ap.add_argument("--pops", default=None, help="default: 200,100 (nsga2), 100 (age)")
    ap.add_argument("--calls", type=int, default=50)
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("time_generate: no CUDA device is available", file=sys.stderr)
        return 2
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    from functools import partial

    from dmosopt_tpu_torch.ops import variation as V

    if args.optimizer == "age":
        from dmosopt_tpu_torch.benchmarks.moo_benchmarks import dtlz2
        from dmosopt_tpu_torch.optimizers.agemoea import AGEMOEA as Opt

        dim, n_obj, objective = 14, 5, partial(dtlz2, n_obj=5)
    else:
        from dmosopt_tpu_torch.benchmarks.zdt import zdt1 as objective
        from dmosopt_tpu_torch.optimizers.nsga2 import NSGA2 as Opt

        dim, n_obj = 30, 2
    pops = args.pops or ("100" if args.optimizer == "age" else "200,100")
    for pop in (int(p) for p in pops.split(",")):
        rng = np.random.default_rng(args.seed)
        x0 = rng.random((pop, dim))
        if args.optimizer == "age":
            x0[:, n_obj - 1:] = 0.5 + 0.05 * (x0[:, n_obj - 1:] - 0.5)
        else:
            x0[:, 1:] *= 0.05
        y0 = objective(torch.as_tensor(x0, dtype=torch.float32, device="cuda")).cpu().numpy()
        bounds = np.stack([np.zeros(dim), np.ones(dim)], axis=1)
        opt = Opt(popsize=pop, nInput=dim, nOutput=n_obj, model=None)
        state = opt.initialize_strategy(x0, y0, bounds, random=args.seed)
        gen = torch.Generator(device="cuda").manual_seed(args.seed + 1)
        x_fix, st_fix = opt.generate_strategy(gen, state)
        y_fix = objective(x_fix)

        def step():
            opt.generate_strategy(gen, state)

        def survival():
            opt.update_strategy(st_fix, x_fix, y_fix)

        def generation():
            x_gen, st = opt.generate_strategy(gen, state)
            opt.update_strategy(st, x_gen, objective(x_gen))

        V.reset_kernel_launches()
        step()
        torch.cuda.synchronize()
        launches = dict(V.KERNEL_LAUNCHES)
        generation()
        cuda_launches = _launches(torch, generation)
        step_us, step_host_us = _median_us(torch, step, args.calls, args.rounds)
        surv_us, surv_host_us = _median_us(torch, survival, args.calls, args.rounds)
        gen_us, gen_host_us = _median_us(torch, generation, args.calls, args.rounds)
        print(json.dumps({
            "tree": tree, "optimizer": args.optimizer, "pop": pop, "dim": dim,
            "n_obj": n_obj,
            "generate_us": step_us, "generate_host_us": step_host_us,
            "survival_us": surv_us, "survival_host_us": surv_host_us,
            "generation_us": gen_us, "generation_host_us": gen_host_us,
            "triton_launches_per_generate": launches,
            "cuda_launches_per_generation": cuda_launches,
            "calls": args.calls, "rounds": args.rounds,
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
