"""Time NSGA-II's offspring step, and one whole generation, from one
fixed state, so that two versions of the package compare on the same
work.

Run on a machine with one CUDA device:

    python3 dmosopt_tpu_torch/benchmarks/time_generate.py [--tree DIR]

``--tree`` is the root of the checkout whose `dmosopt_tpu_torch` is
timed (default: the one this file lies in); run the file by its path, so
that no other copy of the package is imported first. To compare two
commits, unpack the other with ``git archive`` and run the script from
this tree against both, in the order A, B, B, A, in one session.

The state is built from seeded numpy data that does not depend on the
package: a ZDT1 population (dim 30) with the first gene uniform on
[0, 1) and the others uniform on [0, 0.05), i.e. near the front with
several fronts, as in the middle of a run. From that state, each call
of the offspring step (`generate_strategy`) and of a generation
(`generate_strategy`, ZDT1, `update_strategy`) starts again, so both
versions do the same work but for their random draws. For each
population size it prints one JSON line: the median over rounds of the
wall time per call (a batch of calls, synchronized at its end) and of
the host time to queue one call, and the Triton kernel launches per
offspring step.
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.join(os.path.dirname(__file__), "..", ".."))
    ap.add_argument("--pops", default="200,100")
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
    from dmosopt_tpu_torch.benchmarks.zdt import zdt1
    from dmosopt_tpu_torch.ops import variation as V
    from dmosopt_tpu_torch.optimizers.nsga2 import NSGA2

    dim = 30
    for pop in (int(p) for p in args.pops.split(",")):
        rng = np.random.default_rng(args.seed)
        x0 = rng.random((pop, dim))
        x0[:, 1:] *= 0.05
        y0 = zdt1(torch.as_tensor(x0, dtype=torch.float32, device="cuda")).cpu().numpy()
        bounds = np.stack([np.zeros(dim), np.ones(dim)], axis=1)
        opt = NSGA2(popsize=pop, nInput=dim, nOutput=2, model=None)
        state = opt.initialize_strategy(x0, y0, bounds, random=args.seed)
        gen = torch.Generator(device="cuda").manual_seed(args.seed + 1)

        def step():
            opt.generate_strategy(gen, state)

        def generation():
            x_gen, st = opt.generate_strategy(gen, state)
            opt.update_strategy(st, x_gen, zdt1(x_gen))

        V.reset_kernel_launches()
        step()
        torch.cuda.synchronize()
        launches = dict(V.KERNEL_LAUNCHES)
        step_us, step_host_us = _median_us(torch, step, args.calls, args.rounds)
        gen_us, gen_host_us = _median_us(torch, generation, args.calls, args.rounds)
        print(json.dumps({
            "tree": tree, "pop": pop, "dim": dim,
            "generate_us": step_us, "generate_host_us": step_host_us,
            "generation_us": gen_us, "generation_host_us": gen_host_us,
            "triton_launches_per_generate": launches,
            "calls": args.calls, "rounds": args.rounds,
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
