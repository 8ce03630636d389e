"""Where the PyTorch port's time goes on a GPU.

Run on a machine with one CUDA device, from the root of a checkout:

    python3 -m dmosopt_tpu_torch.benchmarks.profile_epoch [--out DIR] \
        [--optimizer nsga2|age]

(the traces go to ``dmosopt_tpu_torch/_build/profile`` by default).

It profiles, with `torch.profiler` (host and device activity), for
``--optimizer nsga2`` (the default):

1. direct NSGA-II on ZDT1 (pop 100, dim 30): 20 warm-up generations,
   then 20 profiled ones;
2. the quick start's first epoch at full width: the GPR fit on the
   90-point SLH initial design (dim 30, `gpr` defaults, after one
   unprofiled warm-up fit), then NSGA-II (pop 200) against it: 20
   warm-up generations, then 20 profiled ones.

and for ``--optimizer age`` the many-objective run's first epoch at
full width (``examples/example_dtlz_many_objective.py``): the GPR fit
on the 70-point SLH design of DTLZ2 with 5 objectives and 14
parameters, then AGE-MOEA (pop 100) against it, 20 warm-up and 20
profiled generations. The greedy survival loop runs inside a
``greedy_survival_loop`` profiler range, and one of its calls is
profiled alone, so its launches, device time and share of the
generation's wall are printed too.

For each it prints the wall time per generation (or per fit), the
device's busy share (the device time of all kernels and copies over the
wall time; one stream, so they never overlap), the device time of each
launch of each Triton kernel, the kernel launches, the
host syncs per generation (counted with CUDA sync debug mode, in a
separate unprofiled pass) and the top operators by host and by device
time. Nothing here imports JAX.
"""

import argparse
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import torch
from torch.autograd import DeviceType

from dmosopt_tpu_torch import sampling
from dmosopt_tpu_torch.benchmarks.zdt import zdt1
from dmosopt_tpu_torch.models import Model
from dmosopt_tpu_torch.models.gp import GPR_Matern
from dmosopt_tpu_torch.moasmo import _surrogate_eval_fn
from dmosopt_tpu_torch.optimizers.base import run_ea_loop
from dmosopt_tpu_torch.optimizers.nsga2 import NSGA2

ACT = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
TRITON_KERNELS = ("mutation_kernel", "sbx_kernel", "offspring_kernel")


GREEDY_RANGE = "greedy_survival_loop"


def _device_us(evt) -> float:
    """Device time of a device-side event (a kernel or a copy); the host
    operators that launched it carry the same time and are skipped, and
    so is the device-side span of a `record_function` range, which
    covers the kernels inside it rather than adding to them."""
    if getattr(evt, "device_type", None) != DeviceType.CUDA or evt.key == GREEDY_RANGE:
        return 0.0
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _profiled(label, fn, n_units, unit, out_dir):
    """Run ``fn`` once under the profiler and print the breakdown.
    Returns (wall seconds, device microseconds, kernel launches, the
    profiler's key averages)."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=ACT) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ka = prof.key_averages()
    device_us = sum(_device_us(e) for e in ka)
    launches = sum(e.count for e in ka if "LaunchKernel" in e.key)
    syncs = sum(e.count for e in ka if e.key in (
        "cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpyAsync"))
    print(f"== {label}: {n_units} {unit}(s), wall {wall * 1e3:.3f} ms "
          f"({wall * 1e3 / n_units:.3f} ms per {unit}); device busy "
          f"{device_us / 1e3:.3f} ms = {100 * device_us / 1e6 / wall:.1f}% of wall; "
          f"{launches / n_units:.1f} kernel launches and {syncs / n_units:.2f} "
          f"sync/copy calls per {unit}")
    for e in ka:
        if _device_us(e) and e.key.startswith(TRITON_KERNELS):
            print(f"   Triton {e.key}: {e.count} launches, "
                  f"{_device_us(e) / e.count:.3f} us each on the device")
    sort_dev = "self_device_time_total" if hasattr(ka[0], "self_device_time_total") \
        else "self_cuda_time_total"
    print(ka.table(sort_by="self_cpu_time_total", row_limit=12, max_name_column_width=48))
    print(ka.table(sort_by=sort_dev, row_limit=12, max_name_column_width=48))
    prof.export_chrome_trace(os.path.join(out_dir, f"{label}.json"))
    return wall, device_us, launches, ka


def _count_syncs(fn) -> int:
    """Host syncs made by ``fn``, as CUDA sync debug mode reports them."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def direct_ea(out_dir):
    dim, pop, gens = 30, 100, 20
    bounds = np.stack([np.zeros(dim), np.ones(dim)], axis=1)
    x0 = sampling.lh(2 * pop, dim, 1)
    y0 = zdt1(torch.as_tensor(x0, device="cuda")).cpu().numpy()
    opt = NSGA2(popsize=pop, nInput=dim, nOutput=2, model=None)
    opt.initialize_strategy(x0, y0, bounds, random=1)
    g = torch.Generator(device="cuda").manual_seed(2)
    opt.state = run_ea_loop(opt, opt.state, g, gens, zdt1)  # warm-up
    syncs = _count_syncs(lambda: run_ea_loop(opt, opt.state, g, gens, zdt1))
    print(f"direct EA: {syncs / gens:.2f} host syncs per generation")
    _profiled("direct_ea", lambda: run_ea_loop(opt, opt.state, g, gens, zdt1),
              gens, "generation", out_dir)


def quick_start_epoch(out_dir):
    dim, pop = 30, 200
    rng = np.random.default_rng(0)
    mdl, eval_fn, x0, bounds = _surrogate_setup(zdt1, dim, 2, 3 * dim, rng, out_dir)
    opt = NSGA2(popsize=pop, nInput=dim, nOutput=2, model=mdl, distance_metric=None)
    x = np.vstack([x0, sampling.lh(pop, dim, rng)]).astype(np.float32)
    y = eval_fn(torch.as_tensor(x, device="cuda")).cpu().numpy()
    opt.initialize_strategy(x, y, bounds, random=rng)
    g = torch.Generator(device="cuda").manual_seed(3)
    gens = 20
    opt.state = run_ea_loop(opt, opt.state, g, gens, eval_fn)  # warm-up
    syncs = _count_syncs(lambda: run_ea_loop(opt, opt.state, g, gens, eval_fn))
    print(f"surrogate EA: {syncs / gens:.2f} host syncs per generation")
    _profiled("surrogate_ea", lambda: run_ea_loop(opt, opt.state, g, gens, eval_fn),
              gens, "generation", out_dir)


def _surrogate_setup(obj, dim, n_obj, n_design, rng, out_dir):
    """GPR fit on an SLH design of ``obj`` (after one unprofiled warm-up
    fit), profiled. Returns the `Model`, its batch objective, the design
    and the unit bounds."""
    xlb, xub = np.zeros(dim), np.ones(dim)
    x0 = sampling.slh(n_design, dim, rng, maxiter=5)
    y0 = obj(torch.as_tensor(x0, dtype=torch.float32, device="cuda")).cpu().numpy()
    fit = {}

    def train():
        fit["sm"] = GPR_Matern(x0, y0, dim, n_obj, xlb, xub)

    GPR_Matern(x0, y0, dim, n_obj, xlb, xub)  # warm-up (library handles, caches)
    _profiled("gp_fit", train, 1, "fit", out_dir)
    print(f"gp_fit: {fit['sm'].fit_info}")
    mdl = Model(objective=fit["sm"])
    return mdl, _surrogate_eval_fn(mdl), x0, np.stack([xlb, xub], 1)


def many_objective_epoch(out_dir):
    """AGE-MOEA against a GPR fit of DTLZ2 (5 objectives, 14 parameters),
    pop 100, and the greedy survival loop alone."""
    from dmosopt_tpu_torch.benchmarks.moo_benchmarks import get_problem
    from dmosopt_tpu_torch.optimizers import agemoea
    from dmosopt_tpu_torch.optimizers.agemoea import AGEMOEA

    n_obj, dim, pop = 5, 14, 100
    rng = np.random.default_rng(7)
    mdl, eval_fn, x0, bounds = _surrogate_setup(
        get_problem("dtlz2", n_obj), dim, n_obj, 5 * dim, rng, out_dir)
    opt = AGEMOEA(popsize=pop, nInput=dim, nOutput=n_obj, model=mdl)
    x = np.vstack([x0, sampling.lh(pop, dim, rng)]).astype(np.float32)
    y = eval_fn(torch.as_tensor(x, device="cuda")).cpu().numpy()
    opt.initialize_strategy(x, y, bounds, random=rng)
    g = torch.Generator(device="cuda").manual_seed(3)
    gens = 20

    greedy = agemoea._greedy_scores
    last_args = {}

    def annotated(*args):
        last_args["args"] = args
        with torch.profiler.record_function(GREEDY_RANGE):
            return greedy(*args)

    agemoea._greedy_scores = annotated
    try:
        opt.state = run_ea_loop(opt, opt.state, g, gens, eval_fn)  # warm-up
        syncs = _count_syncs(lambda: run_ea_loop(opt, opt.state, g, gens, eval_fn))
        print(f"AGE-MOEA surrogate EA: {syncs / gens:.2f} host syncs per generation")
        wall, device_us, launches, ka = _profiled(
            "agemoea_ea", lambda: run_ea_loop(opt, opt.state, g, gens, eval_fn),
            gens, "generation", out_dir)
    finally:
        agemoea._greedy_scores = greedy
    loop = [e for e in ka if e.key == GREEDY_RANGE]
    if loop:
        host_us = loop[0].cpu_time_total
        print(f"{GREEDY_RANGE}: {loop[0].count} calls, host "
              f"{host_us / 1e3:.3f} ms = {100 * host_us / 1e6 / wall:.1f}% of the "
              f"wall of {gens} generations")

    def loop_once():
        greedy(*last_args["args"])

    loop_once()
    l_wall, l_dev, l_launch, _ = _profiled(
        GREEDY_RANGE, loop_once, 1, "call", out_dir)
    print(f"greedy survival loop alone: {l_launch} launches, device "
          f"{l_dev / 1e3:.3f} ms, wall {l_wall * 1e3:.3f} ms per call; per "
          f"generation the EA made {launches / gens:.1f} launches in "
          f"{wall * 1e3 / gens:.3f} ms, so the loop is "
          f"{100 * l_launch * gens / max(launches, 1):.1f}% of the launches and "
          f"{100 * l_wall * gens / wall:.1f}% of the wall")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--out", default=os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "_build", "profile"),
        help="directory for the Chrome traces",
    )
    ap.add_argument("--optimizer", choices=("nsga2", "age"), default="nsga2",
                    help="which surrogate EA to profile")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_epoch: no CUDA device is available", file=sys.stderr)
        return 2
    os.makedirs(args.out, exist_ok=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(smi, f"torch {torch.__version__}")
    if args.optimizer == "age":
        many_objective_epoch(args.out)
        return 0
    direct_ea(args.out)
    quick_start_epoch(args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
