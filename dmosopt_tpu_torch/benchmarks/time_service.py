"""Time the ask/tell service's step against its task-graph concurrency.

Run on a machine with one CUDA device, from the root of a checkout:

    python3 -m dmosopt_tpu_torch.benchmarks.time_service [--tenants 64]
        [--modes lockstep,1,2,4,7] [--reps 2] [--one-bucket-at-a-time]

Each run is ``bench.py`` Config 12 (``bench.py:1200-1338``): T tenants
of ZDT1 at dims 4, 5, 6 and 7, round-robin (four static buckets), pop
16, 8 generations, 2 epochs, 3 initial points per parameter, `gpr` with
2 starts and 40 steps, ``min_bucket`` 2, seeds 100 + i, batched torch
objectives. A mode is ``lockstep`` (``scheduler=None``) or a task-graph
concurrency (``scheduler=N``). The modes run in turns, ``--reps`` times
(after one untimed lockstep run that warms the process), and each
prints one JSON line: the walls, their best, and the host seconds of
the buckets' ``gp_fit`` and ``ea_scan`` spans summed over the run (the
spans of buckets that run side by side on worker threads overlap, so
their sum can exceed the wall).

``--one-bucket-at-a-time`` is an experiment, not a service option: it
holds a lock around each bucket node's epoch
(`tenants.initialize_epochs_batched`), so at most one bucket launches at
a time while the evaluation, fold and checkpoint nodes still overlap.
"""

import argparse
import json
import sys
import threading
import time


def config12(svc, T):
    from dmosopt_tpu_torch.benchmarks.zdt import zdt1

    dims = (4, 5, 6, 7)
    for i in range(T):
        dim = dims[i % len(dims)]
        svc.submit(
            zdt1, {f"x{j}": [0.0, 1.0] for j in range(dim)}, ["f1", "f2"],
            opt_id=f"tg_{T}_{i}", torch_objective=True, n_epochs=2,
            population_size=16, num_generations=8, n_initial=3,
            surrogate_method_kwargs={"n_starts": 2, "n_iter": 40, "seed": 0},
            random_seed=100 + i,
        )


def one_run(torch, T, scheduler):
    """(wall, host seconds of the gp_fit and ea_scan spans) of one run."""
    from dmosopt_tpu_torch.service import OptimizationService

    svc = OptimizationService(min_bucket=2, scheduler=scheduler, device="cuda")
    config12(svc, T)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    svc.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    spans = {
        name: sum(sp.duration_s or 0.0 for sp in svc.telemetry.tracer.spans(name))
        for name in ("gp_fit", "ea_scan")
    }
    svc.close()
    return wall, spans


def serialize_buckets():
    """Hold one lock around every `initialize_epochs_batched` call of the
    service's bucket nodes (the experiment of ``--one-bucket-at-a-time``)."""
    from dmosopt_tpu_torch import tenants

    lock = threading.Lock()
    inner = tenants.initialize_epochs_batched

    def locked(*args, **kwargs):
        with lock:
            return inner(*args, **kwargs)

    tenants.initialize_epochs_batched = locked


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tenants", type=int, default=64)
    ap.add_argument("--modes", default="lockstep,1,2,4,7")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--one-bucket-at-a-time", action="store_true")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("time_service: no CUDA device is available", file=sys.stderr)
        return 2
    if args.one_bucket_at_a_time:
        serialize_buckets()
    modes = [m.strip() for m in args.modes.split(",") if m.strip()]
    sched = {m: (None if m == "lockstep" else int(m)) for m in modes}
    one_run(torch, args.tenants, None)  # warms the process
    walls = {m: [] for m in modes}
    spans = {m: [] for m in modes}
    for _ in range(args.reps):
        for m in modes:
            w, s = one_run(torch, args.tenants, sched[m])
            walls[m].append(w)
            spans[m].append(s)
    device = torch.cuda.get_device_name(0)
    for m in modes:
        print(json.dumps({
            "device": device, "tenants": args.tenants, "mode": m,
            "one_bucket_at_a_time": args.one_bucket_at_a_time,
            "walls_s": [round(w, 4) for w in walls[m]], "best_s": round(min(walls[m]), 4),
            "gp_fit_host_s": [round(s["gp_fit"], 4) for s in spans[m]],
            "ea_scan_host_s": [round(s["ea_scan"], 4) for s in spans[m]],
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
