"""Readings for the limits of the comparison that decides ``correct``.

    python3 -m h100bench.calibrate --workload <cell> --seeds 1,2,3 --seconds 20 \\
        [--faults fit_unchanged,ea_unchanged] [--fault-seconds 20] [--fault-seeds 3] \\
        [--out chiprun_out/readings.jsonl]

In one process, for each seed: one run of the cell as the benchmark runs
it, judged twice, as the program's answers and with the reference put in
the program's place in the next lower precision (the control); then, for
each fault named, one run with that fault planted (``h100bench.faults``),
on the first ``--fault-seeds`` seeds (all by default). Each reading is one
JSON line; the program's carries the per-layer metrics its spans give,
which show the host's speed over the call. The benchmark's own runs never
run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

T_PROCESS0 = time.perf_counter()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m h100bench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seconds", type=float, default=None)
    ap.add_argument("--fault-seeds", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from h100bench import faults
    from h100bench.harness import runner, spec
    from h100bench.reference import check

    if not torch.cuda.is_available():
        print("h100bench.calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    dev = torch.device("cuda", 0)
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    seeds = [int(s) for s in args.seeds.split(",")]
    fault_seeds = seeds[:args.fault_seeds] if args.fault_seeds is not None else seeds
    for seed in seeds:
        run = runner.Run(cell, seed, args.seconds, False, dev, time.perf_counter())
        spec.driver(cell.traffic).drive(run)
        spans = {m["name"]: spec.metric_reader(m["name"])(run) for m in cell.per_layer
                 if m["source"] == "program_span"}
        for control in (False, True):
            t = time.perf_counter()
            nums = check.judge(run.answers, cell.config, run.missing, dev, control=control)
            emit({"workload": cell.name, "seed": seed,
                  "side": "control" if control else "program",
                  "answers": len(run.answers), "attempted": run.attempted,
                  "failed": run.failed, "e2e": run.e2e, "setup_s": run.setup_s,
                  "judge_s": time.perf_counter() - t, "numbers": nums,
                  **({} if control else {"spans": spans})})
        del run
        for name in filter(None, args.faults.split(",") if seed in fault_seeds else []):
            run = runner.Run(cell, seed, args.fault_seconds or args.seconds, False, dev,
                             time.perf_counter())
            with faults.FAULTS[name]():
                spec.driver(cell.traffic).drive(run)
            nums = check.judge(run.answers, cell.config, run.missing, dev)
            emit({"workload": cell.name, "seed": seed, "side": f"fault:{name}",
                  "answers": len(run.answers), "attempted": run.attempted,
                  "failed": run.failed, "numbers": nums})
            del run
    return 0


if __name__ == "__main__":
    sys.exit(main())
