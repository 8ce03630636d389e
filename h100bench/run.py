"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m h100bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Exits 2 without a result where no CUDA device is present, or fewer than
the cell asks for; exits 3 without a result where the process holds JAX
or the JAX package once the window has closed.
"""

from __future__ import annotations

import time

T_PROCESS0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def _power_line():
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m h100bench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from h100bench.harness import spec

    cell = spec.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"h100bench: the cell needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} present",
              file=sys.stderr)
        return 2
    # the program's kernel cache, at a fixed path inside the checkout
    os.environ["TRITON_CACHE_DIR"] = str(spec.ROOT / "dmosopt_tpu_torch" / "_build" / "triton")
    print(f"h100bench: {args.workload} seed {args.seed} on {_power_line()}", file=sys.stderr)

    from h100bench.harness import runner

    result, rows, forbidden = runner.execute(
        cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), T_PROCESS0)
    if forbidden:
        print(f"h100bench: the process holds {', '.join(forbidden)}; no result",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for name, value, limit in rows:
        print(f"compared {name} {value!r} limit {limit!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
