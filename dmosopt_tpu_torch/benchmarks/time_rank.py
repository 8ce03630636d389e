"""Time the memory-bounded non-dominated rank on the card.

Ranks seeded objective sets of the sizes the large-population run
gives it (SMPSO's archive of 45 056 rows, its five swarm survivals of
12 288 rows as one batched call) for each column-block width and count
of diagonal refinements given, and prints per case: the fronts, the
relaxation steps, the wall time (median of ``--repeats``
calls, each ended by a device sync) and the extra device memory at the
call's peak. The sets are ``t + noise * u`` in each of 3 objectives
(t, u uniform): the smaller the noise, the more correlated the
objectives and the more fronts, as the Lorenz example's per-axis errors
are.

    python3 -m dmosopt_tpu_torch.benchmarks.time_rank \\
        --sizes 1x45056 5x12288 --noise 0.3 0.02 --blocks 0 744 372 --inner 16 32

A block of 0 means the default (`ops.dominance.default_block`).
"""

from __future__ import annotations

import argparse
import subprocess
import time


def _sets(torch, S, n, noise, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    t = torch.rand((S, n, 1), generator=g, device="cuda")
    u = torch.rand((S, n, 3), generator=g, device="cuda")
    Y = t + noise * u
    return Y[0] if S == 1 else Y


def main() -> int:
    import torch

    from dmosopt_tpu_torch.ops import dominance as D

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", nargs="+", default=["1x45056", "5x12288"])
    ap.add_argument("--noise", type=float, nargs="+", default=[0.3, 0.02])
    ap.add_argument("--blocks", type=int, nargs="+", default=[0])
    ap.add_argument("--inner", type=int, nargs="+", default=[D.INNER])
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_rank: no CUDA device is available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)

    steps = [0]
    relax = D._relax_step

    def counted(*a):
        steps[0] += 1
        return relax(*a)

    D._relax_step = counted
    for size in args.sizes:
        S, n = (int(v) for v in size.split("x"))
        for noise in args.noise:
            Y = _sets(torch, S, n, noise)
            want = None
            for block in args.blocks:
                for inner in args.inner:
                    D.INNER = inner
                    B = block or None
                    r = D.non_dominated_rank(Y, block=B)  # warm-up
                    want = r if want is None else want
                    assert torch.equal(r, want), (size, noise, block, inner)
                    walls, peaks = [], []
                    for _ in range(args.repeats):
                        torch.cuda.synchronize()
                        base = torch.cuda.memory_allocated()
                        torch.cuda.reset_peak_memory_stats()
                        steps[0] = 0
                        t0 = time.perf_counter()
                        D.non_dominated_rank(Y, block=B)
                        torch.cuda.synchronize()
                        walls.append(time.perf_counter() - t0)
                        peaks.append(torch.cuda.max_memory_allocated() - base)
                    width = block or D.default_block(n, S)
                    print(
                        f"[{smi}] rank {S}x{n}x3 noise {noise}: {int(r.max()) + 1} "
                        f"fronts; block {width}, inner {inner}: {steps[0]} steps, "
                        f"{sorted(walls)[len(walls) // 2] * 1e3:.1f} ms, "
                        f"{max(peaks) / 1e9:.3f} GB extra at the peak",
                        flush=True,
                    )
    D._relax_step = relax
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
