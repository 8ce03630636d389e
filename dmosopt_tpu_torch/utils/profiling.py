"""Phase timing and device profiling hooks.

Port of ``dmosopt_tpu/utils/profiling.py``, a copy (pure Python).

Capability match: the reference keeps lightweight wall-clock bookkeeping
— per-evaluation timing shipped with worker results
(dmosopt.py:2361-2363), `*_start`/`*_end` phase keys diffed in
`get_stats` (dmosopt.py:846-854), and eval-time aggregates
(dmosopt.py:278-300). Those all survive unchanged in the driver; this
module adds a phase-timer context manager that feeds the same stats
dict. (Device trace capture moved to `Telemetry.device_capture`, which
also joins each capture into the device-time ledger.)
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict


@contextlib.contextmanager
def phase_timer(stats: Dict, name: str):
    """Record `{name}_start` / `{name}_end` into a stats dict, matching the
    reference's phase-key convention so `DistOptimizer.get_stats` diffs
    them into durations."""
    stats[f"{name}_start"] = time.time()
    try:
        yield stats
    finally:
        stats[f"{name}_end"] = time.time()


def eval_time_stats(times) -> Dict[str, float]:
    """Aggregate per-evaluation wall-clock times the way the strategy does
    (reference dmosopt.py:278-300): min/max/mean/std/median/sum over
    positive entries, -1 sentinels when none."""
    import numpy as np

    ts = np.asarray(times, dtype=float)
    ts = ts[ts > 0.0]
    if len(ts) == 0:
        return {
            k: -1.0
            for k in (
                "eval_min", "eval_max", "eval_mean",
                "eval_std", "eval_sum", "eval_median",
            )
        }
    return {
        "eval_min": float(np.min(ts)),
        "eval_max": float(np.max(ts)),
        "eval_mean": float(np.mean(ts)),
        "eval_std": float(np.std(ts)),
        "eval_sum": float(np.sum(ts)),
        "eval_median": float(np.median(ts)),
    }
