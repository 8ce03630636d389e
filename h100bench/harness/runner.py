"""One run of one cell: drive it, judge it, and build the result line."""

from __future__ import annotations

import gc
import sys
import time
from typing import Any, Dict, List, Optional

from h100bench.harness import guard, spec
from h100bench.harness.probes import Audit
from h100bench.reference import check


class Run:
    """A run's settings, and what its driver records of the window."""

    def __init__(self, cell: spec.Cell, seed: int, seconds: float, trace: bool, device,
                 t_process0: float, log=None):
        self.cell, self.seed, self.seconds, self.trace = cell, int(seed), float(seconds), bool(trace)
        self.device, self.t_process0 = device, t_process0
        self.log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
        self.audit = Audit()
        self.live = int(cell.traffic.get("live", 1))
        self.n_epochs = int(cell.traffic.get("n_epochs", cell.config["n_epochs"]))
        self.telemetry = None
        self.e2e: Dict[str, float] = {}
        self.setup_s: Optional[float] = None
        self.t0 = self.t1 = None
        self.steps: List[dict] = []
        self.profiled = None  # (t_start, t_end) of the profiled step
        self.capture = None
        self.offspring = None
        self.latencies: List[float] = []
        self.epoch_stats: List[dict] = []
        self.answers: List[Dict[str, Any]] = []
        self.attempted = self.failed = self.missing = 0
        self.memory_peak_bytes: Optional[int] = None

    def _sync(self):
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)

    def mark_setup_done(self):
        self._sync()
        self.setup_s = time.perf_counter() - self.t_process0

    def close_window(self, t0: float, t1: float):
        self.t0, self.t1 = t0, t1

    def read_memory(self):
        if self.device.type == "cuda":
            import torch

            self.memory_peak_bytes = int(torch.cuda.max_memory_allocated(self.device))

    def add_answer(self, key, x, y):
        self.answers.append({"key": key, "front_x": x, "front_y": y,
                             "calls": self.audit.calls[key],
                             "epochs": self.audit.epochs[key]})

    def window_spans(self, name: str):
        """Closed spans named ``name`` inside the window, the profiled
        step's left out (the profiler slows what it watches)."""
        out = []
        for sp in self.telemetry.tracer.spans(name):
            if sp.t_end is None or sp.t_start < self.t0 or sp.t_end > self.t1:
                continue
            if self.profiled and sp.t_start >= self.profiled[0] and sp.t_end <= self.profiled[1]:
                continue
            out.append(sp)
        return out

    @property
    def counted_steps(self):
        return [s for s in self.steps if not s["profiled"]]


def execute(cell: spec.Cell, seed: int, seconds: float, trace: bool, device,
            t_process0: float, control: bool = False, log=None):
    """Drive ``cell`` once and judge it. Returns (result, compared rows,
    forbidden modules found)."""
    run = Run(cell, seed, seconds, trace, device, t_process0, log)
    spec.driver(cell.traffic).drive(run)
    # the program's state is freed before the reference runs
    gc.collect()
    if device.type == "cuda":
        import torch

        torch.cuda.empty_cache()
    numbers = check.judge(run.answers, cell.config, run.missing, device, control=control)
    ok, rows = check.verdict(numbers, cell.limits)
    correct = ok and run.failed == 0 and run.attempted > 0

    metrics: Dict[str, Dict[str, Any]] = {}
    if not trace:
        values = dict(run.e2e, setup_s=run.setup_s)
        for m in cell.end_to_end:
            v = values.get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            v = spec.metric_reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev: Dict[str, Any] = {"platform": "gpu" if device.type == "cuda" else device.type,
                           "count": cell.chips,
                           "memory_peak_bytes": run.memory_peak_bytes}
    if device.type == "cuda":
        import torch

        dev["kind"] = torch.cuda.get_device_name(device)
    result: Dict[str, Any] = {"correct": bool(correct), "attempted": int(run.attempted),
                              "failed": int(run.failed), "metrics": metrics, "device": dev}
    if trace and run.capture is not None:
        run.log(f"trace: {len(run.capture.kernels)} kernels, events by kind "
                f"{dict(run.capture.activities)}")
        dev["busy_s"] = run.capture.busy_s
        dev["window_s"] = run.capture.wall_s
        result["breakdown"] = run.capture.breakdown()
    result["compared"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return result, rows, guard.forbidden_loaded()
