"""The device trace of a traced run, reduced in memory.

``Capture`` runs ``torch.profiler`` over whole steps and keeps only
intervals: the union of the card's kernel, copy and set intervals, each
kernel's name and duration, and the host spans' annotation windows. The
interval arithmetic is a frozen copy of the port's
``telemetry/device_ledger.py`` (``_merge_intervals``)."""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

Interval = Tuple[float, float]


def merge_intervals(intervals: Sequence[Interval]) -> List[Interval]:
    """Sorted union of (start, end) intervals."""
    out: List[Interval] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def total(intervals: Sequence[Interval]) -> float:
    return sum(e - s for s, e in intervals)


def gaps(merged: Sequence[Interval], lo: float, hi: float) -> List[Interval]:
    """The parts of [lo, hi] that a merged union leaves uncovered."""
    out, cur = [], lo
    for s, e in merged:
        if e <= lo or s >= hi:
            continue
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
    if cur < hi:
        out.append((cur, hi))
    return out


def innermost(spans: Sequence[Tuple[str, float, float]], t: float) -> Optional[str]:
    """Name of the latest-starting host span open at ``t``."""
    best = None
    for name, s, e in spans:
        if s <= t <= e and (best is None or s > best[1]):
            best = (name, s)
    return None if best is None else best[0]


def idle_by_span(merged, lo, hi, spans) -> Dict[str, float]:
    """Idle seconds of the card in [lo, hi], by the host span open at the
    middle of each gap (``"no span"`` where none is)."""
    out: Dict[str, float] = defaultdict(float)
    for s, e in gaps(merged, lo, hi):
        out[innermost(spans, 0.5 * (s + e)) or "no span"] += e - s
    return dict(out)


class Capture:
    """``with Capture(): ...`` profiles the enclosed steps. After exit:
    ``device`` (merged busy intervals, seconds), ``kernels`` ([(name,
    start, dur)]), ``spans`` ([(name, start, end)] host annotations),
    ``lo``/``hi`` (the capture's extent on the trace's clock) and
    ``wall_s`` (its length on the host clock)."""

    def __init__(self, device):
        self._dev = device

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize(self._dev)
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.synchronize(self._dev)
        self.wall_s = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self._reduce(self._prof.profiler.kineto_results.events())
        self._prof = None
        return False

    def _reduce(self, events):
        evs = []
        for ev in events:
            s = ev.start_ns() * 1e-9
            # the card's events: kernels, copies and sets, and the
            # annotations' shadows on its timeline, which are no work
            evs.append((ev.name(), s, s + ev.duration_ns() * 1e-9,
                        "cuda" in str(ev.device_type()).lower(), ev.is_user_annotation()))
        span_names = {n for n, _, _, card, ann in evs if ann and not card}
        busy, kernels, spans = [], [], []
        self.activities: Dict[str, int] = defaultdict(int)
        for name, s, e, card, ann in evs:
            ann = ann or (card and name in span_names)
            kind = ("annotation" if ann else
                    "copy" if name.startswith(("Memcpy", "Memset")) else "kernel")
            self.activities[f"{'card' if card else 'host'}:{kind}"] += 1
            if card and not ann:
                busy.append((s, e))
                if kind == "kernel":
                    kernels.append((name, s, e - s))
            elif not card and ann:
                spans.append((name, s, e))
        self.device = merge_intervals(busy)
        self.kernels = kernels
        self.spans = spans
        self.lo = min((s for _, s, _, _, _ in evs), default=0.0)
        self.hi = max((e for _, _, e, _, _ in evs), default=0.0)

    @property
    def busy_s(self) -> float:
        return total(self.device)

    def kernel_seconds(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for name, _, d in self.kernels:
            out[name] += d
        return dict(out)

    def breakdown(self) -> Dict[str, list]:
        ops = sorted(self.kernel_seconds().items(), key=lambda kv: -kv[1])[:10]
        idle = idle_by_span(self.device, self.lo, self.hi, self.spans)
        return {
            "device_ops": [[name[:120], sec] for name, sec in ops],
            "idle_gaps": [[name, sec] for name, sec in
                          sorted(idle.items(), key=lambda kv: -kv[1])[:10]],
        }
