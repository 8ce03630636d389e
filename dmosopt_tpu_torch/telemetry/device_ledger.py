"""Device-time ledger: the card's own clock, joined to the host spans.

Port of ``dmosopt_tpu/telemetry/device_ledger.py``, rebuilt on the trace
that ``torch.profiler`` exports (`Telemetry.device_capture` runs the
capture and hands the trace here).

- **Device lanes** are the trace's GPU events: complete ("X") events of
  the categories ``kernel``, ``gpu_memcpy`` and ``gpu_memset``, one lane
  per (device, stream). Their union is the device's busy time.
- **Annotation windows** are the ``user_annotation`` events that
  ``torch.profiler.record_function`` leaves on the host threads: every
  `Tracer.span` opened while the capture is armed enters one of its own
  name. Each host span is joined to its window by name and order, per
  thread where the trace's thread ids are the spans' native thread ids
  (else by name alone, as the JAX parser joins), with the JAX
  package's `_assign_windows` (tail alignment for serial spans,
  duration matching for overlapping ones).
- The device busy time clipped to a span's window is charged to that
  span's program row (span name and ``bucket`` label);
  ``tenant_cost`` child spans split their parent's device seconds by
  their host shares into ``tenant_device_seconds``.
- ``device_busy_fraction`` is the busy union over the capture window
  (the extent of every event in the trace) and
  ``device_overlap_ratio`` the busy union over the device timeline's
  extent. A trace with no device lanes (a CPU run) has neither: both
  are None.

`ProgramRow`, `CaptureSummary`, `device_busy_fraction`,
`device_overlap_ratio` and `tenant_device_seconds` keep the JAX
package's names and meaning, and `summary()` its schema, so a trace in
either profiler's format with the same intervals gives the same
summary. The JAX ledger's compile-side rows (``record_compile``, fed by
XLA's AOT compiles) have no counterpart: eager torch compiles no
programs, so a row's ``compiles`` and ``compile_s`` stay 0 and its
numbers come from traces alone.

Nothing here runs on a hot path: ingestion happens only after an
explicitly profiled epoch, and a ``telemetry=False`` run holds no
ledger at all.
"""

from __future__ import annotations

import json
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

#: trace-event categories of work on the card in a torch.profiler trace
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
#: category of the host-side `record_function` windows
ANNOTATION_CATEGORY = "user_annotation"


# ----------------------------------------------------- interval utilities


def _merge_intervals(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Sorted union of (start, end) intervals."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _total(intervals: Sequence[Tuple[float, float]]) -> float:
    return sum(e - s for s, e in intervals)


def _clipped_total(
    intervals: Sequence[Tuple[float, float]], lo: float, hi: float
) -> float:
    """Total length of `intervals` (a merged union) clipped to [lo, hi]."""
    out = 0.0
    for s, e in intervals:
        if e <= lo:
            continue
        if s >= hi:
            break
        out += min(e, hi) - max(s, lo)
    return out


def _spans_overlap(spans) -> bool:
    """True when any two spans (sorted by t_start) overlap in host time."""
    prev_end = None
    for s in spans:
        if prev_end is not None and s.t_start < prev_end:
            return True
        end = s.t_end if s.t_end is not None else s.t_start
        prev_end = end if prev_end is None else max(prev_end, end)
    return False


def _assign_windows(
    name_spans, windows: List[Tuple[float, float]]
) -> List[Optional[int]]:
    """Map each same-name host span (sorted by start) to the index of its
    annotation window, or None when unjoined (the JAX ledger's rule).

    Serial spans join by rank with tail alignment: the k-th surviving
    span matches the k-th most recent window. Overlapping spans (the
    same name on several threads at once) are matched, longest first,
    to the unused window whose duration is closest to their own."""
    n_s, n_w = len(name_spans), len(windows)
    if not _spans_overlap(name_spans):
        offset = max(n_w - n_s, 0)
        return [(i + offset) if (i + offset) < n_w else None for i in range(n_s)]
    assigned: List[Optional[int]] = [None] * n_s
    used = set()
    order = sorted(range(n_s), key=lambda i: -(name_spans[i].duration_s or 0.0))
    for i in order:
        dur = name_spans[i].duration_s or 0.0
        best, best_diff = None, None
        for j in range(n_w):
            if j in used:
                continue
            diff = abs((windows[j][1] - windows[j][0]) - dur)
            if best_diff is None or diff < best_diff:
                best, best_diff = j, diff
        if best is not None:
            used.add(best)
            assigned[i] = best
    return assigned


# ------------------------------------------------------------ trace parse


@dataclass
class ParsedTrace:
    """One capture's relevant content, in seconds on the trace's clock:
    annotation windows by (name, thread id), the merged busy intervals
    of every device lane, and the extent of all events."""

    annotations: Dict[Tuple[str, Any], List[Tuple[float, float]]]
    device_lanes: Dict[Tuple[Any, Any], List[Tuple[float, float]]]
    window: Tuple[float, float]
    #: device events by name: [count, seconds] (kernels, copies, sets)
    device_events: Dict[str, List[float]] = field(default_factory=dict)

    @property
    def device_busy(self) -> List[Tuple[float, float]]:
        """Union of busy intervals across every device lane."""
        merged: List[Tuple[float, float]] = []
        for lane in self.device_lanes.values():
            merged.extend(lane)
        return _merge_intervals(merged)

    def windows(self, name: str, thread=None) -> List[Tuple[float, float]]:
        """The windows of `name` on `thread`, or on every thread (sorted)
        when `thread` is None."""
        if thread is not None:
            return self.annotations.get((name, thread), [])
        out = []
        for (n, _), ws in self.annotations.items():
            if n == name:
                out.extend(ws)
        return sorted(out)


def _complete_events(trace: Dict[str, Any]):
    """(event, t0, t1) in seconds for every complete event with numbers."""
    for ev in trace.get("traceEvents", []) or []:
        if not isinstance(ev, dict) or ev.get("ph") != "X":
            continue
        ts, dur = ev.get("ts"), ev.get("dur", 0)
        if isinstance(ts, (int, float)) and isinstance(dur, (int, float)):
            yield ev, ts / 1e6, (ts + dur) / 1e6


def _finish(annotations, lanes, device_events, lo, hi) -> ParsedTrace:
    for key in lanes:
        lanes[key] = _merge_intervals(lanes[key])
    for key in annotations:
        annotations[key].sort()
    if lo > hi:
        lo = hi = 0.0
    return ParsedTrace(annotations, lanes, (lo, hi), device_events)


def parse_torch_trace(trace: Dict[str, Any], span_names) -> ParsedTrace:
    """Split a ``torch.profiler`` Chrome trace into annotation windows
    (``user_annotation`` events named like one of `span_names`, keyed by
    their thread id) and device-lane busy intervals (``kernel``,
    ``gpu_memcpy`` and ``gpu_memset`` events, one lane per (pid, tid):
    the device and its stream)."""
    names = set(span_names)
    annotations: Dict[Tuple[str, Any], List[Tuple[float, float]]] = {}
    lanes: Dict[Tuple[Any, Any], List[Tuple[float, float]]] = {}
    device_events: Dict[str, List[float]] = {}
    lo, hi = float("inf"), float("-inf")
    for ev, t0, t1 in _complete_events(trace):
        lo, hi = min(lo, t0), max(hi, t1)
        cat, name = ev.get("cat"), str(ev.get("name", ""))
        if cat in DEVICE_CATEGORIES:
            if t1 > t0:
                lanes.setdefault((ev.get("pid"), ev.get("tid")), []).append((t0, t1))
            acc = device_events.setdefault(name, [0, 0.0])
            acc[0] += 1
            acc[1] += t1 - t0
        elif cat == ANNOTATION_CATEGORY and name in names:
            annotations.setdefault((name, ev.get("tid")), []).append((t0, t1))
    return _finish(annotations, lanes, device_events, lo, hi)


def load_trace(path: str) -> Dict[str, Any]:
    with open(path) as fh:
        return json.load(fh)


# ----------------------------------------------------------------- ledger


@dataclass
class ProgramRow:
    """Cumulative device accounting for one program identity (host-span
    name + bucket label). ``compiles`` and ``compile_s`` keep the JAX
    row's schema and stay 0: the port compiles no programs."""

    program: str
    bucket: Optional[str] = None
    compiles: int = 0
    retraces: int = 0
    compile_s: float = 0.0
    flops: Optional[float] = None
    bytes_accessed: Optional[float] = None
    memory_bytes: Optional[float] = None
    device_time_s: float = 0.0
    host_time_s: float = 0.0
    n_spans: int = 0  # host spans seen during captures
    n_joined: int = 0  # host spans matched to a trace annotation

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "program": self.program,
            "compiles": self.compiles,
            "compile_s": round(self.compile_s, 6),
            "device_time_s": round(self.device_time_s, 6),
            "host_time_s": round(self.host_time_s, 6),
            "n_spans": self.n_spans,
            "n_joined": self.n_joined,
        }
        if self.bucket:
            out["bucket"] = self.bucket
        if self.retraces:
            out["retraces"] = self.retraces
        for k in ("flops", "bytes_accessed", "memory_bytes"):
            v = getattr(self, k)
            if v is not None:
                out[k] = v
        if self.n_spans:
            out["join_fraction"] = round(self.n_joined / self.n_spans, 4)
        return out


@dataclass
class CaptureSummary:
    """One ingested capture in the ledger's vocabulary (seconds;
    fractions in [0, 1] where defined, None without device lanes)."""

    window_s: float
    device_busy_s: float
    device_busy_fraction: Optional[float]
    device_overlap_ratio: Optional[float]
    n_spans: int
    n_joined: int
    tenant_device_seconds: Dict[Tuple[str, str], float] = field(default_factory=dict)
    #: device lanes (device, stream) that ran work in the capture
    n_device_lanes: int = 0
    #: device events by name: [count, seconds]
    device_events: Dict[str, List[float]] = field(default_factory=dict)

    @property
    def join_fraction(self) -> Optional[float]:
        return (self.n_joined / self.n_spans) if self.n_spans else None

    def to_dict(self) -> Dict[str, Any]:
        """The JAX capture's fields (the lane count and the device
        events stay out, so both packages' summaries compare equal)."""
        return {
            "window_s": round(self.window_s, 6),
            "device_busy_s": round(self.device_busy_s, 6),
            "device_busy_fraction": (
                round(self.device_busy_fraction, 4)
                if self.device_busy_fraction is not None
                else None
            ),
            "device_overlap_ratio": (
                round(self.device_overlap_ratio, 4)
                if self.device_overlap_ratio is not None
                else None
            ),
            "n_spans": self.n_spans,
            "n_joined": self.n_joined,
            "join_fraction": (
                round(self.join_fraction, 4)
                if self.join_fraction is not None
                else None
            ),
        }


class DeviceLedger:
    """Per-program device accounting folded in from traces by
    `ingest_trace`. Thread-safe."""

    def __init__(self):
        self._rows: Dict[Tuple[str, Optional[str]], ProgramRow] = {}
        self._tenant_device: Dict[Tuple[str, str], float] = {}
        self.captures = 0
        self.last_capture: Optional[CaptureSummary] = None
        self._lock = threading.Lock()

    def _row_locked(self, program: str, bucket: Optional[str]) -> ProgramRow:
        key = (program, bucket)
        row = self._rows.get(key)
        if row is None:
            row = self._rows[key] = ProgramRow(program=program, bucket=bucket)
        return row

    # ------------------------------------------------------------- traces

    def ingest_trace(self, trace: Dict[str, Any], host_spans) -> CaptureSummary:
        """Join one ``torch.profiler`` capture against the host spans
        recorded during it (the CLOSED `tracing.Span`s opened while it
        ran: the caller brackets the capture with `Tracer.mark` /
        `spans_since`) and fold device times into the program rows.

        Spans of one name on one thread join their windows on that
        thread when the trace carries the spans' native thread ids;
        otherwise spans of one name join that name's windows on every
        thread. Device time charged to a span is the device busy union
        clipped to its window; its ``tenant_cost`` children split it by
        their host shares."""
        spans = [s for s in host_spans if s.t_end is not None]
        by_name: Dict[str, List] = {}
        children: Dict[int, List] = {}
        for s in spans:
            if s.name == "tenant_cost":
                if s.parent_id is not None:
                    children.setdefault(s.parent_id, []).append(s)
            else:
                by_name.setdefault(s.name, []).append(s)
        for lst in by_name.values():
            lst.sort(key=lambda s: (s.t_start, s.span_id))

        parsed = parse_torch_trace(trace, by_name.keys())
        busy = parsed.device_busy
        window_s = max(parsed.window[1] - parsed.window[0], 0.0)
        busy_s = _total(busy)
        extent_s = (busy[-1][1] - busy[0][0]) if busy else 0.0
        has_lanes = bool(parsed.device_lanes)

        cap = CaptureSummary(
            window_s=window_s,
            device_busy_s=busy_s,
            device_busy_fraction=(
                busy_s / window_s if has_lanes and window_s > 0 else None
            ),
            device_overlap_ratio=(busy_s / extent_s) if extent_s > 0 else None,
            n_spans=0,
            n_joined=0,
            n_device_lanes=len(parsed.device_lanes),
            device_events=parsed.device_events,
        )
        with self._lock:
            for name, name_spans in by_name.items():
                threads = {(name, s.native_thread) for s in name_spans}
                if threads <= set(parsed.annotations):
                    groups = {}
                    for s in name_spans:
                        groups.setdefault(s.native_thread, []).append(s)
                    joins = [
                        (grp, parsed.windows(name, tid)) for tid, grp in groups.items()
                    ]
                else:
                    joins = [(name_spans, parsed.windows(name))]
                for grp, windows in joins:
                    assign = _assign_windows(grp, windows)
                    for i, sp in enumerate(grp):
                        self._charge_locked(
                            cap, sp, None if assign[i] is None else windows[assign[i]],
                            busy, children.get(sp.span_id),
                        )
            self.captures += 1
            self.last_capture = cap
        return cap

    def _charge_locked(self, cap, sp, window, busy, kids):
        row = self._row_locked(sp.name, (sp.labels or {}).get("bucket"))
        row.n_spans += 1
        cap.n_spans += 1
        row.host_time_s += sp.duration_s or 0.0
        if window is None:
            return
        dev_s = _clipped_total(busy, window[0], window[1])
        row.n_joined += 1
        cap.n_joined += 1
        row.device_time_s += dev_s
        host_dur = sp.duration_s or 0.0
        if kids and host_dur > 0 and dev_s > 0:
            for kid in kids:
                share = (kid.duration_s or 0.0) / host_dur
                key = (
                    str((kid.labels or {}).get("tenant", "?")),
                    str((kid.labels or {}).get("phase", "?")),
                )
                amount = dev_s * share
                cap.tenant_device_seconds[key] = (
                    cap.tenant_device_seconds.get(key, 0.0) + amount
                )
                self._tenant_device[key] = self._tenant_device.get(key, 0.0) + amount

    # ------------------------------------------------------------ queries

    @property
    def has_data(self) -> bool:
        with self._lock:
            return bool(self._rows) or self.captures > 0

    @property
    def device_busy_fraction(self) -> Optional[float]:
        cap = self.last_capture
        return cap.device_busy_fraction if cap is not None else None

    @property
    def device_overlap_ratio(self) -> Optional[float]:
        cap = self.last_capture
        return cap.device_overlap_ratio if cap is not None else None

    def program_rows(self) -> List[ProgramRow]:
        with self._lock:
            return sorted(self._rows.values(), key=lambda r: (r.program, r.bucket or ""))

    def tenant_device_seconds(self) -> Dict[str, Dict[str, float]]:
        """{tenant: {phase: attributed device seconds}}, cumulative over
        captures."""
        out: Dict[str, Dict[str, float]] = {}
        with self._lock:
            for (tenant, phase), v in self._tenant_device.items():
                out.setdefault(tenant, {})[phase] = round(v, 9)
        return out

    def summary(self) -> Dict[str, Any]:
        """JSON-able snapshot in the JAX ledger's schema: cumulative
        program rows, the last capture's fractions, per-tenant device
        seconds."""
        out: Dict[str, Any] = {
            "captures": self.captures,
            "programs": [r.to_dict() for r in self.program_rows()],
        }
        if self.last_capture is not None:
            out["last_capture"] = self.last_capture.to_dict()
            out["device_busy_fraction"] = self.last_capture.device_busy_fraction
            out["device_overlap_ratio"] = self.last_capture.device_overlap_ratio
        tenant = self.tenant_device_seconds()
        if tenant:
            out["tenant_device_seconds"] = tenant
        return out
