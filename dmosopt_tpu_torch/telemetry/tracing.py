"""Span-based host tracing with Chrome trace-event export.

Port of ``dmosopt_tpu/telemetry/tracing.py``. One change: the device
annotation each span enters is ``torch.profiler.record_function`` (not
``jax.profiler.TraceAnnotation``), and only while a device capture is
armed (`annotations_armed`), so an unprofiled span costs what the JAX
one costs without its annotation. Each span also keeps the native id of
its thread, which the device ledger joins annotation windows by.

The metrics registry answers "how many / how long in aggregate"; the
event log answers "what happened this epoch"; spans answer *where a
specific epoch's wall time went and for whom*: each `Span` is one timed
host-side region (epoch -> gp_fit -> ea_scan -> resample ->
eval_dispatch/eval_drain -> h5_write) with a trace id, a span id, a
parent link, and free-form labels (tenant, bucket, phase). The span
taxonomy is cataloged in ``docs/observability.md`` and enforced by
graftlint's ``metrics-catalog`` rule, exactly like metric names.

Two consumers:

- **Chrome trace-event JSON** (`Tracer.export`): a
  ``{"traceEvents": [...]}`` file loadable in chrome://tracing or
  https://ui.perfetto.dev. Spans become complete ("X") events; labels
  and parent links ride in ``args``.
- **Per-epoch persistence** (`Tracer.drain` +
  `storage.save_spans_to_h5`): the driver stores each epoch's closed
  spans beside the telemetry summaries so a stored run's timeline
  survives resume.

Device alignment: while `Telemetry.device_capture` runs a
``torch.profiler`` capture, every span opened through `Tracer.span`
also enters a ``torch.profiler.record_function`` of the same name, so
host spans line up with the card's kernels in the captured trace.

Spans the port opens and the JAX package does not (its compiled scan
and tenant core have no host loop to time), `PORT_SPANS`; the JAX
package's catalog lists the rest:

- ``ea_variation`` / ``ea_survival``: one generation's offspring and
  their clamp, and its survival (``update_strategy``, plus the tenant
  core's freeze), children of ``ea_scan``. They are `LoopPart`s: while
  a capture is armed each generation opens one live span of each
  (annotated on the trace); otherwise the loop adds up their seconds
  and `Tracer.record_parts` records one closed span of each at the
  loop's end, labelled ``generations``.
- ``plan``: the tenant core's pass 1 over a step's tenants, and each
  batched tenant's plan (labelled ``tenant``).
- ``submit``: one `OptimizationService.submit` call, on the caller's
  thread.

Discipline: spans open and close on the host where the port already
synchronizes or between launches; a span adds no device sync. Spans must
also never be held across a generator ``yield`` that hands control to
other span-opening code (the nesting stack is thread-local); intervals
measured around suspensions are recorded after the fact with
`Tracer.record_span`.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional

from dmosopt_tpu_torch.utils import json_default


@dataclass
class Span:
    """One closed (or still-open) host-side timed region."""

    name: str
    trace_id: str
    span_id: int
    parent_id: Optional[int]
    t_start: float  # perf_counter seconds, same clock as Tracer
    t_end: Optional[float] = None
    labels: Dict[str, Any] = field(default_factory=dict)
    thread: int = 0
    # the OS thread id (`threading.get_native_id`): the thread id a
    # torch.profiler trace gives the span's annotation window
    native_thread: int = 0

    @property
    def duration_s(self) -> Optional[float]:
        if self.t_end is None:
            return None
        return self.t_end - self.t_start

    def to_dict(self) -> Dict[str, Any]:
        out = {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "t_start": self.t_start,
            "t_end": self.t_end,
            "duration_s": self.duration_s,
        }
        if self.parent_id is not None:
            out["parent_id"] = self.parent_id
        if self.labels:
            out["labels"] = {str(k): v for k, v in self.labels.items()}
        return out


#: the port's own spans (the module docstring says where each opens);
#: every other span name is in the JAX package's catalog
PORT_SPANS = ("ea_variation", "ea_survival", "plan", "submit")

# armed device captures (`Telemetry.device_capture`); spans enter a
# profiler annotation only while this is above 0
_ARMED = 0
_ARMED_LOCK = threading.Lock()


@contextlib.contextmanager
def annotations_armed():
    """Arm the spans' ``torch.profiler.record_function`` annotations for
    the enclosed region (a device capture)."""
    global _ARMED
    with _ARMED_LOCK:
        _ARMED += 1
    try:
        yield
    finally:
        with _ARMED_LOCK:
            _ARMED -= 1


def _trace_annotation(name: str):
    """A ``torch.profiler.record_function`` for `name` while a capture is
    armed, else a null context (torch is imported only then)."""
    if not _ARMED:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(name)


class LoopPart:
    """One part of a loop's body, timed over the whole loop: enter it
    with ``with part:`` in every iteration. Unarmed, an entry reads the
    clock twice and adds the seconds up (`Tracer.record_parts` records
    the sum when the loop ends); while a capture is armed it opens a
    live span of the part's name instead, with its annotation, so the
    captured trace and the device ledger see every iteration. Reused
    across iterations: the loop allocates nothing a turn."""

    __slots__ = ("tracer", "name", "seconds", "count", "_t0", "_live")

    def __init__(self, tracer: "Tracer", name: str):
        self.tracer = tracer
        self.name = name
        self.seconds = 0.0  # unarmed iterations' time, summed
        self.count = 0  # unarmed iterations
        self._t0 = 0.0
        self._live = None

    def __enter__(self):
        if _ARMED:
            self._live = self.tracer.span(self.name)
            self._live.__enter__()
        else:
            self._t0 = time.perf_counter()

    def __exit__(self, *exc):
        live = self._live
        if live is not None:
            self._live = None
            return live.__exit__(*exc)
        self.seconds += time.perf_counter() - self._t0
        self.count += 1
        return False


class Tracer:
    """Collects host-side spans; exports Chrome trace-event JSON.

    Thread-safe: each thread nests through its own span stack (a
    background-writer ``h5_write`` span is parentless on its own
    track), the span list is lock-protected. The buffer is bounded by
    ``max_spans``: past it, the OLDEST spans are evicted
    (already-drained ones first — they sit at the front), so per-epoch
    persistence keeps flowing on a long-lived service and the Chrome
    export keeps the most recent window; every eviction is counted in
    ``spans_dropped`` (a trace with a silent hole is worse than a
    truncated one that says so).
    """

    def __init__(
        self,
        path: Optional[str] = None,
        max_spans: int = 16384,
        trace_id: Optional[str] = None,
    ):
        self.path = path
        self.trace_id = trace_id or uuid.uuid4().hex[:16]
        self.max_spans = int(max_spans)
        self.spans_dropped = 0
        self._spans: Deque[Span] = deque()
        self._drained = 0  # index of the first span `drain` has not seen
        self._ids = itertools.count(1)
        self._last_id = 0  # highest id handed out (for `mark`)
        self._lock = threading.Lock()
        self._tls = threading.local()
        # perf_counter origin paired with a wall-clock stamp so exported
        # timestamps can be related to event-log `ts` values
        self.t0 = time.perf_counter()
        self.wall0 = time.time()

    # ------------------------------------------------------------- spans

    def _stack(self) -> List[Span]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _native_id(self) -> int:
        """This thread's native id, read once a thread: the read is a
        system call (``gettid``), which cost about 90 µs a call on an
        H100 machine's host while the card ran."""
        nid = getattr(self._tls, "native", None)
        if nid is None:
            nid = self._tls.native = threading.get_native_id()
        return nid

    def _append(self, sp: Span) -> bool:
        with self._lock:
            if len(self._spans) >= self.max_spans:
                # evict the OLDEST span (already-drained ones sit at
                # the front by construction, so they go first): the
                # Chrome export keeps the most recent `max_spans`
                # window — a consumer investigating a slowdown needs
                # the run's tail, not its start — and per-epoch
                # persistence never goes dark. Evictions are counted
                # in `spans_dropped`; the deque makes each one O(1).
                self._spans.popleft()
                if self._drained > 0:
                    self._drained -= 1
                self.spans_dropped += 1
            self._spans.append(sp)
            self._last_id = max(self._last_id, sp.span_id)
            return True

    @contextlib.contextmanager
    def span(self, name: str, **labels):
        """Open one nested span around the enclosed region; yields the
        `Span` (labels may be added to ``span.labels`` before close).
        While a capture is armed it also enters a same-named
        ``torch.profiler.record_function``, so the captured trace lines
        up with the host span."""
        stack = self._stack()
        parent = stack[-1] if stack else None
        sp = Span(
            name=name,
            trace_id=self.trace_id,
            span_id=next(self._ids),
            parent_id=parent.span_id if parent is not None else None,
            t_start=time.perf_counter(),
            labels={k: v for k, v in labels.items() if v is not None},
            thread=threading.get_ident(),
            native_thread=self._native_id(),
        )
        stack.append(sp)
        self._append(sp)
        try:
            with _trace_annotation(name):
                yield sp
        finally:
            sp.t_end = time.perf_counter()
            # defensive out-of-order close: remove by identity wherever
            # it sits (a mis-nested caller must not corrupt the stack)
            try:
                stack.remove(sp)
            except ValueError:
                pass

    def record_span(
        self,
        name: str,
        t_start: float,
        t_end: float,
        parent: Optional[Span] = None,
        **labels,
    ) -> Optional[Span]:
        """Record an already-measured interval (perf_counter seconds, the
        tracer's clock) as a closed span — used for attribution slices
        (per-tenant cost shares of a bucket span) and for intervals
        measured across generator suspensions, where a live ``with``
        span would mis-nest."""
        sp = Span(
            name=name,
            trace_id=self.trace_id,
            span_id=next(self._ids),
            parent_id=parent.span_id if parent is not None else None,
            t_start=float(t_start),
            t_end=float(t_end),
            labels={k: v for k, v in labels.items() if v is not None},
            thread=threading.get_ident(),
            native_thread=self._native_id(),
        )
        return sp if self._append(sp) else None

    def record_parts(self, parts: List[LoopPart], count_label: str):
        """Record each `LoopPart`'s unarmed seconds as one closed span,
        a child of this thread's innermost open span, labelled with its
        iteration count under `count_label`. The spans tile the time
        just before now in the order given (a cost share, like
        ``tenant_cost``: a part's iterations were interleaved with the
        others'). A part with no unarmed iteration records nothing."""
        stack = self._stack()
        parent = stack[-1] if stack else None
        t = time.perf_counter() - sum(p.seconds for p in parts)
        for p in parts:
            if p.count:
                self.record_span(p.name, t, t + p.seconds, parent=parent,
                                 **{count_label: p.count})
            t += p.seconds

    # ----------------------------------------------------------- queries

    def spans(self, name: Optional[str] = None) -> List[Span]:
        with self._lock:
            out = list(self._spans)
        if name is not None:
            out = [s for s in out if s.name == name]
        return out

    def mark(self) -> int:
        """The highest span id handed out so far — bracket a region with
        `mark()` / `spans_since(mark)` to collect exactly the spans it
        opened (the device-ledger capture join uses this)."""
        with self._lock:
            return self._last_id

    def spans_since(self, mark: int) -> List[Span]:
        """Every buffered span opened after `mark`. Spans evicted by
        the buffer bound are gone — the device ledger tail-aligns the
        survivors to the most recent trace annotations, so eviction
        loses the evicted spans' device time without misattributing
        the survivors'."""
        with self._lock:
            return [s for s in self._spans if s.span_id > mark]

    def drain(self) -> List[Span]:
        """Closed spans not yet returned by a previous `drain` (the
        driver persists these per epoch). Spans stay in the export
        buffer — draining never shortens the Chrome export."""
        with self._lock:
            n_new = len(self._spans) - self._drained
            undrained = [self._spans.pop() for _ in range(n_new)]
            new, still_open = [], []
            for sp in reversed(undrained):
                (new if sp.t_end is not None else still_open).append(sp)
            # keep still-open spans (e.g. a writer span mid-flight) in
            # the undrained window so a later drain picks them up closed
            self._spans.extend(new + still_open)
            self._drained += len(new)
            return new

    # ------------------------------------------------------------ export

    def to_chrome_trace(self) -> Dict[str, Any]:
        """The Chrome trace-event representation of every span recorded
        so far (open spans are clamped to now)."""
        now = time.perf_counter()
        events: List[Dict[str, Any]] = [
            {
                "ph": "M", "name": "process_name", "pid": 1, "tid": 0,
                "args": {"name": "dmosopt_tpu_torch"},
            }
        ]
        with self._lock:
            spans = list(self._spans)
        tids: Dict[int, int] = {}
        for sp in spans:
            tid = tids.setdefault(sp.thread, len(tids) + 1)
        for thread, tid in tids.items():
            events.append(
                {
                    "ph": "M", "name": "thread_name", "pid": 1, "tid": tid,
                    "args": {"name": f"host-{tid}"},
                }
            )
        # a bounded buffer may have evicted a span whose children remain:
        # drop the dangling parent link (the child becomes a root in the
        # exported window) so the export stays schema-valid under
        # overflow — `spans_dropped` in otherData accounts for the loss
        exported_ids = {sp.span_id for sp in spans}
        for sp in spans:
            t_end = sp.t_end if sp.t_end is not None else now
            args: Dict[str, Any] = {
                "trace_id": sp.trace_id,
                "span_id": sp.span_id,
            }
            if sp.parent_id is not None and sp.parent_id in exported_ids:
                args["parent_id"] = sp.parent_id
            args.update({str(k): v for k, v in sp.labels.items()})
            events.append(
                {
                    "name": sp.name,
                    "cat": "host",
                    "ph": "X",
                    "ts": (sp.t_start - self.t0) * 1e6,  # microseconds
                    "dur": max(t_end - sp.t_start, 0.0) * 1e6,
                    "pid": 1,
                    "tid": tids[sp.thread],
                    "args": args,
                }
            )
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "trace_id": self.trace_id,
                "wall_start": self.wall0,
                "spans_dropped": self.spans_dropped,
            },
        }

    def export(self, path: Optional[str] = None) -> str:
        """Write the Chrome trace JSON to `path` (default: the tracer's
        configured path) and return the path written."""
        path = path or self.path
        if path is None:
            raise ValueError("no trace path configured")
        with open(path, "w") as fh:
            json.dump(self.to_chrome_trace(), fh, default=json_default)
        return path


def validate_chrome_trace(trace: Dict[str, Any]) -> List[str]:
    """Schema-check a Chrome trace-event object (the `make trace-smoke`
    gate of the JAX package): returns a list of problems, empty when valid. Checks the
    container shape, per-event required fields, phase-specific fields
    of complete ("X") events, and that every parent_id resolves to a
    span_id present in the trace."""
    problems: List[str] = []
    if not isinstance(trace, dict):
        return ["trace is not a JSON object"]
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    span_ids = set()
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"event {i}: not an object")
            continue
        for key in ("ph", "name", "pid", "tid"):
            if key not in ev:
                problems.append(f"event {i}: missing {key!r}")
        ph = ev.get("ph")
        if ph == "X":
            for key in ("ts", "dur"):
                v = ev.get(key)
                if not isinstance(v, (int, float)):
                    problems.append(f"event {i}: {key!r} not numeric")
                elif v < 0:
                    problems.append(f"event {i}: {key!r} negative")
            args = ev.get("args", {})
            if not isinstance(args, dict) or "span_id" not in args:
                problems.append(f"event {i}: X event without args.span_id")
            else:
                span_ids.add(args["span_id"])
        elif ph not in ("M",):
            problems.append(f"event {i}: unknown phase {ph!r}")
    for i, ev in enumerate(events):
        if isinstance(ev, dict) and ev.get("ph") == "X":
            parent = ev.get("args", {}).get("parent_id")
            if parent is not None and parent not in span_ids:
                problems.append(
                    f"event {i}: parent_id {parent} resolves to no span"
                )
    return problems


def load_chrome_trace(path: str) -> Dict[str, Any]:
    with open(path) as fh:
        return json.load(fh)
