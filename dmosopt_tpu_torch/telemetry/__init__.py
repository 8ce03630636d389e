"""End-to-end telemetry: metrics registry + event log + spans + the
card's own clock.

Port of ``dmosopt_tpu/telemetry/__init__.py``. One `Telemetry` object
travels the whole stack (the driver's epoch loop, the per-problem
strategies, the MO-ASMO phases, the tenant core, the evaluators and the
background writer), so a run's observability has one switchboard:

- `Telemetry.registry` (`MetricsRegistry`): counters, gauges, histograms.
- `Telemetry.log` (`EventLog`): typed per-epoch and per-phase records in
  a bounded ring buffer, with an optional JSONL sink.
- `Telemetry.tracer` (`Tracer`): host spans (epoch, gp_fit, ea_scan,
  resample, eval_dispatch, eval_drain, h5_write, tenant_cost; the port
  alone also opens ea_variation and ea_survival for the parts of each
  generation, plan around the tenant core's plans, and submit: see
  `tracing`).
- ``torch.profiler`` captures of the epochs that ``profile_epochs``
  names, into ``profile_dir`` (`Telemetry.device_capture`), each joined
  into `Telemetry.ledger`, the device-time ledger.

Configuration arrives through the driver's ``telemetry`` parameter, with
the JAX package's semantics (`create_telemetry`): None or True builds
the on-by-default instance, False holds none (zero telemetry calls), a
dict is `Telemetry` keyword arguments, an instance passes through. The
metric and span names are the JAX package's, all in its catalog
``docs/observability.md``.

Differences from the JAX package: `device_capture` runs
``torch.profiler.profile`` and raises, on a CUDA run, when the profiler
cannot start or records no CUDA kernel event (the JAX capture swallows
a refusing profiler); on the CPU the capture has no device lanes and
its busy fraction is None. `record_device_memory` reads the run's CUDA
device through ``torch.cuda`` and does nothing on the CPU. No
``compile_cache_*`` gauges: the port compiles no programs.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Dict, Optional, Sequence, Union

from dmosopt_tpu_torch.telemetry.device_ledger import DeviceLedger, load_trace
from dmosopt_tpu_torch.telemetry.events import Event, EventLog, jsonable, read_jsonl  # noqa: F401
from dmosopt_tpu_torch.telemetry.health import (  # noqa: F401
    HealthEngine,
    HealthRule,
    default_rulebook,
)
from dmosopt_tpu_torch.telemetry.registry import MetricsRegistry  # noqa: F401
from dmosopt_tpu_torch.telemetry.tracing import (  # noqa: F401
    LoopPart,
    Span,
    Tracer,
    annotations_armed,
    validate_chrome_trace,
)


class DeviceCaptureError(RuntimeError):
    """A requested capture of a CUDA run that could not start, or that
    recorded no CUDA kernel event."""


def _all_threads_config():
    """The profiler option that records every thread's
    ``record_function`` annotations, not only the capturing thread's:
    the service's scheduler opens its buckets' ``gp_fit`` / ``ea_scan``
    spans on worker threads. None where torch lacks the option."""
    try:
        from torch._C._profiler import _ExperimentalConfig

        return _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        return None


def _is_cuda(device) -> bool:
    if device is None:
        import torch

        return torch.cuda.is_available()
    return str(device).startswith("cuda")


class Telemetry:
    """Facade over the registry, the event log and the tracer, with
    phase-timer helpers.

    A disabled instance (``enabled=False``) is a no-op: every mutator
    returns at once, and ``bool(tel)`` is False so call sites can skip
    whole blocks. A ``telemetry=False`` run goes further: the driver
    holds None, so the hot path makes no telemetry call at all.
    """

    def __init__(
        self,
        enabled: bool = True,
        ring_size: int = 1024,
        jsonl_path: Optional[str] = None,
        jsonl_max_bytes: Optional[int] = None,
        jsonl_keep: int = 3,
        profile_dir: Optional[str] = None,
        profile_epochs: Optional[Sequence[int]] = None,
        histogram_buckets: Optional[Dict[str, Sequence[float]]] = None,
        label_series_limit: Optional[int] = 512,
        trace_path: Optional[str] = None,
        trace_max_spans: int = 16384,
    ):
        self.enabled = bool(enabled)
        self.registry = MetricsRegistry(
            histogram_buckets=histogram_buckets,
            series_limit=label_series_limit,
        )
        self.log = EventLog(
            ring_size=ring_size,
            jsonl_path=jsonl_path if self.enabled else None,
            max_bytes=jsonl_max_bytes,
            keep=jsonl_keep,
        )
        if self.enabled:
            self.log.on_rotate = lambda: self.registry.counter_inc(
                "telemetry_sink_rotations_total"
            )
        # the device-time ledger, fed by the captures of profiled epochs;
        # a disabled instance has none
        self.ledger: Optional[DeviceLedger] = DeviceLedger() if self.enabled else None
        # spans are always collected on an enabled instance (they feed the
        # per-epoch store); `trace_path` also exports them on close
        self.tracer: Optional[Tracer] = (
            Tracer(path=trace_path, max_spans=trace_max_spans) if self.enabled else None
        )
        self.profile_dir = profile_dir
        self.profile_epochs = (
            frozenset(int(e) for e in profile_epochs)
            if profile_epochs is not None
            else None
        )
        self.epoch: Optional[int] = None  # default epoch stamp for events
        # every event of the current and newer epochs, for `epoch_summary`
        # (the ring buffer may evict an event-heavy epoch's early events
        # before the driver persists the summary); `set_epoch` prunes
        # older epochs
        self._events_by_epoch: Dict[int, list] = {}

    def __bool__(self) -> bool:
        return self.enabled

    # -------------------------------------------------------------- state

    def set_epoch(self, epoch: Optional[int]):
        self.epoch = int(epoch) if epoch is not None else None
        if self.epoch is not None:
            for e in [e for e in self._events_by_epoch if e < self.epoch]:
                del self._events_by_epoch[e]

    def should_trace(self, epoch: int) -> bool:
        """Capture this epoch? Needs a ``profile_dir``;
        ``profile_epochs=None`` captures every epoch, else only the
        listed ones."""
        if not self.enabled or self.profile_dir is None:
            return False
        return self.profile_epochs is None or int(epoch) in self.profile_epochs

    @contextlib.contextmanager
    def device_capture(self, epoch: Optional[int] = None, device=None):
        """Run a ``torch.profiler`` capture around the enclosed region
        and fold it into the device-time ledger on exit.

        On a CUDA ``device`` (None: CUDA when present) the capture
        records CPU and CUDA activity, synchronizes the device at both
        edges, and raises `DeviceCaptureError` when the profiler cannot
        start or the trace holds no CUDA kernel event. Python stacks,
        shapes and memory are not recorded. The trace is written to
        ``profile_dir`` (``epoch<E>_<time>.pt.trace.json``), joined to the
        spans opened inside the region on any thread (each entered a
        same-named ``record_function`` while the capture was armed; the
        profiler records every thread's annotations), and its
        ``device_busy_fraction`` and ``device_overlap_ratio`` gauges and
        per-tenant ``tenant_device_seconds`` are set. A ``device_capture``
        event carries the capture's summary, its device lane count and
        its trace path; a CPU capture's says its busy fraction is None
        for want of device lanes. Yields the ledger, or None (no-op)
        without a ``profile_dir``."""
        if not self.enabled or self.profile_dir is None:
            yield None
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        cuda = _is_cuda(device)
        activities = [ProfilerActivity.CPU]
        if cuda:
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(self.profile_dir, exist_ok=True)
        mark = self.tracer.mark() if self.tracer is not None else 0
        prof = profile(
            activities=activities, record_shapes=False, profile_memory=False,
            with_stack=False, experimental_config=_all_threads_config(),
        )
        if cuda:
            torch.cuda.synchronize(device)
        try:
            prof.__enter__()
        except Exception as e:
            raise DeviceCaptureError(f"torch.profiler did not start: {e!r}") from e
        self.event("trace", epoch=epoch, profile_dir=self.profile_dir)
        try:
            with annotations_armed():
                yield self.ledger
        finally:
            # an exception of the region propagates past the ingest below
            if cuda:
                torch.cuda.synchronize(device)
            prof.__exit__(None, None, None)
        path = os.path.join(
            self.profile_dir,
            f"epoch{'' if epoch is None else int(epoch)}_{time.time_ns()}.pt.trace.json",
        )
        prof.export_chrome_trace(path)
        trace = load_trace(path)
        spans = self.tracer.spans_since(mark) if self.tracer is not None else []
        cap = self.ledger.ingest_trace(trace, spans)
        n_kernels = sum(
            1 for ev in trace.get("traceEvents", [])
            if isinstance(ev, dict) and ev.get("cat") == "kernel"
        )
        if cuda and n_kernels == 0:
            raise DeviceCaptureError(
                f"the capture of epoch {epoch} on {device or 'cuda'} recorded "
                f"no CUDA kernel event ({path})"
            )
        if cap.device_busy_fraction is not None:
            self.gauge("device_busy_fraction", cap.device_busy_fraction)
        if cap.device_overlap_ratio is not None:
            self.gauge("device_overlap_ratio", cap.device_overlap_ratio)
        for (tenant, phase), sec in sorted(cap.tenant_device_seconds.items()):
            self.inc("tenant_device_seconds", sec, tenant=tenant, phase=phase)
        fields = dict(
            cap.to_dict(), n_device_lanes=cap.n_device_lanes,
            n_kernel_events=n_kernels, trace_path=path,
        )
        if cap.device_busy_fraction is None:
            fields["no_device_lanes"] = "no device events in the trace (a CPU run)"
        self.event("device_capture", epoch=epoch, **fields)

    # ------------------------------------------------------------ metrics

    def inc(self, name: str, value: float = 1.0, **labels):
        if self.enabled:
            self.registry.counter_inc(name, value, **labels)

    def gauge(self, name: str, value: float, **labels):
        if self.enabled:
            self.registry.gauge_set(name, value, **labels)

    def observe(self, name: str, value: float, **labels):
        if self.enabled:
            self.registry.histogram_observe(name, value, **labels)

    # ------------------------------------------------------------- events

    def event(self, kind: str, epoch: Optional[int] = None, **fields) -> Optional[Event]:
        if not self.enabled:
            return None
        ev = self.log.emit(
            kind, epoch=epoch if epoch is not None else self.epoch, **fields
        )
        if ev.epoch is not None:
            self._events_by_epoch.setdefault(ev.epoch, []).append(ev)
        return ev

    # -------------------------------------------------------------- spans

    def span(self, name: str, **labels):
        """Open one nested host span (`tracing.Tracer.span`); a disabled
        instance returns a null context yielding None."""
        if self.enabled and self.tracer is not None:
            return self.tracer.span(name, **labels)
        return contextlib.nullcontext(None)

    @contextlib.contextmanager
    def phase(self, phase: str, epoch: Optional[int] = None, **fields):
        """Time a region: on exit, observes `phase_duration_seconds`
        {phase=...} and emits one ``phase`` event. Yields a dict the
        caller may extend with result fields before the event is written."""
        if not self.enabled:
            yield {}
            return
        extra: Dict[str, Any] = dict(fields)
        t0 = time.perf_counter()
        try:
            yield extra
        finally:
            dt = time.perf_counter() - t0
            self.observe("phase_duration_seconds", dt, phase=phase)
            self.event("phase", epoch=epoch, phase=phase, duration_s=dt, **extra)

    # ------------------------------------------------------------ summary

    def epoch_summary(self, epoch: int) -> Dict[str, Any]:
        """One epoch's events folded into a flat JSON-able dict (the JAX
        package's `epoch_summary`): per-phase durations, EA throughput,
        surrogate-fit results, merged eval-time aggregates, resample
        accounting. This is what the driver stores in the HDF5
        ``telemetry`` group."""
        summary: Dict[str, Any] = {"epoch": int(epoch), "phases": {}}
        eval_agg = {"eval_n": 0, "eval_sum": 0.0, "eval_min": None, "eval_max": None}
        # a multi-problem epoch emits one train/optimize/resample event a
        # problem: counts add up, ratios average, termination reasons
        # union, gens_per_sec comes from the totals
        mean_acc: Dict[str, list] = {}
        terminations: list = []
        events = self._events_by_epoch.get(int(epoch))
        if events is None:
            events = self.log.records(epoch=int(epoch))
        for ev in events:
            f = ev.fields
            if ev.kind == "phase":
                name = f.get("phase", "unknown")
                summary["phases"][name] = (
                    summary["phases"].get(name, 0.0) + float(f.get("duration_s", 0.0))
                )
                if name == "train":
                    for k in ("n_train", "duplicates_removed", "fit_n_steps"):
                        if k in f:
                            summary[k] = summary.get(k, 0) + f[k]
                    for k in ("feasible_fraction", "surrogate_loss"):
                        if f.get(k) is not None:
                            mean_acc.setdefault(k, []).append(float(f[k]))
                    if "surrogate" in f:
                        summary["surrogate"] = f["surrogate"]
                    if "fit_early_stopped" in f:
                        summary["fit_early_stopped"] = bool(
                            summary.get("fit_early_stopped", False)
                            or f["fit_early_stopped"]
                        )
                elif name == "optimize":
                    for k in ("n_generations", "n_evals"):
                        if k in f:
                            summary[k] = summary.get(k, 0) + f[k]
                    t = f.get("termination")
                    if t is not None and t not in terminations:
                        terminations.append(t)
                elif name == "xinit" and "n_points" in f:
                    summary["n_initial_points"] = f["n_points"]
                elif name == "eval":
                    n = int(f.get("n_evals", 0))
                    eval_agg["eval_n"] += n
                    if f.get("eval_sum", -1.0) and f.get("eval_sum", -1.0) > 0:
                        eval_agg["eval_sum"] += float(f["eval_sum"])
                    for k, red in (("eval_min", min), ("eval_max", max)):
                        v = f.get(k)
                        if v is not None and v > 0:
                            eval_agg[k] = v if eval_agg[k] is None else red(eval_agg[k], v)
            elif ev.kind == "epoch":
                summary["wall_s"] = f.get("duration_s")
                for k in ("eval_count", "save_count"):
                    if k in f:
                        summary[k] = f[k]
            elif ev.kind == "resample":
                for k in ("resample_batch", "resample_duplicates_removed"):
                    if k in f:
                        summary[k] = summary.get(k, 0) + f[k]
        for k, vals in mean_acc.items():
            summary[k] = sum(vals) / len(vals)
        if terminations:
            summary["termination"] = "+".join(terminations)
        opt_s = summary["phases"].get("optimize")
        if opt_s and summary.get("n_generations"):
            summary["gens_per_sec"] = round(summary["n_generations"] / opt_s, 3)
        if eval_agg["eval_n"]:
            eval_agg["eval_mean"] = (
                eval_agg["eval_sum"] / eval_agg["eval_n"] if eval_agg["eval_sum"] else None
            )
            summary["eval"] = eval_agg
        return jsonable(summary)

    def close(self):
        if self.tracer is not None and self.tracer.path is not None:
            try:
                self.tracer.export()
            except OSError:
                pass  # an unwritable trace path must not mask run teardown
        self.log.close()


def phase_scope(tel: Optional["Telemetry"], phase: str, epoch=None, **fields):
    """`tel.phase(...)` when telemetry is live, else a no-op context
    yielding a throwaway dict."""
    if tel:
        return tel.phase(phase, epoch=epoch, **fields)
    return contextlib.nullcontext({})


def span_scope(tel: Optional["Telemetry"], name: str, **labels):
    """`tel.span(...)` when telemetry is live, else a no-op context
    yielding None."""
    if tel:
        return tel.span(name, **labels)
    return contextlib.nullcontext(None)


# the context `loop_parts` hands out without live telemetry: one shared
# instance (a null context holds no state), so a part entered once a
# generation allocates nothing on a telemetry-free run
_NO_SPAN = contextlib.nullcontext(None)


def loop_parts(tel: Optional["Telemetry"], *names: str) -> list:
    """One `tracing.LoopPart` per name when telemetry is live (hand them
    to `record_parts` when the loop ends), else the shared null context
    per name: a telemetry-free loop makes no tracer call."""
    if tel and tel.tracer is not None:
        return [LoopPart(tel.tracer, name) for name in names]
    return [_NO_SPAN] * len(names)


def record_parts(tel: Optional["Telemetry"], parts: list, count_label: str):
    """`Tracer.record_parts` for `loop_parts`'s parts when telemetry is
    live, else nothing."""
    if tel and tel.tracer is not None:
        tel.tracer.record_parts(parts, count_label)


def record_device_memory(tel: Optional["Telemetry"], device=None):
    """Gauge the run's CUDA device memory (``torch.cuda.memory_stats``
    for the bytes in use and their peak, ``torch.cuda.mem_get_info`` for
    the device's total) under the JAX package's three gauge names,
    labelled with the device index. A CPU device (or none) is a no-op,
    as the JAX function is on CPU devices."""
    if not tel or device is None or not _is_cuda(device):
        return
    import torch

    dev = torch.device(device)
    stats = torch.cuda.memory_stats(dev)
    _free, total = torch.cuda.mem_get_info(dev)
    label = str(dev.index if dev.index is not None else torch.cuda.current_device())
    tel.gauge("device_memory_bytes_in_use",
              float(stats.get("allocated_bytes.all.current", 0)), device=label)
    tel.gauge("device_memory_peak_bytes",
              float(stats.get("allocated_bytes.all.peak", 0)), device=label)
    tel.gauge("device_memory_bytes_limit", float(total), device=label)


def create_telemetry(
    spec: Union[None, bool, Dict, Telemetry] = None,
) -> Optional[Telemetry]:
    """Resolve the driver's ``telemetry`` value, as the JAX package does:
    None/True -> a default enabled `Telemetry`; False (or a dict with
    ``enabled: False``, or a disabled instance) -> None; a dict ->
    ``Telemetry(**dict)``; an enabled instance passes through."""
    if spec is None or spec is True:
        return Telemetry()
    if spec is False:
        return None
    if isinstance(spec, Telemetry):
        return spec if spec.enabled else None
    if isinstance(spec, dict):
        if not spec.get("enabled", True):
            return None
        return Telemetry(**spec)
    raise TypeError(
        f"telemetry must be None, bool, dict, or Telemetry; got {type(spec)!r}"
    )
