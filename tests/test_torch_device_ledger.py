"""The port's device-time ledger held against the JAX package's.

- One synthetic GPU capture: kernel, copy and set events on two streams
  of a device, the host spans' ``record_function`` windows (two of one
  name overlapping on two threads, joined per thread), a bucket span
  tiled by ``tenant_cost`` children, and a writer span with no window.
  The same intervals in the torch profiler's format (categories
  ``kernel``/``gpu_memcpy``/``gpu_memset``, ``user_annotation``) go
  through the port's ledger and, in the JAX profiler's format (a
  ``/device:GPU:0`` process), through the JAX ledger: the summaries
  (busy fraction, overlap ratio, program rows, tenant seconds) agree to
  1e-9.
- A real ``torch.profiler`` capture on the CPU through
  `Telemetry.device_capture`: the spans opened inside it join their
  annotation windows, the capture has no device lanes and its busy
  fraction is None; a capture asked to record CUDA that finds no kernel
  event raises instead of reporting an idle device.
- `record_device_memory` sets the JAX package's three gauges from
  ``torch.cuda`` on a CUDA device and does nothing on the CPU.
"""

import math

import pytest
import torch

torch.set_num_threads(1)

from dmosopt_tpu.telemetry import device_ledger as jax_ledger
from dmosopt_tpu.telemetry import tracing as jax_tracing

from dmosopt_tpu_torch import telemetry as port_tel
from dmosopt_tpu_torch.telemetry import device_ledger as port_ledger
from dmosopt_tpu_torch.telemetry import tracing as port_tracing

MAIN, WRITER, POOL = 101, 202, 303  # the native thread ids of the spans
BUCKET = "d4_o2_p16"
# host spans: (id, name, parent id, host start, host end, thread, labels)
SPANS = [
    (1, "epoch", None, 0.0, 10.0, MAIN, {"epoch": 3}),
    (2, "gp_fit", 1, 0.1, 4.0, MAIN, {"bucket": BUCKET, "n_tenants": 3}),
    (3, "ea_scan", 1, 4.1, 9.0, MAIN, {"bucket": BUCKET, "n_tenants": 3}),
    (4, "resample", 1, 9.1, 9.8, MAIN, {"bucket": BUCKET}),
    (5, "eval_drain", 1, 9.82, 9.97, MAIN, {}),
    (6, "eval_drain", None, 9.83, 9.91, POOL, {}),
    (7, "h5_write", None, 5.0, 5.5, WRITER, {}),
]
# tenant_cost children tiling gp_fit and ea_scan: (id, parent, start, end, tenant)
TILES = [
    (8, 2, 0.1, 1.4, "0"), (9, 2, 1.4, 3.0, "1"), (10, 2, 3.0, 4.0, "2"),
    (11, 3, 4.1, 6.0, "0"), (12, 3, 6.0, 7.5, "1"), (13, 3, 7.5, 9.0, "2"),
]
# annotation windows in the trace, µs: name -> [(ts, dur, thread)]
WINDOWS = {
    "epoch": [(0, 10000, MAIN)],
    "gp_fit": [(100, 3900, MAIN)],
    "ea_scan": [(4100, 4900, MAIN)],
    "resample": [(9100, 700, MAIN)],
    "eval_drain": [(9820, 150, MAIN), (9830, 80, POOL)],
}
# device events, µs: (category, name, stream, ts, dur)
DEVICE = [
    ("kernel", "trsm", 7, 200, 1000),
    ("kernel", "reduce", 13, 1000, 800),
    ("kernel", "trsm", 7, 1500, 1000),
    ("kernel", "offspring_kernel", 7, 4200, 1800),
    ("kernel", "sort", 13, 6500, 2300),
    ("gpu_memcpy", "Memcpy DtoH", 7, 9200, 100),
    ("kernel", "offspring_kernel", 7, 9840, 20),
    ("gpu_memset", "Memset", 13, 9990, 5),
]


def _spans(mod):
    out = []
    for sid, name, parent, t0, t1, thread, labels in SPANS:
        out.append((sid, name, parent, t0, t1, thread, labels))
    for sid, parent, t0, t1, tenant in TILES:
        phase = "fit" if parent == 2 else "ea"
        out.append((sid, "tenant_cost", parent, t0, t1, MAIN,
                    {"tenant": tenant, "phase": phase, "bucket": BUCKET}))
    spans = []
    for sid, name, parent, t0, t1, thread, labels in out:
        kw = dict(name=name, trace_id="t", span_id=sid, parent_id=parent,
                  t_start=t0, t_end=t1, labels=labels, thread=thread)
        if mod is port_tracing:
            kw["native_thread"] = thread
        spans.append(mod.Span(**kw))
    return spans


def _torch_trace():
    ev = [{"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 1, "tid": MAIN,
           "ts": 50, "dur": 10}]
    for name, wins in WINDOWS.items():
        for ts, dur, tid in wins:
            ev.append({"ph": "X", "cat": "user_annotation", "name": name, "pid": 1,
                       "tid": tid, "ts": ts, "dur": dur})
    for cat, name, stream, ts, dur in DEVICE:
        ev.append({"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": stream,
                   "ts": ts, "dur": dur})
    # a flow event and a zero-length annotation of another name
    ev.append({"ph": "f", "cat": "ac2g", "name": "ac2g", "pid": 0, "tid": 7, "ts": 210})
    ev.append({"ph": "X", "cat": "user_annotation", "name": "other", "pid": 1,
               "tid": MAIN, "ts": 10005, "dur": 0})
    return {"traceEvents": ev}


def _jax_trace():
    ev = [
        {"ph": "M", "name": "process_name", "pid": 1, "args": {"name": "/host:CPU"}},
        {"ph": "M", "name": "process_name", "pid": 9, "args": {"name": "/device:GPU:0"}},
        {"ph": "X", "name": "aten::mm", "pid": 1, "tid": 1, "ts": 50, "dur": 10},
    ]
    for name, wins in WINDOWS.items():
        for ts, dur, _tid in wins:
            ev.append({"ph": "X", "name": name, "pid": 1, "tid": 1, "ts": ts, "dur": dur})
    for _cat, name, stream, ts, dur in DEVICE:
        ev.append({"ph": "X", "name": name, "pid": 9, "tid": stream, "ts": ts, "dur": dur})
    ev.append({"ph": "X", "name": "other", "pid": 1, "tid": 1, "ts": 10005, "dur": 0})
    return {"traceEvents": ev}


def _assert_close(a, b, path="summary"):
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _assert_close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_close(x, y, f"{path}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert math.isclose(a, b, rel_tol=0.0, abs_tol=1e-9), (path, a, b)
    else:
        assert a == b, (path, a, b)


def test_synthetic_capture_summaries_match_jax():
    """The same intervals through both ledgers: equal summaries (the
    port joins the two overlapping eval_drain spans per thread, the JAX
    ledger by name and duration)."""
    jax = jax_ledger.DeviceLedger()
    jcap = jax.ingest_chrome_trace(_jax_trace(), _spans(jax_tracing))
    port = port_ledger.DeviceLedger()
    pcap = port.ingest_trace(_torch_trace(), _spans(port_tracing))
    _assert_close(port.summary(), jax.summary())
    _assert_close(pcap.tenant_device_seconds, jcap.tenant_device_seconds)
    s = port.summary()
    # the union: [200, 2500] (three events on two streams), [4200, 6000],
    # [6500, 8800], the copy, the last kernel and the set
    busy = (2300 + 1800 + 2300 + 100 + 20 + 5) / 1e6
    assert s["last_capture"]["device_busy_s"] == pytest.approx(busy, abs=1e-12)
    assert s["device_busy_fraction"] == pytest.approx(busy / 0.010005, abs=1e-12)
    assert s["device_overlap_ratio"] == pytest.approx(busy / (9995e-6 - 200e-6), abs=1e-12)
    rows = {(r["program"], r.get("bucket")): r for r in s["programs"]}
    assert rows[("gp_fit", BUCKET)]["device_time_s"] == pytest.approx(2.3e-3)
    assert rows[("ea_scan", BUCKET)]["device_time_s"] == pytest.approx(4.1e-3)
    assert rows[("h5_write", None)]["n_joined"] == 0
    # the tenants' device seconds tile the bucket rows' exactly
    tenant = sum(v for t in s["tenant_device_seconds"].values() for v in t.values())
    # (the summary rounds each entry to 1e-9)
    assert tenant == pytest.approx(2.3e-3 + 4.1e-3, abs=1e-8)
    assert pcap.n_device_lanes == 2
    assert pcap.device_events["offspring_kernel"] == [2, pytest.approx(1.82e-3)]


def test_overlapping_spans_join_per_thread():
    """Two same-name spans overlapping on two threads: with the threads
    in the trace each joins the window of its own thread, even where the
    windows' durations would pair them the other way."""
    spans = _spans(port_tracing)
    for sp in spans:
        if sp.native_thread == POOL:
            sp.labels = {"bucket": "pool"}  # a row of its own
    trace = _torch_trace()
    for ev in trace["traceEvents"]:
        if ev.get("name") == "eval_drain":
            ev["dur"] = 80 if ev["tid"] == MAIN else 150  # swapped durations
    # a kernel inside POOL's window [9830, 9980] only
    trace["traceEvents"].append({"ph": "X", "cat": "kernel", "name": "k", "pid": 0,
                                 "tid": 13, "ts": 9910, "dur": 40})
    led = port_ledger.DeviceLedger()
    led.ingest_trace(trace, spans)
    rows = {(r.program, r.bucket): r for r in led.program_rows()}
    # MAIN's window [9820, 9900] holds the 20 µs offspring event, POOL's
    # that one and the 40 µs kernel
    assert rows[("eval_drain", None)].device_time_s == pytest.approx(20e-6, abs=1e-12)
    assert rows[("eval_drain", "pool")].device_time_s == pytest.approx(60e-6, abs=1e-12)


def test_cpu_capture_joins_spans_and_reports_no_device(tmp_path):
    """A real torch.profiler capture on the CPU: spans inside it join
    their windows; no device lanes, so no busy fraction."""
    tel = port_tel.Telemetry(profile_dir=str(tmp_path), profile_epochs=[0])
    assert tel.should_trace(0) and not tel.should_trace(1)
    a = torch.randn(64, 64)
    with tel.span("gp_fit"):  # before the capture: no annotation entered
        a @ a
    with tel.device_capture(epoch=0, device="cpu") as ledger:
        assert ledger is tel.ledger
        with tel.span("epoch", epoch=0):
            with tel.span("gp_fit"):
                (a @ a).sum()
            with tel.span("ea_scan"):
                torch.sort(a, dim=0)
    cap = tel.ledger.last_capture
    assert tel.ledger.captures == 1
    assert cap.device_busy_fraction is None and cap.device_overlap_ratio is None
    assert cap.n_device_lanes == 0 and cap.window_s > 0
    rows = {r.program: r for r in tel.ledger.program_rows()}
    assert {p: (r.n_spans, r.n_joined) for p, r in rows.items()} == {
        "epoch": (1, 1), "gp_fit": (1, 1), "ea_scan": (1, 1)}
    assert all(r.device_time_s == 0.0 for r in rows.values())
    (ev,) = tel.log.records(kind="device_capture")
    assert ev.epoch == 0 and ev.fields["device_busy_fraction"] is None
    assert "no_device_lanes" in ev.fields and ev.fields["n_kernel_events"] == 0
    assert list(tmp_path.glob("epoch0_*.pt.trace.json"))
    snap = tel.registry.snapshot()
    assert "device_busy_fraction" not in snap["gauges"]
    # no profile_dir: the capture is a no-op yielding None
    with port_tel.Telemetry().device_capture(0) as none:
        assert none is None


def test_cuda_capture_without_kernel_events_raises(tmp_path, monkeypatch):
    """No fallback that hides the device: a capture of a CUDA run whose
    trace holds no kernel event raises (here a CPU build asked for CUDA
    activity records none)."""
    monkeypatch.setattr(port_tel, "_is_cuda", lambda device: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    tel = port_tel.Telemetry(profile_dir=str(tmp_path))
    with pytest.raises(port_tel.DeviceCaptureError):
        with tel.device_capture(epoch=2, device="cuda"):
            with tel.span("epoch"):
                torch.ones(8).sum()


def test_record_device_memory(monkeypatch):
    tel = port_tel.Telemetry()
    port_tel.record_device_memory(tel, torch.device("cpu"))
    port_tel.record_device_memory(None, "cuda")
    assert tel.registry.snapshot()["gauges"] == {}
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda dev: {
        "allocated_bytes.all.current": 1024, "allocated_bytes.all.peak": 4096})
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda dev: (10, 80 * 2**30))
    port_tel.record_device_memory(tel, "cuda:0")
    assert tel.registry.snapshot()["gauges"] == {
        "device_memory_bytes_in_use": {"device=0": 1024.0},
        "device_memory_peak_bytes": {"device=0": 4096.0},
        "device_memory_bytes_limit": {"device=0": float(80 * 2**30)},
    }
