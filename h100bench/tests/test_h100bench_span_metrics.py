"""The readers of the spans inside the inner EA's generation, around the
tenant plans and the service's submits, on synthetic spans and kernels:
the value on known ones, and None where the program opens no such span
or the run has no capture."""

import types

import pytest

from h100bench.harness import spec
from h100bench.tests.test_h100bench_metrics import _fake_capture, _span, _window_run

STEPS = [{"profiled": False}, {"profiled": True}, {"profiled": False}]
PROFILED = (3.5, 7.5)


def _read(name, run):
    return spec.metric_reader(name)(run)


def test_submit_s_counts_every_window_step():
    spans = [_span("submit", 0.1, 0.3), _span("submit", 3.0, 3.4),  # before the profiled step
             _span("submit", 8.0, 8.1),
             _span("submit", 10.2, 10.6)]  # the overrun step's refill
    run = _window_run(spans, STEPS, profiled=PROFILED)
    assert _read("submit_s.serve", run) == pytest.approx(0.7 / 3)
    assert _read("submit_s.serve", _window_run([_span("fold", 1, 2)], STEPS)) is None


def test_bucket_host_s_sums_plans_and_resamples_over_the_counted_steps():
    spans = [_span("plan", 0.0, 0.1), _span("plan", 0.1, 0.15), _span("resample", 2.0, 2.5),
             _span("plan", 4.0, 4.2), _span("resample", 7.0, 7.4),  # the profiled step
             _span("plan", 8.0, 8.05), _span("resample", 9.0, 9.3)]
    run = _window_run(spans, STEPS, profiled=PROFILED)
    assert _read("bucket_host_s.serve", run) == pytest.approx((0.15 + 0.5 + 0.05 + 0.3) / 2)
    # a program without `plan` spans: the resamples alone are not the metric
    only = _window_run([_span("resample", 2.0, 2.5)], STEPS)
    assert _read("bucket_host_s.serve", only) is None


def _gens(name, t0, t1, generations):
    """A part's span as the program records it: one an ``ea_scan``,
    labelled with the generations it covers."""
    sp = _span(name, t0, t1)
    sp.labels = {"generations": generations}
    return sp


@pytest.mark.parametrize("name", ["ea_survival_ms_per_gen.serve",
                                  "ea_survival_ms_per_gen.archive"])
def test_ea_survival_is_its_seconds_over_its_generations(name):
    spans = [_gens("ea_survival", 1.0, 1.006, 2), _gens("ea_survival", 2.0, 2.024, 6),
             _gens("ea_survival", 5.0, 5.5, 1),  # the profiled step
             _gens("ea_variation", 1.006, 1.01, 2)]
    run = _window_run(spans, STEPS, profiled=PROFILED)
    assert _read(name, run) == pytest.approx(1e3 * 0.030 / 8)
    # live spans (no label) count one generation each
    live = [_span("ea_survival", 1.0, 1.002), _span("ea_survival", 1.01, 1.014)]
    for sp in live:
        sp.labels = {}
    assert _read(name, _window_run(live, STEPS)) == pytest.approx(3.0)
    assert _read(name, _window_run([_span("ea_scan", 1, 2)], STEPS)) is None


def _kernel_capture():
    """A profiled step's trace: an ``ea_scan`` (4.5, 6.5) whose loop
    holds two generations from 5.0, and a second ``ea_scan`` (7, 8)
    that annotates no generation."""
    spans = [("step", 4.0, 9.0), ("ea_scan", 4.5, 6.5),
             ("ea_variation", 5.0, 5.1), ("ea_survival", 5.2, 5.5),
             ("ea_variation", 5.5, 5.6), ("ea_survival", 5.7, 6.0),
             ("ea_scan", 7.0, 8.0)]
    # two before the loop (the initial predict), six in it, one after
    # the first ea_scan's end, two in the second
    starts = [4.6, 4.9, 5.01, 5.3, 5.55, 5.9, 6.2, 6.49, 6.6, 7.2, 7.5]
    cap = _fake_capture([], [("k", t, 1e-6) for t in starts], 5.0)
    cap.spans = spans
    return cap


def test_ea_kernels_per_gen_reads_the_generations_annotations():
    run = _window_run([], STEPS, profiled=(4.0, 9.0))
    run.capture = _kernel_capture()
    assert _read("ea_kernels_per_gen.serve", run) == pytest.approx(6 / 2)


def test_ea_kernels_per_gen_is_none_without_capture_or_annotations():
    run = _window_run([], STEPS, profiled=(4.0, 9.0))
    run.capture = None
    assert _read("ea_kernels_per_gen.serve", run) is None
    # the parent's trace: an ea_scan with no generation inside
    bare = _fake_capture([], [("k", 5.0, 1e-6)], 3.0)
    run.capture = bare
    assert _read("ea_kernels_per_gen.serve", run) is None
    unprofiled = _window_run([], STEPS)
    unprofiled.capture = types.SimpleNamespace(kernels=[], spans=[])
    assert _read("ea_kernels_per_gen.serve", unprofiled) is None
