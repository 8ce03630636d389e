"""The readers' arithmetic on synthetic spans, trace intervals and
launches."""

import types

import pytest
import torch

from h100bench.harness import bytecount, spec, stats, trace
from h100bench.harness.peaks import HBM_BYTES_PER_S


@pytest.mark.parametrize("iv,merged", [
    ([(0, 1), (0.5, 2), (3, 4)], [(0, 2), (3, 4)]),
    ([(3, 4), (0, 1), (1, 1.5)], [(0, 1.5), (3, 4)]),
    ([(0, 0), (2, 1)], []),
    ([(0, 5), (1, 2)], [(0, 5)]),
])
def test_merge_intervals(iv, merged):
    assert trace.merge_intervals(iv) == merged
    assert trace.total(merged) == pytest.approx(sum(e - s for s, e in merged))


def test_gaps_and_idle_by_span():
    busy = trace.merge_intervals([(1, 2), (4, 5)])
    assert trace.gaps(busy, 0, 6) == [(0, 1), (2, 4), (5, 6)]
    spans = [("epoch", 0, 6), ("gp_fit", 1.5, 4.5), ("fold", 5.2, 5.9)]
    assert trace.innermost(spans, 3.0) == "gp_fit"
    assert trace.innermost(spans, 7.0) is None
    idle = trace.idle_by_span(busy, 0, 6, spans)
    assert idle == pytest.approx({"epoch": 1.0, "gp_fit": 2.0, "fold": 1.0})
    assert sum(idle.values()) == pytest.approx(6 - trace.total(busy))


def _fake_capture(busy, kernels, wall):
    cap = trace.Capture.__new__(trace.Capture)
    cap.device = trace.merge_intervals(busy)
    cap.kernels = kernels
    cap.spans = [("ea_scan", 0.0, wall)]
    cap.lo, cap.hi, cap.wall_s = 0.0, wall, wall
    return cap


def test_breakdown_and_idle_share():
    cap = _fake_capture([(0, 1), (2, 2.5)], [("k_a", 0, 1.0), ("k_b", 2, 0.5)], 4.0)
    b = cap.breakdown()
    assert b["device_ops"] == [["k_a", 1.0], ["k_b", 0.5]]
    assert b["idle_gaps"] == [["ea_scan", 2.5]]
    run = types.SimpleNamespace(capture=cap)
    assert spec.metric_reader("device_idle_pct.serve")(run) == pytest.approx(62.5)
    assert spec.metric_reader("device_idle_pct.archive")(types.SimpleNamespace(capture=None)) is None


def _offspring_args(T, pop, n, npairs, seed=0):
    g = torch.Generator().manual_seed(seed)
    parm = torch.rand(T, pop, n, generator=g)
    pool_idx = torch.randint(0, pop, (T, pop), generator=g)
    r = torch.rand(T, 3, npairs, generator=g)
    u = torch.rand(T, 3, npairs, n, generator=g)
    pool_n = torch.full((T,), pop, dtype=torch.int32)
    shift_hi = torch.full((T,), pop, dtype=torch.int64)
    return [parm, pool_idx, r, u, pool_n, shift_hi]


def test_offspring_bytes_by_hand():
    # one pair, pool of 2: both slots, both rows; a crossover slot
    parm = torch.tensor([[0.1, 0.2], [0.3, 0.4]])
    pool_idx = torch.tensor([0, 1])
    r = torch.tensor([[0.0], [0.5], [0.0]])
    u = torch.zeros(3, 1, 2)
    is_x = torch.tensor([True])
    got = bytecount.offspring_bytes_one(parm, pool_idx, r, u, torch.tensor(2), torch.tensor(2), is_x)
    want = 4 * 3 + 4 * 2 * 1 + 8 * 2 + 4 * 2 * 2 + (4 * 4 * 2 + 12) + (4 * 2 * 1 * 2 + 1)
    assert got == want
    # a bucket counts each tenant's share
    args = _offspring_args(3, 10, 4, 5)
    tags = torch.rand(3, 5) < 0.5
    assert bytecount.offspring_bytes(args, tags) == sum(
        bytecount.offspring_bytes_one(*(a[t] for a in args), tags[t]) for t in range(3))


def test_offspring_roofline_reader():
    args = _offspring_args(2, 8, 3, 4)
    tags = torch.rand(2, 4) < 0.5
    nbytes = bytecount.offspring_bytes(args, tags)
    probe = types.SimpleNamespace(samples=[(0, args, tags), (10, args, tags)], launches=12)
    kernels = [("offspring_kernel", float(i), 1e-6) for i in range(12)] + [("gemm", 0.5, 1.0)]
    run = types.SimpleNamespace(capture=_fake_capture([], kernels, 1.0), offspring=probe)
    read = spec.metric_reader("offspring_roofline_pct.serve")
    assert read(run) == pytest.approx(100 * (2 * nbytes / HBM_BYTES_PER_S) / 2e-6)
    probe.launches = 11  # the trace and the launches disagree
    assert read(run) is None


def _span(name, t0, t1):
    return types.SimpleNamespace(name=name, t_start=t0, t_end=t1, duration_s=t1 - t0)


def _window_run(spans, steps, profiled=None, generations=10):
    from h100bench.harness.runner import Run

    run = Run.__new__(Run)
    run.telemetry = types.SimpleNamespace(tracer=types.SimpleNamespace(
        spans=lambda name=None: [s for s in spans if name is None or s.name == name]))
    run.t0, run.t1, run.steps, run.profiled = 0.0, 10.0, steps, profiled
    run.cell = types.SimpleNamespace(config={"num_generations": generations})
    return run


def test_span_readers_keep_to_the_window_and_leave_the_profiled_step_out():
    steps = [{"profiled": False}, {"profiled": True}, {"profiled": False}]
    spans = [_span("gp_fit", 0.5, 1.5), _span("gp_fit", 4.0, 7.0), _span("gp_fit", 8.0, 9.0),
             _span("gp_fit", 9.5, 10.5),  # past the window's end
             _span("ea_scan", 1.5, 2.0), _span("ea_scan", 8.0, 8.5),
             _span("admit", 0.0, 0.1), _span("eval_drain", 0.1, 0.3), _span("fold", 2.0, 2.2)]
    run = _window_run(spans, steps, profiled=(3.5, 7.5))
    assert spec.metric_reader("bucket_fit_s.serve")(run) == pytest.approx(2.0 / 2)
    assert spec.metric_reader("ea_ms_per_gen.serve")(run) == pytest.approx(1e3 * 1.0 / 20)
    assert spec.metric_reader("step_host_s.serve")(run) == pytest.approx(0.5 / 2)


def test_epoch_stats_readers():
    run = types.SimpleNamespace(epoch_stats=[
        {"train_s": 2.0, "fit_n_steps": 100, "optimize_s": 0.5, "n_generations": 100},
        {"train_s": 1.0, "fit_n_steps": 50, "optimize_s": 0.3, "n_generations": 100}])
    assert spec.metric_reader("gp_fit_ms_per_step.archive")(run) == pytest.approx(20.0)
    assert spec.metric_reader("ea_ms_per_gen.archive")(run) == pytest.approx(4.0)
    assert spec.metric_reader("gp_fit_ms_per_step.archive")(
        types.SimpleNamespace(epoch_stats=[])) is None


def test_p90():
    assert stats.p90(list(range(1, 11))) == pytest.approx(9.1)
    assert stats.p90([]) is None
    run = types.SimpleNamespace(latencies=[float(v) for v in range(101)])
    assert spec.metric_reader("calibration_p90_s.serve")(run) == pytest.approx(90.0)
