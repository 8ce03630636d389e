"""The port's spans for the parts of the inner EA's generation, around
the tenant plans and the service's submits, and the tracer's bounded
buffer.

- A 2-tenant service bucket (`tenants.run_bucket_epoch`) and a `run()`
  surrogate epoch (`moasmo._optimize_on_device`) record one
  ``ea_variation`` and one ``ea_survival`` span an ``ea_scan``, its
  children, labelled with the generations they cover and tiling the
  time in that order; while a capture is armed the loop opens one live
  span of each a generation instead, and a ``torch.profiler`` trace
  holds their annotations.
- `LoopPart` adds up its unarmed iterations and `Tracer.record_parts`
  records nothing for a part without one.
- ``plan`` opens once over the tenant core's pass 1 and once for each
  batched tenant's plan (labelled ``tenant``), under the step's
  ``epoch``; a sequential tenant's epoch opens its spans outside it.
  ``submit`` opens once a submit, on the caller's thread, as a root.
- ``telemetry=False`` gives bit-identical resample batches and makes no
  tracer call.
- The tracer reads a thread's native id once; the buffer's eviction
  keeps the list-based order, ``spans_dropped`` and ``drain`` of a plain
  model.
"""

import time
from collections import Counter

import numpy as np
import pytest
import torch

# one intra-op thread: the test workers share the machine
torch.set_num_threads(1)

import dmosopt_tpu_torch
import dmosopt_tpu_torch.driver as port_driver
from dmosopt_tpu_torch import tenants
from dmosopt_tpu_torch import telemetry as port_tel
from dmosopt_tpu_torch.benchmarks.zdt import zdt1
from dmosopt_tpu_torch.service import OptimizationService
from dmosopt_tpu_torch.telemetry import tracing

SMK = {"n_starts": 2, "n_iter": 10, "seed": 0}
N_GEN = 4
N_EPOCHS = 2
EA_SPANS = ("ea_variation", "ea_survival")


def _serve(telemetry=True, min_bucket=2):
    """Two d4 tenants through the lockstep service to their last epoch.
    Returns (the service's telemetry or None, {tenant id: [each bucket
    epoch's resample batch]})."""
    batches = {}
    inner = tenants.run_bucket_epoch

    def recorded(plans, **kw):
        res = inner(plans, **kw)
        for pid, r in res.items():
            batches.setdefault(pid, []).append(np.array(r["x_resample"]))
        return res

    tenants.run_bucket_epoch = recorded
    try:
        svc = OptimizationService(device="cpu", min_bucket=min_bucket, telemetry=telemetry)
        handles = [
            svc.submit(zdt1, {f"x{i}": [0.0, 1.0] for i in range(4)}, ["f1", "f2"],
                       opt_id=f"t{k}", n_epochs=N_EPOCHS, population_size=16,
                       num_generations=N_GEN, n_initial=3,
                       surrogate_method_kwargs=dict(SMK), random_seed=20 + k)
            for k in range(2)
        ]
        svc.run()
        assert all(h.done and h.error is None for h in handles)
        tel = svc.telemetry
        svc.close()
    finally:
        tenants.run_bucket_epoch = inner
    return tel, batches


@pytest.fixture(scope="module")
def served():
    return _serve()


def _children(spans, parent):
    return [s for s in spans if s.parent_id == parent.span_id]


def _assert_generations(spans, n_gen):
    """Every ``ea_scan`` holds one span of each generation part, in
    order and tiling, inside its bounds, labelled with ``n_gen``."""
    scans = [s for s in spans if s.name == "ea_scan"]
    assert scans
    for scan in scans:
        kids = [s for s in _children(spans, scan) if s.name in EA_SPANS]
        assert [s.name for s in kids] == list(EA_SPANS)
        assert kids[0].t_end == kids[1].t_start
        assert scan.t_start <= kids[0].t_start and kids[-1].t_end <= scan.t_end
        assert all(s.labels == {"generations": n_gen} for s in kids)
        assert all(s.duration_s > 0 for s in kids)
    n = Counter(s.name for s in spans)
    assert [n[name] for name in EA_SPANS] == [len(scans)] * len(EA_SPANS)


def _assert_live_generations(spans, n_gen):
    """Every ``ea_scan`` holds ``n_gen`` rounds of live part spans, in
    order, unlabelled."""
    scans = [s for s in spans if s.name == "ea_scan"]
    assert scans
    for scan in scans:
        kids = [s for s in _children(spans, scan) if s.name in EA_SPANS]
        assert [s.name for s in kids] == list(EA_SPANS) * n_gen
        for a, b in zip(kids, kids[1:]):
            assert a.t_end <= b.t_start
        assert scan.t_start <= kids[0].t_start and kids[-1].t_end <= scan.t_end
        assert all(s.labels == {} for s in kids)


def test_bucket_generation_spans_are_children_of_ea_scan(served):
    tel, batches = served
    spans = tel.tracer.spans()
    scans = [s for s in spans if s.name == "ea_scan"]
    # one bucket epoch a tenant epoch: both tenants share each bucket
    assert len(scans) == N_EPOCHS
    assert all(s.labels == {"bucket": "d4_o2_p16", "n_tenants": 2} for s in scans)
    _assert_generations(spans, N_GEN)


def test_plan_spans_cover_pass_one_and_each_batched_plan(served):
    tel, _ = served
    spans = tel.tracer.spans()
    by_id = {s.span_id: s for s in spans}
    for fit in (s for s in spans if s.name == "gp_fit"):
        step = by_id[fit.parent_id]
        assert step.name == "epoch"
        plans = [s for s in _children(spans, step) if s.name == "plan"]
        # pass 1, then one a batched tenant, all before the bucket's fit
        assert [s.labels for s in plans] == [{}, {"tenant": "0"}, {"tenant": "1"}]
        assert all(s.t_end <= fit.t_start for s in plans)
        assert plans[0].t_end <= plans[1].t_start
    assert not any(_children(spans, s) for s in spans if s.name == "plan")


def test_submit_spans_are_roots_on_the_callers_thread(served):
    tel, _ = served
    spans = tel.tracer.spans()
    submits = [s for s in spans if s.name == "submit"]
    first_step = min(s.t_start for s in spans if s.name == "epoch")
    assert len(submits) == 2
    assert all(s.parent_id is None and s.t_end <= first_step for s in submits)
    assert not any(s.parent_id in {u.span_id for u in submits} for s in spans)


def _run_params(opt_id, **over):
    params = {
        "opt_id": opt_id, "obj_fun": zdt1, "torch_objective": True,
        "objective_names": ["f1", "f2"],
        "space": {f"x{i}": [0.0, 1.0] for i in range(4)},
        "problem_parameters": {}, "n_initial": 3, "n_epochs": N_EPOCHS,
        "population_size": 16, "num_generations": N_GEN, "resample_fraction": 0.5,
        "surrogate_method_kwargs": dict(SMK), "random_seed": 5,
    }
    params.update(over)
    return params


def test_sequential_tenants_open_their_epochs_outside_plan():
    """Two problems of a run below its bucket minimum: each epoch's pass
    1 is one ``plan`` span, and each problem's sequential epoch opens its
    ``gp_fit`` and ``ea_scan`` (with the generation spans) beside it."""
    dmosopt_tpu_torch.run(
        _run_params("seq_plans", tenant_batching=True, problem_ids={0, 1},
                    min_tenant_bucket=99),
        verbose=False, device="cpu",
    )
    spans = port_driver.dopt_dict["seq_plans"].telemetry.tracer.spans()
    by_id = {s.span_id: s for s in spans}
    plans = [s for s in spans if s.name == "plan"]
    assert len(plans) == N_EPOCHS and all(s.labels == {} for s in plans)
    scans = [s for s in spans if s.name == "ea_scan"]
    assert len(scans) == 2 * N_EPOCHS
    for s in spans:
        if s.name in ("gp_fit", "ea_scan"):
            assert by_id[s.parent_id].name == "epoch"
    _assert_generations(spans, N_GEN)


def test_disabled_telemetry_gives_the_same_batches_and_no_tracer_call(served, monkeypatch):
    _, on = served

    def _boom(*a, **k):
        raise AssertionError("tracer touched in a telemetry=False run")

    monkeypatch.setattr(tracing.Tracer, "span", _boom)
    monkeypatch.setattr(tracing.Tracer, "record_span", _boom)
    monkeypatch.setattr(tracing.Tracer, "record_parts", _boom)
    monkeypatch.setattr(tracing.LoopPart, "__init__", _boom)
    monkeypatch.setattr(port_tel.Telemetry, "span", _boom)
    tel, off = _serve(telemetry=False)
    assert tel is None
    assert sorted(off) == sorted(on)
    for pid in on:
        assert len(off[pid]) == len(on[pid]) == N_EPOCHS
        for a, b in zip(off[pid], on[pid]):
            np.testing.assert_array_equal(a, b)


def test_run_surrogate_epochs_open_the_generation_spans():
    dmosopt_tpu_torch.run(_run_params("gen_spans"), verbose=False, device="cpu")
    spans = port_driver.dopt_dict["gen_spans"].telemetry.tracer.spans()
    assert len([s for s in spans if s.name == "ea_scan"]) == N_EPOCHS
    _assert_generations(spans, N_GEN)
    assert not [s for s in spans if s.name in ("plan", "submit")]


def test_optimize_on_device_spans_and_telemetry_free_result():
    """The loop itself: with telemetry, one span of each part for the
    loop, and armed, two live spans a generation; without telemetry, the
    same offspring from the same draws."""
    from dmosopt_tpu_torch import moasmo
    from dmosopt_tpu_torch.optimizers.nsga2 import NSGA2

    def run(tel):
        rng = np.random.default_rng(3)
        opt = NSGA2(popsize=12, nInput=3, nOutput=2, model=None, device="cpu")
        x0 = rng.random((12, 3)).astype(np.float32)
        y0 = zdt1(torch.as_tensor(x0)).numpy()
        opt.initialize_strategy(x0, y0, np.array([[0.0, 1.0]] * 3), rng)
        gen = torch.Generator().manual_seed(7)
        return moasmo._optimize_on_device(opt, zdt1, 5, gen, telemetry=tel)

    tel = port_tel.Telemetry()
    with tel.span("ea_scan"):
        with_spans = run(tel)
    _assert_generations(tel.tracer.spans(), 5)
    armed = port_tel.Telemetry()
    with tracing.annotations_armed(), armed.span("ea_scan"):
        with_live = run(armed)
    _assert_live_generations(armed.tracer.spans(), 5)
    for a, b, c in zip(with_spans, with_live, run(None)):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, c)


def test_armed_generations_annotate_the_trace():
    """A bucket epoch inside a ``torch.profiler`` capture: each part's
    ``record_function`` annotation once a generation, inside the
    ``ea_scan`` annotation."""
    from torch.profiler import ProfilerActivity, profile

    with tracing.annotations_armed(), profile(activities=[ProfilerActivity.CPU]) as prof:
        tel, _ = _serve()
    events = [e for e in prof.profiler.kineto_results.events() if e.is_user_annotation()]
    scans = [e for e in events if e.name() == "ea_scan"]
    assert len(scans) == N_EPOCHS
    for scan in scans:
        lo, hi = scan.start_ns(), scan.start_ns() + scan.duration_ns()
        inside = Counter(e.name() for e in events
                         if lo <= e.start_ns() and e.start_ns() + e.duration_ns() <= hi)
        assert [inside[name] for name in EA_SPANS] == [N_GEN] * 2
    _assert_live_generations(tel.tracer.spans(), N_GEN)


# ------------------------------------------------------------- loop parts


def test_loop_part_sums_its_unarmed_iterations():
    tr = tracing.Tracer()
    a, b = tracing.LoopPart(tr, "a"), tracing.LoopPart(tr, "b")
    with tr.span("loop") as loop:
        for i in range(3):
            with a:
                time.sleep(0.002)
            if i == 1:
                with tracing.annotations_armed(), b:  # armed: a live span
                    pass
        tr.record_parts([a, b], "generations")
    assert (a.count, b.count) == (3, 0)
    assert a.seconds >= 0.006
    spans = tr.spans()
    assert [s.name for s in spans] == ["loop", "b", "a"]
    live, summed = spans[1], spans[2]
    assert live.parent_id == summed.parent_id == loop.span_id
    assert live.labels == {} and summed.labels == {"generations": 3}
    assert summed.duration_s == pytest.approx(a.seconds)
    assert summed.t_end <= loop.t_end


def test_loop_part_raises_through_and_keeps_count():
    tr = tracing.Tracer()
    part = tracing.LoopPart(tr, "p")
    with pytest.raises(ValueError):
        with part:
            raise ValueError("inside")
    assert part.count == 1
    with pytest.raises(ValueError):
        with tracing.annotations_armed(), part:
            raise ValueError("armed")
    live = tr.spans("p")
    assert len(live) == 1 and live[0].t_end is not None
    assert tr._stack() == []
    # parts alone on a thread with no open span: roots
    tr.record_parts([part], "generations")
    assert tr.spans("p")[-1].parent_id is None


def test_native_thread_id_is_read_once_a_thread(monkeypatch):
    import threading

    calls = []
    real = threading.get_native_id

    def counted():
        calls.append(1)
        return real()

    monkeypatch.setattr(tracing.threading, "get_native_id", counted)
    tr = tracing.Tracer()
    for _ in range(5):
        with tr.span("a"):
            pass
    t = time.perf_counter()
    tr.record_span("tenant_cost", t, t)
    assert len(calls) == 1
    reads = []

    def work():  # another thread: one read of its own
        n0 = len(calls)
        for _ in range(3):
            tr.record_span("b", t, t)
        reads.append(len(calls) - n0)

    th = threading.Thread(target=work)
    th.start()
    th.join()
    assert reads == [1]
    assert {s.native_thread for s in tr.spans() if s.name != "b"} == {real()}
    assert {s.native_thread for s in tr.spans("b")} == {th.native_id}
    assert th.native_id != real()


# -------------------------------------------------------- bounded buffer


class _ListModel:
    """The list-based buffer the deque replaced: evict from the front,
    count it, keep the drain cursor on the same span."""

    def __init__(self, cap):
        self.cap, self.items, self.drained, self.dropped = cap, [], 0, 0

    def append(self, sp):
        if len(self.items) >= self.cap:
            self.items.pop(0)
            if self.drained > 0:
                self.drained -= 1
            self.dropped += 1
        self.items.append(sp)

    def drain(self):
        new = [s for s in self.items[self.drained:] if s.t_end is not None]
        still = [s for s in self.items[self.drained:] if s.t_end is None]
        self.items[self.drained:] = new + still
        self.drained += len(new)
        return new


@pytest.mark.parametrize("cap", [1, 5, 16])
def test_eviction_drain_and_order_match_the_list_model(cap):
    rng = np.random.default_rng(cap)
    tr = tracing.Tracer(max_spans=cap)
    model = _ListModel(cap)
    open_ctx = None
    for i in range(200):
        r = rng.random()
        if r < 0.1 and open_ctx is None:
            open_ctx = tr.span("h5_write")
            model.append(open_ctx.__enter__())
        elif r < 0.15 and open_ctx is not None:
            open_ctx.__exit__(None, None, None)
            open_ctx = None
        elif r < 0.3:
            assert [s.span_id for s in tr.drain()] == [s.span_id for s in model.drain()]
        else:
            t = time.perf_counter()
            model.append(tr.record_span("tenant_cost", t, t))
        assert [s.span_id for s in tr.spans()] == [s.span_id for s in model.items]
        assert tr.spans_dropped == model.dropped
    assert tracing.validate_chrome_trace(tr.to_chrome_trace()) == []
