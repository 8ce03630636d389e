"""The port's telemetry layer held against the JAX package's.

- The registry, the event log (ring eviction, JSONL rotation), the
  tracer (nesting, drain, eviction, Chrome export), the facade's
  `epoch_summary` folding and the health engine: the same calls on both
  packages give equal snapshots, records, summaries and transitions,
  timestamps and ids aside.
- A small `run()` in both packages with telemetry on (ZDT1 dim 4 as a
  host objective whose first call returns NaN, pop 16, 4 generations,
  2 epochs, `gpr` 2 starts x 10 steps, warm refits, ``save=True``):
  the same counter, gauge and histogram names, equal structural
  counters, the same event kinds per epoch, the same span tree (the
  port's own spans inside each generation aside), the same health
  transitions, and each package's store groups read by the
  other's loaders. The JAX run's compile-cache gauges and its
  ``program_compile`` / ``compile_cache`` events have no counterpart in
  the port, which compiles no programs.
- ``telemetry=False`` makes no telemetry call at all.
- Every metric and span name the port emits is in the JAX package's
  catalog, ``docs/observability.md``.
- A 3-problem bucket opens its ``gp_fit`` and ``ea_scan`` spans with
  ``tenant_cost`` children that tile them.
- The rank and predictor hooks record outside the generation loop and
  nothing inside it.
"""

import ast
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import dmosopt_tpu
import dmosopt_tpu.driver as jax_driver
from dmosopt_tpu import storage as jax_storage
from dmosopt_tpu import telemetry as jax_tel
from dmosopt_tpu.telemetry import events as jax_events
from dmosopt_tpu.telemetry import health as jax_health
from dmosopt_tpu.telemetry import registry as jax_registry
from dmosopt_tpu.telemetry import tracing as jax_tracing

import dmosopt_tpu_torch
import dmosopt_tpu_torch.driver as port_driver
from dmosopt_tpu_torch import storage as port_storage
from dmosopt_tpu_torch import telemetry as port_tel
from dmosopt_tpu_torch.telemetry import events as port_events
from dmosopt_tpu_torch.telemetry import health as port_health
from dmosopt_tpu_torch.telemetry import registry as port_registry
from dmosopt_tpu_torch.telemetry import tracing as port_tracing

REPO = Path(__file__).resolve().parents[1]
N_DIM = 4
N_EPOCHS, N_GENERATIONS, POP = 2, 4, 16
# what the JAX run emits that the port has no counterpart for: the
# persistent compile cache's gauges and event, and the compile records
# of XLA programs (eager torch compiles none)
JAX_ONLY_GAUGES = {"compile_cache_hits", "compile_cache_misses"}
# the spans the port opens where the JAX package runs one compiled
# program: the parts of each generation, the tenant plans, the submits
PORT_ONLY_SPANS = set(port_tracing.PORT_SPANS)
JAX_ONLY_EVENTS = {"program_compile", "compile_cache"}
# counters whose values are structure, not algorithm or time
STRUCTURAL_COUNTERS = (
    "epochs_total", "ea_generations_total", "resample_points_total",
    "eval_batches_total", "evals_total", "h5_saves_total",
    "gp_predictor_builds_total", "gp_warm_starts_total",
    "points_quarantined_total", "health_alerts_total",
)


# ------------------------------------------------------ module parity


def _registry_calls(reg):
    for i in range(10):
        reg.counter_inc("evals_total", 1.0, problem=str(i))
    reg.counter_inc("evals_total", 2.5, problem="0")
    reg.counter_inc("epochs_total")
    reg.gauge_set("tenant_bucket_size", 3.0, bucket="a")
    reg.gauge_set("tenant_bucket_size", 5.0, bucket="a")
    for v in (0.0004, 0.003, 0.2, 7.0, 400.0):
        reg.histogram_observe("phase_duration_seconds", v, phase="train")
    reg.histogram_observe("gp_predict_seconds", 0.01)
    with pytest.raises(ValueError):
        reg.counter_inc("evals_total", -1.0)
    return reg.snapshot()


def test_registry_snapshots_match_jax():
    """Counters, gauges, histograms and the label-series limit: equal
    snapshots after the same calls."""
    kw = dict(series_limit=4, histogram_buckets={"gp_predict_seconds": (0.005, 0.05)})
    jax_snap = _registry_calls(jax_registry.MetricsRegistry(**kw))
    port_snap = _registry_calls(port_registry.MetricsRegistry(**kw))
    assert port_snap == jax_snap
    assert port_snap["counters"]["telemetry_series_overflow_total"][""] == 6.0


def _event_calls(mod, path):
    log = mod.EventLog(ring_size=3, jsonl_path=str(path), max_bytes=200, keep=2)
    rotations = []
    log.on_rotate = lambda: rotations.append(1)
    for i in range(8):
        log.emit("phase", epoch=i // 3, phase="train", duration_s=0.5 * i,
                 arr=np.arange(3), x=np.float32(1.5))
    log.emit("epoch", epoch=2, duration_s=1.0)
    log.close()
    files = sorted(p.name.replace(path.name, "sink") for p in path.parent.iterdir())
    lines = [
        {k: v for k, v in e.to_dict().items() if k != "ts"}
        for e in mod.read_jsonl(str(path))
    ]
    ring = [(e.kind, e.epoch, e.fields) for e in log.records()]
    return ring, log.rotations, len(rotations), files, lines


def test_event_log_ring_and_rotation_match_jax(tmp_path):
    """Ring eviction, the JSONL sink's rotation chain and `read_jsonl`."""
    (tmp_path / "j").mkdir()
    (tmp_path / "p").mkdir()
    jax_out = _event_calls(jax_events, tmp_path / "j" / "events.jsonl")
    port_out = _event_calls(port_events, tmp_path / "p" / "events.jsonl")
    assert port_out == jax_out
    assert jax_out[1] > 0 and jax_out[3] == ["sink", "sink.1", "sink.2"]


def _summary_events(tel):
    """A two-problem epoch's events and the ring's oldest events."""
    tel.set_epoch(0)
    tel.event("phase", phase="xinit", duration_s=0.1, n_points=12)
    for pid, (n, loss) in enumerate(((20, -1.0), (24, -3.0))):
        tel.event("phase", phase="train", duration_s=0.2, n_train=n,
                  duplicates_removed=pid, fit_n_steps=10, surrogate="gpr",
                  surrogate_loss=loss, fit_early_stopped=bool(pid),
                  feasible_fraction=0.5 + pid / 4)
        tel.event("phase", phase="optimize", duration_s=0.4, n_generations=4,
                  n_evals=64, termination="num_generations" if pid else "criterion")
        tel.event("resample", resample_batch=8, resample_duplicates_removed=pid)
    tel.event("phase", phase="eval", duration_s=0.05, n_evals=8, eval_min=0.001,
              eval_max=0.004, eval_sum=0.02, eval_mean=0.0025)
    tel.event("phase", phase="eval", duration_s=0.05, n_evals=4, eval_min=-1.0,
              eval_max=-1.0, eval_sum=-1.0)
    tel.event("epoch", duration_s=1.5, eval_count=20, save_count=2)
    with tel.phase("train", n_train=3) as ph:
        ph["surrogate"] = "svgp"
    live = tel.epoch_summary(0)
    # past the epoch, its summary folds what the 4-event ring kept
    tel.set_epoch(1)
    tel.inc("evals_total", 2, backend="host")
    out = {"live": live, "ring": tel.epoch_summary(0), "next": tel.epoch_summary(1)}
    for summary in out.values():
        if "train" in summary["phases"]:
            summary["phases"]["train"] = round(summary["phases"]["train"], 1)
    snap = tel.registry.snapshot()
    hist = snap["histograms"]["phase_duration_seconds"]["phase=train"]
    return out, snap["counters"], hist["count"]


def test_epoch_summary_folding_matches_jax():
    """`Telemetry.epoch_summary` over a multi-problem epoch (sums,
    means, termination union, merged eval aggregates, gens/s), the
    facade's phase timer, and a disabled instance."""
    jax_out = _summary_events(jax_tel.Telemetry(ring_size=4))
    port_out = _summary_events(port_tel.Telemetry(ring_size=4))
    assert port_out == jax_out
    assert jax_out[0]["live"]["termination"] == "criterion+num_generations"
    assert jax_out[0]["ring"] != jax_out[0]["live"]
    for mod in (jax_tel, port_tel):
        off = mod.Telemetry(enabled=False)
        off.inc("evals_total")
        assert not off and off.registry.snapshot()["counters"] == {}
        assert mod.create_telemetry(False) is None
        assert mod.create_telemetry({"enabled": False}) is None
        assert isinstance(mod.create_telemetry(None), mod.Telemetry)
        assert mod.create_telemetry({"ring_size": 8}).log._ring.maxlen == 8
        with pytest.raises(TypeError):
            mod.create_telemetry(3)


def _tracer_calls(mod):
    tr = mod.Tracer(max_spans=6)
    with tr.span("epoch", epoch=0) as ep:
        with tr.span("gp_fit", bucket="b"):
            pass
        with tr.span("ea_scan", bucket="b") as ea:
            pass
        for i in range(2):
            tr.record_span("tenant_cost", ea.t_start, ea.t_end, parent=ea,
                           tenant=str(i), phase="ea")
        mark = tr.mark()
        with tr.span("resample", n_tenants=None):
            pass
    since = [s.name for s in tr.spans_since(mark)]
    drained = [s.name for s in tr.drain()]
    with tr.span("epoch", epoch=1):
        with tr.span("eval_drain", stage="reconcile"):
            pass
    spans = tr.spans()
    by_id = {s.span_id: s.name for s in spans}
    tree = [(s.name, by_id.get(s.parent_id), s.labels) for s in spans]
    trace = tr.to_chrome_trace()
    return (since, drained, [s.name for s in tr.drain()], tree, tr.spans_dropped,
            mod.validate_chrome_trace(trace), len(trace["traceEvents"]),
            ep.duration_s is not None)


def test_tracer_matches_jax():
    """Nesting, record_span, mark/spans_since, drain, the bounded buffer's
    eviction and the Chrome export's schema."""
    assert _tracer_calls(port_tracing) == _tracer_calls(jax_tracing)


def _health_rounds(mod, tel_mod):
    tel = tel_mod.Telemetry()
    engine = mod.HealthEngine(mod.default_rulebook(include_host=False), telemetry=tel)
    snaps = [
        {"counters": {"points_quarantined_total": {"": 1.0}}, "gauges": {}},
        {"counters": {"points_quarantined_total": {"": 1.0}},
         "gauges": {"device_busy_fraction": {"": 0.05}}},
        {"counters": {"points_quarantined_total": {"": 1.0},
                      "eval_timeouts_total": {"backend=host": 4.0}},
         "gauges": {"device_busy_fraction": {"": 0.02}}},
        {"counters": {"points_quarantined_total": {"": 1.0},
                      "eval_timeouts_total": {"backend=host": 4.0}},
         "gauges": {"device_busy_fraction": {"": 0.5}}},
    ]
    rounds = [engine.evaluate(s, introspect={"writer": {"failed": i == 2}}, step=i, epoch=i)
              for i, s in enumerate(snaps)]
    events = [
        {k: v for k, v in e.to_dict().items() if k != "ts"}
        for e in tel.log.records(kind="health_alert")
    ]
    return (rounds, engine.summary(), engine.fired(), engine.active(),
            engine.transitions(epoch=2, state="firing"), events,
            tel.registry.snapshot()["counters"])


def test_health_engine_matches_jax():
    """The rulebook over the same snapshot sequence: the same
    transitions (hysteresis, delta mode, introspect paths), summaries
    and side effects on the telemetry."""
    port = _health_rounds(port_health, port_tel)
    jax = _health_rounds(jax_health, jax_tel)
    assert port == jax
    assert ("device_busy_collapse", "warning") in jax[2]
    assert [r.name for r in port_health.default_rulebook()] == [
        r.name for r in jax_health.default_rulebook()
    ]


# ------------------------------------------------------------ the run


def _run_params(file_path, obj_fun, **over):
    params = {
        "opt_id": "tel_run", "obj_fun": obj_fun,
        "objective_names": ["f1", "f2"],
        "space": {f"x{i}": [0.0, 1.0] for i in range(N_DIM)},
        "problem_parameters": {}, "n_initial": 3, "n_epochs": N_EPOCHS,
        "population_size": POP, "num_generations": N_GENERATIONS,
        "resample_fraction": 0.5, "surrogate_method_name": "gpr",
        "surrogate_method_kwargs": {"n_starts": 2, "n_iter": 10, "seed": 0},
        "surrogate_refit": "warm", "random_seed": 11,
        "save": True, "file_path": str(file_path),
    }
    params.update(over)
    return params


def _nan_once_zdt1():
    """ZDT1 of a parameter dict whose first call returns NaN: one
    quarantined row in epoch 0, so the health rule fires and resolves."""
    calls = []

    def obj(pp):
        calls.append(1)
        x = np.array([pp[f"x{i}"] for i in range(N_DIM)])
        g = 1.0 + 9.0 / (N_DIM - 1) * np.sum(x[1:])
        f = np.array([x[0], g * (1.0 - np.sqrt(x[0] / g))])
        return np.array([np.nan, f[1]]) if len(calls) == 1 else f

    return obj


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One run in each package on the same configuration."""
    d = tmp_path_factory.mktemp("tel_runs")
    out = {}
    for name, pkg, drv, kw in (
        ("jax", dmosopt_tpu, jax_driver, {}),
        ("port", dmosopt_tpu_torch, port_driver, {"device": "cpu"}),
    ):
        path = d / f"{name}.h5"
        pkg.run(_run_params(path, _nan_once_zdt1()), verbose=False, **kw)
        dopt = drv.dopt_dict["tel_run"]
        out[name] = (dopt, path)
    return out


def _names(tel):
    snap = tel.registry.snapshot()
    return {k: set(snap[k]) for k in ("counters", "gauges", "histograms")}


def test_run_emits_the_jax_names_and_structural_counts(runs):
    jdopt, pdopt = runs["jax"][0], runs["port"][0]
    jnames, pnames = _names(jdopt.telemetry), _names(pdopt.telemetry)
    assert pnames["counters"] == jnames["counters"]
    assert pnames["gauges"] == jnames["gauges"] - JAX_ONLY_GAUGES
    assert pnames["histograms"] == jnames["histograms"]
    jc = jdopt.telemetry.registry.snapshot()["counters"]
    pc = pdopt.telemetry.registry.snapshot()["counters"]
    for name in STRUCTURAL_COUNTERS:
        assert pc[name] == jc[name], name
    assert pc["ea_generations_total"] == {"": N_EPOCHS * N_GENERATIONS}
    assert pc["points_quarantined_total"] == {"": 1.0}
    jh = jdopt.telemetry.registry.snapshot()["histograms"]
    ph = pdopt.telemetry.registry.snapshot()["histograms"]
    assert set(ph["phase_duration_seconds"]) == set(jh["phase_duration_seconds"])
    # the refit controller took the same paths in both packages
    assert (pdopt.optimizer_dict[0].refit_controller.path_history
            == jdopt.optimizer_dict[0].refit_controller.path_history == ["cold", "warm"])


def _event_kinds(tel):
    return Counter(
        (e.epoch, e.kind, e.fields.get("phase")) for e in tel.log.records()
        if e.kind not in JAX_ONLY_EVENTS
    )


def _span_tree(spans):
    by_id = {s["span_id"]: s["name"] for s in spans}
    return Counter((s["name"], by_id.get(s.get("parent_id"))) for s in spans)


def _shared_spans(spans):
    """The spans both packages open: the port's generation parts (leaves
    under `ea_scan`) have no counterpart in the JAX package's scan."""
    return [s for s in spans if s["name"] not in PORT_ONLY_SPANS]


def test_run_events_spans_and_alerts_match_jax(runs):
    jdopt, pdopt = runs["jax"][0], runs["port"][0]
    assert _event_kinds(pdopt.telemetry) == _event_kinds(jdopt.telemetry)
    jspans = [s.to_dict() for s in jdopt.telemetry.tracer.spans()]
    pspans = [s.to_dict() for s in pdopt.telemetry.tracer.spans()]
    assert _span_tree(_shared_spans(pspans)) == _span_tree(jspans)
    assert {("gp_fit", "epoch"), ("ea_scan", "epoch"), ("resample", "epoch"),
            ("eval_dispatch", "epoch"), ("eval_drain", "epoch")} <= set(_span_tree(pspans))
    port_only = _span_tree(pspans) - _span_tree(_shared_spans(pspans))
    assert port_only == Counter({(name, "ea_scan"): N_EPOCHS
                                 for name in ("ea_variation", "ea_survival")})

    def strip(ts):
        return [{k: v for k, v in t.items() if k != "value"} for t in ts]

    assert strip(pdopt.health.transitions()) == strip(jdopt.health.transitions())
    assert [t["state"] for t in pdopt.health.transitions()] == ["firing", "resolved"]
    # each epoch's summary: the same keys and structural values
    for e in range(N_EPOCHS):
        js, ps = (d.telemetry.epoch_summary(e) for d in (jdopt, pdopt))
        assert set(ps) == set(js), e
        for k in ("n_generations", "n_evals", "resample_batch", "n_train",
                  "eval_count", "save_count"):
            assert ps[k] == js[k], (e, k)


@pytest.mark.parametrize("reader", ["jax", "port"])
def test_store_groups_read_across_packages(runs, reader):
    """Each package's telemetry, span and alert groups load through the
    other package's loaders, with the same epochs and structure."""
    mod = jax_storage if reader == "jax" else port_storage
    other = "port" if reader == "jax" else "jax"
    path, own = runs[other][1], runs[reader][1]
    summaries = mod.load_telemetry_from_h5(str(path), "tel_run")
    mine = mod.load_telemetry_from_h5(str(own), "tel_run")
    assert sorted(summaries) == sorted(mine) == list(range(N_EPOCHS))
    for e in summaries:
        assert set(summaries[e]) == set(mine[e])
        assert summaries[e]["n_generations"] == N_GENERATIONS
    spans, my_spans = (mod.load_spans_from_h5(str(p), "tel_run") for p in (path, own))
    assert sorted(spans) == sorted(my_spans)
    assert sum((_span_tree(_shared_spans(v)) for v in spans.values()), Counter()) == sum(
        (_span_tree(_shared_spans(v)) for v in my_spans.values()), Counter())
    alerts, my_alerts = (mod.load_alerts_from_h5(str(p), "tel_run") for p in (path, own))
    assert {e: [(a["rule"], a["state"]) for a in v] for e, v in alerts.items()} == {
        e: [(a["rule"], a["state"]) for a in v] for e, v in my_alerts.items()
    } == {0: [("quarantine_spike", "firing")], 1: [("quarantine_spike", "resolved")]}


def test_disabled_run_makes_zero_telemetry_calls(tmp_path, monkeypatch):
    """telemetry=False: no Telemetry is built and nothing records (the
    JAX package's tests/test_telemetry.py test, on the port)."""

    def _boom(*a, **k):
        raise AssertionError("telemetry touched in a telemetry=False run")

    monkeypatch.setattr(port_tel.Telemetry, "__init__", _boom)
    monkeypatch.setattr(port_tel.MetricsRegistry, "counter_inc", _boom)
    monkeypatch.setattr(port_tel.MetricsRegistry, "gauge_set", _boom)
    monkeypatch.setattr(port_tel.MetricsRegistry, "histogram_observe", _boom)
    monkeypatch.setattr(port_tel.EventLog, "emit", _boom)
    monkeypatch.setattr(port_tel.Tracer, "span", _boom)
    monkeypatch.setattr(port_tel.HealthEngine, "__init__", _boom)
    fp = tmp_path / "silent.h5"
    dmosopt_tpu_torch.run(
        _run_params(fp, _nan_once_zdt1(), telemetry=False, opt_id="silent",
                    n_epochs=1, surrogate_refit=None),
        verbose=False, device="cpu",
    )
    dopt = port_driver.dopt_dict["silent"]
    assert dopt.telemetry is None and dopt.health is None
    import h5py

    with h5py.File(fp, "r") as h5:
        assert not {"telemetry", "telemetry_spans", "telemetry_alerts"} & set(h5["silent"])


def test_default_run_is_on_and_a_caller_instance_stays_open(tmp_path):
    """telemetry None builds and closes its own instance; a caller's
    `Telemetry` is used and left open (its JSONL sink keeps writing)."""
    sink = tmp_path / "events.jsonl"
    tel = port_tel.Telemetry(jsonl_path=str(sink))
    dmosopt_tpu_torch.run(
        _run_params(tmp_path / "mine.h5", _nan_once_zdt1(), telemetry=tel,
                    opt_id="mine", n_epochs=1),
        verbose=False, device="cpu",
    )
    assert port_driver.dopt_dict["mine"].telemetry is tel
    tel.event("after_run")
    tel.close()
    kinds = [e.kind for e in port_tel.read_jsonl(str(sink))]
    assert kinds[-1] == "after_run" and "epoch" in kinds
    dmosopt_tpu_torch.run(
        _run_params(tmp_path / "own.h5", _nan_once_zdt1(), opt_id="own", n_epochs=1),
        verbose=False, device="cpu",
    )
    own = port_driver.dopt_dict["own"]
    assert isinstance(own.telemetry, port_tel.Telemetry) and own.health is not None
    assert own.telemetry.log._fh is None  # closed by run()


# ------------------------------------------------------------ catalog


def _loop_parts_in_tree(tree):
    """The part names of every ``loop_parts(tel, "name", ...)`` call."""
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "loop_parts"):
            for arg in node.args[1:]:
                assert isinstance(arg, ast.Constant), ast.dump(arg)
                yield arg.value


def test_every_emitted_name_is_in_the_jax_catalog():
    """Every metric and span name the port emits is in the JAX package's
    catalog, but for the port's own spans (`tracing.PORT_SPANS`), which
    the JAX catalog does not list and the port opens every one of."""
    from tools.graftlint.rules import metrics_catalog as mc

    # each port file parsed once, for the metrics (`mc.check`'s scan), the
    # span names and the health rules' metrics
    catalog = mc.catalog_names(REPO / "docs" / "observability.md")
    metrics, spans = set(), set()
    for path in (REPO / "dmosopt_tpu_torch").rglob("*.py"):
        tree = ast.parse(path.read_text())
        metrics |= {name for name, _ in mc.emissions_in_tree(tree)}
        spans |= {name for name, _ in mc.spans_in_tree(tree)}
        spans |= set(_loop_parts_in_tree(tree))
        spans |= {name for name, _ in mc.health_rule_metrics_in_tree(tree)}
    assert {"evals_total", "fleet_migrations_total"} <= metrics
    assert metrics <= catalog, sorted(metrics - catalog)
    assert {"epoch", "gp_fit", "ea_scan", "resample", "h5_write", "eval_drain",
            "tenant_cost"} <= spans
    assert not PORT_ONLY_SPANS & catalog
    assert PORT_ONLY_SPANS <= spans, sorted(PORT_ONLY_SPANS - spans)
    assert spans <= catalog | PORT_ONLY_SPANS, sorted(spans - catalog - PORT_ONLY_SPANS)


# ------------------------------------------------------------ buckets


def test_bucket_spans_are_tiled_by_tenant_cost_children():
    """bench.py Config 11's shape at 3 problems: the bucket's gp_fit and
    ea_scan spans carry the bucket label and n_tenants, and their
    tenant_cost children tile them in tenant order."""
    from dmosopt_tpu_torch.benchmarks.zdt import zdt1

    params = {
        "opt_id": "tel_bucket", "obj_fun": zdt1, "torch_objective": True,
        "objective_names": ["f1", "f2"],
        "space": {f"x{i}": [0.0, 1.0] for i in range(N_DIM)},
        "problem_parameters": {}, "n_initial": 3, "n_epochs": 2,
        "population_size": 16, "num_generations": 8, "resample_fraction": 0.5,
        "surrogate_method_kwargs": {"n_starts": 2, "n_iter": 10, "seed": 0},
        "random_seed": 17, "tenant_batching": True, "problem_ids": {0, 1, 2},
    }
    dmosopt_tpu_torch.run(params, verbose=False, device="cpu")
    tel = port_driver.dopt_dict["tel_bucket"].telemetry
    spans = tel.tracer.spans()
    kids = {}
    for sp in spans:
        if sp.name == "tenant_cost":
            kids.setdefault(sp.parent_id, []).append(sp)
    parents = [sp for sp in spans if sp.name in ("gp_fit", "ea_scan")]
    assert len(parents) == 2 * 2
    for parent in parents:
        assert parent.labels == {"bucket": "d4_o2_p16", "n_tenants": 3}
        tiles = kids[parent.span_id]
        assert [t.labels["tenant"] for t in tiles] == ["0", "1", "2"]
        assert tiles[0].t_start == parent.t_start
        for a, b in zip(tiles, tiles[1:]):
            assert a.t_end == b.t_start
        assert tiles[-1].t_end <= parent.t_end
        covered = sum(t.duration_s for t in tiles)
        assert covered == pytest.approx(parent.duration_s, rel=0.05)
    c = tel.registry.snapshot()["counters"]
    assert c["tenant_bucket_epochs_total"] == {"bucket=d4_o2_p16": 2.0}
    assert c["tenants_batched_total"] == {"": 6.0}
    assert {k.split(",")[0] for k in c["tenant_cost_seconds"]} == {"phase=ea", "phase=fit"}
    kinds = Counter(e.kind for e in tel.log.records())
    assert kinds["tenant_bucket"] == 2
    # the torch evaluator's batches, labelled with its backend
    assert c["eval_batches_total"] == {"backend=torch": 2.0}


def test_rank_and_predictor_hooks_stay_silent_in_the_generation_loop():
    """The hooks `run()` attaches record a build, a predict outside the
    generation loop and a 3-objective rank there; inside the loop they
    record nothing (the JAX hooks count eager calls only)."""
    from dmosopt_tpu_torch.models.gp import GPR_Matern
    from dmosopt_tpu_torch.models.predictor import set_predictor_telemetry
    from dmosopt_tpu_torch.ops.dominance import non_dominated_rank, set_rank_telemetry
    from dmosopt_tpu_torch.telemetry.hooks import generation_loop

    rng = np.random.default_rng(0)
    X, Y = rng.random((24, 3)), rng.random((24, 2))
    tel = port_tel.Telemetry()
    set_predictor_telemetry(tel)
    set_rank_telemetry(tel)
    try:
        sm = GPR_Matern(X, Y, 3, 2, np.zeros(3), np.ones(3), n_starts=1, n_iter=5,
                        predictor="matmul", device="cpu")
        sm.build_predictor()
        xq = torch.as_tensor(rng.random((8, 3)), dtype=torch.float32)
        sm.predict(xq)
        y3 = torch.as_tensor(rng.random((40, 3)), dtype=torch.float32)
        non_dominated_rank(y3)
        with generation_loop():
            sm.predict(xq)
            non_dominated_rank(y3)
    finally:
        set_predictor_telemetry(None)
        set_rank_telemetry(None)
    snap = tel.registry.snapshot()
    assert snap["counters"]["gp_predictor_builds_total"] == {"regime=matmul": 1.0}
    # W = L⁻¹, (d, P, P) float32 at the fit's 64-row bucket
    assert snap["gauges"]["gp_predictor_cache_bytes"][""] == 2 * 64 * 64 * 4
    assert snap["histograms"]["gp_predict_seconds"][""]["count"] == 1
    steps = snap["counters"]["rank_peel_iterations_total"][""]
    assert steps > 0 and snap["counters"]["rank_tile_sweeps_total"][""] == steps
    assert snap["gauges"]["rank_tile_size"][""] == 40
    (ev,) = tel.log.records(kind="gp_predictor")
    assert ev.fields["n_train"] == 24 and ev.fields["regime"] == "matmul"
