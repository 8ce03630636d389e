"""The port's OpenMetrics exposition against the JAX package's.

`dmosopt_tpu_torch.telemetry.exposition` is a copy of
`dmosopt_tpu.telemetry.exposition`: for the same registry snapshot both
render byte-identical text, the port's parser rejects what the JAX one
rejects with the same message, and the port's exporter serves
``/metrics``, ``/healthz`` and ``/statusz`` on 127.0.0.1 (port 0, so
parallel test workers never collide) and joins its thread on close,
also as the service's ``exporter=``.
"""

import http.client
import json
import math

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from dmosopt_tpu.telemetry import MetricsRegistry as JaxRegistry
from dmosopt_tpu.telemetry import exposition as jax_expo
from dmosopt_tpu_torch.telemetry import MetricsRegistry, Telemetry
from dmosopt_tpu_torch.telemetry import exposition as torch_expo
from dmosopt_tpu_torch.telemetry.exposition import (
    MetricsExporter,
    OpenMetricsParseError,
    parse_openmetrics,
    render_openmetrics,
    samples_as_snapshot,
)
from dmosopt_tpu_torch.telemetry.health import HealthEngine, HealthRule


def _populate(reg):
    reg.counter_inc("evals_total", 12)
    reg.counter_inc("eval_batches_total", 3, backend="host")
    reg.counter_inc("eval_batches_total", 9, backend="torch")
    reg.counter_inc("tenant_cost_seconds", 1.25, tenant="t0", phase="ea")
    reg.counter_inc("tenant_cost_seconds", 2.0, tenant="sweep=lr0.1,bs32", phase="fit")
    reg.gauge_set("tenants_active", 4)
    reg.gauge_set("device_memory_bytes_in_use", 1024.0, device="0")
    reg.gauge_set("gp_distill_error", math.inf)
    reg.gauge_set("scheduler_stall_seconds", 0.123456789)
    for v in (0.002, 0.3, 0.3, 7.0, 1e4):
        reg.histogram_observe("phase_duration_seconds", v, phase="train")
    reg.histogram_observe("eval_wait_seconds", 0.05)
    reg.histogram_observe("service_step_seconds", 0.5, phase='a"b\\c\nd')
    return reg


def test_render_is_byte_identical_to_jax():
    snap = _populate(MetricsRegistry()).snapshot()
    jsnap = _populate(JaxRegistry()).snapshot()
    assert snap == jsnap
    text = render_openmetrics(snap)
    assert text == jax_expo.render_openmetrics(jsnap)
    assert text.endswith("# EOF\n")
    fams = parse_openmetrics(text)
    assert fams == jax_expo.parse_openmetrics(text)
    assert samples_as_snapshot(fams) == jax_expo.samples_as_snapshot(fams)


def test_exposition_agrees_exactly_with_snapshot():
    snap = _populate(MetricsRegistry()).snapshot()
    fams = parse_openmetrics(render_openmetrics(snap))
    back = samples_as_snapshot(fams)
    for name, series in snap["counters"].items():
        family = name[:-len("_total")] if name.endswith("_total") else name
        assert back["counters"][family] == series, name
    assert back["gauges"] == snap["gauges"]
    for name, series in snap["histograms"].items():
        samples = fams[name]["samples"]
        for label_str, summ in series.items():
            base = dict(torch_expo._parse_label_str(label_str))
            count = [v for n, lab, v in samples if n == name + "_count" and lab == base]
            total = [v for n, lab, v in samples if n == name + "_sum" and lab == base]
            assert count == [summ["count"]] and total == [pytest.approx(summ["sum"])]


BAD_TEXTS = {
    "missing_eof": "# TYPE a counter\na_total 1\n",
    "after_eof": "# TYPE a counter\na_total 1\n# EOF\na_total 2\n",
    "no_total": "# TYPE a counter\na 1\n# EOF\n",
    "outside_family": "# TYPE a counter\nb_total 1\n# EOF\n",
    "no_type": "a_total 1\n# EOF\n",
    "duplicate_series": "# TYPE a counter\na_total 1\na_total 2\n# EOF\n",
    "duplicate_type": "# TYPE a gauge\na 1\n# TYPE a gauge\n# EOF\n",
    "bad_type": "# TYPE a summary\n# EOF\n",
    "negative_counter": "# TYPE a counter\na_total -1\n# EOF\n",
    "gauge_suffix": "# TYPE a gauge\na_x 1\n# EOF\n",
    "non_numeric": "# TYPE a gauge\na one\n# EOF\n",
    "unquoted_label": "# TYPE a gauge\na{k=v} 1\n# EOF\n",
    "unclosed_braces": '# TYPE a gauge\na{k="v" 1\n# EOF\n',
    "non_cumulative": (
        "# TYPE h histogram\n"
        'h_bucket{le="1"} 5\nh_bucket{le="2"} 3\nh_bucket{le="+Inf"} 5\n'
        "h_count 5\nh_sum 1\n# EOF\n"),
    "inf_mismatch": (
        "# TYPE h histogram\n"
        'h_bucket{le="1"} 2\nh_bucket{le="+Inf"} 3\nh_count 4\nh_sum 1\n# EOF\n'),
    "missing_inf": (
        "# TYPE h histogram\n"
        'h_bucket{le="1"} 2\nh_count 2\nh_sum 1\n# EOF\n'),
    "no_le": "# TYPE h histogram\nh_bucket 2\nh_count 2\nh_sum 1\n# EOF\n",
}


@pytest.mark.parametrize("name", sorted(BAD_TEXTS))
def test_parser_rejects_what_jax_rejects(name):
    text = BAD_TEXTS[name]
    with pytest.raises(OpenMetricsParseError) as t_err:
        parse_openmetrics(text)
    with pytest.raises(jax_expo.OpenMetricsParseError) as j_err:
        jax_expo.parse_openmetrics(text)
    assert str(t_err.value) == str(j_err.value)


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read().decode(), dict(resp.getheaders())
    finally:
        conn.close()


def test_exporter_serves_metrics_healthz_statusz_and_joins():
    tel = Telemetry()
    tel.registry.counter_inc("evals_total", 5)
    eng = HealthEngine(
        rules=[HealthRule(name="critical_watch", metric="counter:eval_failures_total",
                          threshold=0.0, mode="delta", severity="critical")],
        telemetry=tel,
    )
    exporter = MetricsExporter(
        snapshot_fn=tel.registry.snapshot, health_fn=eng.summary,
        status_fn=lambda: {"steps": 7, "closed": False},
    ).start()
    thread = exporter._thread
    try:
        port = exporter.port
        assert exporter.url == f"http://127.0.0.1:{port}"
        status, body, headers = _get(port, "/metrics")
        assert status == 200 and "openmetrics-text" in headers["Content-Type"]
        assert parse_openmetrics(body)["evals"]["samples"][0][2] == 5.0
        status, body, _ = _get(port, "/healthz")
        assert status == 200 and json.loads(body)["status"] == "ok"
        tel.registry.counter_inc("eval_failures_total", 3)
        eng.evaluate(tel.registry.snapshot(), step=1)
        status, body, _ = _get(port, "/healthz")
        assert status == 503 and json.loads(body)["firing"][0]["rule"] == "critical_watch"
        eng.evaluate(tel.registry.snapshot(), step=2)
        assert _get(port, "/healthz")[0] == 200
        status, body, _ = _get(port, "/statusz")
        assert status == 200 and json.loads(body)["steps"] == 7
        assert _get(port, "/nope")[0] == 404
    finally:
        exporter.close()
    assert exporter.port is None and not thread.is_alive()
    with pytest.raises(OSError):
        _get(port, "/metrics")


def test_exporter_broken_snapshot_returns_500_and_survives():
    calls = {"n": 0}

    def snapshot():
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("torn")
        return MetricsRegistry().snapshot()

    exporter = MetricsExporter(snapshot_fn=snapshot).start()
    try:
        assert _get(exporter.port, "/metrics")[0] == 500
        assert _get(exporter.port, "/metrics")[0] == 200
    finally:
        exporter.close()


def test_service_exporter_lifecycle_and_scrape():
    """The service's ``exporter=True``: after a step, the scraped
    ``/metrics`` parses with the port's parser and agrees with the
    registry's snapshot; ``/healthz`` and ``/statusz`` answer; close()
    joins the thread."""
    from dmosopt_tpu_torch.service import OptimizationService

    def obj(pp):
        x = np.asarray([pp["x0"], pp["x1"]], dtype=np.float64)
        return np.asarray([x[0], 1.0 - x[0] + x[1]], dtype=np.float64)

    with pytest.raises(ValueError, match="telemetry"):
        OptimizationService(telemetry=False, exporter=True, device="cpu")
    svc = OptimizationService(telemetry=True, exporter=True, device="cpu")
    thread = svc.exporter._thread
    try:
        info = svc.introspect()["exporter"]
        assert info["url"].startswith("http://127.0.0.1:")
        port = info["port"]
        svc.submit(
            obj, {"x0": [0.0, 1.0], "x1": [0.0, 1.0]}, ["f1", "f2"],
            opt_id="exp_t0", torch_objective=False,
            population_size=8, num_generations=2, n_initial=3, n_epochs=1,
            surrogate_method_kwargs={"n_starts": 1, "n_iter": 10, "seed": 0},
            random_seed=1,
        )
        svc.step()
        status, body, _ = _get(port, "/metrics")
        assert status == 200
        back = samples_as_snapshot(parse_openmetrics(body))
        snap = svc.telemetry.registry.snapshot()
        for name, series in snap["counters"].items():
            family = name[:-len("_total")] if name.endswith("_total") else name
            assert back["counters"][family] == series, name
        assert back["counters"]["service_epochs"] == {"": 1.0}
        status, body, _ = _get(port, "/statusz")
        assert status == 200 and json.loads(body)["steps"] == 1
        assert _get(port, "/healthz")[0] == 200
    finally:
        svc.close()
    assert svc.exporter is None and not thread.is_alive()
    with pytest.raises(OSError):
        _get(port, "/metrics")
