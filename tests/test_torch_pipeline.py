"""The port's evaluation pipeline: thread-pool host evaluator, the
``serial``/``overlap_io``/``speculative`` modes and the background writer.

Small port versions of tests/test_pipeline.py's oracles: ``overlap_io``
(the default, as in the JAX package) writes a store byte-identical to
``serial``; arrival order never leaks into archive row order; a failed
request under ``skip`` drops only its row, under ``raise`` aborts the
run; ``speculative`` returns at quorum and reconciles its stragglers; a
time-limit stop keeps the results that had landed. The host evaluator's
`submit_batch` is held against the JAX one on one scripted objective,
its telemetry counters (batches, timeouts, retries, failures) included.
"""

import threading
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from dmosopt_tpu import telemetry as jax_telemetry
from dmosopt_tpu.parallel import evaluator as jax_evaluator
from dmosopt_tpu.parallel.pipeline import PipelineConfig as JaxPipelineConfig

import dmosopt_tpu_torch
from dmosopt_tpu_torch.benchmarks.zdt import zdt1
from dmosopt_tpu_torch.driver import DistOptimizer, dopt_dict
from dmosopt_tpu_torch.parallel import evaluator as port_evaluator
from dmosopt_tpu_torch.parallel.pipeline import BackgroundWriter, PipelineConfig
from dmosopt_tpu_torch import telemetry as port_telemetry

N_DIM = 4


def zdt1_host(pp):
    x = np.array([pp[f"x{i}"] for i in range(N_DIM)])
    f1 = x[0]
    g = 1.0 + 9.0 / (N_DIM - 1) * np.sum(x[1:])
    return np.array([f1, g * (1.0 - np.sqrt(f1 / g))])


def _params(**over):
    params = {
        "opt_id": "torch_pipeline",
        "obj_fun": zdt1_host,
        "objective_names": ["f1", "f2"],
        "space": {f"x{i}": [0.0, 1.0] for i in range(N_DIM)},
        "problem_parameters": {},
        "n_initial": 3,
        "n_epochs": 2,
        "population_size": 16,
        "num_generations": 5,
        "resample_fraction": 0.5,
        "surrogate_method_kwargs": {"n_starts": 2, "n_iter": 20, "seed": 0},
        "random_seed": 7,
    }
    params.update(over)
    return params


def _run(**over):
    dmosopt_tpu_torch.run(_params(**over), device="cpu", verbose=False)
    return dopt_dict[over.get("opt_id", "torch_pipeline")]


def _archive(dopt):
    strat = dopt.optimizer_dict[0]
    return np.asarray(strat.x), np.asarray(strat.y)


def test_pipeline_config_resolves_as_in_the_jax_package():
    for spec in (None, "serial", "speculative", {"mode": "overlap_io", "eval_retries": 2}):
        port, ref = PipelineConfig.from_spec(spec), JaxPipelineConfig.from_spec(spec)
        assert (port.mode, port.quorum_fraction, port.eval_retries) == (
            ref.mode, ref.quorum_fraction, ref.eval_retries
        )
    assert PipelineConfig.from_spec(None).mode == "overlap_io"
    dopt = DistOptimizer("cfg", zdt1_host, **{
        k: v for k, v in _params().items() if k not in ("opt_id", "obj_fun")
    }, device="cpu")
    assert dopt.pipeline.mode == "overlap_io"
    with pytest.raises(ValueError, match="skip"):
        DistOptimizer("cfg", zdt1_host, **{
            **{k: v for k, v in _params().items() if k not in ("opt_id", "obj_fun")},
            "surrogate_method_name": None,
            "pipeline": {"on_eval_failure": "skip"},
        }, device="cpu")


def test_background_writer_runs_in_order_and_surfaces_errors():
    seen = []
    w = BackgroundWriter()
    for i in range(20):
        w.submit(seen.append, i)
    w.flush()
    assert seen == list(range(20))

    hiccups = iter([OSError("busy"), OSError("busy")])

    def flaky_append(v):
        err = next(hiccups, None)
        if err is not None:
            raise err
        seen.append(v)

    w.submit(flaky_append, "retried")  # transient errors retry in place
    w.submit(seen.append, "next")
    w.flush()
    assert seen[-2:] == ["retried", "next"]

    def boom():
        raise ValueError("disk full")

    w.submit(boom)
    w.submit(seen.append, "after")  # may be queued before the error lands
    with pytest.raises(RuntimeError, match="failed"):
        w.flush()
    assert "after" not in seen  # nothing is written after a failed write
    with pytest.raises(RuntimeError, match="dead"):
        w.submit(seen.append, 0)
    w.close()


def test_serial_and_overlap_io_stores_are_byte_identical(tmp_path, monkeypatch):
    """The wall clock is the one nondeterministic input of the store
    (stats), so it is frozen; what remains is the write sequence. The
    telemetry groups (random trace ids, the spans' threads) stay out, as
    the JAX package's pin runs with ``telemetry=False``
    (tests/test_pipeline.py)."""
    monkeypatch.setattr(time, "time", lambda: 0.0)
    monkeypatch.setattr(time, "perf_counter", lambda: 0.0)
    blobs = {}
    for mode in ("serial", None):
        fp = tmp_path / f"{mode}.h5"
        dopt = _run(opt_id="bytes", file_path=str(fp), save=True, save_eval=5,
                    save_surrogate_evals=True, pipeline=mode, n_epochs=3,
                    telemetry=False)
        blobs[dopt.pipeline.mode] = fp.read_bytes()
    assert blobs["overlap_io"] == blobs["serial"]


def test_out_of_order_arrival_preserves_archive_row_order():
    def sleepy(pp):
        time.sleep(0.004 * (1.0 - float(pp["x0"])))  # later rows finish first
        return zdt1_host(pp)

    serial = _archive(_run(opt_id="ooo_serial", obj_fun=sleepy, pipeline="serial"))
    overlap = _archive(_run(opt_id="ooo_overlap", obj_fun=sleepy, n_eval_workers=4))
    np.testing.assert_array_equal(serial[0], overlap[0])
    np.testing.assert_array_equal(serial[1], overlap[1])


def test_speculative_quorum_reconciles_stragglers():
    def sleepy(pp):
        time.sleep(0.01)
        return zdt1_host(pp)

    dopt = _run(opt_id="spec", obj_fun=sleepy, n_epochs=3,
                pipeline={"mode": "speculative", "quorum_fraction": 0.5})
    assert not dopt._inflight
    stats = dopt.pipeline_stats
    assert stats["quorum_returns"] >= 1 and stats["stragglers"] >= 1
    assert stats["eval_overlap_s"] > 0
    x, y = _archive(dopt)
    # every drained request is archived: the design and both resample
    # batches, stragglers included
    assert x.shape[0] == dopt.eval_count == 12 + 2 * 8
    assert np.all(np.isfinite(y))


@pytest.mark.parametrize("policy", ["skip", "raise"])
def test_failed_request_policies(policy):
    calls = {"n": 0}

    def flaky(pp):
        calls["n"] += 1
        if calls["n"] == 14:  # one evaluation of the first resample batch
            raise RuntimeError("sensor glitch")
        return zdt1_host(pp)

    params = dict(opt_id=f"fail_{policy}", obj_fun=flaky,
                  pipeline={"mode": "overlap_io", "on_eval_failure": policy})
    if policy == "raise":
        with pytest.raises(RuntimeError, match="failed terminally"):
            _run(**params)
        return
    dopt = _run(**params)
    x, _ = _archive(dopt)
    assert calls["n"] == 12 + 8
    assert x.shape[0] == dopt.eval_count == 12 + 8 - 1


def test_time_limit_soft_stop_salvages_completed_results():
    def slow(pp):
        time.sleep(0.05)
        return zdt1_host(pp)

    t0 = time.perf_counter()
    dmosopt_tpu_torch.run(_params(opt_id="softstop", obj_fun=slow, n_epochs=5),
                          time_limit=0.3, device="cpu", verbose=False)
    assert time.perf_counter() - t0 < 10.0
    dopt = dopt_dict["softstop"]
    assert not dopt._inflight
    strat = dopt.optimizer_dict[0]
    n_rows = (0 if strat.x is None else strat.x.shape[0]) + len(strat.completed)
    assert n_rows == dopt.eval_count > 0


def _scripted_objective(release):
    """Request 1 raises on its first attempt only; request 2 hangs past
    the timeout on every attempt (until `release` is set)."""
    attempts = {}
    lock = threading.Lock()

    def obj(sv):
        i = int(sv["i"])
        with lock:
            attempts[i] = attempts.get(i, 0) + 1
            n = attempts[i]
        if i == 1 and n == 1:
            raise ValueError("transient")
        if i == 2:
            release.wait(5.0)
        return {0: np.array([float(i)]), "time": 0.0}

    return obj, attempts


def _collect(module, retries, release):
    obj, attempts = _scripted_objective(release)
    ev = module.HostFunEvaluator(obj, n_workers=2)
    tel_module = port_telemetry if module is port_evaluator else jax_telemetry
    ev.telemetry = tel = tel_module.Telemetry()
    try:
        h = ev.submit_batch([{"i": np.array(i)} for i in range(4)],
                            timeout=0.2, retries=retries, backoff=0.01)
        got = {}
        while not h.done:
            item = h.poll(timeout=10.0)
            assert item is not None
            got[item[0]] = item[1]
    finally:
        # close() must not join a worker stuck in an abandoned attempt
        t0 = time.perf_counter()
        ev.close(drain_timeout=0.1)
        assert time.perf_counter() - t0 < 2.0
    summary = {
        i: (("failure", r.timed_out, r.n_attempts, type(r.error).__name__)
            if isinstance(r, module.EvalFailure) else ("ok", float(r[0][0])))
        for i, r in got.items()
    }
    snap = tel.registry.snapshot()
    batches = snap["histograms"]["eval_batch_duration_seconds"]["backend=host"]
    counts = (snap["counters"], batches["count"])
    return summary, dict(attempts), counts


@pytest.mark.parametrize("retries", [0, 1])
def test_host_submit_batch_matches_jax(retries):
    release = threading.Event()
    before = set(threading.enumerate())
    try:
        port = _collect(port_evaluator, retries, release)
        ref = _collect(jax_evaluator, retries, release)
    finally:
        release.set()
        # the abandoned attempts return now; let them end here
        for t in set(threading.enumerate()) - before:
            t.join(5.0)
    assert port == ref
    summary, attempts, (counters, n_batches) = port
    assert counters["eval_timeouts_total"][""] == retries + 1 and n_batches == 1
    assert summary[2] == ("failure", True, retries + 1, "NoneType")
    assert summary[1] == (("failure", False, 1, "ValueError") if retries == 0
                          else ("ok", 1.0))
    assert attempts[2] == retries + 1


def test_torch_submit_batch_chunks_match_evaluate_batch():
    ev = port_evaluator.TorchBatchEvaluator(zdt1, "cpu")
    rows = [{0: r} for r in np.random.default_rng(1).random((7, N_DIM))]
    want = [r[0] for r in ev.evaluate_batch(rows)]
    h = ev.submit_batch(rows, n_chunks=3)
    got = {}
    while not h.done:
        i, res = h.poll(timeout=1.0)
        got[i] = res[0]
    np.testing.assert_array_equal(np.stack([got[i] for i in range(7)]), np.stack(want))
    assert ev.submit_batch([]).done


def test_threads_return_after_run_with_a_pool_and_the_writer(tmp_path):
    before = threading.active_count()
    _run(opt_id="threads", n_eval_workers=4, pipeline="overlap_io",
         save=True, file_path=str(tmp_path / "t.h5"))
    assert threading.active_count() == before
