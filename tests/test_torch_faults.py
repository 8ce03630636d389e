"""The port's fault-injection harness against the JAX package's.

`dmosopt_tpu_torch.testing.faults` is a copy of
`dmosopt_tpu.testing.faults` over the port's evaluators. Both packages'
`FaultPlan`s must take the same decisions for the same seed and spec,
call by call, whatever the interleaving; the wrappers must drive the
port's real timeout and retry machinery (`_HostEvalHandle`), the result
layer of `TorchBatchEvaluator`, and the `BackgroundWriter`'s retries.
"""

import json

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from dmosopt_tpu.testing import faults as jax_faults
from dmosopt_tpu_torch.parallel.evaluator import (
    EvalFailure,
    HostFunEvaluator,
    TorchBatchEvaluator,
)
from dmosopt_tpu_torch.parallel.pipeline import BackgroundWriter
from dmosopt_tpu_torch.testing import faults as torch_faults
from dmosopt_tpu_torch.testing.faults import (
    FAULT_PLAN_ENV,
    FaultPlan,
    FaultRule,
    FaultyEvaluator,
    FaultyStore,
    InjectedFault,
)

SPECS = {
    "window": {"seed": 0, "rules": [
        {"kind": "raise", "target": "a", "after": 2, "count": 2}]},
    "probability": {"seed": 7, "rules": [
        {"kind": "nan", "target": "*", "p": 0.5},
        {"kind": "raise", "target": "t*", "p": 0.3, "after": 1}]},
    "mixed": {"seed": 3, "rules": [
        {"kind": "delay", "target": "a", "p": 0.25, "delay_s": 0.0},
        {"kind": "io_error", "target": "writer", "op": "io", "count": 3},
        {"kind": "raise", "target": "b", "count": 1},
        {"kind": "nan", "target": "?", "p": 0.6}]},
}
CALLS = [("eval", t) for t in "aabtatbbt1a"] + [("io", "writer")] * 5 + [
    ("eval", t) for t in ["t0", "t1", "t0", "b", "a"] * 3]


def _decisions(plan, calls):
    out = []
    for op, target in calls:
        rule = plan.next_fault(op, target)
        out.append(None if rule is None else (rule.kind, rule.target))
    return out


@pytest.mark.parametrize("name", sorted(SPECS))
def test_plan_decisions_match_jax(name):
    spec = SPECS[name]
    jp = jax_faults.FaultPlan.from_spec(json.dumps(spec))
    tp = torch_faults.FaultPlan.from_spec(json.dumps(spec))
    assert _decisions(tp, CALLS) == _decisions(jp, CALLS)
    assert tp.injected == jp.injected
    assert tp.to_spec() == jp.to_spec()
    for op, target in set(CALLS):
        assert tp.calls(op, target) == jp.calls(op, target)
    assert tp.fires() == jp.fires() and tp.fires(kind="nan") == jp.fires(kind="nan")
    # the stateless draw itself, over a grid of coordinates
    for ridx in range(len(spec["rules"])):
        for target in ("a", "t0", "writer"):
            for i in range(8):
                assert tp._chance(ridx, target, i) == jp._chance(ridx, target, i)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_plan_decisions_are_interleaving_free(name):
    """Per (target, call index) the decisions do not depend on the order
    in which targets are consulted: calls and fires are counted per
    target."""
    spec = SPECS[name]
    p1, p2 = FaultPlan.from_spec(spec), FaultPlan.from_spec(spec)
    per1, per2 = {}, {}
    for (op, t), d in zip(CALLS, _decisions(p1, CALLS)):
        per1.setdefault((op, t), []).append(d)
    rev = list(reversed(CALLS))
    for (op, t), d in zip(rev, _decisions(p2, rev)):
        per2.setdefault((op, t), []).append(d)
    assert per1 == per2


@pytest.mark.parametrize(
    "bad", [{"kind": "meteor"}, {"kind": "raise", "op": "network"},
            {"kind": "raise", "p": 1.5}, {"kind": "nan", "p": -0.1}],
)
def test_rule_validation_matches_jax(bad):
    with pytest.raises(ValueError) as t_err:
        FaultRule(**bad)
    with pytest.raises(ValueError) as j_err:
        jax_faults.FaultRule(**bad)
    assert str(t_err.value) == str(j_err.value)


def test_plan_from_env_inline_and_path(tmp_path, monkeypatch):
    monkeypatch.delenv(FAULT_PLAN_ENV, raising=False)
    assert FaultPlan.from_env() is None
    spec = {"seed": 5, "rules": [{"kind": "nan", "target": "x*"}]}
    monkeypatch.setenv(FAULT_PLAN_ENV, json.dumps(spec))
    plan = FaultPlan.from_env()
    assert plan.seed == 5 and plan.rules[0].kind == "nan"
    p = tmp_path / "plan.json"
    p.write_text(json.dumps(spec))
    monkeypatch.setenv(FAULT_PLAN_ENV, f"@{p}")
    assert FaultPlan.from_env().to_spec() == jax_faults.FaultPlan.from_env().to_spec()
    with pytest.raises(ValueError, match="rules"):
        FaultPlan.from_spec({"seed": 1})


def _drain(handle):
    out = {}
    while not handle.done:
        item = handle.poll(timeout=5.0)
        if item is not None:
            out[item[0]] = item[1]
    return [out[i] for i in sorted(out)]


def _ok_eval(sv):
    return {0: np.asarray([float(sv["i"]), 1.0]), "time": 0.01}


def test_host_raise_transient_retry_and_exhaustion():
    plan = FaultPlan([{"kind": "raise", "target": "t", "count": 1,
                       "message": "transient"}])
    ev = FaultyEvaluator(HostFunEvaluator(_ok_eval), plan, "t")
    try:
        (res,) = _drain(ev.submit_batch([{"i": np.asarray(0)}], retries=1))
        assert not isinstance(res, EvalFailure) and res[0][0] == 0.0
        assert plan.fires(kind="raise") == 1
        plan.rules.append(FaultRule(kind="raise", target="t"))
        (res,) = _drain(ev.submit_batch([{"i": np.asarray(1)}], retries=1))
        assert isinstance(res, EvalFailure) and isinstance(res.error, InjectedFault)
        assert res.n_attempts == 2
    finally:
        ev.close()


def test_host_hang_times_out():
    plan = FaultPlan([{"kind": "hang", "target": "t", "delay_s": 0.5}])
    ev = FaultyEvaluator(HostFunEvaluator(_ok_eval), plan, "t")
    try:
        (res,) = _drain(ev.submit_batch([{"i": np.asarray(0)}], timeout=0.05))
        assert isinstance(res, EvalFailure) and res.timed_out
    finally:
        ev.close()


def test_host_nan_and_inner_never_mutated():
    plan = FaultPlan([{"kind": "nan", "target": "t", "count": 1}])
    inner = HostFunEvaluator(_ok_eval)
    ev = FaultyEvaluator(inner, plan, "t")
    assert inner.eval_fun is _ok_eval
    (res,) = _drain(ev.submit_batch([{"i": np.asarray(3)}]))
    assert np.all(np.isnan(res[0])) and res["time"] == 0.01
    # the blocking path goes through the same faulty objective
    out = ev.evaluate_batch([{"i": np.asarray(4)}])
    assert out[0][0][0] == 4.0
    ev.close()
    assert inner.eval_fun is _ok_eval


def test_torch_result_layer():
    """`TorchBatchEvaluator` gets faults at the result layer, as the JAX
    package's batch evaluator does (tests/test_faults.py)."""

    def batch_fun(X):
        return torch.stack([X[:, 0], X[:, 1]], dim=1)

    plan = FaultPlan([{"kind": "nan", "target": "j", "count": 1},
                      {"kind": "raise", "target": "j", "after": 1, "count": 1}])
    ev = FaultyEvaluator(TorchBatchEvaluator(batch_fun, "cpu"), plan, "j")
    assert not hasattr(ev, "eval_fun")
    X = [{0: np.asarray([0.1, 0.2], np.float32)},
         {0: np.asarray([0.3, 0.4], np.float32)},
         {0: np.asarray([0.5, 0.6], np.float32)}]
    results = _drain(ev.submit_batch(X, timeout=5.0, retries=2))
    assert np.all(np.isnan(np.asarray(results[0][0])))
    assert isinstance(results[1], EvalFailure)
    assert isinstance(results[1].error, InjectedFault)
    np.testing.assert_allclose(np.asarray(results[2][0]), [0.5, 0.6], rtol=1e-6)
    # the blocking path: the plan's windows are spent, so it passes through
    out = ev.evaluate_batch(X[:1])
    np.testing.assert_allclose(np.asarray(out[0][0]), [0.1, 0.2], rtol=1e-6)
    assert plan.fires(target="j") == 2


def _writer(max_retries):
    w = BackgroundWriter()
    w.MAX_RETRIES, w.BACKOFF, w.BACKOFF_CAP = max_retries, 0.01, 0.05
    return w


def test_store_drives_writer_retry_then_success():
    plan = FaultPlan([{"kind": "io_error", "target": "writer", "count": 2,
                       "op": "io", "message": "transient disk"}])
    store = FaultyStore(plan, "writer")
    seen = []
    w = _writer(3)
    w.submit(store.wrap(seen.append), 1)
    w.flush()
    assert seen == [1]
    assert w.retries_total == 2 and not w.writer_failed
    w.close()


def test_store_exhausts_writer_retries():
    plan = FaultPlan([{"kind": "io_error", "target": "writer", "op": "io"}])
    store = FaultyStore(plan, "writer")
    w = _writer(2)
    w.submit(store.wrap(lambda: None))
    with pytest.raises(RuntimeError, match="background persistence"):
        w.flush()
    assert w.writer_failed and w.retries_total == 2
    w.close()
