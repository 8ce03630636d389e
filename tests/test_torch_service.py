"""The port's ask/tell service (`dmosopt_tpu_torch.service`) on the CPU.

Held, bitwise, to the port's own routes: a bucketed service against an
all-sequential one (``min_bucket`` above the tenant count), tenant by
tenant, with staggered submits, two dimensions and a shorter generation
budget riding a bucket; the task-graph scheduler at concurrency 1 and 2
against the lockstep step; a resume from a mid-run checkpoint against
the uninterrupted run; the survivors of a fault plan against a
fault-free run. The JAX package's service is the reference for
structure only: one tiny JAX service (submitted and closed, never
stepped: its step compiles for seconds) writes the checkpoint the port
resumes, and gives the ``introspect()`` key set. The JAX pin of the
staggered case (`tests/test_service.py`) fails in the reference's own
runs, so the port is not held to its numbers.
"""

import json
import os

import numpy as np
import pytest
import torch

# one intra-op thread: the test workers share the machine
torch.set_num_threads(1)

from dmosopt_tpu_torch.benchmarks.zdt import zdt1
from dmosopt_tpu_torch.service import EvalPolicy, OptimizationService
from dmosopt_tpu_torch.storage import (
    CheckpointLeaseError,
    claim_service_checkpoint,
    load_fronts_from_h5,
    load_service_checkpoint_from_h5,
    save_front_to_h5,
)

SMK = {"n_starts": 2, "n_iter": 10, "seed": 0}


def _space(dim):
    return {f"x{i}": [0.0, 1.0] for i in range(dim)}


def _submit(svc, name, *, dim, seed, n_epochs=2, num_generations=4, **extra):
    return svc.submit(
        zdt1, _space(dim), ["f1", "f2"], opt_id=name, n_epochs=n_epochs,
        population_size=16, num_generations=num_generations, n_initial=3,
        surrogate_method_kwargs=dict(SMK), random_seed=seed, **extra,
    )


def _host_zdt1(dim):
    def f(pp):
        x = torch.as_tensor([[pp[f"x{i}"] for i in range(dim)]], dtype=torch.float32)
        return zdt1(x)[0].numpy()

    return f


def _fronts(handle):
    return [(u.epoch, u.x, u.y) for u in handle.updates()]


def _assert_fronts_equal(got, want, who=""):
    assert [e for e, _, _ in got] == [e for e, _, _ in want], who
    for (e, xg, yg), (_, xw, yw) in zip(got, want):
        np.testing.assert_array_equal(xg, xw, err_msg=f"{who} epoch {e}")
        np.testing.assert_array_equal(yg, yw, err_msg=f"{who} epoch {e}")


def _staggered(min_bucket=2, scheduler=None, checkpoint_path=None, stop_after=None):
    """Two d6 tenants, then after one step a late d6 tenant with a
    shorter generation budget (epoch phase one behind) and two d4
    tenants. Returns ({name: fronts}, service snapshot, registry) or,
    with ``stop_after``, the service and handles after that many steps."""
    svc = OptimizationService(
        min_bucket=min_bucket, scheduler=scheduler, device="cpu",
        checkpoint_path=checkpoint_path,
    )
    h = {"a": _submit(svc, "a", dim=6, seed=10, n_epochs=3),
         "b": _submit(svc, "b", dim=6, seed=11, n_epochs=3)}
    svc.step()
    h["d"] = _submit(svc, "d", dim=6, seed=13, n_epochs=2, num_generations=2)
    h["c"] = _submit(svc, "c", dim=4, seed=12, n_epochs=2)
    h["e"] = _submit(svc, "e", dim=4, seed=14, n_epochs=2)
    if stop_after is not None:
        for _ in range(stop_after - 1):
            svc.step()
        return svc, h
    svc.run()
    assert all(x.done and x.error is None for x in h.values())
    fronts = {k: _fronts(x) for k, x in h.items()}
    snap, reg = svc.introspect(), svc.telemetry.registry
    svc.close()
    return fronts, snap, reg


@pytest.fixture(scope="module")
def runs():
    """The staggered scenario: bucketed lockstep, all sequential, and
    the task graph at concurrency 1 and 2."""
    return {
        "bucketed": _staggered(),
        "sequential": _staggered(min_bucket=99),
        "graph1": _staggered(scheduler=1),
        "graph2": _staggered(scheduler=2),
    }


@pytest.fixture(scope="module")
def jax_service(tmp_path_factory):
    """One tiny JAX service: submitted, checkpointed on close, never
    stepped. Returns its checkpoint path, its introspect() snapshots
    (plain, and with the scheduler and the exporter on) and the submit
    arguments."""
    from dmosopt_tpu.service import OptimizationService as JaxService

    path = str(tmp_path_factory.mktemp("jax_svc") / "ckpt.h5")
    kw = dict(opt_id="j0", n_epochs=2, population_size=16, num_generations=4,
              n_initial=3, surrogate_method_kwargs=dict(SMK), random_seed=21)
    svc = JaxService(checkpoint_path=path, owner="w0", placement_epoch=3)
    svc.submit(None, _space(4), ["f1", "f2"],
               objective_ref="dmosopt_tpu.benchmarks.zdt:zdt1", **kw)
    plain = svc.introspect()
    svc.close()
    svc2 = JaxService(scheduler=1, exporter=True)
    full = svc2.introspect()
    svc2.close()
    return path, plain, full, kw


def test_bucketed_equals_sequential_per_tenant(runs):
    bucketed, snap, reg = runs["bucketed"]
    sequential, _, seq_reg = runs["sequential"]
    # the buckets really ran: d6 with 2 tenants, then 3 (a, b beside the
    # late d), d4 with 2; the sequential service batched nothing
    assert reg.counter_value("tenant_bucket_epochs_total", bucket="d6_o2_p16") == 3.0
    assert reg.counter_value("tenant_bucket_epochs_total", bucket="d4_o2_p16") == 2.0
    assert reg.counter_value("tenants_batched_total") == 2 + (3 + 2) + (3 + 2)
    assert seq_reg.counter_value("tenants_batched_total") == 0.0
    assert snap["tenant_counts"] == {"completed": 5}
    for k in sequential:
        _assert_fronts_equal(bucketed[k], sequential[k], who=k)
        assert [e for e, _, _ in bucketed[k]] == list(range(3 if k in "ab" else 2))


@pytest.mark.parametrize("mode", ["graph1", "graph2"])
def test_scheduler_equals_lockstep_per_tenant(runs, mode):
    lockstep, lock_snap, _ = runs["bucketed"]
    graph, snap, reg = runs[mode]
    for k in lockstep:
        _assert_fronts_equal(graph[k], lockstep[k], who=f"{mode} {k}")
    assert "scheduler" not in lock_snap
    sched = snap["scheduler"]
    assert sched["concurrency"] == int(mode[-1])
    nodes = sched["last_graph"]["nodes"]
    assert {"dispatch", "eval", "fold", "checkpoint", "bucket"} <= {n["kind"] for n in nodes}
    assert all(n["state"] == "done" for n in nodes)
    # the last step: a dispatch, the five tenants' evals, the d6 (a, b,
    # d) and d4 (c, e) buckets, five folds, the checkpoint
    assert len(nodes) == 1 + 5 + 2 + 5 + 1
    assert reg.counter_value("scheduler_nodes_total", kind="bucket") == 1 + 2 + 2
    assert reg.counter_value("tenant_bucket_epochs_total", bucket="d6_o2_p16") == 3.0


def test_resume_midrun_equals_uninterrupted(runs, tmp_path):
    """Stop a checkpointing service after two steps (the late tenants
    mid-run), resume the checkpoint, run both to the end: the resumed
    tenants' continuation equals the uninterrupted run's, bitwise."""
    ckpt = str(tmp_path / "svc.h5")
    svc, handles = _staggered(checkpoint_path=ckpt, stop_after=2)
    data = load_service_checkpoint_from_h5(ckpt)
    states = {tp["state"]["opt_id"]: tp for tp in data["tenants"].values()}
    assert sorted(states) == ["a", "b", "c", "d", "e"]
    assert states["a"]["state"]["epochs_run"] == 2
    assert states["d"]["state"]["epochs_run"] == 1
    assert states["a"]["config"]["torch_objective"] is True
    assert states["a"]["arrays"]["pending_x"].shape == (4, 6)
    assert states["a"]["arrays"]["pending_has_pred"].all()
    done = {k: _fronts(h) for k, h in handles.items()}
    svc.close()

    svc2, h2 = OptimizationService.resume(
        ckpt, {k: zdt1 for k in states}, checkpoint=False, device="cpu")
    assert svc2.min_bucket == 2
    assert {k: h.tenant_id for k, h in h2.items()} == {k: h.tenant_id for k, h in handles.items()}
    svc2.run()
    uninterrupted = runs["bucketed"][0]
    for k, h in h2.items():
        assert h.done and h.error is None
        _assert_fronts_equal(done[k] + _fronts(h), uninterrupted[k], who=f"resumed {k}")
    svc2.close()


def test_fault_plan_leaves_survivors_unchanged(monkeypatch):
    """Under a fault plan (driven through DMOSOPT_FAULT_PLAN, as the JAX
    package's chaos runs drive it): two tenants' batches fail once at
    the torch evaluator's result layer, a third's first three rows come
    back NaN. The policy skips: the first two continue degraded, the
    third quarantines its rows; the other bucket-mates' fronts equal a
    fault-free run's, bitwise."""
    names = ("s0", "r1", "r2", "n1", "s1")

    def run(plan):
        if plan is None:
            monkeypatch.delenv("DMOSOPT_FAULT_PLAN", raising=False)
        else:
            monkeypatch.setenv("DMOSOPT_FAULT_PLAN", json.dumps(plan))
        svc = OptimizationService(
            device="cpu", scheduler=2,
            eval_policy=EvalPolicy(retries=1, on_eval_failure="skip"),
        )
        h = {k: _submit(svc, k, dim=4, seed=30 + i)
             for i, k in enumerate(names)}
        svc.run()
        out = {k: _fronts(x) for k, x in h.items()}
        snap, reg = svc.introspect(), svc.telemetry.registry
        svc.close()
        return out, h, snap, reg

    ref, _, ref_snap, _ = run(None)
    assert ref_snap["tenant_counts"] == {"completed": 5}
    plan = {"seed": 7, "rules": [
        {"kind": "raise", "target": "r*", "after": 2, "count": 1},
        {"kind": "nan", "target": "n1", "count": 3}]}
    got, handles, snap, reg = run(plan)
    assert snap["tenant_counts"] == {"completed": 5}
    by_id = {t["opt_id"]: t for t in snap["tenants"]}
    for k in ("r1", "r2"):
        assert by_id[k]["degraded"] is True and by_id[k]["eval_failures_total"] == 1
        assert reg.counter_value("tenant_eval_failures_total", tenant=k) == 1.0
    assert by_id["n1"]["points_quarantined_total"] == 3
    assert reg.counter_value("tenant_points_quarantined_total", tenant="n1") == 3.0
    for k in ("s0", "s1"):
        assert "degraded" not in by_id[k]
        _assert_fronts_equal(got[k], ref[k], who=k)
    for k in ("r1", "r2", "n1"):
        assert handles[k].error is None
        assert np.all(np.isfinite(handles[k].result().y))


def test_introspect_keys_match_jax(jax_service, tmp_path):
    _, plain, full, _ = jax_service
    status = str(tmp_path / "status.json")
    svc = OptimizationService(device="cpu", status_path=status)
    h0 = _submit(svc, "t0", dim=4, seed=1)
    _submit(svc, "t1", dim=4, seed=2)
    svc.step()
    snap = svc.introspect()
    assert set(snap) == set(plain)
    for key in ("queue_depths", "writer", "lease", "throughput", "health"):
        assert set(snap[key]) >= set(plain[key]) - {"note"}, key
    by_id = {t["opt_id"]: t for t in snap["tenants"]}
    assert by_id["t0"]["state"] == "active" and by_id["t0"]["epoch"] == 1
    assert by_id["t0"]["cost_seconds"]["fit"] > 0 and by_id["t0"]["gens_per_sec"] > 0
    assert set(by_id["t0"]["cost_seconds"]) == {"fit", "ea"}
    assert h0.cost_seconds["ea"] > 0
    assert snap["last_step"]["n_advanced"] == 2
    assert set(snap["last_step"]["phases"]) == {"admit", "eval", "fit", "fold"}
    reg = svc.telemetry.registry
    for phase in ("admit", "eval", "fit", "fold", "step"):
        assert reg.histogram_summary("service_step_seconds", phase=phase)["count"] == 1
    with open(status) as fh:
        assert json.load(fh)["steps"] == 1
    svc.run()
    assert svc.introspect()["tenant_counts"] == {"completed": 2}
    svc.close()
    assert json.load(open(status))["closed"] is True
    svc2 = OptimizationService(device="cpu", scheduler=1, exporter=True)
    assert set(svc2.introspect()) == set(full)
    svc2.close()


def test_failure_isolation_and_usage_errors():
    def broken(pp):
        raise RuntimeError("objective exploded")

    svc = OptimizationService(device="cpu")
    bad = svc.submit(
        broken, _space(4), ["f1", "f2"], torch_objective=False, n_epochs=2,
        population_size=16, num_generations=4, n_initial=3,
        surrogate_method_kwargs=dict(SMK), random_seed=7,
    )
    good = _submit(svc, "good", dim=4, seed=8)
    with pytest.raises(RuntimeError, match="still running"):
        good.result()
    svc.run()
    assert bad.done and bad.error is not None
    with pytest.raises(RuntimeError):
        bad.result()
    assert good.done and good.error is None and good.result().epoch == 1
    reg = svc.telemetry.registry
    assert reg.counter_value("tenants_failed_total") == 1.0
    assert reg.counter_value("tenants_completed_total") == 1.0
    with pytest.raises(ValueError, match="surrogate"):
        svc.submit(zdt1, _space(2), ["f1", "f2"], surrogate_method_name=None)
    with pytest.raises(NotImplementedError, match="jax_objective"):
        svc.submit(zdt1, _space(2), ["f1", "f2"], jax_objective=True)
    late = _submit(svc, "late", dim=4, seed=9, n_epochs=3)
    svc.step()
    svc.close()
    assert late.done and late.best().epoch == 0
    with pytest.raises(RuntimeError, match="service closed before"):
        late.result()
    with pytest.raises(RuntimeError, match="closed"):
        _submit(svc, "after", dim=4, seed=6)
    with pytest.raises(RuntimeError, match="closed"):
        svc.step()
    # a host objective on the service's thread pool and a caller's
    # evaluator ride the same service
    svc = OptimizationService(device="cpu", telemetry=False)
    h = svc.submit(_host_zdt1(4), _space(4), ["f1", "f2"], torch_objective=False,
                   n_epochs=2, population_size=16, num_generations=4, n_initial=3,
                   surrogate_method_kwargs=dict(SMK), random_seed=3)
    svc.run()
    assert np.all(np.isfinite(h.result().y)) and svc.telemetry is None
    svc.close()


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        OptimizationService()


def test_packages_read_each_others_fronts(tmp_path):
    from dmosopt_tpu import storage as jax_storage

    rng = np.random.default_rng(0)
    x, y = rng.random((5, 3)), rng.random((5, 2))
    for writer, reader in ((save_front_to_h5, jax_storage.load_fronts_from_h5),
                           (jax_storage.save_front_to_h5, load_fronts_from_h5)):
        path = str(tmp_path / f"{writer.__module__}.h5")
        for epoch in (1, 0):
            writer("t0", epoch, ["a", "b", "c"], ["f1", "f2"], x + epoch, y, path)
        fronts = reader(path, "t0")
        assert list(fronts) == [0, 1]
        np.testing.assert_array_equal(fronts[1][0], (x + 1).astype(np.float32))
        np.testing.assert_array_equal(fronts[0][1], y.astype(np.float32))


def test_port_resumes_jax_checkpoint(jax_service, tmp_path):
    """The JAX service's checkpoint (its jax_objective read as
    torch_objective, its objective_ref re-imported as the port's ZDT1)
    resumes in the port and runs as a fresh port submission of the same
    seed, bitwise; then its lease refuses a stale claim."""
    path, _, _, kw = jax_service
    import shutil

    local = str(tmp_path / "jax_ckpt.h5")
    shutil.copy(path, local)
    data = load_service_checkpoint_from_h5(local)
    (tp,) = data["tenants"].values()
    assert tp["config"]["jax_objective"] is True
    assert data["service"]["owner"] == "w0"
    svc, handles = OptimizationService.resume(
        local, {"j0": zdt1}, checkpoint=False, device="cpu")
    svc.run()
    got = _fronts(handles["j0"])
    svc.close()
    fresh = OptimizationService(device="cpu")
    h = fresh.submit(zdt1, _space(4), ["f1", "f2"], **kw)
    fresh.run()
    _assert_fronts_equal(got, _fronts(h), who="j0")
    fresh.close()

    with pytest.raises(CheckpointLeaseError, match="stale"):
        claim_service_checkpoint(local, "w0", "w1", 3)
    with pytest.raises(CheckpointLeaseError, match="owned by"):
        claim_service_checkpoint(local, "w9", "w1", 4)
    before = claim_service_checkpoint(local, "w0", "w1", 4)
    assert before["owner"] == "w0"
    with pytest.raises(CheckpointLeaseError):
        claim_service_checkpoint(local, "w0", "w2", 5)


def test_jax_reads_port_checkpoint_and_adoption(tmp_path):
    """The JAX package loads the port's checkpoint payload as the port
    wrote it; a second service adopts its tenants under the lease, and
    a second adoption is refused."""
    from dmosopt_tpu import storage as jax_storage

    ckpt = str(tmp_path / "port.h5")
    svc = OptimizationService(device="cpu", checkpoint_path=ckpt, owner="w0",
                              placement_epoch=1)
    _submit(svc, "p0", dim=4, seed=5)
    svc.step()
    svc.close()
    ours = load_service_checkpoint_from_h5(ckpt)
    theirs = jax_storage.load_service_checkpoint_from_h5(ckpt)
    assert theirs["service"] == ours["service"] and theirs["version"] == ours["version"]
    (key,) = ours["tenants"]
    for part in ("config", "state"):
        assert theirs["tenants"][key][part] == ours["tenants"][key][part]
    for name, arr in ours["tenants"][key]["arrays"].items():
        other = theirs["tenants"][key]["arrays"][name]
        assert (arr is None) == (other is None), name
        if arr is not None:
            np.testing.assert_array_equal(arr, other)

    adopter = OptimizationService(device="cpu", owner="w1")
    handles = adopter.adopt_checkpoint(ckpt, {"p0": zdt1}, expected_owner="w0",
                                       placement_epoch=2)
    adopter.run()
    assert handles["p0"].result().epoch == 1
    assert adopter.telemetry.registry.counter_value("tenants_adopted_total") == 1.0
    with pytest.raises(CheckpointLeaseError):
        OptimizationService(device="cpu", owner="w2").adopt_checkpoint(
            ckpt, {"p0": zdt1}, expected_owner="w0", placement_epoch=3)
    adopter.close()
    assert os.path.exists(ckpt)
