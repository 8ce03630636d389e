"""The port's fleet: worker supervision, failure detection, migration.

Counterparts of ``tests/test_fleet_supervisor.py`` on the port, on the
CPU: the ownership lease (a claimed checkpoint adopted bitwise, a
second adoption refused), admission caps, shedding and weighted
placement, heartbeat hysteresis, and the worker harness's fault kinds
and flags, all in process. Then one 2-worker subprocess fleet
(``device="cpu"``) with 4 tenants loses a worker to SIGKILL mid-epoch:
every tenant completes and every stored front equals an uninterrupted
in-process port service's bitwise, while a copy that resumes a tenant
from another tenant's generator state does not. The JAX package's
``status --fleet-dir``, `scan_fleet_dir` and ``fleet --dir`` read the
port's fleet directory into the same tables and summary as the port's.

Every subprocess wait has a deadline of at most 60 s, and the fleet's
teardown SIGKILLs any worker still running.
"""

import json
import os
import sys
import time

import numpy as np
import pytest
import torch

# one intra-op thread: the test workers share the machine, and torch's
# default of one thread per core oversubscribes it (the fleet's workers
# get OMP_NUM_THREADS=1, so their float arithmetic is this process's)
torch.set_num_threads(1)

from dmosopt_tpu_torch.fleet import (
    AdmissionPolicy,
    FleetAdmissionError,
    FleetSupervisor,
    LivenessPolicy,
)
from dmosopt_tpu_torch.fleet.objectives import host_zdt1
from dmosopt_tpu_torch.fleet.wire import (
    EXIT_FENCED,
    EXIT_OK,
    atomic_write_json,
    read_json,
    touch_flag,
    worker_dir,
)
from dmosopt_tpu_torch.service import OptimizationService
from dmosopt_tpu_torch.storage import (
    CheckpointLeaseError,
    claim_service_checkpoint,
    load_fronts_from_h5,
    load_service_checkpoint_from_h5,
    save_service_checkpoint_to_h5,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMK = {"n_starts": 2, "n_iter": 20, "seed": 0}
SPACE4 = {f"x{i}": [0.0, 1.0] for i in range(4)}
SUBMIT_KW = dict(
    torch_objective=False,
    n_epochs=4,
    population_size=16,
    num_generations=4,
    n_initial=3,
    surrogate_method_kwargs=SMK,
)
OBJECTIVE_REF = "dmosopt_tpu_torch.fleet.objectives:host_zdt1"
DEADLINE = 60.0


def _fleet_spec(i, root, **overrides):
    spec = {
        "opt_id": f"t{i}",
        "objective": OBJECTIVE_REF,
        "space": dict(SPACE4),
        "objective_names": ["f1", "f2"],
        "random_seed": 40 + i,
        "file_path": os.path.join(str(root), "results", f"t{i}.h5"),
        **SUBMIT_KW,
    }
    spec.update(overrides)
    return spec


def _fronts(handle):
    return [(u.epoch, u.x.copy(), u.y.copy()) for u in handle.updates()]


def _reference(root):
    """The uninterrupted run: one in-process port service, 4 tenants,
    each front stored in its own results file under ``root``."""
    svc = OptimizationService(telemetry=False, device="cpu")
    handles = {
        f"t{i}": svc.submit(
            host_zdt1, SPACE4, ["f1", "f2"], opt_id=f"t{i}", random_seed=40 + i,
            file_path=os.path.join(str(root), f"t{i}.h5"), **SUBMIT_KW,
        )
        for i in range(4)
    }
    svc.run()
    svc.close()
    return {k: _fronts(h) for k, h in handles.items()}


# --------------------------------------------------------------- lease unit


def test_lease_claim_adopt_bitwise_and_double_adoption_refused(reference, tmp_path):
    """Worker service w0 checkpoints two epoch boundaries and 'dies'; a
    survivor that already owns a tenant adopts w0's checkpoint under the
    lease and finishes the migrated tenants bitwise equal to the
    uninterrupted run. A second adoption, a stale fencing token and the
    adopter's own repeat are refused."""
    ref_fronts, _ = reference
    ck = str(tmp_path / "w0.h5")
    w0 = OptimizationService(
        telemetry=False, checkpoint_path=ck, owner="w0", placement_epoch=0,
        device="cpu",
    )
    for i in range(2):
        w0.submit(
            None, SPACE4, ["f1", "f2"], opt_id=f"t{i}",
            random_seed=40 + i, objective_ref=OBJECTIVE_REF, **SUBMIT_KW,
        )
    w0.step()
    w0.step()
    # no close(): the checkpoint on disk is the last epoch boundary,
    # exactly what a SIGKILL would leave
    data = load_service_checkpoint_from_h5(ck)
    assert data["service"]["owner"] == "w0"
    assert data["service"]["placement_epoch"] == 0

    w1 = OptimizationService(telemetry=True, owner="w1", placement_epoch=0,
                             device="cpu")
    own = w1.submit(
        host_zdt1, SPACE4, ["f1", "f2"], opt_id="own", random_seed=99, **SUBMIT_KW,
    )
    adopted = w1.adopt_checkpoint(ck, expected_owner="w0", placement_epoch=1)
    assert sorted(adopted) == ["t0", "t1"]
    assert w1.telemetry.registry.counter_value("tenants_adopted_total") == 2.0

    w2 = OptimizationService(telemetry=False, owner="w2", device="cpu")
    with pytest.raises(CheckpointLeaseError):
        w2.adopt_checkpoint(ck, expected_owner="w0", placement_epoch=2)
    with pytest.raises(CheckpointLeaseError):
        w2.adopt_checkpoint(ck, expected_owner="w1", placement_epoch=1)
    with pytest.raises(ValueError):
        w1.adopt_checkpoint(ck, expected_owner="w1", placement_epoch=2)
    w2.close()
    stamped = load_service_checkpoint_from_h5(ck)["service"]
    assert (stamped["owner"], stamped["placement_epoch"], stamped["claimed_from"]) \
        == ("w1", 1, "w0")

    w1.run()
    for k, h in adopted.items():
        got = _fronts(h)
        assert [e for e, _, _ in got] == [2, 3]
        for (e, x, y), (er, xr, yr) in zip(got, ref_fronts[k][2:]):
            assert e == er
            np.testing.assert_array_equal(x, xr)
            np.testing.assert_array_equal(y, yr)
        assert h.done and h.error is None
    assert own.done and own.error is None
    w1.close()


# --------------------------------------------------- admission + placement


def _fake_status(wid, *, ts=None, tenants=None, load_ratio=0.1,
                 thr_status="ok", exporter=None):
    return {
        "worker_id": wid, "pid": 1, "seq": 1,
        "ts": time.time() if ts is None else ts,
        "state": "running", "steps": 1, "exporter": exporter,
        "tenants": tenants or {}, "lease_conflicts": 0,
        "service": {"throughput": {"status": thr_status, "load_ratio": load_ratio}},
    }


def _write_status(root, wid, **kw):
    atomic_write_json(os.path.join(worker_dir(str(root), wid), "status.json"),
                      _fake_status(wid, **kw))


def _unspawned(root, **kw):
    """A supervisor whose workers are marked alive without processes."""
    sup = FleetSupervisor(str(root), n_workers=2, telemetry=True, device="cpu", **kw)
    for w in sup.workers.values():
        os.makedirs(w.dir, exist_ok=True)
        w.state = "alive"
        w.spawn_ts = time.monotonic()
    return sup


def test_admission_caps_shedding_and_weighted_placement(tmp_path):
    sup = _unspawned(tmp_path, admission=AdmissionPolicy(max_ea_budget=1000))
    # budget cap: 16 * 40 * 4 = 2560 > 1000 -> shed
    with pytest.raises(FleetAdmissionError, match="budget"):
        sup.submit(_fleet_spec(9, tmp_path, num_generations=40))
    assert sup.shed[0]["reason"] == "budget"
    reg = sup.telemetry.registry
    assert reg.counter_value("fleet_tenants_shed_total", reason="budget") == 1.0

    # w0 busy (an active tenant with most of its budget left plus
    # attributed cost), w1 idle: an unpinned submission lands on w1
    _write_status(tmp_path, "w0", tenants={"busy": {
        "state": "active", "epoch": 0, "n_epochs": 4,
        "cost_seconds": {"fit": 5.0, "ea": 5.0}}})
    _write_status(tmp_path, "w1")
    sup.placements["busy"] = {"worker": "w0", "budget": 256, "spec": {}}
    assert sup.submit(_fleet_spec(0, tmp_path))["worker"] == "w1"
    inbox = os.listdir(os.path.join(worker_dir(str(tmp_path), "w1"), "inbox"))
    assert any(n.endswith("-submit.json") for n in inbox)
    with pytest.raises(ValueError, match="already placed"):
        sup.submit(_fleet_spec(0, tmp_path))
    with pytest.raises(ValueError, match="objective_ref"):
        sup.submit({"opt_id": "x", "space": SPACE4})

    # every worker contended -> shed
    for wid in ("w0", "w1"):
        _write_status(tmp_path, wid, thr_status="host_contended", load_ratio=9.9)
    with pytest.raises(FleetAdmissionError, match="contended"):
        sup.submit(_fleet_spec(1, tmp_path))
    assert sup.shed[-1]["reason"] == "contended"
    assert read_json(os.path.join(str(tmp_path), "fleet.json"))["shed"][-1]["opt_id"] == "t1"
    sup._closed = True  # no processes were spawned; nothing to stop


def test_heartbeat_hysteresis_and_checkpointless_migration(tmp_path):
    """A stale heartbeat must persist for `confirm_rounds` consecutive
    rounds before the worker is declared dead; with no checkpoint on
    disk the migration restarts the tenant from its spec."""
    sup = _unspawned(tmp_path, liveness=LivenessPolicy(
        heartbeat_timeout=5.0, confirm_rounds=2, fence_grace=0.1))
    _write_status(tmp_path, "w0", ts=time.time() - 600.0)  # long stale
    _write_status(tmp_path, "w1")
    sup.placements["t0"] = {"worker": "w0", "budget": 256,
                            "spec": _fleet_spec(0, tmp_path)}
    sup.tenant_states["t0"] = "placed"

    assert sup.monitor_once() == []  # round 1: suspect, hysteresis holds
    assert sup.workers["w0"].state == "suspect"
    events = sup.monitor_once()  # round 2: confirmed dead
    kinds = [e["event"] for e in events]
    assert "worker_dead" in kinds and "migration" in kinds
    migration = next(e for e in events if e["event"] == "migration")
    assert migration["checkpoint_claimed"] is False
    assert migration["resubmitted"] == ["t0"]
    assert sup.placements["t0"]["worker"] == "w1"
    assert os.path.exists(os.path.join(worker_dir(str(tmp_path), "w0"), "fence"))
    reg = sup.telemetry.registry
    assert reg.counter_value("fleet_worker_deaths_total", worker="w0") == 1.0
    assert reg.counter_value("fleet_migrations_total") == 1.0
    assert sup.workers["w1"].suspect_rounds == 0
    sup._closed = True


def test_exit_code_recorded_when_the_process_exits_before_the_fence(tmp_path):
    """A worker declared dead on its heartbeat whose process finishes
    exiting before the fence (a SIGKILLed process that held a CUDA
    context takes a while to exit) keeps its exit code in the summary."""

    class Exiting:
        """A process that is still running at the liveness round and has
        exited, SIGKILLed, by the fence."""

        pid, returncode, _polls = 1, None, 0

        def poll(self):
            self._polls += 1
            if self._polls > 1:
                self.returncode = -9
            return self.returncode

    sup = _unspawned(tmp_path, liveness=LivenessPolicy(
        heartbeat_timeout=5.0, confirm_rounds=1, fence_grace=0.1))
    sup.workers["w0"].proc = Exiting()
    _write_status(tmp_path, "w0", ts=time.time() - 600.0)
    _write_status(tmp_path, "w1")
    events = sup.monitor_once()
    assert events[0]["cause"].startswith("heartbeat age")
    assert sup.summary()["workers"]["w0"]["exit_code"] == -9
    assert sup.workers["w0"].state == "dead"
    sup.workers["w0"].proc = None
    sup._closed = True


def test_supervisor_and_worker_default_to_cuda(tmp_path):
    """No fall-back that hides the device: a supervisor or a worker
    asked for CUDA on a machine without a card raises."""
    from dmosopt_tpu_torch.fleet import worker

    with pytest.raises(RuntimeError, match="CUDA"):
        FleetSupervisor(str(tmp_path), n_workers=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        worker.main(["--fleet-dir", str(tmp_path), "--worker-id", "wc",
                     "--no-exporter"])


# --------------------------------------------------------- worker harness


def test_worker_harness_fault_kinds_and_flags(tmp_path, monkeypatch):
    """``heartbeat_hang`` mutes the status heartbeat while it fires,
    ``partition`` also closes the exporter, a fence flag exits with
    `EXIT_FENCED` writing nothing, a stop flag closes gracefully."""
    from dmosopt_tpu_torch.fleet.worker import WorkerHarness

    plan = {"seed": 0, "rules": [
        {"kind": "heartbeat_hang", "op": "worker", "target": "wh",
         "after": 0, "count": 2},
        {"kind": "partition", "op": "worker", "target": "wh",
         "after": 2, "count": 1},
    ]}
    monkeypatch.setenv("DMOSOPT_FAULT_PLAN", json.dumps(plan))
    h = WorkerHarness(str(tmp_path), "wh", poll=0.01, exporter=True,
                      telemetry=True, device="cpu")
    status0 = read_json(h._status_path)
    assert status0["state"] == "starting"
    assert status0["exporter"]["port"] > 0  # ephemeral bind surfaced

    h.run(max_loops=2)  # both loops heartbeat_hang -> no status writes
    st = read_json(h._status_path)
    assert st["seq"] == status0["seq"] == 0 and st["state"] == "starting"
    h.run(max_loops=1)  # partition: exporter closed, still muted
    assert h.service.exporter is None
    assert read_json(h._status_path)["state"] == "starting"
    h.run(max_loops=1)  # plan exhausted: heartbeat resumes
    st = read_json(h._status_path)
    assert st["state"] == "running" and st["seq"] >= 1
    assert st["exporter"] is None  # the blackhole is visible
    h.service.close()
    monkeypatch.delenv("DMOSOPT_FAULT_PLAN")

    h3 = WorkerHarness(str(tmp_path), "wf", poll=0.01, exporter=False,
                       telemetry=False, device="cpu")
    touch_flag(h3._fence_path)
    before = read_json(h3._status_path)
    assert h3.run() == EXIT_FENCED
    assert read_json(h3._status_path) == before  # no further writes
    h3.service.close()

    h4 = WorkerHarness(str(tmp_path), "ws", poll=0.01, exporter=False,
                       telemetry=False, device="cpu")
    touch_flag(h4._stop_path)
    assert h4.run() == EXIT_OK
    assert read_json(h4._status_path)["state"] == "stopped"


# --------------------------------------------------------- subprocess fleet


@pytest.fixture(scope="module")
def fleet_run(tmp_path_factory):
    """2 workers, 4 tenants (2 a worker); t0's 19th evaluation (the
    12-row design, then 4 a resample: mid-epoch 3, two epoch boundaries
    checkpointed) SIGKILLs w0. Returns the run's summary, the fleet
    directory and the supervisor's registry."""
    root = tmp_path_factory.mktemp("fleet")
    plan = {"seed": 0, "rules": [
        {"kind": "kill", "target": "t0", "op": "eval", "after": 18}]}
    env = {"PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    sup = FleetSupervisor(
        str(root), n_workers=2, telemetry=True, device="cpu",
        liveness=LivenessPolicy(heartbeat_timeout=20.0, confirm_rounds=2,
                                fence_grace=10.0, probe_timeout=2.0,
                                probe_retries=1),
        worker_env={"w0": dict(env, DMOSOPT_FAULT_PLAN=json.dumps(plan)),
                    "w1": dict(env)},
        python=sys.executable,
    )
    ref_root = tmp_path_factory.mktemp("reference")
    try:
        sup.start(timeout=DEADLINE)
        for i in range(4):
            sup.submit(_fleet_spec(i, root), worker=f"w{i % 2}")
        # the uninterrupted run, in this process while the workers run;
        # the supervisor's first round after it finds w0 dead
        reference = (_reference(ref_root), ref_root)
        summary = sup.run(poll=0.05, timeout=DEADLINE)
        sup.stop(timeout=DEADLINE)
        sup.close()
    finally:
        for w in sup.workers.values():
            if w.proc is not None and w.proc.poll() is None:
                w.proc.kill()
                w.proc.wait(timeout=DEADLINE)
    return summary, root, sup.telemetry.registry, reference


@pytest.fixture(scope="module")
def reference(fleet_run):
    """The uninterrupted run's fronts by tenant, and its results folder."""
    return fleet_run[3]


def test_fleet_kill9_migration(fleet_run):
    summary, root, reg, _ = fleet_run
    assert summary["tenants"] == {f"t{i}": "completed" for i in range(4)}
    assert summary["workers"]["w0"]["state"] in ("dead", "fenced")
    assert summary["workers"]["w0"]["exit_code"] == -9
    assert len(summary["migrations"]) == 1
    migration = summary["migrations"][0]
    assert (migration["from"], migration["to"]) == ("w0", "w1")
    assert sorted(migration["tenants"]) == ["t0", "t2"]
    assert migration["checkpoint_claimed"] is True
    assert summary["lease_conflicts"] == 0
    assert reg.counter_value("fleet_worker_deaths_total", worker="w0") == 1.0
    assert reg.counter_value("fleet_migrations_total") == 1.0
    assert reg.counter_value("fleet_tenants_migrated_total") == 2.0
    # the dead worker's checkpoint carries its adopter's lease, so any
    # later claim fails the expected-owner check
    ck = str(root / "workers" / "w0" / "checkpoint.h5")
    stamped = load_service_checkpoint_from_h5(ck)["service"]
    assert stamped["owner"] == "w1" and stamped["claimed_from"] == "w0"
    with pytest.raises(CheckpointLeaseError):
        claim_service_checkpoint(ck, "w0", "w9", 99)


def _assert_fronts_equal(got, want, label):
    assert sorted(got) == sorted(want) == [0, 1, 2, 3], label
    for e in want:
        np.testing.assert_array_equal(got[e][0], want[e][0], err_msg=f"{label} {e} x")
        np.testing.assert_array_equal(got[e][1], want[e][1], err_msg=f"{label} {e} y")


def test_fleet_fronts_equal_the_uninterrupted_run_bitwise(fleet_run, reference):
    _, root, _, _ = fleet_run
    _, ref_root = reference
    for i in range(4):
        opt_id = f"t{i}"
        _assert_fronts_equal(
            load_fronts_from_h5(str(root / "results" / f"{opt_id}.h5"), opt_id),
            load_fronts_from_h5(str(ref_root / f"{opt_id}.h5"), opt_id),
            opt_id,
        )


def test_a_swapped_generator_state_fails_the_comparison(fleet_run, reference, tmp_path):
    """The bitwise comparison can fail: t0 resumed from the dead worker's
    checkpoint with t2's generator state (and t2 with t0's) streams
    fronts that differ from the uninterrupted run's, while the unswapped
    checkpoint resumes to them exactly."""
    _, root, _, _ = fleet_run
    ref_fronts, _ = reference
    data = load_service_checkpoint_from_h5(str(root / "workers" / "w0" / "checkpoint.h5"))
    tenants = {tp["state"]["opt_id"]: tp for tp in data["tenants"].values()}
    assert sorted(tenants) == ["t0", "t2"]
    for tp in tenants.values():
        tp["config"]["file_path"] = None  # the copies write no stores

    def resumed_fronts(name):
        path = str(tmp_path / f"{name}.h5")
        save_service_checkpoint_to_h5(data, path)
        svc, handles = OptimizationService.resume(path, {}, telemetry=False,
                                                  checkpoint=False, device="cpu")
        svc.run()
        svc.close()
        return _fronts(handles["t0"])

    def same(got, want):
        return len(got) == len(want) and all(
            e == er and np.array_equal(x, xr) and np.array_equal(y, yr)
            for (e, x, y), (er, xr, yr) in zip(got, want))

    want = ref_fronts["t0"][2:]
    assert same(resumed_fronts("plain"), want)
    a, b = tenants["t0"]["state"], tenants["t2"]["state"]
    a["rng_state"], b["rng_state"] = b["rng_state"], a["rng_state"]
    assert not same(resumed_fronts("swapped"), want)


def test_jax_package_reads_the_port_fleet_directory(fleet_run, monkeypatch, capsys):
    """The JAX package's `scan_fleet_dir`, ``status --fleet-dir`` and
    ``fleet --dir`` read the port's fleet directory into the port's
    tables and summary (one clock for both renderings)."""
    from click.testing import CliRunner

    from dmosopt_tpu import cli as jcli
    from dmosopt_tpu.telemetry import fleet as jfleet
    from dmosopt_tpu_torch import cli as tcli
    from dmosopt_tpu_torch.telemetry import fleet as tfleet

    _, root, _, _ = fleet_run
    scan = tfleet.scan_fleet_dir(str(root))
    assert scan == jfleet.scan_fleet_dir(str(root))
    assert [w["worker_id"] for w in scan["workers"]] == ["w0", "w1"]
    assert scan["workers"][0]["fenced"] and scan["workers"][0]["has_checkpoint"]

    now = time.time()
    monkeypatch.setattr(time, "time", lambda: now)
    capsys.readouterr()
    assert tcli.main(["status", "-d", str(root)]) == 0
    out = capsys.readouterr().out
    result = CliRunner().invoke(jcli.status, ["-d", str(root)])
    assert result.exit_code == 0 and result.stdout == out
    assert "migration @ epoch 1: w0 -> w1 (2 tenant(s): t0,t2" in out
    assert "FENCED" in out and "completed" in out

    assert tcli.main(["fleet", "--dir", str(root), "--as-json"]) == 0
    ours = json.loads(capsys.readouterr().out)
    result = CliRunner().invoke(jcli.fleet, ["--dir", str(root), "--as-json"])
    assert result.exit_code == 0 and json.loads(result.stdout) == ours
    # six files scanned; runs come only from w0's checkpoint (its two
    # tenants at their last boundary): w1 closed with none running, and
    # a results store of fronts holds no run group
    assert (ours["n_stores"], ours["n_runs"]) == (1, 2)
    assert list(ours["signatures"]) == ["d4_o2"]
