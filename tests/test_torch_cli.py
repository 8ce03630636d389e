"""The port's argparse CLI against the JAX package's click CLI.

One store, written by the port's ``run(save=True, device="cpu")``, is
read by both packages' commands. `analyze`, `telemetry` and `fleet`
print the same lines and write the same JSON; the numbers in them are
held at rtol 1e-6, since the JAX package's `get_best` returns float32
rows where the port's returns the archive's float64 ones. `status`
renders the same status file to the same text (the health block and a
``--watch`` loop stopped by an interrupt included). `train`'s
`torch.save` file rebuilds a surrogate that predicts as the JAX
`train`'s joblib dump does, within the single-restart GP parity
tolerance of ``tests/test_torch_gp.py`` (one restart, 40 Adam steps:
rtol 1e-3, atol 1e-4). Importing the port's CLI loads neither click nor
jax.
"""

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

# one intra-op thread: the test workers share the machine, and torch's
# default of one thread per core oversubscribes it
torch.set_num_threads(1)

import dmosopt_tpu_torch
from dmosopt_tpu_torch import cli as tcli

N_DIM = 5
OPT_ID = "cli_run"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_NUM = re.compile(r"-?\d+\.\d*(?:e[-+]?\d+)?|-?\d+e[-+]?\d+|nan|inf")


def zdt1_obj(pp):
    x = np.array([pp[f"x{i}"] for i in range(N_DIM)])
    f1 = x[0]
    g = 1.0 + 9.0 / (N_DIM - 1) * np.sum(x[1:])
    return np.array([f1, g * (1.0 - np.sqrt(f1 / g))])


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    fp = tmp_path_factory.mktemp("cli") / "run.h5"
    dmosopt_tpu_torch.run(
        {
            "opt_id": OPT_ID,
            "obj_fun": zdt1_obj,
            "objective_names": ["f1", "f2"],
            "space": {f"x{i}": [0.0, 1.0] for i in range(N_DIM)},
            "problem_parameters": {},
            "n_initial": 6,
            "n_epochs": 2,
            "population_size": 24,
            "num_generations": 8,
            "resample_fraction": 0.5,
            "surrogate_method_name": "gpr",
            "surrogate_method_kwargs": {"n_starts": 2, "n_iter": 25, "seed": 0},
            "random_seed": 9,
            "save": True,
            "file_path": str(fp),
        },
        verbose=False,
        device="cpu",
    )
    return str(fp)


def _port(capsys, argv):
    """(exit code, stdout, stderr) of the port's CLI."""
    capsys.readouterr()
    rc = tcli.main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def _jax_result(command, argv):
    """The JAX CLI's ``command`` run through click's CliRunner. click and
    the JAX CLI are imported here, so the tests of the port alone need
    neither."""
    from click.testing import CliRunner

    from dmosopt_tpu import cli as jcli

    return CliRunner().invoke(getattr(jcli, command), argv)


def _jax(command, argv):
    result = _jax_result(command, argv)
    return result.exit_code, result.stdout


def _same_text(a: str, b: str, rtol=1e-6, atol=1e-7):
    """Equal line for line, the numbers in a line within rtol/atol."""
    la, lb = a.splitlines(), b.splitlines()
    assert len(la) == len(lb), (a, b)
    for x, y in zip(la, lb):
        assert _NUM.sub("#", x) == _NUM.sub("#", y), (x, y)
        nx = [float(v) for v in _NUM.findall(x)]
        ny = [float(v) for v in _NUM.findall(y)]
        np.testing.assert_allclose(nx, ny, rtol=rtol, atol=atol, err_msg=x)


def _same_json(a, b, rtol=1e-6, atol=1e-7):
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), (a, b)
        for k in a:
            _same_json(a[k], b[k], rtol, atol)
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), (a, b)
        for x, y in zip(a, b):
            _same_json(x, y, rtol, atol)
    elif isinstance(a, float) or isinstance(b, float):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)
    else:
        assert a == b, (a, b)


ANALYZE_CASES = {
    "knn": ["--knn", "5"],
    "sort_keys": ["--sort-key", "f2", "--sort-key", "f1", "--verbose"],
    "epsilon_hv": ["--epsilons", "0.05", "--hv", "-v"],
    "per_objective_eps_ref": ["--epsilons", "0.05,0.1", "--hv", "--hv-ref", "2,2"],
    "filter_no_constraints": ["--no-constraints", "--filter-objectives", "f1",
                              "--no-hv", "--knn", "3", "-v"],
}


@pytest.mark.parametrize("case", sorted(ANALYZE_CASES))
def test_analyze_matches_jax(store, tmp_path, capsys, case):
    argv = ["-p", store, "--opt-id", OPT_ID, *ANALYZE_CASES[case]]
    t_out, j_out = tmp_path / "port.json", tmp_path / "jax.json"
    rc, out, _ = _port(capsys, ["analyze", *argv, "--output-file", str(t_out),
                                "--device", "cpu"])
    jrc, jout = _jax("analyze", [*argv, "--output-file", str(j_out)])
    assert rc == 0 and jrc == 0, (out, jout)
    _same_text(out.replace(str(t_out), "OUT"), jout.replace(str(j_out), "OUT"))
    _same_json(json.loads(t_out.read_text()), json.loads(j_out.read_text()))
    if "-v" not in argv and "--verbose" not in argv:
        # the rows go to stdout without an output file, as in the JAX CLI
        rc, out, _ = _port(capsys, ["analyze", *argv, "--device", "cpu"])
        jrc, jout = _jax("analyze", argv)
        assert rc == jrc == 0
        _same_text(out, jout)
    assert re.search(r"^\d+: \{'f1': ", out, re.M), out


@pytest.mark.parametrize(
    "extra, message",
    [
        (["--sort-key", "nope"], "unknown sort key"),
        (["--hv", "--hv-ref", "2"], "--hv-ref needs"),
        (["--epsilons", "1,2,3"], "--epsilons needs"),
    ],
)
def test_analyze_errors_match_jax(store, capsys, extra, message):
    argv = ["-p", store, "--opt-id", OPT_ID, *extra]
    rc, out, err = _port(capsys, ["analyze", *argv, "--device", "cpu"])
    result = _jax_result("analyze", argv)
    assert rc == result.exit_code == 1
    assert err.startswith("Error: ") and message in err
    # click's ClickException text, less its own stream handling
    assert err.strip() in result.output


def test_usage_errors_exit_2(tmp_path, capsys):
    missing = str(tmp_path / "missing.h5")
    rc, _, err = _port(capsys, ["analyze", "-p", missing, "--opt-id", "x"])
    assert rc == 2 and "usage:" in err and f"Path '{missing}' does not exist." in err
    assert _jax_result("analyze", ["-p", missing, "--opt-id", "x"]).exit_code == 2
    rc, _, err = _port(capsys, ["status", "-d", __file__])
    assert rc == 2 and "is a file" in err
    rc, _, err = _port(capsys, ["analyze", "-p", __file__])
    assert rc == 2 and "--opt-id" in err
    rc, _, err = _port(capsys, [])
    assert rc == 2 and "analyze" in err


def test_telemetry_matches_jax(store, tmp_path, capsys):
    t_out, j_out = tmp_path / "port.json", tmp_path / "jax.json"
    argv = ["-p", store, "--opt-id", OPT_ID, "--hv"]
    rc, out, _ = _port(capsys, ["telemetry", *argv, "-o", str(t_out),
                                "--device", "cpu"])
    jrc, jout = _jax("telemetry", [*argv, "-o", str(j_out)])
    assert rc == jrc == 0, (out, jout)
    assert "hv" in out.splitlines()[0] and len(out.splitlines()) == 2 + 2 + 1
    _same_text(out.replace(str(t_out), "OUT"), jout.replace(str(j_out), "OUT"))
    _same_json(json.loads(t_out.read_text()), json.loads(j_out.read_text()))
    rc, _, err = _port(capsys, ["telemetry", "-p", store, "--opt-id", "absent"])
    assert rc == 1 and "no telemetry group" in err


def test_fleet_matches_jax(store, tmp_path, capsys):
    t_out, j_out = tmp_path / "port.json", tmp_path / "jax.json"
    rc, out, _ = _port(capsys, ["fleet", "-p", store, "-o", str(t_out)])
    jrc, jout = _jax("fleet", ["-p", store, "-o", str(j_out)])
    assert rc == jrc == 0
    assert out.startswith("fleet: 1 run(s) across 1 store(s), 1 signature(s)")
    assert out.replace(str(t_out), "OUT") == jout.replace(str(j_out), "OUT")
    assert json.loads(t_out.read_text()) == json.loads(j_out.read_text())
    rc, out, _ = _port(capsys, ["fleet", "-p", store, "--as-json", "-s", "d5_o2"])
    jrc, jout = _jax("fleet", ["-p", store, "--as-json", "-s", "d5_o2"])
    assert rc == jrc == 0 and json.loads(out) == json.loads(jout)
    rc, _, err = _port(capsys, ["fleet", "-p", store, "-s", "d9_o9"])
    assert rc == 1 and "not in the fleet" in err
    rc, _, err = _port(capsys, ["fleet"])
    assert rc == 1 and "nothing to scan" in err


# ------------------------------------------------------- status / watch


def _status_snapshot():
    return {
        "ts": 0.0, "closed": False, "steps": 3,
        "tenant_counts": {"active": 1, "completed": 2},
        "tenants": [
            {"opt_id": "t0", "tenant_id": 0, "state": "active",
             "epoch": 2, "n_epochs": 5,
             "cost_seconds": {"fit": 1.0, "ea": 0.5}},
            {"opt_id": "t1", "tenant_id": 1, "state": "active", "degraded": True,
             "epoch": 1, "n_epochs": 5, "eval_failures_total": 2,
             "points_quarantined_total": 1, "cost_seconds": {}},
        ],
        "queue_depths": {"pending_submissions": 0, "writer_backlog": 0},
        "writer": {"failed": True, "retries_total": 3},
        "checkpoint_path": "/ck.h5",
        "lease": {"owner": "w0", "placement_epoch": 2},
        "series_overflow_total": 0,
        "spans_dropped": 4,
        "last_step": {"wall_s": 0.5, "n_advanced": 1,
                      "phases": {"eval": 0.1, "fit": 0.3}},
        "throughput": {"status": "ok", "last_step_s_per_tenant": 0.5,
                       "best_step_s_per_tenant": 0.4, "loadavg_1m": 0.5,
                       "cpu_count": 8, "load_ratio": 0.06},
        "health": {
            "status": "alerting",
            "firing": [
                {"rule": "eval_timeout_surge", "severity": "warning",
                 "since_step": 2, "value": 4.0},
            ],
            "firing_counts": {"warning": 1},
            "transitions_total": 3,
            "rules": 10,
        },
        "exporter": {"host": "127.0.0.1", "port": 9464,
                     "url": "http://127.0.0.1:9464"},
        "device_ledger": {
            "device_busy_fraction": 0.12, "device_overlap_ratio": 0.5,
            "captures": 1, "last_capture": {"n_joined": 3, "n_spans": 4},
            "programs": [{"program": "gp_fit", "bucket": "d4_o2",
                          "device_time_s": 0.01, "host_time_s": 0.2}],
            "tenant_device_seconds": {"t0": {"fit": 0.01, "ea": 0.02}},
        },
        "trace_path": "/trace.json",
    }


def test_status_renders_like_jax(tmp_path, capsys):
    path = tmp_path / "status.json"
    path.write_text(json.dumps(_status_snapshot()))
    rc, out, _ = _port(capsys, ["status", "-p", str(path)])
    jrc, jout = _jax("status", ["-p", str(path)])
    assert rc == jrc == 0
    assert out == jout
    assert "health: alerting (1 firing / 10 rules, 3 transitions)" in out
    assert "ALERT [warning] eval_timeout_surge since step 2" in out
    assert "exporter: http://127.0.0.1:9464" in out
    rc, out, _ = _port(capsys, ["status", "-p", str(path), "--as-json"])
    assert rc == 0 and json.loads(out) == _status_snapshot()
    rc, _, err = _port(capsys, ["status"])
    assert rc == 1 and "exactly one of" in err


def test_status_watch_rerenders_until_interrupted(tmp_path, capsys, monkeypatch):
    """``--watch N`` re-renders the status file every N seconds and an
    interrupt ends it with exit code 0: a patched sleep rewrites the
    file after the first render and interrupts after the second, in
    both packages, which print the same text."""
    path = tmp_path / "status.json"
    outputs = []
    for run in ("port", "jax"):
        snap = _status_snapshot()
        path.write_text(json.dumps(snap))
        calls = {"n": 0}

        def fake_sleep(seconds):
            assert seconds == 0.25
            calls["n"] += 1
            if calls["n"] == 1:
                snap["steps"] = 4
                snap["health"].update(status="ok", firing=[], firing_counts={})
                path.write_text(json.dumps(snap))
                return
            raise KeyboardInterrupt

        monkeypatch.setattr(time, "sleep", fake_sleep)
        argv = ["-p", str(path), "--watch", "0.25"]
        if run == "port":
            rc, out, _ = _port(capsys, ["status", *argv])
        else:
            rc, out = _jax("status", argv)
        assert rc == 0 and calls["n"] == 2
        outputs.append(out)
    assert outputs[0] == outputs[1]
    assert "steps=3" in outputs[0] and "steps=4" in outputs[0]
    assert "health: ok" in outputs[0] and "watching" in outputs[0]


def test_status_of_a_port_service(tmp_path, capsys):
    """A real port service's status file renders to the same text in
    both packages (the keys the JAX renderer reads are all there)."""
    from dmosopt_tpu_torch.fleet.objectives import host_zdt1
    from dmosopt_tpu_torch.service import OptimizationService

    path = tmp_path / "svc.json"
    svc = OptimizationService(device="cpu", status_path=str(path))
    for i in range(2):
        svc.submit(host_zdt1, {f"x{j}": [0.0, 1.0] for j in range(3)}, ["f1", "f2"],
                   opt_id=f"s{i}", torch_objective=False, n_epochs=2,
                   population_size=8, num_generations=2, n_initial=2,
                   surrogate_method_kwargs={"n_starts": 1, "n_iter": 5, "seed": 0},
                   random_seed=i)
    svc.step()
    svc.close()
    rc, out, _ = _port(capsys, ["status", "-p", str(path)])
    jrc, jout = _jax("status", ["-p", str(path)])
    assert rc == jrc == 0 and out == jout
    assert re.search(r"s0 +cancelled +1/2", out) and re.search(r"s1 +cancelled +1/2", out)


# ------------------------------------------------------- train / onestep


def test_train_saves_a_surrogate_that_predicts_as_jax(store, tmp_path, capsys):
    import joblib
    kw = '{"n_starts": 1, "n_iter": 40, "convergence_tol": null, "seed": 0}'
    t_out, j_out = tmp_path / "port.pt", tmp_path / "jax.joblib"
    rc, out, _ = _port(capsys, ["train", "-p", store, "--opt-id", OPT_ID, "-o",
                                str(t_out), "--surrogate-kwargs", kw, "--device", "cpu"])
    jrc, jout = _jax("train", ["-p", store, "--opt-id", OPT_ID, "-o", str(j_out),
                                  "--surrogate-kwargs", kw])
    assert rc == jrc == 0, (out, jout)
    assert out.replace(str(t_out), "OUT") == jout.replace(str(j_out), "OUT")
    assert out.startswith("trained GPR_Matern surrogate on ")
    sm = tcli.load_surrogate(str(t_out), device="cpu")
    jsm = joblib.load(j_out)
    xq = np.random.default_rng(3).random((7, N_DIM))
    for a, b in zip(sm.predict(xq), jsm.predict(xq)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-3, atol=1e-4)
    blob = torch.load(t_out, weights_only=False)
    assert blob["class"] == "dmosopt_tpu_torch.models.gp:GPR_Matern"
    assert set(blob) == {"format", "version", "class", "state"}
    assert blob["format"] == tcli.SURROGATE_FORMAT
    rc, _, err = _port(capsys, ["train", "-p", store, "--opt-id", OPT_ID,
                                "--problem-id", "7", "-o", str(t_out), "--device", "cpu"])
    assert rc == 1 and "no evaluations for problem 7" in err


def test_onestep_proposes_candidates_in_bounds(store, tmp_path, capsys):
    out_file = tmp_path / "resample.npz"
    rc, out, _ = _port(capsys, [
        "onestep", "-p", store, "--opt-id", OPT_ID, "--population-size", "16",
        "--num-generations", "5", "--resample-fraction", "0.5", "-o", str(out_file),
        "--surrogate-kwargs", '{"n_starts": 2, "n_iter": 20}', "--device", "cpu"])
    assert rc == 0, out
    assert out.splitlines() == ["proposed 8 resample candidates", f"wrote {out_file}"]
    data = np.load(out_file)
    assert data["x_resample"].shape == (8, N_DIM) and data["y_pred"].shape == (8, 2)
    assert np.all((data["x_resample"] >= 0.0) & (data["x_resample"] <= 1.0))
    assert np.all(np.isfinite(data["y_pred"]))


def test_compute_commands_default_to_cuda(store, capsys):
    """Without ``--device`` a command computes on CUDA, and raises here,
    where there is no card."""
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["analyze", "-p", store, "--opt-id", OPT_ID])


def test_import_loads_neither_click_nor_jax(tmp_path):
    """``python -m dmosopt_tpu_torch.cli status`` renders a status file
    and imports none of click, jax, joblib, the JAX package, h5py or
    torch (the interpreter's import log lists every module it loaded)."""
    path = tmp_path / "status.json"
    path.write_text(json.dumps(_status_snapshot()))
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "dmosopt_tpu_torch.cli", "status",
         "-p", str(path)], env=env, capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stderr
    assert "health: alerting" in res.stdout
    loaded = {line.split("|")[-1].strip().split(".")[0]
              for line in res.stderr.splitlines() if line.startswith("import time:")}
    assert "dmosopt_tpu_torch" in loaded and "numpy" in loaded
    assert not loaded & {"click", "jax", "joblib", "dmosopt_tpu", "h5py", "torch"}
