"""The port's benchmark runner against the JAX package's.

The port's `BenchmarkRunner(device="cpu")` runs at the JAX tests'
``FAST`` budget (``tests/test_benchmark_runner.py``) and returns the
JAX package's result fields and files. The JAX runner itself is not run:
its trajectories differ from the port's by the random streams
(threefry against Philox). What both share is the hypervolume engine
the runner measures with: on the same archive array both packages'
`AdaptiveHyperVolume` agree to 1e-12 where they compute exactly, and
their FPRAS estimates at 10 objectives within three times the sum of
their confidence half-widths.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

# one intra-op thread: the test workers share the machine, and torch's
# default of one thread per core oversubscribes it
torch.set_num_threads(1)

from dmosopt_tpu import hv as jhv
from dmosopt_tpu.benchmarks import runner as jrunner
from dmosopt_tpu_torch import hv as thv
from dmosopt_tpu_torch.benchmarks.runner import BenchmarkResult, BenchmarkRunner

FAST = dict(
    population_size=16,
    num_generations=5,
    n_epochs=2,
    n_initial=4,
    surrogate_method_kwargs={"n_starts": 2, "n_iter": 20, "seed": 0},
)


@pytest.fixture(scope="module")
def dtlz2_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("runner")
    runner = BenchmarkRunner(output_dir=str(out), device="cpu")
    res = runner.run_single_benchmark("dtlz2", 3, **FAST)
    return runner, res, out


def test_runner_captures_dtlz2_with_the_jax_fields(dtlz2_run):
    runner, res, out = dtlz2_run
    names = [f.name for f in dataclasses.fields(jrunner.BenchmarkResult)]
    assert [f.name for f in dataclasses.fields(BenchmarkResult)] == names
    assert isinstance(res, BenchmarkResult)
    assert res.problem_name == "dtlz2" and res.n_objectives == 3
    assert res.n_variables == 12  # n_obj + 9
    assert len(res.hv_trajectory) == 2 and res.final_epoch == 2
    assert res.final_hv == res.hv_trajectory[-1] > 0.0
    assert res.computation_time_seconds > 0.0
    assert res.termination_reason == "epoch_budget" and res.converged is False
    assert res.hv_method == "exact" and res.hv_ci == 0.0
    assert res.n_archive == 4 * 12 + 4  # the design, then 16 x 0.25 a resample
    assert res.metadata["pf_shape"] == "concave"

    payload = json.loads((out / "dtlz2_m3_result.json").read_text())
    assert list(payload) == names
    assert payload["final_hv"] == res.final_hv
    assert payload["hv_trajectory"] == res.hv_trajectory

    runner.save_summary()
    rows = json.loads((out / "summary.json").read_text())
    assert len(rows) == 1 and rows[0] == payload
    assert runner.TIERS == jrunner.BenchmarkRunner.TIERS


def test_runner_maf2_many_objective(tmp_path):
    """The 5-objective path (ref-point sizing, save_json=False) at a
    minimal budget, as the JAX package's test runs it."""
    runner = BenchmarkRunner(output_dir=str(tmp_path), device="cpu")
    res = runner.run_single_benchmark(
        "maf2", 5, save_json=False,
        **{**FAST, "n_epochs": 1, "num_generations": 3, "population_size": 8},
    )
    assert res.n_objectives == 5 and res.final_hv > 0.0
    assert not (tmp_path / "maf2_m5_result.json").exists()
    runner.save_summary()
    rows = json.loads((tmp_path / "summary.json").read_text())
    assert rows[0]["problem_name"] == "maf2" and rows[0]["n_objectives"] == 5


def test_runner_hv_improves_on_dtlz7(tmp_path):
    """The archive HV against a fixed reference point cannot fall as
    epochs add resampled points: the trajectory is measured."""
    runner = BenchmarkRunner(output_dir=str(tmp_path), device="cpu")
    res = runner.run_single_benchmark(
        "dtlz7", 3, save_json=False, **{**FAST, "n_epochs": 3}
    )
    traj = res.hv_trajectory
    assert len(traj) == 3
    assert all(b >= a - 1e-12 for a, b in zip(traj, traj[1:])), traj


def test_runner_defaults_to_cuda(tmp_path):
    with pytest.raises(RuntimeError, match="CUDA"):
        BenchmarkRunner(output_dir=str(tmp_path))


def test_exact_hypervolume_matches_jax_on_the_archive(dtlz2_run):
    """The runner's exact route on its own archive: the port's and the
    JAX package's engine give one value."""
    from dmosopt_tpu_torch.driver import dopt_dict

    y = dopt_dict["dtlz2_m3"].optimizer_dict[0].y
    ref = thv.default_reference_point(y)
    np.testing.assert_array_equal(ref, jhv.default_reference_point(y))
    t = thv.AdaptiveHyperVolume(ref, epsilon=0.05, device="cpu")
    j = jhv.AdaptiveHyperVolume(ref, epsilon=0.05)
    a, b = t.compute_hypervolume(y), j.compute_hypervolume(y)
    assert t.last_method == j.last_method == "exact"
    assert abs(a - b) <= 1e-12 * max(1.0, abs(b))


def test_fpras_hypervolume_agrees_with_jax_at_ten_objectives():
    """Above the exact route's dimension both engines estimate by FPRAS,
    each from its own random stream: the estimates agree within three
    times the sum of their confidence half-widths."""
    rng = np.random.default_rng(5)
    y = rng.random((40, 10))
    y /= np.linalg.norm(y, axis=1, keepdims=True)  # a spherical front
    ref = thv.default_reference_point(y)
    t = thv.AdaptiveHyperVolume(ref, epsilon=0.05, device="cpu")
    j = jhv.AdaptiveHyperVolume(ref, epsilon=0.05)
    (a, ca), (b, cb) = (t.compute_hypervolume_with_confidence(y),
                        j.compute_hypervolume_with_confidence(y))
    assert t.last_method == j.last_method == "fpras"
    assert t.last_n_samples > 0 and j.last_n_samples > 0
    assert ca > 0 and cb > 0
    assert abs(a - b) <= 3.0 * (ca + cb), (a, b, ca, cb)
