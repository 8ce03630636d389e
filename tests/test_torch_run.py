"""The port end to end through `dmosopt_tpu_torch.run()`, on the CPU.

The configuration is tests/test_driver.py's (host objective, dim 8),
run through the port only. Its symmetric-LH initial design is numpy
drawn from the run's seeded Generator in the reference's order, so it
must be bit-for-bit `dmosopt_tpu.sampling.slh`'s; the archive must hold
the rows the JAX driver's epoch accounting gives; the front must meet
the reference test's oracle.
"""

import pkgutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

# one intra-op thread: the test workers share the machine, and torch's
# default of one thread per core oversubscribes it
torch.set_num_threads(1)

import dmosopt_tpu_torch
from dmosopt_tpu import sampling as jax_sampling
from dmosopt_tpu_torch.benchmarks.zdt import distance_to_front, zdt1, zdt1_pareto
from dmosopt_tpu_torch.driver import dopt_dict

N_DIM = 8


def zdt1_obj(pp):
    """Host-Python objective taking a parameter dict (reference style)."""
    x = np.array([pp[f"x{i}"] for i in range(N_DIM)])
    f1 = x[0]
    g = 1.0 + 9.0 / (N_DIM - 1) * np.sum(x[1:])
    return np.array([f1, g * (1.0 - np.sqrt(f1 / g))])


def _params(**over):
    params = {
        "opt_id": "test_torch_zdt1",
        "obj_fun": zdt1_obj,
        "objective_names": ["f1", "f2"],
        "space": {f"x{i}": [0.0, 1.0] for i in range(N_DIM)},
        "problem_parameters": {},
        "n_initial": 8,
        "n_epochs": 3,
        "population_size": 64,
        "num_generations": 40,
        "resample_fraction": 0.5,
        "initial_method": "slh",
        "optimizer_name": "nsga2",
        "surrogate_method_name": "gpr",
        "surrogate_method_kwargs": {"n_starts": 4, "n_iter": 60, "seed": 0},
        "random_seed": 42,
    }
    params.update(over)
    return params


def test_run_zdt1_host_objective():
    best = dmosopt_tpu_torch.run(_params(), device="cpu", verbose=False)
    dopt = dopt_dict["test_torch_zdt1"]
    x_all, y_all = dopt.optimizer_dict[0].get_evals()

    n0 = 8 * N_DIM
    design = jax_sampling.slh(n0, N_DIM, np.random.default_rng(42), maxiter=5)
    np.testing.assert_array_equal(x_all[:n0], design)
    # epochs 0 and 1 each enqueue int(64 * 0.5) resample points; the last
    # epoch does not (the JAX driver, driver.py:1428-1490)
    assert x_all.shape[0] == n0 + 2 * 32
    assert [s["n_generations"] for s in dopt.epoch_stats] == [40, 40, 40]

    y = np.column_stack([v for _, v in best[1]])
    d = distance_to_front(y, zdt1_pareto(500))
    assert (d < 0.1).sum() >= 10, (y.shape, float(np.median(d)))


def test_run_torch_objective_and_no_surrogate():
    """The batched objective route, and the per-generation host path of
    a run without a surrogate."""
    best = dmosopt_tpu_torch.run(
        _params(opt_id="torch_obj", obj_fun=zdt1, torch_objective=True,
                n_initial=4, n_epochs=2, population_size=32, num_generations=10),
        device="cpu", verbose=False,
    )
    assert len(best[0]) == N_DIM and len(best[1]) == 2
    best = dmosopt_tpu_torch.run(
        _params(opt_id="no_sm", surrogate_method_name=None, n_epochs=1,
                num_generations=5, population_size=32),
        device="cpu", verbose=False,
    )
    assert len(best[0]) == N_DIM
    # the 64-point design, then the EA's initial population of 32 and 5
    # generations of 32 offspring, all evaluated for real
    assert dopt_dict["no_sm"].eval_count == 64 + 32 + 5 * 32


def test_run_with_constraints_returns_feasible_points():
    """A host objective returning (y, c): the archive keeps the constraint
    columns and the returned set is the feasible non-dominated one."""

    def constrained(pp):
        y = zdt1_obj(pp)
        return y, np.array([0.6 - pp["x0"]])  # feasible iff x0 < 0.6

    best = dmosopt_tpu_torch.run(
        _params(opt_id="constrained", obj_fun=constrained, constraint_names=["c0"],
                n_epochs=2, num_generations=10),
        device="cpu", verbose=False, return_constraints=True,
    )
    prms, _, constr = best
    x0 = dict(prms)["x0"]
    assert len(x0) > 0 and (x0 < 0.6).all()
    assert (dict(constr)["c0"] > 0).all()
    x_all, _, c_all = dopt_dict["constrained"].optimizer_dict[0].get_evals(
        return_constraints=True
    )
    assert c_all.shape == (x_all.shape[0], 1)


@pytest.mark.parametrize("option", [{"mesh": object()}, {"jax_objective": True}])
def test_unported_driver_options_raise(option):
    # ``mesh`` is ported (tests/test_torch_mesh.py): a value that is not a
    # mesh is refused by type
    with pytest.raises(TypeError if "mesh" in option else NotImplementedError):
        dmosopt_tpu_torch.run(_params(**option), device="cpu", verbose=False)


@pytest.mark.parametrize("per_problem", [True, False])
def test_stats_per_problem_matches_jax(per_problem):
    """``stats_per_problem`` True keeps each problem's keys, False
    aggregates them into ``K_mean`` and ``stats_n_problems``: the port's
    `get_stats` over a two-problem run's stats equals the JAX driver's
    over the same stats (``dmosopt_tpu/driver.py:643-689``)."""
    from types import SimpleNamespace

    from dmosopt_tpu.driver import DistOptimizer as JaxDistOptimizer

    opt_id = f"stats_per_problem_{per_problem}"
    dmosopt_tpu_torch.run(
        _params(opt_id=opt_id, obj_fun=_problems_zdt1, problem_ids={0, 1},
                stats_per_problem=per_problem, n_epochs=1, num_generations=2,
                n_initial=2, population_size=8),
        device="cpu", verbose=False,
    )
    dopt = dopt_dict[opt_id]
    assert dopt.stats_per_problem is per_problem

    def twin(cls):
        return SimpleNamespace(
            problem_ids=set(dopt.problem_ids), stats=dict(dopt.stats),
            optimizer_dict={pid: SimpleNamespace(stats=dict(s.stats))
                            for pid, s in dopt.optimizer_dict.items()},
            stats_per_problem=per_problem,
            _STATS_PER_PROBLEM_LIMIT=cls._STATS_PER_PROBLEM_LIMIT,
            _collapse_phase_pairs=cls._collapse_phase_pairs,
        )

    ported = type(dopt).get_stats(twin(type(dopt)))
    assert ported == JaxDistOptimizer.get_stats(twin(JaxDistOptimizer))
    if per_problem:
        assert any(k.startswith("0_") for k in ported)
        assert any(k.startswith("1_") for k in ported)
    else:
        assert ported["stats_n_problems"] == 2
        assert any(k.endswith("_mean") for k in ported)
    with pytest.raises(ValueError, match="stats_per_problem"):
        dmosopt_tpu_torch.run(_params(stats_per_problem="sometimes"), device="cpu",
                              verbose=False)


def _problems_zdt1(mpp):
    return {pid: zdt1_obj(pp) for pid, pp in mpp.items()}


def _featured_zdt1(pp):
    x = np.array([pp[f"x{i}"] for i in range(N_DIM)])
    return zdt1_obj(pp), np.array([x.sum()], dtype=np.float32)


@pytest.mark.parametrize(
    # the options the port took over from the JAX package: each runs a
    # short run through run() instead of raising
    "option",
    [{"tenant_batching": True, "problem_ids": {0, 1}, "obj_fun": _problems_zdt1},
     {"feature_dtypes": [("f", np.float32)], "obj_fun": _featured_zdt1},
     {"surrogate_custom_training": "no.such.hook"},
     {"problem_ids": {0, 1}, "obj_fun": _problems_zdt1},
     {"telemetry": True}],
)
def test_ported_driver_options_run(option):
    params = _params(opt_id="ported_option", n_epochs=1, num_generations=2, n_initial=2,
                     population_size=8, **option)
    if "surrogate_custom_training" in option:
        # the hook is imported by path when the epoch fits its surrogate
        with pytest.raises(ModuleNotFoundError):
            dmosopt_tpu_torch.run(params, device="cpu", verbose=False)
        return
    best = dmosopt_tpu_torch.run(params, device="cpu", verbose=False,
                                 return_features=True)
    best = best if "problem_ids" in option else {0: best}
    for prms, res, ftrs in best.values():
        assert len(prms) == N_DIM and len(res) == 2
        assert (ftrs is not None) == ("feature_dtypes" in option)


@pytest.mark.parametrize(
    # every registry name of the JAX package resolves in the port; a name
    # that is neither a shorthand nor an import path raises
    "option", [{"surrogate_method_name": "no_such_surrogate"},
               {"optimizer_name": "no_such_optimizer"},
               {"sensitivity_method_name": "no_such_method"}],
)
def test_unported_components_raise(option):
    with pytest.raises(NotImplementedError):
        dmosopt_tpu_torch.run(
            _params(n_epochs=1, num_generations=2, **option),
            device="cpu", verbose=False,
        )


FAST_GP = {"n_starts": 2, "n_iter": 30, "seed": 0}


@pytest.mark.parametrize(
    "option,check",
    [
        ({"surrogate_refit": "warm"}, "warm"),
        ({"surrogate_refit": {"mode": "warm", "rank_update_after": 0}}, "rank"),
        ({"surrogate_method_kwargs": dict(FAST_GP, predictor="matmul")}, "matmul"),
        ({"surrogate_method_kwargs": dict(FAST_GP, predictor="nystrom",
                                          nystrom_points=4096)}, "nystrom"),
        ({"surrogate_method_kwargs": dict(FAST_GP, dtype="float64")}, "float64"),
        ({"surrogate_method_name": "egp"}, "egp"),
        ({"surrogate_method_name": "megp"}, "megp"),
    ],
    ids=["warm", "warm-dict", "matmul", "nystrom", "float64", "egp", "megp"],
)
def test_run_with_exact_gp_options(option, check):
    """Each exact-GP option the JAX package's `run()` takes, end to end
    (pop 24, 10 generations, 3 epochs): the option shows in the epochs'
    stats, and the returned set meets the oracle of
    `test_run_cycling_nsga2_and_trs_with_a_surrogate`, under a quarter
    of the initial design's median distance to the front."""
    opt_id = f"gp_option_{check}"
    params = _params(opt_id=opt_id, n_initial=6, population_size=24,
                     num_generations=10, surrogate_method_kwargs=dict(FAST_GP),
                     random_seed=7)
    params.update(option)
    best = dmosopt_tpu_torch.run(params, device="cpu", verbose=False)
    dopt = dopt_dict[opt_id]
    stats = dopt.epoch_stats
    paths = [s.get("refit_path") for s in stats]
    regimes = [s["gp_predictor"] for s in stats]
    if check in ("warm", "rank"):
        history = dopt.optimizer_dict[0].refit_controller.path_history
        assert history == paths and history[0] == "cold", history
        assert check in history, history
        assert all(s["objective"]["n_steps"] == 0 for s in stats
                   if s["refit_path"].startswith("rank"))
    else:
        assert paths == [None] * 3
    assert regimes == [check if check in ("matmul", "nystrom") else "solve"] * 3
    if check in ("egp", "megp"):
        assert all(s["surrogate"] == check for s in stats)
    front = zdt1_pareto(500)
    x_all, y_all = dopt.optimizer_dict[0].get_evals()
    y = np.column_stack([v for _, v in best[1]])
    d = np.median(distance_to_front(y, front))
    d_design = np.median(distance_to_front(y_all[: 6 * N_DIM], front))
    assert d < 0.25 * d_design, (d, d_design)


def test_run_many_objective_age_with_fast_termination():
    """examples/example_dtlz_many_objective.py's configuration at a small
    size: DTLZ2 with 5 objectives through AGE-MOEA, the "fast" adaptive
    termination, a batched torch objective, 3 epochs (two resample
    batches of 8). The returned set is non-dominated and on or outside
    the unit sphere (the DTLZ2 front). The quality oracle, as in
    chip_smoke.py: the resampled rows dominate more volume than each of
    50 seeded sets of as many uniform random points and 1.07 times
    their median (reference point 2.5 per objective); a random
    resampler passes it about once in 51 runs. (The median distance
    to the sphere is no oracle: the JAX package's resamples lie farther
    out than the design, and than random points, too.)"""
    from dmosopt_tpu_torch.benchmarks.moo_benchmarks import (
        generate_problem_space, get_problem,
    )
    from dmosopt_tpu_torch.hv import hypervolume_exact

    space = generate_problem_space("dtlz2", 5)
    n_x, pop, n_epochs = len(space), 16, 3
    best = dmosopt_tpu_torch.run({
        "opt_id": "dtlz2_age", "obj_fun": get_problem("dtlz2", 5),
        "torch_objective": True, "problem_parameters": {}, "space": space,
        "objective_names": [f"f{i + 1}" for i in range(5)],
        "population_size": pop, "num_generations": 30, "optimizer_name": "age",
        "surrogate_method_name": "gpr",
        "surrogate_method_kwargs": {"n_starts": 2, "n_iter": 20},
        "termination_conditions": {"strategy": "fast"},
        "n_initial": 5, "n_epochs": n_epochs, "resample_fraction": 0.5,
        "random_seed": 7,
    }, device="cpu", verbose=False)
    dopt = dopt_dict["dtlz2_age"]
    x_all, y_all = dopt.optimizer_dict[0].get_evals()
    n0 = 5 * n_x
    design = jax_sampling.slh(n0, n_x, np.random.default_rng(7), maxiter=5)
    np.testing.assert_array_equal(x_all[:n0], design)
    assert n0 < x_all.shape[0] <= n0 + (n_epochs - 1) * pop // 2
    for s in dopt.epoch_stats:
        # the criterion is the only stopping rule: the fast composite's
        # generation cap (30) is checked every 10 generations
        assert s["stop_reasons"] and s["n_generations"] <= 40, s
        assert s["termination_checks"] >= 1
    y = np.column_stack([v for _, v in best[1]])
    assert y.shape[0] > 0 and np.all(np.isfinite(y))
    le = np.all(y[:, None, :] <= y[None, :, :], axis=2)
    lt = np.any(y[:, None, :] < y[None, :, :], axis=2)
    assert not np.any(le & lt), "returned set is dominated"
    norm = np.linalg.norm(y, axis=1)
    assert np.all(norm**2 >= 1 - 1e-5)
    ref = np.full(5, 2.5)
    y_res = y_all[n0:]
    hv_res = hypervolume_exact(y_res, ref)
    rng = np.random.default_rng(0)
    f = get_problem("dtlz2", 5)
    hv_random = [
        hypervolume_exact(
            f(torch.as_tensor(rng.random((len(y_res), n_x)), dtype=torch.float32)).numpy(),
            ref,
        )
        for _ in range(50)
    ]
    bar = max(max(hv_random), 1.07 * np.median(hv_random))
    assert hv_res > bar, (hv_res, bar)


def test_run_lorenz_cycling_cmaes_and_smpso_without_a_surrogate():
    """examples/example_lorenz.py's configuration at a small size: the
    3-objective Lorenz estimation at a short horizon through a batched
    torch objective, ``["cmaes", "smpso"]`` cycled over 2 epochs, no
    surrogate. Each optimizer's initial population is evaluated for real
    at the start of its epoch (SMPSO's S·P), then each generation's
    offspring (CMA-ES P/2, SMPSO 2·S·P); the archive is cut to P by the
    memory-bounded rank and blocked dedupe before each generation, so it
    holds at most P plus one generation of rows, each once."""
    from functools import partial

    from dmosopt_tpu_torch.benchmarks.lorenz import lorenz_objectives

    pop, gens = 24, 2
    best = dmosopt_tpu_torch.run({
        "opt_id": "lorenz_small",
        "obj_fun": partial(lorenz_objectives, n_steps=120, skip=20),
        "torch_objective": True, "problem_parameters": {},
        "space": {"s": [5.0, 15.0], "r": [15.0, 35.0], "b": [1.0, 10.0]},
        "objective_names": ["x", "y", "z"], "population_size": pop,
        "num_generations": gens, "optimizer_name": ["cmaes", "smpso"],
        "surrogate_method_name": None, "n_initial": 10, "n_epochs": 2,
        "resample_fraction": 0.25, "random_seed": 0,
    }, device="cpu", verbose=False)
    dopt = dopt_dict["lorenz_small"]
    n0, S = 30, 5
    cmaes_evals = pop + gens * pop // 2
    smpso_evals = S * pop + gens * 2 * S * pop
    assert dopt.eval_count == n0 + cmaes_evals + smpso_evals
    assert [s["n_generations"] for s in dopt.epoch_stats] == [gens, gens]
    x_all, y_all = dopt.optimizer_dict[0].get_evals()
    assert x_all.shape[0] <= pop + 2 * S * pop
    assert np.unique(x_all, axis=0).shape[0] == x_all.shape[0]
    assert np.all(np.isfinite(y_all))
    y = np.column_stack([v for _, v in best[1]])
    le = np.all(y[:, None, :] <= y[None, :, :], axis=2)
    lt = np.any(y[:, None, :] < y[None, :, :], axis=2)
    assert y.shape[0] > 0 and not np.any(le & lt), "returned set is dominated"
    assert y.sum(axis=1).min() <= y_all.sum(axis=1).min()


def test_run_cycling_nsga2_and_trs_with_a_surrogate():
    """tests/test_optimizers.py::test_optimizer_cycling_nsga2_trs, the
    reference's headline cycling configuration, scaled down (pop 24, 15
    generations, 3 epochs, a small `gpr` fit). At this size the returned
    set's median distance to the front varies widely with the seed in
    both packages (seeds 7-9: JAX 0.13-0.63, the port 0.29-0.64, against
    the design's 2.90-3.02), so the oracle is the one both meet: under a
    quarter of the initial design's."""
    best = dmosopt_tpu_torch.run(
        _params(opt_id="nsga2_trs", n_initial=6, n_epochs=3, population_size=24,
                num_generations=15, optimizer_name=["nsga2", "trs"],
                surrogate_method_kwargs={"n_starts": 2, "n_iter": 30, "seed": 0},
                random_seed=7),
        device="cpu", verbose=False,
    )
    dopt = dopt_dict["nsga2_trs"]
    assert [s["n_generations"] for s in dopt.epoch_stats] == [15, 15, 15]
    # two resample batches of 12; the dedupe may drop a re-evaluated row
    n0 = 6 * N_DIM
    assert dopt.eval_count == n0 + 2 * 12
    x_all, y_all = dopt.optimizer_dict[0].get_evals()
    assert x_all.shape[0] <= dopt.eval_count
    front = zdt1_pareto(500)
    y = np.column_stack([v for _, v in best[1]])
    d = np.median(distance_to_front(y, front))
    d_design = np.median(distance_to_front(y_all[:n0], front))
    assert d < 0.25 * d_design, (d, d_design)


def test_run_needs_cuda_unless_the_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        dmosopt_tpu_torch.run(_params(), verbose=False)


@pytest.mark.parametrize("name", ["cmaes", "smpso", "trs"])
def test_optimizers_are_found_by_name_and_need_cuda(name, monkeypatch):
    from dmosopt_tpu_torch.config import default_optimizers, resolve

    cls = resolve(name, default_optimizers)
    assert cls.__module__ == f"dmosopt_tpu_torch.optimizers.{name}"
    assert cls(popsize=8, nInput=3, nOutput=2, device="cpu").device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cls(popsize=8, nInput=3, nOutput=2)


def test_port_imports_neither_jax_nor_the_jax_package():
    modules = sorted(
        m.name for m in pkgutil.walk_packages(
            dmosopt_tpu_torch.__path__, "dmosopt_tpu_torch."
        )
    )
    code = textwrap.dedent(f"""
        import importlib, sys
        for name in {modules!r}:
            importlib.import_module(name)
        bad = [m for m in sys.modules
               if m == "jax" or m.startswith(("jax.", "jaxlib"))
               or m == "dmosopt_tpu" or m.startswith("dmosopt_tpu.")]
        assert not bad, bad
        print(len({modules!r}))
    """)
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        cwd=str(__import__("pathlib").Path(__file__).resolve().parents[1]),
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) == len(modules) >= 20


_quota_calls = []


def _quota_sampler(file_path, iteration, evaluated_samples, next_samples,
                   sampler, quota=12, **_):
    """tests/test_driver.py's round-by-round epoch-0 sampler: 4-point
    batches of the proposal until `quota` evaluations exist."""
    _quota_calls.append(iteration)
    if len(evaluated_samples) >= quota:
        return None
    return np.asarray(next_samples)[:4]


def test_dynamic_initial_sampling():
    """The epoch-0 hook drives extra evaluation rounds until it returns
    None (tests/test_driver.py::test_dynamic_initial_sampling)."""
    _quota_calls.clear()
    quota = 18
    best = dmosopt_tpu_torch.run(_params(
        opt_id="dyninit",
        dynamic_initial_sampling=f"{__name__}._quota_sampler",
        dynamic_initial_sampling_kwargs={"quota": quota},
        population_size=16, num_generations=5,
        surrogate_method_kwargs={"n_starts": 2, "n_iter": 20, "seed": 0},
        n_initial=2, n_epochs=2, random_seed=14,
    ), device="cpu", verbose=False)
    strat = dopt_dict["dyninit"].optimizer_dict[0]
    assert len(_quota_calls) >= 2  # at least one extra round ran
    assert strat.x.shape[0] >= quota  # archive holds the quota'd evals
    assert np.all(np.isfinite(np.column_stack([v for _, v in best[1]])))


def test_run_with_sensitivity_analysis():
    """sensitivity_method_name through run() (tests/test_driver.py's
    case): the indices reach each epoch's optimizer as per-gene vectors."""
    best = dmosopt_tpu_torch.run(_params(
        opt_id="sa_run", sensitivity_method_name="dgsm",
        population_size=16, num_generations=5,
        surrogate_method_kwargs={"n_starts": 2, "n_iter": 15, "seed": 0},
        n_initial=2, n_epochs=2, random_seed=3,
    ), device="cpu", verbose=False)
    assert np.all(np.isfinite(np.column_stack([v for _, v in best[1]])))
    for s in dopt_dict["sa_run"].epoch_stats:
        di = s["di_mutation"]
        assert di.shape == (N_DIM,) and di.max() == pytest.approx(20.0) and di.min() >= 1.0


def test_run_torch_objective_with_constraints():
    """torch_objective=True with constraints (tests/test_driver.py's
    jax-objective case): the batched evaluator takes the (y, c) tuple and
    a feasibility model is fitted every epoch."""

    def obj_c(X):
        y = torch.stack([X[:, 0], 1.0 - X[:, 0] + torch.sum(X[:, 1:] ** 2, dim=1)], dim=1)
        return y, X[:, :1] - 0.1  # feasible iff x0 > 0.1

    for pipeline in ("serial", "overlap_io"):
        best = dmosopt_tpu_torch.run(_params(
            opt_id="torch_c", obj_fun=obj_c, torch_objective=True,
            constraint_names=["c1"], feasibility_method_name="logreg",
            population_size=16, num_generations=5,
            surrogate_method_kwargs={"n_starts": 2, "n_iter": 15, "seed": 0},
            n_initial=2, n_epochs=2, random_seed=3, pipeline=pipeline,
        ), device="cpu", verbose=False, return_constraints=True)
        dopt = dopt_dict["torch_c"]
        strat = dopt.optimizer_dict[0]
        assert strat.c is not None and strat.c.shape == (strat.x.shape[0], 1)
        np.testing.assert_allclose(strat.c[:, 0], strat.x[:, 0] - 0.1, rtol=1e-6)
        assert np.all(np.isfinite(np.column_stack([v for _, v in best[1]])))
        assert np.all(dict(best[2])["c1"] > 0)
        assert all(s["feasibility"]["n_fitted"] == 1 for s in dopt.epoch_stats)


def _tnk(pp):
    x1, x2 = pp["x1"], pp["x2"]
    c1 = x1**2 + x2**2 - 1.0 - 0.1 * np.cos(16.0 * np.arctan2(x1, x2 + 1e-12))
    c2 = 0.5 - (x1 - 0.5) ** 2 - (x2 - 0.5) ** 2
    return np.array([x1, x2]), np.array([c1, c2])


def test_run_tnk_with_logreg_returns_feasible_points():
    """examples/example_tnk.py cut to pop 24, 10 generations, 3 epochs:
    every returned point is feasible and the feasibility rank ordered
    the fronts of every epoch's optimizer."""
    best = dmosopt_tpu_torch.run({
        "opt_id": "tnk_small", "obj_fun": _tnk, "problem_parameters": {},
        "space": {"x1": [1e-6, np.pi], "x2": [1e-6, np.pi]},
        "objective_names": ["f1", "f2"], "constraint_names": ["c1", "c2"],
        "feasibility_method_name": "logreg", "population_size": 24,
        "num_generations": 10, "optimizer_name": "nsga2",
        "surrogate_method_name": "gpr",
        "surrogate_method_kwargs": {"n_starts": 2, "n_iter": 20, "seed": 0},
        "n_initial": 20, "n_epochs": 3, "resample_fraction": 0.5, "random_seed": 1,
    }, device="cpu", verbose=False, return_constraints=True)
    c = np.column_stack([v for _, v in best[2]])
    assert c.shape[0] > 0 and np.all(c > 0)
    dopt = dopt_dict["tnk_small"]
    assert [s["feasibility"]["n_fitted"] for s in dopt.epoch_stats] == [2, 2, 2]


def test_run_options_raise_or_are_ignored():
    """Unknown keywords raise; the reference's distwq keywords and
    compile_cache_dir are accepted and do nothing; return_features=True
    on a run without features gives None in the features' place."""
    with pytest.raises(TypeError, match="bogus_option"):
        dmosopt_tpu_torch.run(_params(), device="cpu", verbose=False, bogus_option=1)
    best = dmosopt_tpu_torch.run(
        _params(opt_id="legacy", n_epochs=1, num_generations=2, n_initial=2,
                population_size=8,
                surrogate_method_kwargs={"n_starts": 1, "n_iter": 5, "seed": 0}),
        device="cpu", verbose=False, compile_cache_dir="unused",
        spawn_workers=True, nprocs_per_worker=4, return_features=True,
    )
    assert len(best[0]) == N_DIM and best[2] is None


def test_archive_queries_need_cuda_unless_the_cpu_is_asked_for(monkeypatch):
    from dmosopt_tpu_torch import moasmo

    x = np.random.default_rng(0).random((10, 3))
    y = np.column_stack([x[:, 0], 1.0 - x[:, 0]])
    assert moasmo.get_duplicates(x, device="cpu").shape == (10,)
    assert moasmo.get_best(x, y, None, None, 3, 2, device="cpu")[0].shape[1] == 3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (
        lambda: moasmo.get_best(x, y, None, None, 3, 2, device=None),
        lambda: moasmo.get_duplicates(x, device=None),
        lambda: moasmo.remove_duplicates(x, y),
        lambda: moasmo.get_feasible(x, y, None, None, 3, 2),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
