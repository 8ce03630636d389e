"""The port's termination criteria against the JAX package's.

Both packages' criteria are fed the same sequence of populations (a
front that closes in on the unit sphere and then stalls, with parameter
rows that settle likewise), one check per generation, as numpy arrays;
each criterion must stop at the same generation with the same
`stop_reasons`. The `create_adaptive_termination` presets are held the
same way. On the epoch loop: an evaluation budget is never overshot,
and a plain `MaximumGenerationTermination` runs the JAX package's
generation count, ``I * (m // I + 1)``.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

# one intra-op thread: the test workers share the machine, and torch's
# default of one thread per core oversubscribes it
torch.set_num_threads(1)

from dmosopt_tpu import adaptive_termination as jax_at
from dmosopt_tpu import hv_termination as jax_hvt
from dmosopt_tpu import moasmo as jax_moasmo
from dmosopt_tpu import termination as jax_t
from dmosopt_tpu.datatypes import OptHistory as JaxOptHistory
from dmosopt_tpu_torch import adaptive_termination as port_at
from dmosopt_tpu_torch import hv_termination as port_hvt
from dmosopt_tpu_torch import moasmo as port_moasmo
from dmosopt_tpu_torch import sampling
from dmosopt_tpu_torch import termination as port_t
from dmosopt_tpu_torch.benchmarks.zdt import zdt1
from dmosopt_tpu_torch.datatypes import OptHistory
from dmosopt_tpu_torch.optimizers.nsga2 import NSGA2

D, N_X, POP = 3, 4, 24
PROBLEM = SimpleNamespace(n_objectives=D, lb=np.zeros(N_X), ub=np.ones(N_X),
                          logger=None)


def _populations(n_gen=300, seed=0):
    """Generation g's (x, y): directions on the sphere scaled by
    1 + 0.5 exp(-g/6), plus noise that fades, so progress stalls."""
    rng = np.random.default_rng(seed)
    v = np.abs(rng.standard_normal((POP, D))) + 0.05
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    x_star = rng.random((POP, N_X))
    for g in range(n_gen):
        scale = 1.0 + 0.5 * np.exp(-g / 6.0)
        noise = np.exp(-g / 4.0)
        y = v * scale + 0.01 * noise * rng.random((POP, D))
        x = np.clip(x_star + 0.1 * noise * rng.standard_normal((POP, N_X)), 0, 1)
        yield g, x, y


def _stop_generation(term, history_cls, n_gen=300, pop_size=POP):
    for g, x, y in _populations(n_gen):
        if term.has_terminated(history_cls(g, g * pop_size, x, y, None)):
            return g, term.stop_reasons()
    return None, term.stop_reasons()


CRITERIA = {
    "max_gen": ("termination", "MaximumGenerationTermination", dict(n_max_gen=35)),
    "parameter_tol": ("termination", "ParameterToleranceTermination",
                      dict(n_last=5, tol=1e-3)),
    "objective_tol": ("termination", "MultiObjectiveToleranceTermination",
                      dict(n_last=5, tol=0.01)),
    "standard": ("termination", "StandardTermination",
                 dict(x_tol=1e-3, f_tol=0.01, n_last=5, n_max_gen=500)),
    "hv_progress": ("hv_termination", "HypervolumeProgressTermination",
                    dict(n_last=5, nth_gen=1, min_generations=5, hv_tol=1e-4)),
    "per_objective": ("adaptive_termination", "PerObjectiveConvergence",
                      dict(n_last=5, nth_gen=1, obj_tol=1e-3)),
    "multiscale": ("adaptive_termination", "MultiScaleStagnationTermination",
                   dict(timescales=(2, 4, 8), nth_gen=1)),
    "adaptive_window": ("adaptive_termination", "AdaptiveWindowTermination",
                        dict(initial_window=4, max_window=10, tol=1e-3)),
    "resource": ("adaptive_termination", "ResourceAwareTermination",
                 dict(max_function_evals=10 * POP)),
}
MODULES = {
    "termination": (jax_t, port_t),
    "hv_termination": (jax_hvt, port_hvt),
    "adaptive_termination": (jax_at, port_at),
}


@pytest.mark.parametrize("name", list(CRITERIA))
def test_each_criterion_stops_where_the_jax_packages_does(name):
    module, cls, kwargs = CRITERIA[name]
    jax_mod, port_mod = MODULES[module]
    want = _stop_generation(getattr(jax_mod, cls)(PROBLEM, **kwargs), JaxOptHistory)
    got = _stop_generation(getattr(port_mod, cls)(PROBLEM, **kwargs), OptHistory)
    assert got == want
    assert want[0] is not None and want[1], want


@pytest.mark.parametrize("strategy", ["fast", "comprehensive", "conservative", "simple"])
def test_the_adaptive_factory_presets_stop_where_the_jax_packages_do(strategy):
    spec = dict(strategy=strategy, n_max_gen=120, max_function_evals=100 * POP)
    want_term = jax_at.create_adaptive_termination(PROBLEM, **spec)
    got_term = port_at.create_adaptive_termination(PROBLEM, **spec)
    assert type(got_term).__name__ == type(want_term).__name__
    assert got_term.eval_budget() == want_term.eval_budget() == 100 * POP
    want = _stop_generation(want_term, JaxOptHistory, n_gen=150)
    got = _stop_generation(got_term, OptHistory, n_gen=150)
    assert got == want and want[0] is not None


def _nsga2(pop=16, dim=4, seed=1):
    bounds = np.stack([np.zeros(dim), np.ones(dim)], axis=1)
    x0 = sampling.lh(2 * pop, dim, seed)
    y0 = zdt1(torch.as_tensor(x0, dtype=torch.float32)).numpy()
    opt = NSGA2(popsize=pop, nInput=dim, nOutput=2, model=None, device="cpu")
    opt.initialize_strategy(x0, y0, bounds, random=seed)
    return opt, x0, y0, bounds


@pytest.mark.parametrize("budget", [130, 160])
def test_the_evaluation_budget_is_never_overshot(budget):
    """Chunks shrink to the whole generations that fit under the budget
    (16 offspring each), and the stop is attributed to the budget."""
    opt, *_ = _nsga2()
    term = port_at.ResourceAwareTermination(PROBLEM, max_function_evals=budget)
    stats = {}
    x, _, counts = port_moasmo._optimize_on_device(
        opt, zdt1, 1000, torch.Generator().manual_seed(0), termination=term,
        termination_check_interval=3, stats=stats,
    )
    assert x.shape[0] == counts.sum() == 16 * (budget // 16) <= budget
    assert stats["n_generations"] == budget // 16
    assert stats["stop_reasons"] == ["ResourceAwareTermination"]
    assert stats["termination_checks"] >= 1 and stats["termination_s"] >= 0.0


def test_maximum_generations_run_the_jax_packages_count():
    """Under a plain MaximumGenerationTermination the port's chunked loop
    runs the JAX package's fused budget, ``I * (m // I + 1)``
    generations, and a collection of the same cap runs the same count."""
    import jax
    from dmosopt_tpu.benchmarks.zdt import zdt1 as jax_zdt1
    from dmosopt_tpu.optimizers.nsga2 import NSGA2 as JaxNSGA2

    for m, interval in ((7, 3), (10, 10), (0, 4)):
        stats = {}
        opt, *_ = _nsga2()
        _, _, got = port_moasmo._optimize_on_device(
            opt, zdt1, 1000, torch.Generator().manual_seed(0),
            termination=port_t.MaximumGenerationTermination(PROBLEM, m),
            termination_check_interval=interval, stats=stats,
        )
        want = jax_moasmo._fused_generation_total(
            jax_t.MaximumGenerationTermination(PROBLEM, m), interval
        )
        assert len(got) == stats["n_generations"] == want == interval * (m // interval + 1)
        assert stats["stop_reasons"] == ["MaximumGenerationTermination"]

    m, interval = 7, 3
    opt, x0, y0, bounds = _nsga2()
    jopt = JaxNSGA2(popsize=16, nInput=4, nOutput=2, model=None)
    jopt.initialize_strategy(x0, y0, bounds, random=1)
    _, _, want = jax_moasmo._optimize_on_device(
        jopt, jax_zdt1, 1000, jax.random.PRNGKey(0),
        termination=jax_t.MaximumGenerationTermination(PROBLEM, m),
        termination_check_interval=interval,
    )
    _, _, got = port_moasmo._optimize_on_device(
        opt, zdt1, 1000, torch.Generator().manual_seed(0),
        termination=port_t.MaximumGenerationTermination(PROBLEM, m),
        termination_check_interval=interval,
    )
    np.testing.assert_array_equal(got, want)
    # a collection with the same cap stops at the same generation
    opt, *_ = _nsga2()
    _, _, chunked = port_moasmo._optimize_on_device(
        opt, zdt1, 1000, torch.Generator().manual_seed(0),
        termination=port_t.TerminationCollection(
            PROBLEM, port_t.MaximumGenerationTermination(PROBLEM, m)),
        termination_check_interval=interval,
    )
    assert len(chunked) == len(got)


def test_criteria_read_a_host_copy_of_the_population():
    """Each check hands the criterion the optimizer's current population
    as numpy arrays, with the generation and evaluation counts; the copy
    time is recorded as part of the check time."""
    seen = []

    class Recorder(port_t.Termination):
        def _do_continue(self, opt):
            seen.append((opt.n_gen, opt.n_eval, opt.x, opt.y))
            return opt.n_gen < 6

    opt, *_ = _nsga2()
    stats = {}
    port_moasmo._optimize_on_device(
        opt, zdt1, 1000, torch.Generator().manual_seed(0),
        termination=Recorder(PROBLEM), termination_check_interval=2, stats=stats,
    )
    assert [(g, e) for g, e, _, _ in seen] == [(g, 16 * g) for g in (0, 2, 4, 6)]
    assert all(isinstance(a, np.ndarray) for _, _, x, y in seen for a in (x, y))
    pop_x, pop_y = opt.get_population_strategy(opt.state)
    np.testing.assert_array_equal(seen[-1][2], pop_x.numpy())
    np.testing.assert_array_equal(seen[-1][3], pop_y.numpy())
    assert stats["termination_checks"] == len(seen) == 4
    assert 0.0 <= stats["termination_wait_s"] <= stats["termination_s"]


def test_hypervolume_criterion_estimates_on_the_runs_device():
    """With 11 objectives the HV criterion leaves the exact path for the
    FPRAS estimator; built by a CPU run's strategy, it estimates on the
    CPU (it would otherwise ask for a card)."""
    from dmosopt_tpu_torch.strategy import DistOptStrategy

    d = 11
    problem = SimpleNamespace(n_objectives=d, lb=np.zeros(N_X), ub=np.ones(N_X),
                              logger=None)
    run = SimpleNamespace(prob=problem, num_generations=50, device="cpu")
    term = DistOptStrategy._build_termination(run, {"strategy": "simple"})
    rng = np.random.default_rng(3)
    y = 1.0 + 0.1 * rng.random((12, d))
    # the first check builds the tracker from the population
    assert not term.has_terminated(OptHistory(0, 0, rng.random((12, N_X)), y, None))
    router = term._mf_tracker.router
    # one coarse estimate (the criterion's own fidelities ask for up to
    # 2e6 samples, too many for a CPU test)
    hv = router.compute(y, term.ref_point, 0.2)
    assert router.last_method == "fpras" and router.last_n_samples > 0
    assert np.isfinite(hv) and hv > 0
    est = next(iter(router._hv_cache.values()))
    assert est.device == "cpu" and est._generator.device.type == "cpu"
