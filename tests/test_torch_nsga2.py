"""The port's NSGA-II against the JAX package, and the ZDT1 oracle.

State parity: a JAX `NSGA2State` is carried over through `interop`, both
packages apply `update_strategy` to the same offspring, and the
survivors, their order and their ranks must be exactly equal on
tie-free data (survival is a sort; the float32 crowding distances that
break rank ties are the same sums in the same order). The adaptive
operator rates and population size are float32 state updated by the
same formulas (rtol 1e-6). The oracle is a port of
tests/test_nsga2_zdt1.py::test_nsga2_converges_on_zdt1.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

# one intra-op thread: the test workers share the machine, and torch's
# default of one thread per core oversubscribes it
torch.set_num_threads(1)

from dmosopt_tpu.optimizers.nsga2 import NSGA2 as JNSGA2
from dmosopt_tpu_torch import interop, sampling
from dmosopt_tpu_torch.benchmarks.zdt import distance_to_front, zdt1, zdt1_pareto
from dmosopt_tpu_torch.moasmo import _optimize_on_device
from dmosopt_tpu_torch.optimizers.base import run_ea_loop
from dmosopt_tpu_torch.optimizers.nsga2 import NSGA2


def _population(n_rows, n, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.random((n_rows, n)).astype(np.float32),
            rng.random((n_rows, d)).astype(np.float32))


OPTIONS = [
    {},
    {"distance_metric": None},
    {"adaptive_operator_rates": True},
    {"adaptive_population_size": True, "min_population_size": 8,
     "max_population_size": 64},
]


@pytest.mark.parametrize("options", OPTIONS)
def test_initialize_and_update_match_jax(options):
    pop, n, d = 40, 6, 2
    x0, y0 = _population(70, n, d, seed=1)
    bounds = np.stack([np.zeros(n), np.ones(n)], axis=1)
    jopt = JNSGA2(popsize=pop, nInput=n, nOutput=d, model=None, **options)
    jstate = jopt.initialize_strategy(x0, y0, bounds, random=0)
    topt = NSGA2(popsize=pop, nInput=n, nOutput=d, model=None, device="cpu", **options)
    tstate = topt.initialize_strategy(x0, y0, bounds, random=0)
    np.testing.assert_array_equal(tstate.population_parm.numpy(),
                                  np.asarray(jstate.population_parm))
    np.testing.assert_array_equal(tstate.rank.numpy(), np.asarray(jstate.rank))

    # carry the JAX state over, with operator tags and counters that the
    # adaptive-rate update reads
    rng = np.random.default_rng(2)
    is_x = rng.random(pop // 2) < 0.8
    jstate = jstate._replace(
        last_is_crossover=jnp.asarray(np.concatenate([is_x, is_x])),
        total_crossovers=jnp.float32(is_x.sum()),
        total_mutations=jnp.float32(2 * (~is_x).sum()),
        n_active=jnp.int32(pop - 4) if options.get("adaptive_population_size")
        else jstate.n_active,
    )
    tstate = interop.nsga2_state_from_arrays(
        {k: np.asarray(v) for k, v in jstate._asdict().items()}, "cpu"
    )
    x_gen, y_gen = _population(pop, n, d, seed=3)
    want = jax.jit(jopt.update_strategy)(jstate, jnp.asarray(x_gen), jnp.asarray(y_gen))
    got = topt.update_strategy(tstate, torch.as_tensor(x_gen), torch.as_tensor(y_gen))
    for name in ("population_parm", "population_obj", "rank", "n_active",
                 "last_is_crossover"):
        np.testing.assert_array_equal(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name
        )
    for name in ("di_crossover", "di_mutation", "crossover_prob",
                 "mutation_prob", "mutation_rate", "successful_crossovers",
                 "total_crossovers"):
        np.testing.assert_allclose(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)),
            rtol=1e-6, err_msg=name,
        )


def _zdt1_setup(popsize, dim, seed, **options):
    bounds = np.stack([np.zeros(dim), np.ones(dim)], axis=1)
    x0 = sampling.lh(popsize * 2, dim, seed)
    y0 = zdt1(torch.as_tensor(x0)).numpy()
    opt = NSGA2(popsize=popsize, nInput=dim, nOutput=2, model=None,
                device="cpu", **options)
    opt.initialize_strategy(x0, y0, bounds, random=seed)
    return opt


def test_nsga2_converges_on_zdt1():
    opt = _zdt1_setup(100, 30, seed=1)
    state = run_ea_loop(opt, opt.state, torch.Generator().manual_seed(2), 300, zdt1)
    y = state.population_obj.numpy()
    dists = distance_to_front(y, zdt1_pareto(1000))
    assert int((dists <= 0.01).sum()) >= 30, int((dists <= 0.01).sum())
    on = y[dists <= 0.01]
    assert on[:, 0].max() - on[:, 0].min() > 0.5


def test_generate_emits_pop_offspring_in_bounds():
    opt = _zdt1_setup(50, 10, seed=3, adaptive_operator_rates=True)
    x_gen, state = opt.generate()
    assert x_gen.shape == (50, 10)
    assert bool((x_gen >= 0).all()) and bool((x_gen <= 1).all())
    assert float(state.total_crossovers) + float(state.total_mutations) / 2 == 25
    opt.update(x_gen, zdt1(x_gen), state)
    assert np.isfinite(float(opt.state.crossover_prob))


def test_adaptive_population_grows_its_capacity():
    """Low diversity grows the live size to the capacity; the host then
    doubles the capacity between generation chunks. Two identical
    objectives make every population a dominance chain (one point on
    front 0), the lowest diversity there is."""
    opt = _zdt1_setup(16, 6, seed=4, adaptive_population_size=True,
                      min_population_size=8, max_population_size=64)

    def chain(x):
        s = x.sum(dim=1)
        return torch.stack([s, s], dim=1)

    x, y, counts = _optimize_on_device(
        opt, chain, 30, torch.Generator().manual_seed(5),
        termination_check_interval=5,
    )
    assert opt.capacity > 16
    assert x.shape[0] == y.shape[0] == counts.sum() and len(counts) == 30
    px, py = opt.get_population_strategy(opt.state)
    assert px.shape[0] == int(opt.state.n_active) <= opt.capacity
