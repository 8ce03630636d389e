"""The port's AGE-MOEA against the JAX package, and the direct-EA oracle.

Environmental selection is a sort on (rank, -survival score); the
survival scores come from a greedy max-min spread whose picks one float32
ulp could flip, so the fronts here are spread points of the DTLZ2 sphere
(greedy margins far above 1e-4). On the same inputs the selected set,
the survivor order ``perm[:pop]`` and the ranks must be exactly equal,
and the survival scores allclose (rtol 1e-5, infinities equal). State
parity carries a JAX `AGEMOEAState` over through `interop`. The oracle is
a port of tests/test_optimizers.py::test_agemoea_improves_and_is_scannable.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

# one intra-op thread: the test workers share the machine, and torch's
# default of one thread per core oversubscribes it
torch.set_num_threads(1)

from dmosopt_tpu.optimizers import agemoea as jax_age
from dmosopt_tpu_torch import interop, sampling
from dmosopt_tpu_torch.benchmarks.zdt import distance_to_front, zdt1, zdt1_pareto
from dmosopt_tpu_torch.optimizers import agemoea as port_age
from dmosopt_tpu_torch.optimizers.base import run_ea_loop

N, N_X = 40, 6


def _fronts(d, seed):
    """(x, y) of N rows: half on the unit sphere's positive orthant (one
    front), half the same directions pushed out by 5-60% (later fronts),
    with two duplicated parameter rows."""
    rng = np.random.default_rng(seed)
    v = np.abs(rng.standard_normal((N, d))) + 0.05
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    r = np.ones(N)
    r[N // 2:] += rng.uniform(0.05, 0.6, N // 2)
    y = (v * r[:, None]).astype(np.float32)
    x = rng.random((N, N_X)).astype(np.float32)
    x[[7, 31]] = x[[3, 12]]
    return x, y


def _jax_selection():
    # compiled once per shape (a new wrapper re-reads the module constants)
    return jax.jit(jax_age.environmental_selection, static_argnames=("pop",))


_jax_select = _jax_selection()


def _select_both(x, y, mask, jax_select=_jax_select):
    pop = N // 2
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.as_tensor(mask)
    want = [np.asarray(a) for a in jax_select(
        jnp.asarray(x), jnp.asarray(y), pop=pop, mask=jm)]
    got = [t.numpy() for t in port_age.environmental_selection(
        torch.as_tensor(x), torch.as_tensor(y), pop, mask=tm)]
    return pop, want, got


def _assert_selection_equal(pop, want, got):
    (jp, jr, jc), (tp, tr, tc) = want, got
    assert set(tp[:pop]) == set(jp[:pop])
    np.testing.assert_array_equal(tp[:pop], jp[:pop])
    np.testing.assert_array_equal(tr, jr)
    np.testing.assert_allclose(tc, jc, rtol=1e-5)


@pytest.mark.parametrize("d, masked", [(3, False), (5, False), (5, True)])
def test_environmental_selection_matches_jax(d, masked):
    x, y = _fronts(d, seed=d)
    mask = np.random.default_rng(5).random(N) < 0.85 if masked else None
    pop, want, got = _select_both(x, y, mask)
    _assert_selection_equal(pop, want, got)
    # the duplicated rows are out, and the corner solutions score inf
    assert np.isneginf(got[2][[7, 31]]).all()
    assert np.isinf(got[2]).sum() >= d + 2


def test_on_demand_columns_match_jax_and_the_dense_matrix(monkeypatch):
    """Above `_DENSE_SURVIVAL_MAX` candidates each greedy step computes
    its distance column on demand; with the ceiling patched low in both
    packages the two agree, and the port's two regimes agree."""
    x, y = _fronts(4, seed=11)
    _, _, dense = _select_both(x, y, None)
    monkeypatch.setattr(jax_age, "_DENSE_SURVIVAL_MAX", 8)
    monkeypatch.setattr(port_age, "_DENSE_SURVIVAL_MAX", 8)
    pop, want, got = _select_both(x, y, None, jax_select=_jax_selection())
    _assert_selection_equal(pop, want, got)
    _assert_selection_equal(pop, dense, got)


@pytest.mark.parametrize("options", [
    {}, {"adaptive_population_size": True, "min_population_size": 8,
         "max_population_size": 64},
])
def test_update_strategy_from_a_carried_state_matches_jax(options):
    pop, d = 20, 3
    x0, y0 = _fronts(d, seed=2)
    bounds = np.stack([np.zeros(N_X), np.ones(N_X)], axis=1)
    jopt = jax_age.AGEMOEA(popsize=pop, nInput=N_X, nOutput=d, model=None, **options)
    perm, rank, crowd = _jax_select(jnp.asarray(x0), jnp.asarray(y0), pop=pop)
    keep = np.asarray(perm)[:pop]
    jstate = jax_age.AGEMOEAState(
        population_parm=jnp.asarray(x0[keep]), population_obj=jnp.asarray(y0[keep]),
        rank=rank[keep], crowd_dist=crowd[keep], bounds=jnp.asarray(bounds, jnp.float32),
        n_active=jnp.int32(pop),
    )
    topt = port_age.AGEMOEA(popsize=pop, nInput=N_X, nOutput=d, model=None,
                            device="cpu", **options)
    tstate = topt.initialize_strategy(x0, y0, bounds, random=0)
    for name in ("population_parm", "rank", "n_active"):
        np.testing.assert_array_equal(getattr(tstate, name).numpy(),
                                      np.asarray(getattr(jstate, name)))

    if options:
        jstate = jstate._replace(n_active=jnp.int32(pop - 3))
    tstate = interop.agemoea_state_from_arrays(
        {k: np.asarray(v) for k, v in jstate._asdict().items()}, "cpu"
    )
    x_gen, y_gen = _fronts(d, seed=3)
    x_gen, y_gen = x_gen[:pop], y_gen[:pop] * 0.98
    want = jax.jit(jopt.update_strategy)(jstate, jnp.asarray(x_gen), jnp.asarray(y_gen))
    got = topt.update_strategy(tstate, torch.as_tensor(x_gen), torch.as_tensor(y_gen))
    for name in ("population_parm", "population_obj", "rank", "n_active"):
        np.testing.assert_array_equal(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name
        )
    np.testing.assert_allclose(got.crowd_dist.numpy(), np.asarray(want.crowd_dist),
                               rtol=1e-5)


DIM, POP = 10, 48


def test_agemoea_improves_on_zdt1():
    """The reference package's direct-EA oracle, on the port."""
    bounds = np.stack([np.zeros(DIM), np.ones(DIM)], 1)
    front = zdt1_pareto(400)
    x0 = sampling.lh(POP, DIM, 42)
    y0 = zdt1(torch.as_tensor(x0, dtype=torch.float32)).numpy()
    opt = port_age.AGEMOEA(popsize=POP, nInput=DIM, nOutput=2, model=None,
                           device="cpu")
    opt.initialize_strategy(x0, y0, bounds, random=1)
    d0 = float(np.mean(distance_to_front(opt.state.population_obj.numpy(), front)))
    st = run_ea_loop(opt, opt.state, torch.Generator().manual_seed(3), 60, zdt1)
    d1 = float(np.mean(distance_to_front(st.population_obj.numpy(), front)))
    assert d1 < d0 * 0.2, (d0, d1)
    # survival scores: extremes get inf, others finite positive
    assert np.isinf(st.crowd_dist.numpy()).sum() >= 2
    x_gen, _ = opt.generate_strategy(torch.Generator().manual_seed(4), st)
    assert x_gen.shape == (POP, DIM)
    assert bool((x_gen >= 0).all()) and bool((x_gen <= 1).all())
