"""The port's SMPSO against the JAX package.

With the JAX package's draws injected (the turbulence picks and mutation
uniforms of ``generate_strategy``; the velocity draws and leader picks
that its ``update_strategy`` folds from the state), a generation's
offspring and velocities agree to 1e-5, and `update_strategy` from a JAX
state carried over through `interop` keeps the same survivors in every
swarm (exactly equal rows and ranks). A generation calls the mutation
operator once, on all swarms' (S·P, n) parents: one kernel launch on a
card.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

# one intra-op thread: the test workers share the machine, and torch's
# default of one thread per core oversubscribes it
torch.set_num_threads(1)

from dmosopt_tpu.optimizers import smpso as jax_smpso
from dmosopt_tpu_torch import interop
from dmosopt_tpu_torch.ops import variation
from dmosopt_tpu_torch.optimizers import smpso as port_smpso

S, POP, N_X, D = 5, 12, 4, 2
BOUNDS = np.stack([np.zeros(N_X), np.ones(N_X)], axis=1)


def _velocity_draws(state):
    """The velocity draws and leader picks the JAX package's
    ``update_strategy`` derives from ``state`` (``smpso.py:177-190``)."""
    key = jax.random.fold_in(
        jax.random.PRNGKey(0), (state.successful_children + 1).astype(jnp.int32)
    )
    key = jax.random.fold_in(key, jnp.sum(state.rank))
    draws, leaders = [], []
    for k in jax.random.split(key, S):
        kr, kl = jax.random.split(k)
        r1, r2 = jax.random.uniform(kr, (2,))
        w = jax.random.uniform(jax.random.fold_in(kr, 1), (), minval=0.1, maxval=0.5)
        c1 = jax.random.uniform(jax.random.fold_in(kr, 2), (), minval=1.5, maxval=2.5)
        c2 = jax.random.uniform(jax.random.fold_in(kr, 3), (), minval=1.5, maxval=2.5)
        draws.append([r1, r2, w, c1, c2])
        leaders.append(np.array(jax.random.randint(kl, (2,), 0, POP)))
    return np.array(draws, np.float32), np.array(leaders, np.int64)


def _arrays(state):
    return {k: np.array(v) for k, v in state._asdict().items()}


@pytest.fixture(scope="module")
def jax_generation():
    """One JAX generation from a seeded state (both steps compiled once)
    and the draws both of its steps consume."""
    jopt = jax_smpso.SMPSO(popsize=POP, nInput=N_X, nOutput=D, model=None)
    rng = np.random.default_rng(1)
    f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    st = jax_smpso.SMPSOState(
        population_parm=f32(rng.random((S, POP, N_X))),
        population_obj=f32(rng.random((S, POP, D))),
        rank=jnp.asarray(rng.integers(0, 4, (S, POP)), jnp.int32),
        velocity=f32(rng.uniform(-0.2, 0.2, (S, POP, N_X))),
        bounds=f32(BOUNDS), di_mutation=f32(np.full(N_X, 20.0)),
        mutation_rate=f32(1.0 / N_X), successful_children=f32(7.0),
    )
    key = jax.random.PRNGKey(9)
    k_pick, k_mut = jax.random.split(key)
    pick = np.array(jax.random.randint(k_pick, (S, POP), 0, POP))
    u = np.concatenate([
        np.array(jax.random.uniform(k, (POP, N_X), jnp.float32))
        for k in jax.random.split(k_mut, S)
    ])
    x_gen, _ = jax.jit(jopt.generate_strategy)(key, st)
    y_gen = rng.random((2 * S * POP, D)).astype(np.float32)
    new = jax.jit(jopt.update_strategy)(st, x_gen, jnp.asarray(y_gen))
    draws, leaders = _velocity_draws(st)
    carried = dict(_arrays(st), draws=draws, leaders=leaders)
    return carried, pick, u, np.array(x_gen), y_gen, _arrays(new)


def _port():
    return port_smpso.SMPSO(popsize=POP, nInput=N_X, nOutput=D, model=None, device="cpu")


def test_generation_core_with_the_jax_draws_matches_jax(jax_generation):
    carried, pick, u, x_want, _, _ = jax_generation
    state = interop.smpso_state_from_arrays(carried, "cpu")
    x_got = _port()._generate_core(state, torch.as_tensor(pick).long(), torch.as_tensor(u))
    np.testing.assert_allclose(x_got.numpy(), x_want, rtol=1e-5, atol=1e-6)


def test_update_strategy_from_a_carried_state_matches_jax(jax_generation):
    carried, _, _, x_gen, y_gen, want = jax_generation
    got = _port().update_strategy(
        interop.smpso_state_from_arrays(carried, "cpu"),
        torch.as_tensor(x_gen), torch.as_tensor(y_gen),
    )
    for name in ("population_parm", "population_obj", "rank", "successful_children"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), want[name], err_msg=name)
    np.testing.assert_allclose(got.velocity.numpy(), want["velocity"],
                               rtol=1e-5, atol=1e-6)
    # the velocity must have moved off the carried one for the check to bite
    assert not np.allclose(want["velocity"], carried["velocity"])


def test_a_generation_mutates_every_swarm_in_one_call(monkeypatch):
    calls = []

    def counting(u, parents, *args):
        calls.append(tuple(parents.shape))
        return variation._mutation_core(u, parents, *args)

    monkeypatch.setattr(port_smpso, "mutation", counting)
    opt = _port()
    rng = np.random.default_rng(3)
    opt.initialize_strategy(rng.random((S * POP, N_X)), rng.random((S * POP, D)),
                            BOUNDS, random=4)
    x_gen, _ = opt.generate()
    assert calls == [(S * POP, N_X)]
    assert x_gen.shape == (2 * S * POP, N_X) == (opt.n_offspring(), N_X)


def test_adaptive_population_size_raises():
    with pytest.raises(NotImplementedError):
        port_smpso.SMPSO(popsize=POP, nInput=N_X, nOutput=D, device="cpu",
                         adaptive_population_size=True)
