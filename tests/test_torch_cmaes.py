"""The port's MO-CMA-ES against the JAX package.

The batched rank-1 Cholesky update is float32 products in another
order: allclose at 1e-5, and A_new A_new^T and Ainv_new A_new hold the
update's invariants. With the JAX package's parent picks and normal
draws injected, a generation's offspring agree to 1e-5; `update_strategy`
from a JAX state carried over through `interop` selects the same
survivors (exactly equal rows and ranks) with allclose strategy
parameters (rtol 1e-5).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

# one intra-op thread: the test workers share the machine, and torch's
# default of one thread per core oversubscribes it
torch.set_num_threads(1)

from dmosopt_tpu.optimizers import cmaes as jax_cmaes
from dmosopt_tpu_torch import interop
from dmosopt_tpu_torch.optimizers import cmaes as port_cmaes

POP, N_X, D = 16, 4, 2
BOUNDS = np.stack([np.zeros(N_X), np.ones(N_X)], axis=1)


def _spd_factors(B, n, seed):
    rng = np.random.default_rng(seed)
    A = np.stack([np.linalg.cholesky(
        (lambda M: M @ M.T + n * np.eye(n))(rng.normal(size=(n, n)))
    ) for _ in range(B)]).astype(np.float32)
    return A, np.linalg.inv(A).astype(np.float32), rng


def test_update_cholesky_batch_matches_jax_and_keeps_invariants():
    B, n, cc, ccov, pthresh = 4, 6, 0.2, 0.3, 0.44
    A, Ainv, rng = _spd_factors(B, n, 5)
    z = rng.normal(size=(B, n)).astype(np.float32)
    pc = rng.normal(size=(B, n)).astype(np.float32)
    psucc = np.array([0.1, 0.9, 0.2, 0.8], np.float32)  # both branches
    want = [np.asarray(a) for a in jax_cmaes._update_cholesky_batch(
        *map(jnp.asarray, (A, Ainv, z, psucc, pc)), cc, ccov, pthresh)]
    got = [a.numpy() for a in port_cmaes._update_cholesky_batch(
        *map(torch.as_tensor, (A, Ainv, z, psucc, pc)), cc, ccov, pthresh)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    A2, Ainv2, pc2 = got
    alpha = np.where(psucc < pthresh, 1 - ccov, (1 - ccov) + ccov * cc * (2 - cc))
    for b in range(B):
        C_new = A2[b] @ A2[b].T
        C_expect = alpha[b] * (A[b] @ A[b].T) + ccov * np.outer(pc2[b], pc2[b])
        np.testing.assert_allclose(C_new, C_expect, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(Ainv2[b] @ A2[b], np.eye(n), atol=2e-3)


def _jax_state(jopt, seed):
    """A JAX state some generations in: spread sigmas, factors and
    success rates, so every branch of the update is live."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    A, Ainv, _ = _spd_factors(POP, N_X, seed)
    return jax_cmaes.CMAESState(
        bounds=f32(BOUNDS), parents_x=f32(rng.random((POP, N_X))),
        parents_y=f32(rng.random((POP, D))),
        sigmas=f32(rng.uniform(0.01, 0.05, (POP, N_X))),
        A=jnp.asarray(A), Ainv=jnp.asarray(Ainv),
        pc=f32(rng.normal(size=(POP, N_X)) * 0.1),
        psucc=f32(rng.uniform(0.05, 0.9, POP)),
        rank=jnp.asarray(rng.integers(0, 4, POP), jnp.int32),
        gen_pidx=jnp.zeros(jopt.n_offspring, jnp.int32),
    )


def _arrays(state):
    return {k: np.array(v) for k, v in state._asdict().items()}


@pytest.fixture(scope="module")
def jax_generation():
    """One JAX generation, its update compiled once: the state, the
    draws of ``generate_strategy``, the offspring and the next state."""
    jopt = jax_cmaes.CMAES(popsize=POP, nInput=N_X, nOutput=D, model=None)
    st = _jax_state(jopt, 3)
    key = jax.random.PRNGKey(11)
    k_pick, k_z = jax.random.split(key)
    js = np.array(jax.random.randint(k_pick, (jopt.n_offspring,), 0, jopt.opt_params.mu))
    z = np.array(jax.random.normal(k_z, (jopt.n_offspring, N_X), jnp.float32))
    x_gen, st_gen = jax.jit(jopt.generate_strategy)(key, st)
    y_gen = np.random.default_rng(4).random((jopt.n_offspring, D)).astype(np.float32)
    new = jax.jit(jopt.update_strategy)(st_gen, x_gen, jnp.asarray(y_gen))
    return st, js, z, np.array(x_gen), _arrays(st_gen), y_gen, _arrays(new)


def test_generation_core_with_the_jax_draws_matches_jax(jax_generation):
    st, js, z, x_want, st_gen, _, _ = jax_generation
    topt = port_cmaes.CMAES(popsize=POP, nInput=N_X, nOutput=D, model=None, device="cpu")
    tstate = interop.cmaes_state_from_arrays(_arrays(st), "cpu")
    x_got, tgen = topt._generate_core(tstate, torch.as_tensor(js).long(), torch.as_tensor(z))
    np.testing.assert_allclose(x_got.numpy(), x_want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(tgen.gen_pidx.numpy(), st_gen["gen_pidx"])


def test_update_strategy_from_a_carried_state_matches_jax(jax_generation):
    _, _, _, x_gen, st_gen, y_gen, want = jax_generation
    topt = port_cmaes.CMAES(popsize=POP, nInput=N_X, nOutput=D, model=None, device="cpu")
    got = topt.update_strategy(
        interop.cmaes_state_from_arrays(st_gen, "cpu"),
        torch.as_tensor(x_gen), torch.as_tensor(y_gen),
    )
    for name in ("parents_x", "parents_y", "rank"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), want[name], err_msg=name)
    for name in ("sigmas", "A", "Ainv", "pc", "psucc"):
        np.testing.assert_allclose(getattr(got, name).numpy(), want[name],
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_cmaes_needs_cuda_unless_the_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_cmaes.CMAES(popsize=POP, nInput=N_X, nOutput=D)
