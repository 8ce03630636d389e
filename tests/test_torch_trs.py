"""The port's TRS against the JAX package.

With the JAX package's Sobol digital shift and dimension mask injected, a
generation's candidates agree to 1e-5 (the Sobol points themselves are
bit-equal, `tests/test_torch_sampling.py`). `update_strategy` from a JAX
state carried over through `interop` selects the same survivors (exactly
equal rows and ranks) and leaves the same trust region, success window
and restart flag, on an ordinary step and on the restart branch (a
bottomed-out region reset at the top of the update).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

# one intra-op thread: the test workers share the machine, and torch's
# default of one thread per core oversubscribes it
torch.set_num_threads(1)

from dmosopt_tpu.optimizers import trs as jax_trs
from dmosopt_tpu.sampling import sobol_direction_numbers
from dmosopt_tpu_torch import interop
from dmosopt_tpu_torch.optimizers import trs as port_trs

POP, N_X, D = 16, 5, 3
BOUNDS = np.stack([np.zeros(N_X), np.linspace(1.0, 3.0, N_X)], axis=1)


def _arrays(state):
    return {k: np.array(v) for k, v in state._asdict().items()}


def _port():
    return port_trs.TRS(popsize=POP, nInput=N_X, nOutput=D, model=None, device="cpu")


@pytest.fixture(scope="module")
def jax_trs_case():
    jopt = jax_trs.TRS(popsize=POP, nInput=N_X, nOutput=D, model=None)
    rng = np.random.default_rng(6)
    W = jopt.opt_params.success_window_size
    # a state some generations in, its success window three entries long
    st = jax_trs.TRSState(
        bounds=jnp.asarray(BOUNDS, jnp.float32),
        population_parm=jnp.asarray(rng.random((POP, N_X)) * BOUNDS[:, 1], jnp.float32),
        population_obj=jnp.asarray(rng.random((POP, D)), jnp.float32),
        rank=jnp.asarray(rng.integers(0, 3, POP), jnp.int32),
        tr_length=jnp.float32(0.3), restart=jnp.bool_(False),
        succ_buffer=jnp.zeros(W, jnp.float32).at[:3].set(jnp.asarray([9.0, 2.0, 12.0])),
        succ_count=jnp.int32(3), succ_ptr=jnp.int32(3),
        sobol_sv=jnp.asarray(sobol_direction_numbers(N_X)),
    )
    key = jax.random.PRNGKey(8)
    k_shift, k_mask = jax.random.split(key)
    shift = np.array(jax.random.bits(k_shift, (N_X,), jnp.uint32)).astype(np.int64)
    mask = np.array(jax.random.bernoulli(k_mask, min(20.0 / N_X, 1.0), (N_X,)))
    x_gen, _ = jax.jit(jopt.generate_strategy)(key, st)
    y_gen = rng.random((POP, D)).astype(np.float32) * 0.9
    update = jax.jit(jopt.update_strategy)
    restarting = st._replace(restart=jnp.bool_(True))
    new = {False: _arrays(update(st, x_gen, jnp.asarray(y_gen))),
           True: _arrays(update(restarting, x_gen, jnp.asarray(y_gen)))}
    carried = {False: _arrays(st), True: _arrays(restarting)}
    return carried, shift, mask, np.array(x_gen), y_gen, new


def test_generation_core_with_the_jax_draws_matches_jax(jax_trs_case):
    carried, shift, mask, x_want, _, _ = jax_trs_case
    state = interop.trs_state_from_arrays(carried[False], "cpu")
    x_got = _port()._generate_core(state, torch.as_tensor(shift), torch.as_tensor(mask))
    np.testing.assert_allclose(x_got.numpy(), x_want, rtol=1e-5, atol=1e-6)
    assert not np.allclose(x_want, carried[False]["population_parm"])


@pytest.mark.parametrize("restart", [False, True])
def test_update_strategy_from_a_carried_state_matches_jax(jax_trs_case, restart):
    carried, _, _, x_gen, y_gen, new = jax_trs_case
    want = new[restart]
    got = _port().update_strategy(
        interop.trs_state_from_arrays(carried[restart], "cpu"),
        torch.as_tensor(x_gen), torch.as_tensor(y_gen),
    )
    for name in ("population_parm", "population_obj", "rank", "restart",
                 "succ_count", "succ_ptr"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), want[name], err_msg=name)
    for name in ("tr_length", "succ_buffer"):
        np.testing.assert_allclose(getattr(got, name).numpy(), want[name],
                                   rtol=1e-6, err_msg=name)
    # the restart reset the window: one entry, the region from length_init
    assert int(got.succ_count) == (1 if restart else 4)
