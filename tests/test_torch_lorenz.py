"""The port's Lorenz objectives against ``examples/example_lorenz.py``.

The trajectories are chaotic, so the two float32 integrators agree only
over a short horizon: at 100 RK4 steps within rtol 1e-5, atol 1e-4 (the
states reach about 60). The objectives built on them (the example's
per-axis errors and the bench's error and prior) agree at that horizon
within 1e-4. The true parameters read exactly 0 at the full horizon,
because the target comes from the same integrator in the same batch.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import jax.numpy as jnp
import torch

# one intra-op thread: the test workers share the machine, and torch's
# default of one thread per core oversubscribes it
torch.set_num_threads(1)

from dmosopt_tpu_torch.benchmarks import lorenz

STEPS, SKIP = 100, 20


@pytest.fixture(scope="module")
def example():
    path = Path(__file__).resolve().parents[1] / "examples" / "example_lorenz.py"
    spec = importlib.util.spec_from_file_location("example_lorenz", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _params(n=8, seed=0):
    """(n, 3) parameter sets in (sigma, rho, beta) order inside the
    example's box."""
    rng = np.random.default_rng(seed)
    return np.column_stack([rng.uniform(5, 15, n), rng.uniform(15, 35, n),
                            rng.uniform(1, 10, n)]).astype(np.float32)


def _reference(example, P):
    """The example's trajectories of P and of the true parameters over
    the short horizon, sampled as the objectives sample them."""
    traj = np.stack([np.asarray(example.integrate_lorenz(jnp.asarray(p), STEPS))
                     for p in P])
    target = np.asarray(example.integrate_lorenz(example.TRUE_P, STEPS))
    return traj, traj[:, SKIP::lorenz.STRIDE], target[SKIP::lorenz.STRIDE]


def test_rk4_and_objectives_match_the_example(example):
    P = _params()
    traj, sampled, target = _reference(example, P)
    got = lorenz.integrate_lorenz(torch.as_tensor(P), STEPS, skip=0, stride=1)
    np.testing.assert_allclose(got.numpy(), traj, rtol=1e-5, atol=1e-4)

    # the example's objective takes (b, r, s) columns
    want3 = np.abs(sampled - target).mean(axis=1)
    got3 = lorenz.lorenz_objectives(torch.as_tensor(P[:, ::-1].copy()), STEPS, SKIP)
    np.testing.assert_allclose(got3.numpy(), want3, atol=1e-4)
    # the bench's: mean error over samples and axes, squared distance
    want2 = np.column_stack([
        np.abs(sampled - target).mean(axis=(1, 2)),
        ((P - np.asarray(example.TRUE_P)) ** 2).sum(axis=1),
    ])
    got2 = lorenz.lorenz_error_prior(torch.as_tensor(P), STEPS, SKIP)
    np.testing.assert_allclose(got2.numpy(), want2, rtol=1e-5, atol=1e-4)


def test_true_parameters_read_zero():
    P = np.vstack([[8.0 / 3.0, 28.0, 10.0], _params(1)[0, ::-1]]).astype(np.float32)
    y = lorenz.lorenz_objectives(torch.as_tensor(P)).numpy()
    assert y.shape == (2, 3)
    np.testing.assert_array_equal(y[0], 0.0)
    assert (y[1] > 0.1).all()
    y2 = lorenz.lorenz_error_prior(torch.as_tensor(P[:, ::-1].copy()), STEPS, SKIP)
    np.testing.assert_array_equal(y2.numpy()[0], 0.0)
