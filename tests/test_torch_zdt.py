"""The port's ZDT problems and sampled fronts against the JAX package's:
objectives within rtol 1e-6 on the same float32 inputs (including the
f1 = 0 and f1 = 1 edges), fronts equal as numpy arrays."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

# one intra-op thread: the test workers share the machine, and torch's
# default of one thread per core oversubscribes it
torch.set_num_threads(1)

from dmosopt_tpu.benchmarks import zdt as JZ
from dmosopt_tpu_torch.benchmarks import zdt as TZ


@pytest.mark.parametrize("name", ["zdt1", "zdt2", "zdt3"])
def test_objective_matches_jax(name):
    X = np.random.default_rng(1).random((32, 30)).astype(np.float32)
    X[0, 0], X[1, 0] = 0.0, 1.0
    want = np.asarray(getattr(JZ, name)(jnp.asarray(X)))
    got = getattr(TZ, name)(torch.as_tensor(X)).numpy()
    assert got.shape == (32, 2)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ["zdt1_pareto", "zdt2_pareto", "zdt3_pareto"])
def test_front_matches_jax(name):
    for n in (50, 500):
        np.testing.assert_array_equal(getattr(TZ, name)(n), getattr(JZ, name)(n))
