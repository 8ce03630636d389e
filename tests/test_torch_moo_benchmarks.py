"""The port's many-objective benchmark problems against the JAX package's.

Every problem of `benchmarks/moo_benchmarks.py` (DTLZ1-5/7, WFG1/4,
MaF1/2/4) is evaluated by both packages on the same seeded (B, n)
inputs drawn uniformly inside the problem's own space, at 3 and 5
objectives, in float32; the values agree to rtol 1e-5 (atol 1e-6). A
single (n,) point gives the (n_obj,) row of the batch. The problem
spaces, the problem table and the metadata are equal.
"""

import numpy as np
import pytest
import torch

# one intra-op thread: the test workers share the machine, and torch's
# default of one thread per core oversubscribes it
torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from dmosopt_tpu.benchmarks import moo_benchmarks as jax_mb
from dmosopt_tpu_torch.benchmarks import moo_benchmarks as port_mb

B = 16


def _inputs(name, n_obj, seed=0):
    space = port_mb.generate_problem_space(name, n_obj)
    lo, hi = np.array(list(space.values()), dtype=np.float64).T
    rng = np.random.default_rng(seed)
    x = lo + (hi - lo) * rng.random((B, len(space)))
    # the box's corners too: DTLZ/WFG transitions sit at the bounds
    x[0], x[1] = lo, hi
    return x.astype(np.float32)


@pytest.mark.parametrize("n_obj", [3, 5])
@pytest.mark.parametrize("name", sorted(port_mb.PROBLEMS))
def test_problem_values_match_the_jax_package(name, n_obj):
    x = _inputs(name, n_obj)
    # one compiled program per problem (eager dispatch would compile each
    # primitive on its own)
    want = np.asarray(jax.jit(jax_mb.get_problem(name, n_obj))(jnp.asarray(x)))
    got = port_mb.get_problem(name, n_obj)(torch.as_tensor(x)).numpy()
    assert got.shape == want.shape == (B, n_obj) and got.dtype == np.float32
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    one = port_mb.get_problem(name, n_obj)(torch.as_tensor(x[2])).numpy()
    assert one.shape == (n_obj,)
    np.testing.assert_array_equal(one, got[2])


def test_spaces_table_and_metadata_match_the_jax_package():
    assert sorted(port_mb.PROBLEMS) == sorted(jax_mb.PROBLEMS)
    for name in port_mb.PROBLEMS:
        for n_obj in (3, 5, 8):
            for n_var in (None, 12):
                assert port_mb.generate_problem_space(
                    name, n_obj, n_var
                ) == jax_mb.generate_problem_space(name, n_obj, n_var)
            assert port_mb.get_problem_metadata(
                name, n_obj
            ) == jax_mb.get_problem_metadata(name, n_obj)
