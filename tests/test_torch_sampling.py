"""The port's GLP and Sobol designs, and `xinit`'s default, against the
JAX package.

Sobol: the scrambled design is scipy's with the same numpy Generator,
and `sobol_block` gets the shift bits the JAX package drew from its key,
so both must be bit-for-bit the JAX package's.

GLP builds candidate lattices with numpy (the port's copy of the
reference's code) and keeps the one of least centered L2 discrepancy.
The candidates must be bit-for-bit the JAX package's. The pick cannot
be: the best lattices come in sets that are reflections or column
permutations of each other, whose CD2 is exactly equal, and the JAX
package's float32 scores break such a tie by rounding noise (their
error exceeds the gap to the next lattice by orders of magnitude). The
port scores in float64 and takes the first of the tied set; the test
holds the JAX package's pick to the same set (float64 CD2 equal to
rtol 1e-10; distinct lattices differ by more than 1e-5 relative).
"""

import numpy as np
import pytest
import torch

# one intra-op thread: the test workers share the machine, and torch's
# default of one thread per core oversubscribes it
torch.set_num_threads(1)

from dmosopt_tpu import moasmo as JM
from dmosopt_tpu import sampling as JS
from dmosopt_tpu_torch import moasmo as TM
from dmosopt_tpu_torch import sampling as TS
from dmosopt_tpu_torch.discrepancy import CD2


def _cd2_64(x):
    return CD2(torch.as_tensor(x, dtype=torch.float64)).numpy()


def _candidates(module, monkeypatch, n, s):
    """``module``'s GLP design for (n, s) and the candidates it scored."""
    seen = []
    score_and_pick = module._score_and_pick
    monkeypatch.setattr(
        module, "_score_and_pick", lambda d: seen.append(d) or score_and_pick(d)
    )
    design = module.GoodLatticePointsDesign(n, s, 0)
    monkeypatch.setattr(module, "_score_and_pick", score_and_pick)
    (designs,) = seen
    return design, designs


# (n, s) covering GLP's branches (sampling.py:218-236): totative
# combinations, power generating vectors, each with and without n+1
@pytest.mark.parametrize(
    "n,s", [(13, 3), (31, 5), (12, 3), (40, 5)],
    ids=["small", "power", "small-n+1", "power-n+1"],
)
def test_glp_scores_the_jax_candidates_and_picks_from_the_same_tie(n, s, monkeypatch):
    want, want_designs = _candidates(JS, monkeypatch, n, s)
    got, got_designs = _candidates(TS, monkeypatch, n, s)
    np.testing.assert_array_equal(got_designs, want_designs)

    scores = _cd2_64(got_designs)
    best = scores.min()
    tie = np.nonzero(scores <= best * (1 + 1e-10))[0]
    assert len(tie) < len(scores)  # the score separates the lattices
    np.testing.assert_array_equal(got, got_designs[tie[0]])
    np.testing.assert_allclose(_cd2_64(want), best, rtol=1e-10)
    assert any(np.array_equal(want, got_designs[i]) for i in tie)


@pytest.mark.parametrize("n_eval,n_in", [(8, 5), (4, 3)])
def test_xinit_defaults_to_the_jax_packages_glp_design(n_eval, n_in, monkeypatch):
    """Unpatched, the JAX package's GLP lattice (``maxiter=0``: no
    de-correlation) is one of the port's tied set, and the port's is the
    first of it. With default arguments, `xinit` returns exactly the JAX
    package's design once both break GLP's tie the same way: the JAX
    package's scoring is pinned to the first of the tied set, as the
    port's is."""
    names = [f"x{i}" for i in range(n_in)]
    xlb = np.linspace(-1.0, 0.0, n_in)
    xub = np.linspace(1.0, 3.0, n_in)
    _, designs = _candidates(TS, monkeypatch, n_eval * n_in, n_in)
    scores = _cd2_64(designs)
    tie = np.nonzero(scores <= scores.min() * (1 + 1e-10))[0]
    tied = [designs[i] * (xub - xlb) + xlb for i in tie]
    lattice = JM.xinit(n_eval, names, xlb, xub, maxiter=0)
    assert any(np.array_equal(lattice, d) for d in tied)
    np.testing.assert_array_equal(TM.xinit(n_eval, names, xlb, xub, maxiter=0), tied[0])

    monkeypatch.setattr(JS, "_score_and_pick", TS._score_and_pick)
    want = JM.xinit(n_eval, names, xlb, xub, local_random=np.random.default_rng(3))
    got = TM.xinit(n_eval, names, xlb, xub, local_random=np.random.default_rng(3))
    np.testing.assert_array_equal(got, want)
    assert got.shape == (n_eval * n_in, n_in)


@pytest.mark.parametrize("n, s", [(50, 4), (100, 15)])
def test_sobol_design_is_bit_for_bit_the_jax_packages(n, s):
    want = JS.sobol(n, s, np.random.default_rng(3))
    np.testing.assert_array_equal(TS.sobol(n, s, np.random.default_rng(3)), want)
    # the registry shorthand reaches it through xinit
    names = [f"x{i}" for i in range(s)]
    lb, ub = np.zeros(s), np.full(s, 2.0)
    np.testing.assert_array_equal(
        TM.xinit(4, names, lb, ub, method="sobol", local_random=np.random.default_rng(5)),
        JM.xinit(4, names, lb, ub, method="sobol", local_random=np.random.default_rng(5)),
    )


@pytest.mark.parametrize("dim, n", [(1, 7), (6, 300)])
def test_sobol_block_with_the_jax_shift_bits_is_bit_for_bit(dim, n):
    import jax
    import jax.numpy as jnp

    sv = JS.sobol_direction_numbers(dim)
    np.testing.assert_array_equal(TS.sobol_direction_numbers(dim), sv)
    key = jax.random.PRNGKey(dim)
    want = np.asarray(JS.sobol_block(jnp.asarray(sv), key, n))
    bits = np.asarray(jax.random.bits(key, (dim,), jnp.uint32)).astype(np.int64)
    got = TS.sobol_block(sv, torch.as_tensor(bits), n).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32 and 0.0 <= got.min() and got.max() < 1.0
    shift = TS.sobol_shift(dim, torch.Generator().manual_seed(0))
    assert shift.dtype == torch.int64 and bool(((shift >= 0) & (shift < 2**32)).all())
