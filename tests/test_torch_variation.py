"""The port's variation operators against the JAX package.

Both packages get the same seeded numpy inputs (uniforms included). The
port's plain cores — what a CPU tensor runs, and what the Triton kernels
are held to on the card by chip_smoke.py — must match the JAX dense
cores and the Pallas kernels (interpret mode, as tests/test_ops.py runs
them) to rtol 1e-6 / atol 1e-7: the same float32 arithmetic, with pow
and division rounded by different libraries.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

# one intra-op thread: the test workers share the machine, and torch's
# default of one thread per core oversubscribes it
torch.set_num_threads(1)

from dmosopt_tpu.ops import variation as JV
from dmosopt_tpu_torch.ops import variation as TV

RTOL, ATOL = 1e-6, 1e-7


def _operands(B, n, seed):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    xlb = (-1.0 + 0.5 * rng.random(n)).astype(f32)
    xub = (1.0 + rng.random(n)).astype(f32)
    span = xub - xlb
    p1 = (xlb + span * rng.random((B, n))).astype(f32)
    p2 = (xlb + span * rng.random((B, n))).astype(f32)
    u = rng.random((B, n), dtype=f32)
    return u, p1, p2, xlb, xub


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


@pytest.mark.parametrize("B,n,di", [(16, 5, 15.0), (100, 30, 20.0)])
def test_mutation_core_matches_jax_core_and_pallas(B, n, di, monkeypatch):
    monkeypatch.setenv("DMOSOPT_PALLAS", "1")
    u, p1, _, xlb, xub = _operands(B, n, seed=B + n)
    dis = np.full(n, di, np.float32)
    rate = np.float32(1.0 / n)
    want_core = np.asarray(jax.jit(JV._mutation_core)(u, p1, dis, xlb, xub, rate))
    want_pallas = np.asarray(JV._mutation_pallas(u, p1, dis, xlb, xub, rate))
    got = TV.mutation(*_t(u, p1, dis, xlb, xub), torch.tensor(rate)).numpy()
    np.testing.assert_allclose(got, want_core, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, want_pallas, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("B,n,di", [(16, 5, 15.0), (100, 30, 1.0)])
def test_sbx_core_matches_jax_core_and_pallas(B, n, di, monkeypatch):
    monkeypatch.setenv("DMOSOPT_PALLAS", "1")
    u, p1, p2, xlb, xub = _operands(B, n, seed=3 * B + n)
    dis = np.full(n, di, np.float32)
    want_core = jax.jit(JV._sbx_core)(u, p1, p2, dis, xlb, xub)
    want_pallas = JV._sbx_pallas(u, p1, p2, dis, xlb, xub)
    got = TV.sbx(*_t(u, p1, p2, dis, xlb, xub))
    for g, wc, wp in zip(got, want_core, want_pallas):
        np.testing.assert_allclose(g.numpy(), np.asarray(wc), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(wp), rtol=RTOL, atol=ATOL)


def test_cpu_tensors_take_the_plain_route_and_stay_in_bounds():
    """A CPU tensor never reaches the kernel (its launch counter stays put)
    and the public operators keep children inside the bounds."""
    u, p1, p2, xlb, xub = _operands(32, 7, seed=1)
    before = dict(TV.KERNEL_LAUNCHES)
    g = torch.Generator().manual_seed(0)
    P1, P2, LB, UB = _t(p1, p2, xlb, xub)
    m = TV.polynomial_mutation(g, P1, 20.0, LB, UB, 1.0 / 7)
    c1, c2 = TV.sbx_crossover(g, P1, P2, 1.0, LB, UB)
    assert TV.KERNEL_LAUNCHES == before
    for child in (m, c1, c2):
        assert child.shape == P1.shape
        assert bool((child >= LB).all()) and bool((child <= UB).all())


def _selection_inputs(n, seed):
    rng = np.random.default_rng(seed)
    rank = rng.integers(0, 6, n).astype(np.int32)
    metric = rng.permutation(n).astype(np.float32) / n  # tie-free tiebreak
    return rank, metric


@pytest.mark.parametrize("masked", [False, True])
def test_tournament_selection_matches_jax_with_injected_gumbel(masked):
    """Same sorted order, and with the JAX Gumbel draws injected, exactly
    the same selected indices."""
    n, poolsize = 64, 24
    rank, metric = _selection_inputs(n, seed=5)
    mask = np.arange(n) % 5 != 0 if masked else None
    key = jax.random.PRNGKey(11)
    want = np.asarray(JV.tournament_selection(
        key, poolsize, jnp.asarray(rank), jnp.asarray(metric),
        mask=None if mask is None else jnp.asarray(mask),
    ))
    want_order = np.asarray(jnp.lexsort((jnp.asarray(metric), jnp.asarray(rank))))
    # the draw tournament_selection makes with its key
    gumbel = np.array(jax.random.gumbel(key, (n,), dtype=jnp.float32))

    order, prob = TV._tournament_order(
        torch.as_tensor(rank), torch.as_tensor(metric),
        mask=None if mask is None else torch.as_tensor(mask),
    )
    np.testing.assert_array_equal(order.numpy(), want_order)
    got = TV._gumbel_top_k(order, prob, torch.as_tensor(gumbel), poolsize)
    np.testing.assert_array_equal(got.numpy(), want)


def test_tournament_selection_draws_distinct_valid_individuals():
    n, poolsize = 50, 20
    rank, metric = _selection_inputs(n, seed=9)
    mask = torch.as_tensor(np.arange(n) < 30)
    g = torch.Generator().manual_seed(4)
    idx = TV.tournament_selection(
        g, poolsize, torch.as_tensor(rank), torch.as_tensor(metric), mask=mask
    ).numpy()
    assert len(set(idx.tolist())) == poolsize
    assert (idx < 30).all()
