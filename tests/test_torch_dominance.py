"""The port's ranking, crowding and sorting against the JAX package.

Ranks are integers and must be exactly equal, on duplicates, NaN, ±inf
and masks, to both the JAX dispatcher (the d == 2 sweep or the tiled
sweep) and its dense matrix-peel oracle. Crowding distances are float32
sums of the same terms in the same order (allclose at 1e-6). Sort
permutations must be equal on tie-free inputs.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

# one intra-op thread: the test workers share the machine, and torch's
# default of one thread per core oversubscribes it
torch.set_num_threads(1)

from dmosopt_tpu.ops import distances as JDist
from dmosopt_tpu.ops import dominance as JDom
from dmosopt_tpu.ops import sort as JSort
from dmosopt_tpu_torch.ops import distances as TDist
from dmosopt_tpu_torch.ops import dominance as TDom
from dmosopt_tpu_torch.ops import sort as TSort


def _objectives(n, d, seed, kind):
    rng = np.random.default_rng(seed)
    if kind == "continuous":
        Y = rng.random((n, d))
    else:  # coarse grid: many ties, long dominance chains
        Y = rng.integers(0, 5, (n, d)).astype(np.float64)
    Y = Y.astype(np.float32)
    if kind == "special":
        Y[5] = Y[3]  # duplicate rows share a front
        Y[7] = Y[3]
        Y[11, 0] = np.nan
        Y[13, d - 1] = np.inf
        Y[17] = -np.inf
        Y[19, 1] = np.inf
        Y[19, 0] = -np.inf
    return Y


@pytest.mark.parametrize("d", [2, 3, 5])
@pytest.mark.parametrize("kind", ["continuous", "grid", "special"])
@pytest.mark.parametrize("masked", [False, True])
def test_non_dominated_rank_equals_jax(d, kind, masked):
    n = 60
    Y = _objectives(n, d, seed=10 * d + len(kind), kind=kind)
    mask = (np.arange(n) % 7 != 2) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    want = np.asarray(JDom.non_dominated_rank(jnp.asarray(Y), mask=jm))
    peel = np.asarray(JDom._rank_matrix_peel(jnp.asarray(Y), mask=jm))
    got = TDom.non_dominated_rank(
        torch.as_tensor(Y), mask=None if mask is None else torch.as_tensor(mask)
    ).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, peel)


@pytest.mark.parametrize("check_every", [1, 3, 64])
def test_rank_convergence_check_does_not_change_ranks(check_every, monkeypatch):
    Y = _objectives(80, 2, seed=3, kind="grid")
    want = TDom.non_dominated_rank(torch.as_tensor(Y)).numpy()
    monkeypatch.setattr(TDom, "CHECK_EVERY", check_every)
    got = TDom.non_dominated_rank(torch.as_tensor(Y))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("masked", [False, True])
def test_crowding_distance_matches_jax(d, masked):
    n = 50
    Y = _objectives(n, d, seed=d, kind="continuous")
    Y[4] = Y[9]  # a tie: the stable sort must order it alike
    mask = (np.arange(n) % 4 != 1) if masked else None
    want = np.asarray(JDist.crowding_distance(
        jnp.asarray(Y), None if mask is None else jnp.asarray(mask)
    ))
    got = TDist.crowding_distance(
        torch.as_tensor(Y), None if mask is None else torch.as_tensor(mask)
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    want_e = np.asarray(JDist.euclidean_distance_metric(jnp.asarray(Y)))
    got_e = TDist.euclidean_distance_metric(torch.as_tensor(Y)).numpy()
    np.testing.assert_allclose(got_e, want_e, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("metrics", [("crowding",), None, ("euclidean",)])
def test_sort_mo_permutation_equals_jax(metrics):
    rng = np.random.default_rng(21)
    x = rng.random((70, 4)).astype(np.float32)
    y = rng.random((70, 2)).astype(np.float32)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    xs, ys, rank, _, perm = JSort.sort_mo(jx, jy, y_distance_metrics=metrics)
    txs, tys, trank, _, tperm = TSort.sort_mo(
        torch.as_tensor(x), torch.as_tensor(y), y_distance_metrics=metrics
    )
    np.testing.assert_array_equal(tperm.numpy(), np.asarray(perm))
    np.testing.assert_array_equal(trank.numpy(), np.asarray(rank))
    np.testing.assert_array_equal(txs.numpy(), np.asarray(xs))


def test_lexsort_matches_numpy_on_ties():
    rng = np.random.default_rng(2)
    keys = [rng.integers(0, 3, 40), rng.integers(0, 2, 40), rng.integers(0, 4, 40)]
    want = np.lexsort(keys)
    got = TSort.lexsort([torch.as_tensor(k) for k in keys]).numpy()
    np.testing.assert_array_equal(got, want)


def _dense_relaxation(Y, mask=None):
    """Today's reference form of the port's rank: the longest dominator
    chain relaxed over the whole dense dominance matrix until it stops."""
    dom = TDom.dominance_matrix(torch.as_tensor(Y), None if mask is None
                                else torch.as_tensor(mask))
    r = torch.zeros(Y.shape[0], dtype=torch.int32)
    while True:
        nxt = torch.where(dom, r[:, None] + 1, 0).amax(dim=0).to(torch.int32)
        if torch.equal(nxt, r):
            break
        r = nxt
    if mask is not None:
        r = torch.where(torch.as_tensor(mask), r, Y.shape[0])
    return r.numpy()


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("kind", ["grid", "special"])
@pytest.mark.parametrize("block", [1, 7, 16])
def test_blocked_rank_equals_dense_and_jax(d, kind, block):
    """Forced small column blocks (Gauss-Seidel sweeps with diagonal
    refinements) give the dense relaxation's and the JAX package's ranks
    on duplicates, NaN, ±inf, long chains and masks, for each set of a
    batch ranked in one call."""
    n, S = 60, 3
    Ys = np.stack([_objectives(n, d, seed=100 * d + s, kind=kind) for s in range(S)])
    masks = np.stack([np.arange(n) % (5 + s) != 1 for s in range(S)])
    got = TDom.non_dominated_rank(torch.as_tensor(Ys), mask=torch.as_tensor(masks),
                                  block=block).numpy()
    for s in range(S):
        want = np.asarray(JDom.non_dominated_rank(jnp.asarray(Ys[s]),
                                                  mask=jnp.asarray(masks[s])))
        np.testing.assert_array_equal(got[s], want)
        np.testing.assert_array_equal(got[s], _dense_relaxation(Ys[s], masks[s]))
    unmasked = TDom.non_dominated_rank(torch.as_tensor(Ys[0]), block=block).numpy()
    np.testing.assert_array_equal(unmasked, _dense_relaxation(Ys[0]))


def test_batched_sort_and_crowding_equal_the_jax_vmap():
    """SMPSO's survival sort: one batched call per generation, the JAX
    package's ``vmap`` of `sort_mo(need=)` over the swarms."""
    import jax

    rng = np.random.default_rng(8)
    S, n, need = 4, 48, 16
    x = rng.random((S, n, 3)).astype(np.float32)
    y = rng.random((S, n, 3)).astype(np.float32)
    mask = rng.random((S, n)) > 0.1
    want = jax.vmap(lambda a, b: JSort.sort_mo(a, b, need=need))(jnp.asarray(x), jnp.asarray(y))
    got = TSort.sort_mo(torch.as_tensor(x), torch.as_tensor(y), need=need)
    for g, w in zip((got[0], got[1], got[2], got[4]), (want[0], want[1], want[2], want[4])):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(got[3][0].numpy(), np.asarray(want[3][0]), rtol=1e-6, atol=1e-7)
    cd = TDist.crowding_distance(torch.as_tensor(y), torch.as_tensor(mask)).numpy()
    for s in range(S):
        one = TDist.crowding_distance(torch.as_tensor(y[s]), torch.as_tensor(mask[s]))
        np.testing.assert_array_equal(cd[s], one.numpy())


@pytest.mark.parametrize("block", [None, 1, 9])
def test_blocked_get_duplicates_equals_jax(block):
    """The archive dedupe over row blocks of the masked triangle gives the
    JAX package's dense float64 answer, with repeats, NaN and a second
    array (a row meets only earlier rows)."""
    from dmosopt_tpu.moasmo import get_duplicates as jax_dups
    from dmosopt_tpu_torch.moasmo import get_duplicates

    rng = np.random.default_rng(4)
    X = rng.random((120, 3)).astype(np.float32)
    X[[50, 90, 101]] = X[10]
    X[7] = X[60]
    X[33, 1] = np.nan
    X[34] = X[33]
    Y = rng.random((70, 3)).astype(np.float32)
    Y[5], Y[60] = X[70], X[20]
    for a, b in ((X, None), (X, Y), (Y, X)):
        want = jax_dups(a, b)
        np.testing.assert_array_equal(
            get_duplicates(a, b, block=block, device="cpu"), want
        )
    assert jax_dups(X).sum() == 4
