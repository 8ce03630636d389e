"""Non-dominated subsets (minimisation), plain numpy."""

import numpy as np


def dominated_by_any(Y, Z):
    """For each row of ``Y``, whether some row of ``Z`` dominates it: no
    worse in every objective and better in one."""
    Y = np.asarray(Y, dtype=np.float64)
    Z = np.asarray(Z, dtype=np.float64)
    out = np.zeros(Y.shape[0], dtype=bool)
    for i in range(0, Y.shape[0], 256):
        y = Y[i:i + 256, None, :]
        le = np.all(Z[None, :, :] <= y, axis=2)
        lt = np.any(Z[None, :, :] < y, axis=2)
        out[i:i + 256] = np.any(le & lt, axis=1)
    return out


def non_dominated(Y):
    """Mask of the rows of ``Y`` that no other row dominates."""
    return ~dominated_by_any(Y, Y)


def covered(P, Z):
    """For each row of ``P``, whether some row of ``Z`` is no worse in
    every objective: the region ``Z`` covers, as a hypervolume counts it."""
    P = np.asarray(P, dtype=np.float64)
    Z = np.asarray(Z, dtype=np.float64)
    out = np.zeros(P.shape[0], dtype=bool)
    for i in range(0, P.shape[0], 256):
        out[i:i + 256] = np.any(np.all(Z[None, :, :] <= P[i:i + 256, None, :], axis=2), axis=1)
    return out


def hv_stall(Y_init, Y_new, n_samples=1 << 15, seed=0):
    """The hypervolume of ``Y_init`` over that of ``Y_init`` and ``Y_new``
    together: 1 where ``Y_new`` covers nothing that ``Y_init`` does not,
    less the more it adds. Monte Carlo, on ``n_samples`` points drawn
    from ``seed`` uniformly in the box from the union's ideal point to
    a tenth of its range past its nadir; both volumes count the same
    points, so a ``Y_new`` inside ``Y_init`` reads exactly 1."""
    Y_init = np.asarray(Y_init, dtype=np.float64)
    U = np.vstack([Y_init, np.asarray(Y_new, dtype=np.float64)])
    lo, hi = U.min(0), U.max(0)
    P = lo + np.random.default_rng(seed).random((n_samples, U.shape[1])) * 1.1 * (hi - lo)
    both = int(np.count_nonzero(covered(P, U)))
    return float(np.count_nonzero(covered(P, Y_init))) / both if both else float("nan")
