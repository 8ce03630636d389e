"""Design-of-experiments samplers: MC, Latin hypercube, symmetric LH, with
optional RGS de-correlation.

Port of ``dmosopt_tpu/sampling.py`` for the samplers this slice runs.
Every sampler maps ``(n, s, random, maxiter) -> (n, s)`` points in the
unit box. The symmetric LH and the RGS decorrelation are numpy, copied
verbatim, so for the same numpy Generator they give the reference's
designs bit for bit. LH and MC draw from a CPU `torch.Generator` seeded
like the reference's `as_key` (one draw from a numpy Generator), so they
consume the caller's numpy stream in the same order as the reference,
though their own numbers differ. GLP and Sobol are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from dmosopt_tpu_torch.utils.prng import as_generator, as_torch_generator


def MonteCarloDesign(n: int, s: int, random=None) -> np.ndarray:
    gen = as_torch_generator(random)
    return torch.rand((n, s), generator=gen).numpy()


def LatinHypercubeDesign(n: int, s: int, random=None) -> np.ndarray:
    """Standard LH: per dimension, one uniform draw in each of n strata,
    independently permuted."""
    gen = as_torch_generator(random)
    perms = torch.stack([torch.randperm(n, generator=gen) for _ in range(s)])
    u = torch.rand((n, s), generator=gen)
    return ((perms.T.to(u.dtype) + u) / n).numpy()


def SymmetricLatinHypercubeDesign(n: int, s: int, random=None) -> np.ndarray:
    """Symmetric LH (reference: dmosopt/sampling.py:43-77): strata centers
    with mirrored pairing — rows i and n-1-i use complementary strata."""
    rng = as_generator(random)
    k = n // 2
    p = np.zeros((n, s), dtype=int)
    p[:, 0] = np.arange(n)
    if n % 2 == 1:
        p[k, :] = k
    for j in range(1, s):
        pj = rng.permutation(k)
        flip = rng.random(k) < 0.5
        # flip: bottom keeps pj, top gets mirror; else bottom gets mirror.
        p[:k, j] = np.where(flip, pj, n - 1 - pj)
        p[n - 1 : n - 1 - k : -1, j] = np.where(flip, n - 1 - pj, pj)
    return (p + 0.5) / n


# ------------------------------------------------- RGS de-correlation


def _rmtrend(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    xm = x - x.mean()
    ym = y - y.mean()
    b = (xm * ym).sum() / (xm**2).sum()
    return y - b * xm


def _rank_to_unit(z: np.ndarray) -> np.ndarray:
    n = len(z)
    x = np.empty(n)
    x[z.argsort()] = np.arange(n)
    return (x + 0.5) / n


def decorr(x: np.ndarray) -> np.ndarray:
    """One Ranked Gram-Schmidt de-correlation iteration
    (reference: dmosopt/sampling.py:97-109)."""
    x = np.array(x, copy=True)
    n, s = x.shape
    for j in range(1, s):
        for k in range(j):
            x[:, k] = _rank_to_unit(_rmtrend(x[:, j], x[:, k]))
    for j in range(s - 2, -1, -1):
        for k in range(s - 1, j, -1):
            x[:, k] = _rank_to_unit(_rmtrend(x[:, j], x[:, k]))
    return x


def _with_decorr(x: np.ndarray, maxiter: int) -> np.ndarray:
    for _ in range(maxiter):
        x = decorr(x)
    return x


# ------------------------------------------------------------ short names


def mc(n, s, random=None, maxiter=0):
    return MonteCarloDesign(n, s, random)


def lh(n, s, random=None, maxiter=0):
    return _with_decorr(LatinHypercubeDesign(n, s, random), maxiter)


def slh(n, s, random=None, maxiter=0):
    return _with_decorr(SymmetricLatinHypercubeDesign(n, s, random), maxiter)
