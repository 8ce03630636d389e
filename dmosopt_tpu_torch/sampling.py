"""Design-of-experiments samplers: MC, Latin hypercube, symmetric LH, Sobol,
good lattice points, with optional RGS de-correlation.

Port of ``dmosopt_tpu/sampling.py`` for the samplers the port carries.
Every sampler maps ``(n, s, random, maxiter) -> (n, s)`` points in the
unit box. The symmetric LH, the GLP candidate lattices and the RGS
decorrelation are numpy, copied verbatim, so for the same numpy
Generator they give the reference's designs bit for bit. LH and MC draw
from a CPU `torch.Generator` seeded like the reference's `as_key` (one
draw from a numpy Generator), so they consume the caller's numpy stream
in the same order as the reference, though their own numbers differ.
GLP scores its candidate lattices by centered L2 discrepancy in float64
(see `_score_and_pick`). The scrambled Sobol design is scipy's
`qmc.Sobol` seeded with the caller's numpy Generator, as in the JAX
package, so it is that package's design bit for bit. `sobol_block` is
the digitally shifted Sobol block on a device (the hypervolume FPRAS
draws from it); its shift bits are an argument, drawn by
`sobol_shift`.
"""

from __future__ import annotations

import functools
import itertools
import math

import numpy as np
import torch

from dmosopt_tpu_torch.discrepancy import CD2
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


def SobolDesign(n: int, s: int, random=None) -> np.ndarray:
    """Scrambled Sobol sequence, generated in power-of-two blocks and
    truncated (reference: dmosopt/sampling.py:11-22)."""
    from scipy.stats import qmc

    rng = as_generator(random)
    sampler = qmc.Sobol(d=s, scramble=True, seed=rng)
    m = max(1, math.ceil(math.log2(max(n, 2))))
    sample = sampler.random_base2(m)
    return np.asarray(sample[:n])


# ------------------------------------------------------ Sobol on a device

SOBOL_BITS = 30  # scipy's direction numbers are 30-bit fractions


@functools.lru_cache(maxsize=64)
def sobol_direction_numbers(dim: int) -> np.ndarray:
    """Joe-Kuo direction numbers for a `dim`-dimensional Sobol sequence,
    (dim, bits) uint32, read from scipy once per dimension so the points
    can be generated on a device (`sobol_block` reads the bit width off
    the table's shape). The returned array is read-only."""
    from scipy.stats import qmc

    sampler = qmc.Sobol(d=dim, scramble=False)
    sv = getattr(sampler, "_sv", None)  # private scipy internals
    if sv is None or np.ndim(sv) != 2 or np.shape(sv)[0] != dim:
        raise RuntimeError(
            "cannot extract Sobol direction numbers from scipy.stats.qmc."
            "Sobol._sv (scipy internals changed?); pin scipy or supply a "
            "direction-number table to sobol_block directly"
        )
    out = np.asarray(sv, dtype=np.uint32)
    out.setflags(write=False)
    return out


_MASK32 = 0xFFFFFFFF


def sobol_shift(dim: int, generator: torch.Generator, device=None) -> torch.Tensor:
    """(dim,) random 32-bit words for `sobol_block`'s digital shift, as
    int64, drawn from ``generator`` (on ``device``, the generator's own
    by default)."""
    device = generator.device if device is None else device
    return torch.randint(
        0, 2**32, (dim,), generator=generator, dtype=torch.int64, device=device
    )


def sobol_block(sv, shift: torch.Tensor, n: int) -> torch.Tensor:
    """First ``n`` Sobol points with a digital shift, on ``shift``'s
    device (reference ``dmosopt_tpu/sampling.py:131``).

    ``sv`` is the (dim, bits) direction-number table of
    `sobol_direction_numbers` (or that table as an int64 tensor already
    on the device, which spares a host-to-device copy per call); ``shift`` holds (dim,) random 32-bit words
    (`sobol_shift`), of which the top ``bits`` are XORed into every
    point, a randomized-QMC digital shift. Point k is the XOR of the
    direction numbers picked by the set bits of gray(k) = k ^ (k >> 1).
    The words are int64 masked to 32 bits, because torch's uint32 lacks
    bitwise and shift kernels on some backends; the XOR-reduce halves
    the bit axis as the JAX package's does. The result is truncated to
    float32's 24-bit mantissa before the cast, so no point rounds up to
    1.0. Returns (n, dim) float32 in [0, 1)."""
    dev = shift.device
    if not torch.is_tensor(sv):
        sv = np.asarray(sv, dtype=np.int64)
    sv = torch.as_tensor(sv, dtype=torch.int64, device=dev)
    dim, bits = sv.shape
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    gray = idx ^ (idx >> 1)
    bit = (gray[:, None] >> torch.arange(bits, device=dev)[None, :]) & 1
    # (n, dim, bits): the direction number where the gray bit is set
    x = torch.where(bit[:, None, :].bool(), sv[None, :, :], torch.zeros_like(sv[None]))
    width = 1
    while width < bits:
        width *= 2
    if width != bits:  # pad with zeros, XOR's identity
        x = torch.nn.functional.pad(x, (0, width - bits))
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] ^ x[..., h:]
    x = x[..., 0] & _MASK32
    x = x ^ ((shift.to(torch.int64) & _MASK32) >> (32 - bits))[None, :]
    if bits > 24:
        x = x >> (bits - 24)
        bits = 24
    return x.to(torch.float32) * (2.0**-bits)


# ------------------------------------------------------------------- GLP


def _prime_factors(n: int) -> list[int]:
    p, f = [], 2
    while f * f <= n:
        while n % f == 0:
            p.append(f)
            n //= f
        f += 1
    if n > 1:
        p.append(n)
    return p


def euler_phi(n: int) -> int:
    phi = n
    for f in sorted(set(_prime_factors(n))):
        phi -= phi // f
    return phi


def _lattice_points(n: int, h: np.ndarray) -> np.ndarray:
    """u[i, j] = ((i+1) * h[j] - 1) mod n + 1 (reference glpmod,
    dmosopt/GLP.py:130-139, where a 0 residue means n)."""
    i = np.arange(1, n + 1)[:, None]
    u = (i * h[None, :]) % n
    u = np.where(u == 0, n, u)
    return u.astype(float)


def _power_gen_vectors(n: int, s: int) -> np.ndarray:
    """Candidate generating vectors h = (a^0, ..., a^(s-1)) mod n for units a
    whose first s powers are distinct and != 1 (reference dmosopt/GLP.py:105-127)."""
    cands = []
    for a in range(2, n):
        if math.gcd(a, n) != 1:
            continue
        powers = np.mod([pow(a, t, n) for t in range(1, s)], n)
        sp = np.sort(powers)
        if sp[0] == 1 or np.any(sp[1:] == sp[:-1]):
            continue
        cands.append([pow(a, t, n) for t in range(s)])
    return np.asarray(cands, dtype=float)


# elements of one batch of pairwise products in `_score_and_pick`
_CD2_BATCH_ELEMENTS = 1 << 24


def _score_and_pick(designs: np.ndarray) -> np.ndarray:
    """The candidate design of least centered L2 discrepancy, the first of
    them where several tie. Lattices that are reflections or column
    permutations of each other tie exactly, and the best ones usually
    come in such sets. The scores are float64: in float32 (the JAX
    package's) their rounding error exceeds the gaps between candidates,
    so the float32 argmin among near-equal lattices follows the
    reduction order of whatever computes it. Scores within a relative
    1e-10 count as a tie, far above float64's error and below any gap
    between lattices that do not tie."""
    num, dim = designs.shape[1:]
    per_batch = max(1, _CD2_BATCH_ELEMENTS // (num * num * dim))
    x = torch.as_tensor(designs, dtype=torch.float64)
    scores = torch.cat([CD2(x[i : i + per_batch]) for i in range(0, len(x), per_batch)])
    best = scores.min()
    return designs[int(torch.nonzero(scores <= best + 1e-10 * best)[0, 0])]


def GoodLatticePointsDesign(n: int, s: int, random=None) -> np.ndarray:
    """Number-theoretic uniform design (reference dmosopt/GLP.py:14-28):
    when the Euler totient of n is too small, use n+1 points and drop the
    last row; small cases enumerate totative combinations, large cases use
    power generating vectors."""
    if s == 1:
        return LatinHypercubeDesign(n, 1, random)
    m = euler_phi(n)
    plusone = (m / n) < 0.9
    small = m < 20 and s < 4  # branch on phi(n) before any n+1 adjustment
    nn = n + 1 if plusone else n
    m = euler_phi(nn) if plusone else m
    if small:
        h_all = np.asarray([i for i in range(nn) if math.gcd(i, nn) == 1])
        combos = list(itertools.combinations(range(len(h_all)), s))
        if len(combos) == 0:  # fewer totatives than dims (reference falls
            return LatinHypercubeDesign(n, s, random)  # back to random design)
        u = _lattice_points(nn, h_all)
        designs = np.stack([u[:, list(c)] for c in combos])
    else:
        hs = _power_gen_vectors(nn, s)
        if len(hs) == 0:
            return LatinHypercubeDesign(n, s, random)
        designs = np.stack([_lattice_points(nn, h) for h in hs])

    if plusone:
        designs = (designs[:, : nn - 1, :] - 0.5) / (nn - 1)
    else:
        designs = (designs - 0.5) / nn
    return np.asarray(_score_and_pick(designs))


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


def glp(n, s, random=None, maxiter=0):
    return _with_decorr(GoodLatticePointsDesign(n, s, random), maxiter)


def sobol(n, s, random=None, maxiter=0):
    return SobolDesign(n, s, random)
