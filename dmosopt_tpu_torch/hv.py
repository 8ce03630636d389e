"""Hypervolume stack: exact (2-D staircase, d-D local upper bounds), Monte
Carlo estimators, batched EHVI, and an adaptive routing facade.

Port of ``dmosopt_tpu/hv.py`` (after reference `dmosopt/hv.py`,
`dmosopt/hv_box_decomposition.py` and `dmosopt/hv_adaptive.py`). Beside
each jitted function of the JAX package stands a plain torch version:
the 2-D staircase (`hypervolume_2d`), the chunked dominance prune
(`_dominated_mask_chunked`), the rejection Monte Carlo count
(`_mc_dominated_count`), the FPRAS union-of-boxes blocks (`_fpras_block`
and its QMC form `_fpras_block_qmc`, drawing from
`sampling.sobol_block`) and batched EHVI (`ehvi_batch`). The numpy code
of that module is copied as it is: the WFG recursion, `hypervolume_exact`,
the local-upper-bound decomposition, `HyperVolumeBoxDecomposition` and
`default_reference_point`.

Randomness comes from a `torch.Generator` in place of the JAX key, and
each random block's draws are an argument of the block function, so the
same uniforms or shift bits can go through both packages. The
estimators run on ``device`` (None means CUDA, as the port's entry
points do); the exact paths are numpy on the host.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from dmosopt_tpu_torch import sampling
from dmosopt_tpu_torch.utils.device import resolve_device


# ------------------------------------------------------------- exact, 2-D


def hypervolume_2d(points: torch.Tensor, ref_point: torch.Tensor) -> torch.Tensor:
    """Exact 2-D hypervolume via the staircase sweep (minimization), on
    the tensors' device: points outside the reference box are masked to
    +inf so they neither contribute area nor advance the staircase;
    dominated points contribute zero via the prefix-min."""
    inside = torch.all(points < ref_point, dim=1)
    x = torch.where(inside, points[:, 0], torch.inf)
    y = torch.where(inside, points[:, 1], torch.inf)
    order = torch.argsort(x, stable=True)
    xs, ys = x[order], y[order]
    cummin = torch.cummin(ys, dim=0).values
    prev_best = torch.cat(
        [ref_point[1:2], torch.minimum(cummin[:-1], ref_point[1])]
    )
    width = torch.where(torch.isfinite(xs), ref_point[0] - xs, 0.0)
    height = torch.clamp(prev_best - ys, min=0.0)
    height = torch.where(torch.isfinite(height), height, 0.0)
    return torch.sum(width * height)


# ----------------------------------------------------- exact, d dimensions


def _filter_dominated(points: np.ndarray) -> np.ndarray:
    """Keep the non-dominated subset (minimization)."""
    n = len(points)
    if n <= 1:
        return points
    le = np.all(points[:, None, :] <= points[None, :, :], axis=2)
    lt = np.any(points[:, None, :] < points[None, :, :], axis=2)
    dominated = np.any(le & lt, axis=0)
    return points[~dominated]


def _dominated_mask_chunked(points: torch.Tensor, chunk: int = 512) -> torch.Tensor:
    """(N, d) -> (N,) True where another point dominates it (minimization),
    in (chunk, N, d) tiles so memory stays at about chunk·N·d bools at
    any N (the host `_filter_dominated` builds the whole (N, N, d) cube)."""
    N = points.shape[0]
    out = []
    for i0 in range(0, N, chunk):
        rows = points[i0:i0 + chunk]  # (chunk, d)
        le = torch.all(points[None, :, :] <= rows[:, None, :], dim=2)
        lt = torch.any(points[None, :, :] < rows[:, None, :], dim=2)
        out.append(torch.any(le & lt, dim=1))
    return torch.cat(out) if out else torch.zeros(0, dtype=torch.bool,
                                                  device=points.device)


def _hypervolume_wfg(points: np.ndarray, ref_point: np.ndarray) -> float:
    """WFG-style exclusive-volume recursion — an independent exact oracle
    used to cross-check the box decomposition (exponential worst case;
    test-sized inputs only)."""
    points = _filter_dominated(points[np.all(points < ref_point, axis=1)])
    n = len(points)
    if n == 0:
        return 0.0
    pts = points[np.argsort(points[:, 0])[::-1]]
    total = 0.0
    for i in range(n):
        p = pts[i]
        box = float(np.prod(ref_point - p))
        rest = pts[i + 1 :]
        if len(rest) > 0:
            box -= _hypervolume_wfg(np.maximum(rest, p), ref_point)
        total += box
    return total


def hypervolume_exact(points: np.ndarray, ref_point: np.ndarray) -> float:
    """Exact hypervolume for minimization w.r.t. ``ref_point``.

    d<=2 uses the host staircase sweep; d>=3 sums the disjoint
    dominated-region boxes from the local-upper-bound decomposition
    (Lacour et al. 2017) — the same algorithm family as the reference
    exact path (hv_box_decomposition.py:86-129).
    """
    points = np.asarray(points, dtype=np.float64)
    ref_point = np.asarray(ref_point, dtype=np.float64)
    if points.ndim != 2 or points.shape[0] == 0:
        return 0.0
    points = points[np.all(points < ref_point, axis=1)]
    points = _filter_dominated(points)
    n, d = points.shape
    if n == 0:
        return 0.0
    if d == 1:
        return float(ref_point[0] - points[:, 0].min())
    if d == 2:
        pts = points[np.argsort(points[:, 0])]
        hv = 0.0
        best_f2 = ref_point[1]
        for x1, x2 in pts:
            if x2 < best_f2:
                hv += (ref_point[0] - x1) * (best_f2 - x2)
                best_f2 = x2
        return float(hv)
    lowers, uppers = dominated_boxes(points, ref_point)
    return float(np.sum(np.prod(uppers - lowers, axis=1)))


# ------------------------------------------------------------- Monte Carlo

_MC_BLOCK = 4096


def _mc_dominated_count(points: torch.Tensor, lo, hi, u: torch.Tensor):
    """Dominated samples among the uniforms ``u`` (n_blocks, block, d)
    mapped into the box [lo, hi], one block at a time so memory is
    bounded at any sample count. Returns (count, total) with count a 0-d
    int32 tensor."""
    count = torch.zeros((), dtype=torch.int32, device=points.device)
    for ub in u:
        s = lo + ub * (hi - lo)
        dominated = torch.any(
            torch.all(points[None, :, :] <= s[:, None, :], dim=2), dim=1
        )
        count = count + dominated.sum(dtype=torch.int32)
    return count, u.shape[0] * u.shape[1]


def hypervolume_mc(
    points,
    ref_point,
    n_samples: int = 100_000,
    generator: Optional[torch.Generator] = None,
    return_ci: bool = False,
    device=None,
    uniforms: Optional[torch.Tensor] = None,
):
    """Monte Carlo hypervolume estimate (minimization), on ``device``.

    Samples uniformly in the [ideal, ref] bounding box and counts
    dominated samples (reference: dmosopt/hv.py:191-241). The uniforms
    are (ceil(n_samples / 4096), 4096, d) draws from ``generator`` (seed
    0 by default) unless ``uniforms`` gives them. Returns the estimate,
    optionally with a 95% confidence half-width.
    """
    dev = resolve_device(device)
    points = torch.as_tensor(np.asarray(points), dtype=torch.float32, device=dev)
    ref_point = torch.as_tensor(np.asarray(ref_point), dtype=torch.float32, device=dev)
    d = points.shape[1]
    if uniforms is None:
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        n_blocks = (int(n_samples) + _MC_BLOCK - 1) // _MC_BLOCK
        uniforms = torch.rand((n_blocks, _MC_BLOCK, d), generator=generator,
                              device=dev)
    inside = torch.all(points < ref_point, dim=1)
    big = torch.where(inside[:, None], points, ref_point[None, :])
    lo = big.amin(dim=0)
    lo = torch.where(torch.isfinite(lo), lo, ref_point)
    box_vol = torch.prod(ref_point - lo)
    count, total = _mc_dominated_count(big, lo, ref_point, uniforms.to(dev))
    frac = count.to(torch.float32) / total
    hv = float(box_vol * frac)
    if return_ci:
        se = float(torch.sqrt(frac * (1.0 - frac) / total) * box_vol)
        return hv, 1.96 * se
    return hv


# ------------------------------------------------- FPRAS (union of boxes)


_COVER_CHUNK = 1024  # point-axis chunk for the cover count (bounds memory)


def _cover_counts(points_chunks, x):
    """Number of boxes [p_i, ref] covering each sample in `x`, with the
    point axis pre-chunked to (m, chunk, d) (+inf padding rows never
    count), reduced one chunk at a time so memory stays bounded."""
    K = torch.zeros(x.shape[0], dtype=torch.int32, device=x.device)
    for pchunk in points_chunks:
        K = K + torch.sum(
            torch.all(pchunk[None, :, :] <= x[:, None, :], dim=2), dim=1,
            dtype=torch.int32,
        )
    return K


def _fpras_sample(points, points_chunks, ref, cdf, u_box, u_pos):
    """1/K of each sample: the box is drawn with probability proportional
    to its volume (inverse CDF of ``u_box``), the point uniformly inside
    it (``u_pos``)."""
    idx = torch.clamp(torch.searchsorted(cdf, u_box.contiguous()), 0,
                      points.shape[0] - 1)
    lo = points[idx]  # (block, d)
    x = lo + u_pos * (ref - lo)
    K = _cover_counts(points_chunks, x)
    return 1.0 / torch.clamp(K, min=1).to(torch.float32)


def _fpras_block(points, points_chunks, ref, cdf, u_box, u_pos):
    """One batch of the Karp-Luby union-of-boxes estimator over the
    uniforms ``u_box`` (block,) and ``u_pos`` (block, d). Returns (sum
    1/K, sum (1/K)^2) over the batch."""
    z = _fpras_sample(points, points_chunks, ref, cdf, u_box, u_pos)
    return z.sum(), (z * z).sum()


def _fpras_block_qmc(points, points_chunks, ref, cdf, sv, shift, block: int):
    """QMC variant: the (d+1)-dimensional sample (box choice + position)
    comes from a Sobol block with the digital shift ``shift``
    (`sampling.sobol_block`). Returns the batch mean of 1/K (batch means
    are i.i.d. across shifts, so confidence intervals are taken over
    batches)."""
    q = sampling.sobol_block(sv, shift, block)  # (block, d+1)
    return _fpras_sample(points, points_chunks, ref, cdf, q[:, 0], q[:, 1:]).mean()


def hypervolume_fpras(
    points,
    ref_point,
    epsilon: float = 0.01,
    generator: Optional[torch.Generator] = None,
    max_samples: int = 2_000_000,
    batch: int = 8192,
    qmc: bool = True,
    return_info: bool = False,
    prune: bool = True,
    device=None,
):
    """FPRAS-class hypervolume estimator with CI-driven adaptive sampling
    (minimization), as the JAX package's (reference
    dmosopt/hv_adaptive.py:266 FPRAS, :356 MCM2RV, :575 hybrid).

    The dominated region is the union of the boxes [p_i, ref]. Sampling
    a box ~ its volume and a uniform point within it gives the unbiased
    union-volume estimate ``V_sum * E[1/K]`` where ``K`` is the cover
    count; box volumes are handled in log space. With ``qmc`` each batch
    is a digitally shifted Sobol block (randomized QMC). Sampling stops
    when the 95% CI half-width is below ``epsilon * estimate`` or at
    ``max_samples``. The draws come from ``generator`` (seed 0 by
    default) on ``device``. Returns the estimate, plus
    ``(ci, n_samples)`` when ``return_info``.
    """
    from scipy.stats import t as student_t  # here: scipy.stats loads slowly

    points = np.asarray(points, dtype=np.float64)
    ref = np.asarray(ref_point, dtype=np.float64)
    if points.ndim != 2 or points.shape[0] == 0:
        return (0.0, (0.0, 0)) if return_info else 0.0
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    points = points[np.all(points < ref, axis=1)]
    if prune:
        if points.shape[0] <= 2048:
            points = _filter_dominated(points)
        else:
            # archive-scale fronts: the chunked prune on the device, in
            # float32, the cover-count scan's own working precision
            mask = _dominated_mask_chunked(
                torch.as_tensor(points, dtype=torch.float32, device=dev)
            ).cpu().numpy()
            points = points[~mask]
    n, d = points.shape
    if n == 0:
        return (0.0, (0.0, 0)) if return_info else 0.0

    log_vols = np.sum(np.log(ref - points), axis=1)
    m = log_vols.max()
    vols = np.exp(log_vols - m)
    v_sum = float(np.exp(m + np.log(vols.sum())))
    cdf = np.cumsum(vols / vols.sum())

    pts = torch.as_tensor(points, dtype=torch.float32, device=dev)
    # a front smaller than a chunk is one chunk of its own size
    chunk = min(n, _COVER_CHUNK)
    n_pad = -n % chunk
    pts_chunks = torch.cat(
        [pts, torch.full((n_pad, d), torch.inf, device=dev)]
    ).reshape(-1, chunk, d)
    ref32 = torch.as_tensor(ref, dtype=torch.float32, device=dev)
    cdf32 = torch.as_tensor(cdf, dtype=torch.float32, device=dev)
    sv = sampling.sobol_direction_numbers(d + 1) if qmc else None

    # accumulate batch statistics until the CI target is met; the
    # estimate is refreshed every batch so a tight max_samples still
    # returns the running estimate, never the 0.0 placeholder
    min_batches = min(8, max(1, max_samples // batch))
    batch_means: list = []
    s1 = s2 = 0.0
    n_samples = 0
    est = ci = 0.0
    while n_samples < max_samples:
        if qmc:
            shift = sampling.sobol_shift(d + 1, generator, device=dev)
            zm = float(_fpras_block_qmc(pts, pts_chunks, ref32, cdf32, sv, shift, batch))
            batch_means.append(zm)
            n_samples += batch
            bm = np.asarray(batch_means)
            mean = bm.mean()
            if len(bm) >= 2:
                # small-sample t quantile: at 8 batches 1.96 would
                # under-cover by ~17%
                q = float(student_t.ppf(0.975, len(bm) - 1))
                se = q / 1.96 * bm.std(ddof=1) / np.sqrt(len(bm))
            else:
                se = np.inf
        else:
            u_box = torch.rand(batch, generator=generator, device=dev)
            u_pos = torch.rand((batch, d), generator=generator, device=dev)
            bs1, bs2 = _fpras_block(pts, pts_chunks, ref32, cdf32, u_box, u_pos)
            s1 += float(bs1)
            s2 += float(bs2)
            n_samples += batch
            mean = s1 / n_samples
            var = max(s2 / n_samples - mean * mean, 0.0)
            se = np.sqrt(var / n_samples)
        est = v_sum * mean
        ci = 1.96 * v_sum * se if np.isfinite(se) else np.inf
        if (
            len(batch_means) >= min_batches or (not qmc and n_samples >= min_batches * batch)
        ) and est > 0 and ci <= epsilon * est:
            break
    if not np.isfinite(ci):
        ci = 0.0 if est == 0.0 else float(v_sum)
    return (est, (ci, n_samples)) if return_info else est


# -------------------------------------------- dominated-region decomposition


def local_upper_bounds(
    front: np.ndarray, ref_point: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Local upper bounds of a non-dominated front with their defining
    points, via the nonincremental algorithm of Lacour, Klamroth & Fonseca
    (2017) — the algorithm behind the reference exact HV path
    (hv_box_decomposition.py:165-248; this is an independent
    implementation of the published algorithm, with -inf dummy coordinates
    so it is correct for objectives of any sign).

    Returns (ubs, defs): ubs (M, d) upper-bound coordinates; defs (M, d)
    coordinates z^k_j(u) of the defining point of each dimension — laid
    out as defs[m, k, j] = j-th coordinate of the defining point for
    dimension k of upper bound m, shape (M, d, d).
    """
    front = np.asarray(front, dtype=np.float64)
    ref_point = np.asarray(ref_point, dtype=np.float64)
    n, d = front.shape

    # dummy defining point for dimension k: coordinate k = ref_k, else -inf
    dummy = np.full((d, d), -np.inf)
    np.fill_diagonal(dummy, ref_point)

    ubs = [ref_point.copy()]
    defs = [dummy.copy()]  # defs[m][k] = defining point (d,) for dim k

    order = np.argsort(front[:, -1])
    for z in front[order]:
        U = np.asarray(ubs)
        dominated = np.all(z < U, axis=1)  # strictly dominated LUBs (set A)
        if not dominated.any():
            continue
        keep_ubs = [u for u, m in zip(ubs, dominated) if not m]
        keep_defs = [q for q, m in zip(defs, dominated) if not m]
        new_ubs, new_defs = [], []
        for u, q in ((u, q) for u, q, m in zip(ubs, defs, dominated) if m):
            # update in the last dimension unconditionally
            nu = u.copy()
            nu[-1] = z[-1]
            nq = q.copy()
            nq[-1] = z
            new_ubs.append(nu)
            new_defs.append(nq)
            # update in dimension j < d-1 only if z_j > max_{k!=j} z^k_j(u).
            # This assumes general position — tied coordinates are broken
            # upstream by `_break_ties` before the decomposition.
            for j in range(d - 1):
                other = np.delete(q[:, j], j)
                if np.max(other) < z[j]:
                    nu = u.copy()
                    nu[j] = z[j]
                    nq = q.copy()
                    nq[j] = z
                    new_ubs.append(nu)
                    new_defs.append(nq)
        ubs = keep_ubs + new_ubs
        defs = keep_defs + new_defs
        # dedupe by coordinates
        seen = {}
        for u, q in zip(ubs, defs):
            seen.setdefault(tuple(u), (u, q))
        ubs = [v[0] for v in seen.values()]
        defs = [v[1] for v in seen.values()]

    return np.asarray(ubs), np.asarray(defs)


def _break_ties(front: np.ndarray, ref_point: np.ndarray):
    """Simulation-of-simplicity for the box decomposition: tied
    coordinates make the local-upper-bound update drop needed bounds (the
    algorithm assumes general position), silently losing volume.

    Works in RANK space: each dimension's coordinates are replaced by
    their dense rank (exact small integers), with ties split by
    ``rank + i/(n+2)`` — immune to floating-point spacing, unlike value
    perturbation, which silently fails when a column's values are within
    a few ulps. The decomposition only ever copies coordinates (no
    arithmetic on them), so ``unmap`` restores the ORIGINAL values on box
    corners exactly and the final volumes are exact, not epsilon-shifted.
    Any consistent tie-break yields a valid partition in the
    zero-perturbation limit. Returns (front_t, ref_t, unmap)."""
    front = np.asarray(front, dtype=np.float64)
    n, d = front.shape
    front_t = np.empty_like(front)
    ref_t = np.empty(d)
    maps = []
    for j in range(d):
        col = front[:, j]
        vals = np.unique(np.append(col, ref_point[j]))  # sorted, distinct
        rank = {v: float(i) for i, v in enumerate(vals)}
        back = {}
        new = np.empty(n)
        for v in np.unique(col):
            ties = np.flatnonzero(col == v)
            for i, idx in enumerate(ties):
                tv = rank[v] + i / (n + 2)
                new[idx] = tv
                back[tv] = v
        front_t[:, j] = new
        ref_t[j] = rank[ref_point[j]]
        back[ref_t[j]] = ref_point[j]
        maps.append(back)

    def unmap(arr):
        out = np.array(arr, copy=True)
        for j, back in enumerate(maps):
            out[:, j] = [back.get(v, v) for v in out[:, j]]
        return out

    return front_t, ref_t, unmap


def dominated_boxes(
    front: np.ndarray, ref_point: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Disjoint boxes partitioning the region dominated by `front` within
    the reference box (Lacour et al. eq. (2)): for each local upper bound
    u, B(u) = [z^1_1(u), r_1] x prod_{j>=2} [max_{k<j} z^k_j(u), u_j].
    Degenerate boxes are dropped. Returns (lowers, uppers), each (B, d)."""
    front = np.asarray(front, dtype=np.float64)
    ref_point = np.asarray(ref_point, dtype=np.float64)
    if front.shape[0] == 0:
        return np.zeros((0, len(ref_point))), np.zeros((0, len(ref_point)))
    unmap = None
    for j in range(front.shape[1]):
        if np.unique(front[:, j]).size < front.shape[0]:
            front, ref_lub, unmap = _break_ties(front, ref_point)
            break
    else:
        ref_lub = ref_point
    ubs, defs = local_upper_bounds(front, ref_lub)
    M, d = ubs.shape
    lowers = np.empty((M, d))
    uppers = np.empty((M, d))
    lowers[:, 0] = defs[:, 0, 0]  # z^1_1(u)
    uppers[:, 0] = ref_lub[0]  # in tie-broken rank space until unmapped
    for j in range(1, d):
        lowers[:, j] = np.max(defs[:, :j, j], axis=1)  # max_{k<j} z^k_j(u)
        uppers[:, j] = ubs[:, j]
    if unmap is not None:
        lowers, uppers = unmap(lowers), unmap(uppers)
    valid = np.all(uppers > lowers, axis=1) & np.all(np.isfinite(lowers), axis=1)
    return lowers[valid], uppers[valid]


# ------------------------------------------------------------------- EHVI

_SQRT_2PI = math.sqrt(2.0 * math.pi)


def _psi(lo, hi, m, s):
    """E[(hi - max(Y, lo))+] for Y ~ N(m, s^2), elementwise; lo may be -inf
    (then the term reduces to E[(hi - Y)+])."""
    b = (hi - m) / s
    a = torch.where(torch.isinf(lo), -1e30, (lo - m) / s)
    cdf_a = torch.special.ndtr(a)
    cdf_b = torch.special.ndtr(b)
    pdf_a = torch.exp(-0.5 * a * a) / _SQRT_2PI
    pdf_b = torch.exp(-0.5 * b * b) / _SQRT_2PI
    finite_lo = torch.where(torch.isinf(lo), hi, lo)  # (hi-lo)*cdf_a -> 0 at -inf
    return (
        (hi - finite_lo) * cdf_a
        + (hi - m) * (cdf_b - cdf_a)
        + s * (pdf_b - pdf_a)
    )


def ehvi_batch(lowers, uppers, means, variances, ref_point) -> torch.Tensor:
    """Batched exact expected-hypervolume-improvement (minimization).

    Identity: HVI(y) = vol(dom(y)) - vol(dom(y) & dom(front)), with
    dom(front) partitioned into disjoint boxes (lowers, uppers]. Both
    terms factorize over independent per-objective Gaussians:

        EHVI = prod_j E[(r_j - Y_j)+]
             - sum_k prod_j E[(u_kj - max(Y_j, l_kj))+]

    One (candidates x boxes x objectives) expression over tensors on one
    device. Shapes: lowers/uppers (B, d); means/variances (C, d); ref
    (d,) -> (C,).
    """
    std = torch.sqrt(torch.clamp(variances, min=1e-12))  # (C, d)
    total = torch.prod(
        _psi(torch.full_like(means, -torch.inf), ref_point[None, :], means, std),
        dim=1,
    )  # (C,)
    if lowers.shape[0] == 0:
        return total
    m = means[:, None, :]  # (C, 1, d)
    s = std[:, None, :]
    overlap = torch.prod(
        _psi(lowers[None, :, :], uppers[None, :, :], m, s), dim=2
    )  # (C, B)
    return total - torch.sum(overlap, dim=1)


class HyperVolumeBoxDecomposition:
    """EHVI candidate selector over the staircase decomposition, API-
    compatible with the reference class used by CMAES/TRS selection
    (reference: hv_box_decomposition.py:62-416). The EHVI scores are
    computed on ``device`` (None means CUDA)."""

    def __init__(self, ref_point, device=None):
        self.ref_point = np.asarray(ref_point, dtype=np.float64)
        self.d = len(self.ref_point)
        self.device = device

    def compute_hypervolume(self, points) -> float:
        return hypervolume_exact(points, self.ref_point)

    def select_candidates(
        self,
        pareto_front: np.ndarray,
        candidate_means: np.ndarray,
        candidate_variances: np.ndarray,
        n_select: int = 1,
        batch_size: int = 100,
    ):
        """Top-`n_select` candidates by exact EHVI. Returns
        (indices, scores)."""
        candidate_means = np.asarray(candidate_means, dtype=np.float64)
        candidate_variances = np.asarray(candidate_variances, dtype=np.float64)
        pareto_front = np.asarray(pareto_front, dtype=np.float64)
        if len(pareto_front) > 0:
            pareto_front = _filter_dominated(
                pareto_front[np.all(pareto_front < self.ref_point, axis=1)]
            )
        lowers, uppers = dominated_boxes(pareto_front, self.ref_point)
        dev = resolve_device(self.device)

        def f32(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)

        scores = ehvi_batch(
            f32(lowers), f32(uppers), f32(candidate_means),
            f32(candidate_variances), f32(self.ref_point),
        ).cpu().numpy()
        selected = np.argsort(-scores)[:n_select].copy()
        return selected, scores[selected]


# ------------------------------------------------------------------ facade


def default_reference_point(Y) -> np.ndarray:
    """Nadir-anchored reference point with a span-proportional margin:
    ``nadir + 0.1 * span`` (falling back to ``|nadir| + 1`` per
    degenerate axis), valid for objectives of any sign. Shared by the
    benchmark runner and the analyze CLI so their hypervolumes agree."""
    Y = np.asarray(Y)
    nadir = Y.max(axis=0)
    span = nadir - Y.min(axis=0)
    margin = np.where(span > 0, span, np.abs(nadir) + 1.0)
    return nadir + 0.1 * margin + 1e-9


class AdaptiveHyperVolume:
    """Routing facade (reference: dmosopt/hv.py:77-189 plus the
    hv_adaptive.py estimator family): exact computation for low
    dimension / small fronts; above that, the CI-target-driven FPRAS
    estimator when ``epsilon`` is set (adaptive sample counts, QMC
    variance reduction), else fixed-budget rejection Monte Carlo. The
    estimators draw from one `torch.Generator` seeded with ``seed``, on
    ``device`` (None means CUDA); the exact path needs no device."""

    def __init__(
        self,
        ref_point,
        exact_dim_threshold: int = 10,
        exact_size_threshold: int = 300,
        mc_samples: int = 100_000,
        epsilon: Optional[float] = None,
        max_mc_samples: int = 2_000_000,
        qmc: bool = True,
        seed: int = 0,
        device=None,
    ):
        self.ref_point = np.asarray(ref_point, dtype=np.float64)
        self.d = len(self.ref_point)
        self.exact_dim_threshold = exact_dim_threshold
        self.exact_size_threshold = exact_size_threshold
        self.mc_samples = mc_samples
        self.epsilon = epsilon
        self.max_mc_samples = max_mc_samples
        self.qmc = qmc
        self.seed = seed
        self.device = device
        self._generator = None
        self.last_method = None
        self.last_ci = 0.0
        self.last_n_samples = 0

    def _use_exact(self, n: int) -> bool:
        if self.d <= 2:
            return True
        return (
            self.d < self.exact_dim_threshold and n <= self.exact_size_threshold
        )

    def compute_hypervolume(self, points) -> float:
        return self.compute_hypervolume_with_confidence(points)[0]

    def compute_hypervolume_with_confidence(self, points):
        """Returns (estimate, ci_halfwidth); exact results have zero CI."""
        points = np.asarray(points, dtype=np.float64)
        n = points.shape[0] if points.ndim == 2 else 0
        self.last_ci = 0.0
        self.last_n_samples = 0
        if n == 0:
            self.last_method = "exact"
            return 0.0, 0.0
        if self._use_exact(n):
            self.last_method = "exact"
            return hypervolume_exact(points, self.ref_point), 0.0
        dev = resolve_device(self.device)
        if self._generator is None:
            self._generator = torch.Generator(device=dev).manual_seed(self.seed)
        if self.epsilon is not None:
            self.last_method = "fpras"
            est, (ci, ns) = hypervolume_fpras(
                points,
                self.ref_point,
                epsilon=self.epsilon,
                generator=self._generator,
                max_samples=self.max_mc_samples,
                qmc=self.qmc,
                return_info=True,
                device=dev,
            )
            self.last_ci = ci
            self.last_n_samples = ns
            return est, ci
        self.last_method = "mc"
        est, ci = hypervolume_mc(
            points, self.ref_point, n_samples=self.mc_samples,
            generator=self._generator, return_ci=True, device=dev,
        )
        self.last_n_samples = self.mc_samples
        self.last_ci = ci
        return est, ci

    __call__ = compute_hypervolume
