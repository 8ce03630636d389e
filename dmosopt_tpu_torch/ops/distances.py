"""Diversity metrics and duplicate detection: crowding distance, the
euclidean metric and the duplicate-row mask.

Port of ``dmosopt_tpu/ops/distances.py`` (`crowding_distance` :26,
`euclidean_distance_metric` :70, `pairwise_distances` :113,
`duplicate_mask` :175). Host-side duplicate detection uses
`moasmo.get_duplicates` (float64 numpy), as the reference does.

The per-objective order is a STABLE sort, as `jnp.argsort` is, so tied
objective values get the same neighbours in both packages. The
scatter-add of the reference becomes a gather through the inverse
permutation, summed over objectives in the reference's order.
"""

from __future__ import annotations

import torch


def _valid_mask(Y: torch.Tensor, mask) -> torch.Tensor:
    if mask is None:
        return torch.ones(Y.shape[:-1], dtype=torch.bool, device=Y.device)
    return mask.to(torch.bool)


def crowding_distance(Y: torch.Tensor, mask=None) -> torch.Tensor:
    """Crowding distance with the reference's conventions
    (dmosopt/indicators.py:12-51): objectives unit-normalized per column,
    boundary points get 1.0 per objective (not inf), interior points the
    neighbour gap ``US[i+1] - US[i-1]``, contributions summed over
    objectives, NaNs zeroed. Invalid (masked) rows return 0 and do not
    perturb neighbours. ``Y`` is (n, d), or (S, n, d) for S independent
    sets (``mask`` then (S, n))."""
    n, d = Y.shape[-2:]
    valid = _valid_mask(Y, mask)
    n_valid = valid.sum(dim=-1)[..., None, None]

    big = torch.finfo(Y.dtype).max  # a Python scalar: no host-to-device copy
    Yv = torch.where(valid[..., None], Y, big)
    lb = Yv.amin(dim=-2, keepdim=True)
    ub = torch.where(valid[..., None], Y, -big).amax(dim=-2, keepdim=True)
    span = torch.where(ub - lb == 0.0, torch.ones_like(ub), ub - lb)
    U = (Yv - lb) / span  # invalid rows ~ +huge, sort to the end

    US, idx = torch.sort(U, dim=-2, stable=True)  # per-objective order

    prev = torch.cat([US[..., :1, :], US[..., :-1, :]], dim=-2)
    nxt = torch.cat([US[..., 1:, :], US[..., -1:, :]], dim=-2)
    gaps = nxt - prev

    pos = torch.arange(n, device=Y.device)[:, None]
    is_boundary = (pos == 0) | (pos == n_valid - 1)
    in_range = pos < n_valid
    DS = torch.where(is_boundary, torch.ones_like(gaps), gaps)
    DS = torch.where(in_range, DS, torch.zeros_like(DS))

    # inverse permutation per column: row i's contribution sits at the
    # position it was sorted to
    inv = torch.empty_like(idx)
    inv.scatter_(-2, idx, pos.expand(idx.shape).contiguous())
    contrib = torch.gather(DS, -2, inv)
    D = torch.zeros(Y.shape[:-1], dtype=Y.dtype, device=Y.device)
    for j in range(d):  # the reference's summation order over objectives
        D = D + contrib[..., j]
    D = torch.nan_to_num(D, nan=0.0, posinf=0.0, neginf=0.0)
    # single-point convention: distance 1.0 (reference indicators.py:23-24)
    D = torch.where(n_valid[..., 0] == 1, torch.ones_like(D), D)
    return torch.where(valid, D, torch.zeros_like(D))


def euclidean_distance_metric(Y: torch.Tensor, mask=None) -> torch.Tensor:
    """Row-wise euclidean norm of unit-normalized objectives
    (reference: dmosopt/indicators.py:54-62); accepts a leading batch
    axis as `crowding_distance` does."""
    valid = _valid_mask(Y, mask)
    big = torch.finfo(Y.dtype).max
    lb = torch.where(valid[..., None], Y, big).amin(dim=-2, keepdim=True)
    ub = torch.where(valid[..., None], Y, -big).amax(dim=-2, keepdim=True)
    span = torch.where(ub - lb == 0.0, torch.ones_like(ub), ub - lb)
    U = (Y - lb) / span
    out = torch.sqrt(torch.sum(U**2, dim=-1))
    return torch.where(valid, out, torch.zeros_like(out))


def _default_row_chunk(n: int) -> int:
    """Row-block size of the chunked duplicate mask: the whole array up
    to 1024 rows (one block is the dense form), 1024 beyond."""
    return n if n <= 1024 else 1024


def _pairwise_block(X, Y, y2):
    x2 = torch.sum(X * X, dim=1, keepdim=True)
    # full float32 product (TF32 stays off): the identity cancels
    sq = x2 + y2.T - 2.0 * torch.matmul(X, Y.T)
    return torch.sqrt(torch.clamp(sq, min=0.0))


def pairwise_distances(X: torch.Tensor, Y=None, row_chunk=None) -> torch.Tensor:
    """Euclidean cdist (N, M) as the matmul identity
    ``|x|² + |y|² - 2 x·y`` (clamped at 0), computed in ``row_chunk``-row
    blocks so the working set beyond the output stays bounded (one block
    up to 1024 rows), as the reference computes it."""
    if Y is None:
        Y = X
    B = int(row_chunk) if row_chunk is not None else _default_row_chunk(X.shape[0])
    y2 = torch.sum(Y * Y, dim=1, keepdim=True)
    if B >= X.shape[0]:
        return _pairwise_block(X, Y, y2)
    return torch.cat(
        [_pairwise_block(X[i:i + B], Y, y2) for i in range(0, X.shape[0], B)]
    )


def _duplicate_mask_dense(X, eps, mask):
    n = X.shape[-2]
    D = torch.sqrt(torch.sum((X[..., :, None, :] - X[..., None, :, :]) ** 2, dim=-1))
    iu = torch.ones((n, n), dtype=torch.bool, device=X.device).triu(1)  # j > i
    near = iu & ~torch.isnan(D) & (D <= eps)
    if mask is not None:
        valid = mask.to(torch.bool)
        near = near & valid[..., :, None] & valid[..., None, :]
    return near.any(dim=-2)


def _duplicate_mask_chunked(X, eps, mask, chunk: int):
    n = X.shape[-2]
    valid = (torch.ones(X.shape[:-1], dtype=torch.bool, device=X.device)
             if mask is None else mask.to(torch.bool))
    col = torch.arange(n, device=X.device)
    dup = torch.zeros(X.shape[:-1], dtype=torch.bool, device=X.device)
    for i0 in range(0, n, chunk):
        Xi = X[..., i0:i0 + chunk, :]
        # exact differences (not the matmul identity), so identical rows
        # are exactly 0 apart; (chunk, n) live, never (n, n, f)
        D = torch.sqrt(torch.sum((Xi[..., :, None, :] - X[..., None, :, :]) ** 2, dim=-1))
        gi = col[i0:i0 + chunk]
        near = (gi[:, None] < col[None, :]) & ~torch.isnan(D) & (D <= eps)
        near = near & valid[..., i0:i0 + chunk, None] & valid[..., None, :]
        dup = dup | near.any(dim=-2)
    return dup


def duplicate_mask(X: torch.Tensor, eps: float = 1e-16, mask=None,
                   chunk=None) -> torch.Tensor:
    """Mark rows that duplicate an earlier row (within ``eps`` euclidean
    distance), as reference dmosopt/MOEA.py:426-436 does: only the upper
    triangle (j > i) marks j as a duplicate of i, NaN distances are
    ignored, and rows with ``mask`` False neither mark nor are marked.
    Up to one chunk (1024 rows by default) the mask is one dense
    comparison; larger inputs stream row blocks so (n, n, f) never
    exists. A leading batch axis (S, n, f) marks each set on its own."""
    B = int(chunk) if chunk is not None else _default_row_chunk(X.shape[-2])
    if B >= X.shape[-2]:
        return _duplicate_mask_dense(X, eps, mask)
    return _duplicate_mask_chunked(X, eps, mask, B)
