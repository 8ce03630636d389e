"""L2 discrepancy and uniformity metrics of a design.

Port of ``dmosopt_tpu/discrepancy.py:15-87`` (Hickernell 1998; reference
dmosopt/discrepancy.py:38-151): `MD2`, `CD2`, `SD2`, `WD2`, `MinDist`,
`corrscore` and `all_metrics`, with the pairwise products broadcast over
a leading batch of candidate designs (GLP's design search scores its
lattices with `CD2`).
"""

import numpy as np
import torch


def _pair(X: torch.Tensor) -> torch.Tensor:
    """(..., num, num, dim) absolute pairwise differences."""
    return torch.abs(X[..., :, None, :] - X[..., None, :, :])


def MD2(X: torch.Tensor) -> torch.Tensor:
    """Modified L2-discrepancy of each (num, dim) design in ``X``."""
    num, dim = X.shape[-2:]
    D1 = (4.0 / 3.0) ** dim
    D2 = torch.prod(3.0 - X**2, dim=-1).sum(-1)
    pair_max = torch.maximum(X[..., :, None, :], X[..., None, :, :])
    D3 = torch.prod(2.0 - pair_max, dim=-1).sum((-2, -1))
    return torch.sqrt(D1 - D2 * (2.0 ** (1 - dim)) / num + D3 / num**2)


def CD2(X: torch.Tensor) -> torch.Tensor:
    """Centered L2-discrepancy of each (num, dim) design in ``X`` (..., num,
    dim), computed in ``X``'s dtype."""
    num, dim = X.shape[-2:]
    D1 = (13.0 / 12.0) ** dim
    a = torch.abs(X - 0.5)
    D2 = torch.prod(1.0 + 0.5 * a - 0.5 * a**2, dim=-1).sum(-1)
    pair = (
        1.0
        + 0.5 * a[..., :, None, :]
        + 0.5 * a[..., None, :, :]
        - 0.5 * _pair(X)
    )
    D3 = torch.prod(pair, dim=-1).sum((-2, -1))
    return torch.sqrt(D1 - 2.0 * D2 / num + D3 / num**2)


def SD2(X: torch.Tensor) -> torch.Tensor:
    """Symmetric L2-discrepancy."""
    num, dim = X.shape[-2:]
    D1 = (4.0 / 3.0) ** dim
    D2 = torch.prod(1.0 + 2.0 * X - 2.0 * X**2, dim=-1).sum(-1)
    D3 = torch.prod(1.0 - _pair(X), dim=-1).sum((-2, -1))
    return torch.sqrt(D1 - 2.0 * D2 / num + D3 * (2.0**dim) / num**2)


def WD2(X: torch.Tensor) -> torch.Tensor:
    """Wrap-around L2-discrepancy."""
    num, dim = X.shape[-2:]
    diff = _pair(X)
    D3 = torch.prod(1.5 - diff * (1.0 - diff), dim=-1).sum((-2, -1))
    return torch.sqrt(-((4.0 / 3.0) ** dim) + D3 / num**2)


def MinDist(X: torch.Tensor) -> torch.Tensor:
    """Minimum point-to-point distance (to be maximized)."""
    n = X.shape[-2]
    sq = torch.sum((X[..., :, None, :] - X[..., None, :, :]) ** 2, dim=-1)
    eye = torch.eye(n, dtype=torch.bool, device=X.device)
    sq = torch.where(eye, torch.inf, sq)
    return torch.sqrt(sq.amin((-2, -1)))


def corrscore(X) -> float:
    """Sum of squared upper-triangle correlations (reference computes
    np.corrcoef over rows, dmosopt/discrepancy.py:147-151)."""
    c = np.corrcoef(np.asarray(X))
    return float(np.sum(np.triu(c, 1) ** 2))


def all_metrics(X) -> dict:
    X = torch.as_tensor(X)
    return {
        "MD2": float(MD2(X)),
        "CD2": float(CD2(X)),
        "SD2": float(SD2(X)),
        "WD2": float(WD2(X)),
        "MinDist": float(MinDist(X)),
        "corrscore": corrscore(X),
    }
