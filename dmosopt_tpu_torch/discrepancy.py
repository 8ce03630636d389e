"""Centered L2 discrepancy, the score of GLP's design search.

Port of ``CD2`` in ``dmosopt_tpu/discrepancy.py:26-40`` (Hickernell 1998;
reference dmosopt/discrepancy.py), with the pairwise products broadcast
over a leading batch of candidate designs.
"""

import torch


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
        - 0.5 * torch.abs(X[..., :, None, :] - X[..., None, :, :])
    )
    D3 = torch.prod(pair, dim=-1).sum((-2, -1))
    return torch.sqrt(D1 - 2.0 * D2 / num + D3 / num**2)
