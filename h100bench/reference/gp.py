"""The surrogate the configurations state, in float64 plain torch.

An independent GP per objective with a Matern-5/2 kernel on the unit box,
targets standardised by their mean and (population) standard deviation,
and the regularisation ``noise + 1e-6 + rel_jitter * amplitude`` on the
diagonal (``rel_jitter`` 1e-4 for a float32 surrogate). Hyperparameters
live in a bounded log-uniform parameterisation ``lo * (hi / lo) **
sigmoid(u)``, in which the fit runs Adam. These functions take the
hyperparameters the program found and work out, from the reference's own
training set, the marginal likelihood and the posterior mean there.
"""

from __future__ import annotations

import math

import torch

_JITTER = 1e-6
_LOG2PI = math.log(2.0 * math.pi)


def _tf32(t):
    """``t`` rounded to TF32's 10-bit mantissa (what a TF32 matrix product
    does to its operands)."""
    i = t.float().contiguous().view(torch.int32)
    i = (i + 0x1000) & ~0x1FFF
    return i.view(torch.float32)


def _matmul(a, b, tf32):
    if tf32:
        return torch.matmul(_tf32(a), _tf32(b))
    return torch.matmul(a, b)


def matern52(X1, X2, ls, amp, tf32=False):
    """(d, N, M) kernel matrices for lengthscales ``ls`` (d, L) and
    amplitudes ``amp`` (d,). In the TF32 control the squared distances go
    through a matrix product, as a float32 program would compute them."""
    A = X1[None] / ls[:, None, :]
    B = X2[None] / ls[:, None, :]
    if tf32:
        sq = (A * A).sum(-1)[..., None] + (B * B).sum(-1)[:, None, :] \
            - 2.0 * _matmul(A, B.transpose(-1, -2), True)
        sq = torch.clamp(sq, min=0.0)
    else:
        sq = ((A[:, :, None, :] - B[:, None, :, :]) ** 2).sum(-1)
    r = torch.sqrt(sq + 1e-30)
    s5r = math.sqrt(5.0) * r
    return amp[:, None, None] * (1.0 + s5r + (5.0 / 3.0) * r * r) * torch.exp(-s5r)


class Bounds:
    def __init__(self, lo, hi, dtype, device):
        self.lo = torch.tensor(float(lo), dtype=dtype, device=device)
        self.hi = torch.tensor(float(hi), dtype=dtype, device=device)

    def forward(self, u):
        return self.lo * (self.hi / self.lo) ** torch.sigmoid(u)

    def inverse(self, theta):
        s = torch.log(theta / self.lo) / torch.log(self.hi / self.lo)
        s = torch.clamp(s, 1e-4, 1.0 - 1e-4)
        return torch.log(s) - torch.log1p(-s)


def standardise(Y):
    """(Yn, mean, std) with the population standard deviation, 1 where 0."""
    mean = Y.mean(0)
    std = Y.std(0, unbiased=False)
    std = torch.where(std == 0, torch.ones_like(std), std)
    return (Y - mean) / std, mean, std


def _factor(X, amp, ls, noise, rel_jitter, tf32):
    N = X.shape[0]
    K = matern52(X, X, ls, amp, tf32)
    K = 0.5 * (K + K.transpose(-1, -2))
    diag = noise + _JITTER + rel_jitter * amp
    K = K + diag[:, None, None] * torch.eye(N, dtype=X.dtype, device=X.device)
    L, info = torch.linalg.cholesky_ex(K)
    # a matrix that is not positive definite gives NaN, never a number
    return L * torch.where(info == 0, 1.0, torch.nan).to(L.dtype)[:, None, None]


def nmll(X, Yn, amp, ls, noise, rel_jitter=1e-4, tf32=False):
    """Negative log marginal likelihood of each objective's GP: (d,)."""
    L = _factor(X, amp, ls, noise, rel_jitter, tf32)
    y = Yn.transpose(0, 1)[..., None]
    alpha = torch.cholesky_solve(y, L)[..., 0]
    return (0.5 * (y[..., 0] * alpha).sum(-1)
            + torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
            + 0.5 * X.shape[0] * _LOG2PI)


def posterior_mean(X, Yn, mean, std, amp, ls, noise, Xq, rel_jitter=1e-4, tf32=False):
    """Posterior mean at ``Xq`` in the targets' own units: (M, d)."""
    L = _factor(X, amp, ls, noise, rel_jitter, tf32)
    alpha = torch.cholesky_solve(Yn.transpose(0, 1)[..., None], L)
    Kq = matern52(Xq, X, ls, amp, tf32)
    mu = _matmul(Kq, alpha, tf32)[..., 0].transpose(0, 1)
    return mean + std * mu


def nmll_slack(X, Yn, amp, ls, noise, bounds, lr, n_steps, rel_jitter=1e-4):
    """How far Adam, started at the given hyperparameters in the bounded
    parameterisation, lowers each objective's NMLL in ``n_steps`` steps:
    (NMLL there - best NMLL seen) / max(1, |NMLL there|), at least 0. A
    fitted GP sits near a minimum and reads near 0."""
    b_amp, b_ls, b_noise = bounds
    start = nmll(X, Yn, amp, ls, noise, rel_jitter).detach()
    u = [b_amp.inverse(amp).detach().clone(), b_ls.inverse(ls).detach().clone(),
         b_noise.inverse(noise).detach().clone()]
    mom = [torch.zeros_like(p) for p in u]
    vel = [torch.zeros_like(p) for p in u]
    best = start.clone()
    b1, b2, eps = 0.9, 0.999, 1e-8
    for k in range(1, n_steps + 1):
        leaves = [p.requires_grad_(True) for p in u]
        with torch.enable_grad():
            vals = nmll(X, Yn, b_amp.forward(leaves[0]), b_ls.forward(leaves[1]),
                        b_noise.forward(leaves[2]), rel_jitter)
            finite = torch.isfinite(vals)
            grads = torch.autograd.grad(torch.where(finite, vals, 0.0).sum(), leaves)
        best = torch.where(finite & (vals.detach() < best), vals.detach(), best)
        new = []
        for i, (p, g) in enumerate(zip(u, grads)):
            g = torch.nan_to_num(g)
            mom[i] = (1 - b1) * g + b1 * mom[i]
            vel[i] = (1 - b2) * g * g + b2 * vel[i]
            step = lr * (mom[i] / (1 - b1 ** k)) / (torch.sqrt(vel[i] / (1 - b2 ** k)) + eps)
            new.append((p - step).detach())
        u = new
    slack = (start - best) / torch.clamp(start.abs(), min=1.0)
    return torch.clamp(slack, min=0.0)
