"""Sparse variational GP surrogates: the SVGP family of the JAX package.

Port of ``dmosopt_tpu/models/svgp.py`` (reference `dmosopt/model.py:98-1048`,
the GPflow family): `VGP_Matern` (inducing set = training set),
`SVGP_Matern` and `SIV_Matern` (shared kernel and inducing set),
`SPV_Matern` (a kernel and an inducing set per output) and `CRV_Matern`
(outputs mixed from latent GPs by a learned W). One trainer, `fit_svgp`,
maximizes the uncollapsed Hensman bound with a Gaussian likelihood over
whitened variational parameters (u = L_uu v, q(v) = N(vm, vL vLᵀ)).

The Q latent GPs sit on a leading batch axis of every tensor. A shared
kernel (Qk = 1) or a shared inducing set (Qz = 1) is a batch axis of one
that broadcasts, so a shared K_uu is built and factored once a step, not
once per latent. The differences from the JAX package:

- Random draws are arguments: the inducing rows ``inducing_idx``
  (Qz, M), the minibatch rows ``batch_idx`` (n_iter, B) and CRV's
  ``W0`` (d, Q). By default they come from the fit's `torch.Generator`,
  so a fit here and a JAX fit with the same seed use different rows; the
  tests inject the JAX draws.
- The Adam steps are a Python loop with no host sync: the minibatch
  rows are drawn up front, K_uu is factored by `cholesky_ex` (NaN on
  failure, as `jnp.linalg.cholesky`), and the final ELBO stays on the
  device until the caller reads it.
- Adam is `gp._Adam` (optax's numerics) and the last iterate is returned,
  as ``optax.adam`` in the JAX package: no NaN masking, no best iterate.
- `SVGPFit` carries the factor of K_uu at the fitted parameters
  (``Luu``), made once after the fit, so a prediction does not refactor
  it (the JAX package does at every call); the numbers are the same.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from dmosopt_tpu_torch.models.gp import (
    _KERNELS,
    SurrogateBase,
    _Adam,
    _Bounds,
    _cholesky_or_nan,
    _make_bounds,
    _prepare_training_data,
)
from dmosopt_tpu_torch.utils.prng import as_torch_generator

_JITTER = 1e-5
_LOG2PI = math.log(2.0 * math.pi)


class SVGPParams(NamedTuple):
    """Trainable state. Leading axis Q = number of latent GPs; Qk and Qz
    are 1 when the kernel or the inducing set is shared, else Q."""

    u_amp: torch.Tensor  # (Qk,)
    u_ls: torch.Tensor  # (Qk, L)
    u_noise: torch.Tensor  # (d,) one observation noise per output
    Z: torch.Tensor  # (Qz, M, n) inducing locations
    vm: torch.Tensor  # (Q, M) whitened variational mean
    vL: torch.Tensor  # (Q, M, M) whitened variational scale (used through tril)
    W: Optional[torch.Tensor]  # (d, Q) mixing matrix or None


@dataclass
class SVGPFit:
    params: SVGPParams
    bounds_amp: _Bounds
    bounds_ls: _Bounds
    bounds_noise: _Bounds
    elbo: torch.Tensor
    kernel: str = "matern52"
    # (Qb, M, M) factor of K_uu at the fitted parameters, Qb = max(Qk, Qz)
    Luu: Optional[torch.Tensor] = None


def _kuu_factor(amp, ls, Z, kernel_fn):
    """Lower factor of K_uu + 1e-5·amp·I for each distinct (kernel,
    inducing set) pair: (Qb, M, M), NaN where not positive definite."""
    M = Z.shape[-2]
    eye = torch.eye(M, dtype=Z.dtype, device=Z.device)
    Kuu = kernel_fn(Z, Z, ls, amp) + (_JITTER * amp)[:, None, None] * eye
    return _cholesky_or_nan(Kuu)


def _latent_moments(amp, ls, Z, vm, vL, Xq, kernel_fn, Luu=None):
    """q(f) moments of the Q latent GPs at queries Xq (B, n), reference
    ``_latent_moments`` (svgp.py:71-84) batched over the latents:
    mean = Ksu L_uu⁻ᵀ vm, var = k_ss − ‖a‖² + ‖vLᵀ a‖², a = L_uu⁻¹ K_us.
    amp (Qk,), ls (Qk, L), Z (Qz, M, n), vm (Q, M), vL (Q, M, M);
    ``Luu`` is `_kuu_factor`'s, made here when not given. Returns
    (mean, var), each (Q, B)."""
    if Luu is None:
        Luu = _kuu_factor(amp, ls, Z, kernel_fn)
    Kus = kernel_fn(Z, Xq, ls, amp)  # (Qb, M, B)
    a = torch.linalg.solve_triangular(Luu, Kus, upper=False)  # (Qb, M, B)
    mean = torch.matmul(vm[:, None, :], a)[:, 0, :]  # (Q, B)
    # stationary kernels: k(x, x) = amp
    var = (
        amp[:, None]
        - torch.sum(a * a, dim=-2)
        + torch.sum(torch.matmul(torch.tril(vL).mT, a) ** 2, dim=-2)
    )
    return mean, torch.clamp(var, min=1e-10)


def _kl_whitened(vm, vL):
    """KL(q(v) ‖ N(0, I)) of each latent's whitened variational
    parameters (svgp.py:87-92). vm (Q, M), vL (Q, M, M); returns (Q,)."""
    L = torch.tril(vL)
    diag = torch.diagonal(L, dim1=-2, dim2=-1)
    logdet = torch.sum(torch.log(torch.clamp(diag * diag, min=1e-20)), dim=-1)
    trace = torch.sum(L * L, dim=(-2, -1))
    return 0.5 * (trace + torch.sum(vm * vm, dim=-1) - vm.shape[-1] - logdet)


def _unpack(params: SVGPParams, b_amp, b_ls, b_noise):
    return (b_amp.forward(params.u_amp), b_ls.forward(params.u_ls),
            b_noise.forward(params.u_noise))


def _mix(params: SVGPParams, means, variances):
    """Output moments (d, B) from the latents' (Q, B)."""
    if params.W is None:
        return means, variances  # Q == d
    return params.W @ means, (params.W ** 2) @ variances


def _elbo(params: SVGPParams, b_amp, b_ls, b_noise, Xb, Yb, N, kernel_fn):
    """Minibatch evidence lower bound (svgp.py:102-132): Xb (B, n), Yb
    (B, d), the likelihood scaled by N / B."""
    amp, ls, noise = _unpack(params, b_amp, b_ls, b_noise)
    B = Yb.shape[0]
    means, variances = _latent_moments(
        amp, ls, params.Z, params.vm, params.vL, Xb, kernel_fn
    )
    f_mean, f_var = _mix(params, means, variances)
    err = Yb.T - f_mean  # (d, B)
    lik = -0.5 * (
        _LOG2PI + torch.log(noise)[:, None] + (err ** 2 + f_var) / noise[:, None]
    )
    kl = _kl_whitened(params.vm, params.vL).sum()
    return (N / B) * torch.sum(lik) - kl


def _draw_rows(generator, n_rows, N, k, device):
    """``n_rows`` independent draws of k of N row indices without
    replacement (each row of the result a random k-subset, a random
    permutation when k == N), in one sort: (n_rows, k) int64."""
    u = torch.rand((n_rows, N), generator=generator, device=device)
    return torch.argsort(u, dim=1)[:, :k]


def fit_svgp(
    generator: torch.Generator,
    X: torch.Tensor,  # (N, n) unit box
    Y: torch.Tensor,  # (N, d) standardized targets
    n_inducing: int,
    n_latent: Optional[int] = None,
    share_kernel: bool = False,
    share_inducing: bool = True,
    kernel: str = "matern52",
    lengthscale_bounds=(1e-3, 100.0),
    amplitude_bounds=(1e-4, 1e3),
    noise_bounds=(1e-6, 1.0),
    ard: bool = False,
    batch_size: int = 256,
    n_iter: int = 400,
    learning_rate: float = 0.05,
    inducing_idx: Optional[torch.Tensor] = None,
    batch_idx: Optional[torch.Tensor] = None,
    W0: Optional[torch.Tensor] = None,
) -> SVGPFit:
    """Fit the SVGP family (reference `fit_svgp`, svgp.py:135-219): Q latent
    GPs (the d outputs, unless ``n_latent`` sets a coregionalization),
    kernels and inducing sets shared or one per latent, ``n_iter`` Adam
    steps on minibatches of B = min(batch_size, N) rows, the final ELBO
    on the first min(N, 1024) rows.

    The inducing rows (``inducing_idx`` (Qz, M), unused when M == N),
    each step's minibatch rows (``batch_idx`` (n_iter, B)) and CRV's
    initial mixing matrix (``W0`` (d, Q)) are drawn from ``generator``
    unless given."""
    N, n = X.shape
    d = Y.shape[1]
    dt, dev = X.dtype, X.device
    Q = n_latent if n_latent is not None else d
    coreg = n_latent is not None
    M = min(n_inducing, N)
    Lls = n if ard else 1

    b_amp = _make_bounds(amplitude_bounds, dt, dev)
    b_ls = _make_bounds(lengthscale_bounds, dt, dev)
    b_noise = _make_bounds(noise_bounds, dt, dev)
    kernel_fn = _KERNELS[kernel]

    Qk = 1 if share_kernel else Q
    Qz = 1 if share_inducing else Q

    # inducing points: a distinct random training subset per inducing set
    # (the whole training set, in order, when M == N: VGP)
    if M == N:
        Z0 = X.expand(Qz, M, n).clone()
    else:
        if inducing_idx is None:
            inducing_idx = _draw_rows(generator, Qz, N, M, dev)
        Z0 = X[inducing_idx.to(dev)]  # (Qz, M, n)
    W = None
    if coreg:
        if W0 is None:
            W0 = 0.1 * torch.randn((d, Q), generator=generator, dtype=dt, device=dev)
            W0 = W0 + torch.eye(d, Q, dtype=dt, device=dev)
        W = torch.as_tensor(W0, dtype=dt, device=dev).clone()

    def init(b, value, shape):
        return b.inverse(torch.tensor(value, dtype=dt, device=dev)).expand(shape).clone()

    leaves = [
        init(b_amp, 1.0, (Qk,)),
        init(b_ls, 0.5, (Qk, Lls)),
        init(b_noise, 0.05, (d,)),
        Z0,
        torch.zeros((Q, M), dtype=dt, device=dev),
        torch.eye(M, dtype=dt, device=dev).expand(Q, M, M).clone(),
    ] + ([W] if coreg else [])

    def as_params(ls_):
        return SVGPParams(*ls_[:6], ls_[6] if coreg else None)

    B = min(batch_size, N)
    if batch_idx is None:
        batch_idx = _draw_rows(generator, n_iter, N, B, dev)
    batch_idx = batch_idx.to(dev)

    opt = _Adam(leaves, learning_rate)
    for t in range(n_iter):
        sel = batch_idx[t]
        with torch.enable_grad():
            req = [p.detach().requires_grad_(True) for p in leaves]
            loss = -_elbo(as_params(req), b_amp, b_ls, b_noise, X[sel], Y[sel],
                          N, kernel_fn)
            grads = torch.autograd.grad(loss, req)
        leaves = opt.update(leaves, grads)

    params = as_params([p.detach() for p in leaves])
    nb = min(N, 1024)
    with torch.no_grad():
        elbo = _elbo(params, b_amp, b_ls, b_noise, X[:nb], Y[:nb], N, kernel_fn)
        amp, ls, _ = _unpack(params, b_amp, b_ls, b_noise)
        Luu = _kuu_factor(amp, ls, params.Z, kernel_fn)
    return SVGPFit(params, b_amp, b_ls, b_noise, elbo, kernel, Luu)


def svgp_predict(fit: SVGPFit, Xq: torch.Tensor):
    """Posterior mean and variance per output at Xq (svgp.py:222-249),
    with the fit's kernel and its cached K_uu factor. Returns ((B, d),
    (B, d)); the variance includes the observation noise."""
    params = fit.params
    amp, ls, noise = _unpack(params, fit.bounds_amp, fit.bounds_ls, fit.bounds_noise)
    means, variances = _latent_moments(
        amp, ls, params.Z, params.vm, params.vL, Xq, _KERNELS[fit.kernel],
        Luu=fit.Luu,
    )
    f_mean, f_var = _mix(params, means, variances)
    return f_mean.T, (f_var + noise[:, None]).T


# ---------------------------------------------------------------- wrappers


class _SVGPBase(SurrogateBase):
    """Shared wrapper (svgp.py:252-332): the reference surrogate interface
    (``predict`` -> (mean, var), ``evaluate``), unit-box x normalization
    and per-objective y standardization (model.py:1216-1229). The
    inducing set holds max(int(inducing_fraction·N), min_inducing) rows,
    at most N (N for `VGP_Matern`). Float32; ``device`` None means CUDA.
    The fit is cold every epoch: the refit controller does not cover this
    family."""

    kernel = "matern52"
    share_kernel = False
    share_inducing = True
    n_latent_factor: Optional[float] = None  # CRV: latents = ceil(d * factor)
    full_inducing = False  # VGP: inducing = all training points

    def __init__(
        self,
        xin,
        yin,
        nInput,
        nOutput,
        xlb,
        xub,
        seed=None,
        inducing_fraction: float = 0.25,
        min_inducing: int = 100,
        batch_size: int = 256,
        n_iter: int = 400,
        learning_rate: float = 0.05,
        anisotropic: bool = False,
        num_latent_gps: Optional[int] = None,
        return_mean_variance: bool = False,
        nan: Optional[str] = "remove",
        top_k: Optional[int] = None,
        logger=None,
        device=None,
        **kwargs,
    ):
        self._init_surface(device, torch.float32, return_mean_variance, logger)
        dev = self.device
        X, Yn, y_mean, y_std = _prepare_training_data(
            self, xin, yin, nInput, nOutput, xlb, xub, nan, top_k
        )
        self._set_bounds_tensors()
        N = X.shape[0]
        if self.full_inducing:
            n_inducing = N
        else:
            # reference sizing (model.py:813-818)
            n_inducing = min(max(int(inducing_fraction * N), min_inducing), N)
        n_latent = None
        if self.n_latent_factor is not None:
            n_latent = num_latent_gps or max(
                1, int(np.ceil(nOutput * self.n_latent_factor))
            )
        fit = fit_svgp(
            as_torch_generator(seed, dev),
            torch.as_tensor(X.astype(np.float32), device=dev),
            torch.as_tensor(Yn.astype(np.float32), device=dev),
            n_inducing=n_inducing,
            n_latent=n_latent,
            share_kernel=self.share_kernel,
            share_inducing=self.share_inducing,
            kernel=self.kernel,
            ard=bool(anisotropic),
            batch_size=batch_size,
            n_iter=n_iter,
            learning_rate=learning_rate,
        )
        self.fit = fit
        self.y_mean = torch.as_tensor(y_mean, dtype=torch.float32, device=dev)
        self.y_std = torch.as_tensor(y_std, dtype=torch.float32, device=dev)
        # the fixed-length Adam loop; the loss is the negative final ELBO
        # (lower is better, as the exact GP's NMLL); the one host read
        self.fit_info = {
            "loss": -float(fit.elbo),
            "n_steps": int(n_iter),
            "n_iter_max": int(n_iter),
            "early_stopped": False,
            "n_inducing": int(n_inducing),
        }

    def predict_normalized(self, Xq):
        mean, var = svgp_predict(self.fit, Xq)
        return self.y_mean + self.y_std * mean, (self.y_std ** 2) * var


class VGP_Matern(_SVGPBase):
    """Full variational GP: inducing points = training points
    (reference model.py:991-1180)."""

    full_inducing = True


class SVGP_Matern(_SVGPBase):
    """Sparse variational GP, shared kernel and inducing locations,
    independent variational posteriors (reference model.py:769-988)."""

    share_kernel = True
    share_inducing = True


class SPV_Matern(_SVGPBase):
    """A kernel and an inducing set per output (reference model.py:547-766)."""

    share_kernel = False
    share_inducing = False


class SIV_Matern(_SVGPBase):
    """Shared inducing variables and kernel (reference model.py:328-544)."""

    share_kernel = True
    share_inducing = True


class CRV_Matern(_SVGPBase):
    """Linear coregionalization: outputs mix ``num_latent_gps`` latent GPs
    through a learned W (reference model.py:98-325)."""

    share_kernel = False
    share_inducing = True
    n_latent_factor = 1.0
