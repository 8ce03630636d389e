"""Deep-kernel GP surrogates: nonstationary modelling through a learned warp.

Port of ``dmosopt_tpu/models/deep_gp.py`` (reference
`dmosopt/model_gpytorch.py`: `MDGP_Matern` :1308, `MDSPP_Matern` :991).
A small MLP (``torch.matmul`` and ``tanh``, with a skip connection)
warps the inputs into a feature space where an exact Matérn GP per
objective is fitted; the MLP weights and the GP hyperparameters are
trained together by Adam on the summed exact NMLL, the d objectives on a
leading batch axis. `MDSPP_Matern` is the same model trained on random
minibatches.

The differences from the JAX package:

- The MLP's initial weights (``mlp_init``) and the minibatch rows
  (``batch_idx`` (n_iter, B)) are arguments; by default they come from
  the fit's `torch.Generator`, so a fit here and a JAX fit with the same
  seed start from different weights; the tests inject the JAX draws.
- Adam is `gp._Adam` (optax's numerics), the last iterate is returned,
  and a kernel that is not positive definite makes the loss, the
  gradients and so the parameters NaN, as in the JAX package.
- The loss history stays on the device; with ``early_stopping`` it is
  copied to the host once per chunk of ``max(n_iter // 8, 25)`` steps
  for the stopping check, else once when the fit ends.
- The fit records the steps it ran (``n_steps``), which the models'
  ``fit_info`` reports.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from dmosopt_tpu_torch.models.early_stopping import (
    AdaptiveEarlyStopping,
    EarlyStoppingConfig,
    ModelType,
)
from dmosopt_tpu_torch.models.gp import (
    _KERNELS,
    SurrogateBase,
    _Adam,
    _Bounds,
    _cho_solve,
    _cholesky_or_nan,
    _make_bounds,
    _prepare_training_data,
    _regularized_kernel,
)
from dmosopt_tpu_torch.models.svgp import _draw_rows
from dmosopt_tpu_torch.utils.prng import as_torch_generator

_LOG2PI = math.log(2.0 * math.pi)


class MLPParams(NamedTuple):
    weights: tuple  # per layer (in, out)
    biases: tuple  # per layer (out,)


class DeepGPParams(NamedTuple):
    mlp: MLPParams
    u_amp: torch.Tensor  # (d,)
    u_ls: torch.Tensor  # (d, L)
    u_noise: torch.Tensor  # (d,)


@dataclass
class DeepGPFit:
    params: DeepGPParams
    X: torch.Tensor  # (N, n) training inputs (unit box)
    F: torch.Tensor  # (N, k) warped training features
    L: torch.Tensor  # (d, N, N) Cholesky factors on the warped features
    alpha: torch.Tensor  # (d, N)
    y_mean: torch.Tensor
    y_std: torch.Tensor
    bounds_amp: _Bounds
    bounds_ls: _Bounds
    bounds_noise: _Bounds
    nmll: torch.Tensor  # the last step's loss
    n_steps: int = 0  # Adam steps run


def _init_mlp(generator, sizes: Sequence[int], dtype=torch.float32,
              device=None) -> MLPParams:
    """He-scaled normal weights and zero biases (deep_gp.py:76-82)."""
    ws, bs = [], []
    for m, n in zip(sizes[:-1], sizes[1:]):
        ws.append(torch.randn((m, n), generator=generator, dtype=dtype, device=device)
                  * math.sqrt(2.0 / m))
        bs.append(torch.zeros((n,), dtype=dtype, device=device))
    return MLPParams(tuple(ws), tuple(bs))


def _mlp_forward(mlp: MLPParams, X):
    h = X
    n_layers = len(mlp.weights)
    for i, (w, b) in enumerate(zip(mlp.weights, mlp.biases)):
        h = torch.matmul(h, w) + b
        if i < n_layers - 1:
            h = torch.tanh(h)
    # skip connection keeps the identity warp reachable
    if h.shape[1] == X.shape[1]:
        h = h + X
    return h


def _nmll_on_features(F, Y, amp, ls, noise, kernel_fn):
    """Exact NMLL of d GPs on features F (N, k) (deep_gp.py:98-106):
    targets Y (N, d), amp (d,), ls (d, L), noise (d,). Returns (d,); a
    kernel that is not positive definite gives NaN."""
    N = F.shape[0]
    K = _regularized_kernel(F, ls, amp, noise, kernel_fn)  # (d, N, N)
    L = _cholesky_or_nan(K)
    a = torch.linalg.solve_triangular(L, Y.T[..., None], upper=False)[..., 0]
    diag = torch.diagonal(L, dim1=-2, dim2=-1)
    logdet = 2.0 * torch.sum(torch.log(torch.clamp(diag, min=1e-20)), dim=-1)
    return 0.5 * (torch.sum(a * a, dim=-1) + logdet + N * _LOG2PI)


def _unflatten(leaves, n_layers) -> DeepGPParams:
    ws = tuple(leaves[:n_layers])
    bs = tuple(leaves[n_layers:2 * n_layers])
    return DeepGPParams(MLPParams(ws, bs), *leaves[2 * n_layers:])


def fit_deep_gp(
    generator: torch.Generator,
    X: torch.Tensor,  # (N, n) unit box
    Y: torch.Tensor,  # (N, d) standardized targets
    hidden: Sequence[int] = (32, 32),
    feature_dim: Optional[int] = None,
    kernel: str = "matern52",
    lengthscale_bounds=(1e-3, 100.0),
    amplitude_bounds=(1e-4, 1e3),
    noise_bounds=(1e-8, 1e-1),
    ard: bool = False,
    n_iter: int = 500,
    learning_rate: float = 0.01,
    batch_size: Optional[int] = None,
    early_stopping: bool = False,
    mlp_init: Optional[MLPParams] = None,
    batch_idx: Optional[torch.Tensor] = None,
) -> DeepGPFit:
    """Joint Adam training of the MLP warp and a per-objective exact GP on
    the warped features (reference `fit_deep_gp`, deep_gp.py:109-250).
    With ``batch_size`` < N each step's NMLL is taken on a random
    minibatch (the MDSPP path). With ``early_stopping`` the steps run in
    chunks of ``max(n_iter // 8, 25)`` and `AdaptiveEarlyStopping` (the
    deep-GP configuration, its minimum and window cut to the step
    budget) is asked after each chunk.

    The MLP's initial weights (``mlp_init``) and the minibatch rows
    (``batch_idx`` (n_iter, B)) are drawn from ``generator`` unless
    given."""
    N, n = X.shape
    d = Y.shape[1]
    dt, dev = X.dtype, X.device
    if feature_dim is None:
        feature_dim = n
    L_dim = feature_dim if ard else 1
    kernel_fn = _KERNELS[kernel]

    b_amp = _make_bounds(amplitude_bounds, dt, dev)
    b_ls = _make_bounds(lengthscale_bounds, dt, dev)
    b_noise = _make_bounds(noise_bounds, dt, dev)

    if mlp_init is None:
        mlp_init = _init_mlp(generator, [n, *hidden, feature_dim], dt, dev)
    n_layers = len(mlp_init.weights)

    def init(b, value):
        return b.inverse(torch.tensor(value, dtype=dt, device=dev))

    leaves = [torch.as_tensor(w, dtype=dt, device=dev).clone()
              for w in (*mlp_init.weights, *mlp_init.biases)] + [
        init(b_amp, 1.0).expand(d).clone(),
        init(b_ls, 0.5).expand(d, L_dim).clone(),
        init(b_noise, 1e-4).expand(d).clone(),
    ]

    B = min(batch_size, N) if batch_size else N
    if B < N:
        if batch_idx is None:
            batch_idx = _draw_rows(generator, n_iter, N, B, dev)
        batch_idx = batch_idx.to(dev)

    def loss_fn(p: DeepGPParams, Xb, Yb):
        F = _mlp_forward(p.mlp, Xb)
        return torch.sum(_nmll_on_features(
            F, Yb, b_amp.forward(p.u_amp), b_ls.forward(p.u_ls),
            b_noise.forward(p.u_noise), kernel_fn,
        ))

    stopper = None
    if early_stopping:
        cfg = EarlyStoppingConfig.for_model_type(
            ModelType.DEEP_STOCHASTIC if batch_size else ModelType.DEEP_GP
        )
        cfg.min_iterations = min(cfg.min_iterations, n_iter // 2)
        cfg.window_size = min(cfg.window_size, max(n_iter // 4, 10))
        stopper = AdaptiveEarlyStopping(cfg)

    opt = _Adam(leaves, learning_rate)
    chunk = n_iter if stopper is None else max(n_iter // 8, 25)
    losses = []  # device scalars, one a step
    host_hist = []  # the chunks copied to the host for the stopping check
    done = 0
    while done < n_iter:
        n_chunk = min(chunk, n_iter - done)
        for t in range(done, done + n_chunk):
            if B < N:
                sel = batch_idx[t]
                Xb, Yb = X[sel], Y[sel]
            else:
                Xb, Yb = X, Y
            with torch.enable_grad():
                req = [p.detach().requires_grad_(True) for p in leaves]
                loss = loss_fn(_unflatten(req, n_layers), Xb, Yb)
                grads = torch.autograd.grad(loss, req)
            losses.append(loss.detach())
            leaves = opt.update(leaves, grads)
        done += n_chunk
        if stopper is not None:
            host_hist.append(torch.stack(losses[-n_chunk:]).cpu().numpy())
            stop, _reason = stopper.should_stop(done, np.concatenate(host_hist))
            if stop:
                break

    params = _unflatten([p.detach() for p in leaves], n_layers)
    with torch.no_grad():
        # the posterior on the whole training set
        F = _mlp_forward(params.mlp, X)
        K = _regularized_kernel(F, b_ls.forward(params.u_ls), b_amp.forward(params.u_amp),
                                b_noise.forward(params.u_noise), kernel_fn)
        L = _cholesky_or_nan(K)
        alpha = _cho_solve(L, Y.T[..., None])[..., 0]
    return DeepGPFit(
        params=params, X=X, F=F, L=L, alpha=alpha,
        y_mean=torch.zeros(d, dtype=dt, device=dev),
        y_std=torch.ones(d, dtype=dt, device=dev),
        bounds_amp=b_amp, bounds_ls=b_ls, bounds_noise=b_noise,
        nmll=losses[-1], n_steps=done,
    )


def deep_gp_predict(fit: DeepGPFit, Xq: torch.Tensor, kernel: str = "matern52"):
    """Posterior mean and variance at queries (M, n) on the warped
    features cached on the fit (deep_gp.py:253-274). Returns ((M, d),
    (M, d))."""
    params = fit.params
    F_q = _mlp_forward(params.mlp, Xq)
    amp = fit.bounds_amp.forward(params.u_amp)
    ls = fit.bounds_ls.forward(params.u_ls)
    noise = fit.bounds_noise.forward(params.u_noise)
    Ks = _KERNELS[kernel](fit.F, F_q, ls, amp)  # (d, N, M)
    mean = torch.matmul(Ks.mT, fit.alpha[..., None])[..., 0]  # (d, M)
    v = torch.linalg.solve_triangular(fit.L, Ks, upper=False)
    var = torch.clamp(amp[:, None] + noise[:, None] - torch.sum(v * v, dim=-2), min=1e-12)
    ym, ys = fit.y_mean[:, None], fit.y_std[:, None]
    return (ym + ys * mean).T, (ys * ys * var).T


class MDGP_Matern(SurrogateBase):
    """Deep-kernel GP surrogate (deep_gp.py:277-331), the analog of the
    reference's two-layer deep GP (model_gpytorch.py:1308-1620). Float32;
    ``device`` None means CUDA. ``fit_info`` reports the last step's
    loss, the steps run and whether early stopping ended the fit (the
    JAX package's model keeps no such summary). The fit is cold every
    epoch: the refit controller does not cover this family."""

    kernel = "matern52"
    default_batch_size: Optional[int] = None

    def __init__(
        self,
        xin,
        yin,
        nInput,
        nOutput,
        xlb,
        xub,
        seed=None,
        hidden=(32, 32),
        feature_dim=None,
        n_iter: int = 500,
        learning_rate: float = 0.01,
        batch_size: Optional[int] = None,
        early_stopping: bool = False,
        anisotropic: bool = False,
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
        fit = fit_deep_gp(
            as_torch_generator(seed, dev),
            torch.as_tensor(X.astype(np.float32), device=dev),
            torch.as_tensor(Yn.astype(np.float32), device=dev),
            hidden=tuple(hidden),
            feature_dim=feature_dim,
            kernel=self.kernel,
            ard=bool(anisotropic),
            n_iter=n_iter,
            learning_rate=learning_rate,
            batch_size=batch_size or self.default_batch_size,
            early_stopping=early_stopping,
        )
        fit.y_mean = torch.as_tensor(y_mean, dtype=torch.float32, device=dev)
        fit.y_std = torch.as_tensor(y_std, dtype=torch.float32, device=dev)
        self.fit = fit
        self.fit_info = {
            "loss": float(fit.nmll),
            "n_steps": int(fit.n_steps),
            "n_iter_max": int(n_iter),
            "early_stopped": int(fit.n_steps) < int(n_iter),
        }

    def predict_normalized(self, Xq):
        return deep_gp_predict(self.fit, Xq, kernel=self.kernel)


class MDSPP_Matern(MDGP_Matern):
    """The same deep-kernel construction trained on random minibatches of
    256 rows, the analog of the reference's deep sigma-point process
    (model_gpytorch.py:991-1270; deep_gp.py:334-338)."""

    default_batch_size = 256
