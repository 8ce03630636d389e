"""Exact Gaussian-process surrogates: the exact-GP family of the JAX package.

Port of ``dmosopt_tpu/models/gp.py``: the `matern52` / `rbf` kernels,
the bounded reparameterization `_Bounds`, `_regularized_kernel`,
`_apply_train_mask`, `_nmll`, `_scan_with_convergence`, `fit_gp_batch`
(with ``warm_start`` and the ``model``-axis restart split over a
mesh), `fit_gp_shared`, `gp_predict`, the
problems-axis fit and predict of the batched tenant core
(`fit_gp_problems`, `gp_predict_problems`), the
cross-epoch posterior updates (`extend_cholesky_rank_k`,
`posterior_from_params`, `clone_with_fit`), `_prepare_training_data`,
`_pad_to_bucket`, `_resolve_surrogate_mesh_spec`, and the surrogates
`GPR_Matern` (with ``mesh`` and the routed ``surrogate_mesh`` fit of
`models.gp_sharded`), `GPR_RBF`,
`EGP_Matern` and `MEGP_Matern` with the ``predictor`` options
(``"solve"``, ``"matmul"``, ``"nystrom"``; `models/predictor.py`) and
``dtype="float64"``.

As in the reference, the hyperparameters of every (restart x objective)
pair are fitted together: one batched Cholesky of an (S, d, N, N) kernel
tensor per Adam step, the NMLL gradient by autograd, the best restart per
objective kept. The differences are the framework's:

- `torch.linalg.cholesky_ex` does not raise on a matrix that is not
  positive definite; its ``info`` turns that (restart, objective) cell's
  loss non-finite, which the fit masks exactly as the reference masks
  the NaN of `jnp.linalg.cholesky`, so one bad restart never aborts the
  fit. The posterior updates set a failed factor to NaN, so a block that
  is not positive definite surfaces as a non-finite NMLL, as there.
- Adam is written out with optax's numerics (b1 0.9, b2 0.999, eps 1e-8
  outside the square root, bias correction) and the best iterate is
  recorded before each update.
- The convergence-checked scan becomes a Python loop with one host check
  per chunk of ``convergence_check_every`` steps (at most 20 syncs per
  fit with the defaults), keeping the reference's exact step count and
  remainder semantics.
- ``dtype="float64"`` makes the model's tensors float64 on its device;
  there is no process-wide switch (the JAX package turns on
  ``jax_enable_x64`` for the whole process).
- Float32 matrix products run in full float32: the port never enables
  TF32 (``torch.backends.cuda.matmul.allow_tf32`` stays False and the
  float32 matmul precision stays "highest").
- A model keeps a host copy of its padded training inputs (``_X_host``,
  cast as the fit's inputs are), so the refit controller's append check
  needs no device-to-host copy of a fit this package made.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from dmosopt_tpu_torch.ops.filtering import filter_samples
from dmosopt_tpu_torch.ops.sort import top_k_mo
from dmosopt_tpu_torch.utils.device import resolve_device
from dmosopt_tpu_torch.utils.prng import as_torch_generator

_JITTER = 1e-6
_LOG2PI = math.log(2.0 * math.pi)

# Batch convention: a kernel takes inputs X1 (N, n), X2 (M, n), a
# lengthscale ``ls`` (..., L) with L = 1 (isotropic) or n (ARD) and an
# amplitude ``amp`` (...), and returns (..., N, M) — one kernel matrix per
# leading batch index (restarts x objectives in the fit, objectives in
# prediction).


def _scaled_sqdist(X1, X2, ls):
    """Pairwise squared distance of inputs scaled per dimension by ``ls``,
    with the matrix product in full float32 (the cancellation identity
    loses too much at lower precision to keep Gram matrices PD)."""
    A = X1 / ls[..., None, :]
    B = X2 / ls[..., None, :]
    a2 = torch.sum(A * A, dim=-1, keepdim=True)
    b2 = torch.sum(B * B, dim=-1, keepdim=True)
    sq = a2 + b2.transpose(-1, -2) - 2.0 * torch.matmul(A, B.transpose(-1, -2))
    return torch.clamp(sq, min=0.0)


def matern52(X1, X2, ls, amp):
    r = torch.sqrt(_scaled_sqdist(X1, X2, ls) + 1e-30)
    s5r = math.sqrt(5.0) * r
    return amp[..., None, None] * (1.0 + s5r + (5.0 / 3.0) * r * r) * torch.exp(-s5r)


def rbf(X1, X2, ls, amp):
    return amp[..., None, None] * torch.exp(-0.5 * _scaled_sqdist(X1, X2, ls))


_KERNELS = {"matern52": matern52, "rbf": rbf}


# ------------------------------------------------- bounded parameterization


class _Bounds(NamedTuple):
    """Log-uniform sigmoid reparameterization: theta = lo*(hi/lo)^sigmoid(u),
    keeping hyperparameters inside the bounds the reference passes to
    sklearn (`model.py:1192-1194`) while Adam runs unconstrained."""

    lo: torch.Tensor
    hi: torch.Tensor

    def forward(self, u):
        return self.lo * (self.hi / self.lo) ** torch.sigmoid(u)

    def inverse(self, theta):
        s = torch.log(theta / self.lo) / torch.log(self.hi / self.lo)
        s = torch.clamp(s, 1e-4, 1.0 - 1e-4)
        return torch.log(s) - torch.log1p(-s)


class GPParams(NamedTuple):
    u_amp: torch.Tensor  # (...)
    u_ls: torch.Tensor  # (..., L)
    u_noise: torch.Tensor  # (...)


@dataclass
class GPFit:
    """Posterior state for a batch of d independent GPs."""

    X: torch.Tensor  # (N, n) unit-box inputs (possibly bucket-padded)
    L: torch.Tensor  # (d, N, N) Cholesky of K + noise*I
    alpha: torch.Tensor  # (d, N)  (K + noise I)^-1 y_std
    amp: torch.Tensor  # (d,)
    ls: torch.Tensor  # (d, L)
    noise: torch.Tensor  # (d,)
    y_mean: torch.Tensor  # (d,)
    y_std: torch.Tensor  # (d,)
    nmll: torch.Tensor  # (d,) final negative log marginal likelihood
    train_mask: torch.Tensor  # (N,) 1 = real training row, 0 = padding
    n_steps: Optional[int] = None  # Adam steps actually run
    best_start: Optional[torch.Tensor] = None  # (d,) winning restart index
    # (d, N, N) whitening factor W = L⁻¹, carried by a mesh-sharded fit
    # (`gp_sharded.fit_gp_sharded`, or the JAX package's through
    # `interop`); any posterior update that changes L drops it.
    whitened: Optional[torch.Tensor] = None


def _default_rel_jitter(dtype) -> float:
    """Amplitude-relative jitter by dtype: an f32 Cholesky fails outright
    at the reference's noise floor of 1e-9 (`model.py:1194`), so f32
    carries a 1e-4·amp floor; f64 needs none."""
    return 1e-4 if dtype == torch.float32 else 0.0


def _regularized_kernel(X, ls, amp, noise, kernel_fn, rel_jitter=None):
    """K + (noise + jitter) I, symmetrized; `rel_jitter` scales with the
    amplitude and defaults from the input dtype."""
    if rel_jitter is None:
        rel_jitter = _default_rel_jitter(X.dtype)
    N = X.shape[-2]
    jitter = _JITTER + rel_jitter * amp
    K = kernel_fn(X, X, ls, amp)
    K = 0.5 * (K + K.transpose(-1, -2))
    eye = torch.eye(N, dtype=X.dtype, device=X.device)
    return K + (noise + jitter)[..., None, None] * eye


def _apply_train_mask(K, train_mask):
    """Decouple padded rows from the GP exactly: K_m = (m mᵀ)∘K + diag(1−m).
    With padded targets zeroed, the padded block is an identity whose
    quadratic term and log-determinant are both zero, so the masked MLL,
    posterior and predictions equal the unpadded ones in exact
    arithmetic."""
    if train_mask is None:
        return K
    m = train_mask.to(K.dtype)
    return (m[..., :, None] * m[..., None, :]) * K + torch.diag_embed(1.0 - m)


def _nmll(params: GPParams, bounds3, X, Y, kernel_fn, rel_jitter, train_mask=None):
    """Exact negative log marginal likelihood for a batch of (..., d)
    hyperparameter cells: the last batch axis of ``params`` indexes the
    columns of ``Y`` (N, d), which must already be zero on padded rows
    when `train_mask` is given. A cell whose Cholesky fails gets NaN.
    Returns (..., d)."""
    b_amp, b_ls, b_noise = bounds3
    amp = b_amp.forward(params.u_amp)
    ls = b_ls.forward(params.u_ls)
    noise = b_noise.forward(params.u_noise)
    N = X.shape[-2] if train_mask is None else torch.sum(train_mask, dim=-1)
    K = _apply_train_mask(
        _regularized_kernel(X, ls, amp, noise, kernel_fn, rel_jitter), train_mask
    )
    L, info = torch.linalg.cholesky_ex(K)
    y = Y.transpose(-1, -2).expand(K.shape[:-1])  # (..., d, N)
    alpha = _cho_solve(L, y[..., None])[..., 0]
    val = (
        0.5 * torch.sum(y * alpha, dim=-1)
        + torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)
        + 0.5 * N * _LOG2PI
    )
    return torch.where(info == 0, val, torch.full_like(val, torch.nan))


def _resolve_convergence_defaults(d, tol, check_every):
    """The "auto" convergence defaults by objective count (reference
    `_resolve_convergence_defaults`, gp.py:195): (1e-3, 10) for d <= 2,
    (1e-4, 20) beyond."""
    if tol == "auto":
        tol = 1e-3 if d <= 2 else 1e-4
    if check_every is None:
        check_every = 10 if d <= 2 else 20
    return tol, check_every


def _improving(prev_win, win, tol) -> bool:
    """Whether any component improved by more than ``tol * max(1, |win|)``
    (inf -> finite counts as improving, inf -> inf as not); one host sync."""
    delta = prev_win - win
    return bool(torch.any(delta > tol * torch.clamp(torch.abs(win), min=1.0)))


def _scan_with_convergence(step, n_iter, convergence_tol,
                           convergence_check_every, winner_fn, best_vals_fn):
    """Run ``step()`` up to ``n_iter`` times, checking every
    ``convergence_check_every`` steps whether the last chunk improved any
    component of ``winner_fn(best_vals_fn())`` by more than
    ``tol * max(1, |winner|)``, and stopping once a chunk did not. The
    first chunk always runs; ``convergence_tol=None`` runs exactly
    ``n_iter`` steps. A run that exhausts every full chunk still owes the
    remainder steps only if its last chunk improved (the reference's
    exact ``n_iter`` semantics). Returns the number of steps run."""
    chunk = (
        max(1, min(convergence_check_every, n_iter))
        if convergence_tol is not None
        else n_iter
    )
    if convergence_tol is None or chunk >= n_iter:
        for _ in range(n_iter):
            step()
        return int(n_iter)

    n_full, rem = divmod(n_iter, chunk)
    prev_win = torch.full_like(winner_fn(best_vals_fn()), torch.inf)
    i = 0
    while i < n_full:
        win = winner_fn(best_vals_fn())
        if i > 0 and not _improving(prev_win, win, convergence_tol):
            break
        prev_win = win
        for _ in range(chunk):
            step()
        i += 1
    n_steps = i * chunk
    if rem and i == n_full and _improving(
        prev_win, winner_fn(best_vals_fn()), convergence_tol
    ):
        for _ in range(rem):
            step()
        n_steps += rem
    return n_steps


class _Adam:
    """optax.adam's numerics over a list of tensors: moments
    ``(1-b)*g + b*m``, bias-corrected, ``-lr * mu_hat / (sqrt(nu_hat) + eps)``."""

    def __init__(self, params, lr, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0

    def update(self, params, grads):
        self.count += 1
        c1 = 1.0 - self.b1 ** self.count
        c2 = 1.0 - self.b2 ** self.count
        out = []
        for i, (p, g) in enumerate(zip(params, grads)):
            self.mu[i] = (1.0 - self.b1) * g + self.b1 * self.mu[i]
            self.nu[i] = (1.0 - self.b2) * (g * g) + self.b2 * self.nu[i]
            mu_hat = self.mu[i] / c1
            nu_hat = self.nu[i] / c2
            out.append(p - self.lr * (mu_hat / (torch.sqrt(nu_hat) + self.eps)))
        return out


def _minimize(params, loss_fn, vals_shape, learning_rate, n_iter,
              convergence_tol, convergence_check_every, winner_fn):
    """Adam on a batch of losses ``loss_fn(*params)`` of ``vals_shape``
    (the leading axes of every parameter). A non-finite cell adds nothing
    to the gradient and never becomes a best iterate; each cell's best
    iterate is recorded before each update; stopping as in
    `_scan_with_convergence` on ``winner_fn`` of the best values.
    Returns (best params, best values, steps run)."""
    p0 = params[0]
    opt = _Adam(params, learning_rate)
    best = {"params": [p.clone() for p in params],
            "vals": torch.full(vals_shape, torch.inf, dtype=p0.dtype, device=p0.device)}
    nd = len(vals_shape)

    def step():
        leaves = [p.detach().requires_grad_(True) for p in params]
        with torch.enable_grad():
            vals = loss_fn(*leaves)
            finite = torch.isfinite(vals)
            total = torch.where(finite, vals, torch.zeros_like(vals)).sum()
            grads = torch.autograd.grad(total, leaves)
        vals = torch.where(finite, vals.detach(), torch.full_like(vals, torch.inf))
        improved = vals < best["vals"]
        best["params"] = [
            torch.where(improved.reshape(improved.shape + (1,) * (p.dim() - nd)), p, bp)
            for p, bp in zip(params, best["params"])
        ]
        best["vals"] = torch.where(improved, vals, best["vals"])
        params[:] = opt.update(params, [torch.nan_to_num(g) for g in grads])

    n_steps = _scan_with_convergence(
        step, n_iter, convergence_tol, convergence_check_every, winner_fn,
        lambda: best["vals"],
    )
    return best["params"], best["vals"], n_steps


def _make_bounds(b, dt, dev):
    return _Bounds(torch.tensor(b[0], dtype=dt, device=dev),
                   torch.tensor(b[1], dtype=dt, device=dev))


def _cholesky_or_nan(K):
    """Lower Cholesky factor of each matrix of K; a matrix that is not
    positive definite gets an all-NaN factor (what `jnp.linalg.cholesky`
    returns), so everything solved against it is non-finite, and so is
    every gradient taken through it, as through `jnp.linalg.cholesky`
    (the sparse and deep trainers backpropagate through it). No host
    sync: the failure flag stays on the device."""
    L, info = torch.linalg.cholesky_ex(K)
    # a factor of 1 leaves a factor and its gradient exact; a factor of
    # NaN poisons both (a masked select would zero the failed factor's
    # gradient instead)
    scale = torch.where(info == 0, 1.0, torch.nan).to(L.dtype)
    return L * scale[..., None, None]


def _cho_solve(L, B):
    """(L Lᵀ)⁻¹ B for a batch of lower factors L (..., N, N) and right-hand
    sides B (..., N, k), as two triangular solves: `torch.cholesky_solve`
    fails on CUDA for a batch of float64 factors of 8192 rows."""
    z = torch.linalg.solve_triangular(L, B, upper=False)
    return torch.linalg.solve_triangular(L.mT, z, upper=True)


def _posterior(X, Y, train_mask, amp, ls, noise, kernel_fn, rel_jitter):
    """(L, alpha) of the masked, regularized kernel of d GPs at fixed
    hyperparameters: L (d, N, N), alpha (d, N) for targets Y (N, d)."""
    K = _apply_train_mask(
        _regularized_kernel(X, ls, amp, noise, kernel_fn, rel_jitter), train_mask
    )
    L = _cholesky_or_nan(K)
    return L, _cho_solve(L, Y.transpose(-1, -2)[..., None])[..., 0]


def fit_gp_batch(
    generator: torch.Generator,
    X: torch.Tensor,  # (N, n) unit box
    Y: torch.Tensor,  # (N, d) standardized targets
    lengthscale_bounds: Tuple[float, float] = (1e-3, 100.0),
    amplitude_bounds: Tuple[float, float] = (1e-4, 1e3),
    noise_bounds: Tuple[float, float] = (1e-9, 1e-2),
    kernel: str = "matern52",
    n_starts: int = 8,
    n_iter: int = 200,
    learning_rate: float = 0.1,
    ard: bool = False,
    rel_jitter: Optional[float] = None,
    train_mask: Optional[torch.Tensor] = None,
    convergence_tol="auto",
    convergence_check_every: Optional[int] = None,
    warm_start: Optional[Tuple] = None,
    mesh=None,
    model_axis: str = "model",
) -> GPFit:
    """Fit d independent GPs with S random restarts each (reference
    `fit_gp_batch`, gp.py:287). The (S, d) grid of NMLLs shares one
    batched Cholesky per Adam step and the best restart per objective
    wins. Restart 0 is the reference's deterministic init (amp 1.0, ls
    0.5, noise 1e-6); the others are jittered with ``2 * N(0, 1)`` draws
    from ``generator``. `train_mask` marks real rows of bucket-padded
    X/Y; masked fits equal the unpadded fits. Convergence stopping as in
    `_scan_with_convergence`, with the winner (min over restarts) per
    objective as the watched quantity.

    ``warm_start`` is an ``(amp, ls, noise)`` triple of shapes (d,),
    (d, L), (d,) from a previous converged fit (gp.py:305, :371-385):
    restart 0 then starts exactly there and the others are jittered
    around it by the same draws as a cold fit.

    With a ``mesh`` whose ``model_axis`` size divides ``n_starts``
    (gp.py:343-405), each rank of that axis runs the Adam loop of its
    block of restarts (every rank draws the whole grid, so the restarts
    are the unsplit fit's); the convergence checks read the winner over
    all ranks (one ``all_reduce(MIN)`` a check), and the ranks gather
    every restart's best values and parameters before the winner per
    objective is kept, so every rank returns the same fit."""
    split = None
    if mesh is not None and model_axis in (mesh.mesh_dim_names or ()):
        from dmosopt_tpu_torch.parallel.mesh import axis_size

        W = axis_size(mesh, model_axis)
        if W > 1 and n_starts % W == 0:
            split = (mesh, model_axis, W)
    return _fit_gp(
        generator, X, Y, train_mask, lengthscale_bounds, amplitude_bounds,
        noise_bounds, kernel, n_starts, n_iter, learning_rate, ard, rel_jitter,
        convergence_tol, convergence_check_every, warm_start, split,
    )


def fit_gp_problems(
    generators,
    X: torch.Tensor,  # (P, N, n) unit box, bucket-padded to a common N
    Y: torch.Tensor,  # (P, N, d) standardized targets, zero on padded rows
    train_mask: torch.Tensor,  # (P, N) 1 = real row
    **common,
) -> GPFit:
    """`fit_gp_batch` over a leading problems axis
    (``dmosopt_tpu/models/gp.py:602``): ONE Adam loop fits every problem
    of a bucket, one batched Cholesky of a (P, S, d, N, N) tensor a
    step. Each problem keeps its own restarts (jittered from its own
    generator of ``generators``, drawn in the order its standalone fit
    draws them), its own Adam moments and its own best-iterate tracking,
    so its result is the math of its standalone `fit_gp_batch` at the
    same padding. The convergence stop means "run while ANY problem
    still improves", as under the JAX package's ``vmap``: a problem that
    converged early takes further best-iterate-tracked steps, which can
    only lower its winning NMLL.

    The JAX package splits a bucket's fit into ``FIT_CHUNK = 8``
    problems per call across CPU threads (``dmosopt_tpu/tenants.py:
    326-362``), which only helps XLA on a CPU, where a batched Cholesky
    runs its batch serially; on the card one call takes the whole
    bucket. ``common`` takes `fit_gp_batch`'s keyword arguments but
    ``warm_start``. Returns a `GPFit` whose tensors lead with (P,)
    (``n_steps`` one int for all); `gp_predict_problems` reads it."""
    common = dict(common)
    common.pop("mesh", None)
    common.pop("warm_start", None)
    keys = ("lengthscale_bounds", "amplitude_bounds", "noise_bounds", "kernel",
            "n_starts", "n_iter", "learning_rate", "ard", "rel_jitter",
            "convergence_tol", "convergence_check_every")
    defaults = dict(lengthscale_bounds=(1e-3, 100.0), amplitude_bounds=(1e-4, 1e3),
                    noise_bounds=(1e-9, 1e-2), kernel="matern52", n_starts=8,
                    n_iter=200, learning_rate=0.1, ard=False, rel_jitter=None,
                    convergence_tol="auto", convergence_check_every=None)
    unknown = sorted(set(common) - set(keys))
    if unknown:
        raise TypeError(f"fit_gp_problems: unexpected arguments {unknown}")
    defaults.update(common)
    if len(generators) != X.shape[0]:
        raise ValueError(f"{len(generators)} generators for {X.shape[0]} problems")
    return _fit_gp(list(generators), X, Y, train_mask,
                   *(defaults[k] for k in keys), None)


def _fit_bounds(lengthscale_bounds, amplitude_bounds, noise_bounds, dt, dev):
    """The (amplitude, lengthscale, noise) `_Bounds` of a fit."""
    return (_make_bounds(amplitude_bounds, dt, dev),
            _make_bounds(lengthscale_bounds, dt, dev),
            _make_bounds(noise_bounds, dt, dev))


def _restart_grid(generator, lead, n_starts, d, Lls, bounds3, warm_start, dt, dev):
    """The unconstrained (u_amp, u_ls, u_noise) restart grid of a fit,
    shapes (*lead, S, d), (*lead, S, d, Lls), (*lead, S, d): restart 0
    at the anchors (the reference's amp 1.0, ls 0.5, noise 1e-6, or
    ``warm_start``), the others jittered by ``2 * N(0, 1)`` draws taken
    from ``generator`` (one generator, or one per problem of ``lead``)
    in the order amplitude, lengthscale, noise."""
    anchors = (1.0, 0.5, 1e-6) if warm_start is None else warm_start

    def init(b, value, shape):
        return b.inverse(torch.as_tensor(value, dtype=dt, device=dev)).expand(shape)

    def jitter(shape):
        if not lead:
            return 2.0 * torch.randn(shape, generator=generator, dtype=dt, device=dev)
        out = torch.empty(lead + shape, dtype=dt, device=dev)
        for i, g in enumerate(generator):  # each problem from its own stream
            torch.randn(shape, generator=g, out=out[i])
        return 2.0 * out

    b_amp, b_ls, b_noise = bounds3
    start_mask = (torch.arange(n_starts, device=dev) > 0).to(dt)
    return [
        init(b_amp, anchors[0], lead + (n_starts, d))
        + start_mask[:, None] * jitter((n_starts, d)),
        init(b_ls, anchors[1], lead + (n_starts, d, Lls))
        + start_mask[:, None, None] * jitter((n_starts, d, Lls)),
        init(b_noise, anchors[2], lead + (n_starts, d))
        + start_mask[:, None] * jitter((n_starts, d)),
    ]


def _fit_gp(
    generator, X, Y, train_mask, lengthscale_bounds, amplitude_bounds,
    noise_bounds, kernel, n_starts, n_iter, learning_rate, ard, rel_jitter,
    convergence_tol, convergence_check_every, warm_start, split=None,
) -> GPFit:
    """`fit_gp_batch`'s math for X (N, n) and one generator, or, with a
    leading problems axis, X (P, N, n) and a list of P generators. The
    (restart, objective) cells get their own axes after the problems
    axis; inputs and masks are reshaped to broadcast over them.
    ``split`` (mesh, axis, axis size) fits each rank's block of the
    restarts and gathers them before the winner is picked."""
    lead = tuple(X.shape[:-2])
    N, n = X.shape[-2:]
    dt, dev = X.dtype, X.device
    if train_mask is not None:
        Y = Y * train_mask[..., None].to(Y.dtype)
    d = Y.shape[-1]
    convergence_tol, convergence_check_every = _resolve_convergence_defaults(
        d, convergence_tol, convergence_check_every
    )
    Lls = n if ard else 1
    if rel_jitter is None:
        rel_jitter = _default_rel_jitter(dt)

    bounds3 = _fit_bounds(lengthscale_bounds, amplitude_bounds, noise_bounds, dt, dev)
    b_amp, b_ls, b_noise = bounds3
    kernel_fn = _KERNELS[kernel]
    params = _restart_grid(generator, lead, n_starts, d, Lls, bounds3, warm_start, dt, dev)

    def cells(t, k):  # t (*lead, ...) -> (*lead, 1 x k, ...)
        return t.reshape(lead + (1,) * k + tuple(t.shape[len(lead):]))

    Xc, Yc = cells(X, 2), cells(Y, 1)
    mc = None if train_mask is None else cells(train_mask, 2)
    winner = lambda v: torch.amin(v, dim=-2)  # noqa: E731
    if split is not None:
        # this rank's block of restarts; every convergence check reads
        # the winner over all ranks' restarts, so the ranks stop together
        from dmosopt_tpu_torch.parallel.mesh import all_reduce, axis_index

        mesh, axis, W = split
        S_loc = n_starts // W
        a = axis_index(mesh, axis) * S_loc
        params = [t[a:a + S_loc] for t in params]
        winner = lambda v: all_reduce(  # noqa: E731
            torch.amin(v, dim=-2), mesh, axis, op=torch.distributed.ReduceOp.MIN)
    vals_shape = lead + (params[0].shape[len(lead)], d)
    best_params, final, n_steps = _minimize(
        params,
        lambda *leaves: _nmll(GPParams(*leaves), bounds3, Xc, Yc, kernel_fn,
                              rel_jitter, mc),
        vals_shape, learning_rate, n_iter, convergence_tol,
        convergence_check_every, winner,
    )
    if split is not None:
        # every rank's restarts, in restart order
        from dmosopt_tpu_torch.parallel.mesh import all_gather

        final = all_gather(final, mesh, axis)
        best_params = [all_gather(t, mesh, axis) for t in best_params]
    best_start = torch.argmin(final, dim=-2)  # (*lead, d)
    k = len(lead)

    def pick(p):  # the winning restart's cell per objective
        extra = tuple(p.shape[k + 2:])
        idx = best_start.unsqueeze(k).reshape(lead + (1, d) + (1,) * len(extra))
        return torch.gather(p, k, idx.expand(lead + (1, d) + extra)).squeeze(k)

    u_amp, u_ls, u_noise = (pick(p) for p in best_params)
    amp = b_amp.forward(u_amp)
    ls = b_ls.forward(u_ls)
    noise = b_noise.forward(u_noise)

    L, alpha = _posterior(
        cells(X, 1), Y, None if train_mask is None else cells(train_mask, 1),
        amp, ls, noise, kernel_fn, rel_jitter,
    )
    tm = (torch.ones(lead + (N,), dtype=dt, device=dev) if train_mask is None
          else train_mask.to(dt))
    return GPFit(X=X, L=L, alpha=alpha, amp=amp, ls=ls, noise=noise,
                 y_mean=torch.zeros(lead + (d,), dtype=dt, device=dev),
                 y_std=torch.ones(lead + (d,), dtype=dt, device=dev),
                 nmll=torch.amin(final, dim=-2), train_mask=tm,
                 n_steps=n_steps, best_start=best_start)


def gp_predict(fit: GPFit, Xq: torch.Tensor, kernel: str = "matern52"):
    """Posterior mean and variance of all d GPs at query points (M, n),
    variance including the fitted noise level (sklearn's
    ``predict(return_std=True)`` with a WhiteKernel, reference
    model.py:1266-1270). Returns ((M, d), (M, d)); a fit and queries
    with a leading problems axis give ((P, M, d), (P, M, d))."""
    Ks = _KERNELS[kernel](fit.X.unsqueeze(-3), Xq.unsqueeze(-3), fit.ls, fit.amp)
    # (..., d, N, M); padded training rows carry no information: zero
    # their cross-covariance so the posterior equals the unpadded one
    Ks = Ks * fit.train_mask[..., None, :, None].to(Ks.dtype)
    mean = torch.matmul(Ks.transpose(-1, -2), fit.alpha[..., None])[..., 0]
    v = torch.linalg.solve_triangular(fit.L, Ks, upper=False)
    var = fit.amp[..., None] + fit.noise[..., None] - torch.sum(v * v, dim=-2)
    var = torch.clamp(var, min=1e-12)
    mean = fit.y_mean[..., None] + fit.y_std[..., None] * mean
    var = (fit.y_std * fit.y_std)[..., None] * var
    return mean.transpose(-1, -2), var.transpose(-1, -2)


def gp_predict_problems(fit: GPFit, Xq: torch.Tensor, kernel: str = "matern52"):
    """`gp_predict` over a problems-stacked `GPFit` (`fit_gp_problems`)
    and per-problem queries ``Xq`` (P, M, n): ((P, M, d), (P, M, d)),
    each problem's solve-oracle posterior, batched into one set of
    launches (``dmosopt_tpu/models/gp.py:636``)."""
    return gp_predict(fit, Xq, kernel=kernel)


def fit_gp_shared(
    generator: torch.Generator,
    X: torch.Tensor,  # (N, n) unit box
    Y: torch.Tensor,  # (N, d) standardized targets
    lengthscale_bounds: Tuple[float, float] = (1e-3, 100.0),
    amplitude_bounds: Tuple[float, float] = (1e-4, 1e3),
    noise_bounds: Tuple[float, float] = (1e-9, 1e-2),
    kernel: str = "matern52",
    n_starts: int = 8,
    n_iter: int = 300,
    learning_rate: float = 0.1,
    rel_jitter: Optional[float] = None,
    train_mask: Optional[torch.Tensor] = None,
    convergence_tol="auto",
    convergence_check_every: Optional[int] = None,
) -> GPFit:
    """Joint multi-output fit (reference `fit_gp_shared`, gp.py:478): one
    shared ARD kernel for all d objectives, optimized on the summed exact
    MLL, one Cholesky per restart serving every objective; the posterior
    stays per objective. Restart 0 is the deterministic init, the others
    jittered by ``2 * N(0, 1)`` draws (amp, then ls, then noise, as in the
    reference); convergence stopping on the winning summed NMLL."""
    N, n = X.shape
    dt, dev = X.dtype, X.device
    if train_mask is not None:
        Y = Y * train_mask[:, None].to(Y.dtype)
    d = Y.shape[1]
    convergence_tol, convergence_check_every = _resolve_convergence_defaults(
        d, convergence_tol, convergence_check_every
    )
    if rel_jitter is None:
        rel_jitter = _default_rel_jitter(dt)
    b_amp = _make_bounds(amplitude_bounds, dt, dev)
    b_ls = _make_bounds(lengthscale_bounds, dt, dev)
    b_noise = _make_bounds(noise_bounds, dt, dev)
    kernel_fn = _KERNELS[kernel]
    N_eff = N if train_mask is None else torch.sum(train_mask)

    def init(b, value, shape):
        u = b.inverse(torch.tensor(value, dtype=dt, device=dev)).expand(shape)
        jitter = 2.0 * torch.randn(shape, generator=generator, dtype=dt, device=dev)
        mask = (torch.arange(n_starts, device=dev) > 0).to(dt)
        return u + mask.reshape((n_starts,) + (1,) * (len(shape) - 1)) * jitter

    params = [init(b_amp, 1.0, (n_starts,)), init(b_ls, 0.5, (n_starts, n)),
              init(b_noise, 1e-6, (n_starts,))]

    def loss(u_amp, u_ls, u_noise):
        K = _apply_train_mask(
            _regularized_kernel(X, b_ls.forward(u_ls), b_amp.forward(u_amp),
                                b_noise.forward(u_noise), kernel_fn, rel_jitter),
            train_mask,
        )
        L, info = torch.linalg.cholesky_ex(K)  # (S, N, N)
        alpha = _cho_solve(L, Y.expand(n_starts, N, d))
        val = (
            0.5 * torch.sum(Y * alpha, dim=(-2, -1))
            + d * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)
            + 0.5 * d * N_eff * _LOG2PI
        )
        return torch.where(info == 0, val, torch.full_like(val, torch.nan))

    best_params, vals, n_steps = _minimize(
        params, loss, (n_starts,), learning_rate, n_iter, convergence_tol,
        convergence_check_every, torch.amin,
    )
    i = torch.argmin(vals)
    amp = b_amp.forward(best_params[0][i]).expand(d)
    ls = b_ls.forward(best_params[1][i]).expand(d, n)
    noise = b_noise.forward(best_params[2][i]).expand(d)
    L, alpha = _posterior(X, Y, train_mask, amp, ls, noise, kernel_fn, rel_jitter)
    tm = torch.ones(N, dtype=dt, device=dev) if train_mask is None else train_mask.to(dt)
    return GPFit(X=X, L=L, alpha=alpha, amp=amp, ls=ls, noise=noise,
                 y_mean=torch.zeros(d, dtype=dt, device=dev),
                 y_std=torch.ones(d, dtype=dt, device=dev),
                 nmll=(vals[i] / d).expand(d), train_mask=tm, n_steps=n_steps)


# ------------------------------------------- cross-epoch posterior updates


def _masked_nmll_from_chol(L, alpha, y, train_mask):
    """Exact NMLL of d GPs given their factorized posteriors (reference
    gp.py:680): L (d, P, P), alpha and y (d, P); padded rows contribute
    zero to every term. Returns (d,)."""
    return (
        0.5 * torch.sum(y * alpha, dim=-1)
        + torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)
        + 0.5 * torch.sum(train_mask) * _LOG2PI
    )


def extend_cholesky_rank_k(
    L_old: torch.Tensor,  # (d, P, P) previous factor (identity on padded rows)
    X_pad: torch.Tensor,  # (P, n) inputs with rows [n_old, n_new) newly filled
    train_mask: torch.Tensor,  # (P,) 1 for rows < n_new
    Yn_pad: torch.Tensor,  # (P, d) standardized targets, zero beyond n_new
    amp: torch.Tensor,  # (d,)
    ls: torch.Tensor,  # (d, L)
    noise: torch.Tensor,  # (d,)
    kernel: str,
    n_old: int,
    n_new: int,
    rel_jitter: Optional[float],
):
    """Blocked rank-k Cholesky update (reference gp.py:692): extend a
    cached posterior by the k = n_new - n_old rows appended inside the
    padding bucket. The padded rows are an identity block of the masked
    kernel, so the old factor's top-left (n_old, n_old) block is the
    Cholesky of the old training kernel and the update is the block step
    L21 = K21 L11⁻ᵀ, L22 = chol(K22 − L21 L21ᵀ), at O(N²k) per objective,
    then alpha re-solved against all targets. A (k, k) block that is not
    positive definite leaves an all-NaN L22, so the NMLL is non-finite.
    Returns (L, alpha, nmll) of shapes ((d, P, P), (d, P), (d,))."""
    kernel_fn = _KERNELS[kernel]
    if rel_jitter is None:
        rel_jitter = _default_rel_jitter(X_pad.dtype)
    k = n_new - n_old
    # only the appended rows' kernel blocks: rows [n_old, n_new) against
    # real columns [0, n_new), where the train mask is 1 throughout
    rows = kernel_fn(X_pad[n_old:n_new], X_pad[:n_new], ls, amp)  # (d, k, n_new)
    B = rows[..., :n_old]
    K22 = rows[..., n_old:n_new]
    eye = torch.eye(k, dtype=X_pad.dtype, device=X_pad.device)
    K22 = 0.5 * (K22 + K22.mT) + (noise + _JITTER + rel_jitter * amp)[:, None, None] * eye
    L21t = torch.linalg.solve_triangular(
        L_old[:, :n_old, :n_old], B.mT, upper=False
    )  # (d, n_old, k)
    S = K22 - L21t.mT @ L21t
    L22 = _cholesky_or_nan(0.5 * (S + S.mT))
    L_new = L_old.clone()
    L_new[:, n_old:n_new, :n_old] = L21t.mT
    L_new[:, n_old:n_new, n_old:n_new] = L22
    y = Yn_pad.T
    alpha = _cho_solve(L_new, y[..., None])[..., 0]
    return L_new, alpha, _masked_nmll_from_chol(L_new, alpha, y, train_mask)


def posterior_from_params(
    X: torch.Tensor,  # (P, n)
    Yn: torch.Tensor,  # (P, d)
    train_mask: torch.Tensor,  # (P,)
    amp: torch.Tensor,  # (d,)
    ls: torch.Tensor,  # (d, L)
    noise: torch.Tensor,  # (d,)
    kernel: str,
    rel_jitter: Optional[float],
):
    """Full masked refactorization at fixed hyperparameters (reference
    gp.py:756): the fall-back when a rank-k append crosses a bucket
    boundary, and the oracle of the rank-k update. A kernel that is not
    positive definite gets a NaN factor and NMLL. Returns (L, alpha,
    nmll) like `extend_cholesky_rank_k`."""
    L, alpha = _posterior(X, Yn, train_mask, amp, ls, noise, _KERNELS[kernel], rel_jitter)
    return L, alpha, _masked_nmll_from_chol(L, alpha, Yn.T, train_mask)


def clone_with_fit(prev, fit: GPFit, fit_info: dict):
    """New surrogate of `prev`'s class sharing its normalization state
    and device but carrying an updated posterior (reference gp.py:784),
    built without the constructor's fit: the result of a rank-k append
    or a bucket-crossing refactorization. The predictor cache is not
    carried over (serving it would be stale); callers that can extend it
    set ``_predictor_obj`` afterwards. The host copy of the inputs is
    the caller's to set (``_X_host``), else it is copied from the fit on
    first use."""
    new = object.__new__(type(prev))
    for attr in (
        "nInput", "nOutput", "xlb", "xub", "xrg", "_dtype",
        "return_mean_variance", "logger", "device", "_xlb_t", "_xrg_t", "kernel",
    ):
        setattr(new, attr, getattr(prev, attr))
    new._rel_jitter = getattr(prev, "_rel_jitter", None)
    new._predictor_spec = dict(getattr(prev, "_predictor_spec", None) or {})
    new._predictor_obj = None
    new._X_host = None
    new.fit = fit
    new.fit_info = fit_info
    return new


# ---------------------------------------------------------------- wrappers


def _gp_fit_info(fit: GPFit, n_iter: int) -> dict:
    """Host-side summary of one fit: winning per-objective NMLLs, their
    mean as ``loss``, and the convergence-stop accounting."""
    nmll = fit.nmll.detach().cpu().numpy().astype(np.float64)
    n_steps = int(fit.n_steps) if fit.n_steps is not None else int(n_iter)
    return {
        "loss": float(np.mean(nmll)),
        "nmll_per_objective": [float(v) for v in nmll],
        "n_steps": n_steps,
        "n_iter_max": int(n_iter),
        "early_stopped": n_steps < int(n_iter),
    }


def _prepare_training_data(
    model, xin, yin, nInput, nOutput, xlb, xub, nan, top_k, y_stats=None
):
    """Shared training-data pipeline (reference model.py:1206-1229): NaN
    policy, optional top-k truncation, unit-box x normalization, per-
    objective y standardization. Sets the bounds attributes on ``model``
    and returns (X_unit, Y_standardized, y_mean, y_std) as float64 numpy.
    ``y_stats``, a ``(y_mean, y_std)`` pair, overrides the computed
    standardization (the rank-k refit keeps the cached alpha's)."""
    model.nInput = int(nInput)
    model.nOutput = int(nOutput)
    model.xlb = np.asarray(xlb, dtype=np.float64)
    model.xub = np.asarray(xub, dtype=np.float64)
    model.xrg = np.where(model.xub - model.xlb == 0.0, 1.0, model.xub - model.xlb)

    xin = np.asarray(xin, dtype=np.float64)
    yin = np.asarray(yin, dtype=np.float64)
    if yin.ndim == 1:
        yin = yin.reshape(-1, 1)
    if nan is not None:
        yin, xin = filter_samples(yin, xin, nan=nan)
    xin, yin = top_k_mo(xin, yin, top_k)
    yin = np.nan_to_num(yin)

    X = (xin - model.xlb) / model.xrg
    if y_stats is None:
        y_mean = yin.mean(axis=0)
        y_std = yin.std(axis=0)
        y_std = np.where(y_std == 0.0, 1.0, y_std)
    else:
        y_mean = np.asarray(y_stats[0], dtype=np.float64)
        y_std = np.asarray(y_stats[1], dtype=np.float64)
    Yn = (yin - y_mean) / y_std
    return X, Yn, y_mean, y_std


def _bucket_size(N: int) -> int:
    """Padding bucket for a training-set size: multiples of 64 up to 512,
    multiples of 256 beyond (reference gp.py:863). The port keeps the
    buckets, so fits carried over from the JAX package have the same
    padded shapes and masked fits can be checked against unpadded ones."""
    step = 64 if N <= 512 else 256
    return max(step, step * -(-N // step))


def _pad_to_bucket(X: np.ndarray, Yn: np.ndarray, cap: Optional[int] = None):
    """Pad (X, Y) rows up to `_bucket_size` and return (X_pad, Y_pad, mask).
    Padded x rows sit at the unit-box center; the train mask decouples
    them exactly (see `_apply_train_mask`)."""
    N = X.shape[0]
    if cap is None:
        cap = _bucket_size(N)
    elif cap < N:
        raise ValueError(f"pad cap {cap} < {N} rows")
    if cap == N:
        return X, Yn, np.ones((N,), dtype=X.dtype)
    pad = cap - N
    X_pad = np.concatenate([X, np.full((pad, X.shape[1]), 0.5, X.dtype)])
    Y_pad = np.concatenate([Yn, np.zeros((pad, Yn.shape[1]), Yn.dtype)])
    mask = np.concatenate([np.ones((N,), X.dtype), np.zeros((pad,), X.dtype)])
    return X_pad, Y_pad, mask


def _resolve_dtype(dtype) -> torch.dtype:
    """"float32"/"float64" (or numpy dtypes) -> the model's torch dtype.
    Float64 is per model: the JAX package's process-wide x64 switch
    (gp.py:895-905) has no counterpart here."""
    return torch.float64 if np.dtype(dtype) == np.float64 else torch.float32


def _resolve_predictor_spec(
    predictor, nystrom_points, nystrom_probe_points, nystrom_mean_tol,
    nystrom_var_ratio_tol,
):
    """Validate and pack the exact-GP family's predictor options (the
    `GPPredictor` keyword arguments but the fit and kernel; gp.py:907)."""
    from dmosopt_tpu_torch.models.predictor import PREDICTOR_MODES

    if predictor not in PREDICTOR_MODES:
        raise ValueError(f"predictor {predictor!r} not in {PREDICTOR_MODES}")
    return dict(
        mode=predictor,
        nystrom_points=int(nystrom_points),
        nystrom_probe_points=int(nystrom_probe_points),
        nystrom_mean_tol=float(nystrom_mean_tol),
        nystrom_var_ratio_tol=float(nystrom_var_ratio_tol),
    )


def _resolve_surrogate_mesh_spec(spec):
    """Validate and normalize the exact-GP family's ``surrogate_mesh``
    option (gp.py:928-958): None or False turns the sharded fit off (the
    single-device fit is untouched), True turns it on with the defaults,
    a dict overrides ``min_points`` (real training rows from which the
    fit is routed), ``tile`` (the Cholesky panel width, None:
    `gp_sharded.default_chol_tile`) and ``axis`` (the mesh axis, None:
    the mesh's first)."""
    if spec is None or spec is False:
        return None
    out = {"min_points": 4096, "tile": None, "axis": None}
    if spec is True:
        return out
    if isinstance(spec, dict):
        unknown = sorted(set(spec) - set(out))
        if unknown:
            raise ValueError(
                f"surrogate_mesh keys {unknown} not understood; "
                f"expected a subset of {sorted(out)}"
            )
        out.update(spec)
        out["min_points"] = int(out["min_points"])
        if out["tile"] is not None:
            out["tile"] = int(out["tile"])
        return out
    raise TypeError(
        f"surrogate_mesh must be None, bool, or dict; got {type(spec)!r}"
    )


class SurrogateBase:
    """The surrogate surface of every surrogate family (reference
    ``SurrogateMixin``, gp.py:959-983): unit-box x normalization and the
    reference's ``predict``/``evaluate`` contract on top of the family's
    own ``predict_normalized``. A model holds ``device``, ``_dtype`` and
    the bounds as tensors (``_xlb_t``, ``_xrg_t``)."""

    def _init_surface(self, device, dtype, return_mean_variance, logger):
        self.device = resolve_device(device)
        self._dtype = dtype
        self.return_mean_variance = return_mean_variance
        self.logger = logger

    def _set_bounds_tensors(self):
        self._xlb_t = torch.as_tensor(self.xlb, dtype=self._dtype, device=self.device)
        self._xrg_t = torch.as_tensor(self.xrg, dtype=self._dtype, device=self.device)

    def normalize_x(self, xin):
        x = torch.as_tensor(xin, dtype=self._dtype, device=self.device)
        return (x - self._xlb_t) / self._xrg_t

    def predict(self, xin):
        x = torch.atleast_2d(torch.as_tensor(xin, dtype=self._dtype, device=self.device))
        return self.predict_normalized(self.normalize_x(x))

    def evaluate(self, x):
        mean, var = self.predict(x)
        if self.return_mean_variance:
            return mean, var
        return mean

    def get_stats(self):
        return dict(getattr(self, "fit_info", None) or {})


class SurrogateMixin(SurrogateBase):
    """The exact-GP family's surface: `SurrogateBase` with predictions
    routed through the per-fit `GPPredictor`. A model also holds ``fit``,
    ``_predictor_spec`` and ``_predictor_obj``."""

    def _init_common(self, device, dtype, return_mean_variance, logger, spec):
        self._init_surface(device, dtype, return_mean_variance, logger)
        self._predictor_spec = spec
        self._predictor_obj = None

    def predict_normalized(self, Xq: torch.Tensor):
        """Mean and variance at unit-box queries through the per-fit
        predictor (``"solve"``, the default, is `gp_predict`)."""
        return self._predictor().predict_normalized(Xq)

    def _predictor(self):
        if self._predictor_obj is None:
            from dmosopt_tpu_torch.models.predictor import GPPredictor

            self._predictor_obj = GPPredictor(
                self.fit, self.kernel, mesh=getattr(self, "_mesh", None),
                rel_jitter=getattr(self, "_rel_jitter", None),
                **self._predictor_spec,
            )
            if (
                self._predictor_obj.regime == "nystrom"
                and self.fit.whitened is not None
            ):
                # a carried-over W = L⁻¹ was only the probe's matmul
                # fall-back; the probe passed, so release it
                self.fit = dataclasses.replace(self.fit, whitened=None)
                self._predictor_obj.fit = self.fit
        return self._predictor_obj

    def build_predictor(self):
        """Build (or return) the per-fit predictive cache eagerly
        (gp.py:1212), so `moasmo.train` pays its O(N³) build inside the
        timed train phase rather than in the first EA generation."""
        return self._predictor()

    @property
    def predictor_regime(self) -> str:
        """Regime serving predictions: the requested mode, or ``matmul``
        after a failed Nyström distillation probe."""
        if self._predictor_obj is not None:
            return self._predictor_obj.regime
        return self._predictor_spec["mode"]

    def _host_X(self) -> np.ndarray:
        """The fit's padded inputs on the host, in the fit's dtype: the
        copy kept at construction, else one device-to-host copy."""
        if getattr(self, "_X_host", None) is None:
            self._X_host = self.fit.X.detach().cpu().numpy()
        return self._X_host


class GPR_Matern(SurrogateMixin):
    """Independent exact GP per objective, Matérn-5/2 kernel (reference
    ``GPR_Matern``, model.py:1182-1275; JAX package gp.py:986):
    hyperparameters from batched multi-start Adam (from ``warm_start``
    when given), predictions through the ``predictor`` regime.
    ``dtype="float64"`` gives float64 tensors, no relative jitter.
    ``device`` None means CUDA. ``optimizer`` is accepted and ignored,
    as the JAX package ignores it.

    ``mesh`` (a `parallel.mesh.create_mesh` mesh) splits the restarts
    over its ``"model"`` axis (`fit_gp_batch`) and the predictor's
    queries over its first axis (``query_sharding``, the matmul and
    Nyström regimes). ``surrogate_mesh`` opts in to the row-sharded
    tiled-Cholesky fit (`gp_sharded.fit_gp_sharded`) from
    ``min_points`` real rows on (`_resolve_surrogate_mesh_spec`); a
    sharded fit whose NMLL is not finite is discarded for the
    single-device fit, logged and counted (`_try_fit_sharded`)."""

    kernel = "matern52"
    anisotropic_default = False

    def __init__(
        self,
        xin,
        yin,
        nInput: int,
        nOutput: int,
        xlb,
        xub,
        optimizer: str = "adam",
        seed=None,
        length_scale_bounds=(1e-3, 100.0),
        constant_kernel_bounds=(1e-4, 1e3),
        noise_level_bounds=(1e-9, 1e-2),
        anisotropic: Optional[bool] = None,
        return_mean_variance: bool = False,
        nan: Optional[str] = "remove",
        top_k: Optional[int] = None,
        n_starts: int = 8,
        n_iter: int = 200,
        learning_rate: float = 0.1,
        dtype="float32",
        rel_jitter: Optional[float] = None,
        convergence_tol="auto",
        convergence_check_every: Optional[int] = None,
        warm_start=None,
        predictor: str = "solve",
        nystrom_points: int = 512,
        nystrom_probe_points: int = 256,
        nystrom_mean_tol: float = 0.1,
        nystrom_var_ratio_tol: float = 3.0,
        mesh=None,
        surrogate_mesh=None,
        logger=None,
        device=None,
        **kwargs,
    ):
        # ``optimizer`` is taken and never read, as in the JAX package:
        # every fit runs Adam
        dt = _resolve_dtype(dtype)
        self._mesh = mesh
        self._shard_spec = _resolve_surrogate_mesh_spec(surrogate_mesh)
        spec = _resolve_predictor_spec(
            predictor, nystrom_points, nystrom_probe_points,
            nystrom_mean_tol, nystrom_var_ratio_tol,
        )
        self._init_common(device, dt, return_mean_variance, logger, spec)
        dev = self.device
        X, Yn, y_mean, y_std = _prepare_training_data(
            self, xin, yin, nInput, nOutput, xlb, xub, nan, top_k
        )
        n_real = X.shape[0]
        if anisotropic is None:
            anisotropic = self.anisotropic_default
        X, Yn, tmask = _pad_to_bucket(X, Yn)
        if rel_jitter is None:
            rel_jitter = _default_rel_jitter(dt)
        self._rel_jitter = rel_jitter
        if warm_start is not None:
            # (amp, ls, noise) of a previous converged fit of the same
            # configuration (gp.py:1061-1076)
            w_amp, w_ls, w_noise = warm_start
            Lls = int(nInput) if anisotropic else 1
            w_ls = np.asarray(w_ls, dtype=np.float64)
            if w_ls.shape != (int(nOutput), Lls):
                raise ValueError(
                    f"warm_start lengthscales have shape {w_ls.shape}; "
                    f"this fit expects {(int(nOutput), Lls)} "
                    f"(anisotropic={bool(anisotropic)})"
                )
            warm_start = tuple(
                torch.as_tensor(np.asarray(w, dtype=np.float64), dtype=dt, device=dev)
                for w in (w_amp, w_ls, w_noise)
            )
        self._set_bounds_tensors()
        # the fit's inputs as the host holds them (same rounding as the
        # device copy): the refit controller's append check reads these
        self._X_host = X.astype(np.float64 if dt == torch.float64 else np.float32)
        args = (
            torch.as_tensor(self._X_host, device=dev),
            torch.as_tensor(Yn, dtype=dt, device=dev),
        )
        common = dict(
            train_mask=torch.as_tensor(tmask, dtype=dt, device=dev),
            lengthscale_bounds=tuple(length_scale_bounds),
            amplitude_bounds=tuple(constant_kernel_bounds),
            noise_bounds=tuple(noise_level_bounds),
            kernel=self.kernel,
            n_starts=n_starts,
            n_iter=n_iter,
            learning_rate=learning_rate,
            ard=bool(anisotropic),
            rel_jitter=rel_jitter,
            convergence_tol=convergence_tol,
            convergence_check_every=convergence_check_every,
            warm_start=warm_start,
        )
        fit = shard_info = None
        if self._shard_spec is not None and mesh is not None:
            fit, shard_info = self._try_fit_sharded(seed, args, n_real, mesh, common)
        if fit is None:
            fit = fit_gp_batch(as_torch_generator(seed, dev), *args, mesh=mesh, **common)
        fit.y_mean = torch.as_tensor(y_mean, dtype=dt, device=dev)
        fit.y_std = torch.as_tensor(y_std, dtype=dt, device=dev)
        self.fit = fit
        self.fit_info = _gp_fit_info(fit, n_iter)
        if shard_info:
            self.fit_info.update(shard_info)

    def _try_fit_sharded(self, seed, args, n_real, mesh, common):
        """The row-sharded fit (`gp_sharded.fit_gp_sharded`) when the
        ``surrogate_mesh`` spec, the archive size and the mesh and bucket
        shapes allow it (gp.py:1033-1140). A tile that does not divide
        the bucket gives way to `default_chol_tile`, with a warning. A
        fit whose NMLL is not finite is discarded (counted in
        ``gp_shard_fallbacks_total``, logged) and the caller fits on one
        device instead: the routed path may fail, it is never served
        failed. A fit from the same seed draws the same restarts either
        way. Returns ``(fit or None, fit_info extras or None)``."""
        import time as _time

        from dmosopt_tpu_torch.models import gp_sharded
        from dmosopt_tpu_torch.parallel.mesh import axis_size

        spec = self._shard_spec
        X = args[0]
        P = X.shape[0]
        axis = spec["axis"] or mesh.mesh_dim_names[0]
        if n_real < spec["min_points"] or not gp_sharded.mesh_compatible(mesh, axis, P):
            return None, None
        tile = spec["tile"]
        if tile is None or tile < 1 or P % tile:
            if tile is not None and self.logger is not None:
                self.logger.warning(
                    f"surrogate_mesh: tile {tile} does not divide the "
                    f"padding bucket {P}; using {gp_sharded.default_chol_tile(P)}"
                )
            tile = gp_sharded.default_chol_tile(P)
        n_devices = axis_size(mesh, axis)
        t0 = _time.perf_counter()
        fit = gp_sharded.fit_gp_sharded(
            as_torch_generator(seed, self.device), *args,
            mesh=mesh, shard_axis=axis, tile=tile,
            # the solve predictor never reads W = L⁻¹: gathering it would
            # double every rank's share of the result
            gather_whitened=self._predictor_spec["mode"] != "solve",
            **common,
        )
        ok = bool(torch.isfinite(fit.nmll).all())
        wall = _time.perf_counter() - t0
        gp_sharded.record_sharded_fit(
            ok, wall, n_devices, tile, n_real, P, int(args[1].shape[1])
        )
        if not ok:
            if self.logger is not None:
                self.logger.warning(
                    f"surrogate_mesh: sharded fit at N={n_real} (bucket {P}, "
                    f"{n_devices} devices) produced a non-finite NMLL; fitting "
                    f"on one device instead"
                )
            return None, None
        return fit, {"sharded": True, "shard_devices": n_devices, "shard_tile": tile}


class GPR_RBF(GPR_Matern):
    """RBF-kernel variant (reference model.py:1278-1325; gp.py:1229)."""

    kernel = "rbf"


class EGP_Matern(GPR_Matern):
    """Exact GP with ARD lengthscales and more Adam steps, the analog of
    the reference's GPyTorch path (model_gpytorch.py:1929-2167; JAX
    package gp.py:1235); ``adam_lr`` is the reference's name for
    ``learning_rate``."""

    anisotropic_default = True

    def __init__(self, *args, n_iter: int = 300, **kwargs):
        if "adam_lr" in kwargs:
            kwargs.setdefault("learning_rate", float(kwargs.pop("adam_lr")))
        super().__init__(*args, n_iter=n_iter, **kwargs)


class MEGP_Matern(SurrogateMixin):
    """Multi-output exact GP fitted jointly (reference
    model_gpytorch.py:1623-1926; JAX package gp.py:1250-1328): one shared
    ARD kernel for all objectives, hyperparameters on the sum of the
    per-objective exact MLLs (`fit_gp_shared`), independent posteriors.
    Float32, as in the JAX package; ``device`` None means CUDA."""

    kernel = "matern52"

    def __init__(
        self,
        xin,
        yin,
        nInput,
        nOutput,
        xlb,
        xub,
        seed=None,
        length_scale_bounds=(1e-3, 100.0),
        constant_kernel_bounds=(1e-4, 1e3),
        noise_level_bounds=(1e-9, 1e-2),
        return_mean_variance: bool = False,
        nan: Optional[str] = "remove",
        top_k: Optional[int] = None,
        n_starts: int = 8,
        n_iter: int = 300,
        learning_rate: float = 0.1,
        convergence_tol="auto",
        convergence_check_every: Optional[int] = None,
        predictor: str = "solve",
        nystrom_points: int = 512,
        nystrom_probe_points: int = 256,
        nystrom_mean_tol: float = 0.1,
        nystrom_var_ratio_tol: float = 3.0,
        logger=None,
        device=None,
        **kwargs,
    ):
        spec = _resolve_predictor_spec(
            predictor, nystrom_points, nystrom_probe_points,
            nystrom_mean_tol, nystrom_var_ratio_tol,
        )
        dt = torch.float32
        self._init_common(device, dt, return_mean_variance, logger, spec)
        dev = self.device
        X, Yn, y_mean, y_std = _prepare_training_data(
            self, xin, yin, nInput, nOutput, xlb, xub, nan, top_k
        )
        X, Yn, tmask = _pad_to_bucket(X, Yn)
        self._set_bounds_tensors()
        self._X_host = X.astype(np.float32)
        fit = fit_gp_shared(
            as_torch_generator(seed, dev),
            torch.as_tensor(self._X_host, device=dev),
            torch.as_tensor(Yn, dtype=dt, device=dev),
            train_mask=torch.as_tensor(tmask, dtype=dt, device=dev),
            lengthscale_bounds=tuple(length_scale_bounds),
            amplitude_bounds=tuple(constant_kernel_bounds),
            noise_bounds=tuple(noise_level_bounds),
            kernel=self.kernel,
            n_starts=n_starts,
            n_iter=n_iter,
            learning_rate=learning_rate,
            convergence_tol=convergence_tol,
            convergence_check_every=convergence_check_every,
        )
        fit.y_mean = torch.as_tensor(y_mean, dtype=dt, device=dev)
        fit.y_std = torch.as_tensor(y_std, dtype=dt, device=dev)
        self.fit = fit
        self.fit_info = _gp_fit_info(fit, n_iter)
