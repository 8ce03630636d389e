"""Per-fit predictive caches for the exact-GP family.

Port of ``dmosopt_tpu/models/predictor.py``. The inner EA calls the
surrogate every generation, and with the default ``solve`` regime each
call back-substitutes against the (d, P, P) Cholesky factor, O(N²·M) per
objective and sequential. `GPPredictor` is built once per fit (inside
`moasmo.train`'s timed phase) and serves every generation of the epoch
in one of three regimes:

- ``solve`` (default): `gp.gp_predict`, the oracle of the other two.
- ``matmul``: the whitening factor ``W = L⁻¹`` is built once per fit
  (O(N³)); a prediction's variance is ``amp + noise − Σ (W Ks)²``, a
  batched matrix product with no triangular solve. A rank-k append
  extends W by the block triangular-inverse identity
  (`extend_whitened_rank_k`) instead of rebuilding it.
- ``nystrom``: the posterior distilled onto m inducing rows (a
  deterministic stride subsample of the training rows) in the whitened
  inducing basis ``φ(x) = Lzz⁻¹ k(Z, x)``: ``mean ≈ φᵀw``, ``var ≈
  amp + noise − φᵀBφ``, O(m²·M) a prediction whatever N is. A probe on
  held-out training rows gates it: if the standardized mean error or
  the variance ratio exceeds its tolerance, the predictor serves
  ``matmul`` instead.

The algebra is the reference's with torch's batched linear algebra
(`torch.linalg.solve_triangular`, `torch.linalg.cholesky_ex`,
`torch.matmul`) over the leading objective axis in place of `jax.vmap`.
The inducing kernel's Cholesky uses `cholesky_ex`: a block that is not
positive definite gives NaN caches, which the probe rejects. A build on
a CUDA device synchronizes before it returns, so its O(N³) work lands in
the timed train phase and not in the first EA generation
(predictor.py:384-391).

With a telemetry attached for a run (`set_predictor_telemetry`, which
`run()` sets and clears) every build counts in
``gp_predictor_builds_total`` {regime}, sets ``gp_predictor_cache_bytes``
(and ``gp_distill_error`` after a Nyström probe) and emits a
``gp_predictor`` event; a predict outside the generation loop (the
initial design's) is timed into ``gp_predict_seconds``, synchronizing
the device first, as the JAX package times its eager calls; predicts
inside the loop are not (`telemetry.hooks`).

``query_sharding`` (a `parallel.mesh.population_sharding`; the
predictor builds one over its mesh's first axis for the matmul and
Nyström regimes, predictor.py:116-131, :359-365) splits a predict's
queries over the mesh: each rank predicts its block of rows and one
``all_gather`` an output returns them in order, so the predict inside a
mesh run's generation scales over the ranks with the cache replicated.
Caches are derived state and never persisted.
"""

from __future__ import annotations

import time
from functools import partial
from typing import NamedTuple, Optional

import numpy as np
import torch

from dmosopt_tpu_torch.models.gp import (
    _JITTER,
    _KERNELS,
    GPFit,
    _cholesky_or_nan,
    _default_rel_jitter,
    gp_predict,
)

#: predictor regimes accepted by the exact-GP family's ``predictor`` option
PREDICTOR_MODES = ("solve", "matmul", "nystrom")

# the run's telemetry, set by `run()` for its duration (None: no calls)
_TELEMETRY = None


def set_predictor_telemetry(tel) -> None:
    """Attach a `telemetry.Telemetry` (or None) to the predictor layer:
    builds, cache bytes, distillation error and the latency of predicts
    outside the generation loop (``dmosopt_tpu/models/predictor.py:79``).
    Process-wide; `run()` sets it for the run and clears it after."""
    global _TELEMETRY
    _TELEMETRY = tel


def _synchronize(t: torch.Tensor):
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def _moments(mean_std, quad, amp, noise, y_mean, y_std):
    """Output-unit mean and variance (M, d) from the standardized mean
    (d, M) and the variance's quadratic term (d, M), the variance floored
    at 1e-12 as in `gp_predict`."""
    var = torch.clamp(amp[:, None] + noise[:, None] - quad, min=1e-12)
    mean = y_mean[:, None] + y_std[:, None] * mean_std
    return mean.T, ((y_std * y_std)[:, None] * var).T


# ------------------------------------------------------------ matmul regime
#
# The cache is W = L⁻¹, not the kernel's inverse: ‖W Ks‖² is a sum of
# squares whose float32 error scales with cond(L) = √cond(K), where the
# quadratic form Ksᵀ K⁻¹ Ks would lose cond(K)·eps (reference
# predictor.py:89-96).


def build_whitened_cache(fit: GPFit) -> torch.Tensor:
    """(d, P, P) inverse Cholesky factor ``W = L⁻¹`` of the masked,
    regularized training kernel (reference predictor.py:101); padded rows
    keep identity blocks."""
    P = fit.L.shape[-1]
    eye = torch.eye(P, dtype=fit.L.dtype, device=fit.L.device)
    return torch.linalg.solve_triangular(fit.L, eye, upper=False)


def _sharded(predict, Xq, query_sharding):
    """``predict(Xq)`` with the queries split over ``query_sharding``'s
    axis (each rank's block, gathered in order), or whole."""
    if query_sharding is None:
        return predict(Xq)
    from dmosopt_tpu_torch.parallel.mesh import gather_rows

    return gather_rows(predict, Xq, query_sharding.mesh, query_sharding.axis)


def gp_predict_matmul(fit: GPFit, W: torch.Tensor, Xq: torch.Tensor,
                      kernel: str = "matern52", query_sharding=None):
    """Posterior mean and variance with the variance as a batched matrix
    product (reference predictor.py:117): ``W Ks`` equals the ``L⁻¹ Ks``
    that `gp_predict` back-substitutes for; the mean is the same
    ``Ksᵀα``. ``query_sharding`` splits the queries over a mesh axis.
    Returns ((M, d), (M, d))."""
    return _sharded(partial(_predict_matmul, fit, W, kernel=kernel), Xq, query_sharding)


def _predict_matmul(fit: GPFit, W: torch.Tensor, Xq: torch.Tensor, kernel: str):
    Ks = _KERNELS[kernel](fit.X, Xq, fit.ls, fit.amp)  # (d, P, M)
    Ks = Ks * fit.train_mask[:, None].to(Ks.dtype)
    mean = torch.matmul(Ks.mT, fit.alpha[..., None])[..., 0]
    v = torch.matmul(W, Ks)
    return _moments(mean, torch.sum(v * v, dim=-2), fit.amp, fit.noise,
                    fit.y_mean, fit.y_std)


def extend_whitened_rank_k(W_old: torch.Tensor, L_new: torch.Tensor,
                           n_old: int, n_new: int) -> torch.Tensor:
    """Rank-k update of the whitening cache for rows appended inside the
    padding bucket (reference predictor.py:155), the block
    triangular-inverse identity

        [L11  0 ]⁻¹ = [W11                 0    ]
        [L21  L22]    [−L22⁻¹ L21 W11   L22⁻¹]

    with L21, L22 read off the factor that `extend_cholesky_rank_k`
    returned; O(N²k) per objective. Rows ≥ n_new keep their identity."""
    k = n_new - n_old
    W11 = W_old[:, :n_old, :n_old]
    L21 = L_new[:, n_old:n_new, :n_old]
    L22 = L_new[:, n_old:n_new, n_old:n_new]
    eye = torch.eye(k, dtype=L_new.dtype, device=L_new.device)
    W22 = torch.linalg.solve_triangular(L22, eye, upper=False)
    W = W_old.clone()
    W[:, n_old:n_new, :n_old] = -torch.matmul(W22, torch.matmul(L21, W11))
    W[:, n_old:n_new, n_old:n_new] = W22
    return W


# ----------------------------------------------------------- nystrom regime


class NystromCache(NamedTuple):
    """Distilled posterior (reference predictor.py:196): no tensor whose
    size depends on the archive length, all in the whitened inducing
    basis."""

    Z: torch.Tensor  # (m, n) inducing inputs (a subset of training rows)
    Wzz: torch.Tensor  # (d, m, m) whitening factor Lzz⁻¹ of the inducing kernel
    w: torch.Tensor  # (d, m) distilled mean weights
    B: torch.Tensor  # (d, m, m) distilled variance form φᵀBφ (PSD)
    amp: torch.Tensor  # (d,)
    ls: torch.Tensor  # (d, L)
    noise: torch.Tensor  # (d,)
    y_mean: torch.Tensor  # (d,)
    y_std: torch.Tensor  # (d,)


def build_nystrom_cache(fit: GPFit, z_idx: torch.Tensor, kernel: str,
                        rel_jitter: Optional[float]) -> NystromCache:
    """Distill the exact posterior onto the inducing rows ``Z =
    X[z_idx]`` (reference predictor.py:216), with ``T = Lzz⁻¹ k(Z, X)``:

        w = T α,    B = (L⁻¹ Tᵀ)ᵀ (L⁻¹ Tᵀ)

    O(N²m) to build per objective. A Kzz that is not positive definite
    gives NaN caches."""
    kernel_fn = _KERNELS[kernel]
    if rel_jitter is None:
        rel_jitter = _default_rel_jitter(fit.X.dtype)
    Z = fit.X[z_idx]
    m = Z.shape[0]
    eye = torch.eye(m, dtype=Z.dtype, device=Z.device)
    Kzz = kernel_fn(Z, Z, fit.ls, fit.amp)  # (d, m, m)
    Kzz = 0.5 * (Kzz + Kzz.mT) + (_JITTER + rel_jitter * fit.amp)[:, None, None] * eye
    Wzz = torch.linalg.solve_triangular(_cholesky_or_nan(Kzz), eye, upper=False)
    C = kernel_fn(Z, fit.X, fit.ls, fit.amp)  # (d, m, P)
    C = C * fit.train_mask[None, :].to(C.dtype)
    T = torch.matmul(Wzz, C)  # (d, m, P)
    w = torch.matmul(T, fit.alpha[..., None])[..., 0]
    A1 = torch.linalg.solve_triangular(fit.L, T.mT, upper=False)  # (d, P, m)
    B = torch.matmul(A1.mT, A1)
    return NystromCache(
        Z=Z, Wzz=Wzz, w=w, B=0.5 * (B + B.mT), amp=fit.amp, ls=fit.ls,
        noise=fit.noise, y_mean=fit.y_mean, y_std=fit.y_std,
    )


def gp_predict_nystrom(cache: NystromCache, Xq: torch.Tensor,
                       kernel: str = "matern52", query_sharding=None):
    """Posterior mean and variance from the distilled cache (reference
    predictor.py:264): matrix products against (m, m) factors only.
    ``query_sharding`` splits the queries over a mesh axis."""
    return _sharded(partial(_predict_nystrom, cache, kernel=kernel), Xq, query_sharding)


def _predict_nystrom(cache: NystromCache, Xq: torch.Tensor, kernel: str):
    Kq = _KERNELS[kernel](cache.Z, Xq, cache.ls, cache.amp)  # (d, m, M)
    phi = torch.matmul(cache.Wzz, Kq)
    mean = torch.matmul(phi.mT, cache.w[..., None])[..., 0]
    quad = torch.sum(phi * torch.matmul(cache.B, phi), dim=-2)
    return _moments(mean, quad, cache.amp, cache.noise, cache.y_mean, cache.y_std)


# --------------------------------------------------------------- the layer


def _stride_subsample(rows: np.ndarray, m: int) -> np.ndarray:
    """An even, deterministic subsample of ``rows`` of at most m entries
    (no random draws: building a predictor must not shift any seeded
    trajectory)."""
    return rows[np.unique(np.round(np.linspace(0, len(rows) - 1, m)).astype(np.int64))]


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float64)


class GPPredictor:
    """Per-fit predictive cache for one `GPFit` (reference
    predictor.py:310-558). ``mode`` is the requested regime, ``regime``
    the one serving (``nystrom`` falls back to ``matmul`` when its
    distillation probe fails). The cache is built in the constructor."""

    def __init__(
        self,
        fit: GPFit,
        kernel: str,
        mode: str = "solve",
        *,
        mesh=None,
        rel_jitter: Optional[float] = None,
        nystrom_points: int = 512,
        nystrom_probe_points: int = 256,
        nystrom_mean_tol: float = 0.1,
        nystrom_var_ratio_tol: float = 3.0,
    ):
        if mode not in PREDICTOR_MODES:
            raise ValueError(f"predictor mode {mode!r} not in {PREDICTOR_MODES}")
        self.fit = fit
        self.kernel = kernel
        self.mode = mode
        self.regime = mode
        self._rel_jitter = (
            rel_jitter if rel_jitter is not None else _default_rel_jitter(fit.X.dtype)
        )
        self._opts = dict(
            nystrom_points=int(nystrom_points),
            nystrom_probe_points=int(nystrom_probe_points),
            nystrom_mean_tol=float(nystrom_mean_tol),
            nystrom_var_ratio_tol=float(nystrom_var_ratio_tol),
        )
        # a mesh splits the matmul and Nyström predicts' queries over its
        # first axis (the solve regime stays whole, as in the reference)
        self._query_sharding = None
        if mesh is not None and mode != "solve":
            from dmosopt_tpu_torch.parallel.mesh import population_sharding

            self._query_sharding = population_sharding(mesh, mesh.mesh_dim_names[0])
        self.whitened = None  # (d, P, P) W = L⁻¹ (matmul regime)
        self.nystrom = None  # NystromCache (nystrom regime)
        self.distill_error: Optional[dict] = None
        t0 = time.perf_counter()
        self._build()
        self._record_build(time.perf_counter() - t0)

    # ------------------------------------------------------------- build

    def _build(self):
        if self.mode == "solve":
            return
        if self.mode == "nystrom":
            if self._build_nystrom():
                _synchronize(self.fit.L)
                return
            self.regime = "matmul"  # the probe's fall-back
        # a mesh-sharded fit (this package's, or the JAX package's carried
        # over) already holds W = L⁻¹: adopt it, no rebuild
        W = self.fit.whitened
        self.whitened = build_whitened_cache(self.fit) if W is None else W
        _synchronize(self.whitened)

    def _build_nystrom(self) -> bool:
        """Distill and probe against the exact solve on held-out training
        rows; True when the distillation is within tolerance (reference
        predictor.py:399-469)."""
        real = np.flatnonzero(_host(self.fit.train_mask) > 0.0)
        z_idx = _stride_subsample(real, min(self._opts["nystrom_points"], len(real)))
        dev = self.fit.X.device
        self.nystrom = build_nystrom_cache(
            self.fit, torch.as_tensor(z_idx, device=dev), self.kernel,
            self._rel_jitter,
        )
        # stride over the whole held-out set, not its prefix: archives
        # grow at the tail, where the EA queries next
        held_out = np.setdiff1d(real, z_idx)
        probe = held_out if len(held_out) else z_idx
        probe = _stride_subsample(
            probe, min(self._opts["nystrom_probe_points"], len(probe))
        )
        Xp = self.fit.X[torch.as_tensor(probe, device=dev)]
        mean_e, var_e = map(_host, gp_predict(self.fit, Xp, kernel=self.kernel))
        mean_n, var_n = map(_host, gp_predict_nystrom(self.nystrom, Xp, kernel=self.kernel))
        y_std = np.maximum(_host(self.fit.y_std), 1e-12)
        mean_err = float(np.max(np.abs(mean_n - mean_e) / y_std[None, :]))
        # variance ratio floored at 0.1% of the amplitude (output units):
        # at held-out training rows the exact variance sits near the
        # noise floor, where a ratio would amplify sub-noise differences
        floor = 1e-3 * (_host(self.fit.amp) + _host(self.fit.noise)) * y_std**2
        ve = np.maximum(var_e, floor[None, :])
        vn = np.maximum(var_n, floor[None, :])
        var_ratio = float(np.max(np.maximum(vn / ve, ve / vn)))
        # NaN errors (a failed distillation) fail both comparisons
        ok = (
            mean_err <= self._opts["nystrom_mean_tol"]
            and var_ratio <= self._opts["nystrom_var_ratio_tol"]
        )
        self.distill_error = {
            "mean_err": mean_err,
            "var_ratio": var_ratio,
            "m": int(len(z_idx)),
            "probe_points": int(len(probe)),
            "ok": ok,
        }
        if not ok:
            self.nystrom = None
        return ok

    def _record_build(self, build_s: float):
        tel = _TELEMETRY
        if not tel:
            return
        tel.inc("gp_predictor_builds_total", regime=self.regime)
        tel.gauge("gp_predictor_cache_bytes", float(self.cache_bytes()))
        fields = dict(
            regime=self.regime, mode=self.mode,
            n_train=int((self.fit.train_mask > 0.0).sum()),
            bucket=int(self.fit.X.shape[0]),
            build_s=round(build_s, 6),
            cache_bytes=int(self.cache_bytes()),
        )
        if self.distill_error is not None:
            tel.gauge("gp_distill_error", self.distill_error["mean_err"])
            fields.update(
                distill_mean_err=round(self.distill_error["mean_err"], 6),
                distill_var_ratio=round(self.distill_error["var_ratio"], 6),
                distill_m=self.distill_error["m"],
                fallback=not self.distill_error["ok"],
            )
        tel.event("gp_predictor", **fields)

    def cache_bytes(self) -> int:
        """Bytes held by the per-fit cache beyond the fit itself."""
        tensors = {"matmul": [self.whitened], "nystrom": self.nystrom}.get(self.regime)
        return int(sum(t.numel() * t.element_size() for t in tensors or ()))

    # ----------------------------------------------------------- predict

    def predict_normalized(self, Xq: torch.Tensor):
        """Mean and variance at unit-box queries, routed by regime. With
        the telemetry attached, a call outside the generation loop times
        itself into ``gp_predict_seconds``."""
        from dmosopt_tpu_torch.telemetry.hooks import in_generation_loop

        tel = None if in_generation_loop() else _TELEMETRY
        t0 = time.perf_counter() if tel else None
        if self.regime == "matmul":
            out = gp_predict_matmul(self.fit, self.whitened, Xq, kernel=self.kernel,
                                    query_sharding=self._query_sharding)
        elif self.regime == "nystrom":
            out = gp_predict_nystrom(self.nystrom, Xq, kernel=self.kernel,
                                     query_sharding=self._query_sharding)
        else:
            out = gp_predict(self.fit, Xq, kernel=self.kernel)
        if tel:
            _synchronize(out[0])
            tel.observe("gp_predict_seconds", time.perf_counter() - t0)
        return out

    # ----------------------------------------------- cross-epoch updates

    def after_rank_update(self, fit: GPFit, n_old: int, n_new: int):
        """Predictor for a posterior extended in place by
        `extend_cholesky_rank_k` in the same bucket (reference
        predictor.py:515): the matmul cache is extended at O(N²k), solve
        carries no cache, and nystrom returns None (its inducing set and
        probe depend on the rows, so the caller rebuilds). None always
        means "rebuild", never "serve the stale cache"."""
        if self.regime == "solve":
            return self._clone_for(fit)
        if (
            self.regime == "matmul"
            and self.whitened is not None
            and fit.L.shape == self.fit.L.shape
        ):
            t0 = time.perf_counter()
            new = self._clone_for(fit)
            new.whitened = extend_whitened_rank_k(self.whitened, fit.L, n_old, n_new)
            _synchronize(new.whitened)
            new._record_build(time.perf_counter() - t0)
            return new
        return None

    def _clone_for(self, fit: GPFit) -> "GPPredictor":
        new = object.__new__(GPPredictor)
        new.__dict__.update(self.__dict__)
        new.fit = fit
        new.whitened = None
        new.nystrom = None
        new.distill_error = None
        new.regime = "solve" if self.mode == "solve" else "matmul"
        return new
