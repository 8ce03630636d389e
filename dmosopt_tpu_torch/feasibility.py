"""Feasibility models: constraint-satisfaction classifiers.

Port of ``dmosopt_tpu/feasibility.py`` (reference `dmosopt/feasibility.py`):
`LogisticFeasibilityModel`, one binary classifier per constraint
(feasible iff c > 0), `predict`/`predict_proba`, and `rank(x)` = mean
feasible probability, which every optimizer uses as an x-distance key.

Inputs are standardized and PCA-rotated on the host (a d x d SVD in
float64 numpy, as in the JAX package). The fit runs on the model's
device: every constraint's L1-regularized logistic regression, for each
regularization strength of the grid and each cross-validation fold, AND
the refit on all rows for each strength, is one batch of 300
proximal-gradient steps (`_fit_logistic_l1_batch`); the folds' held-out
accuracy then picks each constraint's strength and its refit weights are
gathered on the device. The JAX package runs the CV batch, then the
refit at the chosen strength; refitting every strength in the same batch
gives the same weights without a second loop. Nothing inside the steps
waits for the host.

The JAX package pads the rows to power-of-two buckets (and the feature
axis to d) to reuse compiled programs; its padded rows are masked out
and its padded features keep zero weights, so the unpadded fit here
computes the same answers. The fold assignment is the only random draw:
the JAX package takes ``jax.random.permutation(key, n) % 3`` from a key
seeded by ``seed``; here it is ``torch.randperm`` on a generator seeded
by ``seed`` on the model's device, or the caller's ``folds``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from dmosopt_tpu_torch.utils.device import resolve_device

# reference grid: np.logspace(-4, 4, 4) on C
_LAMBDAS = np.logspace(-4, 4, 4).astype(np.float32)
_N_FOLDS = 3
_N_STEPS = 300


def _soft_threshold(w, t):
    return torch.sign(w) * torch.clamp(torch.abs(w) - t, min=0.0)


def _fit_logistic_l1_batch(X, Y, M, lam, n_steps: int = _N_STEPS, lr: float = 0.1):
    """Proximal gradient descent on B masked logistic losses with L1
    penalty ``lam * |w|`` over one design ``X`` (n, k): labels ``Y`` (B, n),
    row masks ``M`` (B, n), strengths ``lam`` (B,). Each problem is the
    JAX package's `_fit_logistic_l1` (``dmosopt_tpu/feasibility.py:36-56``).
    Returns (w (B, k), b (B,))."""
    B, k = Y.shape[0], X.shape[1]
    w = torch.zeros((B, k), dtype=X.dtype, device=X.device)
    b = torch.zeros((B,), dtype=X.dtype, device=X.device)
    denom = torch.clamp(M.sum(dim=1), min=1.0)
    thresh = (lr * lam / denom)[:, None]
    Xt = X.T
    for _ in range(n_steps):
        g = (torch.sigmoid(w @ Xt + b[:, None]) - Y) * M
        gw = g @ X / denom[:, None]
        gb = g.sum(dim=1) / denom
        w = _soft_threshold(w - lr * gw, thresh)
        b = b - lr * gb
    return w, b


def _fit_constraints(X, Y, folds, n_folds: int = _N_FOLDS, n_steps: int = _N_STEPS):
    """Fit C constraint classifiers over one design ``X`` (n, k): labels
    ``Y`` (C, n) in {0, 1}, fold of each row ``folds`` (C, n). For every
    constraint, strength and fold one training problem (the other folds'
    rows), plus the refit on all rows for every strength, all in one
    batch. The mean held-out accuracy over the folds picks the strength
    (the first best, as ``argmax`` does in the JAX package's
    `_fit_constraint`, ``dmosopt_tpu/feasibility.py:59-83``). Returns
    (w (C, k), b (C,), cv scores (C, L), chosen strength index (C,))."""
    C, n = Y.shape
    lam = torch.as_tensor(_LAMBDAS, dtype=X.dtype, device=X.device)
    L, F = lam.shape[0], n_folds
    k_idx = torch.arange(F, device=X.device)
    train = (folds[:, None, :] != k_idx[None, :, None]).to(X.dtype)  # (C, F, n)
    every = torch.ones((C, 1, n), dtype=X.dtype, device=X.device)
    masks = torch.cat([train, every], dim=1)  # (C, F + 1, n)
    M = masks[:, None].expand(C, L, F + 1, n).reshape(-1, n)
    Yb = Y[:, None, None, :].expand(C, L, F + 1, n).reshape(-1, n)
    lamb = lam[None, :, None].expand(C, L, F + 1).reshape(-1)
    w, b = _fit_logistic_l1_batch(X, Yb, M, lamb, n_steps=n_steps)
    w = w.reshape(C, L, F + 1, -1)
    b = b.reshape(C, L, F + 1)

    pred = (torch.einsum("clfk,nk->clfn", w[:, :, :F], X) + b[:, :, :F, None]) > 0
    held = (folds[:, None, :] == k_idx[None, :, None])[:, None]  # (C, 1, F, n)
    correct = (pred == (Y[:, None, None, :] > 0.5)) & held
    acc = correct.sum(dim=-1) / torch.clamp(held.sum(dim=-1), min=1)
    scores = acc.mean(dim=-1)  # (C, L)
    best = torch.argmax(scores, dim=1)
    rows = torch.arange(C, device=X.device)
    return w[rows, best, F], b[rows, best, F], scores, best


class LogisticFeasibilityModel:
    """Per-constraint L1 logistic feasibility classifier (reference
    dmosopt/feasibility.py:14-67; ``dmosopt_tpu/feasibility.py:86-171``).

    ``folds`` (optional): the fold of each row, (n,) for every constraint
    or (n_constraints, n); by default a permutation of the rows modulo 3,
    drawn per fitted constraint from a generator seeded by ``seed``.
    ``device`` None means CUDA. `rank`, `predict` and `predict_proba`
    return tensors on the device and never wait for the host."""

    def __init__(self, X, C, seed: Optional[int] = 0, folds=None, device=None):
        self.device = dev = resolve_device(device)
        X = np.asarray(X, dtype=np.float64)
        C = np.asarray(C, dtype=np.float64)
        if C.ndim == 1:
            C = C.reshape(-1, 1)
        self.n_constraints = C.shape[1]
        self.X = X

        # standardize + PCA rotation (shared by all constraints)
        self.x_mean = X.mean(axis=0)
        self.x_std = np.where(X.std(axis=0) == 0.0, 1.0, X.std(axis=0))
        Z = (X - self.x_mean) / self.x_std
        _, _, Vt = np.linalg.svd(Z, full_matrices=False)
        self.rotation = Vt.T  # (d, k)
        Zr = Z @ self.rotation
        n, k_dim = Zr.shape

        labels = (C > 0.0).astype(np.float32)  # (n, n_constraints)
        # a constraint seen in one class only gets no classifier: w = 0
        # and b = 30, so its feasibility probability is ~1 (reference
        # behaviour, dmosopt_tpu/feasibility.py:139-149)
        self.fitted = [
            i for i in range(self.n_constraints) if len(np.unique(labels[:, i])) > 1
        ]
        W = torch.zeros((self.n_constraints, k_dim), dtype=torch.float32, device=dev)
        b = torch.full((self.n_constraints,), 30.0, dtype=torch.float32, device=dev)
        if self.fitted:
            idx = torch.as_tensor(self.fitted, device=dev)
            w_fit, b_fit, _, _ = _fit_constraints(
                torch.as_tensor(Zr.astype(np.float32), device=dev),
                torch.as_tensor(labels[:, self.fitted].T.copy(), device=dev),
                self._folds(folds, n, seed),
            )
            W[idx] = w_fit
            b[idx] = b_fit
        self._set_parameters(self.x_mean, self.x_std, self.rotation, W, b)

    def _folds(self, folds, n: int, seed) -> torch.Tensor:
        """(len(fitted), n) fold index of each row for each fitted
        constraint: the caller's, or one seeded permutation each."""
        if folds is not None:
            f = np.asarray(folds, dtype=np.int64)
            f = np.broadcast_to(f, (self.n_constraints, n)) if f.ndim == 1 else f
            return torch.as_tensor(f[self.fitted], device=self.device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed or 0))
        return torch.stack([
            torch.randperm(n, generator=gen, device=self.device) % _N_FOLDS
            for _ in self.fitted
        ])

    def _set_parameters(self, x_mean, x_std, rotation, W, b):
        """The device copies `rank` and `predict` read."""
        f32 = dict(dtype=torch.float32, device=self.device)
        self._x_mean = torch.as_tensor(np.asarray(x_mean), **f32)
        self._x_std = torch.as_tensor(np.asarray(x_std), **f32)
        self._rot = torch.as_tensor(np.asarray(rotation), **f32)
        self._W = torch.as_tensor(W, **f32)
        self._b = torch.as_tensor(b, **f32)

    @classmethod
    def from_parameters(cls, x_mean, x_std, rotation, W, b, device=None):
        """A fitted model from its parameters (standardization, rotation,
        stacked weights (n_constraints, k) and biases), without a fit."""
        self = cls.__new__(cls)
        self.device = resolve_device(device)
        self.X = None
        self.x_mean, self.x_std = np.asarray(x_mean), np.asarray(x_std)
        self.rotation = np.asarray(rotation)
        W, b = np.asarray(W, np.float32), np.asarray(b, np.float32)
        self.n_constraints = W.shape[0]
        self.fitted = [
            i for i in range(self.n_constraints)
            if np.any(W[i] != 0.0) or b[i] != 30.0
        ]
        self._set_parameters(self.x_mean, self.x_std, self.rotation, W, b)
        return self

    @property
    def weights(self):
        """Per-constraint host copies (w, b), None for a constraint seen
        in one class only (the JAX package's ``weights`` list)."""
        W, b = self._W.cpu().numpy(), self._b.cpu().numpy()
        return [
            (W[i], float(b[i])) if i in self.fitted else None
            for i in range(self.n_constraints)
        ]

    def _proba_feasible(self, x) -> torch.Tensor:
        """(..., N, n_constraints) probability of feasibility of the rows
        of ``x`` (..., N, d); a leading batch axis (SMPSO's swarms) passes
        through."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        if x.dim() == 1:
            x = x[None]
        Z = ((x - self._x_mean) / self._x_std) @ self._rot
        return torch.sigmoid(Z @ self._W.T + self._b)

    def predict(self, x) -> torch.Tensor:
        """(N, n_constraints) hard feasibility predictions (int64)."""
        return (self._proba_feasible(x) > 0.5).long()

    def predict_proba(self, x) -> torch.Tensor:
        """(n_constraints, N, 2) class probabilities, sklearn layout
        (column 1 = feasible)."""
        p = self._proba_feasible(x).transpose(-1, -2)
        return torch.stack([1.0 - p, p], dim=-1)

    def rank(self, x) -> torch.Tensor:
        """Mean feasible probability per row (reference :64-67), the
        optimizers' x-distance key."""
        return self._proba_feasible(x).mean(dim=-1)

    def get_stats(self):
        return {
            "n_constraints": self.n_constraints,
            "n_fitted": len(self.fitted),
            "n_steps": _N_STEPS if self.fitted else 0,
        }
