"""Sensitivity analysis: FAST and DGSM, self-contained (no SALib).

Port of ``dmosopt_tpu/sa.py`` (reference `dmosopt/sa.py`): `SA_FAST`
(:11) and `SA_DGSM` (:47) sample the input box, evaluate the *surrogate*
on the samples and return first-order sensitivity indices `S1` per
objective; `moasmo.analyze_sensitivity` maps them to per-gene
distribution indices.

The designs are the JAX package's numpy code, so they are bit-for-bit
its designs (FAST's search curves are deterministic; DGSM draws from
``np.random.default_rng(seed)``). The surrogate evaluates the whole
design in one batched call on its device (FAST at 10 parameters and the
default 10 000 samples: 100 000 rows); its output is copied to the host
once and the spectrum and derivative reductions run in numpy, as in the
reference, so equal outputs give equal indices.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_M_HARMONICS = 4  # interference factor, standard FAST choice


def _host_outputs(Y) -> np.ndarray:
    """The surrogate's output as a host array (N, n_out): the mean of a
    (mean, variance) pair, a device tensor copied once."""
    if isinstance(Y, tuple):
        Y = Y[0]
    if isinstance(Y, torch.Tensor):
        Y = Y.detach().cpu().numpy()
    Y = np.asarray(Y)
    return Y.reshape(-1, 1) if Y.ndim == 1 else Y


class SA_FAST:
    """Fourier Amplitude Sensitivity Test (Cukier et al.; Saltelli's
    extended sampling, the method behind SALib's fast_sampler/fast)."""

    def __init__(self, lo_bounds, hi_bounds, param_names, output_names, logger=None):
        self.lb = np.asarray(lo_bounds, dtype=np.float64)
        self.ub = np.asarray(hi_bounds, dtype=np.float64)
        self.param_names = list(param_names)
        self.output_names = list(output_names)
        self.logger = logger
        self.d = len(self.param_names)

    def _frequencies(self, N: int):
        """Per-parameter frequencies: the analyzed parameter runs at
        omega_max; the complementary set gets low distinct frequencies."""
        omega_max = (N - 1) // (2 * _M_HARMONICS)
        d = self.d
        max_compl = max(omega_max // (2 * _M_HARMONICS), 1)
        compl = 1 + (np.arange(d - 1) % max_compl) if d > 1 else np.array([], int)
        return omega_max, compl

    def sample(self, num_samples: int = 10000) -> np.ndarray:
        """(d * N, d) design: one block of N points per analyzed parameter."""
        N = int(num_samples)
        omega_max, compl = self._frequencies(N)
        s = (2.0 * np.pi / N) * np.arange(N)
        blocks = []
        for i in range(self.d):
            omega = np.empty(self.d)
            omega[i] = omega_max
            omega[np.arange(self.d) != i] = compl
            x = 0.5 + (1.0 / np.pi) * np.arcsin(np.sin(omega[None, :] * s[:, None]))
            blocks.append(x)
        X = np.vstack(blocks)
        return self.lb + X * (self.ub - self.lb)

    def analyze(self, model, num_samples: int = 10000) -> Dict:
        N = int(num_samples)
        Y = _host_outputs(model.evaluate(self.sample(num_samples=N)))
        n_out = Y.shape[1]
        omega_max, _ = self._frequencies(N)

        S1s = np.zeros((self.d, n_out))
        STs = np.zeros((self.d, n_out))
        for i in range(self.d):
            y = Y[i * N : (i + 1) * N, :]  # (N, n_out)
            f = np.fft.fft(y, axis=0)
            spectrum = (np.abs(f) ** 2) / N  # power at each integer frequency
            half = spectrum[1 : (N + 1) // 2, :]
            V = half.sum(axis=0)
            # first-order: power at omega_max and its harmonics
            idx = np.arange(1, _M_HARMONICS + 1) * omega_max - 1
            idx = idx[idx < half.shape[0]]
            D1 = half[idx, :].sum(axis=0)
            # total-order: the power at frequencies <= omega_max/2 is
            # "everything but parameter i"
            cutoff = max(omega_max // 2, 1)
            Dt = half[: cutoff - 1, :].sum(axis=0) if cutoff > 1 else 0.0
            V = np.where(V == 0, 1.0, V)
            S1s[i] = D1 / V
            STs[i] = 1.0 - Dt / V

        return {
            "S1": {name: S1s[:, j] for j, name in enumerate(self.output_names)},
            "ST": {name: STs[:, j] for j, name in enumerate(self.output_names)},
        }


class SA_DGSM:
    """Derivative-based global sensitivity measures (Sobol & Kucherenko):
    v_i = E[(df/dx_i)^2] over the box, scaled by the bound range, the
    measure behind SALib's dgsm (reference sa.py:47-80)."""

    def __init__(self, lo_bounds, hi_bounds, param_names, output_names, logger=None):
        self.lb = np.asarray(lo_bounds, dtype=np.float64)
        self.ub = np.asarray(hi_bounds, dtype=np.float64)
        self.param_names = list(param_names)
        self.output_names = list(output_names)
        self.logger = logger
        self.d = len(self.param_names)

    def sample(self, num_samples: int = 1000, delta: float = 0.01, seed: int = 0):
        """Base points + per-dimension forward perturbations:
        (N * (d+1), d) design."""
        rng = np.random.default_rng(seed)
        N = int(num_samples)
        span = self.ub - self.lb
        base = self.lb + rng.uniform(size=(N, self.d)) * span * (1.0 - delta)
        rows = [base]
        for i in range(self.d):
            shifted = base.copy()
            shifted[:, i] = shifted[:, i] + delta * span[i]
            rows.append(shifted)
        return np.vstack(rows)

    def analyze(self, model, num_samples: int = 1000, delta: float = 0.01) -> Dict:
        N = int(num_samples)
        X = self.sample(num_samples=N, delta=delta)
        Y = _host_outputs(model.evaluate(X))
        n_out = Y.shape[1]
        span = self.ub - self.lb

        y0 = Y[:N]
        var = np.var(y0, axis=0)
        var = np.where(var == 0, 1.0, var)
        S1s = np.zeros((self.d, n_out))
        for i in range(self.d):
            yi = Y[(i + 1) * N : (i + 2) * N]
            g = (yi - y0) / (delta * span[i])
            vi = np.mean(g * g, axis=0)
            S1s[i] = vi * span[i] ** 2 / (np.pi**2 * var)

        return {
            "S1": {name: S1s[:, j] for j, name in enumerate(self.output_names)}
        }
