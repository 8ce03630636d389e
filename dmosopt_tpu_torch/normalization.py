"""Bound normalization helpers (reference: dmosopt/normalization.py,
pymoo-derived). Host-side utilities used by termination criteria.

Port of ``dmosopt_tpu/normalization.py``, copied: it is numpy only.
"""

from __future__ import annotations

import numpy as np


def normalize(X, xl=None, xu=None):
    """Scale X into [0, 1] given bounds; degenerate dimensions map to 0."""
    X = np.asarray(X, dtype=float)
    if xl is None and xu is None:
        return X
    xl = np.asarray(xl, dtype=float)
    xu = np.asarray(xu, dtype=float)
    denom = xu - xl
    denom = np.where(np.abs(denom) < 1e-32, 1.0, denom)
    out = (X - xl) / denom
    return np.where(np.abs(xu - xl)[None, :] < 1e-32, 0.0, out) if X.ndim == 2 else out


def denormalize(X, xl, xu):
    X = np.asarray(X, dtype=float)
    return X * (np.asarray(xu) - np.asarray(xl)) + np.asarray(xl)
