"""Host-side sample filtering policies for surrogate training data.

Port of ``dmosopt_tpu/ops/filtering.py`` (numpy only, copied so the port
imports nothing of the JAX package). Semantics follow reference
`dmosopt/MOEA.py:445-467` (``filter_samples``): NaN handling by removal,
max-substitution, or constant fill, plus optional log-zscore outlier
rejection.
"""

from __future__ import annotations

import numpy as np


def filter_samples(y, *companion_arrays, nan="remove", outliers="ignore"):
    """Filter objective rows (and companion arrays row-wise) by NaN/outlier
    policy. ``nan`` in {"remove", "max", <float fill>}; ``outliers`` in
    {"ignore", "zscore"}. Returns (y_filtered, *companions_filtered)."""
    y = np.array(y, copy=True, dtype=float)
    mask = np.ones(y.shape[0], dtype=bool)
    if nan == "max":
        m = np.max(np.nan_to_num(y), axis=0)
        for c in range(y.shape[1]):
            y[:, c] = np.nan_to_num(y[:, c], nan=max(1e3 * m[c], 1e5))
    elif nan == "remove":
        mask = ~np.any(np.isnan(y), axis=1)
    else:
        y = np.nan_to_num(y, nan=float(nan))

    if outliers == "zscore":
        # stats over rows surviving the NaN mask only, and log clipped to
        # its domain, so one NaN/negative row cannot poison the column stats
        with np.errstate(invalid="ignore", divide="ignore"):
            ylog = np.log(np.maximum(y + 1, 1e-300))
        ok = ylog[mask]
        ylstd = np.std(ok, axis=0)
        ylstd = np.where(ylstd == 0.0, 1.0, ylstd)
        zscores = (ylog - np.mean(ok, axis=0)) / ylstd
        mask = mask & ~np.any(np.abs(zscores) > 2, axis=1)

    out = [y[mask]]
    for arr in companion_arrays:
        out.append(arr[mask] if arr is not None else None)
    return tuple(out)
