"""ZDT1 (Zitzler, Deb and Thiele 2000), float64."""

import numpy as np


def evaluate(x, **_params):
    x = np.asarray(x, dtype=np.float64)
    f1 = x[:, 0]
    g = 1.0 + 9.0 / (x.shape[1] - 1) * np.sum(x[:, 1:], axis=1)
    f2 = g * (1.0 - np.sqrt(f1 / g))
    return np.stack([f1, f2], axis=1)
