"""DTLZ2 with ``n_obj`` objectives (Deb, Thiele, Laumanns and Zitzler 2005), float64."""

import numpy as np


def evaluate(x, n_obj, **_params):
    x = np.asarray(x, dtype=np.float64)
    m = int(n_obj)
    g = np.sum((x[:, m - 1:] - 0.5) ** 2, axis=1)
    a = x[:, : m - 1] * (np.pi / 2.0)
    f = np.empty((x.shape[0], m))
    for i in range(m):
        # f_i = (1 + g) cos(a_0) ... cos(a_{m-2-i}) [sin(a_{m-1-i}) for i > 0]
        v = np.prod(np.cos(a[:, : m - 1 - i]), axis=1)
        if i > 0:
            v = v * np.sin(a[:, m - 1 - i])
        f[:, i] = v
    return f * (1.0 + g)[:, None]
