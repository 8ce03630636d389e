"""DTLZ2 with ``n_obj`` objectives on a (B, n) float32 tensor."""

import math

import torch


def evaluate(x, n_obj, **_params):
    m = int(n_obj)
    g = torch.sum((x[:, m - 1:] - 0.5) ** 2, dim=1)
    a = x[:, : m - 1] * (math.pi / 2.0)
    cos, sin = torch.cos(a), torch.sin(a)
    cols = []
    for i in range(m):
        v = torch.prod(cos[:, : m - 1 - i], dim=1)
        if i > 0:
            v = v * sin[:, m - 1 - i]
        cols.append(v)
    return torch.stack(cols, dim=1) * (1.0 + g)[:, None]
