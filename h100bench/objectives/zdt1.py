"""ZDT1 on a (B, n) float32 tensor."""

import torch


def evaluate(x, **_params):
    f1 = x[:, 0]
    g = 1.0 + 9.0 / (x.shape[1] - 1) * torch.sum(x[:, 1:], dim=1)
    f2 = g * (1.0 - torch.sqrt(f1 / g))
    return torch.stack([f1, f2], dim=1)
