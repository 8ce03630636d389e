"""The plain reference against independent statements of the same
mathematics."""

import math

import numpy as np
import pytest
import torch

from h100bench.reference import gp as rgp
from h100bench.reference import pareto, problems


def test_zdt1_on_its_front():
    x = np.zeros((5, 30))
    x[:, 0] = np.linspace(0, 1, 5)
    y = problems.load("zdt1")(x)
    np.testing.assert_allclose(y[:, 1], 1 - np.sqrt(x[:, 0]))


def test_dtlz2_on_its_front_and_off_it():
    rng = np.random.default_rng(0)
    x = rng.random((20, 14))
    x[:, 4:] = 0.5
    y = problems.load("dtlz2")(x, n_obj=5)
    np.testing.assert_allclose(np.sum(y ** 2, axis=1), 1.0, rtol=1e-12)
    x[:, 4:] = 0.0
    y = problems.load("dtlz2")(x, n_obj=5)
    np.testing.assert_allclose(np.sum(y ** 2, axis=1), (1 + 10 * 0.25) ** 2, rtol=1e-12)


def test_non_dominated():
    Y = np.array([[0, 1], [1, 0], [1, 1], [0.5, 0.5], [0.5, 0.5], [2, -1]])
    assert pareto.non_dominated(Y).tolist() == [True, True, False, True, True, True]
    assert pareto.dominated_by_any(np.array([[3.0, 3.0], [-1, -1]]), Y).tolist() == [True, False]


def _dense_nmll(X, y, amp, ls, noise):
    d = np.sqrt(((X[:, None, :] - X[None, :, :]) ** 2).sum(-1)) / ls
    K = amp * (1 + math.sqrt(5) * d + 5 / 3 * d ** 2) * np.exp(-math.sqrt(5) * d)
    K += (noise + 1e-6 + 1e-4 * amp) * np.eye(len(X))
    sign, logdet = np.linalg.slogdet(K)
    return 0.5 * y @ np.linalg.solve(K, y) + 0.5 * logdet + 0.5 * len(X) * math.log(2 * math.pi)


def _toy(n=25, dim=3, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.random((n, dim))
    Y = np.stack([np.sin(3 * X[:, 0]) + X[:, 1], np.cos(2 * X[:, 2])], axis=1)
    return torch.tensor(X), torch.tensor(Y)


def test_hv_stall_is_one_inside_the_pool_and_falls_with_what_a_batch_adds():
    rng = np.random.default_rng(3)
    pool = rng.random((60, 5))
    assert pareto.hv_stall(pool, pool[rng.choice(60, 20, replace=False)]) == 1.0
    # one point that dominates the whole pool covers the union's whole box
    assert pareto.hv_stall(pool, pool.min(0, keepdims=True) - 0.01) < 0.5
    # in two objectives the volumes are areas: a pool of one point at (1, 1) and a batch
    # point at (0, 0) in the box [0, 1.1]^2 cover 0.01 and 1.21
    assert pareto.hv_stall([[1.0, 1.0]], [[0.0, 0.0]], n_samples=1 << 16) == pytest.approx(
        0.01 / 1.21, abs=2e-3)


def test_nmll_and_posterior_against_dense_numpy():
    X, Y = _toy()
    Yn, mean, std = rgp.standardise(Y)
    amp = torch.tensor([1.3, 0.7], dtype=torch.float64)
    ls = torch.tensor([[0.4], [0.9]], dtype=torch.float64)
    noise = torch.tensor([1e-3, 1e-5], dtype=torch.float64)
    got = rgp.nmll(X, Yn, amp, ls, noise)
    for k in range(2):
        want = _dense_nmll(X.numpy(), Yn[:, k].numpy(), amp[k].item(), ls[k, 0].item(), noise[k].item())
        assert got[k].item() == pytest.approx(want, rel=1e-10)
    mu = rgp.posterior_mean(X, Yn, mean, std, amp, ls, noise, X)
    # near-noiseless GPs interpolate their data
    assert torch.max(torch.abs(mu - Y) / std).item() < 0.05


def test_slack_is_small_at_a_minimum_and_large_away_from_it():
    X, Y = _toy(seed=1)
    Yn, _, _ = rgp.standardise(Y)
    dt = torch.float64
    bounds = (rgp.Bounds(1e-4, 1e3, dt, "cpu"), rgp.Bounds(1e-3, 100.0, dt, "cpu"),
              rgp.Bounds(1e-9, 1e-2, dt, "cpu"))
    amp = torch.tensor([50.0, 50.0], dtype=dt)
    ls = torch.tensor([[20.0], [20.0]], dtype=dt)
    noise = torch.tensor([1e-2, 1e-2], dtype=dt)
    far = rgp.nmll_slack(X, Yn, amp, ls, noise, bounds, 0.1, 30)
    assert far.min().item() > 0.05
    assert rgp.nmll_slack(X, Yn, amp, ls, noise, bounds, 0.1, 0).abs().max().item() == 0.0
    # walk to a minimum with many steps, then the slack there is small
    p = [b.inverse(t).clone().requires_grad_(True) for b, t in zip(bounds, (amp, ls, noise))]
    opt = torch.optim.Adam(p, lr=0.05)
    for _ in range(1500):
        opt.zero_grad()
        rgp.nmll(X, Yn, *(b.forward(v) for b, v in zip(bounds, p))).sum().backward()
        opt.step()
    near = rgp.nmll_slack(X, Yn, *(b.forward(v.detach()) for b, v in zip(bounds, p)), bounds, 0.1, 30)
    assert near.max().item() < 1e-3 < far.min().item()


def test_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11 + 2 ** -13, 3.14159265], dtype=torch.float32)
    r = rgp._tf32(x)
    assert r[0].item() == 1.0 + 2 ** -10
    assert r[1].item() == 1.0 + 2 ** -10
    assert abs(r[2].item() - 3.14159265) <= 2 ** -10 * 2
