"""The port's mesh-sharded GP fit (`models.gp_sharded`) on a one-process
mesh, mirroring tests/test_gp_sharded.py:50-420.

The tiled stages are held to the dense ones: the posterior at fixed
hyperparameters against a float64 dense oracle (`gp.posterior_from_params`
and `predictor.build_whitened_cache` in float64; a float64 sharded run
within 1e-9, a float32 one within the bars the float32 dense path meets,
L atol 2e-5, alpha and W 2e-4 of their scales, the NMLL rtol 1e-4, and
no further from the oracle than twice the float32 dense path), the
analytic backward pass against autograd of the dense NMLL in float64
(rtol 1e-7), and the full fit against `fit_gp_batch` from the same
seed (tests/test_gp_sharded.py's trajectory tolerances: winning restart
and step count equal, NMLL rtol 5e-3, log lengthscale atol 0.15, log
amplitude atol 0.3, predicted mean atol 2e-2, variance rtol 0.35) and,
single-restart at 60
fixed Adam steps (RNG-free), against the JAX package's `fit_gp_batch`
within rtol 1e-3, as tests/test_torch_gp.py holds the dense fit. The
routing in `GPR_Matern` is pinned by call counts, the finite probe by a
poisoned fit, and the predictors' use of the fit's whitening factor
(adopted by matmul, released by Nyström, dropped by a rank-k update).
Two-rank runs of the same stages are in tests/test_torch_mesh.py.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

# one intra-op thread: the test workers share the machine, and torch's
# default of one thread per core oversubscribes it
torch.set_num_threads(1)

from dmosopt_tpu.models import gp as JGP
from dmosopt_tpu_torch import moasmo
from dmosopt_tpu_torch.models import gp, gp_sharded
from dmosopt_tpu_torch.models.gp import GPR_Matern, gp_predict
from dmosopt_tpu_torch.models.predictor import build_whitened_cache
from dmosopt_tpu_torch.models.refit import SurrogateRefitConfig, SurrogateRefitController
from dmosopt_tpu_torch.parallel.mesh import create_mesh
from dmosopt_tpu_torch.testing.multihost import local_group


@pytest.fixture(scope="module")
def mesh():
    with local_group():
        yield create_mesh(device="cpu")


def _data(P, dim=5, d=2, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(P, dim)).astype(np.float32)
    Y = np.stack([np.sin(3.0 * X[:, 0]), X.sum(1)], 1)[:, :d]
    Y = ((Y - Y.mean(0)) / Y.std(0)).astype(np.float32)
    return torch.as_tensor(X), torch.as_tensor(Y)


HYPER = (torch.tensor([1.3, 0.8]), torch.tensor([[0.4], [0.7]]), torch.tensor([1e-4, 3e-4]))


def _dense(X, Ym, tm, amp, ls, noise):
    L, a, n = gp.posterior_from_params(X, Ym, tm, amp, ls, noise, "matern52", 1e-4)
    fit = gp.GPFit(X=X, L=L, alpha=a, amp=amp, ls=ls, noise=noise, y_mean=None,
                   y_std=None, nmll=n, train_mask=tm)
    return L, build_whitened_cache(fit), a, n


@pytest.mark.parametrize("n_real,P,tile", [(64, 64, 16), (50, 64, 64), (96, 96, 32)])
def test_posterior_sharded_matches_float64_oracle(mesh, n_real, P, tile):
    X, Y = _data(P)
    tm = torch.as_tensor((np.arange(P) < n_real).astype(np.float32))
    Ym = Y * tm[:, None]
    d64 = [t.double() for t in (X, Ym, tm, *HYPER)]
    oracle = [t.numpy() for t in _dense(*d64)]
    got64 = gp_sharded.posterior_sharded(*d64, rel_jitter=1e-4, mesh=mesh, tile=tile)
    for g, o in zip(got64, oracle):
        np.testing.assert_allclose(g.numpy(), o, rtol=1e-9, atol=1e-9)
    got = [t.numpy() for t in gp_sharded.posterior_sharded(
        X, Ym, tm, *HYPER, rel_jitter=1e-4, mesh=mesh, tile=tile)]
    dense32 = [t.numpy() for t in _dense(X, Ym, tm, *HYPER)]
    for ours in (got, dense32):
        L, W, a, n = ours
        np.testing.assert_allclose(L, oracle[0], atol=2e-5)
        np.testing.assert_allclose(W, oracle[1], atol=2e-4 * np.abs(oracle[1]).max())
        np.testing.assert_allclose(a, oracle[2], atol=2e-4 * np.abs(oracle[2]).max())
        np.testing.assert_allclose(n, oracle[3], rtol=1e-4, atol=1e-3)
    # and no further from the oracle than twice the dense float32 path
    for g, d, o in zip(got, dense32, oracle):
        assert np.abs(g - o).max() <= 2.0 * np.abs(d - o).max() + 1e-6 * np.abs(o).max()


def test_nmll_backward_matches_autograd_float64(mesh):
    P = 48
    X, Y = (t.double() for t in _data(P, d=1, seed=3))
    for n_real in (P, 40):
        tm = torch.as_tensor((np.arange(P) < n_real).astype(np.float64))
        y = Y[:, 0] * tm

        def dense(a, l, nz):
            K = gp._apply_train_mask(
                gp._regularized_kernel(X, l, a, nz, gp._KERNELS["matern52"], 1e-4), tm)
            Lc = torch.linalg.cholesky(K)
            al = gp._cho_solve(Lc, y[:, None])[:, 0]
            return (0.5 * torch.dot(y, al) + torch.log(torch.diagonal(Lc)).sum()
                    + 0.5 * tm.sum() * gp._LOG2PI)

        def leaves():
            return [torch.tensor(1.3, dtype=torch.float64, requires_grad=True),
                    torch.tensor([0.45], dtype=torch.float64, requires_grad=True),
                    torch.tensor(2e-4, dtype=torch.float64, requires_grad=True)]

        ref_args, sh_args = leaves(), leaves()
        v0 = dense(*ref_args)
        g0 = torch.autograd.grad(v0, ref_args)
        v1 = gp_sharded.nmll_sharded(*sh_args, X, tm, y, mesh=mesh, tile=16, rel_jitter=1e-4)
        g1 = torch.autograd.grad(v1, sh_args)
        np.testing.assert_allclose(v1.item(), v0.item(), rtol=1e-12)
        for a, b in zip(g1, g0):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-7)


def test_fit_gp_sharded_matches_fit_gp_batch(mesh):
    dim, n_real = 5, 50
    rng = np.random.default_rng(7 + n_real)
    Xr = rng.uniform(size=(n_real, dim))
    Yr = np.stack([np.sin(3.0 * Xr[:, 0]), Xr.sum(1)], 1)
    Yr = (Yr - Yr.mean(0)) / Yr.std(0)
    X, Y, tm = (torch.as_tensor(a) for a in gp._pad_to_bucket(
        Xr.astype(np.float32), Yr.astype(np.float32)))
    common = dict(n_starts=2, n_iter=60, train_mask=tm)
    ref = gp.fit_gp_batch(torch.Generator().manual_seed(2), X, Y, **common)
    sh = gp_sharded.fit_gp_sharded(torch.Generator().manual_seed(2), X, Y, mesh=mesh,
                                   tile=16, **common)
    np.testing.assert_array_equal(sh.best_start.numpy(), ref.best_start.numpy())
    assert sh.n_steps == ref.n_steps
    np.testing.assert_allclose(sh.nmll.numpy(), ref.nmll.numpy(), rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(np.log(sh.ls.numpy()), np.log(ref.ls.numpy()), atol=0.15)
    np.testing.assert_allclose(np.log(sh.amp.numpy()), np.log(ref.amp.numpy()), atol=0.3)
    Xq = torch.as_tensor(rng.uniform(size=(32, dim)).astype(np.float32))
    (m1, v1), (m0, v0) = gp_predict(sh, Xq), gp_predict(ref, Xq)
    np.testing.assert_allclose(m1.numpy(), m0.numpy(), atol=2e-2)
    np.testing.assert_allclose(v1.numpy(), v0.numpy(), rtol=0.35, atol=1e-4)
    # the fit carries W = L⁻¹ of its own factor
    np.testing.assert_allclose(sh.whitened.numpy(), build_whitened_cache(sh).numpy(),
                               atol=1e-4 * float(sh.whitened.abs().max()))


def test_fit_gp_sharded_gathers_whitened_only_when_asked(mesh):
    X, Y = _data(64)
    common = dict(n_starts=2, n_iter=4, mesh=mesh, tile=16)
    full = gp_sharded.fit_gp_sharded(torch.Generator().manual_seed(4), X, Y, **common)
    bare = gp_sharded.fit_gp_sharded(torch.Generator().manual_seed(4), X, Y,
                                     gather_whitened=False, **common)
    assert full.whitened is not None and full.whitened.shape == full.L.shape
    assert bare.whitened is None
    for f in ("L", "alpha", "nmll", "amp", "ls", "noise"):
        assert torch.equal(getattr(bare, f), getattr(full, f)), f


def _rough(N=30, n=3, seed=0):
    """tests/test_torch_gp.py's data: a target rough enough that amplitude
    and lengthscale are well determined (a smooth one leaves a flat
    amp-ls valley that float32 Adam trajectories drift along)."""
    rng = np.random.default_rng(seed)
    X = rng.random((N, n)).astype(np.float32)
    Y = np.stack([np.sin(6 * X[:, 0]) + np.cos(5 * X[:, 1]) * X[:, 2],
                  np.cos(7 * X[:, 2]) - np.sin(4 * X[:, 0])], axis=1)
    return gp._pad_to_bucket(X, ((Y - Y.mean(0)) / Y.std(0)).astype(np.float32))


@pytest.fixture(scope="module")
def jax_single_restart():
    X, Y, tm = _rough()
    fit = jax.jit(lambda X, Y, tm: JGP.fit_gp_batch(
        jax.random.PRNGKey(0), X, Y, train_mask=tm, n_starts=1, n_iter=60,
        convergence_tol=None))
    return X, Y, tm, fit(jnp.asarray(X), jnp.asarray(Y), jnp.asarray(tm))


def test_single_restart_sharded_fit_matches_jax(mesh, jax_single_restart):
    X, Y, tm, jfit = jax_single_restart
    sh = gp_sharded.fit_gp_sharded(torch.Generator().manual_seed(0), torch.as_tensor(X),
                                   torch.as_tensor(Y), train_mask=torch.as_tensor(tm),
                                   mesh=mesh, n_starts=1, n_iter=60, convergence_tol=None)
    assert sh.n_steps == int(jfit.n_steps) == 60
    for name in ("amp", "ls", "noise", "nmll"):
        np.testing.assert_allclose(getattr(sh, name).numpy(), np.asarray(getattr(jfit, name)),
                                   rtol=1e-3, err_msg=name)


# ---------------------------------------------------------------- routing


def _count_calls(monkeypatch):
    counts = {"batch": 0, "sharded": 0}
    orig_batch, orig_sharded = gp.fit_gp_batch, gp_sharded.fit_gp_sharded

    def batch(*a, **k):
        counts["batch"] += 1
        return orig_batch(*a, **k)

    def sharded(*a, **k):
        counts["sharded"] += 1
        return orig_sharded(*a, **k)

    monkeypatch.setattr(gp, "fit_gp_batch", batch)
    monkeypatch.setattr(gp_sharded, "fit_gp_sharded", sharded)
    return counts


def _gp_args(seed, n=48, dim=4):
    rng = np.random.default_rng(seed)
    xin = rng.uniform(size=(n, dim))
    yin = np.stack([np.sin(2 * xin[:, 0]), xin.sum(1)], 1)
    return (xin, yin, dim, 2, np.zeros(dim), np.ones(dim))


FAST = dict(seed=0, n_starts=2, n_iter=10, device="cpu")


def test_routing_counts_pin_single_device_default(mesh, monkeypatch):
    args = _gp_args(0)
    counts = _count_calls(monkeypatch)
    GPR_Matern(*args, mesh=mesh, **FAST)
    assert counts == {"batch": 1, "sharded": 0}
    counts = _count_calls(monkeypatch)
    GPR_Matern(*args, mesh=mesh, surrogate_mesh={"min_points": 10_000}, **FAST)
    assert counts == {"batch": 1, "sharded": 0}
    counts = _count_calls(monkeypatch)
    GPR_Matern(*args, surrogate_mesh={"min_points": 0}, **FAST)
    assert counts == {"batch": 1, "sharded": 0}
    counts = _count_calls(monkeypatch)
    sm = GPR_Matern(*args, mesh=mesh, surrogate_mesh={"min_points": 0, "tile": 16}, **FAST)
    assert counts == {"batch": 0, "sharded": 1}
    assert sm.fit_info["sharded"] is True and sm.fit_info["shard_devices"] == 1
    assert sm.fit.whitened is None  # the solve predictor never reads it
    counts = _count_calls(monkeypatch)
    sm = GPR_Matern(*args, mesh=mesh, predictor="matmul",
                    surrogate_mesh={"min_points": 0, "tile": 16}, **FAST)
    assert counts == {"batch": 0, "sharded": 1} and sm.fit.whitened is not None
    # a tile that does not divide the bucket gives way to the default
    counts = _count_calls(monkeypatch)
    sm = GPR_Matern(*args, mesh=mesh, surrogate_mesh={"min_points": 0, "tile": 100}, **FAST)
    assert counts == {"batch": 0, "sharded": 1}
    assert sm.fit_info["shard_tile"] == gp_sharded.default_chol_tile(sm.fit.X.shape[0])


def test_routing_falls_back_on_nonfinite_probe(mesh, monkeypatch):
    import dataclasses

    from dmosopt_tpu_torch.telemetry import Telemetry

    orig = gp_sharded.fit_gp_sharded
    counts = _count_calls(monkeypatch)

    def poisoned(*a, **k):
        counts["sharded"] += 1
        fit = orig(*a, **k)
        return dataclasses.replace(fit, nmll=torch.full_like(fit.nmll, torch.inf))

    monkeypatch.setattr(gp_sharded, "fit_gp_sharded", poisoned)
    tel = Telemetry()
    gp_sharded.set_gp_shard_telemetry(tel)
    try:
        sm = GPR_Matern(*_gp_args(1), mesh=mesh,
                        surrogate_mesh={"min_points": 0, "tile": 16}, **FAST)
    finally:
        gp_sharded.set_gp_shard_telemetry(None)
    assert counts == {"batch": 1, "sharded": 1}  # fell back, counted
    assert "sharded" not in sm.fit_info
    assert bool(torch.isfinite(sm.fit.nmll).all())
    snap = tel.registry.snapshot()["counters"]
    assert snap["gp_shard_fits_total"] == {"": 1.0}
    assert snap["gp_shard_fallbacks_total"] == {"": 1.0}


def test_surrogate_mesh_spec_validation_and_default_tile():
    assert gp._resolve_surrogate_mesh_spec(None) is None
    assert gp._resolve_surrogate_mesh_spec(False) is None
    assert gp._resolve_surrogate_mesh_spec(True) == {"min_points": 4096, "tile": None,
                                                     "axis": None}
    spec = gp._resolve_surrogate_mesh_spec({"min_points": 16, "tile": 32})
    assert spec["min_points"] == 16 and spec["tile"] == 32
    with pytest.raises(ValueError):
        gp._resolve_surrogate_mesh_spec({"bogus_knob": 1})
    with pytest.raises(TypeError):
        gp._resolve_surrogate_mesh_spec("yes")
    for P in (64, 96, 128, 320, 512, 768, 4096, 32768):
        B = gp_sharded.default_chol_tile(P)
        assert P % B == 0 and B <= 512


# -------------------------------------------------- predictor composition


def test_predictors_adopt_and_release_the_fit_whitened(mesh):
    args = _gp_args(4, n=56)
    kw = dict(mesh=mesh, surrogate_mesh={"min_points": 0, "tile": 16}, seed=0,
              n_starts=2, n_iter=20, device="cpu")
    sm = GPR_Matern(*args, predictor="matmul", **kw)
    pred = sm.build_predictor()
    assert pred.regime == "matmul" and pred.whitened is sm.fit.whitened  # adopted
    Xq = torch.as_tensor(np.random.default_rng(4).uniform(size=(16, 4)).astype(np.float32))
    mu, var = pred.predict_normalized(Xq)
    mu0, var0 = gp_predict(sm.fit, Xq)
    np.testing.assert_allclose(mu.numpy(), mu0.numpy(), atol=1e-3)
    np.testing.assert_allclose(var.numpy(), var0.numpy(), rtol=2e-2, atol=1e-5)
    sm = GPR_Matern(*args, predictor="nystrom", **kw)
    assert sm.fit.whitened is not None  # held for the probe's fall-back
    pred = sm.build_predictor()
    if pred.regime == "nystrom":
        assert sm.fit.whitened is None
    else:
        assert pred.whitened is not None


def test_rank_update_drops_stale_whitened():
    import dataclasses

    rng = np.random.default_rng(2)
    dim = 4
    X = rng.uniform(size=(80, dim))
    Y = np.column_stack([X.sum(1), ((X - 0.5) ** 2).sum(1)])
    ctrl = SurrogateRefitController(SurrogateRefitConfig("warm", rank_update_after=0))

    def train(n):
        return moasmo.train(dim, 2, np.zeros(dim), np.ones(dim), X[:n], Y[:n], None,
                            surrogate_method_kwargs={"n_starts": 2, "n_iter": 40, "seed": 0},
                            surrogate_refit=ctrl, device="cpu")

    sm = train(56)
    # a sharded fit's factor riding the cached posterior
    sm.fit = dataclasses.replace(sm.fit, whitened=build_whitened_cache(sm.fit))
    sm2 = train(60)  # an append inside the bucket: the rank path
    assert ctrl.path_history[-1] == "rank" and sm2.fit_info.get("refit_path") == "rank"
    assert sm2.fit.whitened is None
