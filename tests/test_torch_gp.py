"""The port's exact-GP surrogate against the JAX package.

Same seeded numpy data into both. The NMLL and its gradient are the
same float32 algebra with a different Cholesky and reduction order
(rtol 1e-4 on values; on gradients rtol 1e-3, plus an absolute 1e-3 of
the largest component for the small components that cancellation
leaves). A single-restart fit is
RNG-free (restart 0 is the deterministic init) and runs a fixed number
of Adam steps here, so the two fits must land on the same
hyperparameters within rtol 1e-3 after 60 float32 steps (further on,
the float32 trajectories drift apart along the flat amplitude valley of
the NMLL while its value still agrees). Predictions
from a fit carried over through `interop` are one kernel matrix and one
triangular solve apart (rtol 1e-4).

A warm-started single-restart fit starts exactly at the warm values in
both packages and lands on the same hyperparameters (rtol 1e-3 after 60
steps), as do single-restart fits of `GPR_RBF`, `EGP_Matern` (ARD, the
reference's ``adam_lr``) and `MEGP_Matern` (one shared ARD kernel,
`fit_gp_shared`). A float64 fit (``dtype="float64"``, no relative
jitter) predicts and reports its NMLL as a float64 numpy solve at its
own hyperparameters does (rtol 1e-6). Both packages take an
``optimizer`` kwarg and ignore it (every fit runs Adam).
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
from dmosopt_tpu_torch import interop
from dmosopt_tpu_torch.models import gp as TGP


def _data(N=24, n=3, d=2, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.random((N, n)).astype(np.float32)
    # rough enough that amplitude and lengthscale are well determined
    # (a smooth target leaves a flat amp-ls valley that float32 Adam
    # trajectories drift along)
    Y = np.stack(
        [np.sin(6 * X[:, 0]) + np.cos(5 * X[:, 1]) * X[:, 2],
         np.cos(7 * X[:, 2]) - np.sin(4 * X[:, 0])],
        axis=1,
    )[:, :d]
    Y = ((Y - Y.mean(0)) / Y.std(0)).astype(np.float32)
    return X, Y


def _bounds(mod, lib, dt):
    t = (lambda v: jnp.asarray(v, dt)) if lib == "jax" else (
        lambda v: torch.tensor(v, dtype=torch.float32))
    return (
        mod._Bounds(t(1e-4), t(1e3)),
        mod._Bounds(t(1e-3), t(100.0)),
        mod._Bounds(t(1e-9), t(1e-2)),
    )


@jax.jit
@jax.value_and_grad
def _jax_nmll_value_and_grad(p, X, y, tm):
    """The JAX package's NMLL and its gradient, compiled once per shape
    (op-by-op dispatch compiles every primitive on first use)."""
    return JGP._nmll(p, _bounds(JGP, "jax", jnp.float32), X, y, JGP.matern52,
                     1e-4, tm)


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize(
    "u", [(0.0, [0.3], -2.0), (1.5, [-0.7], 0.5), (-1.0, [1.2, -0.4, 0.1], -3.0)]
)
def test_nmll_value_and_gradient_match_jax(u, padded):
    X, Y = _data(N=20)
    tm = None
    if padded:
        X, Y, tm = TGP._pad_to_bucket(X, Y, cap=32)
        Y = Y * tm[:, None]
    u_amp, u_ls, u_noise = u
    y = Y[:, 0]
    jparams = JGP.GPParams(
        jnp.float32(u_amp), jnp.asarray(u_ls, jnp.float32), jnp.float32(u_noise)
    )
    want, want_g = _jax_nmll_value_and_grad(
        jparams, jnp.asarray(X), jnp.asarray(y), None if tm is None else jnp.asarray(tm)
    )

    leaves = [torch.tensor([u_amp]), torch.tensor([u_ls]), torch.tensor([u_noise])]
    for t in leaves:
        t.requires_grad_(True)
    got = TGP._nmll(
        TGP.GPParams(*leaves), _bounds(TGP, "torch", None), torch.as_tensor(X),
        torch.as_tensor(Y[:, :1]), TGP.matern52, 1e-4,
        None if tm is None else torch.as_tensor(tm),
    )
    got.sum().backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-4)
    # a gradient component much smaller than the largest one is the
    # float32 difference of terms of that size: absolute slack 1e-3 of it
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want_g)
    for g, w in zip(leaves, want_g):
        np.testing.assert_allclose(
            g.grad.numpy().reshape(-1), np.asarray(w).reshape(-1),
            rtol=1e-3, atol=1e-3 * scale,
        )


def test_nmll_marks_failed_cholesky_non_finite():
    """A cell whose kernel matrix is not positive definite gets a
    non-finite loss (the reference's NaN Cholesky), its neighbours not."""
    X, Y = _data(N=16)
    # cell 0: amplitude ~1e3 and lengthscale ~100 make K nearly rank one;
    # float32 rounding (~1e-3 here) swamps the 1e-6 jitter
    u_amp = torch.tensor([[10.0, 0.0]])
    u_ls = torch.tensor([[[5.0], [0.0]]])
    u_noise = torch.tensor([[-30.0, 0.0]])
    vals = TGP._nmll(
        TGP.GPParams(u_amp, u_ls, u_noise), _bounds(TGP, "torch", None),
        torch.as_tensor(X), torch.as_tensor(Y), TGP.matern52, 0.0,
    )
    assert vals.shape == (1, 2)
    assert not bool(torch.isfinite(vals[0, 0]))
    assert bool(torch.isfinite(vals[0, 1]))


def _fit_both(X, Y, tm, **kw):
    jfit = JGP.fit_gp_batch(
        jax.random.PRNGKey(0), jnp.asarray(X), jnp.asarray(Y),
        train_mask=None if tm is None else jnp.asarray(tm), **kw,
    )
    tfit = TGP.fit_gp_batch(
        torch.Generator().manual_seed(0), torch.as_tensor(X), torch.as_tensor(Y),
        train_mask=None if tm is None else torch.as_tensor(tm), **kw,
    )
    return jfit, tfit


def test_single_restart_fit_matches_jax():
    X, Y = _data(N=30)
    X, Y, tm = TGP._pad_to_bucket(X, Y)
    jfit, tfit = _fit_both(
        X, Y, tm, n_starts=1, n_iter=60, convergence_tol=None,
    )
    assert tfit.n_steps == int(jfit.n_steps) == 60
    for name in ("amp", "ls", "noise", "nmll"):
        np.testing.assert_allclose(
            getattr(tfit, name).numpy(), np.asarray(getattr(jfit, name)),
            rtol=1e-3, err_msg=name,
        )


def _schedule(n_iter, plateau):
    """best_vals (S=2, d=2) after k steps: improving by 10% of the value per
    step until ``plateau``, flat after it; inf before the first step."""
    k = np.minimum(np.arange(n_iter + 1), plateau).astype(np.float32)
    v = 5.0 + 100.0 * 0.9 ** k
    table = np.stack([v, v + 1.0], axis=-1)[:, None, :].repeat(2, axis=1)
    table[0] = np.inf
    return table.astype(np.float32)


@pytest.mark.parametrize(
    "n_iter,every,tol", [(95, 10, 1e-3), (100, 10, 1e-3), (7, 10, 1e-3), (95, 10, None)]
)
# plateaus that stop the loop early (3, 36), after every full chunk
# without the remainder (75: 90 of 95 steps) and with it (85, 500)
@pytest.mark.parametrize("plateau", [3, 36, 75, 85, 500])
def test_scan_with_convergence_steps_equal_jax(n_iter, every, tol, plateau):
    """The same scripted sequence of best values stops both loops after
    the same number of steps, remainder included."""
    table = _schedule(n_iter, plateau)
    jt = jnp.asarray(table)

    def jstep(carry, _):
        k, o, bp, _bv = carry
        return (k + 1, o, bp, jt[k + 1]), None

    _, want = JGP._scan_with_convergence(
        jstep, (jnp.int32(0), 0.0, 0.0, jt[0]), n_iter, tol, every,
        lambda v: jnp.min(v, axis=0), jnp.float32,
    )
    state = {"k": 0}

    def step():
        state["k"] += 1

    got = TGP._scan_with_convergence(
        step, n_iter, tol, every, lambda v: torch.amin(v, dim=0),
        lambda: torch.as_tensor(table[state["k"]]),
    )
    assert got == int(want) == state["k"]


def test_convergence_stop_counts_whole_chunks():
    """With the default convergence stop, the step count is a whole number
    of chunks (or n_iter), as in the reference's scan."""
    X, Y = _data(N=30)
    fit = TGP.fit_gp_batch(
        torch.Generator().manual_seed(1), torch.as_tensor(X), torch.as_tensor(Y),
        n_starts=4, n_iter=95,
    )
    assert fit.n_steps == 95 or fit.n_steps % 10 == 0
    assert fit.L.shape == (2, 30, 30) and bool(torch.isfinite(fit.nmll).all())


def test_gp_predict_on_a_carried_over_jax_fit():
    X, Y = _data(N=40, n=3)
    Xp, Yp, tm = TGP._pad_to_bucket(X, Y)
    jfit = JGP.fit_gp_batch(
        jax.random.PRNGKey(3), jnp.asarray(Xp), jnp.asarray(Yp),
        train_mask=jnp.asarray(tm), n_starts=2, n_iter=40,
    )
    jfit = jfit._replace(y_mean=jnp.asarray([0.5, -1.0]), y_std=jnp.asarray([2.0, 0.5]))
    tfit = interop.gp_fit_from_arrays(
        {k: (None if v is None else np.asarray(v)) for k, v in jfit._asdict().items()},
        "cpu",
    )
    Xq = np.random.default_rng(5).random((17, 3)).astype(np.float32)
    want_m, want_v = JGP.gp_predict(jfit, jnp.asarray(Xq))
    got_m, got_v = TGP.gp_predict(tfit, torch.as_tensor(Xq))
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=1e-4, atol=1e-6)


def test_padded_fit_equals_unpadded_fit():
    X, Y = _data(N=40)
    Xp, Yp, tm = TGP._pad_to_bucket(X, Y)
    assert Xp.shape[0] == 64
    kw = dict(n_starts=2, n_iter=60, convergence_tol=None)
    plain = TGP.fit_gp_batch(torch.Generator().manual_seed(2),
                             torch.as_tensor(X), torch.as_tensor(Y), **kw)
    padded = TGP.fit_gp_batch(torch.Generator().manual_seed(2),
                              torch.as_tensor(Xp), torch.as_tensor(Yp),
                              train_mask=torch.as_tensor(tm), **kw)
    for name in ("amp", "ls", "noise", "nmll"):
        np.testing.assert_allclose(
            getattr(padded, name).numpy(), getattr(plain, name).numpy(),
            rtol=1e-3, err_msg=name,
        )
    Xq = torch.rand(9, 3, generator=torch.Generator().manual_seed(0))
    for a, b in zip(TGP.gp_predict(padded, Xq), TGP.gp_predict(plain, Xq)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3, atol=1e-4)


def test_gpr_matern_runs_on_cpu_and_needs_cuda_by_default(monkeypatch):
    X, Y = _data(N=25)
    xlb, xub = np.zeros(3), np.ones(3)
    sm = TGP.GPR_Matern(X, Y, 3, 2, xlb, xub, n_starts=2, n_iter=20,
                        seed=0, device="cpu")
    mean = sm.evaluate(X[:5])
    assert mean.shape == (5, 2) and bool(torch.isfinite(mean).all())
    assert sm.get_stats()["n_iter_max"] == 20
    with pytest.raises(ValueError, match="predictor"):
        TGP.GPR_Matern(X, Y, 3, 2, xlb, xub, predictor="exact", device="cpu")
    # meshes are ported (tests/test_torch_gp_sharded.py); a malformed
    # surrogate_mesh spec is refused before any fit
    with pytest.raises(TypeError, match="surrogate_mesh"):
        TGP.GPR_Matern(X, Y, 3, 2, xlb, xub, surrogate_mesh="yes", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TGP.GPR_Matern(X, Y, 3, 2, xlb, xub, n_starts=1, n_iter=5)


def test_warm_started_fit_matches_jax():
    X, Y = _data(N=30)
    X, Y, tm = TGP._pad_to_bucket(X, Y)
    ws = (np.asarray([2.0, 0.3], np.float32), np.asarray([[0.2], [1.5]], np.float32),
          np.asarray([1e-4, 1e-3], np.float32))
    jfit, tfit = _fit_both(X, Y, tm, n_starts=1, n_iter=60, convergence_tol=None,
                           warm_start=ws)
    cold = TGP.fit_gp_batch(torch.Generator().manual_seed(0), torch.as_tensor(X),
                            torch.as_tensor(Y), train_mask=torch.as_tensor(tm),
                            n_starts=1, n_iter=60, convergence_tol=None)
    assert not np.allclose(tfit.amp.numpy(), cold.amp.numpy(), rtol=1e-2)
    for name in ("amp", "ls", "noise", "nmll"):
        np.testing.assert_allclose(
            getattr(tfit, name).numpy(), np.asarray(getattr(jfit, name)),
            rtol=1e-3, err_msg=name,
        )


def test_warm_start_shape_is_checked():
    X, Y = _data(N=25)
    ws = (np.ones(2), np.ones((2, 3)), np.full(2, 1e-4))  # ARD ls, isotropic fit
    with pytest.raises(ValueError, match="warm_start"):
        TGP.GPR_Matern(X, Y, 3, 2, np.zeros(3), np.ones(3), warm_start=ws, device="cpu")


FAMILY = {
    "rbf": (JGP.GPR_RBF, TGP.GPR_RBF, {"learning_rate": 0.1}),
    "egp": (JGP.EGP_Matern, TGP.EGP_Matern, {"adam_lr": 0.05}),
    "megp": (JGP.MEGP_Matern, TGP.MEGP_Matern, {}),
}


@pytest.mark.parametrize("name", sorted(FAMILY))
def test_exact_gp_family_matches_jax(name):
    jcls, tcls, extra = FAMILY[name]
    X, Y = _data(N=30)
    kw = dict(n_starts=1, n_iter=40, convergence_tol=None, seed=0, **extra)
    jm = jcls(X, Y, 3, 2, np.zeros(3), np.ones(3), **kw)
    tm = tcls(X, Y, 3, 2, np.zeros(3), np.ones(3), device="cpu", **kw)
    assert tm.fit.ls.shape == tuple(jm.fit.ls.shape)
    for field in ("amp", "ls", "noise", "nmll"):
        np.testing.assert_allclose(
            getattr(tm.fit, field).numpy(), np.asarray(getattr(jm.fit, field)),
            rtol=1e-3, err_msg=field,
        )
    Xq = np.random.default_rng(4).random((11, 3))
    for a, b in zip(tm.predict(Xq), jm.predict(Xq)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-3, atol=1e-4)


def test_float64_fit_against_a_numpy_oracle():
    X, Y = _data(N=25)
    sm = TGP.GPR_Matern(X, Y, 3, 2, np.zeros(3), np.ones(3), n_starts=2, n_iter=30,
                        seed=0, dtype="float64", device="cpu")
    assert sm.fit.L.dtype == torch.float64 and sm._rel_jitter == 0.0
    Xq = np.random.default_rng(6).random((9, 3))
    mean, var = sm.predict(Xq)
    assert mean.dtype == torch.float64
    X, Y = X.astype(np.float64), Y.astype(np.float64)
    y_mean, y_std = Y.mean(0), Y.std(0)
    Yn = (Y - y_mean) / y_std
    for i in range(2):
        amp, noise = float(sm.fit.amp[i]), float(sm.fit.noise[i])
        ls = float(sm.fit.ls[i, 0])

        def kern(A, B):
            r = np.sqrt(np.sum((A[:, None, :] - B[None, :, :]) ** 2, -1)) / ls
            return amp * (1 + np.sqrt(5) * r + 5 / 3 * r * r) * np.exp(-np.sqrt(5) * r)

        K = kern(X, X) + (noise + 1e-6) * np.eye(len(X))
        Ks = kern(X, Xq)
        alpha = np.linalg.solve(K, Yn[:, i])
        np.testing.assert_allclose(mean[:, i].numpy(), y_mean[i] + y_std[i] * Ks.T @ alpha,
                                   rtol=1e-6)
        v = amp + noise - np.sum(Ks * np.linalg.solve(K, Ks), 0)
        np.testing.assert_allclose(var[:, i].numpy(), y_std[i] ** 2 * v, rtol=1e-6)
        nmll = (0.5 * Yn[:, i] @ alpha + 0.5 * np.linalg.slogdet(K)[1]
                + 0.5 * len(X) * np.log(2 * np.pi))
        np.testing.assert_allclose(float(sm.fit.nmll[i]), nmll, rtol=1e-6)


def test_optimizer_kwarg_is_taken_and_ignored_as_in_jax():
    """A dmosopt configuration may name the fit's optimizer: the JAX
    `GPR_Matern` takes ``optimizer`` and never reads it, so both packages
    take the same kwargs, run Adam, and land on the same fit."""
    X, Y = _data(N=30)
    kw = dict(optimizer="lbfgs", n_starts=1, n_iter=40, convergence_tol=None, seed=0)
    jm = JGP.GPR_Matern(X, Y, 3, 2, np.zeros(3), np.ones(3), **kw)
    tm = TGP.GPR_Matern(X, Y, 3, 2, np.zeros(3), np.ones(3), device="cpu", **kw)
    adam = TGP.GPR_Matern(X, Y, 3, 2, np.zeros(3), np.ones(3), device="cpu",
                          **dict(kw, optimizer="adam"))
    for field in ("amp", "ls", "noise", "nmll"):
        np.testing.assert_array_equal(getattr(tm.fit, field).numpy(),
                                      getattr(adam.fit, field).numpy())
        np.testing.assert_allclose(
            getattr(tm.fit, field).numpy(), np.asarray(getattr(jm.fit, field)),
            rtol=1e-3, err_msg=field,
        )
