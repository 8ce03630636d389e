"""The port's predictor layer (`models/predictor.py`) against the JAX
package's.

A posterior made by the JAX package (`posterior_from_params` at fixed
hyperparameters, bucket-padded) is carried over with `interop`, and both
packages predict at the same queries in each regime. The oracle is the
exact posterior of the same inputs, targets and hyperparameters in
float64 numpy. The JAX package's own float32 regimes miss it by up to
2.1e-5 of y_std in the mean and 3.7e-6 of the prior variance in the
variance, and its Nyström distillations onto 40-64 rows by 0.49-1.67
y_std (measured in this test's cases), so each of the port's regimes is
held to twice the JAX package's error in the same regime on the same
case, and not to the JAX package's output at a tighter bar.

The Nyström probe decides as the JAX package's does, with the same
`distill_error`; a JAX Nyström cache pushed through
`interop.nystrom_cache_from_arrays` predicts as it does there. The
rank-k extension of the whitening factor equals a fresh inverse, a
rank update's predictor serves the updated posterior (a stale one
would miss by about 0.1 y_std, see `PREDICT_BARS` in chip_smoke.py), and
a clone never serves the previous fit's cache.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

# one intra-op thread: the test workers share the machine, and torch's
# default of one thread per core oversubscribes it
torch.set_num_threads(1)

from dmosopt_tpu.models import gp as JGP
from dmosopt_tpu.models import predictor as JPR
from dmosopt_tpu_torch import interop, moasmo
from dmosopt_tpu_torch.models import gp as TGP
from dmosopt_tpu_torch.models import predictor as TPR
from dmosopt_tpu_torch.models.refit import SurrogateRefitConfig, SurrogateRefitController

# the bars of chip_smoke.py's PREDICT_BARS: a served predictor against a
# solve of the same posterior, mean over y_std and variance over the
# prior variance
BARS = {"mean": 2e-3, "var": 2e-5}


def _pool(n, dim, d, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, dim))
    cols = [np.sum(X**2, 1), np.sum((X - 0.5) ** 2, 1), np.sin(3.0 * X[:, 0]) + X[:, -1]]
    return X, np.column_stack(cols[:d])


def _jax_fit(n, dim, d, seed=0):
    """A bucket-padded JAX posterior at fixed hyperparameters, with
    non-trivial output scaling; returns (fit, Xp, Yp, mask)."""
    X, Y = _pool(n, dim, d, seed)
    Yn = (Y - Y.mean(0)) / Y.std(0)
    Xp, Yp, mask = JGP._pad_to_bucket(X.astype(np.float32), Yn.astype(np.float32))
    amp = jnp.asarray(np.linspace(1.3, 0.7, d), jnp.float32)
    ls = jnp.asarray(np.linspace(0.4, 0.8, d)[:, None], jnp.float32)
    noise = jnp.asarray(np.full(d, 1e-5), jnp.float32)
    L, alpha, nmll = JGP.posterior_from_params(
        jnp.asarray(Xp), jnp.asarray(Yp), jnp.asarray(mask), amp, ls, noise,
        kernel="matern52", rel_jitter=1e-4,
    )
    fit = JGP.GPFit(
        X=jnp.asarray(Xp), L=L, alpha=alpha, amp=amp, ls=ls, noise=noise,
        y_mean=jnp.asarray(np.linspace(-0.5, 0.5, d), jnp.float32),
        y_std=jnp.asarray(np.linspace(1.0, 2.0, d), jnp.float32),
        nmll=nmll, train_mask=jnp.asarray(mask),
    )
    return fit, Xp, Yp, mask


def _carry(fit):
    return interop.gp_fit_from_arrays(
        {k: (None if v is None else np.asarray(v)) for k, v in fit._asdict().items()},
        "cpu",
    )


def _oracle(fit, Yp, mask, Xq):
    """The exact posterior in float64 numpy: the masked, regularized
    Matérn-5/2 kernel of the fit's inputs and hyperparameters (jitter
    1e-6 + 1e-4 amp), mean and variance in output units."""
    X = np.asarray(fit.X, np.float64)
    Xq = np.asarray(Xq, np.float64)
    m = np.asarray(mask, np.float64)
    amp, ls, noise = (np.asarray(a, np.float64) for a in (fit.amp, fit.ls, fit.noise))
    y_mean, y_std = (np.asarray(a, np.float64) for a in (fit.y_mean, fit.y_std))

    def kern(A, B, i):
        A, B = A / ls[i], B / ls[i]
        sq = np.sum(A * A, 1)[:, None] + np.sum(B * B, 1)[None, :] - 2.0 * A @ B.T
        r = np.sqrt(np.maximum(sq, 0.0) + 1e-30)
        return amp[i] * (1.0 + np.sqrt(5.0) * r + 5.0 / 3.0 * r * r) * np.exp(-np.sqrt(5.0) * r)

    means, vars_ = [], []
    for i in range(len(amp)):
        K = kern(X, X, i)
        K = 0.5 * (K + K.T) + (noise[i] + 1e-6 + 1e-4 * amp[i]) * np.eye(len(X))
        K = np.outer(m, m) * K + np.diag(1.0 - m)
        Ks = kern(X, Xq, i) * m[:, None]
        mean = Ks.T @ np.linalg.solve(K, np.asarray(Yp[:, i], np.float64) * m)
        var = np.maximum(amp[i] + noise[i] - np.sum(Ks * np.linalg.solve(K, Ks), 0), 1e-12)
        means.append(y_mean[i] + y_std[i] * mean)
        vars_.append(y_std[i] ** 2 * var)
    return np.stack(means, 1), np.stack(vars_, 1)


def _errors(pred, oracle, fit):
    """(mean error / y_std, variance error / prior variance), maxima."""
    y_std = np.asarray(fit.y_std, np.float64)
    prior = (np.asarray(fit.amp, np.float64) + np.asarray(fit.noise, np.float64)) * y_std**2
    m, v = (np.asarray(a, np.float64) for a in pred)
    return (float(np.max(np.abs(m - oracle[0]) / y_std)),
            float(np.max(np.abs(v - oracle[1]) / prior)))


def _z_idx(n, m):
    return np.round(np.linspace(0, n - 1, m)).astype(np.int64)


# (n, dim, d): a padded bucket (90 of 128 rows), one objective, three
# objectives, with m Nyström rows
SHAPES = [(90, 5, 2, 60), (70, 3, 1, 40), (100, 5, 3, 64)]


@pytest.fixture(scope="module")
def cases():
    """Per shape: the JAX fit, its padded data, queries (37 random and 20
    training rows), the oracle and the JAX package's three regimes."""
    out = {}
    for n, dim, d, m in SHAPES:
        fit, Xp, Yp, mask = _jax_fit(n, dim, d)
        rng = np.random.default_rng(3)
        Xq = np.concatenate([rng.uniform(size=(37, dim)).astype(np.float32), Xp[:20]])
        W = JPR.build_whitened_cache(fit)
        nc = JPR.build_nystrom_cache(fit, jnp.asarray(_z_idx(n, m), jnp.int32),
                                     kernel="matern52", rel_jitter=1e-4)
        jq = jnp.asarray(Xq)
        out[(n, dim, d)] = dict(
            fit=fit, Xq=Xq, m=m, nc=nc,
            oracle=_oracle(fit, Yp, mask, Xq),
            jax={"solve": JGP.gp_predict(fit, jq),
                 "matmul": JPR.gp_predict_matmul(fit, W, jq),
                 "nystrom": JPR.gp_predict_nystrom(nc, jq)},
        )
    return out


@pytest.mark.parametrize("shape", [s[:3] for s in SHAPES])
def test_regimes_against_the_float64_oracle(cases, shape):
    """Measured (mean/y_std, var/prior), JAX then port: (90, 5, 2) solve
    1.33e-5/3.17e-6 and 1.69e-5/2.80e-6, matmul 1.33e-5/3.17e-6 and
    1.69e-5/3.17e-6, nystrom (m 60) 1.149/0.621 for both; (70, 3, 1)
    solve 1.14e-5/3.73e-6 and 1.00e-5/3.52e-6, matmul 1.16e-5/3.43e-6
    and 1.00e-5/3.61e-6; (100, 5, 3) solve 1.93e-5/3.17e-6 and
    2.15e-5/2.80e-6."""
    c = cases[shape]
    n, _, _ = shape
    tfit = _carry(c["fit"])
    Xq = torch.as_tensor(c["Xq"])
    z_idx = torch.as_tensor(_z_idx(n, c["m"]))
    port = {
        "solve": TGP.gp_predict(tfit, Xq),
        "matmul": TPR.gp_predict_matmul(tfit, TPR.build_whitened_cache(tfit), Xq),
        "nystrom": TPR.gp_predict_nystrom(
            TPR.build_nystrom_cache(tfit, z_idx, "matern52", 1e-4), Xq),
    }
    for regime, pred in port.items():
        got = _errors(pred, c["oracle"], c["fit"])
        want = _errors(c["jax"][regime], c["oracle"], c["fit"])
        # an absolute floor of one float32 ulp of the unit scale
        assert got[0] <= 2.0 * want[0] + 1.2e-7, (regime, got, want)
        assert got[1] <= 2.0 * want[1] + 1.2e-7, (regime, got, want)


@pytest.mark.parametrize("shape", [s[:3] for s in SHAPES])
def test_nystrom_cache_is_built_as_jax_builds_it(cases, shape):
    """The port's distillation of the carried-over fit onto the same
    inducing rows against the JAX package's: measured, the fields differ
    by at most 3.9e-5 of their largest entry (Wzz 3.8e-5, w 2.0e-5, B
    3.9e-5) and the predictions by at most 4.7e-5 absolute."""
    c = cases[shape]
    n, _, _ = shape
    got = TPR.build_nystrom_cache(_carry(c["fit"]), torch.as_tensor(_z_idx(n, c["m"])),
                                  "matern52", 1e-4)
    for field in ("Z", "Wzz", "w", "B"):
        want = np.asarray(getattr(c["nc"], field))
        np.testing.assert_allclose(getattr(got, field).numpy(), want, rtol=1e-3,
                                   atol=2e-4 * np.max(np.abs(want)), err_msg=field)
    pred = TPR.gp_predict_nystrom(got, torch.as_tensor(c["Xq"]))
    for g, w in zip(pred, c["jax"]["nystrom"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3, atol=1e-4)


def test_a_jax_nystrom_cache_predicts_alike_in_the_port(cases):
    c = cases[(90, 5, 2)]
    cache = interop.nystrom_cache_from_arrays(
        {k: np.asarray(v) for k, v in c["nc"]._asdict().items()}, "cpu")
    got = TPR.gp_predict_nystrom(cache, torch.as_tensor(c["Xq"]))
    for g, w in zip(got, c["jax"]["nystrom"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize(
    "opts", [dict(nystrom_points=4096), dict(nystrom_points=12, nystrom_mean_tol=1e-4,
                                             nystrom_var_ratio_tol=1.01)],
    ids=["passes", "falls-back"],
)
def test_probe_gate_decides_as_jax(cases, opts):
    """The same carried-over fit: the same served regime, gate decision,
    inducing and probe counts, and the probe's errors within 1e-3
    relative or 1e-4 absolute (measured on the fall-back: mean_err
    3.33728 in both, var_ratio 987.262 in both)."""
    c = cases[(90, 5, 2)]
    jp = JPR.GPPredictor(c["fit"], "matern52", "nystrom", rel_jitter=1e-4, **opts)
    tp = TPR.GPPredictor(_carry(c["fit"]), "matern52", "nystrom", rel_jitter=1e-4, **opts)
    assert tp.regime == jp.regime
    je, te = jp.distill_error, tp.distill_error
    assert te["ok"] == je["ok"] and te["m"] == je["m"]
    assert te["probe_points"] == je["probe_points"]
    for key in ("mean_err", "var_ratio"):
        np.testing.assert_allclose(te[key], je[key], rtol=1e-3, atol=1e-4, err_msg=key)
    if tp.regime == "matmul":
        assert tp.nystrom is None and tp.whitened is not None
    else:
        assert tp.nystrom is not None and tp.whitened is None


def test_extend_whitened_rank_k_equals_a_fresh_inverse():
    dim, n0, k = 4, 70, 20
    fit, Xp, Yp, mask = _jax_fit(n0, dim, 2, seed=8)
    tfit = _carry(fit)
    X, Y = _pool(n0 + k, dim, 2, seed=9)
    P = Xp.shape[0]
    X_pad = Xp.copy()
    X_pad[n0:n0 + k] = X[n0:].astype(np.float32)
    mask2 = (np.arange(P) < n0 + k).astype(np.float32)
    Yn_pad = np.zeros((P, 2), np.float32)
    Yn_pad[:n0] = Yp[:n0]
    Yn_pad[n0:n0 + k] = ((Y[n0:] - Y.mean(0)) / Y.std(0)).astype(np.float32)
    L_new, _, _ = TGP.extend_cholesky_rank_k(
        tfit.L, torch.as_tensor(X_pad), torch.as_tensor(mask2), torch.as_tensor(Yn_pad),
        tfit.amp, tfit.ls, tfit.noise, kernel="matern52", n_old=n0, n_new=n0 + k,
        rel_jitter=1e-4,
    )
    W_up = TPR.extend_whitened_rank_k(TPR.build_whitened_cache(tfit), L_new, n0, n0 + k)
    W_fresh = torch.linalg.solve_triangular(L_new, torch.eye(P), upper=False)
    np.testing.assert_allclose(W_up.numpy(), W_fresh.numpy(), rtol=2e-3, atol=2e-4)


def _errors_to_solve(sm, Xq):
    fresh = TGP.gp_predict(sm.fit, Xq, kernel=sm.kernel)
    pred = sm.predict_normalized(Xq)
    y_std = sm.fit.y_std.double()
    prior = (sm.fit.amp.double() + sm.fit.noise.double()) * y_std**2
    return (float(((pred[0] - fresh[0]).double().abs() / y_std).max()),
            float(((pred[1] - fresh[1]).double().abs() / prior).max()))


def test_a_rank_update_serves_the_updated_posterior():
    """A built matmul cache is extended through a rank update (measured
    against a fresh solve of the updated fit: mean 0, variance 2e-6 of
    the prior); a bucket-crossing update leaves the clone to rebuild."""
    dim = 5
    X, Y = _pool(140, dim, 2, seed=6)
    ctrl = SurrogateRefitController(
        SurrogateRefitConfig("warm", rank_update_after=0, audit_every=50))
    Xq = torch.as_tensor(np.random.default_rng(9).uniform(size=(30, dim)), dtype=torch.float32)
    models = []
    for n in (100, 120, 130):
        sm = moasmo.train(
            dim, 2, np.zeros(dim), np.ones(dim), X[:n], Y[:n], None,
            surrogate_method_kwargs={"n_starts": 2, "n_iter": 40, "seed": 0,
                                     "predictor": "matmul"},
            surrogate_refit=ctrl, device="cpu",
        )
        models.append(sm)
        errs = _errors_to_solve(sm, Xq)
        assert errs[0] <= BARS["mean"] and errs[1] <= BARS["var"], (n, errs)
    assert ctrl.path_history == ["cold", "rank", "rank_refactor"]
    p1 = models[1]._predictor_obj
    assert p1 is not models[0]._predictor_obj and p1.fit is models[1].fit
    W_fresh = TPR.build_whitened_cache(models[1].fit)
    np.testing.assert_allclose(p1.whitened.numpy(), W_fresh.numpy(), rtol=2e-3, atol=2e-4)
    # the bucket crossing rebuilt its cache for the new (192-row) factor
    assert models[2]._predictor_obj.whitened.shape == (2, 192, 192)


def test_a_clone_never_serves_a_stale_cache():
    dim = 4
    X, Y = _pool(80, dim, 2)
    sm = TGP.GPR_Matern(X, Y, dim, 2, np.zeros(dim), np.ones(dim), n_starts=2,
                        n_iter=30, seed=0, predictor="matmul", device="cpu")
    sm.build_predictor()
    clone = TGP.clone_with_fit(sm, sm.fit, dict(sm.fit_info))
    assert clone._predictor_obj is None
    assert clone._predictor_spec == sm._predictor_spec
    assert clone.device == sm.device and clone.kernel == sm.kernel
    mean, _ = clone.predict(X[:5])
    np.testing.assert_allclose(mean.numpy(), sm.predict(X[:5])[0].numpy(), rtol=1e-6)
    assert clone._predictor_obj is not sm._predictor_obj
