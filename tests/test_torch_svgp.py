"""The port's sparse variational GP family (`models/svgp.py`) against the
JAX package's (`dmosopt_tpu/models/svgp.py`).

Five configurations: shared or separate kernels, shared or separate
inducing sets, and CRV's coregionalization W.

- On parameters carried over from short JAX fits, `_kl_whitened` and
  `_elbo` agree at rtol 1e-5, atol 1e-6; `_latent_moments` and the
  gradient of the negative ELBO, which go through an ill-conditioned
  solve against K_uu, are held with the JAX package's to the port's
  float64 evaluation at 1e-5 and 1e-4 of their scale (`_held`).
- `fit_svgp` for 20 steps with the JAX draws injected (the inducing rows,
  CRV's W and every step's minibatch, rebuilt with the same
  `jax.random` calls on the same key splits) lands on the JAX fit's
  parameters and ELBO within 5e-4 of their scale.
- `svgp_predict` on a carried fit agrees to rtol 1e-4.
- The classes' inducing counts and CRV's mixing matrix, a factor that is
  not positive definite poisons values and gradients as
  `jnp.linalg.cholesky` does, and ``device=None`` needs CUDA.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

# one intra-op thread: the test workers share the machine
torch.set_num_threads(1)

from dmosopt_tpu.models import svgp as JS
from dmosopt_tpu.models.gp import _KERNELS as J_KERNELS
from dmosopt_tpu.utils.prng import as_key
from dmosopt_tpu_torch import interop
from dmosopt_tpu_torch.models import svgp as TS
from dmosopt_tpu_torch.models.gp import _KERNELS as T_KERNELS, _cholesky_or_nan

N, DIM, M, B, N_ITER, SEED = 96, 3, 24, 32, 20, 5
# (share_kernel, share_inducing, n_latent): the trainer is fitted with a
# shared kernel and inducing set (SVGP, SIV) and with CRV's separate
# kernels, shared inducing set and W; the other configurations take
# parameters cut from those fits
FITTED = {
    "shared_kernel_shared_z": (True, True, None),
    "coregionalized": (False, True, 2),
}
CONFIGS = sorted(FITTED) + ["separate_kernel_separate_z", "shared_kernel_separate_z",
                            "separate_kernel_shared_z"]


def _data():
    rng = np.random.default_rng(0)
    X = rng.uniform(size=(N, DIM)).astype(np.float32)
    Y = np.column_stack([np.sin(3 * X[:, 0]) + 0.5 * X[:, 1], np.cos(2 * X[:, 1]) * X[:, 2]])
    Y = (Y - Y.mean(0)) / Y.std(0)
    return X, Y.astype(np.float32)


def _jax_draws(Qz, Q, d, coreg):
    """The draws `fit_svgp` makes from its key (svgp.py:172-207)."""
    k_z, k_p, k_b = jax.random.split(as_key(SEED), 3)
    idx = jax.vmap(lambda k: jax.random.choice(k, N, (M,), replace=False))(
        jax.random.split(k_z, Qz)
    )
    W0 = 0.1 * jax.random.normal(k_p, (d, Q)) + jnp.eye(d, Q) if coreg else None
    sel = jax.vmap(lambda k: jax.random.choice(k, N, (B,), replace=False))(
        jax.random.split(k_b, N_ITER)
    )
    return idx, W0, sel


def _jax_moments(p, b3, Xq):
    """The JAX `_elbo`'s per-latent moments, all latents."""
    amp, ls, _ = JS._unpack(p, *b3)
    Q, Qk, Qz = p.vm.shape[0], p.u_amp.shape[0], p.Z.shape[0]
    one = lambda q: JS._latent_moments(  # noqa: E731
        amp[jnp.minimum(q, Qk - 1)], ls[jnp.minimum(q, Qk - 1)], p.Z[jnp.minimum(q, Qz - 1)],
        p.vm[q], p.vL[q], Xq, J_KERNELS["matern52"])
    return jax.vmap(one)(jnp.arange(Q))


def _jax_references(fits, X, Y, Xq):
    """For every configuration, the moments, KL, the negative ELBO and its
    gradient on (X[:B], Y[:B]) and the prediction at Xq, all in one
    compiled program (the fits share their bounds and kernel)."""
    base = next(iter(fits.values()))
    b3 = (base.bounds_amp, base.bounds_ls, base.bounds_noise)

    @jax.jit
    def ref(params, Xb, Yb, Xq):
        out = {}
        for name, p in params.items():
            mean, var = _jax_moments(p, b3, Xb)
            kl = jax.vmap(JS._kl_whitened)(p.vm, p.vL)
            val, grad = jax.value_and_grad(
                lambda q: -JS._elbo(q, *b3, Xb, Yb, N, J_KERNELS["matern52"]))(p)
            pred = JS.svgp_predict(base._replace(params=p), Xq)
            out[name] = (mean, var, kl, val, grad, pred)
        return out

    out = ref({k: f.params for k, f in fits.items()},
              jnp.asarray(X[:B]), jnp.asarray(Y[:B]), jnp.asarray(Xq))
    return jax.tree_util.tree_map(np.asarray, out)


@pytest.fixture(scope="module")
def jax_ref():
    """Short JAX fits with their draws, parameters for all five
    configurations, and each configuration's reference."""
    X, Y = _data()
    Xq = np.random.default_rng(1).uniform(size=(40, DIM)).astype(np.float32)

    @jax.jit
    def fit_all(X, Y):
        """Both fits and their draws, one compiled program (the fit's own
        eager set-up would otherwise compile op by op)."""
        out = {}
        for name, (sk, si, nl) in FITTED.items():
            fit = JS.fit_svgp(as_key(SEED), X, Y, n_inducing=M, n_latent=nl,
                              share_kernel=sk, share_inducing=si, batch_size=B,
                              n_iter=N_ITER)
            Q = nl or 2
            out[name] = (tuple(fit[:5]), _jax_draws(1 if si else Q, Q, 2, nl is not None))
        return out

    fits, draws = {}, {}
    for name, (leaves, drawn) in fit_all(jnp.asarray(X), jnp.asarray(Y)).items():
        fits[name], draws[name] = JS.SVGPFit(*leaves, "matern52"), drawn
    # a separate inducing set per latent: the two fits' sets; CRV's
    # kernels, or SVGP's shared one; and CRV's fit without its W
    shared, crv = fits["shared_kernel_shared_z"], fits["coregionalized"]
    Z2 = jnp.concatenate([shared.params.Z, crv.params.Z])
    fits["separate_kernel_separate_z"] = crv._replace(
        params=crv.params._replace(Z=Z2, W=None))
    fits["shared_kernel_separate_z"] = shared._replace(params=shared.params._replace(Z=Z2))
    fits["separate_kernel_shared_z"] = crv._replace(params=crv.params._replace(W=None))
    return X, Y, Xq, fits, draws, _jax_references(fits, X, Y, Xq)


def _fit_dict(fit):
    d = fit.params._asdict()
    d.update(bounds_amp=tuple(fit.bounds_amp), bounds_ls=tuple(fit.bounds_ls),
             bounds_noise=tuple(fit.bounds_noise), elbo=fit.elbo, kernel=fit.kernel)
    return {k: (v if isinstance(v, (str, tuple)) or v is None else np.asarray(v))
            for k, v in d.items()}


def _scale_diff(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(1.0, np.max(np.abs(b))))


def _cast(fit, dtype):
    p = TS.SVGPParams(*(None if t is None else t.to(dtype) for t in fit.params))
    b3 = [type(b)(b.lo.to(dtype), b.hi.to(dtype))
          for b in (fit.bounds_amp, fit.bounds_ls, fit.bounds_noise)]
    return p, b3


def _port_moments(fit, Xb, dtype):
    p, b3 = _cast(fit, dtype)
    amp, ls, _ = TS._unpack(p, *b3)
    return TS._latent_moments(amp, ls, p.Z, p.vm, p.vL, torch.as_tensor(Xb, dtype=dtype),
                              T_KERNELS["matern52"])


def _port_bound(fit, Xb, Yb, dtype):
    """The negative ELBO and its gradient, one tensor per field."""
    p, b3 = _cast(fit, dtype)
    leaves = [t.clone().requires_grad_(True) for t in p if t is not None]
    coreg = p.W is not None
    params = TS.SVGPParams(*leaves[:6], leaves[6] if coreg else None)
    val = -TS._elbo(params, *b3, torch.as_tensor(Xb, dtype=dtype),
                    torch.as_tensor(Yb, dtype=dtype), N, T_KERNELS["matern52"])
    fields = [f for f in TS.SVGPParams._fields if f != "W" or coreg]
    return val.detach(), dict(zip(fields, torch.autograd.grad(val, leaves)))


def _held(got, want, exact, tol, label):
    """The port's float32 ``got`` and the JAX package's ``want`` against
    the port's float64 ``exact``: the JAX package within 10·tol of the
    scale (so the float64 evaluation is right), the port's error at most
    four times the JAX package's or tol of the scale (the two packages'
    float32 errors in an ill-conditioned solve differ by up to 3.5x
    here, each rounding its own way)."""
    got, exact = np.asarray(got, np.float64), np.asarray(exact, np.float64)
    scale = max(1.0, float(np.max(np.abs(exact))))
    err_port = float(np.max(np.abs(got - exact)))
    err_jax = float(np.max(np.abs(np.asarray(want, np.float64) - exact)))
    assert err_jax <= 10 * tol * scale, (label, err_jax, scale)
    assert err_port <= max(4.0 * err_jax, tol * scale), (label, err_port, err_jax)


@pytest.mark.parametrize("name", CONFIGS)
def test_bound_and_gradient_on_carried_params_match_jax(jax_ref, name):
    """The KL and the bound at rtol 1e-5, atol 1e-6. The moments and the
    gradient go through a solve against K_uu, whose condition number
    reaches 1/jitter (1e5), so float32 results of either package miss
    the float64 ones by up to a few 1e-6 (moments) and 1e-4 of the scale
    (gradients): each package's float32 moments and gradients are held
    to the port's float64 ones (`_held`, tol 1e-5 and 1e-4)."""
    X, Y, _, fits, _, refs = jax_ref
    jm, jv, jkl, jval, jgrad, _ = refs[name]
    tfit = interop.svgp_fit_from_arrays(_fit_dict(fits[name]), "cpu")
    p = tfit.params
    Xb, Yb = X[:B], Y[:B]

    moments32 = _port_moments(tfit, Xb, torch.float32)
    moments64 = _port_moments(tfit, Xb, torch.float64)
    for label, got, want, exact in zip(("mean", "var"), moments32, (jm, jv), moments64):
        _held(got.numpy(), want, exact.numpy(), 1e-5, (name, label))
    np.testing.assert_allclose(TS._kl_whitened(p.vm, p.vL).numpy(), jkl,
                               rtol=1e-5, atol=1e-6)

    val32, grad32 = _port_bound(tfit, Xb, Yb, torch.float32)
    _, grad64 = _port_bound(tfit, Xb, Yb, torch.float64)
    np.testing.assert_allclose(float(val32), float(jval), rtol=1e-5, atol=1e-6)
    for field, g in grad32.items():
        _held(g.numpy(), getattr(jgrad, field), grad64[field].numpy(), 1e-4, (name, field))


@pytest.mark.parametrize("name", sorted(FITTED))
def test_short_fit_with_jax_draws_matches_jax(jax_ref, name):
    X, Y, _, fits, draws, _ = jax_ref
    jfit, (idx, W0, sel) = fits[name], draws[name]
    sk, si, nl = FITTED[name]
    tfit = TS.fit_svgp(
        torch.Generator().manual_seed(0), torch.as_tensor(X), torch.as_tensor(Y),
        n_inducing=M, n_latent=nl, share_kernel=sk, share_inducing=si,
        batch_size=B, n_iter=N_ITER,
        inducing_idx=torch.as_tensor(np.array(idx), dtype=torch.int64),
        batch_idx=torch.as_tensor(np.array(sel), dtype=torch.int64),
        W0=None if W0 is None else torch.as_tensor(np.array(W0)),
    )
    for field in TS.SVGPParams._fields:
        want = getattr(jfit.params, field)
        got = getattr(tfit.params, field)
        if want is None:
            assert got is None
            continue
        assert got.shape == want.shape, field
        assert _scale_diff(got.numpy(), want) <= 5e-4, (name, field)
    assert _scale_diff(float(tfit.elbo), float(jfit.elbo)) <= 5e-4, name
    # vL's upper triangle never moves: it enters only through tril
    upper = np.triu(np.ones((M, M)), 1).astype(bool)
    assert np.all(tfit.params.vL.numpy()[:, upper] == 0.0)


@pytest.mark.parametrize("name", CONFIGS)
def test_predict_on_a_carried_fit_matches_jax(jax_ref, name):
    _, _, Xq, fits, _, refs = jax_ref
    jm, jv = refs[name][5]
    tm, tv = TS.svgp_predict(interop.svgp_fit_from_arrays(_fit_dict(fits[name]), "cpu"),
                             torch.as_tensor(Xq))
    np.testing.assert_allclose(tm.numpy(), jm, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), jv, rtol=1e-4, atol=1e-6)


def test_inducing_counts_and_the_mixing_matrix():
    """tests/test_svgp.py:51-66's numbers: 0.2 of 300 rows with at least 30
    is 60 inducing rows, VGP's are all 300; CRV mixes 2 latents into 2
    outputs (one Adam step is enough for the shapes)."""
    rng = np.random.default_rng(0)
    X = rng.uniform(size=(300, 4))
    Y = np.column_stack([np.sin(3 * X[:, 0]), X[:, 1] * X[:, 2]])
    kw = dict(n_iter=1, batch_size=64, seed=0, device="cpu")
    m = TS.SVGP_Matern(X, Y, 4, 2, np.zeros(4), np.ones(4),
                       inducing_fraction=0.2, min_inducing=30, **kw)
    assert m.fit.params.Z.shape == (1, 60, 4) and m.fit_info["n_inducing"] == 60
    assert TS.VGP_Matern(X, Y, 4, 2, np.zeros(4), np.ones(4), **kw).fit.params.Z.shape[1] == 300
    assert TS.SPV_Matern(X, Y, 4, 2, np.zeros(4), np.ones(4), **kw).fit.params.Z.shape == (2, 100, 4)
    c = TS.CRV_Matern(X, Y, 4, 2, np.zeros(4), np.ones(4), **kw)
    assert c.fit.params.W.shape == (2, 2)
    mean, var = c.predict(X[:5])
    assert mean.shape == (5, 2) and bool(torch.all(var > 0))
    mean_var = TS.SIV_Matern(X, Y, 4, 2, np.zeros(4), np.ones(4), return_mean_variance=True,
                             **kw).evaluate(X[:3])
    assert isinstance(mean_var, tuple) and len(mean_var) == 2


def test_a_failed_factor_poisons_values_and_gradients_as_jax():
    K_bad = np.array([[1.0, 2.0], [2.0, 1.0]], np.float32)
    K_ok = np.array([[2.0, 0.5], [0.5, 1.0]], np.float32)
    for K, finite in ((K_bad, False), (K_ok, True)):
        gj = jax.grad(lambda k: jnp.sum(jnp.linalg.cholesky(k)))(jnp.asarray(K))
        k = torch.as_tensor(K).requires_grad_(True)
        L = _cholesky_or_nan(k)
        (g,) = torch.autograd.grad(L.sum(), k)
        assert bool(torch.isfinite(L).all()) == finite
        assert bool(torch.isfinite(g).all()) == finite == bool(np.isfinite(gj).all())


def test_svgp_needs_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, Y = _data()
    with pytest.raises(RuntimeError, match="CUDA"):
        TS.SVGP_Matern(X, Y, DIM, 2, np.zeros(DIM), np.ones(DIM), n_iter=1)
