"""The port's deep-kernel GPs (`models/deep_gp.py`) against the JAX
package's (`dmosopt_tpu/models/deep_gp.py`).

- `_mlp_forward` and `_nmll_on_features` on carried weights agree at
  rtol 1e-5 (the NMLL at 1e-5 of its scale), `deep_gp_predict` on a
  carried fit at rtol 1e-4.
- `fit_deep_gp` with the JAX MLP init injected: a 20-step minibatch fit
  (the MDSPP path, the JAX picks rebuilt from the same key splits) lands
  on the JAX fit's weights, hyperparameters, centered features and NMLL
  within 5e-4 of their scale (`_check_params` says why the biases are
  held looser); the
  full-batch fit with early stopping (chunks of 40 steps) stops at the
  same step as the JAX fit, with the NMLL within 1e-3.
- The classes report their steps, MDSPP minibatches, and
  ``device=None`` needs CUDA.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

# one intra-op thread: the test workers share the machine
torch.set_num_threads(1)

from dmosopt_tpu.models import deep_gp as JD
from dmosopt_tpu.models.gp import _KERNELS as J_KERNELS
from dmosopt_tpu.utils.prng import as_key
from dmosopt_tpu_torch import interop
from dmosopt_tpu_torch.models import deep_gp as TD
from dmosopt_tpu_torch.models.gp import _KERNELS as T_KERNELS

N, DIM, SEED, HIDDEN = 32, 2, 3, (8, 8)
# the early-stopping fit's step budget and learning rate stop it before
# its end; the minibatch fit takes the default learning rate
ES_ITER, ES_LR, MB_ITER, MB_BATCH, MB_LR = 320, 0.03, 20, 16, 0.01


def _data():
    """The JAX package's nonstationary test function (tests/test_deep_gp.py)."""
    rng = np.random.default_rng(0)
    X = rng.uniform(size=(N, DIM)).astype(np.float32)
    t = X[:, 0]
    Y = np.column_stack([np.sin(2 * np.pi * t * (1 + 3 * t)), np.cos(4 * np.pi * X[:, 1] ** 2)])
    return X, ((Y - Y.mean(0)) / Y.std(0)).astype(np.float32)


def _jax_draws(n_iter, batch):
    """The MLP init and the minibatch picks of `fit_deep_gp`'s key
    (deep_gp.py:142, :170, :195-202), one training chunk."""
    key, k_mlp = jax.random.split(as_key(SEED))
    mlp = JD._init_mlp(k_mlp, [DIM, *HIDDEN, DIM])
    _, k_train = jax.random.split(key)
    _, k = jax.random.split(k_train)
    sel = jax.vmap(lambda kk: jax.random.choice(kk, N, (batch,), replace=False))(
        jax.random.split(k, n_iter)
    )
    init = TD.MLPParams(tuple(torch.tensor(np.asarray(w)) for w in mlp.weights),
                        tuple(torch.tensor(np.asarray(b)) for b in mlp.biases))
    return init, torch.tensor(np.asarray(sel), dtype=torch.int64)


def _fit_dict(fit):
    p = fit.params
    d = {k: np.asarray(getattr(fit, k))
         for k in ("X", "F", "L", "alpha", "y_mean", "y_std", "nmll")}
    d.update(weights=[np.asarray(w) for w in p.mlp.weights],
             biases=[np.asarray(b) for b in p.mlp.biases],
             u_amp=np.asarray(p.u_amp), u_ls=np.asarray(p.u_ls),
             u_noise=np.asarray(p.u_noise),
             **{k: tuple(np.asarray(v) for v in getattr(fit, k))
                for k in ("bounds_amp", "bounds_ls", "bounds_noise")})
    return d


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX fits (full batch with early stopping; a short minibatch
    fit), and on the first one's parameters the warped features, the
    per-objective NMLLs and a prediction, in one compiled program."""
    X, Y = _data()
    Xq = np.random.default_rng(1).uniform(size=(24, DIM)).astype(np.float32)
    es = JD.fit_deep_gp(SEED, jnp.asarray(X), jnp.asarray(Y), hidden=HIDDEN,
                        n_iter=ES_ITER, learning_rate=ES_LR, early_stopping=True)
    mb = JD.fit_deep_gp(SEED, jnp.asarray(X), jnp.asarray(Y), hidden=HIDDEN,
                        n_iter=MB_ITER, learning_rate=MB_LR, batch_size=MB_BATCH)
    kernel_fn = J_KERNELS["matern52"]

    @jax.jit
    def ref(fit, X, Y, Xq):
        p = fit.params
        F = JD._mlp_forward(p.mlp, X)
        amp = fit.bounds_amp.forward(p.u_amp)
        ls = fit.bounds_ls.forward(p.u_ls)
        noise = fit.bounds_noise.forward(p.u_noise)
        nmll = jax.vmap(lambda a, l, s, y: JD._nmll_on_features(F, y, a, l, s, kernel_fn),
                        in_axes=(0, 0, 0, 1))(amp, ls, noise, Y)
        return F, nmll, JD.deep_gp_predict.__wrapped__(fit, Xq)

    out = jax.tree_util.tree_map(np.asarray, ref(es, jnp.asarray(X), jnp.asarray(Y),
                                                 jnp.asarray(Xq)))
    return X, Y, Xq, es, mb, out


def _scale_diff(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(1.0, np.max(np.abs(b))))


def test_mlp_nmll_and_predict_on_a_carried_fit_match_jax(jax_ref):
    X, Y, Xq, es, _, (jF, jnmll, (jmean, jvar)) = jax_ref
    tfit = interop.deep_gp_fit_from_arrays(_fit_dict(es), "cpu")
    p = tfit.params
    F = TD._mlp_forward(p.mlp, torch.as_tensor(X))
    np.testing.assert_allclose(F.numpy(), jF, rtol=1e-5, atol=1e-6)
    nmll = TD._nmll_on_features(
        F, torch.as_tensor(Y), tfit.bounds_amp.forward(p.u_amp),
        tfit.bounds_ls.forward(p.u_ls), tfit.bounds_noise.forward(p.u_noise),
        T_KERNELS["matern52"],
    )
    assert _scale_diff(nmll.numpy(), jnmll) <= 1e-5
    mean, var = TD.deep_gp_predict(tfit, torch.as_tensor(Xq))
    assert _scale_diff(mean.numpy(), jmean) <= 1e-4
    assert _scale_diff(var.numpy(), jvar) <= 1e-4


def _check_params(tfit, jfit, tol):
    """Weights, hyperparameters and the centered training features within
    ``tol`` of their scale. Adam scales each element's step by its own
    gradient's size, so an element whose gradient is near zero moves by
    up to the learning rate a step on float32 rounding alone: the hidden
    biases are held to 4·tol, and the output bias not at all (the kernel
    sees differences of features only, so its gradient is zero up to
    rounding)."""
    tp, jp = tfit.params, jfit.params
    pairs = [(g, w, tol) for g, w in zip(tp.mlp.weights, jp.mlp.weights)]
    pairs += [(g, w, 4 * tol) for g, w in zip(tp.mlp.biases[:-1], jp.mlp.biases[:-1])]
    pairs += [(getattr(tp, k), getattr(jp, k), tol) for k in ("u_amp", "u_ls", "u_noise")]
    for got, want, t in pairs:
        assert got.shape == want.shape
        assert _scale_diff(got.numpy(), want) <= t
    F, jF = tfit.F.numpy(), np.asarray(jfit.F)
    assert _scale_diff(F - F.mean(0), jF - jF.mean(0)) <= tol


def test_minibatch_fit_with_jax_draws_matches_jax(jax_ref):
    X, Y, _, _, mb, _ = jax_ref
    init, sel = _jax_draws(MB_ITER, MB_BATCH)
    tfit = TD.fit_deep_gp(torch.Generator().manual_seed(0), torch.as_tensor(X),
                          torch.as_tensor(Y), hidden=HIDDEN, n_iter=MB_ITER,
                          learning_rate=MB_LR, batch_size=MB_BATCH, mlp_init=init,
                          batch_idx=sel)
    assert tfit.n_steps == MB_ITER
    _check_params(tfit, mb, 5e-4)
    assert _scale_diff(float(tfit.nmll), float(mb.nmll)) <= 5e-4


def test_early_stopping_stops_at_the_jax_step(jax_ref):
    """Chunks of max(320 // 8, 25) = 40 steps; checks open at the deep-GP
    configuration's 200 warm-up steps, and three agreeing checks in a row
    stop the fit before its 320 steps."""
    X, Y, _, es, _, _ = jax_ref
    init, _ = _jax_draws(1, 1)
    tfit = TD.fit_deep_gp(torch.Generator().manual_seed(0), torch.as_tensor(X),
                          torch.as_tensor(Y), hidden=HIDDEN, n_iter=ES_ITER,
                          learning_rate=ES_LR, early_stopping=True, mlp_init=init)
    # the JAX fit keeps no step count: its run is recovered from its
    # final loss, which only the stopping step reproduces
    assert 200 <= tfit.n_steps < ES_ITER and tfit.n_steps % 40 == 0
    assert _scale_diff(float(tfit.nmll), float(es.nmll)) <= 1e-3
    full = TD.fit_deep_gp(torch.Generator().manual_seed(0), torch.as_tensor(X),
                          torch.as_tensor(Y), hidden=HIDDEN, n_iter=tfit.n_steps + 40,
                          learning_rate=ES_LR, mlp_init=init)
    assert _scale_diff(float(full.nmll), float(es.nmll)) > 1e-3


def test_classes_report_steps_and_need_cuda(monkeypatch):
    X, Y = _data()
    m = TD.MDGP_Matern(X, Y, DIM, 2, np.zeros(DIM), np.ones(DIM), seed=0, n_iter=5,
                       hidden=HIDDEN, device="cpu")
    assert m.fit_info["n_steps"] == 5 and not m.fit_info["early_stopped"]
    mean, var = m.predict(X[:4])
    assert mean.shape == (4, 2) and bool(torch.all(var > 0))
    s = TD.MDSPP_Matern(X, Y, DIM, 2, np.zeros(DIM), np.ones(DIM), seed=0, n_iter=5,
                        hidden=HIDDEN, batch_size=8, device="cpu")
    assert s.fit.n_steps == 5 and np.isfinite(s.fit_info["loss"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TD.MDGP_Matern(X, Y, DIM, 2, np.zeros(DIM), np.ones(DIM), n_iter=1)
