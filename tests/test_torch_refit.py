"""The port's cross-epoch surrogate reuse (`models/refit.py` and the
posterior updates of `models/gp.py`) against the JAX package's.

- `extend_cholesky_rank_k` on a carried-over JAX posterior equals the
  JAX package's update of the same inputs (float32 reduction order
  apart) and the port's own full refactorization at the same
  hyperparameters (the JAX package's bars: L within 1e-3 and alpha
  within 3e-2 of their scale, NMLL within 1e-3 relative); a (k, k)
  block that is not positive definite gives a non-finite NMLL.
- Single-restart fits (``n_starts=1``) draw nothing, since restart 0 is
  exact, so the controller's schedule is the same in both packages: the
  same ``path_history`` over a growing archive.
- Configuration validation, a seeded controller's first fit (warm), a
  warm state that no longer fits the configuration (cold), MEGP outside
  the warm family, and ``surrogate_refit="cold"`` giving the same
  archive as None.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

# one intra-op thread: the test workers share the machine, and torch's
# default of one thread per core oversubscribes it
torch.set_num_threads(1)

import dmosopt_tpu_torch
from dmosopt_tpu import moasmo as jax_moasmo
from dmosopt_tpu.models import gp as JGP
from dmosopt_tpu.models import refit as JRF
from dmosopt_tpu_torch import interop
from dmosopt_tpu_torch import moasmo as port_moasmo
from dmosopt_tpu_torch.driver import dopt_dict
from dmosopt_tpu_torch.models import gp as TGP
from dmosopt_tpu_torch.models.refit import SurrogateRefitConfig, SurrogateRefitController


def _objective(x):
    return np.column_stack([np.sum(x**2, axis=1), np.sum((x - 0.5) ** 2, axis=1)])


def _pool(n, dim=5, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, dim))
    return X, _objective(X)


def _norm_diff(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(1.0, np.max(np.abs(b))))


def _append_inputs(n0, k, dim=5):
    """A JAX posterior of the first n0 rows (fixed hyperparameters) and
    the padded inputs with k rows appended in its bucket."""
    X, Y = _pool(n0 + k, dim)
    Yn = ((Y - Y[:n0].mean(0)) / Y[:n0].std(0)).astype(np.float32)
    Xp, Yp, mask = JGP._pad_to_bucket(X[:n0].astype(np.float32), Yn[:n0])
    amp = jnp.asarray([1.2, 0.9], jnp.float32)
    ls = jnp.asarray([[0.6], [0.45]], jnp.float32)
    noise = jnp.asarray([1e-4, 3e-5], jnp.float32)
    L, alpha, nmll = JGP.posterior_from_params(
        jnp.asarray(Xp), jnp.asarray(Yp), jnp.asarray(mask), amp, ls, noise,
        kernel="matern52", rel_jitter=1e-4,
    )
    P = Xp.shape[0]
    assert n0 + k <= P
    X_pad = Xp.copy()
    X_pad[n0:n0 + k] = X[n0:].astype(np.float32)
    mask2 = (np.arange(P) < n0 + k).astype(np.float32)
    Yn_pad = np.zeros((P, 2), np.float32)
    Yn_pad[:n0 + k] = Yn
    hyper = {"amp": amp, "ls": ls, "noise": noise}
    return L, X_pad, mask2, Yn_pad, hyper


@pytest.mark.parametrize("n0,k", [(70, 8), (100, 28)])
def test_extend_cholesky_rank_k_matches_jax_and_the_refactorization(n0, k):
    """(70, 8) appends inside a partly padded 128 bucket; (100, 28) fills
    it to its edge."""
    L, X_pad, mask, Yn_pad, h = _append_inputs(n0, k)
    want = JGP.extend_cholesky_rank_k(
        L, jnp.asarray(X_pad), jnp.asarray(mask), jnp.asarray(Yn_pad), h["amp"],
        h["ls"], h["noise"], kernel="matern52", n_old=n0, n_new=n0 + k, rel_jitter=1e-4,
    )
    t = {key: torch.as_tensor(np.array(v)) for key, v in h.items()}
    args = (torch.as_tensor(X_pad), torch.as_tensor(mask), torch.as_tensor(Yn_pad),
            t["amp"], t["ls"], t["noise"])
    got = TGP.extend_cholesky_rank_k(
        torch.as_tensor(np.array(L)), *args, kernel="matern52", n_old=n0,
        n_new=n0 + k, rel_jitter=1e-4,
    )
    full = TGP.posterior_from_params(
        torch.as_tensor(X_pad), torch.as_tensor(Yn_pad), torch.as_tensor(mask),
        t["amp"], t["ls"], t["noise"], kernel="matern52", rel_jitter=1e-4,
    )
    for ref, name in ((want, "jax"), (full, "refactorization")):
        assert _norm_diff(got[0], ref[0]) < 1e-3, name
        assert _norm_diff(got[1], ref[1]) < 3e-2, name
        np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), rtol=1e-3,
                                   atol=1e-2, err_msg=name)


def test_a_block_that_is_not_positive_definite_gives_a_non_finite_nmll():
    L, X_pad, mask, Yn_pad, h = _append_inputs(70, 8)
    t = {key: torch.as_tensor(np.array(v)) for key, v in h.items()}
    # a negative noise larger than the amplitude makes K22 - L21 L21ᵀ
    # indefinite
    _, alpha, nmll = TGP.extend_cholesky_rank_k(
        torch.as_tensor(np.array(L)), torch.as_tensor(X_pad), torch.as_tensor(mask),
        torch.as_tensor(Yn_pad), t["amp"], t["ls"], -2.0 * t["amp"], kernel="matern52",
        n_old=70, n_new=78, rel_jitter=1e-4,
    )
    assert not bool(torch.isfinite(nmll).any())
    assert not bool(torch.isfinite(alpha).all())


# sizes inside one 128-row bucket, then across it: cold, warm, then
# rank updates and a bucket-crossing refactorization
SIZES = [70, 78, 86, 120, 136]
SINGLE = {"n_starts": 1, "n_iter": 60, "seed": 0}


def test_the_controller_schedule_matches_jax():
    """Same archive, single-restart fits: the same path history in both
    packages (measured: cold, warm, rank, rank, rank_refactor)."""
    dim = 5
    X, Y = _pool(max(SIZES), dim, seed=4)
    histories = []
    for moasmo, ctrl, kw in (
        (jax_moasmo, JRF.SurrogateRefitController(JRF.SurrogateRefitConfig("warm")), {}),
        (port_moasmo, SurrogateRefitController(SurrogateRefitConfig("warm")),
         {"device": "cpu"}),
    ):
        for n in SIZES:
            sm = moasmo.train(dim, 2, np.zeros(dim), np.ones(dim), X[:n], Y[:n], None,
                              surrogate_method_kwargs=dict(SINGLE), surrogate_refit=ctrl,
                              **kw)
        histories.append(ctrl.path_history)
        assert sm.fit_info["n_steps"] == 0
    assert histories[1] == histories[0], histories
    assert set(histories[0]) >= {"cold", "warm", "rank"}, histories


def test_refit_config_validation():
    with pytest.raises(ValueError):
        SurrogateRefitConfig("lukewarm")
    with pytest.raises(TypeError):
        SurrogateRefitConfig.from_spec(3.14)
    with pytest.raises(ValueError, match="audit_every"):
        SurrogateRefitConfig("warm", audit_every=1)
    cfg = SurrogateRefitConfig.from_spec({"mode": "warm", "audit_every": 7})
    assert cfg.audit_every == 7
    assert SurrogateRefitConfig.from_spec(None).mode == "cold"
    assert SurrogateRefitConfig.from_spec(cfg) is cfg
    with pytest.raises(ValueError, match="mode"):
        SurrogateRefitConfig.from_spec({"hyper_tol": 0.2})


def _train(ctrl, X, Y, **kw):
    dim = X.shape[1]
    return port_moasmo.train(
        dim, 2, np.zeros(dim), np.ones(dim), X, Y, None,
        surrogate_method_kwargs={"n_starts": 2, "n_iter": 40, "seed": 0, **kw},
        surrogate_refit=ctrl, device="cpu",
    )


def test_a_seeded_controller_fits_warm_first():
    """A controller seeded from a checkpointed state warm-starts its first
    fit (no factor is cached, so never a rank update), also when the
    state says it is stable."""
    X, Y = _pool(80)
    donor = SurrogateRefitController(SurrogateRefitConfig("warm"))
    _train(donor, X[:70], Y[:70])
    state = donor.export_state()
    state["stable"] = 5
    seeded = SurrogateRefitController(
        SurrogateRefitConfig("warm", rank_update_after=1), seed_state=state)
    sm = _train(seeded, X, Y)
    assert seeded.path_history == ["warm"]
    assert sm.predict(X[:3])[0].shape == (3, 2)


def test_a_mismatched_warm_state_refits_cold():
    """Isotropic warm state for an anisotropic fit (a resume after
    flipping ``anisotropic``): the controller falls back to a cold fit."""
    X, Y = _pool(90)
    donor = SurrogateRefitController(SurrogateRefitConfig("warm"))
    _train(donor, X[:70], Y[:70])
    seeded = SurrogateRefitController(
        SurrogateRefitConfig("warm"), seed_state=donor.export_state())
    sm = _train(seeded, X, Y, anisotropic=True)
    assert seeded.path_history == ["cold"]
    assert tuple(sm.fit.ls.shape) == (2, 5)


def test_megp_stays_outside_the_warm_family():
    """MEGP's shared-kernel fit takes the plain constructor: the
    controller never engages, as in the JAX package."""
    ctrl = SurrogateRefitController(SurrogateRefitConfig("warm"))
    X, Y = _pool(60, dim=3)
    info = {}
    sm = port_moasmo.train(
        3, 2, np.zeros(3), np.ones(3), X, Y, None, surrogate_method_name="megp",
        surrogate_method_kwargs={"n_starts": 2, "n_iter": 20, "seed": 0},
        info=info, surrogate_refit=ctrl, device="cpu",
    )
    assert ctrl.path_history == [] and "refit_path" not in info
    assert not ctrl.applies(type(sm)) and sm.predict(X[:4])[0].shape == (4, 2)


def _zdt1(pp):
    x = np.array([pp[f"x{i}"] for i in range(4)])
    g = 1.0 + 3.0 * np.sum(x[1:])
    return np.array([x[0], g * (1.0 - np.sqrt(x[0] / g))])


def test_cold_refit_gives_the_same_archive_as_none():
    archives = []
    for opt_id, refit in (("refit_none", None), ("refit_cold", "cold")):
        dmosopt_tpu_torch.run({
            "opt_id": opt_id, "obj_fun": _zdt1, "objective_names": ["f1", "f2"],
            "space": {f"x{i}": [0.0, 1.0] for i in range(4)}, "problem_parameters": {},
            "n_initial": 3, "n_epochs": 3, "population_size": 16, "num_generations": 8,
            "resample_fraction": 0.5, "surrogate_method_name": "gpr",
            "surrogate_method_kwargs": {"n_starts": 2, "n_iter": 30, "seed": 0},
            "surrogate_refit": refit, "random_seed": 11,
        }, device="cpu", verbose=False)
        strat = dopt_dict[opt_id].optimizer_dict[0]
        assert strat.refit_controller is None
        archives.append(strat.get_evals())
    for a, b in zip(*archives):
        assert np.array_equal(a, b)


def test_a_carried_over_fit_with_a_whitening_factor_serves_it():
    """A JAX fit carrying ``whitened`` (the mesh-sharded fit's W = L⁻¹)
    crosses `interop`, and the matmul predictor adopts it as its cache."""
    L, X_pad, mask, Yn_pad, h = _append_inputs(70, 8)
    W = np.linalg.inv(np.asarray(L, np.float64)).astype(np.float32)
    fit = {"X": X_pad, "L": np.asarray(L), "alpha": np.zeros((2, 128), np.float32),
           "amp": np.asarray(h["amp"]), "ls": np.asarray(h["ls"]),
           "noise": np.asarray(h["noise"]), "y_mean": np.zeros(2, np.float32),
           "y_std": np.ones(2, np.float32), "nmll": np.zeros(2, np.float32),
           "train_mask": (np.arange(128) < 70).astype(np.float32), "whitened": W}
    tfit = interop.gp_fit_from_arrays(fit, "cpu")
    from dmosopt_tpu_torch.models.predictor import GPPredictor

    p = GPPredictor(tfit, "matern52", "matmul", rel_jitter=1e-4)
    assert p.whitened is tfit.whitened
    np.testing.assert_array_equal(p.whitened.numpy(), W)
