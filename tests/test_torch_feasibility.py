"""The port's feasibility model and constrained archive queries against
the JAX package.

Same standardized, rotated inputs, labels and masks give the same
proximal-gradient weights (1e-4); with the JAX package's fold draws
injected the cross-validation scores are equal and pick the same
strength; the whole model's `rank` agrees to 1e-5 on 1000 seeded points
and `predict` wherever the logit is not within 1e-4 of 0; a fit carried
across with `interop.feasibility_from_arrays` ranks as the JAX model does
and NSGA-II's and AGE-MOEA's survival keep the same rows with it as the
within-front key. `moasmo.get_feasible` and `epsilon_get_best` are exact
copies of the JAX package's host code with the dedupe on the run's
device, so their answers are equal.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

# one intra-op thread: the test workers share the machine, and torch's
# default of one thread per core oversubscribes it
torch.set_num_threads(1)

from dmosopt_tpu import feasibility as jax_feas
from dmosopt_tpu import moasmo as jax_moasmo
from dmosopt_tpu.models.gp import _bucket_size
from dmosopt_tpu_torch import feasibility as port_feas
from dmosopt_tpu_torch import interop
from dmosopt_tpu_torch import moasmo as port_moasmo
from dmosopt_tpu_torch.models import Model


def _data(seed=0, n=60, d=4):
    """Inputs in [-1, 1]^d and constraints: a noisy half-space, a band,
    and one that is always satisfied (single class)."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1.0, 1.0, size=(n, d))
    C = np.column_stack([
        X[:, 0] + 0.2 * rng.normal(size=n),
        0.3 - X[:, 1] + 0.1 * X[:, 2],
        np.ones(n),
    ])
    return X, C


def _jax_folds(C, seed=0):
    """The fold of each row for each two-class constraint, as the JAX
    model draws them: one key split per fitted constraint, a permutation
    of the bucket-padded rows modulo 3, the real rows' entries."""
    n = C.shape[0]
    bucket = _bucket_size(n)
    key = jax.random.PRNGKey(seed)
    folds = np.zeros((C.shape[1], n), np.int64)
    for i in range(C.shape[1]):
        if len(np.unique(C[:, i] > 0.0)) <= 1:
            continue
        key, k = jax.random.split(key)
        folds[i] = np.asarray(jax.random.permutation(k, bucket) % 3)[:n]
    return folds


@pytest.fixture(scope="module")
def jax_fit():
    """The JAX model on `_data()` (its CV program compiled once), with
    its folds, and the proximal-gradient step compiled once."""
    X, C = _data()
    model = jax_feas.LogisticFeasibilityModel(X, C, seed=0)
    fit_l1 = jax.jit(jax_feas._fit_logistic_l1)
    return X, C, model, _jax_folds(C), fit_l1


def test_proximal_gradient_fit_matches_jax(jax_fit):
    """Every strength of the grid as one batch: the same weights as the
    JAX package's fit of each, masked rows left out."""
    *_, fit_l1 = jax_fit
    rng = np.random.default_rng(1)
    Z = rng.normal(size=(40, 3)).astype(np.float32)
    y = (Z[:, 0] - 0.5 * Z[:, 1] + 0.3 * rng.normal(size=40) > 0).astype(np.float32)
    mask = (rng.uniform(size=40) > 0.2).astype(np.float32)
    lams = np.asarray(jax_feas._LAMBDAS)
    w, b = port_feas._fit_logistic_l1_batch(
        torch.as_tensor(Z), torch.as_tensor(np.tile(y, (4, 1))),
        torch.as_tensor(np.tile(mask, (4, 1))), torch.as_tensor(np.array(lams)),
    )
    for i, lam in enumerate(lams):
        wj, bj = fit_l1(jnp.asarray(Z), jnp.asarray(y), jnp.asarray(mask), lam)
        np.testing.assert_allclose(w[i].numpy(), np.asarray(wj), atol=1e-4)
        np.testing.assert_allclose(float(b[i]), float(bj), atol=1e-4)


def test_cv_selection_matches_jax(jax_fit):
    """With the JAX package's folds, the held-out accuracies are equal and
    pick the same strength; the refit's weights agree."""
    X, C, *_ = jax_fit
    Z = jnp.asarray(np.random.default_rng(2).normal(size=(48, 3)), jnp.float32)
    y = (np.asarray(Z)[:, 0] + 0.4 * np.asarray(Z)[:, 2] > 0.1).astype(np.float32)
    key = jax.random.PRNGKey(5)
    wj, bj, scores = jax_feas._fit_constraint(
        Z, jnp.asarray(y), jnp.ones(48, bool), key
    )
    folds = np.asarray(jax.random.permutation(key, 48) % 3)
    w, b, port_scores, best = port_feas._fit_constraints(
        torch.as_tensor(np.asarray(Z)), torch.as_tensor(y[None]),
        torch.as_tensor(folds[None]),
    )
    np.testing.assert_array_equal(port_scores[0].numpy(), np.asarray(scores))
    assert int(best[0]) == int(jnp.argmax(scores))
    np.testing.assert_allclose(w[0].numpy(), np.asarray(wj), atol=1e-4)
    np.testing.assert_allclose(float(b[0]), float(bj), atol=1e-4)


def test_whole_model_rank_and_predict_match_jax(jax_fit):
    X, C, jm, folds, _ = jax_fit
    pm = port_feas.LogisticFeasibilityModel(X, C, folds=folds, device="cpu")
    assert pm.fitted == [0, 1] and pm.weights[2] is None and jm.weights[2] is None
    xt = np.random.default_rng(3).uniform(-1.0, 1.0, size=(1000, 4))
    np.testing.assert_allclose(pm.rank(xt).numpy(), np.asarray(jm.rank(xt)), atol=1e-5)
    Zq = ((xt - jm.x_mean) / jm.x_std) @ jm.rotation
    logits = Zq @ np.asarray(jm._W, np.float64).T + np.asarray(jm._b, np.float64)
    clear = np.abs(logits) > 1e-4
    np.testing.assert_array_equal(pm.predict(xt).numpy()[clear], jm.predict(xt)[clear])
    np.testing.assert_allclose(
        pm.predict_proba(xt).numpy(), jm.predict_proba(xt), atol=1e-5
    )
    # the always-satisfied constraint: w = 0, b = 30, probability ~1
    assert np.all(pm.predict(xt).numpy()[:, 2] == 1)


def test_single_class_model_and_default_folds():
    """Only single-class constraints: no fit, rank ~1 everywhere; the
    default folds (a seeded draw on the device) give a working model."""
    rng = np.random.default_rng(1)
    X = rng.uniform(size=(50, 3))
    pm = port_feas.LogisticFeasibilityModel(X, np.ones((50, 1)), device="cpu")
    assert pm.weights == [None] and pm.get_stats()["n_fitted"] == 0
    np.testing.assert_allclose(pm.rank(X[:5]).numpy(), 1.0)
    X, C = _data(seed=4, n=120)
    pm = port_feas.LogisticFeasibilityModel(X, C, device="cpu")
    assert pm.predict(np.array([[0.9, -0.9, 0.0, 0.0]])).tolist() == [[1, 1, 1]]


def test_feasibility_model_needs_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, C = _data()
    with pytest.raises(RuntimeError, match="CUDA"):
        port_feas.LogisticFeasibilityModel(X, C)


def _carried(jm):
    return interop.feasibility_from_arrays(
        {k: np.asarray(getattr(jm, k)) for k in ("x_mean", "x_std", "rotation", "_W", "_b")},
        "cpu",
    )


class _JaxModel:
    def __init__(self, feasibility):
        self.objective = None
        self.feasibility = feasibility
        self.sensitivity = None


def test_carried_model_ranks_and_survival_match_jax(jax_fit):
    """A JAX fit carried across ranks as the JAX model does; NSGA-II's
    sorted survival and AGE-MOEA's environmental selection keep the same
    rows with it as their within-front key (tie-free inputs: 2
    objectives in few fronts, distinct feasibility ranks)."""
    from dmosopt_tpu.optimizers import agemoea as jax_age
    from dmosopt_tpu.optimizers import nsga2 as jax_nsga2
    from dmosopt_tpu_torch.optimizers import agemoea as port_age
    from dmosopt_tpu_torch.optimizers import nsga2 as port_nsga2

    X, C, jm, _, _ = jax_fit
    pm = _carried(jm)
    assert pm.fitted == [0, 1]
    xt = np.random.default_rng(5).uniform(-1.0, 1.0, size=(200, 4))
    np.testing.assert_allclose(pm.rank(xt).numpy(), np.asarray(jm.rank(xt)), atol=1e-6)

    rng = np.random.default_rng(6)
    x = rng.uniform(-1.0, 1.0, size=(64, 4)).astype(np.float32)
    t = rng.uniform(size=64)
    y = np.column_stack([t, 1.0 - t + 0.05 * rng.integers(0, 3, 64)]).astype(np.float32)
    bounds = np.stack([-np.ones(4), np.ones(4)], axis=1)
    pmodel = Model(feasibility=pm)
    for jcls, pcls in ((jax_nsga2.NSGA2, port_nsga2.NSGA2),
                       (jax_age.AGEMOEA, port_age.AGEMOEA)):
        jopt = jcls(popsize=32, nInput=4, nOutput=2, model=_JaxModel(jm),
                    distance_metric=None)
        popt = pcls(popsize=32, nInput=4, nOutput=2, model=pmodel,
                    distance_metric=None, device="cpu")
        # one compiled program: the same survival as the eager call, at
        # a fraction of its many small compilations
        js = jax.jit(jopt.initialize_state)(
            jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(y), jnp.asarray(bounds)
        )
        ps = popt.initialize_state(
            torch.Generator().manual_seed(0), torch.as_tensor(x), torch.as_tensor(y),
            torch.as_tensor(bounds, dtype=torch.float32),
        )
        np.testing.assert_array_equal(
            ps.population_parm.numpy(), np.asarray(js.population_parm)
        )


def _archive(seed, feasible=True):
    """A seeded archive with repeated rows, epochs and constraints."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(40, 3)).astype(np.float32)
    x[[30, 31]] = x[[2, 5]]
    t = rng.uniform(size=40)
    # float32 objectives, as the archive holds them and as the JAX
    # package's sort sees them
    y = np.column_stack([t, 1.0 - t + 0.3 * rng.uniform(size=40)]).astype(np.float32)
    y[[30, 31]] = y[[2, 5]]
    c = rng.normal(size=(40, 2)) + (0.5 if feasible else -10.0)
    epochs = rng.integers(0, 3, 40)
    f = rng.normal(size=(40, 1))
    return x, y, f, c, epochs


@pytest.mark.parametrize("feasible", [True, False])
def test_get_feasible_equals_jax(feasible):
    x, y, f, c, epochs = _archive(7, feasible)
    want = jax_moasmo.get_feasible(x, y, f, c, 3, 2, epochs=epochs)
    got = port_moasmo.get_feasible(x, y, f, c, 3, 2, epochs=epochs, device="cpu")
    for a, b in zip(got[0], want[0]):
        np.testing.assert_array_equal(a, b)
    for part in (1, 2):
        for a, b in zip(got[part], want[part]):
            if a.dtype == object:
                for u, v in zip(a, b):
                    np.testing.assert_array_equal(u, v)
            else:
                np.testing.assert_array_equal(a, b)
    for u, v in zip(got[3].ravel(), want[3].ravel()):
        np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("epsilons", [None, "auto", 0.05, [0.1, 0.02]])
@pytest.mark.parametrize("feasible", [True, False])
def test_epsilon_get_best_equals_jax(epsilons, feasible):
    x, y, f, c, _ = _archive(8, feasible)
    want = jax_moasmo.epsilon_get_best(x, y, f, c, epsilons=epsilons)
    got = port_moasmo.epsilon_get_best(x, y, f, c, epsilons=epsilons, device="cpu")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
