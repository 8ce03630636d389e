"""Several problems, features and the run's hooks: the port against the
JAX package.

- Three problems with ``feature_dtypes`` (structured records) or a
  ``feature_class``: after the initial design is evaluated through the
  multi-problem host wrapper, both drivers hold the same problems, the
  same archive rows and float64-equal feature columns (the design is
  the same numpy draw in both and the objective is deterministic), and
  `get_best(return_features=True)` returns per problem the same rows
  with records of the same names and shapes. A whole port run returns
  each problem's best set with its features, by `run(return_features=
  True)`, and with a torch objective evaluated once per problem.
- ``surrogate_custom_training`` gets the same ``options`` dict and the
  same arguments in both packages' epoch engines, and the model it
  returns is the one the port's epoch predicts with.
- An external ``evaluator=`` is used and `run()` does not close it.
- `pairwise_distances` against the JAX function at the tolerance the
  reference meets against exact distances (rtol 1e-4, atol 1e-5;
  ROADMAP.md Queue 3, "Reference caveats").
- The options the port still lacks raise; the ported ones do not.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

torch.set_num_threads(1)

import dmosopt_tpu.driver as jax_driver
from dmosopt_tpu import moasmo as jax_moasmo
from dmosopt_tpu.ops import pairwise_distances as jax_pairwise

import dmosopt_tpu_torch
import dmosopt_tpu_torch.driver as port_driver
from dmosopt_tpu_torch import moasmo as port_moasmo
from dmosopt_tpu_torch.benchmarks.zdt import zdt1
from dmosopt_tpu_torch.ops import pairwise_distances
from dmosopt_tpu_torch.parallel.evaluator import TorchBatchEvaluator

DIM = 4
PROBLEMS = {0, 1, 2}
FEATURES = [("x_sum", "<f8"), ("g", "<f8")]


def _zdt1(x):
    g = 1.0 + 9.0 / (DIM - 1) * np.sum(x[1:])
    return np.array([x[0], g * (1.0 - np.sqrt(x[0] / g))]), g


def problems_obj(mpp):
    """Each problem's ZDT1 of its parameter dict, shifted by its id, with
    a structured feature record."""
    out = {}
    for pid, pp in mpp.items():
        x = np.array([pp[f"x{i}"] for i in range(DIM)])
        y, g = _zdt1(x)
        out[pid] = (y + pid, np.array([(x.sum(), g + pid)], dtype=FEATURES))
    return out


def feature_rows(F):
    """A ``feature_class``: the flat float columns as a (rows, 2) array."""
    return None if F is None else np.atleast_2d(np.asarray(F, np.float64))


def _params(opt_id, **over):
    params = {
        "opt_id": opt_id, "obj_fun": problems_obj, "problem_ids": set(PROBLEMS),
        "space": {f"x{i}": [0.0, 1.0] for i in range(DIM)}, "problem_parameters": {},
        "objective_names": ["f1", "f2"], "feature_dtypes": FEATURES,
        "population_size": 16, "num_generations": 5, "n_initial": 3, "n_epochs": 2,
        "surrogate_method_kwargs": {"n_starts": 2, "n_iter": 20, "seed": 0},
        "random_seed": 5,
    }
    params.update(over)
    return params


def _designed(pkg, params):
    """A driver with every problem's initial design evaluated and folded."""
    if pkg == "jax":
        dopt = jax_driver.dopt_init({**params, "telemetry": False}, initialize_strategy=True)
    else:
        dopt = port_driver.dopt_init({**params, "device": "cpu"}, initialize_strategy=True)
    dopt._process_requests()
    for pid in PROBLEMS:
        dopt.optimizer_dict[pid]._update_evals()
    return dopt


@pytest.mark.parametrize("feature_class", [None, "test_torch_problems.feature_rows"])
def test_three_problems_with_features_match_jax(feature_class):
    over = {} if feature_class is None else {"feature_class": feature_class}
    jd = _designed("jax", _params("problems_jax", **over))
    pd = _designed("torch", _params("problems_port", **over))
    assert pd.problem_ids == jd.problem_ids == PROBLEMS and pd.has_problem_ids
    assert pd.feature_names == jd.feature_names == ["x_sum", "g"]
    for pid in PROBLEMS:
        js, ps = jd.optimizer_dict[pid], pd.optimizer_dict[pid]
        np.testing.assert_array_equal(ps.x, js.x)
        np.testing.assert_array_equal(ps.y, js.y)
        assert ps.f.dtype == js.f.dtype == np.float64
        np.testing.assert_array_equal(ps.f, js.f)
        np.testing.assert_allclose(ps.f[:, 1] - pid, [_zdt1(x)[1] for x in ps.x], rtol=1e-12)
    jbest = jd.get_best(return_features=True)
    pbest = pd.get_best(return_features=True)
    assert sorted(pbest) == sorted(jbest) == sorted(PROBLEMS)
    for pid in PROBLEMS:
        (jp, jy, jf), (pp, py, pf) = jbest[pid], pbest[pid]
        assert [n for n, _ in pp] == [n for n, _ in jp]
        # the JAX package hands its best objectives back in float32
        np.testing.assert_allclose(np.column_stack([v for _, v in py]),
                                   np.column_stack([v for _, v in jy]), rtol=1e-6)
        assert type(pf) is type(jf) and pf.shape == jf.shape
        assert pf.dtype.names == jf.dtype.names
        np.testing.assert_array_equal(pf, jf)


def _features_obj(x):
    """A batched torch objective with features: ZDT1 and (sum, g)."""
    g = 1.0 + 9.0 / (x.shape[1] - 1) * x[:, 1:].sum(dim=1)
    return zdt1(x), torch.stack([x.sum(dim=1), g], dim=1)


class CountingEvaluator(TorchBatchEvaluator):
    """A caller's evaluator: counts its batches and any close."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.batches = self.closed = 0

    def submit_batch(self, *a, **k):
        self.batches += 1
        return super().submit_batch(*a, **k)

    def close(self):
        self.closed += 1


def test_run_returns_features_per_problem_through_a_callers_evaluator():
    evaluator = CountingEvaluator(_features_obj, "cpu", problem_ids=sorted(PROBLEMS))
    best = dmosopt_tpu_torch.run(
        _params("problems_run", obj_fun=_features_obj, evaluator=evaluator,
                tenant_batching=True),
        device="cpu", verbose=False, return_features=True,
    )
    assert evaluator.batches > 0 and evaluator.closed == 0
    dopt = port_driver.dopt_dict["problems_run"]
    assert [set(s["routing"].values()) for s in dopt.epoch_stats] == [{"batched"}] * 2
    assert sorted(best) == sorted(PROBLEMS)
    for pid, (prms, res, ftrs) in best.items():
        x = np.column_stack([v for _, v in prms])
        assert ftrs.dtype.names == ("x_sum", "g") and ftrs.shape == (x.shape[0],)
        np.testing.assert_allclose(ftrs["x_sum"], x.sum(axis=1), rtol=1e-6)
        x_all, _, f_all = dopt.optimizer_dict[pid].get_evals(return_features=True)
        assert f_all.shape == (x_all.shape[0],)
    stats = dopt.get_stats()
    assert all(f"{pid}_n_generations" in stats for pid in PROBLEMS)


# ------------------------------------------------------------- the hooks


class _Recorded(Exception):
    pass


HOOK_CALLS = []


def recording_hook(optimizer_cls, Xinit, Yinit, C, xlb, xub, file_path, options=None,
                   **kwargs):
    """Records what it was handed, then stops the epoch."""
    HOOK_CALLS.append((optimizer_cls.__name__, np.asarray(Xinit).shape, C,
                       list(np.asarray(xlb)), file_path, dict(options), dict(kwargs)))
    raise _Recorded()


class CountingModel:
    """The model a hook returns: a port `gpr` fit counting its evaluations."""

    def __init__(self, sm):
        self.sm, self.calls = sm, 0
        self.return_mean_variance = False

    def evaluate(self, x):
        self.calls += 1
        return self.sm.evaluate(x)

    def get_stats(self):
        return {"counting_model": True}


HOOK_MODELS = []


def counting_hook(optimizer_cls, Xinit, Yinit, C, xlb, xub, file_path, options=None,
                  **kwargs):
    from dmosopt_tpu_torch.models.gp import GPR_Matern

    sm = GPR_Matern(Xinit, Yinit, len(xlb), Yinit.shape[1], xlb, xub, device="cpu",
                    **{**options["surrogate_method_kwargs"], **kwargs})
    HOOK_MODELS.append(CountingModel(sm))
    return optimizer_cls, HOOK_MODELS[-1], None, None


def test_custom_training_gets_the_same_options_and_its_model_is_used():
    rng = np.random.default_rng(0)
    X, Y = rng.random((12, DIM)), rng.random((12, 2))
    common = dict(
        pop=16, optimizer_name="nsga2", optimizer_kwargs={"mutation_prob": 0.2},
        surrogate_method_name="gpr", surrogate_method_kwargs={"n_iter": 5},
        surrogate_custom_training="test_torch_problems.recording_hook",
        surrogate_custom_training_kwargs={"lr": 0.5}, file_path="run.h5",
    )
    names = [f"x{i}" for i in range(DIM)]
    for engine, extra in ((jax_moasmo, {}), (port_moasmo, {"device": "cpu"})):
        gen = engine.epoch(5, names, ["f1", "f2"], np.zeros(DIM), np.ones(DIM), 0.5,
                           X, Y, None, **common, **extra)
        with pytest.raises(_Recorded):
            next(gen)
    assert len(HOOK_CALLS) == 2 and HOOK_CALLS[0] == HOOK_CALLS[1], HOOK_CALLS
    assert HOOK_CALLS[0][5]["surrogate_method_kwargs"] == {"n_iter": 5}
    # the hook's model serves the port's epoch: it predicts the resamples
    gen = port_moasmo.epoch(
        5, names, ["f1", "f2"], np.zeros(DIM), np.ones(DIM), 0.5, X, Y, None,
        **{**common, "surrogate_custom_training": "test_torch_problems.counting_hook"},
        device="cpu",
    )
    with pytest.raises(StopIteration) as stop:
        next(gen)
    res, model = stop.value.value, HOOK_MODELS[-1]
    assert model.calls >= 1 + 5 and res["stats"]["objective"] == {"counting_model": True}
    # the resampled rows the EA made (an archive row keeps its evaluation)
    made = ~np.any(np.all(res["x_resample"][:, None] == X.astype(np.float32)[None], -1), 1)
    assert made.sum() > 0
    want = model.sm.evaluate(torch.as_tensor(res["x_resample"][made], dtype=torch.float32))
    np.testing.assert_allclose(res["y_pred"][made], want.numpy(), rtol=1e-6)


def test_pairwise_distances_match_jax():
    rng = np.random.default_rng(4)
    X = rng.random((37, 5)).astype(np.float32)
    Y = rng.random((21, 5)).astype(np.float32)
    want = np.asarray(jax_pairwise(jnp.asarray(X), jnp.asarray(Y)))
    for chunk in (None, 4, 10):
        got = pairwise_distances(torch.as_tensor(X), torch.as_tensor(Y), row_chunk=chunk)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    # Y defaults to X (the diagonal is the identity's cancellation, ~1e-3
    # in float32 in either package, so it is left out)
    off = ~np.eye(37, dtype=bool)
    got = pairwise_distances(torch.as_tensor(X)).numpy()[off]
    np.testing.assert_allclose(got, np.asarray(jax_pairwise(jnp.asarray(X)))[off],
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("option", [{"jax_objective": True}, {"mesh": object()},
                                    {"jax_objective": True, "mesh": object()}])
def test_options_not_ported_still_raise(option):
    # the error names every unported option it was given
    # (``stats_per_problem`` is ported: tests/test_torch_run.py; ``mesh``
    # is ported: a value that is not a mesh is refused by type)
    unported = sorted(set(option) - {"mesh"})
    with pytest.raises(NotImplementedError if unported else TypeError) as err:
        port_driver.DistOptimizer(**_params("x", **option), device="cpu")
    for name in unported or option:
        assert name in str(err.value)
    assert ("mesh" in str(err.value)) == (not unported)
