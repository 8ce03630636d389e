"""The port's large-archive reroute, mean-variance optimization and
surrogate-accuracy log against the JAX package's.

- `_route_large_n` gives the JAX package's answer for every registry name,
  an import path and a class, at N below, at and above the threshold, and
  with the threshold off (None, 0).
- `train` past ``large_n_threshold`` fits the sparse class, keeps and
  drops the kwargs the JAX package's `train` keeps and drops (its log
  lines, word for word; tests/test_gp.py:181-215's case), and names the
  routed class in ``info["surrogate"]``; every dense-kernel name
  reroutes, egp and megp included.
- Small `run()`s with ``svgp`` and ``mdgp``, and with
  ``optimize_mean_variance=True`` (4 prediction columns for 2
  objectives), on the CPU.
- `_log_surrogate_accuracy` logs the JAX package's line for the same
  evaluations, feasible rows and mean columns only.
"""

import logging

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import dmosopt_tpu_torch
from dmosopt_tpu import config as jax_config
from dmosopt_tpu import moasmo as jax_moasmo
from dmosopt_tpu.driver import DistOptimizer as JaxDistOptimizer
from dmosopt_tpu.models import svgp as jax_svgp
from dmosopt_tpu_torch import config as port_config
from dmosopt_tpu_torch import moasmo as port_moasmo
from dmosopt_tpu_torch.benchmarks.zdt import zdt1
from dmosopt_tpu_torch.driver import DistOptimizer as PortDistOptimizer
from dmosopt_tpu_torch.driver import dopt_dict
from dmosopt_tpu_torch.models import svgp as port_svgp


class _Recorder(logging.Handler):
    def __init__(self):
        super().__init__(logging.DEBUG)
        self.lines = []

    def emit(self, record):
        self.lines.append((record.levelname, record.getMessage()))


def _logger(name):
    log = logging.getLogger(name)
    log.setLevel(logging.DEBUG)
    log.propagate = False
    log.handlers = [_Recorder()]
    return log


NAMES = sorted(jax_config.default_surrogate_methods) + [
    "dmosopt_tpu.models.gp.GPR_Matern", port_svgp.SVGP_Matern,
]


def test_the_registries_name_the_same_surrogates():
    assert sorted(port_config.default_surrogate_methods) == sorted(
        jax_config.default_surrogate_methods)
    for name in port_config.default_surrogate_methods:
        cls = port_config.resolve(name, port_config.default_surrogate_methods)
        assert cls.__name__ == jax_config.default_surrogate_methods[name].rpartition(".")[2]


@pytest.mark.parametrize("name", NAMES, ids=lambda n: getattr(n, "__name__", n))
def test_route_large_n_matches_jax(name):
    for threshold in (4096, 32, None, 0):
        for n in (1, 32, 33, 4096, 4097, 10_000):
            assert port_moasmo._route_large_n(name, n, threshold) == \
                jax_moasmo._route_large_n(name, n, threshold), (name, n, threshold)


def _train_inputs():
    rng = np.random.default_rng(3)
    X = rng.random((64, 3))
    return X, np.stack([X[:, 0], X.sum(axis=1)], axis=1)


KWARGS = {
    "large_n_threshold": 32,
    # exact-GP knobs: dropped on reroute
    "n_starts": 4, "length_scale_bounds": (1e-2, 10.0), "dtype": "float32",
    # shared and sparse knobs: forwarded
    "n_iter": 20, "min_inducing": 8, "inducing_fraction": 0.1, "batch_size": 32,
}


def test_train_reroutes_and_filters_kwargs_as_jax(monkeypatch):
    """The JAX package's sparse fit is replaced by a stub (its trainer is
    not what this compares); both trains see the same rows and kwargs."""
    X, Y = _train_inputs()

    class _StubFit:
        elbo = 0.0

    monkeypatch.setattr(jax_svgp, "fit_svgp", lambda *a, **k: _StubFit())
    jlog, plog = _logger("jax_train"), _logger("port_train")
    jinfo, pinfo = {}, {}
    jm = jax_moasmo.train(3, 2, np.zeros(3), np.ones(3), X, Y, None,
                          surrogate_method_name="gpr", surrogate_method_kwargs=dict(KWARGS),
                          logger=jlog, info=jinfo)
    pm = port_moasmo.train(3, 2, np.zeros(3), np.ones(3), X, Y, None,
                           surrogate_method_name="gpr", surrogate_method_kwargs=dict(KWARGS),
                           logger=plog, info=pinfo, device="cpu")
    assert type(jm).__name__ == type(pm).__name__ == "SVGP_Matern"
    assert jlog.handlers[0].lines == plog.handlers[0].lines
    assert pinfo["surrogate"] == jinfo["surrogate"] == "svgp"
    assert pinfo["n_train"] == 64 and pinfo["fit_n_steps"] == 20
    assert pm.fit_info["n_inducing"] == 8  # max(int(0.1 * 64), 8)
    mean, _ = pm.predict(X[:5])
    assert bool(torch.isfinite(mean).all())


@pytest.mark.parametrize("name", sorted(port_moasmo._DENSE_KERNEL_SURROGATES))
def test_every_dense_name_reroutes_past_the_threshold(name):
    """egp, megp, mdgp, mdspp and vgp reroute as gpr does; below the
    threshold the name is fitted as given."""
    X, Y = _train_inputs()
    info = {}
    m = port_moasmo.train(3, 2, np.zeros(3), np.ones(3), X, Y, None,
                          surrogate_method_name=name,
                          surrogate_method_kwargs={"large_n_threshold": 63, "n_iter": 3},
                          info=info, device="cpu")
    assert isinstance(m, port_svgp.SVGP_Matern) and info["surrogate"] == "svgp"
    assert not hasattr(m, "build_predictor")
    info = {}
    m = port_moasmo.train(3, 2, np.zeros(3), np.ones(3), X, Y, None,
                          surrogate_method_name=name,
                          surrogate_method_kwargs={"large_n_threshold": 64, "n_iter": 3},
                          info=info, device="cpu")
    assert info["surrogate"] == name
    assert type(m).__name__ == jax_config.default_surrogate_methods[name].rpartition(".")[2]


def _run_params(opt_id, name, kw, **over):
    params = {
        "opt_id": opt_id, "obj_fun": zdt1, "torch_objective": True,
        "space": {f"x{i}": [0.0, 1.0] for i in range(6)}, "problem_parameters": {},
        "objective_names": ["f1", "f2"], "population_size": 16, "num_generations": 10,
        "n_initial": 5, "n_epochs": 2, "optimizer_name": "nsga2",
        "surrogate_method_name": name, "surrogate_method_kwargs": kw, "random_seed": 0,
    }
    params.update(over)
    return params


@pytest.mark.parametrize(
    "name,kw,over",
    [("svgp", {"n_iter": 40, "min_inducing": 10, "seed": 0}, {}),
     ("mdgp", {"n_iter": 40, "hidden": (8, 8), "seed": 0}, {}),
     ("svgp", {"n_iter": 40, "min_inducing": 10, "seed": 0},
      {"optimize_mean_variance": True, "optimizer_name": "age"})],
    ids=["svgp", "mdgp", "svgp-mean-variance"],
)
def test_small_runs_with_the_new_surrogates(name, kw, over):
    """pop 16, 10 generations, 2 epochs, ZDT1 dim 6 on the CPU: each epoch
    names its surrogate, the second logs the first fit's accuracy on the
    rows it resampled, the archive is distinct and finite, the returned
    set non-dominated; with mean-variance the EA ranked 4 columns and
    the resampled rows carry 4 prediction columns."""
    opt_id = f"new_surrogate_{name}_{len(over)}"
    best = dmosopt_tpu_torch.run(_run_params(opt_id, name, kw, **over), device="cpu",
                                 verbose=False)
    dopt = dopt_dict[opt_id]
    stats = dopt.epoch_stats
    assert [s["surrogate"] for s in stats] == [name] * 2
    assert "surrogate_accuracy" not in stats[0]
    acc = stats[1]["surrogate_accuracy"]
    assert acc["fit_epoch"] == 0 and acc["n_rows"] == 4
    assert all(np.isfinite(acc["mae"]))
    strat = dopt.optimizer_dict[0]
    x_all, y_all = strat.get_evals()
    assert np.all(np.isfinite(x_all)) and np.all(np.isfinite(y_all))
    assert np.unique(x_all, axis=0).shape[0] == x_all.shape[0]
    y = np.column_stack([v for _, v in best[1]])
    le = np.all(y[:, None] <= y[None], axis=2)
    lt = np.any(y[:, None] < y[None], axis=2)
    assert not np.any(le & lt)
    pred = strat.folded_evals[2]
    width = 4 if over.get("optimize_mean_variance") else 2
    assert pred.shape == (4, width) and np.all(np.isfinite(pred))
    if width == 4:
        assert np.all(pred[:, 2:] >= 0.0)


def test_accuracy_log_matches_jax():
    """Constrained rows: the infeasible ones are left out; a NaN
    prediction leaves its cell out; mean-variance predictions count by
    their mean columns."""
    rng = np.random.default_rng(0)
    y = rng.random((6, 2))
    pred = np.hstack([y + rng.normal(0.0, 0.1, size=y.shape), rng.random((6, 2))])
    pred[1, 0] = np.nan
    c = np.ones((6, 1))
    c[4] = -1.0
    evals = (rng.random((6, 3)), y, pred, None, c)
    jlog, plog = _logger("jax_acc"), _logger("port_acc")
    j_self = type("J", (), {"logger": jlog})()
    p_self = type("P", (), {"logger": plog})()
    JaxDistOptimizer._log_surrogate_accuracy(j_self, 0, 3, evals)
    out = PortDistOptimizer._log_surrogate_accuracy(p_self, 0, 3, evals)
    assert plog.handlers[0].lines == jlog.handlers[0].lines
    keep = np.arange(6) != 4
    err = np.abs(y - pred[:, :2])[keep]
    assert out["mae"][0] == pytest.approx(np.nanmean(err[:, 0]))
    assert out["n_rows"] == 5 and out["fit_epoch"] == 3


@pytest.mark.parametrize("optimizer", ["nsga2", "age", "smpso", "cmaes", "trs"])
def test_mean_variance_runs_with_every_optimizer(optimizer):
    """Every optimizer the JAX package takes ``optimize_mean_variance`` for
    keeps ``nOutput`` at 2 while it ranks 4 columns (pop 16, 5
    generations, 2 epochs, `gpr` at 2 starts and 20 steps); the
    resampled rows carry 4 finite prediction columns."""
    opt_id = f"mean_variance_{optimizer}"
    dmosopt_tpu_torch.run(
        _run_params(opt_id, "gpr", {"n_starts": 2, "n_iter": 20, "seed": 0},
                    num_generations=5, optimizer_name=optimizer,
                    optimize_mean_variance=True),
        device="cpu", verbose=False)
    dopt = dopt_dict[opt_id]
    pred = dopt.optimizer_dict[0].folded_evals[2]
    assert pred.shape[1] == 4 and np.all(np.isfinite(pred)) and np.all(pred[:, 2:] >= 0)
    assert len(dopt.epoch_stats[1]["surrogate_accuracy"]["mae"]) == 2
