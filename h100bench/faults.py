"""Faults planted under a run, for the readings that set the limits and
for the tests that see ``correct`` come out false.

Each is a context manager that breaks one part of the timed path for its
duration, and puts it back after:

- ``step_unchanged``: a service step returns without advancing a tenant;
- ``fit_unchanged``: the GP fit's Adam step leaves the hyperparameters
  where they were (the fit ends at its random restarts);
- ``ea_unchanged``: the inner EA's survival returns the state it was
  given (NSGA-II and AGE-MOEA);
- ``half_batch``: the objective's batch is evaluated for its first half
  only, and the rest get that half's mean;
- ``answer_altered``: the non-dominated set the program hands back has
  one objective value moved by 1e-3 where it is produced.

No cell here spans chips, so none leaves out an exchange between them.
"""

from __future__ import annotations

import contextlib

import numpy as np


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def step_unchanged():
    from dmosopt_tpu_torch.service import OptimizationService

    return _patched(OptimizationService, "step", lambda self: 0)


def fit_unchanged():
    from dmosopt_tpu_torch.models import gp

    return _patched(gp._Adam, "update", lambda self, params, grads: list(params))


@contextlib.contextmanager
def ea_unchanged():
    from dmosopt_tpu_torch.optimizers.agemoea import AGEMOEA
    from dmosopt_tpu_torch.optimizers.nsga2 import NSGA2

    keep = lambda self, state, x_gen, y_gen: state  # noqa: E731
    with _patched(NSGA2, "update_strategy", keep), _patched(AGEMOEA, "update_strategy", keep):
        yield


def half_batch():
    import torch
    from dmosopt_tpu_torch.parallel.evaluator import TorchBatchEvaluator

    orig = TorchBatchEvaluator._call

    def call(self, x):
        outs = orig(self, x)
        h = max(1, x.shape[0] // 2)
        return tuple(torch.cat([o[:h], o[:h].mean(0, keepdim=True).expand_as(o[h:])])
                     for o in outs)

    return _patched(TorchBatchEvaluator, "_call", call)


def answer_altered():
    from dmosopt_tpu_torch import moasmo

    orig = moasmo.get_best

    def get_best(*a, **k):
        out = list(orig(*a, **k))
        y = np.array(out[1], dtype=np.float64, copy=True)
        if y.size:
            y[0, 0] += 1e-3
        out[1] = y
        return tuple(out)

    return _patched(moasmo, "get_best", get_best)


FAULTS = {f.__name__: f for f in (step_unchanged, fit_unchanged, ea_unchanged,
                                   half_batch, answer_altered)}
