"""What the benchmark records of the program's work, from its own files.

- ``Audit`` keeps, for the calibrations the seed picks, every batch the
  objective was called with and what it returned, and each epoch's GP
  hyperparameters, marginal likelihood, resample batch and the surrogate
  means the inner EA gave that batch, and, in the tenant core, the EA's
  initial design. The reference judges them after the window.
- ``ServiceProbe`` wraps the tenant core's bucket epoch
  (``tenants.run_bucket_epoch``) and its batched fit
  (``tenants.fit_gp_problems``); ``RunProbe`` wraps the sequential
  epoch (``moasmo.epoch``) and its surrogate fit (``moasmo.train``).
  An epoch's record holds the fit's own training inputs (``GPFit.X``,
  its real rows), as the fit saw them. ``ServiceProbe.fit_steps`` keeps
  the Adam steps each bucket fit ran.
  Each records only audited calibrations' rows, as device clones or
  host copies, and adds no device synchronisation.
- ``OffspringProbe`` counts the fused offspring kernel's launches
  (``_variation_kernels.launch_offspring``) while a trace runs and keeps
  the operands of every ``every``-th, for the byte count.

Each probe is installed for one run and removed after it.
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, List, Optional

import numpy as np


class Audit:
    def __init__(self):
        self.seq = itertools.count()
        self.calls: Dict[int, List[tuple]] = {}
        self.epochs: Dict[int, List[Dict[str, Any]]] = {}
        self.key_of_pid: Dict[Any, int] = {}
        self.current: Optional[int] = None  # the run driver's calibration

    def objective(self, key: int, fn):
        """``fn`` recording its inputs and outputs under calibration ``key``."""
        self.calls[key] = []
        self.epochs[key] = []

        def recorded(x):
            y = fn(x)
            self.calls[key].append((next(self.seq), x.detach().clone(), y.detach().clone()))
            return y

        return recorded

    def add_epoch(self, key: int, fit, t: Optional[int], seq: int, res: Dict[str, Any],
                  x_init=None):
        pick = (lambda a: a[t]) if t is not None else (lambda a: a)
        X = pick(fit.X)
        mask = fit.train_mask
        if mask is not None:
            X = X[pick(mask) > 0]
        self.epochs[key].append({
            "seq": seq,
            "amp": pick(fit.amp).detach().clone(),
            "ls": pick(fit.ls).detach().clone(),
            "noise": pick(fit.noise).detach().clone(),
            "nmll": pick(fit.nmll).detach().clone(),
            "x_resample": np.array(res["x_resample"], dtype=np.float64),
            "y_pred": np.array(res["y_pred"], dtype=np.float64),
            "x_train": X.detach().clone(),
            "x_init": None if x_init is None else np.array(x_init, dtype=np.float64),
        })


class _Patch:
    """Replaces attributes of a module, and puts them back."""

    def __init__(self):
        self._undo = []

    def set(self, module, name, value):
        self._undo.append((module, name, getattr(module, name)))
        setattr(module, name, value)

    def remove(self):
        for module, name, value in reversed(self._undo):
            setattr(module, name, value)
        self._undo = []


class ServiceProbe(_Patch):
    def __init__(self, audit: Audit):
        super().__init__()
        from dmosopt_tpu_torch import tenants

        box: Dict[str, Any] = {}
        fit_orig, run_orig = tenants.fit_gp_problems, tenants.run_bucket_epoch
        self.fit_steps: List[int] = []  # Adam steps of each bucket fit, in order

        def fit_gp_problems(*a, **k):
            box["fit"] = out = fit_orig(*a, **k)
            self.fit_steps.append(int(out.n_steps) if out.n_steps is not None else -1)
            return out

        def run_bucket_epoch(plans, *a, **k):
            box.clear()
            seq = next(audit.seq)
            res = run_orig(plans, *a, **k)
            for t, p in enumerate(plans):
                key = audit.key_of_pid.get(p.pid)
                if key is not None:
                    audit.add_epoch(key, box["fit"], t, seq, res[p.pid], p.x_init)
            return res

        self.set(tenants, "fit_gp_problems", fit_gp_problems)
        self.set(tenants, "run_bucket_epoch", run_bucket_epoch)


class RunProbe(_Patch):
    def __init__(self, audit: Audit):
        super().__init__()
        from dmosopt_tpu_torch import moasmo

        box: Dict[str, Any] = {}
        train_orig, epoch_orig = moasmo.train, moasmo.epoch

        def train(*a, **k):
            box["model"] = sm = train_orig(*a, **k)
            box["seq"] = next(audit.seq)
            return sm

        def epoch(*a, **k):
            box.clear()
            res = yield from epoch_orig(*a, **k)
            key = audit.current
            if key is not None and "x_resample" in res and "model" in box:
                audit.add_epoch(key, box["model"].fit, None, box["seq"], res)
            return res

        self.set(moasmo, "train", train)
        self.set(moasmo, "epoch", epoch)


class OffspringProbe(_Patch):
    def __init__(self, every: int = 10):
        super().__init__()
        from dmosopt_tpu_torch.ops import _variation_kernels as K

        self.armed = False
        self.launches = 0  # launches while armed, in order
        self.samples: List[tuple] = []  # (armed launch index, args, tags)
        orig = K.launch_offspring

        def launch_offspring(*args):
            out = orig(*args)
            if self.armed:
                if self.launches % every == 0:
                    self.samples.append((self.launches, args, out[1]))
                self.launches += 1
            return out

        self.set(K, "launch_offspring", launch_offspring)
