"""Importable objective functions for fleet tenant specs.

Port of ``dmosopt_tpu/fleet/objectives.py``, unchanged (pure numpy).

A fleet tenant submission crosses a process boundary, so its objective
cannot be a closure — it is an ``objective_ref`` string
(``"package.module:attr"``, resolved by
`dmosopt_tpu_torch.utils.import_object` inside the worker). This module
hosts the stock host objectives the fleet tests submit; user fleets
point their specs at their own importable functions the same way.

Every function here is a *per-point host objective*: it receives the
parameter dict `eval_obj_fun_sp` builds (``{name: value}``) and
returns a float64 objective vector — pure numpy, so a tenant's
trajectory is bitwise-identical whether it runs in a worker
subprocess, the in-process reference service, or a post-migration
survivor.
"""

from __future__ import annotations

import numpy as np


def _vector(pp) -> np.ndarray:
    """Parameter dict -> float64 vector in x0..xN order (numeric-suffix
    sort, so x10 follows x9, not x1)."""
    names = sorted(pp, key=lambda n: (len(n), n))
    return np.asarray([pp[n] for n in names], dtype=np.float64)


def host_zdt1(pp) -> np.ndarray:
    """Pure-numpy ZDT1 at any dimension — the fleet testing workhorse
    (the same math as ``tests/_service_crash_worker.host_zdt1``,
    generalized over dim)."""
    x = _vector(pp)
    f1 = x[0]
    g = 1.0 + 9.0 * np.mean(x[1:])
    f2 = g * (1.0 - np.sqrt(f1 / g))
    return np.asarray([f1, f2], dtype=np.float64)


def host_zdt2(pp) -> np.ndarray:
    """Pure-numpy ZDT2 (non-convex front) — a second signature for
    mixed-bucket fleet scenarios."""
    x = _vector(pp)
    f1 = x[0]
    g = 1.0 + 9.0 * np.mean(x[1:])
    f2 = g * (1.0 - (f1 / g) ** 2)
    return np.asarray([f1, f2], dtype=np.float64)
