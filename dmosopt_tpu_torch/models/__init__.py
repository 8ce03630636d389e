"""Surrogate model container and the exact-GP surrogate.

Port of ``dmosopt_tpu/models/__init__.py``: `Model` bundles the
sub-models an epoch trains (reference: dmosopt/model.py:70-95).
"""

from __future__ import annotations

import time
from typing import Any, Optional


class Model:
    """Container for per-epoch sub-models (reference: dmosopt/model.py:70)."""

    def __init__(
        self,
        objective: Optional[Any] = None,
        feasibility: Optional[Any] = None,
        sensitivity: Optional[Any] = None,
        return_mean_variance: bool = False,
    ):
        self.objective = objective
        self.feasibility = feasibility
        self.sensitivity = sensitivity
        self.return_mean_variance = return_mean_variance
        self._timestamp = time.time()

    def get_stats(self):
        stats = {}
        for name in ("objective", "feasibility", "sensitivity"):
            sub = getattr(self, name)
            if sub is not None and hasattr(sub, "get_stats"):
                stats[name] = sub.get_stats()
        return stats


from dmosopt_tpu_torch.models.gp import GPR_Matern  # noqa: E402,F401
