"""Surrogate model container and the surrogate families.

Port of ``dmosopt_tpu/models/__init__.py``: `Model` bundles the
sub-models an epoch trains (reference: dmosopt/model.py:70-95). The
exact-GP family is in `gp`, the sparse variational family in `svgp`,
the deep-kernel GPs in `deep_gp`.
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


from dmosopt_tpu_torch.models.gp import (  # noqa: E402,F401
    GPR_Matern,
    GPR_RBF,
    EGP_Matern,
    MEGP_Matern,
)
from dmosopt_tpu_torch.models.svgp import (  # noqa: E402,F401
    CRV_Matern,
    SIV_Matern,
    SPV_Matern,
    SVGP_Matern,
    VGP_Matern,
)
from dmosopt_tpu_torch.models.deep_gp import (  # noqa: E402,F401
    MDGP_Matern,
    MDSPP_Matern,
)
