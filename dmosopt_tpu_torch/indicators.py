"""Performance indicators: IGD, hypervolume, EHVI selection, diversity.

Port of ``dmosopt_tpu/indicators.py`` (after reference
`dmosopt/indicators.py`): the indicator class hierarchy with optional
zero-to-one pre-normalization, `IGD`, `Hypervolume`,
`HypervolumeImprovement` (EHVI candidate selection),
`PopulationDiversity` and `SlidingWindow`. These are host-side facades
over numpy arrays; the ranking and crowding they need run on CPU
tensors, and the hypervolume math is `dmosopt_tpu_torch.hv`, whose
estimators run on the ``device`` given in the keyword arguments (None
means CUDA; the exact paths need none).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from dmosopt_tpu_torch.hv import AdaptiveHyperVolume, HyperVolumeBoxDecomposition
from dmosopt_tpu_torch.ops import crowding_distance, euclidean_distance_metric  # noqa: F401
from dmosopt_tpu_torch.ops.dominance import non_dominated_rank


def crowding_distance_metric(Y) -> np.ndarray:
    """Host-friendly crowding distance (reference indicators.py:12-51)."""
    return crowding_distance(torch.as_tensor(np.asarray(Y), dtype=torch.float32)).numpy()


def _front0(F) -> np.ndarray:
    return non_dominated_rank(torch.as_tensor(np.asarray(F), dtype=torch.float32)).numpy() == 0


class SlidingWindow(list):
    """Bounded FIFO of recent metric values (reference indicators.py:129-144)."""

    def __init__(self, size: Optional[int] = None) -> None:
        super().__init__()
        self.size = size

    def append(self, entry):
        super().append(entry)
        if self.size is not None:
            while len(self) > self.size:
                self.pop(0)

    def is_full(self) -> bool:
        return self.size == len(self)


class _Normalization:
    """Zero-to-one normalization over [ideal, nadir] when enabled
    (reference indicators.py PreNormalization semantics)."""

    def __init__(self, zero_to_one=False, ideal=None, nadir=None):
        self.zero_to_one = zero_to_one
        self.ideal = np.asarray(ideal, dtype=np.float64) if ideal is not None else None
        self.nadir = np.asarray(nadir, dtype=np.float64) if nadir is not None else None

    def forward(self, F):
        if not self.zero_to_one or F is None:
            return F
        denom = np.where(
            self.nadir - self.ideal == 0.0, 1.0, self.nadir - self.ideal
        )
        return (np.asarray(F, dtype=np.float64) - self.ideal) / denom


def _derive_ideal_nadir(pf, ideal, nadir):
    if pf is not None:
        pf = np.atleast_2d(np.asarray(pf, dtype=np.float64))
        if ideal is None:
            ideal = pf.min(axis=0)
        if nadir is None:
            nadir = pf.max(axis=0)
    return ideal, nadir


class Indicator:
    def __init__(self, zero_to_one=False, ideal=None, nadir=None):
        self.ideal = ideal
        self.nadir = nadir
        self.normalization = _Normalization(zero_to_one, ideal, nadir)
        self.default_if_empty = 0.0

    def do(self, F, *args, **kwargs):
        F = np.asarray(F)
        if F.ndim == 1:
            F = F[None, :]
        if len(F) == 0:
            return self.default_if_empty
        return self._do(self.normalization.forward(F), *args, **kwargs)

    def _do(self, F, *args, **kwargs):  # pragma: no cover
        raise NotImplementedError


class IGD(Indicator):
    """Inverted generational distance to a known Pareto front
    (reference indicators.py:183-211)."""

    def __init__(self, pf, zero_to_one=False, ideal=None, nadir=None, **kwargs):
        pf = np.atleast_2d(np.asarray(pf, dtype=np.float64))
        ideal, nadir = _derive_ideal_nadir(pf, ideal, nadir)
        super().__init__(zero_to_one=zero_to_one, ideal=ideal, nadir=nadir)
        self.pf = self.normalization.forward(pf)

    def _do(self, F):
        D = np.linalg.norm(self.pf[:, None, :] - F[None, :, :], axis=2)
        return float(np.mean(np.min(D, axis=1)))


def _resolve_ref_point(ref_point, pf, normalization, norm_ref_point):
    if ref_point is None and pf is not None:
        ref_point = np.asarray(pf, dtype=np.float64).max(axis=0)
    if ref_point is not None and norm_ref_point:
        ref_point = normalization.forward(np.asarray(ref_point, dtype=np.float64))
    assert ref_point is not None, (
        "For Hypervolume a reference point needs to be provided!"
    )
    return ref_point


class Hypervolume(Indicator):
    """Hypervolume indicator with adaptive exact/MC routing
    (reference indicators.py:213-257)."""

    def __init__(
        self,
        ref_point=None,
        pf=None,
        nds=False,
        norm_ref_point=True,
        ideal=None,
        nadir=None,
        zero_to_one=False,
        **kwargs,
    ):
        ideal, nadir = _derive_ideal_nadir(pf, ideal, nadir)
        super().__init__(zero_to_one=zero_to_one, ideal=ideal, nadir=nadir)
        self.nds = nds
        self.ref_point = _resolve_ref_point(
            ref_point, pf, self.normalization, norm_ref_point
        )
        self._hv = AdaptiveHyperVolume(self.ref_point, **kwargs)

    def _do(self, F):
        if self.nds:
            F = F[_front0(F)]
        return self._hv.compute_hypervolume(F)


class HypervolumeImprovement(Indicator):
    """EHVI-based candidate selection (reference indicators.py:259-313):
    given the current front and candidate predictive Gaussians, returns
    the indices of the top-k candidates by expected HV improvement."""

    def __init__(
        self,
        ref_point=None,
        pf=None,
        nds=False,
        norm_ref_point=True,
        ideal=None,
        nadir=None,
        zero_to_one=False,
        **kwargs,
    ):
        ideal, nadir = _derive_ideal_nadir(pf, ideal, nadir)
        super().__init__(zero_to_one=zero_to_one, ideal=ideal, nadir=nadir)
        self.default_if_empty = []
        self.nds = nds
        self.ref_point = _resolve_ref_point(
            ref_point, pf, self.normalization, norm_ref_point
        )
        self._hv = HyperVolumeBoxDecomposition(
            self.ref_point, device=kwargs.get("device")
        )

    def _do(self, F, means, variances, k):
        assert k > 0
        assert len(F) > 0
        if self.nds:
            non_dom = _front0(F)
            if non_dom.any():
                F = F[non_dom]
        selection, _ = self._hv.select_candidates(F, means, variances, n_select=k)
        assert len(selection) > 0
        return np.asarray(selection, dtype=int)


class PopulationDiversity(Indicator):
    """Fraction of population on front 0 and crowding-distance spread
    (reference indicators.py:316-335)."""

    def _do(self, F, Y):
        F = np.asarray(F)
        front_0 = np.argwhere(F.flat == 0)
        diversity = len(front_0) / len(F.flat)
        D = crowding_distance_metric(Y)
        if len(front_0) > 1:
            cd_values = D[front_0.flat]
            finite = cd_values[np.isfinite(cd_values)]
            if len(finite) > 1 and np.mean(finite) != 0:
                cd_spread = float(np.std(finite) / np.mean(finite))
            else:
                cd_spread = 0.0
        else:
            cd_spread = 0.0
        return diversity, cd_spread
