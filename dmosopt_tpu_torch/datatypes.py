"""Core data model: nested parameter spaces, problem spec, evaluation records.

Port of ``dmosopt_tpu/datatypes.py`` (numpy only, copied): the nested
`ParameterSpace` with sorted-key flattening and dotted paths,
`OptProblem`, and the evaluation request/entry records of the reference
data model (dmosopt/datatypes.py:52-375).
"""

from __future__ import annotations

from collections import namedtuple
from dataclasses import dataclass, field
from enum import IntEnum
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np


@dataclass
class ParameterValue:
    """A fixed parameter value (leaf of a value-only space)."""

    value: float
    is_integer: bool = False
    name: Optional[str] = None


@dataclass
class ParameterDefn:
    """Range and type for one parameter (reference: dmosopt/datatypes.py:38-48)."""

    lower: float
    upper: float
    is_integer: bool = False
    name: Optional[str] = None

    def __post_init__(self):
        if self.lower > self.upper:
            self.lower, self.upper = self.upper, self.lower


Leaf = Union[ParameterDefn, ParameterValue]


@dataclass
class ParameterSpace:
    """Nested parameter space with deterministic (sorted-key) flattening:
    depth-first over sorted keys, as the reference does
    (dmosopt/datatypes.py:66-81)."""

    ranges: Dict[str, Union[Leaf, "ParameterSpace"]] = field(default_factory=dict)
    _flat: List[Leaf] = field(default_factory=list, init=False)
    _paths: Dict[str, List[str]] = field(default_factory=dict, init=False)

    def __post_init__(self):
        self._flatten("")

    def _flatten(self, prefix: str) -> None:
        self._flat = []
        self._paths = {}
        for name in sorted(self.ranges):
            item = self.ranges[name]
            path = f"{prefix}.{name}" if prefix else name
            if isinstance(item, (ParameterDefn, ParameterValue)):
                item.name = path
                self._flat.append(item)
                self._paths[path] = path.split(".")
            elif isinstance(item, ParameterSpace):
                item._flatten(path)
                self._flat.extend(item._flat)
                self._paths.update(item._paths)
            else:
                raise ValueError(f"unexpected item in parameter space: {item!r}")

    @classmethod
    def from_dict(cls, config: Dict, is_value_only: bool = False) -> "ParameterSpace":
        """Build a space from a nested dict; leaves are `[lo, hi, is_integer?]`
        lists (ranges) or bare numbers (values, when ``is_value_only``)."""

        def parse(x):
            if isinstance(x, (list, tuple)):
                return ParameterDefn(
                    lower=float(x[0]),
                    upper=float(x[1]),
                    is_integer=bool(x[2]) if len(x) > 2 else False,
                )
            if isinstance(x, (int, float, np.floating, np.integer)) and is_value_only:
                return ParameterValue(
                    value=float(x), is_integer=isinstance(x, (int, np.integer))
                )
            if isinstance(x, dict):
                return cls(ranges={k: parse(v) for k, v in x.items()})
            raise ValueError(f"unexpected value type in parameter space: {type(x)}")

        out = parse(config)
        if not isinstance(out, ParameterSpace):
            raise ValueError("top-level parameter space config must be a dict")
        return out

    @property
    def is_value_space(self) -> bool:
        return all(isinstance(r, ParameterValue) for r in self._flat)

    @property
    def parameter_values(self) -> np.ndarray:
        if not self.is_value_space:
            raise ValueError("not a value-only parameter space")
        return np.asarray([p.value for p in self._flat])

    @property
    def parameter_names(self) -> List[str]:
        return [p.name for p in self._flat]

    @property
    def items(self) -> List[Leaf]:
        return list(self._flat)

    @property
    def n_parameters(self) -> int:
        return len(self._flat)

    @property
    def bound1(self) -> np.ndarray:
        if self.is_value_space:
            raise ValueError("cannot get bounds from value-only parameter space")
        return np.asarray([p.lower for p in self._flat])

    @property
    def bound2(self) -> np.ndarray:
        if self.is_value_space:
            raise ValueError("cannot get bounds from value-only parameter space")
        return np.asarray([p.upper for p in self._flat])

    def flatten(self, params: Dict) -> np.ndarray:
        """Nested parameter dict -> flat array in canonical order."""
        out = np.zeros(self.n_parameters)
        for i, p in enumerate(self._flat):
            cur = params
            path = self._paths[p.name]
            for key in path[:-1]:
                cur = cur[key]
            out[i] = cur[path[-1]]
        return out

    def unflatten(self, flat_params: Optional[Sequence[float]] = None) -> Dict:
        """Flat array -> nested parameter dict."""
        if flat_params is None:
            return self.unflatten(self.parameter_values)
        params: Dict[str, Any] = {}
        for i, p in enumerate(self._flat):
            cur = params
            path = self._paths[p.name]
            for key in path[:-1]:
                cur = cur.setdefault(key, {})
            cur[path[-1]] = flat_params[i]
        return params


class StrategyState(IntEnum):
    EnqueuedRequests = 1
    WaitingRequests = 2
    CompletedEpoch = 3


EvalEntry = namedtuple(
    "EvalEntry",
    ["epoch", "parameters", "objectives", "features", "constraints", "prediction", "time"],
    defaults=[None, None, None, None, None, None, -1.0],
)

EvalRequest = namedtuple("EvalRequest", ["parameters", "prediction", "epoch"])

OptHistory = namedtuple("OptHistory", ["n_gen", "n_eval", "x", "y", "c"])

EpochResults = namedtuple(
    "EpochResults", ["best_x", "best_y", "gen_index", "x", "y", "optimizer"]
)


class OptProblem:
    """Optimization problem spec (reference: dmosopt/datatypes.py:308-353)."""

    __slots__ = (
        "dim", "lb", "ub", "param_names", "objective_names",
        "constraint_names", "n_objectives", "n_constraints",
    )

    def __init__(
        self,
        param_names: Sequence[str],
        objective_names: Sequence[str],
        constraint_names,
        spec: ParameterSpace,
    ):
        self.dim = len(spec.bound1)
        if self.dim <= 0:
            raise ValueError("empty parameter space")
        self.lb, self.ub = spec.bound1, spec.bound2
        self.param_names = list(param_names)
        self.objective_names = list(objective_names)
        self.n_objectives = len(objective_names)
        self.constraint_names = constraint_names
        self.n_constraints = (
            len(constraint_names) if constraint_names is not None else None
        )


def update_nested_dict(base: Dict, update: Dict) -> Dict:
    """Recursive dict merge (reference: dmosopt/datatypes.py:356-375)."""
    result = base.copy()
    for key, value in update.items():
        if key in result and isinstance(result[key], dict) and isinstance(value, dict):
            result[key] = update_nested_dict(result[key], value)
        else:
            result[key] = value
    return result
