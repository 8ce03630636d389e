"""Optimizer strategy framework.

Port of ``dmosopt_tpu/optimizers/base.py`` (`Struct`, `MOEA`,
`generate_initial`, `run_ea_loop`). The reference's stateful interface
(dmosopt/MOEA.py:55-188) stays: ``initialize_strategy`` / ``generate`` /
``update`` on the host side, over functions of an explicit state object
(``initialize_state`` / ``generate_strategy`` / ``update_strategy``).
Where the JAX package scans a generation under ``lax.scan``, the port
runs a Python loop of eager launches on the optimizer's device; all
randomness flows from one explicit `torch.Generator` on that device.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch

from dmosopt_tpu_torch import sampling
from dmosopt_tpu_torch.utils.device import resolve_device
from dmosopt_tpu_torch.utils.prng import as_torch_generator


class Struct:
    """Plain attribute bag for optimizer hyperparameters
    (reference: dmosopt/MOEA.py:26-52)."""

    def __init__(self, **items):
        self.__dict__.update(items)

    def update(self, items):
        self.__dict__.update(items)

    def items(self):
        return self.__dict__.items()

    def __call__(self):
        return dict(self.__dict__)

    def __getitem__(self, key):
        return self.__dict__[key]

    def __setitem__(self, key, val):
        self.__dict__[key] = val

    def __contains__(self, k):
        return k in self.__dict__

    def __repr__(self):
        return f"Struct({self.__dict__})"


class MOEA:
    """Base class for multi-objective evolutionary strategies.

    Subclasses implement:
      initialize_state(generator, x, y, bounds, mask=None) -> state
      generate_strategy(generator, state)   -> (x_gen, state)
      update_strategy(state, x_gen, y_gen)  -> state
      get_population_strategy(state)        -> (x, y)

    ``device`` is where the population lives (None means CUDA; see
    `utils.device.resolve_device`).
    """

    def __init__(self, name: str, popsize: int, nInput: int, nOutput: int,
                 device=None, **kwargs):
        self.name = name
        self.popsize = int(popsize)
        self.nInput = int(nInput)
        self.nOutput = int(nOutput)
        self.device = resolve_device(device)
        self.opt_params = Struct(**self.default_parameters)
        self.opt_params.update(
            {
                "popsize": self.popsize,
                "nInput": self.nInput,
                "nOutput": self.nOutput,
                "initial_size": self.popsize,
                "initial_sampling_method": None,
                "initial_sampling_method_params": None,
            }
        )
        for k, v in kwargs.items():
            if k not in self.opt_params or v is not None:
                self.opt_params[k] = v
        # static capacity; equals popsize unless adaptive population
        # sizing grows it (the live size is then the state's `n_active`)
        self.capacity = self.popsize
        self.state = None
        self.generator = None

    @property
    def default_parameters(self) -> Dict[str, Any]:
        return {}

    def n_offspring(self) -> int:
        """Offspring emitted per generation: ``capacity // 2`` pair slots
        of two children each (the fixed-batch scheme of NSGA-II and
        AGE-MOEA)."""
        return 2 * (self.capacity // 2)

    @property
    def opt_parameters(self) -> Dict[str, Any]:
        """The hyperparameters as a plain dict (what the store saves)."""
        return self.opt_params()

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a,
                               dtype=torch.float32, device=self.device)

    # ------------------------------------------------------------- host API

    def initialize_strategy(self, x, y, bounds, random=None, **params):
        """Initialize from evaluated points. ``bounds`` is (n, 2)."""
        self.bounds = self._tensor(bounds)
        self.generator = as_torch_generator(random, self.device)
        self.state = self.initialize_state(
            self.generator, self._tensor(x), self._tensor(y), self.bounds
        )
        return self.state

    def generate(self, **params):
        """One generation of candidates, clipped to bounds."""
        x, state = self.generate_strategy(self.generator, self.state)
        x = torch.clamp(x, self.bounds[:, 0], self.bounds[:, 1])
        self.state = state
        return x, state

    def update(self, x, y, state=None, **params):
        self.state = self.update_strategy(
            state if state is not None else self.state,
            self._tensor(x),
            self._tensor(y),
        )
        return self.state

    @property
    def population_objectives(self):
        return self.get_population_strategy(self.state)

    def generate_initial(self, bounds, random=None):
        """Initial design for strategy bootstrap
        (reference: dmosopt/MOEA.py:118-143)."""
        bounds = np.asarray(bounds)
        xlb, xub = bounds[:, 0], bounds[:, 1]
        n = self.opt_params.initial_size
        method = self.opt_params.initial_sampling_method
        method_params = self.opt_params.initial_sampling_method_params
        if method is None:
            x = sampling.lh(n, self.nInput, random)
            x = x * (xub - xlb) + xlb
        elif isinstance(method, str):
            fn = getattr(sampling, method, None)
            if fn is None:
                raise NotImplementedError(
                    f"sampling method {method!r} is not ported"
                )
            x = fn(n, self.nInput, random) * (xub - xlb) + xlb
        elif callable(method):
            if method_params is None:
                x = method(random, n, self.nInput, xlb, xub)
            else:
                x = method(random, **method_params)
        else:
            raise RuntimeError(f"unknown sampling method {method}")
        return x

    # ------------------------------------------- adaptive population size

    @property
    def adaptive_population_size(self) -> bool:
        return bool(getattr(self.opt_params, "adaptive_population_size", False))

    def maybe_grow_capacity(self) -> bool:
        """Host-side growth hook, called between generation chunks: when
        the live size has pinned at the capacity ceiling, double the
        capacity (clamped to ``max_population_size``) and pad the state.
        Returns True when the capacity changed."""
        if not self.adaptive_population_size or self.state is None:
            return False
        n_active = getattr(self.state, "n_active", None)
        if n_active is None:
            return False
        max_pop = int(
            getattr(self.opt_params, "max_population_size", self.capacity)
        )
        if int(n_active) >= self.capacity and self.capacity < max_pop:
            new_cap = min(max_pop, self.capacity * 2)
            self.state = self.expand_capacity(self.state, new_cap)
            self.capacity = new_cap
            if "poolsize" in self.opt_params:
                self.opt_params.poolsize = int(round(new_cap / 2.0))
            return True
        return False

    def expand_capacity(self, state, new_capacity: int):
        raise NotImplementedError(
            f"{self.name} does not support adaptive population size"
        )

    # ------------------------------------------------ state functions

    def initialize_state(self, generator, x, y, bounds, mask=None):
        raise NotImplementedError

    def generate_strategy(self, generator, state):
        raise NotImplementedError

    def update_strategy(self, state, x_gen, y_gen):
        raise NotImplementedError

    def get_population_strategy(self, state):
        raise NotImplementedError


def run_ea_loop(
    opt: MOEA,
    state: Any,
    generator: torch.Generator,
    n_generations: int,
    eval_fn: Callable[[torch.Tensor], torch.Tensor],
) -> Any:
    """``n_generations`` of generate -> evaluate -> update, on the
    optimizer's device (reference ``run_ea_loop`` :227, a jitted scan).
    ``eval_fn`` maps a (B, n) tensor to (B, d) on the same device."""
    lb, ub = opt.bounds[:, 0], opt.bounds[:, 1]
    for _ in range(n_generations):
        x_gen, state = opt.generate_strategy(generator, state)
        x_gen = torch.clamp(x_gen, lb, ub)
        state = opt.update_strategy(state, x_gen, eval_fn(x_gen))
    return state
