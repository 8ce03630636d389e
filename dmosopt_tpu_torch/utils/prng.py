"""Randomness plumbing: one place to normalize seeds.

Counterpart of ``dmosopt_tpu/utils/prng.py``. Device code there threads
`jax.random` keys; here it threads explicit `torch.Generator`s. Host-side
sampling helpers (symmetric Latin hypercube, RGS decorrelation) keep
numpy Generators. `as_torch_generator` derives its seed exactly as the
reference's `as_key` does (`prng.py:28-38`), so a numpy Generator
threaded through both packages is consumed in the same order and every
numpy draw after it (e.g. the SLH initial design) comes out identical.
"""

from __future__ import annotations

import numpy as np
import torch


def as_torch_generator(random, device="cpu") -> torch.Generator:
    """Normalize to a seeded `torch.Generator` on ``device``: None -> seed
    0, an int -> that seed, a numpy Generator -> one draw from it (the
    reference's `as_key` draw), a `torch.Generator` -> itself."""
    if isinstance(random, torch.Generator):
        return random
    if random is None:
        seed = 0
    elif isinstance(random, (int, np.integer)):
        seed = int(random)
    elif isinstance(random, np.random.Generator):
        seed = int(random.integers(0, 2**31 - 1))
    else:
        raise TypeError(f"cannot convert {type(random)} to a torch Generator")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def as_generator(random) -> np.random.Generator:
    """Normalize to a numpy Generator (for host-side one-shot sampling)."""
    if random is None:
        return np.random.default_rng()
    if isinstance(random, np.random.Generator):
        return random
    if isinstance(random, (int, np.integer)):
        return np.random.default_rng(int(random))
    if isinstance(random, torch.Generator):
        return np.random.default_rng(int(random.initial_seed()))
    raise TypeError(f"cannot convert {type(random)} to a numpy Generator")


def as_seed(random) -> int:
    return int(as_generator(random).integers(0, 2**31 - 1))
