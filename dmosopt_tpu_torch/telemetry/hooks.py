"""Where the eager-only telemetry hooks stay silent: the generation loop.

The JAX package's rank and predictor hooks (`ops.dominance.
set_rank_telemetry`, `models.predictor.set_predictor_telemetry`) record
only on eager calls: inside the jitted generation loop their arguments
are tracers and the branch is dead. The port's generation loop is eager
torch, so it marks itself instead: the hooks record nothing while
`in_generation_loop()` is True on the calling thread, which keeps their
counters at the JAX package's call sites and keeps their timing syncs
out of a generation.
"""

from __future__ import annotations

import contextlib
import threading

_STATE = threading.local()


@contextlib.contextmanager
def generation_loop():
    """Mark the enclosed region (an inner-EA generation loop) on this
    thread."""
    depth = getattr(_STATE, "depth", 0)
    _STATE.depth = depth + 1
    try:
        yield
    finally:
        _STATE.depth = depth


def in_generation_loop() -> bool:
    return getattr(_STATE, "depth", 0) > 0
