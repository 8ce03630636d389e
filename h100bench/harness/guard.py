"""The modules a run may not hold: JAX and the JAX package, compared by
whole top-level name (``dmosopt_tpu_torch`` is the port, not the JAX
package ``dmosopt_tpu``)."""

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "dmosopt_tpu"})


def forbidden_loaded(modules=None):
    """Sorted top-level names of forbidden modules in ``modules``
    (``sys.modules`` by default)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN)
