"""Float64 numpy test problems, one module per problem, found by name."""

import importlib


def load(name: str):
    """The ``evaluate(x, **params) -> (B, d)`` function of problem ``name``."""
    return importlib.import_module(f"{__name__}.{name}").evaluate
