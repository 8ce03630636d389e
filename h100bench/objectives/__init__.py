"""The calibrations' objectives as batched torch functions, one module per
problem, found by name. They stand for the user's model: the program
receives them as ``obj_fun`` and evaluates them on the card."""

import importlib


def load(name: str):
    """The ``evaluate(x, **params) -> (B, d)`` function of problem ``name``."""
    return importlib.import_module(f"{__name__}.{name}").evaluate
