"""Shared utilities.

Port of ``dmosopt_tpu/utils/__init__.py`` (`json_default`,
`import_object`, `jittered_backoff`). Import-light: nothing here imports
torch.
"""


def json_default(o):
    """``json.dumps(..., default=json_default)`` fallback that turns numpy
    scalars and arrays (and anything else with ``.tolist()`` or
    ``.item()``) into plain Python values; the default encoder raises on
    a stray ``np.float64`` in a payload."""
    for attr in ("tolist", "item"):
        fn = getattr(o, attr, None)
        if callable(fn):
            try:
                return fn()
            except Exception:
                continue
    raise TypeError(
        f"Object of type {type(o).__name__} is not JSON serializable"
    )


def import_object(ref: str):
    """Resolve a ``"package.module:attr"`` reference to the object it
    names: the form in which a service checkpoint's ``objective_ref``
    names an objective (a process that resumes it cannot receive a
    closure; it receives a name it can import). The attr part may be
    dotted (``mod:Class.method``)."""
    module_name, sep, attr_path = ref.partition(":")
    if not sep or not module_name or not attr_path:
        raise ValueError(
            f"object reference {ref!r} must look like 'package.module:attr'"
        )
    import importlib

    obj = importlib.import_module(module_name)
    for part in attr_path.split("."):
        obj = getattr(obj, part)
    return obj


def jittered_backoff(attempt: int, base: float, cap: float) -> float:
    """Capped exponential backoff with jitter: ``min(base·2^attempt,
    cap)`` scaled uniformly into ``[0.5x, 1.0x)`` so simultaneous
    failures don't retry in lockstep. ``attempt`` is the zero-based
    retry index. Shared by every retry loop (background writer,
    host-evaluator resubmission)."""
    import random

    return min(base * 2.0 ** attempt, cap) * (0.5 + 0.5 * random.random())
