"""Shared utilities.

Port of ``dmosopt_tpu/utils/__init__.py`` (`json_default`,
`jittered_backoff`). Import-light: nothing here imports torch.
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


def jittered_backoff(attempt: int, base: float, cap: float) -> float:
    """Capped exponential backoff with jitter: ``min(base·2^attempt,
    cap)`` scaled uniformly into ``[0.5x, 1.0x)`` so simultaneous
    failures don't retry in lockstep. ``attempt`` is the zero-based
    retry index. Shared by every retry loop (background writer,
    host-evaluator resubmission)."""
    import random

    return min(base * 2.0 ** attempt, cap) * (0.5 + 0.5 * random.random())
