"""Seconds a step spends in the service's own phases around the bucket:
``admit`` + ``eval`` (the ``eval_drain`` span) + ``fold`` (the spans
around the same blocks that ``service_step_seconds{phase=}`` times), over
the counted steps."""


def read(run):
    steps = len(run.counted_steps)
    if not steps:
        return None
    total = sum(sp.duration_s for name in ("admit", "eval_drain", "fold")
                for sp in run.window_spans(name))
    return total / steps
