"""Seconds a step spends in the bucket's batched GP fit: the window's
``gp_fit`` spans (closed after the fit's device synchronise), summed, over
the counted steps."""


def read(run):
    spans = run.window_spans("gp_fit")
    steps = len(run.counted_steps)
    return sum(sp.duration_s for sp in spans) / steps if spans and steps else None
