"""Seconds a step spends in the tenant core's host work around the
bucket: the window's ``plan`` spans (every tenant's epoch opening and
each batched tenant's plan) and ``resample`` spans (each tenant's dedupe
and crowding sort), summed, over the counted steps. None where the
program opens no ``plan`` span."""


def read(run):
    plans = run.window_spans("plan")
    steps = len(run.counted_steps)
    if not plans or not steps:
        return None
    spans = plans + run.window_spans("resample")
    return sum(sp.duration_s for sp in spans) / steps
