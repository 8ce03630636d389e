"""Seconds a step's refill spends in the service's ``submit`` calls: the
window's ``submit`` spans, summed, over all the window's steps (the
profiled one included: the refill before it lies outside its bounds).
None where the program opens no ``submit`` span."""


def read(run):
    spans = run.window_spans("submit")
    steps = len(run.steps)
    return sum(sp.duration_s for sp in spans) / steps if spans and steps else None
