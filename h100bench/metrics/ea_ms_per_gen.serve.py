"""Milliseconds a generation of the bucket's inner EA: the window's
``ea_scan`` spans, summed, over the generations they ran (each bucket
epoch runs the configuration's ``num_generations``)."""


def read(run):
    spans = run.window_spans("ea_scan")
    gens = len(spans) * int(run.cell.config["num_generations"])
    return 1e3 * sum(sp.duration_s for sp in spans) / gens if gens else None
