"""Milliseconds a generation of the inner EA: the window's epochs'
``optimize_s`` over their generations (``n_generations``)."""


def read(run):
    eps = [e for e in run.epoch_stats if e.get("n_generations")]
    gens = sum(int(e["n_generations"]) for e in eps)
    return 1e3 * sum(float(e["optimize_s"]) for e in eps) / gens if gens else None
