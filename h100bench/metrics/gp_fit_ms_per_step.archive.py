"""Milliseconds an Adam step of the dense GP fit: the window's epochs'
``train_s`` (synchronised) over their fits' Adam steps (``fit_n_steps``)."""


def read(run):
    eps = [e for e in run.epoch_stats if e.get("fit_n_steps")]
    steps = sum(int(e["fit_n_steps"]) for e in eps)
    return 1e3 * sum(float(e["train_s"]) for e in eps) / steps if steps else None
