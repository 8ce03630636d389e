"""Milliseconds a generation of the bucket's inner EA spends in survival
(``update_strategy`` and the freeze of tenants past their budget): the
window's ``ea_survival`` seconds over the generations they cover (the
program records one span an ``ea_scan``, labelled with its
``generations``; a span without the label is one generation). None
where the program opens no ``ea_survival`` span."""


def read(run):
    spans = run.window_spans("ea_survival")
    gens = sum((sp.labels or {}).get("generations", 1) for sp in spans)
    return 1e3 * sum(sp.duration_s for sp in spans) / gens if gens else None
