"""Card kernels a generation of the bucket's inner EA: in the profiled
step's trace, the kernels that start between the first ``ea_variation``
annotation inside an ``ea_scan`` annotation and that ``ea_scan``'s end,
over the ``ea_survival`` annotations there (one a generation: the
program opens the generation's parts as live spans while a capture is
armed). ``ea_scan`` closes after the trajectories' copy to the host and
the fit before it after a synchronise, so exactly the generation loop's
kernels start inside. None where the run has no capture or the program
annotates no generation."""


def read(run):
    cap = run.capture
    if cap is None:
        return None
    kernels = survivals = 0
    for name, lo, hi in cap.spans:
        if name != "ea_scan":
            continue
        inside = [(n, s) for n, s, e in cap.spans if lo <= s and e <= hi]
        starts = [s for n, s in inside if n == "ea_variation"]
        if not starts:
            continue
        first = min(starts)
        kernels += sum(1 for _, s, _ in cap.kernels if first <= s <= hi)
        survivals += sum(1 for n, _ in inside if n == "ea_survival")
    return kernels / survivals if survivals else None
