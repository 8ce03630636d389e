"""One calibration at a time through ``dmosopt_tpu_torch.run()``.

Each calibration starts from a ``design_rows``-row design that this
driver draws from the calibration's seed (float32 values, uniform in the
box) and hands to ``run()`` through ``initial_method`` as a dict of
columns; it runs ``n_epochs`` epochs at the configuration's settings with
``save`` off. Set-up runs one calibration from the warm-up seed stream,
so every shape of the window has been through once. The window ends at
the end of the last epoch (an ``epoch`` span) that ended within
``--seconds``; a calibration still running then runs to its end and the
rest of it is not counted. The traced run profiles the first calibration
that starts after the middle of the window, whole.
"""

from __future__ import annotations

import itertools
import time

import numpy as np

from h100bench import drivers
from h100bench.harness.probes import OffspringProbe, RunProbe
from h100bench.harness.trace import Capture


def _design(seed, rows, names, lb, ub):
    rng = np.random.default_rng(seed)
    x = (lb + (ub - lb) * rng.random((rows, len(names)))).astype(np.float32)
    return {k: x[:, i].astype(np.float64) for i, k in enumerate(names)}


def drive(run):
    from dmosopt_tpu_torch import driver as dmo
    from dmosopt_tpu_torch.datatypes import ParameterSpace
    from dmosopt_tpu_torch.telemetry import Telemetry
    from dmosopt_tpu_torch.telemetry.tracing import annotations_armed

    cfg, mix = run.cell.config, run.cell.traffic
    fn = drivers.objective(cfg)
    space = drivers.space(cfg)
    names = list(ParameterSpace.from_dict(space).parameter_names)
    lb, ub = cfg["parameter_bounds"]
    audit_every = int(mix["audit_every"])
    run.telemetry = tel = Telemetry(trace_max_spans=1_000_000)
    probe = RunProbe(run.audit)
    offspring = OffspringProbe() if run.trace else None
    keys = itertools.count()

    def calibrate(s, key, audited):
        obj = run.audit.objective(key, fn) if audited else fn
        run.audit.current = key if audited else None
        params = {
            "opt_id": f"cal{key}", "obj_fun": obj, "torch_objective": True,
            "problem_parameters": {}, "space": space,
            "objective_names": cfg["objective_names"],
            "population_size": int(cfg["population_size"]),
            "num_generations": int(cfg["num_generations"]),
            "optimizer_name": cfg["optimizer_name"],
            "surrogate_method_name": cfg["surrogate_method_name"],
            "surrogate_method_kwargs": drivers.gp_kwargs(cfg, s),
            "n_initial": int(cfg["n_initial"]), "n_epochs": int(run.n_epochs),
            "resample_fraction": float(cfg["resample_fraction"]),
            "initial_method": _design(s, int(mix["design_rows"]), names, lb, ub),
            "random_seed": s, "telemetry": tel, "save": False,
        }
        try:
            prms, lres = dmo.run(params, verbose=False, device=run.device)
        finally:
            run.audit.current = None
        x = np.column_stack([v for _, v in prms])
        y = np.column_stack([v for _, v in lres])
        return x, y, dmo.dopt_dict[f"cal{key}"].epoch_stats

    try:
        warm = drivers.seed_stream(run.seed, 1)
        calibrate(next(warm), next(keys), False)
        run.mark_setup_done()

        seeds = drivers.seed_stream(run.seed, 0)
        t0 = time.perf_counter()
        deadline = t0 + run.seconds
        mark = tel.tracer.mark()
        stats, answers, started, failed = [], [], 0, 0
        profiled = None
        while time.perf_counter() < deadline:
            key = next(keys)
            audited = key % audit_every == run.seed % audit_every
            trace_this = (run.trace and profiled is None
                          and time.perf_counter() - t0 >= 0.5 * run.seconds)
            started += 1
            t_s = time.perf_counter()
            try:
                if trace_this:
                    offspring.armed = True
                    with annotations_armed(), Capture(run.device) as cap:
                        x, y, st = calibrate(next(seeds), key, audited)
                    offspring.armed = False
                    run.capture, run.offspring = cap, offspring
                else:
                    x, y, st = calibrate(next(seeds), key, audited)
            except Exception as e:  # a calibration that fails is an answer that never came
                run.log(f"calibration {key} failed: {type(e).__name__}: {e}")
                failed += 1
                continue
            if trace_this:
                profiled = (t_s, time.perf_counter())
            if audited:
                answers.append((key, x, y))
            stats.append((t_s, st))
        ends = sorted(sp.t_end for sp in tel.tracer.spans_since(mark)
                      if sp.name == "epoch" and sp.t_end is not None and sp.t_end <= deadline)
        if not ends:
            raise RuntimeError(f"no epoch ended within {run.seconds} s")
        last = ends[-1]
        run.close_window(t0, last)
        run.profiled = profiled
        run.e2e["epoch_s"] = (last - t0) / len(ends)
        run.epoch_stats = [e for t_s, st in stats for e in st
                           if not (profiled and t_s == profiled[0])]
        run.attempted = started
        run.failed = failed
        run.missing = 0
        run.read_memory()
        for key, x, y in answers:
            run.add_answer(key, x, y)
    finally:
        probe.remove()
        if offspring is not None:
            offspring.remove()
