"""Closed-loop traffic through the ask/tell ``OptimizationService``.

``live`` calibrations are in the service at all times in its default
lockstep mode. Set-up submits them over ``stagger_steps`` steps, so that
their epochs are staggered; every shape of the window has then been
through a step. ``fit_convergence_tol``, where the mix gives it, is the
bucket fits' stop (null: all ``n_iter`` Adam steps, so that a step's
work does not depend on which calibrations share the bucket). In the window, before each step, every calibration that
delivered its final front is replaced by a fresh one with the next seed
from ``--seed``. The window ends at the end of the last step that ended
within ``--seconds``; the step that overran is not counted. The traced
run profiles the first step that starts after the middle of the window.
"""

from __future__ import annotations

import itertools
import math
import time
from dataclasses import dataclass
from typing import Any, List, Optional

import torch

from h100bench import drivers
from h100bench.harness.probes import OffspringProbe, ServiceProbe
from h100bench.harness.stats import p90
from h100bench.harness.trace import Capture

#: seconds past the close that an answer due in the window may take
GRACE_S = 60.0


@dataclass
class Calibration:
    key: int
    handle: Any
    audited: bool
    submit_t: float
    submit_step: int
    done_t: Optional[float] = None


def _log_steps(run, log, t0, last):
    """One stderr line a step: its wall, its fits' Adam steps, and its
    ``gp_fit`` and ``ea_scan`` spans; set-up's steps marked ``setup``,
    the window's ``window``, the overrun ``after``."""
    spans = {name: run.telemetry.tracer.spans(name) for name in ("gp_fit", "ea_scan")}
    for i, (t_s, t_e, adam) in enumerate(log):
        inside = {name: sum(sp.duration_s for sp in sps if sp.t_end is not None
                            and sp.t_start >= t_s and sp.t_end <= t_e)
                  for name, sps in spans.items()}
        where = "setup" if t_e <= t0 else "window" if t_e <= last else "after"
        run.log(f"step {i} {where}: {t_e - t_s:.3f} s, Adam steps {adam}, "
                f"gp_fit {inside['gp_fit']:.3f} s, ea_scan {inside['ea_scan']:.3f} s")


def drive(run):
    from dmosopt_tpu_torch.service import OptimizationService
    from dmosopt_tpu_torch.telemetry import Telemetry
    from dmosopt_tpu_torch.telemetry.tracing import annotations_armed

    cfg, mix = run.cell.config, run.cell.traffic
    fn = drivers.objective(cfg)
    space = drivers.space(cfg)
    seeds = drivers.seed_stream(run.seed, 0)
    keys = itertools.count()
    audit_every = int(mix["audit_every"])
    run.telemetry = tel = Telemetry(trace_max_spans=1_000_000)
    svc = OptimizationService(telemetry=tel, device=run.device)
    probe = ServiceProbe(run.audit)
    offspring = OffspringProbe() if run.trace else None
    live: List[Calibration] = []
    finished: List[Calibration] = []
    step_index = 0
    log: List[tuple] = []  # (t_start, t_end, Adam steps of the step's fits)

    def submit():
        key = next(keys)
        s = next(seeds)
        audited = key % audit_every == run.seed % audit_every
        obj = run.audit.objective(key, fn) if audited else fn
        h = svc.submit(
            obj, space, cfg["objective_names"], opt_id=f"cal{key}",
            torch_objective=True, n_epochs=int(run.n_epochs),
            population_size=int(cfg["population_size"]),
            num_generations=int(cfg["num_generations"]),
            n_initial=int(cfg["n_initial"]),
            resample_fraction=float(cfg["resample_fraction"]),
            optimizer_name=cfg["optimizer_name"],
            surrogate_method_name=cfg["surrogate_method_name"],
            surrogate_method_kwargs=drivers.gp_kwargs(cfg, s, mix),
            random_seed=s,
        )
        if audited:
            run.audit.key_of_pid[h.tenant_id] = key
        live.append(Calibration(key, h, audited, time.perf_counter(), step_index))

    def step():
        nonlocal step_index
        t_s = time.perf_counter()
        k = len(probe.fit_steps)
        n = svc.step()
        if run.device.type == "cuda":
            torch.cuda.synchronize(run.device)
        t_e = time.perf_counter()
        log.append((t_s, t_e, probe.fit_steps[k:]))
        step_index += 1
        for c in list(live):
            if c.handle.done:
                c.done_t = t_e
                live.remove(c)
                finished.append(c)
        return t_s, t_e, n

    def refill():
        while len(live) < run.live:
            submit()

    try:
        # set-up: staggered arrivals
        per = math.ceil(run.live / int(mix["stagger_steps"]))
        for _ in range(int(mix["stagger_steps"])):
            for _ in range(min(per, run.live - len(live))):
                submit()
            step()
        run.mark_setup_done()

        t0 = time.perf_counter()
        n_before = len(finished)
        steps, profiled = [], None
        while True:
            refill()
            trace_this = (run.trace and profiled is None
                          and time.perf_counter() - t0 >= 0.5 * run.seconds)
            if trace_this:
                offspring.armed = True
                with annotations_armed(), Capture(run.device) as cap:
                    t_s, t_e, n = step()
                offspring.armed = False
                profiled = (t_s, t_e)
                run.capture, run.offspring = cap, offspring
            else:
                t_s, t_e, n = step()
            if t_e - t0 > run.seconds:
                break
            steps.append({"t_start": t_s, "t_end": t_e, "advanced": n,
                          "profiled": trace_this})
        if not steps:
            raise RuntimeError(f"no service step ended within {run.seconds} s")
        last = steps[-1]["t_end"]
        run.close_window(t0, last)
        run.steps = steps
        run.profiled = profiled
        window_done = [c for c in finished[n_before:] if c.done_t <= last]
        run.latencies = [c.done_t - c.submit_t for c in window_done]
        run.e2e["calibration_p90_s"] = p90(run.latencies)
        run.e2e["tenant_epochs_per_s"] = sum(s["advanced"] for s in steps) / (last - t0)
        _log_steps(run, log, t0, last)
        # the answers due in the window: every calibration whose last
        # epoch fell in a counted step (steps are numbered from 0; the
        # last one run overran and is not counted)
        last_step = step_index - 2
        due_by = last_step - (run.n_epochs - 1)
        everyone = finished + live
        due = [c for c in everyone if c.submit_step <= due_by
               and (c.done_t is None or c.done_t > t0)]
        run.attempted = len(due)
        run.read_memory()
        # wait, a minute past the close at most, for audited answers due
        deadline = time.perf_counter() + GRACE_S
        while (any(c.audited and c.done_t is None for c in due)
               and time.perf_counter() < deadline):
            step()
        run.failed = sum(1 for c in due if c.done_t is None or c.handle.error is not None)
        run.missing = sum(1 for c in due if c.audited and c.done_t is None)
        for c in due:
            if c.audited and c.done_t is not None and c.handle.error is None:
                front = c.handle.result()
                run.add_answer(c.key, front.x, front.y)
    finally:
        probe.remove()
        if offspring is not None:
            offspring.remove()
        svc.close()
