"""Command-line tools: analyze / train / onestep / telemetry / status /
fleet.

Port of ``dmosopt_tpu/cli/__init__.py`` on the standard library's
`argparse` in place of click: the same six subcommands with the JAX
package's option names, short flags, defaults and printed text. Run it
as ``python -m dmosopt_tpu_torch.cli <command> ...`` (or the
``dmosopt-tpu-torch`` script); `main` returns the exit code. A command
error prints ``Error: ...`` on stderr and exits 1, as a click
``ClickException`` does; a bad option, or a ``--file-path`` that does
not exist, prints the usage and exits 2.

`analyze` extracts and ranks the non-dominated set of a results store,
`train` fits a surrogate offline from its evaluations, `onestep` runs
one surrogate epoch from them, `telemetry` renders the per-epoch
summaries the driver persists (docs/observability.md), `status` renders
the snapshot an `OptimizationService(status_path=...)` publishes after
every step (``--watch N`` re-renders it live; ``--fleet-dir`` aggregates
a fleet directory), and `fleet` rolls N stores' persisted telemetry into
per-problem-signature distributions.

The four commands that compute (`analyze`, `train`, `onestep`,
`telemetry`) take ``--device`` (default ``cuda``, the port's device
rule: raising without a card). `train` persists its surrogate with
`torch.save` (`save_surrogate`; `load_surrogate` reads it back) where
the JAX package dumps it with joblib. Importing this module loads
neither click nor jax; the store commands import h5py only when they
read a store.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
from collections import OrderedDict

import numpy as np

from dmosopt_tpu_torch.utils import json_default

PROG = "dmosopt-tpu-torch"

#: the `train` file's layout tag; bumped when it changes incompatibly
SURROGATE_FORMAT = "dmosopt_tpu_torch.surrogate"
SURROGATE_VERSION = 1


class CommandError(Exception):
    """A command's refusal (click's ``ClickException``): `main` prints
    ``Error: <message>`` on stderr and returns 1."""


def echo(message: str = "", err: bool = False) -> None:
    print(message, file=sys.stderr if err else sys.stdout, flush=True)


def _clear() -> None:
    """Clear the terminal, as ``click.clear`` does: only on a tty."""
    if sys.stdout.isatty():
        sys.stdout.write("\033[2J\033[1;1H")


def _existing_path(path: str) -> str:
    if not os.path.exists(path):
        raise argparse.ArgumentTypeError(f"Path '{path}' does not exist.")
    return path


def _existing_dir(path: str) -> str:
    _existing_path(path)
    if not os.path.isdir(path):
        raise argparse.ArgumentTypeError(f"Directory '{path}' is a file.")
    return path


def _load(file_path, opt_id):
    from dmosopt_tpu_torch.storage import h5_load_raw

    raw = h5_load_raw(file_path, opt_id)
    problem_ids = sorted(raw["problem_ids"]) if raw["problem_ids"] else [0]
    return raw, problem_ids


def _stack_evals(entries):
    x = np.vstack([e.parameters for e in entries])
    y = np.vstack([e.objectives for e in entries])
    c = (
        np.vstack([e.constraints for e in entries])
        if entries[0].constraints is not None
        else None
    )
    f = (
        np.vstack([np.atleast_1d(e.features) for e in entries])
        if entries[0].features is not None
        else None
    )
    epochs = np.concatenate([np.atleast_1d(e.epoch) for e in entries])
    return x, y, f, c, epochs


# ---------------------------------------------------------------- analyze


def analyze(args):
    """Extract and rank the non-dominated set from a results store
    (intent of reference dmosopt_analyze.py, plus epsilon-box archives
    and hypervolume reporting)."""
    from dmosopt_tpu_torch import moasmo

    device = args.device
    sort_key = args.sort_key
    raw, problem_ids = _load(args.file_path, args.opt_id)
    objective_names = raw["objective_names"]
    param_names = raw["parameter_names"]

    # displayed objective columns are problem-independent: filter and
    # validate the sort keys once, before any Pareto extraction
    names = list(objective_names)
    keep = None
    if args.filter_objectives is not None:
        keep = [i for i, n in enumerate(names)
                if n in set(args.filter_objectives.split(","))]
        names = [names[i] for i in keep]
    missing = [k for k in sort_key if k not in names]
    if missing:
        raise CommandError(
            f"unknown sort key(s) {missing}; objectives: {names}"
        )
    eps_arg = None
    if args.epsilons is not None:
        if args.epsilons == "auto":
            eps_arg = "auto"
        elif "," in args.epsilons:
            eps_arg = [float(v) for v in args.epsilons.split(",")]
        else:
            eps_arg = float(args.epsilons)

    out = {}
    for problem_id in problem_ids:
        entries = raw["evals"].get(problem_id, [])
        if not entries:
            echo(f"No results for id {problem_id}")
            continue
        x, y, f, c, epochs = _stack_evals(entries)
        if keep is not None:
            y = y[:, keep]

        echo(f"Found {x.shape[0]} results for id {problem_id}")
        if isinstance(eps_arg, list) and len(eps_arg) != y.shape[1]:
            raise CommandError(
                f"--epsilons needs {y.shape[1]} values (one per displayed "
                f"objective), got {len(eps_arg)}"
            )
        if eps_arg is not None:
            best_x, best_y, best_f, best_c, eps_used = moasmo.epsilon_get_best(
                x, y, f, c, feasible=args.constraints, epsilons=eps_arg,
                device=device,
            )
            best_epoch = None
            echo(f"epsilon boxes: {np.round(eps_used, 6).tolist()}")
        else:
            best_x, best_y, best_f, best_c, best_epoch, _ = moasmo.get_best(
                x, y, f, c, x.shape[1], y.shape[1], epochs=epochs,
                feasible=args.constraints, device=device,
            )
        echo(f"Found {best_x.shape[0]} best results for id {problem_id}")

        hv_value = None
        if args.with_hv and best_y.shape[0] > 0:
            from dmosopt_tpu_torch.hv import (
                AdaptiveHyperVolume,
                default_reference_point,
            )

            if args.hv_ref is not None:
                ref = np.asarray([float(v) for v in args.hv_ref.split(",")])
                if ref.shape[0] != best_y.shape[1]:
                    raise CommandError(
                        f"--hv-ref needs {best_y.shape[1]} values"
                    )
            else:
                ref = default_reference_point(best_y)
            engine = AdaptiveHyperVolume(ref, device=device)
            hv_value = float(engine.compute_hypervolume(best_y))
            echo(
                f"hypervolume ({engine.last_method}, ref "
                f"{np.round(ref, 4).tolist()}): {hv_value:.6g}"
            )

        order = np.arange(best_y.shape[0])
        if args.knn > 0 and best_y.shape[0] > 0:
            # kNN-to-origin ranking on max-normalized objectives
            # (reference dmosopt_analyze.py:130-150)
            pts = best_y.copy()
            for j in range(pts.shape[1]):
                mx = np.max(pts[:, j])
                if mx > 0:
                    pts[:, j] = pts[:, j] / mx
            d = np.linalg.norm(pts, axis=1)
            order = np.argsort(d)[: min(args.knn, len(d))]

        if sort_key:
            # order the (possibly knn-restricted) rows by named objective
            # columns (reference dmosopt_analyze.py --sort-key); the first
            # option given is the primary key
            cols = [best_y[order, names.index(k)] for k in sort_key]
            order = order[np.lexsort(tuple(reversed(cols)))]

        rows = OrderedDict()
        for i in order:
            row = {
                "objectives": {n: float(best_y[i, j]) for j, n in enumerate(names)},
                "parameters": {n: float(best_x[i, j])
                               for j, n in enumerate(param_names)},
            }
            if best_epoch is not None:
                row["epoch"] = int(best_epoch[i])
            if best_c is not None:
                row["constraints"] = [float(v) for v in best_c[i]]
            rows[int(i)] = row
            if args.verbose or args.output_file is None:
                echo(f"{i}: {row['objectives']} @ {row['parameters']}")
        # with --hv the shape is stable for every problem (hypervolume may
        # be null when the best set is empty); without it, bare rows
        out[str(problem_id)] = (
            {"hypervolume": hv_value, "rows": rows} if args.with_hv else rows
        )

    if args.output_file is not None:
        with open(args.output_file, "w") as fh:
            json.dump(out, fh, indent=2, default=json_default)
        echo(f"wrote {args.output_file}")


# ------------------------------------------------------------------ train


_TRANSIENT = ("logger", "_mesh", "_predictor_obj")


def _map_tensors(obj, fn):
    """``obj`` with every torch tensor inside it replaced by ``fn(t)``,
    through dicts, lists, tuples (named ones too) and dataclasses."""
    import copy
    import dataclasses

    import torch

    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: _map_tensors(v, fn) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_map_tensors(v, fn) for v in obj]
    if isinstance(obj, tuple):
        items = [_map_tensors(v, fn) for v in obj]
        return type(obj)._make(items) if hasattr(obj, "_fields") else tuple(items)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = copy.copy(obj)
        for fld in dataclasses.fields(obj):
            # object.__setattr__: a frozen dataclass takes it too
            object.__setattr__(out, fld.name, _map_tensors(getattr(obj, fld.name), fn))
        return out
    return obj


def save_surrogate(sm, path) -> None:
    """Persist a fitted surrogate with `torch.save`: its class
    (``module:qualname``) and its fitted state (every attribute but the
    logger, the mesh and the lazily built predictor, tensors moved to
    the host)."""
    import torch

    state = {k: v for k, v in vars(sm).items() if k not in _TRANSIENT}
    torch.save(
        {
            "format": SURROGATE_FORMAT,
            "version": SURROGATE_VERSION,
            "class": f"{type(sm).__module__}:{type(sm).__qualname__}",
            "state": _map_tensors(state, lambda t: t.detach().cpu()),
        },
        path,
    )


def load_surrogate(path, device=None):
    """Rebuild a surrogate that `save_surrogate` (the `train` command)
    wrote, on ``device`` (None means CUDA, raising without a card):
    the stored class with its fitted state, ready to ``predict``. The
    file unpickles its classes, so load only files you trust."""
    import torch

    from dmosopt_tpu_torch.utils import import_object
    from dmosopt_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    blob = torch.load(path, map_location="cpu", weights_only=False)
    if blob.get("format") != SURROGATE_FORMAT:
        raise ValueError(
            f"{path!r} is not a surrogate file (format {blob.get('format')!r})"
        )
    cls = import_object(blob["class"])
    sm = cls.__new__(cls)
    for name in _TRANSIENT:
        setattr(sm, name, None)
    vars(sm).update(_map_tensors(blob["state"], lambda t: t.to(dev)))
    sm.device = dev
    return sm


def train(args):
    """Fit a surrogate offline from stored evaluations and persist it
    (intent of reference dmosopt_train.py, which dumps it with joblib
    :97; here `save_surrogate`)."""
    from dmosopt_tpu_torch import moasmo

    raw, _ = _load(args.file_path, args.opt_id)
    entries = raw["evals"].get(args.problem_id, [])
    if not entries:
        raise CommandError(f"no evaluations for problem {args.problem_id}")
    x, y, f, c, _ = _stack_evals(entries)
    space = raw["parameter_space"]
    kwargs = json.loads(args.surrogate_kwargs)

    logger = logging.getLogger(f"train.{args.opt_id}")
    sm = moasmo.train(
        x.shape[1], y.shape[1], space.bound1, space.bound2, x, y, c,
        surrogate_method_name=args.surrogate_method,
        surrogate_method_kwargs=kwargs,
        logger=logger,
        device=args.device,
    )
    save_surrogate(sm, args.output_file)
    # name the class actually fitted — large training sets reroute
    # dense-kernel surrogates to the sparse family (moasmo._route_large_n)
    echo(f"trained {type(sm).__name__} surrogate on {x.shape[0]} evals "
         f"-> {args.output_file}")


# ---------------------------------------------------------------- onestep


def onestep(args):
    """Run one surrogate epoch from stored evals and emit the resample
    candidates (intent of reference dmosopt_onestep.py)."""
    from dmosopt_tpu_torch import moasmo

    raw, _ = _load(args.file_path, args.opt_id)
    entries = raw["evals"].get(args.problem_id, [])
    if not entries:
        raise CommandError(f"no evaluations for problem {args.problem_id}")
    x, y, f, c, _ = _stack_evals(entries)
    space = raw["parameter_space"]
    param_names = raw["parameter_names"]
    objective_names = raw["objective_names"]

    gen = moasmo.epoch(
        args.num_generations,
        param_names,
        objective_names,
        space.bound1,
        space.bound2,
        args.resample_fraction,
        x,
        y,
        c,
        pop=args.population_size,
        optimizer_name=args.optimizer,
        surrogate_method_name=args.surrogate_method,
        surrogate_method_kwargs=json.loads(args.surrogate_kwargs),
        local_random=args.seed,
        device=args.device,
    )
    try:
        next(gen)
        raise CommandError(
            "onestep requires a surrogate-mode epoch (it must not request "
            "real evaluations)"
        )
    except StopIteration as ex:
        res = ex.value
    x_resample = np.asarray(res["x_resample"])
    y_pred = np.asarray(res["y_pred"])
    echo(f"proposed {x_resample.shape[0]} resample candidates")
    if args.output_file is not None:
        np.savez(args.output_file, x_resample=x_resample, y_pred=y_pred)
        echo(f"wrote {args.output_file}")
    else:
        for i in range(x_resample.shape[0]):
            echo(
                f"{i}: x={np.array2string(x_resample[i], precision=4)} "
                f"pred={np.array2string(y_pred[i], precision=4)}"
            )


# -------------------------------------------------------------- telemetry


_TELEMETRY_PHASES = ("xinit", "train", "optimize", "eval")


def _fmt(v, width, nd=2):
    if v is None:
        return "-".rjust(width)
    if isinstance(v, float):
        return f"{v:.{nd}f}".rjust(width)
    return str(v).rjust(width)


def telemetry(args):
    """Per-epoch telemetry table from a results store: phase durations,
    EA throughput, eval-time stats, surrogate-fit results — the
    summaries the driver persists into the HDF5 `telemetry` group
    (docs/observability.md)."""
    from dmosopt_tpu_torch.storage import load_telemetry_from_h5

    file_path, opt_id, with_hv = args.file_path, args.opt_id, args.with_hv
    summaries = load_telemetry_from_h5(file_path, opt_id)
    if not summaries:
        raise CommandError(
            f"no telemetry group for opt id {opt_id!r} in {file_path} "
            f"(run with telemetry enabled and save=True)"
        )

    hv_by_epoch = {}
    if with_hv:
        raw, _ = _load(file_path, opt_id)
        entries = raw["evals"].get(args.problem_id, [])
        if entries:
            from dmosopt_tpu_torch import moasmo
            from dmosopt_tpu_torch.hv import (
                AdaptiveHyperVolume,
                default_reference_point,
            )

            device = args.device
            x, y, f, c, epochs = _stack_evals(entries)
            # one fixed reference point over the full archive keeps the
            # trajectory comparable across epochs
            engine = AdaptiveHyperVolume(default_reference_point(y), device=device)
            for e in sorted(summaries):
                m = epochs <= e
                if not m.any():
                    continue
                best = moasmo.get_best(
                    x[m], y[m], None, c[m] if c is not None else None,
                    x.shape[1], y.shape[1], device=device,
                )
                if best[1].shape[0] > 0:
                    hv_by_epoch[e] = float(
                        engine.compute_hypervolume(best[1])
                    )

    header = (
        f"{'epoch':>5} {'wall_s':>8} "
        + " ".join(f"{p:>9}" for p in _TELEMETRY_PHASES)
        + f" {'gens':>6} {'gens/s':>8} {'evals':>6} {'eval_mean':>9}"
        + (f" {'hv':>10}" if with_hv else "")
    )
    echo(header)
    echo("-" * len(header))
    for e in sorted(summaries):
        s = summaries[e]
        phases = s.get("phases", {})
        ev = s.get("eval", {})
        line = (
            _fmt(e, 5)
            + " " + _fmt(s.get("wall_s"), 8)
            + " " + " ".join(_fmt(phases.get(p), 9, 3) for p in _TELEMETRY_PHASES)
            + " " + _fmt(s.get("n_generations"), 6)
            + " " + _fmt(s.get("gens_per_sec"), 8)
            + " " + _fmt(ev.get("eval_n"), 6)
            + " " + _fmt(ev.get("eval_mean"), 9, 4)
        )
        if with_hv:
            line += " " + _fmt(hv_by_epoch.get(e), 10, 4)
        echo(line)

    if args.output_file is not None:
        payload = {
            str(e): (
                dict(summaries[e], hypervolume=hv_by_epoch.get(e))
                if with_hv
                else summaries[e]
            )
            for e in sorted(summaries)
        }
        with open(args.output_file, "w") as fh:
            json.dump(payload, fh, indent=2, default=json_default)
        echo(f"wrote {args.output_file}")


# ----------------------------------------------------------------- status


def status(args):
    """Live-service introspection: render the snapshot an
    `OptimizationService(status_path=...)` publishes after every step —
    tenants with epoch/state/attributed cost, queue depths, writer
    backlog, telemetry series-overflow state, the health-alert block,
    and the loadavg-normalized throughput check (docs/observability.md).
    With `--fleet-dir` the same command aggregates a whole fleet
    directory instead: per-worker liveness/heartbeat age/exporter
    ports, the tenant placement table, and the migration history
    (docs/robustness.md "Fleet failure model"). With `--watch N` the
    table re-renders every N seconds — the zero-dependency live
    dashboard."""
    import time as _time

    status_file, fleet_dir = args.status_file, args.fleet_dir
    as_json, watch = args.as_json, args.watch
    if (status_file is None) == (fleet_dir is None):
        raise CommandError(
            "pass exactly one of --status-file/-p or --fleet-dir/-d"
        )

    def render_once():
        if fleet_dir is not None:
            from dmosopt_tpu_torch.telemetry.fleet import scan_fleet_dir

            scan = scan_fleet_dir(fleet_dir)
            if as_json:
                echo(json.dumps(scan, indent=2, default=json_default))
            else:
                _render_fleet_status(scan)
            return
        with open(status_file) as fh:
            snap = json.load(fh)
        if as_json:
            echo(json.dumps(snap, indent=2, default=json_default))
        else:
            _render_status(snap)

    if watch and watch > 0:
        try:
            while True:
                _clear()
                render_once()
                echo(
                    f"(watching {status_file or fleet_dir} every "
                    f"{watch:g}s — Ctrl-C to stop)"
                )
                _time.sleep(watch)
        except KeyboardInterrupt:
            return
    else:
        render_once()


def _render_fleet_status(scan):
    """One rendering of a fleet-directory aggregation: per-worker
    liveness lines, the placement table, migration history."""
    import time as _time

    state = scan.get("state") or {}
    now = _time.time()
    workers = scan.get("workers", [])
    st_workers = state.get("workers", {})
    echo(
        f"fleet: {scan.get('fleet_dir')} — {len(workers)} worker(s), "
        f"placement epoch {state.get('placement_epoch', 0)}, "
        f"{len(state.get('migrations', []))} migration(s), "
        f"{len(state.get('shed', []))} shed, "
        f"lease_conflicts={state.get('lease_conflicts', 0)}"
    )
    header = (
        f"{'worker':>8} {'state':>10} {'hb_age':>8} {'steps':>6} "
        f"{'tenants':>8} {'exporter':>24}"
    )
    echo(header)
    echo("-" * len(header))
    for w in workers:
        wid = w["worker_id"]
        wstatus = w.get("status") or {}
        sup_state = (st_workers.get(wid) or {}).get("state")
        state_str = sup_state or wstatus.get("state", "?")
        if w.get("fenced"):
            state_str = "FENCED"
        age = (
            f"{max(now - float(wstatus['ts']), 0.0):.1f}s"
            if wstatus.get("ts")
            else "-"
        )
        exporter = (wstatus.get("exporter") or {}).get("url") or "-"
        tenants = wstatus.get("tenants") or {}
        echo(
            f"{wid:>8} {state_str:>10} {age:>8} "
            f"{str(wstatus.get('steps', '-')):>6} "
            f"{len(tenants):>8} {exporter:>24}"
        )
        if wstatus.get("last_error"):
            echo(f"  note: {wstatus['last_error']}")
    placements = state.get("placements", {})
    tenant_states = state.get("tenants", {})
    if placements:
        header = f"{'tenant':>20} {'worker':>8} {'state':>10} {'budget':>8}"
        echo(header)
        echo("-" * len(header))
        for opt_id in sorted(placements):
            p = placements[opt_id]
            echo(
                f"{opt_id:>20} {p.get('worker', '?'):>8} "
                f"{tenant_states.get(opt_id, '?'):>10} "
                f"{str(p.get('budget', '-')):>8}"
            )
    for m in state.get("migrations", []):
        echo(
            f"migration @ epoch {m.get('placement_epoch')}: "
            f"{m.get('from')} -> {m.get('to')} "
            f"({len(m.get('tenants', []))} tenant(s): "
            f"{','.join(m.get('tenants', []))}; "
            f"cause: {m.get('cause', '?')})"
        )
    for s in state.get("shed", []):
        echo(
            f"shed: {s.get('opt_id')} ({s.get('reason')})"
        )


def _render_status(snap):
    """One rendering of a status snapshot (shared by the one-shot and
    `--watch` paths)."""
    counts = snap.get("tenant_counts", {})
    counts_str = " ".join(f"{k}={v}" for k, v in sorted(counts.items()))
    qd = snap.get("queue_depths", {})
    echo(
        f"service: steps={snap.get('steps', 0)} "
        f"closed={snap.get('closed', False)} {counts_str}"
    )
    echo(
        f"queues: pending_submissions={qd.get('pending_submissions', 0)} "
        f"writer_backlog={qd.get('writer_backlog', 0)} "
        f"series_overflow_total={snap.get('series_overflow_total', 0)}"
        + (
            f" spans_dropped={snap['spans_dropped']}"
            if snap.get("spans_dropped") is not None
            else ""
        )
    )
    if snap.get("spans_dropped"):
        echo(
            "  note: the span buffer overflowed — the Chrome export "
            "keeps only the most recent window (raise trace_max_spans "
            "to keep more)"
        )
    writer = snap.get("writer", {})
    if writer.get("failed") or writer.get("retries_total"):
        echo(
            f"writer: failed={writer.get('failed', False)} "
            f"retries_total={writer.get('retries_total', 0)}"
        )
        if writer.get("failed"):
            echo(
                "  note: persistence writer is DEAD (write failed after "
                "its retry budget) — fronts/checkpoints are no longer "
                "written; optimization continues"
            )
    if snap.get("checkpoint_path"):
        line = f"checkpoint: {snap['checkpoint_path']}"
        lease = snap.get("lease") or {}
        if lease.get("owner"):
            line += (
                f" (owner {lease['owner']}, placement epoch "
                f"{lease.get('placement_epoch', 0)})"
            )
        echo(line)
    thr = snap.get("throughput", {})
    line = (
        f"throughput: {thr.get('status', 'no_data')} "
        f"(last {_fmt(thr.get('last_step_s_per_tenant'), 0, 4)}s/tenant, "
        f"best {_fmt(thr.get('best_step_s_per_tenant'), 0, 4)}s/tenant, "
        f"load {_fmt(thr.get('loadavg_1m'), 0, 2)}"
        f"/{thr.get('cpu_count', '-')} cpus)"
    )
    echo(line)
    if thr.get("note"):
        echo(f"  note: {thr['note']}")
    health = snap.get("health")
    if health is not None:
        hstatus = health.get("status", "ok")
        firing = health.get("firing", [])
        echo(
            f"health: {hstatus} "
            f"({len(firing)} firing / {health.get('rules', 0)} rules, "
            f"{health.get('transitions_total', 0)} transitions)"
        )
        for alert in firing:
            since = alert.get("since_step")
            val = alert.get("value")
            echo(
                f"  ALERT [{alert.get('severity', '?')}] "
                f"{alert.get('rule', '?')}"
                + (f" since step {since}" if since is not None else "")
                + (f" (value {val:g})" if isinstance(val, (int, float))
                   else "")
            )
    exporter = snap.get("exporter")
    if exporter and exporter.get("url"):
        echo(
            f"exporter: {exporter['url']} (/metrics /healthz /statusz)"
        )
    last = snap.get("last_step", {})
    if last.get("phases"):
        echo(
            "last step: "
            + " ".join(
                f"{k}={v:.3f}s" for k, v in last["phases"].items()
            )
            + f" (wall {_fmt(last.get('wall_s'), 0, 3)}s)"
        )
    tenants = snap.get("tenants", [])
    if tenants:
        header = (
            f"{'tenant':>20} {'state':>10} {'epoch':>8} {'fit_s':>8} "
            f"{'ea_s':>8} {'compile_s':>10} {'gens/s':>8}"
        )
        echo(header)
        echo("-" * len(header))
        for t in tenants:
            cost = t.get("cost_seconds", {})
            # an active-but-degraded tenant (eval failures, sub-quorum
            # epochs) is flagged in place; retirees already carry the
            # "degraded" state
            state = t.get("state", "?")
            if t.get("degraded") and state == "active":
                state = "active!"
            line = (
                f"{t.get('opt_id', '?'):>20} {state:>10} "
                f"{str(t.get('epoch', '-')) + '/' + str(t.get('n_epochs', '-')):>8} "
                + _fmt(cost.get("fit"), 8, 3) + " "
                + _fmt(cost.get("ea"), 8, 3) + " "
                + _fmt(cost.get("compile"), 10, 3) + " "
                + _fmt(t.get("gens_per_sec"), 8)
            )
            extras = []
            if t.get("eval_failures_total"):
                extras.append(f"eval_failures={t['eval_failures_total']}")
            if t.get("failed_epochs_consecutive"):
                extras.append(
                    f"subquorum_epochs={t['failed_epochs_consecutive']}"
                )
            if t.get("points_quarantined_total"):
                extras.append(
                    f"quarantined={t['points_quarantined_total']}"
                )
            if extras:
                line += "  [" + " ".join(extras) + "]"
            echo(line)
    dl = snap.get("device_ledger")
    if dl:
        # device truth (profiled steps): trace-derived fractions beat
        # the host-clock throughput line above whenever they disagree
        cap = dl.get("last_capture") or {}
        echo(
            f"device: busy_fraction={_fmt(dl.get('device_busy_fraction'), 0, 3)} "
            f"overlap_ratio={_fmt(dl.get('device_overlap_ratio'), 0, 3)} "
            f"captures={dl.get('captures', 0)} "
            f"joined={cap.get('n_joined', '-')}/{cap.get('n_spans', '-')} spans"
        )
        for row in dl.get("programs", []):
            line = (
                f"  program {row.get('program', '?')}"
                + (f" [{row['bucket']}]" if row.get("bucket") else "")
                + f": device {_fmt(row.get('device_time_s'), 0, 3)}s"
                f" / host {_fmt(row.get('host_time_s'), 0, 3)}s"
                f" compile {_fmt(row.get('compile_s'), 0, 3)}s"
                f" x{row.get('compiles', 0)}"
            )
            if row.get("memory_bytes"):
                line += f" mem {int(row['memory_bytes'])}B"
            if row.get("retraces"):
                line += f" retraces={row['retraces']}"
            echo(line)
        tds = dl.get("tenant_device_seconds")
        if tds:
            parts = []
            for tenant, phases_ in sorted(tds.items()):
                total = sum(phases_.values())
                parts.append(f"{tenant}={total:.3f}s")
            echo("  tenant device seconds: " + " ".join(parts))
    if snap.get("trace_path"):
        echo(f"trace: {snap['trace_path']}")


# ------------------------------------------------------------------ fleet


def fleet(args):
    """Fleet telemetry rollup: scan N runs' persisted telemetry
    (per-epoch summaries, spans, health alerts, warm-refit
    hyperparameter state) into per-problem-signature distributions —
    the substrate fleet-learned warm-start priors consume
    (docs/observability.md "Fleet telemetry rollup"). `--dir` scans a
    whole fleet directory (every worker checkpoint + results store) in
    one flag."""
    from dmosopt_tpu_torch.telemetry.fleet import (
        fleet_dir_stores,
        fleet_summary,
        write_fleet_summary,
    )

    signature, output_file = args.signature, args.output_file
    paths = list(args.file_paths)
    for d in args.fleet_dirs:
        paths.extend(fleet_dir_stores(d))
    if not paths:
        raise CommandError(
            "nothing to scan: pass --file-path/-p stores and/or a "
            "--dir fleet directory containing checkpoints or results"
        )
    if output_file is not None:
        summary = write_fleet_summary(paths, output_file)
    else:
        summary = fleet_summary(paths)
    if signature is not None:
        if signature not in summary["signatures"]:
            raise CommandError(
                f"signature {signature!r} not in the fleet; present: "
                f"{sorted(summary['signatures'])}"
            )
        summary = dict(
            summary,
            signatures={signature: summary["signatures"][signature]},
        )
    if args.as_json:
        echo(json.dumps(summary, indent=2, default=json_default))
        if output_file is not None:
            echo(f"wrote {output_file}", err=True)
        return

    echo(
        f"fleet: {summary['n_runs']} run(s) across "
        f"{summary['n_stores']} store(s), "
        f"{len(summary['signatures'])} signature(s)"
    )
    for sig, entry in summary["signatures"].items():
        echo(f"\nsignature {sig}: {entry['n_runs']} run(s), "
             f"{entry['n_problems']} problem(s)")
        for dist_key in ("epochs", "fit_steps", "gens_per_sec",
                         "epochs_to_front", "n_train", "quarantine_rate"):
            d = entry.get(dist_key)
            if d:
                echo(
                    f"  {dist_key:>16}: mean={d['mean']:.4g} "
                    f"median={d['median']:.4g} "
                    f"[{d['min']:.4g}, {d['max']:.4g}] n={d['count']}"
                )
        hp = entry.get("hyperparameters", {})
        for name in ("amp", "lengthscale", "noise"):
            d = (hp.get(name) or {}).get("log10")
            if d:
                echo(
                    f"  {name:>16}: log10 mean={d['mean']:.3f} "
                    f"std={d['std']:.3f} "
                    f"[{d['min']:.3f}, {d['max']:.3f}] n={d['count']}"
                )
        if entry.get("alert_firings"):
            echo(
                "  alerts: "
                + " ".join(
                    f"{rule}={n}"
                    for rule, n in sorted(entry["alert_firings"].items())
                )
            )
    if output_file is not None:
        echo(f"\nwrote {output_file}")


# ----------------------------------------------------------------- parser


def _store_options(p, opt_id_required=True):
    p.add_argument("--file-path", "-p", required=True, type=_existing_path)
    p.add_argument("--opt-id", required=opt_id_required, type=str)


def _device_option(p):
    p.add_argument("--device", default="cuda",
                   help="torch device to compute on (default cuda: raises "
                        "without a card)")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog=PROG, description="dmosopt-tpu-torch command-line tools."
    )
    sub = parser.add_subparsers(dest="command", metavar="COMMAND")
    bool_flag = argparse.BooleanOptionalAction

    p = sub.add_parser("analyze", help="rank the non-dominated set of a store",
                       description=analyze.__doc__)
    _store_options(p)
    p.add_argument("--constraints", action=bool_flag, default=True)
    p.add_argument("--knn", default=0, type=int,
                   help="rank the k best points nearest the normalized origin")
    p.add_argument("--sort-key", type=str, action="append", default=[],
                   help="objective name(s) to sort the rows by (repeatable; "
                        "first given is the primary key)")
    p.add_argument("--filter-objectives", type=str, default=None,
                   help="comma-separated subset of objectives")
    p.add_argument("--epsilons", type=str, default=None,
                   help='epsilon-box archive instead of the exact front: a '
                        'number (all objectives), comma-separated '
                        'per-objective values, or "auto" (0.05 IQR per '
                        'objective)')
    p.add_argument("--hv", dest="with_hv", action=bool_flag, default=False,
                   help="report the archive hypervolume (adaptive exact/FPRAS)")
    p.add_argument("--hv-ref", type=str, default=None,
                   help="comma-separated HV reference point (default: nadir "
                        "+ 10%% of the span)")
    p.add_argument("--output-file", type=str, default=None)
    p.add_argument("--verbose", "-v", action="store_true")
    _device_option(p)
    p.set_defaults(func=analyze)

    p = sub.add_parser("train", help="fit a surrogate from a store",
                       description=train.__doc__)
    _store_options(p)
    p.add_argument("--problem-id", default=0, type=int)
    p.add_argument("--surrogate-method", default="gpr", type=str)
    p.add_argument("--surrogate-kwargs", default="{}", type=str,
                   help="JSON dict of surrogate options")
    p.add_argument("--output-file", "-o", required=True, type=str)
    _device_option(p)
    p.set_defaults(func=train)

    p = sub.add_parser("onestep", help="one surrogate epoch from a store",
                       description=onestep.__doc__)
    _store_options(p)
    p.add_argument("--problem-id", default=0, type=int)
    p.add_argument("--population-size", default=100, type=int)
    p.add_argument("--num-generations", default=100, type=int)
    p.add_argument("--resample-fraction", default=0.25, type=float)
    p.add_argument("--optimizer", default="nsga2", type=str)
    p.add_argument("--surrogate-method", default="gpr", type=str)
    p.add_argument("--surrogate-kwargs", default="{}", type=str)
    p.add_argument("--output-file", "-o", type=str, default=None)
    p.add_argument("--seed", default=0, type=int)
    _device_option(p)
    p.set_defaults(func=onestep)

    p = sub.add_parser("telemetry", help="per-epoch telemetry of a store",
                       description=telemetry.__doc__)
    _store_options(p)
    p.add_argument("--problem-id", default=0, type=int,
                   help="problem whose archive feeds the --hv trajectory")
    p.add_argument("--hv", dest="with_hv", action=bool_flag, default=False,
                   help="add a cumulative archive-hypervolume column "
                        "(computed from the stored evaluations per epoch)")
    p.add_argument("--output-file", "-o", type=str, default=None,
                   help="also export the summaries (plus hv) as JSON")
    _device_option(p)
    p.set_defaults(func=telemetry)

    p = sub.add_parser("status", help="render a service or fleet status",
                       description=status.__doc__)
    p.add_argument("--status-file", "-p", default=None, type=_existing_path,
                   help="JSON snapshot the service writes after every step "
                        "(OptimizationService(status_path=...))")
    p.add_argument("--fleet-dir", "-d", default=None, type=_existing_dir,
                   help="fleet directory (FleetSupervisor(fleet_dir=...)): "
                        "aggregate every worker's status file plus the "
                        "supervisor state — per-worker liveness, the tenant "
                        "placement table, and the migration history")
    p.add_argument("--as-json", dest="as_json", action="store_true",
                   help="emit the raw snapshot JSON instead of the table")
    p.add_argument("--watch", "-w", default=0.0, type=float,
                   help="re-render from the status file every N seconds "
                        "(live operation; Ctrl-C to stop)")
    p.set_defaults(func=status)

    p = sub.add_parser("fleet", help="roll stores up into a fleet summary",
                       description=fleet.__doc__)
    p.add_argument("--file-path", "-p", dest="file_paths", action="append",
                   default=[], type=_existing_path,
                   help="HDF5 store to scan (repeatable; results stores and "
                        "service checkpoints both work)")
    p.add_argument("--dir", "-d", dest="fleet_dirs", action="append",
                   default=[], type=_existing_dir,
                   help="fleet directory (repeatable): scan every worker "
                        "checkpoint and per-tenant results store it holds "
                        "(workers/*/checkpoint.h5 + results/*.h5)")
    p.add_argument("--signature", "-s", default=None,
                   help="only report this problem signature (d<dim>_o<nobj>)")
    p.add_argument("--output-file", "-o", type=str, default=None,
                   help="write the full fleet-summary JSON here")
    p.add_argument("--as-json", dest="as_json", action="store_true",
                   help="emit the fleet-summary JSON to stdout instead of "
                        "the table")
    p.set_defaults(func=fleet)
    return parser


def main(argv=None) -> int:
    """Console entry point: run one subcommand; returns the exit code
    (0, 1 for a command error, 2 for a usage error)."""
    parser = build_parser()
    try:
        args = parser.parse_args(argv)
    except SystemExit as e:  # usage errors and --help
        return int(e.code or 0)
    if args.command is None:
        parser.print_help(sys.stderr)
        return 2
    try:
        args.func(args)
    except CommandError as e:
        echo(f"Error: {e}", err=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
