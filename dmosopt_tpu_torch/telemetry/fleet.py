"""Fleet telemetry rollup: cross-run aggregation of persisted telemetry.

Port of ``dmosopt_tpu/telemetry/fleet.py``. It reads stores through the
port's `storage` loaders (h5py imported only inside `scan_store` and
those loaders) and emits the JAX package's JSON layout, format string
and version included, so both packages' summaries of the same stores
are the same document.

Every run (and every service tenant) persists its observability to
HDF5 — per-epoch telemetry summaries (`/{opt_id}/telemetry`), closed
tracing spans (`/{opt_id}/telemetry_spans`), health-alert transitions
(`/{opt_id}/telemetry_alerts`), warm-refit hyperparameter state
(`/{opt_id}/{problem_id}/surrogate_refit`), and streamed fronts
(`/{opt_id}/fronts`). Until this module, **no code read that data
across runs**: each store was a silo. The fleet rollup scans N stores
(plain results stores and service checkpoints alike) into per-run
records, then folds them into **per-problem-signature distributions**
— converged lengthscales / amplitudes / noise floors (linear and
log10), surrogate fit steps, epochs-to-front, gens/sec, quarantine and
alert rates — emitted as one JSON fleet summary.

This is the data substrate fleet-learned priors will
consume: a new tenant whose problem signature matches the fleet can
warm-start its first GP fit from the signature's log-space
hyperparameter distribution instead of a cold restart grid.

Problem signatures are ``d<dim>_o<nobj>`` — the same axes the tenant
bucketing keys on (`dmosopt_tpu_torch.tenants`), so a fleet prior lookup and
a bucket lookup agree on what "the same kind of problem" means.
"""

from __future__ import annotations

import json
import math
import os
from typing import Any, Dict, List, Optional

import numpy as np

from dmosopt_tpu_torch.utils import json_default

#: bumped when the fleet-summary JSON layout changes incompatibly
FLEET_SUMMARY_VERSION = 1

#: refit-state keys carrying positive hyperparameter vectors
_HYPER_KEYS = ("amp", "ls", "noise")


def problem_signature(dim: Optional[int], n_obj: Optional[int]) -> str:
    return f"d{dim if dim is not None else '?'}_o{n_obj if n_obj is not None else '?'}"


def _dist(values: List[float]) -> Optional[Dict[str, Any]]:
    """count/mean/std/min/max/median over finite values (None when
    nothing finite landed)."""
    arr = np.asarray(
        [float(v) for v in values if v is not None], dtype=np.float64
    )
    arr = arr[np.isfinite(arr)]
    if arr.size == 0:
        return None
    return {
        "count": int(arr.size),
        "mean": float(np.mean(arr)),
        "std": float(np.std(arr)),
        "min": float(np.min(arr)),
        "max": float(np.max(arr)),
        "median": float(np.median(arr)),
    }


def _log10_dist(values: List[float]) -> Optional[Dict[str, Any]]:
    pos = [v for v in values if v is not None and v > 0]
    if not pos:
        return None
    return _dist([math.log10(v) for v in pos])


# ------------------------------------------------------------------- scan


def _summaries_rollup(summaries: Dict[int, Dict]) -> Dict[str, Any]:
    """Fold one run's per-epoch telemetry summaries into run totals."""
    out: Dict[str, Any] = {"epochs": len(summaries)}
    wall = gens = fit_steps = evals = n_train = 0.0
    gps: List[float] = []
    losses: List[float] = []
    for s in summaries.values():
        wall += float(s.get("wall_s") or 0.0)
        gens += float(s.get("n_generations") or 0.0)
        fit_steps += float(s.get("fit_n_steps") or 0.0)
        n_train = max(n_train, float(s.get("n_train") or 0.0))
        ev = s.get("eval") or {}
        evals += float(ev.get("eval_n") or 0.0)
        if s.get("gens_per_sec") is not None:
            gps.append(float(s["gens_per_sec"]))
        if s.get("surrogate_loss") is not None:
            losses.append(float(s["surrogate_loss"]))
    out.update(
        wall_s_total=round(wall, 6),
        gens_total=int(gens),
        fit_steps_total=int(fit_steps),
        evals_total=int(evals),
        n_train_max=int(n_train),
        gens_per_sec_mean=(
            round(sum(gps) / len(gps), 3) if gps else None
        ),
        surrogate_loss_last=(losses[-1] if losses else None),
    )
    return out


def _spans_rollup(spans_by_epoch: Dict[int, list]) -> Dict[str, Dict]:
    """{span_name: {count, seconds}} across one run's persisted spans."""
    out: Dict[str, Dict] = {}
    for spans in spans_by_epoch.values():
        for sp in spans:
            name = sp.get("name", "?")
            g = out.setdefault(name, {"count": 0, "seconds": 0.0})
            g["count"] += 1
            g["seconds"] += float(sp.get("duration_s") or 0.0)
    for g in out.values():
        g["seconds"] = round(g["seconds"], 6)
    return out


def _alerts_rollup(alerts_by_epoch: Dict[int, list]) -> Dict[str, int]:
    """{rule: firing-transition count} across one run's persisted
    health alerts."""
    out: Dict[str, int] = {}
    for alerts in alerts_by_epoch.values():
        for a in alerts:
            if a.get("state") == "firing":
                out[a.get("rule", "?")] = out.get(a.get("rule", "?"), 0) + 1
    return out


def _space_dim(space_json: Optional[str]) -> Optional[int]:
    if not space_json:
        return None
    try:
        items = json.loads(space_json)
    except (TypeError, ValueError):
        return None
    if not isinstance(items, list):
        return None
    return sum(1 for it in items if isinstance(it, dict) and "lower" in it)


def _scan_results_store(path: str, h5) -> List[Dict[str, Any]]:
    from dmosopt_tpu_torch.storage import (
        load_alerts_from_h5,
        load_fronts_from_h5,
        load_refit_state_from_h5,
        load_spans_from_h5,
        load_telemetry_from_h5,
    )

    records = []
    for opt_id in h5.keys():
        grp = h5[opt_id]
        if "parameter_space" not in grp.attrs:
            continue  # not a run group
        dim = _space_dim(grp.attrs.get("parameter_space"))
        obj_names = None
        if "objective_names" in grp.attrs:
            try:
                obj_names = json.loads(grp.attrs["objective_names"])
            except (TypeError, ValueError):
                obj_names = None
        n_obj = len(obj_names) if obj_names else None
        problem_ids = (
            [int(i) for i in grp["problem_ids"][:]]
            if "problem_ids" in grp
            else [0]
        )
        summaries = load_telemetry_from_h5(path, opt_id)
        refit: Dict[str, Any] = {}
        for pid in problem_ids:
            state = load_refit_state_from_h5(path, opt_id, pid)
            if state:
                refit[str(pid)] = {
                    k: state[k] for k in _HYPER_KEYS if k in state
                }
                for extra in ("n_train", "n_iter_max"):
                    if extra in state:
                        refit[str(pid)][extra] = state[extra]
        fronts = load_fronts_from_h5(path, opt_id)
        rec = {
            "store": path,
            "opt_id": opt_id,
            "kind": "store",
            "signature": problem_signature(dim, n_obj),
            "dim": dim,
            "n_obj": n_obj,
            "n_problems": len(problem_ids),
            "telemetry": _summaries_rollup(summaries),
            "spans": _spans_rollup(load_spans_from_h5(path, opt_id)),
            "alerts": _alerts_rollup(load_alerts_from_h5(path, opt_id)),
            "refit": refit,
        }
        if fronts:
            epochs = sorted(fronts)
            rec["fronts"] = {
                "n_epochs": len(epochs),
                "first_epoch": int(epochs[0]),
                "last_epoch": int(epochs[-1]),
            }
            rec["epochs_to_front"] = int(epochs[0]) + 1
        records.append(rec)
    return records


def _scan_service_checkpoint(path: str) -> List[Dict[str, Any]]:
    from dmosopt_tpu_torch.storage import load_service_checkpoint_from_h5

    data = load_service_checkpoint_from_h5(path)
    records = []
    for key in sorted(data["tenants"], key=int):
        tp = data["tenants"][key]
        cfg = tp.get("config") or {}
        st = tp.get("state") or {}
        space = cfg.get("space") or {}
        dim = len(space) if space else None
        names = cfg.get("objective_names")
        n_obj = len(names) if names else None
        refit_state = st.get("refit") or None
        refit = (
            {
                "0": {
                    k: refit_state[k]
                    for k in (*_HYPER_KEYS, "n_train")
                    if k in refit_state
                }
            }
            if refit_state
            else {}
        )
        epochs_run = int(st.get("epochs_run", 0))
        quarantined = int(st.get("quarantined", 0))
        # the checkpoint carries no telemetry summaries, but its archive
        # IS the evaluation record: every archived row was one finite
        # evaluation, and quarantined rows were evaluations the archive
        # rejected — together they are the rate denominator
        x = (tp.get("arrays") or {}).get("x")
        n_archived = int(x.shape[0]) if x is not None else 0
        records.append(
            {
                "store": path,
                "opt_id": st.get("opt_id", f"tenant_{key}"),
                "kind": "service_checkpoint",
                "signature": problem_signature(dim, n_obj),
                "dim": dim,
                "n_obj": n_obj,
                "n_problems": 1,
                "telemetry": {
                    "epochs": epochs_run,
                    "evals_total": n_archived + quarantined,
                },
                "spans": {},
                "alerts": {},
                "refit": refit,
                "quarantined_total": quarantined,
                "eval_failures_total": int(st.get("eval_failures", 0)),
            }
        )
    return records


def scan_store(path: str) -> List[Dict[str, Any]]:
    """All run records in one HDF5 file — a results store yields one
    record per stored ``opt_id``, a service checkpoint one per stored
    tenant. Files of neither format yield an empty list."""
    try:
        import h5py
    except ImportError as e:  # pragma: no cover
        raise RuntimeError(
            "h5py is required for the fleet rollup but is not installed"
        ) from e
    with h5py.File(path, "r") as h5:
        if h5.attrs.get("format") == "dmosopt_tpu.service_checkpoint":
            checkpoint = True
        else:
            checkpoint = False
            records = _scan_results_store(path, h5)
    if checkpoint:
        records = _scan_service_checkpoint(path)
    return records


# ----------------------------------------------------------------- rollup


def _flatten_hyper(refit: Dict[str, Any], key: str) -> List[float]:
    out: List[float] = []
    for state in refit.values():
        v = state.get(key)
        if v is None:
            continue
        out.extend(float(x) for x in np.asarray(v, dtype=np.float64).ravel())
    return out


def rollup(records: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Fold per-run records into the per-signature fleet summary."""
    by_sig: Dict[str, List[Dict]] = {}
    for rec in records:
        by_sig.setdefault(rec["signature"], []).append(rec)

    signatures: Dict[str, Any] = {}
    for sig in sorted(by_sig):
        recs = by_sig[sig]
        amps: List[float] = []
        lss: List[float] = []
        noises: List[float] = []
        n_trains: List[float] = []
        for rec in recs:
            amps.extend(_flatten_hyper(rec.get("refit", {}), "amp"))
            lss.extend(_flatten_hyper(rec.get("refit", {}), "ls"))
            noises.extend(_flatten_hyper(rec.get("refit", {}), "noise"))
            for state in rec.get("refit", {}).values():
                if state.get("n_train") is not None:
                    n_trains.append(float(state["n_train"]))
        alert_totals: Dict[str, int] = {}
        quarantines: List[float] = []
        for rec in recs:
            for rule, n in rec.get("alerts", {}).items():
                alert_totals[rule] = alert_totals.get(rule, 0) + n
            if rec.get("quarantined_total") is not None:
                evals = float(
                    rec.get("telemetry", {}).get("evals_total") or 0
                )
                if evals > 0:  # a true rate needs a real denominator
                    quarantines.append(rec["quarantined_total"] / evals)
        entry = {
            "n_runs": len(recs),
            "n_problems": sum(r.get("n_problems", 1) for r in recs),
            "epochs": _dist(
                [r.get("telemetry", {}).get("epochs") for r in recs]
            ),
            "fit_steps": _dist(
                [r.get("telemetry", {}).get("fit_steps_total") for r in recs]
            ),
            "gens_per_sec": _dist(
                [r.get("telemetry", {}).get("gens_per_sec_mean") for r in recs]
            ),
            "epochs_to_front": _dist(
                [r.get("epochs_to_front") for r in recs]
            ),
            "n_train": _dist(n_trains),
            # the warm-start prior substrate: linear AND
            # log10 distributions of every converged hyperparameter seen
            # for this problem signature across the fleet
            "hyperparameters": {
                "amp": {"linear": _dist(amps), "log10": _log10_dist(amps)},
                "lengthscale": {
                    "linear": _dist(lss), "log10": _log10_dist(lss),
                },
                "noise": {
                    "linear": _dist(noises), "log10": _log10_dist(noises),
                },
            },
            "alert_firings": alert_totals,
            "quarantine_rate": _dist(quarantines),
        }
        signatures[sig] = entry

    return {
        "format": "dmosopt_tpu.fleet_summary",
        "version": FLEET_SUMMARY_VERSION,
        "n_stores": len({r["store"] for r in records}),
        "n_runs": len(records),
        "runs": records,
        "signatures": signatures,
    }


# ------------------------------------------------------- fleet directories


def fleet_dir_stores(fleet_dir: str) -> List[str]:
    """Every HDF5 store a fleet directory holds: per-worker service
    checkpoints (``workers/*/checkpoint.h5``) and per-tenant results
    stores (``results/*.h5``) — the input set `fleet_summary` rolls up
    for a whole fleet in one call (the ``fleet --dir`` CLI path).
    Layout names come from `dmosopt_tpu_torch.fleet.wire` (imported at call
    time — the supervisor side imports this module's sibling package,
    so a module-level import would be a cycle)."""
    from dmosopt_tpu_torch.fleet import wire

    out: List[str] = []
    workers_root = os.path.join(fleet_dir, "workers")
    if os.path.isdir(workers_root):
        for wid in sorted(os.listdir(workers_root)):
            ck = os.path.join(workers_root, wid, wire.CHECKPOINT_FILE)
            if os.path.isfile(ck):
                out.append(ck)
    results_root = wire.results_dir(fleet_dir)
    if os.path.isdir(results_root):
        for name in sorted(os.listdir(results_root)):
            if name.endswith(".h5"):
                out.append(os.path.join(results_root, name))
    return out


def scan_fleet_dir(fleet_dir: str) -> Dict[str, Any]:
    """Aggregate one fleet directory's control plane: the supervisor
    state file (placements, migration history, shed log) plus every
    worker's latest status-file heartbeat — the ``status --fleet-dir``
    CLI's data source. Liveness judgement is the CALLER's (it needs a
    clock); this scan only reports each status's ``ts``."""
    from dmosopt_tpu_torch.fleet import wire

    state = None
    state_path = os.path.join(fleet_dir, wire.FLEET_STATE_FILE)
    if os.path.isfile(state_path):
        try:
            state = wire.read_json(state_path)
        except (OSError, ValueError):
            state = None
    workers: List[Dict[str, Any]] = []
    workers_root = os.path.join(fleet_dir, "workers")
    if os.path.isdir(workers_root):
        for wid in sorted(os.listdir(workers_root)):
            wdir = os.path.join(workers_root, wid)
            if not os.path.isdir(wdir):
                continue
            try:
                status = wire.read_json(os.path.join(wdir, wire.STATUS_FILE))
            except (OSError, ValueError):
                status = None
            workers.append(
                {
                    "worker_id": wid,
                    "dir": wdir,
                    "status": status,
                    "fenced": os.path.exists(
                        os.path.join(wdir, wire.FENCE_FILE)
                    ),
                    "has_checkpoint": os.path.isfile(
                        os.path.join(wdir, wire.CHECKPOINT_FILE)
                    ),
                }
            )
    return {"fleet_dir": fleet_dir, "state": state, "workers": workers}


def fleet_summary(paths: List[str]) -> Dict[str, Any]:
    """Scan every store and fold the records — the one-call entry point
    the ``fleet`` CLI subcommand (and item 5's prior loader) uses."""
    records: List[Dict[str, Any]] = []
    for path in paths:
        if not os.path.exists(path):
            raise FileNotFoundError(f"fleet: store not found: {path}")
        records.extend(scan_store(path))
    return rollup(records)


def write_fleet_summary(paths: List[str], output_path: str) -> Dict[str, Any]:
    summary = fleet_summary(paths)
    tmp = output_path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(summary, fh, indent=2, default=json_default)
    os.replace(tmp, output_path)
    return summary
