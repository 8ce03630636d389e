"""HDF5 persistence: the append-only store that `run()` saves to and
resumes from.

Port of ``dmosopt_tpu/storage.py``, the part the driver's run uses, with
the same schema, so a file written by either package loads in the
other: one group per ``opt_id`` holding the stored seed, the problem
ids and JSON attributes for the parameter space, problem parameters,
names and metadata; per problem, resizable ``uint32`` epoch labels and
``float64`` parameter, objective, prediction (and optional feature and
constraint) logs; per epoch, the surrogate's evaluations, the
optimizer's parameters and the runtime stats. numpy and h5py only: the
callers hand over host arrays.

Layout:
    /{opt_id}/random_seed, problem_ids, metadata(json), parameter_space(json),
              problem_parameters(json), objective_names(json),
              feature_dtypes(json), constraint_names(json)
    /{opt_id}/{problem_id}/epochs        (N,)      uint32
    /{opt_id}/{problem_id}/parameters    (N, n)    float64
    /{opt_id}/{problem_id}/objectives    (N, d)    float64
    /{opt_id}/{problem_id}/features      (N, ...)  float64   [optional]
    /{opt_id}/{problem_id}/constraints   (N, m)    float64   [optional]
    /{opt_id}/{problem_id}/predictions   (N, d|2d) float64
    /{opt_id}/{problem_id}/surrogate_evals/{epoch}/{gen_index,x,y}
    /{opt_id}/{problem_id}/optimizer_params/{epoch}  (json attrs)
    /{opt_id}/{problem_id}/optimizer_stats/{epoch}   (json attrs)
    /{opt_id}/{problem_id}.attrs["surrogate_refit"]  (json, latest epoch)
    /{opt_id}/telemetry.attrs[{epoch}]               (json epoch summary)
    /{opt_id}/telemetry_spans/{epoch}                (json string dataset)
    /{opt_id}/telemetry_alerts/{epoch}               (json string dataset)

Not ported yet: the fronts and the service checkpoint.
"""

from __future__ import annotations

import json
from typing import Dict, Optional

import numpy as np

from dmosopt_tpu_torch.datatypes import (
    EvalEntry,
    ParameterDefn,
    ParameterSpace,
)
from dmosopt_tpu_torch.utils import json_default


def _require_h5py():
    try:
        import h5py
    except ImportError as e:
        raise RuntimeError(
            "h5py is required for HDF5 persistence but is not installed"
        ) from e
    return h5py


def h5_get_group(h, groupname):
    return h[groupname] if groupname in h.keys() else h.create_group(groupname)


def h5_get_dataset(g, dsetname, **kwargs):
    if dsetname in g.keys():
        return g[dsetname]
    kwargs["maxshape"] = (None,) + tuple(kwargs.get("shape", (0,)))[1:]
    return g.create_dataset(dsetname, **kwargs)


def h5_concat_dataset(dset, data):
    """Append rows to a resizable dataset."""
    dsize = dset.shape[0]
    newshape = (dsize + data.shape[0],) + dset.shape[1:]
    dset.resize(newshape)
    dset[dsize:] = data
    return dset


def _column_safe(dtype) -> bool:
    """Dtypes that cast losslessly to the float64 column archive
    (complex and timedelta64 do not)."""
    if np.issubdtype(dtype, np.complexfloating) or np.issubdtype(
        dtype, np.timedelta64
    ):
        return False
    return np.issubdtype(dtype, np.number) or np.issubdtype(dtype, np.bool_)


def non_numeric_feature_fields(dtype) -> list:
    """Field names of a structured dtype that cannot be archived as
    float64 columns (empty list for a plain dtype that can)."""
    if dtype.names:
        return [n for n in dtype.names if not _column_safe(dtype[n].base)]
    return [] if _column_safe(dtype) else [str(dtype)]


def feature_columns(f) -> np.ndarray:
    """Feature record -> flat float64 columns: structured records flatten
    to their fields in declaration order, plain arrays cast directly.
    Numeric fields only (decided by dtype, so a string like "12" is
    refused rather than silently cast)."""
    arr = np.asarray(f)
    bad = non_numeric_feature_fields(arr.dtype)
    if bad:
        raise TypeError(
            f"feature fields {bad} are not numeric; only numeric "
            f"feature fields can be archived/persisted"
        )
    if arr.dtype.names:
        from numpy.lib.recfunctions import structured_to_unstructured

        arr = structured_to_unstructured(arr, dtype=np.float64)
    return np.asarray(arr, dtype=np.float64)


# ----------------------------------------------------- space serialization


def _space_to_json(space: Optional[ParameterSpace]) -> str:
    if space is None:
        return json.dumps(None, default=json_default)
    items = []
    for leaf in space.items:
        if isinstance(leaf, ParameterDefn):
            items.append({
                "name": leaf.name, "lower": leaf.lower, "upper": leaf.upper,
                "is_integer": bool(leaf.is_integer),
            })
        else:
            items.append({
                "name": leaf.name, "value": leaf.value,
                "is_integer": bool(leaf.is_integer),
            })
    return json.dumps(items, default=json_default)


def _space_from_json(s: str, is_value_only: bool = False) -> Optional[ParameterSpace]:
    items = json.loads(s)
    if items is None:
        return None
    config: Dict = {}
    for item in items:
        path = item["name"].split(".")
        cur = config
        for key in path[:-1]:
            cur = cur.setdefault(key, {})
        if "value" in item:
            cur[path[-1]] = item["value"]
        else:
            cur[path[-1]] = [item["lower"], item["upper"], item["is_integer"]]
    return ParameterSpace.from_dict(config, is_value_only=is_value_only)


def _json_attr(grp, name, value):
    grp.attrs[name] = json.dumps(value, default=json_default)


def _load_json_attr(grp, name, default=None):
    if name in grp.attrs:
        return json.loads(grp.attrs[name])
    return default


def _feature_dtype_from_json(entry):
    """JSON entry [name, dtype] or [name, dtype, shape] -> dtype tuple
    (the shape may be a bare int in older stores)."""
    if len(entry) <= 2:
        return tuple(entry[:2])
    shape = (
        tuple(entry[2]) if isinstance(entry[2], (list, tuple)) else (int(entry[2]),)
    )
    return (entry[0], entry[1], shape)


# ------------------------------------------------------------------- init


def init_h5(
    opt_id, problem_ids, has_problem_ids, spec: ParameterSpace, param_names,
    objective_names, feature_dtypes, constraint_names,
    problem_parameters: Optional[ParameterSpace], metadata, random_seed, fpath,
    surrogate_mean_variance: bool = False,
):
    """Create the run's group and its problem-definition attributes."""
    h5py = _require_h5py()
    with h5py.File(fpath, "a") as h5:
        opt_grp = h5_get_group(h5, opt_id)
        if random_seed is not None:
            opt_grp["random_seed"] = random_seed
        opt_grp["problem_ids"] = np.asarray(sorted(problem_ids), dtype=np.int64)
        opt_grp.attrs["has_problem_ids"] = bool(has_problem_ids)
        opt_grp.attrs["surrogate_mean_variance"] = bool(surrogate_mean_variance)
        _json_attr(opt_grp, "metadata", metadata)
        opt_grp.attrs["parameter_space"] = _space_to_json(spec)
        opt_grp.attrs["problem_parameters"] = _space_to_json(problem_parameters)
        _json_attr(opt_grp, "parameter_names", list(param_names))
        _json_attr(opt_grp, "objective_names", list(objective_names))
        _json_attr(
            opt_grp, "feature_dtypes",
            [
                # canonical dtype string, plus the subarray shape as a list
                [dt[0], np.dtype(dt[1]).str]
                + ([np.atleast_1d(dt[2]).astype(int).tolist()] if len(dt) > 2 else [])
                for dt in feature_dtypes
            ]
            if feature_dtypes is not None
            else None,
        )
        _json_attr(
            opt_grp, "constraint_names",
            list(constraint_names) if constraint_names is not None else None,
        )


# ------------------------------------------------------------------ write


def save_to_h5(
    opt_id, problem_ids, has_problem_ids, objective_names, feature_dtypes,
    constraint_names, spec, evals: Dict, problem_parameters, metadata,
    random_seed, fpath, logger=None, surrogate_mean_variance: bool = False,
):
    """Append finished evaluations: ``evals[problem_id]`` is (epochs, x,
    y, f, c, predictions), each a list of per-row host values."""
    h5py = _require_h5py()
    with h5py.File(fpath, "a") as h5:
        opt_grp = h5_get_group(h5, opt_id)
        for problem_id in problem_ids:
            if problem_id not in evals:
                continue
            epochs_c, x_c, y_c, f_c, c_c, pred_c = evals[problem_id]
            if len(x_c) == 0:
                continue
            grp = h5_get_group(opt_grp, str(problem_id))
            epochs = np.asarray(epochs_c, dtype=np.uint32)
            X = np.vstack([np.asarray(x, dtype=np.float64) for x in x_c])
            Y = np.vstack([np.asarray(y, dtype=np.float64) for y in y_c])
            P = np.vstack([np.asarray(p, dtype=np.float64).ravel() for p in pred_c])
            columns = [
                ("epochs", epochs, np.uint32),
                ("parameters", X, np.float64),
                ("objectives", Y, np.float64),
                ("predictions", P, np.float64),
            ]
            if f_c is not None:
                F = np.vstack([feature_columns(f).reshape(1, -1) for f in f_c])
                columns.append(("features", F, np.float64))
            if c_c is not None:
                C = np.vstack(
                    [np.asarray(c, dtype=np.float64).reshape(1, -1) for c in c_c]
                )
                columns.append(("constraints", C, np.float64))
            for name, data, dtype in columns:
                dset = h5_get_dataset(
                    grp, name, dtype=dtype, shape=(0,) + data.shape[1:]
                )
                h5_concat_dataset(dset, data)
    if logger is not None:
        logger.info(f"saved evals to {fpath}")


def save_surrogate_evals_to_h5(
    opt_id, problem_id, param_names, objective_names, epoch, gen_index, x_sm,
    y_sm, fpath, logger=None,
):
    """Store one epoch's surrogate evaluations (the inner EA's points)."""
    h5py = _require_h5py()
    with h5py.File(fpath, "a") as h5:
        grp = h5_get_group(h5, f"{opt_id}/{problem_id}/surrogate_evals/{int(epoch)}")
        grp["gen_index"] = np.asarray(gen_index, dtype=np.uint32)
        grp["x"] = np.asarray(x_sm, dtype=np.float64)
        grp["y"] = np.asarray(y_sm, dtype=np.float64)


def save_optimizer_params_to_h5(
    opt_id, problem_id, epoch, optimizer_name, optimizer_params, fpath, logger=None
):
    """Store one epoch's optimizer hyperparameters as attributes."""
    h5py = _require_h5py()
    with h5py.File(fpath, "a") as h5:
        grp = h5_get_group(h5, f"{opt_id}/{problem_id}/optimizer_params/{int(epoch)}")
        grp.attrs["optimizer_name"] = str(optimizer_name)
        for k, v in (optimizer_params or {}).items():
            try:
                grp.attrs[k] = (
                    v.tolist() if isinstance(v, (np.ndarray, list, tuple)) else v
                )
            except TypeError:
                grp.attrs[k] = str(v)


def save_stats_to_h5(opt_id, problem_id, epoch, fpath, logger=None, stats=None):
    """Store one epoch's runtime stats as attributes."""
    h5py = _require_h5py()
    with h5py.File(fpath, "a") as h5:
        grp = h5_get_group(h5, f"{opt_id}/{problem_id}/optimizer_stats/{int(epoch)}")
        for k, v in (stats or {}).items():
            try:
                grp.attrs[k] = v
            except TypeError:
                grp.attrs[k] = str(v)


def save_telemetry_to_h5(opt_id, epoch, summary, fpath, logger=None):
    """Store one epoch's telemetry summary (`Telemetry.epoch_summary`)
    under ``/{opt_id}/telemetry``, one JSON attribute keyed by the epoch
    label (``dmosopt_tpu/storage.py:385``); a resumed run that lands on
    the same epoch overwrites it."""
    h5py = _require_h5py()
    with h5py.File(fpath, "a") as h5:
        _json_attr(h5_get_group(h5, f"{opt_id}/telemetry"), str(int(epoch)), summary)


def load_telemetry_from_h5(fpath, opt_id) -> Dict[int, Dict]:
    """Every stored epoch summary, ``{epoch: summary}`` (empty without
    the group)."""
    h5py = _require_h5py()
    with h5py.File(fpath, "r") as h5:
        key = f"{opt_id}/telemetry"
        if key not in h5:
            return {}
        grp = h5[key]
        return {int(k): json.loads(grp.attrs[k]) for k in grp.attrs}


def _save_json_dataset(group, epoch, items, fpath):
    h5py = _require_h5py()
    with h5py.File(fpath, "a") as h5:
        grp = h5_get_group(h5, group)
        key = str(int(epoch))
        if key in grp:
            del grp[key]
        grp.create_dataset(key, data=json.dumps(items, default=json_default))


def _load_json_datasets(group, fpath) -> Dict[int, list]:
    h5py = _require_h5py()
    out: Dict[int, list] = {}
    with h5py.File(fpath, "r") as h5:
        grp = h5.get(group)
        if grp is None:
            return out
        for key in grp:
            raw = grp[key][()]
            if isinstance(raw, bytes):
                raw = raw.decode()
            out[int(key)] = json.loads(raw)
    return dict(sorted(out.items()))


def save_spans_to_h5(opt_id, epoch, spans, fpath, logger=None):
    """Store one epoch's closed spans (`Span.to_dict` dicts) as one JSON
    string dataset ``/{opt_id}/telemetry_spans/{epoch}``
    (``dmosopt_tpu/storage.py:398``): a dataset, since an epoch's spans
    can pass the HDF5 attribute size limit."""
    _save_json_dataset(f"{opt_id}/telemetry_spans", epoch, spans, fpath)


def load_spans_from_h5(fpath, opt_id) -> Dict[int, list]:
    """Every stored epoch's spans, ``{epoch: [span dicts]}``."""
    return _load_json_datasets(f"{opt_id}/telemetry_spans", fpath)


def save_alerts_to_h5(opt_id, epoch, alerts, fpath, logger=None):
    """Store one epoch's health-alert transitions (`HealthEngine`
    transition dicts) as ``/{opt_id}/telemetry_alerts/{epoch}``
    (``dmosopt_tpu/storage.py:431``)."""
    _save_json_dataset(f"{opt_id}/telemetry_alerts", epoch, alerts, fpath)


def load_alerts_from_h5(fpath, opt_id) -> Dict[int, list]:
    """Every stored epoch's alert transitions, ``{epoch: [dicts]}``."""
    return _load_json_datasets(f"{opt_id}/telemetry_alerts", fpath)


def save_refit_state_to_h5(opt_id, problem_id, state, fpath, logger=None):
    """Store one problem's surrogate warm-refit state (the JSON-able dict
    of `SurrogateRefitController.export_state`) as the JSON attribute
    ``surrogate_refit`` of ``/{opt_id}/{problem_id}``, overwritten each
    epoch (``dmosopt_tpu/storage.py:475``): only the latest converged
    hyperparameters seed a resumed run."""
    h5py = _require_h5py()
    with h5py.File(fpath, "a") as h5:
        grp = h5_get_group(h5, f"{opt_id}/{problem_id}")
        _json_attr(grp, "surrogate_refit", state)


# ------------------------------------------------------------------- read


def load_refit_state_from_h5(fpath, opt_id, problem_id) -> Optional[Dict]:
    """The stored warm-refit state dict of a problem, or None when the
    store has none (a fresh run, cold mode, or an older store)."""
    h5py = _require_h5py()
    with h5py.File(fpath, "r") as h5:
        key = f"{opt_id}/{problem_id}"
        if key not in h5:
            return None
        return _load_json_attr(h5[key], "surrogate_refit")



def h5_load_raw(fpath, opt_id):
    """Everything stored for ``opt_id``: the problem definition and, per
    problem, the evaluation log as `EvalEntry` rows."""
    h5py = _require_h5py()
    out = {}
    with h5py.File(fpath, "r") as h5:
        opt_grp = h5[opt_id]
        out["random_seed"] = (
            int(opt_grp["random_seed"][()]) if "random_seed" in opt_grp else None
        )
        out["problem_ids"] = (
            set(int(i) for i in opt_grp["problem_ids"][:])
            if "problem_ids" in opt_grp
            else {0}
        )
        out["has_problem_ids"] = bool(opt_grp.attrs.get("has_problem_ids", False))
        out["metadata"] = _load_json_attr(opt_grp, "metadata")
        out["parameter_space"] = _space_from_json(opt_grp.attrs["parameter_space"])
        out["problem_parameters"] = _space_from_json(
            opt_grp.attrs["problem_parameters"], is_value_only=True
        )
        out["parameter_names"] = _load_json_attr(opt_grp, "parameter_names")
        out["objective_names"] = _load_json_attr(opt_grp, "objective_names")
        fdt = _load_json_attr(opt_grp, "feature_dtypes")
        out["feature_dtypes"] = (
            [_feature_dtype_from_json(entry) for entry in fdt]
            if fdt is not None
            else None
        )
        out["constraint_names"] = _load_json_attr(opt_grp, "constraint_names")

        evals = {}
        for problem_id in out["problem_ids"]:
            key = str(problem_id)
            if key not in opt_grp or "parameters" not in opt_grp[key]:
                evals[problem_id] = []
                continue
            grp = opt_grp[key]
            epochs = grp["epochs"][:]
            X = grp["parameters"][:]
            Y = grp["objectives"][:]
            P, F, C = (
                grp[name][:] if name in grp else None
                for name in ("predictions", "features", "constraints")
            )
            evals[problem_id] = [
                EvalEntry(
                    np.asarray([epochs[i]]), X[i], Y[i],
                    F[i] if F is not None else None,
                    C[i] if C is not None else None,
                    P[i] if P is not None else None,
                    -1.0,
                )
                for i in range(X.shape[0])
            ]
        out["evals"] = evals
    return out


def init_from_h5(fpath, param_names, opt_id, logger=None):
    """Driver state of a previous run: (random_seed, max_epoch,
    old_evals, param_space, objective_names, feature_dtypes,
    constraint_names, problem_parameters, problem_ids)."""
    raw = h5_load_raw(fpath, opt_id)
    param_space = raw["parameter_space"]
    if param_names is not None:
        stored = list(param_space.parameter_names)
        if list(param_names) != stored:
            raise RuntimeError(
                f"init_from_h5: stored parameter names {stored} do not match "
                f"requested parameter names {list(param_names)}"
            )
    max_epoch = -1
    for entries in raw["evals"].values():
        for e in entries:
            if e.epoch is not None:
                max_epoch = max(max_epoch, int(np.max(e.epoch)))
    problem_ids = raw["problem_ids"] if raw["has_problem_ids"] else None
    return (
        raw["random_seed"], max_epoch, raw["evals"], param_space,
        raw["objective_names"], raw["feature_dtypes"], raw["constraint_names"],
        raw["problem_parameters"], problem_ids,
    )
