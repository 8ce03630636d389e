"""The port's HDF5 store, save and resume, held against the JAX package.

- The same synthetic archive written through `dmosopt_tpu.storage` and
  through `dmosopt_tpu_torch.storage` gives files with the same
  datasets, dtypes, shapes, values and (parsed) attributes, and each
  package's reader loads the other's file.
- A store written by the JAX package's storage functions restores in
  the JAX driver and in the port's to the same start epoch, archive,
  epoch labels and remaining initial requests.
- A port run saves and resumes on one file (tests/test_storage.py's
  resume oracle), and the file loads through the JAX package's reader.
- The surrogate refit state written by either package's
  `save_refit_state_to_h5` reads back through the other's
  `load_refit_state_from_h5`; a warm port run stores it every epoch and
  its resumed run's controller starts warm from it.
"""

import json
import sys

import h5py
import numpy as np
import pytest
import torch
from scipy.spatial.distance import cdist

torch.set_num_threads(1)

import dmosopt_tpu.driver as jax_driver
from dmosopt_tpu import datatypes as jax_dt
from dmosopt_tpu import sampling as jax_sampling
from dmosopt_tpu import storage as jax_storage

import dmosopt_tpu_torch
import dmosopt_tpu_torch.driver as port_driver
from dmosopt_tpu_torch import datatypes as port_dt
from dmosopt_tpu_torch import storage as port_storage

N_DIM = 4

SPACE = {"a": {"x": [0.0, 1.0], "y": [-2.0, 3.0]}, "b": [0.0, 10.0, True], "c": [0.5, 1.5]}
PROBLEM_PARAMETERS = {"k": 3, "w": 0.25}


def zdt1_obj(pp):
    x = np.array([pp[f"x{i}"] for i in range(N_DIM)])
    f1 = x[0]
    g = 1.0 + 9.0 / (N_DIM - 1) * np.sum(x[1:])
    return np.array([f1, g * (1.0 - np.sqrt(f1 / g))])


def _write_archive(pkg, dt, fpath):
    """One synthetic run through a package's storage functions: the
    store's header, two appends (float32 rows among them, as the EA's
    resamples are), and one epoch's surrogate evaluations, optimizer
    parameters and stats."""
    rng = np.random.default_rng(3)
    spec = dt.ParameterSpace.from_dict(SPACE)
    pp = dt.ParameterSpace.from_dict(PROBLEM_PARAMETERS, is_value_only=True)
    names = spec.parameter_names
    pkg.init_h5("run", {0}, False, spec, names, ["f1", "f2"], None, ["c0"], pp,
                {"note": "synthetic", "n": np.int64(2)}, 11, fpath)
    for epoch, n_rows, dtype in ((0, 5, np.float64), (1, 3, np.float32)):
        rows = {0: (
            [epoch] * n_rows,
            list(rng.random((n_rows, len(names))).astype(dtype)),
            list(rng.random((n_rows, 2))),
            None,
            list(rng.random((n_rows, 1))),
            [[np.nan, np.nan]] * n_rows if epoch == 0 else list(rng.random((n_rows, 2))),
        )}
        pkg.save_to_h5("run", {0}, False, ["f1", "f2"], None, ["c0"], spec, rows,
                       pp, None, 11, fpath)
    pkg.save_surrogate_evals_to_h5(
        "run", 0, names, ["f1", "f2"], 1, np.arange(6) // 2,
        rng.random((6, len(names))).astype(np.float32), rng.random((6, 2)), fpath,
    )
    pkg.save_optimizer_params_to_h5(
        "run", 0, 1, "NSGA2",
        {"popsize": 16, "mutation_rate": 0.25, "di": np.array([1.0, 20.0]),
         "sampling_method": "slh", "bounds": {"lo": 0}}, fpath,
    )
    pkg.save_stats_to_h5("run", 0, 1, fpath, stats={
        "train_s": 0.5, "n_generations": 5, "objective": {"n_steps": 20},
    })


def _contents(fpath):
    """{path: (kind, dtype, shape, value)} for every group and dataset,
    with JSON string attributes parsed."""
    out = {}

    def attrs(obj):
        parsed = {}
        for k, v in obj.attrs.items():
            if isinstance(v, str):
                try:
                    v = json.loads(v)
                except json.JSONDecodeError:
                    pass
            elif isinstance(v, np.ndarray):
                v = (v.dtype.str, v.tolist())
            parsed[k] = v
        return parsed

    def visit(name, obj):
        if isinstance(obj, h5py.Dataset):
            out[name] = ("dataset", obj.dtype.str, obj.shape, obj.maxshape,
                         np.asarray(obj[()]), attrs(obj))
        else:
            out[name] = ("group", attrs(obj))

    with h5py.File(fpath, "r") as h5:
        h5.visititems(visit)
    return out


def _assert_same_contents(a, b):
    assert sorted(a) == sorted(b)
    for name in a:
        if a[name][0] == "group":
            assert a[name] == b[name], name
            continue
        kind, dtype, shape, maxshape, value, attrs = a[name]
        assert (dtype, shape, maxshape, attrs) == b[name][1:4] + (b[name][5],), name
        np.testing.assert_array_equal(value, b[name][4], err_msg=name)


def _same_raw(a, b):
    for key in ("random_seed", "problem_ids", "has_problem_ids", "metadata",
                "parameter_names", "objective_names", "feature_dtypes",
                "constraint_names"):
        assert a[key] == b[key], key
    assert a["parameter_space"].parameter_names == b["parameter_space"].parameter_names
    np.testing.assert_array_equal(a["parameter_space"].bound1, b["parameter_space"].bound1)
    np.testing.assert_array_equal(a["parameter_space"].bound2, b["parameter_space"].bound2)
    assert [(i.name, i.value) for i in a["problem_parameters"].items] == [
        (i.name, i.value) for i in b["problem_parameters"].items
    ]
    for ea, eb in zip(a["evals"][0], b["evals"][0], strict=True):
        for fa, fb in zip(ea, eb, strict=True):
            np.testing.assert_array_equal(fa, fb)


def test_store_schema_and_contents_match_jax_storage(tmp_path):
    jax_fp, port_fp = str(tmp_path / "jax.h5"), str(tmp_path / "port.h5")
    _write_archive(jax_storage, jax_dt, jax_fp)
    _write_archive(port_storage, port_dt, port_fp)
    _assert_same_contents(_contents(jax_fp), _contents(port_fp))
    with h5py.File(port_fp, "r") as h5:
        assert h5["run/0/epochs"].dtype == np.uint32
        assert h5["run/0/parameters"].dtype == np.float64
        assert h5["run/0/parameters"].maxshape == (None, 4)

    # each package's reader loads the other's file to equal contents
    for fp in (jax_fp, port_fp):
        _same_raw(jax_storage.h5_load_raw(fp, "run"), port_storage.h5_load_raw(fp, "run"))
    _same_raw(jax_storage.h5_load_raw(port_fp, "run"), port_storage.h5_load_raw(jax_fp, "run"))
    jax_state = jax_storage.init_from_h5(port_fp, None, "run")
    port_state = port_storage.init_from_h5(jax_fp, None, "run")
    assert jax_state[1] == port_state[1] == 1  # max epoch


def test_save_without_h5py_raises(tmp_path, monkeypatch):
    """With h5py unimportable nothing raises any more: the port writes
    the store with its own HDF5 module, and h5py reads it back."""
    fp = str(tmp_path / "none.h5")
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "h5py", None)
        port_driver.DistOptimizer(
            "noh5", zdt1_obj, space={"x0": [0.0, 1.0]}, problem_parameters={},
            objective_names=["f1", "f2"], save=True, file_path=fp, device="cpu",
        )
    with h5py.File(fp, "r") as h5:
        assert json.loads(h5["noh5"].attrs["objective_names"]) == ["f1", "f2"]
        assert json.loads(h5["noh5"].attrs["parameter_space"])[0]["name"] == "x0"


def _params(fp, **over):
    params = {
        "opt_id": "torch_store",
        "obj_fun": zdt1_obj,
        "objective_names": ["f1", "f2"],
        "space": {f"x{i}": [0.0, 1.0] for i in range(N_DIM)},
        "problem_parameters": {},
        "n_initial": 3,
        "n_epochs": 2,
        "population_size": 16,
        "num_generations": 5,
        "resample_fraction": 0.5,
        "surrogate_method_name": "gpr",
        "surrogate_method_kwargs": {"n_starts": 2, "n_iter": 20, "seed": 0},
        "random_seed": 21,
        "file_path": str(fp),
        "save": True,
        "save_eval": 5,
        "save_surrogate_evals": True,
    }
    params.update(over)
    return params


@pytest.mark.parametrize("n_design", [7, 12])
def test_jax_written_store_resumes_like_the_jax_driver(tmp_path, n_design):
    """Part (7 rows) or all (12) of the SLH design of 3 points per
    dimension, plus 3 resampled rows labelled epoch 1, one of them a
    copy of a design point not evaluated yet, written by the JAX
    package's storage functions."""
    fp = str(tmp_path / "jax.h5")
    params = _params(fp, save=False)
    spec = jax_dt.ParameterSpace.from_dict(params["space"])
    design = jax_sampling.slh(3 * N_DIM, N_DIM, np.random.default_rng(21), maxiter=5)
    resampled = np.random.default_rng(5).random((3, N_DIM)).astype(np.float32)
    resampled[0] = design[-2]
    x = np.vstack([design[:n_design], resampled])
    epochs = [0] * n_design + [1] * 3
    jax_storage.init_h5("torch_store", {0}, False, spec, spec.parameter_names,
                        ["f1", "f2"], None, None, None, None, 21, fp)
    jax_storage.save_to_h5(
        "torch_store", {0}, False, ["f1", "f2"], None, None, spec,
        {0: (epochs, list(x), [zdt1_obj(dict(zip(spec.parameter_names, r))) for r in x],
             None, None, [[np.nan, np.nan]] * len(x))},
        None, None, 21, fp,
    )

    jd = jax_driver.dopt_init({**params, "telemetry": False}, initialize_strategy=True)
    pd = port_driver.dopt_init({**params, "device": "cpu"}, initialize_strategy=True)
    assert pd.start_epoch == jd.start_epoch == (2 if n_design == 12 else 1)
    js, ps = jd.optimizer_dict[0], pd.optimizer_dict[0]
    np.testing.assert_array_equal(ps.x, js.x)
    np.testing.assert_array_equal(ps.y, js.y)
    np.testing.assert_array_equal(
        np.concatenate([e.epoch for e in pd.old_evals[0]]),
        np.concatenate([e.epoch for e in jd.old_evals[0]]),
    )
    remaining = []
    for strat in (js, ps):
        reqs = []
        while (req := strat.get_next_request()) is not None:
            reqs.append(req.parameters)
        remaining.append(np.array(reqs).reshape(-1, N_DIM))
    np.testing.assert_array_equal(remaining[1], remaining[0])
    # the design skips the 10 stored rows and drops the stored copy
    assert remaining[1].shape[0] == (1 if n_design == 7 else 0)


def test_save_and_resume_end_to_end(tmp_path):
    fp = tmp_path / "resume.h5"
    dmosopt_tpu_torch.run(_params(fp), device="cpu", verbose=False)
    with h5py.File(fp, "r") as h5:
        n_before = h5["torch_store/0/parameters"].shape[0]
        max_epoch_before = int(h5["torch_store/0/epochs"][:].max())

    dmosopt_tpu_torch.run(_params(fp), device="cpu", verbose=False)
    dopt = port_driver.dopt_dict["torch_store"]
    assert dopt.start_epoch == max_epoch_before + 1
    assert [s["epoch"] for s in dopt.epoch_stats] == [2, 3]
    with h5py.File(fp, "r") as h5:
        grp = h5["torch_store/0"]
        X, epochs = grp["parameters"][:], grp["epochs"][:]
        # the JAX driver writes these for epochs after 0 that resample:
        # of 0, 1 and 2, 3 only epoch 2
        assert sorted(grp["surrogate_evals"]) == ["2"]
        assert sorted(grp["optimizer_params"]) == ["2"]
        assert sorted(grp["optimizer_stats"]) == ["0", "1", "2", "3"]
        assert grp["optimizer_params/2"].attrs["optimizer_name"] == "NSGA2"
    assert X.shape[0] > n_before
    assert int(epochs.max()) == max_epoch_before + 2
    # the log holds every evaluation. A row repeats only where the
    # resample dedupe's masked triangle (the JAX package's semantics, a
    # known fault of both packages) let a candidate equal to an archived
    # row through: always a resample row (epoch >= 1), never the resumed
    # run's initial design; the archive keeps each distinct row once
    D = cdist(X, X)
    repeats = np.array([bool(np.any(D[j, :j] < 1e-12)) for j in range(len(X))])
    assert np.all(epochs[repeats] >= 1)
    assert X.shape[0] - repeats.sum() == dopt.optimizer_dict[0].x.shape[0]

    names = [f"x{i}" for i in range(N_DIM)]
    jax_state = jax_storage.init_from_h5(str(fp), names, "torch_store")
    port_state = port_storage.init_from_h5(str(fp), names, "torch_store")
    assert jax_state[0] == port_state[0] == 21
    assert jax_state[1] == port_state[1] == int(epochs.max())
    for ea, eb in zip(jax_state[2][0], port_state[2][0], strict=True):
        np.testing.assert_array_equal(ea.parameters, eb.parameters)
        np.testing.assert_array_equal(ea.objectives, eb.objectives)
        np.testing.assert_array_equal(ea.epoch, eb.epoch)

    # the problem definition alone restores from the file
    from_file = port_driver.DistOptimizer(
        "torch_store", zdt1_obj, file_path=str(fp), device="cpu",
    )
    assert from_file.param_names == names
    assert from_file.objective_names == ["f1", "f2"]


def test_resample_dedupe_matches_the_jax_package():
    """The port marks duplicates as `dmosopt_tpu.moasmo.get_duplicates`
    does, within one set and for resample candidates against an archive
    (the masked triangle: candidate i meets only archive rows j < i)."""
    from dmosopt_tpu import moasmo as jax_moasmo
    from dmosopt_tpu_torch import moasmo as port_moasmo

    X = np.random.default_rng(0).random((12, 3)).astype(np.float32)
    X[[4, 9]] = X[[1, 2]]
    np.testing.assert_array_equal(
        port_moasmo.get_duplicates(X, device="cpu"), jax_moasmo.get_duplicates(X)
    )
    cand = np.array([[0.0, 0.0], [5.0, 5.0], [1.0, 1.0]])
    archive = np.array([[1.0, 1.0], [0.0, 0.0]])
    want = jax_moasmo.get_duplicates(cand, archive)
    assert want.tolist() == [False, False, True]
    np.testing.assert_array_equal(
        port_moasmo.get_duplicates(cand, archive, device="cpu"), want
    )
    # more candidates than archive rows, and the reverse
    rng = np.random.default_rng(1)
    arch = rng.random((5, 3))
    cands = np.concatenate([arch[[3, 0]], rng.random((4, 3)), arch[[1, 4]]])
    for a, b in ((cands, arch), (arch, cands)):
        np.testing.assert_array_equal(
            port_moasmo.get_duplicates(a, b, device="cpu"),
            jax_moasmo.get_duplicates(a, b),
        )


REFIT_STATE = {
    "amp": [1.5, 0.25], "ls": [[0.3], [2.0]], "noise": [1e-6, 3e-4],
    "eff_noise": [1.5e-4, 3.3e-4], "stable": 2, "warm_wins": 1,
    "fits_since_audit": 3, "n_train": 57, "n_iter_max": 200,
}


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_refit_state_written_by_one_package_reads_in_the_other(tmp_path, writer):
    fp = str(tmp_path / "refit.h5")
    save, load = (
        (jax_storage.save_refit_state_to_h5, port_storage.load_refit_state_from_h5)
        if writer == "jax"
        else (port_storage.save_refit_state_to_h5, jax_storage.load_refit_state_from_h5)
    )
    save("run", 0, {"amp": [0.0]}, fp)
    save("run", 0, REFIT_STATE, fp)  # the latest epoch's state wins
    assert load(fp, "run", 0) == REFIT_STATE
    assert load(fp, "run", 1) is None


def test_warm_run_stores_its_refit_state_and_resumes_warm(tmp_path):
    fp = tmp_path / "warm.h5"
    params = _params(fp, opt_id="torch_warm", surrogate_refit="warm", n_epochs=3)
    dmosopt_tpu_torch.run(params, device="cpu", verbose=False)
    first = port_driver.dopt_dict["torch_warm"].optimizer_dict[0].refit_controller
    assert first.path_history[0] == "cold" and len(first.path_history) == 3
    state = jax_storage.load_refit_state_from_h5(str(fp), "torch_warm", 0)
    assert state == json.loads(json.dumps(first.export_state()))

    dmosopt_tpu_torch.run(params, device="cpu", verbose=False)
    resumed = port_driver.dopt_dict["torch_warm"].optimizer_dict[0].refit_controller
    assert resumed.path_history[0] == "warm", resumed.path_history


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_mean_variance_store_resumes_in_the_other_package(tmp_path, writer):
    """A store of a mean-variance run keeps 2·d prediction columns, [mean,
    variance], and the ``surrogate_mean_variance`` attribute. One written
    by the port's run resumes in the JAX driver as in the port's; one
    written by the JAX package's storage functions (the design, then 3
    resampled rows with 4-wide predictions) resumes in a port run, which
    appends rows of the same width that the JAX package's reader loads."""
    fp = str(tmp_path / f"{writer}_mv.h5")
    params = _params(fp, optimize_mean_variance=True)
    names = list(params["space"])
    if writer == "torch":
        dmosopt_tpu_torch.run(params, device="cpu", verbose=False)
        jd = jax_driver.dopt_init({**params, "telemetry": False}, initialize_strategy=True)
        pd = port_driver.dopt_init({**params, "device": "cpu"}, initialize_strategy=True)
        assert pd.start_epoch == jd.start_epoch == 2
        np.testing.assert_array_equal(pd.optimizer_dict[0].x, jd.optimizer_dict[0].x)
        np.testing.assert_array_equal(pd.optimizer_dict[0].y, jd.optimizer_dict[0].y)
    else:
        spec = jax_dt.ParameterSpace.from_dict(params["space"])
        design = jax_sampling.slh(3 * N_DIM, N_DIM, np.random.default_rng(21), maxiter=5)
        resampled = np.random.default_rng(5).random((3, N_DIM))
        x = np.vstack([design, resampled])
        y = [zdt1_obj(dict(zip(names, r))) for r in x]
        pred = [[np.nan] * 4] * len(design) + [list(v) + [0.01, 0.02] for v in y[-3:]]
        jax_storage.init_h5("torch_store", {0}, False, spec, names, ["f1", "f2"], None,
                            None, None, None, 21, fp, surrogate_mean_variance=True)
        jax_storage.save_to_h5("torch_store", {0}, False, ["f1", "f2"], None, None, spec,
                               {0: ([0] * len(design) + [1] * 3, list(x), y, None, None,
                                    pred)},
                               None, None, 21, fp, surrogate_mean_variance=True)
        dmosopt_tpu_torch.run(_params(fp, optimize_mean_variance=True, n_epochs=2),
                              device="cpu", verbose=False)
        assert port_driver.dopt_dict["torch_store"].start_epoch == 2
    with h5py.File(fp, "r") as h5:
        grp = h5["torch_store"]
        assert bool(grp.attrs["surrogate_mean_variance"])
        P = grp["0/predictions"][:]
        epochs = grp["0/epochs"][:]
    assert P.shape[1] == 4
    resampled = P[epochs >= 1]
    assert resampled.shape[0] >= 3 and np.all(np.isfinite(resampled))
    assert np.all(resampled[:, 2:] >= 0.0)
    state = jax_storage.init_from_h5(fp, names, "torch_store")
    assert sum(1 for e in state[2][0] if e.prediction.shape == (4,)) == P.shape[0]


FEATURES = [("x_sum", "<f8"), ("g", "<f8")]


def problems_obj(mpp):
    """ZDT1 of each problem's parameter dict, shifted by its id, with a
    structured feature record."""
    out = {}
    for pid, pp in mpp.items():
        x = np.array([pp[f"x{i}"] for i in range(N_DIM)])
        y = zdt1_obj(pp)
        g = 1.0 + 9.0 / (N_DIM - 1) * np.sum(x[1:])
        out[pid] = (y + pid, np.array([(x.sum(), g + pid)], dtype=FEATURES))
    return out


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_problems_and_features_store_resumes_in_the_other_package(tmp_path, writer):
    """A store of three problems with features, written by one package's
    driver (the initial designs evaluated and saved), resumes in both
    drivers with the same problems, the same archive per problem and
    float64-equal feature columns; the port's resumed run then appends
    to each problem's group, and the JAX package's reader loads it."""
    fp = str(tmp_path / f"{writer}_problems.h5")
    params = _params(fp, obj_fun=problems_obj, problem_ids={0, 1, 2},
                     feature_dtypes=FEATURES, save_eval=50)
    if writer == "jax":
        w = jax_driver.dopt_init({**params, "telemetry": False}, initialize_strategy=True)
    else:
        w = port_driver.dopt_init({**params, "device": "cpu"}, initialize_strategy=True)
    w._process_requests()
    w._flush_writes()
    w._close_writer()
    jd = jax_driver.dopt_init({**params, "telemetry": False}, initialize_strategy=True)
    pd = port_driver.dopt_init({**params, "device": "cpu"}, initialize_strategy=True)
    assert pd.problem_ids == jd.problem_ids == {0, 1, 2} and pd.has_problem_ids
    assert [tuple(d) for d in pd.feature_dtypes] == [tuple(d) for d in jd.feature_dtypes]
    assert pd.start_epoch == jd.start_epoch == 1
    for pid in (0, 1, 2):
        js, ps = jd.optimizer_dict[pid], pd.optimizer_dict[pid]
        assert ps.x.shape == (3 * N_DIM, N_DIM)
        np.testing.assert_array_equal(ps.x, js.x)
        np.testing.assert_array_equal(ps.y, js.y)
        np.testing.assert_array_equal(ps.f, js.f)
        np.testing.assert_allclose(ps.y[:, 0] - pid, ps.x[:, 0], rtol=1e-12, atol=1e-15)
        np.testing.assert_allclose(ps.f[:, 0], ps.x.sum(axis=1), rtol=1e-12)
    best = dmosopt_tpu_torch.run(params, device="cpu", verbose=False, return_features=True)
    assert sorted(best) == [0, 1, 2]
    assert all(best[pid][2].dtype.names == ("x_sum", "g") for pid in best)
    state = jax_storage.init_from_h5(fp, list(params["space"]), "torch_store")
    assert state[8] == {0, 1, 2} and state[5] is not None
    for pid in (0, 1, 2):
        epochs = np.concatenate([e.epoch for e in state[2][pid]])
        assert epochs.max() == 2 and len(state[2][pid]) > 3 * N_DIM
        assert all(e.features.shape == (2,) for e in state[2][pid])
