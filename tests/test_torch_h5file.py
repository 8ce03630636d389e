"""The port's own HDF5 reader and writer (`dmosopt_tpu_torch.utils.h5file`),
held against h5py in both directions.

- One tree holding every kind of object the stores write (an empty
  resizable log, a 40 000-row log in 512-row chunks whose chunk index
  needs two B-tree levels, 40 subgroups, so several symbol-table nodes,
  one group with over 64 KB of JSON attributes, bool, uint32, int64 and
  float32 values, variable-length strings in attributes and scalar
  datasets) is written by h5py and by the port; both readers read both
  files to the same snapshot.
- Appends both ways: the port appends to h5py's file, h5py resizes,
  appends and splits the index nodes of the port's file, and the port
  appends again.
- Random small trees round-trip through the port's writer and both
  readers (hypothesis, 25 examples).
- A write that fails mid-way leaves the previous file whole and
  unchanged; a writing open excludes a second writer, which then reads
  the first one's file.
- In a subprocess where h5py cannot be imported: a saved and resumed
  `run()`, a checkpointed and resumed 2-tenant service, `scan_store`
  and the CLI's ``analyze``.
"""

import json
import os
import subprocess
import sys
import threading
import time

import h5py
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from hypothesis.extra import numpy as hnp

from dmosopt_tpu_torch.utils import h5file

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_LOG = 40_000
CHUNK_ROWS = 512


def _plain(value):
    """A value read through either module, as something ``==`` compares
    exactly (NaNs included): its type, dtype, shape and bytes."""
    if isinstance(value, (str, bytes)):
        return type(value).__name__, value
    arr = np.asarray(value)
    payload = arr.tolist() if arr.dtype == object else arr.tobytes()
    return type(value).__name__, arr.dtype.str, arr.shape, payload


def _snapshot(f):
    """{path: everything both modules report of the object at path}."""
    out = {}

    def visit(node, path):
        attrs = {k: _plain(node.attrs[k]) for k in node.attrs}
        if isinstance(node, (h5py.Group, h5file.Group)):
            out[path] = ("group", list(node.keys()), attrs)
            for name in node.keys():
                visit(node[name], path.rstrip("/") + "/" + name)
        else:
            out[path] = (
                "dataset", node.shape, node.maxshape, node.chunks,
                node.dtype.str, _plain(node[()]), attrs,
            )

    visit(f, "/")
    return out


def _read_both(path):
    with h5py.File(path, "r") as a:
        by_h5py = _snapshot(a)
    with h5file.File(path, "r") as b:
        by_port = _snapshot(b)
    assert by_h5py == by_port
    return by_port


def _append(dset, rows):
    n = dset.shape[0]
    dset.resize((n + rows.shape[0],) + dset.shape[1:])
    dset[n:] = rows


def _write_cases(mod, path):
    """The store's kinds of objects, through ``mod`` (h5py or the port)."""
    rng = np.random.default_rng(0)
    with mod.File(path, "w") as f:
        f.attrs["format"] = "dmosopt_tpu.service_checkpoint"
        f.attrs["version"] = 2
        f.attrs["flag"] = True
        f.attrs["ratio"] = np.float32(0.5)
        f.attrs["count"] = np.uint32(7)
        f.attrs["big"] = np.int64(-(2 ** 40))
        f.attrs["vec"] = [1.0, 2.5, np.nan]
        f.attrs["names"] = ["f1", "f2", "ünï"]
        run = f.create_group("run")
        run["random_seed"] = 11
        run["problem_ids"] = np.arange(3, dtype=np.int64)
        run.create_dataset("empty", shape=(0, 5), dtype=np.float64, maxshape=(None, 5))
        log = run.create_dataset(
            "0/parameters", shape=(0, 3), dtype=np.float64, maxshape=(None, 3)
        )
        epochs = run.create_dataset("0/epochs", shape=(0,), dtype=np.uint32, maxshape=(None,))
        for n in (1000, N_LOG - 1000):
            _append(log, rng.random((n, 3)))
            _append(epochs, rng.integers(0, 9, n).astype(np.uint32))
        for e in range(40):
            g = run.create_group(f"0/surrogate_evals/{e}")
            g["gen_index"] = np.arange(4, dtype=np.uint32)
            g["x"] = rng.random((4, 2)).astype(np.float32)
        telemetry = run.create_group("telemetry")
        for e in range(80):
            telemetry.attrs[str(e)] = json.dumps({"epoch": e, "pad": "x" * 1000})
        spans = run.create_group("telemetry_spans")
        spans.create_dataset("0", data=json.dumps([{"name": "h5_write", "s": 0.25}]))
        pending = run.create_group("pending")
        pending["has_pred"] = np.array([True, False, True])
        pending["epoch"] = np.array([3, 4], dtype=np.int64)


def test_h5py_files_read_by_the_port_and_port_files_by_h5py(tmp_path):
    by_h5py, by_port = str(tmp_path / "h5py.h5"), str(tmp_path / "port.h5")
    _write_cases(h5py, by_h5py)
    _write_cases(h5file, by_port)
    want = _read_both(by_h5py)
    assert _read_both(by_port) == want
    for fp in (by_h5py, by_port):
        with h5py.File(fp, "r") as h5:
            log = h5["run/0/parameters"]
            # h5py's chunks for an (N, 3) float64 log, as the port's
            assert log.shape == (N_LOG, 3) and log.chunks == (CHUNK_ROWS, 2)
            # one chunk B-tree node holds 64 chunks: this index has two levels
            assert log.id.get_num_chunks() > 64
            assert h5["run/empty"].chunks == (256, 3)  # h5py's guess, as the port's
            assert h5["run/0/epochs"].chunks == (1024,)
            assert len(h5["run/0/surrogate_evals"]) == 40
            assert sum(len(v) for v in h5["run/telemetry"].attrs.values()) > 64 * 1024
    with h5file.File(by_port, "r") as f:
        assert f.attrs["format"] == "dmosopt_tpu.service_checkpoint"
        assert f.attrs["flag"] is np.True_ and isinstance(f.attrs["version"], np.int64)
        assert f["run/telemetry_spans/0"][()] == b'[{"name": "h5_write", "s": 0.25}]'
        assert f["run/pending/has_pred"].dtype == np.bool_
        assert "run/0/surrogate_evals/39" in f and "run/0/nothing" not in f
        assert f.get("run/nothing") is None


def test_fixed_length_strings_and_refusals(tmp_path):
    fp = str(tmp_path / "misc.h5")
    with h5py.File(fp, "w") as h5:
        h5.attrs.create("fixed", np.bytes_("abcde"))
        h5["words"] = np.array([b"ab", b"cde"], dtype="S3")
    _read_both(fp)
    with h5file.File(fp, "r") as f:
        assert f.attrs["fixed"] == b"abcde" and f["words"].dtype == np.dtype("S3")
    with h5file.File(fp, "a") as f:
        f.attrs["more"] = 1
    _read_both(fp)
    for name, kwargs, refused in (
        ("gzip", dict(data=np.zeros((64, 2)), compression="gzip"), "filter pipeline"),
        ("rec", dict(data=np.zeros(2, dtype=[("a", "<f8"), ("b", "<i4")])), "compound"),
        ("be", dict(data=np.arange(3, dtype=">f8")), "big-endian"),
    ):
        with h5py.File(fp, "w") as h5:
            h5.create_dataset(name, **kwargs)
        with pytest.raises(h5file.UnsupportedFormat, match=refused):
            h5file.File(fp, "r")
    with h5py.File(fp, "w", libver="latest") as h5:
        h5["x"] = 1
    with pytest.raises(h5file.UnsupportedFormat, match="superblock version"):
        h5file.File(fp, "r")


def test_appends_both_ways(tmp_path):
    rng = np.random.default_rng(1)
    by_h5py, by_port = str(tmp_path / "h5py.h5"), str(tmp_path / "port.h5")
    _write_cases(h5py, by_h5py)
    _write_cases(h5file, by_port)

    # the port appends to h5py's file, as a store's later epochs do
    rows = rng.random((700, 3))
    with h5file.File(by_h5py, "a") as f:
        _append(f["run/0/parameters"], rows)
        _append(f["run/empty"], np.ones((2, 5)))
        f.create_group("run/0/surrogate_evals/40")["x"] = np.zeros((1, 2), np.float32)
        f["run/telemetry"].attrs["80"] = json.dumps({"epoch": 80})
        del f["run/telemetry_spans/0"]
        f["run/telemetry_spans"].create_dataset("0", data="[]")
    with h5py.File(by_h5py, "r") as h5:
        np.testing.assert_array_equal(h5["run/0/parameters"][N_LOG:], rows)
        np.testing.assert_array_equal(h5["run/empty"][:], np.ones((2, 5)))
        assert len(h5["run/0/surrogate_evals"]) == 41
        assert h5["run/telemetry_spans/0"][()] == b"[]"
    _read_both(by_h5py)

    # h5py grows the port's file: more chunks, more symbol-table nodes
    more = rng.random((N_LOG, 3))
    with h5py.File(by_port, "a") as h5:
        _append(h5["run/0/parameters"], more)
        _append(h5["run/0/epochs"], np.arange(5, dtype=np.uint32))
        for e in range(40, 340):
            h5.create_group(f"run/0/surrogate_evals/{e}")
        h5["run/telemetry"].attrs["80"] = json.dumps({"epoch": 80, "pad": "y" * 5000})
    _read_both(by_port)
    with h5file.File(by_port, "a") as f:
        log = f["run/0/parameters"]
        np.testing.assert_array_equal(log[N_LOG:], more)
        assert len(list(f["run/0/surrogate_evals"])) == 340
        assert json.loads(f["run/telemetry"].attrs["80"])["pad"] == "y" * 5000
        _append(log, rows)
    with h5py.File(by_port, "r") as h5:
        assert h5["run/0/parameters"].shape == (2 * N_LOG + 700, 3)
        np.testing.assert_array_equal(h5["run/0/parameters"][-700:], rows)


_NAMES = st.text("abcxyz019", min_size=1, max_size=6)
# h5py refuses NUL in variable-length strings; lone surrogates have no UTF-8
_TEXT = st.text(st.characters(blacklist_categories=("Cs",), blacklist_characters="\0"), max_size=30)
_DTYPES = st.sampled_from(
    ["<f4", "<f8", "<i1", "<i2", "<i4", "<i8", "<u1", "<u2", "<u4", "<u8", "?"]
)


@st.composite
def _datasets(draw):
    if draw(st.integers(0, 5)) == 0:
        return ("string", draw(_TEXT))
    dtype = np.dtype(draw(_DTYPES))
    shape = draw(hnp.array_shapes(min_dims=0, max_dims=3, min_side=0, max_side=5))
    data = draw(hnp.arrays(dtype, shape))
    resizable = len(shape) > 0 and draw(st.booleans())
    return ("array", data, resizable)


_ATTRS = st.dictionaries(
    _NAMES,
    st.one_of(
        _TEXT, st.integers(-(2 ** 63), 2 ** 63 - 1),
        st.floats(allow_nan=False), st.booleans(),
        hnp.arrays(_DTYPES, hnp.array_shapes(min_dims=1, max_dims=2, max_side=4)),
        st.lists(_TEXT, min_size=1, max_size=3),
    ),
    max_size=4,
)
_TREES = st.dictionaries(
    _NAMES,
    st.one_of(_datasets(), st.tuples(st.just("group"), _ATTRS, st.dictionaries(_NAMES, _datasets(), max_size=4))),
    max_size=5,
)


def _fill(group, tree):
    for name, item in tree.items():
        if item[0] == "string":
            group.create_dataset(name, data=item[1])
        elif item[0] == "array":
            _, data, resizable = item
            if resizable:
                d = group.create_dataset(
                    name, shape=(0,) + data.shape[1:], dtype=data.dtype,
                    maxshape=(None,) + data.shape[1:],
                )
                _append(d, data)
            else:
                group.create_dataset(name, data=data)
        else:
            _, attrs, children = item
            sub = group.create_group(name)
            for k, v in attrs.items():
                sub.attrs[k] = v
            _fill(sub, children)


@settings(max_examples=25, deadline=None, suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(tree=_TREES, attrs=_ATTRS)
def test_random_trees_round_trip(tmp_path, tree, attrs):
    """A random tree through the port's writer reads back the same in
    both modules, and equals the same tree written by h5py."""
    ours, theirs = str(tmp_path / "ours.h5"), str(tmp_path / "theirs.h5")
    for mod, fp in ((h5file, ours), (h5py, theirs)):
        with mod.File(fp, "w") as f:
            for k, v in attrs.items():
                f.attrs[k] = v
            _fill(f, tree)
    assert _read_both(ours) == _read_both(theirs)


def test_failed_write_leaves_the_old_file(tmp_path, monkeypatch):
    fp = str(tmp_path / "store.h5")
    with h5file.File(fp, "w") as f:
        f["x"] = np.arange(5.0)
    before = open(fp, "rb").read()

    def fail(*args):
        raise OSError("no space left on device")

    for target, name in ((os, "fsync"), (os, "replace"), (h5file._Writer, "_dataset")):
        with monkeypatch.context() as m:
            m.setattr(target, name, fail)
            with pytest.raises(OSError, match="no space"):
                with h5file.File(fp, "a") as f:
                    f["y"] = np.ones(3)
        assert open(fp, "rb").read() == before
        assert os.listdir(tmp_path) == ["store.h5"]
    # an error inside the block discards the open's changes
    with pytest.raises(KeyError):
        with h5file.File(fp, "a") as f:
            f["z"] = np.ones(2)
            f["missing"]
    assert open(fp, "rb").read() == before
    with h5py.File(fp, "r") as h5:
        assert list(h5) == ["x"]


def test_a_writing_open_excludes_a_second_writer(tmp_path):
    """The second writer waits on the first's lock, then reads the file
    the first one wrote (not the inode it had opened before the
    rename): the read, check and write of a lease claim is exclusive."""
    fp = str(tmp_path / "ckpt.h5")
    with h5file.File(fp, "w") as f:
        f.attrs["owner"] = "w0"
    seen = []

    def second():
        with h5file.File(fp, "r+") as f:
            seen.append(f.attrs["owner"])
            f.attrs["owner"] = "w2"

    first = h5file.File(fp, "r+")
    t = threading.Thread(target=second)
    t.start()
    time.sleep(0.2)
    assert not seen
    first.attrs["owner"] = "w1"
    first.close()
    t.join(timeout=10)
    assert not t.is_alive() and seen == ["w1"]
    with h5py.File(fp, "r") as h5:
        assert h5.attrs["owner"] == "w2"


_WITHOUT_H5PY = r'''
import importlib.abc, json, os, runpy, sys

class _NoH5py(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "h5py" or name.startswith("h5py."):
            raise ImportError("No module named 'h5py'")

sys.meta_path.insert(0, _NoH5py())
import numpy as np
import torch
torch.set_num_threads(1)
import dmosopt_tpu_torch
from dmosopt_tpu_torch import driver, storage
from dmosopt_tpu_torch.benchmarks.zdt import zdt1
from dmosopt_tpu_torch.service import OptimizationService
from dmosopt_tpu_torch.telemetry.fleet import rollup, scan_store

d = sys.argv[1]
space = {f"x{i}": [0.0, 1.0] for i in range(4)}
smk = {"n_starts": 2, "n_iter": 10, "seed": 0}
fp = os.path.join(d, "run.h5")
params = dict(opt_id="noh5", obj_fun=zdt1, torch_objective=True,
              objective_names=["f1", "f2"], space=space, problem_parameters={},
              n_initial=3, n_epochs=2, population_size=16, num_generations=3,
              surrogate_method_kwargs=smk, random_seed=5, save=True, file_path=fp)
dmosopt_tpu_torch.run(params, device="cpu", verbose=False)
assert storage.init_from_h5(fp, None, "noh5")[1] == 1
dmosopt_tpu_torch.run(dict(params, n_epochs=1), device="cpu", verbose=False)
dopt = driver.dopt_dict["noh5"]
assert dopt.start_epoch == 2 and [s["epoch"] for s in dopt.epoch_stats] == [2]
evals = storage.init_from_h5(fp, None, "noh5")[2][0]
stored = np.unique(np.vstack([e.parameters for e in evals]), axis=0)
archive = np.asarray(dopt.optimizer_dict[0].x)
assert np.unique(archive, axis=0).shape == archive.shape
assert np.array_equal(stored, np.unique(archive, axis=0))
assert sorted(storage.load_telemetry_from_h5(fp, "noh5")) == [0, 1, 2]

ck = os.path.join(d, "svc.h5")
svc = OptimizationService(device="cpu", checkpoint_path=ck)
for i in range(2):
    svc.submit(zdt1, space, ["f1", "f2"], opt_id=f"t{i}", n_epochs=2,
               population_size=16, num_generations=3, n_initial=3,
               surrogate_method_kwargs=smk, random_seed=20 + i,
               file_path=os.path.join(d, f"t{i}.h5"))
svc.step()
svc.close()
records = scan_store(fp) + scan_store(ck)
assert [r["kind"] for r in records] == ["store"] + 2 * ["service_checkpoint"], records
assert rollup(records)["n_runs"] == 3
svc2, handles = OptimizationService.resume(ck, {"t0": zdt1, "t1": zdt1}, device="cpu")
svc2.run()
assert all(h.done and h.error is None and h.result().epoch == 1 for h in handles.values())
svc2.close()
assert sorted(storage.load_fronts_from_h5(os.path.join(d, "t0.h5"), "t0")) == [0, 1]

sys.argv = ["dmosopt_tpu_torch.cli", "analyze", "-p", fp, "--opt-id", "noh5", "--device", "cpu"]
try:
    runpy.run_module("dmosopt_tpu_torch.cli", run_name="__main__", alter_sys=True)
except SystemExit as e:
    assert e.code in (0, None), e.code
assert "h5py" not in sys.modules
print("NO_H5PY_OK")
'''


def test_store_service_and_cli_without_h5py(tmp_path):
    """h5py is blocked by an import hook that raises ImportError, as on a
    machine without it, so the script can end by checking that no code
    loaded it (a ``sys.modules["h5py"] = None`` entry would be there)."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run(
        [sys.executable, "-c", _WITHOUT_H5PY, str(tmp_path)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "NO_H5PY_OK" in proc.stdout
