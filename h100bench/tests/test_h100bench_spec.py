"""``BENCHMARK.json`` keeps to the contract's shape and characters, and
every file a cell needs is found by name."""

import json
import re
import subprocess
import sys

import pytest

from h100bench.harness import guard, spec

# the characters that names, units and texts in BENCHMARK.json may use
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")


def is_name(s) -> bool:
    return isinstance(s, str) and bool(NAME.match(s))


def is_unit(s) -> bool:
    return isinstance(s, str) and bool(UNIT.match(s))


def is_text(s) -> bool:
    """1 to 200 characters on one line, no tab."""
    return isinstance(s, str) and 1 <= len(s) <= 200 and not any(c in s for c in "\n\r\t")


def is_path(s) -> bool:
    return (isinstance(s, str) and bool(PATH.match(s)) and not s.startswith("/")
            and ".." not in s.split("/"))


BENCH = spec.load_benchmark()
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_keys_and_command():
    assert set(BENCH) == TOP
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(is_text(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16 and all(is_path(p) for p in BENCH["paths"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_configs(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert is_name(entry["name"]) and is_text(entry["source"])
    assert is_text(entry["why"]) and entry["file"].startswith("h100bench/")
    assert len(entry["reduced"]) <= 16 and all(is_name(k) for k in entry["reduced"])
    with open(spec.ROOT / entry["file"]) as f:
        cfg = json.load(f)
    assert cfg["name"] == entry["name"] and cfg["reduced"] == entry["reduced"]
    assert [float(b) for b in cfg["parameter_bounds"]] == [0.0, 1.0]


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda e: e["name"])
def test_workloads_and_their_files(entry):
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert all(is_name(entry[k]) for k in ("name", "config", "traffic"))
    assert entry["chips"] in (1, 4) and is_text(entry["why"])
    cell = spec.load_cell(entry["name"])
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    assert spec.driver(cell.traffic).drive
    for m in cell.per_layer:
        assert callable(spec.metric_reader(m["name"]))


def test_metrics():
    seen = set()
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert is_name(m["name"]) and m["name"] not in seen
        seen.add(m["name"])
        assert is_unit(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert is_text(m["layer"]) and m["moves"] in e2e
        assert (spec.BENCH_DIR / "metrics" / f"{m['name']}.py").exists()
        if m["name"].endswith(("_roofline", "_roofline_pct")) or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_pairs_appear_once_and_four_chip_share():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(pairs) // 4)


@pytest.mark.parametrize("text,ok", [("tokens/s", True), ("tokens per second", False),
                                     ("%", True), ("µs", False)])
def test_unit_characters(text, ok):
    assert is_unit(text) is ok


@pytest.mark.parametrize("mods,found", [
    ({"jax.numpy": 1, "dmosopt_tpu_torch.service": 1}, ["jax"]),
    ({"dmosopt_tpu_torch": 1, "numpy": 1}, []),
    ({"dmosopt_tpu.moasmo": 1, "flax": 1, "jaxlib.xla": 1}, ["dmosopt_tpu", "flax", "jaxlib"]),
])
def test_forbidden_names_compare_whole_top_level(mods, found):
    assert guard.forbidden_loaded(mods) == found


def _modules_after(code):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys; print(sorted(sys.modules))"],
                         cwd=spec.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    return eval(out.stdout.strip().splitlines()[-1])


def test_harness_loads_no_jax():
    mods = _modules_after(
        "import h100bench.run, h100bench.harness.runner, h100bench.calibrate, h100bench.faults\n"
        "from h100bench.harness import spec\n"
        "for w in spec.load_benchmark()['workloads']:\n"
        "    c = spec.load_cell(w['name']); spec.driver(c.traffic)\n"
        "    [spec.metric_reader(m['name']) for m in c.per_layer]\n"
        "import dmosopt_tpu_torch.service, dmosopt_tpu_torch.driver")
    assert guard.forbidden_loaded(mods) == []


def test_reference_loads_nothing_of_the_program():
    mods = _modules_after("import h100bench.reference.check, h100bench.reference.problems.zdt1,"
                          " h100bench.reference.problems.dtlz2")
    assert not [m for m in mods if m.split(".")[0] in guard.FORBIDDEN | {"dmosopt_tpu_torch"}]
