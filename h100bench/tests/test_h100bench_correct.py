"""``correct`` comes out true for the program, and false for the control
and for each fault a cell can have, at a size the CPU holds. These runs
skip the harness's look for a chip and drive the rest of a run with the
cells' own limits."""

import subprocess
import sys

import pytest

from h100bench import faults
from h100bench.harness import spec
from h100bench.tests.conftest import cpu_run, dumps, tiny_cell

#: the faults each cell can have (no cell spans chips, so none leaves out
#: an exchange between them; the run() cell has no service step)
CELL_FAULTS = {
    "zdt1-nsga2.serve64": ["step_unchanged", "fit_unchanged", "ea_unchanged", "half_batch",
                           "answer_altered"],
    "dtlz2-m5-age.serve64": ["step_unchanged", "fit_unchanged", "ea_unchanged", "half_batch",
                             "answer_altered"],
    "zdt1-nsga2.archive1k": ["fit_unchanged", "ea_unchanged", "half_batch", "answer_altered"],
}
SEED = 2 ** 31 + 12345
SECONDS = 60.0


def test_every_cell_has_its_faults_listed():
    assert set(CELL_FAULTS) == {w["name"] for w in spec.load_benchmark()["workloads"]}


@pytest.mark.parametrize("cell", sorted(CELL_FAULTS))
def test_program_correct_and_control_not(cell):
    c = tiny_cell(cell)
    res = cpu_run(c, SEED, SECONDS)
    assert res["correct"], dumps(res["compared"])
    assert res["attempted"] > 0 and res["failed"] == 0
    # every end-to-end metric the cell declares is reported
    assert set(res["metrics"]) == {m["name"] for m in c.end_to_end}, res["metrics"]
    ctl = cpu_run(c, SEED, SECONDS, control=True)
    assert not ctl["correct"], dumps(ctl["compared"])


@pytest.mark.parametrize("cell,fault", [(c, f) for c in sorted(CELL_FAULTS) for f in CELL_FAULTS[c]])
def test_fault_makes_correct_false(cell, fault):
    with faults.FAULTS[fault]():
        res = cpu_run(tiny_cell(cell), SEED + 1, SECONDS)
    assert not res["correct"], dumps(res["compared"])


@pytest.mark.card
def test_benchmark_command_on_the_card(cuda_device):
    out = subprocess.run(
        [sys.executable, "-m", "h100bench.run", "--workload", "zdt1-nsga2.archive1k",
         "--seed", str(SEED), "--seconds", "10", "--trace", "0"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    assert '"correct": true' in out.stdout.strip().splitlines()[-1]
