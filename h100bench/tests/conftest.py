"""Tests of the benchmark. Those marked ``card`` need a CUDA device; each
decides inside the ``cuda_device`` fixture whether one is present, and
skips here without one. Run them on the card with
``python3 -m pytest h100bench/tests -m card``."""

import copy
import json
import os
import time

import pytest

from h100bench.harness import spec


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (runs on the card)")
    # pytest-xdist's workers share the cores: torch's threads spin when
    # more of them run than there are cores, and the windowed runs slow
    # many times over, so each worker takes its share
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    if workers > 1:
        import torch

        torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    return torch.device("cuda", 0)


#: the sizes of the CPU runs: the cells' problems, designs and fit
#: settings, with fewer calibrations, fewer generations and two restarts a
#: fit; NSGA-II with a smaller population (AGE-MOEA keeps its own, where
#: ``ea_stall`` reads as at the cell's size: 0.70-0.82 an epoch at 25
#: generations, 0.63-0.79 at 100)
TINY = {
    "zdt1-nsga2": dict(population_size=100, num_generations=6),
    "dtlz2-m5-age": dict(num_generations=25),
}
TINY_TRAFFIC = {"serve64": dict(live=4, audit_every=2), "archive1k": dict(design_rows=120)}
#: limits of their own at the CPU runs' size, where the cell's are set
#: from readings at its own: a fit in a bucket of 4 stops farther from its
#: minimum than one in a bucket of 64 (a 4-tenant bucket read 0.105, the
#: faults 0.9 and more)
TINY_LIMITS = {"zdt1-nsga2.serve64": dict(fit_slack=0.5)}


def tiny_cell(name):
    """Cell ``name`` at the CPU runs' size, with the cell's own limits
    but for those ``TINY_LIMITS`` gives."""
    cell = spec.load_cell(name)
    cell = copy.deepcopy(cell)
    cell.config.update(TINY[cell.config["name"]])
    cell.config["gp"]["n_starts"] = 2
    traffic = next(t for t in TINY_TRAFFIC if name.endswith("." + t))
    cell.traffic.update(TINY_TRAFFIC[traffic])
    cell.limits.update(TINY_LIMITS.get(name, {}))
    return cell


def cpu_run(cell, seed, seconds, control=False):
    """Drive ``cell`` once on the CPU past the harness's look for a chip;
    returns its result line."""
    import torch

    from h100bench.harness import runner

    result, _, _ = runner.execute(cell, seed, seconds, False, torch.device("cpu"),
                                  time.perf_counter(), control=control)
    return result


def dumps(x):
    return json.dumps(x, default=str)
