"""The window ends at the end of the last step or epoch that ended within
``--seconds``, and the rates count the work of that window only."""

import time

import pytest
import torch

from h100bench.harness import runner, spec
from h100bench.tests.conftest import tiny_cell


@pytest.mark.parametrize("cell", ["zdt1-nsga2.serve64", "zdt1-nsga2.archive1k"])
def test_window_ends_at_the_last_boundary_within_the_seconds(cell):
    c = tiny_cell(cell)
    seconds = 60.0
    run = runner.Run(c, 2 ** 32 + 7, seconds, False, torch.device("cpu"), time.perf_counter())
    spec.driver(c.traffic).drive(run)
    assert run.setup_s is not None and run.t0 < run.t1 <= run.t0 + seconds
    if run.steps:
        assert run.t1 == run.steps[-1]["t_end"]
        epochs = sum(s["advanced"] for s in run.steps)
        assert run.e2e["tenant_epochs_per_s"] == pytest.approx(epochs / (run.t1 - run.t0))
    else:
        ends = sorted(sp.t_end for sp in run.telemetry.tracer.spans("epoch")
                      if run.t0 <= sp.t_end <= run.t0 + seconds)
        assert run.t1 == ends[-1]
        assert run.e2e["epoch_s"] == pytest.approx((run.t1 - run.t0) / len(ends))
