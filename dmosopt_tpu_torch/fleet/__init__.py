"""Horizontally scaled service fleet.

Port of ``dmosopt_tpu/fleet/__init__.py``, with its import surface.
`dmosopt_tpu_torch.fleet` runs N `OptimizationService` worker
subprocesses under one supervisor and makes worker death a non-event:
tenant placement with admission control and load shedding, liveness
detection (``/healthz`` probes + status-file heartbeats under a
deadline + hysteresis policy), and live tenant migration that uses the
service's crash-safe checkpoints as the wire format — a SIGKILLed
worker's tenants resume on a survivor bitwise-equal to an uninterrupted
run, under an ownership lease that makes double adoption impossible
(docs/robustness.md "Fleet failure model"). The checkpoints are HDF5
files, so a fleet needs h5py.

Import surface: the supervisor side builds no service; the worker
harness imports the service stack and is meant to run as
``python -m dmosopt_tpu_torch.fleet.worker`` inside its own process.
"""

from dmosopt_tpu_torch.fleet.supervisor import (  # noqa: F401
    AdmissionPolicy,
    FleetAdmissionError,
    FleetSupervisor,
    LivenessPolicy,
)
from dmosopt_tpu_torch.fleet.wire import (  # noqa: F401
    EXIT_FENCED,
    EXIT_OK,
    results_dir,
    worker_dir,
)
