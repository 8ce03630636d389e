"""dmosopt_tpu_torch: the PyTorch/CUDA port of dmosopt_tpu.

A second package beside the JAX one, slice by slice, with the JAX package
as its reference. It runs MO-ASMO — `run()` with NSGA-II or AGE-MOEA
against an exact-GP surrogate, optionally stopped by the adaptive
termination criteria — on a CUDA device, with the variation kernels as
Triton kernels (see `dmosopt_tpu_torch.ops.variation`), host objectives
on a thread pool under the JAX package's pipeline modes, and the HDF5
store it saves to and resumes from (`dmosopt_tpu_torch.storage`), with
the JAX package's telemetry on by default (`dmosopt_tpu_torch.telemetry`:
metrics, events, spans, health rules, and a device ledger read from
``torch.profiler`` captures). `OptimizationService` is the ask/tell
front over the same machinery: callers submit problems at any time and
each `step()` advances every tenant one epoch, bucket-mates sharing one
fit and one EA, lockstep or as a task graph, with per-tenant fault
policies, atomic checkpoints and an optional OpenMetrics exporter. It
imports neither jax nor dmosopt_tpu.
"""

__version__ = "0.1.0"

from dmosopt_tpu_torch.datatypes import (  # noqa: F401
    EpochResults,
    EvalEntry,
    EvalRequest,
    OptProblem,
    ParameterSpace,
    StrategyState,
)


def run(dopt_params, **kwargs):
    """Run a complete MO-ASMO optimization (see dmosopt_tpu_torch.driver.run)."""
    from dmosopt_tpu_torch.driver import run as _run

    return _run(dopt_params, **kwargs)


def __getattr__(name):
    if name in ("DistOptimizer", "dopt_init"):
        from dmosopt_tpu_torch import driver

        return getattr(driver, name)
    if name in ("OptimizationService", "EvalPolicy", "TenantHandle"):
        from dmosopt_tpu_torch import service

        return getattr(service, name)
    if name == "DistOptStrategy":
        from dmosopt_tpu_torch.strategy import DistOptStrategy

        return DistOptStrategy
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
