"""Deterministic test doubles for the service stack.

Port of ``dmosopt_tpu/testing``: `dmosopt_tpu_torch.testing.faults` is
the fault-injection harness (a seeded `FaultPlan` and the
`FaultyEvaluator` / `FaultyStore` wrappers) that drives the ask/tell
service through failures.
"""

from dmosopt_tpu_torch.testing.faults import (  # noqa: F401
    FAULT_PLAN_ENV,
    FaultPlan,
    FaultRule,
    FaultyEvaluator,
    FaultyStore,
    InjectedFault,
)
