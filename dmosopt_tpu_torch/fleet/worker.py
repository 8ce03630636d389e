"""Fleet worker harness: one `OptimizationService` per subprocess.

Port of ``dmosopt_tpu/fleet/worker.py`` around the port's service.

The worker is the unit the supervisor places tenants on and the unit
whose death must be a non-event. It wraps an `OptimizationService`
with the service's full survival kit — per-worker crash-safe
``checkpoint_path`` (owner-stamped, the migration wire format), an
ephemeral-port OpenMetrics exporter (the supervisor's ``/healthz``
probe target; ``port=0`` so N workers coexist on one host), and a
heartbeat status file embedding ``introspect()`` — then runs a simple
supervision loop:

1. **fence check** — if the supervisor revoked this worker's lease
   (``fence`` flag file) the worker exits IMMEDIATELY with
   `wire.EXIT_FENCED`, writing nothing more: its tenants belong to
   someone else now (split-brain prevention, docs/robustness.md);
2. **stop check** — the graceful path: ``svc.close()`` (which
   checkpoints), final status, exit 0;
3. **worker-level fault hook** — one `FaultPlan.next_fault("worker",
   worker_id)` consultation per loop (env-gated like the service's
   eval faults): ``kill`` SIGKILLs, ``heartbeat_hang`` mutes the
   status write while it keeps firing, ``partition`` additionally
   closes the exporter (probe blackhole), ``delay`` sleeps, ``raise``
   crashes the worker with a nonzero exit;
4. **order intake** — claim inbox orders: ``submit`` (a tenant spec
   whose objective is an importable ``objective_ref``) and ``migrate``
   (adopt a dead worker's checkpoint under the lease protocol);
5. **step** the service when it has tenants, else idle-sleep;
6. **heartbeat** — atomically publish ``status.json`` (seq, ts,
   exporter port, adoption/lease-conflict accounting, the full
   introspect snapshot).

Run as ``python -m dmosopt_tpu_torch.fleet.worker --fleet-dir D
--worker-id w0 --device cuda``; the supervisor spawns exactly that. The
worker's service runs on ``--device`` (CUDA by default, raising without
a card, as every entry point of the port does); a submitted spec names
its objective kind with ``torch_objective`` where the JAX package's
says ``jax_objective``.
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import sys
import time
from typing import Any, Dict, List, Optional

from dmosopt_tpu_torch.fleet.wire import (
    CHECKPOINT_FILE,
    EXIT_FENCED,
    EXIT_OK,
    FENCE_FILE,
    INBOX_DIR,
    STATUS_FILE,
    STOP_FILE,
    atomic_write_json,
    claim_orders,
    mark_done,
    worker_dir,
)

logger = logging.getLogger(__name__)


class WorkerHarness:
    """The supervision loop around one worker's `OptimizationService`.

    Single-threaded by design: orders, steps, fault hooks and
    heartbeats all run on this loop, so the only concurrency inside a
    worker is what the service already owns (its writer, evaluator
    pools and exporter thread — all lifecycle-ruled)."""

    def __init__(
        self,
        fleet_dir: str,
        worker_id: str,
        *,
        poll: float = 0.1,
        min_bucket: int = 2,
        exporter: bool = True,
        telemetry: bool = True,
        placement_epoch: int = 0,
        device=None,
        logger=logger,
    ):
        self.fleet_dir = fleet_dir
        self.worker_id = str(worker_id)
        self.poll = float(poll)
        self.logger = logger
        self.dir = worker_dir(fleet_dir, self.worker_id)
        self.inbox = os.path.join(self.dir, INBOX_DIR)
        os.makedirs(self.inbox, exist_ok=True)
        self._status_path = os.path.join(self.dir, STATUS_FILE)
        self._stop_path = os.path.join(self.dir, STOP_FILE)
        self._fence_path = os.path.join(self.dir, FENCE_FILE)
        self.checkpoint_path = os.path.join(self.dir, CHECKPOINT_FILE)
        from dmosopt_tpu_torch.service import OptimizationService
        from dmosopt_tpu_torch.testing.faults import FaultPlan

        # the service consumes the same env-gated plan for eval faults;
        # this harness consults the worker-op rules of its own instance
        # (separate call accounting — worker loops are not eval calls)
        self._plan = FaultPlan.from_env()
        self.service = OptimizationService(
            min_bucket=min_bucket,
            telemetry=telemetry,
            checkpoint_path=self.checkpoint_path,
            owner=self.worker_id,
            placement_epoch=int(placement_epoch),
            exporter=bool(exporter) and bool(telemetry),
            logger=self.logger,
            device=device,
        )
        self._seq = 0
        self._orders_processed = 0
        self._adoptions: List[Dict[str, Any]] = []
        self._lease_conflicts = 0
        self._last_error: Optional[str] = None
        self._partitioned = False
        # first heartbeat immediately: the supervisor's start() blocks
        # on it, and it surfaces the exporter's ephemeral port before
        # any step has run
        self.write_status("starting")

    # ------------------------------------------------------------ status

    def write_status(self, state: str) -> None:
        snap = self.service.introspect()
        tenants = {
            t["opt_id"]: {
                "state": t["state"],
                "epoch": t.get("epoch"),
                "n_epochs": t.get("n_epochs"),
                "cost_seconds": t.get("cost_seconds"),
            }
            for t in snap.get("tenants", [])
        }
        atomic_write_json(
            self._status_path,
            {
                "worker_id": self.worker_id,
                "pid": os.getpid(),
                "seq": self._seq,
                "ts": time.time(),
                "state": state,
                "steps": snap.get("steps", 0),
                "exporter": snap.get("exporter"),
                "lease": snap.get("lease"),
                "tenants": tenants,
                "orders_processed": self._orders_processed,
                "adoptions": self._adoptions,
                "lease_conflicts": self._lease_conflicts,
                "last_error": self._last_error,
                "service": snap,
            },
        )

    # ------------------------------------------------------------- orders

    def _known_opt_ids(self) -> set:
        """Every opt_id this service has seen: active, pending, and the
        recent retirees — the duplicate-submission guard's view."""
        svc = self.service
        known = {
            t.handle.opt_id
            for t in list(svc._active.values()) + list(svc._pending)
        }
        known.update(r.get("opt_id") for r in svc._retired)
        return known

    def _apply_order(self, order: Dict[str, Any]) -> None:
        kind = order.get("kind")
        if kind == "submit":
            spec = dict(order["spec"])
            space = spec.pop("space")
            objective_names = spec.pop("objective_names")
            opt_id = spec.get("opt_id")
            if opt_id is not None and opt_id in self._known_opt_ids():
                # restart-from-spec raced an adoption that already
                # carried this tenant: the adopted (checkpointed,
                # further-along) instance wins, the duplicate is a no-op
                self.logger.warning(
                    f"submit order for {opt_id!r} skipped: tenant "
                    f"already lives in this service"
                )
                return
            self.service.submit(None, space, objective_names, **spec)
        elif kind == "migrate":
            from dmosopt_tpu_torch.storage import CheckpointLeaseError

            try:
                handles = self.service.adopt_checkpoint(
                    order["checkpoint"],
                    expected_owner=order.get("expected_owner"),
                    placement_epoch=int(order["placement_epoch"]),
                )
            except CheckpointLeaseError as e:
                # the double-adoption guard fired: someone else owns
                # these tenants — record it loudly, adopt nothing
                self._lease_conflicts += 1
                self._last_error = f"lease conflict: {e}"
                self.logger.warning(f"migration refused: {e}")
                return
            self._adoptions.append(
                {
                    "from": order.get("expected_owner"),
                    "placement_epoch": int(order["placement_epoch"]),
                    "tenants": sorted(handles),
                }
            )
        else:
            raise ValueError(f"unknown fleet order kind {kind!r}")

    def _process_inbox(self) -> None:
        for path, order in claim_orders(self.inbox):
            try:
                self._apply_order(order)
            except Exception as e:
                # a broken order must not take the worker (and every
                # healthy tenant on it) down — record and continue
                self._last_error = f"{type(e).__name__}: {e}"
                self.logger.exception(
                    f"fleet order {os.path.basename(path)} failed"
                )
            finally:
                mark_done(path)
                self._orders_processed += 1

    # -------------------------------------------------------- fault hook

    def _consult_faults(self) -> bool:
        """One worker-op fault consultation; returns True when the
        heartbeat must stay silent this loop."""
        if self._plan is None:
            return False
        rule = self._plan.next_fault("worker", self.worker_id)
        if rule is None:
            return False
        if rule.kind == "kill":
            os.kill(os.getpid(), signal.SIGKILL)
        if rule.kind == "raise":
            from dmosopt_tpu_torch.testing.faults import InjectedFault

            raise InjectedFault(rule.message)
        if rule.kind == "delay":
            time.sleep(rule.delay_s)
            return False
        if rule.kind in ("hang", "heartbeat_hang"):
            return True
        if rule.kind == "partition":
            if not self._partitioned and self.service.exporter is not None:
                # blackhole the probe endpoint: from the supervisor's
                # side this worker just vanished from the network
                self.service.exporter.close()
                self.service.exporter = None
            self._partitioned = True
            return True
        return False

    # --------------------------------------------------------------- run

    def run(self, max_loops: Optional[int] = None) -> int:
        """The supervision loop. ``max_loops`` is a testing/diagnostic
        bound: when it expires the harness RETURNS without closing the
        service, so a test can continue driving it; the unbounded form
        only exits through the stop/fence flags (or a fault)."""
        loops = 0
        while max_loops is None or loops < max_loops:
            loops += 1
            if os.path.exists(self._fence_path):
                # lease revoked: tenants were (or are being) adopted
                # elsewhere — exit NOW and never write again; one
                # in-flight step at most raced this check, which is
                # why the supervisor also waits out fence_grace before
                # claiming the checkpoint (docs/robustness.md)
                self.logger.warning(
                    f"worker {self.worker_id!r} fenced; exiting without "
                    f"checkpoint"
                )
                return EXIT_FENCED
            mute = self._consult_faults()
            if os.path.exists(self._stop_path):
                self.service.close()  # graceful: checkpoints first
                if not mute:
                    self.write_status("stopped")
                return EXIT_OK
            self._process_inbox()
            svc = self.service
            if svc._active or svc._pending:
                svc.step()
            else:
                time.sleep(self.poll)
            self._seq += 1
            if not mute:
                self.write_status("running")
        return EXIT_OK


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        description="dmosopt-tpu-torch fleet worker (one OptimizationService "
        "subprocess; spawned by dmosopt_tpu_torch.fleet.supervisor)"
    )
    parser.add_argument("--fleet-dir", required=True)
    parser.add_argument("--worker-id", required=True)
    parser.add_argument("--poll", type=float, default=0.1)
    parser.add_argument("--min-bucket", type=int, default=2)
    parser.add_argument("--placement-epoch", type=int, default=0)
    parser.add_argument("--no-exporter", action="store_true")
    parser.add_argument("--no-telemetry", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the worker's service "
                        "(cuda: raises without a card)")
    args = parser.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format=f"[%(asctime)s {args.worker_id}] %(levelname)s %(message)s",
    )
    harness = WorkerHarness(
        args.fleet_dir,
        args.worker_id,
        poll=args.poll,
        min_bucket=args.min_bucket,
        exporter=not args.no_exporter,
        telemetry=not args.no_telemetry,
        placement_epoch=args.placement_epoch,
        device=args.device,
    )
    return harness.run()


if __name__ == "__main__":
    sys.exit(main())
