"""Fleet supervisor: worker placement, failure detection, migration.

Port of ``dmosopt_tpu/fleet/supervisor.py``. `FleetSupervisor` runs N
`dmosopt_tpu_torch.fleet.worker` subprocesses, each with its service on
the supervisor's ``device`` (None means CUDA, raising without a card),
and makes worker death a non-event:

- **placement + admission**: tenant submissions are placed on the
  least-loaded *alive* worker — load weighted by the worker's remaining
  placed EA budget plus its attributed ``tenant_cost_seconds`` — with
  each worker's own loadavg-normalized contention check
  (``introspect()["throughput"]``) consulted first. Submissions larger
  than the per-tenant EA-budget cap are shed, and when EVERY candidate
  worker reads contended the submission is shed instead of queued
  (`FleetAdmissionError`) — the fleet degrades by refusing work, not by
  melting;
- **liveness**: each monitor round combines three signals per worker —
  subprocess exit (unambiguous), ``/healthz`` probe against the
  worker's ephemeral-port exporter (retried with
  `utils.jittered_backoff`), and status-file heartbeat age against a
  deadline. Probe/heartbeat failures must persist for
  ``confirm_rounds`` CONSECUTIVE rounds before a worker is declared
  dead (the HealthEngine ``for_steps`` hysteresis discipline — a one
  round blip never kills a worker);
- **migration**: a confirmed-dead worker is **fenced** (flag file its
  loop checks every iteration), given ``fence_grace`` to exit on its
  own, then killed if still running — only THEN is its checkpoint
  claimed, under the ownership lease (`storage.claim_service_checkpoint`
  with a bumped placement epoch), by a survivor that adopts every
  incomplete tenant (`OptimizationService.adopt_checkpoint`). Unclaimed
  inbox orders of the dead worker are re-enqueued on the survivor.
  Fence-then-grace-then-kill-then-claim serializes writers, and the
  lease makes a second claim fail loudly: no tenant is ever owned by
  two workers (docs/robustness.md "Fleet failure model").

The supervisor is single-threaded: callers drive `monitor_once()` /
`run()` from their own loop, so there is no supervisor-internal
locking to get wrong.
"""

from __future__ import annotations

import logging
import os
import subprocess
import sys
import time
import urllib.error
import urllib.request
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from dmosopt_tpu_torch.fleet.wire import (
    EXIT_FENCED,
    EXIT_OK,
    FENCE_FILE,
    FLEET_STATE_FILE,
    INBOX_DIR,
    LOG_FILE,
    STATUS_FILE,
    STOP_FILE,
    CHECKPOINT_FILE,
    atomic_write_json,
    claim_orders,
    enqueue_order,
    mark_done,
    read_json,
    results_dir,
    touch_flag,
    worker_dir,
)
from dmosopt_tpu_torch.telemetry import Telemetry, create_telemetry
from dmosopt_tpu_torch.utils import jittered_backoff
from dmosopt_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

#: tenant states the supervisor treats as terminal ("lost" is the
#: reconciliation fallback: a tenant a migration could not account for
#: — absent from the adopted checkpoint, not requeued, not resubmitted;
#: its durable artifacts, if any, are in its results store)
TERMINAL_STATES = ("completed", "failed", "degraded", "cancelled", "lost")


class FleetAdmissionError(RuntimeError):
    """A tenant submission the fleet refused: over the per-tenant
    EA-budget cap, or every candidate worker reads contended (load
    shedding — docs/robustness.md)."""


@dataclass(frozen=True)
class LivenessPolicy:
    """Deadline + hysteresis policy of the failure detector.

    heartbeat_timeout: max age in seconds of a worker's status-file
        heartbeat before the worker reads suspect.
    probe_timeout / probe_retries / probe_backoff(_cap): per-attempt
        ``/healthz`` probe budget and the `jittered_backoff` retry
        schedule between attempts.
    confirm_rounds: CONSECUTIVE suspect monitor rounds before a
        still-running worker is declared dead (process exit skips the
        hysteresis — it is unambiguous).
    fence_grace: seconds a fenced worker gets to observe its fence and
        exit before the supervisor kills it; the checkpoint is claimed
        only after the process is gone, so there is never a live writer
        behind an adopted checkpoint.
    """

    heartbeat_timeout: float = 15.0
    probe_timeout: float = 2.0
    probe_retries: int = 2
    probe_backoff: float = 0.05
    probe_backoff_cap: float = 1.0
    confirm_rounds: int = 2
    fence_grace: float = 10.0


@dataclass(frozen=True)
class AdmissionPolicy:
    """Admission control at the supervisor.

    max_ea_budget: per-tenant cap on ``population_size *
        num_generations * n_epochs`` (None = uncapped); an over-budget
        submission is shed.
    shed_when_contended: with every alive worker reading contended
        (its own `introspect()` throughput check says
        ``host_contended``, or its load ratio exceeds
        ``load_ratio_limit``), shed the submission instead of piling on.
    load_ratio_limit: loadavg/cores above which a worker counts as
        contended for placement purposes.
    """

    max_ea_budget: Optional[int] = None
    shed_when_contended: bool = True
    load_ratio_limit: float = 1.5


@dataclass
class _Worker:
    id: str
    dir: str
    proc: Optional[subprocess.Popen] = None
    log_handle: Any = None
    state: str = "starting"  # starting|alive|suspect|dead|fenced|stopping|stopped
    status: Optional[Dict[str, Any]] = None
    spawn_ts: float = 0.0
    suspect_rounds: int = 0
    exit_code: Optional[int] = None
    last_probe_ok: Optional[bool] = None
    placement_epoch: int = 0
    extra_env: Dict[str, str] = field(default_factory=dict)

    @property
    def checkpoint_path(self) -> str:
        return os.path.join(self.dir, CHECKPOINT_FILE)


class FleetSupervisor:
    """Place tenants across N worker subprocesses, detect worker
    failure, and migrate dead workers' tenants to survivors from their
    lease-stamped checkpoints."""

    def __init__(
        self,
        fleet_dir: str,
        n_workers: int = 2,
        *,
        telemetry=None,
        liveness: Optional[LivenessPolicy] = None,
        admission: Optional[AdmissionPolicy] = None,
        min_bucket: int = 2,
        worker_poll: float = 0.05,
        exporter: bool = True,
        python: str = sys.executable,
        worker_env: Optional[Dict[str, Dict[str, str]]] = None,
        device=None,
        logger=logger,
    ):
        self.device = resolve_device(device)
        self.fleet_dir = os.path.abspath(fleet_dir)
        self.telemetry = create_telemetry(telemetry)
        # the service's ownership discipline: a Telemetry the caller
        # handed us is theirs to close; one we built closes with us
        self._owns_telemetry = not isinstance(telemetry, Telemetry)
        self.liveness = liveness or LivenessPolicy()
        self.admission = admission or AdmissionPolicy()
        self.min_bucket = int(min_bucket)
        self.worker_poll = float(worker_poll)
        self.exporter = bool(exporter)
        self.python = python
        self.logger = logger
        os.makedirs(results_dir(self.fleet_dir), exist_ok=True)
        self.workers: Dict[str, _Worker] = {}
        worker_env = worker_env or {}
        for i in range(int(n_workers)):
            wid = f"w{i}"
            self.workers[wid] = _Worker(
                id=wid,
                dir=worker_dir(self.fleet_dir, wid),
                extra_env=dict(worker_env.get(wid, {})),
            )
        #: monotonically increasing fencing token; each migration bumps
        self.placement_epoch = 0
        self._order_seq = 0
        #: opt_id -> {"worker", "budget", "spec"}
        self.placements: Dict[str, Dict[str, Any]] = {}
        #: merged tenant states across worker statuses (terminal sticks)
        self.tenant_states: Dict[str, str] = {}
        self.migrations: List[Dict[str, Any]] = []
        self.shed: List[Dict[str, Any]] = []
        self._closed = False

    # ------------------------------------------------------------ lifecycle

    def start(self, timeout: float = 120.0) -> "FleetSupervisor":
        """Spawn every worker and wait for its first heartbeat."""
        for w in self.workers.values():
            self._spawn(w)
        deadline = time.monotonic() + timeout
        for w in self.workers.values():
            while w.status is None:
                w.status = read_json(os.path.join(w.dir, STATUS_FILE))
                if w.status is not None:
                    w.state = "alive"
                    break
                if w.proc is not None and w.proc.poll() is not None:
                    raise RuntimeError(
                        f"fleet worker {w.id!r} exited with code "
                        f"{w.proc.returncode} before its first heartbeat "
                        f"(see {os.path.join(w.dir, LOG_FILE)})"
                    )
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"fleet worker {w.id!r} produced no heartbeat "
                        f"within {timeout}s"
                    )
                time.sleep(0.05)
        self._gauge_alive()
        self._persist()
        return self

    def _spawn(self, w: _Worker) -> None:
        os.makedirs(w.dir, exist_ok=True)
        cmd = [
            self.python, "-m", "dmosopt_tpu_torch.fleet.worker",
            "--fleet-dir", self.fleet_dir,
            "--worker-id", w.id,
            "--poll", str(self.worker_poll),
            "--min-bucket", str(self.min_bucket),
            "--placement-epoch", str(w.placement_epoch),
            "--device", str(self.device),
        ]
        if not self.exporter:
            cmd.append("--no-exporter")
        env = dict(os.environ)
        env.update(w.extra_env)
        w.log_handle = open(os.path.join(w.dir, LOG_FILE), "ab")
        w.proc = subprocess.Popen(
            cmd, env=env, stdout=w.log_handle, stderr=subprocess.STDOUT,
        )
        w.spawn_ts = time.monotonic()
        w.state = "starting"
        self.logger.info(f"spawned fleet worker {w.id} (pid {w.proc.pid})")

    # ------------------------------------------------------------ admission

    @staticmethod
    def _spec_budget(spec: Dict[str, Any]) -> int:
        return (
            int(spec.get("population_size", 64))
            * int(spec.get("num_generations", 50))
            * int(spec.get("n_epochs", 5))
        )

    def _worker_contended(self, w: _Worker) -> bool:
        thr = ((w.status or {}).get("service") or {}).get("throughput") or {}
        if thr.get("status") == "host_contended":
            return True
        ratio = thr.get("load_ratio")
        return (
            ratio is not None
            and float(ratio) > self.admission.load_ratio_limit
        )

    def _worker_load(self, w: _Worker) -> float:
        """Placement weight: remaining placed EA budget plus attributed
        cost — the two signals of 'how much work does this worker still
        own' the statuses give us."""
        remaining = 0.0
        tenants = (w.status or {}).get("tenants") or {}
        for opt_id, p in self.placements.items():
            if p["worker"] != w.id:
                continue
            st = tenants.get(opt_id)
            if st is not None and st.get("state") in TERMINAL_STATES:
                continue
            budget = float(p["budget"])
            if st is not None and st.get("n_epochs"):
                done = float(st.get("epoch") or 0) / float(st["n_epochs"])
                budget *= max(1.0 - done, 0.0)
            remaining += budget
        cost = 0.0
        for st in tenants.values():
            if st.get("state") in TERMINAL_STATES:
                continue  # finished work is not load
            for v in (st.get("cost_seconds") or {}).values():
                cost += float(v)
        return remaining + cost

    def submit(
        self, spec: Dict[str, Any], *, worker: Optional[str] = None
    ) -> Dict[str, Any]:
        """Admit and place one tenant spec. The spec is the worker-side
        `OptimizationService.submit` kwargs with ``space`` /
        ``objective_names`` / an importable ``objective_ref`` (plus
        ``opt_id``); ``worker=`` pins placement (tests, operator
        override). Returns ``{"opt_id", "worker", "budget"}``; raises
        `FleetAdmissionError` when the submission is shed."""
        if self._closed:
            raise RuntimeError("fleet supervisor is closed")
        spec = dict(spec)
        if "objective" in spec:  # friendlier alias
            spec["objective_ref"] = spec.pop("objective")
        opt_id = spec.get("opt_id")
        if not opt_id:
            raise ValueError("fleet tenant specs must carry an opt_id")
        if opt_id in self.placements:
            raise ValueError(f"tenant {opt_id!r} is already placed")
        if "evaluator" in spec:
            raise ValueError(
                f"tenant {opt_id!r}: fleet specs cross a process "
                f"boundary as JSON — an evaluator object cannot travel; "
                f"use an importable objective_ref instead"
            )
        if not spec.get("objective_ref"):
            raise ValueError(
                f"tenant {opt_id!r}: fleet specs need an importable "
                f"objective_ref (a subprocess cannot receive a closure)"
            )
        budget = self._spec_budget(spec)
        cap = self.admission.max_ea_budget
        if cap is not None and budget > cap:
            self._shed(opt_id, "budget", budget=budget, cap=cap)
        self.refresh()
        if worker is not None:
            if worker not in self.workers:
                raise ValueError(f"unknown worker {worker!r}")
            target = self.workers[worker]
            if target.state in ("dead", "fenced", "stopped", "stopping"):
                raise ValueError(
                    f"worker {worker!r} is {target.state}; cannot pin "
                    f"placement there"
                )
        else:
            candidates = [
                w for w in self.workers.values()
                if w.state in ("alive", "starting", "suspect")
            ]
            if not candidates:
                self._shed(opt_id, "no_workers")
            placeable = [
                w for w in candidates if not self._worker_contended(w)
            ]
            if not placeable:
                if self.admission.shed_when_contended:
                    self._shed(opt_id, "contended")
                placeable = candidates
            target = min(placeable, key=self._worker_load)
        self._order_seq += 1
        enqueue_order(
            os.path.join(target.dir, INBOX_DIR), self._order_seq,
            "submit", {"spec": spec},
        )
        placement = {"opt_id": opt_id, "worker": target.id, "budget": budget}
        self.placements[opt_id] = {
            "worker": target.id, "budget": budget, "spec": spec,
        }
        self.tenant_states.setdefault(opt_id, "placed")
        if self.telemetry:
            self.telemetry.inc("fleet_tenants_placed_total", worker=target.id)
        self._persist()
        return placement

    def _shed(self, opt_id: str, reason: str, **extra) -> None:
        self.shed.append({"opt_id": opt_id, "reason": reason, **extra})
        if self.telemetry:
            self.telemetry.inc("fleet_tenants_shed_total", reason=reason)
        self._persist()
        raise FleetAdmissionError(
            f"tenant {opt_id!r} shed ({reason}): "
            + (
                f"EA budget {extra.get('budget')} exceeds the per-tenant "
                f"cap {extra.get('cap')}"
                if reason == "budget"
                else "every fleet worker is contended"
                if reason == "contended"
                else "no alive workers"
            )
        )

    # ------------------------------------------------------------- liveness

    def refresh(self) -> None:
        """Re-read every worker's status file and fold tenant states
        (terminal states stick — a stale status from a dead worker can
        never un-complete a tenant)."""
        for w in self.workers.values():
            status = read_json(os.path.join(w.dir, STATUS_FILE))
            if status is not None:
                w.status = status
            for opt_id, st in ((w.status or {}).get("tenants") or {}).items():
                prev = self.tenant_states.get(opt_id)
                if prev in TERMINAL_STATES:
                    continue
                self.tenant_states[opt_id] = st.get("state", "unknown")
            self._reconcile_adoptions(w)

    def _reconcile_adoptions(self, w: _Worker) -> None:
        """Match a survivor's reported adoptions against the migration
        records they fulfil. A moved tenant the adoption did NOT carry
        (it completed on the dead worker after its last status, so it
        was retired out of the checkpoint), and that no requeue or
        resubmit covers, is marked ``lost`` — a terminal,
        loudly-flagged state, so the fleet run converges instead of
        waiting forever for a tenant nobody owns."""
        for a in (w.status or {}).get("adoptions") or []:
            mig = next(
                (
                    m
                    for m in self.migrations
                    if m["placement_epoch"] == a.get("placement_epoch")
                ),
                None,
            )
            if mig is None or mig.get("adopted") is not None:
                continue
            mig["adopted"] = list(a.get("tenants", []))
            covered = set(mig["adopted"])
            covered.update(mig.get("requeued_orders", []))
            covered.update(mig.get("resubmitted", []))
            for opt_id in mig.get("tenants", []):
                if opt_id in covered:
                    continue
                if self.tenant_states.get(opt_id) in TERMINAL_STATES:
                    continue
                self.logger.warning(
                    f"tenant {opt_id!r} was not in {mig['from']!r}'s "
                    f"adopted checkpoint (it likely finished unreported "
                    f"before the fence); marking it lost — check its "
                    f"results store for its durable fronts"
                )
                self.tenant_states[opt_id] = "lost"

    def _probe(self, w: _Worker) -> Optional[bool]:
        """One retried ``/healthz`` probe; None when the worker has not
        surfaced an exporter port yet (heartbeat age governs alone)."""
        exporter = (w.status or {}).get("exporter") or {}
        url = exporter.get("url")
        if not url:
            return None
        pol = self.liveness
        for attempt in range(pol.probe_retries + 1):
            t0 = time.perf_counter()
            try:
                with urllib.request.urlopen(
                    url + "/healthz", timeout=pol.probe_timeout
                ) as resp:
                    resp.read()
                if self.telemetry:
                    self.telemetry.observe(
                        "fleet_probe_seconds",
                        time.perf_counter() - t0,
                        worker=w.id,
                    )
                return True
            except (urllib.error.URLError, OSError, TimeoutError):
                if self.telemetry:
                    self.telemetry.inc(
                        "fleet_probe_failures_total", worker=w.id
                    )
                if attempt < pol.probe_retries:
                    time.sleep(
                        jittered_backoff(
                            attempt, pol.probe_backoff, pol.probe_backoff_cap
                        )
                    )
        return False

    def _heartbeat_age(self, w: _Worker) -> float:
        if w.status is None:
            return time.monotonic() - w.spawn_ts
        return max(time.time() - float(w.status.get("ts", 0.0)), 0.0)

    def monitor_once(self) -> List[Dict[str, Any]]:
        """One failure-detection round: refresh statuses, evaluate the
        three liveness signals per worker under the hysteresis policy,
        and migrate the tenants of any worker confirmed dead. Returns
        the events produced this round."""
        events: List[Dict[str, Any]] = []
        self.refresh()
        for w in self.workers.values():
            if w.state in ("dead", "fenced", "stopped"):
                continue
            code = w.proc.poll() if w.proc is not None else None
            if code is not None:
                w.exit_code = code
                if w.state == "stopping" and code == EXIT_OK:
                    w.state = "stopped"
                    continue
                # unambiguous death: no hysteresis needed
                events.extend(self._declare_dead(w, f"process exit {code}"))
                continue
            if w.state == "stopping":
                continue
            hb_age = self._heartbeat_age(w)
            probe_ok = self._probe(w)
            w.last_probe_ok = probe_ok
            suspect = hb_age > self.liveness.heartbeat_timeout or (
                probe_ok is False
            )
            if suspect:
                w.suspect_rounds += 1
                w.state = "suspect"
                if w.suspect_rounds >= self.liveness.confirm_rounds:
                    events.extend(
                        self._declare_dead(
                            w,
                            f"heartbeat age {hb_age:.1f}s, probe "
                            f"{'failed' if probe_ok is False else 'n/a'} "
                            f"for {w.suspect_rounds} consecutive rounds",
                        )
                    )
            else:
                w.suspect_rounds = 0
                if w.state in ("starting", "suspect"):
                    w.state = "alive"
        self._gauge_alive()
        if events:
            self._persist()
        return events

    def _gauge_alive(self) -> None:
        if self.telemetry:
            self.telemetry.gauge(
                "fleet_workers_alive",
                sum(
                    1
                    for w in self.workers.values()
                    if w.state in ("alive", "starting", "suspect")
                ),
            )

    # ------------------------------------------------------------ migration

    def _declare_dead(self, w: _Worker, cause: str) -> List[Dict[str, Any]]:
        self.logger.warning(f"fleet worker {w.id!r} declared dead: {cause}")
        w.state = "dead"
        if self.telemetry:
            self.telemetry.inc("fleet_worker_deaths_total", worker=w.id)
        events: List[Dict[str, Any]] = [
            {"event": "worker_dead", "worker": w.id, "cause": cause}
        ]
        events.extend(self._fence_and_migrate(w, cause))
        return events

    def _fence_and_migrate(
        self, w: _Worker, cause: str
    ) -> List[Dict[str, Any]]:
        """The fencing protocol: fence flag -> grace for self-exit ->
        kill if still running -> only then claim + adopt. Serializing
        the writer out of existence BEFORE the claim is what makes the
        lease check sufficient: there is never a live process behind a
        checkpoint a survivor adopts."""
        touch_flag(os.path.join(w.dir, FENCE_FILE))
        if w.proc is not None and w.proc.poll() is None:
            deadline = time.monotonic() + self.liveness.fence_grace
            while w.proc.poll() is None and time.monotonic() < deadline:
                time.sleep(0.05)
            if w.proc.poll() is None:
                self.logger.warning(
                    f"fenced worker {w.id!r} still running after "
                    f"{self.liveness.fence_grace}s grace; killing it"
                )
                w.proc.kill()
                w.proc.wait(timeout=30.0)
            w.exit_code = w.proc.returncode
        w.state = "fenced" if w.exit_code == EXIT_FENCED else "dead"

        survivor = self._pick_survivor(exclude=w.id)
        moved_tenants = [
            opt_id
            for opt_id, p in self.placements.items()
            if p["worker"] == w.id
            and self.tenant_states.get(opt_id) not in TERMINAL_STATES
        ]
        events: List[Dict[str, Any]] = []
        if survivor is None:
            self.logger.error(
                f"no survivor available to adopt {w.id!r}'s tenants "
                f"{moved_tenants}; they are stranded until a worker "
                f"joins"
            )
            return [
                {
                    "event": "migration_stranded",
                    "worker": w.id,
                    "tenants": moved_tenants,
                }
            ]
        self.placement_epoch += 1
        # adoption first: the lease-claimed checkpoint carries every
        # tenant that reached an epoch boundary on the dead worker
        migrated = False
        if os.path.exists(w.checkpoint_path):
            self._order_seq += 1
            enqueue_order(
                os.path.join(survivor.dir, INBOX_DIR), self._order_seq,
                "migrate",
                {
                    "checkpoint": w.checkpoint_path,
                    "expected_owner": w.id,
                    "placement_epoch": self.placement_epoch,
                    "from_worker": w.id,
                },
            )
            migrated = True
        # then the dead worker's unclaimed inbox orders, so a tenant
        # whose submit order was never even processed lands somewhere
        requeued = []
        for path, order in claim_orders(os.path.join(w.dir, INBOX_DIR)):
            self._order_seq += 1
            enqueue_order(
                os.path.join(survivor.dir, INBOX_DIR), self._order_seq,
                order.get("kind", "submit"),
                {k: v for k, v in order.items() if k not in ("kind", "seq")},
            )
            mark_done(path)
            spec = order.get("spec") or {}
            if spec.get("opt_id"):
                requeued.append(spec["opt_id"])
        # finally, restart-from-spec for tenants with NO durable state:
        # the worker died before its first epoch-boundary checkpoint
        # (nothing to adopt), or the tenant was never observed in any
        # status (so it cannot be in the checkpoint). A seeded tenant
        # restarted from its spec reproduces the same trajectory — the
        # worker-side opt_id dedupe makes the tiny
        # checkpointed-but-never-reported race a no-op instead of a
        # double submission.
        resubmitted = []
        for opt_id in moved_tenants:
            if opt_id in requeued:
                continue
            if migrated and self.tenant_states.get(opt_id) != "placed":
                continue
            self._order_seq += 1
            enqueue_order(
                os.path.join(survivor.dir, INBOX_DIR), self._order_seq,
                "submit", {"spec": self.placements[opt_id]["spec"]},
            )
            resubmitted.append(opt_id)
        for opt_id, p in self.placements.items():
            if p["worker"] == w.id:
                p["worker"] = survivor.id
        record = {
            "event": "migration",
            "from": w.id,
            "to": survivor.id,
            "cause": cause,
            "placement_epoch": self.placement_epoch,
            "tenants": moved_tenants,
            "requeued_orders": requeued,
            "resubmitted": resubmitted,
            "checkpoint_claimed": migrated,
            "ts": time.time(),
        }
        self.migrations.append(record)
        events.append(record)
        if self.telemetry:
            if migrated or requeued or resubmitted:
                self.telemetry.inc("fleet_migrations_total")
            if moved_tenants:
                self.telemetry.inc(
                    "fleet_tenants_migrated_total", len(moved_tenants)
                )
        self.logger.warning(
            f"migrated worker {w.id!r} -> {survivor.id!r}: "
            f"{len(moved_tenants)} tenant(s), placement epoch "
            f"{self.placement_epoch}"
        )
        return events

    def _pick_survivor(self, exclude: str) -> Optional[_Worker]:
        candidates = [
            w
            for w in self.workers.values()
            if w.id != exclude and w.state in ("alive", "starting", "suspect")
        ]
        if not candidates:
            return None
        return min(candidates, key=self._worker_load)

    # ------------------------------------------------------------- running

    def pending_tenants(self) -> List[str]:
        return [
            opt_id
            for opt_id in self.placements
            if self.tenant_states.get(opt_id) not in TERMINAL_STATES
        ]

    def run(
        self, poll: float = 0.3, timeout: float = 900.0
    ) -> Dict[str, Any]:
        """Monitor until every placed tenant reaches a terminal state
        (or `timeout`); returns `summary()`."""
        deadline = time.monotonic() + timeout
        while True:
            self.monitor_once()
            if not self.pending_tenants():
                return self.summary()
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"fleet run timed out with tenants still pending: "
                    f"{self.pending_tenants()}"
                )
            time.sleep(poll)

    def summary(self) -> Dict[str, Any]:
        lease_conflicts = sum(
            int((w.status or {}).get("lease_conflicts") or 0)
            for w in self.workers.values()
        )
        return {
            "fleet_dir": self.fleet_dir,
            "placement_epoch": self.placement_epoch,
            "workers": {
                w.id: {
                    "state": w.state,
                    "pid": w.proc.pid if w.proc is not None else None,
                    "exit_code": w.exit_code,
                    "steps": (w.status or {}).get("steps"),
                    "exporter": (w.status or {}).get("exporter"),
                    "suspect_rounds": w.suspect_rounds,
                }
                for w in self.workers.values()
            },
            "placements": {
                opt_id: {"worker": p["worker"], "budget": p["budget"]}
                for opt_id, p in self.placements.items()
            },
            "tenants": dict(self.tenant_states),
            "migrations": list(self.migrations),
            "shed": list(self.shed),
            "lease_conflicts": lease_conflicts,
        }

    def _persist(self) -> None:
        atomic_write_json(
            os.path.join(self.fleet_dir, FLEET_STATE_FILE),
            dict(self.summary(), format="dmosopt_tpu.fleet_state", version=1),
        )

    # -------------------------------------------------------------- stop

    def stop(self, timeout: float = 60.0) -> None:
        """Graceful shutdown: stop flags, wait, kill stragglers."""
        for w in self.workers.values():
            if w.proc is not None and w.proc.poll() is None:
                w.state = "stopping"
                touch_flag(os.path.join(w.dir, STOP_FILE))
        deadline = time.monotonic() + timeout
        for w in self.workers.values():
            if w.proc is None:
                continue
            while w.proc.poll() is None and time.monotonic() < deadline:
                time.sleep(0.05)
            if w.proc.poll() is None:
                w.proc.kill()
                w.proc.wait(timeout=30.0)
            w.exit_code = w.proc.returncode
            if w.state == "stopping":
                w.state = "stopped"
            if w.log_handle is not None:
                w.log_handle.close()
                w.log_handle = None
        self.refresh()
        self._persist()

    def close(self) -> None:
        if self._closed:
            return
        self.stop()
        self._closed = True
        if self.telemetry is not None and self._owns_telemetry:
            self.telemetry.close()

    def __enter__(self) -> "FleetSupervisor":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
