"""Host-side task-DAG scheduler for service epochs.

Port of ``dmosopt_tpu/parallel/taskgraph.py``, the same code over the
port's `span_scope`. The lockstep service step is a barrier chain —
admit, eval-drain (all tenants), fit (all buckets, serially), fold (all
tenants), checkpoint — so the card idles whenever any stage is
host-bound. Here the epoch is a small per-tenant/per-bucket task DAG,
and a host-side scheduler runs every node whose dependencies are met,
so bucket B's fit and generation loop launch while bucket A's
evaluations drain and fold. In the JAX package the overlap comes from
async dispatch; in eager torch every node issues onto the device's one
default stream from its worker thread, so what overlaps is host work
(evaluation drains, folds, one bucket's host tail) with another
bucket's launches, within what the GIL allows.

Guarantees, as in the JAX package:

- **Determinism at concurrency 1.** Node creation order must be a
  topological order (``add`` rejects a dependency on a not-yet-created
  node), and the serial path runs nodes exactly in creation order on
  the calling thread: no pool, no queue. A service step whose graph is
  built in lockstep order reproduces the lockstep trajectories bitwise.
- **Deterministic dispatch order under concurrency.** The ready set is
  ordered by creation sequence; workers are only handed the
  lowest-sequence ready node. Completion order still varies with
  thread timing; per-tenant results stay bitwise because every service
  tenant owns its own random streams.
- **Single-coordinator state.** All graph state (node states, dependency
  counts, the ready heap) is mutated only on the coordinator thread;
  worker threads run a node's closure and report the node through a
  `queue.Queue`. A failed node transitively SKIPs its dependents while
  unrelated branches keep running.
- **Bounded lifecycle.** The worker pool is a ``with``-scoped
  `ThreadPoolExecutor` created per `run` call; it cannot outlive the
  step.

Telemetry (the JAX package's names): per-node ``scheduler_node`` spans
(opened on the worker thread, so nested ``gp_fit``/``ea_scan`` spans
keep their parent on that thread), counters ``scheduler_nodes_total`` /
``scheduler_node_failures_total`` / ``scheduler_nodes_skipped_total``,
histograms ``scheduler_node_wait_seconds`` /
``scheduler_node_run_seconds``, gauges ``scheduler_queue_depth`` and
``scheduler_stall_seconds`` (the longest a device-launching node sat
ready before a worker picked it up), and one ``scheduler_run`` event.
"""

from __future__ import annotations

import heapq
import queue
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from dmosopt_tpu_torch.telemetry import span_scope

#: node lifecycle states
PENDING = "pending"      # dependencies not yet satisfied
READY = "ready"          # dependencies done, waiting for a worker
RUNNING = "running"      # closure executing
DONE = "done"
FAILED = "failed"        # closure raised; error recorded on the node
SKIPPED = "skipped"      # a transitive dependency failed

#: node kinds whose ready-wait counts toward the stall gauge — these
#: are the nodes that launch device programs, so a long ready-wait on
#: one of them is exactly "ready nodes but idle device"
DEVICE_KINDS = ("bucket", "seq")


@dataclass
class TaskNode:
    """One schedulable unit of a service epoch."""

    name: str
    fn: Callable[[], Any]
    kind: str = "task"
    tenant: Optional[str] = None
    seq: int = 0
    deps: Tuple["TaskNode", ...] = ()
    state: str = PENDING
    result: Any = None
    error: Optional[BaseException] = None
    t_ready: Optional[float] = None
    t_start: Optional[float] = None
    t_end: Optional[float] = None

    @property
    def wait_s(self) -> Optional[float]:
        if self.t_ready is None or self.t_start is None:
            return None
        return self.t_start - self.t_ready

    @property
    def run_s(self) -> Optional[float]:
        if self.t_start is None or self.t_end is None:
            return None
        return self.t_end - self.t_start


@dataclass
class GraphRun:
    """Outcome of one `TaskGraph.run`: the executed nodes plus the
    aggregates the service folds into `introspect()` and telemetry."""

    nodes: List[TaskNode]
    wall_s: float
    concurrency: int
    stall_s: float = 0.0
    counts: Dict[str, int] = field(default_factory=dict)

    @property
    def failed(self) -> List[TaskNode]:
        return [n for n in self.nodes if n.state == FAILED]

    @property
    def skipped(self) -> List[TaskNode]:
        return [n for n in self.nodes if n.state == SKIPPED]

    def to_dict(self) -> Dict[str, Any]:
        return {
            "n_nodes": len(self.nodes),
            "wall_s": round(self.wall_s, 6),
            "concurrency": self.concurrency,
            "stall_s": round(self.stall_s, 6),
            "counts": dict(self.counts),
            "nodes": [
                {
                    "name": n.name,
                    "kind": n.kind,
                    "tenant": n.tenant,
                    "state": n.state,
                    "wait_s": (
                        round(n.wait_s, 6) if n.wait_s is not None else None
                    ),
                    "run_s": (
                        round(n.run_s, 6) if n.run_s is not None else None
                    ),
                }
                for n in self.nodes
            ],
        }


class TaskGraph:
    """A small DAG of `TaskNode`s built in topological (creation)
    order and executed by `run`.

    ``add`` enforces the creation-order invariant the serial path's
    bitwise guarantee rests on: every dependency must already be a node
    of this graph (so ``seq(dep) < seq(node)``), which makes creation
    order a valid topological order by construction.
    """

    def __init__(self, name: str = "epoch"):
        self.name = name
        self.nodes: List[TaskNode] = []

    def add(
        self,
        name: str,
        fn: Callable[[], Any],
        *,
        deps: Sequence[TaskNode] = (),
        kind: str = "task",
        tenant: Optional[str] = None,
    ) -> TaskNode:
        for d in deps:
            if not isinstance(d, TaskNode) or d.seq >= len(self.nodes) or (
                self.nodes[d.seq] is not d
            ):
                raise ValueError(
                    f"node {name!r} depends on {getattr(d, 'name', d)!r}, "
                    f"which is not an earlier node of this graph — "
                    f"creation order must be a topological order"
                )
        node = TaskNode(
            name=name,
            fn=fn,
            kind=kind,
            tenant=tenant,
            seq=len(self.nodes),
            deps=tuple(deps),
        )
        self.nodes.append(node)
        return node

    # ------------------------------------------------------------------ run

    def run(
        self,
        *,
        concurrency: int = 1,
        telemetry=None,
        logger=None,
    ) -> GraphRun:
        """Execute the graph and return its `GraphRun`.

        ``concurrency <= 1`` runs every node on the calling thread in
        creation order (the bitwise-parity path); ``concurrency > 1``
        runs ready nodes on a per-call worker pool, lowest sequence
        first. Either way a node whose closure raises is marked FAILED
        (error kept on the node — never re-raised out of `run`) and
        its transitive dependents are SKIPPED.
        """
        t0 = time.perf_counter()
        if concurrency <= 1:
            stall_s = self._run_serial(telemetry)
        else:
            stall_s = self._run_pooled(concurrency, telemetry)
        counts: Dict[str, int] = {}
        for n in self.nodes:
            counts[n.state] = counts.get(n.state, 0) + 1
        run = GraphRun(
            nodes=list(self.nodes),
            wall_s=time.perf_counter() - t0,
            concurrency=max(1, int(concurrency)),
            stall_s=stall_s,
            counts=counts,
        )
        self._emit(run, telemetry, logger)
        return run

    # ---------------------------------------------------------- execution

    def _execute(self, node: TaskNode, telemetry) -> None:
        """Run one node's closure (caller has set t_start); record the
        outcome on the node. Runs on a worker thread under concurrency —
        it touches only the node itself, never graph state."""
        try:
            with span_scope(
                telemetry, "scheduler_node",
                kind=node.kind, node=node.name, tenant=node.tenant,
            ):
                node.result = node.fn()
            node.state = DONE
        except BaseException as e:
            node.error = e
            node.state = FAILED

    def _skip_dependents(self, node: TaskNode, dependents) -> List[TaskNode]:
        """Transitively SKIP every pending dependent of a failed or
        skipped node; returns the nodes newly skipped."""
        out: List[TaskNode] = []
        work = [node]
        while work:
            cur = work.pop()
            for child in dependents.get(cur.seq, ()):
                if child.state == PENDING:
                    child.state = SKIPPED
                    out.append(child)
                    work.append(child)
        return out

    def _run_serial(self, telemetry) -> float:
        dependents = self._dependents()
        for node in self.nodes:
            if node.state == SKIPPED:
                continue
            if any(d.state != DONE for d in node.deps):
                node.state = SKIPPED
                self._skip_dependents(node, dependents)
                continue
            node.t_ready = time.perf_counter()
            node.state = RUNNING
            node.t_start = node.t_ready
            self._execute(node, telemetry)
            node.t_end = time.perf_counter()
            if node.state == FAILED:
                self._skip_dependents(node, dependents)
        return 0.0

    def _run_pooled(self, concurrency: int, telemetry) -> float:
        """Coordinator loop: all graph state lives on this thread; the
        pool workers only execute closures and report completions
        through `done`."""
        dependents = self._dependents()
        n_unmet = {n.seq: sum(1 for _ in n.deps) for n in self.nodes}
        ready: List[int] = []  # heap of seq — deterministic dispatch order
        done: "queue.Queue" = queue.Queue()
        remaining = len(self.nodes)
        running = 0

        def worker(node: TaskNode):
            node.t_start = time.perf_counter()
            self._execute(node, telemetry)
            node.t_end = time.perf_counter()
            done.put(node)

        for n in self.nodes:
            if n_unmet[n.seq] == 0:
                n.state = READY
                n.t_ready = time.perf_counter()
                heapq.heappush(ready, n.seq)

        with ThreadPoolExecutor(
            max_workers=concurrency, thread_name_prefix="dmosopt-sched"
        ) as pool:
            while remaining > 0:
                while ready:
                    node = self.nodes[heapq.heappop(ready)]
                    node.state = RUNNING
                    running += 1
                    pool.submit(worker, node)
                if telemetry:
                    telemetry.gauge(
                        "scheduler_queue_depth", len(ready) + running
                    )
                if running == 0:
                    # nothing runnable and nothing running: every
                    # remaining node hangs off a failed branch
                    for n in self.nodes:
                        if n.state == PENDING:
                            n.state = SKIPPED
                            remaining -= 1
                    break
                node = done.get()
                running -= 1
                remaining -= 1
                now = time.perf_counter()
                if node.state == FAILED:
                    for skipped in self._skip_dependents(node, dependents):
                        remaining -= 1
                        if skipped.seq in n_unmet:
                            n_unmet.pop(skipped.seq, None)
                else:
                    for child in dependents.get(node.seq, ()):
                        if child.state != PENDING:
                            continue
                        n_unmet[child.seq] -= 1
                        if n_unmet[child.seq] == 0:
                            child.state = READY
                            child.t_ready = now
                            heapq.heappush(ready, child.seq)
        return 0.0

    def _dependents(self) -> Dict[int, List[TaskNode]]:
        out: Dict[int, List[TaskNode]] = {}
        for n in self.nodes:
            for d in n.deps:
                out.setdefault(d.seq, []).append(n)
        return out

    # ---------------------------------------------------------- telemetry

    def _emit(self, run: GraphRun, telemetry, logger) -> None:
        """Fold one run's aggregates into telemetry (coordinator
        thread, after the pool is gone)."""
        stall = run.stall_s
        for node in run.nodes:
            wait = node.wait_s
            if (
                node.kind in DEVICE_KINDS
                and wait is not None
                and run.concurrency > 1
            ):
                stall = max(stall, wait)
        run.stall_s = stall
        if telemetry:
            for node in run.nodes:
                labels = {"kind": node.kind}
                telemetry.inc("scheduler_nodes_total", 1, **labels)
                if node.state == FAILED:
                    telemetry.inc("scheduler_node_failures_total", 1, **labels)
                elif node.state == SKIPPED:
                    telemetry.inc("scheduler_nodes_skipped_total", 1, **labels)
                if node.wait_s is not None:
                    telemetry.observe(
                        "scheduler_node_wait_seconds", node.wait_s, **labels
                    )
                if node.run_s is not None:
                    telemetry.observe(
                        "scheduler_node_run_seconds", node.run_s, **labels
                    )
            telemetry.gauge("scheduler_queue_depth", 0)
            telemetry.gauge("scheduler_stall_seconds", run.stall_s)
            telemetry.event(
                "scheduler_run",
                graph=self.name,
                n_nodes=len(run.nodes),
                concurrency=run.concurrency,
                wall_s=round(run.wall_s, 6),
                stall_s=round(run.stall_s, 6),
                **{k: v for k, v in run.counts.items()},
            )
        if logger is not None and run.failed:
            for node in run.failed:
                logger.warning(
                    "taskgraph %s: node %s (%s) failed: %r",
                    self.name, node.name, node.kind, node.error,
                )


def resolve_concurrency(scheduler) -> int:
    """Resolve the service's ``scheduler`` knob to a worker count:
    None/False -> 0 (lockstep step, no graph), True -> a bounded
    auto width, an int -> itself (1 = serial graph, the parity mode),
    a dict -> its ``concurrency`` entry through the same rules."""
    if scheduler is None or scheduler is False:
        return 0
    if scheduler is True:
        import os

        return max(2, min(8, (os.cpu_count() or 2) - 1))
    if isinstance(scheduler, dict):
        return resolve_concurrency(scheduler.get("concurrency", True))
    n = int(scheduler)
    if n < 1:
        return 0
    return n
