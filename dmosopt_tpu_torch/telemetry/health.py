"""Run-health engine: declarative alert rules over the telemetry state.

Port of ``dmosopt_tpu/telemetry/health.py``, a copy (pure Python). The
port's driver evaluates it at each epoch boundary over the metrics
snapshot alone; the rules that read ``introspect:`` paths wait for the
service and are skipped there.

The observability stack before this module was entirely *passive*:
every incident class this project has actually hit — retrace storms,
writer death, quarantine spikes, eval-timeout surges, host contention,
device-busy collapse, label-series overflow — was visible only if a
human read the `status` CLI at the right moment. The health engine
makes the stack *active*: a set of declarative `HealthRule`s is
evaluated over the metrics snapshot (`MetricsRegistry.snapshot()`) and
the service's `introspect()` dict at every epoch/step boundary, each
rule carrying a metric expression, a threshold, a severity, and a
`for_steps` hysteresis, with a full firing -> resolved lifecycle.

Metric expressions (the `HealthRule.metric` string) name one source:

- ``counter:<name>`` — the SUM across every label series of that
  counter in the snapshot (an absent counter reads 0.0 — counters are
  zero until first incremented);
- ``gauge:<name>`` — the unlabeled series of that gauge, falling back
  to the mean across labeled series; an absent gauge reads ``None``
  and the rule is **skipped** that round (state frozen, never fired on
  missing data);
- ``introspect:<dotted.path>`` — a numeric (or bool) leaf of the
  introspection snapshot, e.g. ``introspect:queue_depths.writer_backlog``;
  a missing path skips the rule like an absent gauge.

``counter:``/``gauge:`` names are held to the docs/observability.md
metric catalog by graftlint's ``metrics-catalog`` rule (a rule
referencing an uncataloged metric turns ``make lint`` red), so alert
definitions cannot rot ahead of the catalog.

Evaluation is **deterministic**: no wall-clock or randomness enters a
firing decision — the same snapshot sequence produces the same alert
sequence, which is what lets `make health-smoke` pin the exact alert
set a seeded chaos plan fires (and pin a fault-free run to zero).
Alert transitions are events (``health_alert`` kind — JSONL sink +
per-epoch HDF5 via `storage.save_alerts_to_h5`, like spans), counted
in ``health_alerts_total{rule,severity}``, and surfaced through
``introspect()["health"]`` and the ``status`` CLI.

Thread-safety: `evaluate()` runs on the stepping thread while the
exposition exporter's request threads read `summary()` / `active()` /
`has_critical()` — all state transitions and reads run under one lock.
"""

from __future__ import annotations

import re
import threading
from dataclasses import dataclass, fields
from typing import Any, Dict, List, Optional, Sequence, Union

SEVERITIES = ("info", "warning", "critical")

COMPARATORS = {
    ">": lambda v, t: v > t,
    ">=": lambda v, t: v >= t,
    "<": lambda v, t: v < t,
    "<=": lambda v, t: v <= t,
}

MODES = ("value", "delta")

#: expression grammar: source prefix + name/path
_EXPR_RE = re.compile(
    r"^(counter|gauge):([a-z][a-z0-9_]*)$|^introspect:([A-Za-z0-9_.]+)$"
)


@dataclass(frozen=True)
class HealthRule:
    """One declarative alert rule.

    name: alert identifier (snake_case; what fires and resolves).
    metric: the metric expression evaluated each round (module
        docstring grammar).
    threshold: the comparison boundary.
    severity: ``info`` / ``warning`` / ``critical`` — ``critical``
        alerts flip the exposition ``/healthz`` endpoint non-200.
    compare: ``>``, ``>=``, ``<``, ``<=`` (value vs. threshold).
    for_steps: hysteresis — the comparison must hold on this many
        CONSECUTIVE evaluations before the alert fires (a one-round
        blip on a `for_steps=2` rule never alerts).
    mode: ``value`` compares the resolved value itself; ``delta``
        compares the change since the previous evaluation (the shape
        for monotone counters: "more than N timeouts THIS step").
    description: what the alert means and what to do — rendered by the
        `status` CLI and carried on every transition event.
    """

    name: str
    metric: str
    threshold: float
    severity: str = "warning"
    compare: str = ">"
    for_steps: int = 1
    mode: str = "value"
    description: str = ""

    def __post_init__(self):
        if not re.match(r"^[a-z][a-z0-9_]*$", self.name):
            raise ValueError(f"rule name must be snake_case: {self.name!r}")
        if _EXPR_RE.match(self.metric) is None:
            raise ValueError(
                f"rule {self.name!r}: metric expression {self.metric!r} "
                f"must be 'counter:<name>', 'gauge:<name>' or "
                f"'introspect:<dotted.path>'"
            )
        if self.severity not in SEVERITIES:
            raise ValueError(
                f"rule {self.name!r}: severity must be one of {SEVERITIES}"
            )
        if self.compare not in COMPARATORS:
            raise ValueError(
                f"rule {self.name!r}: compare must be one of "
                f"{tuple(COMPARATORS)}"
            )
        if self.mode not in MODES:
            raise ValueError(
                f"rule {self.name!r}: mode must be one of {MODES}"
            )
        if self.for_steps < 1:
            raise ValueError(f"rule {self.name!r}: for_steps must be >= 1")

    def to_dict(self) -> Dict[str, Any]:
        return {f.name: getattr(self, f.name) for f in fields(self)}

    @classmethod
    def from_spec(
        cls, spec: Union["HealthRule", Dict[str, Any]]
    ) -> "HealthRule":
        if isinstance(spec, cls):
            return spec
        if isinstance(spec, dict):
            return cls(**spec)
        raise TypeError(
            f"health rule must be a HealthRule or dict; got {type(spec)!r}"
        )


def _resolve(metric: str, snapshot: Optional[Dict], introspect: Optional[Dict]):
    """Resolve one metric expression against the two sources. Returns
    a float, or None when the source cannot answer (rule is skipped)."""
    kind, _, name = metric.partition(":")
    if kind == "counter":
        series = (snapshot or {}).get("counters", {}).get(name)
        if series is None:
            return 0.0  # counters are zero until first incremented
        return float(sum(series.values()))
    if kind == "gauge":
        series = (snapshot or {}).get("gauges", {}).get(name)
        if not series:
            return None
        if "" in series:  # the unlabeled series
            return float(series[""])
        return float(sum(series.values()) / len(series))
    # introspect:<dotted.path>
    node: Any = introspect
    for part in name.split("."):
        if not isinstance(node, dict) or part not in node:
            return None
        node = node[part]
    if isinstance(node, bool):
        return 1.0 if node else 0.0
    if isinstance(node, (int, float)):
        return float(node)
    return None


def default_rulebook(include_host: bool = True) -> List[HealthRule]:
    """The seeded rulebook: one rule per incident class this project
    has actually hit (each cites its origin). With
    ``include_host=False`` the environment-sensitive rules (host
    contention — a function of the machine, not the run) are dropped:
    that subset is what the deterministic pins (`make health-smoke`,
    tests) evaluate, so a loaded CI host can never fail a
    "healthy run fires nothing" assertion.
    """
    rules = [
        HealthRule(
            name="bucket_retrace_storm",
            metric="counter:tenant_bucket_retraces_total",
            threshold=1.0, compare=">", mode="delta", severity="warning",
            description=(
                "2+ bucket-program retraces in one step: shape drift is "
                "re-paying multi-second compiles every epoch (see "
                "'Compile and retrace observability')"
            ),
        ),
        HealthRule(
            name="quarantine_spike",
            metric="counter:points_quarantined_total",
            threshold=0.0, compare=">", mode="delta", severity="warning",
            description=(
                "non-finite objective rows diverted from a driver "
                "archive this epoch — an objective is returning NaN/inf"
            ),
        ),
        HealthRule(
            name="tenant_quarantine_spike",
            metric="counter:tenant_points_quarantined_total",
            threshold=0.0, compare=">", mode="delta", severity="warning",
            description=(
                "non-finite objective rows quarantined out of a service "
                "tenant's archive this step (docs/robustness.md)"
            ),
        ),
        HealthRule(
            name="writer_backlog_growth",
            metric="introspect:queue_depths.writer_backlog",
            threshold=64.0, compare=">", for_steps=2, severity="warning",
            description=(
                "persistence closures are queueing faster than the "
                "background writer drains them across consecutive steps"
            ),
        ),
        HealthRule(
            name="writer_dead",
            metric="introspect:writer.failed",
            threshold=1.0, compare=">=", severity="critical",
            description=(
                "the background persistence writer died (write failed "
                "after its retry budget): fronts and checkpoints are NO "
                "LONGER written (docs/robustness.md)"
            ),
        ),
        HealthRule(
            name="eval_timeout_surge",
            metric="counter:eval_timeouts_total",
            threshold=2.0, compare=">", mode="delta", severity="warning",
            description=(
                "3+ evaluation attempts timed out this step — an "
                "objective is wedging past its EvalPolicy budget"
            ),
        ),
        HealthRule(
            name="eval_failure_surge",
            metric="counter:eval_failures_total",
            threshold=2.0, compare=">", mode="delta", severity="warning",
            description=(
                "3+ evaluation requests exhausted their retry budget "
                "this step"
            ),
        ),
        HealthRule(
            name="device_busy_collapse",
            metric="gauge:device_busy_fraction",
            threshold=0.1, compare="<", for_steps=2, severity="warning",
            description=(
                "trace-derived device utilization below 10% on "
                "consecutive profiled epochs — the device is idling "
                "(ROADMAP items 2/6; see 'Device-time ledger')"
            ),
        ),
        HealthRule(
            name="pipeline_overlap_collapse",
            metric="gauge:pipeline_overlap_ratio",
            threshold=0.05, compare="<", for_steps=2, severity="warning",
            description=(
                "evaluation batches are no longer overlapping driver "
                "work (serial-mode behavior in an overlap config)"
            ),
        ),
        HealthRule(
            name="scheduler_stall",
            metric="gauge:scheduler_stall_seconds",
            threshold=1.0, compare=">", for_steps=2, severity="warning",
            description=(
                "a device-launching task-graph node (bucket/seq) sat "
                "READY for over a second on consecutive steps while "
                "workers were busy elsewhere — ready nodes but an idle "
                "device; raise the scheduler concurrency or check for "
                "a host-bound eval hogging the pool (docs/parallel.md "
                "'Async task-graph epochs')"
            ),
        ),
        HealthRule(
            name="series_overflow",
            metric="counter:telemetry_series_overflow_total",
            threshold=0.0, compare=">", mode="delta", severity="warning",
            description=(
                "emissions are collapsing into overflow series — a "
                "label axis (per-tenant?) exceeded label_series_limit "
                "(see 'Label cardinality')"
            ),
        ),
    ]
    if include_host:
        rules.append(
            HealthRule(
                name="host_contention",
                metric="introspect:throughput.load_ratio",
                threshold=1.5, compare=">", for_steps=2, severity="warning",
                description=(
                    "1-minute loadavg above 1.5x cores on consecutive "
                    "steps: walls can be 3-9x inflated (the BENCH_r04/"
                    "r05 trap) — re-measure idle before trusting any "
                    "regression"
                ),
            )
        )
    return rules


class _RuleState:
    __slots__ = ("streak", "firing", "fired_step", "last_value", "prev_raw")

    def __init__(self):
        self.streak = 0
        self.firing = False
        self.fired_step: Optional[int] = None
        self.last_value: Optional[float] = None
        self.prev_raw: Optional[float] = None  # delta-mode baseline


class HealthEngine:
    """Evaluate a rulebook over (metrics snapshot, introspect snapshot)
    at every epoch/step boundary and manage each rule's
    firing -> resolved lifecycle.

    `telemetry` (optional) receives the side effects of every
    transition: one ``health_alert`` event (kind, rule, severity,
    state, value, threshold, step) and — on firing only — one
    ``health_alerts_total{rule,severity}`` counter increment. The
    engine itself never reads the clock: determinism is the contract
    the smoke gate pins.
    """

    def __init__(
        self,
        rules: Optional[Sequence[Union[HealthRule, Dict]]] = None,
        telemetry=None,
    ):
        self.rules: List[HealthRule] = [
            HealthRule.from_spec(r)
            for r in (default_rulebook() if rules is None else rules)
        ]
        names = [r.name for r in self.rules]
        dupes = {n for n in names if names.count(n) > 1}
        if dupes:
            raise ValueError(f"duplicate health rule name(s): {sorted(dupes)}")
        self.telemetry = telemetry
        self._lock = threading.Lock()
        self._state: Dict[str, _RuleState] = {
            r.name: _RuleState() for r in self.rules
        }
        #: every transition ever produced, in evaluation order
        self.alerts: List[Dict[str, Any]] = []

    # ---------------------------------------------------------- evaluate

    def evaluate(
        self,
        snapshot: Optional[Dict] = None,
        introspect: Optional[Dict] = None,
        step: Optional[int] = None,
        epoch: Optional[int] = None,
    ) -> List[Dict[str, Any]]:
        """One evaluation round. Returns the transitions produced this
        round (possibly empty): dicts with ``rule``, ``severity``,
        ``state`` (``firing``/``resolved``), ``value``, ``threshold``,
        ``step``, ``description``."""
        transitions: List[Dict[str, Any]] = []
        with self._lock:
            for rule in self.rules:
                st = self._state[rule.name]
                raw = _resolve(rule.metric, snapshot, introspect)
                if raw is None:
                    continue  # source cannot answer: state frozen
                if rule.mode == "delta":
                    base = st.prev_raw if st.prev_raw is not None else 0.0
                    value = raw - base
                    st.prev_raw = raw
                else:
                    value = raw
                st.last_value = value
                breach = COMPARATORS[rule.compare](value, rule.threshold)
                if breach:
                    st.streak += 1
                    if not st.firing and st.streak >= rule.for_steps:
                        st.firing = True
                        st.fired_step = step
                        transitions.append(
                            self._transition(rule, "firing", value, step, epoch)
                        )
                else:
                    st.streak = 0
                    if st.firing:
                        st.firing = False
                        transitions.append(
                            self._transition(rule, "resolved", value, step, epoch)
                        )
            self.alerts.extend(transitions)
        # telemetry side effects outside the engine lock (the registry
        # and event log have their own locks; holding ours across their
        # IO would invert the lock-discipline blocking rule)
        tel = self.telemetry
        if tel:
            for tr in transitions:
                if tr["state"] == "firing":
                    tel.inc(
                        "health_alerts_total",
                        rule=tr["rule"], severity=tr["severity"],
                    )
                tel.event(
                    "health_alert",
                    epoch=epoch,
                    rule=tr["rule"], severity=tr["severity"],
                    state=tr["state"], value=tr["value"],
                    threshold=tr["threshold"], step=tr["step"],
                    description=tr["description"],
                )
        return transitions

    @staticmethod
    def _transition(rule, state, value, step, epoch) -> Dict[str, Any]:
        return {
            "rule": rule.name,
            "severity": rule.severity,
            "state": state,
            "metric": rule.metric,
            "value": round(float(value), 6),
            "threshold": rule.threshold,
            "step": step,
            "epoch": epoch,
            "description": rule.description,
        }

    # ------------------------------------------------------------ queries

    def active(self) -> List[Dict[str, Any]]:
        """Currently firing alerts (rule, severity, since-step, last
        value), stable rulebook order."""
        with self._lock:
            return [
                {
                    "rule": r.name,
                    "severity": r.severity,
                    "since_step": self._state[r.name].fired_step,
                    "value": self._state[r.name].last_value,
                    "threshold": r.threshold,
                    "description": r.description,
                }
                for r in self.rules
                if self._state[r.name].firing
            ]

    def has_critical(self) -> bool:
        with self._lock:
            return any(
                r.severity == "critical" and self._state[r.name].firing
                for r in self.rules
            )

    def summary(self) -> Dict[str, Any]:
        """JSON-able engine snapshot for ``introspect()["health"]`` and
        the ``status`` CLI: firing alerts, per-severity firing counts,
        total transitions, and the rulebook size."""
        with self._lock:
            firing = [
                {
                    "rule": r.name,
                    "severity": r.severity,
                    "since_step": self._state[r.name].fired_step,
                    "value": self._state[r.name].last_value,
                }
                for r in self.rules
                if self._state[r.name].firing
            ]
            counts: Dict[str, int] = {}
            for f in firing:
                counts[f["severity"]] = counts.get(f["severity"], 0) + 1
            return {
                "status": (
                    "critical"
                    if any(f["severity"] == "critical" for f in firing)
                    else ("alerting" if firing else "ok")
                ),
                "firing": firing,
                "firing_counts": counts,
                "transitions_total": len(self.alerts),
                "rules": len(self.rules),
            }

    def transitions(
        self, epoch: Optional[int] = None, state: Optional[str] = None
    ) -> List[Dict[str, Any]]:
        """Recorded transitions, optionally filtered by epoch and/or
        state — the per-epoch slice is what the driver persists to
        HDF5 beside the spans."""
        with self._lock:
            out = list(self.alerts)
        if epoch is not None:
            out = [t for t in out if t.get("epoch") == epoch]
        if state is not None:
            out = [t for t in out if t.get("state") == state]
        return out

    def fired(self) -> List[tuple]:
        """The deduplicated ``(rule, severity)`` set that has EVER
        fired, sorted — the exact object the smoke gate pins against
        its expected alert set."""
        with self._lock:
            return sorted(
                {
                    (t["rule"], t["severity"])
                    for t in self.alerts
                    if t["state"] == "firing"
                }
            )
