"""OpenMetrics exposition: render the metrics registry as scrape text,
serve it (plus health and introspection) over stdlib HTTP.

Port of ``dmosopt_tpu/telemetry/exposition.py``, the same code: both
packages render byte-identical text for the same registry snapshot.

Two layers, both dependency-free:

- `render_openmetrics(snapshot)` turns a `MetricsRegistry.snapshot()`
  dict into OpenMetrics 1.0 text (counters, gauges, histograms with
  cumulative buckets, terminated by ``# EOF``), and
  `parse_openmetrics(text)` is the in-repo validating parser the tests
  round-trip through — exposition output must parse cleanly AND agree
  exactly with the snapshot it rendered.
- `MetricsExporter` is the service's network-facing surface: an opt-in
  ``http.server`` thread serving

  - ``/metrics``  — the OpenMetrics rendering of a live snapshot,
  - ``/healthz``  — the health engine's alert state as JSON; responds
    ``503`` while any **critical** alert is firing, ``200`` otherwise
    (the liveness-probe contract), and
  - ``/statusz`` — the full ``introspect()`` snapshot as JSON.

  The server thread is an instance attribute joined on ``close()``;
  request handlers only call the three injected snapshot callbacks (each internally locked by its
  owner — registry lock, health-engine lock, service lock), and the
  exporter holds no mutable shared state of its own.

Naming: OpenMetrics requires counter *samples* to carry the ``_total``
suffix on their family name. Registry counters already named
``*_total`` expose family = name minus the suffix; the two cumulative
seconds counters without it (``tenant_cost_seconds``,
``tenant_device_seconds``) expose family = registry name and sample =
``<name>_total``. `parse_openmetrics` + `samples_as_snapshot` undo the
mapping, which is how the agree-exactly test closes the loop.
"""

from __future__ import annotations

import json
import math
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

from dmosopt_tpu_torch.utils import json_default

CONTENT_TYPE = "application/openmetrics-text; version=1.0.0; charset=utf-8"


# ---------------------------------------------------------------- rendering


def _escape_label_value(v: str) -> str:
    return (
        v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def _parse_label_str(label_str: str) -> List[Tuple[str, str]]:
    """Invert the registry's ``k=v,k2=v2`` label-series key. Label
    KEYS are code-controlled keyword identifiers (never ``,`` or
    ``=``), so each part's key is everything before its first ``=``;
    a value containing ``=`` stays intact, and a part WITHOUT ``=`` is
    a comma that belonged to the previous value (user-supplied
    ``opt_id``s land in ``tenant=`` labels verbatim) and is rejoined.
    The one residual ambiguity — a value containing the exact pattern
    ``,<word>=`` — is inherent to the flat key format."""
    if not label_str:
        return []
    out: List[Tuple[str, str]] = []
    for part in label_str.split(","):
        if "=" in part:
            k, _, v = part.partition("=")
            out.append((k, v))
        elif out:
            k, v = out[-1]
            out[-1] = (k, v + "," + part)
    return out


def _format_labels(pairs: List[Tuple[str, str]]) -> str:
    if not pairs:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label_value(v)}"' for k, v in pairs
    )
    return "{" + inner + "}"


def _format_value(v: float) -> str:
    f = float(v)
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _counter_family(name: str) -> str:
    return name[: -len("_total")] if name.endswith("_total") else name


def render_openmetrics(snapshot: Dict[str, Any]) -> str:
    """OpenMetrics 1.0 text for one registry snapshot. Families are
    emitted in sorted name order, series in sorted label order, so the
    output is byte-deterministic for a given snapshot."""
    lines: List[str] = []

    for name in sorted(snapshot.get("counters", {})):
        series = snapshot["counters"][name]
        family = _counter_family(name)
        lines.append(f"# TYPE {family} counter")
        for label_str in sorted(series):
            labels = _format_labels(_parse_label_str(label_str))
            lines.append(
                f"{family}_total{labels} "
                f"{_format_value(series[label_str])}"
            )

    for name in sorted(snapshot.get("gauges", {})):
        series = snapshot["gauges"][name]
        lines.append(f"# TYPE {name} gauge")
        for label_str in sorted(series):
            labels = _format_labels(_parse_label_str(label_str))
            lines.append(
                f"{name}{labels} {_format_value(series[label_str])}"
            )

    for name in sorted(snapshot.get("histograms", {})):
        series = snapshot["histograms"][name]
        lines.append(f"# TYPE {name} histogram")
        for label_str in sorted(series):
            summary = series[label_str]
            base = _parse_label_str(label_str)
            # snapshot buckets are per-bucket counts at the recorded
            # (non-zero) boundaries; OpenMetrics buckets are cumulative
            bounds = sorted(
                (
                    (math.inf if b == "inf" else float(b)), c
                )
                for b, c in (summary.get("buckets") or {}).items()
            )
            cum = 0
            for bound, count in bounds:
                cum += count
                if math.isinf(bound):
                    continue  # +Inf is emitted once below, = count
                lines.append(
                    f"{name}_bucket"
                    f"{_format_labels(base + [('le', _format_value(bound))])}"
                    f" {cum}"
                )
            lines.append(
                f"{name}_bucket"
                f"{_format_labels(base + [('le', '+Inf')])}"
                f" {summary['count']}"
            )
            lines.append(
                f"{name}_count{_format_labels(base)} {summary['count']}"
            )
            lines.append(
                f"{name}_sum{_format_labels(base)} "
                f"{_format_value(summary['sum'])}"
            )

    lines.append("# EOF")
    return "\n".join(lines) + "\n"


# ------------------------------------------------------------------ parsing


class OpenMetricsParseError(ValueError):
    """Exposition text violating the (subset of the) OpenMetrics spec
    this stack emits."""


def _parse_sample_line(line: str) -> Tuple[str, Dict[str, str], float]:
    name, labels_part, rest = line, "", None
    if "{" in line:
        name, _, tail = line.partition("{")
        labels_part, closed, rest = tail.partition("}")
        if not closed:
            raise OpenMetricsParseError(f"unclosed label braces: {line!r}")
        rest = rest.strip()
    else:
        name, _, rest = line.partition(" ")
    if rest is None or not rest:
        raise OpenMetricsParseError(f"sample without a value: {line!r}")
    name = name.strip()
    if not name or not name.replace("_", "a").isalnum():
        raise OpenMetricsParseError(f"invalid sample name: {line!r}")
    labels: Dict[str, str] = {}
    if labels_part:
        # labels are k="v" pairs; values were escaped by the renderer
        for m_k, m_v in _iter_label_pairs(labels_part, line):
            labels[m_k] = m_v
    value_str = rest.split()[0]
    if value_str == "+Inf":
        value = math.inf
    elif value_str == "-Inf":
        value = -math.inf
    else:
        try:
            value = float(value_str)
        except ValueError as e:
            raise OpenMetricsParseError(
                f"non-numeric sample value: {line!r}"
            ) from e
    return name, labels, value


def _iter_label_pairs(labels_part: str, line: str):
    i, n = 0, len(labels_part)
    while i < n:
        eq = labels_part.find("=", i)
        if eq < 0:
            raise OpenMetricsParseError(f"malformed labels: {line!r}")
        key = labels_part[i:eq]
        if eq + 1 >= n or labels_part[eq + 1] != '"':
            raise OpenMetricsParseError(f"unquoted label value: {line!r}")
        j = eq + 2
        buf = []
        while j < n:
            ch = labels_part[j]
            if ch == "\\" and j + 1 < n:
                esc = labels_part[j + 1]
                buf.append(
                    {"n": "\n", "\\": "\\", '"': '"'}.get(esc, esc)
                )
                j += 2
                continue
            if ch == '"':
                break
            buf.append(ch)
            j += 1
        else:
            raise OpenMetricsParseError(f"unterminated label value: {line!r}")
        yield key, "".join(buf)
        i = j + 1
        if i < n and labels_part[i] == ",":
            i += 1


def parse_openmetrics(text: str) -> Dict[str, Dict[str, Any]]:
    """Validating parser for the exposition subset this module emits.

    Returns ``{family: {"type": ..., "samples": [(sample_name, labels,
    value), ...]}}``. Raises `OpenMetricsParseError` on: missing
    ``# EOF`` terminator (or content after it), samples before their
    ``# TYPE`` declaration, counter samples without the ``_total``
    suffix, histogram sample names outside the
    ``_bucket``/``_count``/``_sum`` triple, non-cumulative histogram
    buckets, a ``+Inf`` bucket disagreeing with ``_count``, negative
    counter/histogram values, or duplicate series."""
    families: Dict[str, Dict[str, Any]] = {}
    current: Optional[str] = None
    saw_eof = False
    seen_series = set()
    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        if saw_eof:
            raise OpenMetricsParseError("content after # EOF")
        if line == "# EOF":
            saw_eof = True
            continue
        if line.startswith("# TYPE "):
            parts = line.split()
            if len(parts) != 4:
                raise OpenMetricsParseError(f"malformed TYPE line: {line!r}")
            _, _, family, mtype = parts
            if mtype not in ("counter", "gauge", "histogram"):
                raise OpenMetricsParseError(
                    f"unsupported metric type {mtype!r}"
                )
            if family in families:
                raise OpenMetricsParseError(
                    f"duplicate TYPE declaration for {family!r}"
                )
            families[family] = {"type": mtype, "samples": []}
            current = family
            continue
        if line.startswith("#"):
            continue  # HELP/UNIT lines are legal, uninterpreted
        name, labels, value = _parse_sample_line(line)
        if current is None or not name.startswith(current):
            raise OpenMetricsParseError(
                f"sample {name!r} outside its family block"
            )
        mtype = families[current]["type"]
        suffix = name[len(current):]
        if mtype == "counter":
            if suffix != "_total":
                raise OpenMetricsParseError(
                    f"counter sample {name!r} must end in _total"
                )
            if value < 0:
                raise OpenMetricsParseError(
                    f"negative counter value on {name!r}"
                )
        elif mtype == "gauge":
            if suffix != "":
                raise OpenMetricsParseError(
                    f"gauge sample {name!r} must match its family name"
                )
        else:  # histogram
            if suffix not in ("_bucket", "_count", "_sum"):
                raise OpenMetricsParseError(
                    f"histogram sample {name!r} has invalid suffix"
                )
            if suffix == "_bucket" and "le" not in labels:
                raise OpenMetricsParseError(
                    f"histogram bucket without le label: {name!r}"
                )
            if suffix in ("_bucket", "_count") and value < 0:
                raise OpenMetricsParseError(
                    f"negative histogram value on {name!r}"
                )
        series_key = (name, tuple(sorted(labels.items())))
        if series_key in seen_series:
            raise OpenMetricsParseError(f"duplicate series {series_key!r}")
        seen_series.add(series_key)
        families[current]["samples"].append((name, labels, value))
    if not saw_eof:
        raise OpenMetricsParseError("missing # EOF terminator")
    _validate_histograms(families)
    return families


def _validate_histograms(families: Dict[str, Dict[str, Any]]):
    for family, fam in families.items():
        if fam["type"] != "histogram":
            continue
        # group by base label set
        groups: Dict[tuple, Dict[str, Any]] = {}
        for name, labels, value in fam["samples"]:
            base = tuple(
                sorted((k, v) for k, v in labels.items() if k != "le")
            )
            g = groups.setdefault(base, {"buckets": [], "count": None, "sum": None})
            suffix = name[len(family):]
            if suffix == "_bucket":
                le = labels["le"]
                bound = math.inf if le == "+Inf" else float(le)
                g["buckets"].append((bound, value))
            elif suffix == "_count":
                g["count"] = value
            else:
                g["sum"] = value
        for base, g in groups.items():
            if g["count"] is None or g["sum"] is None:
                raise OpenMetricsParseError(
                    f"histogram {family}{dict(base)} missing _count/_sum"
                )
            buckets = sorted(g["buckets"])
            if not buckets or not math.isinf(buckets[-1][0]):
                raise OpenMetricsParseError(
                    f"histogram {family}{dict(base)} missing +Inf bucket"
                )
            prev = -math.inf
            last = 0.0
            for bound, value in buckets:
                if bound <= prev:
                    raise OpenMetricsParseError(
                        f"histogram {family}{dict(base)} duplicate le"
                    )
                if value < last:
                    raise OpenMetricsParseError(
                        f"histogram {family}{dict(base)} buckets are not "
                        f"cumulative"
                    )
                prev, last = bound, value
            if buckets[-1][1] != g["count"]:
                raise OpenMetricsParseError(
                    f"histogram {family}{dict(base)} +Inf bucket "
                    f"!= _count"
                )


def samples_as_snapshot(
    families: Dict[str, Dict[str, Any]]
) -> Dict[str, Dict[str, Dict[str, float]]]:
    """Fold parsed counter/gauge families back into the registry's
    ``{"counters": {name: {label_str: value}}, "gauges": ...}`` shape
    (histogram summaries are not invertible from cumulative buckets —
    the agree-exactly test checks their count/sum samples directly)."""
    out: Dict[str, Dict[str, Dict[str, float]]] = {
        "counters": {}, "gauges": {},
    }
    for family, fam in families.items():
        if fam["type"] == "counter":
            for _name, labels, value in fam["samples"]:
                key = ",".join(
                    f"{k}={v}" for k, v in sorted(labels.items())
                )
                out["counters"].setdefault(family, {})[key] = value
        elif fam["type"] == "gauge":
            for _name, labels, value in fam["samples"]:
                key = ",".join(
                    f"{k}={v}" for k, v in sorted(labels.items())
                )
                out["gauges"].setdefault(family, {})[key] = value
    return out


# ----------------------------------------------------------------- exporter


class MetricsExporter:
    """Opt-in stdlib-HTTP exposition thread.

    ``snapshot_fn`` returns a `MetricsRegistry.snapshot()` dict (served
    on ``/metrics``); ``health_fn`` (optional) returns a
    `HealthEngine.summary()` dict (``/healthz``; ``503`` while its
    ``status`` is ``critical``); ``status_fn`` (optional) returns the
    ``introspect()`` snapshot (``/statusz``). Each callback is expected
    to do its own locking — the exporter adds no shared mutable state.

    Lifecycle: `start()` binds the socket and
    launches one ``serve_forever`` thread; `close()` shuts the server
    down, joins the thread, and closes the socket. Request handling is
    single-threaded (one scrape at a time), which bounds the exposure
    surface of a misbehaving scraper to one queued request.
    """

    def __init__(
        self,
        snapshot_fn: Callable[[], Dict],
        health_fn: Optional[Callable[[], Optional[Dict]]] = None,
        status_fn: Optional[Callable[[], Dict]] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        logger=None,
    ):
        self.snapshot_fn = snapshot_fn
        self.health_fn = health_fn
        self.status_fn = status_fn
        self.host = host
        self._requested_port = int(port)
        self.logger = logger
        self._server = None
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- server

    def start(self) -> "MetricsExporter":
        if self._server is not None:
            return self
        import http.server

        exporter = self

        class _Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # socket timeout per connection: the server is
            # single-threaded, so an idle keep-alive client (Prometheus
            # scrapers keep connections open between scrapes) would
            # otherwise hold serve_forever inside rfile.readline()
            # forever — blocking every other scraper AND the
            # server.shutdown() call in close()
            timeout = 5.0

            def log_message(self, fmt, *args):  # silence stderr chatter
                if exporter.logger is not None:
                    exporter.logger.debug(
                        "exporter: " + fmt % args
                    )

            def _send(self, code: int, body: bytes, content_type: str):
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler API
                try:
                    path = self.path.split("?", 1)[0]
                    if path == "/metrics":
                        body = render_openmetrics(
                            exporter.snapshot_fn()
                        ).encode("utf-8")
                        self._send(200, body, CONTENT_TYPE)
                    elif path == "/healthz":
                        summary = (
                            exporter.health_fn()
                            if exporter.health_fn is not None
                            else None
                        )
                        if summary is None:
                            summary = {"status": "ok", "firing": []}
                        code = (
                            503 if summary.get("status") == "critical"
                            else 200
                        )
                        body = json.dumps(
                            summary, default=json_default
                        ).encode("utf-8")
                        self._send(code, body, "application/json")
                    elif path == "/statusz":
                        snap = (
                            exporter.status_fn()
                            if exporter.status_fn is not None
                            else {}
                        )
                        body = json.dumps(
                            snap, default=json_default
                        ).encode("utf-8")
                        self._send(200, body, "application/json")
                    else:
                        self._send(
                            404,
                            b'{"error": "not found; try /metrics, '
                            b'/healthz, /statusz"}',
                            "application/json",
                        )
                except Exception as e:  # a broken snapshot must not
                    # kill the exporter thread: the scrape gets a 500
                    try:
                        self._send(
                            500,
                            json.dumps({"error": str(e)}).encode("utf-8"),
                            "application/json",
                        )
                    except OSError:
                        pass  # client already gone

        self._server = http.server.HTTPServer(
            (self.host, self._requested_port), _Handler
        )
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            kwargs={"poll_interval": 0.1},
            name="dmosopt-metrics-exporter",
            daemon=True,
        )
        self._thread.start()
        return self

    @property
    def port(self) -> Optional[int]:
        return (
            self._server.server_address[1]
            if self._server is not None
            else None
        )

    @property
    def url(self) -> Optional[str]:
        return (
            f"http://{self.host}:{self.port}"
            if self._server is not None
            else None
        )

    def close(self):
        server, self._server = self._server, None
        thread, self._thread = self._thread, None
        if server is not None:
            server.shutdown()
            server.server_close()
        if thread is not None:
            thread.join(timeout=10.0)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()
        return False
