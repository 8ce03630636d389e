"""Structured event log: typed per-epoch/per-phase records.

Port of ``dmosopt_tpu/telemetry/events.py``, a copy (pure Python).

Events are the narrative complement to the metrics registry: where a
counter says "eval batches: 12", the event log says *which epoch's eval
phase took how long with what per-eval statistics*. Each record is an
`Event` (kind, timestamp, optional epoch, free-form fields) held in a
bounded in-memory ring buffer and, when a ``jsonl_path`` is configured,
appended to a JSON-lines file — one self-describing JSON object per
line, so a run's telemetry can be tailed, grepped, or loaded with any
JSON tooling while the run is still going.

Known kinds (free-form kinds are allowed; these are what the framework
emits and what ``Telemetry.epoch_summary`` understands):

- ``phase``   — one timed region of an epoch; fields always include
  ``phase`` (xinit | train | optimize | eval) and ``duration_s``.
- ``epoch``   — one driver epoch completed; ``duration_s``, counters.
- ``resample``— resample selection of an epoch; batch size, dedupe.
- ``compile_cache`` — persistent-cache accounting at run end.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, Iterator, List, Optional

from dmosopt_tpu_torch.utils import json_default


def jsonable(value):
    """Coerce numpy scalars/arrays and other common non-JSON types to
    plain Python so every event (and the HDF5 summary built from them)
    serializes without a custom encoder."""
    import numpy as np

    if isinstance(value, (np.integer,)):
        return int(value)
    if isinstance(value, (np.floating,)):
        return float(value)
    if isinstance(value, (np.bool_,)):
        return bool(value)
    if isinstance(value, np.ndarray):
        return [jsonable(v) for v in value.tolist()]
    if isinstance(value, dict):
        return {str(k): jsonable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [jsonable(v) for v in value]
    return value


@dataclasses.dataclass(frozen=True)
class Event:
    kind: str
    ts: float
    epoch: Optional[int]
    fields: Dict[str, Any]

    def to_dict(self) -> Dict[str, Any]:
        out = {"kind": self.kind, "ts": self.ts}
        if self.epoch is not None:
            out["epoch"] = self.epoch
        out.update(self.fields)
        return out

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Event":
        d = dict(d)
        kind = d.pop("kind")
        ts = d.pop("ts")
        epoch = d.pop("epoch", None)
        return cls(kind=kind, ts=ts, epoch=epoch, fields=d)


class EventLog:
    """Bounded ring buffer of `Event`s with an optional JSONL sink.

    The sink can be size-bounded: with ``max_bytes`` set, a write that
    would grow the file past the bound first rotates it —
    ``events.jsonl`` becomes ``events.jsonl.1`` (existing ``.1`` shifts
    to ``.2`` and so on, at most ``keep`` rotated files are retained) —
    so a long-lived service's sink can never grow without bound.
    Rotations are counted in `rotations` and reported through the
    optional ``on_rotate`` callback (the `Telemetry` facade wires it to
    the ``telemetry_sink_rotations_total`` counter)."""

    def __init__(
        self,
        ring_size: int = 1024,
        jsonl_path: Optional[str] = None,
        max_bytes: Optional[int] = None,
        keep: int = 3,
    ):
        if ring_size <= 0:
            raise ValueError("ring_size must be positive")
        if max_bytes is not None and max_bytes <= 0:
            raise ValueError("max_bytes must be positive")
        if keep < 1:
            raise ValueError("keep must be >= 1")
        self._ring: deque = deque(maxlen=int(ring_size))
        self.jsonl_path = jsonl_path
        self.max_bytes = int(max_bytes) if max_bytes is not None else None
        self.keep = int(keep)
        self.rotations = 0
        self.on_rotate = None  # callable, invoked AFTER each rotation
        self._lock = threading.Lock()
        self._fh = None
        self._bytes = 0
        self._rotate_disabled = False  # set after an unrotatable chain
        if jsonl_path is not None:
            self._fh = open(jsonl_path, "a", buffering=1)  # line-buffered
            try:
                self._bytes = os.path.getsize(jsonl_path)
            except OSError:
                self._bytes = 0

    def _rotate_locked(self) -> bool:
        """Rotate the sink file chain (caller holds the lock). The live
        file becomes ``.1``; ``.{keep}`` falls off the end. Returns
        True only when the chain actually moved; any failure degrades
        the sink (rotation disabled, or dark on an unreopenable path)
        instead of taking the run down."""
        self._fh.close()
        moved = True
        try:
            for i in range(self.keep, 0, -1):
                src = (
                    self.jsonl_path
                    if i == 1
                    else f"{self.jsonl_path}.{i - 1}"
                )
                if os.path.exists(src):
                    os.replace(src, f"{self.jsonl_path}.{i}")
        except OSError:
            # an unrotatable chain (EACCES/EXDEV...): keep appending to
            # the live file and stop attempting — retrying the doomed
            # close/replace/reopen cycle on every emit would add IO per
            # event and inflate the rotation counter with non-rotations
            moved = False
            self._rotate_disabled = True
        if moved:
            # the chain moved on disk: count it NOW, before the reopen
            # can fail — the counter must agree with the on-disk state
            # it explains, even when the sink then goes dark
            self.rotations += 1
        try:
            self._fh = open(self.jsonl_path, "a", buffering=1)  # graftlint: disable=lock-discipline -- rotation fires at most once per max_bytes of sink output, and the reopen MUST serialize with concurrent emit() writers on this same lock (an outside-the-lock reopen would race them onto a closed handle)
        except OSError:
            # disk-full/EMFILE at the reopen: the sink goes dark (emit
            # keeps the ring buffer; no more JSONL) rather than leaving
            # a closed handle for the next emit to crash on
            self._fh = None
            self._bytes = 0
            return moved
        try:
            self._bytes = os.path.getsize(self.jsonl_path)
        except OSError:
            self._bytes = 0
        return moved

    def emit(self, kind: str, epoch: Optional[int] = None, **fields) -> Event:
        if not isinstance(kind, str) or not kind:
            raise ValueError(f"event kind must be a non-empty string: {kind!r}")
        ev = Event(
            kind=kind,
            ts=time.time(),
            epoch=int(epoch) if epoch is not None else None,
            fields={k: jsonable(v) for k, v in fields.items()},
        )
        rotated = False
        with self._lock:
            self._ring.append(ev)
            if self._fh is not None:
                # fields are jsonable()-coerced above, but torch tensors
                # (not np.ndarray) fall through it unchanged — the
                # duck-typed default catches those
                line = json.dumps(ev.to_dict(), default=json_default) + "\n"
                # the file is text-mode UTF-8: size-account the encoded
                # byte length, not code points, or non-ASCII content
                # would let the file overrun the documented bound
                nbytes = len(line.encode("utf-8"))
                if (
                    self.max_bytes is not None
                    and not self._rotate_disabled
                    and self._bytes > 0
                    and self._bytes + nbytes > self.max_bytes
                ):
                    rotated = self._rotate_locked()
            if self._fh is not None:  # rotation may have gone dark
                self._fh.write(line)
                self._bytes += nbytes
                if kind in ("phase", "health_alert"):
                    # a phase close is the natural durability boundary
                    # (and a health-alert transition must never be lost
                    # to a crash — the alert IS the incident record):
                    # flush so a killed run's sink keeps everything up
                    # to its last completed phase and every alert fired
                    # before it, independent of the file object's
                    # buffering mode
                    self._fh.flush()
        if rotated and self.on_rotate is not None:
            self.on_rotate()
        return ev

    def flush(self):
        with self._lock:
            if self._fh is not None:
                self._fh.flush()

    def records(
        self, kind: Optional[str] = None, epoch: Optional[int] = None
    ) -> List[Event]:
        with self._lock:
            evs = list(self._ring)
        if kind is not None:
            evs = [e for e in evs if e.kind == kind]
        if epoch is not None:
            evs = [e for e in evs if e.epoch == epoch]
        return evs

    def __len__(self) -> int:
        return len(self._ring)

    def close(self):
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


def read_jsonl(path: str) -> Iterator[Event]:
    """Load events back from a JSONL sink (round-trip of `EventLog.emit`)."""
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                yield Event.from_dict(json.loads(line))
