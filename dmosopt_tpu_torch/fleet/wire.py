"""File wire protocol of the fleet control plane.

Port of ``dmosopt_tpu/fleet/wire.py``, unchanged: the file names, exit
codes and JSON layouts are the JAX package's, so either package's
``status --fleet-dir`` reads a fleet directory the other wrote.

The supervisor and its worker subprocesses share nothing but a
directory tree — no sockets for control, no pickled closures, no
shared memory — so every control-plane artifact is a small JSON file
written atomically (tmp + ``os.replace``) and read whole. That keeps
the protocol inspectable with ``cat``, survivable across kill -9 at
any byte (a reader sees the previous complete file, never a torn one
— the same discipline as the service checkpoint and status snapshot),
and portable to any shared filesystem.

Layout under one fleet directory::

    fleet.json                 supervisor state (placements, migrations)
    results/<opt_id>.h5        per-tenant front stores (follow migration)
    workers/<worker_id>/
        inbox/NNNNNNNN-<kind>.json   orders: submit / migrate
        status.json            worker heartbeat + embedded introspect()
        checkpoint.h5          the worker service's crash-safe snapshot
        stop                   flag: finish the current step, close, exit 0
        fence                  flag: lease revoked — exit NOW, write nothing
        log.txt                captured worker stdout/stderr

Orders are sequence-numbered by the supervisor (zero-padded, so
lexicographic listing is submission order) and *claimed* by the worker
by renaming to ``<name>.done`` after processing — a crashed worker
leaves unprocessed orders in place for inspection, and a processed
order can never run twice.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

from dmosopt_tpu_torch.utils import json_default

#: well-known file names inside one worker directory
STATUS_FILE = "status.json"
CHECKPOINT_FILE = "checkpoint.h5"
STOP_FILE = "stop"
FENCE_FILE = "fence"
INBOX_DIR = "inbox"
LOG_FILE = "log.txt"

#: supervisor state at the fleet root
FLEET_STATE_FILE = "fleet.json"

#: worker exit codes the supervisor distinguishes
EXIT_OK = 0
EXIT_FENCED = 3


def worker_dir(fleet_dir: str, worker_id: str) -> str:
    return os.path.join(fleet_dir, "workers", worker_id)


def results_dir(fleet_dir: str) -> str:
    return os.path.join(fleet_dir, "results")


def atomic_write_json(path: str, payload: Dict[str, Any]) -> None:
    """Write one JSON document atomically: a concurrent reader sees the
    previous complete document or the new one, never a torn file."""
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(payload, fh, default=json_default)
    os.replace(tmp, path)


def read_json(path: str) -> Optional[Dict[str, Any]]:
    """Read one JSON document, or None when the file does not exist
    yet (a worker that has not heartbeat, a fleet without state)."""
    try:
        with open(path) as fh:
            return json.load(fh)
    except FileNotFoundError:
        return None


def enqueue_order(inbox: str, seq: int, kind: str, order: Dict[str, Any]) -> str:
    """Atomically place one order file into a worker inbox. The
    sequence number makes listing order submission order; the kind
    rides in the name for humans tailing the directory."""
    os.makedirs(inbox, exist_ok=True)
    name = f"{int(seq):08d}-{kind}.json"
    path = os.path.join(inbox, name)
    atomic_write_json(path, dict(order, kind=kind, seq=int(seq)))
    return path


def claim_orders(inbox: str) -> List[Tuple[str, Dict[str, Any]]]:
    """The unprocessed orders in one inbox, oldest first, as
    ``(path, order)`` pairs. The caller marks each processed with
    `mark_done` so it can never be claimed again."""
    if not os.path.isdir(inbox):
        return []
    out: List[Tuple[str, Dict[str, Any]]] = []
    for name in sorted(os.listdir(inbox)):
        if not name.endswith(".json"):
            continue
        path = os.path.join(inbox, name)
        order = read_json(path)
        if order is not None:
            out.append((path, order))
    return out


def mark_done(path: str) -> None:
    os.replace(path, path + ".done")


def touch_flag(path: str) -> None:
    """Create a flag file (stop / fence) atomically-enough: the flag's
    existence IS the signal, its content is a human breadcrumb."""
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        fh.write("1\n")
    os.replace(tmp, path)
