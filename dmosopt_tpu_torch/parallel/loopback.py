"""Loopback multi-process cluster launcher.

Port of ``dmosopt_tpu/parallel/loopback.py:20-122``: starts N python
processes that together form one ``torch.distributed`` cluster on this
machine (`parallel.mesh.initialize_distributed` over a TCP store on
localhost), the counterpart of the reference's ``mpirun -n K`` runs
(dmosopt.py:2518-2536). Each process owns one device: a CPU rank on
gloo, or, on a machine with one card, a CUDA rank that shares it over
gloo. The tests and `chip_smoke.py` run `dmosopt_tpu_torch.testing.
multihost` through it.
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import time
from typing import List, Tuple


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _kill_group(p: subprocess.Popen) -> None:
    try:
        os.killpg(p.pid, signal.SIGKILL)
    except OSError:
        try:
            p.kill()
        except OSError:
            pass


def launch_loopback_cluster(
    worker_script: str,
    n_processes: int = 2,
    timeout: float = 600.0,
    extra_args: Tuple[str, ...] = (),
) -> List[Tuple[int, str]]:
    """Run ``python worker_script <coordinator> <n> <rank> [extra...]``
    in ``n_processes`` processes, the coordinator a free localhost port;
    returns ``[(returncode, output)]`` in rank order. One deadline covers
    the whole cluster: past it every rank still running is killed with
    its process group (a hung collective must not orphan the peers
    holding the port) and its output marked ``[TIMEOUT ...]``."""
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    coordinator = f"127.0.0.1:{free_port()}"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [repo] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    )
    # each rank in a session of its own, so a timeout kills its children too
    procs = [
        subprocess.Popen(
            [sys.executable, worker_script, coordinator, str(n_processes), str(rank),
             *extra_args],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, start_new_session=True,
        )
        for rank in range(n_processes)
    ]
    results: dict = {}
    deadline = time.time() + timeout
    try:
        for i, p in enumerate(procs):
            out, _ = p.communicate(timeout=max(0.1, deadline - time.time()))
            results[i] = (p.returncode, out)
    except subprocess.TimeoutExpired:
        # kill only the ranks still running: a finished rank's pid may
        # already be reused
        for i, p in enumerate(procs):
            if i not in results:
                _kill_group(p)
        for i, p in enumerate(procs):
            if i in results:
                continue
            try:
                out, _ = p.communicate(timeout=5)
            except subprocess.TimeoutExpired:
                out = ""
                if p.stdout is not None:
                    p.stdout.close()
                try:
                    p.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    pass
            results[i] = (p.returncode, f"[TIMEOUT after {timeout}s]\n{out}")
    return [results[i] for i in range(n_processes)]
