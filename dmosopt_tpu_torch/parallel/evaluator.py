"""Objective-evaluation backends.

Port of ``dmosopt_tpu/parallel/evaluator.py``:

- `HostFunEvaluator` (:384): the objective is host Python taking a
  parameter dict, run inline or fanned out over a thread pool of
  ``n_workers``;
- `TorchBatchEvaluator`, the counterpart of `JaxBatchEvaluator` (:550)
  (``jax_objective=True`` there, ``torch_objective=True`` here): the
  objective is a batched torch function, one call per problem per batch
  on the run's device, its rows split over a mesh when given one.

Both return the reference worker protocol, ``{problem_id: result,
"time": seconds}`` per request, from a blocking ``evaluate_batch`` and
from the asynchronous ``submit_batch``, whose `AsyncEvalHandle` streams
results back as they complete: per-request futures with a timeout and
retry budget for host objectives, chunks tracked by CUDA events for
torch objectives. A request that exhausts its retries is delivered as
an `EvalFailure`; the rest of the batch is unaffected.

With a `Telemetry` attached by the driver (``evaluator.telemetry``)
both count their batches (``eval_batches_total`` labelled with the
backend, ``eval_batch_duration_seconds``) as the JAX package's do; the
host backend counts timeouts, retries and terminal failures, the torch
backend times the launch of its calls (``eval_dispatch_seconds``) and
the copy of their outputs to the host (``eval_execute_seconds``). The
torch backend's ``backend`` label is ``"torch"`` where the JAX
package's device-batch evaluator says ``"jax"``, and it has no
``eval_batch_compiles_total``: eager torch compiles no program per
batch shape.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dmosopt_tpu_torch.utils import jittered_backoff


class EvalFailure:
    """Terminal failure of one evaluation request (the batch survives):
    each attempt raised (`error` holds the last exception) or exceeded
    the per-attempt timeout (`timed_out`)."""

    __slots__ = ("error", "n_attempts", "timed_out")

    def __init__(self, error, n_attempts: int, timed_out: bool = False):
        self.error = error
        self.n_attempts = n_attempts
        self.timed_out = timed_out

    def __repr__(self):
        cause = "timeout" if self.timed_out else repr(self.error)
        return f"EvalFailure({cause}, attempts={self.n_attempts})"


class AsyncEvalHandle:
    """Streaming handle for one submitted evaluation batch.

    ``poll(timeout)`` returns the next completed ``(index, result)`` in
    completion order (``index`` is the request's position in the batch;
    ``result`` a worker-protocol dict or an `EvalFailure`), or None when
    nothing completed within ``timeout`` seconds. The driver buffers and
    folds in submission order."""

    def __init__(self, total: int):
        self.total = int(total)
        self.delivered = 0
        self.t_submit = time.perf_counter()
        # when the latest result reached the handle: a worker's return,
        # or the poll that found a device chunk finished. The JAX
        # package stamps the last delivery instead, which counts a
        # straggler batch's wait for its reconcile as evaluation time.
        self.t_landed: Optional[float] = None

    def poll(self, timeout: Optional[float] = None):
        raise NotImplementedError

    @property
    def done(self) -> bool:
        return self.delivered >= self.total

    def cancel_pending(self) -> int:
        """Cancel work that has not started; returns the number of
        requests cancelled (counted as delivered, never polled)."""
        return 0

    def drain_completed(self):
        """Teardown: every result that has already landed, as [(index,
        result)], with no timeout expiry and no retry started."""
        return []


# --------------------------------------------------------- host evaluator


class _HostRequest:
    __slots__ = ("index", "payload", "attempt", "attempts_used", "started_at")

    def __init__(self, index, payload):
        self.index = index
        self.payload = payload
        self.attempt = 0  # live attempt id; stale completions are dropped
        self.attempts_used = 0
        self.started_at = None  # set by the worker when execution begins


class _HostEvalHandle(AsyncEvalHandle):
    """Per-request futures over the evaluator's thread pool, with a
    per-attempt timeout and retry budget. The timeout clock starts when
    an attempt begins executing. A timed-out attempt cannot be killed
    (Python threads), so it is abandoned: its late completion is ignored
    and a fresh attempt is submitted."""

    def __init__(self, evaluator, payloads, timeout, retries,
                 backoff=0.0, backoff_cap=30.0):
        super().__init__(len(payloads))
        self._ev = evaluator
        self._timeout = timeout
        self._retries = int(retries)
        self._backoff = float(backoff)
        self._backoff_cap = float(backoff_cap)
        self._lock = threading.Lock()
        self._done_q: "queue.Queue" = queue.Queue()
        self._reqs = [_HostRequest(i, p) for i, p in enumerate(payloads)]
        self._futures: Dict[int, Any] = {}
        self._finished = set()
        # {(index, attempt): ran_on_pool} for attempts presumed hung
        self._abandoned_attempts: Dict[Tuple[int, int], bool] = {}
        with self._lock:
            for req in self._reqs:
                self._submit_attempt(req)

    def _submit_attempt(self, req: _HostRequest, dedicated: bool = False):
        """Submit one attempt; the caller holds ``self._lock``.
        ``dedicated`` runs it on its own daemon thread: once hung
        attempts hold every pool worker, work queued on the pool would
        never start and its timeout clock never tick."""
        req.started_at = None
        attempt, index = req.attempt, req.index
        dedicated = dedicated or self._ev._pool_exhausted()
        delay = 0.0
        if req.attempts_used > 0 and self._backoff > 0.0:
            delay = jittered_backoff(
                req.attempts_used - 1, self._backoff, self._backoff_cap
            )

        def run(payload=req.payload, index=index, attempt=attempt, delay=delay):
            if delay > 0.0:
                time.sleep(delay)
            with self._lock:
                r = self._reqs[index]
                if r.attempt == attempt:
                    r.started_at = time.perf_counter()
            try:
                out = self._ev.eval_fun(payload)
                self._done_q.put((index, attempt, out, None))
            except BaseException as e:
                self._done_q.put((index, attempt, None, e))
            finally:
                self.t_landed = time.perf_counter()
                # a timed-out attempt that returns proves its worker was
                # slow, not dead: restore the abandoned count here, since
                # the handle may never be polled again
                with self._lock:
                    if self._reqs[index].attempt != attempt:
                        self._note_recovered(index, attempt)

        if dedicated:
            self._futures[index] = None  # a live thread is not cancellable
            threading.Thread(target=run, daemon=True, name="dmosopt-eval-retry").start()
        else:
            self._futures[index] = self._ev._ensure_pool().submit(run)

    def _tel_inc(self, name):
        tel = self._ev.telemetry
        if tel:
            tel.inc(name)

    def _note_delivered(self):
        """One request delivered; once the last one is, the batch's
        submit-to-done wall goes to ``eval_batch_duration_seconds``."""
        self.delivered += 1
        if self.done:
            tel = self._ev.telemetry
            if tel:
                tel.observe(
                    "eval_batch_duration_seconds",
                    time.perf_counter() - self.t_submit, backend="host",
                )

    def _retry_or_fail(self, req, error, timed_out):
        """Timeout or error on the live attempt: resubmit while budget
        remains (returns None), else return an EvalFailure. The caller
        holds ``self._lock``."""
        req.attempts_used += 1
        req.attempt += 1
        if timed_out:
            self._tel_inc("eval_timeouts_total")
            # only a pool attempt costs a worker slot; the evaluator
            # counts it so close() does not join the pool forever
            on_pool = self._futures.get(req.index) is not None
            self._abandoned_attempts[(req.index, req.attempt - 1)] = on_pool
            if on_pool:
                self._ev._note_abandoned()
            if self._ev._pool_exhausted():
                self._migrate_queued_to_dedicated()
        if req.attempts_used <= self._retries:
            self._tel_inc("eval_retries_total")
            self._submit_attempt(req)
            return None
        self._tel_inc("eval_failures_total")
        self._finished.add(req.index)
        self._note_delivered()
        return EvalFailure(error, req.attempts_used, timed_out=timed_out)

    def _note_recovered(self, index, attempt):
        """A presumed-hung attempt completed after all; the caller holds
        ``self._lock``."""
        on_pool = self._abandoned_attempts.pop((index, attempt), None)
        if on_pool:
            self._ev._note_worker_recovered()

    def _migrate_queued_to_dedicated(self):
        """Move every queued, unstarted attempt off the exhausted pool
        onto dedicated threads; the caller holds ``self._lock``."""
        for r in self._reqs:
            if r.index in self._finished:
                continue
            fut = self._futures.get(r.index)
            if fut is not None and fut.cancel():
                self._submit_attempt(r, dedicated=True)

    def _expire_overdue(self):
        if self._timeout is None:
            return None
        now = time.perf_counter()
        with self._lock:
            for req in self._reqs:
                if req.index in self._finished:
                    continue
                if req.started_at is not None and now - req.started_at > self._timeout:
                    out = self._retry_or_fail(req, None, timed_out=True)
                    if out is not None:
                        return req.index, out
        return None

    def poll(self, timeout: Optional[float] = None):
        deadline = None if timeout is None else time.perf_counter() + timeout
        while not self.done:
            # completions first: a result that landed within its budget
            # while the driver was away must win over a stale expiry
            try:
                index, attempt, out, err = self._done_q.get_nowait()
            except queue.Empty:
                expired = self._expire_overdue()
                if expired is not None:
                    return expired
                wait = 0.02 if self._timeout is not None else 5.0
                if deadline is not None:
                    wait = min(wait, max(deadline - time.perf_counter(), 0.0))
                try:
                    index, attempt, out, err = self._done_q.get(timeout=wait)
                except queue.Empty:
                    if deadline is not None and time.perf_counter() >= deadline:
                        return None
                    continue
            with self._lock:
                req = self._reqs[index]
                if index in self._finished or attempt != req.attempt:
                    self._note_recovered(index, attempt)  # stale attempt
                    continue
                if err is None:
                    self._finished.add(index)
                    self._note_delivered()
                    return index, out
                failure = self._retry_or_fail(req, err, timed_out=False)
            if failure is not None:
                return index, failure
        return None

    def cancel_pending(self) -> int:
        n = 0
        with self._lock:
            for req in self._reqs:
                if req.index in self._finished:
                    continue
                fut = self._futures.get(req.index)
                if fut is not None and fut.cancel():
                    req.attempt += 1  # a racing start becomes stale
                    self._finished.add(req.index)
                    self._note_delivered()
                    n += 1
        return n

    def drain_completed(self):
        out = []
        while True:
            try:
                index, attempt, res, err = self._done_q.get_nowait()
            except queue.Empty:
                break
            with self._lock:
                req = self._reqs[index]
                if index in self._finished or attempt != req.attempt:
                    self._note_recovered(index, attempt)
                    continue
                self._finished.add(index)
                self._note_delivered()
            if err is None:
                out.append((index, res))
            # an errored attempt is dropped: no retry starts at teardown
        return out


class HostFunEvaluator:
    """Evaluate host-Python objectives, one call per request.

    ``eval_fun(space_vals_dict) -> {problem_id: result, "time": t}`` is
    the per-problem objective wrapper the driver builds. With
    ``n_workers > 1`` requests run on a thread pool; ``n_workers == 1``
    runs `evaluate_batch` inline and streams `submit_batch` through one
    worker thread."""

    def __init__(self, eval_fun: Callable, n_workers: int = 1):
        self.eval_fun = eval_fun
        self.n_workers = int(n_workers)
        self.telemetry = None  # attached by the driver when enabled
        # abandoned-worker accounting, changed from the driver thread and
        # from worker threads under different handles' locks
        self._n_abandoned = 0
        self._acct_lock = threading.Lock()
        self._pool = (
            ThreadPoolExecutor(max_workers=self.n_workers)
            if self.n_workers > 1
            else None
        )

    def _note_abandoned(self):
        with self._acct_lock:
            self._n_abandoned += 1

    def _note_worker_recovered(self):
        with self._acct_lock:
            self._n_abandoned = max(self._n_abandoned - 1, 0)

    def _pool_exhausted(self) -> bool:
        """True when hung attempts hold every pool worker."""
        with self._acct_lock:
            return self._n_abandoned >= max(self.n_workers, 1)

    def _ensure_pool(self) -> ThreadPoolExecutor:
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=max(self.n_workers, 1))
        return self._pool

    def evaluate_batch(
        self, space_vals_list: Sequence[Dict[Any, np.ndarray]]
    ) -> List[Dict]:
        t0 = time.perf_counter()
        if self._pool is not None:
            out = list(self._pool.map(self.eval_fun, space_vals_list))
        else:
            out = [self.eval_fun(sv) for sv in space_vals_list]
        tel = self.telemetry
        if tel:
            tel.inc("eval_batches_total", backend="host")
            tel.observe(
                "eval_batch_duration_seconds", time.perf_counter() - t0, backend="host"
            )
        return out

    def submit_batch(
        self, space_vals_list: Sequence[Dict[Any, np.ndarray]],
        timeout: Optional[float] = None, retries: int = 0,
        backoff: float = 0.0, backoff_cap: float = 30.0, **_unused,
    ) -> AsyncEvalHandle:
        """One pool future per request, results streaming back through
        the handle. ``timeout`` bounds each attempt's execution seconds;
        a request is retried up to ``retries`` times after a timeout or
        an exception, then delivered as an `EvalFailure`; retry k first
        waits ``min(backoff * 2**(k-1), backoff_cap)`` (jittered)."""
        if self.telemetry:
            self.telemetry.inc("eval_batches_total", backend="host")
        return _HostEvalHandle(
            self, list(space_vals_list), timeout, retries,
            backoff=backoff, backoff_cap=backoff_cap,
        )

    def close(self, drain_timeout: float = 30.0):
        """Wait for running calls (they may hold files or subprocesses
        that must not outlive the driver) and cancel queued ones. The
        drain runs on a helper thread joined for at most
        ``drain_timeout`` seconds, so a call that never returns cannot
        hang teardown."""
        if self._pool is None:
            return
        pool, self._pool = self._pool, None
        t = threading.Thread(
            target=lambda: pool.shutdown(wait=True, cancel_futures=True),
            daemon=True, name="dmosopt-eval-drain",
        )
        t.start()
        t.join(drain_timeout)


# -------------------------------------------------------- torch evaluator


class _TorchEvalHandle(AsyncEvalHandle):
    """Chunks launched at submit time, drained in launch order: each
    chunk's objectives were copied without blocking into host memory,
    followed by a CUDA event; a chunk is ready when its event has
    completed. CPU chunks are ready when submitted."""

    def __init__(self, total: int, chunks: List[Tuple[List[int], Any, Any, float]],
                 telemetry=None):
        super().__init__(total)
        # [(batch indices, rounds, {problem_id: (round positions, host
        #   outputs)}, CUDA event or None, t_submit)]
        self._chunks = list(chunks)
        self._buffer: List[Tuple[int, Dict]] = []
        self._tel = telemetry

    @staticmethod
    def _ready(event) -> bool:
        return event is None or event.query()

    def _open_chunk(self):
        indices, part, host_by_problem, _event, t_submit = self._chunks.pop(0)
        t0 = self.t_landed = time.perf_counter()
        dt = (time.time() - t_submit) / max(self.total, 1)
        results = _rounds_to_results(part, {
            pid: (idx, tuple(h.numpy() for h in outs))
            for pid, (idx, outs) in host_by_problem.items()
        })
        for r in results:
            r["time"] = dt
        self._buffer = list(zip(indices, results))
        if self._tel:
            # the chunk's host assembly; with the last chunk also the
            # batch's submit-to-land wall
            self._tel.observe("eval_execute_seconds", time.perf_counter() - t0)
            if not self._chunks:
                self._tel.observe(
                    "eval_batch_duration_seconds", time.time() - t_submit,
                    backend=TorchBatchEvaluator.BACKEND,
                )

    def poll(self, timeout: Optional[float] = None):
        """Next result of the first unfinished chunk. A chunk whose event
        has completed opens without any wait; otherwise, with a timeout,
        the event is queried until the deadline (no synchronize), and
        with None (wait forever) the event is synchronized."""
        if not self._buffer:
            if not self._chunks:
                return None
            event = self._chunks[0][3]
            if timeout is None:
                if event is not None:
                    event.synchronize()
            else:
                # return None while the chunk is still running at the
                # deadline, so the caller can check its own stop conditions
                deadline = time.monotonic() + timeout
                while not self._ready(event):
                    if time.monotonic() >= deadline:
                        return None
                    time.sleep(0.0005)
            self._open_chunk()
        idx, res = self._buffer.pop(0)
        self.delivered += 1
        return idx, res

    def cancel_pending(self) -> int:
        n = sum(len(c[0]) for c in self._chunks) + len(self._buffer)
        self._chunks, self._buffer = [], []
        self.delivered += n
        return n

    def drain_completed(self):
        out = []
        while self._buffer or (self._chunks and self._ready(self._chunks[0][3])):
            out.append(self.poll())
        return out


def _rounds_to_results(rounds, outs_by_problem):
    """Worker-protocol result dicts for ``rounds`` from the per-problem
    host output tuples ``{problem_id: (round positions, outputs)}``: each
    problem's row, or the tuple of each output's row (the ``(y, c)``,
    ``(y, f)`` and ``(y, f, c)`` protocols)
    (``dmosopt_tpu/parallel/evaluator.py:651``)."""
    results: List[Dict] = [dict() for _ in rounds]
    for problem_id, (idx, outs) in outs_by_problem.items():
        for j, i in enumerate(idx):
            row = tuple(o[j] for o in outs)
            results[i][problem_id] = row[0] if len(row) == 1 else row
    return results


class TorchBatchEvaluator:
    """Evaluate a batched torch objective, one call per problem per batch
    or chunk.

    ``batch_fun`` maps a (B, n) float32 tensor of flat parameter vectors
    on ``device`` to objectives (B, d) on any device, or to a tuple of
    per-row outputs, objectives first (``(y, f)``, ``(y, c)`` or ``(y,
    f, c)`` when the problem has features or constraints), as the JAX
    package's batch evaluator takes them
    (``dmosopt_tpu/parallel/evaluator.py:554-575``): each output is
    copied to the host and split per row. With several ``problem_ids``
    each round holds one request per problem, and every problem present
    in a batch gets one objective call of its stacked rows
    (`_stack_problems`, ``:663``). With a ``mesh`` (`parallel.mesh`)
    the rows of each call are split over ``batch_axis`` (default: the
    mesh's first axis), each rank evaluating its block, and gathered in
    order (``dmosopt_tpu/parallel/evaluator.py:556-590``); every rank of
    the run evaluates the same batches."""

    #: the ``backend`` label of its batch counters
    BACKEND = "torch"

    def __init__(self, batch_fun: Callable, device, problem_ids=None, mesh=None,
                 batch_axis: Optional[str] = None):
        self.batch_fun = batch_fun
        self.device = torch.device(device)
        self.problem_ids = list(problem_ids) if problem_ids is not None else [0]
        self.telemetry = None  # attached by the driver when enabled
        self.mesh = mesh
        # the mesh's leading axis by default, whatever its name
        # (``dmosopt_tpu/parallel/evaluator.py:579-583``)
        self.batch_axis = (batch_axis or mesh.mesh_dim_names[0]) if mesh is not None else None

    def _call(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        out = self.batch_fun(x)
        if not isinstance(out, tuple):
            out = (out,)
        return tuple(torch.as_tensor(o).detach() for o in out)

    def _launch(self, X: np.ndarray) -> Tuple[torch.Tensor, ...]:
        x = torch.as_tensor(X, dtype=torch.float32, device=self.device)
        if self.mesh is None:
            return self._call(x)
        # each rank evaluates its block of rows; the outputs come back
        # gathered in row order (every rank of the run calls here)
        from dmosopt_tpu_torch.parallel.mesh import gather_rows

        return gather_rows(self._call, x, self.mesh, self.batch_axis)

    def _stack_problems(self, rounds):
        """{problem_id: (round positions, stacked X)} over ``rounds``; a
        round may hold a subset of the problems (unequal queues)."""
        stacked = {}
        for problem_id in self.problem_ids:
            idx = [i for i, sv in enumerate(rounds) if problem_id in sv]
            if idx:
                stacked[problem_id] = (idx, np.stack([rounds[i][problem_id] for i in idx]))
        return stacked

    def evaluate_batch(
        self, space_vals_list: Sequence[Dict[Any, np.ndarray]]
    ) -> List[Dict]:
        if not space_vals_list:
            return []
        t0 = time.time()
        tel = self.telemetry
        outs_by_problem = {}
        for pid, (idx, X) in self._stack_problems(space_vals_list).items():
            t_launch = time.perf_counter()
            outs = self._launch(X)
            t_copy = time.perf_counter()
            outs_by_problem[pid] = (idx, tuple(o.cpu().numpy() for o in outs))
            if tel:
                # the copy to the host waits for the call: launch, then run
                tel.observe("eval_dispatch_seconds", t_copy - t_launch)
                tel.observe("eval_execute_seconds", time.perf_counter() - t_copy)
        results = _rounds_to_results(space_vals_list, outs_by_problem)
        dt = (time.time() - t0) / len(space_vals_list)
        for r in results:
            r["time"] = dt
        if tel:
            tel.inc("eval_batches_total", backend=self.BACKEND)
            tel.observe(
                "eval_batch_duration_seconds", time.time() - t0, backend=self.BACKEND
            )
        return results

    def submit_batch(
        self, space_vals_list: Sequence[Dict[Any, np.ndarray]],
        n_chunks: int = 1, **_unused,
    ) -> AsyncEvalHandle:
        """Split the batch into up to ``n_chunks`` chunks of
        ``ceil(B / n_chunks)`` rounds (the last may be shorter) and launch
        them all now on the current stream, each problem's call followed
        by a non-blocking copy of its outputs into pinned host memory,
        and each chunk by a CUDA event; nothing here waits for the
        device. Per-request timeouts and retries do not apply (a device
        call completes or the run is lost)."""
        rounds = list(space_vals_list)
        B = len(rounds)
        tel = self.telemetry
        if tel:
            tel.inc("eval_batches_total", backend=self.BACKEND)
        n_chunks = max(1, min(int(n_chunks), B)) if B else 1
        chunk_len = max(-(-B // n_chunks), 1)
        t_submit = time.time()
        t_disp0 = time.perf_counter()
        chunks = []
        for start in range(0, B, chunk_len):
            part = rounds[start:start + chunk_len]
            host_by_problem, on_card = {}, False
            for pid, (idx, X) in self._stack_problems(part).items():
                outs = self._launch(X)
                if any(o.is_cuda for o in outs):
                    on_card = True
                    host = []
                    for o in outs:
                        h = torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
                        h.copy_(o, non_blocking=True)
                        host.append(h)
                    host = tuple(host)
                else:
                    host = tuple(o.clone() for o in outs)
                host_by_problem[pid] = (idx, host)
            event = None
            if on_card:
                event = torch.cuda.Event()
                event.record()
            chunks.append(
                (list(range(start, start + len(part))), part, host_by_problem,
                 event, t_submit)
            )
        if tel and B:
            tel.observe("eval_dispatch_seconds", time.perf_counter() - t_disp0)
        return _TorchEvalHandle(B, chunks, telemetry=tel)

    def close(self):
        pass
