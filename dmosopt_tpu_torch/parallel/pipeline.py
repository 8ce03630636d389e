"""Epoch-pipeline plumbing: the pipeline configuration and the background
persistence writer.

Port of ``dmosopt_tpu/parallel/pipeline.py`` (`PipelineConfig`,
`BackgroundWriter`). The driver's ``pipeline`` knob
decides how much of an epoch overlaps:

- ``serial``: the fully synchronous loop;
- ``overlap_io`` (the default): HDF5 appends run on a background writer
  thread, and evaluation results stream back as they complete but fold
  in submission order, so archives stay byte-identical to serial;
- ``speculative``: additionally start the next surrogate fit once a
  quorum fraction of the resample batch has landed; the stragglers
  reconcile into the following training set.

The writer is one thread that runs the submitted closures strictly in
submission order, so the file goes through the same sequence of states
the serial loop would produce: the overlap changes when the driver
blocks, never what is written.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass
from typing import Optional, Union

from dmosopt_tpu_torch.utils import jittered_backoff

#: pipeline modes, in increasing order of overlap
PIPELINE_MODES = ("serial", "overlap_io", "speculative")


@dataclass(frozen=True)
class PipelineConfig:
    """Resolved form of the driver's ``pipeline`` parameter.

    mode: one of `PIPELINE_MODES`.
    quorum_fraction: in ``speculative`` mode, the fraction of a drain's
        evaluation rounds that must fold (in submission order) before
        the epoch proceeds to the surrogate fit; the rest keep
        evaluating and are reconciled at the next drain.
    eval_timeout: per-attempt wall-clock budget in seconds for host
        objectives (None = wait forever); an attempt that exceeds it is
        retried (`eval_retries` times) and then marked failed.
    eval_retries: resubmissions allowed per request after a timeout or
        an objective exception.
    on_eval_failure: ``"raise"`` (a request that fails after all
        retries aborts the run, as the serial loop does) or ``"skip"``
        (only that request is dropped; the batch survives).
    torch_eval_chunks: number of chunks a `TorchBatchEvaluator` batch is
        split into, so results stream back per chunk (1 = no chunking).
    """

    mode: str = "overlap_io"
    quorum_fraction: float = 0.6
    eval_timeout: Optional[float] = None
    eval_retries: int = 0
    on_eval_failure: str = "raise"
    torch_eval_chunks: int = 1

    def __post_init__(self):
        if self.mode not in PIPELINE_MODES:
            raise ValueError(f"pipeline mode {self.mode!r} not in {PIPELINE_MODES}")
        if not (0.0 < self.quorum_fraction <= 1.0):
            raise ValueError(
                f"quorum_fraction must be in (0, 1]; got {self.quorum_fraction}"
            )
        if self.on_eval_failure not in ("raise", "skip"):
            raise ValueError(
                f"on_eval_failure must be 'raise' or 'skip'; "
                f"got {self.on_eval_failure!r}"
            )
        if self.torch_eval_chunks < 1:
            raise ValueError("torch_eval_chunks must be >= 1")

    @property
    def overlaps_io(self) -> bool:
        return self.mode != "serial"

    @property
    def speculative(self) -> bool:
        return self.mode == "speculative"

    @classmethod
    def from_spec(
        cls, spec: Union[None, str, dict, "PipelineConfig"]
    ) -> "PipelineConfig":
        """None -> the default (overlap_io); a mode string; a dict of
        constructor kwargs; or a ready-made config."""
        if spec is None:
            return cls()
        if isinstance(spec, cls):
            return spec
        if isinstance(spec, str):
            return cls(mode=spec)
        if isinstance(spec, dict):
            return cls(**spec)
        raise TypeError(
            f"pipeline must be None, str, dict, or PipelineConfig; got {type(spec)!r}"
        )


class BackgroundWriter:
    """Ordered single-thread executor for persistence closures.

    `flush()` blocks until everything submitted so far has run; the
    driver calls it at the end of each epoch and at teardown. A
    transient failure (`OSError`) is retried in place up to
    `MAX_RETRIES` times with jittered capped exponential backoff,
    before the next closure runs, so order holds. A closure that still
    fails, or raises anything else, kills the writer: the error is
    re-raised from the next `submit`/`flush`/`close` on the driver
    thread, and every later closure is skipped, so a failed append is
    never followed by later writes.

    With ``telemetry`` each closure runs in an ``h5_write`` span on the
    writer's thread, a retry counts in ``writer_retries_total``, and
    ``submit``/``flush`` set the ``writer_queue_depth`` gauge
    (``dmosopt_tpu/parallel/pipeline.py:191-270``).
    """

    # transient-failure retries: count, first backoff and its cap (s)
    MAX_RETRIES = 3
    BACKOFF = 0.05
    BACKOFF_CAP = 2.0

    def __init__(self, telemetry=None):
        self.telemetry = telemetry
        self._q: "queue.Queue" = queue.Queue()
        # guards the error hand-off between the worker thread and the
        # driver thread; the closures themselves run outside it
        self._state_lock = threading.Lock()
        self._error: Optional[BaseException] = None
        self._failed = False  # error already surfaced; writer is dead
        self._closed = False
        self._thread = threading.Thread(
            target=self._run, name="dmosopt-writer", daemon=True
        )
        self._thread.start()

    def _record_error(self, e: BaseException):
        with self._state_lock:
            self._error = e

    def _call(self, fn, args, kwargs):
        attempt = 0
        while True:
            try:
                if self.telemetry:
                    with self.telemetry.span("h5_write"):
                        fn(*args, **kwargs)
                else:
                    fn(*args, **kwargs)
                return
            except OSError as e:
                if attempt >= self.MAX_RETRIES:
                    self._record_error(e)
                    return
                delay = jittered_backoff(attempt, self.BACKOFF, self.BACKOFF_CAP)
                attempt += 1
                if self.telemetry:
                    self.telemetry.inc("writer_retries_total")
                time.sleep(delay)
            except BaseException as e:  # surfaced on the driver thread
                self._record_error(e)
                return

    def _run(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                with self._state_lock:
                    dead = self._error is not None or self._failed
                if not dead:
                    self._call(*item)
            finally:
                self._q.task_done()

    def _raise_pending(self):
        with self._state_lock:
            err, self._error = self._error, None
            if err is not None:
                self._failed = True
            failed = self._failed
        if err is not None:
            raise RuntimeError("background persistence write failed") from err
        if failed:
            raise RuntimeError(
                "background persistence writer is dead after an earlier write failure"
            )

    def submit(self, fn, *args, **kwargs) -> None:
        if self._closed:
            raise RuntimeError("BackgroundWriter is closed")
        self._raise_pending()
        self._q.put((fn, args, kwargs))
        if self.telemetry:
            self.telemetry.gauge("writer_queue_depth", self._q.qsize())

    def flush(self) -> None:
        """Block until every closure submitted so far has run; re-raise
        the first deferred write error."""
        self._q.join()
        if self.telemetry:
            self.telemetry.gauge("writer_queue_depth", 0)
        self._raise_pending()

    def close(self) -> None:
        if self._closed:
            return
        self._q.join()
        self._closed = True
        self._q.put(None)
        self._thread.join()
        # raise only an error nobody has seen yet: run() closes the
        # writer in its finally block, where re-raising an already
        # surfaced failure would mask the exception that ended the run
        with self._state_lock:
            unseen = self._error is not None
        if unseen:
            self._raise_pending()
