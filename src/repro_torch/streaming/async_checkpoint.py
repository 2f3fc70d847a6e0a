"""Background snapshot-then-write checkpoint executor.

The synchronous commit path (`StateStore.checkpoint`) serializes and
fsyncs a full state snapshot *inside* the streaming hot path, so every
checkpointed step pays disk latency.  This module moves the write off
the hot path while keeping the crash matrix of ``faults`` intact, by
splitting a commit in two:

1. **Snapshot (caller thread, cheap)** -- the commit point copies the
   state leaves to host memory *now* (`StateStore._snapshot_leaves`:
   one device-to-host copy of each leaf on CUDA, one host copy on the
   CPU).  The copy is mandatory, not an optimization: the engine's
   appliers update the state tensors IN PLACE, so a view handed to a
   background thread would show the micro-batches applied after the
   commit point.
2. **Write (worker thread, slow)** -- the snapshot plus the atomic
   protocol (`write_npz` -> retain-previous -> `atomic_write_json`
   LATEST) runs as an opaque job on a single FIFO worker.  The atomic
   LATEST replace *is* the commit callback, so a restore can never
   observe a half-written commit -- it lands on the last LATEST whose
   replace completed, exactly as in the synchronous path.

Failure semantics are deliberately process-like.  A job that raises --
including :class:`repro_torch.streaming.faults.InjectedCrash`, which is
a ``BaseException`` precisely so cleanup handlers cannot swallow it --
is recorded as the checkpointer's terminal error; every job queued
behind it is **discarded, never half-run** (a crashed writer commits
nothing further), and the error surfaces on the caller thread at the
next :meth:`AsyncCheckpointer.flush` / :meth:`AsyncCheckpointer.submit`.

Fault sites: the worker trips ``"async.dequeue"`` before starting a
job and ``"async.post_commit"`` after it returns -- the
:data:`repro_torch.streaming.faults.ASYNC_CRASH_SITES` pair that kills
the writer mid-flight.  Backend-free: ``threading`` and ``queue`` only.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, List, Optional, Tuple

from repro_torch.streaming import faults

__all__ = ["AsyncCheckpointer"]

# A commit job: fully self-contained closure ending in an atomic
# LATEST replace.  Paired with a label for error reporting.
_Job = Tuple[Callable[[], None], str]


class AsyncCheckpointer:
    """Single-threaded FIFO executor for snapshot-then-write commits.

    One daemon worker thread drains a FIFO queue of commit jobs;
    submission order is completion order.  The first raising job
    becomes the terminal ``error``: later queued jobs are discarded
    deterministically and both :meth:`submit` and :meth:`flush`
    re-raise it, so a caller cannot keep streaming past a dead writer
    without noticing.  Instances are cheap; a "restarted process"
    (chaos-soak rebuild) simply constructs a fresh one.
    """

    def __init__(self, name: str = "ckpt-writer") -> None:
        self._name = name
        self._queue: "queue.Queue[Optional[_Job]]" = queue.Queue()
        self._lock = threading.Lock()
        self._worker: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._error_label: Optional[str] = None
        self._completed: List[str] = []
        self._pending = 0
        self._closed = False

    # -- caller-thread API -------------------------------------------------

    def submit(self, job: Callable[[], None], label: str = "commit") -> None:
        """Enqueue ``job`` for the background writer (FIFO).

        Raises the recorded terminal error instead of enqueueing if a
        previous job already died — the failure is surfaced at the
        next commit attempt, never silently dropped.
        """
        self.raise_if_failed()
        with self._lock:
            if self._closed:
                raise RuntimeError(f"{self._name}: submit after close()")
            self._pending += 1
            self._ensure_worker()
        self._queue.put((job, label))

    def flush(self) -> None:
        """Block until every submitted job committed or was discarded.

        Re-raises the first job error (including injected crashes) on
        the caller thread.  This is the synchronization point restore
        and shutdown paths must cross before trusting LATEST.
        """
        if self._worker is not None:
            self._queue.join()
        self.raise_if_failed()

    def close(self) -> None:
        """Flush-less shutdown: stop the worker after the queued jobs.

        Does not raise on a recorded error (mirrors process exit); use
        :meth:`flush` first when the caller needs the error surfaced.
        """
        with self._lock:
            if self._closed:
                return
            self._closed = True
            worker = self._worker
        if worker is not None:
            self._queue.put(None)
            worker.join()

    def raise_if_failed(self) -> None:
        """Re-raise the terminal error recorded by the worker, if any."""
        with self._lock:
            err = self._error
        if err is not None:
            raise err

    @property
    def pending(self) -> int:
        """Jobs submitted but not yet committed or discarded."""
        with self._lock:
            return self._pending

    @property
    def error(self) -> Optional[BaseException]:
        """The terminal error recorded by the worker, or None."""
        with self._lock:
            return self._error

    @property
    def completed_labels(self) -> Tuple[str, ...]:
        """Labels of jobs that committed successfully, in order."""
        with self._lock:
            return tuple(self._completed)

    # -- worker thread -----------------------------------------------------

    def _ensure_worker(self) -> None:
        # Lazily started under self._lock so exactly one worker exists.
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(
                target=self._run, name=self._name, daemon=True
            )
            self._worker.start()

    def _run(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                self._queue.task_done()
                return
            job, label = item
            try:
                if self._error is None:
                    # A crashed writer commits nothing further: once an
                    # error is recorded, queued jobs are discarded whole
                    # (never half-run) so the on-disk state stays at the
                    # last completed atomic replace.
                    faults.trip("async.dequeue")
                    job()
                    faults.trip("async.post_commit")
                    with self._lock:
                        self._completed.append(label)
            except BaseException as err:  # noqa: BLE001 - InjectedCrash
                with self._lock:
                    if self._error is None:
                        self._error = err
                        self._error_label = label
            finally:
                with self._lock:
                    self._pending -= 1
                self._queue.task_done()
