"""Bounded build queue with per-endpoint serialization.

reference: daemon/daemon.go:212-272 (StartEndpointBuilders: bounded channel
+ N builder workers) and pkg/buildqueue (per-UUID build serialization:
concurrent enqueues of the same endpoint fold, and one endpoint never
builds on two workers at once).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable

from ..utils import defaults
from ..utils.logging import get_logger

log = get_logger("buildqueue")


class BuildQueue:
    def __init__(
        self,
        build_func: Callable[[object], None],
        workers: int = defaults.MIN_ENDPOINT_BUILDERS,
        maxsize: int = 1024,
    ) -> None:
        self.build_func = build_func
        self._queue: "queue.Queue" = queue.Queue(maxsize=maxsize)
        self._pending: set = set()  # keys queued but not started
        self._building: set = set()  # keys currently building
        self._requeue_items: dict = {}  # key -> item enqueued while building
        self._mutex = threading.Lock()
        self._stop = threading.Event()
        self._idle = threading.Condition(self._mutex)
        self._threads = [
            threading.Thread(target=self._worker, name=f"builder-{i}",
                             daemon=True)
            for i in range(max(1, workers))
        ]
        for t in self._threads:
            t.start()

    def enqueue(self, item, key=None) -> bool:
        """Queue a build; folds duplicates of the same key
        (reference: buildqueue Enqueue serialization)."""
        key = key if key is not None else item
        with self._mutex:
            if key in self._pending:
                return False  # already queued: folded
            if key in self._building:
                # Rebuild after the current one finishes.
                self._requeue_items[key] = item
                return False
            self._pending.add(key)
        self._queue.put((key, item))
        return True

    def _worker(self) -> None:
        while not self._stop.is_set():
            try:
                key, item = self._queue.get(timeout=0.2)
            except queue.Empty:
                continue
            with self._mutex:
                self._pending.discard(key)
                self._building.add(key)
            try:
                self.build_func(item)
            except Exception as e:  # noqa: BLE001 — a failing build must
                log.with_fields(key=str(key), error=str(e)).error(
                    "build failed"
                )  # not kill the worker
            finally:
                with self._mutex:
                    self._building.discard(key)
                    requeued = self._requeue_items.pop(key, None)
                    if requeued is not None:
                        # Mark pending before releasing the mutex so
                        # wait_idle can't observe a false idle between
                        # the pop and the re-enqueue.
                        self._pending.add(key)
                    self._idle.notify_all()
                if requeued is not None:
                    self._queue.put((key, requeued))
                self._queue.task_done()

    def wait_idle(self, timeout: float = 10.0) -> bool:
        """Block until nothing is pending or building (test helper)."""
        import time

        deadline = time.monotonic() + timeout
        with self._idle:
            while (self._pending or self._building or self._requeue_items
                   or not self._queue.empty()):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._idle.wait(timeout=min(remaining, 0.1))
        return True

    def stop(self) -> None:
        self._stop.set()
