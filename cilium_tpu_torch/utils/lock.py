"""Lock wrappers with opt-in debug instrumentation.

reference: pkg/lock — ``lock_fast.go`` aliases sync.Mutex/RWMutex in
production builds; the ``lockdebug`` build tag swaps in deadlock-aware
wrappers that (a) warn when a lock is HELD longer than a selfish
threshold (lock_debug.go selfishThresholdSec 0.1s) and (b) treat
waiting longer than a deadlock timeout as a deadlock and dump stacks.

The Python analog keeps the same two-mode shape: with debug disabled
(default) Mutex/RWMutex add one attribute read over the bare primitive;
``enable_debug()`` turns on hold-time warnings, acquisition-timeout
stack dumps, and same-thread double-acquire detection (Python locks
don't deadlock on re-entry the way a waiting goroutine does — a
non-reentrant re-acquire IS the deadlock, so it raises).
"""

from __future__ import annotations

import logging
import threading
import time
import traceback

log = logging.getLogger(__name__)

SELFISH_THRESHOLD = 0.1  # reference: lock_debug.go selfishThresholdSec
DEADLOCK_TIMEOUT = 310.0  # reference: lock_debug.go deadLockTimeout

_debug = False


def enable_debug() -> None:
    global _debug
    _debug = True


def disable_debug() -> None:
    global _debug
    _debug = False


def debug_enabled() -> bool:
    return _debug


class Mutex:
    """sync.Mutex analog; context-manager usable."""

    def __init__(self, name: str = "") -> None:
        self._lock = threading.Lock()
        self.name = name
        self._owner: int | None = None
        self._acquired_at = 0.0

    def acquire(self, timeout: float | None = None) -> bool:
        """Blocking acquire (timeout=None) never returns False: in
        debug mode a wait past DEADLOCK_TIMEOUT logs stacks and KEEPS
        WAITING (report-don't-steal), so mutual exclusion is identical
        to non-debug mode.  A caller-supplied timeout is plain try-lock
        semantics — its expiry is never treated as a deadlock."""
        me = threading.get_ident()
        if timeout is not None:
            ok = self._lock.acquire(timeout=timeout)
            if ok:
                self._owner = me
                self._acquired_at = time.monotonic()
            return ok
        if _debug:
            if self._owner == me:
                # A non-reentrant self re-acquire can never succeed:
                # report the deadlock immediately instead of hanging.
                raise RuntimeError(
                    f"deadlock: thread re-acquiring mutex {self.name!r} "
                    "it already holds"
                )
            waited = 0.0
            while not self._lock.acquire(timeout=DEADLOCK_TIMEOUT):
                waited += DEADLOCK_TIMEOUT
                log.error(
                    "possible deadlock: waited %.0fs for %r; stacks:\n%s",
                    waited, self.name, _all_stacks(),
                )
        else:
            self._lock.acquire()
        self._owner = me
        self._acquired_at = time.monotonic()
        return True

    def release(self) -> None:
        if _debug and self._owner is not None:
            held = time.monotonic() - self._acquired_at
            if held > SELFISH_THRESHOLD:
                log.warning(
                    "lock %r held for %.3fs (> %.2fs)",
                    self.name, held, SELFISH_THRESHOLD,
                )
        # Owner is tracked in every mode so toggling debug on at
        # runtime never sees a stale owner.
        self._owner = None
        self._lock.release()

    def __enter__(self) -> "Mutex":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class RWMutex:
    """sync.RWMutex analog: many readers or one writer.  Writer
    preference: arriving writers block new readers so writers cannot
    starve (matching Go's RWMutex contract)."""

    def __init__(self, name: str = "") -> None:
        self.name = name
        self._cond = threading.Condition()
        self._readers = 0
        self._writer: int | None = None
        self._writers_waiting = 0
        self._acquired_at = 0.0

    def r_acquire(self) -> None:
        with self._cond:
            if _debug and self._writer == threading.get_ident():
                raise RuntimeError(
                    f"deadlock: RLock of {self.name!r} while holding "
                    "its write lock"
                )
            deadline = time.monotonic() + DEADLOCK_TIMEOUT
            while self._writer is not None or self._writers_waiting:
                if not self._cond.wait(timeout=deadline - time.monotonic()):
                    if _debug:
                        log.error(
                            "possible deadlock: reader waited %.0fs for "
                            "%r; stacks:\n%s",
                            DEADLOCK_TIMEOUT, self.name, _all_stacks(),
                        )
                    deadline = time.monotonic() + DEADLOCK_TIMEOUT
            self._readers += 1

    def r_release(self) -> None:
        with self._cond:
            self._readers -= 1
            if self._readers == 0:
                self._cond.notify_all()

    def acquire(self) -> None:
        with self._cond:
            me = threading.get_ident()
            if _debug and self._writer == me:
                raise RuntimeError(
                    f"deadlock: thread re-acquiring write lock "
                    f"{self.name!r} it already holds"
                )
            self._writers_waiting += 1
            try:
                deadline = time.monotonic() + DEADLOCK_TIMEOUT
                while self._writer is not None or self._readers:
                    if not self._cond.wait(
                        timeout=deadline - time.monotonic()
                    ):
                        if _debug:
                            log.error(
                                "possible deadlock: writer waited %.0fs "
                                "for %r; stacks:\n%s",
                                DEADLOCK_TIMEOUT, self.name, _all_stacks(),
                            )
                        deadline = time.monotonic() + DEADLOCK_TIMEOUT
            finally:
                self._writers_waiting -= 1
            self._writer = me
            self._acquired_at = time.monotonic()

    def release(self) -> None:
        with self._cond:
            if _debug:
                held = time.monotonic() - self._acquired_at
                if held > SELFISH_THRESHOLD:
                    log.warning(
                        "write lock %r held for %.3fs (> %.2fs)",
                        self.name, held, SELFISH_THRESHOLD,
                    )
            self._writer = None
            self._cond.notify_all()

    def __enter__(self) -> "RWMutex":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    class _ReadGuard:
        def __init__(self, rw: "RWMutex") -> None:
            self.rw = rw

        def __enter__(self):
            self.rw.r_acquire()
            return self

        def __exit__(self, *exc):
            self.rw.r_release()

    def read(self) -> "_ReadGuard":
        """``with rw.read():`` — reader-side context manager."""
        return RWMutex._ReadGuard(self)


def _all_stacks() -> str:
    import sys

    frames = sys._current_frames()
    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for ident, frame in frames.items():
        out.append(f"--- {names.get(ident, '?')} ({ident}) ---")
        out.extend(s.rstrip() for s in traceback.format_stack(frame))
    return "\n".join(out)
