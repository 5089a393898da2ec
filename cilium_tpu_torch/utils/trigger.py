"""Serialized, rate-limited trigger (reference: pkg/trigger/trigger.go).

Folds bursts of Trigger() calls into serialized TriggerFunc invocations at
most once per min_interval — the mechanism behind batched policy
regeneration kicks.
"""

from __future__ import annotations

import threading
import time
from typing import Callable


class Trigger:
    def __init__(
        self,
        trigger_func: Callable[[], None],
        min_interval: float = 0.0,
        sleep_interval: float = 0.01,
        name: str = "",
    ) -> None:
        self.trigger_func = trigger_func
        self.min_interval = min_interval
        self.sleep_interval = sleep_interval
        self.name = name
        self._pending = False
        self._mutex = threading.Lock()
        self._wake = threading.Event()
        self._closed = threading.Event()
        self.last_trigger = 0.0
        self.fold_count = 0  # triggers folded into the next invocation
        self.call_count = 0
        self._thread = threading.Thread(
            target=self._waiter, name=f"trigger-{name}", daemon=True
        )
        self._thread.start()

    def trigger(self) -> None:
        """Non-blocking request (reference: trigger.go:90)."""
        with self._mutex:
            self._pending = True
            self.fold_count += 1
        self._wake.set()

    def shutdown(self) -> None:
        self._closed.set()
        self._wake.set()

    def _needs_delay(self) -> tuple[bool, float]:
        if self.min_interval == 0:
            return False, 0.0
        remaining = self.last_trigger + self.min_interval - time.monotonic()
        return remaining > 0, remaining

    def _waiter(self) -> None:
        while not self._closed.is_set():
            with self._mutex:
                pending = self._pending
                self._pending = False
                folded = self.fold_count
                if pending:
                    self.fold_count = 0
            if pending:
                delay, remaining = self._needs_delay()
                while delay and not self._closed.is_set():
                    time.sleep(min(remaining, self.sleep_interval))
                    delay, remaining = self._needs_delay()
                if self._closed.is_set():
                    return
                self.last_trigger = time.monotonic()
                self.call_count += 1
                self.trigger_func()
            else:
                self._wake.wait(timeout=self.sleep_interval)
                self._wake.clear()
