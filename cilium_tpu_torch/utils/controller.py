"""Named reconciliation controllers with interval + error backoff.

reference: pkg/controller/controller.go — every long-running reconciliation
loop is a named Controller: runs DoFunc on RunInterval, retries with
linearly-growing backoff on error, tracks success/failure counters, and is
surfaced by ``status --all-controllers``.
"""

from __future__ import annotations

import threading
import time
import traceback
import uuid as uuid_mod
from dataclasses import dataclass, field
from typing import Callable, Optional


@dataclass
class ControllerParams:
    """reference: controller.go:50."""

    do_func: Optional[Callable[[], None]] = None
    stop_func: Optional[Callable[[], None]] = None
    run_interval: float = 0.0  # seconds; 0 = run once + on update only
    error_retry_base: float = 1.0  # multiplied by consecutive error count
    no_error_retry: bool = False


@dataclass
class ControllerStatus:
    name: str
    uuid: str
    success_count: int
    failure_count: int
    consecutive_errors: int
    last_error: str
    last_duration: float


class Controller:
    """reference: controller.go:128."""

    def __init__(self, name: str, params: ControllerParams) -> None:
        self.name = name
        self.uuid = str(uuid_mod.uuid4())
        self.params = params
        self.mutex = threading.RLock()
        self.success_count = 0
        self.failure_count = 0
        self.consecutive_errors = 0
        self.last_error: str = ""
        self.last_duration = 0.0
        self.last_success_stamp = 0.0
        self.last_error_stamp = 0.0
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._terminated = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name=f"ctrl-{name}", daemon=True
        )
        self._thread.start()

    def _run_once(self) -> None:
        start = time.monotonic()
        try:
            if self.params.do_func is None:
                raise RuntimeError("controller has unset DoFunc")
            self.params.do_func()
        except Exception as e:  # noqa: BLE001 — controllers never die on errors
            with self.mutex:
                self.failure_count += 1
                self.consecutive_errors += 1
                self.last_error = f"{e}"
                self.last_error_stamp = time.time()
                self.last_duration = time.monotonic() - start
        else:
            with self.mutex:
                self.success_count += 1
                self.consecutive_errors = 0
                self.last_error = ""
                self.last_success_stamp = time.time()
                self.last_duration = time.monotonic() - start

    def _next_interval(self) -> float:
        """Error backoff: base * consecutive errors (reference:
        controller.go:70-74), else the regular run interval."""
        with self.mutex:
            errs = self.consecutive_errors
        if errs > 0 and not self.params.no_error_retry:
            return self.params.error_retry_base * errs
        if self.params.run_interval > 0:
            return self.params.run_interval
        return 0.0

    def _run(self) -> None:
        self._run_once()
        while not self._stop.is_set():
            interval = self._next_interval()
            if interval <= 0:
                # No interval: wait for an explicit update/stop.
                self._wake.wait()
            else:
                self._wake.wait(timeout=interval)
            if self._stop.is_set():
                break
            self._wake.clear()
            self._run_once()
        if self.params.stop_func is not None:
            try:
                self.params.stop_func()
            except Exception:  # noqa: BLE001
                traceback.print_exc()
        self._terminated.set()

    def update(self, params: ControllerParams | None = None) -> None:
        """Replace params and run immediately (reference:
        Manager.UpdateController semantics)."""
        if params is not None:
            self.params = params
        self._wake.set()

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        self._wake.set()
        self._terminated.wait(timeout)

    def status(self) -> ControllerStatus:
        with self.mutex:
            return ControllerStatus(
                name=self.name,
                uuid=self.uuid,
                success_count=self.success_count,
                failure_count=self.failure_count,
                consecutive_errors=self.consecutive_errors,
                last_error=self.last_error,
                last_duration=self.last_duration,
            )


class ControllerManager:
    """Collection of controllers keyed by name
    (reference: pkg/controller/manager.go)."""

    def __init__(self) -> None:
        self.controllers: dict[str, Controller] = {}
        self.mutex = threading.RLock()

    def update_controller(self, name: str, params: ControllerParams) -> Controller:
        with self.mutex:
            c = self.controllers.get(name)
            if c is not None:
                c.update(params)
                return c
            c = Controller(name, params)
            self.controllers[name] = c
            return c

    def remove_controller(self, name: str) -> bool:
        with self.mutex:
            c = self.controllers.pop(name, None)
        if c is None:
            return False
        c.stop()
        return True

    def remove_all(self) -> None:
        with self.mutex:
            cs = list(self.controllers.values())
            self.controllers.clear()
        for c in cs:
            c.stop()

    def lookup(self, name: str) -> Controller | None:
        return self.controllers.get(name)

    def statuses(self) -> list[ControllerStatus]:
        with self.mutex:
            return [c.status() for c in self.controllers.values()]


# Global manager used by subsystems (reference: controller package-level API).
manager = ControllerManager()
