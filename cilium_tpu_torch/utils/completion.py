"""Completion tracking with deadlines.

reference: pkg/completion — policy application blocks on proxy ACKs via a
WaitGroup of Completions with a context deadline (pkg/endpoint/bpf.go:555,
pkg/envoy/xds/ack.go).
"""

from __future__ import annotations

import threading


class CompletionError(TimeoutError):
    pass


class Completion:
    """One pending acknowledgement (reference: completion/completion.go)."""

    def __init__(self, wg: "WaitGroup | None" = None) -> None:
        self._event = threading.Event()
        self._wg = wg
        if wg is not None:
            wg._add(self)

    def complete(self) -> None:
        self._event.set()

    @property
    def completed(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: float | None = None) -> bool:
        return self._event.wait(timeout)


class WaitGroup:
    """Waits for all added completions (reference: completion.WaitGroup)."""

    def __init__(self, timeout: float | None = None) -> None:
        self.timeout = timeout
        self._completions: list[Completion] = []
        self._mutex = threading.Lock()

    def _add(self, c: Completion) -> None:
        with self._mutex:
            self._completions.append(c)

    def add_completion(self) -> Completion:
        return Completion(self)

    def wait(self, timeout: float | None = None) -> None:
        """Blocks until all complete; raises CompletionError on deadline."""
        import time

        deadline = None
        t = timeout if timeout is not None else self.timeout
        if t is not None:
            deadline = time.monotonic() + t
        with self._mutex:
            pending = list(self._completions)
        for c in pending:
            remaining = None
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise CompletionError("completion wait deadline exceeded")
            if not c.wait(remaining):
                raise CompletionError("completion wait deadline exceeded")
