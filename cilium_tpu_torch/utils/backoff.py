"""Exponential backoff with jitter (reference: pkg/backoff/backoff.go).

Used by kvstore reconnects and distribution clients.
"""

from __future__ import annotations

import random
import time


class Exponential:
    def __init__(
        self,
        min_duration: float = 1.0,
        max_duration: float = 0.0,  # 0 = unbounded
        factor: float = 2.0,
        jitter: bool = True,
        name: str = "",
    ) -> None:
        self.min = min_duration
        self.max = max_duration
        self.factor = factor
        self.jitter = jitter
        self.name = name
        self.attempt = 0

    def duration(self, attempt: int | None = None) -> float:
        """Backoff duration for the given (1-based) attempt."""
        if attempt is None:
            self.attempt += 1
            attempt = self.attempt
        d = self.min * (self.factor ** (attempt - 1))
        if self.max and d > self.max:
            d = self.max
        if self.jitter:
            d = d / 2 + random.random() * d / 2
        return d

    def reset(self) -> None:
        self.attempt = 0

    def wait(self) -> None:
        time.sleep(self.duration())
