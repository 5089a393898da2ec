"""Span timing statistics (reference: pkg/spanstat/spanstat.go:100).

Measures named stages of long operations (endpoint regeneration phases),
accumulating success/failure durations separately.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field


class SpanStat:
    def __init__(self) -> None:
        self.success_duration = 0.0
        self.failure_duration = 0.0
        self.num_success = 0
        self.num_failure = 0
        self._start = 0.0

    def start(self) -> "SpanStat":
        self._start = time.monotonic()
        return self

    def end(self, success: bool = True) -> float:
        """Accumulate the elapsed span; returns its duration."""
        if self._start == 0.0:
            return 0.0
        d = time.monotonic() - self._start
        self._start = 0.0
        if success:
            self.success_duration += d
            self.num_success += 1
        else:
            self.failure_duration += d
            self.num_failure += 1
        return d

    def total(self) -> float:
        return self.success_duration + self.failure_duration

    def seconds(self) -> float:
        return self.total()


@dataclass
class SpanStats:
    """Named span collection for one operation (the shape of the
    reference's regeneration Statistics structs)."""

    spans: dict[str, SpanStat] = field(default_factory=dict)

    def span(self, name: str) -> SpanStat:
        return self.spans.setdefault(name, SpanStat())

    def report(self) -> dict[str, float]:
        return {name: s.total() for name, s in self.spans.items()}
