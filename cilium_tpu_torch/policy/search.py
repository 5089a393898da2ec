"""Search context, decisions and policy tracing.

reference: pkg/policy/policy.go (SearchContext, Tracing), pkg/policy/api/
decision.go (Decision), pkg/policy/trace.
"""

from __future__ import annotations

import enum
import io
from dataclasses import dataclass, field
from typing import Optional

from ..labels import LabelArray


class Decision(enum.Enum):
    """reference: pkg/policy/api/decision.go."""

    UNDECIDED = 0
    ALLOWED = 1
    DENIED = 2

    def __str__(self) -> str:
        return {0: "undecided", 1: "allowed", 2: "denied"}[self.value]


class Tracing(enum.IntEnum):
    DISABLED = 0
    ENABLED = 1
    VERBOSE = 2


@dataclass
class DPort:
    """L4 destination-port context (models.Port analog)."""

    port: int
    protocol: str = "ANY"  # "TCP" | "UDP" | "ANY" | ""


@dataclass
class SearchContext:
    """From/To label sets + optional L4 ports for a policy question
    (reference: pkg/policy/policy.go:64)."""

    from_labels: LabelArray = field(default_factory=LabelArray)
    to_labels: LabelArray = field(default_factory=LabelArray)
    dports: list[DPort] = field(default_factory=list)
    trace: Tracing = Tracing.DISABLED
    depth: int = 0
    logging: Optional[io.StringIO] = None

    def policy_trace(self, fmt: str, *args) -> None:
        """reference: policy.go:39."""
        if self.trace != Tracing.DISABLED:
            self._log(fmt, *args)

    def policy_trace_verbose(self, fmt: str, *args) -> None:
        if self.trace == Tracing.VERBOSE:
            self._log(fmt, *args)

    def _log(self, fmt: str, *args) -> None:
        msg = (fmt % args) if args else fmt
        if self.logging is not None:
            self.logging.write(msg)

    def call_depth(self) -> str:
        return str(self.depth * 2)

    def __str__(self) -> str:
        return (
            f"From: {[str(l) for l in self.from_labels]} => "
            f"To: {[str(l) for l in self.to_labels]}"
            + (f" Ports: {[(p.port, p.protocol) for p in self.dports]}"
               if self.dports else "")
        )


def new_search_context(
    from_labels: LabelArray, to_labels: LabelArray, dports: list[DPort] | None = None
) -> SearchContext:
    return SearchContext(
        from_labels=from_labels, to_labels=to_labels, dports=dports or []
    )
