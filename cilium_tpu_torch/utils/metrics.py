"""Metrics registry with Prometheus text exposition.

reference: pkg/metrics/metrics.go:51-430 — counters exported in
Prometheus text format.  Copied from ``cilium_tpu/utils/metrics.py``:
the counter type, the registry and the counters the port increments
(the HTTP engine's cache tier, the flow-record ring and the datapath
metrics map's drop and forward counts).
"""

from __future__ import annotations

import threading
from typing import Iterable

NAMESPACE = "cilium_tpu"


def _fmt_labels(label_names, label_values) -> str:
    if not label_names:
        return ""
    inner = ",".join(
        f'{k}="{v}"' for k, v in zip(label_names, label_values)
    )
    return "{" + inner + "}"


class Counter:
    def __init__(self, name: str, help_: str, label_names: tuple = ()) -> None:
        self.name = name
        self.help = help_
        self.label_names = label_names
        self._values: dict[tuple, float] = {}
        self._mutex = threading.Lock()

    def inc(self, *label_values, amount: float = 1.0) -> None:
        with self._mutex:
            self._values[label_values] = self._values.get(label_values, 0.0) + amount

    def get(self, *label_values) -> float:
        return self._values.get(label_values, 0.0)

    def collect(self) -> Iterable[str]:
        yield f"# HELP {self.name} {self.help}"
        yield f"# TYPE {self.name} counter"
        if not self._values and not self.label_names:
            yield f"{self.name} 0"
        for lv, v in sorted(self._values.items()):
            yield f"{self.name}{_fmt_labels(self.label_names, lv)} {v:g}"


class Registry:
    def __init__(self) -> None:
        self._collectors: list = []
        self._mutex = threading.Lock()

    def register(self, collector):
        with self._mutex:
            self._collectors.append(collector)
        return collector

    def counter(self, name, help_, label_names=()):
        return self.register(Counter(f"{NAMESPACE}_{name}", help_, label_names))

    def expose(self) -> str:
        """Prometheus text format."""
        lines: list[str] = []
        with self._mutex:
            collectors = list(self._collectors)
        for c in collectors:
            lines.extend(c.collect())
        return "\n".join(lines) + "\n"


registry = Registry()

# Established-flow verdict cache: every hit is a device row that never
# happens; the cached verdict is attributed to the original rule row.
VerdictCacheHits = registry.counter(
    "verdict_cache_hits_total",
    "Frames short-circuited by the established-flow verdict cache, by "
    "site (engine = judge-step host answer)",
    ("site",),
)

# Flow-level verdict observability (flowlog/): one increment per
# distinct (verdict, path, match_kind) tuple per ROUND — the counter
# twin of the flow-record ring, so dashboards see verdict mix by
# serving path and by how the deciding rule was compiled.
FlowVerdictsTotal = registry.counter(
    "flow_verdicts_total",
    "Flow verdict records by verdict, serving path, and the deciding "
    "rule's compiled match kind (literal|regex|nfa|l3|l4)",
    ("verdict", "path", "match_kind"),
)

# Datapath packet counts, fed from the metrics map (maps/metricsmap.py).
DropCount = registry.counter(
    "drop_count_total", "Dropped packets/requests", ("reason", "direction")
)
ForwardCount = registry.counter(
    "forward_count_total", "Forwarded packets/requests", ("direction",)
)
