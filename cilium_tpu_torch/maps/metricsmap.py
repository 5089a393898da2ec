"""Datapath metrics map: per-(reason, direction) packet/byte counters.

reference: bpf/lib/metrics.h (update_metrics) + pkg/maps/metricsmap
(metrics_key {reason, dir}, metrics_value {count, bytes}); reason 0 is
"forwarded", >0 are drop reasons.

A copy of ``cilium_tpu/maps/metricsmap.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..utils.metrics import DropCount, ForwardCount

REASON_FORWARDED = 0

# The metrics map's direction encoding differs from policy_key's 0/1 bit
# (reference: bpf/lib/common.h metrics_key dir 1=ingress 2=egress vs
# policy_key egress bit) — distinct names to prevent cross-map mixups.
METRIC_DIR_INGRESS = 1
METRIC_DIR_EGRESS = 2

_DIR_NAMES = {METRIC_DIR_INGRESS: "INGRESS", METRIC_DIR_EGRESS: "EGRESS"}


@dataclass
class MetricsValue:
    count: int = 0
    bytes: int = 0


class MetricsMap:
    """Host metrics counters (reference: pkg/maps/metricsmap)."""

    def __init__(self) -> None:
        self.values: dict[tuple[int, int], MetricsValue] = {}

    def update(self, reason: int, direction: int, count: int = 1,
               nbytes: int = 0) -> None:
        v = self.values.setdefault((reason, direction), MetricsValue())
        v.count += count
        v.bytes += nbytes
        # Bridge into the Prometheus registry (reference: pkg/metrics
        # drop_count_total/forward_count_total are fed from this map).
        d = _DIR_NAMES.get(direction, str(direction))
        if reason == REASON_FORWARDED:
            ForwardCount.inc(d, amount=count)
        else:
            DropCount.inc(str(reason), d, amount=count)

    def get(self, reason: int, direction: int) -> MetricsValue:
        return self.values.get((reason, direction), MetricsValue())

    def dump(self):
        return sorted(
            (
                (_DIR_NAMES.get(d, str(d)), reason, v.count, v.bytes)
                for (reason, d), v in self.values.items()
            )
        )
