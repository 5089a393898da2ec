"""L3 (CIDR) policy resolution result.

reference: pkg/policy/l3.go.  The CIDRPolicy tracks allowed prefixes and the
set of distinct prefix lengths; ``to_lpm_data`` (the reference's ToBPFData)
yields the longest-to-shortest prefix-length lists the array-LPM datapath op
consumes (cilium_tpu_torch.ops.lpm).
"""

from __future__ import annotations

import ipaddress
from dataclasses import dataclass, field

from ..labels import LabelArray
from .api import MAX_CIDR_PREFIX_LENGTHS, PolicyValidationError


def get_default_prefix_lengths() -> tuple[list[int], list[int]]:
    """Prefix lengths always present (host, world); longest first
    (reference: l3.go:50-57)."""
    return [128, 0], [32, 0]


@dataclass
class CIDRPolicyMapRule:
    prefix: str
    derived_from_rules: list[LabelArray] = field(default_factory=list)


class CIDRPolicyMap:
    """Allowed prefixes keyed "address/prefixlen" + per-family prefix-length
    counts (reference: l3.go:40)."""

    def __init__(self) -> None:
        self.map: dict[str, CIDRPolicyMapRule] = {}
        self.ipv6_prefix_count: dict[int, int] = {}
        self.ipv4_prefix_count: dict[int, int] = {}

    def insert(self, cidr: str, rule_labels: LabelArray) -> int:
        """Insert; returns 1 if newly added (reference: l3.go:60-98)."""
        try:
            net = ipaddress.ip_network(cidr, strict=False)
        except ValueError:
            try:
                addr = ipaddress.ip_address(cidr)
            except ValueError:
                return 0
            net = ipaddress.ip_network(f"{addr}/{addr.max_prefixlen}")
        key = f"{net.network_address}/{net.prefixlen}"
        existing = self.map.get(key)
        if existing is None:
            self.map[key] = CIDRPolicyMapRule(
                prefix=key, derived_from_rules=[rule_labels]
            )
            counts = (
                self.ipv4_prefix_count if net.version == 4 else self.ipv6_prefix_count
            )
            counts[net.prefixlen] = counts.get(net.prefixlen, 0) + 1
            return 1
        existing.derived_from_rules.append(rule_labels)
        return 0


class CIDRPolicy:
    """reference: l3.go:105."""

    def __init__(self) -> None:
        self.ingress = CIDRPolicyMap()
        self.egress = CIDRPolicyMap()
        s6, s4 = get_default_prefix_lengths()
        for m in (self.ingress, self.egress):
            for p in s6:
                m.ipv6_prefix_count.setdefault(p, 0)
            for p in s4:
                m.ipv4_prefix_count.setdefault(p, 0)

    def to_lpm_data(self) -> tuple[list[int], list[int]]:
        """Distinct prefix lengths longest-first, (v6, v4)
        (reference: l3.go:146-170 ToBPFData)."""
        s6: set[int] = set()
        s4: set[int] = set()
        for m in (self.ingress, self.egress):
            s6.update(m.ipv6_prefix_count)
            s4.update(m.ipv4_prefix_count)
        return sorted(s6, reverse=True), sorted(s4, reverse=True)

    def validate(self) -> None:
        """reference: l3.go:200."""
        for name, m in (("ingress", self.ingress), ("egress", self.egress)):
            for fam, counts in (
                ("IPv6", m.ipv6_prefix_count),
                ("IPv4", m.ipv4_prefix_count),
            ):
                if len(counts) > MAX_CIDR_PREFIX_LENGTHS:
                    raise PolicyValidationError(
                        f"too many {name} {fam} CIDR prefix lengths "
                        f"{len(counts)}/{MAX_CIDR_PREFIX_LENGTHS}"
                    )

    def get_model(self) -> dict:
        return {
            "ingress": [
                {"rule": v.prefix,
                 "derived_from_rules": [l.get_model() for l in v.derived_from_rules]}
                for v in self.ingress.map.values()
            ],
            "egress": [
                {"rule": v.prefix,
                 "derived_from_rules": [l.get_model() for l in v.derived_from_rules]}
                for v in self.egress.map.values()
            ],
        }
