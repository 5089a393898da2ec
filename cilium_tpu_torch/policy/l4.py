"""L4/L7 policy resolution result: L4Filter, L4PolicyMap, L4Policy.

reference: pkg/policy/l4.go.  The L4PolicyMap is keyed ``"port/PROTO"``; each
L4Filter carries the allowed peer selectors and the per-selector L7 rules
(L7DataMap) that the proxy layer compiles into device NFA tables.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..labels import LabelArray
from .api import (
    EndpointSelector,
    L7Rules,
    PortProtocol,
    PortRule,
    PROTO_TCP,
    WILDCARD_SELECTOR,
    proto_number,
)
from .search import Decision, SearchContext

# L7 parser types (reference: pkg/policy/l4.go:80-87).
PARSER_TYPE_NONE = ""
PARSER_TYPE_HTTP = "http"
PARSER_TYPE_KAFKA = "kafka"


def _copy_l7_rules(rules: L7Rules) -> L7Rules:
    return L7Rules(
        http=list(rules.http),
        kafka=list(rules.kafka),
        l7proto=rules.l7proto,
        l7=list(rules.l7),
    )


class L7DataMap(dict):
    """EndpointSelector -> L7Rules (reference: pkg/policy/l4.go:32)."""

    def add_rules_for_endpoints(
        self, rules: L7Rules, endpoints: list[EndpointSelector]
    ) -> None:
        """reference: l4.go:143-160 — no explicit endpoints means the
        wildcard selector carries the rules."""
        if len(rules) == 0:
            return
        # Each selector gets its own copy: merging appends to these lists,
        # and the rule AST stored in the Repository must never be mutated.
        if endpoints:
            for sel in endpoints:
                self[sel] = _copy_l7_rules(rules)
        else:
            self[WILDCARD_SELECTOR] = _copy_l7_rules(rules)

    def get_relevant_rules(self, identity_labels: Optional[LabelArray]) -> L7Rules:
        """Collect the L7 rules whose selector matches the remote identity
        (reference: l4.go:118-141)."""
        rules = L7Rules()
        if identity_labels is not None:
            for selector, ep_rules in self.items():
                if selector == WILDCARD_SELECTOR:
                    continue
                if selector.matches(identity_labels):
                    rules.http.extend(ep_rules.http)
                    rules.kafka.extend(ep_rules.kafka)
                    rules.l7proto = ep_rules.l7proto
                    rules.l7.extend(ep_rules.l7)
        wild = self.get(WILDCARD_SELECTOR)
        if wild is not None:
            rules.http.extend(wild.http)
            rules.kafka.extend(wild.kafka)
            rules.l7proto = wild.l7proto
            rules.l7.extend(wild.l7)
        return rules


@dataclass
class L4Filter:
    """One resolved port/proto entry (reference: pkg/policy/l4.go:89)."""

    port: int
    protocol: str
    u8_proto: int = 0
    endpoints: list[EndpointSelector] = field(default_factory=list)
    l7_parser: str = PARSER_TYPE_NONE
    l7_rules_per_ep: L7DataMap = field(default_factory=L7DataMap)
    ingress: bool = True
    derived_from_rules: list[LabelArray] = field(default_factory=list)

    def allows_all_at_l3(self) -> bool:
        """reference: l4.go:112."""
        if not self.endpoints:
            return True
        return any(sel.is_wildcard() for sel in self.endpoints)

    def is_redirect(self) -> bool:
        return self.l7_parser != PARSER_TYPE_NONE

    def matches_labels(self, lbls: LabelArray) -> bool:
        """reference: l4.go:258-274."""
        if self.allows_all_at_l3():
            return True
        if len(lbls) == 0:
            return False
        return any(sel.matches(lbls) for sel in self.endpoints)


def create_l4_filter(
    peer_endpoints: list[EndpointSelector],
    rule: PortRule,
    port: PortProtocol,
    protocol: str,
    rule_labels: LabelArray,
    ingress: bool,
) -> L4Filter:
    """reference: pkg/policy/l4.go:162-207."""
    p = int(port.port, 0)
    filter_endpoints = peer_endpoints
    if not peer_endpoints or any(s.is_wildcard() for s in peer_endpoints):
        filter_endpoints = [WILDCARD_SELECTOR]

    l4 = L4Filter(
        port=p,
        protocol=protocol,
        u8_proto=proto_number(protocol),
        endpoints=filter_endpoints,
        ingress=ingress,
        derived_from_rules=[rule_labels],
    )
    if protocol == PROTO_TCP and rule.rules is not None:
        if rule.rules.http:
            l4.l7_parser = PARSER_TYPE_HTTP
        elif rule.rules.kafka:
            l4.l7_parser = PARSER_TYPE_KAFKA
        elif rule.rules.l7proto:
            l4.l7_parser = rule.rules.l7proto
        if not rule.rules.is_empty():
            l4.l7_rules_per_ep.add_rules_for_endpoints(rule.rules, filter_endpoints)
    return l4


def create_l4_ingress_filter(
    from_endpoints: list[EndpointSelector],
    endpoints_with_l3_override: list[EndpointSelector],
    rule: PortRule,
    port: PortProtocol,
    protocol: str,
    rule_labels: LabelArray,
) -> L4Filter:
    """reference: l4.go:209-227 — L3-override selectors (host/world in
    allow-localhost modes) get their L7 rules wildcarded."""
    f = create_l4_filter(from_endpoints, rule, port, protocol, rule_labels, True)
    if rule.rules is not None and not rule.rules.is_empty():
        for sel in endpoints_with_l3_override:
            f.l7_rules_per_ep[sel] = L7Rules()
    return f


def create_l4_egress_filter(
    to_endpoints: list[EndpointSelector],
    rule: PortRule,
    port: PortProtocol,
    protocol: str,
    rule_labels: LabelArray,
) -> L4Filter:
    return create_l4_filter(to_endpoints, rule, port, protocol, rule_labels, False)


class L4PolicyMap(dict):
    """"port/PROTO" -> L4Filter (reference: pkg/policy/l4.go:276)."""

    def has_redirect(self) -> bool:
        return any(f.is_redirect() for f in self.values())

    def contains_all_l3_l4(
        self, lbls: LabelArray, dports
    ) -> Decision:
        """reference: l4.go:300-335."""
        if len(self) == 0:
            return Decision.ALLOWED
        if not dports:
            return Decision.DENIED
        for ctx in dports:
            proto = ctx.protocol
            if proto in ("", "ANY"):
                tcp = self.get(f"{ctx.port}/TCP")
                udp = self.get(f"{ctx.port}/UDP")
                tcp_ok = tcp is not None and tcp.matches_labels(lbls)
                udp_ok = udp is not None and udp.matches_labels(lbls)
                if not tcp_ok and not udp_ok:
                    return Decision.DENIED
            else:
                f = self.get(f"{ctx.port}/{proto}")
                if f is None or not f.matches_labels(lbls):
                    return Decision.DENIED
        return Decision.ALLOWED

    def ingress_covers_context(self, ctx: SearchContext) -> Decision:
        return self.contains_all_l3_l4(ctx.from_labels, ctx.dports)

    def egress_covers_context(self, ctx: SearchContext) -> Decision:
        return self.contains_all_l3_l4(ctx.to_labels, ctx.dports)


@dataclass
class L4Policy:
    """reference: pkg/policy/l4.go:337."""

    ingress: L4PolicyMap = field(default_factory=L4PolicyMap)
    egress: L4PolicyMap = field(default_factory=L4PolicyMap)
    revision: int = 0

    def has_redirect(self) -> bool:
        return self.ingress.has_redirect() or self.egress.has_redirect()

    def requires_conntrack(self) -> bool:
        return len(self.ingress) > 0 or len(self.egress) > 0
