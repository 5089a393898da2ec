"""Revisioned policy rule repository and resolution.

reference: pkg/policy/repository.go + pkg/policy/rule.go.  Rules are stored
in insertion order; every mutation bumps the revision.  Resolution walks all
rules whose EndpointSelector matches the destination (ingress) or source
(egress) labels and merges PortRules into an L4PolicyMap, preserving the
reference's merge semantics: wildcard L3 collapse, L7 parser conflicts,
FromRequires folding, and L3/L4-only rules wildcarding L7.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

from ..labels import LabelArray
from .api import (
    EgressRule,
    EndpointSelector,
    IngressRule,
    L7Rules,
    PortRule,
    PortRuleKafka,
    PortRuleHTTP,
    PROTO_ANY,
    PROTO_TCP,
    PROTO_UDP,
    Rule,
    SelectorRequirement,
)
from .l3 import CIDRPolicy
from .l4 import (
    L4Filter,
    L4Policy,
    L4PolicyMap,
    PARSER_TYPE_HTTP,
    PARSER_TYPE_KAFKA,
    PARSER_TYPE_NONE,
    create_l4_egress_filter,
    create_l4_ingress_filter,
)
from .search import Decision, SearchContext


class PolicyMergeError(ValueError):
    """L7 merge conflict (reference: rule.go mergeL4Port errors)."""


@dataclass
class TraceState:
    """reference: repository.go:51."""

    rule_id: int = 0
    selected_rules: int = 0
    matched_rules: int = 0
    constrained_rules: int = 0

    def trace(self, repo: "Repository", ctx: SearchContext) -> None:
        ctx.policy_trace(
            "%d/%d rules selected\n", self.selected_rules, repo.num_rules()
        )
        if self.constrained_rules > 0:
            ctx.policy_trace(
                "Found unsatisfied FromRequires constraint\n"
            )
        elif self.matched_rules > 0:
            ctx.policy_trace("Found allow rule\n")
        else:
            ctx.policy_trace("Found no allow rule\n")


def _l7_rule_exists(existing: L7Rules, kind: str, rule) -> bool:
    if kind == "http":
        return any(r.key() == rule.key() for r in existing.http)
    if kind == "kafka":
        return any(r.key() == rule.key() for r in existing.kafka)
    return any(r.key() == rule.key() for r in existing.l7)


def _merge_l4_port(
    ctx: SearchContext,
    endpoints: list[EndpointSelector],
    existing: L4Filter,
    to_merge: L4Filter,
) -> None:
    """Merge to_merge into existing (reference: rule.go:36-111)."""
    if existing.allows_all_at_l3() or to_merge.allows_all_at_l3():
        from .api import WILDCARD_SELECTOR

        existing.endpoints = [WILDCARD_SELECTOR]
    else:
        existing.endpoints = existing.endpoints + list(endpoints)

    if to_merge.l7_parser != PARSER_TYPE_NONE:
        if existing.l7_parser == PARSER_TYPE_NONE:
            existing.l7_parser = to_merge.l7_parser
        elif to_merge.l7_parser != existing.l7_parser:
            ctx.policy_trace(
                "   Merge conflict: mismatching parsers %s/%s\n",
                to_merge.l7_parser,
                existing.l7_parser,
            )
            raise PolicyMergeError(
                f"cannot merge conflicting L7 parsers "
                f"({to_merge.l7_parser}/{existing.l7_parser})"
            )

    for sel, new_rules in to_merge.l7_rules_per_ep.items():
        ep = existing.l7_rules_per_ep.get(sel)
        if ep is None:
            existing.l7_rules_per_ep[sel] = new_rules
            continue
        if new_rules.http:
            if ep.kafka or ep.l7proto:
                raise PolicyMergeError("cannot merge conflicting L7 rule types")
            for nr in new_rules.http:
                if not _l7_rule_exists(ep, "http", nr):
                    ep.http.append(nr)
        elif new_rules.kafka:
            if ep.http or ep.l7proto:
                raise PolicyMergeError("cannot merge conflicting L7 rule types")
            for nr in new_rules.kafka:
                if not _l7_rule_exists(ep, "kafka", nr):
                    ep.kafka.append(nr)
        elif new_rules.l7proto:
            if ep.kafka or ep.http or (ep.l7proto and ep.l7proto != new_rules.l7proto):
                raise PolicyMergeError("cannot merge conflicting L7 rule types")
            if not ep.l7proto:
                ep.l7proto = new_rules.l7proto
            for nr in new_rules.l7:
                if not _l7_rule_exists(ep, "l7", nr):
                    ep.l7.append(nr)


def _expand_protocols(pp) -> list[str]:
    if pp.protocol != PROTO_ANY:
        return [pp.protocol]
    return [PROTO_TCP, PROTO_UDP]


class Repository:
    """Global revisioned rule store (reference: repository.go:31)."""

    def __init__(self) -> None:
        self.rules: list[Rule] = []
        self.revision: int = 1
        self.mutex = threading.RLock()

    # -- mutation ----------------------------------------------------------

    def add(self, r: Rule) -> int:
        """Sanitize + insert; returns new revision (reference:
        repository.go:529-542)."""
        r.sanitize()
        with self.mutex:
            return self.add_list([r])

    def add_list(self, rules: list[Rule]) -> int:
        with self.mutex:
            self.rules.extend(rules)
            self.revision += 1
            return self.revision

    def delete_by_labels(self, lbls: LabelArray) -> tuple[int, int]:
        """Delete rules whose labels contain lbls; returns (revision,
        n_deleted) (reference: repository.go:566-588)."""
        with self.mutex:
            kept = [r for r in self.rules if not r.labels.contains(lbls)]
            deleted = len(self.rules) - len(kept)
            if deleted > 0:
                self.rules = kept
                self.revision += 1
            return self.revision, deleted

    def bump_revision(self) -> None:
        with self.mutex:
            self.revision += 1

    # -- introspection -----------------------------------------------------

    def num_rules(self) -> int:
        return len(self.rules)

    def get_revision(self) -> int:
        return self.revision

    def is_empty(self) -> bool:
        return not self.rules

    def search(self, lbls: LabelArray) -> list[Rule]:
        """Rules whose labels contain lbls (reference: repository.go:495)."""
        return [r for r in self.rules if r.labels.contains(lbls)]

    def contains_all(self, needed: list[LabelArray]) -> bool:
        """Every needed label set must contain some rule's (non-empty)
        labels (reference: repository.go:510 ContainsAllRLocked)."""
        return all(
            any(r.labels and n.contains(r.labels) for r in self.rules)
            for n in needed
        )

    def get_rules_matching(self, lbls: LabelArray) -> tuple[bool, bool]:
        """Whether any rule's selector matches lbls with ingress/egress
        sections (reference: repository.go:624)."""
        ingress = egress = False
        for r in self.rules:
            if r.endpoint_selector.matches(lbls):
                if r.ingress:
                    ingress = True
                if r.egress:
                    egress = True
        return ingress, egress

    def get_json(self) -> str:
        from .serialize import rules_to_json

        return rules_to_json(self.rules)

    # -- label-level verdicts ---------------------------------------------

    def _can_reach_ingress(self, ctx: SearchContext) -> Decision:
        """reference: repository.go:80 + rule.go canReachIngress."""
        decision = Decision.UNDECIDED
        state = TraceState()
        for i, r in enumerate(self.rules):
            state.rule_id = i
            d = self._rule_can_reach_ingress(r, ctx, state)
            if d == Decision.DENIED:
                decision = Decision.DENIED
                break
            if d == Decision.ALLOWED:
                decision = Decision.ALLOWED
        state.trace(self, ctx)
        return decision

    def _rule_can_reach_ingress(
        self, r: Rule, ctx: SearchContext, state: TraceState
    ) -> Decision:
        if not r.endpoint_selector.matches(ctx.to_labels):
            return Decision.UNDECIDED
        state.selected_rules += 1
        # FromRequires takes precedence (reference: rule.go:358-379).
        for ing in r.ingress:
            for sel in ing.from_requires:
                if not sel.matches(ctx.from_labels):
                    state.constrained_rules += 1
                    return Decision.DENIED
        for ing in r.ingress:
            for sel in ing.get_source_endpoint_selectors():
                if sel.matches(ctx.from_labels):
                    if not ing.to_ports:
                        state.matched_rules += 1
                        return Decision.ALLOWED
        return Decision.UNDECIDED

    def _can_reach_egress(self, ctx: SearchContext) -> Decision:
        decision = Decision.UNDECIDED
        state = TraceState()
        for i, r in enumerate(self.rules):
            state.rule_id = i
            d = self._rule_can_reach_egress(r, ctx, state)
            if d == Decision.DENIED:
                decision = Decision.DENIED
                break
            if d == Decision.ALLOWED:
                decision = Decision.ALLOWED
        state.trace(self, ctx)
        return decision

    def _rule_can_reach_egress(
        self, r: Rule, ctx: SearchContext, state: TraceState
    ) -> Decision:
        if not r.endpoint_selector.matches(ctx.from_labels):
            return Decision.UNDECIDED
        state.selected_rules += 1
        for eg in r.egress:
            for sel in eg.to_requires:
                if not sel.matches(ctx.to_labels):
                    state.constrained_rules += 1
                    return Decision.DENIED
        for eg in r.egress:
            for sel in eg.get_destination_endpoint_selectors():
                if sel.matches(ctx.to_labels):
                    if not eg.to_ports:
                        state.matched_rules += 1
                        return Decision.ALLOWED
        return Decision.UNDECIDED

    def allows_ingress(self, ctx: SearchContext) -> Decision:
        """Full ingress verdict: labels first, then L4 if ports given
        (reference: repository.go:397-420)."""
        ctx.policy_trace("Tracing %s\n", str(ctx))
        decision = self._can_reach_ingress(ctx)
        ctx.policy_trace("Label verdict: %s\n", str(decision))
        if decision == Decision.ALLOWED:
            return decision
        if ctx.dports:
            l4 = self.resolve_l4_ingress_policy(ctx)
            if len(l4) > 0:
                decision = l4.ingress_covers_context(ctx)
        if decision != Decision.ALLOWED:
            decision = Decision.DENIED
        return decision

    def allows_egress(self, ctx: SearchContext) -> Decision:
        """reference: repository.go:422-446."""
        ctx.policy_trace("Tracing %s\n", str(ctx))
        decision = self._can_reach_egress(ctx)
        ctx.policy_trace("Label verdict: %s\n", str(decision))
        if decision == Decision.ALLOWED:
            return decision
        if ctx.dports:
            l4 = self.resolve_l4_egress_policy(ctx)
            if len(l4) > 0:
                decision = l4.egress_covers_context(ctx)
        if decision != Decision.ALLOWED:
            decision = Decision.DENIED
        return decision

    # -- L4 resolution -----------------------------------------------------

    def resolve_l4_ingress_policy(
        self,
        ctx: SearchContext,
        endpoints_with_l3_override: list[EndpointSelector] | None = None,
    ) -> L4PolicyMap:
        """reference: repository.go:245-283."""
        result = L4PolicyMap()
        ctx.policy_trace("Resolving ingress port policy\n")
        state = TraceState()

        # Flatten all FromRequires of rules selecting ctx.to into selector
        # requirements folded into every FromEndpoints (repository.go:252-267).
        requirements: list[SelectorRequirement] = []
        for r in self.rules:
            if r.endpoint_selector.matches(ctx.to_labels):
                for ing in r.ingress:
                    for req_sel in ing.from_requires:
                        requirements.extend(req_sel.to_requirements())

        for i, r in enumerate(self.rules):
            state.rule_id = i
            self._resolve_rule_l4_ingress(
                r, ctx, state, result, requirements,
                endpoints_with_l3_override or [],
            )

        self._wildcard_l3_l4_rules(ctx, True, result)
        state.trace(self, ctx)
        return result

    def _resolve_rule_l4_ingress(
        self,
        r: Rule,
        ctx: SearchContext,
        state: TraceState,
        res_map: L4PolicyMap,
        requirements: list[SelectorRequirement],
        endpoints_with_l3_override: list[EndpointSelector],
    ) -> None:
        if not r.endpoint_selector.matches(ctx.to_labels):
            return
        state.selected_rules += 1
        found = 0
        for ing in r.ingress:
            if not ing.to_ports:
                continue
            from_eps = [
                sel.with_requirements(requirements)
                for sel in ing.get_source_endpoint_selectors()
            ]
            # From-label filter when ctx.From given (reference: rule.go:156-161).
            if ctx.from_labels and from_eps:
                if not any(sel.matches(ctx.from_labels) for sel in from_eps):
                    continue
            for pr in ing.to_ports:
                for pp in pr.ports:
                    for proto in _expand_protocols(pp):
                        key = f"{int(pp.port, 0)}/{proto}"
                        new_f = create_l4_ingress_filter(
                            from_eps, endpoints_with_l3_override, pr, pp, proto,
                            r.labels,
                        )
                        existing = res_map.get(key)
                        if existing is None:
                            res_map[key] = new_f
                        else:
                            _merge_l4_port(ctx, from_eps, existing, new_f)
                            existing.derived_from_rules.append(r.labels)
                        found += 1
        if found:
            state.matched_rules += 1

    def resolve_l4_egress_policy(self, ctx: SearchContext) -> L4PolicyMap:
        """reference: repository.go:291-333."""
        result = L4PolicyMap()
        ctx.policy_trace("Resolving egress port policy\n")
        state = TraceState()

        requirements: list[SelectorRequirement] = []
        for r in self.rules:
            if r.endpoint_selector.matches(ctx.from_labels):
                for eg in r.egress:
                    for req_sel in eg.to_requires:
                        requirements.extend(req_sel.to_requirements())

        for i, r in enumerate(self.rules):
            state.rule_id = i
            self._resolve_rule_l4_egress(r, ctx, state, result, requirements)

        self._wildcard_l3_l4_rules(ctx, False, result)
        state.trace(self, ctx)
        return result

    def _resolve_rule_l4_egress(
        self,
        r: Rule,
        ctx: SearchContext,
        state: TraceState,
        res_map: L4PolicyMap,
        requirements: list[SelectorRequirement],
    ) -> None:
        if not r.endpoint_selector.matches(ctx.from_labels):
            return
        state.selected_rules += 1
        found = 0
        for eg in r.egress:
            if not eg.to_ports:
                continue
            to_eps = [
                sel.with_requirements(requirements)
                for sel in eg.get_destination_endpoint_selectors()
            ]
            if ctx.to_labels and to_eps:
                if not any(sel.matches(ctx.to_labels) for sel in to_eps):
                    continue
            for pr in eg.to_ports:
                for pp in pr.ports:
                    for proto in _expand_protocols(pp):
                        key = f"{int(pp.port, 0)}/{proto}"
                        new_f = create_l4_egress_filter(
                            to_eps, pr, pp, proto, r.labels
                        )
                        existing = res_map.get(key)
                        if existing is None:
                            res_map[key] = new_f
                        else:
                            _merge_l4_port(ctx, to_eps, existing, new_f)
                            existing.derived_from_rules.append(r.labels)
                        found += 1
        if found:
            state.matched_rules += 1

    # -- wildcard L3/L4 -> L7 (reference: repository.go:128-243) -----------

    def _wildcard_l3_l4_rules(
        self, ctx: SearchContext, ingress: bool, l4_policy: L4PolicyMap
    ) -> None:
        """Rules allowing traffic at L3-only or L3/L4-only wildcard the L7
        rules of any redirect filter on the same port, so broader allows are
        not narrowed by another rule's L7 restrictions."""
        for r in self.rules:
            if ingress:
                if not r.endpoint_selector.matches(ctx.to_labels):
                    continue
                sections = r.ingress
            else:
                if not r.endpoint_selector.matches(ctx.from_labels):
                    continue
                sections = r.egress
            for section in sections:
                if not section.is_label_based():
                    continue
                endpoints = (
                    section.get_source_endpoint_selectors()
                    if ingress
                    else section.get_destination_endpoint_selectors()
                )
                if not section.to_ports:
                    # L3-only rule wildcard-matches every port.
                    _wildcard_l3_l4_rule(PROTO_TCP, 0, endpoints, r.labels, l4_policy)
                    _wildcard_l3_l4_rule(PROTO_UDP, 0, endpoints, r.labels, l4_policy)
                else:
                    for pr in section.to_ports:
                        if pr.rules is None or pr.rules.is_empty():
                            for pp in pr.ports:
                                port = int(pp.port, 0)
                                _wildcard_l3_l4_rule(
                                    pp.protocol, port, endpoints, r.labels, l4_policy
                                )

    # -- CIDR resolution ---------------------------------------------------

    def resolve_cidr_policy(self, ctx: SearchContext) -> CIDRPolicy:
        """reference: repository.go:340 + rule.go resolveCIDRPolicy."""
        from .api import compute_resultant_cidr_set

        result = CIDRPolicy()
        ctx.policy_trace("Resolving L3 (CIDR) policy\n")
        for r in self.rules:
            if not r.endpoint_selector.matches(ctx.to_labels):
                continue
            for ing in r.ingress:
                all_cidrs = list(ing.from_cidr) + compute_resultant_cidr_set(
                    ing.from_cidr_set
                )
                # CIDR+L4 ingress handled by mergeL4Ingress (rule.go:315-318).
                if all_cidrs and ing.to_ports:
                    continue
                for c in all_cidrs:
                    result.ingress.insert(c, r.labels)
            for eg in r.egress:
                all_cidrs = list(eg.to_cidr) + compute_resultant_cidr_set(
                    eg.to_cidr_set
                )
                # Egress counts CIDR+L4 too, for prefix-length computation
                # (rule.go:330-340).
                for c in all_cidrs:
                    result.egress.insert(c, r.labels)
        return result


def _wildcard_l3_l4_rule(
    proto: str,
    port: int,
    endpoints: list[EndpointSelector],
    rule_labels: LabelArray,
    l4_policy: L4PolicyMap,
) -> None:
    """reference: repository.go:128-167."""
    for key, f in l4_policy.items():
        if proto != f.protocol or (port != 0 and port != f.port):
            continue
        if f.l7_parser == PARSER_TYPE_NONE:
            continue
        if f.l7_parser == PARSER_TYPE_HTTP:
            for sel in endpoints:
                f.l7_rules_per_ep[sel] = L7Rules(http=[PortRuleHTTP()])
        elif f.l7_parser == PARSER_TYPE_KAFKA:
            for sel in endpoints:
                rule = PortRuleKafka()
                rule.sanitize()
                f.l7_rules_per_ep[sel] = L7Rules(kafka=[rule])
        else:
            for sel in endpoints:
                f.l7_rules_per_ep[sel] = L7Rules(l7proto=f.l7_parser, l7=[])
        f.endpoints = f.endpoints + list(endpoints)
        f.derived_from_rules.append(rule_labels)
