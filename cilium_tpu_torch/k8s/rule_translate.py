"""ToServices -> ToCIDRSet translation driven by k8s service endpoints.

reference: pkg/k8s/rule_translate.go RuleTranslator — when a service's
endpoints change, every egress rule whose ``toServices`` names (or
label-selects) the service gets GENERATED single-address ToCIDRSet
entries for the backend IPs; a revert pass removes the generated
entries for backends that disappeared.
"""

from __future__ import annotations

import ipaddress
from dataclasses import dataclass, field

from ..policy.api import CIDRRule, EgressRule, Rule, Service


@dataclass
class TranslationResult:
    num_to_services_rules: int = 0
    added_cidrs: list[str] = field(default_factory=list)
    removed_cidrs: list[str] = field(default_factory=list)


def _service_matches(
    svc: Service, name: str, namespace: str, service_labels: dict
) -> bool:
    """reference: rule_translate.go serviceMatches."""
    if svc.k8s_service_selector is not None:
        from ..labels import LabelArray, parse_label

        lbls = LabelArray(
            parse_label(f"{k}={v}") for k, v in (service_labels or {}).items()
        )
        return svc.k8s_service_selector.matches(lbls) and (
            svc.k8s_service_namespace in ("", namespace)
        )
    if svc.k8s_service_name:
        return svc.k8s_service_name == name and (
            svc.k8s_service_namespace in ("", namespace)
        )
    return False


def _host_cidr(ip: str) -> str:
    addr = ipaddress.ip_address(ip)
    return f"{addr}/{32 if addr.version == 4 else 128}"


def _populate(egress: EgressRule, backend_ips: list[str], result: TranslationResult) -> None:
    """reference: rule_translate.go generateToCidrFromEndpoint."""
    for ip in backend_ips:
        addr = ipaddress.ip_address(ip)
        covered = any(
            addr in ipaddress.ip_network(c.cidr, strict=False)
            for c in egress.to_cidr_set
        )
        if not covered:
            cidr = _host_cidr(ip)
            egress.to_cidr_set.append(CIDRRule(cidr=cidr, generated=True))
            result.added_cidrs.append(cidr)


def _depopulate(egress: EgressRule, backend_ips: list[str], result: TranslationResult) -> None:
    """Remove GENERATED entries matching the endpoint's backends
    (reference: rule_translate.go deleteToCidrFromEndpoint)."""
    targets = {str(ipaddress.ip_network(_host_cidr(ip))) for ip in backend_ips}
    kept = []
    for c in egress.to_cidr_set:
        key = str(ipaddress.ip_network(c.cidr, strict=False))
        if c.generated and key in targets:
            result.removed_cidrs.append(c.cidr)
        else:
            kept.append(c)
    egress.to_cidr_set = kept


def translate_to_services(
    rules: list[Rule],
    service_name: str,
    service_namespace: str,
    backend_ips: list[str],
    service_labels: dict | None = None,
    revert: bool = False,
) -> TranslationResult:
    """Populate (or revert) generated ToCIDRSet entries on every egress
    rule whose toServices matches the service.  Mirrors the reference's
    Translate over all rules' egress sections; the caller bumps the
    policy revision / triggers regeneration afterwards
    (reference: pkg/policy/repository.go:674 TranslateRules)."""
    result = TranslationResult()
    for rule in rules:
        for egress in rule.egress:
            for svc in egress.to_services:
                result.num_to_services_rules += 1
                if _service_matches(
                    svc, service_name, service_namespace, service_labels or {}
                ):
                    _depopulate(egress, backend_ips, result)
                    if not revert:
                        _populate(egress, backend_ips, result)
    return result
