"""JSON (de)serialization of policy rules.

The wire format matches the reference's JSON rule schema (reference:
pkg/policy/api JSON tags, e.g. examples/policies/*.json), so existing policy
documents written for the reference import unchanged.
"""

from __future__ import annotations

import json
from typing import Any

from ..labels import SOURCE_UNSPEC, Label, LabelArray, get_cilium_key_from, parse_label
from .api import (
    CIDRRule,
    EgressRule,
    EndpointSelector,
    FQDNSelector,
    IngressRule,
    L7Rules,
    OP_DOES_NOT_EXIST,
    OP_EXISTS,
    OP_IN,
    OP_NOT_IN,
    PortProtocol,
    PortRule,
    PortRuleHTTP,
    PortRuleKafka,
    PortRuleL7,
    Rule,
    SelectorRequirement,
    Service,
)


def selector_from_dict(d: dict) -> EndpointSelector:
    reqs = [
        SelectorRequirement(
            key=e["key"],
            operator=e["operator"],
            values=tuple(e.get("values", ())),
        )
        for e in d.get("matchExpressions", [])
    ]
    return EndpointSelector.from_dict(d.get("matchLabels", {}), reqs)


def selector_to_dict(s: EndpointSelector) -> dict:
    # Emit keys in cilium "source:key" form so re-parsing re-extends them
    # (reference: selector.go MarshalJSON via GetCiliumKeyFrom).
    out: dict[str, Any] = {}
    if s.match_labels:
        out["matchLabels"] = {get_cilium_key_from(k): v for k, v in s.match_labels}
    if s.match_expressions:
        out["matchExpressions"] = [
            {"key": get_cilium_key_from(r.key), "operator": r.operator,
             **({"values": list(r.values)} if r.values else {})}
            for r in s.match_expressions
        ]
    return out


def _port_rule_from_dict(d: dict) -> PortRule:
    rules = None
    rd = d.get("rules")
    if rd:
        rules = L7Rules(
            http=[
                PortRuleHTTP(
                    path=h.get("path", ""),
                    method=h.get("method", ""),
                    host=h.get("host", ""),
                    headers=tuple(h.get("headers", ())),
                )
                for h in rd.get("http", [])
            ],
            kafka=[
                PortRuleKafka(
                    role=k.get("role", ""),
                    api_key=k.get("apiKey", ""),
                    api_version=k.get("apiVersion", ""),
                    client_id=k.get("clientID", ""),
                    topic=k.get("topic", ""),
                )
                for k in rd.get("kafka", [])
            ],
            l7proto=rd.get("l7proto", ""),
            l7=[PortRuleL7(e) for e in rd.get("l7", [])],
        )
    return PortRule(
        ports=[
            PortProtocol(port=p["port"], protocol=p.get("protocol", ""))
            for p in d.get("ports", [])
        ],
        rules=rules,
    )


def _port_rule_to_dict(pr: PortRule) -> dict:
    out: dict[str, Any] = {
        "ports": [
            {"port": p.port, **({"protocol": p.protocol} if p.protocol else {})}
            for p in pr.ports
        ]
    }
    if pr.rules is not None:
        rd: dict[str, Any] = {}
        if pr.rules.http:
            rd["http"] = [
                {
                    **({"path": h.path} if h.path else {}),
                    **({"method": h.method} if h.method else {}),
                    **({"host": h.host} if h.host else {}),
                    **({"headers": list(h.headers)} if h.headers else {}),
                }
                for h in pr.rules.http
            ]
        if pr.rules.kafka:
            rd["kafka"] = [
                {
                    **({"role": k.role} if k.role else {}),
                    **({"apiKey": k.api_key} if k.api_key else {}),
                    **({"apiVersion": k.api_version} if k.api_version else {}),
                    **({"clientID": k.client_id} if k.client_id else {}),
                    **({"topic": k.topic} if k.topic else {}),
                }
                for k in pr.rules.kafka
            ]
        if pr.rules.l7proto:
            rd["l7proto"] = pr.rules.l7proto
            rd["l7"] = [dict(e) for e in pr.rules.l7]
        out["rules"] = rd
    return out


def _cidr_rule_from(d) -> CIDRRule:
    if isinstance(d, str):
        return CIDRRule(cidr=d)
    return CIDRRule(cidr=d["cidr"], except_cidrs=tuple(d.get("except", ())))


def rule_from_dict(d: dict) -> Rule:
    ingress = [
        IngressRule(
            from_endpoints=[
                selector_from_dict(s) for s in i.get("fromEndpoints", [])
            ],
            from_requires=[
                selector_from_dict(s) for s in i.get("fromRequires", [])
            ],
            to_ports=[_port_rule_from_dict(p) for p in i.get("toPorts", [])],
            from_cidr=list(i.get("fromCIDR", [])),
            from_cidr_set=[_cidr_rule_from(c) for c in i.get("fromCIDRSet", [])],
            from_entities=list(i.get("fromEntities", [])),
        )
        for i in d.get("ingress", [])
    ]
    egress = [
        EgressRule(
            to_endpoints=[selector_from_dict(s) for s in e.get("toEndpoints", [])],
            to_requires=[selector_from_dict(s) for s in e.get("toRequires", [])],
            to_ports=[_port_rule_from_dict(p) for p in e.get("toPorts", [])],
            to_cidr=list(e.get("toCIDR", [])),
            to_cidr_set=[_cidr_rule_from(c) for c in e.get("toCIDRSet", [])],
            to_entities=list(e.get("toEntities", [])),
            to_services=[
                Service(
                    k8s_service_name=s.get("k8sService", {}).get("serviceName", ""),
                    k8s_service_namespace=s.get("k8sService", {}).get("namespace", ""),
                )
                for s in e.get("toServices", [])
            ],
            to_fqdns=[
                FQDNSelector(match_name=f.get("matchName", ""))
                for f in e.get("toFQDNs", [])
            ],
        )
        for e in d.get("egress", [])
    ]
    return Rule(
        endpoint_selector=selector_from_dict(d.get("endpointSelector", {})),
        ingress=ingress,
        egress=egress,
        labels=LabelArray(_label_from(s) for s in d.get("labels", [])),
        description=d.get("description", ""),
    )


def _label_from(v) -> Label:
    """Labels appear either as ``source:key=value`` strings or as the
    reference's Label object form {key, value, source} (the format the
    examples/policies corpus uses)."""
    if isinstance(v, str):
        return parse_label(v)
    return Label(
        key=v.get("key") or "",
        value=v.get("value") or "",
        source=v.get("source") or SOURCE_UNSPEC,
    )


def rules_from_json(text: str) -> list[Rule]:
    data = json.loads(text)
    if isinstance(data, dict):
        data = [data]
    return [rule_from_dict(d) for d in data]


def rule_to_dict(r: Rule) -> dict:
    out: dict[str, Any] = {
        "endpointSelector": selector_to_dict(r.endpoint_selector)
    }
    if r.ingress:
        out["ingress"] = []
        for i in r.ingress:
            d: dict[str, Any] = {}
            if i.from_endpoints:
                d["fromEndpoints"] = [selector_to_dict(s) for s in i.from_endpoints]
            if i.from_requires:
                d["fromRequires"] = [selector_to_dict(s) for s in i.from_requires]
            if i.to_ports:
                d["toPorts"] = [_port_rule_to_dict(p) for p in i.to_ports]
            if i.from_cidr:
                d["fromCIDR"] = list(i.from_cidr)
            if i.from_cidr_set:
                d["fromCIDRSet"] = [
                    {"cidr": c.cidr,
                     **({"except": list(c.except_cidrs)} if c.except_cidrs else {})}
                    for c in i.from_cidr_set
                ]
            if i.from_entities:
                d["fromEntities"] = list(i.from_entities)
            out["ingress"].append(d)
    if r.egress:
        out["egress"] = []
        for e in r.egress:
            d = {}
            if e.to_endpoints:
                d["toEndpoints"] = [selector_to_dict(s) for s in e.to_endpoints]
            if e.to_requires:
                d["toRequires"] = [selector_to_dict(s) for s in e.to_requires]
            if e.to_ports:
                d["toPorts"] = [_port_rule_to_dict(p) for p in e.to_ports]
            if e.to_cidr:
                d["toCIDR"] = list(e.to_cidr)
            if e.to_cidr_set:
                d["toCIDRSet"] = [
                    {"cidr": c.cidr,
                     **({"except": list(c.except_cidrs)} if c.except_cidrs else {})}
                    for c in e.to_cidr_set
                ]
            if e.to_entities:
                d["toEntities"] = list(e.to_entities)
            if e.to_services:
                d["toServices"] = [
                    {"k8sService": {
                        **({"serviceName": s.k8s_service_name}
                           if s.k8s_service_name else {}),
                        **({"namespace": s.k8s_service_namespace}
                           if s.k8s_service_namespace else {}),
                    }}
                    for s in e.to_services
                ]
            if e.to_fqdns:
                d["toFQDNs"] = [{"matchName": f.match_name} for f in e.to_fqdns]
            out["egress"].append(d)
    if r.labels:
        out["labels"] = [str(l) for l in r.labels]
    if r.description:
        out["description"] = r.description
    return out


def rules_to_json(rules: list[Rule]) -> str:
    return json.dumps([rule_to_dict(r) for r in rules], indent=2)
