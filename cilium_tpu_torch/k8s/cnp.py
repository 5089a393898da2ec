"""CiliumNetworkPolicy v2 (CRD) -> api.Rule translation.

reference: pkg/k8s/apis/cilium.io/utils/utils.go ParseToCiliumRule +
pkg/k8s/apis/cilium.io/v2 (the CNP type embeds one ``spec`` or many
``specs`` of api.Rule JSON).  Namespace scoping: the endpointSelector
and every FromEndpoints/ToEndpoints selector are constrained to the
CNP's namespace unless the selector names a namespace itself (or the
rule matches initializing pods, which carry no namespace label);
FromRequires/ToRequires get no k8s prefixing.
"""

from __future__ import annotations

from dataclasses import replace

from ..policy.api import EndpointSelector, PolicyValidationError, Rule
from ..policy.serialize import rule_from_dict
from .network_policy import (
    POD_NAMESPACE_LABEL,
    extract_namespace,
    policy_labels,
)

_POD_PREFIX_KEY = "k8s." + POD_NAMESPACE_LABEL
_ANY_POD_PREFIX_KEY = "any." + POD_NAMESPACE_LABEL
_INIT_KEY = "reserved.init"


def _scope_selector(sel: EndpointSelector, namespace: str, matches_init: bool) -> EndpointSelector:
    """Add the namespace constraint unless the selector already has one,
    names reserved labels, or matches initializing pods
    (reference: utils.go getEndpointSelector)."""
    if sel.has_key_prefix("reserved."):
        return sel
    if matches_init:
        return sel
    if sel.has_key(_POD_PREFIX_KEY) or sel.has_key(_ANY_POD_PREFIX_KEY):
        return sel
    return replace(
        sel,
        match_labels=tuple(
            sorted(sel.match_labels + ((_POD_PREFIX_KEY, namespace),))
        ),
    )


def _namespaces_are_valid(namespace: str, sel: EndpointSelector) -> bool:
    """A user-specified namespace must match the CNP's own namespace
    (reference: utils.go namespacesAreValid)."""
    for key in (_POD_PREFIX_KEY, _ANY_POD_PREFIX_KEY):
        for k, v in sel.match_labels:
            if k == key and v != namespace:
                return False
    return True


def _parse_one(namespace: str, name: str, spec: dict) -> Rule:
    rule = rule_from_dict(spec)
    if rule.endpoint_selector is None:
        raise PolicyValidationError("CNP rule without endpointSelector")
    matches_init = rule.endpoint_selector.has_key(_INIT_KEY)
    if not _namespaces_are_valid(namespace, rule.endpoint_selector):
        raise PolicyValidationError(
            f"CNP rule selects a namespace other than its own ({namespace})"
        )
    rule.endpoint_selector = _scope_selector(
        rule.endpoint_selector, namespace, matches_init
    )
    for ing in rule.ingress:
        ing.from_endpoints = [
            _scope_selector(s, namespace, matches_init)
            for s in ing.from_endpoints
        ]
    for eg in rule.egress:
        eg.to_endpoints = [
            _scope_selector(s, namespace, matches_init)
            for s in eg.to_endpoints
        ]
    rule.labels = policy_labels(namespace, name, "CiliumNetworkPolicy")
    rule.sanitize()
    return rule


def parse_cnp(cnp: dict) -> list[Rule]:
    """CiliumNetworkPolicy dict -> sanitized api.Rules.

    reference: pkg/k8s/apis/cilium.io/v2 CiliumNetworkPolicy.Parse:
    exactly one of ``spec`` / ``specs``.
    """
    meta = cnp.get("metadata") or {}
    namespace = extract_namespace(meta)
    name = meta.get("name", "")
    if not name:
        raise PolicyValidationError("CNP has no name")
    spec = cnp.get("spec")
    specs = cnp.get("specs")
    if spec and specs:
        raise PolicyValidationError("CNP has both spec and specs")
    if not spec and not specs:
        raise PolicyValidationError("CNP has neither spec nor specs")
    out = []
    for s in [spec] if spec else list(specs):
        out.append(_parse_one(namespace, name, s))
    return out
