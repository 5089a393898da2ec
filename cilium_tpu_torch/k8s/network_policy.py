"""k8s NetworkPolicy v1 -> api.Rule translation.

reference: pkg/k8s/network_policy.go ParseNetworkPolicy — including the
namespace scoping rules (PodSelector is namespace-local; an empty
NamespaceSelector means "any namespace"), the ipBlock -> CIDRRule
mapping, and the k8s default-deny conversion (a policy with no ingress
rules and ingress policyTypes produces one empty IngressRule).

Policies arrive as plain dicts (parsed JSON/YAML) — there is no k8s
client dependency; the fake apiserver serves the same dict shapes.
"""

from __future__ import annotations

from ..labels import LabelArray, parse_label
from ..policy.api import (
    CIDRRule,
    EndpointSelector,
    IngressRule,
    EgressRule,
    PortProtocol,
    PortRule,
    Rule,
    SelectorRequirement,
)

# reference: pkg/k8s/apis/cilium.io/const.go
POD_NAMESPACE_LABEL = "io.kubernetes.pod.namespace"
POD_NAMESPACE_META_LABELS = "io.cilium.k8s.namespace.labels"
POLICY_LABEL_NAME = "io.cilium.k8s.policy.name"
POLICY_LABEL_NAMESPACE = "io.cilium.k8s.policy.namespace"
POLICY_LABEL_DERIVED_FROM = "io.cilium.k8s.policy.derived-from"

# reference: pkg/annotation (annotation.Name)
ANNOTATION_NAME = "io.cilium.name"

K8S_PREFIX = "k8s:"


def policy_labels(ns: str, name: str, derived_from: str) -> LabelArray:
    """reference: cilium.io/utils GetPolicyLabels."""
    return LabelArray([
        parse_label(f"k8s:{POLICY_LABEL_NAME}={name}"),
        parse_label(f"k8s:{POLICY_LABEL_NAMESPACE}={ns}"),
        parse_label(f"k8s:{POLICY_LABEL_DERIVED_FROM}={derived_from}"),
    ])


def extract_namespace(meta: dict) -> str:
    """reference: pkg/k8s/utils ExtractNamespace (default namespace)."""
    return meta.get("namespace") or "default"


def _k8s_prefix_key(key: str) -> str:
    """Prefix a bare selector key with the k8s source unless it already
    carries a source (reference: NewESFromK8sLabelSelector with
    LabelSourceK8sKeyPrefix; existing source prefixes are kept)."""
    if ":" in key or key.startswith("k8s."):
        return key
    return K8S_PREFIX + key


def selector_from_k8s(sel: dict | None, extra_labels: dict | None = None) -> EndpointSelector:
    """k8s LabelSelector dict -> EndpointSelector with k8s-source keys."""
    sel = sel or {}
    ml = {
        _k8s_prefix_key(k): v for k, v in (sel.get("matchLabels") or {}).items()
    }
    for k, v in (extra_labels or {}).items():
        ml[_k8s_prefix_key(k)] = v
    me = [
        SelectorRequirement(
            key=_k8s_prefix_key(e["key"]),
            operator=e["operator"],
            values=tuple(e.get("values", ())),
        )
        for e in sel.get("matchExpressions") or []
    ]
    return EndpointSelector.from_dict(ml, me)


def _parse_peer(namespace: str, peer: dict) -> EndpointSelector | None:
    """reference: network_policy.go parseNetworkPolicyPeer."""
    ns_sel = peer.get("namespaceSelector")
    pod_sel = peer.get("podSelector")
    if ns_sel is not None:
        ml = {
            f"{POD_NAMESPACE_META_LABELS}.{k}": v
            for k, v in (ns_sel.get("matchLabels") or {}).items()
        }
        me = [
            SelectorRequirement(
                key=_k8s_prefix_key(f"{POD_NAMESPACE_META_LABELS}.{e['key']}"),
                operator=e["operator"],
                values=tuple(e.get("values", ())),
            )
            for e in ns_sel.get("matchExpressions") or []
        ]
        if not ml and not me:
            # Empty namespace selector selects ALL namespaces (the
            # namespace label merely exists).
            me = [
                SelectorRequirement(
                    key=_k8s_prefix_key(POD_NAMESPACE_LABEL),
                    operator="Exists",
                )
            ]
        combined = dict((_k8s_prefix_key(k), v) for k, v in ml.items())
        # Pod selector terms AND with the namespace terms.
        for k, v in ((pod_sel or {}).get("matchLabels") or {}).items():
            combined[_k8s_prefix_key(k)] = v
        me += [
            SelectorRequirement(
                key=_k8s_prefix_key(e["key"]),
                operator=e["operator"],
                values=tuple(e.get("values", ())),
            )
            for e in (pod_sel or {}).get("matchExpressions") or []
        ]
        return EndpointSelector.from_dict(combined, me)
    if pod_sel is not None:
        # Namespace-local pod selector.
        return selector_from_k8s(
            pod_sel, extra_labels={POD_NAMESPACE_LABEL: namespace}
        )
    return None


def _ip_block_to_cidr_rule(block: dict) -> CIDRRule:
    return CIDRRule(
        cidr=block["cidr"],
        except_cidrs=list(block.get("except", ())),
    )


def np_policy_name(np: dict) -> str:
    """The policy name used for derived labels: the io.cilium.name
    annotation wins over metadata.name (reference: GetPolicyLabelsv1)."""
    meta = np.get("metadata") or {}
    return (meta.get("annotations") or {}).get(ANNOTATION_NAME) or meta.get(
        "name", ""
    )


def _parse_ports(ports: list[dict]) -> list[PortRule]:
    """reference: network_policy.go parsePorts.  Protocol-only and named
    ports translate to an empty/non-numeric Port string, which
    Rule.Sanitize rejects — EXACTLY as the reference does (its
    PortProtocol.sanitize ParseUints the string), so such policies fail
    import in both implementations."""
    out = []
    for p in ports:
        if p.get("protocol") is None and p.get("port") is None:
            continue
        proto = (p.get("protocol") or "TCP").upper()
        port = str(p.get("port") or "")
        out.append(
            PortRule(ports=[PortProtocol(port=port, protocol=proto)])
        )
    return out


def _wildcard_selector() -> EndpointSelector:
    """reserved:all — matches every source (reference: NewESFromLabels
    with the reserved all label)."""
    return EndpointSelector.from_dict({"reserved:all": ""})


def parse_network_policy(np: dict) -> list[Rule]:
    """k8s NetworkPolicy v1 (dict form) -> sanitized api.Rules.

    reference: pkg/k8s/network_policy.go:123 ParseNetworkPolicy.
    """
    meta = np.get("metadata") or {}
    spec = np.get("spec") or {}
    namespace = extract_namespace(meta)
    name = np_policy_name(np)
    policy_types = spec.get("policyTypes") or []

    ingresses: list[IngressRule] = []
    for i_rule in spec.get("ingress") or []:
        ing = IngressRule()
        if i_rule.get("ports"):
            ing.to_ports = _parse_ports(i_rule["ports"])
        froms = i_rule.get("from") or []
        if froms:
            for peer in froms:
                sel = _parse_peer(namespace, peer)
                if sel is not None:
                    ing.from_endpoints.append(sel)
                if peer.get("ipBlock"):
                    ing.from_cidr_set.append(
                        _ip_block_to_cidr_rule(peer["ipBlock"])
                    )
        else:
            # Empty/missing From matches all sources.
            ing.from_endpoints.append(_wildcard_selector())
        ingresses.append(ing)

    egresses: list[EgressRule] = []
    for e_rule in spec.get("egress") or []:
        eg = EgressRule()
        tos = e_rule.get("to") or []
        if tos:
            for peer in tos:
                if peer.get("namespaceSelector") is not None or peer.get(
                    "podSelector"
                ) is not None:
                    sel = _parse_peer(namespace, peer)
                    if sel is not None:
                        eg.to_endpoints.append(sel)
                if peer.get("ipBlock"):
                    eg.to_cidr_set.append(
                        _ip_block_to_cidr_rule(peer["ipBlock"])
                    )
        else:
            eg.to_endpoints.append(_wildcard_selector())
        if e_rule.get("ports"):
            eg.to_ports = _parse_ports(e_rule["ports"])
        egresses.append(eg)

    # k8s default-deny -> cilium default-deny: no ingress rules + an
    # ingress policyType (or no explicit egress type) yields one empty
    # (deny-by-selection) ingress rule.
    if not ingresses and (
        "Ingress" in policy_types or "Egress" not in policy_types
    ):
        ingresses = [IngressRule()]
    if not egresses and "Egress" in policy_types:
        egresses = [EgressRule()]

    rule = Rule(
        endpoint_selector=selector_from_k8s(
            spec.get("podSelector"),
            extra_labels={POD_NAMESPACE_LABEL: namespace},
        ),
        ingress=ingresses,
        egress=egresses,
        labels=policy_labels(namespace, name, "NetworkPolicy"),
    )
    rule.sanitize()
    return [rule]
