"""Policy engine: rule AST, revisioned repository, L4/L7/CIDR resolution.

The port's copy of ``cilium_tpu/policy`` (reference: pkg/policy +
pkg/policy/api): declarative label/identity rules compiled into (a) packed
L4 policy-map entries (cilium_tpu_torch.maps.policymap), and (b) the L7
rule tables of ``cilium_tpu_torch.models`` (``models.builder``) evaluated
in batch on the card.  ``invariance`` holds the r2d2 and HTTP halves of
the reference's verdict-invariance claims.
"""

from .api import (
    CIDRRule,
    EgressRule,
    EndpointSelector,
    FQDNSelector,
    IngressRule,
    L7Rules,
    PROTO_ANY,
    PROTO_TCP,
    PROTO_UDP,
    PolicyValidationError,
    PortProtocol,
    PortRule,
    PortRuleHTTP,
    PortRuleKafka,
    PortRuleL7,
    Rule,
    SelectorRequirement,
    Service,
    WILDCARD_SELECTOR,
    init_entities,
)
from .config import (
    ALWAYS_ENFORCE,
    DEFAULT_ENFORCEMENT,
    NEVER_ENFORCE,
    get_policy_enabled,
    set_policy_enabled,
)
from .l3 import CIDRPolicy, CIDRPolicyMap, get_default_prefix_lengths
from .l4 import (
    L4Filter,
    L4Policy,
    L4PolicyMap,
    L7DataMap,
    PARSER_TYPE_HTTP,
    PARSER_TYPE_KAFKA,
    PARSER_TYPE_NONE,
)
from .proxyid import parse_proxy_id, proxy_id
from .repository import PolicyMergeError, Repository, TraceState
from .search import Decision, DPort, SearchContext, Tracing
from .serialize import rule_from_dict, rules_from_json, rules_to_json

__all__ = [
    "ALWAYS_ENFORCE",
    "CIDRPolicy",
    "CIDRPolicyMap",
    "CIDRRule",
    "DEFAULT_ENFORCEMENT",
    "DPort",
    "Decision",
    "EgressRule",
    "EndpointSelector",
    "FQDNSelector",
    "IngressRule",
    "L4Filter",
    "L4Policy",
    "L4PolicyMap",
    "L7DataMap",
    "L7Rules",
    "NEVER_ENFORCE",
    "PARSER_TYPE_HTTP",
    "PARSER_TYPE_KAFKA",
    "PARSER_TYPE_NONE",
    "PROTO_ANY",
    "PROTO_TCP",
    "PROTO_UDP",
    "PolicyMergeError",
    "PolicyValidationError",
    "PortProtocol",
    "PortRule",
    "PortRuleHTTP",
    "PortRuleKafka",
    "PortRuleL7",
    "Repository",
    "Rule",
    "SearchContext",
    "SelectorRequirement",
    "Service",
    "TraceState",
    "Tracing",
    "WILDCARD_SELECTOR",
    "get_default_prefix_lengths",
    "get_policy_enabled",
    "init_entities",
    "parse_proxy_id",
    "proxy_id",
    "rule_from_dict",
    "rules_from_json",
    "rules_to_json",
    "set_policy_enabled",
]
