"""Policy rule AST — the declarative policy language.

Mirrors the reference's rule model (reference: pkg/policy/api/{rule,ingress,
egress,l4,l7,http,kafka,selector,entity,cidr}.go): a Rule selects endpoints
via an EndpointSelector and carries ingress/egress sections whose members
(L3 selectors, L4 ports, L7 rules) must all match.  ``sanitize`` validates
and normalizes in place, as the reference's Rule.Sanitize does.
"""

from __future__ import annotations

import ipaddress
import re
from dataclasses import dataclass, field, replace
from typing import Iterable, Optional

from ..labels import (
    ID_NAME_ALL,
    ID_NAME_HOST,
    ID_NAME_INIT,
    ID_NAME_UNMANAGED,
    ID_NAME_WORLD,
    SOURCE_ANY,
    SOURCE_CILIUM_GENERATED,
    SOURCE_K8S,
    SOURCE_RESERVED,
    Label,
    LabelArray,
    PATH_DELIMITER,
    get_extended_key_from,
)
from ..labels.cidr import ip_string_to_label

# ---------------------------------------------------------------------------
# L4 protocol

PROTO_TCP = "TCP"
PROTO_UDP = "UDP"
PROTO_ANY = "ANY"

_PROTO_NUM = {PROTO_TCP: 6, PROTO_UDP: 17, PROTO_ANY: 0, "": 0}


class PolicyValidationError(ValueError):
    """Raised by sanitize on an invalid rule (reference: rule_validation.go)."""


def parse_l4_proto(proto: str) -> str:
    if proto == "":
        return PROTO_ANY
    p = proto.upper()
    if p in (PROTO_TCP, PROTO_UDP, PROTO_ANY):
        return p
    raise PolicyValidationError(f"invalid protocol {proto!r}, must be tcp/udp/any")


def proto_number(proto: str) -> int:
    return _PROTO_NUM.get(proto, 0)


# ---------------------------------------------------------------------------
# Endpoint selectors (k8s LabelSelector semantics over extended keys)

OP_IN = "In"
OP_NOT_IN = "NotIn"
OP_EXISTS = "Exists"
OP_DOES_NOT_EXIST = "DoesNotExist"


@dataclass(frozen=True)
class SelectorRequirement:
    """One matchExpressions entry (k8s LabelSelectorRequirement)."""

    key: str  # extended key, e.g. "any.role"
    operator: str
    values: tuple[str, ...] = ()

    def matches(self, lbls: LabelArray) -> bool:
        if self.operator == OP_IN:
            return lbls.get(self.key) in self.values
        if self.operator == OP_NOT_IN:
            # k8s semantics: matches if key absent OR value not in set.
            v = lbls.get(self.key)
            return v is None or v not in self.values
        if self.operator == OP_EXISTS:
            return lbls.has(self.key)
        if self.operator == OP_DOES_NOT_EXIST:
            return not lbls.has(self.key)
        return False

    def validate(self) -> None:
        if self.operator in (OP_IN, OP_NOT_IN) and not self.values:
            raise PolicyValidationError(
                f"operator {self.operator} requires values for key {self.key}"
            )
        if self.operator in (OP_EXISTS, OP_DOES_NOT_EXIST) and self.values:
            raise PolicyValidationError(
                f"operator {self.operator} forbids values for key {self.key}"
            )
        if self.operator not in (OP_IN, OP_NOT_IN, OP_EXISTS, OP_DOES_NOT_EXIST):
            raise PolicyValidationError(f"invalid selector operator {self.operator!r}")


@dataclass(frozen=True)
class EndpointSelector:
    """k8s-LabelSelector wrapper keyed by extended label keys
    (reference: pkg/policy/api/selector.go:34).

    match_labels keys are stored in extended form (``source.key``); bare
    keys are normalized with the ``any`` source at construction.
    """

    match_labels: tuple[tuple[str, str], ...] = ()
    match_expressions: tuple[SelectorRequirement, ...] = ()

    @staticmethod
    def from_dict(
        match_labels: dict[str, str] | None = None,
        match_expressions: Iterable[SelectorRequirement] = (),
    ) -> "EndpointSelector":
        ml = tuple(
            sorted(
                (get_extended_key_from(k), v)
                for k, v in (match_labels or {}).items()
            )
        )
        me = tuple(
            replace(r, key=get_extended_key_from(r.key)) for r in match_expressions
        )
        return EndpointSelector(match_labels=ml, match_expressions=me)

    @staticmethod
    def from_labels(*lbls: Label) -> "EndpointSelector":
        """reference: pkg/policy/api/selector.go NewESFromLabels."""
        return EndpointSelector(
            match_labels=tuple(
                sorted((l.extended_key, l.value) for l in lbls)
            )
        )

    def matches(self, lbls: LabelArray) -> bool:
        """reference: pkg/policy/api/selector.go:279-306 — the reserved
        ``all`` label key short-circuits to True."""
        all_key = SOURCE_RESERVED + PATH_DELIMITER + ID_NAME_ALL
        for k, v in self.match_labels:
            if k == all_key:
                return True
        for k, v in self.match_labels:
            got = lbls.get(k)
            if got != v:
                return False
        for req in self.match_expressions:
            if not req.matches(lbls):
                return False
        return True

    def is_wildcard(self) -> bool:
        return not self.match_labels and not self.match_expressions

    def with_requirements(
        self, reqs: Iterable[SelectorRequirement]
    ) -> "EndpointSelector":
        """Append extra requirements (used to fold FromRequires/ToRequires
        into the selector, reference: pkg/policy/rule.go:236-249)."""
        reqs = tuple(reqs)
        if not reqs:
            return self
        return EndpointSelector(
            match_labels=self.match_labels,
            match_expressions=self.match_expressions + reqs,
        )

    def to_requirements(self) -> tuple[SelectorRequirement, ...]:
        """reference: selector.go ConvertToLabelSelectorRequirementSlice."""
        out = list(self.match_expressions)
        for k, v in self.match_labels:
            out.append(SelectorRequirement(key=k, operator=OP_IN, values=(v,)))
        return tuple(out)

    def has_key(self, ext_key: str) -> bool:
        return any(k == ext_key for k, _ in self.match_labels) or any(
            r.key == ext_key for r in self.match_expressions
        )

    def has_key_prefix(self, prefix: str) -> bool:
        return any(k.startswith(prefix) for k, _ in self.match_labels) or any(
            r.key.startswith(prefix) for r in self.match_expressions
        )

    def validate(self) -> None:
        for r in self.match_expressions:
            r.validate()

    def __str__(self) -> str:
        parts = [f"{k}={v}" for k, v in self.match_labels]
        parts += [
            f"{r.key} {r.operator.lower()} {list(r.values)}"
            for r in self.match_expressions
        ]
        return "&".join(parts) if parts else "<wildcard>"


WILDCARD_SELECTOR = EndpointSelector()


def _reserved_selector(name: str) -> EndpointSelector:
    return EndpointSelector.from_labels(Label(key=name, source=SOURCE_RESERVED))


RESERVED_ENDPOINT_SELECTORS = {
    ID_NAME_HOST: _reserved_selector(ID_NAME_HOST),
    ID_NAME_WORLD: _reserved_selector(ID_NAME_WORLD),
}

# ---------------------------------------------------------------------------
# Entities (reference: pkg/policy/api/entity.go)

ENTITY_ALL = "all"
ENTITY_WORLD = "world"
ENTITY_CLUSTER = "cluster"
ENTITY_HOST = "host"
ENTITY_INIT = "init"

POLICY_LABEL_CLUSTER = "io.cilium.k8s.policy.cluster"

ENTITY_SELECTOR_MAPPING: dict[str, tuple[EndpointSelector, ...]] = {
    ENTITY_ALL: (WILDCARD_SELECTOR,),
    ENTITY_WORLD: (_reserved_selector(ID_NAME_WORLD),),
    ENTITY_HOST: (_reserved_selector(ID_NAME_HOST),),
    ENTITY_INIT: (_reserved_selector(ID_NAME_INIT),),
    # Populated by init_entities (depends on cluster name).
    ENTITY_CLUSTER: (),
}


def init_entities(cluster_name: str) -> None:
    """reference: entity.go InitEntities."""
    ENTITY_SELECTOR_MAPPING[ENTITY_CLUSTER] = (
        _reserved_selector(ID_NAME_HOST),
        _reserved_selector(ID_NAME_INIT),
        _reserved_selector(ID_NAME_UNMANAGED),
        EndpointSelector.from_labels(
            Label(key=POLICY_LABEL_CLUSTER, value=cluster_name, source=SOURCE_K8S)
        ),
    )


def entities_to_selectors(entities: Iterable[str]) -> list[EndpointSelector]:
    out: list[EndpointSelector] = []
    for e in entities:
        out.extend(ENTITY_SELECTOR_MAPPING.get(e, ()))
    return out


# ---------------------------------------------------------------------------
# CIDR (reference: pkg/policy/api/cidr.go)

CIDR_MATCH_ALL = ("0.0.0.0/0", "::/0")


@dataclass(frozen=True)
class CIDRRule:
    cidr: str
    except_cidrs: tuple[str, ...] = ()
    generated: bool = False

    def sanitize(self) -> int:
        """Validate; returns the prefix length (reference:
        rule_validation.go CIDRRule.sanitize)."""
        try:
            net = ipaddress.ip_network(self.cidr, strict=False)
        except ValueError as e:
            raise PolicyValidationError(f"unable to parse CIDRRule {self.cidr!r}: {e}")
        for p in self.except_cidrs:
            try:
                exc = ipaddress.ip_network(p, strict=False)
            except ValueError as e:
                raise PolicyValidationError(str(e))
            if exc.version != net.version or not (
                int(net.network_address)
                <= int(exc.network_address)
                <= int(net.broadcast_address)
            ):
                raise PolicyValidationError(
                    f"allow CIDR prefix {self.cidr} does not contain "
                    f"exclude CIDR prefix {p}"
                )
        return net.prefixlen


def sanitize_cidr(cidr: str) -> int:
    """Validate a bare CIDR or IP string; returns prefix length
    (reference: rule_validation.go CIDR.sanitize)."""
    if not cidr:
        raise PolicyValidationError("IP must be specified")
    try:
        net = ipaddress.ip_network(cidr, strict=False)
        return net.prefixlen
    except ValueError:
        try:
            ipaddress.ip_address(cidr)
            return 0
        except ValueError as e:
            raise PolicyValidationError(f"unable to parse CIDR: {e}")


def compute_resultant_cidr_set(rules: Iterable[CIDRRule]) -> list[str]:
    """Expand CIDRRules into a minimal covering set of CIDRs with the
    exceptions carved out (reference: api/cidr.go ComputeResultantCIDRSet)."""
    out: list[str] = []
    for r in rules:
        allow = ipaddress.ip_network(r.cidr, strict=False)
        nets = [allow]
        for exc_s in r.except_cidrs:
            exc = ipaddress.ip_network(exc_s, strict=False)
            nxt = []
            for n in nets:
                if exc.version == n.version and exc.subnet_of(n):
                    nxt.extend(n.address_exclude(exc))
                elif exc.version == n.version and n.subnet_of(exc):
                    continue  # fully removed
                else:
                    nxt.append(n)
            nets = nxt
        out.extend(str(n) for n in sorted(nets, key=lambda n: (int(n.network_address), n.prefixlen)))
    return out


def cidrs_to_selectors(cidrs: Iterable[str]) -> list[EndpointSelector]:
    """CIDR strings -> cidr-label selectors; the all-match prefix also adds
    reserved:world once (reference: api/cidr.go GetAsEndpointSelectors)."""
    out: list[EndpointSelector] = []
    world_added = False
    for c in cidrs:
        if c in CIDR_MATCH_ALL and not world_added:
            world_added = True
            out.append(RESERVED_ENDPOINT_SELECTORS[ID_NAME_WORLD])
        lbl = ip_string_to_label(c)
        if lbl is not None:
            out.append(EndpointSelector.from_labels(lbl))
    return out


def cidr_rules_to_selectors(rules: Iterable[CIDRRule]) -> list[EndpointSelector]:
    return cidrs_to_selectors(compute_resultant_cidr_set(rules))


# ---------------------------------------------------------------------------
# L7 rules

@dataclass
class PortRuleHTTP:
    """HTTP constraint; fields are POSIX-extended regexes
    (reference: pkg/policy/api/http.go:28)."""

    path: str = ""
    method: str = ""
    host: str = ""
    headers: tuple[str, ...] = ()

    def sanitize(self) -> None:
        from ..regex import ParseError, compile_pattern

        for pat in (self.path, self.method):
            if pat:
                try:
                    compile_pattern(pat)
                except ParseError as e:
                    raise PolicyValidationError(f"invalid regex {pat!r}: {e}")

    def key(self):
        return (self.path, self.method, self.host, tuple(self.headers))


# Kafka API keys (reference: pkg/policy/api/kafka.go:153-190).
KAFKA_API_KEY_MAP: dict[str, int] = {
    "produce": 0, "fetch": 1, "offsets": 2, "metadata": 3, "leaderandisr": 4,
    "stopreplica": 5, "updatemetadata": 6, "controlledshutdown": 7,
    "offsetcommit": 8, "offsetfetch": 9, "findcoordinator": 10, "joingroup": 11,
    "heartbeat": 12, "leavegroup": 13, "syncgroup": 14, "describegroups": 15,
    "listgroups": 16, "saslhandshake": 17, "apiversions": 18, "createtopics": 19,
    "deletetopics": 20, "deleterecords": 21, "initproducerid": 22,
    "offsetforleaderepoch": 23, "addpartitionstotxn": 24, "addoffsetstotxn": 25,
    "endtxn": 26, "writetxnmarkers": 27, "txnoffsetcommit": 28,
    "describeacls": 29, "createacls": 30, "deleteacls": 31,
    "describeconfigs": 32, "alterconfigs": 33,
}
KAFKA_REVERSE_API_KEY_MAP = {v: k for k, v in KAFKA_API_KEY_MAP.items()}

KAFKA_ROLE_PRODUCE = "produce"
KAFKA_ROLE_CONSUME = "consume"

# Role expansions (reference: kafka.go:274-291): produce needs
# produce+metadata+apiversions; consume needs the full consumer-group set.
KAFKA_PRODUCE_KEYS = (0, 3, 18)
KAFKA_CONSUME_KEYS = (1, 2, 3, 8, 9, 10, 11, 12, 13, 14, 18)

KAFKA_MAX_TOPIC_LEN = 255
# The reference's pattern is a Go *raw* string (kafka.go:244), so its `\\`
# is a regex-escaped literal backslash: backslashes ARE accepted there, and
# this port preserves that exact behavior.
_KAFKA_TOPIC_RE = re.compile(r"^[a-zA-Z0-9._\-\\]+$")

# API keys whose requests carry topics — the behavioral set the matcher
# uses (reference: pkg/kafka/policy.go:27 isTopicAPIKey; note kafka.go's
# constant block also lists FindCoordinator/JoinGroup, but isTopicAPIKey,
# which decides verdicts, does not).
KAFKA_TOPIC_API_KEYS = frozenset(
    [0, 1, 2, 3, 4, 5, 6, 8, 9, 19, 20, 21, 23, 24, 27, 28, 34, 35, 37]
)


@dataclass
class PortRuleKafka:
    """Kafka constraint (reference: pkg/policy/api/kafka.go:26)."""

    role: str = ""
    api_key: str = ""
    api_version: str = ""
    client_id: str = ""
    topic: str = ""

    # Private, filled by sanitize.
    api_keys_int: tuple[int, ...] = field(default=(), compare=False)
    api_version_int: Optional[int] = field(default=None, compare=False)

    def sanitize(self) -> None:
        if self.api_key and self.role:
            raise PolicyValidationError(
                f"cannot set both Role {self.role!r} and APIKey {self.api_key!r}"
            )
        if self.api_key:
            n = KAFKA_API_KEY_MAP.get(self.api_key.lower())
            if n is None:
                raise PolicyValidationError(f"invalid Kafka APIKey {self.api_key!r}")
            self.api_keys_int = (n,)
        if self.role:
            role = self.role.lower()
            if role == KAFKA_ROLE_PRODUCE:
                self.api_keys_int = KAFKA_PRODUCE_KEYS
            elif role == KAFKA_ROLE_CONSUME:
                self.api_keys_int = KAFKA_CONSUME_KEYS
            else:
                raise PolicyValidationError(f"invalid Kafka role {self.role!r}")
        if self.api_version:
            try:
                self.api_version_int = int(self.api_version)
            except ValueError:
                raise PolicyValidationError(
                    f"invalid Kafka APIVersion {self.api_version!r}"
                )
        if self.topic:
            if len(self.topic) > KAFKA_MAX_TOPIC_LEN:
                raise PolicyValidationError(
                    f"kafka topic exceeds maximum len of {KAFKA_MAX_TOPIC_LEN}"
                )
            if not _KAFKA_TOPIC_RE.match(self.topic):
                raise PolicyValidationError(
                    f"invalid Kafka topic name {self.topic!r}"
                )

    def check_api_key_role(self, kind: int) -> bool:
        """reference: kafka.go CheckAPIKeyRole — empty set is a wildcard."""
        return not self.api_keys_int or kind in self.api_keys_int

    def get_api_version(self) -> tuple[int, bool]:
        if self.api_version_int is None:
            return 0, True
        return self.api_version_int, False

    def key(self):
        return (self.role, self.api_key, self.api_version, self.client_id, self.topic)


class PortRuleL7(dict):
    """Generic key/value L7 rule (reference: pkg/policy/api/l7.go:24)."""

    def sanitize(self) -> None:
        for k in self:
            if k == "":
                raise PolicyValidationError("empty key not allowed")

    def key(self):
        return tuple(sorted(self.items()))


@dataclass
class L7Rules:
    """Union of L7 rule types; exactly one kind may be set
    (reference: pkg/policy/api/l4.go:65)."""

    http: list[PortRuleHTTP] = field(default_factory=list)
    kafka: list[PortRuleKafka] = field(default_factory=list)
    l7proto: str = ""
    l7: list[PortRuleL7] = field(default_factory=list)

    def __len__(self) -> int:
        return len(self.http) + len(self.kafka) + len(self.l7)

    def is_empty(self) -> bool:
        return not self.http and not self.kafka and not self.l7 and not self.l7proto

    def sanitize(self) -> None:
        n_types = 0
        if self.http:
            n_types += 1
            for h in self.http:
                h.sanitize()
        if self.kafka:
            n_types += 1
            for k in self.kafka:
                k.sanitize()
        if self.l7 and not self.l7proto:
            raise PolicyValidationError(
                "'l7' may only be specified when a 'l7proto' is also specified"
            )
        if self.l7proto:
            n_types += 1
            for r in self.l7:
                r.sanitize()
        if n_types > 1:
            raise PolicyValidationError(
                "multiple L7 protocol rule types specified in single rule"
            )


# ---------------------------------------------------------------------------
# L4 port rules

MAX_PORTS = 40
MAX_CIDR_PREFIX_LENGTHS = 40


@dataclass(frozen=True)
class PortProtocol:
    port: str
    protocol: str = ""

    def sanitize(self) -> "PortProtocol":
        if not self.port:
            raise PolicyValidationError("port must be specified")
        try:
            p = int(self.port, 0)
        except ValueError as e:
            raise PolicyValidationError(f"unable to parse port: {e}")
        if p == 0:
            raise PolicyValidationError("port cannot be 0")
        if not 0 < p <= 65535:
            raise PolicyValidationError(f"port out of range: {p}")
        return PortProtocol(port=self.port, protocol=parse_l4_proto(self.protocol))


@dataclass
class PortRule:
    ports: list[PortProtocol] = field(default_factory=list)
    rules: Optional[L7Rules] = None

    def sanitize(self) -> None:
        if len(self.ports) > MAX_PORTS:
            raise PolicyValidationError(f"too many ports, the max is {MAX_PORTS}")
        have_l7 = self.rules is not None and not self.rules.is_empty()
        for i, pp in enumerate(self.ports):
            self.ports[i] = pp.sanitize()
            if have_l7 and self.ports[i].protocol != PROTO_TCP:
                raise PolicyValidationError(
                    "L7 rules can only apply exclusively to TCP, "
                    f"not {self.ports[i].protocol}"
                )
        if have_l7:
            self.rules.sanitize()


# ---------------------------------------------------------------------------
# Ingress / egress rules

@dataclass
class Service:
    """ToServices reference (reference: pkg/policy/api/service.go)."""

    k8s_service_name: str = ""
    k8s_service_namespace: str = ""
    k8s_service_selector: Optional[EndpointSelector] = None


@dataclass
class FQDNSelector:
    """ToFQDNs entry (reference: pkg/policy/api/fqdn.go)."""

    match_name: str = ""

    def sanitize(self) -> None:
        if not self.match_name:
            raise PolicyValidationError("FQDNSelector.match_name must be set")


@dataclass
class IngressRule:
    """reference: pkg/policy/api/ingress.go:35."""

    from_endpoints: list[EndpointSelector] = field(default_factory=list)
    from_requires: list[EndpointSelector] = field(default_factory=list)
    to_ports: list[PortRule] = field(default_factory=list)
    from_cidr: list[str] = field(default_factory=list)
    from_cidr_set: list[CIDRRule] = field(default_factory=list)
    from_entities: list[str] = field(default_factory=list)

    def get_source_endpoint_selectors(self) -> list[EndpointSelector]:
        """All L3 source selectors (reference: ingress.go:111-116)."""
        res = list(self.from_endpoints)
        res += entities_to_selectors(self.from_entities)
        res += cidrs_to_selectors(self.from_cidr)
        res += cidr_rules_to_selectors(self.from_cidr_set)
        return res

    def is_label_based(self) -> bool:
        return not (self.from_requires or self.from_cidr or self.from_cidr_set)

    def sanitize(self) -> None:
        l3 = {
            "FromEndpoints": len(self.from_endpoints),
            "FromCIDR": len(self.from_cidr),
            "FromCIDRSet": len(self.from_cidr_set),
            "FromEntities": len(self.from_entities),
        }
        l3_dependent_l4 = {"FromEndpoints": True, "FromCIDR": False,
                           "FromCIDRSet": False, "FromEntities": True}
        _check_l3_members(l3, l3_dependent_l4, len(self.to_ports))
        for es in self.from_endpoints + self.from_requires:
            es.validate()
        for pr in self.to_ports:
            pr.sanitize()
        prefix_lengths = set()
        for c in self.from_cidr:
            prefix_lengths.add(sanitize_cidr(c))
        for cr in self.from_cidr_set:
            prefix_lengths.add(cr.sanitize())
        for e in self.from_entities:
            if e not in ENTITY_SELECTOR_MAPPING:
                raise PolicyValidationError(f"unsupported entity: {e}")
        if len(prefix_lengths) > MAX_CIDR_PREFIX_LENGTHS:
            raise PolicyValidationError(
                f"too many ingress CIDR prefix lengths "
                f"{len(prefix_lengths)}/{MAX_CIDR_PREFIX_LENGTHS}"
            )


@dataclass
class EgressRule:
    """reference: pkg/policy/api/egress.go:28."""

    to_endpoints: list[EndpointSelector] = field(default_factory=list)
    to_requires: list[EndpointSelector] = field(default_factory=list)
    to_ports: list[PortRule] = field(default_factory=list)
    to_cidr: list[str] = field(default_factory=list)
    to_cidr_set: list[CIDRRule] = field(default_factory=list)
    to_entities: list[str] = field(default_factory=list)
    to_services: list[Service] = field(default_factory=list)
    to_fqdns: list[FQDNSelector] = field(default_factory=list)

    def get_destination_endpoint_selectors(self) -> list[EndpointSelector]:
        res = list(self.to_endpoints)
        res += entities_to_selectors(self.to_entities)
        res += cidrs_to_selectors(self.to_cidr)
        res += cidr_rules_to_selectors(self.to_cidr_set)
        return res

    def is_label_based(self) -> bool:
        return not (
            self.to_requires or self.to_cidr or self.to_cidr_set or self.to_services
        )

    def sanitize(self) -> None:
        l3 = {
            "ToCIDR": len(self.to_cidr),
            "ToCIDRSet": len(self.to_cidr_set),
            "ToEndpoints": len(self.to_endpoints),
            "ToEntities": len(self.to_entities),
            "ToServices": len(self.to_services),
            "ToFQDNs": len(self.to_fqdns),
        }
        l3_dependent_l4 = {k: True for k in l3}
        _check_l3_members(l3, l3_dependent_l4, len(self.to_ports))
        for es in self.to_endpoints + self.to_requires:
            es.validate()
        for pr in self.to_ports:
            pr.sanitize()
        prefix_lengths = set()
        for c in self.to_cidr:
            prefix_lengths.add(sanitize_cidr(c))
        for cr in self.to_cidr_set:
            prefix_lengths.add(cr.sanitize())
        for e in self.to_entities:
            if e not in ENTITY_SELECTOR_MAPPING:
                raise PolicyValidationError(f"unsupported entity: {e}")
        for f in self.to_fqdns:
            f.sanitize()
        if len(prefix_lengths) > MAX_CIDR_PREFIX_LENGTHS:
            raise PolicyValidationError(
                f"too many egress CIDR prefix lengths "
                f"{len(prefix_lengths)}/{MAX_CIDR_PREFIX_LENGTHS}"
            )


def _check_l3_members(
    l3: dict[str, int], l3_dependent_l4: dict[str, bool], n_ports: int
) -> None:
    """Mutually-exclusive L3 member check (reference: rule_validation.go:71-95)."""
    present = [k for k, v in l3.items() if v > 0]
    for i, m1 in enumerate(present):
        for m2 in present[i + 1:]:
            raise PolicyValidationError(
                f"combining {m1} and {m2} is not supported yet"
            )
    for m in present:
        if n_ports > 0 and not l3_dependent_l4[m]:
            raise PolicyValidationError(
                f"combining {m} and ToPorts is not supported yet"
            )


# ---------------------------------------------------------------------------
# Rule

@dataclass
class Rule:
    """reference: pkg/policy/api/rule.go:32."""

    endpoint_selector: Optional[EndpointSelector] = None
    ingress: list[IngressRule] = field(default_factory=list)
    egress: list[EgressRule] = field(default_factory=list)
    labels: LabelArray = field(default_factory=LabelArray)
    description: str = ""

    def sanitize(self) -> None:
        """reference: rule_validation.go Rule.Sanitize."""
        for lbl in self.labels:
            if lbl.source == SOURCE_CILIUM_GENERATED:
                raise PolicyValidationError(
                    "rule labels cannot have cilium-generated source"
                )
        if self.endpoint_selector is None:
            raise PolicyValidationError("rule cannot have nil EndpointSelector")
        self.endpoint_selector.validate()
        for i in self.ingress:
            i.sanitize()
        for e in self.egress:
            e.sanitize()

    def get_cidr_prefixes(self) -> list[str]:
        """All CIDR prefixes referenced by this rule
        (reference: pkg/policy/cidr.go GetCIDRPrefixes)."""
        out: list[str] = []
        for i in self.ingress:
            out += [str(ipaddress.ip_network(c, strict=False)) for c in i.from_cidr]
            out += [
                str(ipaddress.ip_network(r.cidr, strict=False))
                for r in i.from_cidr_set
            ]
        for e in self.egress:
            out += [str(ipaddress.ip_network(c, strict=False)) for c in e.to_cidr]
            out += [
                str(ipaddress.ip_network(r.cidr, strict=False))
                for r in e.to_cidr_set
            ]
        return out
