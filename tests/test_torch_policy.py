"""The port's policy engine against the JAX package's.

The cases of tests/test_policy_engine.py (labels, selectors, rule
validation, CIDR sets, the repository, L4 and CIDR resolution, proxy ids,
JSON) run on both packages (``pk``), and tests/test_policygen.py's fuzz
runs on both against its naive evaluator.  Then the same JSON documents
(the policy slice's generator, ``entry.policy_rules``) load into each
package and every answer must be equal, tolerance 0: decisions, resolved
L4 ingress and egress maps as canonical dicts (tests/policy_cases.py),
CIDR policy, ``get_json`` and revisions.
"""

from __future__ import annotations

import json
import random

import pytest

from cilium_tpu_torch import entry
from policy_cases import PKGS, canon_cidr, canon_l4, ctx_to, world
from policy_cases import reference_leak_guard  # noqa: F401 (a module fixture)




@pytest.fixture(params=["port", "ref"])
def pk(request):
    return PKGS[request.param]


def sel(pk, *lbls):
    return pk.api.EndpointSelector.from_labels(*(pk.labels.parse_select_label(x) for x in lbls))


def to(pk, *lbls):
    return pk.policy.SearchContext(to_labels=pk.labels.LabelArray.parse_select(*lbls))


def ctx(pk, frm, to_, dports=()):
    la = pk.labels.LabelArray
    return pk.policy.SearchContext(from_labels=la.parse_select(*frm), to_labels=la.parse_select(*to_),
                                   dports=[pk.policy.DPort(p, "TCP") for p in dports])


def http_port_rule(pk, port="80", path="/"):
    P = pk.policy
    return P.PortRule(ports=[P.PortProtocol(port, "TCP")],
                      rules=P.L7Rules(http=[P.PortRuleHTTP(method="GET", path=path)]))


def plain_port_rule(pk, port="80", proto="TCP"):
    return pk.policy.PortRule(ports=[pk.policy.PortProtocol(port, proto)])


def test_packages_export_the_same_names():
    """Every public name of the reference's labels, policy and proxy
    modules exists in the port's (the imported modules aside)."""
    for mod in ("labels", "cidr", "policy", "api", "l4", "proxy", "npds_push"):
        ref, port = getattr(PKGS["ref"], mod), getattr(PKGS["port"], mod)
        names = {n for n in dir(ref) if not n.startswith("_") and not isinstance(getattr(ref, n), type(json))}
        assert not {n for n in names if not hasattr(port, n)}, mod
    assert PKGS["port"].policy.__all__ == PKGS["ref"].policy.__all__


# --- labels (TestLabels) ---------------------------------------------------------


def test_parse_label_forms(pk):
    L = pk.labels
    lb = L.parse_label("k8s:role=frontend")
    assert (lb.source, lb.key, lb.value) == ("k8s", "role", "frontend")
    lb = L.parse_label("$host")
    assert (lb.source, lb.key) == ("reserved", "host")
    lb = L.parse_label("reserved:world")
    assert (lb.source, lb.key) == ("reserved", "world")
    lb = L.parse_label("foo=bar")
    assert (lb.source, lb.key, lb.value) == ("unspec", "foo", "bar")
    assert L.parse_select_label("foo=bar").source == "any"


def test_extended_key(pk):
    L = pk.labels
    assert L.get_extended_key_from("k8s:foo=bar") == "k8s.foo"
    assert L.get_extended_key_from("foo=bar") == "any.foo"
    assert L.Label.new("k8s:x", "1").extended_key == "k8s.x"


def test_any_source_matches_all_sources(pk):
    L = pk.labels
    assert L.parse_select_label("role=frontend").equals(L.parse_label("k8s:role=frontend"))
    assert not L.parse_label("k8s:role=frontend").equals(L.parse_label("container:role=frontend"))


def test_label_array_contains(pk):
    LA = pk.labels.LabelArray
    arr = LA.parse("k8s:a=1", "k8s:b=2")
    assert arr.contains(LA.parse_select("a=1"))
    assert not arr.contains(LA.parse_select("a=2"))
    assert arr.contains(LA())


def test_labels_sha_and_model(pk):
    Labels = pk.labels.Labels
    l1 = Labels.from_model(["k8s:a=1", "k8s:b=2"])
    l2 = Labels.from_model(["k8s:b=2", "k8s:a=1"])
    assert l1.sha256_sum() == l2.sha256_sum()


def test_label_hashes_and_models_match_reference():
    rng = random.Random(3)
    for _ in range(50):
        strs = [f"{rng.choice(['k8s', 'container', 'reserved', ''])}:{rng.choice('abc')}="
                f"{rng.randrange(5)}".lstrip(":") for _ in range(rng.randrange(1, 5))]
        got, want = (pk.labels.Labels.from_model(strs) for pk in (PKGS["port"], PKGS["ref"]))
        assert got.sha256_sum() == want.sha256_sum()
        assert got.get_model() == want.get_model()
        assert got.sorted_list() == want.sorted_list()
        assert [str(x) for x in got.to_array()] == [str(x) for x in want.to_array()]


def test_cidr_label(pk):
    ip = pk.cidr.ip_string_to_label
    lb = ip("10.0.0.0/8")
    assert (lb.source, lb.key) == ("cidr", "10.0.0.0/8")
    assert ip("192.0.2.3").key == "192.0.2.3/32"
    assert ip("f00d::1").key == "f00d--1/128"
    assert ip("not-an-ip") is None


# --- selectors (TestSelectors) ------------------------------------------------------


def test_wildcard_matches_everything(pk):
    W, LA = pk.policy.WILDCARD_SELECTOR, pk.labels.LabelArray
    assert W.matches(LA.parse_select("anything")) and W.matches(LA()) and W.is_wildcard()


def test_match_labels(pk):
    LA = pk.labels.LabelArray
    s = sel(pk, "role=frontend")
    assert s.matches(LA.parse("k8s:role=frontend"))
    assert not s.matches(LA.parse("k8s:role=backend"))
    assert not s.matches(LA())


def test_reserved_all_label_short_circuits(pk):
    LA = pk.labels.LabelArray
    s = sel(pk, "reserved:all")
    assert s.matches(LA.parse("k8s:whatever=x")) and s.matches(LA())


def test_match_expressions(pk):
    ES, SR, LA = pk.api.EndpointSelector, pk.policy.SelectorRequirement, pk.labels.LabelArray
    s = ES.from_dict(None, [SR("env", "In", ("prod", "staging"))])
    assert s.matches(LA.parse_select("env=prod")) and not s.matches(LA.parse_select("env=dev"))
    s = ES.from_dict(None, [SR("env", "Exists")])
    assert s.matches(LA.parse_select("env=x")) and not s.matches(LA.parse_select("other=x"))
    s = ES.from_dict(None, [SR("env", "DoesNotExist")])
    assert s.matches(LA.parse_select("other=x"))
    s = ES.from_dict(None, [SR("env", "NotIn", ("prod",))])
    assert s.matches(LA.parse_select("other=x")) and not s.matches(LA.parse_select("env=prod"))


def test_requirement_validation(pk):
    SR, E = pk.policy.SelectorRequirement, pk.policy.PolicyValidationError
    for req in (SR("k", "In"), SR("k", "Exists", ("v",)), SR("k", "Bogus")):
        with pytest.raises(E):
            req.validate()


def test_selector_matches_the_same_identities_from_either_packages_labels():
    """Each package's identity cache is built from the same label strings;
    a port selector given the reference's LabelArray still reads it (it
    does not quietly match nothing)."""
    port, ref = PKGS["port"], PKGS["ref"]
    ids = entry.policy_identities()
    s = port.api.EndpointSelector.from_dict({"k8s:app": "app03", "k8s:ns": "dev"})
    got = {n for n, lb in ids.items() if s.matches(port.labels.Labels.from_model(lb).to_array())}
    assert len(got) == 4
    assert got == {n for n, lb in ids.items() if s.matches(ref.labels.Labels.from_model(lb).to_array())}
    r = ref.api.EndpointSelector.from_dict({"k8s:app": "app03", "k8s:ns": "dev"})
    assert got == {n for n, lb in ids.items() if r.matches(ref.labels.Labels.from_model(lb).to_array())}


# --- rule validation (TestSanitize) ---------------------------------------------------


def _rule(pk, **kw):
    return pk.policy.Rule(endpoint_selector=pk.policy.WILDCARD_SELECTOR, **kw)


def test_nil_selector_rejected(pk):
    with pytest.raises(pk.policy.PolicyValidationError):
        pk.policy.Rule().sanitize()


def test_l3_member_exclusivity(pk):
    P = pk.policy
    r = _rule(pk, ingress=[P.IngressRule(from_endpoints=[sel(pk, "a")], from_cidr=["10.0.0.0/8"])])
    with pytest.raises(P.PolicyValidationError, match="[Cc]ombining"):
        r.sanitize()


def test_cidr_with_to_ports(pk):
    P = pk.policy
    r = _rule(pk, ingress=[P.IngressRule(from_cidr=["10.0.0.0/8"], to_ports=[plain_port_rule(pk)])])
    with pytest.raises(P.PolicyValidationError, match="ToPorts"):
        r.sanitize()
    _rule(pk, egress=[P.EgressRule(to_cidr=["10.0.0.0/8"], to_ports=[plain_port_rule(pk)])]).sanitize()


def test_l7_requires_tcp(pk):
    P = pk.policy
    pr = P.PortRule(ports=[P.PortProtocol("53", "UDP")], rules=P.L7Rules(http=[P.PortRuleHTTP(path="/")]))
    with pytest.raises(P.PolicyValidationError, match="TCP"):
        _rule(pk, ingress=[P.IngressRule(to_ports=[pr])]).sanitize()


def test_mixed_l7_types_rejected(pk):
    P = pk.policy
    pr = P.PortRule(ports=[P.PortProtocol("80", "TCP")], rules=P.L7Rules(
        http=[P.PortRuleHTTP(path="/")], kafka=[P.PortRuleKafka(topic="t")]))
    with pytest.raises(P.PolicyValidationError, match="multiple L7"):
        pr.sanitize()


def test_port_validation(pk):
    P = pk.policy
    for port, proto in (("0", "TCP"), ("notaport", "TCP"), ("80", "SCTP")):
        with pytest.raises(P.PolicyValidationError):
            P.PortProtocol(port, proto).sanitize()
    assert P.PortProtocol("80", "tcp").sanitize().protocol == "TCP"
    assert P.PortProtocol("80", "").sanitize().protocol == "ANY"


def test_l7_without_l7proto_rejected(pk):
    P = pk.policy
    pr = P.PortRule(ports=[P.PortProtocol("80", "TCP")], rules=P.L7Rules(l7=[P.PortRuleL7({"cmd": "READ"})]))
    with pytest.raises(P.PolicyValidationError, match="l7proto"):
        pr.sanitize()


def test_cidr_exception_containment(pk):
    P = pk.policy
    P.CIDRRule("10.0.0.0/8", ("10.96.0.0/12",)).sanitize()
    with pytest.raises(P.PolicyValidationError, match="does not contain"):
        P.CIDRRule("10.0.0.0/8", ("192.168.0.0/16",)).sanitize()


def test_kafka_role_rules(pk):
    P, A = pk.policy, pk.api
    with pytest.raises(P.PolicyValidationError):
        P.PortRuleKafka(role="produce", api_key="fetch").sanitize()
    k = P.PortRuleKafka(role="produce")
    k.sanitize()
    assert k.api_keys_int == A.KAFKA_PRODUCE_KEYS
    assert k.check_api_key_role(0) and k.check_api_key_role(18) and not k.check_api_key_role(1)
    k = P.PortRuleKafka(role="consume")
    k.sanitize()
    assert k.api_keys_int == A.KAFKA_CONSUME_KEYS
    k = P.PortRuleKafka(api_key="fetch")
    k.sanitize()
    assert k.api_keys_int == (1,)
    k = P.PortRuleKafka()
    k.sanitize()
    assert k.check_api_key_role(33)


def test_invalid_regex_rejected(pk):
    with pytest.raises(pk.policy.PolicyValidationError):
        pk.policy.PortRuleHTTP(path="([unclosed").sanitize()


def test_entities(pk):
    P, A, LA = pk.policy, pk.api, pk.labels.LabelArray
    r = _rule(pk, ingress=[P.IngressRule(from_entities=["bogus"])])
    with pytest.raises(P.PolicyValidationError, match="entity"):
        r.sanitize()
    P.init_entities("c1")
    sels = A.entities_to_selectors(["cluster"])
    assert any(s.matches(LA.parse("k8s:io.cilium.k8s.policy.cluster=c1")) for s in sels)
    assert any(s.matches(LA.parse("reserved:host")) for s in sels)


# --- CIDR sets (TestCIDR) -------------------------------------------------------------


def test_resultant_cidr_set(pk):
    A, P = pk.api, pk.policy
    assert A.compute_resultant_cidr_set([P.CIDRRule("10.0.0.0/24", ("10.0.0.0/25",))]) == ["10.0.0.128/25"]
    assert A.compute_resultant_cidr_set([P.CIDRRule("10.0.0.0/8")]) == ["10.0.0.0/8"]


def test_resultant_cidr_sets_match_reference():
    rng = random.Random(9)
    for _ in range(40):
        base = f"10.{rng.randrange(256)}.0.0/16"
        exc = tuple(f"10.{base.split('.')[1]}.{rng.randrange(256)}.0/{rng.choice([20, 24, 28])}"
                    for _ in range(rng.randrange(0, 3)))
        got, want = (pk.api.compute_resultant_cidr_set([pk.policy.CIDRRule(base, exc)])
                     for pk in (PKGS["port"], PKGS["ref"]))
        assert got == want


# --- the repository (TestRepository) --------------------------------------------------


def test_add_search_delete_revision(pk):
    P, LA = pk.policy, pk.labels.LabelArray
    repo = P.Repository()
    r1 = P.Rule(endpoint_selector=sel(pk, "foo"), labels=LA.parse("tag1", "tag2"))
    rev0 = repo.get_revision()
    rev = repo.add(r1)
    assert rev > rev0 and repo.search(LA.parse("tag1")) == [r1]
    rev2, deleted = repo.delete_by_labels(LA.parse("tag1"))
    assert deleted == 1 and rev2 > rev and repo.num_rules() == 0
    rev3, deleted = repo.delete_by_labels(LA.parse("tag1"))
    assert deleted == 0 and rev3 == rev2


def test_can_reach_ingress(pk):
    P = pk.policy
    repo = P.Repository()
    repo.add(P.Rule(endpoint_selector=sel(pk, "bar"), ingress=[P.IngressRule(from_endpoints=[sel(pk, "foo")])]))
    assert repo.allows_ingress(ctx(pk, ["foo"], ["bar"])) == P.Decision.ALLOWED
    assert repo.allows_ingress(ctx(pk, ["baz"], ["bar"])) == P.Decision.DENIED


def test_from_requires_denies(pk):
    P = pk.policy
    repo = P.Repository()
    repo.add(P.Rule(endpoint_selector=sel(pk, "bar"), ingress=[P.IngressRule(from_endpoints=[sel(pk, "foo")])]))
    repo.add(P.Rule(endpoint_selector=sel(pk, "bar"), ingress=[P.IngressRule(from_requires=[sel(pk, "team=A")])]))
    assert repo.allows_ingress(ctx(pk, ["foo", "team=A"], ["bar"])) == P.Decision.ALLOWED
    assert repo.allows_ingress(ctx(pk, ["foo"], ["bar"])) == P.Decision.DENIED


def test_egress_requires(pk):
    P = pk.policy
    repo = P.Repository()
    repo.add(P.Rule(endpoint_selector=sel(pk, "foo"), egress=[P.EgressRule(to_endpoints=[sel(pk, "bar")])]))
    repo.add(P.Rule(endpoint_selector=sel(pk, "foo"), egress=[P.EgressRule(to_requires=[sel(pk, "zone=pci")])]))
    assert repo.allows_egress(ctx(pk, ["foo"], ["bar", "zone=pci"])) == P.Decision.ALLOWED
    assert repo.allows_egress(ctx(pk, ["foo"], ["bar"])) == P.Decision.DENIED


# --- L4 resolution (TestL4Resolution, reference: l4Filter_test.go) ---------------------


def _one_rule(pk, *sections, egress=False):
    P = pk.policy
    repo = P.Repository()
    kw = {"egress": list(sections)} if egress else {"ingress": list(sections)}
    repo.add(P.Rule(endpoint_selector=sel(pk, "a"), **kw))
    return repo


def _ing(pk, frm, ports):
    return pk.policy.IngressRule(from_endpoints=frm, to_ports=ports)


def test_case1_allow_all_l3_l4_merge(pk):
    W = pk.policy.WILDCARD_SELECTOR
    repo = _one_rule(pk, _ing(pk, [W], [plain_port_rule(pk)]), _ing(pk, [W], [plain_port_rule(pk)]))
    l4 = repo.resolve_l4_ingress_policy(to(pk, "a"))
    assert set(l4) == {"80/TCP"}
    f = l4["80/TCP"]
    assert f.allows_all_at_l3() and f.l7_parser == "" and not f.is_redirect()


def test_case2_l7_shadowed_by_allow_all(pk):
    W = pk.policy.WILDCARD_SELECTOR
    repo = _one_rule(pk, _ing(pk, [W], [plain_port_rule(pk)]), _ing(pk, [W], [http_port_rule(pk)]))
    f = repo.resolve_l4_ingress_policy(to(pk, "a"))["80/TCP"]
    assert f.l7_parser == pk.policy.PARSER_TYPE_HTTP and f.is_redirect()
    assert any(h.path == "" and h.method == "" for h in f.l7_rules_per_ep[W].http)


def test_case3_duplicate_http_rules_dedup(pk):
    W = pk.policy.WILDCARD_SELECTOR
    repo = _one_rule(pk, _ing(pk, [W], [http_port_rule(pk)]), _ing(pk, [W], [http_port_rule(pk)]))
    f = repo.resolve_l4_ingress_policy(to(pk, "a"))["80/TCP"]
    assert len(f.l7_rules_per_ep[W].http) == 1


def test_case5_conflicting_parsers(pk):
    P = pk.policy
    W = P.WILDCARD_SELECTOR
    gen = P.PortRule(ports=[P.PortProtocol("80", "TCP")],
                     rules=P.L7Rules(l7proto="testing", l7=[P.PortRuleL7({"cmd": "X"})]))
    repo = _one_rule(pk, _ing(pk, [W], [gen]), _ing(pk, [W], [http_port_rule(pk)]))
    with pytest.raises(P.PolicyMergeError, match="parsers"):
        repo.resolve_l4_ingress_policy(to(pk, "a"))


def test_case6_superset_collapses_to_wildcard(pk):
    W = pk.policy.WILDCARD_SELECTOR
    repo = _one_rule(pk, _ing(pk, [sel(pk, "id=a")], [plain_port_rule(pk)]), _ing(pk, [W], [plain_port_rule(pk)]))
    assert repo.resolve_l4_ingress_policy(to(pk, "a"))["80/TCP"].endpoints == [W]


def test_case10_distinct_l3_same_l7(pk):
    repo = _one_rule(pk, _ing(pk, [sel(pk, "id=a")], [http_port_rule(pk)]),
                     _ing(pk, [sel(pk, "id=c")], [http_port_rule(pk)]))
    f = repo.resolve_l4_ingress_policy(to(pk, "a"))["80/TCP"]
    assert len(f.l7_rules_per_ep) == 2 and not f.allows_all_at_l3() and len(f.endpoints) == 2


def test_proto_any_expands(pk):
    repo = _one_rule(pk, _ing(pk, [pk.policy.WILDCARD_SELECTOR], [plain_port_rule(pk, "53", "ANY")]))
    assert set(repo.resolve_l4_ingress_policy(to(pk, "a"))) == {"53/TCP", "53/UDP"}


def test_l3_only_rule_wildcards_l7(pk):
    P = pk.policy
    repo = P.Repository()
    repo.add(P.Rule(endpoint_selector=sel(pk, "a"), ingress=[P.IngressRule(from_endpoints=[sel(pk, "id=a")])]))
    repo.add(P.Rule(endpoint_selector=sel(pk, "a"), ingress=[_ing(pk, [sel(pk, "id=b")], [http_port_rule(pk)])]))
    a_rules = repo.resolve_l4_ingress_policy(to(pk, "a"))["80/TCP"].l7_rules_per_ep.get(sel(pk, "id=a"))
    assert a_rules is not None and any(h.path == "" for h in a_rules.http)


def test_l3_only_rule_wildcards_kafka_l7(pk):
    P = pk.policy
    repo = P.Repository()
    repo.add(P.Rule(endpoint_selector=sel(pk, "a"), ingress=[P.IngressRule(from_endpoints=[sel(pk, "id=a")])]))
    kr = P.PortRule(ports=[P.PortProtocol("9092", "TCP")],
                    rules=P.L7Rules(kafka=[P.PortRuleKafka(role="produce", topic="t")]))
    repo.add(P.Rule(endpoint_selector=sel(pk, "a"), ingress=[_ing(pk, [sel(pk, "id=b")], [kr])]))
    f = repo.resolve_l4_ingress_policy(to(pk, "a"))["9092/TCP"]
    wild = f.l7_rules_per_ep[sel(pk, "id=a")].kafka
    assert len(wild) == 1 and wild[0].check_api_key_role(33)


def test_egress_resolution(pk):
    P = pk.policy
    repo = P.Repository()
    repo.add(P.Rule(endpoint_selector=sel(pk, "foo"), egress=[
        P.EgressRule(to_endpoints=[sel(pk, "db")], to_ports=[plain_port_rule(pk, "5432")])]))
    l4 = repo.resolve_l4_egress_policy(P.SearchContext(from_labels=pk.labels.LabelArray.parse_select("foo")))
    assert set(l4) == {"5432/TCP"} and not l4["5432/TCP"].ingress


def test_from_requires_folded_into_l4(pk):
    P, LA = pk.policy, pk.labels.LabelArray
    repo = _one_rule(pk, _ing(pk, [sel(pk, "id=b")], [plain_port_rule(pk)]),
                     P.IngressRule(from_requires=[sel(pk, "zone=z")]))
    f = repo.resolve_l4_ingress_policy(to(pk, "a"))["80/TCP"]
    assert len(f.endpoints) == 1
    assert f.endpoints[0].matches(LA.parse_select("id=b", "zone=z"))
    assert not f.endpoints[0].matches(LA.parse_select("id=b"))


# --- CIDR resolution (TestCIDRResolution) ----------------------------------------------


def test_resolve_cidr_policy(pk):
    P = pk.policy
    repo = P.Repository()
    repo.add(P.Rule(endpoint_selector=sel(pk, "a"), ingress=[P.IngressRule(from_cidr=["10.0.0.0/8"])],
                    egress=[P.EgressRule(to_cidr_set=[P.CIDRRule("192.168.0.0/16", ("192.168.1.0/24",))])]))
    cp = repo.resolve_cidr_policy(to(pk, "a"))
    assert "10.0.0.0/8" in cp.ingress.map and cp.ingress.ipv4_prefix_count[8] == 1
    assert "192.168.1.0/24" not in cp.egress.map and len(cp.egress.map) > 0
    s6, s4 = cp.to_lpm_data()
    assert s4 == sorted(s4, reverse=True) and 0 in s4 and 32 in s4


def test_egress_cidr_with_l4_counts(pk):
    P = pk.policy
    repo = P.Repository()
    repo.add(P.Rule(endpoint_selector=sel(pk, "a"), egress=[
        P.EgressRule(to_cidr=["10.0.0.0/8"], to_ports=[plain_port_rule(pk)])]))
    assert "10.0.0.0/8" in repo.resolve_cidr_policy(to(pk, "a")).egress.map


# --- proxy ids and JSON (TestProxyID, TestSerialization) --------------------------------


def test_proxy_id_round_trip(pk):
    P = pk.policy
    assert P.parse_proxy_id(P.proxy_id(42, True, "TCP", 80)) == (42, True, "TCP", 80)
    assert P.parse_proxy_id(P.proxy_id(7, False, "UDP", 53)) == (7, False, "UDP", 53)
    with pytest.raises(ValueError):
        P.parse_proxy_id("bogus")


SAMPLE_POLICY = """
[{
  "endpointSelector": {"matchLabels": {"role": "backend"}},
  "labels": ["k8s:io.cilium.k8s.policy.name=rule1"],
  "ingress": [{
    "fromEndpoints": [{"matchLabels": {"role": "frontend"}}],
    "toPorts": [{
      "ports": [{"port": "80", "protocol": "TCP"}],
      "rules": {"http": [{"method": "GET", "path": "/public/.*"}]}
    }]
  }],
  "egress": [{
    "toCIDRSet": [{"cidr": "10.0.0.0/8", "except": ["10.96.0.0/12"]}]
  }]
}]
"""


def test_json_round_trip(pk):
    P, LA = pk.policy, pk.labels.LabelArray
    rules = P.rules_from_json(SAMPLE_POLICY)
    r = rules[0]
    r.sanitize()
    assert r.endpoint_selector.matches(LA.parse("k8s:role=backend"))
    assert r.ingress[0].to_ports[0].rules.http[0].path == "/public/.*"
    assert r.egress[0].to_cidr_set[0].except_cidrs == ("10.96.0.0/12",)
    repo = P.Repository()
    repo.add(P.rules_from_json(P.rules_to_json(rules))[0])
    l4 = repo.resolve_l4_ingress_policy(ctx(pk, ["role=frontend"], ["role=backend"], [80]))
    assert l4["80/TCP"].l7_parser == P.PARSER_TYPE_HTTP


# --- policygen (tests/test_policygen.py) --------------------------------------------------

KEYS = {"app": ["web", "db", "cache"], "tier": ["fe", "be"], "env": ["prod"]}
PORTS = [80, 443, 8080]
UNIVERSE = [{"app": a, "tier": t, "env": "prod"} for a in KEYS["app"] for t in KEYS["tier"]]


def _gen_docs(rng, n_rules):
    """tests/test_policygen.py's generator as JSON documents and its naive
    spec: each rule selects a random matchLabels set and has 1-2 ingress
    sections of 0-2 source selectors and 0-2 TCP ports."""
    def pick():
        return {k: rng.choice(v) for k, v in KEYS.items() if rng.random() < 0.4}

    docs, specs = [], []
    for _ in range(n_rules):
        to_match = pick()
        sections, spec = [], []
        for _ in range(rng.randrange(1, 3)):
            froms = [pick() for _ in range(rng.randrange(0, 3))]
            ports = [rng.choice(PORTS) for _ in range(rng.randrange(1, 3))] if rng.random() < 0.7 else []
            if not froms and not ports:
                continue
            sec = {"toPorts": [{"ports": [{"port": str(p), "protocol": "TCP"}]} for p in ports]}
            if froms:
                sec["fromEndpoints"] = [{"matchLabels": m} for m in froms]
            sections.append(sec)
            spec.append((froms, ports))
        if sections:
            docs.append({"endpointSelector": {"matchLabels": to_match}, "ingress": sections})
            specs.append((to_match, spec))
    return docs, specs


def _naive(specs, src, dst, port):
    def m(match, ep):
        return all(ep.get(k) == v for k, v in match.items())

    for to_match, sections in specs:
        if m(to_match, dst):
            for froms, ports in sections:
                if (not froms or any(m(f, src) for f in froms)) and (not ports or port in ports):
                    return True
    return False


def _labels(pk, d):
    return pk.labels.LabelArray.parse_select(*[f"k8s:{k}={v}" for k, v in sorted(d.items())])


@pytest.mark.parametrize("seed", range(8))
def test_random_policies_match_naive_connectivity_on_both(seed):
    rng = random.Random(100 + seed)
    docs, specs = _gen_docs(rng, rng.randrange(1, 6))
    repos = {}
    for name, pk in PKGS.items():
        repos[name] = pk.policy.Repository()
        for r in pk.policy.rules_from_json(json.dumps(docs)):
            repos[name].add(r)
    for src in UNIVERSE:
        for dst in UNIVERSE:
            for port in PORTS:
                want = _naive(specs, src, dst, port)
                for name, pk in PKGS.items():
                    c = pk.policy.SearchContext(from_labels=_labels(pk, src), to_labels=_labels(pk, dst),
                                                dports=[pk.policy.DPort(port, "TCP")])
                    got = repos[name].allows_ingress(c) == pk.policy.Decision.ALLOWED
                    assert got == want, (name, seed, src, dst, port)


def test_empty_repository_denies_everything(pk):
    c = pk.policy.SearchContext(from_labels=_labels(pk, UNIVERSE[0]), to_labels=_labels(pk, UNIVERSE[1]),
                                dports=[pk.policy.DPort(80, "TCP")])
    assert pk.policy.Repository().allows_ingress(c) == pk.policy.Decision.DENIED


# --- the policy slice's documents in both packages -----------------------------------------


@pytest.mark.parametrize("seed,broad", [(5, 0.35), (6, 0.0), (7, 1.0)])
def test_slice_resolution_matches_reference(seed, broad):
    """The same generated document resolves to equal L4 ingress maps, equal
    decisions, equal CIDR policy, equal JSON and revisions, for a sample of
    destinations (the most-selected one first)."""
    ids = entry.policy_identities()
    docs = entry.policy_rules(120, seed, broad)
    worlds = {name: world(pk, 120, seed, broad) for name, pk in PKGS.items()}
    (p_cache, p_repo), (r_cache, r_repo) = worlds["port"], worlds["ref"]
    assert p_repo.get_json() == r_repo.get_json()
    assert p_repo.get_revision() == r_repo.get_revision() > 0
    dsts = [entry.policy_destination(ids, docs)] + random.Random(seed).sample(sorted(ids), 12)
    for dst in dsts:
        got, want = (canon_l4(repo.resolve_l4_ingress_policy(ctx_to(PKGS[n], cache, dst)))
                     for n, (cache, repo) in (("port", worlds["port"]), ("ref", worlds["ref"])))
        assert got == want, dst
        got, want = (canon_cidr(repo.resolve_cidr_policy(ctx_to(PKGS[n], cache, dst)))
                     for n, (cache, repo) in (("port", worlds["port"]), ("ref", worlds["ref"])))
        assert got == want
        for src in random.Random(dst).sample(sorted(ids), 8):
            for port in (80, 9092, 443):
                decisions = []
                for n, (cache, repo) in (("port", worlds["port"]), ("ref", worlds["ref"])):
                    P = PKGS[n].policy
                    c = P.SearchContext(from_labels=cache[src].to_array(), to_labels=cache[dst].to_array(),
                                        dports=[P.DPort(port, "TCP")])
                    decisions.append((repo.allows_ingress(c).name, repo.allows_egress(c).name))
                assert decisions[0] == decisions[1], (src, dst, port)
    assert any(canon_l4(r_repo.resolve_l4_ingress_policy(ctx_to(PKGS["ref"], r_cache, d))) for d in dsts)


def test_slice_egress_and_cidr_match_reference():
    """Egress sections and CIDR members added to the slice's document
    resolve equally in both packages."""
    docs = entry.policy_rules(40, 11, 0.35)
    rng = random.Random(11)
    for d in docs[:20]:
        k = rng.randrange(8)
        d["egress"] = [
            {"toEndpoints": [{"matchLabels": {"k8s:tier": rng.choice(entry.POLICY_TIERS)}}],
             "toPorts": [{"ports": [{"port": str(rng.choice([5432, 6379])), "protocol": "TCP"}]}]},
            {"toCIDRSet": [{"cidr": f"10.{k}.0.0/16", "except": [f"10.{k}.{rng.randrange(8)}.0/24"]}]},
        ]
    for d in docs[20:30]:
        d["ingress"].append({"fromCIDR": [f"192.168.{rng.randrange(4)}.0/24"]})
    out = []
    for pk in (PKGS["port"], PKGS["ref"]):
        cache = {n: pk.labels.Labels.from_model(lb) for n, lb in entry.policy_identities().items()}
        repo = pk.policy.Repository()
        for r in pk.policy.rules_from_json(json.dumps(docs)):
            repo.add(r)
        res = []
        for n in sorted(cache)[::37]:
            arr = cache[n].to_array()
            c = pk.policy.SearchContext(from_labels=arr, to_labels=arr)
            res.append((canon_l4(repo.resolve_l4_egress_policy(c)), canon_cidr(repo.resolve_cidr_policy(c)),
                        repo.get_rules_matching(arr)))
        out.append((res, repo.get_json()))
    assert out[0] == out[1]
    assert any(r[0] for r in out[0][0])  # some egress resolved


def test_delete_by_labels_revisions_match_reference():
    out = []
    for pk in (PKGS["port"], PKGS["ref"]):
        _, repo = world(pk, 60, 12, 0.35)
        LA = pk.labels.LabelArray
        steps = [repo.get_revision()]
        for i in (3, 3, 17, 59):
            steps.append(repo.delete_by_labels(LA.parse(f"k8s:policy=gen-{i:04d}")))
        steps.append((repo.num_rules(), repo.get_json()))
        out.append(steps)
    assert out[0] == out[1]
