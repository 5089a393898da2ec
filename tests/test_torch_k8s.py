"""The port's Kubernetes layer (``cilium_tpu_torch/k8s/``) against the
reference's.

The 16 cases of tests/test_k8s.py that do not read the reference checkout's
example policies run through both packages (tests/agent_cases.py): the
NetworkPolicy and CNP translations (rules compared as the reference's JSON
schema), the watch loop against the fake API server, ToServices through
Endpoints, IPAM and CNI ADD / DEL, each daemon on the CPU.  The
example-driven HTTP case is twinned with a CNP written here, after the
reference's l7/http example.  Outputs must be equal (tolerance 0).
"""

from __future__ import annotations

import importlib

import pytest

from agent_cases import PKGS, agent_globals, both, config  # noqa: F401 (a fixture)
from policy_cases import reference_leak_guard  # noqa: F401 (a module fixture)

for _pk in PKGS.values():
    for _attr, _mod in (("k8s", "k8s"), ("apiserver", "k8s.apiserver"), ("ipam", "k8s.ipam"), ("cni", "k8s.cni"),
                        ("serialize", "policy.serialize"), ("search", "policy.search")):
        setattr(_pk, _attr, importlib.import_module(f"{_pk.name}.{_mod}"))


def _daemon(pk, tmp_path):
    return pk.daemon.Daemon(config(pk, tmp_path / pk.name, dry_mode=True, enable_health=False))


def np_obj(name="np1", namespace="ns1", spec=None):
    return {"metadata": {"name": name, "namespace": namespace}, "spec": spec or {}}


def cnp_obj(spec=None, name="cnp1", namespace="team-a"):
    obj = {"metadata": {"name": name, "namespace": namespace}}
    if spec is not None:
        obj["spec"] = spec
    return obj


def _rules(pk, rules):
    return [pk.serialize.rule_to_dict(r) for r in rules]


# --- NetworkPolicy v1 and CNP translation ------------------------------------------------


NP_SPECS = {
    "np_pod_selector_gets_namespace": {
        "podSelector": {"matchLabels": {"app": "web"}},
        "ingress": [{"from": [{"podSelector": {"matchLabels": {"role": "fe"}}}]}]},
    "np_empty_from_is_wildcard": {"podSelector": {}, "ingress": [{"ports": [{"port": 80, "protocol": "TCP"}]}]},
    "np_default_deny_conversion": {"podSelector": {}, "policyTypes": ["Ingress"]},
    "np_default_deny_egress": {"podSelector": {}, "policyTypes": ["Egress"]},
    "np_ip_block": {"podSelector": {}, "ingress": [{"from": [{"ipBlock": {
        "cidr": "10.0.0.0/8", "except": ["10.1.0.0/16"]}}]}]},
    "np_empty_namespace_selector_matches_all_namespaces": {
        "podSelector": {}, "ingress": [{"from": [{"namespaceSelector": {}}]}]},
}


def _np(pk, key):
    [rule] = pk.k8s.parse_network_policy(np_obj(spec=NP_SPECS[key]))
    out = {"rule": _rules(pk, [rule])}
    if key == "np_empty_from_is_wildcard":
        out["matches"] = rule.ingress[0].from_endpoints[0].matches(pk.labels.LabelArray.parse("k8s:anything=x"))
    if key == "np_pod_selector_gets_namespace":
        out["labels"] = (sorted(rule.endpoint_selector.match_labels), sorted(rule.ingress[0].from_endpoints[0]
                                                                             .match_labels))
    return out


@pytest.mark.parametrize("key", sorted(NP_SPECS))
def test_network_policy_translation_matches_reference(key):
    out = both(_np, key)
    if key == "np_empty_from_is_wildcard":
        assert out["matches"]
    if key == "np_pod_selector_gets_namespace":
        assert ("k8s.io.kubernetes.pod.namespace", "ns1") in out["labels"][0]
        assert ("k8s.role", "fe") in out["labels"][1]


def _cnp_scoping(pk):
    [rule] = pk.k8s.parse_cnp(cnp_obj(spec={
        "endpointSelector": {"matchLabels": {"app": "db"}},
        "ingress": [{"fromEndpoints": [{"matchLabels": {"app": "web"}}]}]}))
    return _rules(pk, [rule]), sorted((lb.key, lb.value) for lb in rule.labels)


def test_cnp_namespace_scoping_matches_reference():
    rules, labels = both(_cnp_scoping)
    assert ("io.cilium.k8s.policy.derived-from", "CiliumNetworkPolicy") in labels


def _cnp_explicit(pk):
    [rule] = pk.k8s.parse_cnp(cnp_obj(spec={"endpointSelector": {"matchLabels": {
        "k8s:io.kubernetes.pod.namespace": "team-a", "app": "db"}}}))
    try:
        pk.k8s.parse_cnp(cnp_obj(spec={"endpointSelector": {"matchLabels": {
            "k8s:io.kubernetes.pod.namespace": "other-ns"}}}))
    except pk.api.PolicyValidationError as e:
        refused = str(e)
    else:
        refused = None
    return _rules(pk, [rule]), refused


def test_cnp_explicit_namespace_preserved_and_validated_matches_reference():
    _, refused = both(_cnp_explicit)
    assert refused


# --- the watch loop, with a daemon ---------------------------------------------------------


def _watched(pk, tmp_path, body):
    d = _daemon(pk, tmp_path)
    srv = pk.k8s.FakeApiServer()
    watcher = pk.k8s.K8sWatcher(d, srv)
    try:
        return body(pk, d, srv, watcher)
    finally:
        watcher.stop()
        d.close()


HTTP_EXAMPLE = {  # the reference's examples/policies/l7/http/http.json, its labels left to the CRD
    "endpointSelector": {"matchLabels": {"app": "myService"}},
    "ingress": [{"toPorts": [{"ports": [{"port": "80", "protocol": "TCP"}],
                              "rules": {"http": [{"method": "GET", "path": "/path1$"},
                                                 {"method": "PUT", "path": "/path2$",
                                                  "headers": ["X-My-Header: true"]}]}}]}],
}


def _cnp_http(pk, d, srv, watcher):
    watcher.start()
    srv.upsert(pk.apiserver.KIND_CNP, cnp_obj(spec=HTTP_EXAMPLE, name="l7-rule"))
    watcher.sync()
    repo = d.get_policy_repository()
    to_lbls = pk.labels.LabelArray.parse("k8s:app=myService", "k8s:io.kubernetes.pod.namespace=team-a")
    l4 = repo.resolve_l4_ingress_policy(pk.search.SearchContext(from_labels=pk.labels.LabelArray(),
                                                                to_labels=to_lbls))
    f = l4["80/TCP"]
    http = sorted((h.method, h.path, tuple(h.headers)) for rules in f.l7_rules_per_ep.values() for h in rules.http)
    ep = d.endpoint_create(7, ipv4="10.7.0.7", labels=["k8s:app=myService", "k8s:io.kubernetes.pod.namespace=team-a"])
    d.build_queue.wait_idle(10)
    return (repo.num_rules(), sorted(l4), http, srv.get(pk.apiserver.KIND_CNP, "team-a", "l7-rule")["status"],
            sorted((k.dest_port, k.proto, k.direction) for k, _ in ep.policy_map.dump()),
            sorted(p for p in ep.realized_redirects))


def test_cnp_http_end_to_end_matches_reference(tmp_path):
    n, ports, http, status, entries, redirects = both(lambda pk: _watched(pk, tmp_path, _cnp_http), seed=7)
    assert n == 1 and ports == ["80/TCP"] and {h[0] for h in http} == {"GET", "PUT"}
    assert status["nodes"]["node-0"]["ok"] is True and entries and redirects


def _cnp_invalid(pk, d, srv, watcher):
    watcher.start()
    srv.upsert(pk.apiserver.KIND_CNP, cnp_obj(spec={"endpointSelector": {"matchExpressions": [
        {"key": "app", "operator": "Bogus"}]}}, name="bad"))
    watcher.sync()
    st = srv.get(pk.apiserver.KIND_CNP, "team-a", "bad")["status"]["nodes"]["node-0"]
    return st["ok"], bool(st["error"]), d.get_policy_repository().num_rules()


def test_cnp_invalid_spec_writes_error_status_matches_reference(tmp_path):
    assert both(lambda pk: _watched(pk, tmp_path, _cnp_invalid)) == (False, True, 0)


def _np_lifecycle(pk, d, srv, watcher):
    watcher.start()
    repo = d.get_policy_repository()
    kind = pk.apiserver.KIND_NETWORK_POLICY
    out = []
    for port in (80, 8080):
        srv.upsert(kind, np_obj(spec={"podSelector": {"matchLabels": {"app": "web"}},
                                      "ingress": [{"ports": [{"port": port, "protocol": "TCP"}]}]}))
        watcher.sync()
        out.append((repo.num_rules(), _rules(pk, repo.rules)))
    srv.delete(kind, "ns1", "np1")
    watcher.sync()
    return out + [repo.num_rules()]


def test_watcher_np_lifecycle_matches_reference(tmp_path):
    out = both(lambda pk: _watched(pk, tmp_path, _np_lifecycle))
    assert [o[0] for o in out[:2]] == [1, 1] and out[2] == 0


def _initial_sync(pk, d, srv, watcher):
    srv.upsert(pk.apiserver.KIND_NETWORK_POLICY, np_obj(spec={"podSelector": {}}))
    watcher.start()
    watcher.sync()
    return d.get_policy_repository().num_rules()


def test_watcher_initial_sync_replays_existing_matches_reference(tmp_path):
    assert both(lambda pk: _watched(pk, tmp_path, _initial_sync)) == 1


# --- ToServices ------------------------------------------------------------------------------


def _to_services_rule(pk):
    return pk.serialize.rule_from_dict({
        "endpointSelector": {"matchLabels": {"app": "client"}},
        "egress": [{"toServices": [{"k8sService": {"serviceName": "db", "namespace": "prod"}}]}]})


def _translate(pk):
    rule = _to_services_rule(pk)
    res = pk.k8s.translate_to_services([rule], "db", "prod", ["10.5.0.1", "10.5.0.2"])
    out = [sorted(res.added_cidrs), sorted((c.cidr, c.generated) for c in rule.egress[0].to_cidr_set)]
    res = pk.k8s.translate_to_services([rule], "db", "prod", ["10.5.0.1", "10.5.0.2"], revert=True)
    out += [sorted(res.removed_cidrs), rule.egress[0].to_cidr_set]
    res = pk.k8s.translate_to_services([rule], "other", "prod", ["10.9.9.9"])
    return out + [rule.egress[0].to_cidr_set, res.added_cidrs]


def test_translate_to_services_populates_and_reverts_matches_reference():
    out = both(_translate)
    assert out[1] == [("10.5.0.1/32", True), ("10.5.0.2/32", True)] and out[3] == out[4] == out[5] == []


def _endpoints_translation(pk, d, srv, watcher):
    watcher.start()
    repo = d.get_policy_repository()
    d.policy_add([_to_services_rule(pk)])
    srv.upsert(pk.apiserver.KIND_SERVICE, {"metadata": {"name": "db", "namespace": "prod", "labels": {"tier": "db"}}})
    out = []
    for ip in ("10.5.0.1", "10.5.0.7"):
        srv.upsert(pk.apiserver.KIND_ENDPOINTS, {"metadata": {"name": "db", "namespace": "prod"},
                                                 "subsets": [{"addresses": [{"ip": ip}]}]})
        watcher.sync()
        with repo.mutex:
            out.append(sorted(c.cidr for r in repo.rules for e in r.egress for c in e.to_cidr_set))
    return out


def test_watcher_endpoints_translation_matches_reference(tmp_path):
    assert both(lambda pk: _watched(pk, tmp_path, _endpoints_translation)) == [["10.5.0.1/32"], ["10.5.0.7/32"]]


# --- IPAM and CNI ----------------------------------------------------------------------------


def _ipam_exhaust(pk):
    ipam = pk.ipam.IpamAllocator("10.8.0.0/29")
    out = [[ipam.allocate_next("p") for _ in range(5)]]
    for fn in (lambda: ipam.allocate_next("p"), lambda: ipam.allocate_ip("10.8.0.2", "p"),
               lambda: ipam.allocate_ip("10.9.0.1", "p")):
        try:
            out.append(fn())
        except pk.ipam.IpamError:
            out.append("IpamError")
    out.insert(2, (ipam.release("10.8.0.4"), ipam.allocate_next("p")))
    return out


def test_ipam_allocate_release_exhaust_matches_reference():
    out = both(_ipam_exhaust)
    assert out[0] == ["10.8.0.2", "10.8.0.3", "10.8.0.4", "10.8.0.5", "10.8.0.6"]
    assert out[1] == "IpamError" and out[2] == (True, "10.8.0.4") and out[3:] == ["IpamError", "IpamError"]


def _ipam_skips(pk):
    ipam = pk.ipam.IpamAllocator("10.8.0.0/29")
    ipam.allocate_ip("10.8.0.2", "a")
    return ipam.allocate_next("b"), ipam.dump()


def test_ipam_allocate_next_skips_specific_allocations_matches_reference():
    nxt, dump = both(_ipam_skips)
    assert nxt == "10.8.0.3" and dump["10.8.0.2"] == "a"


def _cni_roundtrip(pk, tmp_path):
    d = _daemon(pk, tmp_path)
    try:
        ipam = pk.ipam.IpamAllocator("10.8.0.0/24")
        cni = pk.cni.CniPlugin(d, ipam)
        res = cni.cni_add("c1", "ns1", "pod-a", labels={"app": "web"})
        ep = d.endpoint_manager.lookup(res.endpoint_id)
        out = [vars(res), ep.ipv4, sorted(ep.labels.get_model()), d.ipcache.lookup_by_ip(res.ip) is not None]
        out += [cni.cni_del("c1"), cni.cni_del("c1"), d.endpoint_manager.lookup(res.endpoint_id),
                ipam.allocate_ip(res.ip, "again")]
        return out
    finally:
        d.close()


def test_cni_add_del_roundtrip_matches_reference(tmp_path):
    out = both(_cni_roundtrip, tmp_path, seed=3)
    assert out[0]["ip"].startswith("10.8.0.") and out[0]["gateway"] == "10.8.0.1" and out[1] == out[0]["ip"]
    assert out[3:] == [True, True, False, None, out[0]["ip"]]


def _cni_retry(pk, tmp_path):
    d = _daemon(pk, tmp_path)
    try:
        ipam = pk.ipam.IpamAllocator("10.8.0.0/29")
        while True:
            try:
                ipam.allocate_next("filler")
            except pk.ipam.IpamError:
                break
        cni = pk.cni.CniPlugin(d, ipam)
        try:
            cni.cni_add("c-retry", "ns1", "pod-r")
        except pk.ipam.IpamError:
            first = "IpamError"
        cni.ipam = pk.ipam.IpamAllocator("10.9.0.0/29")
        return first, cni.cni_add("c-retry", "ns1", "pod-r").ip
    finally:
        d.close()


def test_cni_add_retry_after_exhaustion_matches_reference(tmp_path):
    first, ip = both(_cni_retry, tmp_path, seed=4)
    assert first == "IpamError" and ip.startswith("10.9.0.")
