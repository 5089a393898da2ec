"""The port's cilium-health prober and ToFQDNs poller
(``cilium_tpu_torch/health.py``, ``cilium_tpu_torch/fqdn.py``) against the
reference's.

tests/test_health_fqdn_bugtool.py's prober and DNS cache / poller cases
run through both packages (tests/agent_cases.py), the daemon ones with the
port's daemon on the CPU.  Each scenario returns what the reference test
asserts; the two packages' answers must be equal.
"""

from __future__ import annotations

from agent_cases import agent_globals, both, config, wait_for  # noqa: F401 (a fixture)
from policy_cases import reference_leak_guard  # noqa: F401 (a module fixture)

# --- health --------------------------------------------------------------------------


def _prober_healthy_and_degraded(pk):
    r1, r2 = pk.health.HealthResponder(), pk.health.HealthResponder()
    p = pk.health.Prober(node_name="n0")
    try:
        p.add_node("n1", r1.address)
        p.add_node("n2", r2.address)
        p.add_node("n3", "127.0.0.1:1")  # a closed port
        p.probe_all()
        st = p.get_status()
        first = (st["probed_nodes"], st["degraded"], st["healthy"], st["nodes"]["n1"]["reachable"],
                 st["nodes"]["n1"]["latency_ms"] > 0, st["nodes"]["n3"]["failures"])
        p.probe_all()
        return first, p.get_status()["nodes"]["n3"]["failures"]
    finally:
        r1.close()
        r2.close()
        p.close()


def _prober_detects_node_death(pk):
    r = pk.health.HealthResponder()
    p = pk.health.Prober()
    try:
        p.add_node("n1", r.address)
        p.probe_all()
        alive = p.get_status()["degraded"]
        r.close()
        p.probe_all()
        st = p.get_status()
        return alive, st["degraded"], st["nodes"]["n1"]["failures"] >= 1
    finally:
        p.close()


def _remove_node(pk):
    r = pk.health.HealthResponder()
    p = pk.health.Prober()
    try:
        p.add_node("n1", r.address)
        p.add_node("n2", "127.0.0.1:1")
        p.remove_node("n2")
        p.probe_all()
        st = p.get_status()
        return st["probed_nodes"], st["degraded"], sorted(st["nodes"])
    finally:
        r.close()
        p.close()


def test_prober_healthy_and_degraded_nodes_match_reference():
    assert both(_prober_healthy_and_degraded) == ((3, ["n3"], 2, True, True, 1), 2)


def test_prober_detects_node_death_matches_reference():
    assert both(_prober_detects_node_death) == ([], ["n1"], True)


def test_prober_remove_node_matches_reference():
    assert both(_remove_node) == (1, [], ["n1"])


def _daemon_wires_health(pk, tmp_path):
    d = pk.daemon.Daemon(config(pk, tmp_path / pk.name, dry_mode=True))
    try:
        d.health_prober.probe_all()
        st = d.health_prober.get_status()
        return st["probed_nodes"], st["degraded"]
    finally:
        d.close()


def test_daemon_wires_health_matches_reference(tmp_path):
    assert both(_daemon_wires_health, tmp_path) == (1, [])


# --- fqdn ----------------------------------------------------------------------------


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _fqdn_rule(pk, name="svc.example.com"):
    f = pk.api.FQDNSelector(match_name=name)
    f.sanitize()
    r = pk.api.Rule(endpoint_selector=pk.api.EndpointSelector.from_dict({"app": "client"}),
                    egress=[pk.api.EgressRule(to_fqdns=[f])])
    r.sanitize()
    return r


def _cidrs(repo):
    return sorted((c.cidr, c.generated) for c in repo.rules[0].egress[0].to_cidr_set)


def _dns_cache_ttl(pk):
    clock = FakeClock()
    c = pk.fqdn.DnsCache(clock=clock)
    c.update("a.com", ["1.1.1.1", "1.1.1.1", "0.0.0.9"], ttl=10)
    live = c.lookup("a.com"), c.expired("a.com")
    clock.t += 11
    return live, c.lookup("a.com"), c.expired("a.com"), c.lookup_stale("a.com"), c.expired("b.com")


def _poller_generates_and_refreshes(pk):
    repo = pk.repository.Repository()
    repo.add(_fqdn_rule(pk))
    clock = FakeClock()
    answers = {"svc.example.com": (["10.1.1.1", "10.1.1.2"], 30.0)}
    changes = []
    poller = pk.fqdn.DnsPoller(repo, lambda name: answers[name], on_change=lambda: changes.append(1),
                               clock=clock)
    out = []
    poller.lookup_update_dns()
    rev = repo.revision
    out.append((_cidrs(repo), len(changes)))
    poller.lookup_update_dns()  # within the TTL: no re-resolution
    out.append((len(changes), repo.revision == rev))
    clock.t += 31
    answers["svc.example.com"] = (["10.9.9.9"], 30.0)
    poller.lookup_update_dns()
    out.append((_cidrs(repo), len(changes), repo.revision > rev, poller.generated_cidrs()))
    return out


def _poller_shrink_to_empty(pk):
    repo = pk.repository.Repository()
    repo.add(_fqdn_rule(pk))
    clock = FakeClock()
    answers = {"svc.example.com": (["10.5.5.5"], 30.0)}
    changes = []
    poller = pk.fqdn.DnsPoller(repo, lambda name: answers[name], on_change=lambda: changes.append(1),
                               clock=clock)
    poller.lookup_update_dns()
    rev = repo.revision
    clock.t += 31
    poller.lookup_update_dns()  # the same answer after expiry: no change event
    same = (len(changes), repo.revision == rev)
    clock.t += 31
    answers["svc.example.com"] = ([], 30.0)
    poller.lookup_update_dns()
    return same, len(changes), repo.revision > rev, _cidrs(repo)


def _poller_survives_resolver_failure(pk):
    repo = pk.repository.Repository()
    repo.add(_fqdn_rule(pk))
    clock = FakeClock()
    state = {"fail": False}

    def resolver(name):
        if state["fail"]:
            raise OSError("dns down")
        return ["10.2.2.2"], 5.0

    poller = pk.fqdn.DnsPoller(repo, resolver, clock=clock)
    poller.lookup_update_dns()
    before = _cidrs(repo)
    clock.t += 6
    state["fail"] = True
    poller.lookup_update_dns()
    return before, _cidrs(repo)


def _poller_min_ttl_and_controller(pk):
    repo = pk.repository.Repository()
    repo.add(_fqdn_rule(pk))
    clock = FakeClock()
    calls = []

    def resolver(name):
        calls.append(name)
        return ["10.3.3.3"], 0.5  # below the minimum TTL

    poller = pk.fqdn.DnsPoller(repo, resolver, clock=clock, min_ttl=5.0, interval=3600.0).start()
    try:
        wait_for(lambda: calls, 2)
        clock.t += 1.0
        poller.lookup_update_dns()  # within the minimum TTL
        n = len(calls)
        clock.t += 5.0
        poller.lookup_update_dns()
        return n, len(calls), _cidrs(repo)
    finally:
        poller.close()


def test_dns_cache_ttl_matches_reference():
    assert both(_dns_cache_ttl) == ((("0.0.0.9", "1.1.1.1"), False), (), True, ("0.0.0.9", "1.1.1.1"), True)


def test_poller_generates_and_refreshes_matches_reference():
    out = both(_poller_generates_and_refreshes)
    assert out[0] == ([("10.1.1.1/32", True), ("10.1.1.2/32", True)], 1)
    assert out[1] == (1, True)
    assert out[2] == ([("10.9.9.9/32", True)], 2, True, {"svc.example.com": ("10.9.9.9",)})


def test_poller_shrink_to_empty_matches_reference():
    assert both(_poller_shrink_to_empty) == ((1, True), 2, True, [])


def test_poller_survives_resolver_failure_matches_reference():
    assert both(_poller_survives_resolver_failure) == ([("10.2.2.2/32", True)], [("10.2.2.2/32", True)])


def test_poller_min_ttl_and_controller_match_reference():
    assert both(_poller_min_ttl_and_controller) == (1, 2, [("10.3.3.3/32", True)])


def _daemon_dns_poller(pk, tmp_path):
    d = pk.daemon.Daemon(config(pk, tmp_path / pk.name, dry_mode=True))
    try:
        rev0 = d.policy_add([_fqdn_rule(pk)])
        answers = {"svc.example.com": (["10.3.3.3"], 1.0)}
        poller = d.start_dns_poller(lambda n: answers[n], interval=3600)
        poller.lookup_update_dns()
        with d.policy.mutex:
            cidrs = sorted(c.cidr for r in d.policy.rules for e in r.egress for c in e.to_cidr_set)
        return cidrs, d.policy.get_revision() > rev0, d.dns_poller is poller
    finally:
        d.close()


def test_daemon_dns_poller_matches_reference(tmp_path):
    assert both(_daemon_dns_poller, tmp_path) == (["10.3.3.3/32"], True, True)
