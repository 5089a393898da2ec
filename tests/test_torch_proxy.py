"""The port's proxy manager, engine factory and NPDS push against the JAX
package's.

``proxy.ProxyManager`` with ``create_backend`` wired to
``runtime.engines.create_engine_for_redirect`` and a stand-in daemon (an
identity cache, an access logger, a monitor, a flow log and a config)
builds the same engines in both packages: equal redirect ports, equal
engine ops and injects on the same feeds, ``None`` for a generic L7
filter.  ``proxy.npds_push.network_policy_for_endpoint`` renders equal
policies, and ``NpdsPusher`` pushing to the port's ``VerdictService``
(on the CPU) gives the verdicts the reference's pusher and service give.
Tolerance 0; inputs from tests/policy_cases.py's document.
"""

from __future__ import annotations

import dataclasses
import random
from types import SimpleNamespace

import pytest

from cilium_tpu.flowlog import FlowLog as RefFlowLog
from cilium_tpu.monitor import Monitor as RefMonitor
from cilium_tpu.runtime import engines as ref_engines
from cilium_tpu_torch import entry
from cilium_tpu_torch.flowlog import FlowLog
from cilium_tpu_torch.monitor import Monitor
from cilium_tpu_torch.runtime import engines as port_engines
from policy_cases import PKGS, ctx_to, world
from policy_cases import reference_leak_guard  # noqa: F401 (a module fixture)

ENGINES = {"port": port_engines, "ref": ref_engines}




class _Records:
    def __init__(self):
        self.records = []

    def log(self, record):
        self.records.append(record)


class StandInDaemon:
    """The daemon side the factory reads: ``get_identity_cache``,
    ``access_logger``, ``monitor``, ``flowlog`` and ``config``."""

    def __init__(self, name, cache):
        self.cache = cache
        self.access_logger = _Records()
        self.monitor = (Monitor if name == "port" else RefMonitor)()
        self.flowlog = (FlowLog if name == "port" else RefFlowLog)(capacity=4096, monitor=self.monitor)
        self.config = SimpleNamespace(flow_cache=False, mesh="off", verdict_device="cpu")

    def get_identity_cache(self):
        return self.cache


def managers(seed=5, broad=0.35, n_rules=120):
    """{package: (ProxyManager, daemon, ingress L4 map)} on the same
    document, resolved for its most-selected identity."""
    ids = entry.policy_identities()
    dst = entry.policy_destination(ids, entry.policy_rules(n_rules, seed, broad))
    out = {}
    for name, pk in PKGS.items():
        cache, repo = world(pk, n_rules, seed, broad)
        d = StandInDaemon(name, cache)
        pm = pk.proxy.ProxyManager(create_backend=lambda r, d=d, e=ENGINES[name]: e.create_engine_for_redirect(d, r))
        out[name] = (pm, d, repo.resolve_l4_ingress_policy(ctx_to(pk, cache, dst)))
    return out


def feeds(kind, seed, n_flows=96):
    """Three rounds of (flow, chunk, remote) over the slice's requests."""
    rng = random.Random(seed)
    msgs = (entry.policy_http_requests(256, seed=seed) if kind == "http"
            else entry.policy_kafka_frames(256, seed=seed))
    pool = sorted(entry.policy_identities()) + [99_999]
    rounds = [[], [], []]
    for fid in range(n_flows):
        stream = b"".join(rng.choice(msgs) for _ in range(rng.randrange(1, 4)))
        cut1 = rng.randrange(0, len(stream) + 1)
        cut2 = rng.randrange(cut1, len(stream) + 1)
        remote = rng.choice(pool)
        for rnd, chunk in zip(rounds, (stream[:cut1], stream[cut1:cut2], stream[cut2:])):
            rnd.append((fid, chunk, remote))
    return rounds


def drive(eng, rounds):
    out = []
    for rnd in rounds:
        for fid, chunk, remote in rnd:
            eng.feed(fid, chunk, remote_id=remote)
        eng.pump()
        for fid, _, _ in rnd:
            ops, inject = eng.take_ops(fid)
            out.append((fid, [(int(op), n) for op, n in ops], inject))
    return out


@pytest.mark.parametrize("key,kind", [("80/TCP", "http"), ("9092/TCP", "kafka")])
def test_redirect_engines_match_reference(key, kind):
    ms = managers()
    got = {}
    for name, (pm, d, l4) in ms.items():
        pk = PKGS[name]
        r = pm.create_or_update_redirect(l4[key], pk.policy.proxy_id(7, True, "TCP", l4[key].port), 7)
        eng = r.implementation
        want_cls = ENGINES[name].HttpBatchEngine if kind == "http" else ENGINES[name].KafkaBatchEngine
        assert type(eng) is want_cls
        assert eng.monitor is d.monitor and eng.logger is d.access_logger and eng.flowlog is d.flowlog
        assert eng.capacity == 2048
        got[name] = (r.proxy_port, r.l7_parser, drive(eng, feeds(kind, 11)), len(d.access_logger.records))
    assert got["port"] == got["ref"]
    ops = [op for _, o, _ in got["port"][2] for op, _ in o]
    assert 1 in ops and 2 in ops  # PASS and DROP both happen


def test_engine_model_is_on_the_daemons_verdict_device():
    (pm, d, l4) = managers()["port"]
    r = pm.create_or_update_redirect(l4["80/TCP"], PKGS["port"].policy.proxy_id(1, True, "TCP", 80), 1)
    assert r.implementation.model.remote_ids.device.type == "cpu"
    d.config.verdict_device = "default"
    assert port_engines._daemon_device(d) is None  # the card, which this host lacks
    with pytest.raises(RuntimeError, match="CUDA"):
        port_engines.create_engine_for_redirect(d, r)


def test_generic_l7_and_missing_filters_build_no_engine():
    for name, pk in PKGS.items():
        d = StandInDaemon(name, {})
        dm = pk.l4.L7DataMap()
        dm[pk.policy.WILDCARD_SELECTOR] = pk.policy.L7Rules(l7proto="r2d2", l7=[pk.policy.PortRuleL7({"cmd": "READ"})])
        f = pk.l4.L4Filter(port=80, protocol="TCP", l7_parser="r2d2", l7_rules_per_ep=dm)
        pm = pk.proxy.ProxyManager(create_backend=lambda r, d=d, e=ENGINES[name]: e.create_engine_for_redirect(d, r))
        r = pm.create_or_update_redirect(f, pk.policy.proxy_id(3, True, "TCP", 80), 3)
        assert r.implementation is None and r.l7_parser == "r2d2"
        assert ENGINES[name].create_engine_for_redirect(d, SimpleNamespace(l4_filter=None)) is None


def test_redirect_lifecycle_matches_reference():
    """Ports come from the range in order, an update rebuilds the engine,
    a parser change is refused, removal frees the port for reuse."""
    ms = managers()
    out = {}
    for name, (pm, d, l4) in ms.items():
        pk = PKGS[name]
        pid = pk.policy.proxy_id
        r1 = pm.create_or_update_redirect(l4["80/TCP"], pid(1, True, "TCP", 80), 1)
        r2 = pm.create_or_update_redirect(l4["9092/TCP"], pid(1, True, "TCP", 9092), 1)
        r3 = pm.create_or_update_redirect(l4["80/TCP"], pid(2, True, "TCP", 80), 2)
        eng = r1.implementation
        again = pm.create_or_update_redirect(l4["80/TCP"], pid(1, True, "TCP", 80), 1)
        assert again is r1 and again.implementation is not eng
        with pytest.raises(ValueError, match="parser change"):
            pm.create_or_update_redirect(l4["9092/TCP"], pid(1, True, "TCP", 80), 1)
        removed = pm.remove_endpoint_redirects(1)
        r4 = pm.create_or_update_redirect(l4["80/TCP"], pid(3, True, "TCP", 80), 3)
        out[name] = ([r1.proxy_port, r2.proxy_port, r3.proxy_port, r4.proxy_port], removed,
                     sorted(pm.redirects), sorted(pm.allocated_ports), pm.remove_redirect("nope"))
    assert out["port"] == out["ref"]


# --- NPDS --------------------------------------------------------------------------


def endpoints(name, n=6, seed=23):
    """Stand-in endpoints (id, address, identity, resolved ingress) of one
    package on the NPDS document (no 128-identity sources: a verdict
    service's model takes at most 32 remotes a rule)."""
    pk = PKGS[name]
    cache, repo = world(pk, 48, seed, 0.0)
    eps = []
    for i, numeric in enumerate(sorted(cache)[:: len(cache) // n][:n]):
        l4 = repo.resolve_l4_ingress_policy(ctx_to(pk, cache, numeric))
        eps.append(SimpleNamespace(id=i + 1, ipv4=f"10.20.0.{i + 1}", security_identity=SimpleNamespace(id=numeric),
                                   desired_l4_policy=pk.l4.L4Policy(ingress=l4)))
    return cache, eps


def test_network_policy_for_endpoint_matches_reference():
    got = {}
    for name in PKGS:
        cache, eps = endpoints(name, n=16)
        render = PKGS[name].npds_push.network_policy_for_endpoint
        got[name] = [dataclasses.asdict(render(ep, cache)) for ep in eps]
    assert got["port"] == got["ref"]
    rules = [r for p in got["port"] for pp in p["ingress_per_port_policies"] for r in pp["rules"]]
    assert rules and all(pp["port"] != 9092 for p in got["port"] for pp in p["ingress_per_port_policies"])
    assert any(r["remote_policies"] for r in rules) and any(r["http_rules"] for r in rules)


def test_render_drops_selectors_that_match_nobody():
    for name, pk in PKGS.items():
        dm = pk.l4.L7DataMap()
        dm[pk.api.EndpointSelector.from_dict({"k8s:app": "ghost"})] = pk.policy.L7Rules(
            http=[pk.policy.PortRuleHTTP(method="GET")])
        dm[pk.policy.WILDCARD_SELECTOR] = pk.policy.L7Rules(http=[pk.policy.PortRuleHTTP(path="/a/.*")])
        f = pk.l4.L4Filter(port=80, protocol="TCP", l7_parser="http", l7_rules_per_ep=dm)
        ep = SimpleNamespace(id=5, ipv4="", security_identity=None,
                             desired_l4_policy=pk.l4.L4Policy(ingress=pk.l4.L4PolicyMap({"80/TCP": f})))
        pol = pk.npds_push.network_policy_for_endpoint(ep, {})
        assert pol.name == "ep-5" and pol.policy == 0
        (pp,) = pol.ingress_per_port_policies
        assert [r.remote_policies for r in pp.rules] == [[]]


def _serve(name, tmp_path, eps, cache, conns, reqs):
    """Push the endpoints' policies with ``name``'s NpdsPusher to its
    VerdictService on the CPU and send each conn its requests; returns
    the bytes passed per (conn, request) and each conn's reply inject."""
    if name == "port":
        from cilium_tpu_torch.proxylib import instance as inst
        from cilium_tpu_torch.proxy.npds_push import NpdsPusher
        from cilium_tpu_torch.sidecar import SidecarClient, VerdictService
        from cilium_tpu_torch.utils.option import DaemonConfig as Cfg
        cfg = Cfg(batch_timeout_ms=2.0, batch_flows=256, verdict_device="cpu", reasm_min_entries=1)
    else:
        from cilium_tpu.proxylib import instance as inst
        from cilium_tpu.proxy.npds_push import NpdsPusher
        from cilium_tpu.sidecar.client import SidecarClient
        from cilium_tpu.sidecar.service import VerdictService
        from cilium_tpu.utils.option import DaemonConfig as Cfg
        cfg = Cfg(batch_timeout_ms=2.0, batch_flows=256, dispatch_mode="eager", reasm_min_entries=1)
    inst.reset_module_registry()
    svc = VerdictService(str(tmp_path / f"{name}.sock"), cfg).start()
    pusher = client = None
    try:
        pusher = NpdsPusher(svc.socket_path, ack_timeout=60.0)
        for ep in eps:
            assert pusher.upsert(ep, cache)
        client = SidecarClient(svc.socket_path, timeout=60.0)
        mod = client.open_module([])
        out = []
        for cid, (ep, remote) in enumerate(conns):
            res, shim = client.new_connection(mod, "http", 9000 + cid, True, remote, ep.security_identity.id,
                                              "10.9.0.1:40000", f"{ep.ipv4}:80", ep.ipv4)
            assert res == 0
            passed = [shim.on_io(False, r)[1] for r in reqs[cid]]
            out.append((passed, shim.on_io(True, b"")[1]))
        return out, pusher.pushes, pusher.nacks
    finally:
        if client is not None:
            client.close()
        if pusher is not None:
            pusher.close()
        svc.stop()
        inst.reset_module_registry()


def matching_head(http_rule: dict) -> bytes:
    """A request head the rendered HTTP rule allows."""
    path = http_rule["path"].replace("v[0-9]+", "v2").replace(".*", "item")
    head = f"{http_rule['method']} {path} HTTP/1.1\r\nHost: svc.local\r\n"
    return (head + "".join(f"{h}\r\n" for h in http_rule["headers"]) + "\r\n").encode()


def test_npds_push_to_the_port_service_matches_the_references(tmp_path):
    rng = random.Random(4)
    heads = entry.policy_http_requests(128, seed=33)
    cache, eps = endpoints("port")
    render = PKGS["port"].npds_push.network_policy_for_endpoint
    # half the conns from a remote some rule of the endpoint names
    rendered = [[rule for pp in render(ep, cache).ingress_per_port_policies for rule in pp.rules]
                for ep in eps]
    pool = sorted(entry.policy_identities()) + [99_999]
    remotes, reqs = [], []
    for i in range(12):
        rules = rendered[i % len(eps)]
        rule = rng.choice(rules)
        remotes.append(rng.choice(rule.remote_policies or pool) if i % 2 else rng.choice(pool))
        reqs.append([rng.choice(heads), matching_head(rng.choice(rule.http_rules)), rng.choice(heads),
                     matching_head(rng.choice(rng.choice(rules).http_rules))])
    results = {}
    results = {}
    for name in PKGS:
        cache, eps = endpoints(name)
        conns = [(eps[i % len(eps)], remote) for i, remote in enumerate(remotes)]
        results[name] = _serve(name, tmp_path, eps, cache, conns, reqs)
    assert results["port"] == results["ref"]
    out, pushes, nacks = results["port"]
    assert pushes == 6 and nacks == 0
    passed = [p for per, _ in out for p in per]
    assert any(passed) and not all(passed)
