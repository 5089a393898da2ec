"""The port's agent (``cilium_tpu_torch/daemon/``) against the reference's.

tests/test_daemon.py's daemon cases (endpoint lifecycle, policy driving
regeneration, restore, status) and tests/test_npds_push.py's two cases
run through both packages (tests/agent_cases.py), the port's daemon and
verdict service on the CPU.  Then a seeded world through both daemons
with the device export on: ``entry.policy_rules(64)``, 16 identities, 8
endpoints; identities, the ipcache and its datapath map, each endpoint's
realized policy-map entries and redirects, the distribution cache's
resources and K13 on each exported map (the port's plain version against
the reference's JAX function) must be equal.  Proxy ports are allocated in
the order the build-queue workers reach the endpoints, so a port is compared
as the redirect it names.  Last, the port's daemon without a card raises
before it opens a socket or starts a thread.
"""

from __future__ import annotations

import json
import os
import threading

import numpy as np
import pytest
import torch

from agent_cases import PKGS, agent_globals, both, config, wait_for  # noqa: F401 (a fixture)
from cilium_tpu_torch import entry
from policy_cases import reference_leak_guard  # noqa: F401 (a module fixture)

POLICY = """
[{
  "endpointSelector": {"matchLabels": {"app": "server"}},
  "labels": ["k8s:policy=web"],
  "ingress": [{
    "fromEndpoints": [{"matchLabels": {"app": "client"}}],
    "toPorts": [{"ports": [{"port": "80", "protocol": "TCP"}]}]
  }]
}]
"""


def _daemon(pk, tmp_path, **kw):
    return pk.daemon.Daemon(config(pk, tmp_path / pk.name, **kw), node_name="test-node")


# --- tests/test_daemon.py's daemon cases ----------------------------------------------


def _endpoint_lifecycle(pk, tmp_path):
    d = _daemon(pk, tmp_path, dry_mode=True)
    try:
        ep = d.endpoint_create(100, ipv4="10.0.0.100", labels=["k8s:app=server"])
        ident = ep.security_identity.id
        out = [ident >= 256, d.ipcache.lookup_by_ip("10.0.0.100") == ident, d.build_queue.wait_idle(10),
               ep.state.value]
        try:
            d.endpoint_create(100)
        except ValueError:
            out.append("duplicate refused")
        out += [d.endpoint_delete(100), d.ipcache.lookup_by_ip("10.0.0.100"), d.endpoint_delete(100),
                ep.state.value, len(d.endpoint_manager)]
        return out
    finally:
        d.close()


def test_endpoint_lifecycle_matches_reference(tmp_path):
    assert both(_endpoint_lifecycle, tmp_path, seed=1) == [
        True, True, True, "ready", "duplicate refused", True, None, False, "disconnected", 0]


def _policy_drives_regeneration(pk, tmp_path):
    d = _daemon(pk, tmp_path, dry_mode=True)
    try:
        server = d.endpoint_create(1, ipv4="10.0.0.1", labels=["k8s:app=server"])
        client = d.endpoint_create(2, ipv4="10.0.0.2", labels=["k8s:app=client"])
        d.build_queue.wait_idle(10)
        rev = d.policy_add(pk.policy.rules_from_json(POLICY))
        d.build_queue.wait_idle(10)
        regenerated = wait_for(lambda: server.policy_revision >= rev)
        cid = client.security_identity.id
        allowed = server.policy_map.lookup(cid, 80, 6, 0)
        denied = server.policy_map.lookup(99999, 80, 6, 0)
        rev2, deleted = d.policy_delete(pk.labels.LabelArray.parse("k8s:policy=web"))
        idle = d.build_queue.wait_idle(10)
        reverted = wait_for(lambda: server.policy_revision >= rev2)
        return (rev, regenerated, allowed, denied, rev2, deleted, idle, reverted,
                server.policy_map.lookup(99999, 80, 6, 0), d.policy.num_rules())
    finally:
        d.close()


def test_policy_drives_regeneration_matches_reference(tmp_path):
    rev, regenerated, allowed, denied, rev2, deleted, idle, reverted, _, n = both(
        _policy_drives_regeneration, tmp_path, seed=2)
    assert rev > 1 and regenerated and allowed[0] and not denied[0]
    assert rev2 > rev and deleted == 1 and idle and reverted and n == 0


def _restore(pk, tmp_path):
    cfg = config(pk, tmp_path / pk.name, dry_mode=True)
    d1 = pk.daemon.Daemon(cfg, node_name="n1")
    d1.endpoint_create(42, ipv4="10.0.0.42", labels=["k8s:app=x"])
    d1.build_queue.wait_idle(10)
    ep = d1.endpoint_manager.lookup(42)
    ep.write_state(d1._state_dir())
    ident = ep.security_identity.id
    d1.close()
    d2 = pk.daemon.Daemon(cfg, node_name="n1")
    try:
        found = d2.endpoint_manager.lookup(42) is not None
        d2.build_queue.wait_idle(10)
        restored = d2.endpoint_manager.lookup(42)
        return (found, restored.security_identity.labels.get_model(), restored.security_identity.id == ident,
                restored.ipv4, d2.ipcache.lookup_by_ip("10.0.0.42") == restored.security_identity.id,
                restored.state.value, restored.device.type if pk.name == "cilium_tpu_torch" else "cpu")
    finally:
        d2.close()


def test_restore_matches_reference(tmp_path):
    found, labels, _, ipv4, in_ipcache, state, device = both(_restore, tmp_path, seed=3)
    assert (found, labels, ipv4, in_ipcache, state, device) == (True, ["k8s:app=x"], "10.0.0.42", True, "ready",
                                                                "cpu")


def _status(pk, tmp_path):
    d = _daemon(pk, tmp_path, dry_mode=True)
    try:
        st = d.status()
        return (sorted(st), st["cilium"]["state"], st["policy"]["revision"] >= 1,
                sorted(c["name"] for c in st["controllers"]), st["endpoints"], st["verdict_service"],
                sorted(st["kvstore"]), st["node"], sorted(st["proxy"]))
    finally:
        d.close()


def test_status_matches_reference(tmp_path):
    keys, state, revision, controllers, eps, vs, kv_keys, node, proxy = both(_status, tmp_path)
    assert state == "Ok" and revision and "ct-gc" in controllers and vs is None
    assert eps == {"total": 0, "by_state": {}} and node == "test-node"


# --- a seeded world through both daemons, the device export on --------------------------

WORLD_RULES = 64
WORLD_IDENTITIES = 16
WORLD_ENDPOINTS = 8


def _world(pk, tmp_path):
    """The world's canonical state from ``pk``'s daemon: identities by
    labels, the ipcache and its datapath map, per endpoint its identity,
    revision, realized entries, redirects and K13 outputs, and the
    distribution cache's resources; proxy ports as redirect ids."""
    ids = entry.policy_identities()
    doc = entry.policy_rules(WORLD_RULES)
    ranked = sorted(sorted(ids), key=lambda n: -sum(
        all(f"{k}={v}" in ids[n] for k, v in r["endpointSelector"]["matchLabels"].items()) for r in doc))
    chosen = ranked[:WORLD_IDENTITIES]
    d = _daemon(pk, tmp_path, dry_mode=False, enable_health=False)
    try:
        for n in chosen[WORLD_ENDPOINTS:]:  # remote pods' identities
            d.identity_allocator.allocate(pk.labels.Labels.from_model(ids[n]))
        rev = d.policy_add(pk.policy.rules_from_json(json.dumps(doc)))
        eps = [d.endpoint_create(i + 1, ipv4=f"10.50.0.{i + 1}", labels=ids[n])
               for i, n in enumerate(chosen[:WORLD_ENDPOINTS])]
        assert wait_for(lambda: all(ep.state.value == "ready" and ep.policy_revision >= rev for ep in eps), 120)
        assert d.build_queue.wait_idle(60)
        port_of = {r.proxy_port: pid for pid, r in d.proxy_manager.redirects.items()}
        cache = d.get_identity_cache()
        identities = sorted((tuple(sorted(lbls.get_model())), n) for n, lbls in cache.items())
        rng = np.random.default_rng(7)
        pool = np.asarray(sorted(cache) + [4242, 99_999], np.int32)
        q = (rng.choice(pool, 1024).astype(np.int32), rng.choice(np.array([0, 80, 9092, 443], np.int32), 1024),
             rng.choice(np.array([0, 6, 17], np.int32), 1024))
        out_eps = {}
        for ep in eps:
            dm = ep.device_policy_map
            if pk.name == "cilium_tpu":
                got = [np.asarray(x) for x in pk.policymap.policy_can_access_batch(dm, *q, pk.policymap.DIR_INGRESS)]
            else:
                assert dm.table.keys.device.type == "cpu"
                got = [x.numpy() for x in pk.policymap.policy_can_access_batch(
                    dm, *(torch.from_numpy(a) for a in q), pk.policymap.DIR_INGRESS)]
            realized = sorted(((k.identity, k.dest_port, k.proto, k.direction), port_of.get(v.proxy_port, 0))
                              for k, v in ep.realized_map_state.items())
            out_eps[ep.id] = dict(
                identity=ep.security_identity.id, revision=ep.policy_revision, realized=realized,
                redirects=sorted(ep.realized_redirects), allowed=got[0].astype(bool).tolist(),
                proxy=[port_of.get(int(p), int(p)) for p in got[1]])
        res = d.dist_cache.get_resources(pk.distribution.TYPE_NETWORK_POLICY, since_version=0)
        resources = {name: {**r, "redirects": sorted(r["redirects"])} for name, r in res.resources.items()}
        ipcache = sorted((p.ip, p.identity, p.tunnel_endpoint, p.host_ip) for p in d.ipcache.dump())
        ipmap = sorted((k, info.sec_label) for t in (d.ipcache_map.v4, d.ipcache_map.v6)
                       for k, (_, info) in t.items())
        return dict(identities=identities, endpoints=out_eps, resources=resources, ipcache=ipcache, ipmap=ipmap,
                    redirects=sorted(d.proxy_manager.redirects), rules=d.policy.num_rules())
    finally:
        d.close()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("daemon-world")
    saved = {name: (pk.option.config, pk.kvstore._default_client) for name, pk in PKGS.items()}
    try:
        return {name: _world_seeded(pk, tmp) for name, pk in PKGS.items()}
    finally:
        for name, pk in PKGS.items():
            pk.option.config, pk.kvstore._default_client = saved[name]


def _world_seeded(pk, tmp):
    import random

    random.seed(64)
    return _world(pk, tmp)


@pytest.mark.parametrize("part", ["identities", "ipcache", "ipmap", "redirects", "rules"])
def test_world_state_matches_reference(worlds, part):
    assert worlds["port"][part] == worlds["ref"][part]


@pytest.mark.parametrize("ep_id", range(1, WORLD_ENDPOINTS + 1))
def test_world_endpoint_maps_and_k13_match_reference(worlds, ep_id):
    ref, port = worlds["ref"]["endpoints"][ep_id], worlds["port"]["endpoints"][ep_id]
    assert port == ref
    assert ref["realized"] and any(ref["allowed"]) and not all(ref["allowed"])


def test_world_distribution_resources_match_reference(worlds):
    assert worlds["port"]["resources"] == worlds["ref"]["resources"]
    assert len(worlds["ref"]["resources"]) == WORLD_ENDPOINTS
    assert any(r["redirects"] for r in worlds["ref"]["resources"].values())


# --- tests/test_npds_push.py's two cases ---------------------------------------------

HTTP_RULE = {
    "endpointSelector": {"matchLabels": {"app": "server"}},
    "labels": ["k8s:policy=http-test"],
    "ingress": [{"fromEndpoints": [{"matchLabels": {"app": "client"}}],
                 "toPorts": [{"ports": [{"port": "80", "protocol": "TCP"}],
                              "rules": {"http": [{"method": "GET", "path": "/public/.*"}]}}]}],
}


def _requests(seed=11, n=12):
    rng = np.random.default_rng(seed)
    paths = ["/public/index.html", "/public/a/b", "/admin", "/public", "/private/x", "/public/"]
    methods = ["GET", "GET", "POST", "PUT"]
    return [f"{methods[rng.integers(4)]} {paths[rng.integers(len(paths))]} HTTP/1.1\r\nHost: h\r\n\r\n".encode()
            for _ in range(n)]


def _services(pk):
    import importlib

    service = importlib.import_module(f"{pk.name}.sidecar.service")
    client = importlib.import_module(f"{pk.name}.sidecar.client")
    return service.VerdictService, client.SidecarClient


def _npds_drives_verdicts(pk, tmp_path):
    VerdictService, SidecarClient = _services(pk)
    pk.instance.reset_module_registry()
    root = tmp_path / pk.name
    root.mkdir()
    svc = VerdictService(str(root / "vs.sock"),
                         pk.option.DaemonConfig(batch_timeout_ms=2.0, **pk.cfg_kw)).start()
    d = pk.daemon.Daemon(config(pk, root, dry_mode=True, enable_health=False))
    shim_client = None
    try:
        rules = pk.policy.rules_from_json(json.dumps([HTTP_RULE]))
        d.policy_add(rules)
        client_ep = d.endpoint_create(11, ipv4="10.9.0.11", labels=["k8s:app=client"])
        server_ep = d.endpoint_create(12, ipv4="10.9.0.12", labels=["k8s:app=server"])
        assert wait_for(lambda: server_ep.desired_l4_policy is not None)
        pusher = d.attach_verdict_service(svc.socket_path)
        attached = (pusher.pushes >= 1, pusher.nacks)
        shim_client = SidecarClient(svc.socket_path)
        mod = shim_client.open_module([])
        cid, sid = client_ep.security_identity.id, server_ep.security_identity.id

        def conn(conn_id, remote):
            res, shim = shim_client.new_connection(mod, "http", conn_id, True, remote, sid, "10.9.0.11:40000",
                                                   "10.9.0.12:80", "10.9.0.12")
            assert res == int(pk.types.FilterResult.OK)
            return shim

        def drive(conn_id, remote):
            shim = conn(conn_id, remote)
            return [shim.on_io(False, r)[1] for r in _requests()] + [shim.on_io(True, b"")[1]]

        before = drive(9001, cid)
        stranger = drive(9002, 99999)
        pushes = pusher.pushes
        _, deleted = d.policy_delete(rules[0].labels)
        ok_req = b"GET /public/index.html HTTP/1.1\r\n\r\n"
        changed = wait_for(lambda: pusher.pushes > pushes and conn(9003, cid).on_io(False, ok_req)[1] == b"")
        d.build_queue.wait_idle(10)
        after = drive(9004, cid)
        return attached, before, stranger, deleted, changed, after, pusher.nacks
    finally:
        if shim_client is not None:
            shim_client.close()
        d.close()
        svc.stop()
        pk.instance.reset_module_registry()


def test_daemon_policy_drives_verdict_service_matches_reference(tmp_path):
    attached, before, stranger, deleted, changed, after, nacks = both(_npds_drives_verdicts, tmp_path, seed=5)
    http_403 = PKGS["ref"].http_parser.HTTP_403
    assert attached == (True, 0) and nacks == 0 and deleted == 1 and changed
    assert any(before[:-1]) and not all(before[:-1])
    assert before[-1] == http_403 * sum(1 for out in before[:-1] if not out)  # a 403 a denied request
    assert not any(stranger[:-1]) and not any(after[:-1])


def _verdict_service_status(pk, tmp_path):
    VerdictService, _ = _services(pk)
    pk.instance.reset_module_registry()
    root = tmp_path / pk.name
    root.mkdir()
    svc = VerdictService(str(root / "vs.sock"),
                         pk.option.DaemonConfig(batch_timeout_ms=2.0, **pk.cfg_kw)).start()
    d = pk.daemon.Daemon(config(pk, root, dry_mode=True, enable_health=False))
    try:
        unattached = d.status()["verdict_service"]
        d.attach_verdict_service(svc.socket_path)
        st = d.status()["verdict_service"]
        return (unattached, st["state"], st["npds_pushes"] >= 0, st["npds_nacks"],
                all(k in st for k in ("dispatcher", "connections", "requests")))
    finally:
        d.close()
        svc.stop()
        pk.instance.reset_module_registry()


def test_verdict_service_status_surfaces_in_daemon_matches_reference(tmp_path):
    assert both(_verdict_service_status, tmp_path) == (None, "Ok", True, 0, True)


# --- no card: the port's daemon refuses to start, and leaks nothing -------------------


def _open_fds():
    return sorted(os.listdir("/proc/self/fd"))


def test_daemon_without_a_card_raises_and_leaks_nothing(tmp_path, monkeypatch):
    port = PKGS["port"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg_before, client_before = port.option.config, port.kvstore._default_client
    threads, fds = set(threading.enumerate()), _open_fds()
    for cfg in (port.option.DaemonConfig(),
                port.option.DaemonConfig(run_dir=str(tmp_path), dry_mode=True, kvstore="file"),
                port.option.DaemonConfig(run_dir=str(tmp_path), pprof=True, pprof_port=0)):
        with pytest.raises(RuntimeError, match="CUDA device"):
            port.daemon.Daemon(cfg)
    assert set(threading.enumerate()) == threads and _open_fds() == fds
    assert port.option.config is cfg_before and port.kvstore._default_client is client_before
    assert not os.listdir(tmp_path)


def test_daemon_device_follows_verdict_device(tmp_path):
    port = PKGS["port"]
    d = port.daemon.Daemon(config(port, tmp_path, dry_mode=True, enable_health=False))
    try:
        ep = d.endpoint_create(5, ipv4="10.0.0.5", labels=["k8s:app=x"])
        from cilium_tpu_torch.runtime.engines import _daemon_device

        assert d.device.type == "cpu" and d.prefilter.device.type == "cpu"
        assert d.endpoint_manager.device.type == "cpu" and ep.device.type == "cpu"
        assert _daemon_device(d) == "cpu"
    finally:
        d.close()
