"""The control-to-data-plane path of the port against the reference's.

tests/test_full_stack.py's two cases (a CNP through the fake API server,
the watcher, the repository, endpoint regeneration, the NPDS push and the
verdict service down to shim verdicts; a restarted daemon restoring
enforcement) run through both packages (tests/agent_cases.py), each
daemon and service on the CPU.  Then tests/k8s_world.py's node at
``SMALL`` (12 pods, 8 NetworkPolicies, 6 HTTP CNPs and 2 toServices CNPs,
12 Services x 3) through both: identities by labels, every endpoint's
realized map, the LB map, IPAM, the toServices CIDRs and the shim verdicts
of a verdict service on each node's NPDS, before and after churn (a CNP
deleted through the API server, backends cut, pods deleted through CNI).
Outputs must be equal (tolerance 0).
"""

from __future__ import annotations

import importlib
import json

import pytest

import k8s_world as kw
from agent_cases import PKGS, agent_globals, both, config, wait_for  # noqa: F401 (a fixture)
from policy_cases import reference_leak_guard  # noqa: F401 (a module fixture)

for _pk in PKGS.values():
    for _attr, _mod in (("service_mod", "sidecar.service"), ("client_mod", "sidecar.client"),
                        ("npds", "proxy.npds_push")):
        setattr(_pk, _attr, importlib.import_module(f"{_pk.name}.{_mod}"))

NS = "team-a"
OK = b"GET /v1/users HTTP/1.1\r\n\r\n"
BAD = b"DELETE /v1/users HTTP/1.1\r\n\r\n"


def _service(pk, path):
    return pk.service_mod.VerdictService(str(path), pk.option.DaemonConfig(batch_timeout_ms=2.0,
                                                                           **pk.cfg_kw)).start()


# --- tests/test_full_stack.py ------------------------------------------------------------


def _cnp_to_sidecar(pk, tmp_path):
    pk.instance.reset_module_registry()
    root = tmp_path / pk.name
    root.mkdir()
    svc = _service(pk, root / "vs.sock")
    d = pk.daemon.Daemon(config(pk, root, dry_mode=True, enable_health=False))
    k8s = importlib.import_module(f"{pk.name}.k8s")
    apisrv = k8s.FakeApiServer()
    watcher = k8s.K8sWatcher(d, apisrv).start()
    sc = None
    try:
        ns_label = f"k8s:io.kubernetes.pod.namespace={NS}"
        client_ep = d.endpoint_create(21, ipv4="10.20.0.21", labels=["k8s:app=frontend", ns_label])
        server_ep = d.endpoint_create(22, ipv4="10.20.0.22", labels=["k8s:app=api", ns_label])
        apisrv.upsert("CiliumNetworkPolicy", {"metadata": {"name": "api-allow", "namespace": NS}, "spec": {
            "endpointSelector": {"matchLabels": {"app": "api"}},
            "ingress": [{"fromEndpoints": [{"matchLabels": {"app": "frontend"}}],
                         "toPorts": [{"ports": [{"port": "80", "protocol": "TCP"}],
                                      "rules": {"http": [{"method": "GET", "path": "/v1/.*"}]}}]}]}})
        watcher.sync()
        out = [d.get_policy_repository().num_rules(),
               wait_for(lambda: server_ep.desired_l4_policy is not None
                        and len(server_ep.desired_l4_policy.ingress) > 0)]
        pusher = d.attach_verdict_service(svc.socket_path)
        out.append(pusher.nacks)
        sc = pk.client_mod.SidecarClient(svc.socket_path)
        mod = sc.open_module([])
        ids = (client_ep.security_identity.id, server_ep.security_identity.id)
        res, shim = sc.new_connection(mod, "http", 31, True, *ids, "10.20.0.21:42000", "10.20.0.22:80", "10.20.0.22")
        out += [res, shim.on_io(False, OK), shim.on_io(False, BAD), shim.on_io(True, b"")]
        apisrv.delete("CiliumNetworkPolicy", NS, "api-allow")
        watcher.sync()
        out.append(d.get_policy_repository().num_rules())

        def revoked():
            r, s = sc.new_connection(mod, "http", 32, True, *ids, "10.20.0.21:42001", "10.20.0.22:80",
                                     "10.20.0.22")
            return r == 0 and s.on_io(False, OK)[1] == b""

        return out + [wait_for(revoked)]
    finally:
        if sc is not None:
            sc.close()
        watcher.stop()
        d.close()
        svc.stop()
        pk.instance.reset_module_registry()


def test_k8s_cnp_to_sidecar_verdicts_matches_reference(tmp_path):
    out = both(_cnp_to_sidecar, tmp_path, seed=41)
    http_403 = PKGS["ref"].http_parser.HTTP_403
    assert out[:4] == [1, True, 0, 0] and out[4][1] == OK and out[5][1] == b"" and out[6][1] == http_403
    assert out[7:] == [0, True]


RESTART_RULE = json.dumps([{
    "endpointSelector": {"matchLabels": {"app": "api"}},
    "labels": ["k8s:policy=restart-test"],
    "ingress": [{"fromEndpoints": [{"matchLabels": {"app": "frontend"}}],
                 "toPorts": [{"ports": [{"port": "80", "protocol": "TCP"}],
                              "rules": {"http": [{"method": "GET", "path": "/v1/.*"}]}}]}],
}])


def _restart(pk, tmp_path):
    pk.instance.reset_module_registry()
    root = tmp_path / pk.name
    root.mkdir()
    svc = _service(pk, root / "vs2.sock")

    def cfg():
        return config(pk, root, dry_mode=True, enable_health=False, state_dir=str(root / "state"), kvstore="file",
                      kvstore_opts={"path": str(root / "kv.json")})

    try:
        d1 = pk.daemon.Daemon(cfg())
        d1.policy_add(pk.policy.rules_from_json(RESTART_RULE))
        c1 = d1.endpoint_create(41, ipv4="10.30.0.41", labels=["k8s:app=frontend"])
        s1 = d1.endpoint_create(42, ipv4="10.30.0.42", labels=["k8s:app=api"])
        assert wait_for(lambda: s1.desired_l4_policy is not None)
        d1.build_queue.wait_idle(10)
        c1.write_state(d1._state_dir())
        s1.write_state(d1._state_dir())
        d1.close()
        d2 = pk.daemon.Daemon(cfg())
        try:
            d2.policy_add(pk.policy.rules_from_json(RESTART_RULE))
            s2 = d2.endpoint_manager.lookup(42)
            out = [len(d2.endpoint_manager), s2 is not None, wait_for(lambda: s2.desired_l4_policy is not None)]
            pusher = d2.attach_verdict_service(svc.socket_path)
            out.append(pusher.nacks)
            sc = pk.client_mod.SidecarClient(svc.socket_path)
            try:
                mod = sc.open_module([])
                res, shim = sc.new_connection(mod, "http", 51, True, d2.endpoint_manager.lookup(41).security_identity.id,
                                              s2.security_identity.id, "10.30.0.41:40000", "10.30.0.42:80",
                                              "10.30.0.42")
                return out + [res, shim.on_io(False, b"GET /v1/x HTTP/1.1\r\n\r\n"),
                              shim.on_io(False, b"POST /v1/x HTTP/1.1\r\n\r\n")]
            finally:
                sc.close()
        finally:
            d2.close()
    finally:
        svc.stop()
        pk.instance.reset_module_registry()


def test_daemon_restart_restores_enforcement_matches_reference(tmp_path):
    out = both(_restart, tmp_path, seed=42)
    assert out[:5] == [2, True, True, 0, 0] and out[5][1] == b"GET /v1/x HTTP/1.1\r\n\r\n" and out[6][1] == b""


# --- tests/k8s_world.py's node at SMALL ----------------------------------------------------


def _canonical(w):
    """The node's state with identities named by their labels and proxy
    ports as redirect presence."""
    d = w.daemon
    eps = {}
    for ep in w.endpoints():
        eps[ep.id] = dict(
            ipv4=ep.ipv4, labels=sorted(ep.labels.get_model()), identity=kw.labels_of(w, ep.security_identity.id),
            state=ep.state.value, ingress=ep.ingress_policy_enabled, egress=ep.egress_policy_enabled,
            realized=sorted((kw.labels_of(w, k.identity), k.dest_port, k.proto, k.direction, v.proxy_port != 0)
                            for k, v in ep.realized_map_state.items()),
            redirects=sorted(ep.realized_redirects))
    return dict(
        endpoints=eps, rules=d.get_policy_repository().num_rules(), cidrs=w.generated_cidrs(),
        lb=sorted((k.address, k.dport, k.slave, v.target, v.port, v.count) for k, v in d.lb_map.dump()),
        services=sorted(json.dumps(s.to_model(), sort_keys=True) for s in d.service_manager.list()),
        ipam=w.ipam.dump(), ipcache=sorted((p.ip, kw.labels_of(w, p.identity)) for p in d.ipcache.dump()),
        cnp_status={c["metadata"]["name"]: c["status"]["nodes"]["node-0"]["ok"] for c in w.cnps})


def _small_world(pk, tmp_path):
    pk.instance.reset_module_registry()
    root = tmp_path / pk.name
    root.mkdir()
    svc = _service(pk, root / "vs.sock")
    d = pk.daemon.Daemon(config(pk, root, dry_mode=False, enable_health=False), node_name="node-0")
    w = sc = None
    try:
        w = kw.build_world(kw.modules(pk.name), d, kw.SMALL, seed=5)
        out = {"built": _canonical(w)}
        pusher = d.attach_verdict_service(svc.socket_path)
        sc = pk.client_mod.SidecarClient(svc.socket_path)
        mod = sc.open_module([])
        out["verdicts"], base = kw.shim_verdicts(w, pk.npds.network_policy_for_endpoint, sc, mod, 100)
        gone = next(c["metadata"]["name"] for c in w.cnps if "ingress" in c["spec"])
        pushes = pusher.pushes
        kw.delete_cnp(w, gone)
        w.settle("the node after the CNP delete")
        assert wait_for(lambda: pusher.pushes > pushes)
        kw.cut_backends(w, 2, 1)
        kw.cni_del(w, 2)
        w.settle("the node after the churn")
        out["churned"] = _canonical(w)
        out["verdicts-churned"], _ = kw.shim_verdicts(w, pk.npds.network_policy_for_endpoint, sc, mod, base)
        out["nacks"] = pusher.nacks
        return out
    finally:
        if sc is not None:
            sc.close()
        if w is not None:
            w.close()
        d.close()
        svc.stop()
        pk.instance.reset_module_registry()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    import random

    tmp = tmp_path_factory.mktemp("k8s-world")
    saved = {name: (pk.option.config, pk.kvstore._default_client) for name, pk in PKGS.items()}
    try:
        out = {}
        for name, pk in PKGS.items():
            random.seed(43)
            pk.policy.set_policy_enabled("default")
            out[name] = _small_world(pk, tmp)
        return out
    finally:
        for name, pk in PKGS.items():
            pk.option.config, pk.kvstore._default_client = saved[name]


@pytest.mark.parametrize("stage", ["built", "churned"])
@pytest.mark.parametrize("part", ["endpoints", "rules", "cidrs", "lb", "services", "ipam", "ipcache", "cnp_status"])
def test_small_world_matches_reference(worlds, stage, part):
    assert worlds["port"][stage][part] == worlds["ref"][stage][part]


@pytest.mark.parametrize("stage", ["verdicts", "verdicts-churned"])
def test_small_world_verdicts_match_reference(worlds, stage):
    ref = worlds["ref"][stage]
    assert worlds["port"][stage] == ref and worlds["port"]["nacks"] == worlds["ref"]["nacks"] == 0
    outs = [b for v in ref.values() for b in v[1:-1]]
    assert ref and all(v[0] == 0 for v in ref.values()) and any(outs) and not all(outs)


def test_world_documents_are_the_issue_scale():
    pods = kw.pods(kw.SMALL, 5)
    assert len(pods) == 12 and len(kw.network_policies(kw.SMALL, 5, pods)) == 8
    assert len(kw.cnps(kw.SMALL, 5, pods)) == 6 + 2 and len(kw.services(kw.SMALL, 5)) == 12
    full = kw.Scale()
    pods = kw.pods(full, 17)
    nps, cnps = kw.network_policies(full, 17, pods), kw.cnps(full, 17, pods)
    assert len(pods) == 110 and len({p["namespace"] for p in pods}) == 4
    assert len(nps) == 128 and sum(1 for n in nps if "ipBlock" in json.dumps(n)) == 124 // 16
    assert len(cnps) == 64 + 4 and sum(1 for c in cnps if "[0-9]" in json.dumps(c)) == 64 // 8
    svcs = kw.services(full, 17)
    assert len(svcs) == 1024 and all(len(e["subsets"][0]["addresses"]) == 8 for _, e in svcs)
    assert kw.pods(full, 17) == pods and kw.cnps(full, 17, pods) == cnps  # made from the seed alone
