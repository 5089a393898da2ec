"""The port's workload runtime integration and orchestrator plugins
(``cilium_tpu_torch/workloads/``, ``plugins/docker.py``, the CNI lifecycle
of ``k8s/cni.py``) against the reference's.

The cases of tests/test_workloads.py and tests/test_plugins.py run through
both packages (tests/agent_cases.py), each daemon on the CPU; what each
scenario observes must be equal (tolerance 0).
"""

from __future__ import annotations

import importlib
import time

import k8s_world as kw
from agent_cases import PKGS, agent_globals, both, config, wait_for  # noqa: F401 (a fixture)
from policy_cases import reference_leak_guard  # noqa: F401 (a module fixture)

for _pk in PKGS.values():
    for _attr, _mod in (("workloads", "workloads"), ("cni", "k8s.cni"), ("ipam", "k8s.ipam"),
                        ("docker", "plugins.docker"), ("connector", "endpoint.connector")):
        setattr(_pk, _attr, importlib.import_module(f"{_pk.name}.{_mod}"))


def _daemon(pk, tmp_path):
    return pk.daemon.Daemon(config(pk, tmp_path / pk.name, dry_mode=True, enable_health=False))


def _with_daemon(body):
    def run(pk, tmp_path):
        d = _daemon(pk, tmp_path)
        try:
            return body(pk, d, tmp_path)
        finally:
            d.close()
    return run


def _labels(ep):
    return sorted(str(lbl) for lbl in ep.labels.values())


# --- tests/test_workloads.py ----------------------------------------------------------


def _registry(pk):
    rt = pk.workloads.get_runtime("docker")
    try:
        pk.workloads.get_runtime("rkt")
    except ValueError:
        refused = True
    else:
        refused = False
    return pk.workloads.registered_runtimes(), rt.status()["state"], refused


def test_runtime_registry_has_reference_modules_matches_reference():
    runtimes, state, refused = both(_registry)
    assert {"docker", "crio", "containerd"} <= set(runtimes) and state == "failure" and refused


@_with_daemon
def _start_event(pk, d, tmp_path):
    rt = kw.fake_runtime(pk.workloads)
    rt.add("c1" * 32, {"app": "web", "tier": "fe"}, ipv4="10.7.0.1")
    d.endpoint_create(301, ipv4="10.7.0.1", container_name="c1" * 32)
    w = pk.workloads.WorkloadWatcher(d, rt)
    try:
        w.enqueue("c1" * 32, pk.workloads.EventType.START)
        w.flush()
        ep = d.endpoint_manager.lookup(301)
        return _labels(ep), ep.security_identity.id >= 256, w.events_handled
    finally:
        w.close()


def test_start_event_applies_runtime_labels_matches_reference(tmp_path):
    labels, user_identity, _ = both(_start_event, tmp_path, seed=11)
    assert labels == ["container:app=web", "container:tier=fe"] and user_identity


@_with_daemon
def _delete_event(pk, d, tmp_path):
    rt = kw.fake_runtime(pk.workloads)
    rt.add("dead01", {"app": "db"})
    d.endpoint_create(302, container_name="dead01")
    w = pk.workloads.WorkloadWatcher(d, rt)
    try:
        w.enqueue("dead01", pk.workloads.EventType.DELETE)
        w.flush()
        return wait_for(lambda: d.endpoint_manager.lookup(302) is None, 5.0)
    finally:
        w.close()


def test_delete_event_removes_endpoint_matches_reference(tmp_path):
    assert both(_delete_event, tmp_path, seed=12) is True


@_with_daemon
def _correlation_retries(pk, d, tmp_path):
    rt = kw.fake_runtime(pk.workloads)
    rt.add("late77", {"app": "late"}, ipv4="10.7.0.9")
    w = pk.workloads.WorkloadWatcher(d, rt, max_retries=20)
    try:
        w.enqueue("late77", pk.workloads.EventType.START)
        time.sleep(0.1)
        d.endpoint_create(303, ipv4="10.7.0.9", container_name="late77")
        ok = wait_for(lambda: "container:app=late" in _labels(d.endpoint_manager.lookup(303)), 5.0)
        return ok, _labels(d.endpoint_manager.lookup(303))
    finally:
        w.close()


def test_correlation_retries_until_endpoint_appears_matches_reference(tmp_path):
    assert both(_correlation_retries, tmp_path, seed=13) == (True, ["container:app=late"])


@_with_daemon
def _periodic_sync(pk, d, tmp_path):
    rt = kw.fake_runtime(pk.workloads)
    rt.add("seen-by-sync", {"role": "worker"}, ipv4="10.7.0.20")
    d.endpoint_create(304, ipv4="10.7.0.20", container_name="seen-by-sync")
    w = pk.workloads.WorkloadWatcher(d, rt)
    try:
        w.sync_with_runtime()
        w.flush()
        ep = d.endpoint_manager.lookup(304)
        ok = wait_for(lambda: _labels(ep) == ["container:role=worker"], 5.0)
        handled = w.events_handled
        w.sync_with_runtime()
        w.flush()
        return ok, _labels(ep), w.events_handled == handled
    finally:
        w.close()


def test_periodic_sync_discovers_unseen_workloads_matches_reference(tmp_path):
    assert both(_periodic_sync, tmp_path, seed=14) == (True, ["container:role=worker"], True)


@_with_daemon
def _serialized(pk, d, tmp_path):
    rt = kw.fake_runtime(pk.workloads)
    rt.add("ordered", {"app": "x"})
    d.endpoint_create(305, container_name="ordered")
    w = pk.workloads.WorkloadWatcher(d, rt)
    try:
        w.enqueue("ordered", pk.workloads.EventType.START)
        w.enqueue("ordered", pk.workloads.EventType.DELETE)
        w.flush()
        return wait_for(lambda: d.endpoint_manager.lookup(305) is None, 5.0)
    finally:
        w.close()


def test_events_for_one_container_are_serialized_matches_reference(tmp_path):
    assert both(_serialized, tmp_path, seed=15) is True


# --- tests/test_plugins.py: the CNI lifecycle -------------------------------------------


@_with_daemon
def _cni_interfaces(pk, d, tmp_path):
    cni = pk.cni.CniPlugin(d, pk.ipam.IpamAllocator("10.8.0.0/24"), mtu=1450)
    res = cni.cni_add("cont-1", "ns1", "pod-a", netns="/proc/123/ns/net")
    veth = cni.interfaces("cont-1")
    return vars(res), vars(veth), pk.connector.setup_veth("cont-1", "x").host_ifname


def test_cni_add_provisions_interfaces_matches_reference(tmp_path):
    res, veth, again = both(_cni_interfaces, tmp_path, seed=21)
    assert veth["host_ifname"].startswith("lxc") and len(veth["host_ifname"]) == 13 and again == veth["host_ifname"]
    assert veth["container_ifname"] == "eth0" and veth["moved_to_netns"] and veth["mtu"] == 1450
    assert res["routes"] == [f"0.0.0.0/0 via {res['gateway']}"] and res["container_mac"] == veth["container_mac"]


def _check(pk, cni, cid):
    try:
        cni.cni_check(cid)
    except pk.cni.CniError as e:
        return f"CniError: {e}"
    return "ok"


@_with_daemon
def _cni_check(pk, d, tmp_path):
    cni = pk.cni.CniPlugin(d, pk.ipam.IpamAllocator("10.8.0.0/24"))
    out = [_check(pk, cni, "nope")]
    res = cni.cni_add("cont-2", "ns1", "pod-b")
    out.append(_check(pk, cni, "cont-2"))
    d.endpoint_delete(res.endpoint_id)
    return out + [_check(pk, cni, "cont-2")]


def test_cni_check_semantics_matches_reference(tmp_path):
    before, ok, after = both(_cni_check, tmp_path, seed=22)
    assert before.startswith("CniError") and ok == "ok" and after.startswith("CniError")


@_with_daemon
def _cni_del(pk, d, tmp_path):
    ipam = pk.ipam.IpamAllocator("10.8.0.0/29")
    cni = pk.cni.CniPlugin(d, ipam)
    res = cni.cni_add("cont-3", "ns1", "pod-c")
    return (cni.cni_del("cont-3"), cni.cni_del("cont-3"), cni.cni_del("never-added"), cni.interfaces("cont-3"),
            ipam.allocate_ip(res.ip, "reuse") == res.ip)


def test_cni_del_idempotent_and_releases_matches_reference(tmp_path):
    assert both(_cni_del, tmp_path, seed=23) == (True, False, False, None, True)


# --- tests/test_plugins.py: the libnetwork driver ----------------------------------------


@_with_daemon
def _libnetwork(pk, d, tmp_path):
    sock = str(tmp_path / pk.name / "docker.sock")
    drv = pk.docker.LibnetworkDriver(d, pk.ipam.IpamAllocator("10.11.0.0/24")).serve(sock)
    def post(route, body):
        return kw.unix_post(sock, f"/{route}", body)

    try:
        out = [post("Plugin.Activate", {}), post("NetworkDriver.GetCapabilities", {}),
               post("NetworkDriver.CreateNetwork", {"NetworkID": "n1"}),
               post("NetworkDriver.CreateEndpoint", {"EndpointID": "e1", "Interface": {}}),
               post("NetworkDriver.CreateEndpoint", {"EndpointID": "e1", "Interface": {"Address": "10.11.0.7/24"}}),
               d.ipcache.lookup_by_ip("10.11.0.7") is not None,
               post("NetworkDriver.CreateEndpoint", {"EndpointID": "e1", "Interface": {"Address": "10.11.0.8/24"}}),
               post("NetworkDriver.Join", {"EndpointID": "e1", "SandboxKey": "/sb/1"}),
               post("NetworkDriver.EndpointOperInfo", {"EndpointID": "e1"}),
               post("NetworkDriver.Leave", {"EndpointID": "e1"}),
               post("NetworkDriver.DeleteEndpoint", {"EndpointID": "e1"}),
               d.ipcache.lookup_by_ip("10.11.0.7"),
               post("NetworkDriver.Join", {"EndpointID": "e1"})]
        return out
    finally:
        drv.close()


def test_libnetwork_driver_protocol_matches_reference(tmp_path):
    out = both(_libnetwork, tmp_path, seed=24)
    assert out[0] == (200, {"Implements": ["NetworkDriver"]}) and out[1][1]["Scope"] == "local"
    assert out[3][0] == 400 and "No IPv4" in out[3][1]["Err"] and out[4] == (200, {"Interface": {}}) and out[5]
    assert out[6][0] == 400 and "already exists" in out[6][1]["Err"]
    join = out[7][1]
    assert out[7][0] == 200 and join["InterfaceName"]["DstPrefix"] == "eth" and join["Gateway"] == "10.11.0.1"
    assert join["InterfaceName"]["SrcName"].startswith("tmp") and out[8][0] == 200 and out[10][0] == 200
    assert out[11] is None and out[12][0] == 400 and "unknown endpoint" in out[12][1]["Err"]
