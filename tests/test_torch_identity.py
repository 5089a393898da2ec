"""The port's identity, ipcache and node modules against the reference.

Scenarios from tests/test_kvstore_identity.py (reserved identities, the
allocator's round trip and cross-node convergence, owner notification,
the IP -> identity cache and its listeners, ``datapath_listener`` into
each package's ``IpcacheMap``, kvstore sync between two caches, shared
stores and node discovery), run through both packages
(tests/state_cases.py) with label sets and IPs from numpy seeds; the
allocated ids, cache and map contents and node views must be equal.
Host code only.
"""

from __future__ import annotations

import numpy as np
import pytest

from policy_cases import reference_leak_guard  # noqa: F401
from state_cases import PKGS, both, ipcache_contents, label_sets, wait_for


def _identities(pk, sets):
    idm = pk.identity
    L = pk.labels.Labels
    out = [idm.ReservedIdentities["host"].id == idm.RESERVED_HOST,
           idm.look_up_reserved_identity(idm.RESERVED_WORLD).labels.get_model()]
    b = pk.kvstore.LocalBackend()
    notified = []
    a1 = idm.IdentityAllocator(backend=b, node_name="n1", owner_notify=lambda: notified.append(1))
    a2 = idm.IdentityAllocator(backend=b, node_name="n2")
    ident, new = a1.allocate(L.from_model(["reserved:host"]))
    out.append((ident.id, new))
    for lbls in sets:
        i1, n1 = a1.allocate(L.from_model(lbls))
        i2, n2 = a2.allocate(L.from_model(lbls))
        got = a2.lookup_by_id(i1.id)
        out.append((i1.id, n1, i2.id, n2, got.labels.equals(i1.labels), a1.lookup(i1.labels).id))
    out.append(wait_for(lambda: len(notified) > 0))
    out.append(wait_for(lambda: set(a1.get_identity_cache()) == set(a2.get_identity_cache())))
    out.append(sorted((i, sorted(lbls.get_model())) for i, lbls in a1.get_identity_cache().items()))
    out.append(a1.release(a1.lookup(L.from_model(sets[0]))))
    a1.close()
    a2.close()
    return out


@pytest.mark.parametrize("seed", [0, 4])
def test_identity_allocation_matches_reference(seed):
    sets = label_sets(np.random.default_rng(seed), 16)
    out = both(_identities, sets, seed=seed)
    assert out[:3] == [True, ["reserved:world"], (1, False)]
    rows = out[3:3 + len(sets)]
    assert all(r[0] == r[2] and r[1] and not r[3] and r[4] and r[5] == r[0] for r in rows)
    assert all(r[0] >= 256 for r in rows) and out[3 + len(sets):5 + len(sets)] == [True, True]


def _ip_cache(pk, ips, ids):
    ipc = pk.ipcache
    c = ipc.IPIdentityCache()
    events = []
    m = pk.ipcache_map.IpcacheMap()
    c.add_listener(lambda e, ip, p: events.append((e, ip, None if p is None else p.identity)))
    for ip, i in zip(ips, ids):
        c.upsert(ip, int(i), tunnel_endpoint=int(i) * 7)
    c.add_listener(ipc.datapath_listener(m))
    out = [c.upsert(ips[0], int(ids[0]), tunnel_endpoint=int(ids[0]) * 7),
           c.upsert(ips[0], 999), c.lookup_by_ip(ips[0]), sorted(c.lookup_by_identity(999))]
    out += [c.delete(ips[1]), c.delete(ips[1])]
    out += [ipcache_contents(m), events, [(p.ip, p.identity, p.tunnel_endpoint) for p in c.dump()]]
    out.append(None if m.lookup(ips[1]) is None else m.lookup(ips[1]).sec_label)
    out.append(m.lookup(ips[2]).sec_label)
    return out


def test_ip_cache_and_datapath_listener_match_reference():
    rng = np.random.default_rng(7)
    ips = [f"10.{a}.{b}.{c}" for a, b, c in rng.integers(1, 250, (40, 3))] + ["fd00::1", "10.9.0.0/16"]
    ids = rng.integers(256, 2000, len(ips))
    out = both(_ip_cache, ips, ids)
    assert out[:6] == [False, True, 999, [ips[0]], True, False]
    assert len(out[6]) == len(set(ips)) - 1


def _kvstore_sync(pk, ips, ids):
    b = pk.kvstore.LocalBackend()
    c1, c2 = pk.ipcache.IPIdentityCache(), pk.ipcache.IPIdentityCache()
    m = pk.ipcache_map.IpcacheMap()
    c2.add_listener(pk.ipcache.datapath_listener(m))
    s1 = pk.ipcache.KvstoreIPSync(c1, backend=b)
    s2 = pk.ipcache.KvstoreIPSync(c2, backend=b)
    s2.start_watcher()
    for ip, i in zip(ips, ids):
        s1.upsert_to_kvstore(pk.ipcache.IPIdentityPair(ip, int(i), tunnel_endpoint=0x0A000001))
    out = [wait_for(lambda: len(c2.dump()) == len(ips))]
    out.append(ipcache_contents(m))
    for ip in ips[::4]:
        s1.delete_from_kvstore(ip)
    out.append(wait_for(lambda: len(c2.dump()) == len(ips) - len(ips[::4])))
    out.append(ipcache_contents(m))
    s2.stop()
    return out


def test_kvstore_ip_sync_matches_reference():
    rng = np.random.default_rng(9)
    ips = sorted({f"10.1.{a}.{b}" for a, b in rng.integers(0, 256, (64, 2))})
    ids = rng.integers(256, 4000, len(ips))
    out = both(_kvstore_sync, ips, ids)
    assert out[0] and out[2] and len(out[1]) == len(ips)


def _nodes(pk):
    b = pk.kvstore.LocalBackend()
    N = pk.node.Node
    n1 = pk.node.NodeDiscovery(N(name="node1", ipv4_address="192.168.0.1",
                                 ipv4_alloc_cidr="10.1.0.0/16"), backend=b)
    updates = []
    n2 = pk.node.NodeDiscovery(N(name="node2", ipv4_address="192.168.0.2"), backend=b,
                               on_node_update=lambda n: updates.append(n.name))
    out = [wait_for(lambda: "default/node1" in n2.get_nodes())]
    out.append(n2.get_nodes()["default/node1"].to_dict())
    n1.update_local(ipv4_health_ip="10.1.0.4")
    out.append(wait_for(lambda: n2.get_nodes()["default/node1"].ipv4_health_ip == "10.1.0.4"))
    out.append(sorted(n1.get_nodes()))
    n1.close()
    out.append(wait_for(lambda: "default/node1" not in n2.get_nodes()))
    n2.close()
    out.append(sorted(set(updates)))
    return out


def test_node_discovery_matches_reference():
    out = both(_nodes)
    assert out[0] and out[2] and out[4] and out[1]["IPv4AllocCIDR"] == "10.1.0.0/16"
