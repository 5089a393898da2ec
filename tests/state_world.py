"""The state slice's cluster, built through either package.

Two agents, A and B, share one kvstore server (``kvstore/net.py``), each
with its own ``NetBackend`` client (never the module-level
``kvstore.client``).  They allocate the identities of the policy slice's
label sets (A the first five eighths, B the last five eighths: a quarter
is contended), publish pod IP -> identity pairs through ``KvstoreIPSync``
(half each; A's with its tunnel endpoint), and register as nodes.  B's
``IPIdentityCache`` feeds B's ``IpcacheMap`` through
``datapath_listener``; B's ``ServiceManager`` programs its ``LbMap`` with
ids from the kvstore's ``ServiceIDAllocator``; B's endpoints carry
allocated identities and are regenerated through an ``EndpointManager``
and a ``BuildQueue`` against the policy rules, with a stub owner that ACKs
every push (its proxy manager allocates redirect ports and builds no
engine).  ``churn`` deletes IPs and backends and moves endpoints to new
identities.

``build_world`` takes a namespace of one package's modules (``modules``),
so ``chip_smoke.py`` phase 15 runs the port's at ``Scale()`` (the card)
and tests/test_torch_state_slice.py runs both packages at ``SMALL`` and
compares.  This module imports neither package itself.  Every wait on a
watcher has a timeout.
"""

from __future__ import annotations

import importlib
import ipaddress
import threading
import time
from dataclasses import dataclass
from types import SimpleNamespace

import numpy as np

SUBMODULES = {
    "kvstore": "kvstore", "allocator": "kvstore.allocator", "store": "kvstore.store",
    "identity": "identity", "ipcache": "ipcache", "node": "node", "service": "service",
    "endpoint": "endpoint", "labels": "labels", "policy": "policy", "proxy": "proxy",
    "ipcache_map": "maps.ipcache", "lbmap": "maps.lbmap", "policymap": "maps.policymap",
    "ctmap": "maps.ctmap", "lxcmap": "maps.lxcmap", "option": "utils.option",
    "spanstat": "utils.spanstat",
}
A_NODE, B_NODE = "192.168.10.1", "192.168.10.2"
LB_PORT, BACKEND_PORT = 80, 8080


def modules(pkg: str) -> SimpleNamespace:
    """One package's state-layer and map modules under fixed names."""
    return SimpleNamespace(name=pkg, **{k: importlib.import_module(f"{pkg}.{v}")
                                        for k, v in SUBMODULES.items()})


@dataclass(frozen=True)
class Scale:
    """The cluster's size: the Kubernetes scalability thresholds bound it
    (150,000 pods, 10,000 services); the defaults are phase 15's."""

    identities: int = 512
    ips_per_identity: int = 128
    services: int = 1024
    backends: int = 8
    endpoints: int = 64
    churn_ips: int = 1024
    churn_backends: int = 64
    churn_endpoints: int = 8
    timeout: float = 300.0  # seconds a convergence may take


SMALL = Scale(identities=24, ips_per_identity=4, services=12, backends=3, endpoints=4,
              churn_ips=8, churn_backends=4, churn_endpoints=2, timeout=20.0)


def pod_ip(i: int) -> str:
    return f"10.{128 + (i >> 16)}.{(i >> 8) & 255}.{i & 255}"


def ip_int(ip: str) -> int:
    return int(ipaddress.ip_address(ip))


def service_vip(s: int) -> str:
    return f"172.20.{s // 250}.{s % 250 + 1}"


def wait(cond, timeout, what):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise TimeoutError(f"{what}: not converged in {timeout} s")
        time.sleep(0.01)


class StubOwner:
    """The endpoints' daemon: the repository, B's identity cache, a proxy
    manager that allocates redirect ports and builds no engine, and an
    ACK for every push (counted)."""

    def __init__(self, pk, repo, alloc):
        self.repo, self.alloc = repo, alloc
        self.proxy = pk.proxy.ProxyManager()
        self.pushes = 0

    def get_policy_repository(self):
        return self.repo

    def get_identity_cache(self):
        return self.alloc.get_identity_cache()

    def get_proxy_manager(self):
        return self.proxy

    def update_network_policy(self, ep):
        self.pushes += 1
        return True


class World:
    """What ``build_world`` made: the server and both agents' clients,
    allocators, caches, syncs and nodes; B's maps, service manager and
    endpoints; the published pairs; ``stages`` {name: (seconds, info)}."""

    def __init__(self, pk, scale):
        self.pk, self.scale = pk, scale
        self.stages = {}
        self.closers = []

    def stage(self, name, t0, **info):
        self.stages[name] = (time.perf_counter() - t0, info)

    def close(self):
        """Stop every watcher, queue, client and the server (newest first);
        raise the first error any of them raised, after closing the rest."""
        closers, self.closers = self.closers, []
        errors = []
        for fn in reversed(closers):
            try:
                fn()
            except Exception as e:  # noqa: BLE001 - close the rest, raise below
                errors.append(e)
        if errors:
            raise errors[0]


def _run(jobs, concurrent, timeout):
    """Run the callables in threads (``concurrent``, each joined within
    ``timeout`` seconds) or in order; raise the first exception any of
    them raised."""
    errors = []

    def guard(fn):
        try:
            fn()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)

    if concurrent:
        threads = [threading.Thread(target=guard, args=(fn,), daemon=True) for fn in jobs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout)
            if t.is_alive():
                raise TimeoutError(f"an agent's job did not finish in {timeout} s")
    else:
        for fn in jobs:
            guard(fn)
    if errors:
        raise errors[0]


def build_world(pk, scale: Scale, label_sets, rules_json, seed=0, ep_kw=None, concurrent=True,
                ct_clock=None) -> World:
    """Build the cluster of the module docstring through ``pk``.
    ``label_sets``: label-string lists (the first ``scale.identities``
    are used); ``rules_json``: the policy rules' JSON document; ``ep_kw``:
    the endpoints' and manager's device arguments; ``concurrent``: the
    agents allocate and publish in two threads at once (else A, then B:
    the same ids for the same ``random`` seed); ``ct_clock``: the CT
    map's clock."""
    w = World(pk, scale)
    try:
        _build(w, pk, scale, [list(s) for s in label_sets[: scale.identities]], rules_json,
               np.random.default_rng(seed), ep_kw or {}, concurrent, ct_clock)
    except BaseException:
        w.close()
        raise
    return w


def _build(w, pk, scale, sets, rules_json, rng, ep_kw, concurrent, ct_clock):
    L = pk.labels.Labels
    n = len(sets)
    k = n * 5 // 8
    # 1. the kvstore: one server, a client an agent
    t0 = time.perf_counter()
    w.server = pk.kvstore.KvstoreServer()
    w.closers.append(w.server.close)
    w.backend = {}
    for name in "AB":
        w.backend[name] = pk.kvstore.NetBackend(w.server.address, timeout=30.0)
        w.closers.append(w.backend[name].close)
    w.stage("kvstore", t0, address=w.server.address)

    # 2. identities: A the first k label sets, B the last k
    w.alloc = {}
    for name in "AB":
        w.alloc[name] = pk.identity.IdentityAllocator(backend=w.backend[name], node_name=f"node-{name}")
        w.closers.append(w.alloc[name].close)
    taken = {"A": {}, "B": {}}

    def allocate(name, part):
        for lbls in part:
            taken[name][tuple(lbls)] = w.alloc[name].allocate(L.from_model(lbls))[0].id

    t0 = time.perf_counter()
    _run([lambda: allocate("A", sets[:k]), lambda: allocate("B", sets[n - k:])], concurrent,
         scale.timeout)
    contended = set(taken["A"]) & set(taken["B"])
    bad = [s for s in contended if taken["A"][s] != taken["B"][s]]
    if bad:
        raise AssertionError(f"identities: {len(bad)} contended label sets got two ids")
    w.ids = {**taken["A"], **taken["B"]}  # label tuple -> numeric id
    w.id_of = [w.ids[tuple(s)] for s in sets]

    def caches():
        return [{i: sorted(lb.get_model()) for i, lb in w.alloc[x].get_identity_cache().items()}
                for x in "AB"]

    wait(lambda: (lambda a, b: a == b and len(a) >= n)(*caches()), scale.timeout, "identity caches")
    w.stage("identities", t0, allocations=2 * k, contended=len(contended), distinct=len(set(w.id_of)))

    # 3. pod IPs: ips_per_identity an identity, A publishes the first half
    # with its tunnel endpoint, B the second; B's cache feeds its ipcache
    w.n_ips = n * scale.ips_per_identity
    w.ips = [pod_ip(i) for i in range(w.n_ips)]
    w.pair = {}  # ip -> (identity, tunnel endpoint) as published
    half = w.n_ips // 2
    tun_a = ip_int(A_NODE)
    w.ipc = pk.ipcache_map.IpcacheMap()
    w.cache = {x: pk.ipcache.IPIdentityCache() for x in "AB"}
    w.cache["B"].add_listener(pk.ipcache.datapath_listener(w.ipc))
    w.sync = {x: pk.ipcache.KvstoreIPSync(w.cache[x], backend=w.backend[x]) for x in "AB"}
    w.sync["B"].start_watcher()
    w.closers.append(w.sync["B"].stop)
    for i, ip in enumerate(w.ips):
        w.pair[ip] = (w.id_of[i // scale.ips_per_identity], tun_a if i < half else 0)

    def publish(name, lo, hi):
        for ip in w.ips[lo:hi]:
            ident, tun = w.pair[ip]
            w.sync[name].upsert_to_kvstore(pk.ipcache.IPIdentityPair(ip, ident, tunnel_endpoint=tun))

    t0 = time.perf_counter()
    _run([lambda: publish("A", 0, half), lambda: publish("B", half, w.n_ips)], concurrent,
         scale.timeout)
    published = time.perf_counter() - t0
    wait(lambda: len(w.cache["B"].dump()) >= w.n_ips, scale.timeout, "B's ipcache")
    check_ipcache(w)
    w.stage("ipcache", t0, published=w.n_ips, publish_s=published, entries=len(w.cache["B"].dump()))

    # nodes: each agent sees the other
    t0 = time.perf_counter()
    w.nodes = {}
    for name, addr in (("A", A_NODE), ("B", B_NODE)):
        node = pk.node.Node(name=f"node-{name}", ipv4_address=addr, ipv4_alloc_cidr="10.128.0.0/9")
        w.nodes[name] = pk.node.NodeDiscovery(node, backend=w.backend[name])
        w.closers.append(w.nodes[name].close)
    wait(lambda: "default/node-A" in w.nodes["B"].get_nodes()
         and "default/node-B" in w.nodes["A"].get_nodes(), scale.timeout, "node discovery")
    w.stage("nodes", t0, seen={x: sorted(w.nodes[x].get_nodes()) for x in "AB"})

    # 4. services: ServiceManager over B's LbMap, ids from the kvstore
    t0 = time.perf_counter()
    w.lb = pk.lbmap.LbMap()
    w.svc = pk.service.ServiceManager(w.lb, w.backend["B"])
    w.services = {}  # vip -> (service id, backend ips)
    A = pk.service.L3n4Addr
    for s in range(scale.services):
        bes = [w.ips[j] for j in rng.choice(w.n_ips, scale.backends, replace=False)]
        sid, _ = w.svc.upsert(A(service_vip(s), LB_PORT), [A(ip, BACKEND_PORT) for ip in bes])
        w.services[service_vip(s)] = (sid, bes)
    w.stage("services", t0, services=len(w.svc), backends=scale.services * scale.backends)

    # 5. endpoints on B, regenerated against the rules
    t0 = time.perf_counter()
    w.repo = pk.policy.Repository()
    for rule in pk.policy.rules_from_json(rules_json):
        w.repo.add(rule)
    w.owner = StubOwner(pk, w.repo, w.alloc["B"])
    w.manager = pk.endpoint.EndpointManager(**ep_kw)
    w.ep_kw = ep_kw
    # one builder where the ids must repeat: redirect ports go in build order
    w.queue = pk.endpoint.BuildQueue(lambda ep: ep.regenerate(w.owner, "state slice"),
                                     workers=4 if concurrent else 1)
    w.closers.append(w.queue.stop)
    w.ep_pod = {}  # endpoint id -> pod index
    for e in range(scale.endpoints):
        i = half + (e * (w.n_ips - half)) // scale.endpoints
        ident = w.alloc["B"].allocate(L.from_model(sets[i // scale.ips_per_identity]))[0]
        ep = pk.endpoint.Endpoint(100 + e, ipv4=w.ips[i], container_name=f"pod-{e}",
                                  labels=ident.labels, **ep_kw)
        ep.set_identity(ident)
        ep.set_state(pk.endpoint.EndpointState.WAITING_FOR_IDENTITY)
        w.manager.insert(ep)
        w.ep_pod[ep.id] = i
    regenerate(w, w.manager.get_endpoints())
    w.stage("endpoints", t0, endpoints=len(w.manager), rules=w.repo.num_rules(),
            pushes=w.owner.pushes, entries=sum(len(ep.policy_map.entries) for ep in w.manager.get_endpoints()))

    # the datapath maps that the state does not own: B's local endpoints
    # and an empty CT
    w.lxc = pk.lxcmap.LxcMap()
    for ep in w.manager.get_endpoints():
        w.lxc.upsert(ep.ipv4, ep.id, pk.lxcmap.EndpointInfo(ifindex=ep.id - 98))
    w.ct = pk.ctmap.CtMap(clock=ct_clock) if ct_clock is not None else pk.ctmap.CtMap()


def regenerate(w, eps):
    """Queue ``eps`` for regeneration and wait; every one must end ready
    with its policy map exported."""
    before = {ep.id: ep.policy_revision for ep in eps}
    for ep in eps:
        w.queue.enqueue(ep, key=ep.id)
    if not w.queue.wait_idle(w.scale.timeout):
        raise TimeoutError("endpoint regeneration: the build queue did not drain")
    for ep in eps:
        if ep.state.value != "ready" or ep.device_policy_map is None:
            raise AssertionError(f"endpoint {ep.id}: {ep.state.value} after regeneration")
    return before


def check_ipcache(w):
    """B's cache and ipcache map hold exactly the published pairs."""
    got = {p.ip: (p.identity, p.tunnel_endpoint) for p in w.cache["B"].dump()}
    if got != w.pair:
        diff = sorted(set(got.items()) ^ set(w.pair.items()))[:4]
        raise AssertionError(f"B's ipcache differs from what was published: {diff}")
    mapped = {k.split("/")[0]: (info.sec_label, info.tunnel_endpoint) for k, (_, info) in w.ipc.v4.items()}
    if mapped != w.pair:
        raise AssertionError("B's IpcacheMap differs from its cache")


def churn(w, seed=1):
    """B deletes ``churn_ips`` of its pods' IPs and ``churn_backends``
    backends (one from each of that many services), and moves
    ``churn_endpoints`` endpoints to a new identity (a label added; the
    new pair published); every change is waited for."""
    pk, scale = w.pk, w.scale
    rng = np.random.default_rng(seed)
    half = w.n_ips // 2
    ep_ips = {w.ips[i] for i in w.ep_pod.values()}
    svc_ips = {ip for _, bes in w.services.values() for ip in bes}
    pool = [ip for ip in w.ips[half:] if ip not in ep_ips and ip not in svc_ips]
    t0 = time.perf_counter()
    gone = [pool[j] for j in rng.choice(len(pool), scale.churn_ips, replace=False)]
    for ip in gone:
        w.sync["B"].delete_from_kvstore(ip)
        del w.pair[ip]
    wait(lambda: len(w.cache["B"].dump()) == len(w.pair), scale.timeout, "B's ipcache after deletes")
    A = pk.service.L3n4Addr
    for vip in sorted(w.services)[: scale.churn_backends]:
        sid, bes = w.services[vip]
        sid2, _ = w.svc.upsert(A(vip, LB_PORT), [A(ip, BACKEND_PORT) for ip in bes[:-1]])
        w.services[vip] = (sid2, bes[:-1])
    moved = w.manager.get_endpoints()[: scale.churn_endpoints]
    for ep in moved:
        lbls = pk.labels.Labels.from_model(sorted(ep.labels.get_model()) + ["k8s:rollout=v2"])
        ident = w.alloc["B"].allocate(lbls)[0]
        ep.labels = lbls
        ep.set_identity(ident)
        w.pair[ep.ipv4] = (ident.id, 0)
        w.sync["B"].upsert_to_kvstore(pk.ipcache.IPIdentityPair(ep.ipv4, ident.id, tunnel_endpoint=0))
    wait(lambda: all(w.cache["B"].lookup_by_ip(ep.ipv4) == w.pair[ep.ipv4][0] for ep in moved),
         scale.timeout, "B's ipcache after the label change")
    regenerate(w, moved)
    check_ipcache(w)
    w.stage("churn", t0, ips_deleted=len(gone), backends_deleted=scale.churn_backends,
            endpoints_moved=len(moved), entries=len(w.cache["B"].dump()))
    return gone


# --- traffic on the state ------------------------------------------------------


def i32(a) -> np.ndarray:
    return np.asarray(a, np.int64).astype(np.uint32).view(np.int32)


def identity_pool(w):
    """The identities a query draws from: every allocated one, the
    reserved world and host, and one no cache holds."""
    return np.array(sorted(set(w.alloc["B"].get_identity_cache())) + [99_999], np.int64)


def policy_queries(w, rng, f):
    """(identity, dport, proto) [f] int32 columns: allocated identities,
    ports 80 / 9092 / other, TCP mostly."""
    ident = rng.choice(identity_pool(w), f)
    dport = rng.choice(np.array([80, 9092, 8080, 443, 0], np.int64), f, p=[0.4, 0.3, 0.1, 0.1, 0.1])
    proto = rng.choice(np.array([6, 17, 0], np.int64), f, p=[0.8, 0.1, 0.1])
    return i32(ident), i32(dport), i32(proto)


def address_queries(w, rng, f):
    """[f] addresses as int32 bit patterns: three quarters pod IPs
    (published or deleted since), the rest outside the pod range."""
    pods = np.array([ip_int(ip) for ip in w.ips], np.int64)
    addr = pods[rng.integers(0, len(pods), f)]
    miss = rng.random(f) < 0.25
    addr[miss] = rng.integers(ip_int("11.0.0.0"), ip_int("11.255.255.255"), int(miss.sum()))
    return i32(addr)


def lb_queries(w, rng, f):
    """(vip, dport, flow hash) [f] int32: service VIPs on the LB port
    and others, VIPs that no service holds."""
    vips = np.array([ip_int(v) for v in w.services] + [ip_int("172.21.0.1")], np.int64)
    vip = vips[rng.integers(0, len(vips), f)]
    dport = rng.choice(np.array([LB_PORT, 443], np.int64), f, p=[0.9, 0.1])
    return i32(vip), i32(dport), i32(rng.integers(0, 1 << 32, f, dtype=np.int64))


def datapath_packets(w, rng, f):
    """Egress from B's endpoints: (saddr, daddr, sport, dport, proto) [f]
    int32; 40% to service VIPs on the LB port, 40% to pod IPs on 80 /
    9092 / 8080, 20% to outside addresses."""
    eps = np.array([ip_int(ep.ipv4) for ep in w.manager.get_endpoints()], np.int64)
    saddr = eps[rng.integers(0, len(eps), f)]
    roll = rng.random(f)
    daddr = address_queries(w, rng, f).view(np.uint32).astype(np.int64)
    vips = np.array([ip_int(v) for v in w.services], np.int64)
    to_vip = roll < 0.4
    daddr[to_vip] = vips[rng.integers(0, len(vips), int(to_vip.sum()))]
    dport = rng.choice(np.array([80, 9092, 8080], np.int64), f)
    dport[to_vip] = LB_PORT
    sport = rng.integers(1024, 65535, f)
    proto = rng.choice(np.array([6, 17], np.int64), f, p=[0.9, 0.1])
    return tuple(i32(x) for x in (saddr, daddr, sport, dport, proto))


def overlay_packets(w, rng, f):
    """Overlay ingress from A's pods to B's endpoints: (saddr, daddr,
    sport, dport, proto, vni) [f] int32; the tunnel key is the source
    pod's identity on A's side, one in eight an identity no cache holds."""
    half = w.n_ips // 2
    src = rng.integers(0, half, f)
    saddr = np.array([ip_int(w.ips[i]) for i in range(half)], np.int64)[src]
    vni = np.array([w.pair.get(w.ips[i], (99_999, 0))[0] for i in range(half)], np.int64)[src]
    vni[rng.random(f) < 1 / 8] = 99_999
    eps = np.array([ip_int(ep.ipv4) for ep in w.manager.get_endpoints()], np.int64)
    daddr = eps[rng.integers(0, len(eps), f)]
    dport = rng.choice(np.array([80, 9092, 8080], np.int64), f)
    sport = rng.integers(1024, 65535, f)
    proto = rng.choice(np.array([6, 17], np.int64), f, p=[0.9, 0.1])
    return tuple(i32(x) for x in (saddr, daddr, sport, dport, proto, vni))
