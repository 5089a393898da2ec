"""One node's view of a Kubernetes cluster, built through either package.

The node runs at the Kubernetes defaults: 110 pods (the kubelet's default
``--max-pods`` and the per-node limit of kubernetes/community
``sig-scalability/configs-and-limits/thresholds.md``) added by
``CniPlugin.cni_add`` on ``IpamAllocator("10.0.0.0/24")`` (the controller
manager's default per-node /24), in 4 namespaces, labelled in policygen's
app x tier scheme (``entry.policy_rules``).  Policy arrives through a
``FakeApiServer`` and the ``K8sWatcher``: NetworkPolicies (a default-deny
a namespace; podSelector, namespaceSelector and, one in 16, ipBlock with
except; TCP ports other than 80), CiliumNetworkPolicies with 1-4 HTTP
rules on 80/TCP (one in 8 with a regex path) and a few with
``toServices``, resolved through the Endpoints objects; then Services of
8 backends each, as Service and Endpoints objects, which the watcher
programs into the daemon's LB map.

``build_world`` takes a namespace of one package's modules (``modules``)
and a daemon of that package: ``chip_smoke.py`` phase 17 runs the port's
on the card at ``Scale()``, and tests/test_torch_full_stack.py runs both
packages at ``SMALL`` and compares.  The documents are made from
``random.Random(seed)`` and do not depend on the package.  This module
imports neither package itself.  Every wait has a timeout.
"""

from __future__ import annotations

import http.client
import importlib
import json
import random
import socket
import time
from dataclasses import dataclass
from types import SimpleNamespace

SUBMODULES = {"k8s": "k8s", "apiserver": "k8s.apiserver", "cni": "k8s.cni", "ipam": "k8s.ipam"}
NAMESPACES = ("prod", "staging", "dev", "ops")  # policygen's namespaces
APPS = tuple(f"app{i:02d}" for i in range(8))
TIERS = ("web", "api", "worker", "db")
RESOURCES = tuple(f"res{i:02d}" for i in range(64))
METHODS = ("GET", "POST", "PUT", "DELETE")
NP_PORTS = (443, 5432, 6379, 8080)  # a CNP's HTTP rules hold 80 alone
HTTP_PORT = 80
BACKEND_PORT = 8080
POD_CIDR = "10.0.0.0/24"
NS_LABEL = "k8s:io.kubernetes.pod.namespace"


def modules(pkg: str) -> SimpleNamespace:
    """One package's k8s modules under fixed names."""
    return SimpleNamespace(name=pkg, **{k: importlib.import_module(f"{pkg}.{v}")
                                        for k, v in SUBMODULES.items()})


@dataclass(frozen=True)
class Scale:
    """The node's size; the defaults are phase 17's."""

    pods: int = 110
    network_policies: int = 128  # a default-deny a namespace among them
    cnps: int = 64  # HTTP CNPs
    to_services: int = 4  # CNPs with toServices, beside the HTTP ones
    services: int = 1024
    backends: int = 8
    timeout: float = 300.0  # seconds a convergence may take


SMALL = Scale(pods=12, network_policies=8, cnps=6, to_services=2, services=12, backends=3, timeout=60.0)


def wait(cond, timeout, what):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise TimeoutError(f"{what}: not converged in {timeout} s")
        time.sleep(0.01)


# --- the documents ---------------------------------------------------------------


def pods(scale: Scale, seed: int) -> list[dict]:
    """[{container, namespace, name, labels}]: pod i in namespace i mod 4,
    app and tier drawn from ``random.Random(seed)``."""
    rng = random.Random(seed)
    return [dict(container=f"{i:04x}" * 16, namespace=NAMESPACES[i % len(NAMESPACES)], name=f"pod-{i:03d}",
                 labels={"app": rng.choice(APPS), "tier": rng.choice(TIERS)}) for i in range(scale.pods)]


def service_name(s: int) -> str:
    return f"svc-{s:04d}"


def service_namespace(s: int) -> str:
    return NAMESPACES[s % len(NAMESPACES)]


def service_vip(s: int) -> str:
    return f"172.20.{s // 250}.{s % 250 + 1}"


def _pick(rng, pod_list, ns):
    return rng.choice([p for p in pod_list if p["namespace"] == ns])


def _ports(rng):
    return [{"port": rng.choice(NP_PORTS), "protocol": "TCP"}]


def network_policies(scale: Scale, seed: int, pod_list: list[dict]) -> list[dict]:
    """A default-deny NetworkPolicy a namespace, then policies selecting a
    pod's app that admit TCP ports from a podSelector (tier), a
    namespaceSelector (every namespace) with a podSelector (app), or, one
    in 16, an ipBlock with an except on every port (Cilium refuses a
    CIDR source beside ports)."""
    rng = random.Random(seed + 1)
    out = [{"metadata": {"name": "default-deny", "namespace": ns},
            "spec": {"podSelector": {}, "policyTypes": ["Ingress"]}} for ns in NAMESPACES]
    for i in range(scale.network_policies - len(out)):
        ns = NAMESPACES[i % len(NAMESPACES)]
        target = _pick(rng, pod_list, ns)
        src = _pick(rng, pod_list, rng.choice(NAMESPACES))
        if i % 16 == 15:
            peer = {"ipBlock": {"cidr": f"172.16.{i % 256}.0/24", "except": [f"172.16.{i % 256}.128/25"]}}
        elif i % 2:
            peer = {"namespaceSelector": {}, "podSelector": {"matchLabels": {"app": src["labels"]["app"]}}}
        else:
            peer = {"podSelector": {"matchLabels": {"tier": _pick(rng, pod_list, ns)["labels"]["tier"]}}}
        ingress = {"from": [peer]} if "ipBlock" in peer else {"from": [peer], "ports": _ports(rng)}
        out.append({"metadata": {"name": f"np-{i:03d}", "namespace": ns},
                    "spec": {"podSelector": {"matchLabels": {"app": target["labels"]["app"]}},
                             "ingress": [ingress]}})
    return out


def http_rule(rng, regex: bool) -> dict:
    res = rng.choice(RESOURCES)
    path = f"/api/v[0-9]+/{res}/.*" if regex else f"/{res}/.*"
    return {"method": rng.choice(METHODS), "path": path}


def cnps(scale: Scale, seed: int, pod_list: list[dict]) -> list[dict]:
    """``scale.cnps`` HTTP CiliumNetworkPolicies: each selects a pod's app
    (half of them also its tier) in its namespace and admits 80/TCP from
    one app or tier of the same namespace (at most 8 identities: a
    service's model takes 32 remotes a rule) with 1-4 HTTP rules, one CNP
    in 8 with a regex path; then ``scale.to_services`` egress CNPs with
    ``toServices`` naming a Service of their namespace and a section to
    every pod of the namespace."""
    rng = random.Random(seed + 2)
    out = []
    for i in range(scale.cnps):
        ns = NAMESPACES[i % len(NAMESPACES)]
        target = _pick(rng, pod_list, ns)["labels"]
        sel = {"app": target["app"]} if i % 2 else {"app": target["app"], "tier": target["tier"]}
        src = _pick(rng, pod_list, ns)["labels"]
        key = rng.choice(("app", "tier"))
        n = rng.randrange(1, 5)
        rules = [http_rule(rng, regex=(i % 8 == 0 and j == 0)) for j in range(n)]
        out.append({"metadata": {"name": f"cnp-{i:03d}", "namespace": ns},
                    "spec": {"endpointSelector": {"matchLabels": sel},
                             "ingress": [{"fromEndpoints": [{"matchLabels": {key: src[key]}}],
                                          "toPorts": [{"ports": [{"port": str(HTTP_PORT), "protocol": "TCP"}],
                                                       "rules": {"http": rules}}]}]}})
    for i in range(scale.to_services):
        s = to_service_index(scale, i)
        ns = service_namespace(s)
        target = _pick(rng, pod_list, ns)["labels"]
        out.append({"metadata": {"name": f"cnp-svc-{i}", "namespace": ns},
                    "spec": {"endpointSelector": {"matchLabels": {"app": target["app"]}},
                             "egress": [{"toServices": [{"k8sService": {"serviceName": service_name(s),
                                                                        "namespace": ns}}]},
                                        {"toEndpoints": [{"matchLabels": {}}]}]}})
    return out


def to_service_index(scale: Scale, i: int) -> int:
    """The Service the ``i``th toServices CNP names."""
    return (i * 7 + 3) % scale.services


def backend_ip(j: int) -> str:
    """The ``j``th pod of the cluster's other nodes (10.1.0.0/16)."""
    return f"10.1.{(j >> 8) & 255}.{j & 255}"


def services(scale: Scale, seed: int) -> list[tuple[dict, dict]]:
    """[(Service, Endpoints)]: a ClusterIP on 80/TCP ("http") and
    ``scale.backends`` backend pods on 8080, drawn from
    ``random.Random(seed)``."""
    rng = random.Random(seed + 3)
    out = []
    for s in range(scale.services):
        meta = {"name": service_name(s), "namespace": service_namespace(s)}
        svc = {"metadata": {**meta, "labels": {"svc": service_name(s)}},
               "spec": {"clusterIP": service_vip(s), "ports": [{"name": "http", "port": HTTP_PORT,
                                                                "protocol": "TCP"}]}}
        bes = [backend_ip(j) for j in rng.sample(range(1 << 16), scale.backends)]
        eps = {"metadata": dict(meta),
               "subsets": [{"addresses": [{"ip": ip} for ip in bes],
                            "ports": [{"name": "http", "port": BACKEND_PORT, "protocol": "TCP"}]}]}
        out.append((svc, eps))
    return out


# --- the world ------------------------------------------------------------------


class World:
    """What ``build_world`` made: the API server, the watcher, IPAM and
    CNI on ``daemon``; the documents; the pods' CNI results; ``stages``
    {name: (seconds, info)} on the host clock."""

    def __init__(self, pk, daemon, scale, seed):
        self.pk, self.daemon, self.scale, self.seed = pk, daemon, scale, seed
        self.stages = {}
        self.watcher = None

    def stage(self, name, t0, **info):
        self.stages[name] = (time.perf_counter() - t0, info)

    def close(self):
        if self.watcher is not None:
            self.watcher.stop()
            self.watcher = None

    def endpoints(self):
        return sorted(self.daemon.endpoint_manager.get_endpoints(), key=lambda ep: ep.id)

    def settled(self):
        """Every endpoint ready at the repository's revision, the build
        queue idle."""
        rev = self.daemon.get_policy_repository().get_revision()
        return all(ep.state.value == "ready" and ep.policy_revision >= rev for ep in self.endpoints()) \
            and self.daemon.build_queue.wait_idle(0.01)

    def settle(self, what):
        wait(self.settled, self.scale.timeout, what)

    def generated_cidrs(self):
        repo = self.daemon.get_policy_repository()
        with repo.mutex:
            return sorted({c.cidr for r in repo.rules for e in r.egress for c in e.to_cidr_set if c.generated})


def build_world(pk, daemon, scale: Scale = Scale(), seed: int = 17) -> World:
    """Build the node of the module docstring on ``daemon`` through
    ``pk``: policies, then Services and Endpoints (so that the toServices
    rules are in the repository when their Endpoints arrive), then the
    pods through CNI ADD; wait until every endpoint is ready."""
    w = World(pk, daemon, scale, seed)
    try:
        _build(w, pk, daemon, scale, seed)
    except BaseException:
        w.close()
        raise
    return w


def _build(w, pk, daemon, scale, seed):
    api = pk.apiserver
    w.pods = pods(scale, seed)
    w.nps = network_policies(scale, seed, w.pods)
    w.cnps = cnps(scale, seed, w.pods)
    w.services = services(scale, seed)
    w.apisrv = pk.k8s.FakeApiServer()
    w.watcher = pk.k8s.K8sWatcher(daemon, w.apisrv).start()

    t0 = time.perf_counter()
    for obj in w.nps:
        w.apisrv.upsert(api.KIND_NETWORK_POLICY, obj)
    for obj in w.cnps:
        w.apisrv.upsert(api.KIND_CNP, obj)
    w.watcher.sync(scale.timeout)
    bad = {c["metadata"]["name"]: c["status"]["nodes"] for c in w.cnps if not c["status"]["nodes"]["node-0"]["ok"]}
    if bad:
        raise AssertionError(f"CNPs refused: {bad}")
    w.stage("policies", t0, network_policies=len(w.nps), cnps=len(w.cnps),
            rules=daemon.get_policy_repository().num_rules())

    t0 = time.perf_counter()
    for svc, eps in w.services:
        w.apisrv.upsert(api.KIND_SERVICE, svc)
        w.apisrv.upsert(api.KIND_ENDPOINTS, eps)
    w.watcher.sync(scale.timeout)
    want = {f"{ip['ip']}/32" for i in range(scale.to_services)
            for ip in w.services[to_service_index(scale, i)][1]["subsets"][0]["addresses"]}
    if set(w.generated_cidrs()) != want:
        raise AssertionError("toServices: the generated CIDRs differ from the named Services' backends")
    w.stage("services", t0, services=len(daemon.service_manager), lb_entries=len(daemon.lb_map.dump()),
            to_services_cidrs=len(want))

    t0 = time.perf_counter()
    w.ipam = pk.ipam.IpamAllocator(POD_CIDR)
    w.cni = pk.cni.CniPlugin(daemon, w.ipam)
    w.results = {}
    for p in w.pods:
        w.results[p["container"]] = w.cni.cni_add(p["container"], p["namespace"], p["name"], labels=p["labels"])
    w.settle("every pod's endpoint ready")
    w.stage("pods", t0, pods=len(w.results), endpoints=len(daemon.endpoint_manager),
            identities=len({ep.security_identity.id for ep in w.endpoints()}),
            entries=sum(len(ep.policy_map.entries) for ep in w.endpoints()))


# --- churn ----------------------------------------------------------------------


def delete_cnp(w, name):
    """Delete one CNP through the API server and wait for the watcher."""
    obj = next(c for c in w.cnps if c["metadata"]["name"] == name)
    w.apisrv.delete(w.pk.apiserver.KIND_CNP, obj["metadata"]["namespace"], name)
    w.watcher.sync(w.scale.timeout)


def cut_backends(w, n_services, n_cut=2):
    """Drop the last ``n_cut`` backends of the first ``n_services``
    Services' Endpoints; returns the VIPs changed."""
    api = w.pk.apiserver
    vips = []
    for s in range(n_services):
        svc, eps = w.services[s]
        subset = eps["subsets"][0]
        subset["addresses"] = subset["addresses"][:-n_cut]
        w.apisrv.upsert(api.KIND_ENDPOINTS, eps)
        vips.append(svc["spec"]["clusterIP"])
    w.watcher.sync(w.scale.timeout)
    return vips


def cni_del(w, n):
    """CNI DEL the last ``n`` pods; returns their CNI results."""
    gone = []
    for p in w.pods[-n:]:
        res = w.results.pop(p["container"])
        if not w.cni.cni_del(p["container"]):
            raise AssertionError(f"CNI DEL {p['name']}: nothing torn down")
        gone.append((p["container"], res))
    return gone


def shim_verdicts(w, network_policy_for_endpoint, client, mod, conn_base):
    """({(destination, source): [result, outputs...]}, last conn id) of
    HTTP conns through a verdict service on the node's NPDS (``client``
    and ``mod``: a ``SidecarClient`` and its module): for every endpoint
    with HTTP rules on 80, a conn from each other pod of its namespace,
    sending a request each rule admits, one no rule names, then the
    reply's end."""
    cache = w.daemon.get_identity_cache()
    out = {}
    for ep in w.endpoints():
        pol = network_policy_for_endpoint(ep, cache)
        rules = [r for pp in pol.ingress_per_port_policies if pp.port == HTTP_PORT for r in pp.rules
                 if r.http_rules]
        if not rules:
            continue
        heads = [f"{h['method']} {h['path'].replace('v[0-9]+', 'v2').replace('.*', 'x')} HTTP/1.1\r\n\r\n".encode()
                 for r in rules for h in r.http_rules] + [b"PATCH /nothing HTTP/1.1\r\n\r\n"]
        ns = next(lb for lb in ep.labels.get_model() if lb.startswith(NS_LABEL))
        for src in w.endpoints():
            if ns not in src.labels.get_model() or src.id == ep.id:
                continue
            conn_base += 1
            res, shim = client.new_connection(mod, "http", conn_base, True, src.security_identity.id,
                                              ep.security_identity.id, f"{src.ipv4}:40000", f"{ep.ipv4}:80",
                                              ep.ipv4)
            out[(ep.id, src.id)] = [res] + ([shim.on_io(False, h)[1] for h in heads] + [shim.on_io(True, b"")[1]]
                                            if shim is not None else [])
    return out, conn_base


def fake_runtime(workloads):
    """A container runtime answering from a dict, over ``workloads``'s
    ``WorkloadRuntime`` (tests/test_workloads.py's FakeRuntime):
    ``add(id, labels, ipv4)`` makes a container it reports."""

    class FakeRuntime(workloads.WorkloadRuntime):
        name = "fake"

        def __init__(self):
            self.workloads = {}
            self.inspect_calls = 0

        def add(self, wid, labels, ipv4="", name=""):
            self.workloads[wid] = workloads.Workload(id=wid, name=name or wid, labels=labels, ipv4=ipv4)

        def inspect(self, workload_id):
            self.inspect_calls += 1
            return self.workloads.get(workload_id)

        def list_workloads(self):
            return sorted(self.workloads)

    return FakeRuntime()


class _UnixConnection(http.client.HTTPConnection):
    def __init__(self, path):
        super().__init__("localhost", timeout=60)
        self._path = path

    def connect(self):
        self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.sock.connect(self._path)


def unix_post(path, route, body):
    """(status, JSON reply) of a JSON POST over the unix socket at
    ``path`` (the libnetwork driver's protocol)."""
    conn = _UnixConnection(path)
    try:
        conn.request("POST", route, json.dumps(body).encode(), {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read().decode())
    finally:
        conn.close()


def labels_of(w, identity: int):
    """An identity's labels, sorted (ids differ between daemons)."""
    lbls = w.daemon.get_identity_cache().get(identity)
    return tuple(sorted(lbls.get_model())) if lbls is not None else identity
