"""k8s watch loop: apiserver events -> daemon policy add/delete.

reference: daemon/k8s_watcher.go — NetworkPolicy v1 handlers (:472
addK8sNetworkPolicyV1/update/delete), CiliumNetworkPolicy handlers
(:1703 addCiliumNetworkPolicyV2, :1750 delete, CNP status updates
:1690-1946), and Endpoints handlers driving ToServices translation.

Updates are delete-by-labels + re-add (the reference's update path for
both kinds), keyed on the derived policy labels so user rules and other
policies are untouched.  CNP status (ok/error per node) writes back to
the fake apiserver the way the reference PATCHes the CRD status.
"""

from __future__ import annotations

import logging
import threading

from ..labels import LabelArray
from ..service import L3n4Addr, ServiceError
from . import apiserver as api
from .cnp import parse_cnp
from .network_policy import np_policy_name, parse_network_policy, policy_labels
from .rule_translate import translate_to_services

log = logging.getLogger(__name__)


class K8sWatcher:
    """Consumes a FakeApiServer watch stream and drives the daemon."""

    def __init__(self, daemon, apisrv: api.FakeApiServer,
                 node_name: str = "node-0") -> None:
        self.daemon = daemon
        self.apiserver = apisrv
        self.node_name = node_name
        self._queue = None
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self.events_seen = 0
        # Last known endpoints per (namespace, name) service for the
        # ToServices revert pass on endpoint updates.
        self._svc_backends: dict[tuple, list[str]] = {}
        # Service/Endpoints stores driving the load balancer
        # (reference: d.loadBalancer.K8sServices / K8sEndpoints,
        # daemon/k8s_watcher.go:822,945).
        self._k8s_services: dict[tuple, dict] = {}
        self._k8s_eps: dict[tuple, dict] = {}
        # Frontends currently programmed per service, for teardown of
        # ports that disappear (reference: delK8sSVCs).
        self._lb_frontends: dict[tuple, list[L3n4Addr]] = {}

    # -- lifecycle --------------------------------------------------------

    def start(self) -> "K8sWatcher":
        self._queue = self.apiserver.watch()
        self._thread = threading.Thread(
            target=self._loop, name="k8s-watcher", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._queue is not None:
            self._queue.put(None)  # wake
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _loop(self) -> None:
        while not self._stop.is_set():
            ev = self._queue.get()
            if ev is None:
                return
            try:
                self.handle(ev)
            except Exception:  # noqa: BLE001 — one bad object must not
                log.exception("k8s event failed: %s", ev)  # kill the loop
            self.events_seen += 1

    def sync(self, timeout: float = 5.0) -> None:
        """Wait until every queued event has been handled (test helper —
        the informer 'cache synced' analog)."""
        import time

        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self._queue.unfinished_tasks == 0:  # type: ignore[attr-defined]
                return
            time.sleep(0.005)
        raise TimeoutError("k8s watcher did not drain in time")

    # -- event handling ---------------------------------------------------

    def handle(self, ev: api.WatchEvent) -> None:
        try:
            if ev.kind == api.KIND_NETWORK_POLICY:
                self._handle_np(ev)
            elif ev.kind == api.KIND_CNP:
                self._handle_cnp(ev)
            elif ev.kind == api.KIND_ENDPOINTS:
                self._handle_endpoints(ev)
            elif ev.kind == api.KIND_SERVICE:
                self._handle_service(ev)
        finally:
            if self._queue is not None:
                try:
                    self._queue.task_done()
                except ValueError:
                    pass

    def _delete_by_labels(self, lbls: LabelArray) -> int:
        _, deleted = self.daemon.policy_delete(lbls)
        return deleted

    def _handle_np(self, ev: api.WatchEvent) -> None:
        """reference: k8s_watcher.go addK8sNetworkPolicyV1 /
        updateK8sNetworkPolicyV1 / deleteK8sNetworkPolicyV1."""
        meta = ev.obj.get("metadata") or {}
        ns = meta.get("namespace") or "default"
        # The label-derived name honors the io.cilium.name annotation
        # (must match parse_network_policy or deletes would miss).
        name = np_policy_name(ev.obj)
        lbls = policy_labels(ns, name, "NetworkPolicy")
        if ev.type == api.DELETED:
            self._delete_by_labels(lbls)
            return
        rules = parse_network_policy(ev.obj)
        if ev.type == api.MODIFIED:
            self._delete_by_labels(lbls)
        self.daemon.policy_add(rules)

    def _handle_cnp(self, ev: api.WatchEvent) -> None:
        """reference: k8s_watcher.go:1703 addCiliumNetworkPolicyV2 (+
        CNP node-status update on success/failure)."""
        meta = ev.obj.get("metadata") or {}
        ns = meta.get("namespace") or "default"
        name = meta.get("name", "")
        lbls = policy_labels(ns, name, "CiliumNetworkPolicy")
        if ev.type == api.DELETED:
            self._delete_by_labels(lbls)
            return
        try:
            rules = parse_cnp(ev.obj)
            if ev.type == api.MODIFIED:
                self._delete_by_labels(lbls)
            self.daemon.policy_add(rules)
            self._set_cnp_status(ev.obj, ok=True, error="")
        except Exception as exc:  # noqa: BLE001 — status carries the error
            self._set_cnp_status(ev.obj, ok=False, error=str(exc))
            raise

    def _set_cnp_status(self, cnp: dict, ok: bool, error: str) -> None:
        """Write the per-node status back (reference:
        updateCiliumNetworkPolicyV2AnnotationsOnly / CNPStatus nodes)."""
        status = cnp.setdefault("status", {}).setdefault("nodes", {})
        status[self.node_name] = {"ok": ok, "error": error}

    def _handle_endpoints(self, ev: api.WatchEvent) -> None:
        """Endpoints changes re-translate ToServices rules
        (reference: k8s_watcher.go addK8sEndpointV1 ->
        d.policy.TranslateRules)."""
        meta = ev.obj.get("metadata") or {}
        ns = meta.get("namespace") or "default"
        name = meta.get("name", "")
        parsed_eps = _parse_endpoints(ev.obj)
        ips = parsed_eps["ips"]
        svc = self.apiserver.get(api.KIND_SERVICE, ns, name) or {}
        svc_labels = (svc.get("metadata") or {}).get("labels") or {}
        repo = self.daemon.get_policy_repository()
        key = (ns, name)
        old = self._svc_backends.get(key, [])
        with repo.mutex:
            rules = list(repo.rules)
            if old and ev.type in (api.MODIFIED, api.DELETED):
                translate_to_services(
                    rules, name, ns, old, svc_labels, revert=True
                )
            if ev.type != api.DELETED:
                res = translate_to_services(
                    rules, name, ns, ips, svc_labels, revert=False
                )
            else:
                res = None
        if ev.type == api.DELETED:
            self._svc_backends.pop(key, None)
        else:
            self._svc_backends[key] = ips
        if res is None or res.added_cidrs or res.removed_cidrs or old:
            self.daemon.trigger_policy_updates()

        # Feed the load-balancer sync (reference: addK8sEndpointV1 ->
        # addK8sSVCs with the stored service, k8s_watcher.go:945-1032).
        if ev.type == api.DELETED:
            self._k8s_eps.pop(key, None)
        else:
            self._k8s_eps[key] = parsed_eps
        self._sync_lb(key)

    # -- services -> load balancer ----------------------------------------

    def _handle_service(self, ev: api.WatchEvent) -> None:
        """reference: daemon/k8s_watcher.go:822 addK8sServiceV1 /
        :858 update / :862 delete — stores the parsed service and
        reconciles the LB maps against it."""
        meta = ev.obj.get("metadata") or {}
        key = (meta.get("namespace") or "default", meta.get("name", ""))
        if ev.type == api.DELETED:
            self._k8s_services.pop(key, None)
        else:
            self._k8s_services[key] = _parse_service(ev.obj)
        self._sync_lb(key)

    def _sync_lb(self, key: tuple) -> None:
        """Reconcile the programmed frontends for one (ns, name)
        against the current Service + Endpoints pair (reference:
        addK8sSVCs/delK8sSVCs, k8s_watcher.go:1137,1196).  Headless
        services (no clusterIP) program nothing."""
        mgr = self.daemon.service_manager
        svc = self._k8s_services.get(key)
        eps = self._k8s_eps.get(key) or {"ips": [], "ports": {}}

        desired: list[tuple[L3n4Addr, list[L3n4Addr]]] = []
        if svc is not None and svc["frontend_ip"]:
            seen_ports = set()
            for p in svc["ports"]:
                if p["port"] in seen_ports:  # reference: getUniqPorts
                    continue
                seen_ports.add(p["port"])
                fe = L3n4Addr(
                    svc["frontend_ip"], p["port"], p.get("protocol", "TCP")
                )
                be_port = eps["ports"].get(p["name"])
                backends = []
                if be_port is not None:
                    backends = [
                        L3n4Addr(ip, be_port[0], be_port[1])
                        for ip in eps["ips"]
                    ]
                desired.append((fe, backends))

        previous = {fe.key(): fe for fe in self._lb_frontends.get(key, [])}
        desired_keys = {fe.key() for fe, _ in desired}
        for fe_key, fe in previous.items():
            if fe_key not in desired_keys:
                mgr.delete_by_frontend(fe)
        programmed = []
        for fe, backends in desired:
            try:
                mgr.upsert(fe, backends)
                programmed.append(fe)
            except ServiceError:
                log.exception("k8s service %s: LB programming failed", key)
                # A frontend programmed by an earlier sync stays tracked
                # even if this update failed — otherwise its map entries
                # would leak past the Service's deletion.
                if fe.key() in previous:
                    programmed.append(previous[fe.key()])
        if programmed:
            self._lb_frontends[key] = programmed
        else:
            self._lb_frontends.pop(key, None)


def _parse_service(obj: dict) -> dict:
    """Parse a k8s Service into the LB-relevant fields (reference:
    loadbalancer.K8sServiceInfo; 'None'/'' clusterIP = headless,
    k8s_watcher.go:826 NewK8sServiceInfo IsHeadless)."""
    spec = obj.get("spec") or {}
    cluster_ip = spec.get("clusterIP") or ""
    if cluster_ip in ("None", "none"):
        cluster_ip = ""
    ports = [
        {
            "name": p.get("name", ""),
            "port": int(p["port"]),
            "protocol": (p.get("protocol") or "TCP").upper(),
        }
        for p in spec.get("ports") or []
        if p.get("port")
    ]
    return {"frontend_ip": cluster_ip, "ports": ports}


def _parse_endpoints(obj: dict) -> dict:
    """Parse k8s Endpoints into backend IPs + per-name ports
    (reference: loadbalancer.K8sServiceEndpoint: BEIPs set + Ports
    map keyed by port name)."""
    ips: list[str] = []
    ports: dict[str, tuple[int, str]] = {}
    for subset in obj.get("subsets") or []:
        for a in subset.get("addresses") or []:
            if a.get("ip") and a["ip"] not in ips:
                ips.append(a["ip"])
        for p in subset.get("ports") or []:
            if p.get("port"):
                ports[p.get("name", "")] = (
                    int(p["port"]), (p.get("protocol") or "TCP").upper()
                )
    return {"ips": ips, "ports": ports}
