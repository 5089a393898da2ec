"""CNI command surface: ADD / DEL / CHECK against the daemon.

reference: plugins/cilium-cni/cilium-cni.go — the CNI plugin the
kubelet execs per pod sandbox.  The full plugin lifecycle is modeled:

- **ADD** (cmdAdd, cilium-cni.go:293): IPAM allocation → veth-pair
  provisioning (connector.SetupVeth records; the kernel steps are
  simulated, see endpoint/connector.py) → peer moved into the sandbox
  netns and renamed eth0 → endpoint create → CNI result with the
  interface records, IP config, and routes (default via the IPAM
  router, mirroring the reference's route list).
- **DEL** (cmdDel, cilium-cni.go:455): idempotent teardown — endpoint
  delete, IP release, interface record removal; a DEL for an unknown
  container or a repeated DEL succeeds silently (kubelet retries DELs).
- **CHECK**: audits that the recorded state is still consistent — the
  endpoint exists with the allocated IP and the interface record is in
  the netns (CNI spec CHECK; the reference predates it, its analog is
  `cilium endpoint get` validation).

Pod labels arrive through the CNI args (the reference resolves them via
the k8s API; tests pass them directly).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

from ..endpoint.connector import VethRecord, move_to_netns, setup_veth
from .ipam import IpamAllocator
from .network_policy import POD_NAMESPACE_LABEL


class CniError(Exception):
    pass


@dataclass
class CniResult:
    """Subset of the CNI result the reference returns (types.Result)."""

    endpoint_id: int
    ip: str
    gateway: str
    routes: list[str] = field(default_factory=list)
    # CNI "interfaces" list: host-side veth + container eth0.
    host_ifname: str = ""
    container_ifname: str = ""
    container_mac: str = ""


@dataclass
class _Container:
    ep_id: int
    ip: str = ""
    veth: VethRecord | None = None


class CniPlugin:
    """ADD/DEL/CHECK dispatcher bound to one daemon + IPAM range."""

    def __init__(self, daemon, ipam: IpamAllocator, mtu: int = 1500) -> None:
        self.daemon = daemon
        self.ipam = ipam
        self.mtu = mtu
        self._lock = threading.Lock()
        self._next_ep_id = 1000
        self._containers: dict[str, _Container] = {}

    def cni_add(
        self,
        container_id: str,
        namespace: str,
        pod_name: str,
        labels: dict[str, str] | None = None,
        netns: str = "",
    ) -> CniResult:
        """reference: cilium-cni.go cmdAdd: IPAM → veth → netns move →
        endpoint create → result."""
        with self._lock:
            if container_id in self._containers:
                raise CniError(f"container {container_id} already added")
            ep_id = self._next_ep_id
            self._next_ep_id += 1
            # Reserve the slot NOW so a concurrent retried ADD for the
            # same container fails the check above instead of double-
            # allocating (kubelet retries ADDs).  The placeholder stays
            # EMPTY (no ip/veth) until the endpoint exists: a DEL racing
            # this in-flight ADD must find nothing to tear down — it
            # must not free the IP the ADD is about to bind.
            self._containers[container_id] = _Container(ep_id)
        try:
            ip = self.ipam.allocate_next(owner=f"{namespace}/{pod_name}")
        except Exception:
            with self._lock:
                self._containers.pop(container_id, None)
            raise
        # Interface provisioning (connector.SetupVeth) + the netns move
        # (cilium-cni.go:342-355).
        veth = setup_veth(
            container_id, netns or f"/var/run/netns/{container_id}",
            mtu=self.mtu,
        )
        move_to_netns(veth)
        veth.routes = [f"0.0.0.0/0 via {self.ipam.router_ip}"]
        lbl_strs = [
            f"k8s:{k}={v}" for k, v in sorted((labels or {}).items())
        ]
        lbl_strs.append(f"k8s:{POD_NAMESPACE_LABEL}={namespace}")
        try:
            self.daemon.endpoint_create(
                ep_id, ipv4=ip, labels=lbl_strs, container_name=container_id
            )
        except Exception:
            self.ipam.release(ip)
            with self._lock:
                self._containers.pop(container_id, None)
            raise
        with self._lock:
            self._containers[container_id] = _Container(ep_id, ip, veth)
        return CniResult(
            endpoint_id=ep_id,
            ip=ip,
            gateway=self.ipam.router_ip,
            routes=list(veth.routes),
            host_ifname=veth.host_ifname,
            container_ifname=veth.container_ifname,
            container_mac=veth.container_mac,
        )

    def cni_del(self, container_id: str) -> bool:
        """reference: cilium-cni.go cmdDel — idempotent (a DEL for an
        unknown container succeeds; kubelet retries DELs).  Returns
        whether state was actually torn down."""
        with self._lock:
            rec = self._containers.pop(container_id, None)
        if rec is None:
            return False
        self.daemon.endpoint_delete(rec.ep_id)
        if rec.ip:
            self.ipam.release(rec.ip)
        return True

    def cni_check(self, container_id: str) -> None:
        """CNI CHECK: raise CniError if the recorded sandbox state has
        drifted from the daemon's."""
        with self._lock:
            rec = self._containers.get(container_id)
        if rec is None:
            raise CniError(f"container {container_id} not configured")
        ep = self.daemon.endpoint_manager.lookup(rec.ep_id)
        if ep is None:
            raise CniError(f"endpoint {rec.ep_id} missing from the daemon")
        if ep.ipv4 != rec.ip:
            raise CniError(
                f"endpoint IP drifted: {ep.ipv4} != allocated {rec.ip}"
            )
        if rec.veth is None or not rec.veth.moved_to_netns:
            raise CniError("container interface never reached the netns")

    def interfaces(self, container_id: str) -> VethRecord | None:
        """The provisioning record for one container (bugtool/tests)."""
        with self._lock:
            rec = self._containers.get(container_id)
        return rec.veth if rec else None

    def interfaces_all(self) -> dict[str, VethRecord]:
        """Snapshot of every container's provisioning record, taken
        under the lock (the bugtool bundle section)."""
        with self._lock:
            return {
                cid: rec.veth
                for cid, rec in self._containers.items()
                if rec.veth is not None
            }
