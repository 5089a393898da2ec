"""Endpoint connector: veth-pair provisioning records.

reference: pkg/endpoint/connector/veth.go SetupVeth — creates the
host-side veth ``lxc<sha>`` and the container peer, derives MACs,
applies the MTU, and hands the peer to the orchestrator to move into
the container netns and rename to eth0.  This build has no kernel to
plumb, so provisioning produces DETERMINISTIC RECORDS of what the
kernel-side connector would have created — the CNI/docker plugins
store them per container and the tests (and bugtool) can audit the
exact interface state a real node would carry.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field


@dataclass
class VethRecord:
    """What SetupVeth would have created for one endpoint."""

    container_id: str
    host_ifname: str  # lxc<sha> on the host side
    tmp_ifname: str  # temporary peer name before the netns move
    container_ifname: str  # name inside the netns (eth0)
    netns: str  # the sandbox netns path
    mtu: int
    host_mac: str
    container_mac: str
    moved_to_netns: bool = False
    routes: list[str] = field(default_factory=list)


def _mac(seed: bytes) -> str:
    """Locally-administered unicast MAC from a hash (reference:
    connector derives the MAC from the endpoint)."""
    h = hashlib.sha256(seed).digest()
    octets = [h[0] & 0b11111110 | 0b00000010, *h[1:6]]
    return ":".join(f"{o:02x}" for o in octets)


def setup_veth(container_id: str, netns: str, mtu: int = 1500) -> VethRecord:
    """reference: connector/veth.go SetupVeth — name derivation is the
    reference's: ``lxc`` + first 10 hex chars of sha256(containerID)."""
    sha = hashlib.sha256(container_id.encode()).hexdigest()
    rec = VethRecord(
        container_id=container_id,
        host_ifname=f"lxc{sha[:10]}",
        tmp_ifname=f"tmp{sha[:5]}",
        container_ifname="eth0",
        netns=netns,
        mtu=mtu,
        host_mac=_mac(b"host:" + container_id.encode()),
        container_mac=_mac(b"peer:" + container_id.encode()),
    )
    return rec


def move_to_netns(rec: VethRecord) -> None:
    """The orchestrator step: peer moves into the sandbox netns and is
    renamed to eth0 (reference: cilium-cni.go netns.Do + ip link set)."""
    rec.moved_to_netns = True
