"""Node registry: local node addressing + cluster node discovery.

reference: pkg/node — local node identity/CIDR config (node.go:40,
address.go) and discovery of remote nodes through a kvstore SharedStore
(``cilium/state/nodes/v1``), installing per-node state (the reference
installs routes; here the tunnel/ipcache state used by the datapath ops).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Optional

from ..kvstore import Backend, client as kvstore_client
from ..kvstore.store import SharedStore

NODES_PATH = "cilium/state/nodes/v1"


@dataclass
class Node:
    """reference: pkg/node/node.go Node."""

    name: str
    cluster: str = "default"
    ipv4_address: str = ""
    ipv6_address: str = ""
    ipv4_alloc_cidr: str = ""
    ipv6_alloc_cidr: str = ""
    ipv4_health_ip: str = ""

    def to_dict(self) -> dict:
        return {
            "Name": self.name,
            "Cluster": self.cluster,
            "IPv4Address": self.ipv4_address,
            "IPv6Address": self.ipv6_address,
            "IPv4AllocCIDR": self.ipv4_alloc_cidr,
            "IPv6AllocCIDR": self.ipv6_alloc_cidr,
            "IPv4HealthIP": self.ipv4_health_ip,
        }

    @staticmethod
    def from_dict(d: dict) -> "Node":
        return Node(
            name=d.get("Name", ""),
            cluster=d.get("Cluster", "default"),
            ipv4_address=d.get("IPv4Address", ""),
            ipv6_address=d.get("IPv6Address", ""),
            ipv4_alloc_cidr=d.get("IPv4AllocCIDR", ""),
            ipv6_alloc_cidr=d.get("IPv6AllocCIDR", ""),
            ipv4_health_ip=d.get("IPv4HealthIP", ""),
        )

    def fullname(self) -> str:
        return f"{self.cluster}/{self.name}"


class NodeDiscovery:
    """Publishes the local node and tracks remote nodes
    (reference: pkg/node manager + kvstore store)."""

    def __init__(
        self,
        local: Node,
        backend: Backend | None = None,
        on_node_update: Callable[[Node], None] | None = None,
        on_node_delete: Callable[[str], None] | None = None,
    ) -> None:
        self.local = local
        self.nodes: dict[str, Node] = {}
        self._mutex = threading.RLock()
        self._on_update = on_node_update
        self._on_delete = on_node_delete
        self.store = SharedStore(
            backend or kvstore_client(),
            NODES_PATH,
            node_name=local.fullname(),
            on_update=self._store_update,
            on_delete=self._store_delete,
        )
        self.store.update_local_key_sync(local.fullname(), local.to_dict())

    def _store_update(self, name: str, value: dict) -> None:
        node = Node.from_dict(value)
        with self._mutex:
            self.nodes[name] = node
        if self._on_update:
            self._on_update(node)

    def _store_delete(self, name: str) -> None:
        with self._mutex:
            self.nodes.pop(name, None)
        if self._on_delete:
            self._on_delete(name)

    def get_nodes(self) -> dict[str, Node]:
        with self._mutex:
            return dict(self.nodes)

    def update_local(self, **kwargs) -> None:
        for k, v in kwargs.items():
            setattr(self.local, k, v)
        self.store.update_local_key_sync(self.local.fullname(),
                                         self.local.to_dict())

    def close(self) -> None:
        self.store.close()
