"""Clustermesh: merge remote clusters' state into the local caches.

reference: pkg/clustermesh/{clustermesh.go,remote_cluster.go} — the agent
watches a config directory where each file names a remote cluster and
carries its kvstore client config; per cluster it connects and merges
nodes and ipcache entries (identities share one global id space across
the mesh).  Here a remote cluster config is a JSON file
``{"address": "host:port"}`` pointing at that cluster's KvstoreServer;
removing the file disconnects and purges everything learned from it.
"""

from __future__ import annotations

import json
import logging
import os
import threading

from .ipcache import IP_IDENTITIES_PATH, IPIdentityCache
from .kvstore import EventType, NetBackend
from .node import NODES_PATH, Node
from .utils.controller import ControllerManager, ControllerParams

log = logging.getLogger(__name__)


class RemoteCluster:
    """One connected remote cluster (reference: remote_cluster.go)."""

    def __init__(self, name: str, address: str, cache: IPIdentityCache) -> None:
        self.name = name
        self.address = address
        self.cache = cache
        self.backend = NetBackend(address)
        self.nodes: dict[str, Node] = {}
        self._learned_ips: set[str] = set()
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._watch(f"{IP_IDENTITIES_PATH}/{name}/", self._ip_event)
        self._watch(f"{NODES_PATH}/{name}/", self._node_event)

    def _watch(self, prefix: str, handler) -> None:
        w = self.backend.list_and_watch(f"mesh-{self.name}", prefix)

        def run() -> None:
            while not self._stop.is_set():
                ev = w.next_event(timeout=0.2)
                if ev is None or ev.typ == EventType.LIST_DONE:
                    continue
                try:
                    handler(prefix, ev)
                except Exception:  # noqa: BLE001
                    log.exception("clustermesh %s event failed", self.name)
            w.stop()

        t = threading.Thread(
            target=run, daemon=True, name=f"mesh-{self.name}"
        )
        t.start()
        self._threads.append(t)

    def _ip_event(self, prefix: str, ev) -> None:
        ip = ev.key[len(prefix):]
        if ev.typ == EventType.DELETE:
            self.cache.delete(ip)
            self._learned_ips.discard(ip)
            return
        data = json.loads(ev.value.decode())
        self.cache.upsert(
            data.get("IP", ip), data.get("ID", 0),
            data.get("TunnelEndpoint", 0), data.get("HostIP", ""),
        )
        self._learned_ips.add(data.get("IP", ip))

    def _node_event(self, prefix: str, ev) -> None:
        name = ev.key[len(prefix):]
        if ev.typ == EventType.DELETE:
            self.nodes.pop(name, None)
            return
        self.nodes[name] = Node.from_dict(json.loads(ev.value.decode()))

    def status(self) -> dict:
        return {
            "name": self.name,
            "address": self.address,
            "connected": self.backend.ping(),
            "nodes": len(self.nodes),
            "ips": len(self._learned_ips),
        }

    def close(self) -> None:
        """Disconnect and purge everything learned from this cluster
        (reference: remote_cluster.go onRemove)."""
        self._stop.set()
        for ip in sorted(self._learned_ips):
            self.cache.delete(ip)
        self._learned_ips.clear()
        self.nodes.clear()
        self.backend.close()


class ClusterMesh:
    """Config-dir watcher wiring RemoteClusters (clustermesh.go:NewClusterMesh)."""

    def __init__(self, config_dir: str, cache: IPIdentityCache,
                 controllers: ControllerManager | None = None,
                 interval: float = 0.2) -> None:
        self.config_dir = config_dir
        self.cache = cache
        self.clusters: dict[str, RemoteCluster] = {}
        self._mutex = threading.Lock()
        self._controllers = controllers or ControllerManager()
        self._own_controllers = controllers is None
        os.makedirs(config_dir, exist_ok=True)
        self._controllers.update_controller(
            "clustermesh-config",
            ControllerParams(do_func=self.sync, run_interval=interval),
        )

    def sync(self) -> None:
        """Reconcile connected clusters against the config dir."""
        want: dict[str, str] = {}
        for fn in sorted(os.listdir(self.config_dir)):
            path = os.path.join(self.config_dir, fn)
            if not os.path.isfile(path):
                continue
            try:
                with open(path) as f:
                    want[fn] = json.load(f)["address"]
            except (ValueError, KeyError, OSError):
                log.warning("bad clustermesh config %s", path)
        with self._mutex:
            for name in list(self.clusters):
                cluster = self.clusters[name]
                if name not in want or cluster.address != want[name]:
                    self.clusters.pop(name).close()
                elif not cluster.backend.ping():
                    # Connection died (remote store restart): drop and
                    # reconnect on this pass (reference: remote clusters
                    # reconnect with backoff, remote_cluster.go).
                    self.clusters.pop(name).close()
            for name, address in want.items():
                if name not in self.clusters:
                    try:
                        self.clusters[name] = RemoteCluster(
                            name, address, self.cache
                        )
                    except OSError as e:
                        log.warning(
                            "clustermesh %s unreachable: %s", name, e
                        )

    def status(self) -> list[dict]:
        with self._mutex:
            return [c.status() for c in self.clusters.values()]

    def num_connected(self) -> int:
        with self._mutex:
            return sum(1 for c in self.clusters.values())

    def close(self) -> None:
        if self._own_controllers:
            self._controllers.remove_all()
        else:
            self._controllers.remove_controller("clustermesh-config")
        with self._mutex:
            for c in self.clusters.values():
                c.close()
            self.clusters.clear()
