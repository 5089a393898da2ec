"""IP -> identity cache with kvstore synchronization.

reference: pkg/ipcache — the agent upserts its local endpoint IPs into the
kvstore (``cilium/state/ip/v1/<cluster>/<ip>``, kvstore.go) and watches the
global prefix (InitIPIdentityWatcher kvstore.go:435); every change fans out
to listeners, the primary one writing the datapath ipcache map
(pkg/datapath/ipcache) — here the port's maps.IpcacheMap, whose device
export (K12 ``lpm_lookup``, K14 / K15) answers batched identity derivation.

A copy of ``cilium_tpu/ipcache/__init__.py``: host code; nothing here
runs on the device until a table is built from the map.
"""

from __future__ import annotations

import json
import threading
from dataclasses import dataclass
from typing import Callable, Optional

from ..kvstore import Backend, client as kvstore_client
from ..kvstore.backend import EventType
from ..maps.ipcache import IpcacheMap

IP_IDENTITIES_PATH = "cilium/state/ip/v1"


@dataclass
class IPIdentityPair:
    """reference: pkg/identity IPIdentityPair."""

    ip: str
    identity: int
    tunnel_endpoint: int = 0
    host_ip: str = ""


class IPIdentityCache:
    """Local authoritative IP->identity mapping + listener fan-out
    (reference: pkg/ipcache/ipcache.go:66 IPCache)."""

    def __init__(self, cluster_name: str = "default") -> None:
        self.cluster = cluster_name
        self._cache: dict[str, IPIdentityPair] = {}
        self._mutex = threading.RLock()
        self._listeners: list[Callable[[str, str, Optional[IPIdentityPair]], None]] = []

    def add_listener(
        self, listener: Callable[[str, str, Optional[IPIdentityPair]], None]
    ) -> None:
        """listener(event, ip, pair) with event in {"upsert", "delete"};
        on registration the current state replays as upserts (reference:
        ipcache.go addListener initial sync)."""
        with self._mutex:
            self._listeners.append(listener)
            current = list(self._cache.values())
        for pair in current:
            listener("upsert", pair.ip, pair)

    def upsert(self, ip: str, identity: int, tunnel_endpoint: int = 0,
               host_ip: str = "") -> bool:
        """reference: ipcache.go:217 Upsert; returns False if unchanged."""
        pair = IPIdentityPair(ip, identity, tunnel_endpoint, host_ip)
        # Notification happens under the mutex so listener (datapath map)
        # update order always matches cache mutation order.
        with self._mutex:
            old = self._cache.get(ip)
            if (old is not None and old.identity == identity
                    and old.tunnel_endpoint == tunnel_endpoint
                    and old.host_ip == host_ip):
                return False
            self._cache[ip] = pair
            for l in self._listeners:
                l("upsert", ip, pair)
        return True

    def delete(self, ip: str) -> bool:
        with self._mutex:
            pair = self._cache.pop(ip, None)
            if pair is None:
                return False
            for l in self._listeners:
                l("delete", ip, None)
        return True

    def lookup_by_ip(self, ip: str) -> Optional[int]:
        with self._mutex:
            pair = self._cache.get(ip)
            return pair.identity if pair else None

    def lookup_by_identity(self, identity: int) -> list[str]:
        with self._mutex:
            return [ip for ip, p in self._cache.items()
                    if p.identity == identity]

    def dump(self) -> list[IPIdentityPair]:
        with self._mutex:
            return sorted(self._cache.values(), key=lambda p: p.ip)


class KvstoreIPSync:
    """Bidirectional kvstore sync (reference: pkg/ipcache/kvstore.go).

    upsert_to_kvstore publishes local endpoint IPs; the watcher merges
    remote nodes' entries into the local IPIdentityCache.
    """

    def __init__(self, cache: IPIdentityCache,
                 backend: Backend | None = None) -> None:
        self.cache = cache
        self.backend = backend or kvstore_client()
        self._watcher = None

    def _path(self, ip: str) -> str:
        return f"{IP_IDENTITIES_PATH}/{self.cache.cluster}/{ip}"

    def upsert_to_kvstore(self, pair: IPIdentityPair) -> None:
        """reference: kvstore.go upsertToKVStore."""
        self.backend.set(
            self._path(pair.ip),
            json.dumps({
                "IP": pair.ip,
                "ID": pair.identity,
                "TunnelEndpoint": pair.tunnel_endpoint,
                "HostIP": pair.host_ip,
            }).encode(),
            lease=True,
        )

    def delete_from_kvstore(self, ip: str) -> None:
        self.backend.delete(self._path(ip))

    def start_watcher(self) -> None:
        """reference: kvstore.go:435 InitIPIdentityWatcher."""
        w = self.backend.list_and_watch(
            "ipcache", f"{IP_IDENTITIES_PATH}/{self.cache.cluster}/"
        )
        self._watcher = w

        prefix = f"{IP_IDENTITIES_PATH}/{self.cache.cluster}/"

        def run() -> None:
            for ev in w:
                if ev.typ == EventType.LIST_DONE:
                    continue
                # Strip the watch prefix, not rsplit: the ip may itself be a
                # CIDR prefix containing '/'.
                ip = ev.key[len(prefix):]
                if ev.typ == EventType.DELETE:
                    self.cache.delete(ip)
                else:
                    try:
                        data = json.loads(ev.value.decode())
                    except ValueError:
                        continue
                    self.cache.upsert(
                        data.get("IP", ip),
                        data.get("ID", 0),
                        data.get("TunnelEndpoint", 0),
                        data.get("HostIP", ""),
                    )

        threading.Thread(target=run, name="ipcache-watch", daemon=True).start()

    def stop(self) -> None:
        if self._watcher is not None:
            self._watcher.stop()


def datapath_listener(ipcache_map: IpcacheMap):
    """Listener mirroring the cache into the datapath map (reference:
    pkg/datapath/ipcache writing the BPF ipcache from cache updates)."""

    def on_change(event: str, ip: str, pair: Optional[IPIdentityPair]) -> None:
        prefix = ip if "/" in ip else (
            f"{ip}/128" if ":" in ip else f"{ip}/32"
        )
        if event == "upsert" and pair is not None:
            ipcache_map.upsert(prefix, pair.identity, pair.tunnel_endpoint)
        else:
            ipcache_map.delete(prefix)

    return on_change
