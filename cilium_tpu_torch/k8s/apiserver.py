"""Fake in-process apiserver: object store with list+watch semantics.

The test/development stand-in for the k8s apiserver the reference's
informers talk to (reference: daemon/k8s_watcher.go EnableK8sWatcher
cache.NewListWatchFromClient).  Same contract the watcher needs:
``list`` returns the current objects of a kind, ``watch`` returns a
subscription that replays ADDED events for existing objects and then
streams subsequent ADDED/MODIFIED/DELETED events in order.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

ADDED = "ADDED"
MODIFIED = "MODIFIED"
DELETED = "DELETED"

# Object kinds the watcher consumes (reference: k8s_watcher.go:472-703).
KIND_NETWORK_POLICY = "NetworkPolicy"
KIND_CNP = "CiliumNetworkPolicy"
KIND_SERVICE = "Service"
KIND_ENDPOINTS = "Endpoints"


@dataclass
class WatchEvent:
    type: str  # ADDED / MODIFIED / DELETED
    kind: str
    obj: dict


def obj_key(obj: dict) -> tuple[str, str]:
    meta = obj.get("metadata") or {}
    return (meta.get("namespace") or "default", meta.get("name", ""))


class FakeApiServer:
    """Thread-safe object store + watch fan-out."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._objects: dict[str, dict[tuple, dict]] = {}
        self._watchers: list[queue.Queue] = []
        self._resource_version = 0

    def list(self, kind: str) -> list[dict]:
        with self._lock:
            return list(self._objects.get(kind, {}).values())

    def watch(self) -> "queue.Queue[WatchEvent]":
        """Subscribe; existing objects replay as ADDED first (informer
        initial-sync semantics)."""
        q: queue.Queue = queue.Queue()
        with self._lock:
            for kind, objs in self._objects.items():
                for obj in objs.values():
                    q.put(WatchEvent(ADDED, kind, obj))
            self._watchers.append(q)
        return q

    def _publish(self, ev: WatchEvent) -> None:
        for q in self._watchers:
            q.put(ev)

    def upsert(self, kind: str, obj: dict) -> None:
        key = obj_key(obj)
        with self._lock:
            objs = self._objects.setdefault(kind, {})
            ev_type = MODIFIED if key in objs else ADDED
            self._resource_version += 1
            obj.setdefault("metadata", {})["resourceVersion"] = str(
                self._resource_version
            )
            objs[key] = obj
            self._publish(WatchEvent(ev_type, kind, obj))

    def delete(self, kind: str, namespace: str, name: str) -> bool:
        with self._lock:
            objs = self._objects.get(kind, {})
            obj = objs.pop((namespace or "default", name), None)
            if obj is None:
                return False
            self._resource_version += 1
            self._publish(WatchEvent(DELETED, kind, obj))
            return True

    def get(self, kind: str, namespace: str, name: str) -> dict | None:
        with self._lock:
            return self._objects.get(kind, {}).get(
                (namespace or "default", name)
            )
