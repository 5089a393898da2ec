"""Subscription streams and ACK bookkeeping.

reference: pkg/envoy/xds/server.go — per-(node, typeURL) subscription
streams: the server sends the current versioned resource set whenever it
changes; the client responds with an ACK naming the version it applied (or
a NACK repeating the old version).  The ACK observers drive the acking
mutator's completions.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass, field
from typing import Callable, Optional

from .cache import Cache, VersionedResources


@dataclass
class Subscription:
    node_id: str
    type_url: str
    events: "queue.Queue[VersionedResources]" = field(
        default_factory=lambda: queue.Queue()
    )
    last_sent: int = 0
    last_acked: int = 0

    def next(self, timeout: float | None = None) -> Optional[VersionedResources]:
        try:
            return self.events.get(timeout=timeout)
        except queue.Empty:
            return None


class DistributionServer:
    """reference: pkg/envoy/xds/server.go Server + ack observers."""

    def __init__(self, cache: Cache) -> None:
        self.cache = cache
        self._subs: list[Subscription] = []
        self._mutex = threading.RLock()
        # ack observers: (node_id, type_url, acked_version, nack)
        self._ack_observers: list[Callable[[str, str, int, bool], None]] = []
        cache.add_observer(self._on_cache_change)

    def add_ack_observer(self, obs: Callable[[str, str, int, bool], None]) -> None:
        self._ack_observers.append(obs)

    def subscribe(self, node_id: str, type_url: str) -> Subscription:
        """Open a stream; the current state is delivered immediately
        (reference: server.go initial versioned response)."""
        sub = Subscription(node_id=node_id, type_url=type_url)
        with self._mutex:
            self._subs.append(sub)
        current = self.cache.get_resources(type_url, since_version=0)
        if current is not None:
            sub.last_sent = current.version
            sub.events.put(current)
        return sub

    def unsubscribe(self, sub: Subscription) -> None:
        with self._mutex:
            try:
                self._subs.remove(sub)
            except ValueError:
                pass

    def _on_cache_change(self, type_url: str, version: int) -> None:
        with self._mutex:
            subs = [s for s in self._subs if s.type_url == type_url]
        for sub in subs:
            vr = self.cache.get_resources(type_url, since_version=sub.last_sent)
            if vr is not None:
                sub.last_sent = vr.version
                sub.events.put(vr)

    def ack(self, sub: Subscription, version: int, nack: bool = False) -> None:
        """Client acknowledgement (reference: xds/ack.go HandleResourceVersionAck)."""
        if not nack:
            sub.last_acked = max(sub.last_acked, version)
        for obs in list(self._ack_observers):
            obs(sub.node_id, sub.type_url, version, nack)

    def node_acked_version(self, node_id: str, type_url: str) -> int:
        with self._mutex:
            return max(
                (s.last_acked for s in self._subs
                 if s.node_id == node_id and s.type_url == type_url),
                default=0,
            )
