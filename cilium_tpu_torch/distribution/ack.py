"""ACK-tracking resource mutator.

reference: pkg/envoy/xds/ack.go:86 AckingResourceMutatorWrapper — wraps
cache mutations so the caller's Completion completes only once every
targeted node has ACKed a version >= the mutation's; NACKs and stale ACKs
leave the completion pending (the endpoint regeneration then times out and
reverts, reference: pkg/endpoint/bpf.go:555).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from ..utils.completion import Completion
from .cache import Cache
from .server import DistributionServer


@dataclass
class _PendingCompletion:
    """reference: ack.go pendingCompletion."""

    completion: Completion
    type_url: str
    version: int
    remaining_nodes: set = field(default_factory=set)


class AckingMutator:
    """reference: ack.go:86."""

    def __init__(self, cache: Cache, server: DistributionServer) -> None:
        self.cache = cache
        self.server = server
        self._pending: list[_PendingCompletion] = []
        self._mutex = threading.Lock()
        server.add_ack_observer(self._on_ack)

    def upsert(
        self,
        type_url: str,
        name: str,
        resource: Any,
        node_ids: list[str],
        completion: Optional[Completion] = None,
    ) -> Callable[[], None]:
        """reference: ack.go Upsert; returns a revert function."""
        version, updated, revert = self.cache.upsert(
            type_url, name, resource, force=True
        )
        self._track(type_url, version, node_ids, completion)
        return revert or (lambda: None)

    def delete(
        self,
        type_url: str,
        name: str,
        node_ids: list[str],
        completion: Optional[Completion] = None,
    ) -> Callable[[], None]:
        version, updated, revert = self.cache.delete(type_url, name)
        self._track(type_url, version, node_ids, completion)
        return revert or (lambda: None)

    def _track(self, type_url, version, node_ids, completion) -> None:
        if completion is None:
            return
        # Nodes that already ACKed this or a later version don't count.
        remaining = {
            n for n in node_ids
            if self.server.node_acked_version(n, type_url) < version
        }
        if not remaining:
            completion.complete()
            return
        with self._mutex:
            self._pending.append(
                _PendingCompletion(
                    completion=completion,
                    type_url=type_url,
                    version=version,
                    remaining_nodes=remaining,
                )
            )

    def _on_ack(self, node_id: str, type_url: str, version: int,
                nack: bool) -> None:
        """reference: ack.go:138 HandleResourceVersionAck."""
        if nack:
            return
        done: list[_PendingCompletion] = []
        with self._mutex:
            for p in self._pending:
                if p.type_url == type_url and version >= p.version:
                    p.remaining_nodes.discard(node_id)
                    if not p.remaining_nodes:
                        done.append(p)
            self._pending = [p for p in self._pending if p.remaining_nodes]
        for p in done:
            p.completion.complete()

    def pending_count(self) -> int:
        with self._mutex:
            return len(self._pending)
