"""Endpoint manager: ID/name/IP indexes over all local endpoints.

reference: pkg/endpointmanager — insert/remove with index maintenance,
lookups by ID, container name, IP; bulk policy-update triggering across
endpoints (endpointmanager.go TriggerPolicyUpdates).

A copy of ``cilium_tpu/endpoint/manager.py``; a manager holds the
endpoints of one device (None: the CUDA card, raising without one).
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from ..device import resolve_device
from .endpoint import Endpoint


class EndpointManager:
    def __init__(self, device=None) -> None:
        self.device = resolve_device(device)
        self._by_id: dict[int, Endpoint] = {}
        self._by_container: dict[str, Endpoint] = {}
        self._by_ipv4: dict[str, Endpoint] = {}
        self.mutex = threading.RLock()

    def insert(self, ep: Endpoint) -> None:
        if ep.device != self.device:
            raise ValueError(
                f"endpoint {ep.id} exports to {ep.device}, the manager's "
                f"endpoints to {self.device}"
            )
        with self.mutex:
            self._by_id[ep.id] = ep
            if ep.container_name:
                self._by_container[ep.container_name] = ep
            if ep.ipv4:
                self._by_ipv4[ep.ipv4] = ep

    def remove(self, ep: Endpoint) -> bool:
        with self.mutex:
            found = self._by_id.pop(ep.id, None) is not None
            if ep.container_name:
                self._by_container.pop(ep.container_name, None)
            if ep.ipv4:
                self._by_ipv4.pop(ep.ipv4, None)
        return found

    def lookup(self, endpoint_id: int) -> Optional[Endpoint]:
        return self._by_id.get(endpoint_id)

    def lookup_container(self, name: str) -> Optional[Endpoint]:
        return self._by_container.get(name)

    def lookup_ipv4(self, ip: str) -> Optional[Endpoint]:
        return self._by_ipv4.get(ip)

    def get_endpoints(self) -> list[Endpoint]:
        with self.mutex:
            return sorted(self._by_id.values(), key=lambda e: e.id)

    def __len__(self) -> int:
        return len(self._by_id)

    def trigger_policy_updates(
        self, enqueue: Callable[[Endpoint], None]
    ) -> int:
        """Queue every endpoint for regeneration (reference:
        endpointmanager TriggerPolicyUpdates feeding the build queue)."""
        eps = self.get_endpoints()
        for ep in eps:
            enqueue(ep)
        return len(eps)
