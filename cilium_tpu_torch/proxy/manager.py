"""Proxy port allocation and redirect lifecycle.

reference: pkg/proxy/proxy.go — port allocator over the 10000-20000 range
(daemon/daemon.go:1327), CreateOrUpdateRedirect/RemoveRedirect keyed by
ProxyID (pkg/policy/proxyid.go), dispatch by L7 parser type
(proxy.go:229-236).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..policy.l4 import L4Filter
from ..utils import defaults
from ..utils.logging import get_logger

log = get_logger("proxy")


@dataclass
class Redirect:
    """reference: pkg/proxy Redirect."""

    proxy_id: str
    proxy_port: int
    endpoint_id: int
    ingress: bool
    l7_parser: str
    l4_filter: Optional[L4Filter] = None
    # Backend handle: the runtime batch engine serving this redirect.
    implementation: object = None


class ProxyManager:
    """reference: pkg/proxy/proxy.go:59 Proxy."""

    def __init__(
        self,
        port_min: int = defaults.PROXY_PORT_MIN,
        port_max: int = defaults.PROXY_PORT_MAX,
        create_backend: Callable[[Redirect], object] | None = None,
    ) -> None:
        self.port_min = port_min
        self.port_max = port_max
        self.redirects: dict[str, Redirect] = {}
        self.allocated_ports: set[int] = set()
        self._next = port_min
        self._mutex = threading.RLock()
        # Called on new redirects to instantiate the serving engine; the
        # daemon wires this to the runtime's per-protocol batch engines.
        self.create_backend = create_backend

    def _allocate_port(self) -> int:
        """reference: proxy.go allocatePort — linear scan from the range."""
        with self._mutex:
            for _ in range(self.port_max - self.port_min + 1):
                port = self._next
                self._next += 1
                if self._next > self.port_max:
                    self._next = self.port_min
                if port not in self.allocated_ports:
                    self.allocated_ports.add(port)
                    return port
        raise RuntimeError("proxy port range exhausted")

    def create_or_update_redirect(
        self, l4: L4Filter, proxy_id: str, endpoint_id: int
    ) -> Redirect:
        """reference: proxy.go:154 CreateOrUpdateRedirect."""
        with self._mutex:
            existing = self.redirects.get(proxy_id)
            if existing is not None:
                if existing.l7_parser != l4.l7_parser:
                    raise ValueError(
                        f"redirect {proxy_id} parser change "
                        f"{existing.l7_parser} -> {l4.l7_parser} not allowed"
                    )
                existing.l4_filter = l4
                # Rules or identity expansions may have changed: rebuild
                # the serving engine's compiled model (reference: updated
                # NPDS policy re-applied to the running proxy).
                if self.create_backend is not None:
                    existing.implementation = self.create_backend(existing)
                return existing
            port = self._allocate_port()
            r = Redirect(
                proxy_id=proxy_id,
                proxy_port=port,
                endpoint_id=endpoint_id,
                ingress=l4.ingress,
                l7_parser=l4.l7_parser,
                l4_filter=l4,
            )
            if self.create_backend is not None:
                r.implementation = self.create_backend(r)
            self.redirects[proxy_id] = r
            log.with_fields(proxyID=proxy_id, port=port,
                            parser=l4.l7_parser).debug("created redirect")
            return r

    def remove_redirect(self, proxy_id: str) -> bool:
        """reference: proxy.go RemoveRedirect."""
        with self._mutex:
            r = self.redirects.pop(proxy_id, None)
            if r is None:
                return False
            self.allocated_ports.discard(r.proxy_port)
        return True

    def remove_endpoint_redirects(self, endpoint_id: int) -> int:
        with self._mutex:
            dead = [pid for pid, r in self.redirects.items()
                    if r.endpoint_id == endpoint_id]
        for pid in dead:
            self.remove_redirect(pid)
        return len(dead)

    def get(self, proxy_id: str) -> Optional[Redirect]:
        return self.redirects.get(proxy_id)
