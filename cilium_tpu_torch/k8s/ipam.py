"""Host-scope IPAM: per-node pod CIDR allocator.

reference: pkg/ipam (host-scope allocator from the node's allocation
CIDR) + daemon/ipam.go REST handlers.  Sequential-with-free-list
allocation over the usable host range; the network/broadcast addresses
and the router IP (first usable) are reserved.
"""

from __future__ import annotations

import ipaddress
import threading


class IpamError(Exception):
    pass


class IpamAllocator:
    """reference: pkg/ipam/allocator.go."""

    def __init__(self, cidr: str) -> None:
        self.network = ipaddress.ip_network(cidr, strict=False)
        self._lock = threading.Lock()
        self._allocated: dict[str, str] = {}  # ip -> owner
        first = int(self.network.network_address) + 1
        self.router_ip = str(ipaddress.ip_address(first))
        self._allocated[self.router_ip] = "router"
        self._next = first + 1
        self._free: list[int] = []
        self._last = int(self.network.broadcast_address) - (
            1 if self.network.version == 4 else 0
        )

    def allocate_next(self, owner: str) -> str:
        """Next free address (reference: allocator.go AllocateNext)."""
        with self._lock:
            if self._free:
                ip = ipaddress.ip_address(self._free.pop())
            else:
                # Skip addresses claimed out-of-band via allocate_ip.
                while (
                    self._next <= self._last
                    and str(ipaddress.ip_address(self._next)) in self._allocated
                ):
                    self._next += 1
                if self._next > self._last:
                    raise IpamError(f"range {self.network} exhausted")
                ip = ipaddress.ip_address(self._next)
                self._next += 1
            s = str(ip)
            self._allocated[s] = owner
            return s

    def allocate_ip(self, ip: str, owner: str) -> str:
        """Allocate a specific address (reference: allocator.go Allocate)."""
        with self._lock:
            addr = ipaddress.ip_address(ip)
            if addr not in self.network:
                raise IpamError(f"{ip} not in range {self.network}")
            if ip in self._allocated:
                raise IpamError(f"{ip} already allocated")
            # A previously released address must leave the free list or
            # allocate_next would hand it out a second time.
            try:
                self._free.remove(int(addr))
            except ValueError:
                pass
            self._allocated[ip] = owner
            return ip

    def release(self, ip: str) -> bool:
        with self._lock:
            if self._allocated.pop(ip, None) is None:
                return False
            self._free.append(int(ipaddress.ip_address(ip)))
            return True

    def dump(self) -> dict[str, str]:
        with self._lock:
            return dict(self._allocated)

    def __len__(self) -> int:
        with self._lock:
            return len(self._allocated)
