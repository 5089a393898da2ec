"""fqdn: toFQDNs rules -> generated CIDR rules with TTL-driven refresh.

reference: pkg/fqdn — a DNS poller periodically resolves every DNS name
referenced by a ``toFQDNs`` egress section (dnspoller.go), caches the
answers with their TTLs (cache.go DNSCache), and regenerates the owning
rules' ToCIDRSet with one generated /32 (or /128) per live IP; when the
answer set changes, policy regeneration is triggered so endpoints pick
up the new CIDR identities.

The resolver is injectable (tests use a fake; production wires a real
DNS client); answers below min_ttl are clamped up, mirroring the
reference's MinTTL handling.
"""

from __future__ import annotations

import ipaddress
import threading
import time
from dataclasses import dataclass
from typing import Callable, Iterable

from .policy.api import CIDRRule
from .utils.controller import ControllerManager, ControllerParams

DNS_POLLER_INTERVAL = 5.0  # reference: dnspoller.go DNSPollerInterval
DEFAULT_MIN_TTL = 5.0

# resolver(name) -> (ips, ttl_seconds)
Resolver = Callable[[str], tuple[Iterable[str], float]]


@dataclass
class _CacheEntry:
    ips: tuple[str, ...]
    expires: float


class DnsCache:
    """Name -> live IPs with per-answer TTL (reference: cache.go DNSCache,
    folded to one entry per name — the poller re-resolves whole names)."""

    def __init__(self, clock=time.monotonic) -> None:
        self._entries: dict[str, _CacheEntry] = {}
        self._mutex = threading.Lock()
        self.clock = clock

    def update(self, name: str, ips: Iterable[str], ttl: float) -> None:
        with self._mutex:
            self._entries[name] = _CacheEntry(
                ips=tuple(sorted(set(ips))), expires=self.clock() + ttl
            )

    def lookup(self, name: str) -> tuple[str, ...]:
        with self._mutex:
            e = self._entries.get(name)
            if e is None or e.expires < self.clock():
                return ()
            return e.ips

    def lookup_stale(self, name: str) -> tuple[str, ...]:
        """Last known answer regardless of TTL (used for change
        detection across re-resolution, where ``lookup`` would already
        read () for the just-expired entry)."""
        with self._mutex:
            e = self._entries.get(name)
            return () if e is None else e.ips

    def expired(self, name: str) -> bool:
        with self._mutex:
            e = self._entries.get(name)
            return e is None or e.expires < self.clock()


class DnsPoller:
    """Resolve ToFQDNs names and regenerate rules' generated CIDR sets
    (reference: dnspoller.go LookupUpdateDNS + ruleGen semantics)."""

    def __init__(
        self,
        repo,
        resolver: Resolver,
        on_change: Callable[[], None] | None = None,
        min_ttl: float = DEFAULT_MIN_TTL,
        interval: float = DNS_POLLER_INTERVAL,
        controllers: ControllerManager | None = None,
        clock=time.monotonic,
    ) -> None:
        self.repo = repo
        self.resolver = resolver
        self.on_change = on_change
        self.min_ttl = min_ttl
        self.interval = interval
        self.cache = DnsCache(clock=clock)
        self._controllers = controllers or ControllerManager()
        self._own_controllers = controllers is None
        self._started = False

    def start(self) -> "DnsPoller":
        if not self._started:
            self._started = True
            self._controllers.update_controller(
                "dns-poller",
                ControllerParams(do_func=self.lookup_update_dns,
                                 run_interval=self.interval),
            )
        return self

    # -- one poll cycle ----------------------------------------------------

    def _names_in_use(self) -> set[str]:
        names: set[str] = set()
        with self.repo.mutex:
            for rule in self.repo.rules:
                for eg in rule.egress:
                    for f in eg.to_fqdns:
                        names.add(f.match_name)
        return names

    def lookup_update_dns(self) -> None:
        """Resolve every name whose cache TTL lapsed, then regenerate
        the rules if any answer set changed."""
        changed = False
        for name in sorted(self._names_in_use()):
            if not self.cache.expired(name):
                continue
            before = self.cache.lookup_stale(name)
            try:
                ips, ttl = self.resolver(name)
            except Exception:  # noqa: BLE001 — resolver failure keeps
                continue  # the previous answer until it expires
            self.cache.update(name, ips, max(float(ttl), self.min_ttl))
            if tuple(sorted(set(ips))) != before:
                changed = True
        if changed:
            self.regenerate_rules()
            if self.on_change is not None:
                self.on_change()

    def regenerate_rules(self) -> None:
        """Replace each ToFQDNs egress section's GENERATED CIDR entries
        with the current resolutions (user-written entries survive)."""
        with self.repo.mutex:
            for rule in self.repo.rules:
                for eg in rule.egress:
                    if not eg.to_fqdns:
                        continue
                    kept = [c for c in eg.to_cidr_set if not c.generated]
                    for f in eg.to_fqdns:
                        for ip in self.cache.lookup(f.match_name):
                            addr = ipaddress.ip_address(ip)
                            width = 32 if addr.version == 4 else 128
                            kept.append(
                                CIDRRule(cidr=f"{addr}/{width}",
                                         generated=True)
                            )
                    eg.to_cidr_set = kept
            self.repo.revision += 1

    # -- introspection -----------------------------------------------------

    def generated_cidrs(self) -> dict[str, tuple[str, ...]]:
        return {
            name: self.cache.lookup(name) for name in self._names_in_use()
        }

    def close(self) -> None:
        if self._own_controllers:
            self._controllers.remove_all()
        else:
            self._controllers.remove_controller("dns-poller")
