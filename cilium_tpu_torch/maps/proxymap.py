"""Proxy redirect map: proxied 5-tuple -> original destination + identities.

reference: pkg/maps/proxymap (proxy4_tbl) + bpf/lib/lxc.h:103-138
(proxy4_create/update writes on redirect) + envoy/proxymap.cc (the proxy
reading back the original destination on accept).  Entries expire after
PROXY_DEFAULT_LIFETIME unless refreshed.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

# reference: bpf/lib/common.h PROXY_DEFAULT_LIFETIME
PROXY_DEFAULT_LIFETIME = 720


@dataclass(frozen=True)
class ProxyKey4:
    """From the source's perspective; dport is the local proxy port
    (reference: pkg/maps/proxymap/ipv4.go:32)."""

    saddr: int
    daddr: int
    sport: int
    dport: int
    nexthdr: int


@dataclass
class ProxyValue4:
    orig_daddr: int
    orig_dport: int
    identity: int
    lifetime: int = 0


class ProxyMap:
    """Host proxy map (reference: pkg/maps/proxymap)."""

    def __init__(self, clock=time.monotonic) -> None:
        self.entries: dict[ProxyKey4, ProxyValue4] = {}
        self.clock = clock

    def create(self, key: ProxyKey4, orig_daddr: int, orig_dport: int,
               identity: int) -> None:
        self.entries[key] = ProxyValue4(
            orig_daddr=orig_daddr,
            orig_dport=orig_dport,
            identity=identity,
            lifetime=int(self.clock()) + PROXY_DEFAULT_LIFETIME,
        )

    def lookup(self, key: ProxyKey4) -> ProxyValue4 | None:
        """Lookup + lifetime refresh (proxies keep entries alive via
        TCP keepalive in the reference)."""
        v = self.entries.get(key)
        if v is None:
            return None
        now = int(self.clock())
        if v.lifetime < now:
            del self.entries[key]
            return None
        v.lifetime = now + PROXY_DEFAULT_LIFETIME
        return v

    def gc(self) -> int:
        now = int(self.clock())
        dead = [k for k, v in self.entries.items() if v.lifetime < now]
        for k in dead:
            del self.entries[k]
        return len(dead)

    def flush(self) -> int:
        n = len(self.entries)
        self.entries.clear()
        return n

    def save(self, path: str) -> int:
        """Write a binary snapshot for the native proxy side (the
        pinned-BPF-map analog; reader: native/shim.cc
        cilium_tpu_proxymap_open / envoy/proxymap.cc counterpart).
        Layout: b"CTPM" + uint32 count + count * 8 LE uint32s
        (saddr, daddr, sport, dport, proto, orig_daddr, orig_dport,
        identity).  Expired entries are skipped; the write is atomic
        (tmp + rename) so the reader never sees a torn file.
        Returns the number of entries written."""
        import os
        import struct

        now = int(self.clock())
        live = [
            (k, v) for k, v in self.entries.items() if v.lifetime >= now
        ]
        blob = b"CTPM" + struct.pack("<I", len(live))
        for k, v in live:
            blob += struct.pack(
                "<8I",
                k.saddr & 0xFFFFFFFF, k.daddr & 0xFFFFFFFF,
                k.sport, k.dport, k.nexthdr,
                v.orig_daddr & 0xFFFFFFFF, v.orig_dport, v.identity,
            )
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, path)
        return len(live)

    def dump(self):
        return sorted(
            self.entries.items(),
            key=lambda kv: (kv[0].saddr, kv[0].sport, kv[0].dport),
        )
