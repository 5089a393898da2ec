"""IP -> identity cache map with LPM semantics.

reference: pkg/maps/ipcache (BPF ipcache LPM/hash map) + bpf/lib/eps.h
(lookup_ip4_remote_endpoint).  Host-authoritative prefix -> identity table;
``to_device`` exports a DeviceLpm so identity derivation for F source
addresses is one batched longest-prefix sweep (the bpf_netdev.c ingress
identity path, reference: bpf/bpf_netdev.c identity from ipcache).

A copy of ``cilium_tpu/maps/ipcache.py``; ``to_device`` builds the
port's ``DeviceLpm`` on ``device`` (None: the CUDA card).
"""

from __future__ import annotations

import ipaddress
from dataclasses import dataclass

from ..ops.lpm import DeviceLpm, build_lpm


@dataclass
class RemoteEndpointInfo:
    """reference: bpf/lib/common.h:175 remote_endpoint_info."""

    sec_label: int
    tunnel_endpoint: int = 0


class IpcacheMap:
    """Host IP->identity map (reference: pkg/maps/ipcache/ipcache.go)."""

    def __init__(self) -> None:
        # key -> (parsed network, info); networks parsed once on upsert.
        self.v4: dict[str, tuple] = {}
        self.v6: dict[str, tuple] = {}

    def upsert(self, prefix: str, sec_label: int, tunnel_endpoint: int = 0) -> None:
        net = ipaddress.ip_network(prefix, strict=False)
        key = str(net)
        info = RemoteEndpointInfo(sec_label, tunnel_endpoint)
        (self.v4 if net.version == 4 else self.v6)[key] = (net, info)

    def delete(self, prefix: str) -> bool:
        net = ipaddress.ip_network(prefix, strict=False)
        key = str(net)
        table = self.v4 if net.version == 4 else self.v6
        return table.pop(key, None) is not None

    def lookup(self, ip: str) -> RemoteEndpointInfo | None:
        """Host-side LPM lookup."""
        addr = ipaddress.ip_address(ip)
        table = self.v4 if addr.version == 4 else self.v6
        best = None
        best_len = -1
        for net, info in table.values():
            if addr in net and net.prefixlen > best_len:
                best, best_len = info, net.prefixlen
        return best

    def dump(self):
        return sorted((k, v[1]) for k, v in self.v4.items()) + sorted(
            (k, v[1]) for k, v in self.v6.items()
        )

    def save(self, path: str) -> int:
        """Write a v4 binary snapshot for the native datapath process
        (the PolicyHostMap analog; reader: native/shim.cc
        cilium_tpu_hostmap_open — reference: envoy/cilium_host_map.cc
        PolicyHostMap, which subscribes the same IP->identity data via
        NPHDS).  Layout: b"CTHM" + uint32 count + count * 4 LE uint32s
        (network address host-order, prefix_len, sec_label,
        tunnel_endpoint).  Atomic via tmp + rename.  Returns the entry
        count."""
        import os
        import struct

        recs = []
        for net, info in self.v4.values():
            recs.append(
                struct.pack(
                    "<4I",
                    int(net.network_address), net.prefixlen,
                    info.sec_label & 0xFFFFFFFF,
                    info.tunnel_endpoint & 0xFFFFFFFF,
                )
            )
        blob = b"CTHM" + struct.pack("<I", len(recs)) + b"".join(recs)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, path)
        return len(recs)

    def to_device(
        self,
        v6: bool = False,
        pad_to: int | None = None,
        value: str = "sec_label",
        device=None,
    ) -> DeviceLpm:
        """Export one value column as a DeviceLpm: 'sec_label' (identity
        derivation) or 'tunnel_endpoint' (overlay forwarding, reference:
        bpf_netdev.c encap_and_redirect_with_nodeid on
        info->tunnel_endpoint)."""
        from ..ops.maplookup import u32_to_i32

        table = self.v6 if v6 else self.v4
        # Values ride int32 lanes as bit patterns (tunnel endpoints are
        # full uint32 addresses).
        return build_lpm(
            [
                (prefix, int(u32_to_i32(getattr(info, value))))
                for prefix, (_, info) in table.items()
            ],
            v6=v6,
            pad_to=pad_to,
            device=device,
        )
