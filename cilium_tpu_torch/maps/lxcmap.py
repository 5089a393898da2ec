"""Local endpoint map (reference: pkg/maps/lxcmap + bpf/lib/common.h:164
endpoint_info): endpoint IP/ID -> interface + MAC info for local delivery.

A copy of ``cilium_tpu/maps/lxcmap.py``; ``to_device`` builds the port's
``DeviceTable`` on ``device`` (None: the CUDA card)."""

from __future__ import annotations

import struct
from dataclasses import dataclass

# ifindex, unused, lxc_id, flags, 4 alignment-pad bytes (mac_t is __u64),
# mac, node_mac, pad[4] (reference: common.h:164-173, mac_t at :59).
_ENDPOINT_INFO_FMT = "<IHHI4xQQ16x"
ENDPOINT_INFO_SIZE = struct.calcsize(_ENDPOINT_INFO_FMT)  # 48

ENDPOINT_F_HOST = 1


@dataclass
class EndpointInfo:
    ifindex: int = 0
    lxc_id: int = 0
    flags: int = 0
    mac: int = 0
    node_mac: int = 0

    def pack(self) -> bytes:
        return struct.pack(
            _ENDPOINT_INFO_FMT, self.ifindex, 0, self.lxc_id, self.flags,
            self.mac, self.node_mac,
        )

    @property
    def is_host(self) -> bool:
        return bool(self.flags & ENDPOINT_F_HOST)


class LxcMap:
    """Host map of local endpoints keyed by IP string or endpoint ID."""

    def __init__(self) -> None:
        self.by_ip: dict[str, EndpointInfo] = {}
        self.by_id: dict[int, EndpointInfo] = {}

    def upsert(self, ip: str, ep_id: int, info: EndpointInfo) -> None:
        # Clear any stale index entries from a previous IP or ID of this
        # endpoint so neither index dangles.
        old_by_id = self.by_id.get(ep_id)
        if old_by_id is not None:
            for old_ip, i in list(self.by_ip.items()):
                if i is old_by_id and old_ip != ip:
                    del self.by_ip[old_ip]
        old_by_ip = self.by_ip.get(ip)
        if old_by_ip is not None and old_by_ip.lxc_id != ep_id:
            self.by_id.pop(old_by_ip.lxc_id, None)
        info.lxc_id = ep_id
        self.by_ip[ip] = info
        self.by_id[ep_id] = info

    def delete_ip(self, ip: str) -> bool:
        info = self.by_ip.pop(ip, None)
        if info is not None:
            self.by_id.pop(info.lxc_id, None)
            return True
        return False

    def lookup_ip(self, ip: str) -> EndpointInfo | None:
        return self.by_ip.get(ip)

    def lookup_id(self, ep_id: int) -> EndpointInfo | None:
        return self.by_id.get(ep_id)

    def dump(self):
        return sorted(self.by_ip.items())

    def to_device(self, pad_to: int | None = None, device=None):
        """Pack the v4 endpoint IPs into an exact-match DeviceTable
        (key: addr; values: [lxc_id, flags]) — the batched analog of
        lookup_ip4_endpoint (reference: bpf/lib/eps.h, consumed by
        bpf_netdev.c handle_ipv4 for local delivery demux)."""
        import ipaddress

        import numpy as np

        from ..ops.maplookup import pack_table, u32_to_i32

        rows = []
        vals = []
        for ip, info in self.by_ip.items():
            addr = ipaddress.ip_address(ip)
            if addr.version != 4:
                continue
            rows.append([int(addr) & 0xFFFFFFFF])
            vals.append([info.lxc_id, info.flags])
        keys = u32_to_i32(np.array(rows or np.zeros((0, 1)), np.int64))
        return pack_table(
            keys.reshape(-1, 1),
            np.array(vals or np.zeros((0, 2)), np.int64).astype(np.int32),
            pad_to=pad_to,
            device=device,
        )
