"""Per-endpoint policy map: {identity, dport, proto, dir} -> {proxy_port}.

reference: pkg/maps/policymap/policymap.go (PolicyKey/PolicyEntry, Allow/
Delete/DumpToSlice) and the in-kernel lookup cascade bpf/lib/policy.h:47
__policy_can_access:

  1. {identity, dport, proto}  hit -> proxy_port (0 = allow, no redirect)
  2. {identity, 0, 0}          hit -> allow at L3 (no redirect)
  3. {0, dport, proto}         hit -> proxy_port (wildcard-identity L4)
  4. miss                      -> drop

The host table is authoritative and keeps the packed binary ABI (packed key
8 bytes, entry 24 bytes, checked by cilium_tpu.alignchecker); ``to_device``
exports the cascade as a DeviceTable for the batched verdict op.

Counterpart of ``cilium_tpu/maps/policymap.py``: the host map is a copy;
on the card ``policy_can_access_batch`` is kernel K13's
``policy_can_access`` launcher (``csrc/l34_tables.cu``), which probes the
table's hashed index for the three keys of the cascade at once.
"""

from __future__ import annotations

import ctypes
import struct
from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels
from ..ops.l34_index import HashIx
from ..ops.maplookup import DeviceTable, ExactTab, exact_lookup_plain, pack_table

# Traffic directions (reference: pkg/maps/policymap/policymap.go Ingress=0x1?
# — the datapath encodes egress as a 1-bit flag in policy_key, common.h:184).
DIR_INGRESS = 0
DIR_EGRESS = 1

ALL_PORTS = 0

# Packed layouts (reference: bpf/lib/common.h:180-193).
_KEY_FMT = "<IHBB"  # sec_label, dport(be stored as-is), protocol, egress-bit
_ENTRY_FMT = "<HHHHQQ"  # proxy_port(be), pad[3], packets, bytes

KEY_SIZE = struct.calcsize(_KEY_FMT)  # 8
ENTRY_SIZE = struct.calcsize(_ENTRY_FMT)  # 24

MAX_ENTRIES = 65536


@dataclass(frozen=True)
class PolicyKey:
    """reference: policymap.go:64 PolicyKey."""

    identity: int
    dest_port: int = 0  # host byte-order here; packed as big-endian
    proto: int = 0
    direction: int = DIR_INGRESS

    def pack(self) -> bytes:
        be_port = ((self.dest_port & 0xFF) << 8) | (self.dest_port >> 8)
        return struct.pack(_KEY_FMT, self.identity, be_port, self.proto,
                           self.direction & 1)

    @staticmethod
    def unpack(b: bytes) -> "PolicyKey":
        identity, be_port, proto, egress = struct.unpack(_KEY_FMT, b)
        port = ((be_port & 0xFF) << 8) | (be_port >> 8)
        return PolicyKey(identity, port, proto, egress & 1)

    def __str__(self) -> str:
        d = "Egress" if self.direction == DIR_EGRESS else "Ingress"
        if self.dest_port:
            return f"{d}: {self.identity} {self.dest_port}/{self.proto}"
        return f"{d}: {self.identity}"


@dataclass
class PolicyEntry:
    """reference: policymap.go:73 PolicyEntry."""

    proxy_port: int = 0  # host byte-order; packed as big-endian
    packets: int = 0
    bytes: int = 0

    def pack(self) -> bytes:
        be_port = ((self.proxy_port & 0xFF) << 8) | (self.proxy_port >> 8)
        return struct.pack(_ENTRY_FMT, be_port, 0, 0, 0, self.packets, self.bytes)

    @staticmethod
    def unpack(b: bytes) -> "PolicyEntry":
        be_port, _, _, _, packets, nbytes = struct.unpack(_ENTRY_FMT, b)
        port = ((be_port & 0xFF) << 8) | (be_port >> 8)
        return PolicyEntry(port, packets, nbytes)


class PolicyMap:
    """Host-side authoritative policy map (reference: policymap.go)."""

    def __init__(self, endpoint_id: int = 0) -> None:
        self.endpoint_id = endpoint_id
        self.entries: dict[PolicyKey, PolicyEntry] = {}

    def allow(
        self,
        identity: int,
        dport: int = 0,
        proto: int = 0,
        direction: int = DIR_INGRESS,
        proxy_port: int = 0,
    ) -> None:
        """reference: policymap.go:164-186 Allow/AllowKey."""
        key = PolicyKey(identity, dport, proto, direction)
        existing = self.entries.get(key)
        if existing is not None:
            existing.proxy_port = proxy_port
        else:
            if len(self.entries) >= MAX_ENTRIES:
                raise OverflowError("policy map full")
            self.entries[key] = PolicyEntry(proxy_port=proxy_port)

    def delete(
        self, identity: int, dport: int = 0, proto: int = 0,
        direction: int = DIR_INGRESS,
    ) -> bool:
        """reference: policymap.go:188 DeleteKey."""
        return self.entries.pop(PolicyKey(identity, dport, proto, direction),
                                None) is not None

    def exists(self, identity: int, dport: int = 0, proto: int = 0,
               direction: int = DIR_INGRESS) -> bool:
        return PolicyKey(identity, dport, proto, direction) in self.entries

    def flush(self) -> None:
        self.entries.clear()

    def dump(self) -> list[tuple[PolicyKey, PolicyEntry]]:
        """Sorted dump (reference: policymap.go PolicyEntriesDump.Less:
        direction first, then identity)."""
        return sorted(
            self.entries.items(),
            key=lambda kv: (kv[0].direction, kv[0].identity, kv[0].dest_port),
        )

    def lookup(self, identity: int, dport: int, proto: int,
               direction: int = DIR_INGRESS,
               count_packets: bool = True) -> tuple[bool, int]:
        """Host-side reference cascade; returns (allowed, proxy_port)
        (reference: bpf/lib/policy.h:47).  ``count_packets=False`` makes
        the lookup a pure read (oracle use)."""
        for key in (
            PolicyKey(identity, dport, proto, direction),
            PolicyKey(identity, 0, 0, direction),
            PolicyKey(0, dport, proto, direction),
        ):
            e = self.entries.get(key)
            if e is not None:
                if count_packets:
                    e.packets += 1
                if key.dest_port == 0 and key.identity != 0:
                    return True, 0  # L3-only allow, never a redirect
                return True, e.proxy_port
        return False, 0

    def to_device(self, pad_to: int | None = None, device=None) -> "DevicePolicyMap":
        """The cascade as a DeviceTable on ``device`` (None: the CUDA
        card), keyed (identity, dport, proto, direction)."""
        items = list(self.entries.items())
        n = len(items)
        if pad_to is None:
            # Pad to the next power of two (min 64), as the reference
            # does to reuse its compiled shapes.
            pad_to = 64
            while pad_to < n:
                pad_to *= 2
        keys = np.zeros((n, 4), np.int64)
        vals = np.zeros((n, 1), np.int64)
        for i, (k, e) in enumerate(items):
            keys[i] = (k.identity, k.dest_port, k.proto, k.direction)
            vals[i, 0] = e.proxy_port
        return DevicePolicyMap(
            table=pack_table(keys, vals, pad_to=pad_to, device=device)
        )


@dataclass
class DevicePolicyMap:
    # keys (identity, dport, proto, direction), values [N, >= 1]; its
    # index is the one K13-K15 probe
    table: DeviceTable

    def __post_init__(self):
        if self.table.keys.shape[0] != 4:
            raise ValueError("policy table: expected 4 key columns")
        if self.table.values.shape[1] < 1:
            raise ValueError("policy table: expected a value column (the proxy port)")

    @property
    def device(self) -> torch.device:
        return self.table.device


# --- kernel K13: policy_can_access ---------------------------------------------

_POLICY = kernels.CudaKernel("l34_tables", "policy_can_access", [ctypes.c_void_p])


class PolicyArgs(ctypes.Structure):
    _fields_ = [
        ("t", ExactTab), ("ident", ctypes.c_void_p), ("dport", ctypes.c_void_p),
        ("proto", ctypes.c_void_p), ("dir", ctypes.c_int), ("f", ctypes.c_int),
        ("allowed", ctypes.c_void_p), ("proxy", ctypes.c_void_p), ("ix", HashIx),
    ]


def policy_can_access_plain(dmap: DevicePolicyMap, identities, dports, protos,
                            direction: int = DIR_INGRESS):
    """Plain PyTorch version of K13 ``policy_can_access``
    (``cilium_tpu/maps/policymap.py:191``)."""
    zeros = torch.zeros_like(identities)
    dirs = torch.full_like(identities, direction)
    # Step 1: exact L4 match.
    f1, v1 = exact_lookup_plain(dmap.table, identities, dports, protos, dirs)
    # Step 2: L3-only (dport=0, proto=0) — allow without redirect.
    f2, _ = exact_lookup_plain(dmap.table, identities, zeros, zeros, dirs)
    # Step 3: wildcard identity L4.
    f3, v3 = exact_lookup_plain(dmap.table, zeros, dports, protos, dirs)
    allowed = f1 | f2 | f3
    proxy_port = torch.where(
        f1, v1[:, 0], torch.where(f2, 0, torch.where(f3, v3[:, 0], 0))
    )
    return allowed, proxy_port


def policy_can_access_batch(
    dmap: DevicePolicyMap,
    identities,
    dports,
    protos,
    direction: int = DIR_INGRESS,
):
    """Batched __policy_can_access (reference: bpf/lib/policy.h:47-110).

    Args are [F] int32 numpy arrays, or int32 tensors on the table's
    device.  Returns (allowed [F] bool,
    proxy_port [F] int32) on the table's device; on a CUDA table this is
    K13."""
    device = dmap.device
    identities = kernels.arg(identities, "identities", torch.int32, (None,), device)
    f = identities.shape[0]
    dports = kernels.arg(dports, "dports", torch.int32, (f,), device)
    protos = kernels.arg(protos, "protos", torch.int32, (f,), device)
    if kernels.on_cpu(device):
        return policy_can_access_plain(dmap, identities, dports, protos, direction)
    allowed = torch.empty((f,), dtype=torch.bool, device=device)
    proxy = torch.empty((f,), dtype=torch.int32, device=device)
    if f:
        args = PolicyArgs(dmap.table.abi(), identities.data_ptr(), dports.data_ptr(),
                          protos.data_ptr(), int(direction), f, allowed.data_ptr(),
                          proxy.data_ptr(), dmap.table.index.abi())
        _POLICY.launch(device, ctypes.addressof(args))
    return allowed, proxy
