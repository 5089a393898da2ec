"""Load-balancer service/backend maps and batched backend selection.

reference: bpf/lib/lb.h (lb4_lookup_service :604, lb4_lookup_slave :637,
lb4_select_slave :158 — hash-based slave pick) and pkg/maps/lbmap (service
+ RevNAT bookkeeping).  Services are keyed {vip, dport, slave}; slave 0 is
the master entry holding the backend count; slaves 1..count are backends.
Backend selection for F flows is one device pass: hash the flow 5-tuple,
``slave = hash % count + 1``, gather the backend.

Counterpart of ``cilium_tpu/maps/lbmap.py``: the host map is a copy; the
v4 and v6 device maps share one layout (VIP and backend addresses as W
int32 words, W = 1 or 4), and on the card both selectors are kernel
K13's ``lb_select`` launcher (``csrc/l34_tables.cu``), which finds the
service through the hashed index every device table builds when it is
made (``ops/l34_index.py`` ``lb_index``).  The pick follows
the reference to the bit: the first service row whose VIP and port match
(L4 before the wildcard port 0), ``uint32(hash) % uint32(max(count, 1))``,
the backend index clamped into the table as the reference's gather
clamps it, and row 0 gathered and the result masked to 0 when no
service matches.
"""

from __future__ import annotations

import ctypes
import struct
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import kernels
from ..device import as_tensor, resolve_device
from ..ops.l34_index import HashIndex, HashIx, lb_index
from ..ops.maplookup import chunk_rows, u32_to_i32
from .ctmap import CtKey6

# Packed layouts (reference: bpf/lib/common.h:427-445).
_LB4_KEY_FMT = "<IHH"  # address, dport, slave
_LB4_SERVICE_FMT = "<IHHHH"  # target, port, count, rev_nat_index, weight
LB4_KEY_SIZE = struct.calcsize(_LB4_KEY_FMT)  # 8
LB4_SERVICE_SIZE = struct.calcsize(_LB4_SERVICE_FMT)  # 12


@dataclass(frozen=True)
class LbKey:
    address: int
    dport: int = 0
    slave: int = 0

    def pack(self) -> bytes:
        return struct.pack(_LB4_KEY_FMT, self.address, self.dport, self.slave)


@dataclass
class LbBackend:
    """lb4_service value (reference: common.h:433)."""

    target: int = 0  # backend IPv4 (or 0 in the master entry)
    port: int = 0
    count: int = 0  # only meaningful in the master entry
    rev_nat_index: int = 0
    weight: int = 0

    def pack(self) -> bytes:
        return struct.pack(
            _LB4_SERVICE_FMT, self.target, self.port, self.count,
            self.rev_nat_index, self.weight,
        )


class LbMap:
    """Host service table (reference: pkg/maps/lbmap)."""

    def __init__(self) -> None:
        # v4 and v6 services live in separate tables with separate
        # RevNAT registries, mirroring the reference's distinct
        # cilium_lb4_/cilium_lb6_ maps (bpf/lib/maps.h) — a numeric vip
        # alone cannot identify the family (::1 == 1).
        self.services: dict[LbKey, LbBackend] = {}
        self.revnat: dict[int, tuple[int, int]] = {}  # index -> (vip, port)
        self.services6: dict[LbKey, LbBackend] = {}
        self.revnat6: dict[int, tuple[int, int]] = {}

    @staticmethod
    def _upsert(services, revnat, vip, dport, backends, rev_nat_index):
        # Remove old slaves beyond the new count, and the old RevNAT entry
        # if the service's rev_nat_index changed.
        old = services.get(LbKey(vip, dport, 0))
        if old is not None:
            for s in range(len(backends) + 1, old.count + 1):
                services.pop(LbKey(vip, dport, s), None)
            if old.rev_nat_index and old.rev_nat_index != rev_nat_index:
                revnat.pop(old.rev_nat_index, None)
        services[LbKey(vip, dport, 0)] = LbBackend(
            count=len(backends), rev_nat_index=rev_nat_index
        )
        for i, (target, port) in enumerate(backends, start=1):
            services[LbKey(vip, dport, i)] = LbBackend(
                target=target, port=port, rev_nat_index=rev_nat_index
            )
        if rev_nat_index:
            revnat[rev_nat_index] = (vip, dport)

    def upsert_service(
        self, vip: int, dport: int, backends: list[tuple[int, int]],
        rev_nat_index: int = 0,
    ) -> None:
        """Install a v4 service with its backends; master entry at slave
        0, backends at slaves 1..n (reference: lbmap service layout)."""
        self._upsert(self.services, self.revnat, vip, dport, backends,
                     rev_nat_index)

    def upsert_service6(
        self, vip: int, dport: int, backends: list[tuple[int, int]],
        rev_nat_index: int = 0,
    ) -> None:
        """v6 twin (reference: cilium_lb6_services)."""
        self._upsert(self.services6, self.revnat6, vip, dport, backends,
                     rev_nat_index)

    @staticmethod
    def _delete(services, revnat, vip, dport) -> bool:
        master = services.pop(LbKey(vip, dport, 0), None)
        if master is None:
            return False
        for s in range(1, master.count + 1):
            services.pop(LbKey(vip, dport, s), None)
        if master.rev_nat_index:
            revnat.pop(master.rev_nat_index, None)
        return True

    def delete_service(self, vip: int, dport: int) -> bool:
        return self._delete(self.services, self.revnat, vip, dport)

    def delete_service6(self, vip: int, dport: int) -> bool:
        return self._delete(self.services6, self.revnat6, vip, dport)

    @staticmethod
    def _lookup(services, vip, dport) -> LbBackend | None:
        if dport:
            svc = services.get(LbKey(vip, dport, 0))
            if svc is not None and svc.count:
                return svc
        svc = services.get(LbKey(vip, 0, 0))
        if svc is not None and svc.count:
            return svc
        return None

    def lookup_service(self, vip: int, dport: int) -> LbBackend | None:
        """L4 first, then L3 wildcard-port (reference: lb.h:604-630)."""
        return self._lookup(self.services, vip, dport)

    def lookup_service6(self, vip: int, dport: int) -> LbBackend | None:
        return self._lookup(self.services6, vip, dport)

    @staticmethod
    def _select(services, vip, dport, flow_hash):
        key_port = dport
        svc = services.get(LbKey(vip, dport, 0)) if dport else None
        if svc is None or not svc.count:
            key_port = 0
            svc = services.get(LbKey(vip, 0, 0))
        if svc is None or not svc.count:
            return None
        slave = ((flow_hash & 0xFFFFFFFF) % svc.count) + 1
        return services.get(LbKey(vip, key_port, slave))

    def select_backend(self, vip: int, dport: int, flow_hash: int):
        """Host-side backend pick (reference: lb.h lb4_select_slave +
        lb4_lookup_slave): slave = hash % count + 1.  The hash is treated
        as a uint32 bit pattern so host and device picks agree."""
        return self._select(self.services, vip, dport, flow_hash)

    def select_backend6(self, vip: int, dport: int, flow_hash: int):
        return self._select(self.services6, vip, dport, flow_hash)

    def dump(self):
        return sorted(
            self.services.items(),
            key=lambda kv: (kv[0].address, kv[0].dport, kv[0].slave),
        )

    @staticmethod
    def _export(services, words, n_words, max_backends):
        masters = [
            (k, v) for k, v in services.items() if k.slave == 0 and v.count
        ]
        widest = max((v.count for _, v in masters), default=1)
        if max_backends is None:
            max_backends = widest
        elif max_backends < widest:
            raise ValueError(
                f"max_backends {max_backends} < widest service {widest}"
            )
        s = max(len(masters), 1)
        vip_w = np.zeros((n_words, s), np.int64)
        ports = np.zeros((s,), np.int64)
        counts = np.zeros((s,), np.int32)
        revnat = np.zeros((s,), np.int32)
        bt_w = np.zeros((n_words, s, max_backends), np.int64)
        b_port = np.zeros((s, max_backends), np.int32)
        valid = np.zeros((s,), bool)
        for i, (k, master) in enumerate(masters):
            vip_w[:, i] = words(k.address)
            ports[i] = k.dport
            counts[i] = min(master.count, max_backends)
            revnat[i] = master.rev_nat_index
            valid[i] = True
            for b in range(counts[i]):
                be = services.get(LbKey(k.address, k.dport, b + 1))
                if be is not None:
                    bt_w[:, i, b] = words(be.target)
                    b_port[i, b] = be.port
        return (u32_to_i32(vip_w), ports.astype(np.int32), counts, revnat,
                u32_to_i32(bt_w), b_port, valid)

    def to_device(self, max_backends: int | None = None, device=None) -> "DeviceLbMap":
        """Export as dense [S, max_backends] backend arrays per service on
        ``device`` (None: the CUDA card).  max_backends defaults to the
        widest service so no backend is ever silently dropped; an explicit
        value smaller than that is an error."""
        vips, ports, counts, revnat, bt, b_port, valid = self._export(
            self.services, lambda a: (a,), 1, max_backends
        )
        return DeviceLbMap.from_arrays(vips[0], ports, counts, revnat, bt[0], b_port,
                                       valid, device)

    def to_device6(self, max_backends: int | None = None, device=None) -> "DeviceLb6Map":
        """v6 export: vips/backends as four 32-bit word columns (same
        word order as ops/lpm.ipv6_to_words); reference: bpf/lib/lb.h
        lb6_lookup_service/lb6_select_slave — the v6 twins of the v4
        path with wider keys."""
        vips, ports, counts, revnat, bt, b_port, valid = self._export(
            self.services6, CtKey6.words, 4, max_backends
        )
        return DeviceLb6Map.from_arrays(vips, ports, counts, revnat, bt, b_port,
                                        valid, device)


class LbTab(ctypes.Structure):
    """``struct LbTab`` of ``csrc/l34.cuh``."""

    _fields_ = [
        ("vips", ctypes.c_void_p), ("ports", ctypes.c_void_p),
        ("counts", ctypes.c_void_p), ("revnat", ctypes.c_void_p),
        ("b_target", ctypes.c_void_p), ("b_port", ctypes.c_void_p),
        ("valid", ctypes.c_void_p), ("s", ctypes.c_int), ("b", ctypes.c_int),
        ("w", ctypes.c_int),
    ]


@dataclass
class _DeviceLb:
    """Service table on one device: ``vip_words`` [W, S] and
    ``b_target_words`` [W, S, B] int32 address words, ``ports``,
    ``counts``, ``revnat`` [S] int32, ``b_port`` [S, B] int32 and
    ``valid`` [S] bool; ``index``, the hashed (VIP words, port) index
    K13 and K14 probe, is built here, so every constructor has it."""

    vip_words: torch.Tensor
    ports: torch.Tensor
    counts: torch.Tensor
    revnat: torch.Tensor
    b_target_words: torch.Tensor
    b_port: torch.Tensor
    valid: torch.Tensor
    index: HashIndex = field(init=False, repr=False, compare=False)

    def __post_init__(self):
        device = self.device
        kernels.check(self.vip_words, "vip_words", torch.int32, (None, None), device)
        w, s = self.vip_words.shape
        if w not in (1, 4) or s < 1:
            raise ValueError(f"vip_words: expected [1 or 4, S >= 1], got {tuple(self.vip_words.shape)}")
        for name in ("ports", "counts", "revnat"):
            kernels.check(getattr(self, name), name, torch.int32, (s,), device)
        kernels.check(self.b_port, "b_port", torch.int32, (s, None), device)
        b = self.b_port.shape[1]
        if b < 1:
            raise ValueError("b_port: expected at least one backend column")
        kernels.check(self.b_target_words, "b_target_words", torch.int32, (w, s, b), device)
        kernels.check(self.valid, "valid", torch.bool, (s,), device)
        self.index = lb_index(self)

    @classmethod
    def from_arrays(cls, vips, ports, counts, revnat, b_target, b_port, valid, device=None):
        """From the reference's device map leaves, as numpy arrays."""
        device = resolve_device(device)
        w = 1 if cls is DeviceLbMap else 4
        s = np.shape(ports)[0]
        return cls(
            vip_words=as_tensor(np.reshape(vips, (w, s)), torch.int32, device),
            ports=as_tensor(ports, torch.int32, device),
            counts=as_tensor(counts, torch.int32, device),
            revnat=as_tensor(revnat, torch.int32, device),
            b_target_words=as_tensor(np.reshape(b_target, (w, s, -1)), torch.int32, device),
            b_port=as_tensor(b_port, torch.int32, device),
            valid=as_tensor(valid, torch.bool, device),
        )

    @property
    def device(self) -> torch.device:
        return self.ports.device

    @property
    def w(self) -> int:
        return self.vip_words.shape[0]

    def abi(self) -> LbTab:
        p = kernels.p
        s, b = self.b_port.shape
        return LbTab(p(self.vip_words), p(self.ports), p(self.counts), p(self.revnat),
                     p(self.b_target_words), p(self.b_port), p(self.valid), s, b, self.w)


class DeviceLbMap(_DeviceLb):
    """The v4 service table (W = 1); ``vips`` [S] and ``b_target`` [S, B]
    are the reference's names for its one word."""

    @property
    def vips(self) -> torch.Tensor:
        return self.vip_words[0]

    @property
    def b_target(self) -> torch.Tensor:
        return self.b_target_words[0]


class DeviceLb6Map(_DeviceLb):
    """The v6 service table (W = 4)."""


# --- kernel K13: lb_select ----------------------------------------------------

_LB = kernels.CudaKernel("l34_tables", "lb_select", [ctypes.c_void_p])


class LbArgs(ctypes.Structure):
    _fields_ = [
        ("t", LbTab), ("vip", ctypes.c_void_p * 4), ("dport", ctypes.c_void_p),
        ("hash", ctypes.c_void_p), ("f", ctypes.c_int), ("found", ctypes.c_void_p),
        ("target", ctypes.c_void_p * 4), ("port", ctypes.c_void_p), ("rev", ctypes.c_void_p),
        ("ix", HashIx),
    ]


def _first_service(dlb: _DeviceLb, vw, port_query, lo, hi):
    m = dlb.valid[None, :] & (dlb.ports[None, :] == port_query[lo:hi, None])
    for w in range(dlb.w):
        m = m & (dlb.vip_words[w][None, :] == vw[w][lo:hi, None])
    return m.any(dim=1), torch.argmax(m.to(torch.int32), dim=1)


def lb_select_plain(dlb: _DeviceLb, vip_words, dports, flow_hashes):
    """Plain PyTorch version of K13 ``lb_select``
    (``cilium_tpu/maps/lbmap.py:284`` for W = 1, ``:352`` for W = 4):
    (found [F] bool, W target word [F] int32 tensors, port, rev_nat)."""
    f = dports.shape[0]
    device = dlb.device
    found = torch.zeros((f,), dtype=torch.bool, device=device)
    idx = torch.zeros((f,), dtype=torch.int64, device=device)
    zeros = torch.zeros_like(dports)
    step = chunk_rows(dlb.valid.shape[0])
    for lo in range(0, f, step):
        hi = min(f, lo + step)
        f_l4, i_l4 = _first_service(dlb, vip_words, dports, lo, hi)
        f_l3, i_l3 = _first_service(dlb, vip_words, zeros, lo, hi)
        found[lo:hi] = f_l4 | f_l3
        idx[lo:hi] = torch.where(f_l4, i_l4, i_l3)
    count = dlb.counts[idx].to(torch.int64).clamp(min=1)
    # uint32(hash) % uint32(count); the reference's gather clamps the index
    slave = ((flow_hashes.to(torch.int64) & 0xFFFFFFFF) % count).clamp(max=dlb.b_port.shape[1] - 1)
    zero = torch.zeros((), dtype=torch.int32, device=device)
    target = tuple(torch.where(found, dlb.b_target_words[w][idx, slave], zero)
                   for w in range(dlb.w))
    port = torch.where(found, dlb.b_port[idx, slave], zero)
    rev = torch.where(found, dlb.revnat[idx], zero)
    return found, target, port, rev


def lb_select(dlb: _DeviceLb, vip_words, dports, flow_hashes):
    """K13 ``lb_select``: service lookup and backend pick for F flows; on
    a CPU table the plain version runs."""
    device = dlb.device
    if len(vip_words) != dlb.w:
        raise ValueError(f"expected {dlb.w} VIP word arrays, got {len(vip_words)}")
    v0 = kernels.arg(vip_words[0], "vip_words[0]", torch.int32, (None,), device)
    f = v0.shape[0]
    vw = [v0] + [kernels.arg(v, f"vip_words[{i}]", torch.int32, (f,), device)
                 for i, v in enumerate(vip_words[1:], 1)]
    dports = kernels.arg(dports, "dports", torch.int32, (f,), device)
    flow_hashes = kernels.arg(flow_hashes, "flow_hashes", torch.int32, (f,), device)
    if kernels.on_cpu(device):
        return lb_select_plain(dlb, vw, dports, flow_hashes)
    found = torch.empty((f,), dtype=torch.bool, device=device)
    out = torch.empty((dlb.w + 2, f), dtype=torch.int32, device=device)
    if f:
        vip = (ctypes.c_void_p * 4)(*[v.data_ptr() for v in vw])
        target = (ctypes.c_void_p * 4)(*[out[w].data_ptr() for w in range(dlb.w)])
        args = LbArgs(dlb.abi(), vip, dports.data_ptr(), flow_hashes.data_ptr(), f,
                      found.data_ptr(), target, out[dlb.w].data_ptr(), out[dlb.w + 1].data_ptr(),
                      dlb.index.abi())
        _LB.launch(device, ctypes.addressof(args))
    return found, tuple(out[:dlb.w]), out[dlb.w], out[dlb.w + 1]


def lb4_select_backend_batch(dlb: DeviceLbMap, vips, dports, flow_hashes):
    """Batched service lookup + backend selection.

    Args: [F] int32 arrays (vips as uint32 bit patterns).
    Returns (found [F] bool, target [F] int32, port [F] int32,
    rev_nat_index [F] int32).
    reference: bpf/lib/lb.h:604 (L4 then wildcard-port), :158 (hash pick).
    """
    found, target, port, rev = lb_select(dlb, (vips,), dports, flow_hashes)
    return found, target[0], port, rev


def lb6_select_backend_batch(dlb: DeviceLb6Map, vip_words, dports, flow_hashes):
    """v6 batched service lookup + backend selection: vip_words is a
    4-tuple of [F] int32 word arrays.  Returns (found, target_words
    4-tuple, port, rev_nat_index) — the v6 twin of
    lb4_select_backend_batch (reference: bpf/lib/lb.h lb6_*)."""
    return lb_select(dlb, tuple(vip_words), dports, flow_hashes)
