"""Composed L3/L4 datapath step: LB -> CT -> ipcache -> policy -> verdict.

Counterpart of ``cilium_tpu/datapath/pipeline.py``, the batched analog of
the reference's per-packet egress pipeline (reference:
bpf/bpf_lxc.c:684-760 handle_ipv4_from_lxc).  One pass takes [F] packet
5-tuples and renders, for every packet,

  1. service translation  — lb4 service match + backend select
     (reference: bpf/lib/lb.h:604 lb4_lookup_service, :158 slave pick);
     DNAT daddr/dport to the chosen backend
  2. conntrack lookup     — established 5-tuples (post-DNAT) skip policy
     (reference: bpf/lib/conntrack.h ct_lookup4)
  3. destination identity — ipcache LPM on the (DNATed) daddr, WORLD_ID
     on a miss (reference: bpf/lib/eps.h lookup_ip4_remote_endpoint)
  4. policy               — {identity, dport, proto, EGRESS} cascade
     (reference: bpf/lib/policy.h:47 __policy_can_access)
  5. verdict              — FORWARD / DROP / TO_PROXY, and
     needs_ct_create for allowed new flows (the host applies them).

On the card the whole pass is kernel K14 (``csrc/datapath.cu``): one
thread a packet probes the hashed indexes of the four tables
(``ops/l34_index.py``, each built once, by its table; the probes are
``csrc/l34_index.cuh``), so no intermediate leaves the registers.
The v4 and v6 passes share it (``datapath4`` and ``datapath6``, one body
templated on the address width W); ``datapath_pass_plain`` is its plain PyTorch version, the
composition of K12's and K13's plain versions, as the reference composed
its own functions.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import kernels
from ..device import resolve_device
from ..maps.ctmap import CtKey4, CtMap
from ..maps.ipcache import IpcacheMap
from ..maps.lbmap import LbMap, LbTab, _DeviceLb, lb_select_plain
from ..maps.policymap import DIR_EGRESS, DevicePolicyMap, PolicyMap, policy_can_access_plain
from ..ops.l34_index import HashIndex, HashIx, LpmIndex, LpmIx
from ..ops.lpm import DeviceLpm, LpmTab, lpm_lookup_plain
from ..ops.maplookup import DeviceTable, ExactTab, exact_lookup_plain, pack_table, u32_to_i32, wrap32

# Verdicts (the reference's TC return codes collapse to these three
# outcomes at this layer; DROP carries the policy-denied drop reason,
# reference: bpf/lib/drop.h DROP_POLICY).
FORWARD = 0
DROP = 1
TO_PROXY = 2

WORLD_ID = 2  # reserved world identity (pkg/identity/numericidentity.go)

_M32 = 0xFFFFFFFF


def flow_hash32(saddr, daddr, sport, dport, proto):
    """Deterministic per-flow hash used for backend selection; identical
    arithmetic on host and device so both pick the same backend.  int32
    arithmetic that wraps: numpy int32 operands as the reference computes
    it, or int32 tensors (computed in int64 and wrapped, so no operand is
    promoted and no product overflows)."""
    if isinstance(saddr, torch.Tensor):
        h = (
            ((saddr.to(torch.int64) * -1640531527) & _M32)  # 0x9E3779B9 as int32
            + ((daddr.to(torch.int64) * 40503) & _M32)
            + ((sport.to(torch.int64) * 31) & _M32)
            + ((dport.to(torch.int64) * 131) & _M32)
            + (proto.to(torch.int64) & _M32)
        )
        return wrap32(h)
    h = (
        saddr * np.int32(-1640531527)  # 0x9E3779B9 as int32
        + daddr * np.int32(40503)
        + sport * np.int32(31)
        + dport * np.int32(131)
        + proto
    )
    return h


@dataclass
class DatapathIndex:
    """K14's hashed indexes of one table snapshot (``ops/l34_index.py``):
    the tables' own."""

    lb: HashIndex  # (VIP words, port) -> row id
    ct: HashIndex  # the CT key
    ipcache: LpmIndex
    policy: HashIndex  # (identity, dport, proto, direction) -> the values, or the row id


@dataclass
class DatapathTables:
    """One device-resident snapshot of the maps the pipeline reads, and
    the hashed indexes K14 probes (each table's own, built with the table:
    none is built here)."""

    ct: DeviceTable  # keys (daddr, saddr, dport, sport, proto)
    lb: _DeviceLb
    ipcache: DeviceLpm
    policy: DevicePolicyMap
    index: DatapathIndex = field(init=False, repr=False)

    def __post_init__(self):
        w = self.lb.w
        if self.ipcache.w != w or self.ct.keys.shape[0] != 2 * w + 3:
            raise ValueError(f"tables: expected a {w}-word ipcache and a {2 * w + 3}-column CT table")
        device = self.device
        for name in ("lb", "ipcache", "policy"):
            if getattr(self, name).device != device:
                raise ValueError(f"tables: {name} is not on {device}")
        self.index = DatapathIndex(lb=self.lb.index, ct=self.ct.index, ipcache=self.ipcache.index,
                                   policy=self.policy.table.index)

    @property
    def device(self) -> torch.device:
        return self.ct.device

    @property
    def w(self) -> int:
        return self.lb.w


def pack_ct(ct: CtMap, device=None) -> DeviceTable:
    """Snapshot live CT entries into a device exact-match table.

    Expired-but-not-yet-GCed entries must NOT reach the device table:
    ct_lookup4 treats them as misses (conntrack.h lifetime check), so
    the snapshot filters on lifetime like CtMap.lookup does."""
    now = int(ct.clock())
    live = [
        k for k, e in ct.entries.items()
        if e.lifetime >= now and isinstance(k, CtKey4)
    ]
    keys = np.zeros((len(live), 5), np.int64)
    for i, k in enumerate(live):
        keys[i] = (k.daddr, k.saddr, k.dport, k.sport, k.nexthdr)
    keys = u32_to_i32(keys)
    vals = np.zeros((len(live), 1), np.int64)
    return pack_table(keys, vals, device=device)


def build_tables(
    ct: CtMap, lb: LbMap, ipcache: IpcacheMap, policy: PolicyMap, device=None
) -> DatapathTables:
    """Snapshot host maps into tables on ``device`` (None: the CUDA card),
    the analog of the pinned BPF maps the kernel programs read."""
    device = resolve_device(device)
    return DatapathTables(
        ct=pack_ct(ct, device),
        lb=lb.to_device(device=device),
        ipcache=ipcache.to_device(device=device),
        policy=policy.to_device(device=device),
    )


# --- kernel K14: the composed pass ---------------------------------------------

_DATAPATH = {
    1: kernels.CudaKernel("datapath", "datapath4", [ctypes.c_void_p]),
    4: kernels.CudaKernel("datapath", "datapath6", [ctypes.c_void_p]),
}


class DpArgs(ctypes.Structure):
    """``struct DpArgs`` of ``csrc/datapath.cu``."""

    _fields_ = [
        ("lb", LbTab), ("ct", ExactTab), ("ipc", LpmTab), ("pol", ExactTab),
        ("saddr", ctypes.c_void_p * 4), ("daddr", ctypes.c_void_p * 4),
        ("sport", ctypes.c_void_p), ("dport", ctypes.c_void_p), ("proto", ctypes.c_void_p),
        ("f", ctypes.c_int), ("out", ctypes.c_void_p), ("flags", ctypes.c_void_p),
        ("lb_ix", HashIx), ("ct_ix", HashIx), ("ipc_ix", LpmIx), ("pol_ix", HashIx),
    ]


def _split(out: torch.Tensor, flags: torch.Tensor, w: int) -> dict:
    """The pass's output dict from its [W + 6, F] int32 and [2, F] bool
    blocks (rows in the order the kernel writes them)."""
    return {
        "verdict": out[0],
        "new_daddr_words": tuple(out[1:1 + w]),
        "new_dport": out[w + 1],
        "dst_identity": out[w + 2],
        "proxy_port": out[w + 3],
        "rev_nat": out[w + 4],
        "tunnel_endpoint": out[w + 5],
        "established": flags[0],
        "needs_ct_create": flags[1],
    }


def datapath_pass_plain(tables: DatapathTables, saddr_w, daddr_w, sport, dport, proto) -> dict:
    """Plain PyTorch version of K14 for W = 1 (``cilium_tpu/datapath/
    pipeline.py:125``) and W = 4 (``pipeline6.py:92``)."""
    w = tables.w
    if w == 1:
        fh = flow_hash32(saddr_w[0], daddr_w[0], sport, dport, proto)
    else:
        fh = flow_hash32_v6(saddr_w, daddr_w, sport, dport, proto)
    # 1. service translation
    svc_found, be_words, be_port, rev_nat = lb_select_plain(tables.lb, daddr_w, dport, fh)
    new_daddr_w = tuple(torch.where(svc_found, be_words[i], daddr_w[i]) for i in range(w))
    new_dport = torch.where(svc_found, be_port, dport)
    # 2. conntrack on the post-DNAT tuple
    est, _ = exact_lookup_plain(tables.ct, *new_daddr_w, *saddr_w, new_dport, sport, proto)
    # 3. destination identity; unknown -> world
    ip_found, ident, _ = lpm_lookup_plain(tables.ipcache, *new_daddr_w)
    dst_id = torch.where(ip_found, ident, WORLD_ID)
    # 4. policy cascade on new connections
    allowed, proxy_port = policy_can_access_plain(
        tables.policy, dst_id, new_dport, proto, DIR_EGRESS
    )
    pass_ok = est | allowed
    verdict = torch.where(
        pass_ok,
        torch.where((proxy_port > 0) & ~est, TO_PROXY, FORWARD),
        DROP,
    ).to(torch.int32)
    zero = torch.zeros_like(dst_id)
    return {
        "verdict": verdict,
        "new_daddr_words": new_daddr_w,
        "new_dport": new_dport,
        "dst_identity": dst_id,
        "proxy_port": torch.where(est, zero, proxy_port),
        "rev_nat": torch.where(svc_found, rev_nat, zero),
        # Encap selection lives in the node-ingress programs.
        "tunnel_endpoint": zero,
        "established": est,
        "needs_ct_create": pass_ok & ~est,
    }


def datapath_pass(tables: DatapathTables, saddr_w, daddr_w, sport, dport, proto) -> dict:
    """K14: the composed pass over W-word addresses (W = 1 or 4, the
    tables' width); inputs are [F] int32 numpy arrays or int32 tensors on
    the tables' device, outputs [F] tensors there (``new_daddr_words`` a
    W-tuple)."""
    device = tables.device
    w = tables.w
    if len(saddr_w) != w or len(daddr_w) != w:
        raise ValueError(f"expected {w} address word arrays per address")
    f = len(sport)
    sw = [kernels.arg(a, f"saddr_w[{i}]", torch.int32, (f,), device) for i, a in enumerate(saddr_w)]
    dw = [kernels.arg(a, f"daddr_w[{i}]", torch.int32, (f,), device) for i, a in enumerate(daddr_w)]
    rest = [kernels.arg(a, name, torch.int32, (f,), device)
            for name, a in (("sport", sport), ("dport", dport), ("proto", proto))]
    if kernels.on_cpu(device):
        return datapath_pass_plain(tables, sw, dw, *rest)
    ix = tables.index
    out = torch.empty((w + 6, f), dtype=torch.int32, device=device)
    flags = torch.empty((2, f), dtype=torch.bool, device=device)
    if f:
        arr = ctypes.c_void_p * 4
        args = DpArgs(
            tables.lb.abi(), tables.ct.abi(), tables.ipcache.abi(), tables.policy.table.abi(),
            arr(*[t.data_ptr() for t in sw]), arr(*[t.data_ptr() for t in dw]),
            *[t.data_ptr() for t in rest], f, out.data_ptr(), flags.data_ptr(),
            ix.lb.abi(), ix.ct.abi(), ix.ipcache.abi(), ix.policy.abi(),
        )
        _DATAPATH[w].launch(device, ctypes.addressof(args))
    return _split(out, flags, w)


def datapath_verdicts(
    tables: DatapathTables,
    saddr,  # [F] int32 (uint32 bit pattern)
    daddr,  # [F] int32
    sport,  # [F] int32
    dport,  # [F] int32
    proto,  # [F] int32
) -> dict:
    """One composed v4 pass; returns a dict of [F] tensors on the tables'
    device:

    verdict (FORWARD/DROP/TO_PROXY), new_daddr, new_dport (post-DNAT),
    dst_identity, proxy_port, rev_nat, tunnel_endpoint, established,
    needs_ct_create (allowed new flows the host should ct_create4).
    """
    if tables.w != 1:
        raise ValueError("datapath_verdicts takes v4 tables (datapath_verdicts6 the v6 ones)")
    out = datapath_pass(tables, (saddr,), (daddr,), sport, dport, proto)
    new = {"verdict": out.pop("verdict"), "new_daddr": out.pop("new_daddr_words")[0]}
    new.update(out)
    return new


def host_arrays(out: dict) -> dict:
    """numpy copies of an output dict's values; its tensors come back with
    ONE device-to-host copy (tuples stay tuples, bool stays bool)."""
    tensors = [t for v in out.values() for t in (v if isinstance(v, tuple) else (v,))
               if isinstance(t, torch.Tensor)]
    block = iter(torch.stack([t.to(torch.int32) for t in tensors]).cpu().numpy()
                 if tensors else ())

    def host(t):
        if not isinstance(t, torch.Tensor):
            return np.asarray(t)
        row = next(block)
        return row.astype(bool) if t.dtype == torch.bool else row

    return {k: tuple(host(t) for t in v) if isinstance(v, tuple) else host(v)
            for k, v in out.items()}


def as_numpy(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def apply_ct_creates(ct: CtMap, out: dict, saddr, sport, proto) -> int:
    """Host-side follow-up: create CT entries for allowed new flows
    (reference: conntrack.h ct_create4 after the policy verdict).
    Returns the number of entries created."""
    out = host_arrays(out)
    need = out["needs_ct_create"]
    nd = out["new_daddr"].view(np.uint32)
    np_ = out["new_dport"]
    ids = out["dst_identity"]
    rev = out["rev_nat"]
    sa = as_numpy(saddr).astype(np.int32).view(np.uint32)
    sp = as_numpy(sport)
    pr = as_numpy(proto)
    created = 0
    for i in np.flatnonzero(need):
        ct.create(
            CtKey4(
                daddr=int(nd[i]),
                saddr=int(sa[i]),
                dport=int(np_[i]),
                sport=int(sp[i]),
                nexthdr=int(pr[i]),
            ),
            src_sec_id=int(ids[i]),
            rev_nat_index=int(rev[i]),
        )
        created += 1
    return created


def host_oracle(
    ct: CtMap,
    lb: LbMap,
    ipcache: IpcacheMap,
    policy: PolicyMap,
    saddr: int,
    daddr: int,
    sport: int,
    dport: int,
    proto: int,
) -> dict:
    """Reference-semantics host walk of the same pipeline (the fuzz
    oracle; pure read — no CT refresh / counters)."""
    import ipaddress

    def i32(v: int) -> np.int32:
        return u32_to_i32(v).astype(np.int32)

    with np.errstate(over="ignore"):
        fh = int(
            flow_hash32(i32(saddr), i32(daddr), i32(sport), i32(dport),
                        i32(proto))
        )
    be = lb.select_backend(daddr & 0xFFFFFFFF, dport, fh)
    svc_found = be is not None
    new_daddr = be.target if svc_found else daddr & 0xFFFFFFFF
    new_dport = be.port if svc_found else dport
    rev = 0
    if svc_found:
        master = lb.lookup_service(daddr & 0xFFFFFFFF, dport)
        rev = master.rev_nat_index if master else 0

    key = CtKey4(
        daddr=new_daddr, saddr=saddr & 0xFFFFFFFF, dport=new_dport,
        sport=sport, nexthdr=proto,
    )
    entry = ct.entries.get(key)
    est = entry is not None and entry.lifetime >= int(ct.clock())

    info = ipcache.lookup(str(ipaddress.IPv4Address(new_daddr)))
    dst_id = info.sec_label if info is not None else WORLD_ID

    allowed, proxy_port = policy.lookup(
        dst_id, new_dport, proto, direction=DIR_EGRESS, count_packets=False
    )
    pass_ok = est or allowed
    if not pass_ok:
        verdict = DROP
    elif proxy_port > 0 and not est:
        verdict = TO_PROXY
    else:
        verdict = FORWARD
    return {
        "verdict": verdict,
        "new_daddr": new_daddr,
        "new_dport": new_dport,
        "dst_identity": dst_id,
        "proxy_port": 0 if est else proxy_port,
        "rev_nat": rev if svc_found else 0,
        "established": est,
        "needs_ct_create": pass_ok and not est,
    }


def flow_hash32_v6(saddr_w, daddr_w, sport, dport, proto):
    """v6 flow hash: fold the word lanes into the v4 hash shape so host
    and device agree (any fixed function works; see flow_hash32).  The
    folds wrap in int32 like the hash."""
    s = saddr_w[0]
    d = daddr_w[0]
    for w in range(1, 4):
        if isinstance(s, torch.Tensor):
            s = s ^ wrap32(saddr_w[w].to(torch.int64) * 31)
            d = d ^ wrap32(daddr_w[w].to(torch.int64) * 131)
        else:
            s = s ^ (saddr_w[w] * np.int32(31))
            d = d ^ (daddr_w[w] * np.int32(131))
    return flow_hash32(s, d, sport, dport, proto)
