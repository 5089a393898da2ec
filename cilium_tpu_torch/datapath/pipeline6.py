"""Composed IPv6 L3/L4 datapath step — the v6 twin of pipeline.py.

Counterpart of ``cilium_tpu/datapath/pipeline6.py``, the batched analog of
the reference's per-packet IPv6 egress pipeline (reference:
bpf/bpf_lxc.c:418 tail_handle_ipv6 → handle_ipv6_from_lxc): the same five
stages as the v4 pass — lb6 service translation, v6 conntrack, v6
ipcache LPM identity, policy cascade, verdict — with every address
carried as FOUR int32 word lanes (the word order of
ops/lpm.ipv6_to_words).  On the card it is kernel K14's ``datapath6``
launcher, the v4 body at W = 4.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..device import resolve_device
from ..maps.ctmap import CtKey6, CtMap
from ..maps.ipcache import IpcacheMap
from ..maps.lbmap import LbMap
from ..maps.policymap import DIR_EGRESS, PolicyMap
from ..ops.maplookup import DeviceTable, pack_table, u32_to_i32
from .pipeline import (
    DROP,
    FORWARD,
    TO_PROXY,
    WORLD_ID,
    DatapathTables,
    as_numpy,
    datapath_pass,
    flow_hash32_v6,
    host_arrays,
)

__all__ = [
    "DROP", "FORWARD", "TO_PROXY", "WORLD_ID", "DatapathTables6", "apply_ct_creates6",
    "build_tables6", "datapath_verdicts6", "flow_hash32_v6", "host_oracle6", "pack_ct6",
]


@dataclass
class DatapathTables6(DatapathTables):
    """Device snapshot of the v6 maps: an 11-column CT table (d0..d3,
    s0..s3, dport, sport, proto), a ``DeviceLb6Map``, a 4-word ipcache
    LPM and the policy map."""


def pack_ct6(ct: CtMap, device=None) -> DeviceTable:
    """Snapshot live v6 CT entries (CtKey6) into an 11-column device
    exact-match table; expired entries are filtered like pack_ct."""
    now = int(ct.clock())
    live = [
        k for k, e in ct.entries.items()
        if e.lifetime >= now and isinstance(k, CtKey6)
    ]
    keys = np.zeros((len(live), 11), np.int64)
    for i, k in enumerate(live):
        keys[i, 0:4] = CtKey6.words(k.daddr)
        keys[i, 4:8] = CtKey6.words(k.saddr)
        keys[i, 8:11] = (k.dport, k.sport, k.nexthdr)
    vals = np.zeros((len(live), 1), np.int64)
    return pack_table(u32_to_i32(keys), vals, device=device)


def build_tables6(
    ct: CtMap, lb: LbMap, ipcache: IpcacheMap, policy: PolicyMap, device=None
) -> DatapathTables6:
    """The v6 tables on ``device`` (None: the CUDA card)."""
    device = resolve_device(device)
    return DatapathTables6(
        ct=pack_ct6(ct, device),
        lb=lb.to_device6(device=device),
        ipcache=ipcache.to_device(v6=True, device=device),
        policy=policy.to_device(device=device),
    )


def datapath_verdicts6(
    tables: DatapathTables6,
    saddr_w,  # 4-tuple of [F] int32 word arrays
    daddr_w,  # 4-tuple of [F] int32
    sport,
    dport,
    proto,
) -> dict:
    """One composed v6 pass; mirrors datapath_verdicts' output dict with
    new_daddr_words (a 4-tuple of [F] tensors) instead of new_daddr."""
    if tables.w != 4:
        raise ValueError("datapath_verdicts6 takes v6 tables")
    return datapath_pass(tables, tuple(saddr_w), tuple(daddr_w), sport, dport, proto)


def apply_ct_creates6(ct: CtMap, out: dict, saddr_w, sport, proto) -> int:
    """Host-side follow-up for allowed new v6 flows (the v4 twin is
    pipeline.apply_ct_creates).  saddr_w is the 4-tuple of source word
    arrays the pipeline was called with.  Returns entries created."""
    out = host_arrays(out)
    need = out["needs_ct_create"]
    ndw = [w.view(np.uint32) for w in out["new_daddr_words"]]
    saw = [as_numpy(w).astype(np.int32).view(np.uint32) for w in saddr_w]
    np_ = out["new_dport"]
    ids = out["dst_identity"]
    rev = out["rev_nat"]
    sp = as_numpy(sport)
    pr = as_numpy(proto)

    def join(ws, i):
        addr = 0
        for w in range(4):
            addr = (addr << 32) | int(ws[w][i])
        return addr

    created = 0
    for i in np.flatnonzero(need):
        ct.create(
            CtKey6(
                daddr=join(ndw, i),
                saddr=join(saw, i),
                dport=int(np_[i]),
                sport=int(sp[i]),
                nexthdr=int(pr[i]),
            ),
            src_sec_id=int(ids[i]),
            rev_nat_index=int(rev[i]),
        )
        created += 1
    return created


def host_oracle6(
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
    """Reference-semantics host walk (the v6 fuzz oracle)."""
    import ipaddress

    def i32w(addr: int):
        return tuple(
            np.int32(u32_to_i32(w)) for w in CtKey6.words(addr)
        )

    with np.errstate(over="ignore"):
        fh = int(
            flow_hash32_v6(
                i32w(saddr), i32w(daddr), np.int32(sport), np.int32(dport),
                np.int32(proto),
            )
        )
    be = lb.select_backend6(daddr, dport, fh)
    svc_found = be is not None
    new_daddr = be.target if svc_found else daddr
    new_dport = be.port if svc_found else dport
    rev = 0
    if svc_found:
        master = lb.lookup_service6(daddr, dport)
        rev = master.rev_nat_index if master else 0

    key = CtKey6(
        daddr=new_daddr, saddr=saddr, dport=new_dport, sport=sport,
        nexthdr=proto,
    )
    entry = ct.entries.get(key)
    est = entry is not None and entry.lifetime >= int(ct.clock())

    info = ipcache.lookup(str(ipaddress.IPv6Address(new_daddr)))
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
