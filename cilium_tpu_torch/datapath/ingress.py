"""Node-ingress datapath programs: netdev and overlay.

Counterpart of ``cilium_tpu/datapath/ingress.py``, the batched analogs of
the reference's physical-device and tunnel-device tc programs:

- ``netdev_verdicts`` (reference: bpf/bpf_netdev.c:352 handle_ipv4):
  packets arriving from the world.  Source identity is derived from the
  ipcache LPM when the caller's identity is reserved (the HOST_ID
  override nuance included), destinations are demuxed against the local
  endpoint table (reference: bpf/lib/eps.h lookup_ip4_endpoint) —
  host endpoints pass to the stack, local endpoints run the ingress
  policy program, everything else is forwarded (via the overlay when
  the ipcache names a tunnel endpoint, reference:
  bpf_netdev.c encap_and_redirect_with_nodeid).

- ``overlay_verdicts`` (reference: bpf/bpf_overlay.c:97 handle_ipv4):
  packets decapped from the tunnel device.  The source identity comes
  from the tunnel key (VNI) verbatim, then the same demux runs.

CT-established packets skip policy; the CT table is tried in both
orientations (the forward key, and the reply to an entry the egress
pipeline created).  New flows run the {remote identity, dport, proto,
INGRESS} cascade with proxy redirection (reference: bpf/bpf_lxc.c:875,1008
tail_ipv6/ipv4_policy).  On the card both programs are kernel K15
(``csrc/ingress.cu``, one launcher with a netdev/overlay mode): one
thread a packet probes the hashed indexes (``ops/l34_index.py``, built
with every ``IngressTables``) for the identity LPM (netdev only), the
endpoint, both CT orientations, the policy cascade and the tunnel LPM.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

import torch

from .. import kernels
from ..device import resolve_device
from ..maps.ctmap import CtKey4, CtMap
from ..maps.ipcache import IpcacheMap
from ..maps.lxcmap import ENDPOINT_F_HOST, LxcMap
from ..maps.policymap import DIR_INGRESS, DevicePolicyMap, PolicyMap, policy_can_access_plain
from ..ops.l34_index import HashIndex, HashIx, LpmIndex, LpmIx
from ..ops.lpm import DeviceLpm, LpmTab, lpm_lookup_plain
from ..ops.maplookup import DeviceTable, ExactTab, exact_lookup_plain
from .pipeline import DROP, FORWARD, TO_PROXY, WORLD_ID, pack_ct

# Additional routing outcomes at the node boundary.
TO_HOST = 3  # dst is the host endpoint: pass to the local stack (TC_ACT_OK)
TO_OVERLAY = 4  # encap to tunnel_endpoint (encap_and_redirect_with_nodeid)

HOST_ID = 1  # reserved host identity (pkg/identity/numericidentity.go)
RESERVED_ID_MAX = 255  # user identities start at 256 (numericidentity.go)

MODE_NETDEV = 0
MODE_OVERLAY = 1


@dataclass
class IngressIndex:
    """K15's hashed indexes of one table snapshot (``ops/l34_index.py``):
    the tables' own."""

    ipcache_id: LpmIndex
    ipcache_tun: LpmIndex
    lxc: HashIndex  # addr -> (lxc_id, flags, ...), or the row id
    ct: HashIndex
    policy: HashIndex


@dataclass
class IngressTables:
    """Device snapshot of the maps the node-ingress programs read, and the
    hashed indexes K15 probes (each table's own, built with the table: none
    is built here)."""

    ipcache_id: DeviceLpm  # prefix -> sec_label
    ipcache_tun: DeviceLpm  # prefix -> tunnel_endpoint
    lxc: DeviceTable  # addr -> (lxc_id, flags)
    ct: DeviceTable  # (daddr, saddr, dport, sport, proto)
    policy: DevicePolicyMap  # the destination endpoint's policy
    index: IngressIndex = field(init=False, repr=False)

    def __post_init__(self):
        if self.ipcache_id.w != 1 or self.ipcache_tun.w != 1:
            raise ValueError("ingress tables: expected v4 (one-word) ipcache tables")
        if self.lxc.keys.shape[0] != 1 or self.lxc.values.shape[1] < 2:
            raise ValueError("ingress tables: expected an lxc table keyed by one column with (lxc_id, flags)")
        if self.ct.keys.shape[0] != 5:
            raise ValueError("ingress tables: expected a 5-column CT table")
        device = self.device
        for name in ("ipcache_id", "ipcache_tun", "lxc", "ct", "policy"):
            if getattr(self, name).device != device:
                raise ValueError(f"ingress tables: {name} is not on {device}")
        self.index = IngressIndex(ipcache_id=self.ipcache_id.index, ipcache_tun=self.ipcache_tun.index,
                                  lxc=self.lxc.index, ct=self.ct.index, policy=self.policy.table.index)

    @property
    def device(self) -> torch.device:
        return self.ct.device


def build_ingress_tables(
    ipcache: IpcacheMap, lxc: LxcMap, ct: CtMap, policy: PolicyMap, device=None
) -> IngressTables:
    """The node-ingress tables on ``device`` (None: the CUDA card)."""
    device = resolve_device(device)
    return IngressTables(
        ipcache_id=ipcache.to_device(device=device),
        ipcache_tun=ipcache.to_device(value="tunnel_endpoint", device=device),
        lxc=lxc.to_device(device=device),
        ct=pack_ct(ct, device),
        policy=policy.to_device(device=device),
    )


# --- kernel K15: the node-ingress programs -------------------------------------

_INGRESS = kernels.CudaKernel("ingress", "ingress", [ctypes.c_void_p])


class IngArgs(ctypes.Structure):
    """``struct IngArgs`` of ``csrc/ingress.cu``."""

    _fields_ = [
        ("ipc_id", LpmTab), ("ipc_tun", LpmTab), ("lxc", ExactTab), ("ct", ExactTab),
        ("pol", ExactTab), ("saddr", ctypes.c_void_p), ("daddr", ctypes.c_void_p),
        ("sport", ctypes.c_void_p), ("dport", ctypes.c_void_p), ("proto", ctypes.c_void_p),
        ("src", ctypes.c_void_p), ("mode", ctypes.c_int), ("f", ctypes.c_int),
        ("out", ctypes.c_void_p), ("flags", ctypes.c_void_p),
        ("id_ix", LpmIx), ("tun_ix", LpmIx), ("lxc_ix", HashIx), ("ct_ix", HashIx),
        ("pol_ix", HashIx),
    ]


def _netdev_identity(tables: IngressTables, saddr, src_identity):
    """Reserved identities are refined by the ipcache source lookup —
    except when the cache claims HOST_ID (SNAT makes world traffic wear
    the host IP; trust the caller's identity then)."""
    reserved = (src_identity >= 0) & (src_identity <= RESERVED_ID_MAX)
    found, sec, _ = lpm_lookup_plain(tables.ipcache_id, saddr)
    override = reserved & found & (sec != 0) & (sec != HOST_ID)
    return torch.where(
        override,
        sec,
        torch.where(reserved & (src_identity == 0), WORLD_ID, src_identity),
    )


def ingress_plain(tables: IngressTables, mode: int, saddr, daddr, sport, dport, proto, src) -> dict:
    """Plain PyTorch version of K15 (``cilium_tpu/datapath/ingress.py:91``
    ``_ingress_common`` after ``:152`` ``netdev_verdicts``' identity
    step, or ``:185`` ``overlay_verdicts``' verbatim VNI)."""
    src_id = _netdev_identity(tables, saddr, src) if mode == MODE_NETDEV else src
    # Local endpoint demux (eps.h lookup_ip4_endpoint).
    is_local, lxc_vals = exact_lookup_plain(tables.lxc, daddr)
    lxc_id = lxc_vals[:, 0]
    is_host_ep = is_local & ((lxc_vals[:, 1] & ENDPOINT_F_HOST) != 0)
    # Both CT orientations: the forward key, and the reply to an
    # egress-created entry (saddr/daddr and sport/dport swapped).
    est_fwd, _ = exact_lookup_plain(tables.ct, daddr, saddr, dport, sport, proto)
    est_reply, _ = exact_lookup_plain(tables.ct, saddr, daddr, sport, dport, proto)
    est = est_fwd | est_reply
    allowed, proxy_port = policy_can_access_plain(tables.policy, src_id, dport, proto, DIR_INGRESS)
    pass_ok = est | allowed
    local_verdict = torch.where(
        pass_ok,
        torch.where((proxy_port > 0) & ~est, TO_PROXY, FORWARD),
        DROP,
    )
    # Non-local: overlay encap when the ipcache names a tunnel endpoint.
    tun_found, tunnel, _ = lpm_lookup_plain(tables.ipcache_tun, daddr)
    remote_verdict = torch.where(tun_found & (tunnel != 0), TO_OVERLAY, FORWARD)
    verdict = torch.where(
        is_host_ep,
        TO_HOST,
        torch.where(is_local, local_verdict, remote_verdict),
    ).to(torch.int32)
    delivered = is_local & ~is_host_ep
    zero = torch.zeros_like(src_id)
    return {
        "verdict": verdict,
        "src_identity": src_id,
        "lxc_id": torch.where(is_local, lxc_id, zero),
        "tunnel_endpoint": torch.where(~is_local & tun_found, tunnel, zero),
        "proxy_port": torch.where(delivered & ~est, proxy_port, zero),
        "established": est & delivered,
        # Allowed new inbound flows the host should record; the FORWARD
        # orientation (daddr=local endpoint) is the key to create.
        "needs_ct_create": delivered & pass_ok & ~est,
    }


def ingress(tables: IngressTables, mode: int, saddr, daddr, sport, dport, proto, src) -> dict:
    """K15: one node-ingress pass (``mode`` MODE_NETDEV: ``src`` is the
    caller's source identity; MODE_OVERLAY: the tunnel id); inputs are
    [F] int32 numpy arrays or int32 tensors on the tables' device,
    outputs [F] tensors there."""
    if mode not in (MODE_NETDEV, MODE_OVERLAY):
        raise ValueError(f"unknown ingress mode {mode}")
    device = tables.device
    f = len(saddr)
    ins = [kernels.arg(a, name, torch.int32, (f,), device) for name, a in (
        ("saddr", saddr), ("daddr", daddr), ("sport", sport), ("dport", dport),
        ("proto", proto), ("src", src))]
    if kernels.on_cpu(device):
        return ingress_plain(tables, mode, *ins)
    ix = tables.index
    out = torch.empty((5, f), dtype=torch.int32, device=device)
    flags = torch.empty((2, f), dtype=torch.bool, device=device)
    if f:
        args = IngArgs(
            tables.ipcache_id.abi(), tables.ipcache_tun.abi(), tables.lxc.abi(),
            tables.ct.abi(), tables.policy.table.abi(), *[t.data_ptr() for t in ins],
            mode, f, out.data_ptr(), flags.data_ptr(),
            ix.ipcache_id.abi(), ix.ipcache_tun.abi(), ix.lxc.abi(), ix.ct.abi(), ix.policy.abi(),
        )
        _INGRESS.launch(device, ctypes.addressof(args))
    return {
        "verdict": out[0],
        "src_identity": out[1],
        "lxc_id": out[2],
        "tunnel_endpoint": out[3],
        "proxy_port": out[4],
        "established": flags[0],
        "needs_ct_create": flags[1],
    }


def netdev_verdicts(tables: IngressTables, saddr, daddr, sport, dport, proto, src_identity) -> dict:
    """From-world node ingress (bpf_netdev.c:352 handle_ipv4)."""
    return ingress(tables, MODE_NETDEV, saddr, daddr, sport, dport, proto, src_identity)


def overlay_verdicts(tables: IngressTables, saddr, daddr, sport, dport, proto, tunnel_id) -> dict:
    """Tunnel-device ingress (bpf_overlay.c:97 handle_ipv4): the VNI in
    the tunnel key IS the source identity."""
    return ingress(tables, MODE_OVERLAY, saddr, daddr, sport, dport, proto, tunnel_id)


def host_oracle_netdev(
    ipcache: IpcacheMap,
    lxc: LxcMap,
    ct: CtMap,
    policy: PolicyMap,
    saddr: int,
    daddr: int,
    sport: int,
    dport: int,
    proto: int,
    src_identity: int = 0,
    tunnel_id: int | None = None,
) -> dict:
    """Reference-semantics host walk (the fuzz oracle).  With
    ``tunnel_id`` set this is the overlay program instead."""
    import ipaddress

    if tunnel_id is not None:
        src_id = tunnel_id
    else:
        src_id = src_identity
        if 0 <= src_id <= RESERVED_ID_MAX:
            info = ipcache.lookup(str(ipaddress.IPv4Address(saddr)))
            if (
                info is not None
                and info.sec_label
                and info.sec_label != HOST_ID
            ):
                src_id = info.sec_label
            elif src_id == 0:
                src_id = WORLD_ID

    ep = lxc.lookup_ip(str(ipaddress.IPv4Address(daddr)))
    out = {
        "src_identity": src_id,
        "lxc_id": ep.lxc_id if ep is not None else 0,
        "tunnel_endpoint": 0,
        "proxy_port": 0,
        "established": False,
        "needs_ct_create": False,
    }
    if ep is not None and ep.is_host:
        out["verdict"] = TO_HOST
        return out
    if ep is not None:
        now = int(ct.clock())

        def live(key):
            e = ct.entries.get(key)
            return e is not None and e.lifetime >= now

        est = live(
            CtKey4(daddr=daddr & 0xFFFFFFFF, saddr=saddr & 0xFFFFFFFF,
                   dport=dport, sport=sport, nexthdr=proto)
        ) or live(  # reply to an egress-created entry
            CtKey4(daddr=saddr & 0xFFFFFFFF, saddr=daddr & 0xFFFFFFFF,
                   dport=sport, sport=dport, nexthdr=proto)
        )
        allowed, proxy_port = policy.lookup(
            src_id, dport, proto, direction=DIR_INGRESS, count_packets=False
        )
        out["established"] = est
        if est or allowed:
            if proxy_port > 0 and not est:
                out["verdict"] = TO_PROXY
                out["proxy_port"] = proxy_port
            else:
                out["verdict"] = FORWARD
            out["needs_ct_create"] = not est
        else:
            out["verdict"] = DROP
        return out
    info = ipcache.lookup(str(ipaddress.IPv4Address(daddr)))
    if info is not None and info.tunnel_endpoint:
        out["verdict"] = TO_OVERLAY
        out["tunnel_endpoint"] = info.tunnel_endpoint
    else:
        out["verdict"] = FORWARD
    return out
