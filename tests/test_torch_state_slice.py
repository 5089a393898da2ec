"""The state slice as a whole, through both packages, on the CPU.

The cluster of tests/state_world.py (a kvstore server, two agents, the
policy slice's label sets and rules, pod IPs, services and endpoints; the
allocations in order, with the ``random`` module seeded alike) is built
at ``SMALL`` once through the reference and once through the port
(endpoints at ``device="cpu"``).  Equal, tolerance 0: the allocated ids,
B's ipcache, the nodes, the LB map and its service ids, every endpoint's
desired and realized policy-map state and its ``DevicePolicyMap`` table,
and the K12-K15 verdicts (the port's plain path against the reference's
JAX functions) on the maps each package built, before and after churn.
"""

from __future__ import annotations

import json
import random

import numpy as np
import pytest
import torch

from cilium_tpu.datapath import ingress as ref_ingress
from cilium_tpu.datapath import pipeline as ref_pipeline
from cilium_tpu.maps import lbmap as ref_lbmap
from cilium_tpu.maps import policymap as ref_policymap
from cilium_tpu.ops import lpm as ref_lpm
from cilium_tpu_torch import entry
from cilium_tpu_torch.datapath import ingress as port_ingress
from cilium_tpu_torch.datapath import pipeline as port_pipeline
from cilium_tpu_torch.maps import lbmap as port_lbmap
from cilium_tpu_torch.maps import policymap as port_policymap
from cilium_tpu_torch.ops import lpm as port_lpm

import state_world as sw
from policy_cases import reference_leak_guard  # noqa: F401
from state_cases import PKGS, ipcache_contents, lbmap_contents, policymap_contents

F = 384
CLOCK = 1_000.0


@pytest.fixture(scope="module")
def worlds():
    """(reference world, port world), built and churned in turn; closed
    after the module.  Each package's global config is a fresh
    ``DaemonConfig`` (daemon tests leave a dry-mode one, which skips the
    device export) and policy enforcement its default, while it lives."""
    sets = list(entry.policy_identities().values())
    rules = json.dumps(entry.policy_rules(40, 20, 0.35))
    saved = {name: pk.option.config for name, pk in PKGS.items()}
    built = {}
    try:
        for name, pk in PKGS.items():
            pk.option.config = pk.option.DaemonConfig()
            pk.policy.set_policy_enabled("default")
            random.seed(21)
            built[name] = sw.build_world(pk, sw.SMALL, sets, rules, seed=5, ep_kw=pk.ep_kw,
                                         concurrent=False, ct_clock=lambda: CLOCK)
        yield built
    finally:
        for w in built.values():
            w.close()
        for name, pk in PKGS.items():
            pk.option.config = saved[name]


def _state(w):
    eps = w.manager.get_endpoints()
    return dict(
        ids=dict(w.ids), pairs=dict(w.pair), ipcache=ipcache_contents(w.ipc),
        lb=lbmap_contents(w.lb), services={v: (sid, list(b)) for v, (sid, b) in w.services.items()},
        svc_models=[s.to_model() for s in w.svc.list()],
        nodes={x: {k: n.to_dict() for k, n in w.nodes[x].get_nodes().items()} for x in "AB"},
        eps=[(ep.id, ep.ipv4, ep.security_identity.id, ep.state.value, ep.policy_revision,
              policymap_contents(ep.policy_map),
              {(k.identity, k.dest_port, k.proto, k.direction): v.proxy_port
               for k, v in ep.desired_map_state.items()},
              {(k.identity, k.dest_port, k.proto, k.direction): v.proxy_port
               for k, v in ep.realized_map_state.items()},
              dict(ep.realized_redirects)) for ep in eps],
        pushes=w.owner.pushes,
    )


def _table(dmap):
    t = dmap.table
    if isinstance(getattr(t, "keys", None), torch.Tensor):
        return [t.keys.numpy().tolist(), t.values.numpy().tolist(), t.valid.numpy().tolist()]
    return [np.stack([np.asarray(c) for c in t.cols]).tolist(), np.asarray(t.values).tolist(),
            np.asarray(t.valid).tolist()]


def _np(out):
    if isinstance(out, dict):
        return {k: _np(v) for k, v in sorted(out.items())}
    if isinstance(out, (tuple, list)):
        return [_np(v) for v in out]
    if isinstance(out, torch.Tensor):
        return out.numpy()
    return np.asarray(out)


def _verdicts(name, w, seed):
    """K12-K15 on ``w``'s maps: the reference's JAX functions or the
    port's plain path, on the same numpy queries."""
    rng = np.random.default_rng(seed)
    ref = name == "ref"
    eps = w.manager.get_endpoints()
    pol = eps[0].policy_map
    t = (lambda a: a) if ref else torch.from_numpy
    out = {}
    q = sw.policy_queries(w, rng, F)
    pm = ref_policymap if ref else port_policymap
    for d in (pm.DIR_INGRESS, pm.DIR_EGRESS):
        for ep in eps:
            out[f"K13 policy {ep.id}/{d}"] = pm.policy_can_access_batch(
                ep.device_policy_map, *(t(x) for x in q), d)
    addrs = sw.address_queries(w, rng, F)
    lpm = w.ipc.to_device() if ref else w.ipc.to_device(device="cpu")
    out["K12 ipcache"] = (ref_lpm if ref else port_lpm).lpm_lookup(lpm, t(addrs))
    lbq = sw.lb_queries(w, rng, F)
    dlb = w.lb.to_device() if ref else w.lb.to_device(device="cpu")
    out["K13 lb"] = (ref_lbmap if ref else port_lbmap).lb4_select_backend_batch(dlb, *(t(x) for x in lbq))
    pkt = sw.datapath_packets(w, rng, F)
    if ref:
        out["K14 datapath"] = ref_pipeline.datapath_verdicts(ref_pipeline.build_tables(w.ct, w.lb, w.ipc, pol), *pkt)
    else:
        out["K14 datapath"] = port_pipeline.datapath_verdicts(
            port_pipeline.build_tables(w.ct, w.lb, w.ipc, pol, device="cpu"), *pkt)
    ov = sw.overlay_packets(w, rng, F)
    if ref:
        tabs = ref_ingress.build_ingress_tables(w.ipc, w.lxc, w.ct, pol)
        out["K15 overlay"] = ref_ingress.overlay_verdicts(tabs, *ov)
    else:
        tabs = port_ingress.build_ingress_tables(w.ipc, w.lxc, w.ct, pol, device="cpu")
        out["K15 overlay"] = port_ingress.overlay_verdicts(tabs, *ov)
    return _np(out)


def _assert_same(got, want, path=""):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, x) in enumerate(zip(got, want)):
            _assert_same(g, x, f"{path}[{i}]")
    else:
        assert got.dtype == want.dtype, (path, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=path)


def _check(worlds, seed):
    ref, port = worlds["ref"], worlds["port"]
    assert _state(port) == _state(ref)
    for a, b in zip(ref.manager.get_endpoints(), port.manager.get_endpoints()):
        assert _table(b.device_policy_map) == _table(a.device_policy_map)
        assert b.device_policy_map.device == torch.device("cpu")
    want = _verdicts("ref", ref, seed)
    _assert_same(_verdicts("port", port, seed), want)
    return want


def test_state_slice_matches_reference(worlds):
    w = worlds["port"]
    n = sw.SMALL.identities * sw.SMALL.ips_per_identity
    assert len(w.pair) == len(w.ipc.v4) == n and len(set(w.id_of)) == sw.SMALL.identities
    assert w.stages["identities"][1]["contended"] == sw.SMALL.identities - 2 * (
        sw.SMALL.identities - sw.SMALL.identities * 5 // 8)
    assert len(w.svc) == sw.SMALL.services and all(ep.state.value == "ready" for ep in w.manager.get_endpoints())
    want = _check(worlds, 3)
    assert want["K12 ipcache"][0].any() and not want["K12 ipcache"][0].all()
    assert want["K13 lb"][0].any() and not want["K13 lb"][0].all()
    # egress is not enforced (the rules are ingress rules): K14 forwards,
    # DNATs the VIP packets and derives the destination identities
    dp = want["K14 datapath"]
    assert (dp["rev_nat"] > 0).any() and len(set(dp["dst_identity"].tolist())) > 2
    assert len(set(want["K15 overlay"]["verdict"].tolist())) > 1


def test_state_slice_after_churn_matches_reference(worlds):
    for name in ("ref", "port"):
        random.seed(22)
        gone = sw.churn(worlds[name])
    w = worlds["port"]
    assert all(w.cache["B"].lookup_by_ip(ip) is None for ip in gone)
    assert len(w.ipc.v4) == sw.SMALL.identities * sw.SMALL.ips_per_identity - sw.SMALL.churn_ips
    moved = w.manager.get_endpoints()[: sw.SMALL.churn_endpoints]
    assert all("k8s:rollout=v2" in ep.security_identity.labels.get_model() for ep in moved)
    _check(worlds, 4)
