"""The port's L3/L4 datapath (K14 ``datapath_verdicts`` /
``datapath_verdicts6``, K15 ``netdev_verdicts`` / ``overlay_verdicts``,
K12 in ``PreFilter.filter_batch``, and ``account_verdicts``) at
device="cpu" against the JAX package.

The same host maps are built in both packages from one seed
(tests/l34_worlds.py) with a fixed clock, and the same numpy packets go
through both; every output is bool or int, so the tolerance is 0.  The
host oracles of both packages judge the same packets, the CT round trip
(``apply_ct_creates``) creates the same entries in both, and the port's
tables converted from the JAX tables' leaves equal the port's own.
"""

from __future__ import annotations

import random
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import l34_worlds as worlds
from cilium_tpu.datapath import ingress as ref_ingress
from cilium_tpu.datapath import notify as ref_notify
from cilium_tpu.datapath import pipeline as ref_pipeline
from cilium_tpu.datapath import pipeline6 as ref_pipeline6
from cilium_tpu.datapath.prefilter import PreFilter as RefPreFilter
from cilium_tpu.flowlog import FlowLog as RefFlowLog
from cilium_tpu.maps import ctmap as ref_ctmap
from cilium_tpu.maps import ipcache as ref_ipcache
from cilium_tpu.maps import lbmap as ref_lbmap
from cilium_tpu.maps import lxcmap as ref_lxcmap
from cilium_tpu.maps import metricsmap as ref_metricsmap
from cilium_tpu.maps import policymap as ref_policymap
from cilium_tpu_torch import convert, entry
from cilium_tpu_torch.datapath import ingress, notify, pipeline, pipeline6
from cilium_tpu_torch.datapath.prefilter import PreFilter
from cilium_tpu_torch.flowlog import FlowLog
from cilium_tpu_torch.maps import ctmap, ipcache, lbmap, lxcmap, metricsmap, policymap

CPU = "cpu"


def _ns(ct, lb, ipc, pol, lxc):
    return SimpleNamespace(CtMap=ct.CtMap, CtKey4=ct.CtKey4, CtKey6=ct.CtKey6, LbMap=lb.LbMap,
                           IpcacheMap=ipc.IpcacheMap, PolicyMap=pol.PolicyMap, LxcMap=lxc.LxcMap,
                           EndpointInfo=lxc.EndpointInfo)


REF = _ns(ref_ctmap, ref_lbmap, ref_ipcache, ref_policymap, ref_lxcmap)
PORT = _ns(ctmap, lbmap, ipcache, policymap, lxcmap)


def _both(builder, seed, **kw):
    """(ref maps, port maps, ref clock, port clock, rng after the build)."""
    out = []
    for ns in (REF, PORT):
        rng, clock = random.Random(seed), worlds.Clock()
        out.append((builder(ns, rng, clock, **kw), clock, rng))
    (ref, rclock, _), (port, pclock, rng) = out
    return ref, port, rclock, pclock, rng


def _host(out: dict) -> dict:
    return {k: (tuple(np.asarray(w) for w in v) if isinstance(v, tuple) else np.asarray(v))
            for k, v in out.items()}


def _assert_dicts_equal(got: dict, want: dict):
    got = pipeline.host_arrays(got)
    assert got.keys() == want.keys()
    for key, w in want.items():
        g = got[key]
        for a, b in zip(g if isinstance(w, tuple) else (g,), w if isinstance(w, tuple) else (w,)):
            assert a.dtype == b.dtype, (key, a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b, err_msg=key)


def _u32(x) -> int:
    return int(np.int64(x) & 0xFFFFFFFF)


@pytest.mark.parametrize("seed,f", [(3, 512), (4, 64)])
def test_datapath_v4_matches_jax_and_the_oracle(seed, f):
    ref, port, _, _, rng = _both(worlds.egress4_world, seed)
    pkts = worlds.egress4_packets(rng, f, port[4])
    want = _host(ref_pipeline.datapath_verdicts(ref_pipeline.build_tables(*ref[:4]), *pkts))
    got = pipeline.datapath_verdicts(pipeline.build_tables(*port[:4], device=CPU), *pkts)
    _assert_dicts_equal(got, want)
    got = pipeline.host_arrays(got)
    assert set(np.unique(got["verdict"])) == {pipeline.FORWARD, pipeline.DROP, pipeline.TO_PROXY}
    assert got["established"].any() and got["rev_nat"].any()
    for i in range(f):
        args = [_u32(pkts[0][i]), _u32(pkts[1][i]), *(int(p[i]) for p in pkts[2:])]
        oracle = pipeline.host_oracle(*port[:4], *args)
        assert oracle == ref_pipeline.host_oracle(*ref[:4], *args)
        for key, val in oracle.items():
            assert _u32(got[key][i]) == _u32(val), (i, key)


def test_datapath_v6_matches_jax_and_the_oracle():
    ref, port, _, _, rng = _both(worlds.egress6_world, 5)
    sa, da, sw, dw, sport, dport, proto = worlds.egress6_packets(rng, 400, port[4])
    want = _host(ref_pipeline6.datapath_verdicts6(ref_pipeline6.build_tables6(*ref[:4]), sw, dw, sport,
                                                  dport, proto))
    got = pipeline6.datapath_verdicts6(pipeline6.build_tables6(*port[:4], device=CPU), sw, dw, sport, dport,
                                       proto)
    _assert_dicts_equal(got, want)
    got = pipeline.host_arrays(got)
    assert got["established"].any() and (got["verdict"] == pipeline.TO_PROXY).any()
    for i in range(len(sa)):
        args = (sa[i], da[i], int(sport[i]), int(dport[i]), int(proto[i]))
        oracle = pipeline6.host_oracle6(*port[:4], *args)
        assert oracle == ref_pipeline6.host_oracle6(*ref[:4], *args)
        words = sum(int(np.uint32(w[i])) << (96 - 32 * j) for j, w in enumerate(got["new_daddr_words"]))
        assert words == oracle.pop("new_daddr")
        for key, val in oracle.items():
            assert int(got[key][i]) == int(val), (i, key)


@pytest.mark.parametrize("overlay", [False, True])
def test_node_ingress_matches_jax_and_the_oracle(overlay):
    ref, port, _, _, rng = _both(worlds.node_world, 7)
    p = worlds.node_packets(rng, 512)
    cols = [p[k] for k in ("saddr", "daddr", "sport", "dport", "proto")]
    src = p["vni"] if overlay else p["src_id"]
    rfn = ref_ingress.overlay_verdicts if overlay else ref_ingress.netdev_verdicts
    fn = ingress.overlay_verdicts if overlay else ingress.netdev_verdicts
    want = _host(rfn(ref_ingress.build_ingress_tables(*ref), *cols, src))
    got = fn(ingress.build_ingress_tables(*port, device=CPU), *cols, src)
    _assert_dicts_equal(got, want)
    got = pipeline.host_arrays(got)
    assert set(np.unique(got["verdict"])) == {0, 1, 2, 3, 4}
    assert got["established"].any() and (got["tunnel_endpoint"].view(np.uint32) >= 1 << 31).any()
    for i in range(512):
        kw = {"tunnel_id": int(src[i])} if overlay else {"src_identity": int(src[i])}
        args = [_u32(cols[0][i]), _u32(cols[1][i]), *(int(c[i]) for c in cols[2:])]
        oracle = ingress.host_oracle_netdev(*port, *args, **kw)
        assert oracle == ref_ingress.host_oracle_netdev(*ref, *args, **kw)
        for key, val in oracle.items():
            assert _u32(got[key][i]) == _u32(val), (i, key)


def test_expired_ct_entries_and_empty_tables():
    ref, port, rclock, pclock, rng = _both(worlds.egress4_world, 8)
    pkts = worlds.egress4_packets(rng, 128, port[4])
    for clock in (rclock, pclock):
        clock.now += 21600 + 1  # every TCP entry has expired too
    assert len(pipeline.pack_ct(port[0], CPU).valid) == 1  # one padding row
    want = _host(ref_pipeline.datapath_verdicts(ref_pipeline.build_tables(*ref[:4]), *pkts))
    got = pipeline.datapath_verdicts(pipeline.build_tables(*port[:4], device=CPU), *pkts)
    _assert_dicts_equal(got, want)
    assert not pipeline.host_arrays(got)["established"].any()
    empty = [(REF, ref_pipeline, {}), (PORT, pipeline, {"device": CPU})]
    outs = []
    for ns, mod, kw in empty:
        maps = (ns.CtMap(), ns.LbMap(), ns.IpcacheMap(), ns.PolicyMap())
        outs.append(mod.datapath_verdicts(mod.build_tables(*maps, **kw), *pkts))
    _assert_dicts_equal(outs[1], _host(outs[0]))
    assert (pipeline.host_arrays(outs[1])["verdict"] == pipeline.DROP).all()
    tables = ingress.build_ingress_tables(PORT.IpcacheMap(), PORT.LxcMap(), PORT.CtMap(), PORT.PolicyMap(),
                                          device=CPU)
    want = _host(ref_ingress.netdev_verdicts(ref_ingress.build_ingress_tables(
        REF.IpcacheMap(), REF.LxcMap(), REF.CtMap(), REF.PolicyMap()), *pkts, pkts[4]))
    _assert_dicts_equal(ingress.netdev_verdicts(tables, *pkts, pkts[4]), want)


def test_ct_round_trip_v4_and_v6():
    ref, port, _, _, rng = _both(worlds.egress4_world, 9)
    pkts = worlds.egress4_packets(rng, 256, port[4])
    t_ref = ref_pipeline.build_tables(*ref[:4])
    out_ref = ref_pipeline.datapath_verdicts(t_ref, *pkts)
    out = pipeline.datapath_verdicts(pipeline.build_tables(*port[:4], device=CPU), *pkts)
    n = pipeline.apply_ct_creates(port[0], out, pkts[0], pkts[2], pkts[4])
    assert n == ref_pipeline.apply_ct_creates(ref[0], out_ref, pkts[0], pkts[2], pkts[4]) > 0
    assert sorted(map(repr, port[0].entries)) == sorted(
        repr(k).replace("cilium_tpu.", "") for k in ref[0].entries)
    again = pipeline.host_arrays(pipeline.datapath_verdicts(pipeline.build_tables(*port[:4], device=CPU),
                                                            *pkts))
    created = pipeline.host_arrays(out)["needs_ct_create"]
    assert again["established"][created].all() and not again["needs_ct_create"][created].any()

    ref6, port6, _, _, rng = _both(worlds.egress6_world, 10)
    _, _, sw, dw, sport, dport, proto = worlds.egress6_packets(rng, 256, port6[4])
    out_ref = ref_pipeline6.datapath_verdicts6(ref_pipeline6.build_tables6(*ref6[:4]), sw, dw, sport, dport, proto)
    out = pipeline6.datapath_verdicts6(pipeline6.build_tables6(*port6[:4], device=CPU), sw, dw, sport, dport, proto)
    n = pipeline6.apply_ct_creates6(port6[0], out, sw, sport, proto)
    assert n == ref_pipeline6.apply_ct_creates6(ref6[0], out_ref, sw, sport, proto) > 0
    again = pipeline.host_arrays(pipeline6.datapath_verdicts6(
        pipeline6.build_tables6(*port6[:4], device=CPU), sw, dw, sport, dport, proto))
    created = pipeline.host_arrays(out)["needs_ct_create"]
    assert again["established"][created].all()


class _Monitor:
    def __init__(self):
        self.events = []

    def send_verdict(self, **kw):
        self.events.append(kw)


def _records(fl) -> list:
    return [{k: v for k, v in r.items() if k not in ("ts", "time")} for r in fl.query(n=100000)]


@pytest.mark.parametrize("v6", [False, True])
def test_prefilter_matches_jax(v6):
    rng = random.Random(12 + v6)
    bits = 128 if v6 else 32
    import ipaddress

    cidrs = []
    for _ in range(40):
        plen = rng.randrange(8 if not v6 else 32, bits + 1)
        cidrs.append(f"{ipaddress.ip_address(rng.getrandbits(bits))}/{plen}")
    filters = [RefPreFilter(), PreFilter(device=CPU)]
    for pf in filters:
        rev = pf.insert(1, cidrs)
        pf.delete(rev, cidrs[:3])
    assert filters[0].dump() == filters[1].dump()
    nets = [ipaddress.ip_network(c, strict=False) for c in cidrs[3:]]
    addrs = [int(rng.choice(nets).network_address) | rng.getrandbits(4) if rng.random() < 0.3
             else rng.getrandbits(bits) for _ in range(300)]
    words = np.stack(worlds.v6_words(addrs)) if v6 else worlds.as_i32(addrs)
    outs = []
    for pf, fl in zip(filters, (RefFlowLog(capacity=4096), FlowLog(capacity=4096))):
        mon = _Monitor()
        outs.append((pf.filter_batch(words, v6=v6, flowlog=fl, monitor=mon), _records(fl), mon.events))
    (rk, rr, re), (pk, pr, pe) = outs
    assert isinstance(pk, np.ndarray) and pk.dtype == bool
    np.testing.assert_array_equal(pk, np.asarray(rk))
    assert pr == rr and pe == re
    assert 0 < (~pk).sum() < len(pk)


def test_account_verdicts_matches_jax():
    ref, port, _, _, rng = _both(worlds.egress4_world, 14)
    pkts = worlds.egress4_packets(rng, 300, port[4])
    lengths = np.array([rng.randrange(40, 1500) for _ in range(300)], np.int64)
    res = []
    for mod, nmod, mmod, fl, kw in (
        (ref_pipeline, ref_notify, ref_metricsmap, RefFlowLog(capacity=4096), {}),
        (pipeline, notify, metricsmap, FlowLog(capacity=4096), {"device": CPU}),
    ):
        maps = ref[:4] if mod is ref_pipeline else port[:4]
        out = mod.datapath_verdicts(mod.build_tables(*maps, **kw), *pkts)
        metrics, mon = mmod.MetricsMap(), _Monitor()
        counts = nmod.account_verdicts(out, metrics, monitor=mon, lengths=lengths, proto=pkts[4],
                                       src_identity=pkts[0], flowlog=fl,
                                       opts={"PolicyVerdictNotification": True})
        res.append((counts, metrics.dump(), mon.events, _records(fl)))
    assert res[0] == res[1]
    assert res[1][0]["dropped"] and res[1][0]["forwarded"] and res[1][0]["proxied"]
    # ingress verdicts count TO_HOST and TO_OVERLAY as forwarded
    ref_n, port_n, _, _, rng = _both(worlds.node_world, 15)
    p = worlds.node_packets(rng, 200)
    cols = [p[k] for k in ("saddr", "daddr", "sport", "dport", "proto")]
    got = notify.account_verdicts(ingress.netdev_verdicts(ingress.build_ingress_tables(*port_n, device=CPU),
                                                          *cols, p["src_id"]), metricsmap.MetricsMap(),
                                  direction=metricsmap.METRIC_DIR_INGRESS)
    want = ref_notify.account_verdicts(ref_ingress.netdev_verdicts(ref_ingress.build_ingress_tables(*ref_n),
                                                                   *cols, p["src_id"]),
                                       ref_metricsmap.MetricsMap(), direction=metricsmap.METRIC_DIR_INGRESS)
    assert got == want


def test_converted_tables_equal_the_ports_own():
    ref, port, _, _, rng = _both(worlds.egress4_world, 16)
    pkts = worlds.egress4_packets(rng, 200, port[4])
    ref6, port6, _, _, rng6 = _both(worlds.egress6_world, 17)
    _, _, sw, dw, sp, dp, pr = worlds.egress6_packets(rng6, 200, port6[4])
    refn, portn, _, _, rngn = _both(worlds.node_world, 18)
    p = worlds.node_packets(rngn, 200)
    cases = [
        (ref_pipeline.build_tables(*ref[:4]), pipeline.build_tables(*port[:4], device=CPU),
         convert.datapath_tables_from_numpy, lambda t: pipeline.datapath_verdicts(t, *pkts)),
        (ref_pipeline6.build_tables6(*ref6[:4]), pipeline6.build_tables6(*port6[:4], device=CPU),
         convert.datapath_tables6_from_numpy, lambda t: pipeline6.datapath_verdicts6(t, sw, dw, sp, dp, pr)),
        (ref_ingress.build_ingress_tables(*refn), ingress.build_ingress_tables(*portn, device=CPU),
         convert.ingress_tables_from_numpy,
         lambda t: ingress.netdev_verdicts(t, *(p[k] for k in ("saddr", "daddr", "sport", "dport", "proto")),
                                           p["src_id"])),
    ]
    for ref_tables, own, conv, run in cases:
        leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(ref_tables)]
        got = conv(leaves, device=CPU)
        assert type(got) is type(own)
        mine = [x for x in _tensors(got)]
        theirs = [x for x in _tensors(own)]
        assert len(mine) == len(theirs)
        for a, b in zip(mine, theirs):
            assert a.dtype == b.dtype and torch.equal(a, b)
        _assert_dicts_equal(run(got), _host(run(own)))
        with pytest.raises(ValueError):
            conv(leaves + leaves[:1], device=CPU)


def _tensors(obj):
    for val in vars(obj).values():
        if isinstance(val, torch.Tensor):
            yield val
        else:
            yield from _tensors(val)


def test_bench_maps_and_batch():
    ct, lb, ipc, pol = entry.datapath_bench_maps()
    assert (len(ct.entries), len(ipc.v4), len(pol.entries)) == (4096, 1024, 511)
    assert len(lb.services) == 64 * 4
    pkts = entry.datapath_batch(2048)
    assert all(a.dtype == np.int32 and a.shape == (2048,) for a in pkts)
    tables = pipeline.build_tables(ct, lb, ipc, pol, device=CPU)
    assert tables.policy.table.n == 512 and tables.ct.n == 4096
    out = pipeline.host_arrays(pipeline.datapath_verdicts(tables, *pkts))
    assert 0.15 < out["established"].mean() < 0.25 and 0.25 < (out["rev_nat"] > 0).mean() < 0.35
    for i in range(0, 2048, 8):
        want = pipeline.host_oracle(ct, lb, ipc, pol, _u32(pkts[0][i]), _u32(pkts[1][i]), int(pkts[2][i]),
                                    int(pkts[3][i]), int(pkts[4][i]))
        for key, val in want.items():
            assert _u32(out[key][i]) == _u32(val), (i, key)


def test_entry_points_need_a_device_or_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None means it")
    ct, lb, ipc, pol = (PORT.CtMap(), PORT.LbMap(), PORT.IpcacheMap(), PORT.PolicyMap())
    for call in (lambda: pipeline.build_tables(ct, lb, ipc, pol),
                 lambda: pipeline6.build_tables6(ct, lb, ipc, pol),
                 lambda: ingress.build_ingress_tables(ipc, PORT.LxcMap(), ct, pol),
                 lambda: PreFilter(),
                 lambda: convert.datapath_tables_from_numpy([])):
        with pytest.raises(RuntimeError):
            call()
