"""The port's map lookups (K12 ``lpm_lookup``, K13 ``exact_lookup``,
``policy_can_access``, ``lb_select``) at device="cpu" against the JAX
package.

The same host maps are built in both packages from one seed, and the same
numpy inputs go through the JAX function and the port's; every output is
bool or int, so the tolerance is 0.  The plain PyTorch versions run here;
the card's kernels are held against them in tests/test_torch_cuda.py and
chip_smoke.py.  Covered traps: addresses and values at or above 2^31,
ports up to 65,535, duplicate keys whose values sum (with int32 wrap),
padding rows against all-zero queries, LPM ties and /0, duplicate VIPs,
services without backends and counts past the backend columns, empty
tables, and the L3-only proxy-port divergence of the reference.
"""

from __future__ import annotations

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilium_tpu.datapath import pipeline as ref_pipeline
from cilium_tpu.datapath import pipeline6 as ref_pipeline6
from cilium_tpu.maps import lbmap as ref_lbmap
from cilium_tpu.maps import policymap as ref_policymap
from cilium_tpu.ops import lpm as ref_lpm
from cilium_tpu.ops import maplookup as ref_ml
from cilium_tpu_torch.datapath.pipeline import flow_hash32, flow_hash32_v6
from cilium_tpu_torch.maps import lbmap, policymap
from cilium_tpu_torch.ops import lpm, maplookup

CPU = "cpu"


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _equal(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, tuple):
            _equal(tuple(g), w)
            continue
        g, w = _np(g), np.asarray(w)
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w)


def _cidrs(rng: random.Random, v6: bool, n: int) -> list[tuple[str, int]]:
    """Random prefixes with host bits set, a /0, equal prefixes with other
    values, and values at or above 2^31 as int32 bit patterns."""
    bits = 128 if v6 else 32
    out = [("::/0" if v6 else "0.0.0.0/0", 5)]
    for i in range(n):
        addr = rng.getrandbits(bits)
        plen = rng.randrange(bits + 1)
        text = str(__import__("ipaddress").ip_address(addr if v6 else addr & 0xFFFFFFFF))
        out.append((f"{text}/{plen}", int(maplookup.u32_to_i32(rng.getrandbits(32)))))
    out += [(c, v + 1) for c, v in out[1:4]]  # ties: the larger value wins
    return out


def _addresses(rng: random.Random, prefixes, v6: bool, f: int) -> list[int]:
    import ipaddress

    out = []
    for _ in range(f):
        if rng.random() < 0.5:
            net = ipaddress.ip_network(rng.choice(prefixes)[0], strict=False)
            host = rng.getrandbits(net.max_prefixlen - net.prefixlen) if net.prefixlen < net.max_prefixlen else 0
            out.append(int(net.network_address) | host)
        else:
            out.append(rng.getrandbits(128 if v6 else 32))
    return out


@pytest.mark.parametrize("v6,n,f,pad", [(False, 40, 257, None), (True, 24, 300, 64), (False, 0, 64, None),
                                       (True, 0, 64, 4)])
def test_lpm_lookup_matches_jax(v6, n, f, pad):
    rng = random.Random(n * 7 + f)
    prefixes = _cidrs(rng, v6, n) if n else []
    addrs = _addresses(rng, prefixes or [("0.0.0.0/0", 0)], v6, f)
    words = lpm.ipv6_to_words(addrs) if v6 else lpm.ipv4_to_words(addrs)
    _equal(words, ref_lpm.ipv6_to_words(addrs) if v6 else ref_lpm.ipv4_to_words(addrs))
    ref_tab = ref_lpm.build_lpm(prefixes, v6=v6, pad_to=pad)
    tab = lpm.build_lpm(prefixes, v6=v6, pad_to=pad, device=CPU)
    for name in ("words", "masks"):
        np.testing.assert_array_equal(_np(getattr(tab, name)), np.stack(getattr(ref_tab, name)))
    for name in ("plen", "values", "valid"):
        np.testing.assert_array_equal(_np(getattr(tab, name)), np.asarray(getattr(ref_tab, name)))
    got = lpm.lpm_lookup(tab, *words)
    _equal(got, tuple(np.asarray(x) for x in ref_lpm.lpm_lookup(ref_tab, *words)))
    _equal(lpm.prefilter_check_batch(tab, *words), np.asarray(ref_lpm.prefilter_check_batch(ref_tab, *words)))
    if n:
        assert bool(got[0].all())  # the /0 row matches everything
        assert len(set(_np(got[2]).tolist())) > 3


def test_lpm_ties_take_the_largest_value():
    for v6, net in ((False, "10.1.0.0/16"), (True, "fd00::/64")):
        prefixes = [(net, 7), (net, -3), (net, 12), ("0.0.0.0/0" if not v6 else "::/0", 99)]
        addr = [int(__import__("ipaddress").ip_network(net).network_address) + 5]
        words = lpm.ipv6_to_words(addr) if v6 else lpm.ipv4_to_words(addr)
        found, value, plen = lpm.lpm_lookup(lpm.build_lpm(prefixes, v6=v6, device=CPU), *words)
        ref = ref_lpm.lpm_lookup(ref_lpm.build_lpm(prefixes, v6=v6), *words)
        _equal((found, value, plen), tuple(np.asarray(x) for x in ref))
        assert bool(found[0]) and int(value[0]) == 12 and int(plen[0]) == (64 if v6 else 16)


@pytest.mark.parametrize("k,v,n,f,pad", [(1, 2, 12, 100, 16), (4, 1, 30, 257, None), (5, 3, 40, 64, 64),
                                         (11, 1, 20, 50, 32), (3, 2, 0, 20, None)])
def test_exact_lookup_matches_jax(k, v, n, f, pad):
    """Keys from a small range (duplicates sum, with int32 wrap), padding
    rows, all-zero queries."""
    rng = np.random.default_rng(k * 31 + n)
    keys = rng.integers(0, 3, (n, k)).astype(np.int32)
    keys[n - 3:] = keys[:3]  # duplicate keys: their values sum
    values = rng.integers(-(1 << 31), 1 << 31, (n, v)).astype(np.int32)
    tab = maplookup.pack_table(keys, values, pad_to=pad, device=CPU)
    ref_tab = ref_ml.pack_table(keys, values, pad_to=pad)
    np.testing.assert_array_equal(_np(tab.keys), np.stack(ref_tab.cols))
    np.testing.assert_array_equal(_np(tab.values), np.asarray(ref_tab.values))
    q = rng.integers(0, 4, (f, k)).astype(np.int32)
    if n:
        hit = rng.random(f) < 0.5  # half the queries are rows of the table
        q[hit] = keys[rng.integers(0, n, int(hit.sum()))]
    q[:3] = 0
    q = [np.ascontiguousarray(q[:, i]) for i in range(k)]
    got = maplookup.exact_lookup(tab, *q)
    _equal(got, tuple(np.asarray(x) for x in ref_ml.exact_lookup(ref_tab, *q)))
    if n:
        assert bool(got[0].any())


def test_exact_lookup_rejects_a_short_key():
    tab = maplookup.pack_table(np.zeros((2, 3)), np.zeros((2, 1)), device=CPU)
    with pytest.raises(ValueError):
        maplookup.exact_lookup(tab, np.zeros(4, np.int32))


def _policy_maps(rng: random.Random):
    ref, port = ref_policymap.PolicyMap(), policymap.PolicyMap()
    for _ in range(60):
        args = (rng.choice([0, 1, 256, 257, 300, 65535, 1 << 20]), rng.choice([0, 53, 80, 8080, 65535]),
                rng.choice([0, 6, 17]), rng.choice([0, 1]), rng.choice([0, 0, 15000, 65535]))
        if args[1] == 0 and args[2] == 0 and args[0] != 0:
            args = (*args[:4], 0)  # an L3-only entry carries no proxy port (see the divergence test)
        ref.allow(*args)
        port.allow(*args)
    return ref, port


@pytest.mark.parametrize("seed", [1, 2])
def test_policy_can_access_matches_jax_and_host(seed):
    rng = random.Random(seed)
    ref, port = _policy_maps(rng)
    f = 300
    ident = np.array([rng.choice([0, 1, 256, 257, 300, 65535, 1 << 20, 7]) for _ in range(f)], np.int32)
    dport = np.array([rng.choice([0, 53, 80, 8080, 65535, 9]) for _ in range(f)], np.int32)
    proto = np.array([rng.choice([0, 6, 17]) for _ in range(f)], np.int32)
    proto[dport == 0] = 0
    for pad in (None, 512):
        dmap, ref_dmap = port.to_device(pad_to=pad, device=CPU), ref.to_device(pad_to=pad)
        for direction in (0, 1):
            got = policymap.policy_can_access_batch(dmap, ident, dport, proto, direction)
            want = ref_policymap.policy_can_access_batch(ref_dmap, ident, dport, proto, direction)
            _equal(got, tuple(np.asarray(x) for x in want))
            for i in range(f):
                host = port.lookup(int(ident[i]), int(dport[i]), int(proto[i]), direction,
                                   count_packets=False)
                assert (bool(got[0][i]), int(got[1][i])) == host
                assert host == ref.lookup(int(ident[i]), int(dport[i]), int(proto[i]), direction,
                                          count_packets=False)


def test_policy_cascade_sums_duplicate_rows():
    keys = np.array([[5, 80, 6, 1], [5, 80, 6, 1], [0, 80, 6, 1], [0, 80, 6, 1]], np.int32)
    vals = np.array([[0x7FFFFFFF], [2], [3], [4]], np.int32)
    dmap = policymap.DevicePolicyMap(table=maplookup.pack_table(keys, vals, pad_to=8, device=CPU))
    ref_dmap = ref_policymap.DevicePolicyMap(table=ref_ml.pack_table(keys, vals, pad_to=8))
    args = (np.array([5, 9, 0], np.int32), np.array([80, 80, 80], np.int32), np.array([6, 6, 6], np.int32))
    got = policymap.policy_can_access_batch(dmap, *args, direction=1)
    _equal(got, tuple(np.asarray(x) for x in ref_policymap.policy_can_access_batch(ref_dmap, *args, 1)))
    assert _np(got[1]).tolist() == [-(1 << 31) + 1, 7, 7]


def test_l3_only_proxy_port_diverges_from_the_host_map():
    """Reference divergence (ROADMAP Queue 3): an L3-only entry (dport 0,
    proto 0) with a proxy port, hit by a packet with dport 0 and proto 0.
    The device cascade's step 1 returns its proxy port (the pipeline says
    TO_PROXY); PolicyMap.lookup returns (True, 0) ("L3-only never
    redirects", so the host oracle says FORWARD).  The port follows the
    JAX package on both sides."""
    for mod, kw in ((ref_policymap, {}), (policymap, {"device": CPU})):
        pm = mod.PolicyMap()
        pm.allow(300, 0, 0, mod.DIR_EGRESS, proxy_port=15000)
        allowed, proxy = mod.policy_can_access_batch(
            pm.to_device(**kw), np.array([300], np.int32), np.array([0], np.int32),
            np.array([0], np.int32), mod.DIR_EGRESS,
        )
        assert (bool(np.asarray(allowed)[0]), int(np.asarray(proxy)[0])) == (True, 15000)
        assert pm.lookup(300, 0, 0, mod.DIR_EGRESS, count_packets=False) == (True, 0)
    # Through the whole pass: the device says TO_PROXY, the oracle FORWARD.
    from cilium_tpu.maps import ctmap as ref_ctmap
    from cilium_tpu.maps import ipcache as ref_ipcache
    from cilium_tpu_torch.datapath import pipeline
    from cilium_tpu_torch.maps import ctmap, ipcache

    one = [np.array([x], np.int32) for x in (0x0A000001, 0x0A000002, 1000, 0, 0)]
    for mod, cm, lm, im, pmod, kw in (
        (ref_pipeline, ref_ctmap, ref_lbmap, ref_ipcache, ref_policymap, {}),
        (pipeline, ctmap, lbmap, ipcache, policymap, {"device": CPU}),
    ):
        ct, lb, ipc, pol = cm.CtMap(), lm.LbMap(), im.IpcacheMap(), pmod.PolicyMap()
        ipc.upsert("10.0.0.0/8", sec_label=300)
        pol.allow(300, 0, 0, pmod.DIR_EGRESS, proxy_port=15000)
        out = mod.datapath_verdicts(mod.build_tables(ct, lb, ipc, pol, **kw), *one)
        assert int(np.asarray(out["verdict"])[0]) == mod.TO_PROXY
        oracle = mod.host_oracle(ct, lb, ipc, pol, 0x0A000001, 0x0A000002, 1000, 0, 0)
        assert oracle["verdict"] == mod.FORWARD


def _lb_maps(rng: random.Random, v6: bool):
    ref, port = ref_lbmap.LbMap(), lbmap.LbMap()
    base = (0xFD00 << 112) if v6 else (172 << 24)
    up = "upsert_service6" if v6 else "upsert_service"
    for s in range(10):
        vip = base + s % 7  # the same VIP with several ports
        dport = rng.choice([0, 80, 443, 65535])
        backends = [(base + 0x1000 + rng.getrandbits(16), rng.choice([80, 8080, 65535]))
                    for _ in range(rng.randrange(0, 5))]  # some services have none
        for m in (ref, port):
            getattr(m, up)(vip, dport, backends, rev_nat_index=s + 1)
    return ref, port


@pytest.mark.parametrize("v6", [False, True])
def test_lb_select_matches_jax_and_host(v6):
    rng = random.Random(11 + v6)
    ref, port = _lb_maps(rng, v6)
    f = 400
    base = (0xFD00 << 112) if v6 else (172 << 24)
    vips = [base + rng.randrange(9) for _ in range(f)]
    dport = np.array([rng.choice([0, 80, 443, 65535, 1]) for _ in range(f)], np.int32)
    fh = np.array([rng.getrandbits(32) for _ in range(f)], np.int64)
    fh32 = maplookup.u32_to_i32(fh)
    if v6:
        vw = lpm.ipv6_to_words(vips)
        dlb, ref_dlb = port.to_device6(device=CPU), ref.to_device6()
        got = lbmap.lb6_select_backend_batch(dlb, vw, dport, fh32)
        want = ref_lbmap.lb6_select_backend_batch(ref_dlb, vw, dport, fh32)
        _equal(got, (np.asarray(want[0]), tuple(np.asarray(x) for x in want[1]),
                     np.asarray(want[2]), np.asarray(want[3])))
    else:
        vw = lpm.ipv4_to_words(vips)
        dlb, ref_dlb = port.to_device(device=CPU), ref.to_device()
        got = lbmap.lb4_select_backend_batch(dlb, vw[0], dport, fh32)
        _equal(got, tuple(np.asarray(x) for x in ref_lbmap.lb4_select_backend_batch(ref_dlb, vw[0], dport, fh32)))
    found = _np(got[0])
    assert found.any() and not found.all()
    select = port.select_backend6 if v6 else port.select_backend
    for i in range(f):
        be = select(vips[i], int(dport[i]), int(fh[i]))
        assert bool(found[i]) == (be is not None)


@pytest.mark.parametrize("v6", [False, True])
def test_lb_select_hand_built_tables(v6):
    """Duplicate VIP rows (the first wins), counts of -1 and 0 (one
    backend), counts past the backend columns (the reference's gather
    clamps the index), invalid rows."""
    w, s, b = (4 if v6 else 1), 6, 2
    rng = np.random.default_rng(3)
    vips = np.array([[7, 7, 8, 9, 7, 10]] * w, np.int32)
    ports = np.array([80, 80, 0, 80, 0, 443], np.int32)
    counts = np.array([5, 1, -1, 0, 2, 3], np.int32)
    revnat = np.arange(1, s + 1, dtype=np.int32)
    bt = rng.integers(-(1 << 31), 1 << 31, (w, s, b)).astype(np.int32)
    bp = rng.integers(1, 65536, (s, b)).astype(np.int32)
    valid = np.array([True, True, True, True, True, False])
    f = 64
    qv = [rng.choice([7, 8, 9, 10, 11], f).astype(np.int32) for _ in range(w)]
    for q in qv[1:]:
        q[:] = qv[0]
    dport = rng.choice([0, 80, 443], f).astype(np.int32)
    fh = rng.integers(-(1 << 31), 1 << 31, f).astype(np.int32)
    if v6:
        dlb = lbmap.DeviceLb6Map.from_arrays(vips, ports, counts, revnat, bt, bp, valid, CPU)
        ref = ref_lbmap.DeviceLb6Map(*(jnp.asarray(a) for a in (vips, ports, counts, revnat, bt, bp, valid)))
        got = lbmap.lb6_select_backend_batch(dlb, qv, dport, fh)
        want = ref_lbmap.lb6_select_backend_batch(ref, qv, dport, fh)
        want = (np.asarray(want[0]), tuple(np.asarray(x) for x in want[1]), np.asarray(want[2]),
                np.asarray(want[3]))
    else:
        dlb = lbmap.DeviceLbMap.from_arrays(vips[0], ports, counts, revnat, bt[0], bp, valid, CPU)
        ref = ref_lbmap.DeviceLbMap(*(jnp.asarray(a) for a in (vips[0], ports, counts, revnat, bt[0], bp, valid)))
        got = lbmap.lb4_select_backend_batch(dlb, qv[0], dport, fh)
        want = tuple(np.asarray(x) for x in ref_lbmap.lb4_select_backend_batch(ref, qv[0], dport, fh))
    _equal(got, want)


def test_device_maps_export_like_jax():
    rng = random.Random(5)
    for v6 in (False, True):
        ref, port = _lb_maps(rng, v6)
        if v6:
            a, r = port.to_device6(device=CPU), ref.to_device6()
            pairs = [("vip_words", "vip_words"), ("b_target_words", "b_target_words")]
        else:
            a, r = port.to_device(device=CPU), ref.to_device()
            pairs = [("vips", "vips"), ("b_target", "b_target")]
        pairs += [(n, n) for n in ("ports", "counts", "revnat", "b_port", "valid")]
        for mine, theirs in pairs:
            np.testing.assert_array_equal(_np(getattr(a, mine)), np.asarray(getattr(r, theirs)))
        with pytest.raises(ValueError):
            (port.to_device6 if v6 else port.to_device)(max_backends=1, device=CPU)
    assert lbmap.LbMap().to_device(device=CPU).valid.tolist() == [False]  # an empty map: one padding row


def test_flow_hashes_wrap_like_jax():
    rng = np.random.default_rng(9)
    cols = [rng.integers(-(1 << 31), 1 << 31, 500).astype(np.int32) for _ in range(13)]
    cols[0][:4] = [-(1 << 31), (1 << 31) - 1, -1, 0]
    t = [torch.from_numpy(c) for c in cols]
    got = flow_hash32(*t[:5])
    assert got.dtype == torch.int32
    want = np.asarray(ref_pipeline.flow_hash32(*(jnp.asarray(c) for c in cols[:5])))
    np.testing.assert_array_equal(got.numpy(), want)
    with np.errstate(over="ignore"):
        np.testing.assert_array_equal(got.numpy(), flow_hash32(*cols[:5]))
    got6 = flow_hash32_v6(t[0:4], t[4:8], *t[8:11])
    want6 = ref_pipeline6.flow_hash32_v6(
        tuple(jnp.asarray(c) for c in cols[0:4]), tuple(jnp.asarray(c) for c in cols[4:8]),
        *(jnp.asarray(c) for c in cols[8:11]))
    np.testing.assert_array_equal(got6.numpy(), np.asarray(want6))


def test_table_builders_need_a_device_or_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None means it")
    with pytest.raises(RuntimeError):
        maplookup.pack_table(np.zeros((1, 1)), np.zeros((1, 1)))
    with pytest.raises(RuntimeError):
        lpm.build_lpm([("10.0.0.0/8", 1)])
    with pytest.raises(RuntimeError):
        policymap.PolicyMap().to_device()
    with pytest.raises(RuntimeError):
        lbmap.LbMap().to_device()
