"""The map lookups K12 ``lpm_lookup`` and K13 ``exact_lookup``,
``policy_can_access``, ``lb_select`` on the hashed indexes their tables
carry (``cilium_tpu_torch/ops/l34_index.py``), on the CPU.

(a) Every table class builds its index once, when it is made, and the
snapshots of K14 / K15 (``DatapathTables``, ``IngressTables``) hold the
same tensors and build none.  (b) A walk of the LPM index written here,
probe for probe as ``csrc/lpm.cu`` runs it (L lanes an address, each
taking every L-th mask group, G groups a round, best first, the early stop
tested before a round and group by group inside it, the lanes merged),
equals ``lpm_lookup_plain`` for G of 2, 4, 8 and 16 at one lane and for
lane groups of 2 to 8, on
``tests/l34_index_cases.py``'s prefix tables and on tables of many mask
groups (256 v6 prefixes of every length /32-/128: about 90 groups).  (c)
On the same tables converted from numpy leaves, the port's
``lpm_lookup``, ``exact_lookup`` (a wide table whose slots hold the row
id among them), ``policy_can_access_batch`` and
``lb{4,6}_select_backend_batch`` at device="cpu" equal the JAX functions,
and the walks of the index equal them too.  Every output is bool or int:
the tolerance is 0.
"""

from __future__ import annotations

import random
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import l34_index_cases as cases
import l34_worlds as worlds
from cilium_tpu.maps import lbmap as ref_lbmap
from cilium_tpu.maps import policymap as ref_policymap
from cilium_tpu.ops import lpm as ref_lpm
from cilium_tpu.ops import maplookup as ref_ml
from cilium_tpu_torch import convert
from cilium_tpu_torch.datapath import ingress, pipeline, pipeline6
from cilium_tpu_torch.maps import ctmap, ipcache, lbmap, lxcmap, policymap
from cilium_tpu_torch.ops import l34_index, lpm, maplookup

CPU = "cpu"
# (lanes an address, mask groups a round) of csrc/lpm.cu's probe: the G
# sweep at one lane, and lane groups
VARIANTS = [(1, 2), (1, 4), (1, 8), (1, 16), (2, 1), (2, 2), (4, 2), (8, 1)]
PORT = SimpleNamespace(CtMap=ctmap.CtMap, CtKey4=ctmap.CtKey4, CtKey6=ctmap.CtKey6, LbMap=lbmap.LbMap,
                       IpcacheMap=ipcache.IpcacheMap, PolicyMap=policymap.PolicyMap,
                       LxcMap=lxcmap.LxcMap, EndpointInfo=lxcmap.EndpointInfo)


@pytest.fixture(autouse=True, scope="module")
def _reference_leak_guard():
    """Reference tests leave a dummy HTTP rule parser registered and a
    FlightRecorder installed (ROADMAP Queue 3): put the real parser back
    and uninstall every recorder, before and after this module."""
    from cilium_tpu.proxylib.parser import register_l7_rule_parser
    from cilium_tpu.proxylib.parsers.http import http_rule_parser
    from cilium_tpu.sidecar import blackbox as ref_bb
    from cilium_tpu_torch.sidecar import blackbox as port_bb

    def clean():
        register_l7_rule_parser("http", http_rule_parser)
        for bb in (ref_bb, port_bb):
            for rec in list(bb._RECORDERS):
                rec.uninstall()

    clean()
    yield
    clean()


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _equal(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, tuple):
            _equal(tuple(g), w)
            continue
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = w.numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w)


# --- the probes, as csrc/l34_index.cuh and csrc/lpm.cu run them ----------------


def _bucket(ix, q):
    """Every (slot [F, S], matched [F]) of the buckets of keys q, in bucket
    order; the first slot is read whether or not the bucket is empty."""
    h = l34_index.hash32(q) & (ix.buckets - 1)
    b = ix.bounds[h].to(torch.int64)
    lo, hi = b[:, 0], b[:, 1]
    assert lo.numel() == 0 or int(lo.max()) < ix.slots.shape[0]  # the first-slot load stays in bounds
    for j in range(max(int((hi - lo).max()) if lo.numel() else 0, 1)):
        i = lo + j
        live = i < hi
        s = ix.slots[torch.where(live, i, lo)]
        m = live
        for c, qc in enumerate(q):
            m = m & (s[:, c] == qc)
        yield s, m


def lpm_rounds(lix, words, lanes, g_round):
    """csrc/lpm.cu's probe with ``lanes`` lanes an address and G =
    ``g_round`` mask groups a round: lane l takes groups l, l + lanes, ...,
    best first; a round starts only while the lane has a group left and the
    best score it found does not beat the round's first group, and inside
    it a group is tested only where that best (so far in the round) does not
    beat the group's best; then the lanes merge (the best score, the largest
    value at it).  Returns (found, value, plen, rounds each address ran on
    its busiest lane)."""
    w, f = len(words), words[0].shape[0]
    g = lix.groups.to(torch.int64)
    rows = g.shape[0]
    bests, vals, rounds = [], [], torch.zeros(f, dtype=torch.int64)
    for lane in range(lanes):
        best = torch.zeros(f, dtype=torch.int64)
        val = torch.full((f,), -(1 << 31), dtype=torch.int64)
        alive = torch.ones(f, dtype=torch.bool)
        ran = torch.zeros(f, dtype=torch.int64)
        for gi in range(lane, rows + g_round * lanes, g_round * lanes):
            ids = list(range(gi, gi + g_round * lanes, lanes))
            gb = [int(g[j, 0]) if j < rows else 0 for j in ids]
            alive &= (gb[0] > 0) & ~(best > gb[0])
            ran += alive.to(torch.int64)
            for j, bj in zip(ids, gb):
                if bj <= 0:
                    continue
                q = [torch.full((f,), j, dtype=torch.int32)] + \
                    [(words[c] & int(g[j, 1 + c])).to(torch.int32) for c in range(w)]
                test = alive & ~(best > bj)
                for s, m in _bucket(lix.table, q):
                    m = m & test
                    sc, v = s[:, w + 1].to(torch.int64), s[:, w + 2].to(torch.int64)
                    val = torch.where(m & (sc > best), v, torch.where(m & (sc == best), torch.maximum(val, v), val))
                    best = torch.where(m & (sc > best), sc, best)
            if gb[-1] <= 0:
                break
        bests.append(best)
        vals.append(val)
        rounds = torch.maximum(rounds, ran)
    best = torch.stack(bests).max(0).values
    val = torch.stack([torch.where(b == best, v, -(1 << 31)) for b, v in zip(bests, vals)]).max(0).values
    found = best > 0
    return (found, torch.where(found, val, 0).to(torch.int32), torch.where(found, best - 1, -1).to(torch.int32),
            rounds)


def walk_exact(table, q):
    """csrc/l34_tables.cu exact_kernel: one probe; the values from the
    slots, or (a wide table) from the rows whose ids the slots hold."""
    ix, k, v = table.index, len(q), table.values.shape[1]
    nv = maplookup.slot_values(k, v)
    f = q[0].shape[0]
    found = torch.zeros(f, dtype=torch.bool)
    acc = torch.zeros((f, v), dtype=torch.int64)
    for s, m in _bucket(ix, q):
        found |= m
        rows = s[:, k + nv].to(torch.int64)
        vals = s[:, k:k + v] if nv == v else table.values[torch.where(m, rows, 0)]
        acc += torch.where(m[:, None], vals.to(torch.int64), 0)
    return found, maplookup.wrap32(acc)


def walk_policy(dmap, ident, dport, proto, direction):
    zero, d = torch.zeros_like(ident), torch.full_like(ident, direction)
    f1, v1 = walk_exact(dmap.table, [ident, dport, proto, d])
    f2, _ = walk_exact(dmap.table, [ident, zero, zero, d])
    f3, v3 = walk_exact(dmap.table, [zero, dport, proto, d])
    return f1 | f2 | f3, torch.where(f1, v1[:, 0], torch.where(f2, 0, torch.where(f3, v3[:, 0], 0)))


# --- (a) the tables carry their index, built once ------------------------------


@pytest.fixture
def builds(monkeypatch):
    """Counts of the index builds, by build function, from here on."""
    counts = {"exact_index": 0, "lpm_index": 0, "lb_index": 0}
    for mod, name in ((maplookup, "exact_index"), (lpm, "lpm_index"), (lbmap, "lb_index")):
        real = getattr(mod, name)

        def counted(*a, _real=real, _name=name, **kw):
            counts[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(mod, name, counted)
    return counts


def _same_index(a, b) -> bool:
    if isinstance(a, l34_index.LpmIndex):
        return a.groups is b.groups and _same_index(a.table, b.table)
    return a.bounds is b.bounds and a.slots is b.slots


@pytest.mark.parametrize("family", ["datapath", "datapath6"])
def test_datapath_tables_reuse_their_tables_indexes(family, builds):
    rng = random.Random(3)
    if family == "datapath":
        ct, lb, ipc, pol, _ = worlds.egress4_world(PORT, rng, worlds.Clock())
        t = pipeline.build_tables(ct, lb, ipc, pol, device=CPU)
    else:
        ct, lb, ipc, pol, _ = worlds.egress6_world(PORT, rng, worlds.Clock())
        t = pipeline6.build_tables6(ct, lb, ipc, pol, device=CPU)
    assert builds == {"exact_index": 2, "lpm_index": 1, "lb_index": 1}  # CT and policy, ipcache, LB
    parts = {"ct": t.ct.index, "lb": t.lb.index, "ipcache": t.ipcache.index, "policy": t.policy.table.index}
    for name, own in parts.items():
        assert _same_index(getattr(t.index, name), own), name
    t.__post_init__()  # a snapshot made again from its tables builds nothing
    assert builds == {"exact_index": 2, "lpm_index": 1, "lb_index": 1}


def test_ingress_tables_reuse_their_tables_indexes(builds):
    maps = worlds.node_world(PORT, random.Random(4), worlds.Clock())
    t = ingress.build_ingress_tables(*maps, device=CPU)
    assert builds == {"exact_index": 3, "lpm_index": 2, "lb_index": 0}  # lxc, CT, policy; two ipcaches
    for name, own in (("ipcache_id", t.ipcache_id.index), ("ipcache_tun", t.ipcache_tun.index),
                      ("lxc", t.lxc.index), ("ct", t.ct.index), ("policy", t.policy.table.index)):
        assert _same_index(getattr(t.index, name), own), name


@pytest.mark.parametrize("w", [1, 4])
def test_converted_snapshot_builds_one_index_a_table(w, builds):
    rng = np.random.default_rng(5 + w)
    conv = convert.datapath_tables_from_numpy if w == 1 else convert.datapath_tables6_from_numpy
    t = conv(cases.datapath_leaves(rng, w), device=CPU)
    assert builds == {"exact_index": 2, "lpm_index": 1, "lb_index": 1}
    # each index has the slots its kernels read: CT and policy (K = 4) with
    # their one value column, the LB's key and row id, the LPM's group,
    # words, score and value
    assert t.index.ct.width == l34_index.slot_words(2 * w + 3 + 1 + 1)
    assert t.index.policy.width == 8 and t.index.lb.width == l34_index.slot_words(w + 2)
    assert t.index.ipcache.table.width == l34_index.slot_words(w + 3)


def _widened(table, v, seed):
    """``table`` with value columns past its own up to ``v``, random."""
    n, v0 = table.values.shape
    extra = torch.from_numpy(cases.i32(np.random.default_rng(seed).integers(0, 1 << 32, (n, v - v0))))
    return maplookup.DeviceTable(keys=table.keys, values=torch.cat([table.values, extra], 1), valid=table.valid)


@pytest.mark.parametrize("name,v", [("policy", 4), ("policy", 12), ("ct", 3), ("ct", 12), ("lxc", 7), ("lxc", 15)])
def test_snapshots_take_tables_of_any_value_width(name, v):
    """K14 and K15 read value column 0 of a policy row and columns 0 and 1
    of an endpoint row from the index slots, or, where the values do not
    fit a slot, from the row whose id the slot holds: a snapshot takes
    tables of any number of value columns, and the passes answer as they
    do on the narrow tables."""
    rng = random.Random(6)
    if name == "lxc":
        t = ingress.build_ingress_tables(*worlds.node_world(PORT, rng, worlds.Clock()), device=CPU)
        p = worlds.node_packets(rng, 1500)
        args = (ingress.MODE_NETDEV, *(_t(p[k]) for k in ("saddr", "daddr", "sport", "dport", "proto")),
                _t(p["src_id"]))
        wide = ingress.IngressTables(ipcache_id=t.ipcache_id, ipcache_tun=t.ipcache_tun,
                                     lxc=_widened(t.lxc, v, 7), ct=t.ct, policy=t.policy)
        table, run = wide.lxc, ingress.ingress
    else:
        ct, lb, ipc, pol, flows = worlds.egress4_world(PORT, rng, worlds.Clock())
        t = pipeline.build_tables(ct, lb, ipc, pol, device=CPU)
        sa, da, *rest = worlds.egress4_packets(rng, 1500, flows)
        args = ((_t(sa),), (_t(da),), *(_t(x) for x in rest))
        parts = {"ct": t.ct, "policy": t.policy}
        if name == "ct":
            parts["ct"] = table = _widened(t.ct, v, 7)
        else:
            parts["policy"] = policymap.DevicePolicyMap(table=_widened(t.policy.table, v, 7))
            table = parts["policy"].table
        wide = pipeline.DatapathTables(lb=t.lb, ipcache=t.ipcache, **parts)
        run = pipeline.datapath_pass
    k = table.keys.shape[0]
    assert table.index.width == l34_index.slot_words(k + maplookup.slot_values(k, v) + 1)
    got, want = run(wide, *args), run(t, *args)
    assert got.keys() == want.keys()
    for key in want:
        _equal(tuple(got[key]) if isinstance(want[key], tuple) else got[key],
               tuple(want[key]) if isinstance(want[key], tuple) else want[key])


@pytest.mark.parametrize("k,v,nv", [(5, 1, 1), (11, 1, 1), (11, 4, 4), (11, 5, 0), (11, 8, 0), (4, 11, 11),
                                    (4, 12, 0), (1, 2, 2), (1, 14, 14), (1, 15, 0)])
def test_slot_values_fit_sixteen_words(k, v, nv):
    assert maplookup.slot_values(k, v) == nv
    rng = np.random.default_rng(k * 16 + v)
    cols, values, valid = cases.exact_table(rng, k, 40, nv=v, pool=8)
    table = maplookup.table_from_arrays(list(cols), values, valid, CPU)
    assert table.index.width == l34_index.slot_words(k + nv + 1) <= 16


# --- (b) the G-group LPM probe against the plain version -----------------------

LPMS = cases.lpm_cases(np.random.default_rng(12), 1) + cases.lpm_cases(np.random.default_rng(13), 4)
MANY = [(f"many{w}-{n}", *cases.many_group_lpm(np.random.default_rng(100 + n + w), w, n))
        for w, n in ((4, 256), (1, 1024), (4, 40))]


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("case", LPMS + MANY, ids=[c[0] for c in LPMS + MANY])
def test_lpm_rounds_equal_plain(case, variant):
    name, words, masks, plen, values, valid = case
    lanes, g_round = variant
    table = lpm.lpm_from_arrays(words, masks, plen, values, valid, CPU)
    rng = np.random.default_rng(17)
    a = [_t(x) for x in cases.addr_queries(rng, words, masks, 1500)]
    a = [torch.cat([x, _t(y)]) for x, y in zip(a, cases.lpm_sources(rng, words, masks, 500))]
    found, value, plen_, rounds = lpm_rounds(table.index, a, lanes, g_round)
    want = lpm.lpm_lookup_plain(table, *a)
    _equal((found, value, plen_), want)
    if name.startswith("many"):
        n_groups = table.index.n_groups
        assert bool(found.any()) and not bool(found.all())
        # a miss probes every group (its busiest lane ceil(groups / lanes)
        # of them); the early stop ends most hits sooner
        assert int(rounds[~found].max()) == -(-(-(-n_groups // lanes)) // g_round)
        if name == "many4-256":
            assert 85 <= n_groups <= 97


def test_many_group_table_has_its_traps():
    """256 v6 prefixes of every length /32-/128: about 90 mask groups,
    duplicate prefixes with equal and other values, invalid rows, rows that
    can never be selected (bits outside the mask, plen -1)."""
    words, masks, plen, values, valid = MANY[0][1:]
    keys = {(tuple(words[:, i]), tuple(masks[:, i])) for i in range(words.shape[1])}
    assert len(keys) < words.shape[1]  # duplicate prefixes
    clean = ((words & ~masks) == 0).all(0)
    assert (~valid).any() and (~clean).any() and (plen == -1).any()
    table = lpm.lpm_from_arrays(words, masks, plen, values, valid, CPU)
    selectable = int((valid & clean & (plen >= 0)).sum())
    assert int(table.index.table.m) == selectable


# --- (c) the port's lookups against the JAX functions --------------------------


def _ref_lpm(words, masks, plen, values, valid):
    return ref_lpm.DeviceLpm(tuple(jnp.asarray(x) for x in words), tuple(jnp.asarray(x) for x in masks),
                             jnp.asarray(plen), jnp.asarray(values), jnp.asarray(valid))


@pytest.mark.parametrize("case", LPMS + MANY, ids=[c[0] for c in LPMS + MANY])
def test_lpm_lookup_matches_jax(case):
    _, words, masks, plen, values, valid = case
    table = lpm.lpm_from_arrays(words, masks, plen, values, valid, CPU)
    a = cases.lpm_sources(np.random.default_rng(19), words, masks, 700, inside=0.5)
    want = tuple(np.asarray(x) for x in ref_lpm.lpm_lookup(_ref_lpm(words, masks, plen, values, valid), *a))
    _equal(lpm.lpm_lookup(table, *a), want)
    _equal(lpm_rounds(table.index, [_t(x) for x in a], 2, 2)[:3], want)


EXACT = cases.exact_cases(np.random.default_rng(21)) + [("wide", *cases.wide_table(np.random.default_rng(22)))]


@pytest.mark.parametrize("case", EXACT, ids=[c[0] for c in EXACT])
def test_exact_lookup_matches_jax(case):
    name, cols, values, valid = case
    table = maplookup.table_from_arrays(list(cols), values, valid, CPU)
    ref = ref_ml.DeviceTable(tuple(jnp.asarray(c) for c in cols), jnp.asarray(values), jnp.asarray(valid))
    q = cases.key_queries(np.random.default_rng(23), cols, 1200)
    want = tuple(np.asarray(x) for x in ref_ml.exact_lookup(ref, *q))
    _equal(maplookup.exact_lookup(table, *q), want)
    _equal(walk_exact(table, [_t(x) for x in q]), want)
    if name == "wide":
        assert table.index.width == 16 and maplookup.slot_values(11, 8) == 0
        assert bool(want[0].any()) and len(np.unique(want[1][want[0]], axis=0)) > 3


@pytest.mark.parametrize("direction", [0, 1])
@pytest.mark.parametrize("nv", [1, 3, 12])
def test_policy_can_access_matches_jax(nv, direction):
    """Duplicate keys (their values sum), identity 0 (the three keys can
    coincide), one value column or more; 12 columns do not fit a slot, so
    the kernel reads column 0 from the row."""
    rng = np.random.default_rng(24 + nv + direction)
    leaves = cases._policy_leaves(rng, np.array([5, 9, 300]), direction)
    vals = np.concatenate([leaves[4], cases.i32(rng.integers(0, 1 << 32, (leaves[4].shape[0], nv - 1)))], 1)
    dmap = policymap.DevicePolicyMap(table=maplookup.table_from_arrays(leaves[:4], vals, leaves[5], CPU))
    ref = ref_policymap.DevicePolicyMap(
        ref_ml.DeviceTable(tuple(jnp.asarray(c) for c in leaves[:4]), jnp.asarray(vals), jnp.asarray(leaves[5])))
    q = cases.key_queries(rng, np.stack(leaves[:4]), 1500)
    q[0][:200] = 0
    want = tuple(np.asarray(x) for x in ref_policymap.policy_can_access_batch(ref, *q[:3], direction))
    _equal(policymap.policy_can_access_batch(dmap, *q[:3], direction), want)
    _equal(walk_policy(dmap, *(_t(x) for x in q[:3]), direction), want)
    assert bool(want[0].any()) and not bool(want[0].all())


@pytest.mark.parametrize("w", [1, 4])
def test_lb_select_matches_jax(w):
    rng = np.random.default_rng(26 + w)
    leaves = cases.lb_arrays(rng, w, s=40)
    f = 1500
    vw = np.asarray(leaves[0]).reshape(w, -1)
    pick = rng.integers(0, vw.shape[1], f)
    vips = [np.where(rng.random(f) < 0.8, vw[c, pick], 0).astype(np.int32) for c in range(w)]
    dport = rng.choice(np.array([0, 80, 443, 8080], np.int32), f)
    fh = cases.i32(rng.integers(0, 1 << 32, f, dtype=np.int64))
    if w == 1:
        dlb = lbmap.DeviceLbMap.from_arrays(*leaves, CPU)
        ref = ref_lbmap.DeviceLbMap(*(jnp.asarray(a) for a in leaves))
        got = lbmap.lb4_select_backend_batch(dlb, vips[0], dport, fh)
        want = tuple(np.asarray(x) for x in ref_lbmap.lb4_select_backend_batch(ref, vips[0], dport, fh))
    else:
        dlb = lbmap.DeviceLb6Map.from_arrays(*leaves, CPU)
        ref = ref_lbmap.DeviceLb6Map(*(jnp.asarray(a) for a in leaves))
        got = lbmap.lb6_select_backend_batch(dlb, vips, dport, fh)
        r = ref_lbmap.lb6_select_backend_batch(ref, vips, dport, fh)
        want = (np.asarray(r[0]), tuple(np.asarray(x) for x in r[1]), np.asarray(r[2]), np.asarray(r[3]))
    _equal(got, want)
    assert bool(want[0].any()) and not bool(want[0].all())
