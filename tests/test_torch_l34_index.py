"""The hashed table indexes of K14 and K15 (``cilium_tpu_torch/ops/
l34_index.py``) on the CPU.

(a) The index invariants on fuzzed tables (``tests/l34_index_cases.py``):
every valid row lies in the bucket of its key's hash, in row order; no
invalid row is indexed, and no prefix row that can never be selected; the
bucket bounds are monotone and end at the number of indexed rows.
(b) The torch hash equals a pure-Python uint32 MurmurHash3 on fixed
vectors.  (c) A walk of the index written here, probe for probe as
``csrc/l34_index.cuh`` runs it (bucket bounds, the bucket's slots, the
mask groups best first with the early stop), equals the plain lookups.
(d) The port's ``datapath_verdicts``, ``datapath_verdicts6``,
``netdev_verdicts`` and ``overlay_verdicts`` at device="cpu", on tables
converted from the JAX tables' numpy leaves, equal the JAX functions, and
so does that walk composed as K14 and K15 compose it, on the worlds of
``tests/l34_worlds.py`` and on the adversarial tables.  Every output is
bool or int: the tolerance is 0.
"""

from __future__ import annotations

import random
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import l34_index_cases as cases
import l34_worlds as worlds
from cilium_tpu.datapath import ingress as ref_ingress
from cilium_tpu.datapath import pipeline as ref_pipeline
from cilium_tpu.datapath import pipeline6 as ref_pipeline6
from cilium_tpu.maps import ctmap as ref_ctmap
from cilium_tpu.maps import ipcache as ref_ipcache
from cilium_tpu.maps import lbmap as ref_lbmap
from cilium_tpu.maps import lxcmap as ref_lxcmap
from cilium_tpu.maps import policymap as ref_policymap
from cilium_tpu_torch import convert
from cilium_tpu_torch.datapath import ingress, pipeline
from cilium_tpu_torch.datapath.pipeline import flow_hash32, flow_hash32_v6
from cilium_tpu_torch.maps.lbmap import DeviceLb6Map, DeviceLbMap, lb_select_plain
from cilium_tpu_torch.maps.policymap import DevicePolicyMap, policy_can_access_plain
from cilium_tpu_torch.ops import l34_index
from cilium_tpu_torch.ops.lpm import lpm_from_arrays, lpm_lookup_plain
from cilium_tpu_torch.ops.maplookup import exact_lookup_plain, slot_values, table_from_arrays, wrap32

CPU = "cpu"
M32 = 0xFFFFFFFF
REF = SimpleNamespace(CtMap=ref_ctmap.CtMap, CtKey4=ref_ctmap.CtKey4, CtKey6=ref_ctmap.CtKey6,
                      LbMap=ref_lbmap.LbMap, IpcacheMap=ref_ipcache.IpcacheMap,
                      PolicyMap=ref_policymap.PolicyMap, LxcMap=ref_lxcmap.LxcMap,
                      EndpointInfo=ref_lxcmap.EndpointInfo)


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


# --- the walk of the index, as csrc/l34_index.cuh probes it -------------------


def _visit(ix, q):
    """Every (slot [F, S], matched [F]) position of the buckets of keys q
    (K [F] int32 tensors), in bucket order; the first slot is read whether
    or not the bucket is empty, as the kernels read it."""
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


def walk_exact(ix, q, nv, table=None):
    """(found, [F, nv] int32-wrapped sums of the matched rows' first nv
    values): from the slots, or, where ``table``'s values do not fit them,
    from the table rows whose ids the slots hold."""
    k, f = len(q), q[0].shape[0]
    wide = table is not None and slot_values(k, table.values.shape[1]) == 0
    found = torch.zeros(f, dtype=torch.bool)
    acc = torch.zeros((f, nv), dtype=torch.int64)
    for s, m in _visit(ix, q):
        found |= m
        vals = table.values[torch.where(m, s[:, k], 0).to(torch.int64), :nv] if wide else s[:, k:k + nv]
        acc += torch.where(m[:, None], vals.to(torch.int64), 0)
    return found, wrap32(acc)


def walk_first(ix, q):
    """The row id of the first matched slot, -1 for none (the LB)."""
    k, f = len(q), q[0].shape[0]
    first = torch.full((f,), -1, dtype=torch.int64)
    for s, m in _visit(ix, q):
        first = torch.where(m & (first < 0), s[:, k].to(torch.int64), first)
    return first


def walk_lpm(lix, words):
    """lpm_finish: mask groups two at a time, best first, until the best
    score a packet found beats the next group's."""
    w, f = len(words), words[0].shape[0]
    g = lix.groups.to(torch.int64)
    best = torch.zeros(f, dtype=torch.int64)
    val = torch.full((f,), -(1 << 31), dtype=torch.int64)
    alive = torch.ones(f, dtype=torch.bool)
    for gi in range(0, g.shape[0] - 1, 2):
        alive &= (g[gi, 0] > 0) & ~(best > g[gi, 0])
        for j in (gi, gi + 1):
            q = [torch.full((f,), j, dtype=torch.int32)] + [words[c] & int(g[j, 1 + c]) for c in range(w)]
            q = [x.to(torch.int32) if x.dtype != torch.int32 else x for x in q]
            for s, m in _visit(lix.table, q):
                m = m & alive
                sc, v = s[:, w + 1].to(torch.int64), s[:, w + 2].to(torch.int64)
                val = torch.where(m & (sc > best), v, torch.where(m & (sc == best), torch.maximum(val, v), val))
                best = torch.where(m & (sc > best), sc, best)
        if g[gi + 1, 0] <= 0:
            break
    found = best > 0
    return found, torch.where(found, val, 0).to(torch.int32), torch.where(found, best - 1, -1).to(torch.int32)


def walk_policy(ix, ident, dport, proto, direction, table=None):
    zero, d = torch.zeros_like(ident), torch.full_like(ident, direction)
    f1, v1 = walk_exact(ix, [ident, dport, proto, d], 1, table)
    f2, _ = walk_exact(ix, [ident, zero, zero, d], 1, table)
    f3, v3 = walk_exact(ix, [zero, dport, proto, d], 1, table)
    return f1 | f2 | f3, torch.where(f1, v1[:, 0], torch.where(f2, 0, torch.where(f3, v3[:, 0], 0)))


def walk_lb(lb, ix, vip_words, dport, fh):
    w = len(vip_words)
    i4 = walk_first(ix, [*vip_words, dport])
    i3 = walk_first(ix, [*vip_words, torch.zeros_like(dport)])
    found = (i4 >= 0) | (i3 >= 0)
    idx = torch.where(i4 >= 0, i4, torch.where(i3 >= 0, i3, 0))
    count = lb.counts[idx].to(torch.int64).clamp(min=1)
    b = lb.b_port.shape[1]
    slave = torch.minimum((fh.to(torch.int64) & M32) % count, torch.tensor(b - 1))
    target = tuple(torch.where(found, lb.b_target_words[c][idx, slave], 0) for c in range(w))
    return (found, target, torch.where(found, lb.b_port[idx, slave], 0),
            torch.where(found, lb.revnat[idx], 0))


def walk_datapath(t, sw, dw, sport, dport, proto):
    """K14's pass through the index (csrc/datapath.cu)."""
    w, ix = t.w, t.index
    fh = flow_hash32(sw[0], dw[0], sport, dport, proto) if w == 1 else \
        flow_hash32_v6(sw, dw, sport, dport, proto)
    svc, be, be_port, rev = walk_lb(t.lb, ix.lb, dw, dport, fh)
    nd = tuple(torch.where(svc, be[c], dw[c]) for c in range(w))
    ndport = torch.where(svc, be_port, dport)
    est, _ = walk_exact(ix.ct, [*nd, *sw, ndport, sport, proto], 0)
    ip_found, ident, _ = walk_lpm(ix.ipcache, nd)
    dst = torch.where(ip_found, ident, pipeline.WORLD_ID)
    allowed, proxy = walk_policy(ix.policy, dst, ndport, proto, 1, t.policy.table)
    ok = est | allowed
    zero = torch.zeros_like(dst)
    return {"verdict": torch.where(ok, torch.where((proxy > 0) & ~est, 2, 0), 1).to(torch.int32),
            "new_daddr_words": nd, "new_dport": ndport, "dst_identity": dst,
            "proxy_port": torch.where(est, zero, proxy), "rev_nat": torch.where(svc, rev, zero),
            "tunnel_endpoint": zero, "established": est, "needs_ct_create": ok & ~est}


def walk_ingress(t, mode, saddr, daddr, sport, dport, proto, src):
    """K15's pass through the index (csrc/ingress.cu)."""
    ix = t.index
    src_id = src
    if mode == ingress.MODE_NETDEV:
        found, sec, _ = walk_lpm(ix.ipcache_id, [saddr])
        reserved = (src >= 0) & (src <= ingress.RESERVED_ID_MAX)
        src_id = torch.where(reserved & found & (sec != 0) & (sec != ingress.HOST_ID), sec,
                             torch.where(reserved & (src == 0), pipeline.WORLD_ID, src))
    is_local, lxc = walk_exact(ix.lxc, [daddr], 2, t.lxc)
    is_host = is_local & ((lxc[:, 1] & 1) != 0)
    est = walk_exact(ix.ct, [daddr, saddr, dport, sport, proto], 0)[0] | \
        walk_exact(ix.ct, [saddr, daddr, sport, dport, proto], 0)[0]
    allowed, proxy = walk_policy(ix.policy, src_id, dport, proto, 0, t.policy.table)
    tun_found, tunnel, _ = walk_lpm(ix.ipcache_tun, [daddr])
    ok = est | allowed
    local = torch.where(ok, torch.where((proxy > 0) & ~est, 2, 0), 1)
    remote = torch.where(tun_found & (tunnel != 0), 4, 0)
    delivered = is_local & ~is_host
    zero = torch.zeros_like(src_id)
    return {"verdict": torch.where(is_host, 3, torch.where(is_local, local, remote)).to(torch.int32),
            "src_identity": src_id, "lxc_id": torch.where(is_local, lxc[:, 0], zero),
            "tunnel_endpoint": torch.where(~is_local & tun_found, tunnel, zero),
            "proxy_port": torch.where(delivered & ~est, proxy, zero), "established": est & delivered,
            "needs_ct_create": delivered & ok & ~est}


# --- (a) invariants ------------------------------------------------------------


def _check_csr(ix, keep, keys, payload):
    """``keep`` [N] rows indexed, each in its key's bucket in row order,
    with ``payload`` [N, P] as its slot and zeros past P; B sized from N;
    the bounds monotone and ending at the rows indexed; zero slots past
    the last (N + 1 slots in all)."""
    rows = torch.nonzero(keep).reshape(-1)
    m, p, n = rows.numel(), payload.shape[1], keep.numel()
    assert ix.m == m and ix.buckets == l34_index.buckets_for(n) and ix.buckets >= 2 * n
    assert ix.slots.shape[0] == n + 1
    assert ix.bounds.dtype == torch.int32 and ix.slots.dtype == torch.int32
    lo, hi = ix.bounds[:, 0].to(torch.int64), ix.bounds[:, 1].to(torch.int64)
    assert int(lo[0]) == 0 and int(hi[-1]) == m and bool((lo <= hi).all())
    assert torch.equal(lo[1:], hi[:-1])
    assert ix.width == l34_index.slot_words(p) and not bool(ix.slots[m:].any())
    assert not bool(ix.slots[:, p:].any())
    bucket = l34_index.hash32(keys) & (ix.buckets - 1)
    for b in range(ix.buckets):
        want = rows[bucket[rows] == b]  # ascending: table order
        assert torch.equal(ix.slots[int(lo[b]):int(hi[b]), :p], payload[want])


EXACT = cases.exact_cases(np.random.default_rng(11))
LPMS = cases.lpm_cases(np.random.default_rng(12), 1) + cases.lpm_cases(np.random.default_rng(13), 4)


@pytest.mark.parametrize("case", EXACT, ids=[c[0] for c in EXACT])
def test_exact_index_invariants(case):
    _, cols, values, valid = case
    table = table_from_arrays(list(cols), values, valid, CPU)
    nv = values.shape[1]
    ix = l34_index.exact_index(table, nv)
    ids = torch.arange(table.n, dtype=torch.int32)[:, None]
    _check_csr(ix, table.valid, list(table.keys), torch.cat([table.keys.t(), table.values, ids], 1))


@pytest.mark.parametrize("case", LPMS, ids=[c[0] for c in LPMS])
def test_lpm_index_invariants(case):
    _, words, masks, plen, values, valid = case
    lpm = lpm_from_arrays(words, masks, plen, values, valid, CPU)
    lix = l34_index.lpm_index(lpm)
    w = lpm.w
    score = (plen.astype(np.int64) + 1 + (1 << 31)) % (1 << 32) - (1 << 31)
    clean = ((words & ~masks) == 0).all(0)
    keep = valid & clean & (score > 0)
    assert not (keep & ~valid).any() and (score[keep] > 0).all()
    g = lix.groups
    gcount = lix.n_groups
    assert gcount == len({tuple(masks[:, i]) for i in np.flatnonzero(keep)})
    assert g.shape[0] == len(plen) + 2 and not bool(g[gcount:].any())  # zero past the last group
    best = g[:gcount, 0].tolist()
    assert best == sorted(best, reverse=True) and all(b > 0 for b in best)
    gid = np.full(len(plen), -1)
    for i in np.flatnonzero(keep):
        match = [j for j in range(gcount) if tuple(g[j, 1:1 + w].tolist()) == tuple(masks[:, i].tolist())]
        assert len(match) == 1
        gid[i] = match[0]
        assert best[match[0]] >= score[i]
    for j in range(gcount):
        assert best[j] == max(score[i] for i in np.flatnonzero(gid == j))
    gid_t = torch.from_numpy(gid.astype(np.int32))
    payload = torch.cat([gid_t[:, None], lpm.words.t(), _t(score.astype(np.int32))[:, None],
                         lpm.values[:, None]], 1)
    _check_csr(lix.table, _t(keep), [gid_t, *lpm.words], payload)


@pytest.mark.parametrize("w", [1, 4])
def test_lb_index_invariants(w):
    leaves = cases.lb_arrays(np.random.default_rng(14 + w), w, s=40)
    lb = (DeviceLbMap if w == 1 else DeviceLb6Map).from_arrays(*leaves, CPU)
    ix = l34_index.lb_index(lb)
    keys = [*lb.vip_words, lb.ports]
    ids = torch.arange(lb.ports.shape[0], dtype=torch.int32)
    _check_csr(ix, lb.valid, keys, torch.stack([*keys, ids], 1))


# --- (b) the hash ----------------------------------------------------------------


def _murmur3(words) -> int:
    """MurmurHash3 x86_32, seed 0, of the little-endian bytes of ``words``."""
    h = 0
    for word in words:
        k = (word & M32) * 0xCC9E2D51 & M32
        k = ((k << 15) | (k >> 17)) & M32
        k = k * 0x1B873593 & M32
        h ^= k
        h = ((h << 13) | (h >> 19)) & M32
        h = (h * 5 + 0xE6546B64) & M32
    h ^= 4 * len(words)
    h ^= h >> 16
    h = h * 0x85EBCA6B & M32
    h ^= h >> 13
    h = h * 0xC2B2AE35 & M32
    return h ^ (h >> 16)


VECTORS = [[0], [1], [-1], [0x7FFFFFFF], [-(1 << 31)], [0x74736574], [0, 0, 0, 0, 0],
           [0x0A000001, 0xC0A80102, 80, 41000, 6], [-1] * 11, list(range(-5, 6)), [2, 0x0A000000]]


@pytest.mark.parametrize("words", VECTORS)
def test_hash32_is_murmur3(words):
    got = l34_index.hash32([_t(cases.i32([w])) for w in words])
    assert got.dtype == torch.int64 and int(got[0]) == _murmur3(words)


def test_hash32_fixed_values_and_batches():
    # "test" is the bytes of 0x74736574; 0xBA6BD213 is its published MurmurHash3_x86_32 (seed 0)
    assert _murmur3([0x74736574]) == 0xBA6BD213
    rng = np.random.default_rng(15)
    cols = [cases.i32(rng.integers(0, 1 << 32, 500, dtype=np.int64)) for _ in range(5)]
    got = l34_index.hash32([_t(c) for c in cols])
    want = [_murmur3([int(c[i]) for c in cols]) for i in range(500)]
    assert got.tolist() == want and 0 <= int(got.min()) and int(got.max()) <= M32


# --- (c) the walk of the index against the plain lookups -----------------------


@pytest.mark.parametrize("case", EXACT, ids=[c[0] for c in EXACT])
def test_exact_walk_equals_plain(case):
    _, cols, values, valid = case
    rng = np.random.default_rng(16)
    table = table_from_arrays(list(cols), values, valid, CPU)
    q = [_t(x) for x in cases.key_queries(rng, cols, 2000)]
    found, vals = walk_exact(l34_index.exact_index(table, values.shape[1]), q, values.shape[1])
    want = exact_lookup_plain(table, *q)
    assert torch.equal(found, want[0]) and torch.equal(vals, want[1])
    assert bool(found.any()) or not valid.any()


@pytest.mark.parametrize("case", LPMS, ids=[c[0] for c in LPMS])
def test_lpm_walk_equals_plain(case):
    _, words, masks, plen, values, valid = case
    lpm = lpm_from_arrays(words, masks, plen, values, valid, CPU)
    a = [_t(x) for x in cases.addr_queries(np.random.default_rng(17), words, masks, 2000)]
    got = walk_lpm(l34_index.lpm_index(lpm), a)
    want = lpm_lookup_plain(lpm, *a)
    for g, wt in zip(got, want):
        assert torch.equal(g, wt)


@pytest.mark.parametrize("direction", [0, 1])
def test_policy_walk_equals_plain(direction):
    rng = np.random.default_rng(18 + direction)
    leaves = cases._policy_leaves(rng, np.array([5, 9, 300]), direction)
    dmap = DevicePolicyMap(table=table_from_arrays(leaves[:4], leaves[4], leaves[5], CPU))
    cols = np.stack(leaves[:4])
    q = cases.key_queries(rng, cols, 3000)
    q[0][:300] = 0  # the identity 0: the three keys can coincide
    args = [_t(x) for x in q[:3]]
    got = walk_policy(l34_index.exact_index(dmap.table, 1), *args, direction)
    want = policy_can_access_plain(dmap, *args, direction)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]) and bool(got[0].any())


@pytest.mark.parametrize("w", [1, 4])
def test_lb_walk_equals_plain(w):
    rng = np.random.default_rng(20 + w)
    leaves = cases.lb_arrays(rng, w, s=30)
    lb = (DeviceLbMap if w == 1 else DeviceLb6Map).from_arrays(*leaves, CPU)
    f = 2000
    pick = rng.integers(0, 30, f)
    vips = [_t(np.where(rng.random(f) < 0.8, lb.vip_words[c].numpy()[pick], 0).astype(np.int32))
            for c in range(w)]
    dport = _t(rng.choice(np.array([0, 80, 443, 8080], np.int32), f))
    fh = _t(cases.i32(rng.integers(0, 1 << 32, f, dtype=np.int64)))
    got = walk_lb(lb, l34_index.lb_index(lb), vips, dport, fh)
    want = lb_select_plain(lb, vips, dport, fh)
    assert torch.equal(got[0], want[0]) and bool(got[0].any())
    for g, wt in zip(got[1], want[1]):
        assert torch.equal(g, wt)
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])


# --- (d) the passes against the JAX functions -----------------------------------


def _equal(got: dict, want) -> None:
    want = {k: (tuple(np.asarray(x) for x in v) if isinstance(v, tuple) else np.asarray(v))
            for k, v in want.items()}
    got = pipeline.host_arrays(got)
    assert got.keys() == want.keys()
    for key, wv in want.items():
        gv = got[key]
        for a, b in zip(gv if isinstance(wv, tuple) else (gv,), wv if isinstance(wv, tuple) else (wv,)):
            assert a.dtype == b.dtype, key
            np.testing.assert_array_equal(a, b, err_msg=key)


def _dp_views(out: dict, w: int) -> dict:
    """A datapath output as datapath_verdicts(6) names it."""
    if w == 4:
        return out
    out = dict(out)
    new = {"verdict": out.pop("verdict"), "new_daddr": out.pop("new_daddr_words")[0]}
    new.update(out)
    return new


def _ref_tables(template, leaves):
    return jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(template),
                                        [jnp.asarray(x) for x in leaves])


def _datapath_case(source, w, seed, f=1024):
    """(JAX tables, numpy leaves, packets) of a world or an adversarial
    snapshot."""
    rng = random.Random(seed)
    if w == 1:
        maps = worlds.egress4_world(REF, rng, worlds.Clock())
        template = ref_pipeline.build_tables(*maps[:4])
    else:
        maps = worlds.egress6_world(REF, rng, worlds.Clock())
        template = ref_pipeline6.build_tables6(*maps[:4])
    if source == "world":
        leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(template)]
        if w == 1:
            sa, da, *rest = worlds.egress4_packets(rng, f, maps[4])
            pk = ((sa,), (da,), *rest)
        else:
            _, _, sw, dw, *rest = worlds.egress6_packets(rng, f, maps[4])
            pk = (sw, dw, *rest)
        return template, leaves, pk
    nrng = np.random.default_rng(seed)
    leaves = cases.datapath_leaves(nrng, w, **SHAPES.get(source, {}))
    if source in cases.WIDE:
        leaves = cases.widen_datapath(np.random.default_rng(seed + 1), leaves, w, **cases.WIDE[source])
    return _ref_tables(template, leaves), leaves, cases.datapath_packets(nrng, leaves, w, f)


SHAPES = {"adversarial": {}, "one-row": {"n": 1}, "all-invalid": {"invalid": True}}
# the adversarial tables with more value columns (cases.WIDE)
SOURCES = ["world", *SHAPES, *cases.WIDE]


@pytest.mark.parametrize("w", [1, 4])
@pytest.mark.parametrize("source", SOURCES)
def test_datapath_matches_jax(source, w):
    ref_t, leaves, (sw, dw, sport, dport, proto) = _datapath_case(source, w, 30 + w)
    conv = convert.datapath_tables_from_numpy if w == 1 else convert.datapath_tables6_from_numpy
    tables = conv(leaves, device=CPU)
    if w == 1:
        want = ref_pipeline.datapath_verdicts(ref_t, sw[0], dw[0], sport, dport, proto)
        got = pipeline.datapath_verdicts(tables, sw[0], dw[0], sport, dport, proto)
    else:
        want = ref_pipeline6.datapath_verdicts6(ref_t, sw, dw, sport, dport, proto)
        from cilium_tpu_torch.datapath import pipeline6

        got = pipeline6.datapath_verdicts6(tables, sw, dw, sport, dport, proto)
    _equal(got, want)
    walked = walk_datapath(tables, tuple(_t(x) for x in sw), tuple(_t(x) for x in dw),
                           *(_t(x) for x in (sport, dport, proto)))
    _equal(_dp_views(walked, w), want)
    host = pipeline.host_arrays(got)
    if source in ("world", "adversarial", *cases.WIDE):
        assert host["established"].any() and host["rev_nat"].any()
        assert (host["verdict"] == pipeline.DROP).any() and (host["verdict"] == pipeline.FORWARD).any()
    if source in cases.WIDE:  # value column 0 of the policy read, through row ids where "wide"
        assert (host["verdict"] == pipeline.TO_PROXY).any()
    if source == "all-invalid":
        assert not host["established"].any() and (host["verdict"] == pipeline.DROP).all()


def _ingress_case(source, seed, f=1024):
    rng = random.Random(seed)
    maps = worlds.node_world(REF, rng, worlds.Clock())
    template = ref_ingress.build_ingress_tables(*maps)
    if source == "world":
        return template, [np.asarray(x) for x in jax.tree_util.tree_leaves(template)], \
            worlds.node_packets(rng, f)
    nrng = np.random.default_rng(seed)
    leaves = cases.ingress_leaves(nrng, **SHAPES.get(source, {}))
    if source in cases.WIDE:
        leaves = cases.widen_ingress(np.random.default_rng(seed + 1), leaves, **cases.WIDE[source])
    return _ref_tables(template, leaves), leaves, cases.ingress_packets(nrng, leaves, f)


@pytest.mark.parametrize("mode", [ingress.MODE_NETDEV, ingress.MODE_OVERLAY])
@pytest.mark.parametrize("source", SOURCES)
def test_ingress_matches_jax(source, mode):
    ref_t, leaves, p = _ingress_case(source, 40 + mode)
    tables = convert.ingress_tables_from_numpy(leaves, device=CPU)
    cols = [p[k] for k in ("saddr", "daddr", "sport", "dport", "proto")]
    src = p["src_id"] if mode == ingress.MODE_NETDEV else p["vni"]
    if mode == ingress.MODE_NETDEV:
        want = ref_ingress.netdev_verdicts(ref_t, *cols, src)
        got = ingress.netdev_verdicts(tables, *cols, src)
    else:
        want = ref_ingress.overlay_verdicts(ref_t, *cols, src)
        got = ingress.overlay_verdicts(tables, *cols, src)
    _equal(got, want)
    _equal(walk_ingress(tables, mode, *(_t(x) for x in cols), _t(src)), want)
    host = pipeline.host_arrays(got)
    if source in ("world", "adversarial", *cases.WIDE):
        assert host["established"].any() and len(np.unique(host["verdict"])) >= 4
    if source in cases.WIDE:  # the endpoint's id and the policy's value column 0 read
        assert host["lxc_id"].any() and host["proxy_port"].any()


def test_tables_carry_their_index():
    """Every constructor builds the index: the builders from host maps and
    the converters from leaves give equal indexes for equal tables."""
    rng = random.Random(50)
    from cilium_tpu_torch.maps import ctmap, ipcache, lbmap, lxcmap, policymap

    port = SimpleNamespace(CtMap=ctmap.CtMap, CtKey4=ctmap.CtKey4, CtKey6=ctmap.CtKey6, LbMap=lbmap.LbMap,
                           IpcacheMap=ipcache.IpcacheMap, PolicyMap=policymap.PolicyMap,
                           LxcMap=lxcmap.LxcMap, EndpointInfo=lxcmap.EndpointInfo)
    maps = worlds.node_world(port, rng, worlds.Clock())
    ref = worlds.node_world(REF, random.Random(50), worlds.Clock())
    own = ingress.build_ingress_tables(*maps, device=CPU)
    conv = convert.ingress_tables_from_numpy(
        [np.asarray(x) for x in jax.tree_util.tree_leaves(ref_ingress.build_ingress_tables(*ref))], device=CPU)
    assert l34_index.nbytes(own.index) > 0
    for a, b in ((own.index.ct, conv.index.ct), (own.index.lxc, conv.index.lxc),
                 (own.index.ipcache_tun.table, conv.index.ipcache_tun.table)):
        assert torch.equal(a.bounds, b.bounds) and torch.equal(a.slots, b.slots)
    # every prefix of the node world is a /24: one mask group, best score 25
    groups = own.index.ipcache_id.groups
    assert groups[0, :2].tolist() == [25, -256] and not bool(groups[1:].any())
