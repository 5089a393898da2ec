"""Adversarial L3/L4 tables and packets for the hashed indexes of K14 and
K15 (``cilium_tpu_torch/ops/l34_index.py``), made with numpy from a seed.

The CPU tests (``tests/test_torch_l34_index.py``), the card tests
(``tests/test_torch_cuda.py``) and ``chip_smoke.py`` draw from here.  The
tables carry every trap of the index: duplicate keys (exact lookups sum
them, the LB takes the first), all-zero keys on valid rows beside
all-zero padding, keys at or above 2^31, invalid rows holding real keys,
tables of one row and tables whose rows are all invalid, one bucket
holding every row, the 11-column v6 CT, and prefix tables with mixed and
irregular masks, words with bits outside their mask, duplicate prefixes
and prefix lengths of -1 and INT32_MAX.  Every array is int32 (addresses
as uint32 bit patterns) or bool; a table's leaves come in the order that
``convert.datapath_tables_from_numpy`` / ``ingress_tables_from_numpy``
take.
"""

from __future__ import annotations

import numpy as np

INT32_MAX = (1 << 31) - 1
WORLD_ID = 2


def i32(a) -> np.ndarray:
    return (np.asarray(a, np.int64) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


def _pool(rng, n) -> np.ndarray:
    """n distinct-ish int32 bit patterns, half of them >= 2^31."""
    return i32(rng.integers(1, 1 << 32, n, dtype=np.int64))


def exact_table(rng, k, n, nv=1, pool=24, zero_rows=2, invalid=0.2):
    """An exact-match table [K, N] drawn from a pool of ``pool`` keys (so
    keys repeat), ``zero_rows`` valid all-zero keys, invalid rows keeping
    real keys and padding rows of zeros.  Returns (cols [K, N], values
    [N, nv], valid [N])."""
    keys = np.stack([_pool(rng, pool) for _ in range(k)], 1)  # [pool, K]
    cols = keys[rng.integers(0, pool, n)].T.copy()
    valid = rng.random(n) >= invalid
    z = rng.choice(n, min(zero_rows, n), replace=False)
    cols[:, z] = 0
    valid[z] = True
    pad = n // 8
    if pad:
        cols[:, n - pad:] = 0
        valid[n - pad:] = False
    values = rng.integers(-(1 << 31), 1 << 31, (n, nv), dtype=np.int64)
    return cols.astype(np.int32), i32(values), valid


def exact_cases(rng):
    """(name, cols, values, valid) tables for the index invariants."""
    out = [("ct4", *exact_table(rng, 5, 300)), ("ct6", *exact_table(rng, 11, 200, pool=16)),
           ("policy", *exact_table(rng, 4, 150, pool=10)), ("lxc", *exact_table(rng, 1, 40, nv=2, pool=8))]
    one = exact_table(rng, 5, 1, zero_rows=0, invalid=0.0)
    out.append(("one-row", one[0], one[1], np.ones(1, bool)))
    c, v, _ = exact_table(rng, 4, 7)
    out.append(("all-invalid", c, v, np.zeros(7, bool)))
    c = np.repeat(_pool(rng, 5)[:, None], 64, 1)  # every row one key: one bucket
    out.append(("one-bucket", c, i32(rng.integers(0, 1 << 32, (64, 1))), rng.random(64) < 0.9))
    out.append(("zeros", np.zeros((5, 9), np.int32), i32(np.arange(9)[:, None]), np.arange(9) % 2 == 0))
    return out


def _masks_for(plen, w):
    """[W, N] masks of prefix lengths (clipped to [0, 32W])."""
    p = np.clip(np.asarray(plen, np.int64), 0, 32 * w)
    out = np.zeros((w, len(p)), np.int64)
    for j in range(w):
        bits = np.clip(p - 32 * j, 0, 32)
        out[j] = np.where(bits == 0, 0, (0xFFFFFFFF << (32 - bits)) & 0xFFFFFFFF)
    return out


def lpm_table(rng, w, n, irregular=0.1, dirty=0.05, odd_plen=0.05):
    """A prefix table: prefixes drawn from a few bases at mixed lengths
    (duplicates with other values among them), some irregular masks, some
    words with bits outside their mask, some plen of -1 or INT32_MAX, some
    invalid rows.  Returns (words [W, N], masks [W, N], plen, values,
    valid)."""
    bases = rng.integers(0, 1 << 32, (6, w), dtype=np.int64)
    base = bases[rng.integers(0, 6, n)].T  # [W, N]
    plen = rng.choice(np.array([0, 8, 16, 24, 32 * w - 8, 32 * w]), n)
    masks = _masks_for(plen, w)
    odd = rng.random(n) < irregular
    masks[:, odd] = rng.integers(0, 1 << 32, (w, int(odd.sum())), dtype=np.int64)
    words = base & masks
    bad = rng.random(n) < dirty
    words[:, bad] |= ~masks[:, bad] & rng.integers(1, 1 << 32, (w, int(bad.sum())), dtype=np.int64)
    plen = plen.astype(np.int64)
    plen[rng.random(n) < odd_plen] = -1
    plen[rng.random(n) < odd_plen] = INT32_MAX
    values = rng.integers(-3, 12, n)
    valid = rng.random(n) >= 0.1
    return (i32(words), i32(masks), plen.astype(np.int32), values.astype(np.int32), valid)


def lpm_cases(rng, w):
    out = [(f"lpm{w}", *lpm_table(rng, w, 120)), (f"lpm{w}-odd", *lpm_table(rng, w, 60, 0.5, 0.3, 0.2))]
    t = lpm_table(rng, w, 1, 0, 0, 0)
    out.append((f"lpm{w}-one", *t[:4], np.ones(1, bool)))
    t = lpm_table(rng, w, 5)
    out.append((f"lpm{w}-invalid", *t[:4], np.zeros(5, bool)))
    return out


def many_group_lpm(rng, w, n, lo=None, invalid=0.05, unselectable=0.05):
    """A prefix table of ``n`` random prefixes of every length from ``lo``
    (8 for v4, 32 for v6) to 32W, so about as many mask groups as lengths
    (prefilter6's 256 /32-/128 prefixes fall into 91): a tenth of the rows
    repeat an earlier prefix (half with its value, half with another),
    values from a small range (ties at the best length), some rows invalid
    and some that can never be selected (bits outside the mask, plen -1).
    Returns (words [W, N], masks [W, N], plen, values, valid)."""
    lo = (8 if w == 1 else 32) if lo is None else lo
    plen = rng.integers(lo, 32 * w + 1, n)
    masks = _masks_for(plen, w)
    words = rng.integers(0, 1 << 32, (w, n), dtype=np.int64) & masks
    values = rng.integers(0, 8, n)
    dup = rng.choice(n, n // 10, replace=False)
    src = rng.integers(0, n, dup.size)
    words[:, dup], masks[:, dup], plen[dup] = words[:, src], masks[:, src], plen[src]
    same = rng.random(dup.size) < 0.5
    values[dup[same]] = values[src[same]]
    dirty = (rng.random(n) < unselectable / 2) & (plen < 32 * w)
    words[:, dirty] |= ~masks[:, dirty] & 0xFFFFFFFF & rng.integers(1, 1 << 32, (w, int(dirty.sum())),
                                                                    dtype=np.int64)
    plen[rng.random(n) < unselectable / 2] = -1
    valid = rng.random(n) >= invalid
    return i32(words), i32(masks), plen.astype(np.int32), values.astype(np.int32), valid


def lpm_sources(rng, words, masks, f, inside=0.2):
    """[W] of [F] int32 addresses, as the XDP prefilter sees them: a share
    ``inside`` of them in a random prefix of the table (host bits random),
    the rest random (a miss, all but surely)."""
    w, n = words.shape
    pick = rng.integers(0, n, f)
    m = masks.view(np.uint32).astype(np.int64)[:, pick]
    host = rng.integers(0, 1 << 32, (w, f), dtype=np.int64)
    a = (words.view(np.uint32).astype(np.int64)[:, pick] & m) | (host & ~m & 0xFFFFFFFF)
    out = rng.random(f) >= inside
    a[:, out] = rng.integers(0, 1 << 32, (w, int(out.sum())), dtype=np.int64)
    return [i32(x) for x in a]


def wide_table(rng, n=200):
    """An 11-column table with 8 value columns: key, values and row id (20
    words) do not fit a 16-word slot, so its index holds the key and the
    row id and a lookup reads a matched row's values from the table."""
    return exact_table(rng, 11, n, nv=8, pool=16)


def addr_queries(rng, words, masks, f):
    """[W] of [F] int32 addresses: inside the table's prefixes (host bits
    random), zeros, and random."""
    w, n = words.shape
    pick = rng.integers(0, n, f)
    host = rng.integers(0, 1 << 32, (w, f), dtype=np.int64)
    m = masks.view(np.uint32).astype(np.int64)[:, pick]
    a = (words.view(np.uint32).astype(np.int64)[:, pick] & m) | (host & ~m & 0xFFFFFFFF)
    roll = rng.random(f)
    a[:, roll < 0.1] = 0
    a[:, roll > 0.85] = rng.integers(0, 1 << 32, (w, int((roll > 0.85).sum())), dtype=np.int64)
    return [i32(x) for x in a]


def key_queries(rng, cols, f):
    """[K] of [F] int32 queries: table rows (valid or not), zeros, random."""
    k, n = cols.shape
    q = cols[:, rng.integers(0, n, f)].astype(np.int64)
    roll = rng.random(f)
    q[:, roll < 0.1] = 0
    q[:, roll > 0.85] = rng.integers(0, 1 << 32, (k, int((roll > 0.85).sum())), dtype=np.int64)
    return [i32(x) for x in q]


def lb_arrays(rng, w, s=24, b=3):
    """A service table's 7 leaves (``DeviceLbMap.from_arrays`` order):
    duplicate (VIP, port) rows, wildcard-port rows beside L4 ones, counts of
    -1, 0 and past the backend columns, invalid rows, VIPs >= 2^31."""
    vips = np.stack([_pool(rng, 6) for _ in range(w)], 0)[:, rng.integers(0, 6, s)]
    ports = rng.choice(np.array([0, 80, 443], np.int32), s)
    counts = rng.choice(np.array([-1, 0, 1, 2, 3, 9], np.int32), s)
    revnat = rng.integers(0, 100, s).astype(np.int32)
    target = i32(rng.integers(0, 1 << 32, (w, s, b), dtype=np.int64))
    bport = rng.integers(1, 65536, (s, b)).astype(np.int32)
    valid = rng.random(s) < 0.85
    return [vips.reshape(-1) if w == 1 else vips, ports, counts, revnat,
            target.reshape(s, b) if w == 1 else target, bport, valid]


def datapath_leaves(rng, w, n=(600, 24, 150, 160), invalid=False):
    """The leaves of an adversarial egress snapshot (25 for v4, 37 for
    v6): CT (2W + 3 columns), LB, ipcache LPM (W words), policy whose
    identities are the LPM's values, 0 and WORLD_ID; ``n`` the rows of
    each (one count: all four); ``invalid``: every row of every table
    invalid."""
    n_ct, n_lb, n_lpm, n_pol = (n,) * 4 if isinstance(n, int) else n
    ct_cols, _, ct_valid = exact_table(rng, 2 * w + 3, n_ct, pool=max(n_ct // 3, 1),
                                       zero_rows=min(2, n_ct - 1))
    ct = [*ct_cols, np.zeros((n_ct, 1), np.int32), ct_valid]
    lb = lb_arrays(rng, w, s=n_lb)
    words, masks, plen, values, valid = lpm_table(rng, w, n_lpm)
    lpm = [*words, *masks, plen, values, valid]
    pol = _policy_leaves(rng, np.unique(values), direction=1, n=n_pol)
    out = ct + lb + lpm + pol
    k = 2 * w + 3
    return _validity(out, [k + 1, k + 8, k + 9 + 2 * w + 2, len(out) - 1], invalid)


def _validity(leaves, at, invalid):
    """Tables of one row are valid; with ``invalid`` no row is."""
    for i in at:
        v = np.asarray(leaves[i]).copy()
        if invalid:
            v[:] = False
        elif v.shape[0] == 1:
            v[:] = True
        leaves[i] = v
    return leaves


def _policy_leaves(rng, idents, direction, n=160):
    idents = np.concatenate([idents, [0, 0, WORLD_ID]]).astype(np.int64)
    cols = np.stack([rng.choice(idents, n), rng.choice(np.array([0, 80, 443, 8080]), n),
                     rng.choice(np.array([0, 6, 17]), n), np.where(rng.random(n) < 0.85, direction, 1 - direction)])
    l3 = rng.random(n) < 0.2
    cols[1:3, l3] = 0
    vals = rng.choice(np.array([0, 0, 15000, -7, INT32_MAX]), (n, 1))
    valid = rng.random(n) >= 0.1
    return [*i32(cols), i32(vals), valid]


def _mix(rng, f, options):
    """One choice of ``options`` (arrays of [F] candidates) per packet."""
    pick = rng.integers(0, len(options), f)
    return np.choose(pick, [np.asarray(o, np.int64) for o in options])


def datapath_packets(rng, leaves, w, f):
    """(saddr words, daddr words, sport, dport, proto): CT tuples, LB VIPs,
    prefix addresses, zeros and random values, mixed per field."""
    k = 2 * w + 3
    ct_cols, ct_valid = np.stack(leaves[:k]), leaves[k + 1]
    vips = np.asarray(leaves[k + 2]).reshape(w, -1)
    lpm = leaves[k + 9:k + 9 + 2 * w + 3]
    words, masks = np.stack(lpm[:w]), np.stack(lpm[w:2 * w])
    row = rng.integers(0, ct_cols.shape[1], f)
    vip = rng.integers(0, vips.shape[1], f)
    pre = addr_queries(rng, words, masks, f)
    rnd = [i32(rng.integers(0, 1 << 32, f, dtype=np.int64)) for _ in range(2 * w)]
    kind = rng.integers(0, 5, f)  # 0, 1: a CT tuple; 2: a VIP; 3: a prefix; 4: random
    da = [np.where(kind < 2, ct_cols[j, row], np.where(kind == 2, vips[j, vip],
                                                       np.where(kind == 3, pre[j], rnd[j]))) for j in range(w)]
    sa = [np.where(kind < 2, ct_cols[w + j, row], rnd[w + j]) for j in range(w)]
    dport = np.where(kind < 2, ct_cols[2 * w, row], _mix(rng, f, [np.full(f, 80), np.full(f, 443),
                                                                  np.zeros(f), np.full(f, 8080)]))
    sport = np.where(kind < 2, ct_cols[2 * w + 1, row], rng.integers(0, 65536, f))
    proto = np.where(kind < 2, ct_cols[2 * w + 2, row], _mix(rng, f, [np.full(f, 6), np.full(f, 17), np.zeros(f)]))
    zero = rng.random(f) < 0.03  # all-zero packets: never padding's match
    out = [*sa, *da, sport, dport, proto]
    out = [np.where(zero, 0, x) for x in out]
    del ct_valid
    return tuple(i32(x) for x in out[:w]), tuple(i32(x) for x in out[w:2 * w]), i32(out[-3]), \
        i32(out[-2]), i32(out[-1])


def ingress_leaves(rng, n=(150, 90, 40, 600, 160), invalid=False):
    """The 26 leaves of an adversarial node-ingress snapshot: identity and
    tunnel LPMs (the tunnel values >= 2^31 too), the endpoint table
    (duplicate addresses, host flags), CT, ingress policy; ``n`` the rows
    of each (one count: all five); ``invalid``: every row of every table
    invalid."""
    n_id, n_tun, n_lxc, n_ct, n_pol = (n,) * 5 if isinstance(n, int) else n
    idw, idm, idp, idv, idvalid = lpm_table(rng, 1, n_id)
    idv = rng.choice(np.array([0, 1, 2, 100, 101, 300, 256]), idv.shape[0]).astype(np.int32)
    tw, tm, tp, _, tvalid = lpm_table(rng, 1, n_tun)
    tv = i32(rng.choice(np.array([0, 0xC0A80102, 0xFFFFFFFE, 7]), tw.shape[1]))
    lxc_cols, _, lxc_valid = exact_table(rng, 1, n_lxc, nv=2, pool=max(n_lxc // 4, 1),
                                         zero_rows=min(2, n_lxc - 1))
    lxc_vals = np.stack([rng.integers(1, 90, n_lxc), rng.choice(np.array([0, 0, 1, 3]), n_lxc)],
                        1).astype(np.int32)
    ct_cols, _, ct_valid = exact_table(rng, 5, n_ct, pool=max(n_ct // 3, 1), zero_rows=min(2, n_ct - 1))
    side = rng.integers(0, 3, n_ct)  # a local endpoint as daddr (inbound) or saddr (egress-created)
    ep = lxc_cols[0, rng.integers(0, n_lxc, n_ct)]
    ct_cols[0] = np.where(side == 0, ep, ct_cols[0])
    ct_cols[1] = np.where(side == 1, ep, ct_cols[1])
    pol = _policy_leaves(rng, np.array([100, 101, 300, 256, 1]), direction=0, n=n_pol)
    out = [idw[0], idm[0], idp, idv, idvalid, tw[0], tm[0], tp, tv, tvalid,
           lxc_cols[0], lxc_vals, lxc_valid, *ct_cols, np.zeros((n_ct, 1), np.int32), ct_valid, *pol]
    return _validity(out, [4, 9, 12, 19, 25], invalid)


# Value columns of the tables the passes read beyond the ones they use
# (CT: none, policy: column 0, endpoints: columns 0 and 1): "mid" fills
# 16-word index slots with values, "wide" passes 16 words, so the slots
# hold row ids and a match reads its row.
WIDE = {"mid": {"ct": 3, "pol": 5, "lxc": 7}, "wide": {"ct": 12, "pol": 12, "lxc": 15}}


def _widen(rng, leaves, cols):
    """``leaves`` with the value leaf at each index of ``cols`` grown to
    ``cols[index]`` columns by random int32 words."""
    out = list(leaves)
    for i, v in cols.items():
        vals = np.asarray(out[i])
        extra = i32(rng.integers(0, 1 << 32, (vals.shape[0], v - vals.shape[1]), dtype=np.int64))
        out[i] = np.concatenate([vals, extra], 1)
    return out


def widen_datapath(rng, leaves, w, ct, pol, lxc=None):
    """``datapath_leaves`` with CT and policy values of ``ct`` and ``pol``
    columns (``lxc``: unused, the egress snapshot has no endpoint table)."""
    del lxc
    return _widen(rng, leaves, {2 * w + 3: ct, len(leaves) - 2: pol})


def widen_ingress(rng, leaves, ct, pol, lxc):
    """``ingress_leaves`` with endpoint, CT and policy values of ``lxc``,
    ``ct`` and ``pol`` columns."""
    return _widen(rng, leaves, {11: lxc, 18: ct, 24: pol})


def ingress_packets(rng, leaves, f):
    """{saddr, daddr, sport, dport, proto, src_id, vni}: CT tuples in both
    orientations, endpoint addresses, prefix addresses, zeros, random."""
    lxc = leaves[10]
    ct = np.stack(leaves[13:18])
    idw, idm = leaves[0][None, :], leaves[1][None, :]
    tw, tm = leaves[5][None, :], leaves[6][None, :]
    row = rng.integers(0, ct.shape[1], f)
    kind = rng.integers(0, 6, f)  # 0: forward CT; 1: reply CT; 2: endpoint; 3: tunnel prefix; 4, 5: random
    rnd = [i32(rng.integers(0, 1 << 32, f, dtype=np.int64)) for _ in range(2)]
    src_pre = addr_queries(rng, idw, idm, f)[0]
    tun_pre = addr_queries(rng, tw, tm, f)[0]
    ep = lxc[rng.integers(0, lxc.shape[0], f)]
    daddr = np.select([kind == 0, kind == 1, kind == 2, kind == 3], [ct[0, row], ct[1, row], ep, tun_pre], rnd[0])
    saddr = np.select([kind == 0, kind == 1], [ct[1, row], ct[0, row]], np.where(kind == 4, src_pre, rnd[1]))
    port = _mix(rng, f, [np.full(f, 80), np.full(f, 443), np.zeros(f), np.full(f, 8080)])
    dport = np.select([kind == 0, kind == 1], [ct[2, row], ct[3, row]], port)
    sport = np.select([kind == 0, kind == 1], [ct[3, row], ct[2, row]], rng.integers(0, 65536, f))
    proto = np.where(kind < 2, ct[4, row], _mix(rng, f, [np.full(f, 6), np.full(f, 17), np.zeros(f)]))
    out = {"saddr": saddr, "daddr": daddr, "sport": sport, "dport": dport, "proto": proto,
           "src_id": rng.choice(np.array([0, 0, 1, 4, 100, 255, 256, 5000, -7]), f),
           "vni": rng.choice(np.array([100, 101, 300, WORLD_ID, 0]), f)}
    zero = rng.random(f) < 0.03
    return {k: i32(np.where(zero, 0, v)) for k, v in out.items()}
