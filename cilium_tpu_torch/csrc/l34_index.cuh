// Probes of the hashed table indexes that the L3/L4 kernels read: K12
// (lpm.cu), K13 (l34_tables.cu), K14 (datapath.cu) and K15 (ingress.cu).
// ops/l34_index.py builds the indexes, one a table when the table is made
// (its ctypes mirrors are HashIx and LpmIx), and holds the layout: a
// bucketed (CSR) index, bucket h & (B - 1) of a key's MurmurHash3,
// bounds[b] its (first, end) slot, slots row-major and padded to 4, 8 or
// 16 words, a bucket's rows in table order, zero slots past the last
// indexed row (at least one).
//
// A probe is two dependent loads: the bucket's bounds (one 8-byte load)
// and its first slot (16-byte ld.global.nc loads of the S words it reads:
// the slot, or a prefix of it where the stride St between slots is wider,
// St a template argument, or 0 for the index's width read at run time),
// taken whether or not
// the bucket is empty (the zero slots keep it in bounds), so a thread
// issues the bounds of every independent probe, then every first slot,
// and tests none of them before all are issued: a test between two loads
// serialises them.  The rest of a bucket (B is at least twice the rows,
// so rarely any) is walked after.  The indexes and tables of a node's
// snapshot are well under the 50 MB L2.
#pragma once

#include "l34.cuh"

namespace l34x {

using l34::add32;

// ops/l34_index.py HashIndex.abi()
struct HashIx {
  const int2* bounds;     // [B]: first and end slot of each bucket
  const int32_t* slots;   // [N + 1, width]: key words, what is read beside them; zeros past M
  int32_t mask;           // B - 1
  int32_t width;          // words a slot
};

// ops/l34_index.py LpmIndex.abi(): slots (group, W words, score, value)
struct LpmIx {
  HashIx h;
  const int32_t* groups;  // [N + 2, 8]: best score, W masks; best first; zero past the last group
};

// Words of a slot that holds `used` words (ops/l34_index.py slot_words).
__host__ __device__ constexpr int slot_words(int used) {
  return used <= 4 ? 4 : (used <= 8 ? 8 : 16);
}

// Whether the slots of a K-column table with V value columns hold the
// values (ops/maplookup.py slot_values; else the slot holds the row id at
// word K), and the width of its index's slots.
__host__ __device__ constexpr bool in_slot(int k, int v) { return k + v + 1 <= 16; }
__host__ __device__ constexpr int exact_width(int k, int v) {
  return slot_words(k + (in_slot(k, v) ? v : 0) + 1);
}

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

// ops/l34_index.py hash32: MurmurHash3 (x86, 32 bits, seed 0) of K words.
template <int K>
__device__ __forceinline__ uint32_t hash_key(const int32_t (&q)[K]) {
  uint32_t h = 0;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const uint32_t k = rotl(static_cast<uint32_t>(q[i]) * 0xCC9E2D51u, 15) * 0x1B873593u;
    h = rotl(h ^ k, 13) * 5u + 0xE6546B64u;
  }
  h ^= 4u * K;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

// One probe: the bucket's bounds and the first S words of its first
// slot, slots St words apart (0: the index's width).
template <int S, int St = S>
struct Probe {
  int2 b;
  int32_t s[S];
};

// The first S words of slot i.
template <int S, int St>
__device__ __forceinline__ void load_slot(const HashIx& ix, int i, int32_t (&s)[S]) {
  static_assert(St == 0 || St >= S, "a slot holds fewer words than the probe reads");
  const int stride = St > 0 ? St : ix.width;
  const int4* p = reinterpret_cast<const int4*>(ix.slots + static_cast<size_t>(i) * stride);
#pragma unroll
  for (int j = 0; j < S / 4; ++j) {
    const int4 v = __ldg(p + j);
    s[4 * j] = v.x;
    s[4 * j + 1] = v.y;
    s[4 * j + 2] = v.z;
    s[4 * j + 3] = v.w;
  }
}

// The bucket bounds of key q.
template <int K, int S, int St>
__device__ __forceinline__ void start(const HashIx& ix, const int32_t (&q)[K], Probe<S, St>& p) {
  p.b = __ldg(ix.bounds + (hash_key<K>(q) & static_cast<uint32_t>(ix.mask)));
}

// The bucket's first slot (when the bucket is empty, the slot its bound points
// at: a row of the next bucket, or the first zero slot).
template <int S, int St>
__device__ __forceinline__ void first(const HashIx& ix, Probe<S, St>& p) {
  load_slot<S, St>(ix, p.b.x, p.s);
}

template <int K, int S>
__device__ __forceinline__ bool key_eq(const int32_t (&s)[S], const int32_t (&q)[K]) {
  bool m = true;
#pragma unroll
  for (int k = 0; k < K; ++k) m &= s[k] == q[k];
  return m;
}

// on(slot) for every slot of the bucket whose key is q, in table order.
template <int K, int S, int St, typename On>
__device__ __forceinline__ void visit(const HashIx& ix, const Probe<S, St>& p, const int32_t (&q)[K],
                                      On&& on) {
  if (p.b.x < p.b.y && key_eq<K, S>(p.s, q)) on(p.s);
  for (int i = p.b.x + 1; i < p.b.y; ++i) {
    int32_t s[S];
    load_slot<S, St>(ix, i, s);
    if (key_eq<K, S>(s, q)) on(s);
  }
}

// Value column C of the row a matched slot of a K-column table t stands
// for: slot word K + C where the values fit the slot (kIn: known to),
// else column C of the table row whose id the slot holds at word K.
template <int K, int C, bool kIn, int S>
__device__ __forceinline__ int32_t slot_value(const l34::ExactTab& t, const int32_t (&s)[S]) {
  static_assert(K + C < S, "the probe reads too few words of the slot");
  if (kIn || in_slot(K, t.v)) return s[K + C];
  return l34::ld(t.values + static_cast<size_t>(s[K]) * t.v + C);
}

// Whether a row has key q (the CT lookups: `found` only).
template <int K, int S, int St>
__device__ __forceinline__ bool found(const HashIx& ix, const Probe<S, St>& p, const int32_t (&q)[K]) {
  bool f = false;
  visit<K, S>(ix, p, q, [&](const int32_t (&)[S]) { f = true; });
  return f;
}

// ops/maplookup.py exact_lookup: whether a row of table t has key q, and
// the int32-wrapped sum of value columns 0 and 1 of every such row, added
// into acc (kIn: the slots are known to hold the values).
template <bool kIn, int K, int S, int St>
__device__ __forceinline__ bool sum2(const l34::ExactTab& t, const HashIx& ix, const Probe<S, St>& p,
                                     const int32_t (&q)[K], int32_t (&acc)[2]) {
  bool f = false;
  visit<K, S>(ix, p, q, [&](const int32_t (&s)[S]) {
    f = true;
    acc[0] = add32(acc[0], slot_value<K, 0, kIn>(t, s));
    acc[1] = add32(acc[1], slot_value<K, 1, kIn>(t, s));
  });
  return f;
}

// --- the LPM: a probe a mask group, best group first --------------------------

// Two groups' keys and probes: rows gi and gi + 1 of the group list.
template <int W>
struct LpmPair {
  static constexpr int S = slot_words(W + 3);
  int32_t best[2];
  int32_t q[2][W + 1];
  Probe<S> p[2];
};

template <int W>
__device__ __forceinline__ void lpm_start(const LpmIx& ix, const int32_t (&a)[W], int gi,
                                          LpmPair<W>& lp) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int4* row = reinterpret_cast<const int4*>(ix.groups) + 2 * (gi + j);
    const int4 lo = __ldg(row);  // best, masks 0..2
    int32_t m[4] = {lo.y, lo.z, lo.w, 0};
    if (W > 3) m[3] = __ldg(row + 1).x;
    lp.best[j] = lo.x;
    lp.q[j][0] = gi + j;
#pragma unroll
    for (int w = 0; w < W; ++w) lp.q[j][1 + w] = a[w] & m[w];
    start<W + 1, LpmPair<W>::S>(ix.h, lp.q[j], lp.p[j]);
  }
}

template <int W>
__device__ __forceinline__ void lpm_first(const LpmIx& ix, LpmPair<W>& lp) {
  first(ix.h, lp.p[0]);
  first(ix.h, lp.p[1]);
}

// ops/lpm.py lpm_lookup for one address, from the pair of groups 0 and 1
// already started: the best score (plen + 1) wins, the largest value
// among rows at the best score; a miss gives (false, 0, -1).  Groups are
// probed two at a time, best first, until the best score found beats the
// next group's (a group probed past that point cannot change the answer:
// its rows score at most its best).
template <int W>
__device__ __forceinline__ void lpm_finish(const LpmIx& ix, const int32_t (&a)[W], LpmPair<W>& lp,
                                           bool& found_, int32_t& value, int32_t& plen) {
  constexpr int S = LpmPair<W>::S;
  int32_t best = 0;
  int32_t val = INT_MIN;
  for (int gi = 0;; gi += 2) {
    if (gi > 0) {
      lpm_start<W>(ix, a, gi, lp);
      lpm_first<W>(ix, lp);
    }
    if (lp.best[0] <= 0 || best > lp.best[0]) break;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      visit<W + 1, S>(ix.h, lp.p[j], lp.q[j], [&](const int32_t (&s)[S]) {
        const int32_t sc = s[W + 1], v = s[W + 2];
        if (sc > best) {
          best = sc;
          val = v;
        } else if (sc == best) {
          val = max(val, v);
        }
      });
    }
    if (lp.best[1] <= 0) break;  // the group list ends
  }
  found_ = best > 0;
  value = found_ ? val : 0;
  plen = found_ ? best - 1 : -1;
}

// --- the policy cascade -----------------------------------------------------

// The words of a policy slot the cascade reads: the key and word 4 (value
// column 0, or the row id where the values do not fit the slot).
constexpr int kPolS = 8;

// maps/policymap.py policy_can_access_batch: the three exact lookups of
// the cascade, (ident, dport, proto, dir), (ident, 0, 0, dir) and (0,
// dport, proto, dir), each summing value column 0 of its matched rows;
// slots St words apart (0: the index's width).
template <int St = kPolS>
struct PolicyProbe {
  int32_t q[3][4];
  Probe<kPolS, St> p[3];
};

template <int St>
__device__ __forceinline__ void policy_start(const HashIx& ix, int32_t ident, int32_t dport,
                                             int32_t proto, int32_t dir, PolicyProbe<St>& pp) {
  const int32_t keys[3][4] = {{ident, dport, proto, dir}, {ident, 0, 0, dir}, {0, dport, proto, dir}};
#pragma unroll
  for (int j = 0; j < 3; ++j) {
#pragma unroll
    for (int k = 0; k < 4; ++k) pp.q[j][k] = keys[j][k];
    start<4, kPolS>(ix, pp.q[j], pp.p[j]);
  }
}

template <int St>
__device__ __forceinline__ void policy_first(const HashIx& ix, PolicyProbe<St>& pp) {
#pragma unroll
  for (int j = 0; j < 3; ++j) first(ix, pp.p[j]);
}

// The cascade's answer from the policy table t and its index ix (kIn:
// the slots are known to hold value column 0).
template <bool kIn, int St>
__device__ __forceinline__ void policy_finish(const l34::ExactTab& t, const HashIx& ix,
                                              const PolicyProbe<St>& pp, bool& allowed,
                                              int32_t& proxy) {
  bool f[3] = {false, false, false};
  int32_t v[3] = {0, 0, 0};
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    visit<4, kPolS>(ix, pp.p[j], pp.q[j], [&](const int32_t (&s)[kPolS]) {
      f[j] = true;
      v[j] = add32(v[j], slot_value<4, 0, kIn>(t, s));
    });
  }
  allowed = f[0] || f[1] || f[2];
  proxy = f[0] ? v[0] : (f[1] ? 0 : (f[2] ? v[2] : 0));
}

// --- the service table ------------------------------------------------------

template <int W>
struct LbKey {
  static constexpr int S = slot_words(W + 2);  // VIP words, port, row id
};

// maps/lbmap.py lb{4,6}_select_backend_batch for one flow: the first
// valid row with (VIP, dport), else the first with (VIP, 0), found through
// the index (a bucket keeps its rows in table order, so the first slot that
// matches is the first row); backend uint32(hash) % max(count, 1), clamped
// into the table as the reference's gather clamps; row 0 and zeros when no
// service matches.
template <int W>
__device__ __forceinline__ void lb_probe(const l34::LbTab& t, const HashIx& ix,
                                         const int32_t (&vip)[W], int32_t dport, uint32_t hash,
                                         bool& found_, int32_t (&target)[W], int32_t& port,
                                         int32_t& rev) {
  constexpr int S = LbKey<W>::S;
  int32_t q4[W + 1], q3[W + 1];
#pragma unroll
  for (int w = 0; w < W; ++w) q4[w] = q3[w] = vip[w];
  q4[W] = dport;
  q3[W] = 0;
  Probe<S> p4, p3;
  start<W + 1, S>(ix, q4, p4);
  start<W + 1, S>(ix, q3, p3);
  first(ix, p4);
  first(ix, p3);
  int i4 = -1, i3 = -1;
  visit<W + 1, S>(ix, p4, q4, [&](const int32_t (&s)[S]) { if (i4 < 0) i4 = s[W + 1]; });
  visit<W + 1, S>(ix, p3, q3, [&](const int32_t (&s)[S]) { if (i3 < 0) i3 = s[W + 1]; });
  found_ = i4 >= 0 || i3 >= 0;
  const int idx = i4 >= 0 ? i4 : (i3 >= 0 ? i3 : 0);
  const uint32_t count = static_cast<uint32_t>(max(l34::ld(t.counts + idx), 1));
  const int slave = static_cast<int>(min(hash % count, static_cast<uint32_t>(t.b - 1)));
  const size_t cell = static_cast<size_t>(idx) * t.b + slave;
#pragma unroll
  for (int w = 0; w < W; ++w)
    target[w] = found_ ? l34::ld(t.b_target + static_cast<size_t>(w) * t.s * t.b + cell) : 0;
  port = found_ ? l34::ld(t.b_port + cell) : 0;
  rev = found_ ? l34::ld(t.revnat + idx) : 0;
}

// Whether an index was given (a launcher refuses tables without one) and
// has the slot width of its table (exact_width for an exact table: the
// probes read a prefix of it, and where the values sit).
__host__ __device__ inline bool usable(const HashIx& ix, int width) {
  return ix.bounds != nullptr && ix.slots != nullptr && ix.mask >= 0 && ix.width == width;
}

template <int W>
__host__ __device__ inline bool usable(const LpmIx& ix) {
  return usable(ix.h, slot_words(W + 3)) && ix.groups != nullptr;
}

}  // namespace l34x
