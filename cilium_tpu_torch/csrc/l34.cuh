// Shared device code of the L3/L4 kernels K12-K15 (lpm.cu, l34_tables.cu,
// datapath.cu, ingress.cu): the table layouts the Python side packs (its
// ctypes mirrors are LpmTab in ops/lpm.py, ExactTab in ops/maplookup.py
// and LbTab in maps/lbmap.py), and one walk per table kind.
//
// Every walk gives one thread to one packet and reads each table row once,
// at the same index in every thread of a warp, so a row read is one
// broadcast through the read-only path (__ldg).  The tables are small
// (about 0.13 MB at bench shape) and stay in L1/L2 across the blocks.
// With F = 65,536 there are only about 16 warps an SM, too few to hide a
// load's latency row by row, so each walk first loads one column of
// kUnroll rows (the column that rejects most rows) into registers, then
// compares them, and reads a row's other columns only where it passed.
// All address and hash arithmetic is in uint32_t: the reference's int32
// wraparound is defined there, signed overflow is not.
#pragma once

#include "common.cuh"

#include <climits>

namespace l34 {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 128;  // a multiple of 32: every warp is whole
constexpr int kWorldId = 2;    // datapath/pipeline.py WORLD_ID
constexpr int kMaxKeyCols = 11;
constexpr int kUnroll = 8;     // rows whose reject column is loaded at once

// ops/maplookup.py DeviceTable: keys [K, N], values [N, V], valid [N].
struct ExactTab {
  const int32_t* keys;
  const int32_t* values;
  const bool* valid;
  int32_t n, k, v;
};

// ops/lpm.py DeviceLpm: words and masks [W, N], plen, values, valid [N].
struct LpmTab {
  const int32_t* words;
  const int32_t* masks;
  const int32_t* plen;
  const int32_t* values;
  const bool* valid;
  int32_t n, w;
};

// maps/lbmap.py _DeviceLb: vip words [W, S], ports, counts, revnat [S],
// backend target words [W, S, B], backend ports [S, B], valid [S].
struct LbTab {
  const int32_t* vips;
  const int32_t* ports;
  const int32_t* counts;
  const int32_t* revnat;
  const int32_t* b_target;
  const int32_t* b_port;
  const bool* valid;
  int32_t s, b, w;
};

__device__ __forceinline__ int32_t ld(const int32_t* p) { return __ldg(p); }
__device__ __forceinline__ bool ldb(const bool* p) {
  return __ldg(reinterpret_cast<const unsigned char*>(p)) != 0;
}
__device__ __forceinline__ int32_t add32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

// datapath/pipeline.py flow_hash32 in uint32: 0x9E3779B9 is -1640531527.
__device__ __forceinline__ uint32_t flow_hash(uint32_t s, uint32_t d,
                                              uint32_t sp, uint32_t dp,
                                              uint32_t pr) {
  return s * 0x9E3779B9u + d * 40503u + sp * 31u + dp * 131u + pr;
}

// flow_hash32_v6: fold words 1..3 into word 0, then the v4 hash.
template <int W>
__device__ __forceinline__ uint32_t flow_hash_w(const int32_t (&s)[W],
                                                const int32_t (&d)[W],
                                                int32_t sp, int32_t dp,
                                                int32_t pr) {
  uint32_t fs = static_cast<uint32_t>(s[0]);
  uint32_t fd = static_cast<uint32_t>(d[0]);
#pragma unroll
  for (int w = 1; w < W; ++w) {
    fs ^= static_cast<uint32_t>(s[w]) * 31u;
    fd ^= static_cast<uint32_t>(d[w]) * 131u;
  }
  return flow_hash(fs, fd, static_cast<uint32_t>(sp), static_cast<uint32_t>(dp),
                   static_cast<uint32_t>(pr));
}

// ops/lpm.py lpm_lookup for one address of W words: every row is seen
// (the longest match may be the last row); among matches of the best
// length the largest value wins; a miss gives (false, 0, -1).
template <int W>
__device__ __forceinline__ void lpm_walk(const LpmTab& t, const int32_t (&a)[W],
                                         bool& found, int32_t& value,
                                         int32_t& plen) {
  const int n = t.n;
  int32_t best = 0;
  int32_t val = INT_MIN;
  for (int r0 = 0; r0 < n; r0 += kUnroll) {
    bool hit0[kUnroll];  // word 0 matches
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = r0 + u;
      hit0[u] = r < n && (a[0] & ld(t.masks + r)) == ld(t.words + r);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!hit0[u]) continue;
      const int r = r0 + u;
      bool m = ldb(t.valid + r);
#pragma unroll
      for (int w = 1; w < W; ++w)
        m = m && ((a[w] & ld(t.masks + w * n + r)) == ld(t.words + w * n + r));
      if (!m) continue;
      const int32_t s = add32(ld(t.plen + r), 1);
      const int32_t v = ld(t.values + r);
      if (s > best) {
        best = s;
        val = v;
      } else if (s == best) {
        val = max(val, v);
      }
    }
  }
  found = best > 0;
  value = found ? val : 0;
  plen = found ? best - 1 : -1;
}

// ops/maplookup.py exact_lookup for one K-column key: whether a valid row
// has it, and the int32-wrapped sum of value columns [0, nv) of every such
// row, added into acc (the reference extracted rows with a one-hot matmul,
// so duplicate keys sum).  Column K - 2 (the CT key's sport) is compared
// first: it tells rows apart best, and a row's other columns are read only
// where it passed.  kFoundOnly is the form that reads only `found`: a warp
// leaves once every lane has found its row, so all 32 lanes of every warp
// must call it (threads past F included).
template <int K, bool kFoundOnly = false>
__device__ __forceinline__ bool exact_sum(const ExactTab& t, const int32_t (&q)[K],
                                          int nv, int32_t* acc) {
  constexpr int first = K >= 2 ? K - 2 : 0;
  const int n = t.n;
  const int32_t* col = t.keys + first * n;
  const int block = kFoundOnly ? 32 : n;  // rows between two warp votes
  bool found = false;
  for (int base = 0; base < n; base += block) {
    if (kFoundOnly && __all_sync(kFull, found)) break;
    const int end = min(base + block, n);
    for (int r0 = base; r0 < end; r0 += kUnroll) {
      bool hit[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) hit[u] = r0 + u < end && ld(col + r0 + u) == q[first];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (!hit[u]) continue;
        const int r = r0 + u;
        bool m = ldb(t.valid + r);
#pragma unroll
        for (int k = 0; k < K; ++k)
          if (k != first) m = m && ld(t.keys + k * n + r) == q[k];
        if (!m) continue;
        found = true;
        const int32_t* row = t.values + static_cast<size_t>(r) * t.v;
        for (int c = 0; c < nv; ++c) acc[c] = add32(acc[c], ld(row + c));
      }
    }
  }
  return found;
}

// exact_sum's found-only form (the CT lookups of K14).
template <int K>
__device__ __forceinline__ bool exact_found(const ExactTab& t, const int32_t (&q)[K]) {
  return exact_sum<K, true>(t, q, 0, nullptr);
}

// maps/policymap.py policy_can_access_batch: the three exact lookups of
// the cascade (L4, L3-only, wildcard identity) in one walk over the K = 4
// table, each summing the value column 0 of its matched rows as the
// reference's row extraction does.
__device__ __forceinline__ void policy_walk(const ExactTab& t, int32_t ident,
                                            int32_t dport, int32_t proto,
                                            int32_t dir, bool& allowed,
                                            int32_t& proxy) {
  const int n = t.n;
  bool f1 = false, f2 = false, f3 = false;
  int32_t v1 = 0, v3 = 0;
  for (int r0 = 0; r0 < n; r0 += kUnroll) {
    int32_t c0[kUnroll];  // the identity column: every key has ident or 0
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) c0[u] = r0 + u < n ? ld(t.keys + r0 + u) : ~ident | 1;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (c0[u] != ident && c0[u] != 0) continue;
      const int r = r0 + u;
      if (ld(t.keys + 3 * n + r) != dir || !ldb(t.valid + r)) continue;
      const int32_t c1 = ld(t.keys + n + r);
      const int32_t c2 = ld(t.keys + 2 * n + r);
      const bool m1 = c0[u] == ident && c1 == dport && c2 == proto;
      const bool m3 = c0[u] == 0 && c1 == dport && c2 == proto;
      f2 |= c0[u] == ident && c1 == 0 && c2 == 0;
      if (m1 || m3) {
        const int32_t v = ld(t.values + static_cast<size_t>(r) * t.v);
        if (m1) {
          f1 = true;
          v1 = add32(v1, v);
        }
        if (m3) {
          f3 = true;
          v3 = add32(v3, v);
        }
      }
    }
  }
  allowed = f1 || f2 || f3;
  proxy = f1 ? v1 : (f2 ? 0 : (f3 ? v3 : 0));
}

// maps/lbmap.py lb{4,6}_select_backend_batch for one flow: the first
// valid row with the VIP and the port (L4), else the first with port 0;
// backend uint32(hash) % max(count, 1), clamped into the table as the
// reference's gather clamps; row 0 and zeros when no service matches.
template <int W>
__device__ __forceinline__ void lb_walk(const LbTab& t, const int32_t (&vip)[W],
                                        int32_t dport, uint32_t hash,
                                        bool& found, int32_t (&target)[W],
                                        int32_t& port, int32_t& rev) {
  const int s = t.s;
  int i4 = -1, i3 = -1;
  for (int r = 0; r < s; ++r) {
    bool m = ldb(t.valid + r);
#pragma unroll
    for (int w = 0; w < W; ++w) m = m && ld(t.vips + w * s + r) == vip[w];
    if (!m) continue;
    const int32_t p = ld(t.ports + r);
    if (p == dport && i4 < 0) i4 = r;
    if (p == 0 && i3 < 0) i3 = r;
  }
  found = i4 >= 0 || i3 >= 0;
  const int idx = i4 >= 0 ? i4 : (i3 >= 0 ? i3 : 0);
  const uint32_t count = static_cast<uint32_t>(max(ld(t.counts + idx), 1));
  const int slave = static_cast<int>(min(hash % count, static_cast<uint32_t>(t.b - 1)));
  const size_t cell = static_cast<size_t>(idx) * t.b + slave;
#pragma unroll
  for (int w = 0; w < W; ++w)
    target[w] = found ? ld(t.b_target + static_cast<size_t>(w) * s * t.b + cell) : 0;
  port = found ? ld(t.b_port + cell) : 0;
  rev = found ? ld(t.revnat + idx) : 0;
}

inline int blocks_for(int f) { return (f + kThreads - 1) / kThreads; }

}  // namespace l34
