// Shared by the two ACL walks, K10 (cassandra_hits.cu) and K11
// (memcache_hits.cu): 16-byte loads and masked compares of actions, keys
// and needles, and the remote test of a set of passing rows.
//
// Their direct walk, for tables of a few rows: a thread a request issues
// every load of its request (lengths, flags, remote, the first bytes of
// its action or key, its automaton row) and of the tables' rows together,
// through the read-only path (the tables at one address a warp: a
// broadcast), then tests the rows from registers, with no staging and no
// block barrier: at two or three rows a staged table's round trip and
// barrier cost more than the walk (K17's lesson, PERF.md), and a load
// issued after a test of another load's value waits for it, so a row read
// where its test needs it puts a round trip per load on the request's
// chain.  K11 has this walk alone; past its kDirectRows K10 takes
// rule_walk.cuh's lane groups over tables staged in shared memory.
#pragma once

#include "rule_walk.cuh"

namespace acl {

// The direct walk loads at most this many rows at once (R rounded up to 1,
// 2, 4 or 8); past them it takes the rest a row at a time.
constexpr int kRowsAtOnce = 8;

// 16 bytes at p + c, zeros where c >= n: one 16-byte load where vec (p +
// c 16-byte aligned, the chunk inside the row), else byte loads up to n.
__device__ __forceinline__ uint4 load16(const uint8_t* __restrict__ p, int c, int n, bool vec) {
  uint4 out = make_uint4(0u, 0u, 0u, 0u);
  if (c >= n) return out;
  if (vec) return __ldg(reinterpret_cast<const uint4*>(p + c));
  unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (c + i < n) w[i >> 2] |= static_cast<unsigned>(__ldg(p + c + i)) << (8 * (i & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The bytes of a 4-byte word to keep when keep of them count (any int).
__device__ __forceinline__ unsigned keep_mask(int keep) {
  return keep >= 4 ? ~0u : keep > 0 ? (1u << (8 * keep)) - 1u : 0u;
}

// x with its bytes at and past keep (of 16) zeroed.
__device__ __forceinline__ uint4 masked(const uint4& x, int keep) {
  return make_uint4(x.x & keep_mask(keep), x.y & keep_mask(keep - 4), x.z & keep_mask(keep - 8),
                    x.w & keep_mask(keep - 12));
}

// x and y are equal.
__device__ __forceinline__ bool equal16(const uint4& x, const uint4& y) {
  return ((x.x ^ y.x) | (x.y ^ y.y) | (x.z ^ y.z) | (x.w ^ y.w)) == 0u;
}

// x and y agree on their first keep bytes (of 16).
__device__ __forceinline__ bool same16(const uint4& x, const uint4& y, int keep) {
  return (((x.x ^ y.x) & keep_mask(keep)) | ((x.y ^ y.y) & keep_mask(keep - 4)) |
          ((x.z ^ y.z) & keep_mask(keep - 8)) | ((x.w ^ y.w) & keep_mask(keep - 12))) == 0u;
}

// Some row of pass (bit j: row r0 + j) admits the remote: at once where
// one of them is open to any remote (bit j of open), else the others' ids
// compared in order.
__device__ __forceinline__ bool remote_pass(unsigned pass, unsigned open, const int32_t* __restrict__ ids,
                                            int r0, int remote, bool ids16) {
  if (pass & open) return true;
  for (unsigned m = pass; m; m &= m - 1u)
    if (walk::remote_in(ids + static_cast<size_t>(r0 + __ffs(m) - 1) * walk::kMaxRemotes, remote, ids16))
      return true;
  return false;
}

}  // namespace acl
