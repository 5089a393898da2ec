// Shared device code of the L3/L4 kernels K12-K15 (lpm.cu, l34_tables.cu,
// datapath.cu, ingress.cu): the table layouts the Python side packs (its
// ctypes mirrors are LpmTab in ops/lpm.py, ExactTab in ops/maplookup.py
// and LbTab in maps/lbmap.py), the flow hash and the int32 arithmetic.
// The lookups themselves probe the tables' hashed indexes
// (l34_index.cuh); only K12 keeps a row walk, for prefix tables of many
// mask groups and few rows (lpm.cu).  All address and hash arithmetic is
// in uint32_t: the reference's int32 wraparound is defined there, signed
// overflow is not.
#pragma once

#include "common.cuh"

#include <climits>

namespace l34 {

constexpr int kThreads = 128;  // a multiple of 32: every warp is whole
constexpr int kWorldId = 2;    // datapath/pipeline.py WORLD_ID
constexpr int kMaxKeyCols = 11;

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

inline int blocks_for(int f) { return (f + kThreads - 1) / kThreads; }

}  // namespace l34
