// Shared by the two framing kernels, K1 (r2d2_frame.cu) and K5
// (http_frame.cu): the launch geometry, the lane groups, the 16-byte loads
// and the byte masks they scan a row with.
//
// A group of G lanes owns one row (32 / G rows a warp).  A step covers
// S = 16 * G * V bytes: lane q holds V chunks of 16 bytes, chunk v at
// base + 16 * (v * G + q), so each group load is G neighbouring 16-byte
// pieces.  Every lane turns its chunk into bit masks (bit i = byte i of
// the chunk) with SWAR compares; the group settles "first" and "last"
// questions with one ballot and one shuffle.  The next step's chunks are
// loaded before the current step is classified, and a row's first
// kEager bytes before its length arrives (they lie inside the row whatever
// the length is).  No load reaches byte L of its row: the last row ends
// the allocation.  Bytes in [min(len, L), L) may be loaded; the validity
// masks keep them from counting.
#pragma once

#include "common.cuh"

namespace frame {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kEager = 128;
constexpr int kInf = 1 << 30;  // "not found" inside a row
constexpr unsigned kCR = 0x0d0d0d0du, kLF = 0x0a0a0a0au, kSP = 0x20202020u;

struct Geometry {
  int lanes;     // G: lanes a row
  int vecs;      // V: 16-byte chunks a lane a step
  bool aligned;  // 16-byte loads (every row base 16-byte aligned), else byte loads
};

// A batch of at most kFewRows rows wider than kWideRow takes a warp a row,
// and 4 chunks a lane past kLongRow (chip_frame_variants.py's readings).
constexpr int kFewRows = 1024, kWideRow = 256, kLongRow = 2048;

// The variant a launch takes, from the row width, the rows and the data
// pointer.  The scan is bound by its instructions, and a warp steps until
// its slowest row is done, so 4 lanes a row (64 bytes a step) fill a big
// batch's warps with rows; in a batch of a few wide rows the dependent
// steps of a long row set the time, so a warp a row (512 bytes a step, or
// 2,048 at 4 chunks a lane: a 32 KB head takes 16 steps).
inline Geometry geometry(int L, int F, const void* data) {
  Geometry g;
  const bool wide = F <= kFewRows && L > kWideRow;
  g.lanes = wide ? 32 : 4;
  g.vecs = wide && L > kLongRow ? 4 : 1;
  g.aligned = L % 16 == 0 && reinterpret_cast<uintptr_t>(data) % 16 == 0;
  return g;
}

// Runs fn.run<G, V, A>() for the geometry's variant.
template <bool A, typename Fn>
cudaError_t dispatch_lanes(const Geometry& g, const Fn& fn) {
  if (g.lanes == 4) return fn.template run<4, 1, A>();
  return g.vecs == 4 ? fn.template run<32, 4, A>() : fn.template run<32, 1, A>();
}

template <typename Fn>
cudaError_t dispatch(const Geometry& g, const Fn& fn) {
  return g.aligned ? dispatch_lanes<true>(g, fn) : dispatch_lanes<false>(g, fn);
}

// The lanes of one row.  Every lane of the warp runs every ballot and
// shuffle (the step loop ends on a warp vote), so the full mask holds.
template <int G>
struct Group {
  int q;           // lane within the group
  unsigned first;  // the group's first lane in the warp

  __device__ Group() : q(threadIdx.x & (G - 1)), first(threadIdx.x & 31 & ~(G - 1)) {}

  // Bit j: pred on the group's lane j.
  __device__ unsigned ballot(bool pred) const {
    const unsigned b = __ballot_sync(kFull, pred);
    if (G == 32) return b;
    return (b >> first) & ((1u << (G & 31)) - 1u);
  }
  // v of the group's lane src.
  __device__ int from(int v, int src) const { return __shfl_sync(kFull, v, src, G); }
  __device__ unsigned from(unsigned v, int src) const { return __shfl_sync(kFull, v, src, G); }
  // v of lane q + 1 (lane G - 1 gets its own).
  __device__ unsigned down(unsigned v) const { return __shfl_down_sync(kFull, v, 1, G); }
  // v of the lowest / highest group lane whose bit is set in bits (any lane if none).
  __device__ int lowest(int v, unsigned bits) const { return from(v, bits ? __ffs(bits) - 1 : 0); }
  __device__ int highest(int v, unsigned bits) const {
    return from(v, bits ? 31 - __clz(bits) : 0);
  }
};

// The 16 bytes at row + c, zeros where c >= lim (lim <= L).  Aligned: one
// 16-byte load (c is a multiple of 16 and L too, so c < L keeps the load
// inside the row).  Else one byte load each, none at or past L.
template <bool A>
__device__ __forceinline__ uint4 load16(const uint8_t* __restrict__ row, int c, int lim, int L) {
  uint4 out = make_uint4(0u, 0u, 0u, 0u);
  if (c >= lim) return out;
  if (A) return __ldg(reinterpret_cast<const uint4*>(row + c));
  unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (c + i < L) w[i >> 2] |= static_cast<unsigned>(__ldg(row + c + i)) << (8 * (i & 3));
  out.x = w[0];
  out.y = w[1];
  out.z = w[2];
  out.w = w[3];
  return out;
}

// 0x80 in each byte of t that is zero, else 0 (exact: no borrow crosses bytes).
__device__ __forceinline__ unsigned zero_bytes(unsigned t) {
  return ~(((t & 0x7f7f7f7fu) + 0x7f7f7f7fu) | t) & 0x80808080u;
}

// The byte flags of two zero_bytes words as bits 0-7 (lo's bytes first):
// one multiply moves byte k's flag of lo to bit 24 + k and of hi to 28 + k.
__device__ __forceinline__ unsigned gather8(unsigned lo, unsigned hi) {
  return (((lo >> 7) | (hi >> 3)) * 0x01020408u) >> 24;
}

// Bit i: chunk byte i equals b's byte (b = that byte in all four lanes).
__device__ __forceinline__ unsigned byte_mask(const unsigned (&w)[5], unsigned b) {
  return gather8(zero_bytes(w[0] ^ b), zero_bytes(w[1] ^ b)) |
         gather8(zero_bytes(w[2] ^ b), zero_bytes(w[3] ^ b)) << 8;
}

// Bit i: chunk bytes i, i + 1 are CR LF, for i in [0, 18) (w[4] is the
// next chunk's first word).
__device__ __forceinline__ unsigned crlf_mask(const unsigned (&w)[5]) {
  unsigned z[5];
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    const unsigned s = j < 4 ? __funnelshift_r(w[j], w[j + 1 < 5 ? j + 1 : 4], 8)  // bytes 4j+1 .. 4j+4
                             : w[4] >> 8;
    z[j] = zero_bytes((w[j] ^ kCR) | (s ^ kLF));
  }
  return gather8(z[0], z[1]) | gather8(z[2], z[3]) << 8 | (gather8(z[4], 0u) & 3u) << 16;
}

// Bits [0, x) of a 16-bit mask (none for x <= 0, all for x >= 16).
__device__ __forceinline__ unsigned below(int x) { return 0xffffu >> (16 - min(max(x, 0), 16)); }

// Chunk v's first byte for lane q at a step's base.
template <int G>
__device__ __forceinline__ int chunk(int base, int v, int q) {
  return base + 16 * (v * G + q);
}

// Chunk v's 16 bytes as words, and the next chunk's first word: lane
// q + 1's, or for the group's last lane chunk v + 1's first lane, or the
// next step's (nxt).  Every lane runs both shuffles.  Called in loops over
// v that unroll, so the arrays stay in registers.
template <int G, int V>
__device__ __forceinline__ void words(const Group<G>& g, const uint4 (&cur)[V], const uint4 (&nxt)[V],
                                      int v, unsigned (&w)[5]) {
  w[0] = cur[v].x;
  w[1] = cur[v].y;
  w[2] = cur[v].z;
  w[3] = cur[v].w;
  const unsigned down = g.down(cur[v].x);
  const unsigned head = g.from(v + 1 < V ? cur[(v + 1) % V].x : nxt[0].x, 0);
  w[4] = g.q == G - 1 ? head : down;
}

}  // namespace frame

// The variant the framing launchers take for F rows of width L at data:
// lanes | vecs << 8 | aligned << 16 (for tests and timings).
CILIUM_EXPORT int frame_variant(int L, int F, const void* data) {
  const frame::Geometry g = frame::geometry(L, F, data);
  return g.lanes | g.vecs << 8 | (g.aligned ? 1 : 0) << 16;
}
