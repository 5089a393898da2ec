// Shared by the two first-match rule walks, K4 (r2d2_hits.cu) and K9
// (dns_hits.cu): the launch geometry, the lane groups, the loads of a
// flow's [R] bool row as bit masks, and the remote-set test.
//
// A group of G lanes walks one flow's rule rows (32 / G flows a warp, 256
// / G a block).  A step covers G * V rows: lane q holds rows base + q * V
// .. + V - 1, read from the flow's [F, R] bool row with one load of V
// bytes where R and the base allow it (neighbouring lanes on neighbouring
// bytes, so a group's loads coalesce), else with narrower or byte loads.
// Each lane tests its rows in order and keeps its first hit; a ballot
// over the group gives the lowest lane with one, which holds the step's
// first hit: that is the flow's first matching row, and the group stops.
// The step loop ends on a warp vote, so every lane runs every ballot and
// shuffle.  The rule tables are staged in shared memory once a block, in
// tiles of rows when they do not fit, and the remote ids with them up to
// kIdsRows rows; blocks are persistent (as many as the card holds), so
// the staging is paid once a block, not once a flow.  A lane loads what
// its flow needs, and its first step's bytes, before the staging, so the
// two wait for device memory together.
#pragma once

#include <initializer_list>

#include "common.cuh"

namespace walk {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kMaxRemotes = 32;  // models/base.py MAX_REMOTES
// Remote-id tables of at most this many rows (16 KB) are staged in shared
// memory; a larger one is read from device memory, a row where a test
// needs it.
constexpr int kIdsRows = 128;

struct Geometry {
  int lanes;  // G: lanes a flow
  int rows;   // V: rows a lane a step
};

// The variant a launch takes, from the row count R and the flow count F:
// lanes a flow, a power of two, as many as keep F x G within `threads`
// (past that the card is full and more lanes only add steps' overhead),
// but enough that max_rows a lane cover R in `steps` steps, at most a warp
// and no more than R; then the fewest rows a lane (1, 4, 8 or 16, at most
// max_rows) that cover R in one step, else max_rows.
inline Geometry geometry(int R, int F, int threads, int max_rows, int steps) {
  Geometry g;
  g.lanes = 1;
  while (g.lanes < 32 && g.lanes < R &&
         (2LL * g.lanes * F <= threads || static_cast<long long>(g.lanes) * max_rows * steps < R))
    g.lanes *= 2;
  g.rows = max_rows;
  for (int v : {1, 4, 8, 16}) {
    if (v <= max_rows && static_cast<long long>(g.lanes) * v >= R) {
      g.rows = v;
      break;
    }
  }
  return g;
}

// The widest load (16, 8, 4 or 1 bytes, at most V) that every row of an
// [F, R] bool matrix at p allows: R and the base are multiples of it.
inline int load_width(int V, int R, const void* p) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  for (int w = V; w >= 4; w /= 2)
    if (R % w == 0 && a % w == 0) return w;
  return 1;
}

// Runs fn.run<G, V>() for the geometry's variant.
template <int G, typename Fn>
cudaError_t dispatch_rows(int rows, const Fn& fn) {
  switch (rows) {
    case 1: return fn.template run<G, 1>();
    case 4: return fn.template run<G, 4>();
    case 8: return fn.template run<G, 8>();
    default: return fn.template run<G, 16>();
  }
}

template <typename Fn>
cudaError_t dispatch(const Geometry& g, const Fn& fn) {
  switch (g.lanes) {
    case 1: return dispatch_rows<1>(g.rows, fn);
    case 2: return dispatch_rows<2>(g.rows, fn);
    case 4: return dispatch_rows<4>(g.rows, fn);
    case 8: return dispatch_rows<8>(g.rows, fn);
    case 16: return dispatch_rows<16>(g.rows, fn);
    default: return dispatch_rows<32>(g.rows, fn);
  }
}

// The geometry packed as an int (lanes | rows << 8), for the wrappers'
// kernels.hits_variant.
inline int packed(const Geometry& g) { return g.lanes | g.rows << 8; }

// The lanes of one flow.
template <int G>
struct Group {
  int q;           // lane within the group
  unsigned first;  // the group's first lane in the warp

  __device__ Group() : q(threadIdx.x & (G - 1)), first(threadIdx.x & 31 & ~(G - 1)) {}

  // Bit j: pred on the group's lane j.
  __device__ unsigned ballot(bool pred) const {
    if (G == 1) return pred ? 1u : 0u;
    const unsigned b = __ballot_sync(kFull, pred);
    if (G == 32) return b;
    return (b >> first) & ((1u << (G & 31)) - 1u);
  }
  // v of the group's lane src.
  __device__ int from(int v, int src) const {
    if (G == 1) return v;
    return __shfl_sync(kFull, v, src, G);
  }
  // v of the lowest group lane whose bit is set in bits (any lane if none).
  __device__ int lowest(int v, unsigned bits) const { return from(v, bits ? __ffs(bits) - 1 : 0); }
};

// Bits 0-3: bytes 0-3 of w are nonzero (SWAR: no carry crosses a byte,
// and one multiply moves the four flags to bits 21-24).
__device__ __forceinline__ unsigned nonzero4(unsigned w) {
  const unsigned t = ((((w & 0x7f7f7f7fu) + 0x7f7f7f7fu) | w) & 0x80808080u) >> 7;
  return ((t * 0x00204081u) >> 21) & 0xFu;
}

// Bit j (j < V): byte c + j of row is nonzero, for c + j < n; 0 past n.
// c is a multiple of V and n of the load width w (R and the tile start
// are), so each load of w bytes lies inside the row.
template <int V>
__device__ __forceinline__ unsigned row_bits(const uint8_t* __restrict__ row, int c, int n, int w) {
  unsigned m = 0;
  if (V >= 16 && w == 16) {
    if (c < n) {
      const uint4 x = __ldg(reinterpret_cast<const uint4*>(row + c));
      m = nonzero4(x.x) | nonzero4(x.y) << 4 | nonzero4(x.z) << 8 | nonzero4(x.w) << 12;
    }
  } else if (V >= 8 && w == 8) {
#pragma unroll
    for (int k = 0; k < V; k += 8) {
      if (c + k < n) {
        const uint2 x = __ldg(reinterpret_cast<const uint2*>(row + c + k));
        m |= (nonzero4(x.x) | nonzero4(x.y) << 4) << k;
      }
    }
  } else if (V >= 4 && w == 4) {
#pragma unroll
    for (int k = 0; k < V; k += 4)
      if (c + k < n) m |= nonzero4(__ldg(reinterpret_cast<const unsigned*>(row + c + k))) << k;
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k)
      if (c + k < n && __ldg(row + c + k)) m |= 1u << k;
  }
  return m;
}

// A bool (one byte, any nonzero value true) through the read-only path.
__device__ __forceinline__ bool flag(const bool* p) {
  return __ldg(reinterpret_cast<const uint8_t*>(p)) != 0;
}

// remote in a row of ids staged in shared memory (8 int4): every slot
// compared.  Each lane starts at its own quarter-line (rot), so the lanes
// of a warp that test different rows at once read different banks.
__device__ __forceinline__ bool remote_in_shared(const int4* ids, int remote, int rot) {
  bool hit = false;
#pragma unroll
  for (int k = 0; k < kMaxRemotes / 4; ++k) {
    const int4 x = ids[(k + rot) & (kMaxRemotes / 4 - 1)];
    hit |= (x.x == remote) | (x.y == remote) | (x.z == remote) | (x.w == remote);
  }
  return hit;
}

// The [R, kMaxRemotes] remote ids into s_ids (R * 8 int4).  vec: ids is
// 16-byte aligned.
__device__ void stage_ids(const int32_t* __restrict__ ids, int4* s_ids, int R, bool vec) {
  const int n = R * (kMaxRemotes / 4);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (vec) {
      s_ids[i] = __ldg(reinterpret_cast<const int4*>(ids) + i);
    } else {
      s_ids[i] = make_int4(__ldg(ids + 4 * i), __ldg(ids + 4 * i + 1), __ldg(ids + 4 * i + 2),
                           __ldg(ids + 4 * i + 3));
    }
  }
}

// remote in ids[0, kMaxRemotes) in device memory: every slot compared
// (the rows need be neither sorted nor padded in any one way).  vec: ids
// is 16-byte aligned.
__device__ __forceinline__ bool remote_in(const int32_t* __restrict__ ids, int remote, bool vec) {
  bool hit = false;
  if (vec) {
#pragma unroll
    for (int k = 0; k < kMaxRemotes / 4; ++k) {
      const int4 x = __ldg(reinterpret_cast<const int4*>(ids) + k);
      hit |= (x.x == remote) | (x.y == remote) | (x.z == remote) | (x.w == remote);
    }
  } else {
#pragma unroll 8
    for (int k = 0; k < kMaxRemotes; ++k) hit |= __ldg(ids + k) == remote;
  }
  return hit;
}

// Persistent blocks: as many as the card holds at once, at most one a
// tile of flows.
template <typename Kernel>
cudaError_t grid_for(Kernel kernel, int tiles, size_t smem, int* blocks) {
  int resident = 0;
  const cudaError_t err = resident_blocks(kernel, kThreads, smem, &resident);
  if (err != cudaSuccess) return err;
  *blocks = std::max(1, std::min(tiles, resident));
  return cudaSuccess;
}

}  // namespace walk
