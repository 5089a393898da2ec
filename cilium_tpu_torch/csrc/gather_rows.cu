// K16 gather_rows: the sidecar's blob-to-rows build.
//
// Replaces the row gather of cilium_tpu/sidecar/service.py:165
// (_gather_model), before the model call:
//   rows[i, c] = c < lens[i] ? blob[clip(offs[i] + c, 0, B - 1)] : 0
// for a flat payload blob (uint8 [B]; the service uploads one
// BLOB_CHUNK = 65,536-byte window per chunk), int32 offsets and lengths
// [F] and the batch width W (256 at the service's defaults, 64 in the
// seam benchmarks).  The clip is the reference's jnp.clip: an entry whose
// window runs past the blob repeats blob[B - 1] wherever c < lens[i]; a
// negative or zero length gives a row of zeros.
//
// Bound on the H100: bytes (F x W written, at most B read, 8F of offsets
// and lengths): about 0.6 MB for a 2,048-row bucket, 0.18 us at
// 3.35 TB/s, so a single launch's fixed cost sets its time, with two
// dependent trips to memory (the offsets, then the blob words they point
// at) and the stores of the rows behind it.
// Design: a group of G lanes owns a row (G = 16 at W = 256, 4 at W = 64),
// one 16-byte piece of the row a lane, looping where the row has more
// than G pieces; rows and lanes come from threadIdx / blockIdx by shifts.
// Fast path: a lane loads the aligned 16-byte word of the blob that holds
// its piece's first byte (one ld.global.nc.v4), takes the next word from
// its neighbour lane with a shuffle (the group's last lane loads it
// itself), shifts the pair by the misalignment with funnel shifts, zeroes
// the bytes at or past the length with a SWAR mask and stores one uint4.
// It applies where both aligned words lie inside the blob (addresses are
// aligned absolutely, so a blob view at any byte offset takes it too):
// no byte of the piece can then need the clip.  Byte path, the same
// clipped byte loads as before: a piece before the blob's start (a
// negative offset) or whose words reach past its end (a window at
// B - 1).  Rows store one uint4 a piece where W is a multiple of 16 and
// the rows are 16-byte aligned, else byte by byte.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLanes = 16;
constexpr unsigned kFull = 0xffffffffu;

// Word j's mask of the first `keep` bytes of a 16-byte piece.
__device__ __forceinline__ unsigned keep_mask(int keep, int j) {
  const int b = min(max(keep - 4 * j, 0), 4);
  return b == 4 ? kFull : (1u << (8 * b)) - 1u;
}

// Bytes [sh, sh + 16) of the 32 bytes lo:hi, their first `keep` kept.
__device__ __forceinline__ uint4 shift_keep(uint4 lo, uint4 hi, int sh, int keep) {
  const unsigned a[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const int q = sh >> 2;
  const unsigned r = 8u * (sh & 3);
  unsigned b[5];
#pragma unroll
  for (int j = 0; j < 5; ++j)  // words q .. q + 4 of a, by selects (no local memory)
    b[j] = q == 0 ? a[j] : q == 1 ? a[j + 1] : q == 2 ? a[j + 2] : a[j + 3];
  uint4 out;
  out.x = __funnelshift_r(b[0], b[1], r) & keep_mask(keep, 0);
  out.y = __funnelshift_r(b[1], b[2], r) & keep_mask(keep, 1);
  out.z = __funnelshift_r(b[2], b[3], r) & keep_mask(keep, 2);
  out.w = __funnelshift_r(b[3], b[4], r) & keep_mask(keep, 3);
  return out;
}

// The byte path: the first `keep` bytes at blob offset s, each clipped
// into [0, B).
__device__ __forceinline__ uint4 clipped_bytes(const uint8_t* __restrict__ blob,
                                               long long B, long long s, int keep) {
  unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    if (k < keep) {
      long long g = s + k;
      g = g < 0 ? 0 : (g > B - 1 ? B - 1 : g);
      w[k >> 2] |= static_cast<unsigned>(__ldg(blob + g)) << (8 * (k & 3));
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ uint4 shfl_down4(uint4 v, int width) {
  return make_uint4(__shfl_down_sync(kFull, v.x, 1, width), __shfl_down_sync(kFull, v.y, 1, width),
                    __shfl_down_sync(kFull, v.z, 1, width), __shfl_down_sync(kFull, v.w, 1, width));
}

// Every lane of a warp runs every shuffle: the row and piece loops are
// uniform across the block, and a lane past the last row or piece only
// loads and stores nothing.
template <int G>
__global__ void gather_rows_kernel(const uint8_t* __restrict__ blob, int blob_len,
                                   const int32_t* __restrict__ offs,
                                   const int32_t* __restrict__ lens, int n, int width,
                                   uint8_t* __restrict__ rows, bool vec_store) {
  constexpr int kRows = kThreads / G;
  const int q = threadIdx.x & (G - 1);
  const int pieces = (width + 15) >> 4;
  const int steps = (pieces + G - 1) / G;
  const long long B = blob_len;
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(blob) & 15);
  for (int first = blockIdx.x * kRows; first < n; first += gridDim.x * kRows) {
    const int i = first + threadIdx.x / G;
    const bool live = i < n;
    const long long off = live ? offs[i] : 0;
    const int len = live ? lens[i] : 0;
    uint8_t* out = rows + static_cast<size_t>(live ? i : 0) * width;
    for (int step = 0; step < steps; ++step) {
      const int p = step * G + q;
      const int c0 = p * 16;
      const long long s = off + c0;                   // the piece's first byte in the blob
      const long long a0 = ((s + mis) & ~15LL) - mis;  // its aligned word's offset
      const int sh = static_cast<int>((s + mis) & 15);
      const int keep = len <= c0 ? 0 : min(len - c0, 16);
      // The word a lane loads is its left neighbour's second word too.
      uint4 lo = make_uint4(0u, 0u, 0u, 0u);
      if (live && a0 >= 0 && a0 + 16 <= B && c0 - 16 < len)
        lo = __ldg(reinterpret_cast<const uint4*>(blob + a0));
      uint4 hi = shfl_down4(lo, G);
      const bool fast = a0 >= 0 && a0 + 32 <= B;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (keep > 0) {
        if (fast) {
          if (q == G - 1 && sh != 0) hi = __ldg(reinterpret_cast<const uint4*>(blob + a0 + 16));
          v = shift_keep(lo, hi, sh, keep);
        } else {
          v = clipped_bytes(blob, B, s, keep);
        }
      }
      if (live && p < pieces) {
        if (vec_store) {
          *reinterpret_cast<uint4*>(out + c0) = v;
        } else {
          const unsigned w[4] = {v.x, v.y, v.z, v.w};
          const int m = min(width - c0, 16);
          for (int k = 0; k < m; ++k) out[c0 + k] = static_cast<uint8_t>(w[k >> 2] >> (8 * (k & 3)));
        }
      }
    }
  }
}

template <int G>
cudaError_t launch(const uint8_t* blob, int blob_len, const int32_t* offs, const int32_t* lens,
                   int n, int width, uint8_t* rows, bool vec_store, cudaStream_t stream) {
  constexpr int kRows = kThreads / G;
  const long long want = (static_cast<long long>(n) + kRows - 1) / kRows;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  gather_rows_kernel<G><<<blocks, kThreads, 0, stream>>>(blob, blob_len, offs, lens, n, width,
                                                         rows, vec_store);
  return cudaGetLastError();
}

}  // namespace

CILIUM_EXPORT int gather_rows(const uint8_t* blob, int blob_len,
                              const int32_t* offs, const int32_t* lens,
                              int n, int width, uint8_t* rows,
                              void* stream) {
  if (n <= 0 || width <= 0) return static_cast<int>(cudaGetLastError());
  const int pieces = (width + 15) / 16;
  int lanes = 1;  // the smallest power of two that covers the pieces, at most 16
  while (lanes < pieces && lanes < kMaxLanes) lanes *= 2;
  const bool vec_store = width % 16 == 0 && reinterpret_cast<uintptr_t>(rows) % 16 == 0;
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (lanes) {
    case 1: err = launch<1>(blob, blob_len, offs, lens, n, width, rows, vec_store, s); break;
    case 2: err = launch<2>(blob, blob_len, offs, lens, n, width, rows, vec_store, s); break;
    case 4: err = launch<4>(blob, blob_len, offs, lens, n, width, rows, vec_store, s); break;
    case 8: err = launch<8>(blob, blob_len, offs, lens, n, width, rows, vec_store, s); break;
    default: err = launch<16>(blob, blob_len, offs, lens, n, width, rows, vec_store, s); break;
  }
  return static_cast<int>(err);
}
