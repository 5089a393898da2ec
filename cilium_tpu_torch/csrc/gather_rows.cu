// K16 gather_rows: the sidecar's blob-to-rows build.
//
// Replaces the row gather of cilium_tpu/sidecar/service.py:165
// (_gather_model), before the model call:
//   rows[i, c] = c < lens[i] ? blob[clip(offs[i] + c, 0, B - 1)] : 0
// for a flat payload blob (uint8 [B]; the service uploads one
// BLOB_CHUNK = 65,536-byte window per chunk), int32 offsets and lengths
// [F] and the batch width W (256 at the service's defaults).  The clip is
// the reference's jnp.clip: an entry whose window runs past the blob
// repeats blob[B - 1] wherever c < lens[i]; a negative or zero length
// gives a row of zeros.
//
// Bound on the H100: bytes (F x W written, at most B read, 8F of offsets
// and lengths): about 0.6 MB for a 2,048-row bucket, 0.18 us at
// 3.35 TB/s, so a single launch's fixed cost sets its time.
// Design: a grid-stride loop over F x ceil(W / 16) pieces; each thread
// builds 16 output bytes in registers from byte loads of the blob (the
// blob is 64 KB and stays in L1/L2; the 16 source bytes are not aligned)
// and stores them as one uint4 where the row is 16-byte aligned, byte by
// byte otherwise.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPiece = 16;

__global__ void gather_rows_kernel(const uint8_t* __restrict__ blob,
                                   int blob_len,
                                   const int32_t* __restrict__ offs,
                                   const int32_t* __restrict__ lens, int n,
                                   int width, uint8_t* __restrict__ rows) {
  const int pieces = (width + kPiece - 1) / kPiece;
  const long long total = static_cast<long long>(n) * pieces;
  const bool vec = (width % kPiece) == 0;
  for (long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       t < total; t += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int i = static_cast<int>(t / pieces);
    const int c0 = static_cast<int>(t % pieces) * kPiece;
    const long long off = offs[i];
    const int len = lens[i];
    uint8_t* out = rows + static_cast<long long>(i) * width + c0;
    uint8_t b[kPiece];
#pragma unroll
    for (int k = 0; k < kPiece; ++k) {
      const int c = c0 + k;
      long long g = off + c;
      g = g < 0 ? 0 : (g > blob_len - 1 ? blob_len - 1 : g);
      b[k] = c < len ? __ldg(blob + g) : 0;
    }
    if (vec) {
      uint4 v;
      v.x = b[0] | (b[1] << 8) | (b[2] << 16) | (static_cast<uint32_t>(b[3]) << 24);
      v.y = b[4] | (b[5] << 8) | (b[6] << 16) | (static_cast<uint32_t>(b[7]) << 24);
      v.z = b[8] | (b[9] << 8) | (b[10] << 16) | (static_cast<uint32_t>(b[11]) << 24);
      v.w = b[12] | (b[13] << 8) | (b[14] << 16) | (static_cast<uint32_t>(b[15]) << 24);
      *reinterpret_cast<uint4*>(out) = v;
    } else {
      const int m = width - c0 < kPiece ? width - c0 : kPiece;
      for (int k = 0; k < m; ++k) out[k] = b[k];
    }
  }
}

}  // namespace

CILIUM_EXPORT int gather_rows(const uint8_t* blob, int blob_len,
                              const int32_t* offs, const int32_t* lens,
                              int n, int width, uint8_t* rows,
                              void* stream) {
  const long long pieces =
      static_cast<long long>(n) * ((width + kPiece - 1) / kPiece);
  const long long want = (pieces + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  if (blocks > 0) {
    gather_rows_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        blob, blob_len, offs, lens, n, width, rows);
  }
  return static_cast<int>(cudaGetLastError());
}
