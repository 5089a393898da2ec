// K18 seqdfa: long-frame DFA search by chunk folding, in two launchers.
//
// Replaces cilium_tpu/ops/seqdfa.py:137 (seqdfa_search_batch): _fold_chunk
// (:68), _compose (:113) and _apply_start_accept (:121).  The TPU version
// carried each chunk's state map as an [S, S] one-hot int8 matrix, built
// one per byte by one-hot matmuls and composed by matmul.  A state map
// is a function, so here it is the target of each start state.
//
// seqdfa_fold: one thread per (flow f, pattern r, chunk k, start state s0)
// runs the absorbing DFA from s0 over chunk k's active bytes (positions
// below lengths[f]; the rest are the identity) and writes
// maps[f, r, k, s0] (uint8: the host keeps S <= 128).  Consecutive
// threads hold consecutive s0, so the maps are written coalesced and a
// warp's threads read the same data byte (a broadcast).  The classmap
// and, where it fits, the delta table [R, S, C] live in shared memory;
// a larger table is read through L1.  Padded states are folded like any
// other (their targets are valid ids) and never selected by the apply.
//
// seqdfa_apply: one thread per (f, r) walks s = start[r];
// s = maps[f, r, k, s] for k in chunk order and writes accept_final[r, s].
//
// Bound on the H100: operations.  The fold does S table steps per active
// (flow, pattern, byte) where the serial scan (K2) does one, for K*S
// times the parallelism; the bytes are the batch once, the maps
// [F, R, K, S] written and read once and the [F, R] output.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxStates = 128;
// Dynamic shared memory for the delta table; larger tables are read from
// device memory through L1.
constexpr size_t kMaxSmemTable = 160 * 1024;

__global__ void seqdfa_fold_kernel(const uint8_t* __restrict__ data,
                                   const int32_t* __restrict__ lengths,
                                   const uint8_t* __restrict__ classmap,
                                   const uint8_t* __restrict__ delta, int F,
                                   int W, int R, int S, int C, int K,
                                   bool smem_table,
                                   uint8_t* __restrict__ maps) {
  extern __shared__ uint8_t smem[];
  uint8_t* cls_s = smem;
  uint8_t* delta_s = smem + 256;
  for (int i = threadIdx.x; i < 256; i += blockDim.x) cls_s[i] = classmap[i];
  if (smem_table) {
    const int n = R * S * C;
    for (int i = threadIdx.x; i < n; i += blockDim.x) delta_s[i] = delta[i];
  }
  __syncthreads();

  const long long total = static_cast<long long>(F) * R * K * S;
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int s0 = static_cast<int>(idx % S);
  long long q = idx / S;
  const int k = static_cast<int>(q % K);
  q /= K;
  const int r = static_cast<int>(q % R);
  const int f = static_cast<int>(q / R);

  const int lc = W / K;
  const int t0 = k * lc;
  const int end = min(lc, lengths[f] - t0);  // < 0: nothing active
  const uint8_t* row = data + static_cast<size_t>(f) * W + t0;
  const uint8_t* tab =
      (smem_table ? delta_s : delta) + static_cast<size_t>(r) * S * C;

  int s = s0;
  int j = 0;
  if ((reinterpret_cast<uintptr_t>(row) & 15) == 0) {
    for (; j + 16 <= end; j += 16) {
      const uint4 v = *reinterpret_cast<const uint4*>(row + j);
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          s = tab[s * C + cls_s[(w[i] >> (8 * b)) & 0xff]];
        }
      }
    }
  }
  for (; j < end; ++j) s = tab[s * C + cls_s[row[j]]];
  maps[idx] = static_cast<uint8_t>(s);
}

__global__ void seqdfa_apply_kernel(const uint8_t* __restrict__ maps,
                                    const uint8_t* __restrict__ start,
                                    const bool* __restrict__ accept_final,
                                    int F, int R, int S, int K,
                                    bool* __restrict__ out) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(F) * R) return;
  const int r = static_cast<int>(idx % R);
  const uint8_t* m = maps + idx * K * S;
  int s = start[r];
  for (int k = 0; k < K; ++k) s = m[k * S + s];
  out[idx] = accept_final[r * S + s];
}

}  // namespace

CILIUM_EXPORT int seqdfa_fold(const void* data, const void* lengths,
                              const void* classmap, const void* delta, int F,
                              int W, int R, int S, int C, int K, void* maps,
                              void* stream) {
  if (K < 1 || W % K != 0 || S < 1 || S > kMaxStates || C < 1) {
    return cudaErrorInvalidValue;
  }
  const long long total = static_cast<long long>(F) * R * K * S;
  if (total <= 0) return cudaSuccess;
  const size_t table = static_cast<size_t>(R) * S * C;
  const bool smem_table = table <= kMaxSmemTable;
  const size_t smem = 256 + (smem_table ? table : 0);
  cudaError_t err = allow_smem(seqdfa_fold_kernel, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (total + kThreads - 1) / kThreads;
  seqdfa_fold_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data),
      static_cast<const int32_t*>(lengths),
      static_cast<const uint8_t*>(classmap),
      static_cast<const uint8_t*>(delta), F, W, R, S, C, K, smem_table,
      static_cast<uint8_t*>(maps));
  return cudaGetLastError();
}

CILIUM_EXPORT int seqdfa_apply(const void* maps, const void* start,
                               const void* accept_final, int F, int R, int S,
                               int K, void* out, void* stream) {
  if (K < 1 || S < 1 || S > kMaxStates) return cudaErrorInvalidValue;
  const long long total = static_cast<long long>(F) * R;
  if (total <= 0) return cudaSuccess;
  seqdfa_apply_kernel<<<static_cast<unsigned>((total + kThreads - 1) /
                                              kThreads),
                        kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(maps), static_cast<const uint8_t*>(start),
      static_cast<const bool*>(accept_final), F, R, S, K,
      static_cast<bool*>(out));
  return cudaGetLastError();
}
