// K2 dfa_scan: per-pattern DFA search over each flow's span [start, end).
//
// Replaces cilium_tpu/ops/dfa.py:146 (_dfa_scan, behind dfa_search_spans
// :194 and dfa_search_batch :203, with byte_class_onehot :124).  The TPU
// version avoided gathers: a range-compare class one-hot and a one-hot
// dot_general row select per byte, O(S*C) MACs per (flow, pattern, byte).
// On Hopper a shared-memory lookup is cheap, so the step here is
// delta[r][state][class(byte)]: one table read per (flow, pattern, byte).
//
// Bound on the H100: the function needs one table step per (span byte,
// pattern); the bytes (span bytes, bounds, [F, R] output) are a few us at
// the card's DRAM rate.  A step is a shared-memory load whose address hangs
// on the last step's load, so what bounds the kernel is the SM's one
// shared-memory wavefront a clock, its instruction issue, and that chain.
//
// Design (the first version ran one thread a flow over tiles of 8
// patterns: each flow's bytes read once a tile, the 32 lanes of a warp at
// unrelated table rows, warps as long as their longest span; PERF.md):
// - g lanes of a warp walk one flow (32 / g flows a warp), lane q holding
//   patterns q, q + g, ... of a tile of g * kt (ops/dfa.py scan_geometry,
//   from the shape alone).  Every lane of a flow reads the same byte: the
//   span is read once for all patterns, and where g = 32 no lane waits on
//   another's span.  Tables too large for shared memory are tiled over
//   blockIdx.y.
// - The tile's table is staged once a block with 16-byte copies, already
//   in this layout (ops/dfa.py scan_table): nc interleaved columns, lane
//   l reading column l % nc, so with nc = 32 a lane's lookups stay in its
//   own bank.  An entry is the next state's row in the tile (one byte up
//   to 256 rows, else two), so a step is one multiply-add and one load;
//   accept states are made absorbing at upload, so the sticky accept
//   needs nothing in the step, and one flag entry a row (accept |
//   accept_final) decides at the end.  One-byte entries keep the wide
//   shape's table at 58 KB, so two blocks of 1,024 threads share an SM.
// - The class table holds each byte's offset within a row (its class's
//   word of nc columns, and the entry in it), so a byte costs one lookup
//   shared by all kt patterns of the lane.
// - Blocks of 1,024 threads (fewer for a small batch), as many as fit on
//   the card at once, stride over the flows, so one staged table serves
//   32 warps; at the wide shape smaller blocks ran slower.
// - Bytes come 16 at a time where the rows are 16-byte aligned (L and the
//   base pointer multiples of 16), one at a time at the span's ends and
//   elsewhere; never past the row.
//
// Semantics (cilium_tpu/ops/dfa.py:150-190): accepted starts as
// accept(start); a step applies only for start <= t < min(end, L); accept
// is sticky after each step; the result is accepted | accept_final(state),
// so an empty span still applies accept_final to the start state.
#include "common.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kKtMax = 8;  // ops/dfa.py SCAN_KT_MAX
constexpr size_t kSmemBudget = 200 * 1024;

// One byte: every pattern slot of the lane takes its step.
template <int KT, typename E>
__device__ __forceinline__ void step(const uint8_t* s_tab, const uint32_t* s_cm,
                                     uint32_t col4, uint32_t row_bytes,
                                     uint32_t byte, uint32_t (&row)[KT]) {
  const uint32_t at = s_cm[byte] + col4;
#pragma unroll
  for (int j = 0; j < KT; ++j)
    row[j] = *reinterpret_cast<const E*>(s_tab + row[j] * row_bytes + at);
}

// E: the entries' type (uint8_t, or uint16_t past 256 rows a tile).
template <int KT, bool kVec, typename E>
__global__ void __launch_bounds__(kMaxThreads)
dfa_scan_kernel(const uint8_t* __restrict__ data,
                const int32_t* __restrict__ span_start,
                const int32_t* __restrict__ span_end,
                const uint8_t* __restrict__ classmap,
                const uint4* __restrict__ tab,
                const uint8_t* __restrict__ start, int F, int L, int R,
                int S, int C, int g_log2, int nc, int tile_vec,
                bool* __restrict__ out) {
  extern __shared__ uint4 smem[];
  uint32_t* s_cm = reinterpret_cast<uint32_t*>(smem);  // [256]
  const uint8_t* s_tab = reinterpret_cast<const uint8_t*>(smem + 64);
  const uint4* src = tab + static_cast<size_t>(blockIdx.y) * tile_vec;
  for (int i = threadIdx.x; i < tile_vec; i += blockDim.x) smem[64 + i] = src[i];
  // a byte's offset in a row: its class's word of nc columns, and the entry
  constexpr int kEpw = 4 / sizeof(E);
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    const int c = classmap[i];
    s_cm[i] = static_cast<uint32_t>((c / kEpw) * nc * 4 + (c % kEpw) * sizeof(E));
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int g = 1 << g_log2;
  const int q = lane & (g - 1);
  const uint32_t col4 = static_cast<uint32_t>((lane & (nc - 1)) * 4);
  const uint32_t row_bytes = static_cast<uint32_t>((C + kEpw) / kEpw * nc * 4);
  const uint32_t flag_at =
      static_cast<uint32_t>((C / kEpw) * nc * 4 + (C % kEpw) * sizeof(E)) + col4;
  const int r0 = blockIdx.y * g * KT + q;  // pattern of slot j: r0 + j * g

  // Each slot's start row, once a block (KT == kt).
  uint32_t row0[KT];
#pragma unroll
  for (int j = 0; j < KT; ++j) {
    const int r = r0 + j * g;
    row0[j] = r < R ? j * S + start[r] : 0u;
  }

  const int per_warp = 32 >> g_log2;
  const int groups = (F + per_warp - 1) / per_warp;
  const int warps_per_block = blockDim.x / 32;
  const int warps = gridDim.x * warps_per_block;
  for (int grp = blockIdx.x * warps_per_block + threadIdx.x / 32; grp < groups;
       grp += warps) {
    const int f = grp * per_warp + (lane >> g_log2);
    int t = 0, t1 = 0;
    if (f < F) {
      t = max(span_start[f], 0);
      t1 = min(span_end[f], L);
    }
    uint32_t row[KT];
#pragma unroll
    for (int j = 0; j < KT; ++j) row[j] = row0[j];
    const uint8_t* rowp = data + static_cast<size_t>(f) * L;
    if (kVec) {
      // up to the first 16-byte boundary, whole 16-byte pieces, the rest
      const int a0 = min((t + 15) & ~15, t1);
      for (; t < a0; ++t) step<KT, E>(s_tab, s_cm, col4, row_bytes, __ldg(rowp + t), row);
      for (; t + 16 <= t1; t += 16) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(rowp + t));
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int b = 0; b < 16; ++b)
          step<KT, E>(s_tab, s_cm, col4, row_bytes, (w[b >> 2] >> ((b & 3) << 3)) & 0xFFu, row);
      }
    }
    for (; t < t1; ++t) step<KT, E>(s_tab, s_cm, col4, row_bytes, __ldg(rowp + t), row);
    if (f < F) {
      bool* dst = out + static_cast<size_t>(f) * R;
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        const int r = r0 + j * g;
        if (r < R)
          dst[r] = *reinterpret_cast<const E*>(s_tab + row[j] * row_bytes + flag_at) != 0;
      }
    }
  }
}

template <int KT, bool kVec, typename E>
cudaError_t launch(const void* data, const void* span_start,
                   const void* span_end, const void* classmap, const void* tab,
                   const void* start, int F, int L, int R, int S, int C,
                   int g_log2, int nc, int tile_vec, int tiles, void* out,
                   cudaStream_t stream) {
  auto kernel = dfa_scan_kernel<KT, kVec, E>;
  const size_t smem = 1024 + static_cast<size_t>(tile_vec) * 16;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // Blocks of up to 1,024 threads, as many as fit on the card at once;
  // a batch too small to fill them gets smaller blocks, one an SM.
  const long long per_warp = 32 >> g_log2;
  const long long warps = (static_cast<long long>(F) + per_warp - 1) / per_warp * tiles;
  int threads = kMaxThreads;
  while (threads > 64 && warps * 32 < static_cast<long long>(threads) * sms) threads /= 2;
  int resident = 0;
  if ((err = resident_blocks(kernel, threads, smem, &resident)) != cudaSuccess) return err;
  const long long want = (warps / tiles * 32 + threads - 1) / threads;
  const long long fill = std::max(1LL, static_cast<long long>(resident) / tiles);
  dim3 grid(static_cast<unsigned>(std::min(want, fill)), tiles);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const uint8_t*>(data), static_cast<const int32_t*>(span_start),
      static_cast<const int32_t*>(span_end), static_cast<const uint8_t*>(classmap),
      static_cast<const uint4*>(tab), static_cast<const uint8_t*>(start), F, L, R,
      S, C, g_log2, nc, tile_vec, static_cast<bool*>(out));
  return cudaGetLastError();
}

}  // namespace

// tab: ops/dfa.py scan_table for the geometry (g, kt, nc, es, tiles) that
// ops/dfa.py scan_geometry gives for (R, S, C).
CILIUM_EXPORT int dfa_scan(const void* data, const void* span_start,
                           const void* span_end, const void* classmap,
                           const void* tab, const void* start, int F, int L,
                           int R, int S, int C, int g, int kt, int nc, int es,
                           int tiles, void* out, void* stream) {
  if (F <= 0 || R <= 0) return cudaSuccess;
  int g_log2 = 0;
  while ((1 << g_log2) < g) ++g_log2;
  const long long tile_bytes =
      static_cast<long long>(kt) * S * ((C + 4 / es) / (4 / es)) * nc * 4;
  const int tile_vec = static_cast<int>((tile_bytes + 15) / 16);
  if (S < 1 || S > 128 || C < 1 || C > 256 || g < 1 || g > 32 ||
      (1 << g_log2) != g || nc < g || nc > 32 || (nc & (nc - 1)) ||
      kt < 1 || kt > kKtMax || static_cast<long long>(tiles) * g * kt < R ||
      (es != 1 && es != 2) || (es == 1 && kt * S > 256) ||
      1024 + static_cast<size_t>(tile_vec) * 16 > kSmemBudget ||
      reinterpret_cast<uintptr_t>(tab) % 16)
    return cudaErrorInvalidValue;
  const bool vec = L % 16 == 0 && reinterpret_cast<uintptr_t>(data) % 16 == 0;
  auto s = static_cast<cudaStream_t>(stream);
#define CILIUM_DFA_ARGS                                                            \
  data, span_start, span_end, classmap, tab, start, F, L, R, S, C, g_log2, nc,     \
      tile_vec, tiles, out, s
#define CILIUM_DFA_LAUNCH(KT)                                                      \
  return es == 1 ? (vec ? launch<KT, true, uint8_t>(CILIUM_DFA_ARGS)               \
                        : launch<KT, false, uint8_t>(CILIUM_DFA_ARGS))             \
                 : (vec ? launch<KT, true, uint16_t>(CILIUM_DFA_ARGS)              \
                        : launch<KT, false, uint16_t>(CILIUM_DFA_ARGS))
  switch (kt) {
    case 1: CILIUM_DFA_LAUNCH(1);
    case 2: CILIUM_DFA_LAUNCH(2);
    case 3: CILIUM_DFA_LAUNCH(3);
    case 4: CILIUM_DFA_LAUNCH(4);
    case 5: CILIUM_DFA_LAUNCH(5);
    case 6: CILIUM_DFA_LAUNCH(6);
    case 7: CILIUM_DFA_LAUNCH(7);
    default: CILIUM_DFA_LAUNCH(8);
  }
#undef CILIUM_DFA_LAUNCH
#undef CILIUM_DFA_ARGS
}
