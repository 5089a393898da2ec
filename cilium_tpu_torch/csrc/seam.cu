// K19 seam_probe and K20 rtt_tick: the two device ops of the sidecar seam
// benchmark path.  Neither does verdict work; each keeps one real launch
// and readback on the path it measures.
//
// K19 seam_probe replaces SeamProbe.__call__ / verdicts_attr of
// cilium_tpu/models/base.py:41 (:51, :55), the model a seam_probe service
// binds in place of the r2d2 verdict model:
//   ok[i] = lengths[i] >= 0;  msg_len[i] = lengths[i];  rule[i] = 0
// (rule only for the attributed form).  msg_len is written as a copy of
// its own, so that no output of a CUDA graph aliases the graph's static
// input buffer.
//
// K20 rtt_tick replaces `tick` of cilium_tpu/sidecar/latbench.py:617
// (measure_device_rtt_ms, :626-628): y[i] = x[i] + 1 on an [8] int32
// array, with two's-complement wrap (the add is unsigned, so INT32_MAX + 1
// gives INT32_MIN as XLA's add does, with no signed overflow in C++).
//
// Bound on the H100: bytes.  K19 at F = 8,192 reads 32 KiB and writes
// 8 + 32 + 32 KiB (0.03 us at 3.35 TB/s); K20 moves 64 bytes.  A launch
// costs microseconds, so the launch sets both times.
// Design: one thread per element, a grid-stride loop; nothing to tile.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void seam_probe_kernel(const int32_t* __restrict__ lengths, int n,
                                  bool* __restrict__ ok,
                                  int32_t* __restrict__ msg_len,
                                  int32_t* __restrict__ rule) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const int32_t len = lengths[i];
    ok[i] = len >= 0;
    msg_len[i] = len;
    if (rule != nullptr) rule[i] = 0;
  }
}

__global__ void rtt_tick_kernel(const int32_t* __restrict__ x, int n,
                                int32_t* __restrict__ y) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    y[i] = static_cast<int32_t>(static_cast<uint32_t>(x[i]) + 1u);
  }
}

int blocks_for(int n) {
  const int want = (n + kThreads - 1) / kThreads;
  return want < 132 * 8 ? want : 132 * 8;
}

}  // namespace

// rule may be null (the plain call form).
CILIUM_EXPORT int seam_probe(const int32_t* lengths, int n, bool* ok,
                             int32_t* msg_len, int32_t* rule, void* stream) {
  if (n > 0) {
    seam_probe_kernel<<<blocks_for(n), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(lengths, n, ok,
                                                             msg_len, rule);
  }
  return static_cast<int>(cudaGetLastError());
}

CILIUM_EXPORT int rtt_tick(const int32_t* x, int n, int32_t* y,
                           void* stream) {
  if (n > 0) {
    rtt_tick_kernel<<<blocks_for(n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(x, n, y);
  }
  return static_cast<int>(cudaGetLastError());
}
