// K12 lpm_lookup: longest-prefix match of F addresses (W = 1 or 4 words)
// against N prefixes.
//
// Replaces cilium_tpu/ops/lpm.py:109 (lpm_lookup) and :161
// (prefilter_check_batch), which built a dense [F, N] masked compare and
// took the winner with gather-free max-reduces (TPU gathers serialize).
//
// Bound on the H100: operations.  Every address must see every prefix
// (the longest match may be the last row): a mask and a compare of word 0
// for each, of words 1..W-1 only where word 0 matched, against 4 * W * F
// bytes in and 9 * F bytes out.  Design: one thread an
// address keeps its W words in registers and walks the rows in order;
// the threads of a warp read the same row at the same time, so each row
// word is one broadcast load through the read-only path (l34.cuh
// lpm_walk).  Sorting or hashing the prefixes by length is the lever a
// later change can pull.
#include "l34.cuh"

struct LpmArgs {
  l34::LpmTab t;
  const int32_t* addr[4];
  int32_t f;
  bool* found;
  int32_t* value;
  int32_t* plen;
};

namespace {

template <int W>
__global__ void __launch_bounds__(l34::kThreads) lpm_kernel(const LpmArgs a) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= a.f) return;
  int32_t addr[W];
#pragma unroll
  for (int w = 0; w < W; ++w) addr[w] = a.addr[w][f];
  bool found;
  int32_t value, plen;
  l34::lpm_walk<W>(a.t, addr, found, value, plen);
  a.found[f] = found;
  a.value[f] = value;
  a.plen[f] = plen;
}

}  // namespace

CILIUM_EXPORT int lpm_lookup(const LpmArgs* args, void* stream) {
  const LpmArgs a = *args;
  if (a.f <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (a.t.w == 1) {
    lpm_kernel<1><<<l34::blocks_for(a.f), l34::kThreads, 0, s>>>(a);
  } else if (a.t.w == 4) {
    lpm_kernel<4><<<l34::blocks_for(a.f), l34::kThreads, 0, s>>>(a);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
