// K13: the datapath's map lookups on their own, each over F queries.
//
//   exact_lookup       replaces cilium_tpu/ops/maplookup.py:80: found, and
//                      the int32-wrapped sum of every matched row's values
//                      (the reference extracted rows with an int8 one-hot
//                      matmul, so duplicate keys sum), K <= 11 key columns;
//   policy_can_access  replaces cilium_tpu/maps/policymap.py:191: the
//                      L4 -> L3-only -> wildcard-identity cascade;
//   lb_select          replaces cilium_tpu/maps/lbmap.py:284 (W = 1) and
//                      :352 (W = 4): first matching service (L4 before the
//                      wildcard port) and the uint32 hash % count backend.
//
// The reference formed dense [F, N] compares for each and reduced them.
// Bound on the H100: operations.  A query compares one reject column of
// every row (exact_lookup must see them all, since matched rows sum) and
// a row's other key columns only where that one passed; the bytes are the
// [F] columns in and out and the tables (tens of KB) once.  Design: one
// thread a query walks the rows once, the rows read warp-uniform through
// the read-only path, the reject column of 8 rows loaded before any is
// compared (l34.cuh exact_sum, policy_walk, lb_walk); values are touched
// only on a match, and the sums go straight to the thread's own output
// row, so no atomics are needed.
#include "l34.cuh"

struct ExactArgs {
  l34::ExactTab t;
  const int32_t* q[l34::kMaxKeyCols];
  int32_t f;
  bool* found;
  int32_t* vals;
};

struct PolicyArgs {
  l34::ExactTab t;
  const int32_t* ident;
  const int32_t* dport;
  const int32_t* proto;
  int32_t dir;
  int32_t f;
  bool* allowed;
  int32_t* proxy;
};

struct LbArgs {
  l34::LbTab t;
  const int32_t* vip[4];
  const int32_t* dport;
  const int32_t* hash;
  int32_t f;
  bool* found;
  int32_t* target[4];
  int32_t* port;
  int32_t* rev;
};

namespace {

template <int K>
__global__ void __launch_bounds__(l34::kThreads) exact_kernel(const ExactArgs a) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= a.f) return;
  int32_t q[K];
#pragma unroll
  for (int k = 0; k < K; ++k) q[k] = a.q[k][f];
  int32_t* out = a.vals + static_cast<size_t>(f) * a.t.v;
  for (int c = 0; c < a.t.v; ++c) out[c] = 0;
  a.found[f] = l34::exact_sum<K>(a.t, q, a.t.v, out);
}

__global__ void __launch_bounds__(l34::kThreads) policy_kernel(const PolicyArgs a) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= a.f) return;
  bool allowed;
  int32_t proxy;
  l34::policy_walk(a.t, a.ident[f], a.dport[f], a.proto[f], a.dir, allowed, proxy);
  a.allowed[f] = allowed;
  a.proxy[f] = proxy;
}

template <int W>
__global__ void __launch_bounds__(l34::kThreads) lb_kernel(const LbArgs a) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= a.f) return;
  int32_t vip[W], target[W];
#pragma unroll
  for (int w = 0; w < W; ++w) vip[w] = a.vip[w][f];
  bool found;
  int32_t port, rev;
  l34::lb_walk<W>(a.t, vip, a.dport[f], static_cast<uint32_t>(a.hash[f]), found,
                  target, port, rev);
  a.found[f] = found;
#pragma unroll
  for (int w = 0; w < W; ++w) a.target[w][f] = target[w];
  a.port[f] = port;
  a.rev[f] = rev;
}

template <int K>
void launch_exact(const ExactArgs& a, cudaStream_t s) {
  exact_kernel<K><<<l34::blocks_for(a.f), l34::kThreads, 0, s>>>(a);
}

}  // namespace

CILIUM_EXPORT int exact_lookup(const ExactArgs* args, void* stream) {
  const ExactArgs a = *args;
  if (a.f <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  switch (a.t.k) {
    case 1: launch_exact<1>(a, s); break;
    case 2: launch_exact<2>(a, s); break;
    case 3: launch_exact<3>(a, s); break;
    case 4: launch_exact<4>(a, s); break;
    case 5: launch_exact<5>(a, s); break;
    case 6: launch_exact<6>(a, s); break;
    case 7: launch_exact<7>(a, s); break;
    case 8: launch_exact<8>(a, s); break;
    case 9: launch_exact<9>(a, s); break;
    case 10: launch_exact<10>(a, s); break;
    case 11: launch_exact<11>(a, s); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

CILIUM_EXPORT int policy_can_access(const PolicyArgs* args, void* stream) {
  const PolicyArgs a = *args;
  if (a.f <= 0) return cudaSuccess;
  if (a.t.k != 4 || a.t.v < 1) return cudaErrorInvalidValue;
  policy_kernel<<<l34::blocks_for(a.f), l34::kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

CILIUM_EXPORT int lb_select(const LbArgs* args, void* stream) {
  const LbArgs a = *args;
  if (a.f <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (a.t.w == 1) {
    lb_kernel<1><<<l34::blocks_for(a.f), l34::kThreads, 0, s>>>(a);
  } else if (a.t.w == 4) {
    lb_kernel<4><<<l34::blocks_for(a.f), l34::kThreads, 0, s>>>(a);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
