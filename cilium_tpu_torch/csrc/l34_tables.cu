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
// Design: one thread a query probes the hashed index its table carries
// (ops/l34_index.py builds it when the table is made; the probes are
// l34_index.cuh): a key's bucket bounds, then the bucket's first slot,
// every load of the query issued before any is tested, the rest of the
// bucket after (B is at least twice the rows, so rarely any).  A slot holds
// the key, the V value columns and the row id, so a hit reads no table
// row; where K + V + 1 is more than 16 words the slot holds the key and
// the row id, and the value row is read from the table on a match.  The
// cascade's three keys and the LB's two (L4, wildcard port) are started
// together, then their first slots loaded, then tested.  Bound on the
// H100: bytes, the [F] columns in and out and the index read once.  A
// launcher refuses arguments without a usable index: no lookup walks the
// rows.
#include "l34_index.cuh"

// The index rides after the parent's fields, so a parent's launcher reads
// these structs unchanged.
struct ExactArgs {
  l34::ExactTab t;
  const int32_t* q[l34::kMaxKeyCols];
  int32_t f;
  bool* found;
  int32_t* vals;
  l34x::HashIx ix;
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
  l34x::HashIx ix;
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
  l34x::HashIx ix;
};

namespace {

using l34x::exact_width;
using l34x::in_slot;

template <int K, int S>
__global__ void __launch_bounds__(l34::kThreads) exact_kernel(const ExactArgs a) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= a.f) return;
  int32_t q[K];
#pragma unroll
  for (int k = 0; k < K; ++k) q[k] = a.q[k][f];
  l34x::Probe<S> p;
  l34x::start<K, S>(a.ix, q, p);
  l34x::first(a.ix, p);
  const int v = a.t.v;
  int32_t* out = a.vals + static_cast<size_t>(f) * v;
  bool found = false;
  if (in_slot(K, v)) {
    constexpr int kNV = S - K - 1 > 0 ? S - K - 1 : 1;  // value words a slot can hold
    int32_t acc[kNV];
#pragma unroll
    for (int c = 0; c < kNV; ++c) acc[c] = 0;
    l34x::visit<K, S>(a.ix, p, q, [&](const int32_t (&s)[S]) {
      found = true;
#pragma unroll
      for (int c = 0; c < kNV; ++c)
        if (c < v) acc[c] = l34::add32(acc[c], s[K + c]);
    });
#pragma unroll
    for (int c = 0; c < kNV; ++c)
      if (c < v) out[c] = acc[c];
  } else {
    for (int c = 0; c < v; ++c) out[c] = 0;
    l34x::visit<K, S>(a.ix, p, q, [&](const int32_t (&s)[S]) {
      found = true;
      const int32_t* row = a.t.values + static_cast<size_t>(s[K]) * v;
      for (int c = 0; c < v; ++c) out[c] = l34::add32(out[c], l34::ld(row + c));
    });
  }
  a.found[f] = found;
}

template <int St>
__global__ void __launch_bounds__(l34::kThreads) policy_kernel(const PolicyArgs a) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= a.f) return;
  l34x::PolicyProbe<St> pp;
  l34x::policy_start(a.ix, a.ident[f], a.dport[f], a.proto[f], a.dir, pp);
  l34x::policy_first(a.ix, pp);
  bool allowed;
  int32_t proxy;
  l34x::policy_finish<false>(a.t, a.ix, pp, allowed, proxy);
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
  l34x::lb_probe<W>(a.t, a.ix, vip, a.dport[f], static_cast<uint32_t>(a.hash[f]), found, target,
                    port, rev);
  a.found[f] = found;
#pragma unroll
  for (int w = 0; w < W; ++w) a.target[w][f] = target[w];
  a.port[f] = port;
  a.rev[f] = rev;
}

template <int K, int S>
int launch_exact_s(const ExactArgs& a, cudaStream_t s) {
  if constexpr (S >= K + 1) {
    exact_kernel<K, S><<<l34::blocks_for(a.f), l34::kThreads, 0, s>>>(a);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

template <int K>
int launch_exact(const ExactArgs& a, cudaStream_t s) {
  const int width = exact_width(K, a.t.v);
  if (a.t.v < 0 || !l34x::usable(a.ix, width)) return cudaErrorInvalidValue;
  switch (width) {
    case 4: return launch_exact_s<K, 4>(a, s);
    case 8: return launch_exact_s<K, 8>(a, s);
    default: return launch_exact_s<K, 16>(a, s);
  }
}

}  // namespace

CILIUM_EXPORT int exact_lookup(const ExactArgs* args, void* stream) {
  const ExactArgs a = *args;
  if (a.f <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  switch (a.t.k) {
    case 1: return launch_exact<1>(a, s);
    case 2: return launch_exact<2>(a, s);
    case 3: return launch_exact<3>(a, s);
    case 4: return launch_exact<4>(a, s);
    case 5: return launch_exact<5>(a, s);
    case 6: return launch_exact<6>(a, s);
    case 7: return launch_exact<7>(a, s);
    case 8: return launch_exact<8>(a, s);
    case 9: return launch_exact<9>(a, s);
    case 10: return launch_exact<10>(a, s);
    case 11: return launch_exact<11>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

CILIUM_EXPORT int policy_can_access(const PolicyArgs* args, void* stream) {
  const PolicyArgs a = *args;
  if (a.f <= 0) return cudaSuccess;
  if (a.t.k != 4 || a.t.v < 1) return cudaErrorInvalidValue;
  const int width = exact_width(4, a.t.v);
  if (!l34x::usable(a.ix, width)) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (width == 8) {
    policy_kernel<8><<<l34::blocks_for(a.f), l34::kThreads, 0, s>>>(a);
  } else {
    policy_kernel<16><<<l34::blocks_for(a.f), l34::kThreads, 0, s>>>(a);
  }
  return cudaGetLastError();
}

CILIUM_EXPORT int lb_select(const LbArgs* args, void* stream) {
  const LbArgs a = *args;
  if (a.f <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (a.t.w == 1 && l34x::usable(a.ix, l34x::LbKey<1>::S)) {
    lb_kernel<1><<<l34::blocks_for(a.f), l34::kThreads, 0, s>>>(a);
  } else if (a.t.w == 4 && l34x::usable(a.ix, l34x::LbKey<4>::S)) {
    lb_kernel<4><<<l34::blocks_for(a.f), l34::kThreads, 0, s>>>(a);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
