// K14 datapath4 / datapath6: the composed egress pass, one body templated
// on the address width W (1 for IPv4, 4 for IPv6).
//
// Replaces cilium_tpu/datapath/pipeline.py:125 (datapath_verdicts, with
// flow_hash32 :59) and pipeline6.py:92 (datapath_verdicts6, with
// flow_hash32_v6 :34), and with them rows h, i, j and the ipcache LPM of
// row g as the pass runs them: the reference composed dense [F, N]
// compares for the LB, CT, LPM and policy tables, each a separate
// broadcast-and-reduce.
//
// Bound on the H100: operations.  Per packet the pass compares VIP word 0
// of every LB row, the sport of every CT row up to its first match (all
// of them on a miss), word 0 of every prefix (a mask and a compare) and
// the identity column of every policy row (against the identity and 0),
// and a row's other key columns only where that first one passed; the
// bytes are 4 * (2W + 3) * F in, (W + 6) * 4 * F + 2 * F out, and the
// tables once.  Design: one thread a packet runs the
// four walks of l34.cuh in turn, so the post-DNAT tuple, the destination
// identity and the policy answer never leave its registers; every table
// row is a warp-uniform broadcast load.  Threads past F run the walks on
// zeros (the CT walk's early exit votes across the whole warp) and store
// nothing.  Hashing or sorting the CT and prefix tables is the lever a
// later change can pull.
#include "l34.cuh"

struct DpArgs {
  l34::LbTab lb;
  l34::ExactTab ct;
  l34::LpmTab ipc;
  l34::ExactTab pol;
  const int32_t* saddr[4];
  const int32_t* daddr[4];
  const int32_t* sport;
  const int32_t* dport;
  const int32_t* proto;
  int32_t f;
  int32_t* out;  // [W + 6, F]: verdict, new daddr words, new dport,
                 // dst identity, proxy port, rev nat, tunnel endpoint
  bool* flags;   // [2, F]: established, needs_ct_create
};

namespace {

constexpr int kForward = 0, kDrop = 1, kToProxy = 2;  // pipeline.py
constexpr int kDirEgress = 1;                          // maps/policymap.py

template <int W>
__global__ void __launch_bounds__(l34::kThreads) datapath_kernel(const DpArgs a) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = f < a.f;
  int32_t sw[W], dw[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    sw[w] = active ? a.saddr[w][f] : 0;
    dw[w] = active ? a.daddr[w][f] : 0;
  }
  const int32_t sport = active ? a.sport[f] : 0;
  const int32_t dport = active ? a.dport[f] : 0;
  const int32_t proto = active ? a.proto[f] : 0;

  // 1. service translation
  const uint32_t fh = l34::flow_hash_w<W>(sw, dw, sport, dport, proto);
  bool svc;
  int32_t be[W], be_port, rev;
  l34::lb_walk<W>(a.lb, dw, dport, fh, svc, be, be_port, rev);
  int32_t nd[W];
#pragma unroll
  for (int w = 0; w < W; ++w) nd[w] = svc ? be[w] : dw[w];
  const int32_t ndport = svc ? be_port : dport;

  // 2. conntrack on the post-DNAT tuple (daddr, saddr, dport, sport, proto)
  int32_t key[2 * W + 3];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    key[w] = nd[w];
    key[W + w] = sw[w];
  }
  key[2 * W] = ndport;
  key[2 * W + 1] = sport;
  key[2 * W + 2] = proto;
  const bool est = l34::exact_found<2 * W + 3>(a.ct, key);

  // 3. destination identity; unknown -> world
  bool ip_found;
  int32_t ident, plen;
  l34::lpm_walk<W>(a.ipc, nd, ip_found, ident, plen);
  const int32_t dst = ip_found ? ident : l34::kWorldId;

  // 4. policy cascade
  bool allowed;
  int32_t proxy;
  l34::policy_walk(a.pol, dst, ndport, proto, kDirEgress, allowed, proxy);

  if (!active) return;
  const bool pass = est || allowed;
  const int verdict = pass ? ((proxy > 0 && !est) ? kToProxy : kForward) : kDrop;
  const size_t F = static_cast<size_t>(a.f);
  int32_t* out = a.out + f;
  out[0] = verdict;
#pragma unroll
  for (int w = 0; w < W; ++w) out[(1 + w) * F] = nd[w];
  out[(W + 1) * F] = ndport;
  out[(W + 2) * F] = dst;
  out[(W + 3) * F] = est ? 0 : proxy;
  out[(W + 4) * F] = svc ? rev : 0;
  out[(W + 5) * F] = 0;  // encap selection lives in the node-ingress programs
  a.flags[f] = est;
  a.flags[F + f] = pass && !est;
}

template <int W>
int launch(const DpArgs* args, void* stream) {
  const DpArgs a = *args;
  if (a.f <= 0) return cudaSuccess;
  if (a.lb.w != W || a.ipc.w != W || a.ct.k != 2 * W + 3 || a.pol.k != 4 || a.pol.v < 1)
    return cudaErrorInvalidValue;
  datapath_kernel<W><<<l34::blocks_for(a.f), l34::kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

}  // namespace

CILIUM_EXPORT int datapath4(const DpArgs* args, void* stream) { return launch<1>(args, stream); }

CILIUM_EXPORT int datapath6(const DpArgs* args, void* stream) { return launch<4>(args, stream); }
