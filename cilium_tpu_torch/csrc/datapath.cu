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
// Bound on the H100: bytes, 4 * (2W + 3) * F in, (W + 6) * 4 * F + 2 * F
// out, the indexes and the LB's counts, backends and rev NAT once (the
// other tables' keys and the policy's value column 0 live in the index
// slots, or, for a policy table too wide for its slots, the row id whose
// value column 0 is read on a match).  Design: one
// thread a packet probes the hashed indexes of l34_index.cuh
// (ops/l34_index.py builds them with the tables), so a lookup reads one
// bucket, not every row, and the post-DNAT tuple, the destination
// identity and the policy answer never leave its registers: two LB
// probes, then the CT probe and the first pair of LPM mask groups issued
// together, then the policy cascade's three probes.  Each step's loads
// are issued before any of them is tested.  Threads past F store
// nothing.  A launch without the indexes is refused.
#include "l34_index.cuh"

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
  // The hashed indexes (ops/l34_index.py), after the parent's fields.
  l34x::HashIx lb_ix;
  l34x::HashIx ct_ix;
  l34x::LpmIx ipc_ix;
  l34x::HashIx pol_ix;
};

namespace {

constexpr int kForward = 0, kDrop = 1, kToProxy = 2;  // pipeline.py
constexpr int kDirEgress = 1;                          // maps/policymap.py

// kOwn: the CT and policy indexes have the slots of the tables the pass
// is built for (the CT key and a value; the policy key and values 0..2),
// so the slot strides are constants and value column 0 is slot word 4;
// else the strides are read from the indexes, and a policy table too wide
// for its slots has its rows read on a match.
template <int W, bool kOwn>
__global__ void __launch_bounds__(l34::kThreads) datapath_kernel(const DpArgs a) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= a.f) return;
  int32_t sw[W], dw[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    sw[w] = a.saddr[w][f];
    dw[w] = a.daddr[w][f];
  }
  const int32_t sport = a.sport[f];
  const int32_t dport = a.dport[f];
  const int32_t proto = a.proto[f];

  // 1. service translation
  const uint32_t fh = l34::flow_hash_w<W>(sw, dw, sport, dport, proto);
  bool svc;
  int32_t be[W], be_port, rev;
  l34x::lb_probe<W>(a.lb, a.lb_ix, dw, dport, fh, svc, be, be_port, rev);
  int32_t nd[W];
#pragma unroll
  for (int w = 0; w < W; ++w) nd[w] = svc ? be[w] : dw[w];
  const int32_t ndport = svc ? be_port : dport;

  // 2. conntrack on the post-DNAT tuple (daddr, saddr, dport, sport, proto)
  // and 3. the destination identity, their probes issued together
  constexpr int kCtK = 2 * W + 3;
  constexpr int kCtS = l34x::slot_words(kCtK);  // the key words of a slot
  int32_t key[kCtK];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    key[w] = nd[w];
    key[W + w] = sw[w];
  }
  key[2 * W] = ndport;
  key[2 * W + 1] = sport;
  key[2 * W + 2] = proto;
  l34x::Probe<kCtS, kOwn ? kCtS : 0> ct;
  l34x::LpmPair<W> ip;
  l34x::start<kCtK, kCtS>(a.ct_ix, key, ct);
  l34x::lpm_start<W>(a.ipc_ix, nd, 0, ip);
  l34x::first(a.ct_ix, ct);
  l34x::lpm_first<W>(a.ipc_ix, ip);
  const bool est = l34x::found<kCtK, kCtS>(a.ct_ix, ct, key);
  bool ip_found;
  int32_t ident, plen;
  l34x::lpm_finish<W>(a.ipc_ix, nd, ip, ip_found, ident, plen);
  const int32_t dst = ip_found ? ident : l34::kWorldId;

  // 4. policy cascade
  l34x::PolicyProbe<kOwn ? l34x::kPolS : 0> pp;
  l34x::policy_start(a.pol_ix, dst, ndport, proto, kDirEgress, pp);
  l34x::policy_first(a.pol_ix, pp);
  bool allowed;
  int32_t proxy;
  l34x::policy_finish<kOwn>(a.pol, a.pol_ix, pp, allowed, proxy);

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
  if (!l34x::usable(a.lb_ix, l34x::LbKey<W>::S) ||
      !l34x::usable(a.ct_ix, l34x::exact_width(2 * W + 3, a.ct.v)) || !l34x::usable<W>(a.ipc_ix) ||
      !l34x::usable(a.pol_ix, l34x::exact_width(4, a.pol.v)))
    return cudaErrorInvalidValue;
  const bool own = a.ct_ix.width == l34x::slot_words(2 * W + 3) &&
                   a.pol_ix.width == l34x::kPolS && 4 + a.pol.v + 1 <= l34x::kPolS;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (own)
    datapath_kernel<W, true><<<l34::blocks_for(a.f), l34::kThreads, 0, st>>>(a);
  else
    datapath_kernel<W, false><<<l34::blocks_for(a.f), l34::kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

CILIUM_EXPORT int datapath4(const DpArgs* args, void* stream) { return launch<1>(args, stream); }

CILIUM_EXPORT int datapath6(const DpArgs* args, void* stream) { return launch<4>(args, stream); }
