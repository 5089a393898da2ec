// K15 ingress: the node-ingress programs, netdev (mode 0) and overlay
// (mode 1), in one body.
//
// Replaces cilium_tpu/datapath/ingress.py:91 (_ingress_common), :152
// (netdev_verdicts: the source identity from the ipcache LPM when the
// caller's is reserved, unless the cache says HOST_ID or 0) and :185
// (overlay_verdicts: the tunnel id is the source identity).  The
// reference ran two LPMs, three exact lookups (the endpoint table and
// both CT orientations) and the policy cascade as dense [F, N] compares.
//
// Bound on the H100: operations.  Per packet: the identity LPM over every
// prefix (netdev only), the address of every endpoint row, the sport of
// every CT row up to the first match of either orientation (against both
// ports), the identity column of every policy row and the tunnel LPM
// over every prefix, each reading a row's other columns only where its
// first passed; the bytes are 24 * F in, 22 * F out and the tables once.  Design: as K14,
// one thread a packet runs the walks of l34.cuh in turn with every row a
// warp-uniform broadcast load; the two CT orientations share one read of
// each row.  Tunnel endpoints at or above 2^31 ride as int32 bit patterns.
#include "l34.cuh"

struct IngArgs {
  l34::LpmTab ipc_id;
  l34::LpmTab ipc_tun;
  l34::ExactTab lxc;
  l34::ExactTab ct;
  l34::ExactTab pol;
  const int32_t* saddr;
  const int32_t* daddr;
  const int32_t* sport;
  const int32_t* dport;
  const int32_t* proto;
  const int32_t* src;  // source identity (netdev) or tunnel id (overlay)
  int32_t mode;
  int32_t f;
  int32_t* out;  // [5, F]: verdict, src identity, lxc id, tunnel endpoint, proxy port
  bool* flags;   // [2, F]: established, needs_ct_create
};

namespace {

constexpr int kForward = 0, kDrop = 1, kToProxy = 2, kToHost = 3, kToOverlay = 4;
constexpr int kHostId = 1, kReservedMax = 255;  // datapath/ingress.py
constexpr int kDirIngress = 0;                  // maps/policymap.py
constexpr int kHostFlag = 1;                    // maps/lxcmap.py ENDPOINT_F_HOST

// The CT table (daddr, saddr, dport, sport, proto) in both orientations:
// the forward key, and the reply to an entry the egress pass created.
// Reads only `found`, so a warp leaves once all its lanes have found.
__device__ __forceinline__ bool ct_either(const l34::ExactTab& t, int32_t sa,
                                          int32_t da, int32_t sp, int32_t dp,
                                          int32_t pr) {
  const int n = t.n;
  bool found = false;
  const int32_t* col3 = t.keys + 3 * n;  // sport: one of the two ports
  for (int base = 0; base < n; base += 32) {
    if (__all_sync(l34::kFull, found)) break;
    const int end = min(base + 32, n);
    for (int r0 = base; r0 < end; r0 += l34::kUnroll) {
      int32_t c3[l34::kUnroll];
#pragma unroll
      for (int u = 0; u < l34::kUnroll; ++u) c3[u] = r0 + u < end ? l34::ld(col3 + r0 + u) : sp;
#pragma unroll
      for (int u = 0; u < l34::kUnroll; ++u) {
        const int r = r0 + u;
        if ((c3[u] != sp && c3[u] != dp) || r >= end) continue;
        if (!l34::ldb(t.valid + r) || l34::ld(t.keys + 4 * n + r) != pr) continue;
        const int32_t c0 = l34::ld(t.keys + r);
        const int32_t c1 = l34::ld(t.keys + n + r);
        const int32_t c2 = l34::ld(t.keys + 2 * n + r);
        found |= (c0 == da && c1 == sa && c2 == dp && c3[u] == sp) ||
                 (c0 == sa && c1 == da && c2 == sp && c3[u] == dp);
      }
    }
  }
  return found;
}

__global__ void __launch_bounds__(l34::kThreads) ingress_kernel(const IngArgs a) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = f < a.f;
  const int32_t saddr = active ? a.saddr[f] : 0;
  const int32_t daddr = active ? a.daddr[f] : 0;
  const int32_t sport = active ? a.sport[f] : 0;
  const int32_t dport = active ? a.dport[f] : 0;
  const int32_t proto = active ? a.proto[f] : 0;
  const int32_t src = active ? a.src[f] : 0;

  int32_t src_id = src;
  if (a.mode == 0) {  // netdev: refine a reserved identity from the ipcache
    const bool reserved = src >= 0 && src <= kReservedMax;
    const int32_t sa[1] = {saddr};
    bool found;
    int32_t sec, plen;
    l34::lpm_walk<1>(a.ipc_id, sa, found, sec, plen);
    if (reserved && found && sec != 0 && sec != kHostId) {
      src_id = sec;
    } else if (reserved && src == 0) {
      src_id = l34::kWorldId;
    }
  }

  // Local endpoint demux: the lxc table keyed by address, values summed.
  const int32_t dq[1] = {daddr};
  int32_t lxc[2] = {0, 0};  // endpoint id, flags
  const bool is_local = l34::exact_sum<1>(a.lxc, dq, 2, lxc);
  const int32_t lxc_id = lxc[0], lxc_flags = lxc[1];
  const bool is_host = is_local && (lxc_flags & kHostFlag) != 0;

  const bool est = ct_either(a.ct, saddr, daddr, sport, dport, proto);
  bool allowed;
  int32_t proxy;
  l34::policy_walk(a.pol, src_id, dport, proto, kDirIngress, allowed, proxy);
  const int32_t da[1] = {daddr};
  bool tun_found;
  int32_t tunnel, plen;
  l34::lpm_walk<1>(a.ipc_tun, da, tun_found, tunnel, plen);

  if (!active) return;
  const bool pass = est || allowed;
  const int local = pass ? ((proxy > 0 && !est) ? kToProxy : kForward) : kDrop;
  const int remote = (tun_found && tunnel != 0) ? kToOverlay : kForward;
  const int verdict = is_host ? kToHost : (is_local ? local : remote);
  const bool delivered = is_local && !is_host;
  const size_t F = static_cast<size_t>(a.f);
  int32_t* out = a.out + f;
  out[0] = verdict;
  out[F] = src_id;
  out[2 * F] = is_local ? lxc_id : 0;
  out[3 * F] = (!is_local && tun_found) ? tunnel : 0;
  out[4 * F] = (delivered && !est) ? proxy : 0;
  a.flags[f] = est && delivered;
  a.flags[F + f] = delivered && pass && !est;
}

}  // namespace

CILIUM_EXPORT int ingress(const IngArgs* args, void* stream) {
  const IngArgs a = *args;
  if (a.f <= 0) return cudaSuccess;
  if (a.ipc_id.w != 1 || a.ipc_tun.w != 1 || a.lxc.k != 1 || a.lxc.v < 2 ||
      a.ct.k != 5 || a.pol.k != 4 || a.pol.v < 1 || (a.mode != 0 && a.mode != 1))
    return cudaErrorInvalidValue;
  ingress_kernel<<<l34::blocks_for(a.f), l34::kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}
