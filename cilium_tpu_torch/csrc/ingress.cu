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
// Bound on the H100: bytes, 24 * F in, 22 * F out, and the indexes once
// (every value read lives in their slots, but for an endpoint or policy
// table too wide for its slots, whose matched rows' values are read from
// the table).  Design: as K14, one thread a packet probes the
// hashed indexes of l34_index.cuh: the identity LPM's first pair of mask
// groups (netdev only), the endpoint, the CT in both orientations and the
// tunnel LPM's first pair are issued together before any is tested, then
// the policy cascade's three probes on the source identity.  The mode is
// a template argument, so neither body branches on it.  Threads past F
// store nothing.  Tunnel endpoints at or above 2^31 ride as int32 bit
// patterns.  A launch without the indexes is refused.
#include "l34_index.cuh"

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
  // The hashed indexes (ops/l34_index.py), after the parent's fields.
  l34x::LpmIx id_ix;
  l34x::LpmIx tun_ix;
  l34x::HashIx lxc_ix;
  l34x::HashIx ct_ix;
  l34x::HashIx pol_ix;
};

namespace {

constexpr int kForward = 0, kDrop = 1, kToProxy = 2, kToHost = 3, kToOverlay = 4;
constexpr int kHostId = 1, kReservedMax = 255;  // datapath/ingress.py
constexpr int kDirIngress = 0;                  // maps/policymap.py
constexpr int kHostFlag = 1;                    // maps/lxcmap.py ENDPOINT_F_HOST

// The words of a slot the probes read: the CT key; the address and (lxc
// id, flags), or the row id where the endpoint's values do not fit a slot.
constexpr int kCtS = l34x::slot_words(5);
constexpr int kLxcS = l34x::slot_words(1 + 2);

// kOwn: the endpoint, CT and policy indexes have the slots of the tables
// the pass is built for (the address and (lxc id, flags); the CT key and a
// value; the policy key and values 0..2), so the slot strides are
// constants and the values sit in the slots; else the strides are read
// from the indexes, and a table too wide for its slots has its rows read
// on a match.
template <int kMode, bool kOwn>
__global__ void __launch_bounds__(l34::kThreads) ingress_kernel(const IngArgs a) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= a.f) return;
  const int32_t saddr = a.saddr[f];
  const int32_t daddr = a.daddr[f];
  const int32_t sport = a.sport[f];
  const int32_t dport = a.dport[f];
  const int32_t proto = a.proto[f];
  const int32_t src = a.src[f];

  // The probes that need no other answer, issued together: the identity
  // LPM on saddr (netdev), the endpoint on daddr, the CT forward key and
  // the reply to an entry the egress pass created, the tunnel LPM on daddr.
  const int32_t sa[1] = {saddr};
  const int32_t da[1] = {daddr};
  const int32_t kf[5] = {daddr, saddr, dport, sport, proto};
  const int32_t kr[5] = {saddr, daddr, sport, dport, proto};
  l34x::LpmPair<1> idp, tunp;
  l34x::Probe<kLxcS, kOwn ? kLxcS : 0> lx;
  l34x::Probe<kCtS, kOwn ? kCtS : 0> cf, cr;
  if (kMode == 0) l34x::lpm_start<1>(a.id_ix, sa, 0, idp);
  l34x::start<1, kLxcS>(a.lxc_ix, da, lx);
  l34x::start<5, kCtS>(a.ct_ix, kf, cf);
  l34x::start<5, kCtS>(a.ct_ix, kr, cr);
  l34x::lpm_start<1>(a.tun_ix, da, 0, tunp);
  if (kMode == 0) l34x::lpm_first<1>(a.id_ix, idp);
  l34x::first(a.lxc_ix, lx);
  l34x::first(a.ct_ix, cf);
  l34x::first(a.ct_ix, cr);
  l34x::lpm_first<1>(a.tun_ix, tunp);

  int32_t src_id = src;
  if (kMode == 0) {  // netdev: refine a reserved identity from the ipcache
    const bool reserved = src >= 0 && src <= kReservedMax;
    bool found;
    int32_t sec, plen;
    l34x::lpm_finish<1>(a.id_ix, sa, idp, found, sec, plen);
    if (reserved && found && sec != 0 && sec != kHostId) {
      src_id = sec;
    } else if (reserved && src == 0) {
      src_id = l34::kWorldId;
    }
  }
  l34x::PolicyProbe<kOwn ? l34x::kPolS : 0> pp;
  l34x::policy_start(a.pol_ix, src_id, dport, proto, kDirIngress, pp);

  // Local endpoint demux: the lxc table keyed by address, values summed.
  int32_t lxc[2] = {0, 0};  // endpoint id, flags
  const bool is_local = l34x::sum2<kOwn>(a.lxc, a.lxc_ix, lx, da, lxc);
  const int32_t lxc_id = lxc[0], lxc_flags = lxc[1];
  const bool is_host = is_local && (lxc_flags & kHostFlag) != 0;
  const bool est_f = l34x::found<5, kCtS>(a.ct_ix, cf, kf);
  const bool est_r = l34x::found<5, kCtS>(a.ct_ix, cr, kr);
  const bool est = est_f || est_r;
  bool tun_found;
  int32_t tunnel, tplen;
  l34x::lpm_finish<1>(a.tun_ix, da, tunp, tun_found, tunnel, tplen);

  l34x::policy_first(a.pol_ix, pp);
  bool allowed;
  int32_t proxy;
  l34x::policy_finish<kOwn>(a.pol, a.pol_ix, pp, allowed, proxy);

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
  if (!l34x::usable<1>(a.id_ix) || !l34x::usable<1>(a.tun_ix) ||
      !l34x::usable(a.lxc_ix, l34x::exact_width(1, a.lxc.v)) ||
      !l34x::usable(a.ct_ix, l34x::exact_width(5, a.ct.v)) ||
      !l34x::usable(a.pol_ix, l34x::exact_width(4, a.pol.v)))
    return cudaErrorInvalidValue;
  const bool own = a.lxc_ix.width == kLxcS && 1 + a.lxc.v + 1 <= kLxcS && a.ct_ix.width == kCtS &&
                   a.pol_ix.width == l34x::kPolS && 4 + a.pol.v + 1 <= l34x::kPolS;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = l34::blocks_for(a.f);
  if (a.mode == 0 && own)
    ingress_kernel<0, true><<<blocks, l34::kThreads, 0, st>>>(a);
  else if (a.mode == 0)
    ingress_kernel<0, false><<<blocks, l34::kThreads, 0, st>>>(a);
  else if (own)
    ingress_kernel<1, true><<<blocks, l34::kThreads, 0, st>>>(a);
  else
    ingress_kernel<1, false><<<blocks, l34::kThreads, 0, st>>>(a);
  return cudaGetLastError();
}
