// K7 http_hits: the HTTP rule walk and its two reductions.
//
// Replaces the combine half of cilium_tpu/models/http.py:425
// (_http_rule_hits): the regex-tier _scatter_or by slot (:466-482), the
// head-pattern count against head_count (:496-500), remote_ok
// (cilium_tpu/models/base.py:99), the any-allow AND complete
// (http_verdicts :509, :517) and the first true row for attribution
// (first_match, cilium_tpu/models/base.py:62, via _attr :522-536).  The
// TPU version scatter-added [F, PL] and [F, P] hit matrices into [F, R]
// counts and reduced an [F, R, MAX_REMOTES] remote compare.
//
// Bound on the H100: bytes (the method_ok bytes of the rows walked, the
// path_ok bytes where the method holds, the [F, PL] / [F, P] automaton
// hits, [F] out); the work is a few compares per rule row walked.
// Design: above 16 rules, a warp a flow (G = 32 lanes) walks the rules in
// steps of 16 G: lane j of a step holds 4 32-bit words of method_ok
// (rules base + 4 (u G + j) .. + 3, u < 4; a group's word u is 4 G
// consecutive bytes, so the loads coalesce), and the next step's words
// are loaded while this step is tested.  A step whose method bytes are all false holds no rule (unless
// method patterns are searched) and is passed over with one __any_sync.
// Otherwise each lane tests its rules in order: method (OR any_of the
// rule's method patterns), then path (its path_ok byte read only where
// the method holds), the head count, and last the remote set; then
// __ballot_sync / __ffs over the group give the lowest lane with a hit in
// the lowest word: that is the first rule that holds, which is both
// `allow` and `rule` (argmax over bool is the first true), and the walk
// stops.  Up to 16 rules, one lane a flow tests them one by one.  Each
// rule's regex and head patterns come from per-rule index lists (CSR,
// built once with the model from line_rule, line_slot and head_rule);
// summing a rule's head hits counts patterns, as the reference's .at[].add
// does, duplicates included.  An incomplete head skips the walk.
//
// Semantics, per rule r (rx_m, rx_p, head_hits may be absent):
//   m  = method_ok[f, r] | any rx_m[f, k] over the method patterns of r
//   p  = path_ok[f, r]   | any rx_p[f, k] over the path patterns of r
//   h  = head_hits absent, or sum head_hits[f, k] over r's head patterns
//        >= head_count[r]
//   ok = any_remote[r] | remotes[f] in remote_ids[r, :]
//   allow[f] = complete[f] & any_r (m & p & h & ok); rule[f] = the first
//   such r where allow[f], else -1.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRemotes = 32;  // models/base.py MAX_REMOTES

struct Args {
  const bool* complete;
  const bool* method_ok;  // [F, R]
  const bool* path_ok;    // [F, R]
  const bool* rx_m;       // [F, PL] or null
  const bool* rx_p;       // [F, PL] or null
  int PL;
  const bool* head_hits;  // [F, P] or null
  int P;
  const int32_t* remotes;
  const int32_t *m_ptr, *m_idx, *p_ptr, *p_idx, *h_ptr, *h_idx;
  const int32_t* head_count;
  const int32_t* remote_ids;  // [R, kMaxRemotes]
  const bool* any_remote;
  int F, R;
  bool vec;  // rows of method_ok / path_ok are 4-aligned: 32-bit loads
  bool* allow;
  int32_t* rule;
};

__device__ __forceinline__ bool any_of(const bool* __restrict__ hits,
                                       const int32_t* __restrict__ ptr,
                                       const int32_t* __restrict__ idx, int r) {
  for (int k = ptr[r]; k < ptr[r + 1]; ++k)
    if (hits[idx[k]]) return true;
  return false;
}

// Bytes r .. r + 3 of one [F, R] row as a word, 0 past R.
__device__ __forceinline__ uint32_t load4(const bool* __restrict__ row, int r, int R, bool vec) {
  if (r >= R) return 0u;
  if (vec) return __ldg(reinterpret_cast<const uint32_t*>(row + r));
  uint32_t w = 0u;
  const auto* b = reinterpret_cast<const unsigned char*>(row);
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (r + q < R) w |= static_cast<uint32_t>(__ldg(b + r + q)) << (8 * q);
  return w;
}

// Whether rule r holds for flow f, given its method_ok byte m: the path
// byte, the head count and the remote set are read only as far as the
// tests before them hold.
__device__ __forceinline__ bool holds(const Args& a, size_t f, int r, bool m,
                                      const bool* rxm, const bool* rxp, const bool* hh,
                                      int remote) {
  if (!m && !(rxm && any_of(rxm, a.m_ptr, a.m_idx, r))) return false;
  if (!a.path_ok[f * a.R + r] && !(rxp && any_of(rxp, a.p_ptr, a.p_idx, r))) return false;
  if (hh) {
    int count = 0;
    for (int k = a.h_ptr[r]; k < a.h_ptr[r + 1]; ++k) count += hh[a.h_idx[k]];
    if (count < a.head_count[r]) return false;
  }
  if (a.any_remote[r]) return true;
  const int32_t* ids = a.remote_ids + static_cast<size_t>(r) * kMaxRemotes;
  bool ok = false;
#pragma unroll
  for (int j = 0; j < kMaxRemotes; ++j) ok |= ids[j] == remote;
  return ok;
}

// The first of rules r .. r + 3 that holds for flow f (0-3), or -1.
__device__ __forceinline__ int first_in_word(const Args& a, size_t f, uint32_t mw, int r,
                                             const bool* rxm, const bool* rxp,
                                             const bool* hh, int remote) {
  for (int q = 0; q < 4 && r + q < a.R; ++q)
    if (holds(a, f, r + q, (mw >> (8 * q)) & 0xffu, rxm, rxp, hh, remote)) return q;
  return -1;
}

// G lanes a flow (1 or 32), U words a lane a step; with one lane a flow,
// the rules one by one.
template <int G, int U>
__global__ void __launch_bounds__(kThreads) http_hits_kernel(Args a) {
  constexpr int kStep = 4 * G * U;
  const int lane = threadIdx.x & 31;
  const int g = lane & (G - 1);
  const int g0 = lane - g;  // the group's first lane in the warp
  const unsigned gmask = G == 32 ? 0xffffffffu : ((1u << G) - 1u) << g0;
  const size_t f = (static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x) / G;
  if (f >= static_cast<size_t>(a.F)) return;  // the whole group leaves
  int hit = -1;
  if (a.complete[f]) {
    const bool* mrow = a.method_ok + f * a.R;
    const bool* rxm = a.rx_m ? a.rx_m + f * a.PL : nullptr;
    const bool* rxp = a.rx_p ? a.rx_p + f * a.PL : nullptr;
    const bool* hh = a.head_hits ? a.head_hits + f * a.P : nullptr;
    const int remote = a.remotes[f];
    if (G == 1) {
      for (int r = 0; r < a.R; ++r) {
        if (holds(a, f, r, mrow[r], rxm, rxp, hh, remote)) {
          hit = r;
          break;
        }
      }
    } else {
      // The next step's words are in flight while this step is tested.
      uint32_t cur[U], nxt[U];
#pragma unroll
      for (int u = 0; u < U; ++u) cur[u] = load4(mrow, 4 * (u * G + g), a.R, a.vec);
      for (int base = 0; base < a.R && hit < 0; base += kStep) {
        uint32_t any = 0u;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          nxt[u] = load4(mrow, base + kStep + 4 * (u * G + g), a.R, a.vec);
          any |= cur[u];
        }
        // Without method patterns, a step whose method bytes are all
        // false holds no rule.
        if (rxm || __any_sync(gmask, any != 0u)) {
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int r = base + 4 * (u * G + g);
            const int q = r < a.R && (cur[u] || rxm)
                              ? first_in_word(a, f, cur[u], r, rxm, rxp, hh, remote)
                              : -1;
            const unsigned held = __ballot_sync(gmask, q >= 0) & gmask;
            if (held) {
              const int src = __ffs(held) - 1;
              hit = base + 4 * (u * G + src - g0) + __shfl_sync(gmask, q, src);
              break;
            }
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) cur[u] = nxt[u];
      }
    }
  }
  if (g == 0) {
    a.allow[f] = hit >= 0;
    a.rule[f] = hit;
  }
}

template <int G, int U>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const long long threads = static_cast<long long>(a.F) * G;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  http_hits_kernel<G, U><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

CILIUM_EXPORT int http_hits(
    const void* complete, const void* method_ok, const void* path_ok,
    const void* rx_m, const void* rx_p, int PL, const void* head_hits, int P,
    const void* remotes, const void* m_ptr, const void* m_idx,
    const void* p_ptr, const void* p_idx, const void* h_ptr,
    const void* h_idx, const void* head_count, const void* remote_ids,
    const void* any_remote, int F, int R, void* allow, void* rule,
    void* stream) {
  if (F <= 0) return cudaSuccess;
  if (R < 1) return cudaErrorInvalidValue;
  Args a{static_cast<const bool*>(complete), static_cast<const bool*>(method_ok),
         static_cast<const bool*>(path_ok), static_cast<const bool*>(rx_m),
         static_cast<const bool*>(rx_p), PL, static_cast<const bool*>(head_hits), P,
         static_cast<const int32_t*>(remotes), static_cast<const int32_t*>(m_ptr),
         static_cast<const int32_t*>(m_idx), static_cast<const int32_t*>(p_ptr),
         static_cast<const int32_t*>(p_idx), static_cast<const int32_t*>(h_ptr),
         static_cast<const int32_t*>(h_idx), static_cast<const int32_t*>(head_count),
         static_cast<const int32_t*>(remote_ids), static_cast<const bool*>(any_remote),
         F, R, false, static_cast<bool*>(allow), static_cast<int32_t*>(rule)};
  a.vec = R % 4 == 0 &&
          (reinterpret_cast<uintptr_t>(method_ok) | reinterpret_cast<uintptr_t>(path_ok)) % 4 == 0;
  auto st = static_cast<cudaStream_t>(stream);
  // One lane a flow walks up to 16 rules; above that, a warp a flow.
  if (R <= 16) return launch<1, 1>(a, st);
  return launch<32, 4>(a, st);
}
