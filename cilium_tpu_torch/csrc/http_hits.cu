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
// Bound on the H100: bytes (the [F, R] literal-tier matrices and the
// [F, PL] / [F, P] automaton hits in, [F] out); the work is a few
// compares per rule row the walk visits.  Design: one thread per flow
// walks the rule rows in order and stops at the first row that holds,
// which is both `allow` and `rule` (argmax over bool is the first true).
// Each rule's regex and head patterns come from per-rule index lists
// (CSR, built once with the model from line_rule, line_slot and
// head_rule), so the walk reads only the hit columns of the rule at hand;
// summing a rule's head hits counts patterns, as the reference's
// .at[].add does, duplicates included.  An incomplete head skips the walk.
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

constexpr int kThreads = 128;
constexpr int kMaxRemotes = 32;  // models/base.py MAX_REMOTES

__device__ __forceinline__ bool any_of(const bool* __restrict__ hits,
                                       const int32_t* __restrict__ ptr,
                                       const int32_t* __restrict__ idx,
                                       int r) {
  for (int k = ptr[r]; k < ptr[r + 1]; ++k)
    if (hits[idx[k]]) return true;
  return false;
}

__global__ void http_hits_kernel(
    const bool* __restrict__ complete, const bool* __restrict__ method_ok,
    const bool* __restrict__ path_ok, const bool* __restrict__ rx_m,
    const bool* __restrict__ rx_p, int PL, const bool* __restrict__ head_hits,
    int P, const int32_t* __restrict__ remotes,
    const int32_t* __restrict__ m_ptr, const int32_t* __restrict__ m_idx,
    const int32_t* __restrict__ p_ptr, const int32_t* __restrict__ p_idx,
    const int32_t* __restrict__ h_ptr, const int32_t* __restrict__ h_idx,
    const int32_t* __restrict__ head_count,
    const int32_t* __restrict__ remote_ids,
    const bool* __restrict__ any_remote, int F, int R,
    bool* __restrict__ allow, int32_t* __restrict__ rule) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= F) return;
  int hit = -1;
  if (complete[f]) {
    const size_t fr = static_cast<size_t>(f) * R;
    const bool* rxm = rx_m ? rx_m + static_cast<size_t>(f) * PL : nullptr;
    const bool* rxp = rx_p ? rx_p + static_cast<size_t>(f) * PL : nullptr;
    const bool* hh = head_hits ? head_hits + static_cast<size_t>(f) * P : nullptr;
    const int remote = remotes[f];
    for (int r = 0; r < R; ++r) {
      if (!method_ok[fr + r] && !(rxm && any_of(rxm, m_ptr, m_idx, r))) continue;
      if (!path_ok[fr + r] && !(rxp && any_of(rxp, p_ptr, p_idx, r))) continue;
      if (hh) {
        int count = 0;
        for (int k = h_ptr[r]; k < h_ptr[r + 1]; ++k) count += hh[h_idx[k]];
        if (count < head_count[r]) continue;
      }
      bool rem_ok = any_remote[r];
      if (!rem_ok) {
        const int32_t* ids = remote_ids + r * kMaxRemotes;
#pragma unroll
        for (int j = 0; j < kMaxRemotes; ++j) rem_ok |= ids[j] == remote;
      }
      if (rem_ok) {
        hit = r;
        break;
      }
    }
  }
  allow[f] = hit >= 0;
  rule[f] = hit;
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
  http_hits_kernel<<<(F + kThreads - 1) / kThreads, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bool*>(complete), static_cast<const bool*>(method_ok),
      static_cast<const bool*>(path_ok), static_cast<const bool*>(rx_m),
      static_cast<const bool*>(rx_p), PL, static_cast<const bool*>(head_hits),
      P, static_cast<const int32_t*>(remotes),
      static_cast<const int32_t*>(m_ptr), static_cast<const int32_t*>(m_idx),
      static_cast<const int32_t*>(p_ptr), static_cast<const int32_t*>(p_idx),
      static_cast<const int32_t*>(h_ptr), static_cast<const int32_t*>(h_idx),
      static_cast<const int32_t*>(head_count),
      static_cast<const int32_t*>(remote_ids),
      static_cast<const bool*>(any_remote), F, R, static_cast<bool*>(allow),
      static_cast<int32_t*>(rule));
  return cudaGetLastError();
}
