// K9 dns_hits: the DNS rule-row walk and its two reductions.
//
// Replaces the match half of cilium_tpu/models/dns.py:291
// (_dns_rule_hits): the exact-name compare (spans_equal_prefix over the
// dotted span, cilium_tpu/ops/bytescan.py:112 with _spans_compare :84 and
// window_at :52), the OR with the automaton tier where the row uses it,
// the QNAME validity gate, remote_ok (cilium_tpu/models/base.py:99), the
// any-allow of dns_verdicts (:318) and the first true row of
// dns_verdicts_attr (:332, first_match at cilium_tpu/models/base.py:62).
// The TPU version built [F, R, W] and [F, R, 32] compare tensors and
// reduced them.
//
// Bound on the H100: bytes (the [F, R] automaton hits, the spans, the
// dotted bytes of the names it compares, the outputs); the compares are
// one per needle byte of each row whose length equals the span's.
// Design: one thread per flow walks the rule rows in order and stops at
// the first row that holds, which is both `allow` and `rule`.  The rule
// tables are a few KB, read by a whole warp at one address (a broadcast
// through L1), as K4 and K7 read theirs.  A name byte is read only where
// the needle length equals the span length, and never at or past L (the
// reference's window_at zero-fills there; the two agree because the span
// ends at or before L).
//
// Semantics, per rule r (rx may be absent: the model has no pattern or
// regex row):
//   exact = span_len == name_len[r] and dotted[s, s + min(name_len, W))
//           equals needle[r], with span_len = max(span_end - span_start, 0)
//   name  = name_any[r] | (valid & (exact | (use_rx[r] & rx[f, r])))
//   ok    = any_remote[r] | remotes[f] in remote_ids[r, :]
//   allow[f] = any_r (name & ok); rule[f] = the first such r, else -1.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxRemotes = 32;  // models/base.py MAX_REMOTES

__global__ void dns_hits_kernel(
    const uint8_t* __restrict__ dotted, const bool* __restrict__ valid,
    const int32_t* __restrict__ span_start,
    const int32_t* __restrict__ span_end, const bool* __restrict__ rx,
    const int32_t* __restrict__ remotes, const uint8_t* __restrict__ needle,
    const int32_t* __restrict__ name_len, const bool* __restrict__ name_any,
    const bool* __restrict__ use_rx, const int32_t* __restrict__ remote_ids,
    const bool* __restrict__ any_remote, int F, int L, int R, int W,
    bool* __restrict__ allow, int32_t* __restrict__ rule) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= F) return;
  const int s = span_start[f];
  const int span_len = max(span_end[f] - s, 0);
  const bool ok_name = valid[f];
  const uint8_t* row = dotted + static_cast<size_t>(f) * L;
  const bool* rx_row = rx ? rx + static_cast<size_t>(f) * R : nullptr;
  const int remote = remotes[f];

  int hit = -1;
  for (int r = 0; r < R; ++r) {
    bool name_ok = name_any[r];
    if (!name_ok && ok_name) {
      if (rx_row && use_rx[r] && rx_row[r]) {
        name_ok = true;
      } else if (name_len[r] == span_len) {
        const int n = min(span_len, W);
        const uint8_t* nd = needle + static_cast<size_t>(r) * W;
        name_ok = true;
        for (int i = 0; i < n; ++i) {
          const int idx = s + i;
          const uint8_t b = (idx >= 0 && idx < L) ? row[idx] : 0;
          if (b != nd[i]) {
            name_ok = false;
            break;
          }
        }
      }
    }
    if (!name_ok) continue;
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
  allow[f] = hit >= 0;
  rule[f] = hit;
}

}  // namespace

CILIUM_EXPORT int dns_hits(const void* dotted, const void* valid,
                           const void* span_start, const void* span_end,
                           const void* rx, const void* remotes,
                           const void* needle, const void* name_len,
                           const void* name_any, const void* use_rx,
                           const void* remote_ids, const void* any_remote,
                           int F, int L, int R, int W, void* allow,
                           void* rule, void* stream) {
  if (F <= 0) return cudaSuccess;
  dns_hits_kernel<<<(F + kThreads - 1) / kThreads, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(dotted), static_cast<const bool*>(valid),
      static_cast<const int32_t*>(span_start),
      static_cast<const int32_t*>(span_end), static_cast<const bool*>(rx),
      static_cast<const int32_t*>(remotes),
      static_cast<const uint8_t*>(needle),
      static_cast<const int32_t*>(name_len),
      static_cast<const bool*>(name_any), static_cast<const bool*>(use_rx),
      static_cast<const int32_t*>(remote_ids),
      static_cast<const bool*>(any_remote), F, L, R, W,
      static_cast<bool*>(allow), static_cast<int32_t*>(rule));
  return cudaGetLastError();
}
