// K10 cassandra_hits: the Cassandra (action, table) ACL.
//
// Replaces cilium_tpu/models/cassandra.py:160 (cassandra_verdicts) after
// its automaton search: the action compare (spans_equal_prefix over
// [0, action_len), cilium_tpu/ops/bytescan.py:112 with _spans_compare :84
// and window_at :52), the table gate, remote_ok
// (cilium_tpu/models/base.py:99) and the any over rule rows.  The TPU
// version built [F, R, 32] and [F, R, 32] compare tensors and reduced
// them.
//
// Bound on the H100: bytes (the action bytes it compares, the [F, R]
// table hits, five [F] inputs, the [F] output); the compares are one per
// needle byte of each row whose length equals the action's.  Design: one
// thread per request walks the rule rows in order and stops at the first
// row that allows.  The rule tables are read by a whole warp at one
// address (a broadcast through L1).  Action bytes are read only where a
// row's needle length equals the request's action length, and only below
// MAX_ACTION, inside the 128-byte row.
//
// Semantics, per rule r (rx may be absent: no row has a table regex, so
// every table_none is true):
//   action_ok = action_any[r] | (max(action_len, 0) == a_len[r] and
//               data[0, min(a_len, 32)) equals needle[r])
//   table_ok  = table_none[r] | table_len == 0 | rx[f, r]
//   ok        = any_remote[r] | remotes[f] in remote_ids[r, :]
//   allow[f]  = any_r (ok & (non_query[f] | (action_ok & table_ok))).
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxAction = 32;   // models/cassandra.py MAX_ACTION
constexpr int kRow = 32 + 96;    // MAX_ACTION + MAX_TABLE
constexpr int kMaxRemotes = 32;  // models/base.py MAX_REMOTES

__global__ void cassandra_hits_kernel(
    const uint8_t* __restrict__ data, const int32_t* __restrict__ action_len,
    const int32_t* __restrict__ table_len, const bool* __restrict__ non_query,
    const bool* __restrict__ rx, const int32_t* __restrict__ remotes,
    const uint8_t* __restrict__ needle, const int32_t* __restrict__ a_len,
    const bool* __restrict__ action_any, const bool* __restrict__ table_none,
    const int32_t* __restrict__ remote_ids,
    const bool* __restrict__ any_remote, int F, int R,
    bool* __restrict__ allow) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= F) return;
  const int alen = max(action_len[f], 0);
  const bool no_table = table_len[f] == 0;
  const bool nq = non_query[f];
  const uint8_t* row = data + static_cast<size_t>(f) * kRow;
  const bool* rx_row = rx ? rx + static_cast<size_t>(f) * R : nullptr;
  const int remote = remotes[f];

  bool hit = false;
  for (int r = 0; r < R && !hit; ++r) {
    bool l7 = nq;
    if (!l7) {
      bool action_ok = action_any[r];
      if (!action_ok && a_len[r] == alen) {
        const int n = min(alen, kMaxAction);
        const uint8_t* nd = needle + static_cast<size_t>(r) * kMaxAction;
        action_ok = true;
        for (int i = 0; i < n; ++i) {
          if (row[i] != nd[i]) {
            action_ok = false;
            break;
          }
        }
      }
      l7 = action_ok &&
           (table_none[r] || no_table || (rx_row != nullptr && rx_row[r]));
    }
    if (!l7) continue;
    bool rem_ok = any_remote[r];
    if (!rem_ok) {
      const int32_t* ids = remote_ids + r * kMaxRemotes;
#pragma unroll
      for (int j = 0; j < kMaxRemotes; ++j) rem_ok |= ids[j] == remote;
    }
    hit = rem_ok;
  }
  allow[f] = hit;
}

}  // namespace

CILIUM_EXPORT int cassandra_hits(const void* data, const void* action_len,
                                 const void* table_len, const void* non_query,
                                 const void* rx, const void* remotes,
                                 const void* needle, const void* a_len,
                                 const void* action_any,
                                 const void* table_none,
                                 const void* remote_ids,
                                 const void* any_remote, int F, int R,
                                 void* allow, void* stream) {
  if (F <= 0) return cudaSuccess;
  cassandra_hits_kernel<<<(F + kThreads - 1) / kThreads, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data),
      static_cast<const int32_t*>(action_len),
      static_cast<const int32_t*>(table_len),
      static_cast<const bool*>(non_query), static_cast<const bool*>(rx),
      static_cast<const int32_t*>(remotes),
      static_cast<const uint8_t*>(needle), static_cast<const int32_t*>(a_len),
      static_cast<const bool*>(action_any),
      static_cast<const bool*>(table_none),
      static_cast<const int32_t*>(remote_ids),
      static_cast<const bool*>(any_remote), F, R, static_cast<bool*>(allow));
  return cudaGetLastError();
}
