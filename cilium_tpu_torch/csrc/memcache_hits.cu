// K11 memcache_hits: the memcached (command/opcode, key) ACL.
//
// Replaces cilium_tpu/models/memcached.py:209 (memcache_verdicts) after
// its automaton search: the opcode and command table gathers, the exact
// and prefix key compares (spans_equal_prefix and spans_start_with,
// cilium_tpu/ops/bytescan.py:112, :129, with _spans_compare :84 and
// window_at :52), the key-mode select, remote_ok
// (cilium_tpu/models/base.py:99) and the any over rule rows.  The TPU
// version gathered [F, R] table columns and built two [F, R, 96] compare
// tensors for every row, whatever its key mode.
//
// Bound on the H100: bytes (the key bytes it compares, the [F, R] key
// regex hits, seven [F] inputs, the [F] output); the compares are one per
// needle byte of each exact or prefix row whose length test passes.
// Design: one thread per frame walks the rule rows in order and stops at
// the first row that allows.  The rule tables are read by a whole warp at
// one address (a broadcast through L1).  The prefix compare is the plain
// starts-with: unlike K6's HTTP prefix rows it has no newline guard.  Key
// bytes are read only below min(needle length, MAX_KEY), inside the
// 96-byte row.
//
// Semantics, per rule r (rx may be absent: no row has a keyRegex):
//   cmd_ok = is_binary ? op_tab[r, opcode] : cmd_tab[r, cmd_id], each
//            index counted from the end when negative, then clamped into
//            the table (the reference's gather)
//   key_len' = max(key_len, 0); n = min(key_needle_len[r], 96)
//   key_ok = !has_key, or by key_mode[r]: EXACT key_len' == needle_len
//            and key[0, n) == needle; PREFIX key_len' >= needle_len and
//            key[0, n) == needle; REGEX rx[f, r]; otherwise true
//   ok     = any_remote[r] | remotes[f] in remote_ids[r, :]
//   allow[f] = any_r (ok & (empty_rule[r] | (cmd_ok & key_ok))).
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxKey = 96;      // models/memcached.py MAX_KEY
constexpr int kMaxRemotes = 32;  // models/base.py MAX_REMOTES
constexpr int kExact = 1;        // KEY_MODE_EXACT
constexpr int kPrefix = 2;       // KEY_MODE_PREFIX
constexpr int kRegex = 3;        // KEY_MODE_REGEX

__device__ __forceinline__ int gather_index(int i, int n) {
  if (i < 0) i += n;
  return min(max(i, 0), n - 1);
}

__global__ void memcache_hits_kernel(
    const uint8_t* __restrict__ key_data, const int32_t* __restrict__ key_len,
    const bool* __restrict__ has_key, const bool* __restrict__ is_binary,
    const int32_t* __restrict__ opcode, const int32_t* __restrict__ cmd_id,
    const bool* __restrict__ rx, const int32_t* __restrict__ remotes,
    const bool* __restrict__ op_tab, const bool* __restrict__ cmd_tab,
    const bool* __restrict__ empty_rule, const int32_t* __restrict__ key_mode,
    const uint8_t* __restrict__ needle, const int32_t* __restrict__ needle_len,
    const int32_t* __restrict__ remote_ids,
    const bool* __restrict__ any_remote, int F, int R, int NC,
    bool* __restrict__ allow) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= F) return;
  const int klen = max(key_len[f], 0);
  const bool keyed = has_key[f];
  const bool binary = is_binary[f];
  const bool* col = binary ? op_tab + gather_index(opcode[f], 256)
                           : cmd_tab + gather_index(cmd_id[f], NC);
  const int stride = binary ? 256 : NC;
  const uint8_t* key = key_data + static_cast<size_t>(f) * kMaxKey;
  const bool* rx_row = rx ? rx + static_cast<size_t>(f) * R : nullptr;
  const int remote = remotes[f];

  bool hit = false;
  for (int r = 0; r < R && !hit; ++r) {
    bool l7 = empty_rule[r];
    if (!l7 && col[static_cast<size_t>(r) * stride]) {
      bool key_ok = !keyed;
      if (!key_ok) {
        const int mode = key_mode[r];
        if (mode == kExact || mode == kPrefix) {
          const int nlen = needle_len[r];
          if (mode == kExact ? klen == nlen : klen >= nlen) {
            const int n = min(nlen, kMaxKey);
            const uint8_t* nd = needle + static_cast<size_t>(r) * kMaxKey;
            key_ok = true;
            for (int i = 0; i < n; ++i) {
              if (key[i] != nd[i]) {
                key_ok = false;
                break;
              }
            }
          }
        } else if (mode == kRegex) {
          key_ok = rx_row != nullptr && rx_row[r];
        } else {
          key_ok = true;
        }
      }
      l7 = key_ok;
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

CILIUM_EXPORT int memcache_hits(
    const void* key_data, const void* key_len, const void* has_key,
    const void* is_binary, const void* opcode, const void* cmd_id,
    const void* rx, const void* remotes, const void* op_tab,
    const void* cmd_tab, const void* empty_rule, const void* key_mode,
    const void* needle, const void* needle_len, const void* remote_ids,
    const void* any_remote, int F, int R, int NC, void* allow, void* stream) {
  if (F <= 0) return cudaSuccess;
  memcache_hits_kernel<<<(F + kThreads - 1) / kThreads, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(key_data),
      static_cast<const int32_t*>(key_len), static_cast<const bool*>(has_key),
      static_cast<const bool*>(is_binary), static_cast<const int32_t*>(opcode),
      static_cast<const int32_t*>(cmd_id), static_cast<const bool*>(rx),
      static_cast<const int32_t*>(remotes), static_cast<const bool*>(op_tab),
      static_cast<const bool*>(cmd_tab), static_cast<const bool*>(empty_rule),
      static_cast<const int32_t*>(key_mode),
      static_cast<const uint8_t*>(needle),
      static_cast<const int32_t*>(needle_len),
      static_cast<const int32_t*>(remote_ids),
      static_cast<const bool*>(any_remote), F, R, NC,
      static_cast<bool*>(allow));
  return cudaGetLastError();
}
