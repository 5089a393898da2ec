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
// regex hits, seven [F] inputs, the [F] output); the work is one test a
// row walked and the key bytes of each exact or prefix row whose length
// test passes.  Design (acl_walk.cuh's direct walk): a thread walks a
// request.  Its loads (length, flags, opcode, command, remote, automaton
// row and its key's first 16 bytes) go out together with the tables' rows
// (needle length, key mode, flags, the needle's first 16 bytes, read
// through the read-only path at one address a warp) before any test; the
// key's other words up to the tables' longest exact or prefix needle (at
// most 96 bytes) and the request's command column for those rows follow
// together, and a key is compared with a needle word by word under a mask
// of the needle's first min(length, 96) bytes.  The rows are tested from
// registers as bit masks, the remote sets last.  The prefix compare is the
// plain starts-with: unlike K6's HTTP prefix rows it has no newline guard.
// K11 has this walk alone: the memcached policies run here have three
// rows, and at F = 65,536 a lane-group walk (as K10 takes past its
// kDirectRows) was no faster than this one at 24 or 40 rows
// (chip_hits_variants.py's sweep, PERF.md).  Past 8 rows the walk takes
// the rest a row at a time.
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
#include "acl_walk.cuh"

namespace {

using walk::kThreads;

constexpr int kMaxKey = 96;      // models/memcached.py MAX_KEY
constexpr int kKeyWords = kMaxKey / 16;
constexpr int kExact = 1;        // KEY_MODE_EXACT
constexpr int kPrefix = 2;       // KEY_MODE_PREFIX
constexpr int kRegex = 3;        // KEY_MODE_REGEX

__device__ __forceinline__ int gather_index(int i, int n) {
  if (i < 0) i += n;
  return min(max(i, 0), n - 1);
}

struct Args {
  const uint8_t* key_data;  // [F, 96]
  const int32_t* key_len;
  const bool* has_key;
  const bool* is_binary;
  const int32_t* opcode;
  const int32_t* cmd_id;
  const bool* rx;  // [F, R] or null
  const int32_t* remotes;
  const bool* op_tab;   // [R, 256]
  const bool* cmd_tab;  // [R, NC]
  const bool* empty_rule;
  const int32_t* key_mode;
  const uint8_t* needle;  // [R, 96]
  const int32_t* needle_len;
  const int32_t* remote_ids;  // [R, 32]
  const bool* any_remote;
  int F, R, NC;
  bool* allow;
  bool key16;     // the key base is 16-byte aligned (rows are 96 bytes)
  bool needle16;  // the needle base is 16-byte aligned (rows are 96 bytes)
  bool ids16;     // remote_ids is 16-byte aligned
};

// What a thread needs of its request.
struct Request {
  bool keyed;
  int f, klen, remote, stride;
  const bool* col;       // the request's column of op_tab or cmd_tab (row 0)
  const uint8_t* rxrow;  // the request's rx row, null without rx
  uint4 kw[kKeyWords];   // key bytes [0, 16 * words loaded)
};

// The key's words past the first, up to most bytes (the longest exact or
// prefix needle the walk may compare).
__device__ __forceinline__ void load_key_rest(const Args& a, Request& rq, int most) {
  const uint8_t* key = a.key_data + static_cast<size_t>(rq.f) * kMaxKey;
#pragma unroll
  for (int k = 1; k < kKeyWords; ++k)
    if (16 * k < most) rq.kw[k] = acl::load16(key, 16 * k, kMaxKey, a.key16);
}

// The longest needle (at most 96 bytes) of the exact and prefix rows in
// [r, end).
__device__ __forceinline__ int longest_needle(const Args& a, int r, int end) {
  int most = 0;
  for (; r < end; ++r) {
    const int mode = __ldg(a.key_mode + r);
    if (mode == kExact || mode == kPrefix) most = max(most, min(__ldg(a.needle_len + r), kMaxKey));
  }
  return most;
}

// The key equals rule r's needle on their first n bytes (n at most the
// bytes load_key_rest loaded), the needle's first 16 given (head).
__device__ __forceinline__ bool key_equal(const Args& a, const Request& rq, size_t r, const uint4& head, int n) {
  const uint8_t* nd = a.needle + r * kMaxKey;
  bool same = acl::same16(rq.kw[0], head, n);
#pragma unroll
  for (int k = 1; k < kKeyWords; ++k)
    if (16 * k < n) same &= acl::same16(rq.kw[k], acl::load16(nd, 16 * k, kMaxKey, a.needle16), n - 16 * k);
  return same;
}

// Row r passes the request's command and key (its remote set aside):
// nlen, mode, empty and head (its needle's first 16 bytes) are the row's,
// cmd_bit and rx_bit its command column byte and automaton hit.
__device__ __forceinline__ bool row_l7(const Args& a, const Request& rq, size_t r, int nlen, int mode, bool empty,
                                       const uint4& head, bool cmd_bit, bool rx_bit) {
  if (empty) return true;
  if (!cmd_bit) return false;
  if (!rq.keyed) return true;
  if (mode == kExact || mode == kPrefix)
    return (mode == kExact ? rq.klen == nlen : rq.klen >= nlen) && key_equal(a, rq, r, head, min(nlen, kMaxKey));
  return mode != kRegex || rx_bit;
}

// Rows [from, R) of a forced direct walk, a row at a time.
__device__ bool direct_rest(const Args& a, const Request& rq, int from) {
  for (int r = from; r < a.R; ++r) {
    const uint4 head = acl::load16(a.needle + static_cast<size_t>(r) * kMaxKey, 0, kMaxKey, a.needle16);
    if (row_l7(a, rq, r, __ldg(a.needle_len + r), __ldg(a.key_mode + r), walk::flag(a.empty_rule + r), head,
               walk::flag(rq.col + static_cast<size_t>(r) * rq.stride), rq.rxrow && __ldg(rq.rxrow + r)) &&
        (walk::flag(a.any_remote + r) ||
         walk::remote_in(a.remote_ids + static_cast<size_t>(r) * walk::kMaxRemotes, rq.remote, a.ids16)))
      return true;
  }
  return false;
}

// The direct walk: a thread a request, D rows a thread (R rounded up to
// 1, 2, 4 or 8; rows past R read row R - 1 again and are dropped).  Every
// load of the request and of the tables' D rows goes out first, with no
// branch among them: a load issued after a test waits for the loads that
// test reads, so a branch between two loads puts a round trip between
// them, and each row past R costs a row's loads (chip_hits_variants.py's
// readings, PERF.md).  The request's command column and the key's words up
// to the longest needle follow together; then the rows are tested from
// registers as bit masks, the remote sets last.  kVec: the key and needle
// bases are 16-byte aligned; kRx: the model has an automaton.
template <int D, bool kVec, bool kRx>
__global__ void __launch_bounds__(kThreads) memcache_direct_kernel(Args a) {
  const int f = blockIdx.x * kThreads + threadIdx.x;
  if (f >= a.F) return;
  if (a.R <= 0) {
    a.allow[f] = false;
    return;
  }
  Request rq;
  rq.f = f;
  rq.rxrow = kRx ? reinterpret_cast<const uint8_t*>(a.rx) + static_cast<size_t>(f) * a.R : nullptr;
  const int klen = __ldg(a.key_len + f);
  const uint8_t keyed = __ldg(reinterpret_cast<const uint8_t*>(a.has_key) + f);
  const uint8_t binary = __ldg(reinterpret_cast<const uint8_t*>(a.is_binary) + f);
  const int op = __ldg(a.opcode + f);
  const int cid = __ldg(a.cmd_id + f);
  rq.remote = __ldg(a.remotes + f);
  rq.kw[0] = acl::load16(a.key_data + static_cast<size_t>(f) * kMaxKey, 0, kMaxKey, kVec);
#pragma unroll
  for (int k = 1; k < kKeyWords; ++k) rq.kw[k] = make_uint4(0u, 0u, 0u, 0u);
  uint4 head[D];
  int nlen[D], mode[D];
  uint8_t rxb[D], empty[D], open[D];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const int r = min(j, a.R - 1);
    rxb[j] = kRx ? __ldg(rq.rxrow + r) : 0;
    nlen[j] = __ldg(a.needle_len + r);
    mode[j] = __ldg(a.key_mode + r);
    empty[j] = __ldg(reinterpret_cast<const uint8_t*>(a.empty_rule) + r);
    open[j] = __ldg(reinterpret_cast<const uint8_t*>(a.any_remote) + r);
    head[j] = acl::load16(a.needle + static_cast<size_t>(r) * kMaxKey, 0, kMaxKey, kVec);
  }
  rq.klen = max(klen, 0);
  rq.keyed = keyed != 0;
  rq.col = binary ? a.op_tab + gather_index(op, 256) : a.cmd_tab + gather_index(cid, a.NC);
  rq.stride = binary ? 256 : a.NC;
  uint8_t cmd[D];
#pragma unroll
  for (int j = 0; j < D; ++j) cmd[j] = __ldg(reinterpret_cast<const uint8_t*>(rq.col) + static_cast<size_t>(min(j, a.R - 1)) * rq.stride);
  int most = 0;
#pragma unroll
  for (int j = 0; j < D; ++j)
    if (j < a.R && (mode[j] == kExact || mode[j] == kPrefix)) most = max(most, min(nlen[j], kMaxKey));
  if (a.R > D) most = max(most, longest_needle(a, D, a.R));
  load_key_rest(a, rq, most);
  unsigned pass = 0u, opens = 0u;  // bit j: row j passes; its remote set is any
#pragma unroll
  for (int j = 0; j < D; ++j) {
    if (row_l7(a, rq, min(j, a.R - 1), nlen[j], mode[j], empty[j], head[j], cmd[j], rxb[j])) pass |= 1u << j;
    if (open[j]) opens |= 1u << j;
  }
  const unsigned rows = a.R >= D ? (1u << D) - 1u : (1u << a.R) - 1u;
  bool hit = acl::remote_pass(pass & rows, opens & rows, a.remote_ids, 0, rq.remote, a.ids16);
  if (!hit && a.R > D) hit = direct_rest(a, rq, D);
  a.allow[f] = hit;
}

struct Launch {
  Args a;
  cudaStream_t stream;

  // The direct walk over D rows a thread (rows past R read row R - 1 again).
  template <int D>
  cudaError_t direct_rows() const {
    auto kernel = a.key16 && a.needle16 ? (a.rx ? memcache_direct_kernel<D, true, true> : memcache_direct_kernel<D, true, false>)
                     : (a.rx ? memcache_direct_kernel<D, false, true> : memcache_direct_kernel<D, false, false>);
    kernel<<<(a.F + kThreads - 1) / kThreads, kThreads, 0, stream>>>(a);
    return cudaGetLastError();
  }

  cudaError_t direct() const {
    return a.R <= 1 ? direct_rows<1>() : a.R <= 2 ? direct_rows<2>() : a.R <= 4 ? direct_rows<4>()
                                                                       : direct_rows<acl::kRowsAtOnce>();
  }
};

Launch make_launch(const void* key_data, const void* key_len, const void* has_key,
                   const void* is_binary, const void* opcode, const void* cmd_id, const void* rx,
                   const void* remotes, const void* op_tab, const void* cmd_tab,
                   const void* empty_rule, const void* key_mode, const void* needle,
                   const void* needle_len, const void* remote_ids, const void* any_remote, int F,
                   int R, int NC, void* allow, void* stream) {
  Args a;
  a.key_data = static_cast<const uint8_t*>(key_data);
  a.key_len = static_cast<const int32_t*>(key_len);
  a.has_key = static_cast<const bool*>(has_key);
  a.is_binary = static_cast<const bool*>(is_binary);
  a.opcode = static_cast<const int32_t*>(opcode);
  a.cmd_id = static_cast<const int32_t*>(cmd_id);
  a.rx = static_cast<const bool*>(rx);
  a.remotes = static_cast<const int32_t*>(remotes);
  a.op_tab = static_cast<const bool*>(op_tab);
  a.cmd_tab = static_cast<const bool*>(cmd_tab);
  a.empty_rule = static_cast<const bool*>(empty_rule);
  a.key_mode = static_cast<const int32_t*>(key_mode);
  a.needle = static_cast<const uint8_t*>(needle);
  a.needle_len = static_cast<const int32_t*>(needle_len);
  a.remote_ids = static_cast<const int32_t*>(remote_ids);
  a.any_remote = static_cast<const bool*>(any_remote);
  a.F = F;
  a.R = R;
  a.NC = NC;
  a.allow = static_cast<bool*>(allow);
  auto at16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  a.key16 = at16(key_data);
  a.needle16 = at16(needle);
  a.ids16 = at16(remote_ids);
  return Launch{a, static_cast<cudaStream_t>(stream)};
}

}  // namespace

// The (lanes, rows a lane a step) a launch takes for R rules and F
// requests, packed as lanes | rows << 8 (kernels.hits_variant): always 0,
// the direct walk.
CILIUM_EXPORT int hits_variant(int, int) { return 0; }

CILIUM_EXPORT int memcache_hits(
    const void* key_data, const void* key_len, const void* has_key,
    const void* is_binary, const void* opcode, const void* cmd_id,
    const void* rx, const void* remotes, const void* op_tab,
    const void* cmd_tab, const void* empty_rule, const void* key_mode,
    const void* needle, const void* needle_len, const void* remote_ids,
    const void* any_remote, int F, int R, int NC, void* allow, void* stream) {
  if (F <= 0) return cudaSuccess;
  if (NC < 1) return cudaErrorInvalidValue;
  const Launch launch = make_launch(key_data, key_len, has_key, is_binary, opcode, cmd_id, rx,
                                    remotes, op_tab, cmd_tab, empty_rule, key_mode, needle,
                                    needle_len, remote_ids, any_remote, F, R, NC, allow, stream);
  return launch.direct();
}
