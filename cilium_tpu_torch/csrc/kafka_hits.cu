// K17 kafka_hits: the Kafka topic ACL.
//
// Replaces cilium_tpu/models/kafka.py:318 (kafka_verdicts), that is
// kafka_rule_hits (:229) and kafka_combine (:302) fused.  The TPU version
// built [F, R] gate matrices, an [F, R, 64] client compare and an
// [F, T, R, W] topic compare and reduced them.
//
// Bound on the H100: bytes (seven [F] columns, the [F, T] topic lengths,
// the client and topic bytes it compares, the [F] output); the compares
// are a handful of gates and a 32-id remote test per rule row visited,
// one length compare per (active topic, topic rule) and one per byte of
// the topics and client ids whose lengths are equal.  Design: one thread
// per request walks the rule rows in order.  The rule tables are read by
// a whole warp at one address (a broadcast through L1).  Bytes are
// compared only up to the lengths, where both sides are equal in length:
// the batch and the rule tables are zero-padded past their lengths, so
// this equals the reference's compare of the whole padded rows.  Without
// the optional outputs the walk stops once the verdict is settled
// (simple, or every active topic covered); with them it visits every
// row, and writes simple [F] and cover [F, T] exactly as kafka_rule_hits
// does for every slot, active or not.
//
// Semantics, per rule r (key = clamp(api_key, 0, 63), in = 0 <= api_key < 64):
//   base      = mask[r, key] & in & (version_any[r] | version[r] == api_version)
//               & extra & (any_remote[r] | remotes[f] in remote_ids[r, :])
//   extra     = simple_rule[r] ? 1 : parsed ? (client_any[r] | client_eq)
//               : api_key == 10 | !(!topic_any[r] & is_topic_key[key] & in)
//   simple   |= base & (topic_any[r] | topic_count == 0)
//   cover[t] |= base & !topic_any[r] & topic t == rule topic r
//   allow     = (simple | (topic_count > 0 & every t < topic_count covered))
//               & !overflow
// A rule topic longer than the batch width W never equals a batch topic
// (lengths differ), which is the reference's slice of the rule tensor to W.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxApiKey = 64;     // models/kafka.py MAX_API_KEY
constexpr int kMaxClient = 64;     // MAX_CLIENT_LEN
constexpr int kMaxTopicLen = 256;  // MAX_TOPIC_LEN (rule topic row)
constexpr int kMaxRemotes = 32;    // models/base.py MAX_REMOTES
constexpr int kFindCoordinator = 10;

__device__ __forceinline__ bool bytes_equal(const uint8_t* a,
                                            const uint8_t* b, int n) {
  for (int i = 0; i < n; ++i) {
    if (a[i] != b[i]) return false;
  }
  return true;
}

__global__ void kafka_hits_kernel(
    const int32_t* __restrict__ api_key, const int32_t* __restrict__ api_version,
    const uint8_t* __restrict__ client, const int32_t* __restrict__ client_len,
    const uint8_t* __restrict__ topics, const int32_t* __restrict__ topic_len,
    const int32_t* __restrict__ topic_count, const bool* __restrict__ parsed,
    const bool* __restrict__ overflow, const int32_t* __restrict__ remotes,
    const bool* __restrict__ key_mask, const int32_t* __restrict__ r_version,
    const bool* __restrict__ version_any, const uint8_t* __restrict__ r_client,
    const int32_t* __restrict__ r_client_len,
    const bool* __restrict__ client_any, const uint8_t* __restrict__ r_topic,
    const int32_t* __restrict__ r_topic_len, const bool* __restrict__ topic_any,
    const bool* __restrict__ is_topic_key, const int32_t* __restrict__ remote_ids,
    const bool* __restrict__ any_remote, int F, int R, int T, int W,
    bool* __restrict__ allow, bool* __restrict__ simple_out,
    bool* __restrict__ cover_out) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= F) return;
  const bool parts = simple_out != nullptr;
  const int key = api_key[f];
  const bool in_range = key >= 0 && key < kMaxApiKey;
  const int kc = min(max(key, 0), kMaxApiKey - 1);
  const int ver = api_version[f];
  const int clen = client_len[f];
  const int tc = topic_count[f];
  const bool is_parsed = parsed[f];
  const bool nil_topic_key = is_topic_key[kc] && in_range;
  const bool is_fc = key == kFindCoordinator;
  const int remote = remotes[f];
  const uint8_t* crow = client + static_cast<size_t>(f) * kMaxClient;
  const uint8_t* trow = topics + static_cast<size_t>(f) * T * W;
  const int32_t* tlen = topic_len + static_cast<size_t>(f) * T;

  // Slots to cover: the active ones for the verdict, all T for `cover`.
  const int slots = parts ? T : min(max(tc, 0), T);
  const uint32_t active = tc <= 0 ? 0u : (tc >= 32 ? ~0u : (1u << tc) - 1u);
  const uint32_t need = active & (T >= 32 ? ~0u : (1u << T) - 1u);
  bool simple = false;
  uint32_t covered = 0;

  for (int r = 0; r < R; ++r) {
    if (!parts && (simple || (tc > 0 && (need & ~covered) == 0))) break;
    if (!in_range || !key_mask[r * kMaxApiKey + kc]) continue;
    if (!version_any[r] && r_version[r] != ver) continue;
    const bool t_any = topic_any[r];
    const bool c_any = client_any[r];
    bool extra;
    if (t_any && c_any) {
      extra = true;
    } else if (is_parsed) {
      extra = c_any || (clen == r_client_len[r] &&
                        bytes_equal(crow, r_client + r * kMaxClient,
                                    min(max(clen, 0), kMaxClient)));
    } else {
      extra = is_fc || !(!t_any && nil_topic_key);
    }
    if (!extra) continue;
    bool rem_ok = any_remote[r];
    if (!rem_ok) {
      const int32_t* ids = remote_ids + r * kMaxRemotes;
#pragma unroll
      for (int j = 0; j < kMaxRemotes; ++j) rem_ok |= ids[j] == remote;
    }
    if (!rem_ok) continue;
    // base[f, r] holds.
    if (t_any || tc == 0) simple = true;
    if (t_any) continue;
    const int rlen = r_topic_len[r];
    const uint8_t* rt = r_topic + r * kMaxTopicLen;
    for (int t = 0; t < slots; ++t) {
      if ((covered >> t) & 1u) continue;
      if (tlen[t] != rlen) continue;
      // rlen <= W here: a batch topic's length never exceeds its width.
      if (bytes_equal(trow + t * W, rt, min(max(rlen, 0), W))) {
        covered |= 1u << t;
      }
    }
  }
  const bool all_covered = tc > 0 && (need & ~covered) == 0;
  allow[f] = (simple || all_covered) && !overflow[f];
  if (parts) {
    simple_out[f] = simple;
    for (int t = 0; t < T; ++t) {
      cover_out[static_cast<size_t>(f) * T + t] = (covered >> t) & 1u;
    }
  }
}

}  // namespace

CILIUM_EXPORT int kafka_hits(
    const void* api_key, const void* api_version, const void* client,
    const void* client_len, const void* topics, const void* topic_len,
    const void* topic_count, const void* parsed, const void* overflow,
    const void* remotes, const void* key_mask, const void* r_version,
    const void* version_any, const void* r_client, const void* r_client_len,
    const void* client_any, const void* r_topic, const void* r_topic_len,
    const void* topic_any, const void* is_topic_key, const void* remote_ids,
    const void* any_remote, int F, int R, int T, int W, void* allow,
    void* simple, void* cover, void* stream) {
  if (F <= 0) return cudaSuccess;
  if (T < 0 || T > 32 || W <= 0 || W > kMaxTopicLen ||
      (simple == nullptr) != (cover == nullptr)) {
    return cudaErrorInvalidValue;
  }
  kafka_hits_kernel<<<(F + kThreads - 1) / kThreads, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(api_key),
      static_cast<const int32_t*>(api_version),
      static_cast<const uint8_t*>(client),
      static_cast<const int32_t*>(client_len),
      static_cast<const uint8_t*>(topics),
      static_cast<const int32_t*>(topic_len),
      static_cast<const int32_t*>(topic_count),
      static_cast<const bool*>(parsed), static_cast<const bool*>(overflow),
      static_cast<const int32_t*>(remotes), static_cast<const bool*>(key_mask),
      static_cast<const int32_t*>(r_version),
      static_cast<const bool*>(version_any),
      static_cast<const uint8_t*>(r_client),
      static_cast<const int32_t*>(r_client_len),
      static_cast<const bool*>(client_any),
      static_cast<const uint8_t*>(r_topic),
      static_cast<const int32_t*>(r_topic_len),
      static_cast<const bool*>(topic_any),
      static_cast<const bool*>(is_topic_key),
      static_cast<const int32_t*>(remote_ids),
      static_cast<const bool*>(any_remote), F, R, T, W,
      static_cast<bool*>(allow), static_cast<bool*>(simple),
      static_cast<bool*>(cover));
  return cudaGetLastError();
}
