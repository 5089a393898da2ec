// K21 shard_reduce and K22 kafka_shard_combine: the cross-shard merges of
// the rule-sharded verdict steps, run on the lead slot of each flow row
// after every rule shard's partial result was copied there.
//
// K21 replaces the psum / pmin reductions of sharded_verdict_step and
// sharded_verdict_step_attr (cilium_tpu/parallel/rulesharding.py:478,
// :494-498, :527, :553-560).  With allow_parts [R, F] and, for the
// attributed form, rule_parts [R, F] and offsets [R]:
//   allow[f] = OR_j allow_parts[j, f]                   (psum(allow) > 0)
//   cand[f]  = min_j (rule_parts[j, f] >= 0
//                       ? rule_parts[j, f] + offsets[j] : INT32_MAX)
//   rule[f]  = allow[f] ? cand[f] : -1
// (where(allow, pmin(cand), -1): where allow holds but no shard has a row,
// rule is INT32_MAX, exactly as the reference gives).
//
// K22 replaces sharded_kafka_step's merge (rulesharding.py:503, :516-522)
// together with kafka_combine (cilium_tpu/models/kafka.py:302-314), which
// runs on the merged partials because it does not distribute over rule
// subsets.  With simple_parts [R, F], cover_parts [R, F, T], topic_count
// [F] and overflow [F]:
//   simple[f]   = OR_j simple_parts[j, f]
//   covered[f]  = AND_{t < T, t < topic_count[f]} OR_j cover_parts[j, f, t]
//                 and topic_count[f] > 0
//   allow[f]    = (simple[f] | covered[f]) & !overflow[f]
//
// Bound on the H100: bytes.  Each flow reads R bytes (and 8R more for the
// attributed form, TR more for K22) and writes one or five; there is one
// compare or min per byte read.  At F = 65,536 and R = 4 that is well under
// a microsecond at 3.35 TB/s, so the launch sets the time.  Design: one
// thread per flow, a grid-stride loop, a loop over R inside; neighbouring
// threads read neighbouring bytes of each shard's row, so every load of a
// warp is one coalesced segment.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int32_t kNoMatch = 0x7fffffff;

__global__ void shard_reduce_kernel(const bool* __restrict__ allow_parts,
                                    const int32_t* __restrict__ rule_parts,
                                    const int32_t* __restrict__ offsets,
                                    int R, int F, bool* __restrict__ allow,
                                    int32_t* __restrict__ rule) {
  for (int f = blockIdx.x * blockDim.x + threadIdx.x; f < F;
       f += gridDim.x * blockDim.x) {
    bool a = false;
    int32_t cand = kNoMatch;
    for (int j = 0; j < R; ++j) {
      const size_t at = static_cast<size_t>(j) * F + f;
      a = a || allow_parts[at];
      if (rule_parts != nullptr) {
        const int32_t r = rule_parts[at];
        if (r >= 0) cand = min(cand, r + offsets[j]);
      }
    }
    allow[f] = a;
    if (rule != nullptr) rule[f] = a ? cand : -1;
  }
}

__global__ void kafka_shard_combine_kernel(
    const bool* __restrict__ simple_parts, const bool* __restrict__ cover_parts,
    const int32_t* __restrict__ topic_count, const bool* __restrict__ overflow,
    int R, int F, int T, bool* __restrict__ allow) {
  for (int f = blockIdx.x * blockDim.x + threadIdx.x; f < F;
       f += gridDim.x * blockDim.x) {
    bool simple = false;
    for (int j = 0; j < R; ++j) {
      simple = simple || simple_parts[static_cast<size_t>(j) * F + f];
    }
    const int32_t tc = topic_count[f];
    bool covered = tc > 0;
    for (int t = 0; t < T && covered; ++t) {
      if (t >= tc) break;
      bool c = false;
      for (int j = 0; j < R; ++j) {
        c = c || cover_parts[(static_cast<size_t>(j) * F + f) * T + t];
      }
      covered = c;
    }
    allow[f] = (simple || covered) && !overflow[f];
  }
}

int blocks_for(int n) {
  const int want = (n + kThreads - 1) / kThreads;
  return want < 132 * 8 ? want : 132 * 8;
}

}  // namespace

// rule_parts, offsets and rule are all null (the plain form) or none is.
CILIUM_EXPORT int shard_reduce(const bool* allow_parts, const int32_t* rule_parts,
                               const int32_t* offsets, int R, int F, bool* allow,
                               int32_t* rule, void* stream) {
  if (R < 1 || F < 0) return static_cast<int>(cudaErrorInvalidValue);
  if ((rule_parts == nullptr) != (rule == nullptr) ||
      (rule_parts == nullptr) != (offsets == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (F > 0) {
    shard_reduce_kernel<<<blocks_for(F), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        allow_parts, rule_parts, offsets, R, F, allow, rule);
  }
  return static_cast<int>(cudaGetLastError());
}

CILIUM_EXPORT int kafka_shard_combine(const bool* simple_parts,
                                      const bool* cover_parts,
                                      const int32_t* topic_count,
                                      const bool* overflow, int R, int F, int T,
                                      bool* allow, void* stream) {
  if (R < 1 || F < 0 || T < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (F > 0) {
    kafka_shard_combine_kernel<<<blocks_for(F), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
        simple_parts, cover_parts, topic_count, overflow, R, F, T, allow);
  }
  return static_cast<int>(cudaGetLastError());
}
