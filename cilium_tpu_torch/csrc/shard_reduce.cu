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
// Bound on the H100: bytes.  Each flow reads R bytes (and 4R more for the
// attributed form, TR more for K22) and writes one or five; there is one
// OR or min per byte read.  At F = 65,536 and R = 4 that is well under a
// microsecond at 3.35 TB/s, so the launch and one load round trip set the
// time.  K21's design keeps it at one round trip: each thread takes 16
// flows (the plain form: one 16-byte load a shard) or 4 (the attributed
// form: one 4-byte allow load and one 16-byte rule load a shard), issues
// every shard's loads before it combines any (R is a template argument up
// to 8), and ORs whole words: torch bools are 0 or 1, so the OR of the
// bytes is the OR of the bools, with no branch.  The min is a select on
// each lane.  Rows whose pointers or width do not allow the vector loads
// (a sliced view, F not a multiple of the width) take 4-byte words or
// single flows; a scalar tail takes F past the last whole vector.  The
// grid is sized to the work.
//
// K22 is one round trip the same way, branch-free: R is a template
// argument up to 8 (by_r), every shard's loads are issued before any is
// combined, the shards are ORed as whole words and each byte is tested
// for nonzero (SWAR, so a bool byte other than 0 or 1 counts as true, as
// in the plain version), and the active topics are a byte mask built from
// topic_count (every topic where tc >= T; no cover where tc <= 0).  Paths
// (kafka_combine_variant reports the pick, kafka_shard_combine_forced
// forces any):
//   * flow, the pick where T = 8 and cover is 8-byte aligned: one thread a
//     flow, one 8-byte cover load and one simple byte a shard;
//   * general, the pick elsewhere: any T and any alignment, one thread a
//     flow, byte loads, a loop over T (every topic read, the inactive ones
//     masked).
#include "common.cuh"

namespace {

constexpr int32_t kNoMatch = 0x7fffffff;

// The OR of two words, byte by byte.
__device__ __forceinline__ uint4 or_words(uint4 a, uint4 b) {
  return make_uint4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w);
}
__device__ __forceinline__ uint32_t or_words(uint32_t a, uint32_t b) { return a | b; }
__device__ __forceinline__ uint8_t or_words(uint8_t a, uint8_t b) { return a | b; }

// One shard's offset-biased candidate row, INT32_MAX where it has none.
__device__ __forceinline__ int32_t shard_cand(int32_t r, int32_t off) {
  return r >= 0 ? r + off : kNoMatch;
}

// Plain form: allow[f] = OR_j allow_parts[j, f], sizeof(Word) flows a
// thread.  RT > 0: R == RT, every load issued before the ORs; RT == 0:
// any R, eight loads in flight at a time.
template <typename Word, int RT>
__global__ void shard_any_kernel(const uint8_t* __restrict__ parts, int R,
                                 int F, uint8_t* __restrict__ allow) {
  constexpr int V = sizeof(Word);
  const int nvec = F / V;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < nvec) {
    const Word* src = reinterpret_cast<const Word*>(parts) + i;
    Word acc{};
    if (RT > 0) {
      Word v[RT > 0 ? RT : 1];
#pragma unroll
      for (int j = 0; j < RT; ++j) v[j] = __ldg(src + static_cast<size_t>(j) * nvec);
#pragma unroll
      for (int j = 0; j < RT; ++j) acc = or_words(acc, v[j]);
    } else {
#pragma unroll 8
      for (int j = 0; j < R; ++j) acc = or_words(acc, __ldg(src + static_cast<size_t>(j) * nvec));
    }
    reinterpret_cast<Word*>(allow)[i] = acc;
  }
  const int f = nvec * V + i;  // the scalar tail
  if (V > 1 && f < F) {
    uint8_t a = 0;
    for (int j = 0; j < R; ++j) a |= parts[static_cast<size_t>(j) * F + f];
    allow[f] = a;
  }
}

// Attributed form, V = 4 flows a thread (a 4-byte allow word and an int4
// of rules a shard) or V = 1.
template <int V, int RT>
__global__ void shard_attr_kernel(const uint8_t* __restrict__ parts,
                                  const int32_t* __restrict__ rule_parts,
                                  const int32_t* __restrict__ offsets, int R,
                                  int F, uint8_t* __restrict__ allow,
                                  int32_t* __restrict__ rule) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (V == 4) {
    const int nvec = F / 4;
    if (i < nvec) {
      const uint32_t* a_src = reinterpret_cast<const uint32_t*>(parts) + i;
      const int4* r_src = reinterpret_cast<const int4*>(rule_parts) + i;
      uint32_t a = 0;
      int4 c = make_int4(kNoMatch, kNoMatch, kNoMatch, kNoMatch);
      const int n = RT > 0 ? RT : R;
#pragma unroll 8
      for (int j = 0; j < n; ++j) {
        const size_t at = static_cast<size_t>(j) * nvec;
        const uint32_t aj = __ldg(a_src + at);
        const int4 rj = __ldg(r_src + at);
        const int32_t off = __ldg(offsets + j);
        a |= aj;
        c.x = min(c.x, shard_cand(rj.x, off));
        c.y = min(c.y, shard_cand(rj.y, off));
        c.z = min(c.z, shard_cand(rj.z, off));
        c.w = min(c.w, shard_cand(rj.w, off));
      }
      reinterpret_cast<uint32_t*>(allow)[i] = a;
      reinterpret_cast<int4*>(rule)[i] = make_int4(
          a & 0xff ? c.x : -1, a & 0xff00 ? c.y : -1,
          a & 0xff0000 ? c.z : -1, a & 0xff000000u ? c.w : -1);
    }
  }
  const int f = (V == 4 ? (F / 4) * 4 : 0) + i;  // V == 1, or the tail
  if (f < F) {
    uint8_t a = 0;
    int32_t c = kNoMatch;
    const int n = RT > 0 ? RT : R;
#pragma unroll 8
    for (int j = 0; j < n; ++j) {
      const size_t at = static_cast<size_t>(j) * F + f;
      a |= parts[at];
      c = min(c, shard_cand(rule_parts[at], __ldg(offsets + j)));
    }
    allow[f] = a;
    rule[f] = a ? c : -1;
  }
}

constexpr uint64_t kLow7 = 0x7f7f7f7f7f7f7f7full;
constexpr uint64_t kHigh = 0x8080808080808080ull;

// 0x80 in each nonzero byte of x, 0 elsewhere.
__device__ __forceinline__ uint64_t nonzero_bytes(uint64_t x) {
  return (((x & kLow7) + kLow7) | x) & kHigh;
}

// 0x80 in byte t for every active topic t < tc (T = 8).
__device__ __forceinline__ uint64_t active_topics(int32_t tc) {
  return tc >= 8 ? kHigh : tc <= 0 ? 0 : kHigh >> (64 - 8 * tc);
}

// The verdict byte of one flow at T = 8 from its shards' ORed simple byte
// and cover word.
__device__ __forceinline__ uint32_t combine8(uint32_t simple, uint64_t cover,
                                             int32_t tc, uint32_t overflow) {
  const uint64_t act = active_topics(tc);
  const bool covered = tc > 0 && (nonzero_bytes(cover) & act) == act;
  return ((simple != 0) | covered) & (overflow == 0);
}

template <int RT>
__global__ void combine_flow_kernel(const uint8_t* __restrict__ simple,
                                    const uint64_t* __restrict__ cover,
                                    const int32_t* __restrict__ topic_count,
                                    const uint8_t* __restrict__ overflow, int R,
                                    int F, uint8_t* __restrict__ allow) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= F) return;
  const int n = RT > 0 ? RT : R;
  uint32_t s = 0;
  uint64_t c = 0;
#pragma unroll 8
  for (int j = 0; j < n; ++j) {
    const size_t at = static_cast<size_t>(j) * F + f;
    s |= __ldg(simple + at);
    c |= __ldg(reinterpret_cast<const unsigned long long*>(cover) + at);
  }
  allow[f] = combine8(s, c, __ldg(topic_count + f), __ldg(overflow + f));
}

template <int RT>
__global__ void combine_general_kernel(const uint8_t* __restrict__ simple,
                                       const uint8_t* __restrict__ cover,
                                       const int32_t* __restrict__ topic_count,
                                       const uint8_t* __restrict__ overflow, int R,
                                       int F, int T, uint8_t* __restrict__ allow) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= F) return;
  const int n = RT > 0 ? RT : R;
  const int32_t tc = __ldg(topic_count + f);
  const uint32_t ov = __ldg(overflow + f);
  uint32_t s = 0;
#pragma unroll 8
  for (int j = 0; j < n; ++j) s |= __ldg(simple + static_cast<size_t>(j) * F + f);
  bool covered = tc > 0;
  for (int t = 0; t < T; ++t) {
    uint32_t c = 0;
#pragma unroll 8
    for (int j = 0; j < n; ++j) c |= __ldg(cover + (static_cast<size_t>(j) * F + f) * T + t);
    covered &= c != 0 || t >= tc;
  }
  allow[f] = ((s != 0) | covered) & (ov == 0);
}

constexpr int kReduceThreads = 128;

unsigned grid_for(int n, int threads = kReduceThreads) {
  return static_cast<unsigned>((std::max(n, 1) + threads - 1) / threads);
}

template <typename Word, int RT>
void launch_any(const uint8_t* parts, int R, int F, uint8_t* allow,
                cudaStream_t stream) {
  constexpr int V = sizeof(Word);
  const int threads = std::max(F / V, V > 1 ? F % V : 0);
  shard_any_kernel<Word, RT><<<grid_for(threads), kReduceThreads, 0, stream>>>(
      parts, R, F, allow);
}

template <int V, int RT>
void launch_attr(const uint8_t* parts, const int32_t* rule_parts,
                 const int32_t* offsets, int R, int F, uint8_t* allow,
                 int32_t* rule, cudaStream_t stream) {
  const int threads = V == 4 ? std::max(F / 4, F % 4) : F;
  shard_attr_kernel<V, RT><<<grid_for(threads), kReduceThreads, 0, stream>>>(
      parts, rule_parts, offsets, R, F, allow, rule);
}

// Dispatch on R: 1..8 as a template argument, any other R at run time.
template <template <int> class Launch, typename... Args>
void by_r(int R, Args... args) {
  switch (R) {
    case 1: Launch<1>::run(args...); break;
    case 2: Launch<2>::run(args...); break;
    case 3: Launch<3>::run(args...); break;
    case 4: Launch<4>::run(args...); break;
    case 5: Launch<5>::run(args...); break;
    case 6: Launch<6>::run(args...); break;
    case 7: Launch<7>::run(args...); break;
    case 8: Launch<8>::run(args...); break;
    default: Launch<0>::run(args...); break;
  }
}

template <typename Word>
struct AnyLaunch {
  template <int RT>
  struct At {
    static void run(const uint8_t* parts, int R, int F, uint8_t* allow,
                    cudaStream_t stream) {
      launch_any<Word, RT>(parts, R, F, allow, stream);
    }
  };
};

template <int V>
struct AttrLaunch {
  template <int RT>
  struct At {
    static void run(const uint8_t* parts, const int32_t* rule_parts,
                    const int32_t* offsets, int R, int F, uint8_t* allow,
                    int32_t* rule, cudaStream_t stream) {
      launch_attr<V, RT>(parts, rule_parts, offsets, R, F, allow, rule, stream);
    }
  };
};

bool aligned(const void* p, int n) { return reinterpret_cast<uintptr_t>(p) % n == 0; }

enum CombinePath { kCombinePick = 0, kCombineFlow = 1, kCombineGeneral = 2 };
constexpr int kCombineThreads = 128;

struct CombineArgs {
  const uint8_t* simple;
  const uint8_t* cover;
  const int32_t* tc;
  const uint8_t* ov;
  int R, F, T;
  uint8_t* allow;
  cudaStream_t stream;
};

bool flow_ok(const CombineArgs& a) { return a.T == 8 && aligned(a.cover, 8); }

// flow wherever it is allowed: general read 1.07-1.59x its time at R = 1
// to 8, F = 65,536 on an H100 (chip_apply_variants.py).
int combine_pick(const CombineArgs& a) { return flow_ok(a) ? kCombineFlow : kCombineGeneral; }

template <int RT>
struct CombineLaunch {
  static void run(const CombineArgs& a, int path) {
    if (path == kCombineFlow) {
      combine_flow_kernel<RT><<<grid_for(a.F, kCombineThreads), kCombineThreads, 0, a.stream>>>(
          a.simple, reinterpret_cast<const uint64_t*>(a.cover), a.tc, a.ov, a.R, a.F, a.allow);
    } else {
      combine_general_kernel<RT><<<grid_for(a.F, kCombineThreads), kCombineThreads, 0, a.stream>>>(
          a.simple, a.cover, a.tc, a.ov, a.R, a.F, a.T, a.allow);
    }
  }
};

int launch_combine(const bool* simple_parts, const bool* cover_parts, const int32_t* topic_count,
                   const bool* overflow, int R, int F, int T, bool* allow, int path, void* stream) {
  if (R < 1 || F < 0 || T < 0 || path < kCombinePick || path > kCombineGeneral) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const CombineArgs a{reinterpret_cast<const uint8_t*>(simple_parts),
                      reinterpret_cast<const uint8_t*>(cover_parts), topic_count,
                      reinterpret_cast<const uint8_t*>(overflow), R, F, T,
                      reinterpret_cast<uint8_t*>(allow), static_cast<cudaStream_t>(stream)};
  if (path == kCombineFlow && !flow_ok(a)) return static_cast<int>(cudaErrorInvalidValue);
  if (F > 0) by_r<CombineLaunch>(R, a, path == kCombinePick ? combine_pick(a) : path);
  return static_cast<int>(cudaGetLastError());
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
    const auto* parts = reinterpret_cast<const uint8_t*>(allow_parts);
    auto* out = reinterpret_cast<uint8_t*>(allow);
    const auto st = static_cast<cudaStream_t>(stream);
    if (rule_parts == nullptr) {
      if (F % 16 == 0 && aligned(parts, 16) && aligned(out, 16)) {
        by_r<AnyLaunch<uint4>::At>(R, parts, R, F, out, st);
      } else if (F % 4 == 0 && aligned(parts, 4) && aligned(out, 4)) {
        by_r<AnyLaunch<uint32_t>::At>(R, parts, R, F, out, st);
      } else {
        by_r<AnyLaunch<uint8_t>::At>(R, parts, R, F, out, st);
      }
    } else if (F % 4 == 0 && aligned(parts, 4) && aligned(out, 4) &&
               aligned(rule_parts, 16) && aligned(rule, 16)) {
      by_r<AttrLaunch<4>::At>(R, parts, rule_parts, offsets, R, F, out, rule, st);
    } else {
      by_r<AttrLaunch<1>::At>(R, parts, rule_parts, offsets, R, F, out, rule, st);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

CILIUM_EXPORT int kafka_shard_combine(const bool* simple_parts,
                                      const bool* cover_parts,
                                      const int32_t* topic_count,
                                      const bool* overflow, int R, int F, int T,
                                      bool* allow, void* stream) {
  return launch_combine(simple_parts, cover_parts, topic_count, overflow, R, F, T, allow,
                        kCombinePick, stream);
}

// kafka_shard_combine on a forced path (1 flow, 2 general; 0 the pick);
// flow where the inputs do not allow it returns cudaErrorInvalidValue.
CILIUM_EXPORT int kafka_shard_combine_forced(const bool* simple_parts,
                                             const bool* cover_parts,
                                             const int32_t* topic_count,
                                             const bool* overflow, int R, int F,
                                             int T, bool* allow, int path,
                                             void* stream) {
  return launch_combine(simple_parts, cover_parts, topic_count, overflow, R, F, T, allow, path,
                        stream);
}

// The path kafka_shard_combine takes for cover_parts [R, F, T].
CILIUM_EXPORT int kafka_combine_variant(const bool* cover_parts, int T) {
  CombineArgs a{};
  a.cover = reinterpret_cast<const uint8_t*>(cover_parts);
  a.T = T;
  return combine_pick(a);
}
