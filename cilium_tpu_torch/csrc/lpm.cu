// K12 lpm_lookup: longest-prefix match of F addresses (W = 1 or 4 words)
// against N prefixes.
//
// Replaces cilium_tpu/ops/lpm.py:109 (lpm_lookup) and :161
// (prefilter_check_batch), which built a dense [F, N] masked compare and
// took the winner with gather-free max-reduces (TPU gathers serialize).
//
// Design: L lanes an address probe the hashed index the table carries
// (ops/l34_index.py lpm_index, built when the table is made): the
// prefixes are grouped by mask tuple, the groups ranked by their best
// score (plen + 1), and a group is one exact probe of (group, address &
// masks).  Each block stages the group list in shared memory once (a row a
// thread; groups past kStage are read from the list in global memory), so
// a round costs the dependent bucket-bounds load and the slot load alone.
// Lane l of an address takes groups l, l + L, l + 2L, ... best first, G a
// round: a round issues the bounds of its G groups, then their G first
// slots, and tests none before all are issued; a lane stops once the best
// score it found beats its next group's best (no later group of its can
// change the answer: its rows score at most its best), and the lanes then
// merge their (score, value) with shuffles.  A miss probes every group.
// Bound on the H100: bytes, 4 * W * F in, 9 * F out and the index read
// once.
//
// A table of few rows and many groups is cheaper to walk than to probe
// (prefilter6's 256 prefixes in 91 groups): the walk, one thread an
// address, reads every row once, warp-uniform through the read-only path,
// where a probe costs a hash and two dependent loads a group.  Each block
// picks its path from N and the group count it staged, the same in every
// block of a launch: the walk where N < kWalkRowsPerGroup * groups.  L, G
// and the thresholds come from the sweep of chip_hits_variants.py
// (--kernels lpm_lookup), which forces each (L, G) probe and the walk
// (forced_<L>x<G>, forced_walk).
#include "l34_index.cuh"

struct LpmArgs {
  l34::LpmTab t;
  const int32_t* addr[4];
  int32_t f;
  bool* found;
  int32_t* value;
  int32_t* plen;
  l34x::LpmIx ix;  // after the parent's fields
};

namespace lpmk {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kStage = l34::kThreads;  // group rows a block stages, one a thread
constexpr int kUnroll = 8;             // rows whose word-0 test is loaded at once (the walk)

// The launcher's lanes an address and groups a round, by W, and where it
// walks instead.  The sweep on an H100 (F = 65,536): more groups a round
// bought nothing (1x2 to 1x8 within 10%, 1x16 1.5-2x slower), two lanes an
// address took 20% off prefilter's 25 groups (2x2 11.1 us against 1x2
// 13.9) and nothing off the ipcaches' one or two (where four or eight
// lanes lose), and the walk won below about 8 rows a group at W = 1 and
// 11-12 at W = 4 (spreading it over lanes made it slower).
template <int W> struct Pick;
template <> struct Pick<1> {
  static constexpr int kLanes = 2, kGroups = 2, kWalkRowsPerGroup = 8;
};
template <> struct Pick<4> {
  static constexpr int kLanes = 1, kGroups = 2, kWalkRowsPerGroup = 12;
};

enum Path { kPick = 0, kProbe = 1, kWalk = 2 };

// The staged group list: each group's best score and masks.
template <int W>
struct Groups {
  int32_t best[kStage];
  int32_t mask[W][kStage];
};

// Row g of the group list (n + 2 rows, zero past the last group): from
// shared memory below kStage, else from global memory.
template <int W>
__device__ __forceinline__ int32_t group_best(const Groups<W>& gs, const LpmArgs& a, int g) {
  if (g < kStage) return gs.best[g];
  return g < a.t.n + 2 ? __ldg(a.ix.groups + static_cast<size_t>(g) * 8) : 0;
}

// The probe key of group g: (g, address & masks).
template <int W>
__device__ __forceinline__ void group_key(const Groups<W>& gs, const LpmArgs& a, int g,
                                          const int32_t (&addr)[W], int32_t (&q)[W + 1]) {
  q[0] = g;
#pragma unroll
  for (int w = 0; w < W; ++w)
    q[1 + w] = addr[w] & (g < kStage ? gs.mask[w][g]
                                     : __ldg(a.ix.groups + static_cast<size_t>(g) * 8 + 1 + w));
}

__device__ __forceinline__ void take(int32_t sc, int32_t v, int32_t& best, int32_t& val) {
  if (sc > best) {
    best = sc;
    val = v;
  } else if (sc == best) {
    val = max(val, v);
  }
}

// ops/lpm.py lpm_lookup through the index for lane `lane` of L: its
// groups, G a round.
template <int W, int L, int G>
__device__ __forceinline__ void probe(const LpmArgs& a, const Groups<W>& gs, int lane,
                                      const int32_t (&addr)[W], int32_t& best, int32_t& val) {
  constexpr int S = l34x::slot_words(W + 3);  // group, W words, score, value
  const l34x::HashIx& ix = a.ix.h;
  for (int gi = lane;; gi += G * L) {
    int32_t gb[G];
#pragma unroll
    for (int j = 0; j < G; ++j) gb[j] = group_best(gs, a, gi + j * L);
    if (gb[0] <= 0 || best > gb[0]) break;
    l34x::Probe<S> p[G];
#pragma unroll
    for (int j = 0; j < G; ++j) {
      if (gb[j] <= 0) continue;  // past the last group
      int32_t q[W + 1];
      group_key(gs, a, gi + j * L, addr, q);
      l34x::start<W + 1, S>(ix, q, p[j]);
    }
#pragma unroll
    for (int j = 0; j < G; ++j)
      if (gb[j] > 0) l34x::first(ix, p[j]);
#pragma unroll
    for (int j = 0; j < G; ++j) {
      if (gb[j] <= 0 || best > gb[j]) continue;
      int32_t q[W + 1];
      group_key(gs, a, gi + j * L, addr, q);
      l34x::visit<W + 1, S>(ix, p[j], q,
                            [&](const int32_t (&s)[S]) { take(s[W + 1], s[W + 2], best, val); });
    }
    if (gb[G - 1] <= 0) break;  // the group list ends
  }
}

// ops/lpm.py lpm_lookup by a walk of every row: word 0 of kUnroll rows
// loaded before any is tested, a row's other words read only where word 0
// matched.
template <int W>
__device__ __forceinline__ void walk(const l34::LpmTab& t, const int32_t (&a)[W], int32_t& best,
                                     int32_t& val) {
  const int n = t.n;
  for (int r0 = 0; r0 < n; r0 += kUnroll) {
    bool hit0[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = r0 + u;
      hit0[u] = r < n && (a[0] & l34::ld(t.masks + r)) == l34::ld(t.words + r);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!hit0[u]) continue;
      const int r = r0 + u;
      bool m = l34::ldb(t.valid + r);
#pragma unroll
      for (int w = 1; w < W; ++w)
        m = m && ((a[w] & l34::ld(t.masks + w * n + r)) == l34::ld(t.words + w * n + r));
      if (m) take(l34::add32(l34::ld(t.plen + r), 1), l34::ld(t.values + r), best, val);
    }
  }
}

// One launch: L lanes an address and G groups a round on the probe, one
// on the walk; kPath picks the path (kPick: from N and the groups).
template <int W, int L, int G, int kPath>
__global__ void __launch_bounds__(l34::kThreads) lpm_kernel(const LpmArgs a) {
  static_assert(kStage == l34::kThreads, "a block stages one group row a thread");
  __shared__ Groups<W> gs;
  const int i = threadIdx.x;
  int32_t gbest = 0, m[4] = {0, 0, 0, 0};
  if (kPath != kWalk && i < a.t.n + 2) {
    const int4* row = reinterpret_cast<const int4*>(a.ix.groups) + 2 * i;
    const int4 lo = __ldg(row);  // best, masks 0..2
    gbest = lo.x;
    m[0] = lo.y;
    if (W > 1) {
      m[1] = lo.z;
      m[2] = lo.w;
      m[3] = __ldg(row + 1).x;
    }
  }
  gs.best[i] = gbest;
#pragma unroll
  for (int w = 0; w < W; ++w) gs.mask[w][i] = m[w];
  const int staged = __syncthreads_count(gbest > 0);  // groups staged (every group below kStage)
  const bool walks =
      kPath == kWalk || (kPath == kPick && a.t.n < Pick<W>::kWalkRowsPerGroup * staged);
  // a lane group lies in one warp, and every lane of a warp reaches the
  // shuffles
  const int lanes = walks ? 1 : L;
  const int lane = i % lanes;
  const int f = blockIdx.x * (l34::kThreads / lanes) + i / lanes;
  const bool live = f < a.f;
  int32_t addr[W];
#pragma unroll
  for (int w = 0; w < W; ++w) addr[w] = live ? a.addr[w][f] : 0;
  int32_t best = 0, val = INT_MIN;
  if (live) {
    if (walks) {
      walk<W>(a.t, addr, best, val);
    } else {
      probe<W, L, G>(a, gs, lane, addr, best, val);
    }
  }
  for (int off = lanes / 2; off > 0; off /= 2) {
    const int32_t ob = __shfl_xor_sync(kFull, best, off);
    const int32_t ov = __shfl_xor_sync(kFull, val, off);
    take(ob, ov, best, val);
  }
  if (!live || lane != 0) return;
  const bool found = best > 0;
  a.found[f] = found;
  a.value[f] = found ? val : 0;
  a.plen[f] = found ? best - 1 : -1;
}

// A launch at one W.  A block holds kThreads / lanes addresses of the path
// its table takes; the grid covers F at the probe's L lanes unless the
// walk is forced (blocks past F store nothing).
template <int W, int L, int G, int kPath>
int launch_w(const LpmArgs& a, cudaStream_t s) {
  static_assert(32 % L == 0, "a lane group lies in one warp");
  constexpr int per_block = l34::kThreads / (kPath == kWalk ? 1 : L);
  lpm_kernel<W, L, G, kPath><<<(a.f + per_block - 1) / per_block, l34::kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

// L1 lanes and G1 groups a round at W = 1, L4 and G4 at W = 4.
template <int L1, int G1, int L4, int G4, int kPath>
int launch(const LpmArgs* args, void* stream) {
  const LpmArgs a = *args;
  if (a.f <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (a.t.w == 1 && l34x::usable<1>(a.ix)) return launch_w<1, L1, G1, kPath>(a, s);
  if (a.t.w == 4 && l34x::usable<4>(a.ix)) return launch_w<4, L4, G4, kPath>(a, s);
  return cudaErrorInvalidValue;
}

template <int W>
constexpr int pick_code(int n, int groups) {
  return n < Pick<W>::kWalkRowsPerGroup * (groups < kStage ? groups : kStage)
             ? 1 << 8
             : Pick<W>::kLanes << 8 | Pick<W>::kGroups;
}

}  // namespace lpmk

// What the launcher takes for a table of n rows in `groups` mask groups at
// W = w words (kernels.lpm_variant): lanes << 8 | groups a round; one
// lane and groups 0 for the walk.
CILIUM_EXPORT int lpm_variant(int w, int n, int groups) {
  return w == 1 ? lpmk::pick_code<1>(n, groups) : lpmk::pick_code<4>(n, groups);
}

CILIUM_EXPORT int lpm_lookup(const LpmArgs* args, void* stream) {
  using lpmk::Pick;
  return lpmk::launch<Pick<1>::kLanes, Pick<1>::kGroups, Pick<4>::kLanes, Pick<4>::kGroups,
                      lpmk::kPick>(args, stream);
}
