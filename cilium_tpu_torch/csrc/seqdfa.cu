// K18 seqdfa: long-frame DFA search by chunk folding, in two launchers.
//
// Replaces cilium_tpu/ops/seqdfa.py:137 (seqdfa_search_batch): _fold_chunk
// (:68), _compose (:113) and _apply_start_accept (:121).  The TPU version
// carried each chunk's state map as an [S, S] one-hot int8 matrix, built
// one per byte by one-hot matmuls and composed by matmul.  A state map
// is a function, so here it is the target of each start state.
//
// seqdfa_fold writes maps[f, r, k, s0] (uint8: the host keeps S <= 128),
// the state pattern r reaches from s0 over chunk k's active bytes
// (positions below lengths[f]; the rest are the identity).
//
// Bound on the H100: operations, one table step per active (flow,
// pattern, byte); the bytes are the active data read once and the maps
// [F, R, K, S] written once.  Stepping every start state through every
// byte, as the first version did, costs S times that bound.  The design
// avoids it with three facts:
//   * A DFA step is a function: two start states that reach one state go
//     on together.  Each (flow, pattern, segment) group walks all S start
//     states over the segment's first `probe` bytes only, merges the
//     states that coincide and walks just the distinct ones (at most
//     kDmax, held as one packed word: the fast branch) over the rest.
//     A group still holding more than kDmax distinct states (data that
//     keeps the states apart, such as a counter on one byte) takes the
//     slow branch in the same launch: one thread a live start state.
//   * A sink (a state that self-loops on every class: an absorbing
//     accept, a dead state) maps to itself: it is never walked, and a walk
//     that reaches one stops (checked every 16 bytes).
//   * Segments (`seg` bytes, longer on larger batches: the host picks)
//     are short, so a long chunk is many independent walks; a block
//     composes its segment maps into chunk maps in order, across passes
//     where a chunk is longer than one pass.
// A block holds one flow, a tile of patterns and either whole chunks (one
// pass) or one chunk (passes of at most kMaxSegs segments).  It stages
// the bytes as class ids in shared memory, each byte classified once, in
// rows of an odd number of 16-byte units, so lanes on different segments
// read one 16-byte word of 16 classes each without a bank conflict; and
// the pattern tile's delta table transposed to [rt, C, sp] with
// sp % 8 == 4 (an odd number of words a row), so lanes of one pattern on
// one class read within one row and lanes on different classes mostly
// fall on different banks.  The walk items of a pass (fast groups'
// distinct states, slow groups' live start states) are laid out in group
// order by a block scan and drained by all threads together.
//
// seqdfa_apply composes the maps from start[r] (s = maps[f, r, k, s] for
// k in chunk order) and writes accept_final[r, s] for each (f, r) pair.
// Bound on the H100: bytes, K of a pair's K * S map bytes, start and
// accept_final.  A walk that loads maps[f, r, k, s] from global memory
// (one thread a pair, the first design) makes K dependent L2 round trips
// a pair, ~0.17 us each: latency, not bandwidth, sets its time once K
// passes a handful.  No design reaches that bound: a step needs one byte
// of a row only the step before names, so a pair's walk reads all K * S
// bytes (staged) or a 32-byte sector a step (the walk).  Paths (ApplyPath;
// seqdfa_apply_variant reports the launcher's pick, seqdfa_apply_forced
// forces any):
//   * walk, the pick below kApplyStageMinK chunks, where one or a few
//     round trips cost less than staging;
//   * staged, the pick from kApplyStageMinK chunks: a block of P pairs
//     copies the aligned 16-byte words that hold each pair's K * S bytes
//     into shared memory (its loads in flight together, clipped a byte at
//     a time only in blocks whose words pass the ends of the whole maps
//     tensor, so views at any offset work), then one thread a pair walks
//     its K steps there (~30 cycles a step).  Each pair gets a region of
//     an odd number of 16-byte words, so walkers of neighbouring pairs in
//     one state fall on different banks (the maps' own stride, 1,216 bytes
//     at S = 19 and K = 64, would put 16 of a warp's walkers on one bank).
//     Chunks past kApplyStageBytes a pair are staged in tiles of kt.
// The thresholds come from chip_apply_variants.py's sweep: P at four
// blocks an SM, and staging from K = 8 (at K = 1 it read 1.3-1.4x the
// walk's time).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxStates = 128;
constexpr int kMaxGroups = kThreads;  // one thread classifies each group
constexpr int kMaxSegs = 32;          // segments staged in one pass
constexpr int kDmax = 4;              // distinct states a fast group walks
constexpr int kTableBudget = 16 * 1024;
constexpr uint32_t kFinal = 0x80;     // marks a map entry that is final

struct FoldPlan {
  int W, R, S, C, K;
  int lc;          // chunk bytes
  int seg;         // segment bytes (a multiple of 16, at most lc)
  int spc;         // segments a chunk
  int probe;       // bytes every start state walks before the merge
  int multi;       // 1: a block folds cpb whole chunks in one pass
  int cpb;         // chunks a block
  int pass_bytes;  // bytes a pass (multi: cpb * lc)
  int rt;          // patterns a block
  int sp;          // table row stride, >= S, sp % 8 == 4
  int cstr;        // class row stride of a segment, an odd number of 16s
  int n_kb, n_rt;  // blocks along the chunks and the patterns
  int vec;         // rows and segments 16-byte aligned: stage 16 at a time
  int o_tab, o_sink, o_cls, o_tp, o_run, o_fin, o_rep, o_items, o_slow,
      o_seglen, o_misc;
};

// s stepped over the classes cls[j0, j1) of one segment (cls is 16-byte
// aligned); returns early at a sink.
__device__ __forceinline__ int walk(const uint8_t* cls, int j0, int j1,
                                    const uint8_t* tab, const uint8_t* sink,
                                    int sp, int s) {
  int j = j0;
  for (; j < j1 && (j & 15); ++j) s = tab[cls[j] * sp + s];
  for (; j + 16 <= j1; j += 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(cls + j);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int b = 0; b < 4; ++b) s = tab[((w[i] >> (8 * b)) & 0xff) * sp + s];
    }
    if (sink[s]) return s;
  }
  for (; j < j1; ++j) s = tab[cls[j] * sp + s];
  return s;
}

__device__ __forceinline__ uint32_t classify4(const uint8_t* cmap, uint32_t w) {
  return cmap[w & 0xff] | (cmap[(w >> 8) & 0xff] << 8) |
         (cmap[(w >> 16) & 0xff] << 16) | (cmap[w >> 24] << 24);
}

// Exclusive scan of v over the block; *total gets the sum.  Every thread
// calls it.
__device__ uint32_t block_scan(uint32_t v, uint32_t* warp_sum, uint32_t* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  uint32_t x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t n = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += n;
  }
  if (lane == 31) warp_sum[w] = x;
  __syncthreads();
  if (w == 0) {
    uint32_t y = lane < kThreads / 32 ? warp_sum[lane] : 0;
#pragma unroll
    for (int o = 1; o < kThreads / 32; o <<= 1) {
      const uint32_t n = __shfl_up_sync(0xffffffffu, y, o);
      if (lane >= o) y += n;
    }
    if (lane < kThreads / 32) warp_sum[lane] = y;
  }
  __syncthreads();
  *total = warp_sum[kThreads / 32 - 1];
  return x - v + (w > 0 ? warp_sum[w - 1] : 0);
}

__global__ void __launch_bounds__(kThreads)
    seqdfa_fold_kernel(const uint8_t* __restrict__ data,
                       const int32_t* __restrict__ lengths,
                       const uint8_t* __restrict__ classmap,
                       const uint8_t* __restrict__ delta, const FoldPlan p,
                       uint8_t* __restrict__ maps,
                       unsigned long long* __restrict__ debug) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* cmap = smem;
  uint8_t* tab = smem + p.o_tab;      // [rt, C, sp]
  uint8_t* sink = smem + p.o_sink;    // [rt, sp]
  uint8_t* cls = smem + p.o_cls;      // [segments, cstr]
  uint8_t* tp = smem + p.o_tp;        // [groups, sp] probe states, then maps
  uint8_t* run = smem + p.o_run;      // [rt, sp] a chunk's map so far
  uint8_t* fin = smem + p.o_fin;      // [groups, kDmax] fast groups' targets
  uint32_t* rep = reinterpret_cast<uint32_t*>(smem + p.o_rep);  // [groups]
  uint16_t* items = reinterpret_cast<uint16_t*>(smem + p.o_items);
  uint8_t* slow = smem + p.o_slow;    // slow groups, in order
  int32_t* seglen = reinterpret_cast<int32_t*>(smem + p.o_seglen);
  uint32_t* misc = reinterpret_cast<uint32_t*>(smem + p.o_misc);
  uint32_t* warp_sum = misc;          // [kThreads / 32]
  uint32_t* counts = misc + kThreads / 32;  // groups, chains, slow groups

  const int tid = threadIdx.x;
  const int S = p.S, C = p.C, sp = p.sp;
  const int blk = blockIdx.x / p.n_rt;
  const int rti = blockIdx.x % p.n_rt;
  const int kb = blk % p.n_kb;
  const int f = blk / p.n_kb;
  const int r0 = rti * p.rt, nr = min(p.rt, p.R - r0);
  const int k0 = kb * p.cpb, nk = min(p.cpb, p.K - k0);
  const int base = k0 * p.lc, span = nk * p.lc;
  const int len = min(max(lengths[f], 0), p.W);
  const int active = min(max(len - base, 0), span);
  uint8_t* out = maps + (static_cast<size_t>(f) * p.R + r0) * p.K * S +
                 static_cast<size_t>(k0) * S;
  // Thread t serves start state t % S in the loops over (item, s0).
  const int s_mine = tid % S, per = kThreads / S, q_mine = tid / S;

  if (active == 0) {  // nothing active: identity maps
    for (int q = q_mine; q < nr * nk && q_mine < per; q += per) {
      const int rr = q / nk, kk = q - rr * nk;
      out[(static_cast<size_t>(rr) * p.K + kk) * S + s_mine] = s_mine;
    }
    return;
  }

  if (tid < 64) {
    reinterpret_cast<uint32_t*>(cmap)[tid] =
        reinterpret_cast<const uint32_t*>(classmap)[tid];
  }
  if (tid < 3) counts[tid] = 0;
  // The tile's table, transposed, and its sinks: one thread a (pattern, state).
  for (int i = tid; i < nr * S; i += kThreads) {
    const int rr = i / S, s = i - rr * S;
    const uint8_t* src = delta + (static_cast<size_t>(r0) * S + i) * C;
    uint8_t* dst = tab + rr * C * sp + s;
    bool sk = true;
#pragma unroll 4
    for (int c = 0; c < C; ++c) {
      const uint8_t v = src[c];
      dst[c * sp] = v;
      sk &= v == s;
    }
    sink[rr * sp + s] = sk;
  }
  __syncthreads();

  const uint8_t* row = data + static_cast<size_t>(f) * p.W + base;
  for (int pb0 = 0; pb0 < active; pb0 += p.pass_bytes) {
    const int nb = min(p.pass_bytes, span - pb0);
    const int nact = min(nb, active - pb0);
    // A piece is a whole chunk (multi) or the pass's part of one chunk.
    const int plen = p.multi ? p.lc : nb;
    const int spp = p.multi ? p.spc : (nb + p.seg - 1) / p.seg;
    const int npieces = p.multi ? nk : 1;
    const int full = nact / plen;
    const int n_act = full * spp + (nact - full * plen + p.seg - 1) / p.seg;
    const int G = nr * n_act;  // groups: g = rr * n_act + m

    for (int m = tid; m < n_act; m += kThreads) {
      const int pi = m / spp, mi = m - pi * spp;
      const int st = pi * plen + mi * p.seg;
      seglen[m] = min(min(p.seg, plen - mi * p.seg), nact - st);
    }
    if (p.vec) {
      for (int q = tid * 16; q < nact; q += kThreads * 16) {
        const uint4 v = *reinterpret_cast<const uint4*>(row + pb0 + q);
        const int pi = q / plen, rem = q - pi * plen;
        const int mi = rem / p.seg, j = rem - mi * p.seg;
        uint4 o;
        o.x = classify4(cmap, v.x);
        o.y = classify4(cmap, v.y);
        o.z = classify4(cmap, v.z);
        o.w = classify4(cmap, v.w);
        *reinterpret_cast<uint4*>(cls + (pi * spp + mi) * p.cstr + j) = o;
      }
    } else {
      for (int q = tid; q < nact; q += kThreads) {
        const int pi = q / plen, rem = q - pi * plen;
        const int mi = rem / p.seg, j = rem - mi * p.seg;
        cls[(pi * spp + mi) * p.cstr + j] = cmap[row[pb0 + q]];
      }
    }
    __syncthreads();

    // 1. Probe: every start state over the segment's first bytes.  An
    // entry is final (kFinal) at a sink or where the probe ends the segment.
    // Two groups a round, both probed before either is stored.
    if (q_mine < per) {
      const auto probe = [&](int rr, int m) -> uint32_t {
        const uint8_t* sk = sink + rr * sp;
        const int sl = seglen[m];
        int s = s_mine;
        if (!sk[s]) {
          s = walk(cls + m * p.cstr, 0, min(p.probe, sl), tab + rr * C * sp, sk, sp, s);
        }
        return s | (sk[s] || sl <= p.probe ? kFinal : 0);
      };
      const int dr = per / n_act, dm = per - dr * n_act;
      int rr = q_mine / n_act, m = q_mine - rr * n_act;
      for (int g = q_mine; g < G; g += 2 * per) {
        int rr2 = rr + dr, m2 = m + dm;
        if (m2 >= n_act) m2 -= n_act, ++rr2;
        const bool two = g + per < G;
        const uint32_t a = probe(rr, m);
        const uint32_t b = two ? probe(rr2, m2) : 0;
        tp[g * sp + s_mine] = a;
        if (two) tp[(g + per) * sp + s_mine] = b;
        rr = rr2 + dr, m = m2 + dm;
        if (m >= n_act) m -= n_act, ++rr;
      }
    }
    __syncthreads();

    // 2. Merge: group tid's distinct live states, up to kDmax of them
    // packed in one word; more make the group slow.
    uint32_t reps = 0xffffffffu;
    int d_n = 0, live = 0;
    if (tid < G) {
      const uint32_t* e = reinterpret_cast<const uint32_t*>(tp + tid * sp);
      for (int w = 0; w < (S + 3) / 4; ++w) {
        const uint32_t word = e[w];
        for (int b = 0; b < 4 && 4 * w + b < S; ++b) {
          const uint32_t v = (word >> (8 * b)) & 0xff;
          if (v & kFinal) continue;
          ++live;
          if (d_n <= kDmax && !__vcmpeq4(reps, v * 0x01010101u)) {
            if (d_n < kDmax) reps = (reps & ~(0xffu << (8 * d_n))) | (v << (8 * d_n));
            ++d_n;
          }
        }
      }
    }
    const bool is_slow = d_n > kDmax;
    uint32_t total;
    const uint32_t off = block_scan(
        tid < G ? (is_slow ? 1u << 16 : static_cast<uint32_t>(d_n)) : 0u,
        warp_sum, &total);
    if (tid < G) {
      rep[tid] = is_slow ? 0xffffffffu : reps;
      if (is_slow) {
        slow[off >> 16] = static_cast<uint8_t>(tid);
      } else {
        for (int d = 0; d < d_n; ++d) items[(off & 0xffff) + d] = tid | (d << 8);
      }
      if (debug != nullptr) {
        atomicAdd(&counts[0], 1u);
        atomicAdd(&counts[1], static_cast<uint32_t>(is_slow ? live : d_n));
        if (is_slow) atomicAdd(&counts[2], 1u);
      }
    }
    __syncthreads();

    // 3. Walk the rest of each segment: fast groups' distinct states, then
    // slow groups' live start states, in group order.
    const int n_fast = total & 0xffff, n_slow = total >> 16;
    for (int i = tid; i < n_fast + n_slow * S; i += kThreads) {
      int g, s;
      uint8_t* dst;
      if (i < n_fast) {
        const uint32_t it = items[i];
        g = it & 0xff;
        const int d = it >> 8;
        s = (rep[g] >> (8 * d)) & 0xff;
        dst = fin + g * kDmax + d;
      } else {
        const int j = i - n_fast, js = j / S;
        g = slow[js];
        dst = tp + g * sp + (j - js * S);
        const uint32_t v = *dst;
        if (v & kFinal) continue;
        s = v;
      }
      const int rr = g / n_act, m = g - rr * n_act;
      s = walk(cls + m * p.cstr, p.probe, seglen[m], tab + rr * C * sp,
               sink + rr * sp, sp, s);
      *dst = s | kFinal;
    }
    __syncthreads();

    // 4. Compose the pass's segment maps into the chunk maps, in order: a
    // block of whole chunks writes them out, a chunk in passes keeps its
    // map so far in run.
    if (q_mine < per) {
      for (int q = q_mine; q < nr * npieces; q += per) {
        const int rr = q / npieces, pi = q - rr * npieces;
        uint8_t* rp = run + rr * sp + s_mine;
        int s = pb0 == 0 ? s_mine : *rp;
        const int m_end = min((pi + 1) * spp, n_act);
        for (int m = pi * spp; m < m_end; ++m) {
          const int g = rr * n_act + m;
          uint32_t v = tp[g * sp + s];
          if (!(v & kFinal)) {
            const uint32_t hit = __vcmpeq4(rep[g], v * 0x01010101u);
            v = fin[g * kDmax + (__ffs(hit) - 1) / 8];
          }
          s = v & 0x7f;
        }
        if (p.multi) {
          out[(static_cast<size_t>(rr) * p.K + pi) * S + s_mine] = s;
        } else {
          *rp = s;
        }
      }
    }
    // The next pass writes tp only after its staging barrier.
  }
  if (!p.multi) {
    __syncthreads();
    for (int rr = q_mine; rr < nr && q_mine < per; rr += per) {
      out[static_cast<size_t>(rr) * p.K * S + s_mine] = run[rr * sp + s_mine];
    }
  }
  if (debug != nullptr && tid == 0) {
    atomicAdd(&debug[0], static_cast<unsigned long long>(counts[0]));
    atomicAdd(&debug[1], static_cast<unsigned long long>(counts[1]));
    atomicAdd(&debug[2], static_cast<unsigned long long>(counts[2]));
  }
}

__global__ void seqdfa_apply_walk_kernel(const uint8_t* __restrict__ maps,
                                         const uint8_t* __restrict__ start,
                                         const bool* __restrict__ accept_final,
                                         int F, int R, int S, int K,
                                         bool* __restrict__ out) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(F) * R) return;
  const int r = static_cast<int>(idx % R);
  const uint8_t* m = maps + idx * K * S;
  int s = start[r];
  for (int k = 0; k < K; ++k) s = m[k * S + s];
  out[idx] = accept_final[r * S + s];
}

constexpr int kApplyThreads = 128;
constexpr int kApplyStageBytes = 24576;  // bytes a block stages at once, at most
constexpr int kApplyMinBlocks = 528;     // four blocks an SM of an H100 (132 SMs)
constexpr int kApplyStageMinK = 8;       // the launcher stages from this many chunks
constexpr int kApplyUnroll = 4;          // 16-byte loads a thread issues before storing

enum ApplyPath { kApplyPick = 0, kApplyWalk = 1, kApplyStaged = 2 };

struct ApplyPlan {
  int S, K, R;
  long long n;    // pairs, F * R
  int path;
  int P;          // pairs a block
  int kt;         // chunks a tile
  int words;      // 16-byte words a pair's region holds (odd)
  uint32_t wmagic;  // ceil(2^32 / words): i / words = umulhi(i, wmagic) for i < 2^16
  size_t smem;
};

int region_words(int bytes) { return ((bytes + 15) / 16 + 1) | 1; }

void set_pairs(ApplyPlan& p, int P) {
  p.P = P;
  p.smem = static_cast<size_t>(16) * p.words * P;
}

// The plan for F x R pairs of K maps of S states on `path` (kApplyPick:
// the launcher's choice).  P is the most pairs the block's threads and
// kApplyStageBytes hold, cut so that the grid keeps kApplyMinBlocks
// blocks where the batch has them.
ApplyPlan apply_plan(int F, int R, int S, int K, int path) {
  ApplyPlan p{};
  p.S = S, p.K = K, p.R = R;
  p.n = static_cast<long long>(F) * R;
  p.path = path == kApplyPick ? (K >= kApplyStageMinK ? kApplyStaged : kApplyWalk) : path;
  p.P = 1;
  if (p.path == kApplyWalk) return p;
  p.kt = std::max(1, std::min(K, (kApplyStageBytes - 48) / S));
  p.words = region_words(p.kt * S);
  p.wmagic = static_cast<uint32_t>((0x100000000ULL + p.words - 1) / p.words);
  const int most = std::max(1, std::min(kApplyThreads, kApplyStageBytes / (16 * p.words)));
  const long long even = (p.n + kApplyMinBlocks - 1) / kApplyMinBlocks;
  set_pairs(p, static_cast<int>(std::max(1LL, std::min<long long>(most, even))));
  return p;
}

// The 16-byte word at w (16-byte aligned) for bytes inside [lo, hi) only,
// zeros elsewhere: whole where it lies inside, else a byte at a time.
__device__ __forceinline__ uint4 load_clipped(uintptr_t w, uintptr_t lo, uintptr_t hi) {
  if (w >= lo && w + 16 <= hi) return __ldg(reinterpret_cast<const uint4*>(w));
  uint32_t v[4] = {0, 0, 0, 0};
  for (int j = 0; j < 16; ++j) {
    const uintptr_t a = w + j;
    if (a >= lo && a < hi) v[j / 4] |= static_cast<uint32_t>(*reinterpret_cast<const uint8_t*>(a)) << (8 * (j % 4));
  }
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// Staged path: block b holds pairs [b P, b P + P), its tiles of kt chunks
// one after another.
__global__ void __launch_bounds__(kApplyThreads)
    seqdfa_apply_staged_kernel(const uint8_t* __restrict__ maps,
                               const uint8_t* __restrict__ start,
                               const bool* __restrict__ accept_final,
                               const ApplyPlan p, bool* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, S = p.S;
  const long long q0 = static_cast<long long>(blockIdx.x) * p.P;
  const int np = static_cast<int>(min(static_cast<long long>(p.P), p.n - q0));
  const int pb = p.K * S;  // a pair's bytes (the launcher keeps P * pb below 2^31)
  const uintptr_t lo = reinterpret_cast<uintptr_t>(maps);
  const uintptr_t hi = lo + static_cast<size_t>(p.n) * pb;
  const uintptr_t blk = lo + static_cast<size_t>(q0) * pb;  // the block's first pair
  const int blk_lo = static_cast<int>(blk & 15);
  // Every word the block loads lies in the aligned words that span its
  // pairs' bytes [blk, blk + np pb).  Those pass the tensor's ends only
  // where the span's first word starts before lo or its last ends past
  // hi: such a block clips its words, the others load them whole.
  const bool edge = (blk & ~static_cast<uintptr_t>(15)) < lo ||
                    ((blk + static_cast<size_t>(np) * pb + 15) & ~static_cast<uintptr_t>(15)) > hi;
  const bool walker = tid < np;
  const long long q = q0 + tid;
  const int r = walker ? static_cast<int>(q % p.R) : 0;
  int s = walker ? start[r] : 0;
  const int n_words = np * p.words;

  // Stage, into each pair's region, the aligned words that hold its
  // `nbytes` bytes of the tile at chunk k0: region word i is the i-th
  // aligned word from the one that holds the pair's first byte of the
  // tile.  Offsets are from blk, in 32 bits.
  const auto stage = [&](int k0, int nbytes) {
    for (int base = tid; base < n_words; base += kApplyThreads * kApplyUnroll) {
      uint4 v[kApplyUnroll];
      int at[kApplyUnroll];
#pragma unroll
      for (int u = 0; u < kApplyUnroll; ++u) {
        const int idx = base + u * kApplyThreads;
        at[u] = -1;
        if (idx < n_words) {
          const int pp = __umulhi(static_cast<uint32_t>(idx), p.wmagic);
          const int i = idx - pp * p.words;
          const int off = pp * pb + k0 * S;  // the pair's first byte of the tile
          const int wr = ((blk_lo + off) & ~15) - blk_lo + 16 * i;
          if (wr < off + nbytes) {
            const uintptr_t w = blk + wr;
            v[u] = edge ? load_clipped(w, lo, hi) : __ldg(reinterpret_cast<const uint4*>(w));
            at[u] = 16 * idx;  // pp * 16 * words + 16 * i
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kApplyUnroll; ++u) {
        if (at[u] >= 0) *reinterpret_cast<uint4*>(smem + at[u]) = v[u];
      }
    }
  };

  for (int k0 = 0; k0 < p.K; k0 += p.kt) {
    const int kn = min(p.kt, p.K - k0);
    const uint8_t* reg = smem + 16 * p.words * tid + ((blk_lo + tid * pb + k0 * S) & 15);
    stage(k0, kn * S);
    __syncthreads();
    if (walker) {
#pragma unroll 4
      for (int k = 0; k < kn; ++k) s = reg[k * S + s];
    }
    __syncthreads();  // the next tile overwrites the regions
  }
  if (walker) out[q] = accept_final[r * S + s];
}

int apply_code(const ApplyPlan& p) {
  return p.path | p.P << 3 | (p.path == kApplyWalk ? 0 : p.kt) << 11;
}

// Launches `p` (from apply_plan) on F x R pairs of K maps of S states.
int run_apply(const ApplyPlan& p, const void* maps, const void* start, const void* accept_final,
              int F, void* out, void* stream) {
  if (p.n <= 0) return cudaSuccess;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* m = static_cast<const uint8_t*>(maps);
  const auto* s0 = static_cast<const uint8_t*>(start);
  const auto* acc = static_cast<const bool*>(accept_final);
  auto* o = static_cast<bool*>(out);
  if (p.path == kApplyWalk) {
    const long long blocks = (p.n + kThreads - 1) / kThreads;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    seqdfa_apply_walk_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        m, s0, acc, F, p.R, p.S, p.K, o);
    return cudaGetLastError();
  }
  const long long blocks = (p.n + p.P - 1) / p.P;
  if (p.P < 1 || p.P > kApplyThreads || p.smem > 227 * 1024 || blocks > 0x7fffffffLL ||
      static_cast<long long>(p.P) * p.K * p.S >= 0x7fffff00LL) {
    return cudaErrorInvalidValue;
  }
  const cudaError_t err = allow_smem(seqdfa_apply_staged_kernel, p.smem);
  if (err != cudaSuccess) return err;
  seqdfa_apply_staged_kernel<<<static_cast<unsigned>(blocks), kApplyThreads, p.smem, st>>>(
      m, s0, acc, p, o);
  return cudaGetLastError();
}

bool apply_args_ok(int F, int R, int S, int K, int path) {
  return K >= 1 && S >= 1 && S <= kMaxStates && F >= 0 && R >= 0 && path >= kApplyPick &&
         path <= kApplyStaged;
}

int launch_apply(const void* maps, const void* start, const void* accept_final,
                 int F, int R, int S, int K, void* out, int path, void* stream) {
  if (!apply_args_ok(F, R, S, K, path)) return cudaErrorInvalidValue;
  return run_apply(apply_plan(F, R, S, K, path), maps, start, accept_final, F, out, stream);
}

int align16(int n) { return (n + 15) & ~15; }

}  // namespace

// seg: segment bytes (a multiple of 16); probe: bytes every start state
// walks before the merge; debug: null, or three uint64 counters the
// launch adds to (groups, chains walked past the probe, slow groups).
CILIUM_EXPORT int seqdfa_fold(const void* data, const void* lengths,
                              const void* classmap, const void* delta, int F,
                              int W, int R, int S, int C, int K, int seg,
                              int probe, void* maps, void* debug,
                              void* stream) {
  if (K < 1 || W < 0 || W % K != 0 || S < 1 || S > kMaxStates || C < 1 ||
      C > 256 || seg < 16 || seg % 16 != 0 || probe < 0 || F < 0 || R < 0) {
    return cudaErrorInvalidValue;
  }
  const long long total = static_cast<long long>(F) * R * K * S;
  if (total <= 0) return cudaSuccess;
  FoldPlan p{};
  p.W = W, p.R = R, p.S = S, p.C = C, p.K = K;
  p.lc = W / K;
  p.seg = std::min(seg, std::max(p.lc, 1));
  p.spc = p.lc > 0 ? (p.lc + p.seg - 1) / p.seg : 1;
  p.probe = probe;
  p.sp = S + (12 - S % 8) % 8;
  p.rt = std::max(1, std::min({R, kMaxGroups, kTableBudget / (C * p.sp)}));
  const int nseg = std::min(kMaxSegs, kMaxGroups / p.rt);
  p.multi = p.spc <= nseg;
  p.cpb = p.multi ? std::min(K, nseg / p.spc) : 1;
  p.pass_bytes = p.multi ? p.cpb * p.lc : nseg * p.seg;
  p.n_kb = (K + p.cpb - 1) / p.cpb;
  p.n_rt = (R + p.rt - 1) / p.rt;
  int units = (p.seg + 15) / 16;
  if (units % 2 == 0) ++units;
  p.cstr = 16 * units;
  p.vec = reinterpret_cast<uintptr_t>(data) % 16 == 0 && p.lc % 16 == 0;
  const int groups = p.rt * nseg;
  int o = 256;
  p.o_tab = o, o += align16(p.rt * C * p.sp);
  p.o_sink = o, o += align16(p.rt * p.sp);
  p.o_cls = o, o += nseg * p.cstr;
  p.o_tp = o, o += align16(groups * p.sp);
  p.o_run = o, o += align16(p.rt * p.sp);
  p.o_fin = o, o += align16(groups * kDmax);
  p.o_rep = o, o += align16(groups * 4);
  p.o_items = o, o += align16(groups * kDmax * 2);
  p.o_slow = o, o += align16(groups);
  p.o_seglen = o, o += align16(nseg * 4);
  p.o_misc = o, o += 64;
  const size_t smem = static_cast<size_t>(o);
  const long long blocks = static_cast<long long>(F) * p.n_kb * p.n_rt;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(seqdfa_fold_kernel, smem);
  if (err != cudaSuccess) return err;
  seqdfa_fold_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<const int32_t*>(lengths),
      static_cast<const uint8_t*>(classmap),
      static_cast<const uint8_t*>(delta), p, static_cast<uint8_t*>(maps),
      static_cast<unsigned long long*>(debug));
  return cudaGetLastError();
}

CILIUM_EXPORT int seqdfa_apply(const void* maps, const void* start,
                               const void* accept_final, int F, int R, int S,
                               int K, void* out, void* stream) {
  return launch_apply(maps, start, accept_final, F, R, S, K, out, kApplyPick, stream);
}

// seqdfa_apply on a forced path (1 walk, 2 staged; 0 the pick).
CILIUM_EXPORT int seqdfa_apply_forced(const void* maps, const void* start,
                                      const void* accept_final, int F, int R,
                                      int S, int K, void* out, int path,
                                      void* stream) {
  return launch_apply(maps, start, accept_final, F, R, S, K, out, path, stream);
}

// What seqdfa_apply launches for F x R pairs of K maps of S states:
// path | pairs a block << 3 | chunks a tile << 11 (0 on the walk).
CILIUM_EXPORT int seqdfa_apply_variant(int F, int R, int S, int K) {
  return apply_code(apply_plan(F, R, S, K, kApplyPick));
}
