// K3 nfa_scan: union-NFA state-set search over each flow's span.
//
// Replaces cilium_tpu/ops/nfa.py:92 (_nfa_scan, behind nfa_search_spans
// :155 and nfa_search_batch :168), the fallback automaton when a pattern's
// DFA exceeds the 128-state guard.  The TPU version multiplied the [F, S]
// state set by a [S, C*S] matrix per byte (O(S^2*C) MACs) and then picked
// each flow's class with a one-hot reduce, because gathers serialize there.
//
// Bound on the H100: the bytes (span bytes, [F, R] output) and a state
// word per byte; the work a byte needs is one lookup per live state that
// has an edge on the byte's class.  The relation is very sparse (the nfa
// shape of chip_smoke.py: 1,216 edges in 6,080 (class, state) rows, about
// 10 live states a byte), so the first version, which ORed a dense W-word
// row from global memory (delta_bits, 243 KB there) for every live state,
// spent nearly every load on zeros.
//
// Design (the form is chosen from the shape, in nfa_scan below):
// - Up to 64 states (W <= 2: the r2d2 and DNS rule shards of the mesh)
//   the dense rows delta_bits are staged in shared memory and a live state
//   costs W loads (kDenseRows).
// - Past that, the near rows (ops/nfa.py near_rows, built at upload): a
//   (class, state) row's targets in the state's word and the next, one
//   8-byte load a live state, and a W-word mask a class of the states with
//   a target anywhere else, which walk their sparse row (ops/nfa.py
//   sparse_rows: count, first target, the offset of the rest in a 16-bit
//   target list) from global memory.  The edges of a concatenation run
//   forward by a few states, so at the nfa shape no state is far, and the
//   near rows take 48 KB (kNearRows).
// - Where the near rows do not fit, the sparse rows and a has-mask a
//   class are read from global memory through L1 (kSparseRows).
//   Measured, dense rows past W = 2 and near rows up to it ran slower.
// - One thread a flow keeps the state set in W registers of 32 bits (a W
//   template, W <= 32), never indexed by a variable (no local memory):
//   the state words are walked with their index a constant, so the near
//   rows' two words land in registers J and J + 1, and a sparse row's
//   target in the source's word or the next costs one compare, any other
//   W.
// - Blocks are persistent and stride over the flows; bytes come 16 at a
//   time where rows are 16-byte aligned, as in K2, with the step once in
//   the code.
// - Past 32 words (a block of more than 1,024 states that no cut in
//   ops/nfa.py split_parts divides: one long bounded repetition, such
//   as a{256}b{256}), up to 128 words (4,096 states, the reference's
//   MAX_STATES), a warp a flow (kWide, nfa_wide_kernel below): lane l
//   keeps words l, l + 32, l + 64, l + 96 of the state and seen sets in
//   registers, walks the sparse rows of its live states from global
//   memory and ORs their targets into the warp's next-state words in
//   shared memory with atomicOr; after __syncwarp each lane takes its
//   own words back and clears them.  The warp stops when __any_sync
//   finds no live state, and the span's bytes come 32 at a time, one a
//   lane, passed round by shuffle.  Correct first, not tuned: a chain
//   of n states keeps about one state live a byte, so a step is a few
//   loads and two warp barriers.
// At the nfa shape a step inlined 16 times over ran slower than the first
// version, and a factored form (next = follow(state) & enter[class],
// follow by byte-wide table lookups; that table is homogeneous) slower
// than the sparse walk: neither was kept.
// Sticky accept needs no per-step test: a pattern accepts at some step iff
// a state of its accept set was ever live, so the kernel ORs every state
// set into `seen` and tests seen & accept[r] once at the end, and only in
// the words where the union of all patterns' sets meets it.
//
// Semantics (cilium_tpu/ops/nfa.py:92-151): as the DFA scan; the empty set
// stays empty; the result is any(seen & accept[r]) | any(state &
// accept_final[r]).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxWords = 32;  // S <= 1024; ops/nfa.py MAX_STATES
constexpr size_t kSmemBudget = 200 * 1024;
constexpr int kDenseWords = 2;  // the dense rows' variant up to 64 states
constexpr int kWideWords = 128;  // S <= 4096: the wide form (a warp a flow)
constexpr int kWideLane = kWideWords / 32;  // state words a lane keeps
constexpr int kWideWarps = 8;  // flows a block of the wide form

// Which form of the relation a variant walks (chosen from the shape in
// nfa_scan below).
enum Form { kDenseRows, kNearRows, kSparseRows };

struct Tables {
  const int2* rows;       // sparse rows, [C * S]: global memory
  const uint32_t* has;    // [C, W]
  const uint16_t* tgt;
  const uint32_t* dense;  // delta_bits, [C, S, W]
  const int2* near;       // [C * S]: a row's targets in words J and J + 1
  const uint32_t* far;    // [C, W]: states with a target elsewhere
  const uint8_t* cmap;
  int S, words;
};

// Set bit t of the next-state registers of a source in word J: a target
// in word J or J + 1 (the common case: the edges of a concatenation run
// forward by a few states) costs one compare; any other takes W.
template <int W, int J>
__device__ __forceinline__ void set_bit(uint32_t (&nxt)[W], int t) {
  const uint32_t m = 1u << (t & 31);
  const int tw = t >> 5;
  if (tw == J) {
    nxt[J] |= m;
  } else if (J + 1 < W && tw == J + 1) {
    nxt[J + 1 < W ? J + 1 : J] |= m;
  } else {
#pragma unroll
    for (int k = 0; k < W; ++k)
      if (k == tw) nxt[k] |= m;
  }
}

template <int W, int J>
__device__ __forceinline__ void walk_word(const Tables& tb, const int2* crow,
                                          uint32_t bits, uint32_t (&nxt)[W]) {
  while (bits) {
    const int b = __ffs(bits) - 1;
    bits &= bits - 1;
    const int2 rw = crow[J * 32 + b];
    const int n = rw.y & 0xFFFF;
    // one call site keeps the code small
    for (int k = 0, t = rw.y >> 16;;) {
      set_bit<W, J>(nxt, t);
      if (++k >= n) break;
      t = tb.tgt[rw.x + k];
    }
  }
}

// walk_word for J = 0 .. W - 1, with J a constant in each.
template <int W, int J = 0>
__device__ __forceinline__ void walk_words(const Tables& tb, const int2* crow,
                                           const uint32_t* chas,
                                           const uint32_t (&state)[W],
                                           uint32_t (&nxt)[W]) {
  if constexpr (J < W) {
    uint32_t bits = state[J];
    if (bits) bits &= chas[J];
    walk_word<W, J>(tb, crow, bits, nxt);
    walk_words<W, J + 1>(tb, crow, chas, state, nxt);
  }
}

// The near rows for J = 0 .. W - 1: a live state ORs its targets in words
// J and J + 1 with one 8-byte load; one with a target elsewhere (far)
// also walks its sparse row.
template <int W, int J = 0>
__device__ __forceinline__ void near_words(const Tables& tb, const int2* cnear,
                                           const uint32_t* cfar, const int2* crow,
                                           const uint32_t (&state)[W],
                                           uint32_t (&nxt)[W]) {
  if constexpr (J < W) {
    const uint32_t live = state[J];
    if (live) {
      for (uint32_t bits = live; bits; bits &= bits - 1) {
        const int2 nr = cnear[J * 32 + __ffs(bits) - 1];
        nxt[J] |= static_cast<uint32_t>(nr.x);
        if constexpr (J + 1 < W) nxt[J + 1] |= static_cast<uint32_t>(nr.y);
      }
      const uint32_t far = live & cfar[J];
      if (far) walk_word<W, J>(tb, crow, far, nxt);
    }
    near_words<W, J + 1>(tb, cnear, cfar, crow, state, nxt);
  }
}

// One byte: state <- delta(state, class(byte)); seen |= state.  Returns
// false once the set is empty (it stays empty).
template <int W, int kForm>
__device__ __forceinline__ bool nfa_step(const Tables& tb, uint32_t byte,
                                         uint32_t (&state)[W],
                                         uint32_t (&seen)[W]) {
  const int c = tb.cmap[byte];
  uint32_t nxt[W];
#pragma unroll
  for (int j = 0; j < W; ++j) nxt[j] = 0u;
  if constexpr (kForm == kDenseRows) {
    // a live state's dense row: `words` words
    const uint32_t* crow = tb.dense + c * tb.S * tb.words;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      uint32_t bits = state[j];
      while (bits) {
        const uint32_t* row = crow + (j * 32 + __ffs(bits) - 1) * tb.words;
        bits &= bits - 1;
#pragma unroll
        for (int k = 0; k < W; ++k)
          if (k < tb.words) nxt[k] |= row[k];
      }
    }
  } else if constexpr (kForm == kNearRows) {
    near_words<W>(tb, tb.near + c * tb.S, tb.far + c * tb.words, tb.rows + c * tb.S, state,
                  nxt);
  } else {
    walk_words<W>(tb, tb.rows + c * tb.S, tb.has + c * tb.words, state, nxt);
  }
  uint32_t live = 0u;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    state[j] = nxt[j];
    seen[j] |= nxt[j];
    live |= nxt[j];
  }
  return live != 0u;
}

template <int W, int kForm, bool kVec>
__global__ void __launch_bounds__(kThreads)
nfa_scan_kernel(const uint8_t* __restrict__ data,
                const int32_t* __restrict__ span_start,
                const int32_t* __restrict__ span_end,
                const uint8_t* __restrict__ classmap,
                const uint32_t* __restrict__ dense,
                const int2* __restrict__ near,
                const uint32_t* __restrict__ far,
                const int2* __restrict__ rows,
                const uint16_t* __restrict__ targets,
                const uint32_t* __restrict__ has,
                const uint32_t* __restrict__ start,
                const uint32_t* __restrict__ accept,
                const uint32_t* __restrict__ accept_final,
                const uint32_t* __restrict__ any, int F, int L, int R, int S,
                int C, int words, bool* __restrict__ out) {
  __shared__ uint8_t s_cmap[256];
  __shared__ uint32_t s_any[2 * kMaxWords];
  extern __shared__ int2 smem[];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) s_cmap[i] = classmap[i];
  for (int i = threadIdx.x; i < 2 * words; i += blockDim.x)
    s_any[i] = any[i];
  Tables tb{rows, has, targets, dense, near, far, s_cmap, S, words};
  if (kForm == kDenseRows) {
    uint32_t* s_dense = reinterpret_cast<uint32_t*>(smem);
    for (int i = threadIdx.x; i < C * S * words; i += blockDim.x) s_dense[i] = dense[i];
    tb.dense = s_dense;
  } else if (kForm == kNearRows) {
    int2* s_near = smem;
    uint32_t* s_far = reinterpret_cast<uint32_t*>(s_near + C * S);
    for (int i = threadIdx.x; i < C * S; i += blockDim.x) s_near[i] = near[i];
    for (int i = threadIdx.x; i < C * words; i += blockDim.x) s_far[i] = far[i];
    tb.near = s_near;
    tb.far = s_far;
  }
  __syncthreads();

  for (int f = blockIdx.x * blockDim.x + threadIdx.x; f < F;
       f += gridDim.x * blockDim.x) {
    uint32_t state[W], seen[W];
#pragma unroll
    for (int j = 0; j < W; ++j) {
      state[j] = j < words ? start[j] : 0u;
      seen[j] = state[j];
    }
    const uint8_t* rowp = data + static_cast<size_t>(f) * L;
    const int t0 = max(span_start[f], 0);
    const int t1 = min(span_end[f], L);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    for (int t = t0; t < t1; ++t) {
      uint32_t byte;
      if (kVec) {
        // the 16 bytes around t lie in the row: L is a multiple of 16
        if (t == t0 || (t & 15) == 0) v = __ldg(reinterpret_cast<const uint4*>(rowp + (t & ~15)));
        const int b = t & 15;
        const uint32_t w = b < 8 ? (b < 4 ? v.x : v.y) : (b < 12 ? v.z : v.w);
        byte = (w >> ((b & 3) << 3)) & 0xFFu;
      } else {
        byte = __ldg(rowp + t);
      }
      if (!nfa_step<W, kForm>(tb, byte, state, seen)) break;
    }

    // Only words where some pattern's accept meets `seen`, or some
    // accept_final meets `state`, can decide a pattern.
    uint32_t hit[W];
    uint32_t any_hit = 0u;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      hit[j] = j < words ? (seen[j] & s_any[j]) | (state[j] & s_any[words + j]) : 0u;
      any_hit |= hit[j];
    }
    bool* dst = out + static_cast<size_t>(f) * R;
    for (int r = 0; r < R; ++r) {
      uint32_t a = 0u;
      if (any_hit) {
        const uint32_t* acc = accept + static_cast<size_t>(r) * words;
        const uint32_t* fin = accept_final + static_cast<size_t>(r) * words;
#pragma unroll
        for (int j = 0; j < W; ++j)
          if (hit[j]) a |= (seen[j] & __ldg(acc + j)) | (state[j] & __ldg(fin + j));
      }
      dst[r] = a != 0u;
    }
  }
}

template <int W, int kForm, bool kVec>
cudaError_t launch(const void* data, const void* span_start,
                   const void* span_end, const void* classmap,
                   const void* dense, const void* near, const void* far,
                   const void* rows, const void* targets, const void* has,
                   const void* start, const void* accept,
                   const void* accept_final, const void* any, int F, int L,
                   int R, int S, int C, int words, size_t smem, void* out,
                   cudaStream_t stream) {
  auto kernel = nfa_scan_kernel<W, kForm, kVec>;
  int resident = 0;
  cudaError_t err = resident_blocks(kernel, kThreads, smem, &resident);
  if (err != cudaSuccess) return err;
  // Persistent blocks: enough to fill the card once.
  const int blocks = std::min((F + kThreads - 1) / kThreads, resident);
  kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(data), static_cast<const int32_t*>(span_start),
      static_cast<const int32_t*>(span_end), static_cast<const uint8_t*>(classmap),
      static_cast<const uint32_t*>(dense), static_cast<const int2*>(near),
      static_cast<const uint32_t*>(far), static_cast<const int2*>(rows),
      static_cast<const uint16_t*>(targets), static_cast<const uint32_t*>(has),
      static_cast<const uint32_t*>(start), static_cast<const uint32_t*>(accept),
      static_cast<const uint32_t*>(accept_final), static_cast<const uint32_t*>(any), F, L,
      R, S, C, words, static_cast<bool*>(out));
  return cudaGetLastError();
}

// The wide form: a warp a flow, for 33 to 128 words.  Lane l owns words
// l + 32 k (k < kWideLane) of `state` and `seen`; the warp's next-state
// words live in shared memory (s_next), each zero between steps.
__global__ void __launch_bounds__(kWideWarps * 32)
nfa_wide_kernel(const uint8_t* __restrict__ data,
                const int32_t* __restrict__ span_start,
                const int32_t* __restrict__ span_end,
                const uint8_t* __restrict__ classmap,
                const int2* __restrict__ rows,
                const uint16_t* __restrict__ targets,
                const uint32_t* __restrict__ has,
                const uint32_t* __restrict__ start,
                const uint32_t* __restrict__ accept,
                const uint32_t* __restrict__ accept_final,
                const uint32_t* __restrict__ any, int F, int L, int R, int S,
                int words, bool* __restrict__ out) {
  __shared__ uint8_t s_cmap[256];
  __shared__ uint32_t s_next[kWideWarps][kWideWords];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < 256; i += blockDim.x) s_cmap[i] = classmap[i];
  uint32_t* nxt = s_next[warp];
#pragma unroll
  for (int k = 0; k < kWideLane; ++k) nxt[lane + 32 * k] = 0u;
  // the union of the accept sets in the lane's words
  uint32_t any_acc[kWideLane], any_fin[kWideLane];
#pragma unroll
  for (int k = 0; k < kWideLane; ++k) {
    const int j = lane + 32 * k;
    any_acc[k] = j < words ? any[j] : 0u;
    any_fin[k] = j < words ? any[words + j] : 0u;
  }
  __syncthreads();

  const unsigned full = 0xFFFFFFFFu;
  for (int f = blockIdx.x * kWideWarps + warp; f < F; f += gridDim.x * kWideWarps) {
    uint32_t state[kWideLane], seen[kWideLane];
#pragma unroll
    for (int k = 0; k < kWideLane; ++k) {
      const int j = lane + 32 * k;
      state[k] = j < words ? start[j] : 0u;
      seen[k] = state[k];
    }
    const uint8_t* rowp = data + static_cast<size_t>(f) * L;
    const int t0 = max(span_start[f], 0);
    const int t1 = min(span_end[f], L);
    uint32_t chunk = 0u;
    for (int t = t0; t < t1; ++t) {
      const int b = (t - t0) & 31;
      if (b == 0) chunk = t + lane < t1 ? __ldg(rowp + t + lane) : 0u;
      const int c = s_cmap[__shfl_sync(full, chunk, b)];
      const int2* crow = rows + static_cast<size_t>(c) * S;
      const uint32_t* chas = has + static_cast<size_t>(c) * words;
#pragma unroll
      for (int k = 0; k < kWideLane; ++k) {
        const int j = lane + 32 * k;
        uint32_t bits = state[k];
        if (bits) bits &= __ldg(chas + j);
        while (bits) {
          const int2 rw = __ldg(crow + j * 32 + __ffs(bits) - 1);
          bits &= bits - 1;
          const int n = rw.y & 0xFFFF;
          for (int e = 0, tg = rw.y >> 16;;) {
            atomicOr(nxt + (tg >> 5), 1u << (tg & 31));
            if (++e >= n) break;
            tg = __ldg(targets + rw.x + e);
          }
        }
      }
      __syncwarp();
      uint32_t live = 0u;
#pragma unroll
      for (int k = 0; k < kWideLane; ++k) {
        const int j = lane + 32 * k;
        const uint32_t v = nxt[j];
        nxt[j] = 0u;
        state[k] = v;
        seen[k] |= v;
        live |= v;
      }
      __syncwarp();
      if (!__any_sync(full, live != 0u)) break;
    }

    // Only words where some pattern's accept meets `seen`, or some
    // accept_final meets `state`, can decide a pattern.
    uint32_t hit = 0u;
#pragma unroll
    for (int k = 0; k < kWideLane; ++k) hit |= (seen[k] & any_acc[k]) | (state[k] & any_fin[k]);
    const bool any_hit = __any_sync(full, hit != 0u);
    bool* dst = out + static_cast<size_t>(f) * R;
    for (int r = 0; r < R; ++r) {
      uint32_t a = 0u;
      if (any_hit) {
        const uint32_t* acc = accept + static_cast<size_t>(r) * words;
        const uint32_t* fin = accept_final + static_cast<size_t>(r) * words;
#pragma unroll
        for (int k = 0; k < kWideLane; ++k) {
          const int j = lane + 32 * k;
          if (j < words) a |= (seen[k] & __ldg(acc + j)) | (state[k] & __ldg(fin + j));
        }
      }
      const bool v = __any_sync(full, a != 0u);
      if (lane == 0) dst[r] = v;
    }
  }
}

cudaError_t launch_wide(const void* data, const void* span_start, const void* span_end,
                        const void* classmap, const void* rows, const void* targets,
                        const void* has, const void* start, const void* accept,
                        const void* accept_final, const void* any, int F, int L, int R,
                        int S, int words, void* out, cudaStream_t stream) {
  int resident = 0;
  cudaError_t err = resident_blocks(nfa_wide_kernel, kWideWarps * 32, 0, &resident);
  if (err != cudaSuccess) return err;
  const int blocks = std::min((F + kWideWarps - 1) / kWideWarps, resident);
  nfa_wide_kernel<<<blocks, kWideWarps * 32, 0, stream>>>(
      static_cast<const uint8_t*>(data), static_cast<const int32_t*>(span_start),
      static_cast<const int32_t*>(span_end), static_cast<const uint8_t*>(classmap),
      static_cast<const int2*>(rows), static_cast<const uint16_t*>(targets),
      static_cast<const uint32_t*>(has), static_cast<const uint32_t*>(start),
      static_cast<const uint32_t*>(accept), static_cast<const uint32_t*>(accept_final),
      static_cast<const uint32_t*>(any), F, L, R, S, words, static_cast<bool*>(out));
  return cudaGetLastError();
}

}  // namespace

// dense: delta_bits; near, far, rows, targets, has, any: ops/nfa.py
// DeviceNfa.scan_* (near_rows, sparse_rows).
CILIUM_EXPORT int nfa_scan(const void* data, const void* span_start,
                           const void* span_end, const void* classmap,
                           const void* dense, const void* near, const void* far,
                           const void* rows, const void* targets,
                           const void* has, const void* start,
                           const void* accept, const void* accept_final,
                           const void* any, int F, int L, int R, int S, int C,
                           void* out, void* stream) {
  if (F <= 0 || R <= 0) return cudaSuccess;
  const int words = (S + 31) / 32;
  if (S < 1 || words > kWideWords || C < 1 || C > 256) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  // Past one thread's registers, a warp a flow.
  if (words > kMaxWords)
    return launch_wide(data, span_start, span_end, classmap, rows, targets, has, start, accept,
                       accept_final, any, F, L, R, S, words, out, s);
  const bool vec = L % 16 == 0 && reinterpret_cast<uintptr_t>(data) % 16 == 0;
#define CILIUM_NFA_ARGS(smem)                                                     \
  data, span_start, span_end, classmap, dense, near, far, rows, targets, has,     \
      start, accept, accept_final, any, F, L, R, S, C, words, smem, out, s
#define CILIUM_NFA(W, FORM, smem)                                      \
  return vec ? launch<W, FORM, true>(CILIUM_NFA_ARGS(smem))             \
             : launch<W, FORM, false>(CILIUM_NFA_ARGS(smem))
  // Up to kDenseWords words the dense rows, where they fit, cost a live
  // state `words` loads.
  const size_t dense_bytes = static_cast<size_t>(C) * S * words * 4;
  if (words <= kDenseWords && dense_bytes <= kSmemBudget) {
    if (words <= 1) CILIUM_NFA(1, kDenseRows, dense_bytes);
    CILIUM_NFA(2, kDenseRows, dense_bytes);
  }
  // Else the near rows and far masks where they fit, else the sparse rows
  // from global memory.
  const size_t near_bytes = static_cast<size_t>(C) * S * 8 + static_cast<size_t>(C) * words * 4;
#define CILIUM_NFA_W(W)                                                       \
  if (near_bytes <= kSmemBudget) CILIUM_NFA(W, kNearRows, near_bytes);        \
  CILIUM_NFA(W, kSparseRows, 0)
  if (words <= 4) { CILIUM_NFA_W(4); }
  if (words <= 8) { CILIUM_NFA_W(8); }
  if (words <= 12) { CILIUM_NFA_W(12); }
  if (words <= 16) { CILIUM_NFA_W(16); }
  CILIUM_NFA_W(32);
#undef CILIUM_NFA_W
#undef CILIUM_NFA
#undef CILIUM_NFA_ARGS
}
