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
// dotted bytes of the names it compares, the outputs); the work is one
// test a row walked and the name bytes of the rows whose length is the
// span's.  Design (rule_walk.cuh): a group of lanes walks a flow, G * V
// rows a step, each lane's V rx bytes one coalesced load turned into a bit
// mask, and the group's ballot gives the first hit, which is both `allow`
// and `rule`.  The rule tables (name_len and three flags; the needles as
// words, zero past each name's length, up to a shared-memory budget; the
// remote ids up to 128 rows) are staged in shared memory once a block, in
// tiles of rows past the budget: per row its length and flags and its
// needle's words, and per 32 rows a word of bits each for the byte-free
// rows, the automaton's rows and the rows that name each length.  A lane
// takes its V rows' candidates with three word loads and no branch
// (byte-free, the automaton's hit, or a name of the span's length), then
// tests only those, in order.  Where some row names the span's length,
// the group first copies the name into a buffer of its own in shared
// memory, every load of a lane issued together (the row's aligned words
// where rows are 4-byte aligned, a name word then two of them and a
// funnel shift; byte loads otherwise), and a candidate by length compares
// it with its needle word by word; bytes past the staged width (names
// over 4 * ws bytes) are compared from device memory.  The remote set is
// tested only for a row whose name test holds (ids read from device
// memory past 128 rows).
//
// Semantics, per rule r (rx may be absent: the model has no pattern or
// regex row):
//   exact = span_len == name_len[r] and dotted[s, s + min(name_len, W))
//           equals needle[r], with span_len = max(span_end - span_start, 0)
//           (a byte outside [0, L) reads as 0)
//   name  = name_any[r] | (valid & (exact | (use_rx[r] & rx[f, r])))
//   ok    = any_remote[r] | remotes[f] in remote_ids[r, :]
//   allow[f] = any_r (name & ok); rule[f] = the first such r, else -1.
#include "rule_walk.cuh"

namespace {

using walk::Group;
using walk::kThreads;

constexpr unsigned kNameAny = 1u, kUseRx = 2u, kAnyRemote = 4u;
constexpr int kSmemBudget = 48 * 1024;
constexpr int kNameCap = 256;  // needle and span bytes staged a row at most
constexpr int kLenSlots = kNameCap + 1;  // name lengths 0-255, and 256 for any longer
constexpr int kPresentWords = (kLenSlots + 31) / 32;

// The launcher's variant (walk::geometry): lanes while F x G stays within
// 65,536 threads or 16 rows a lane take more than 4 steps
// (chip_hits_variants.py's readings, PERF.md).
inline walk::Geometry geometry(int R, int F) { return walk::geometry(R, F, 65536, 16, 4); }

struct Args {
  const uint8_t* dotted;  // [F, L]
  const bool* valid;
  const int32_t* span_start;
  const int32_t* span_end;
  const bool* rx;  // [F, R] or null
  const int32_t* remotes;
  const uint8_t* needle;  // [R, W]
  const int32_t* name_len;
  const bool* name_any;
  const bool* use_rx;
  const int32_t* remote_ids;  // [R, kMaxRemotes]
  const bool* any_remote;
  int F, L, R, W;
  bool* allow;
  int32_t* rule;
  int width;        // walk::load_width of rx
  bool needle4;     // W and the needle base are multiples of 4
  bool needle16;    // W and the needle base are multiples of 16
  bool row4;        // L and the dotted base are multiples of 4
  bool ids16;       // remote_ids is 16-byte aligned
  bool ids_staged;  // the remote ids lie in shared memory (R <= walk::kIdsRows)
  int ws;           // words of a staged needle and span: min(W, 4 * ws) bytes
  int tile_rows;    // rows staged at once (a multiple of 32)
};

// The tables of a tile of rows in shared memory: per row {name_len, flags}
// and its needle words, and per 32 rows one word each of bits (row i at
// bit i % 32): byte-free rows, automaton rows, and the rows naming each
// length (slot min(len, 256)), so a lane reads its V rows' candidates with
// three word loads.
struct Tables {
  int2* meta;        // [tile]
  unsigned* any;     // [words]
  unsigned* userx;   // [words]
  unsigned* bylen;    // [kLenSlots][words]
  unsigned* present;  // [kPresentWords] bit slot: some row names that length
  unsigned* needle;   // [tile][ws]
  unsigned* spans;    // [kThreads / G][ws + 2]: each group's name, as the row's words
  int words;          // (tile + 31) / 32
};

__device__ __forceinline__ Tables tables_at(const Args& a, int4* smem, int group) {
  const int tile = min(a.R, a.tile_rows);
  Tables t;
  t.words = (tile + 31) / 32;
  t.meta = reinterpret_cast<int2*>(smem + (a.ids_staged ? a.R * (walk::kMaxRemotes / 4) : 0));
  t.any = reinterpret_cast<unsigned*>(t.meta + tile);
  t.userx = t.any + t.words;
  t.bylen = t.userx + t.words;
  t.present = t.bylen + kLenSlots * t.words;
  t.needle = t.present + kPresentWords;
  t.spans = t.needle + tile * a.ws + group * (a.ws + 2);
  return t;
}

// Rows [r0, r0 + n) into t: their {name_len, flags}, their bits, and the
// first min(len, W, 4 ws) needle bytes, zero past them, ws words a row.
__device__ void stage(const Args& a, const Tables& t, int r0, int n) {
  for (int i = threadIdx.x; i < kLenSlots * t.words + kPresentWords; i += blockDim.x) t.bylen[i] = 0;
  __syncthreads();
  for (int base = 0; base < n; base += blockDim.x) {  // whole warps: the ballots
    const int i = base + static_cast<int>(threadIdx.x);
    const bool in = i < n;
    const int r = r0 + (in ? i : 0);
    const bool any = in && walk::flag(a.name_any + r);
    const bool urx = in && walk::flag(a.use_rx + r);
    const int len = in ? __ldg(a.name_len + r) : -1;
    const unsigned any_w = __ballot_sync(walk::kFull, any);
    const unsigned urx_w = __ballot_sync(walk::kFull, urx);
    if (in) {
      const unsigned flags = (any ? kNameAny : 0u) | (urx ? kUseRx : 0u) |
                             (walk::flag(a.any_remote + r) ? kAnyRemote : 0u);
      t.meta[i] = make_int2(len, static_cast<int>(flags));
      if (!any && len >= 0) {
        const int slot = min(len, kNameCap);
        atomicOr(t.bylen + slot * t.words + i / 32, 1u << (i & 31));
        atomicOr(t.present + slot / 32, 1u << (slot & 31));
      }
      if ((threadIdx.x & 31) == 0) {
        t.any[i / 32] = any_w;
        t.userx[i / 32] = urx_w;
      }
    }
  }
  if (a.needle16) {  // 16-byte loads: 4 words a load
    const int wq = a.ws / 4;
#pragma unroll 4
    for (int j = threadIdx.x; j < n * wq; j += blockDim.x) {
      const int i = j / wq, k = 4 * (j - i * wq);
      const int r = r0 + i;
      const int keep = min(__ldg(a.name_len + r), a.W) - 4 * k;  // bytes of these words to keep
      uint4 w = make_uint4(0u, 0u, 0u, 0u);
      if (keep > 0) w = __ldg(reinterpret_cast<const uint4*>(a.needle + static_cast<size_t>(r) * a.W) + k / 4);
      unsigned* dst = t.needle + i * a.ws + k;
      dst[0] = keep >= 4 ? w.x : keep > 0 ? w.x & ((1u << (8 * keep)) - 1u) : 0u;
      dst[1] = keep >= 8 ? w.y : keep > 4 ? w.y & ((1u << (8 * (keep - 4))) - 1u) : 0u;
      dst[2] = keep >= 12 ? w.z : keep > 8 ? w.z & ((1u << (8 * (keep - 8))) - 1u) : 0u;
      dst[3] = keep >= 16 ? w.w : keep > 12 ? w.w & ((1u << (8 * (keep - 12))) - 1u) : 0u;
    }
    return;
  }
#pragma unroll 4
  for (int j = threadIdx.x; j < n * a.ws; j += blockDim.x) {
    const int i = j / a.ws, k = j - i * a.ws;
    const int r = r0 + i;
    const int keep = min(__ldg(a.name_len + r), a.W) - 4 * k;  // bytes of this word to keep
    unsigned w = 0;
    if (keep > 0) {
      const uint8_t* src = a.needle + static_cast<size_t>(r) * a.W + 4 * k;
      if (a.needle4) {
        w = __ldg(reinterpret_cast<const unsigned*>(src));
      } else {
        for (int b = 0; b < 4 && 4 * k + b < a.W; ++b) w |= static_cast<unsigned>(__ldg(src + b)) << (8 * b);
      }
      if (keep < 4) w &= (1u << (8 * keep)) - 1u;
    }
    t.needle[j] = w;
  }
}

// Byte i of the flow's row, 0 outside [0, L).
__device__ __forceinline__ unsigned byte_at(const uint8_t* row, int i, int L) {
  return i >= 0 && i < L ? __ldg(row + i) : 0u;
}

// Word k of the group's copy of the name: the row's aligned words from
// byte s & ~3 on where rows are 4-byte aligned (word k of the name is then
// two of them and a funnel shift), else the name's bytes as words; 0
// outside [0, L) either way.
__device__ __forceinline__ unsigned name_copy_word(const uint8_t* row, int s, int k, int L, bool row4) {
  if (row4) {
    const int at = (s >> 2) + k;  // an aligned word lies wholly inside the row or outside it
    return at >= 0 && 4 * at < L ? __ldg(reinterpret_cast<const unsigned*>(row) + at) : 0u;
  }
  unsigned w = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) w |= byte_at(row, s + 4 * k + b, L) << (8 * b);
  return w;
}

// Word k of the name from the group's copy, 0 past its n bytes.
__device__ __forceinline__ unsigned name_word(const unsigned* copy, int k, int sh, int n) {
  const unsigned w = sh ? __funnelshift_r(copy[k], copy[k + 1], 8 * sh) : copy[k];
  const int keep = n - 4 * k;
  return keep >= 4 ? w : w & ((1u << (8 * keep)) - 1u);
}

// What a lane needs of its flow, and the rx bits of its first step's rows:
// loaded together, before the tables are staged.
struct Flow {
  bool live;  // flows past F ride along: no load, no store
  bool valid;
  int f, s, span_len, remote;
  const uint8_t* rxrow;  // the flow's rx row, null without rx
  unsigned first;        // row_bits of rx at step 0 of tile 0
};

template <int G, int V>
__device__ __forceinline__ Flow load_flow(const Args& a, int t, int q, int n0) {
  Flow fl;
  fl.f = t * (kThreads / G) + static_cast<int>(threadIdx.x) / G;
  fl.live = fl.f < a.F;
  const size_t fi = fl.live ? fl.f : 0;
  fl.rxrow = a.rx ? reinterpret_cast<const uint8_t*>(a.rx) + fi * a.R : nullptr;
  fl.first = fl.live && a.rx ? walk::row_bits<V>(fl.rxrow, q * V, n0, a.width) : 0u;
  fl.valid = fl.live && walk::flag(a.valid + fl.f);
  fl.s = fl.live ? __ldg(a.span_start + fl.f) : 0;
  fl.span_len = fl.live ? max(__ldg(a.span_end + fl.f) - fl.s, 0) : 0;
  fl.remote = fl.live ? __ldg(a.remotes + fl.f) : 0;
  return fl;
}

template <int G, int V>
__global__ void __launch_bounds__(kThreads) dns_hits_kernel(Args a) {
  extern __shared__ int4 smem[];
  int4* s_ids = smem;  // [R, 8] when a.ids_staged
  const Tables t = tables_at(a, smem, threadIdx.x / G);
  const int tile = min(a.R, a.tile_rows);
  const Group<G> g;
  const int rot = threadIdx.x & 7;
  const int tiles = (a.F + kThreads / G - 1) / (kThreads / G);
  const bool one_tile = a.R <= a.tile_rows;
  constexpr unsigned kLaneRows = V >= 32 ? ~0u : (1u << V) - 1u;
  Flow fl = load_flow<G, V>(a, blockIdx.x, g.q, tile);
  if (a.ids_staged) walk::stage_ids(a.remote_ids, s_ids, a.R, a.ids16);
  if (one_tile) stage(a, t, 0, a.R);
  __syncthreads();

  for (int ft = blockIdx.x; ft < tiles; ft += gridDim.x) {
    if (ft != static_cast<int>(blockIdx.x)) fl = load_flow<G, V>(a, ft, g.q, tile);
    const uint8_t* drow = a.dotted + static_cast<size_t>(fl.live ? fl.f : 0) * a.L;
    const int sl = fl.span_len;
    const int slot = min(sl, kNameCap);
    const int n = min(sl, a.W);                 // name bytes an exact row compares
    const int nw = (min(n, 4 * a.ws) + 3) / 4;  // of them in the staged needles, in words
    // The group copies the name's first nw words where a row may name its
    // length, all loads of a lane issued together, before the walk.
    const int sh = a.row4 ? fl.s & 3 : 0;
    const int copy = nw ? nw + (sh != 0) : 0;
    const bool named = fl.valid && (!one_tile || (t.present[slot / 32] >> (slot & 31)) & 1u);
    __syncwarp();  // the group's last flow reads its copy no more
    if (named) {
#pragma unroll 4
      for (int k = g.q; k < copy; k += G) t.spans[k] = name_copy_word(drow, fl.s, k, a.L, a.row4);
    }
    __syncwarp();
    // The name's first word, in a register: most needles of its length differ there.
    const unsigned w0 = named && nw ? name_word(t.spans, 0, sh, n) : 0u;
    int hit = -1;
    for (int r0 = 0; r0 < a.R; r0 += a.tile_rows) {
      const int rows = min(a.tile_rows, a.R - r0);
      if (!one_tile) {
        __syncthreads();
        stage(a, t, r0, rows);
        __syncthreads();
      }
      unsigned rxm = r0 == 0 ? fl.first
                     : fl.live && fl.rxrow ? walk::row_bits<V>(fl.rxrow + r0, g.q * V, rows, a.width)
                                           : 0u;
      for (int base = 0; __any_sync(walk::kFull, fl.live && hit < 0 && base < rows); base += G * V) {
        const int c = base + g.q * V;
        // The next step's rx bytes go out before this step is tested.
        const bool more = fl.live && hit < 0 && fl.rxrow && base + G * V < rows;
        const unsigned rx_next = more ? walk::row_bits<V>(fl.rxrow + r0, c + G * V, rows, a.width) : 0u;
        // Bit j: row c + j is byte-free or the automaton's (by_flag), or
        // names the span's length and needs the bytes compared (by_len).
        unsigned by_flag = 0, by_len = 0;
        if (fl.live && hit < 0 && c < rows) {
          const int w = c >> 5, o = c & 31;
          by_flag = (t.any[w] >> o) & kLaneRows;
          if (fl.valid) {
            by_flag |= (t.userx[w] >> o) & rxm;
            by_len = (t.bylen[slot * t.words + w] >> o) & kLaneRows & ~by_flag;
          }
        }
        rxm = rx_next;
        int mine = -1;
        unsigned cand = by_flag | by_len;
        while (cand) {
          const int j = __ffs(cand) - 1;
          cand &= cand - 1;
          const int r = c + j;
          const int2 m = t.meta[r];
          if ((by_len >> j) & 1u) {
            const unsigned* nd = t.needle + r * a.ws;
            bool same = m.x == sl && (nw == 0 || w0 == nd[0]);  // slot 256: every length past 255
            for (int k = 1; k < nw && same; ++k) same = name_word(t.spans, k, sh, n) == nd[k];
            const uint8_t* tail = a.needle + static_cast<size_t>(r0 + r) * a.W;
            for (int i = 4 * a.ws; i < n && same; ++i) same = byte_at(drow, fl.s + i, a.L) == __ldg(tail + i);
            if (!same) continue;
          }
          const size_t gr = static_cast<size_t>(r0 + r);
          if ((m.y & kAnyRemote) ||
              (a.ids_staged ? walk::remote_in_shared(s_ids + gr * 8, fl.remote, rot)
                            : walk::remote_in(a.remote_ids + gr * walk::kMaxRemotes, fl.remote, a.ids16))) {
            mine = r0 + r;
            break;
          }
        }
        const unsigned b = g.ballot(mine >= 0);
        const int first = g.lowest(mine, b);
        if (b && hit < 0) hit = first;
      }
    }
    if (fl.live && g.q == 0) {
      a.allow[fl.f] = hit >= 0;
      a.rule[fl.f] = hit;
    }
  }
}

struct Launch {
  Args a;
  cudaStream_t stream;

  template <int G, int V>
  cudaError_t run() const {
    auto kernel = dns_hits_kernel<G, V>;
    Args args = a;
    args.ids_staged = a.R <= walk::kIdsRows;
    const int ids_bytes = args.ids_staged ? a.R * walk::kMaxRemotes * 4 : 0;
    const int budget = kSmemBudget - ids_bytes;
    // Needle words: the longest name (at most kNameCap bytes; the rest is
    // compared from device memory), and as many rows as the budget holds.
    const int ws = (std::min(a.W, kNameCap) + 3) / 4;
    auto bytes = [&](int tile) {  // the tables of a tile and the groups' copies of names
      return tile * (8 + 4 * ws) + (tile + 31) / 32 * 4 * (2 + kLenSlots) + 4 * kPresentWords +
             kThreads / G * 4 * (ws + 2);
    };
    int tile_rows = 32;
    while (tile_rows < a.R && bytes(tile_rows + 32) <= budget) tile_rows += 32;
    args.ws = ws;
    args.tile_rows = tile_rows;
    args.width = a.rx ? walk::load_width(V, a.R, a.rx) : 1;
    const size_t smem = ids_bytes + bytes(std::min(a.R, tile_rows));
    const int tiles = (a.F + kThreads / G - 1) / (kThreads / G);
    int blocks = 0;
    cudaError_t err = walk::grid_for(kernel, tiles, smem, &blocks);
    if (err != cudaSuccess) return err;
    kernel<<<blocks, kThreads, smem, stream>>>(args);
    return cudaGetLastError();
  }
};

Launch make_launch(const void* dotted, const void* valid, const void* span_start,
                   const void* span_end, const void* rx, const void* remotes, const void* needle,
                   const void* name_len, const void* name_any, const void* use_rx,
                   const void* remote_ids, const void* any_remote, int F, int L, int R, int W,
                   void* allow, void* rule, void* stream) {
  Args a;
  a.dotted = static_cast<const uint8_t*>(dotted);
  a.valid = static_cast<const bool*>(valid);
  a.span_start = static_cast<const int32_t*>(span_start);
  a.span_end = static_cast<const int32_t*>(span_end);
  a.rx = static_cast<const bool*>(rx);
  a.remotes = static_cast<const int32_t*>(remotes);
  a.needle = static_cast<const uint8_t*>(needle);
  a.name_len = static_cast<const int32_t*>(name_len);
  a.name_any = static_cast<const bool*>(name_any);
  a.use_rx = static_cast<const bool*>(use_rx);
  a.remote_ids = static_cast<const int32_t*>(remote_ids);
  a.any_remote = static_cast<const bool*>(any_remote);
  a.F = F;
  a.L = L;
  a.R = R;
  a.W = W;
  a.allow = static_cast<bool*>(allow);
  a.rule = static_cast<int32_t*>(rule);
  a.width = 1;
  a.needle4 = W % 4 == 0 && reinterpret_cast<uintptr_t>(needle) % 4 == 0;
  a.needle16 = W % 16 == 0 && reinterpret_cast<uintptr_t>(needle) % 16 == 0;
  a.row4 = L % 4 == 0 && reinterpret_cast<uintptr_t>(dotted) % 4 == 0;
  a.ids16 = reinterpret_cast<uintptr_t>(remote_ids) % 16 == 0;
  a.ids_staged = false;
  a.ws = 0;
  a.tile_rows = 16;
  return Launch{a, static_cast<cudaStream_t>(stream)};
}

}  // namespace

// The (lanes, rows a lane a step) a launch takes for R rules and F flows,
// packed as lanes | rows << 8 (kernels.hits_variant).
CILIUM_EXPORT int hits_variant(int R, int F) { return walk::packed(geometry(R, F)); }

CILIUM_EXPORT int dns_hits(const void* dotted, const void* valid,
                           const void* span_start, const void* span_end,
                           const void* rx, const void* remotes,
                           const void* needle, const void* name_len,
                           const void* name_any, const void* use_rx,
                           const void* remote_ids, const void* any_remote,
                           int F, int L, int R, int W, void* allow,
                           void* rule, void* stream) {
  if (F <= 0) return cudaSuccess;
  const Launch launch = make_launch(dotted, valid, span_start, span_end, rx, remotes, needle,
                                    name_len, name_any, use_rx, remote_ids, any_remote, F, L, R,
                                    W, allow, rule, stream);
  return walk::dispatch(geometry(R, F), launch);
}
