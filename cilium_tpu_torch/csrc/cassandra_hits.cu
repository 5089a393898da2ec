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
// table hits, five [F] inputs, the [F] output); the work is one test a
// row walked and the action bytes of the rows whose needle length is the
// request's.  Design (acl_walk.cuh): a request's loads (its lengths and
// flag, remote, automaton row and its first 32 bytes as two 16-byte
// words) go out together before any test, and an action is compared with
// a needle as two 16-byte words under a mask of its first min(action_len,
// 32) bytes.  The launcher picks the walk from R.  Up to kDirectRows
// rows a thread walks its request: the tables' rows (needle length, flags,
// the needle's first 16 bytes) are loaded with the request, through the
// read-only path at one address a warp, and tested from registers as bit
// masks, the table gate (a bit of the automaton row) before the action and
// the remote sets last; a needle's bytes past 16 and a row's remote ids
// are read where a test needs them.  Past it a group of G lanes walks a
// request, V rows a lane a step (rule_walk.cuh): per tile of rows the
// block stages each
// row's {needle length, flags} and its needle's first 16 bytes and, per 32
// rows, words of bits for the action-free rows, the table-free rows and
// the rows naming each action length (0 to 32, and 33 for any longer), and
// the remote ids up to walk::kIdsRows rows; a lane takes its V rows'
// candidates with three word loads and its rx bits, and no branch,
// compares only the candidates whose needle length is the request's, and
// the group's ballot gives the first row that allows.  Blocks are
// persistent, so the staging is paid once a block.
//
// Semantics, per rule r (rx may be absent: no row has a table regex, so
// every table_none is true):
//   action_ok = action_any[r] | (max(action_len, 0) == a_len[r] and
//               data[0, min(a_len, 32)) equals needle[r])
//   table_ok  = table_none[r] | table_len == 0 | rx[f, r]
//   ok        = any_remote[r] | remotes[f] in remote_ids[r, :]
//   allow[f]  = any_r (ok & (non_query[f] | (action_ok & table_ok))).
#include "acl_walk.cuh"

namespace {

using walk::Group;
using walk::kThreads;

constexpr int kMaxAction = 32;   // models/cassandra.py MAX_ACTION
constexpr int kRow = 32 + 96;    // MAX_ACTION + MAX_TABLE
constexpr int kLenSlots = kMaxAction + 2;  // action lengths 0-32, and 33 for any longer
constexpr int kSmemBudget = 48 * 1024;
// Tables of at most this many rows take the direct walk (at F = 65,536
// the direct walk is faster up to 9 rows, the lane walk from 12: chip_hits_variants.py's sweep, PERF.md).
constexpr int kDirectRows = 9;
constexpr unsigned kAny = 1u, kTableNone = 2u, kAnyRemote = 4u;

// The (lanes, rows) of the lane-group walk (walk::geometry, as K9 takes
// them), or {0, 0} for the direct walk, which tables of at most
// kDirectRows rows take.
walk::Geometry geometry(int R, int F) {
  if (R <= kDirectRows) return walk::Geometry{0, 0};
  return walk::geometry(R, F, 65536, 16, 4);
}

// The lane's rows of a step: bit j for row c + j, c + j < rows (V <= 16).
template <int V>
__device__ __forceinline__ unsigned lane_rows(int c, int rows) {
  constexpr unsigned all = (1u << V) - 1u;
  return rows - c >= V ? all : rows > c ? (1u << (rows - c)) - 1u : 0u;
}

struct Args {
  const uint8_t* data;  // [F, 128]
  const int32_t* action_len;
  const int32_t* table_len;
  const bool* non_query;
  const bool* rx;  // [F, R] or null
  const int32_t* remotes;
  const uint8_t* needle;  // [R, 32]
  const int32_t* a_len;
  const bool* action_any;
  const bool* table_none;
  const int32_t* remote_ids;  // [R, 32]
  const bool* any_remote;
  int F, R;
  bool* allow;
  int width;        // walk::load_width of rx in the lane walk (V rows a load at most)
  bool data16;      // the data base is 16-byte aligned (rows are 128 bytes)
  bool needle16;    // the needle base is 16-byte aligned (rows are 32 bytes)
  bool ids16;       // remote_ids is 16-byte aligned
  bool ids_staged;  // the remote ids lie in shared memory (R <= walk::kIdsRows)
  int tile_rows;    // rows staged at once (a multiple of 32)
};

// What a thread or lane needs of its request: loaded together, before any
// test (and, in the lane-group walk, before the tables are staged).
struct Request {
  bool live;  // false: a request past F riding along (no work, no store)
  bool nq, no_table;
  int f, alen, remote;
  uint4 x0, x1;          // the row's bytes [0, 32)
  const uint8_t* rxrow;  // the request's rx row, null without rx
};

// Every load of request f (f < F), with no branch among them; vec: the
// data base is 16-byte aligned.
__device__ __forceinline__ Request load_request(const Args& a, int f, bool vec) {
  Request rq;
  rq.f = f;
  rq.live = true;
  rq.rxrow = a.rx ? reinterpret_cast<const uint8_t*>(a.rx) + static_cast<size_t>(f) * a.R : nullptr;
  rq.alen = max(__ldg(a.action_len + f), 0);
  rq.no_table = __ldg(a.table_len + f) == 0;
  rq.nq = walk::flag(a.non_query + f);
  rq.remote = __ldg(a.remotes + f);
  const uint8_t* row = a.data + static_cast<size_t>(f) * kRow;
  rq.x0 = acl::load16(row, 0, kMaxAction, vec);
  rq.x1 = acl::load16(row, 16, kMaxAction, vec);
  return rq;
}

// The lane walk's request f: requests past F load request F - 1 and ride
// along (live false: no work, no store).
__device__ __forceinline__ Request lane_request(const Args& a, int f) {
  Request rq = load_request(a, min(f, a.F - 1), a.data16);
  rq.f = f;
  rq.live = f < a.F;
  return rq;
}

// The action's bytes [16, n) equal rule r's needle's (n at most 32).
__device__ __forceinline__ bool action_tail_equal(const Args& a, const uint4& x1, size_t r, int n) {
  return n <= 16 || acl::same16(x1, acl::load16(a.needle + r * kMaxAction, 16, kMaxAction, a.needle16), n - 16);
}

// Row r passes a request's action and table (its remote set aside): len,
// the flags and head (its needle's first 16 bytes) are the row's; x0 the
// action's first 16 bytes zeroed past n = min(alen, 32).  Bitwise up to
// the needle's tail, with no branch on the request's flags or the row's
// length: a branch there lets the compiler sink the row's loads below the
// loads it tests, a round trip more; the tail is read only where the head
// matched.
__device__ __forceinline__ bool row_l7(const Args& a, const Request& rq, const uint4& x0, int n, size_t r,
                                       int len, bool any, bool tnone, bool rx_bit, const uint4& head) {
  const bool head_ok = (len == rq.alen) & acl::equal16(x0, acl::masked(head, len));
  const bool named = head_ok && action_tail_equal(a, rq.x1, r, n);
  return rq.nq | ((rq.no_table | tnone | rx_bit) & (any | named));
}

// Rows [from, R) of a forced direct walk, a row at a time.
__device__ bool direct_rest(const Args& a, const Request& rq, const uint4& x0, int n, int from) {
  for (int r = from; r < a.R; ++r) {
    const bool rx_bit = rq.rxrow && __ldg(rq.rxrow + r);
    const uint4 head = acl::load16(a.needle + static_cast<size_t>(r) * kMaxAction, 0, kMaxAction, a.needle16);
    if (row_l7(a, rq, x0, n, r, __ldg(a.a_len + r), walk::flag(a.action_any + r), walk::flag(a.table_none + r),
               rx_bit, head) &&
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
// readings, PERF.md).  Then the rows are tested from registers as bit
// masks, the remote sets last.  kVec: the data and needle bases are
// 16-byte aligned; kRx: the model has an automaton.
template <int D, bool kVec, bool kRx>
__global__ void __launch_bounds__(kThreads) cassandra_direct_kernel(Args a) {
  const int f = blockIdx.x * kThreads + threadIdx.x;
  if (f >= a.F) return;
  if (a.R <= 0) {
    a.allow[f] = false;
    return;
  }
  const Request rq = load_request(a, f, kVec);
  uint4 head[D];
  int len[D];
  uint8_t rxb[D], any[D], tnone[D], open[D];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const int r = min(j, a.R - 1);
    rxb[j] = kRx ? __ldg(rq.rxrow + r) : 0;
    len[j] = __ldg(a.a_len + r);
    any[j] = __ldg(reinterpret_cast<const uint8_t*>(a.action_any) + r);
    tnone[j] = __ldg(reinterpret_cast<const uint8_t*>(a.table_none) + r);
    open[j] = __ldg(reinterpret_cast<const uint8_t*>(a.any_remote) + r);
    head[j] = acl::load16(a.needle + static_cast<size_t>(r) * kMaxAction, 0, kMaxAction, kVec);
  }
  const int n = min(rq.alen, kMaxAction);
  const uint4 x0 = acl::masked(rq.x0, n);
  unsigned pass = 0u, opens = 0u;  // bit j: row j passes; its remote set is any
#pragma unroll
  for (int j = 0; j < D; ++j) {
    if (row_l7(a, rq, x0, n, min(j, a.R - 1), len[j], any[j], tnone[j], rxb[j], head[j])) pass |= 1u << j;
    if (open[j]) opens |= 1u << j;
  }
  const unsigned rows = a.R >= D ? (1u << D) - 1u : (1u << a.R) - 1u;
  bool hit = acl::remote_pass(pass & rows, opens & rows, a.remote_ids, 0, rq.remote, a.ids16);
  if (!hit && a.R > D) hit = direct_rest(a, rq, x0, n, D);
  a.allow[f] = hit;
}

// A tile of rule rows in shared memory.
struct Tables {
  uint4* head;      // [tile]: the needle's first 16 bytes
  int2* meta;       // [tile]: a_len, flags
  unsigned* any;    // [words]: bit i % 32 of word i / 32, row i is action_any
  unsigned* tnone;  // [words]: table_none
  unsigned* bylen;  // [kLenSlots][words]: the rows naming each action length
  int words;
};

__host__ __device__ constexpr int table_bytes(int tile) {
  return tile * (16 + 8) + (tile + 31) / 32 * 4 * (2 + kLenSlots);
}

__device__ __forceinline__ Tables tables_at(const Args& a, int4* smem) {
  const int tile = min(a.R, a.tile_rows);
  Tables t;
  t.words = (tile + 31) / 32;
  t.head = reinterpret_cast<uint4*>(smem + (a.ids_staged ? a.R * (walk::kMaxRemotes / 4) : 0));
  t.meta = reinterpret_cast<int2*>(t.head + tile);
  t.any = reinterpret_cast<unsigned*>(t.meta + tile);
  t.tnone = t.any + t.words;
  t.bylen = t.tnone + t.words;
  return t;
}

// Rows [r0, r0 + n) into t.
__device__ void stage(const Args& a, const Tables& t, int r0, int n) {
  for (int i = threadIdx.x; i < kLenSlots * t.words; i += blockDim.x) t.bylen[i] = 0;
  __syncthreads();
  for (int base = 0; base < n; base += blockDim.x) {  // whole warps: the ballots
    const int i = base + static_cast<int>(threadIdx.x);
    const bool in = i < n;
    const int r = r0 + (in ? i : 0);
    const bool any = in && walk::flag(a.action_any + r);
    const bool tnone = in && walk::flag(a.table_none + r);
    const int len = in ? __ldg(a.a_len + r) : -1;
    const unsigned any_w = __ballot_sync(walk::kFull, any);
    const unsigned tnone_w = __ballot_sync(walk::kFull, tnone);
    if (in) {
      const unsigned flags = (any ? kAny : 0u) | (tnone ? kTableNone : 0u) |
                             (walk::flag(a.any_remote + r) ? kAnyRemote : 0u);
      t.meta[i] = make_int2(len, static_cast<int>(flags));
      t.head[i] = acl::load16(a.needle + static_cast<size_t>(r) * kMaxAction, 0, kMaxAction, a.needle16);
      if (!any && len >= 0) atomicOr(t.bylen + min(len, kLenSlots - 1) * t.words + i / 32, 1u << (i & 31));
      if ((threadIdx.x & 31) == 0) {
        t.any[i / 32] = any_w;
        t.tnone[i / 32] = tnone_w;
      }
    }
  }
}

// The lane-group walk over staged tables.
template <int G, int V>
__global__ void __launch_bounds__(kThreads) cassandra_walk_kernel(Args a) {
  extern __shared__ int4 smem[];
  int4* s_ids = smem;  // [R, 8] when a.ids_staged
  const Tables t = tables_at(a, smem);
  const int tile = min(a.R, a.tile_rows);
  const Group<G> g;
  const int rot = threadIdx.x & 7;
  const int tiles = (a.F + kThreads / G - 1) / (kThreads / G);
  const bool one_tile = a.R <= a.tile_rows;
  // The first flow tile's requests and their first step's rx bits go out
  // before the staging.
  Request rq = lane_request(a, blockIdx.x * (kThreads / G) + static_cast<int>(threadIdx.x) / G);
  unsigned first = rq.rxrow ? walk::row_bits<V>(rq.rxrow, g.q * V, tile, a.width) : 0u;
  if (a.ids_staged) walk::stage_ids(a.remote_ids, s_ids, a.R, a.ids16);
  if (one_tile) stage(a, t, 0, a.R);
  __syncthreads();

  for (int ft = blockIdx.x; ft < tiles; ft += gridDim.x) {
    if (ft != static_cast<int>(blockIdx.x)) {
      rq = lane_request(a, ft * (kThreads / G) + static_cast<int>(threadIdx.x) / G);
      first = rq.rxrow ? walk::row_bits<V>(rq.rxrow, g.q * V, tile, a.width) : 0u;
    }
    const int n = min(rq.alen, kMaxAction);
    const int slot = min(rq.alen, kLenSlots - 1);
    int hit = -1;
    for (int r0 = 0; r0 < a.R; r0 += a.tile_rows) {
      const int rows = min(a.tile_rows, a.R - r0);
      if (!one_tile) {
        __syncthreads();
        stage(a, t, r0, rows);
        __syncthreads();
      }
      unsigned rxm = r0 == 0 ? first
                     : rq.rxrow ? walk::row_bits<V>(rq.rxrow + r0, g.q * V, rows, a.width)
                                : 0u;
      for (int base = 0; __any_sync(walk::kFull, rq.live && hit < 0 && base < rows); base += G * V) {
        const int c = base + g.q * V;
        // The next step's rx bytes go out before this step is tested.
        const bool more = rq.live && hit < 0 && rq.rxrow && base + G * V < rows;
        const unsigned rx_next = more ? walk::row_bits<V>(rq.rxrow + r0, c + G * V, rows, a.width) : 0u;
        // Bit j: row c + j passes without a compare (cand & ~cmp), or
        // passes its table gate and names the action's length (cmp).
        unsigned cand = 0u, cmp = 0u;
        if (rq.live && hit < 0 && c < rows) {
          const unsigned in = lane_rows<V>(c, rows);
          if (rq.nq) {
            cand = in;
          } else {
            const int w = c >> 5, o = c & 31;
            const unsigned table = rq.no_table ? in : ((t.tnone[w] >> o) | rxm) & in;
            const unsigned any = (t.any[w] >> o) & table;
            cmp = (t.bylen[slot * t.words + w] >> o) & table & ~any;
            cand = any | cmp;
          }
        }
        rxm = rx_next;
        int mine = -1;
        while (cand) {
          const int j = __ffs(cand) - 1;
          cand &= cand - 1u;
          const int r = c + j;
          const int2 m = t.meta[r];
          const size_t gr = static_cast<size_t>(r0 + r);
          if ((cmp >> j) & 1u) {
            if (m.x != rq.alen) continue;  // slot 33: every length past 32
            if (!acl::same16(rq.x0, t.head[r], n) || !action_tail_equal(a, rq.x1, gr, n)) continue;
          }
          if ((m.y & kAnyRemote) ||
              (a.ids_staged ? walk::remote_in_shared(s_ids + gr * 8, rq.remote, rot)
                            : walk::remote_in(a.remote_ids + gr * walk::kMaxRemotes, rq.remote, a.ids16))) {
            mine = r0 + r;
            break;
          }
        }
        const unsigned b = g.ballot(mine >= 0);
        const int lowest = g.lowest(mine, b);
        if (b && hit < 0) hit = lowest;
      }
    }
    if (rq.live && g.q == 0) a.allow[rq.f] = hit >= 0;
  }
}

struct Launch {
  Args a;
  cudaStream_t stream;

  // The direct walk over D rows a thread (rows past R read row R - 1 again).
  template <int D>
  cudaError_t direct_rows() const {
    auto kernel = a.data16 && a.needle16 ? (a.rx ? cassandra_direct_kernel<D, true, true> : cassandra_direct_kernel<D, true, false>)
                     : (a.rx ? cassandra_direct_kernel<D, false, true> : cassandra_direct_kernel<D, false, false>);
    kernel<<<(a.F + kThreads - 1) / kThreads, kThreads, 0, stream>>>(a);
    return cudaGetLastError();
  }

  cudaError_t direct() const {
    return a.R <= 1 ? direct_rows<1>() : a.R <= 2 ? direct_rows<2>() : a.R <= 4 ? direct_rows<4>()
                                                                       : direct_rows<acl::kRowsAtOnce>();
  }

  template <int G, int V>
  cudaError_t run() const {
    auto kernel = cassandra_walk_kernel<G, V>;
    Args args = a;
    args.ids_staged = a.R <= walk::kIdsRows;
    const int ids_bytes = args.ids_staged ? a.R * walk::kMaxRemotes * 4 : 0;
    int tile_rows = 32;
    while (tile_rows < a.R && ids_bytes + table_bytes(tile_rows + 32) <= kSmemBudget) tile_rows += 32;
    args.tile_rows = tile_rows;
    args.width = a.rx ? walk::load_width(V, a.R, a.rx) : 1;
    const size_t smem = ids_bytes + table_bytes(std::min(a.R, tile_rows));
    const int tiles = (a.F + kThreads / G - 1) / (kThreads / G);
    int blocks = 0;
    cudaError_t err = walk::grid_for(kernel, tiles, smem, &blocks);
    if (err != cudaSuccess) return err;
    kernel<<<blocks, kThreads, smem, stream>>>(args);
    return cudaGetLastError();
  }
};

Launch make_launch(const void* data, const void* action_len, const void* table_len,
                   const void* non_query, const void* rx, const void* remotes, const void* needle,
                   const void* a_len, const void* action_any, const void* table_none,
                   const void* remote_ids, const void* any_remote, int F, int R, void* allow,
                   void* stream) {
  Args a;
  a.data = static_cast<const uint8_t*>(data);
  a.action_len = static_cast<const int32_t*>(action_len);
  a.table_len = static_cast<const int32_t*>(table_len);
  a.non_query = static_cast<const bool*>(non_query);
  a.rx = static_cast<const bool*>(rx);
  a.remotes = static_cast<const int32_t*>(remotes);
  a.needle = static_cast<const uint8_t*>(needle);
  a.a_len = static_cast<const int32_t*>(a_len);
  a.action_any = static_cast<const bool*>(action_any);
  a.table_none = static_cast<const bool*>(table_none);
  a.remote_ids = static_cast<const int32_t*>(remote_ids);
  a.any_remote = static_cast<const bool*>(any_remote);
  a.F = F;
  a.R = R;
  a.allow = static_cast<bool*>(allow);
  auto at16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  a.width = 1;
  a.data16 = at16(data);
  a.needle16 = at16(needle);
  a.ids16 = at16(remote_ids);
  a.ids_staged = false;
  a.tile_rows = 32;
  return Launch{a, static_cast<cudaStream_t>(stream)};
}

}  // namespace

// The (lanes, rows a lane a step) a launch takes for R rules and F
// requests, packed as lanes | rows << 8; 0 for the direct walk
// (kernels.hits_variant).
CILIUM_EXPORT int hits_variant(int R, int F) { return walk::packed(geometry(R, F)); }

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
  const Launch launch = make_launch(data, action_len, table_len, non_query, rx, remotes, needle,
                                    a_len, action_any, table_none, remote_ids, any_remote, F, R,
                                    allow, stream);
  const walk::Geometry g = geometry(R, F);
  return g.lanes == 0 ? launch.direct() : walk::dispatch(g, launch);
}
