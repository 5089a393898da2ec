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
// the topics and client ids whose lengths are equal.  Design
// (rule_walk.cuh's lane groups and persistent blocks): a group of G lanes
// owns a request, lane q its topic slots q * SL to q * SL + SL - 1 (all
// eight in one lane at G = 1), so a lane's topic lengths are one vector
// load and the group's coalesce.  The rule tables are staged in shared
// memory once a block, in tiles of rows when they do not fit: per row its
// version, client and topic lengths and flags, the [64] bool key mask as
// four 16-bit masks, the client's 64 bytes and the topic's first 32, and
// the remote ids up to walk::kIdsRows rows, a job a thread, each job's
// loads before its stores; a thread's first two jobs are fetched before
// its request's columns and topic lengths, so the table is not queued
// behind the batch at the barrier.  The walk takes G rule rows a step,
// lane q row base + q: the key, version and request-type gates, the
// remote set (every id compared) and, where the row names a client of the
// request's length, the client as four 16-byte compares against the
// staged row.  The group's ballot gives the step's rows whose gates hold;
// `simple` is one more ballot, and each topic row among them is compared
// by every lane against its slots of that length at once, 16-byte words
// masked to the length (a slot's first 32 bytes read where a compare
// needs them, and kept by a lane of one slot; the rule's past 32 from
// device memory).  The launcher takes a lane a request where the batch
// fills the card and more lanes where few requests leave it idle.  Bytes
// are compared only up to the lengths, where both sides are equal in
// length: the batch and the rule tables are zero-padded past their
// lengths, so this equals the reference's compare of the whole padded
// rows.  Without the optional outputs the walk stops once the verdict is
// settled (simple, or every active topic covered); with them it visits
// every row, and writes simple [F] and cover [F, T] exactly as
// kafka_rule_hits does for every slot, active or not (slot t's lane
// writes cover[f, t]).
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
#include "rule_walk.cuh"

namespace {

using walk::Group;
using walk::kFull;
using walk::kThreads;

constexpr int kMaxApiKey = 64;     // models/kafka.py MAX_API_KEY
constexpr int kMaxClient = 64;     // MAX_CLIENT_LEN
constexpr int kMaxTopicLen = 256;  // MAX_TOPIC_LEN (rule topic row)
constexpr int kFindCoordinator = 10;
constexpr int kHead = 32;  // topic bytes staged a rule row and held a lane
constexpr int kSmemBudget = 48 * 1024;
constexpr unsigned kVersionAny = 1u, kClientAny = 2u, kTopicAny = 4u, kAnyRemote = 8u;

struct Geometry {
  int lanes;  // G: lanes a request (and rule rows a step)
};

// Topic slots a lane holds: lane q slots q * SL .. q * SL + SL - 1, SL =
// lane_slots (T <= G * SL).
template <int G>
__host__ __device__ constexpr int lane_slots() { return G >= 8 ? 1 : 8 / G; }

// The variant a launch takes, from the requests F, the rule rows R and the
// topic slots T: a lane a request (its slots in registers) where the
// batch fills the card, doubled while F x G stays within 32,768 threads
// and the rows fill half the lanes at least, and enough lanes for T slots
// (8 a lane at most, one a lane past 8 lanes) (chip_hits_variants.py's
// readings: at F = 65,536 a lane beats 2, 4 and 8; at the Kafka engine's
// 864 requests and 15 rows 32 lanes beat 16 and 8).
inline Geometry geometry(int R, int F, int T) {
  Geometry g;
  g.lanes = 1;
  while ((g.lanes < 8 ? 8 : g.lanes) < T ||
         (g.lanes < 32 && g.lanes < 2 * R && 2LL * g.lanes * F <= 32768))
    g.lanes *= 2;
  return g;
}

struct Args {
  const int32_t* api_key;
  const int32_t* api_version;
  const uint8_t* client;  // [F, 64]
  const int32_t* client_len;
  const uint8_t* topics;  // [F, T, W]
  const int32_t* topic_len;  // [F, T]
  const int32_t* topic_count;
  const bool* parsed;
  const bool* overflow;
  const int32_t* remotes;
  const uint8_t* key_mask;  // [R, 64] bool
  const int32_t* r_version;
  const bool* version_any;
  const uint8_t* r_client;  // [R, 64]
  const int32_t* r_client_len;
  const bool* client_any;
  const uint8_t* r_topic;  // [R, 256]
  const int32_t* r_topic_len;
  const bool* topic_any;
  const bool* is_topic_key;  // [64]
  const int32_t* remote_ids;  // [R, 32]
  const bool* any_remote;
  int F, R, T, W;
  bool* allow;
  bool* simple;  // null without the optional outputs
  bool* cover;
  bool client16;    // the client rows are 16-byte aligned
  bool slots8;      // T = 8, topic_len 16-byte aligned and cover 8-byte aligned: a lane's
                    // slots are one vector load and one store
  bool topics16;    // W and the topics base are multiples of 16
  bool tables16;    // key_mask, r_client and r_topic are 16-byte aligned
  bool ids16;       // remote_ids is 16-byte aligned
  bool ids_staged;  // the remote ids lie in shared memory (R <= walk::kIdsRows)
  int tile_rows;    // rows staged at once (a multiple of 32)
};

// A tile of rule rows in shared memory.
struct Tables {
  uint4* client;   // [tile][4]
  uint4* topic;    // [tile][2]: the first kHead bytes
  int4* meta;      // [tile]: version, client_len, topic_len, flags
  unsigned short* keyh;  // [tile][4]: bit k % 16 of piece k / 16 is key k of the mask
};

__host__ __device__ constexpr int table_bytes(int tile) { return tile * (64 + 2 * 16 + 16 + 8); }

__device__ __forceinline__ Tables tables_at(const Args& a, int4* smem, int tile) {
  Tables t;
  t.client = reinterpret_cast<uint4*>(smem + (a.ids_staged ? a.R * (walk::kMaxRemotes / 4) : 0));
  t.topic = t.client + 4 * tile;
  t.meta = reinterpret_cast<int4*>(t.topic + 2 * tile);
  t.keyh = reinterpret_cast<unsigned short*>(t.meta + tile);
  return t;
}

// 16 bytes at p + c, zeros where c >= n: one 16-byte load where vec (p +
// c 16-byte aligned, the chunk inside the row), else byte loads up to n.
__device__ __forceinline__ uint4 load16(const uint8_t* __restrict__ p, int c, int n, bool vec) {
  uint4 out = make_uint4(0u, 0u, 0u, 0u);
  if (c >= n) return out;
  if (vec) return __ldg(reinterpret_cast<const uint4*>(p + c));
  unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (c + i < n) w[i >> 2] |= static_cast<unsigned>(__ldg(p + c + i)) << (8 * (i & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The bytes of a 4-byte word to keep when keep of them count (0 to 4+).
__device__ __forceinline__ unsigned keep_mask(int keep) {
  return keep >= 4 ? ~0u : keep > 0 ? (1u << (8 * keep)) - 1u : 0u;
}

// x and y agree on their first keep bytes (of 16).
__device__ __forceinline__ bool same16(const uint4& x, const uint4& y, int keep) {
  return (((x.x ^ y.x) & keep_mask(keep)) | ((x.y ^ y.y) & keep_mask(keep - 4)) |
          ((x.z ^ y.z) & keep_mask(keep - 8)) | ((x.w ^ y.w) & keep_mask(keep - 12))) == 0u;
}

// A staging job's loads: eleven jobs a rule row (its meta, four 16-byte
// pieces of the key mask, four of the client, two of the topic's first
// kHead bytes), then with ids eight a row of remote ids.
struct Job {
  int j;    // -1: none
  uint4 v;  // what job j loaded
};

__device__ __forceinline__ int stage_jobs(const Args& a, int n, bool ids) {
  return 11 * n + (ids ? a.R * (walk::kMaxRemotes / 4) : 0);
}

__device__ __forceinline__ Job fetch(const Args& a, int j, int r0, int n, bool ids) {
  Job jb{-1, make_uint4(0u, 0u, 0u, 0u)};
  if (j >= stage_jobs(a, n, ids)) return jb;
  jb.j = j;
  if (j >= 11 * n) {
    const int32_t* p = a.remote_ids + 4 * (j - 11 * n);
    jb.v = a.ids16 ? __ldg(reinterpret_cast<const uint4*>(p))
                   : make_uint4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
    return jb;
  }
  const int i = j / 11, k = j - 11 * i;
  const int r = r0 + i;
  if (k == 0) {
    const unsigned flags = (walk::flag(a.version_any + r) ? kVersionAny : 0u) |
                           (walk::flag(a.client_any + r) ? kClientAny : 0u) |
                           (walk::flag(a.topic_any + r) ? kTopicAny : 0u) |
                           (walk::flag(a.any_remote + r) ? kAnyRemote : 0u);
    jb.v = make_uint4(__ldg(a.r_version + r), __ldg(a.r_client_len + r), __ldg(a.r_topic_len + r), flags);
  } else if (k < 5) {
    jb.v = load16(a.key_mask + static_cast<size_t>(r) * kMaxApiKey, 16 * (k - 1), kMaxApiKey, a.tables16);
  } else if (k < 9) {
    jb.v = load16(a.r_client + static_cast<size_t>(r) * kMaxClient, 16 * (k - 5), kMaxClient, a.tables16);
  } else {
    jb.v = load16(a.r_topic + static_cast<size_t>(r) * kMaxTopicLen, 16 * (k - 9), kHead, a.tables16);
  }
  return jb;
}

// A fetched job into shared memory (the key mask's pieces as 16-bit masks).
__device__ __forceinline__ void put(const Tables& t, int4* s_ids, const Job& jb, int n) {
  if (jb.j < 0) return;
  if (jb.j >= 11 * n) {
    s_ids[jb.j - 11 * n] = make_int4(jb.v.x, jb.v.y, jb.v.z, jb.v.w);
    return;
  }
  const int i = jb.j / 11, k = jb.j - 11 * i;
  const uint4& x = jb.v;
  if (k == 0) t.meta[i] = make_int4(x.x, x.y, x.z, x.w);
  else if (k < 5)
    t.keyh[4 * i + k - 1] = static_cast<unsigned short>(
        walk::nonzero4(x.x) | walk::nonzero4(x.y) << 4 | walk::nonzero4(x.z) << 8 | walk::nonzero4(x.w) << 12);
  else if (k < 9) t.client[4 * i + k - 5] = x;
  else t.topic[2 * i + k - 9] = x;
}

// Rows [r0, r0 + n) into t, and with ids the [R, 32] remote ids into
// s_ids, a job a thread a round; pre holds this thread's first two jobs,
// fetched earlier (j -1 where not).
__device__ void stage(const Args& a, const Tables& t, int4* s_ids, int r0, int n, bool ids,
                      const Job (&pre)[2]) {
  put(t, s_ids, pre[0], n);
  put(t, s_ids, pre[1], n);
  const int jobs = stage_jobs(a, n, ids);
  for (int j = threadIdx.x + (pre[0].j >= 0 ? blockDim.x : 0) + (pre[1].j >= 0 ? blockDim.x : 0);
       j < jobs; j += blockDim.x)
    put(t, s_ids, fetch(a, j, r0, n, ids), n);
}

// What a lane needs of its request: loaded before the tables are staged.
template <int SL>
struct Request {
  bool live;  // requests past F ride along: no load, no store
  int f, key, ver, clen, tc, remote;
  bool parsed, over;
  int tlen[SL];  // of the lane's slots
};

template <int G>
__device__ __forceinline__ Request<lane_slots<G>()> load_request(const Args& a, int tile, int q) {
  constexpr int SL = lane_slots<G>();
  Request<SL> rq;
  rq.f = tile * (kThreads / G) + static_cast<int>(threadIdx.x) / G;
  rq.live = rq.f < a.F;
  const int f = rq.live ? rq.f : 0;
  rq.key = rq.live ? __ldg(a.api_key + f) : -1;
  rq.ver = rq.live ? __ldg(a.api_version + f) : 0;
  rq.clen = rq.live ? __ldg(a.client_len + f) : 0;
  rq.tc = rq.live ? __ldg(a.topic_count + f) : 0;
  rq.remote = rq.live ? __ldg(a.remotes + f) : 0;
  rq.parsed = rq.live && walk::flag(a.parsed + f);
  rq.over = rq.live && walk::flag(a.overflow + f);
  const int32_t* tl = a.topic_len + static_cast<size_t>(f) * a.T + q * SL;
  if (a.slots8 && SL >= 4) {
#pragma unroll
    for (int j = 0; j < SL; j += 4) {
      const int4 x = rq.live ? __ldg(reinterpret_cast<const int4*>(tl + j)) : make_int4(0, 0, 0, 0);
      rq.tlen[j] = x.x, rq.tlen[j + 1] = x.y, rq.tlen[j + 2] = x.z, rq.tlen[j + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < SL; ++j) rq.tlen[j] = rq.live && q * SL + j < a.T ? __ldg(tl + j) : 0;
  }
  return rq;
}

// The request's client against a staged rule client: four 16-byte compares
// up to n bytes (the request's from device memory).
__device__ __forceinline__ bool client_equal(const Args& a, size_t f, const uint4* rule, int n) {
  const uint8_t* p = a.client + f * kMaxClient;
  bool same = true;
#pragma unroll
  for (int k = 0; k < 4; ++k) same &= same16(load16(p, 16 * k, n, a.client16), rule[k], n - 16 * k);
  return same;
}

// Slot bytes [0, n) against the rule topic: the slot's first kHead (x)
// against the staged ones, the rest from device memory.
__device__ __forceinline__ bool topic_equal(const Args& a, const uint8_t* trow, const uint4 (&x)[2],
                                            const uint4* head, size_t r, int n) {
  bool same = same16(x[0], head[0], n) && same16(x[1], head[1], n - 16);
  const uint8_t* rt = a.r_topic + r * kMaxTopicLen;
  for (int b = kHead; b < n && same; ++b) same = __ldg(trow + b) == __ldg(rt + b);
  return same;
}

template <int G>
__global__ void __launch_bounds__(kThreads, 4) kafka_hits_kernel(Args a) {
  constexpr int SL = lane_slots<G>();
  extern __shared__ int4 smem[];
  int4* s_ids = smem;  // [R, 8] when a.ids_staged
  const int tile = min(a.R, a.tile_rows);
  const Tables t = tables_at(a, smem, tile);
  const Group<G> g;
  const int q = g.q;
  const int rot = threadIdx.x & 7;
  const int tiles = (a.F + kThreads / G - 1) / (kThreads / G);
  const bool one_tile = a.R <= a.tile_rows;
  const bool parts = a.simple != nullptr;
  // The table's first loads go out before the request's, so that they are
  // not queued behind the whole batch's at the barrier.
  const Job none{-1, make_uint4(0u, 0u, 0u, 0u)};
  const Job pre[2] = {one_tile ? fetch(a, threadIdx.x, 0, a.R, a.ids_staged) : none,
                      one_tile ? fetch(a, threadIdx.x + blockDim.x, 0, a.R, a.ids_staged) : none};
  Request<SL> rq = load_request<G>(a, blockIdx.x, q);
  if (one_tile) stage(a, t, s_ids, 0, a.R, a.ids_staged, pre);
  __syncthreads();

  for (int ft = blockIdx.x; ft < tiles; ft += gridDim.x) {
    if (ft != static_cast<int>(blockIdx.x)) rq = load_request<G>(a, ft, q);
    const size_t f = rq.live ? rq.f : 0;
    const bool in_range = rq.key >= 0 && rq.key < kMaxApiKey;
    const int kc = min(max(rq.key, 0), kMaxApiKey - 1);
    const bool nil_topic_key = in_range && walk::flag(a.is_topic_key + kc);
    const bool is_fc = rq.key == kFindCoordinator;
    const int cn = min(max(rq.clen, 0), kMaxClient);
    // Slots to cover: the active ones for the verdict, all T for `cover`.
    const int slots = parts ? a.T : min(max(rq.tc, 0), a.T);
    unsigned need = 0u;  // bit j: slot q * SL + j is active (the verdict needs it covered)
#pragma unroll
    for (int j = 0; j < SL; ++j)
      if (q * SL + j < a.T && q * SL + j < rq.tc) need |= 1u << j;
    unsigned cov = 0u;  // bit j: slot q * SL + j covered
    // A lane of one slot keeps that slot's first kHead bytes once loaded
    // (the compares of many rule rows read them).
    uint4 mine[2] = {make_uint4(0u, 0u, 0u, 0u), make_uint4(0u, 0u, 0u, 0u)};
    bool have = false;
    bool simple = false;
    // Every lane runs every ballot: none inside a condition that may skip it.
    const unsigned needed = g.ballot(need != 0u);
    bool done = !parts && rq.tc > 0 && needed == 0u;
    for (int r0 = 0; r0 < a.R; r0 += a.tile_rows) {
      const int rows = min(a.tile_rows, a.R - r0);
      if (!one_tile) {
        __syncthreads();
        const Job nothing[2] = {none, none};
        stage(a, t, s_ids, r0, rows, a.ids_staged && r0 == 0, nothing);
        __syncthreads();
      }
      for (int base = 0; __any_sync(kFull, rq.live && !done && base < rows); base += G) {
        const int i = base + q;  // this lane's row of the step
        bool ok = false, t_any = false;
        if (rq.live && !done && i < rows) {
          const int4 m = t.meta[i];
          const unsigned flags = static_cast<unsigned>(m.w);
          t_any = flags & kTopicAny;
          const bool c_any = flags & kClientAny;
          ok = in_range && ((t.keyh[4 * i + (kc >> 4)] >> (kc & 15)) & 1u) &&
               ((flags & kVersionAny) || m.x == rq.ver);
          if (ok && !(t_any && c_any))
            ok = rq.parsed ? c_any || rq.clen == m.y : is_fc || !(!t_any && nil_topic_key);
          if (ok && !(flags & kAnyRemote)) {
            const size_t gr = static_cast<size_t>(r0 + i);
            ok = a.ids_staged ? walk::remote_in_shared(s_ids + gr * 8, rq.remote, rot)
                              : walk::remote_in(a.remote_ids + gr * walk::kMaxRemotes, rq.remote, a.ids16);
          }
          if (ok && rq.parsed && !c_any) ok = client_equal(a, f, t.client + 4 * i, cn);
        }
        if (g.ballot(ok && (t_any || rq.tc == 0))) simple = true;
        // Topic rows whose gates hold, in turn: each lane compares its slots.
        unsigned rows_t = g.ballot(ok && !t_any);
        while (__any_sync(kFull, rows_t != 0u)) {
          if (rows_t) {
            const int i2 = base + __ffs(rows_t) - 1;
            rows_t &= rows_t - 1u;
            const int rlen = t.meta[i2].z;
            unsigned cand = 0u;  // this lane's open slots of the row's length
#pragma unroll
            for (int j = 0; j < SL; ++j)
              if (q * SL + j < slots && rq.tlen[j] == rlen) cand |= 1u << j;
            cand &= ~cov;
#pragma unroll 1
            while (cand) {
              const int j = __ffs(cand) - 1;
              cand &= cand - 1u;
              const uint8_t* trow = a.topics + (f * a.T + q * SL + j) * a.W;
              const int n = min(max(rlen, 0), a.W);
              uint4 x[2];
              if (SL == 1) {
                if (!have) {
                  const int h = min(max(rq.tlen[0], 0), min(a.W, kHead));
                  mine[0] = load16(trow, 0, h, a.topics16);
                  mine[1] = load16(trow, 16, h, a.topics16);
                  have = true;
                }
                x[0] = mine[0];
                x[1] = mine[1];
              } else {
                x[0] = load16(trow, 0, n, a.topics16);
                x[1] = load16(trow, 16, n, a.topics16);
              }
              if (topic_equal(a, trow, x, t.topic + 2 * i2, static_cast<size_t>(r0 + i2), n)) cov |= 1u << j;
            }
          }
        }
        const unsigned open_lanes = g.ballot((need & ~cov) != 0u);
        if (!parts) done = simple || (rq.tc > 0 && open_lanes == 0u);
      }
    }
    const unsigned open_lanes = g.ballot((need & ~cov) != 0u);
    const bool all_covered = rq.tc > 0 && open_lanes == 0u;
    if (rq.live) {
      if (q == 0) {
        a.allow[f] = (simple || all_covered) && !rq.over;
        if (parts) a.simple[f] = simple;
      }
      if (parts) {
        bool* out = a.cover + f * a.T + q * SL;
        if (a.slots8 && SL >= 2) {  // one store of SL bools (bytes 0 or 1)
          const unsigned lo = ((cov & 0xfu) * 0x00204081u) & 0x01010101u;
          const unsigned hi = (((cov >> 4) & 0xfu) * 0x00204081u) & 0x01010101u;
          if (SL == 8) *reinterpret_cast<uint2*>(out) = make_uint2(lo, hi);
          else if (SL == 4) *reinterpret_cast<unsigned*>(out) = lo;
          else *reinterpret_cast<unsigned short*>(out) = static_cast<unsigned short>(lo);
        } else {
#pragma unroll
          for (int j = 0; j < SL; ++j)
            if (q * SL + j < a.T) out[j] = (cov >> j) & 1u;
        }
      }
    }
  }
}

struct Launch {
  Args a;
  cudaStream_t stream;
  int tile_cap;  // at most this many rows staged at once (0: as the budget allows)

  template <int G>
  cudaError_t run() const {
    if (G * lane_slots<G>() < a.T) return cudaErrorInvalidValue;  // every slot a lane's
    auto kernel = kafka_hits_kernel<G>;
    Args args = a;
    args.ids_staged = a.R <= walk::kIdsRows;
    const int ids_bytes = args.ids_staged ? a.R * walk::kMaxRemotes * 4 : 0;
    int tile_rows = 32;
    while (tile_rows < a.R && ids_bytes + table_bytes(tile_rows + 32) <= kSmemBudget &&
           (tile_cap <= 0 || tile_rows + 32 <= tile_cap))
      tile_rows += 32;
    args.tile_rows = tile_rows;
    const size_t smem = ids_bytes + table_bytes(std::min(a.R, tile_rows));
    const int tiles = (a.F + kThreads / G - 1) / (kThreads / G);
    int blocks = 0;
    cudaError_t err = walk::grid_for(kernel, tiles, smem, &blocks);
    if (err != cudaSuccess) return err;
    kernel<<<blocks, kThreads, smem, stream>>>(args);
    return cudaGetLastError();
  }

  // run<G>() for the geometry's lanes.
  cudaError_t dispatch(const Geometry& g) const {
    switch (g.lanes) {
      case 1: return run<1>();
      case 2: return run<2>();
      case 4: return run<4>();
      case 8: return run<8>();
      case 16: return run<16>();
      default: return run<32>();
    }
  }
};

Launch make_launch(const void* api_key, const void* api_version, const void* client,
                   const void* client_len, const void* topics, const void* topic_len,
                   const void* topic_count, const void* parsed, const void* overflow,
                   const void* remotes, const void* key_mask, const void* r_version,
                   const void* version_any, const void* r_client, const void* r_client_len,
                   const void* client_any, const void* r_topic, const void* r_topic_len,
                   const void* topic_any, const void* is_topic_key, const void* remote_ids,
                   const void* any_remote, int F, int R, int T, int W, void* allow, void* simple,
                   void* cover, void* stream) {
  Args a;
  a.api_key = static_cast<const int32_t*>(api_key);
  a.api_version = static_cast<const int32_t*>(api_version);
  a.client = static_cast<const uint8_t*>(client);
  a.client_len = static_cast<const int32_t*>(client_len);
  a.topics = static_cast<const uint8_t*>(topics);
  a.topic_len = static_cast<const int32_t*>(topic_len);
  a.topic_count = static_cast<const int32_t*>(topic_count);
  a.parsed = static_cast<const bool*>(parsed);
  a.overflow = static_cast<const bool*>(overflow);
  a.remotes = static_cast<const int32_t*>(remotes);
  a.key_mask = static_cast<const uint8_t*>(key_mask);
  a.r_version = static_cast<const int32_t*>(r_version);
  a.version_any = static_cast<const bool*>(version_any);
  a.r_client = static_cast<const uint8_t*>(r_client);
  a.r_client_len = static_cast<const int32_t*>(r_client_len);
  a.client_any = static_cast<const bool*>(client_any);
  a.r_topic = static_cast<const uint8_t*>(r_topic);
  a.r_topic_len = static_cast<const int32_t*>(r_topic_len);
  a.topic_any = static_cast<const bool*>(topic_any);
  a.is_topic_key = static_cast<const bool*>(is_topic_key);
  a.remote_ids = static_cast<const int32_t*>(remote_ids);
  a.any_remote = static_cast<const bool*>(any_remote);
  a.F = F;
  a.R = R;
  a.T = T;
  a.W = W;
  a.allow = static_cast<bool*>(allow);
  a.simple = static_cast<bool*>(simple);
  a.cover = static_cast<bool*>(cover);
  auto at16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  a.client16 = at16(client);
  a.slots8 = T == 8 && at16(topic_len) && (cover == nullptr || reinterpret_cast<uintptr_t>(cover) % 8 == 0);
  a.topics16 = W % 16 == 0 && at16(topics);
  a.tables16 = at16(key_mask) && at16(r_client) && at16(r_topic);
  a.ids16 = at16(remote_ids);
  a.ids_staged = false;
  a.tile_rows = 32;
  return Launch{a, static_cast<cudaStream_t>(stream), 0};
}

}  // namespace

// The lanes a request the launch takes for R rule rows, F requests and T
// topic slots (kernels.kafka_variant).
CILIUM_EXPORT int kafka_variant(int R, int F, int T) { return geometry(R, F, T).lanes; }

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
  const Launch launch = make_launch(api_key, api_version, client, client_len, topics, topic_len,
                                    topic_count, parsed, overflow, remotes, key_mask, r_version,
                                    version_any, r_client, r_client_len, client_any, r_topic,
                                    r_topic_len, topic_any, is_topic_key, remote_ids, any_remote,
                                    F, R, T, W, allow, simple, cover, stream);
  return launch.dispatch(geometry(R, F, T));
}
