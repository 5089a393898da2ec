// K4 r2d2_hits: the r2d2 rule-row walk and its two reductions.
//
// Replaces the match half of cilium_tpu/models/r2d2.py:211: the command
// compare (_spans_compare / spans_equal_prefix / window_at,
// cilium_tpu/ops/bytescan.py:84, :112, :52), the remote-set test
// (remote_ok, cilium_tpu/models/base.py:99), the AND with file_ok, the
// any-allow (jnp.any at cilium_tpu/models/r2d2.py:255, :271) and the
// first-true row (first_match, cilium_tpu/models/base.py:62).  The TPU
// version built [F, R, 8] and [F, R, 32] compare tensors and reduced them;
// its window_at was a barrel shifter because TPU gathers serialize.
//
// Bound on the H100: bytes (file_ok [F, R], sp, remotes, the first bytes
// of each row, the outputs); the work is one test a row walked and a few
// command bytes.  Design (rule_walk.cuh): a group of lanes walks a flow,
// G * V rows a step, each lane's V file_ok bytes one coalesced load turned
// into a bit mask; a lane tests only its rows whose file_ok byte is set,
// in order, and the group's ballot gives the first hit, which is both
// `allow` and `rule` (argmax over bool is the first true).  The rule
// tables (the needle as one 8-byte word, cmd_len and the two flags, and
// the [R, 32] remote ids up to 128 rows) are staged in shared memory once
// a block; the remote set is tested only for a row whose file and command
// already hold (past 128 rows its ids are read from device memory, one
// 128-byte line).  The flow's first min(sp, L, 8) bytes are one 8-byte word
// (one load where the rows are 8-byte aligned), compared with the needle
// under a mask of its first min(sp, 8) bytes.  The reference's window_at
// clips on the CPU and zero-fills on the TPU; this follows the TPU: a
// command byte at or past L reads as 0.
//
// Semantics, per rule r, with s = max(sp[f], 0):
//   cmd = cmd_any[r] | (cmd_len[r] == s and the first min(s, 8) bytes of
//         the row (0 at or past L) equal cmd_needle[r])
//   ok  = any_remote[r] | remotes[f] in remote_ids[r, :]
//   allow[f] = any_r (file_ok[f, r] & cmd & ok); rule[f] = the first
//   such r, else -1.
#include "rule_walk.cuh"

namespace {

using walk::Group;
using walk::kThreads;

constexpr int kMaxCmd = 8;           // models/r2d2.py MAX_CMD
constexpr int kTileRows = 2048;      // rule rows staged at once (32 KB)
constexpr unsigned kCmdAny = 1u, kAnyRemote = 2u;

struct Row {
  unsigned long long needle;  // cmd_needle[r], byte i at bits 8i
  int len;                    // cmd_len[r]
  unsigned flags;             // kCmdAny | kAnyRemote
};

// The launcher's variant (walk::geometry): lanes while F x G stays within
// 65,536 threads or 16 rows a lane take more than 4 steps
// (chip_hits_variants.py's readings, PERF.md).
inline walk::Geometry geometry(int R, int F) { return walk::geometry(R, F, 65536, 16, 4); }

struct Args {
  const uint8_t* data;
  const int32_t* sp;
  const bool* file_ok;  // [F, R]
  const int32_t* remotes;
  const uint8_t* cmd_needle;  // [R, kMaxCmd]
  const int32_t* cmd_len;
  const bool* cmd_any;
  const int32_t* remote_ids;  // [R, kMaxRemotes]
  const bool* any_remote;
  int F, L, R;
  bool* allow;
  int32_t* rule;
  int width;        // walk::load_width of file_ok
  bool head8;       // every row's first 8 bytes are one aligned 8-byte word
  bool needle8;     // cmd_needle is 8-byte aligned
  bool ids16;       // remote_ids is 16-byte aligned
  bool ids_staged;  // the remote ids lie in shared memory (R <= walk::kIdsRows)
  int tile_rows;    // rows staged at once (a multiple of 16)
};

// Rows [r0, r0 + n) of the tables into s_rows.
__device__ void stage(const Args& a, Row* s_rows, int r0, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = r0 + i;
    unsigned long long nd = 0;
    if (a.needle8) {
      nd = __ldg(reinterpret_cast<const unsigned long long*>(a.cmd_needle) + r);
    } else {
#pragma unroll
      for (int k = 0; k < kMaxCmd; ++k)
        nd |= static_cast<unsigned long long>(__ldg(a.cmd_needle + r * kMaxCmd + k)) << (8 * k);
    }
    Row row;
    row.needle = nd;
    row.len = __ldg(a.cmd_len + r);
    row.flags = (walk::flag(a.cmd_any + r) ? kCmdAny : 0u) |
                (walk::flag(a.any_remote + r) ? kAnyRemote : 0u);
    s_rows[i] = row;
  }
}

// What a lane needs of its flow, and the bits of its first step's rows:
// loaded together, before the tables are staged.
struct Flow {
  bool live;  // flows past F ride along: no load, no store
  int f, s, remote;
  unsigned long long head, mask;
  const uint8_t* frow;  // the flow's file_ok row
  unsigned first;       // row_bits of step 0 of tile 0
};

template <int G, int V>
__device__ __forceinline__ Flow load_flow(const Args& a, int t, int q, int n0) {
  Flow fl;
  fl.f = t * (kThreads / G) + static_cast<int>(threadIdx.x) / G;
  fl.live = fl.f < a.F;
  const size_t fi = fl.live ? fl.f : 0;
  fl.frow = reinterpret_cast<const uint8_t*>(a.file_ok) + fi * a.R;
  fl.first = fl.live ? walk::row_bits<V>(fl.frow, q * V, n0, a.width) : 0u;
  const uint8_t* drow = a.data + fi * a.L;
  fl.head = fl.live && a.head8 ? __ldg(reinterpret_cast<const unsigned long long*>(drow)) : 0ull;
  fl.s = fl.live ? max(__ldg(a.sp + fl.f), 0) : 0;
  fl.remote = fl.live ? __ldg(a.remotes + fl.f) : 0;
  // The first min(s, L, 8) bytes of the row, zero past them.
  const int readable = min(min(fl.s, a.L), kMaxCmd);
  if (a.head8) {
    if (readable < kMaxCmd) fl.head &= (1ull << (8 * readable)) - 1ull;
  } else if (fl.live) {
    for (int k = 0; k < readable; ++k)
      fl.head |= static_cast<unsigned long long>(__ldg(drow + k)) << (8 * k);
  }
  fl.mask = fl.s >= kMaxCmd ? ~0ull : (1ull << (8 * fl.s)) - 1ull;
  return fl;
}

template <int G, int V>
__global__ void __launch_bounds__(kThreads) r2d2_hits_kernel(Args a) {
  extern __shared__ int4 smem[];
  int4* s_ids = smem;  // [R, 8] when a.ids_staged
  Row* s_rows = reinterpret_cast<Row*>(smem + (a.ids_staged ? a.R * (walk::kMaxRemotes / 4) : 0));
  const Group<G> g;
  const int rot = threadIdx.x & 7;
  const int tiles = (a.F + kThreads / G - 1) / (kThreads / G);
  const bool one_tile = a.R <= a.tile_rows;
  const int n0 = min(a.tile_rows, a.R);
  Flow fl = load_flow<G, V>(a, blockIdx.x, g.q, n0);
  if (a.ids_staged) walk::stage_ids(a.remote_ids, s_ids, a.R, a.ids16);
  if (one_tile) stage(a, s_rows, 0, a.R);
  __syncthreads();
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    if (t != static_cast<int>(blockIdx.x)) fl = load_flow<G, V>(a, t, g.q, n0);
    int hit = -1;
    for (int r0 = 0; r0 < a.R; r0 += a.tile_rows) {
      const int n = min(a.tile_rows, a.R - r0);
      if (!one_tile) {
        __syncthreads();
        stage(a, s_rows, r0, n);
        __syncthreads();
      }
      unsigned bits = r0 == 0 ? fl.first
                      : fl.live ? walk::row_bits<V>(fl.frow + r0, g.q * V, n, a.width) : 0u;
      for (int base = 0; __any_sync(walk::kFull, fl.live && hit < 0 && base < n); base += G * V) {
        const int c = base + g.q * V;
        // The next step's file_ok bytes go out before this step is tested.
        const bool more = fl.live && hit < 0 && base + G * V < n;
        const unsigned next = more ? walk::row_bits<V>(fl.frow + r0, c + G * V, n, a.width) : 0u;
        int mine = -1;
        if (fl.live && hit < 0) {
          unsigned m = bits;
          while (m) {
            const int r = c + __ffs(m) - 1;
            m &= m - 1;
            const Row row = s_rows[r];
            if (!(row.flags & kCmdAny) &&
                (row.len != fl.s || ((fl.head ^ row.needle) & fl.mask) != 0))
              continue;
            const size_t gr = static_cast<size_t>(r0 + r);
            if ((row.flags & kAnyRemote) ||
                (a.ids_staged ? walk::remote_in_shared(s_ids + gr * 8, fl.remote, rot)
                              : walk::remote_in(a.remote_ids + gr * walk::kMaxRemotes, fl.remote,
                                                a.ids16))) {
              mine = r0 + r;
              break;
            }
          }
        }
        bits = next;
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
    auto kernel = r2d2_hits_kernel<G, V>;
    Args args = a;
    args.width = walk::load_width(V, a.R, a.file_ok);
    args.ids_staged = a.R <= walk::kIdsRows;
    const size_t smem = (args.ids_staged ? static_cast<size_t>(a.R) * walk::kMaxRemotes * 4 : 0) +
                        static_cast<size_t>(std::min(a.R, a.tile_rows)) * sizeof(Row);
    const int tiles = (a.F + kThreads / G - 1) / (kThreads / G);
    int blocks = 0;
    cudaError_t err = walk::grid_for(kernel, tiles, smem, &blocks);
    if (err != cudaSuccess) return err;
    kernel<<<blocks, kThreads, smem, stream>>>(args);
    return cudaGetLastError();
  }
};

Launch make_launch(const void* data, const void* sp, const void* file_ok, const void* remotes,
                   const void* cmd_needle, const void* cmd_len, const void* cmd_any,
                   const void* remote_ids, const void* any_remote, int F, int L, int R,
                   void* allow, void* rule, void* stream) {
  Args a;
  a.data = static_cast<const uint8_t*>(data);
  a.sp = static_cast<const int32_t*>(sp);
  a.file_ok = static_cast<const bool*>(file_ok);
  a.remotes = static_cast<const int32_t*>(remotes);
  a.cmd_needle = static_cast<const uint8_t*>(cmd_needle);
  a.cmd_len = static_cast<const int32_t*>(cmd_len);
  a.cmd_any = static_cast<const bool*>(cmd_any);
  a.remote_ids = static_cast<const int32_t*>(remote_ids);
  a.any_remote = static_cast<const bool*>(any_remote);
  a.F = F;
  a.L = L;
  a.R = R;
  a.allow = static_cast<bool*>(allow);
  a.rule = static_cast<int32_t*>(rule);
  a.width = 1;
  a.head8 = L >= kMaxCmd && L % 8 == 0 && reinterpret_cast<uintptr_t>(data) % 8 == 0;
  a.needle8 = reinterpret_cast<uintptr_t>(cmd_needle) % 8 == 0;
  a.ids16 = reinterpret_cast<uintptr_t>(remote_ids) % 16 == 0;
  a.ids_staged = false;
  a.tile_rows = kTileRows;
  return Launch{a, static_cast<cudaStream_t>(stream)};
}

}  // namespace

// The (lanes, rows a lane a step) a launch takes for R rules and F flows,
// packed as lanes | rows << 8 (kernels.hits_variant).
CILIUM_EXPORT int hits_variant(int R, int F) { return walk::packed(geometry(R, F)); }

CILIUM_EXPORT int r2d2_hits(const void* data, const void* sp,
                            const void* file_ok, const void* remotes,
                            const void* cmd_needle, const void* cmd_len,
                            const void* cmd_any, const void* remote_ids,
                            const void* any_remote, int F, int L, int R,
                            void* allow, void* rule, void* stream) {
  if (F <= 0) return cudaSuccess;
  const Launch launch = make_launch(data, sp, file_ok, remotes, cmd_needle, cmd_len, cmd_any,
                                    remote_ids, any_remote, F, L, R, allow, rule, stream);
  return walk::dispatch(geometry(R, F), launch);
}
