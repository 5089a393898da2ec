// K6 http_lit: the HTTP literal tier on the method and path spans.
//
// Replaces cilium_tpu/models/http.py:403 (_lit_hits, with
// spans_equal_prefix and spans_start_with, cilium_tpu/ops/bytescan.py:112,
// :129, and their window_at/_spans_compare), :417 (_scatter_or) and the
// wildcard flags at :452-462.  The TPU version windowed every span's first
// LIT_W bytes (a barrel shifter, since gathers serialize there), compared
// them with every needle as an [F, N, W] tensor and scatter-added the
// [F, N] hits onto [F, R] rules.
//
// Bound on the H100: bytes, nearly all of them the two [F, R] bool
// outputs (409.6 MB at F = 2,048, R = 100,000); the compares are one per
// needle byte of each row whose length test passes.  Design: a 2-D grid
// of (rule tile, flow tile) blocks, so a 100,000-rule table at F = 2,048
// runs on thousands of blocks.  A block first packs its flows' spans and
// span windows into shared memory: the first bytes of each span as
// words, zero past min(span length, 64), only as many words as the slot's
// needles can reach (W / 4: 2 at rules_100k), one thread a (flow, word) so
// a warp reads a row's span bytes in order.  Then each thread owns 4
// consecutive rules: it reads their per-rule lists of live rows (a CSR
// built with the model) once and keeps, per slot, each rule's first row
// and a 4-byte length gate in registers.  For each flow of the block one
// SIMD byte compare (__vcmpeq4 / __vcmpgeu4) of the span length against
// the 4 first rows' lengths decides which rules need more than that; only
// those read their needle words (a few masked word XORs that touch no
// byte outside [start, start + nlen)) or their further rows.  The 4 rules'
// method_ok and path_ok bytes (the wildcard flag OR a hit of one of the
// rule's rows) are written once, after their hits are known, as one
// 32-bit store each where the outputs' rows are 4-aligned; consecutive
// threads own consecutive rules, so a warp's stores are contiguous.  The
// rule tile's width follows R (a template: 1, 2 or 4 threads along the
// rules up to 16 rules, else 64), so at R of order 10 the threads stay on
// flows.
//
// Semantics (cilium_tpu/models/http.py:403-414, bytescan.py:84-109):
//   span_len = max(end - start, 0)
//   exact row:  span_len == nlen and span[0, nlen) == needle
//   prefix row: span_len >= nlen and span[0, nlen) == needle and
//               last_nl < start + nlen (no LF in the ".*" remainder)
//   a dead row (live false) never hits; bytes at or past L read as 0.
//   method_ok[f, r] = method_any[r] | any hit of a method row of rule r
//   path_ok[f, r]   = path_any[r]   | any hit of a path row of rule r
// with the method span [0, sp1) and the path span [sp1 + 1, sp2).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLitW = 64;  // models/http.py LIT_W
constexpr int kWords = kLitW / 4;
constexpr int kWinStride = kWords + 1;  // + 1 spreads flows over the banks
constexpr int kMaxTR = 64;              // threads along the rules, at most

// One span's literal rows and the per-rule list of its live rows.
struct Slot {
  const uint32_t* needle;  // [N, wpr] words, zero-padded past nlen
  const int32_t* len;      // [N]
  const bool* prefix;      // [N]
  const int32_t* ptr;      // [R + 1]
  const int32_t* idx;      // the live rows of rule r: idx[ptr[r], ptr[r + 1])
  const bool* any;         // [R], the field was omitted
  int wpr;                 // needle words a row
};

constexpr int kPrefix = 1 << 16;
constexpr int kAny = 1 << 17;    // the field was omitted: the rule holds
constexpr int kRows = 1 << 18;   // the rule has a live row
constexpr int kMulti = 1 << 19;  // ... and more than one

// A thread's 4 rules in one slot, kept in registers: each rule's first
// live row, and a gate, one byte a rule, that a flow's span length must
// pass before anything else is read.  The gate compares the span length
// (at most 255: needles are at most 64 bytes) with the 4 first rows'
// nlen at once, equal for an exact row and at least for a prefix row;
// a rule with an omitted field or several rows always passes it.
struct Quad {
  unsigned lo4;      // the first rows' nlen, a byte a rule
  unsigned exact4;   // 0xff where that row is an exact row
  unsigned prefix4;  // 0xff where it is a prefix row
  unsigned always4;  // 0xff where the length alone cannot decide
  int row[4];        // the first live row, idx[ptr[r]]
  int info[4];       // its nlen | kPrefix, and kAny / kRows / kMulti
};

__device__ __forceinline__ bool ldg_bool(const bool* p) {
  return __ldg(reinterpret_cast<const unsigned char*>(p)) != 0;
}

__device__ __forceinline__ int row_info(const Slot& s, int i) {
  return (__ldg(s.len + i) & 0xFFFF) | (ldg_bool(s.prefix + i) ? kPrefix : 0);
}

__device__ __forceinline__ Quad load_quad(const Slot& s, int r0, int R) {
  Quad qd{0u, 0u, 0u, 0u, {0, 0, 0, 0}, {0, 0, 0, 0}};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = r0 + q;
    if (r >= R) continue;  // past the table: the gate passes nothing
    const int k0 = __ldg(s.ptr + r);
    const int n = __ldg(s.ptr + r + 1) - k0;
    int info = ldg_bool(s.any + r) ? kAny : 0;
    if (n > 0) {
      qd.row[q] = __ldg(s.idx + k0);
      info |= row_info(s, qd.row[q]) | kRows | (n > 1 ? kMulti : 0);
    }
    qd.info[q] = info;
    const unsigned byte = 0xffu << (8 * q);
    if (info & (kAny | kMulti)) {
      qd.always4 |= byte;
    } else if (n > 0) {
      qd.lo4 |= static_cast<unsigned>(info & 0xFF) << (8 * q);
      if (info & kPrefix) qd.prefix4 |= byte;
      else qd.exact4 |= byte;
    }
  }
  return qd;
}

struct Span {
  int len, start, last_nl;
};

__device__ __forceinline__ bool row_hit(int info, const uint32_t* __restrict__ nw,
                                        const uint32_t* __restrict__ win, Span sp) {
  const int nlen = info & 0xFFFF;
  const bool prefix = info & kPrefix;
  if (prefix ? sp.len < nlen : sp.len != nlen) return false;
  if (prefix && sp.last_nl >= sp.start + nlen) return false;
  for (int j = 0; 4 * j < nlen; ++j) {
    const int left = nlen - 4 * j;
    const uint32_t mask = left >= 4 ? 0xffffffffu : (1u << (8 * left)) - 1u;
    if ((win[j] ^ __ldg(nw + j)) & mask) return false;
  }
  return true;
}

// Rule r's byte for one flow: the wildcard flag OR a hit of its rows.
__device__ __forceinline__ bool rule_hit(int row, int info, const Slot& s, int r,
                                         const uint32_t* __restrict__ win, Span sp) {
  if (info & kAny) return true;
  if (!(info & kRows)) return false;
  if (row_hit(info, s.needle + static_cast<size_t>(row) * s.wpr, win, sp)) return true;
  if (info & kMulti) {
    const int k1 = __ldg(s.ptr + r + 1);
    for (int k = __ldg(s.ptr + r) + 1; k < k1; ++k) {
      const int i = __ldg(s.idx + k);
      if (row_hit(row_info(s, i), s.needle + static_cast<size_t>(i) * s.wpr, win, sp)) return true;
    }
  }
  return false;
}

// The 4 rules' bytes (0 or 1 each) for one flow's span in one slot.
__device__ __forceinline__ uint32_t quad_hits(const Quad& qd, const Slot& s, int r0,
                                              const uint32_t* __restrict__ win, Span sp) {
  const unsigned l4 = static_cast<unsigned>(min(sp.len, 255)) * 0x01010101u;
  const unsigned gate = (__vcmpeq4(l4, qd.lo4) & qd.exact4) |
                        (__vcmpgeu4(l4, qd.lo4) & qd.prefix4) | qd.always4;
  uint32_t out = 0u;
  if (gate) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if ((gate >> (8 * q)) & 0xffu)
        out |= static_cast<uint32_t>(rule_hit(qd.row[q], qd.info[q], s, r0 + q, win, sp)) << (8 * q);
  }
  return out;
}

// Flows a block covers with TR threads along the rules: at least one a
// thread along the flows.
template <int TR>
__host__ __device__ constexpr int flow_tile() {
  return TR == kMaxTR ? 128 : (kThreads / TR > 64 ? kThreads / TR : 64);
}

// TR threads along the rules (4 rules each), kThreads / TR along the
// flows; a block covers 4 TR rules of flow_tile<TR>() flows.
template <int TR>
__global__ void __launch_bounds__(kThreads) http_lit_kernel(
    const uint8_t* __restrict__ data, const int32_t* __restrict__ sp1,
    const int32_t* __restrict__ sp2, const int32_t* __restrict__ last_nl_m,
    const int32_t* __restrict__ last_nl_p, Slot m, Slot p, int F, int L, int R,
    bool vec, bool* __restrict__ method_ok, bool* __restrict__ path_ok) {
  constexpr int TF = kThreads / TR;
  constexpr int FT = flow_tile<TR>();
  __shared__ uint32_t s_win[FT][2][kWinStride];
  __shared__ Span s_span[FT][2];

  // 1. The block's flows' spans, then their windows: only the words a
  // slot's needles can reach (its width W / 4), one thread a (flow, word),
  // so a warp reads a row's span bytes in order.
  const int f0 = blockIdx.y * FT;
  for (int item = threadIdx.x; item < 2 * FT; item += kThreads) {
    const int i = item >> 1;
    const int slot = item & 1;
    const int f = f0 + i;
    if (f < F) {
      const int s1 = __ldg(sp1 + f);
      const int start = slot ? s1 + 1 : 0;
      const int end = slot ? __ldg(sp2 + f) : s1;
      s_span[i][slot] = Span{max(end - start, 0), start, __ldg((slot ? last_nl_p : last_nl_m) + f)};
    }
  }
  __syncthreads();
  const int wpf = m.wpr + p.wpr;  // window words a flow
#pragma unroll 4
  for (int item = threadIdx.x; item < FT * wpf; item += kThreads) {
    const int i = item / wpf;
    const int slot = item % wpf >= m.wpr;
    const int j = item % wpf - (slot ? m.wpr : 0);
    const int f = f0 + i;
    uint32_t w = 0u;
    if (f < F) {
      const Span sp = s_span[i][slot];
      const int avail = min(sp.len, kLitW);
      const uint8_t* row = data + static_cast<size_t>(f) * L + sp.start;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int b = 4 * j + q;
        if (b < avail && sp.start + b < L) w |= static_cast<uint32_t>(row[b]) << (8 * q);
      }
    }
    s_win[i][slot][j] = w;
  }

  // 2. This thread's 4 rules, read once.
  const int tr = threadIdx.x % TR;
  const int tf = threadIdx.x / TR;
  const int r0 = (blockIdx.x * TR + tr) * 4;
  const Quad qm = load_quad(m, r0, R);
  const Quad qp = load_quad(p, r0, R);
  __syncthreads();
  if (r0 >= R) return;

  // 3. Each flow of the tile: the 4 rules' bytes, each written once.
  for (int i = tf; i < FT; i += TF) {
    const int f = f0 + i;
    if (f >= F) break;
    const uint32_t mw = quad_hits(qm, m, r0, s_win[i][0], s_span[i][0]);
    const uint32_t pw = quad_hits(qp, p, r0, s_win[i][1], s_span[i][1]);
    const size_t at = static_cast<size_t>(f) * R + r0;
    if (vec) {
      *reinterpret_cast<uint32_t*>(method_ok + at) = mw;
      *reinterpret_cast<uint32_t*>(path_ok + at) = pw;
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (r0 + q < R) {
          method_ok[at + q] = (mw >> (8 * q)) & 1u;
          path_ok[at + q] = (pw >> (8 * q)) & 1u;
        }
      }
    }
  }
}

template <int TR>
cudaError_t launch(const uint8_t* data, const int32_t* sp1, const int32_t* sp2,
                   const int32_t* last_nl_m, const int32_t* last_nl_p, const Slot& m,
                   const Slot& p, int F, int L, int R, bool vec, bool* method_ok,
                   bool* path_ok, cudaStream_t stream) {
  constexpr int FT = flow_tile<TR>();
  const long long flow_tiles = (F + FT - 1) / FT;
  const long long rule_tiles = (static_cast<long long>(R) + 4 * TR - 1) / (4 * TR);
  if (flow_tiles > 65535 || rule_tiles > 0x7fffffff) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(rule_tiles), static_cast<unsigned>(flow_tiles));
  http_lit_kernel<TR><<<grid, kThreads, 0, stream>>>(
      data, sp1, sp2, last_nl_m, last_nl_p, m, p, F, L, R, vec, method_ok, path_ok);
  return cudaGetLastError();
}

}  // namespace

CILIUM_EXPORT int http_lit(
    const void* data, const void* sp1, const void* sp2, const void* last_nl_m,
    const void* last_nl_p, const void* m_needle, const void* m_len,
    const void* m_prefix, const void* m_ptr, const void* m_idx, int Wm,
    const void* p_needle, const void* p_len, const void* p_prefix,
    const void* p_ptr, const void* p_idx, int Wp, const void* method_any,
    const void* path_any, int F, int L, int R, void* method_ok, void* path_ok,
    void* stream) {
  if (F <= 0) return cudaSuccess;
  if (Wm % 8 || Wp % 8 || Wm > kLitW || Wp > kLitW || R < 1 || L < 0)
    return cudaErrorInvalidValue;
  const Slot m{static_cast<const uint32_t*>(m_needle), static_cast<const int32_t*>(m_len),
               static_cast<const bool*>(m_prefix), static_cast<const int32_t*>(m_ptr),
               static_cast<const int32_t*>(m_idx), static_cast<const bool*>(method_any),
               Wm / 4};
  const Slot p{static_cast<const uint32_t*>(p_needle), static_cast<const int32_t*>(p_len),
               static_cast<const bool*>(p_prefix), static_cast<const int32_t*>(p_ptr),
               static_cast<const int32_t*>(p_idx), static_cast<const bool*>(path_any),
               Wp / 4};
  // 32-bit stores where every output row starts 4-aligned.
  const bool vec = R % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(method_ok) | reinterpret_cast<uintptr_t>(path_ok)) % 4 == 0;
  // Up to 16 rules, just enough threads along them (4 rules each); above
  // that, a whole rule tile.
  const int tr = R <= 4 ? 1 : R <= 8 ? 2 : R <= 16 ? 4 : kMaxTR;
  const auto* d = static_cast<const uint8_t*>(data);
  const auto* s1 = static_cast<const int32_t*>(sp1);
  const auto* s2 = static_cast<const int32_t*>(sp2);
  const auto* nm = static_cast<const int32_t*>(last_nl_m);
  const auto* np = static_cast<const int32_t*>(last_nl_p);
  auto* mo = static_cast<bool*>(method_ok);
  auto* po = static_cast<bool*>(path_ok);
  auto st = static_cast<cudaStream_t>(stream);
  switch (tr) {
    case 1: return launch<1>(d, s1, s2, nm, np, m, p, F, L, R, vec, mo, po, st);
    case 2: return launch<2>(d, s1, s2, nm, np, m, p, F, L, R, vec, mo, po, st);
    case 4: return launch<4>(d, s1, s2, nm, np, m, p, F, L, R, vec, mo, po, st);
    default: return launch<64>(d, s1, s2, nm, np, m, p, F, L, R, vec, mo, po, st);
  }
}
