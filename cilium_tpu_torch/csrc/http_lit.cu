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
// Bound on the H100: at the shapes of this slice, bytes (the [F, R]
// outputs and the few span bytes each flow needs); the compares are one
// per needle byte per live row.  Design: one thread per flow.  The
// needles (as 32-bit words) and one 8-byte meta entry per row pass
// through shared memory in tiles of at most kSmemBudget bytes, each read
// by a whole warp at one address (a broadcast); a table of any size
// (the rule-sharded 100k-rule tables hold 25,000 rows a slot) takes as
// many tiles as it needs.  Each thread packs the first min(span length,
// 64) bytes of its span into 16 register words once per slot, so a row's
// compare is a few masked word XORs and touches no byte outside
// [start, start + nlen).  A hit stores true into its rule's output byte;
// several rows of one rule store the same value, which is the reference's
// OR of summed duplicates.
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

constexpr int kThreads = 128;
constexpr int kLitW = 64;  // models/http.py LIT_W
constexpr int kWords = kLitW / 4;
// Shared memory one tile of rows may take (meta + needles).
constexpr size_t kSmemBudget = 96 * 1024;

struct RowMeta {
  int32_t rule;
  int32_t info;  // nlen | prefix << 16 | live << 17
};

__device__ __forceinline__ void pack_window(const uint8_t* __restrict__ row,
                                            int L, int start, int avail,
                                            uint32_t (&win)[kWords]) {
#pragma unroll
  for (int j = 0; j < kWords; ++j) win[j] = 0u;
#pragma unroll
  for (int i = 0; i < kLitW; ++i) {
    if (i < avail) {
      const int idx = start + i;
      const uint32_t b = idx < L ? row[idx] : 0u;
      win[i >> 2] |= b << (8 * (i & 3));
    }
  }
}

__device__ __forceinline__ void tile_hits(
    const uint32_t (&win)[kWords], int span_len, int start, int last_nl,
    const RowMeta* __restrict__ meta, const uint32_t* __restrict__ needle,
    int n_rows, int words_per_row, bool* __restrict__ out) {
  for (int k = 0; k < n_rows; ++k) {
    const RowMeta mk = meta[k];
    const int nlen = mk.info & 0xFFFF;
    const bool prefix = (mk.info >> 16) & 1;
    const bool live = (mk.info >> 17) & 1;
    if (!live) continue;
    if (prefix ? span_len < nlen : span_len != nlen) continue;
    if (prefix && last_nl >= start + nlen) continue;
    const uint32_t* nw = needle + k * words_per_row;
    bool eq = true;
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      const int left = nlen - 4 * j;
      if (left > 0) {
        const uint32_t mask = left >= 4 ? 0xffffffffu : (1u << (8 * left)) - 1u;
        if ((win[j] ^ nw[j]) & mask) eq = false;
      }
    }
    if (eq) out[mk.rule] = true;
  }
}

__global__ void http_lit_kernel(
    const uint8_t* __restrict__ data, const int32_t* __restrict__ sp1,
    const int32_t* __restrict__ sp2, const int32_t* __restrict__ last_nl_m,
    const int32_t* __restrict__ last_nl_p,
    const uint8_t* __restrict__ m_needle, const int32_t* __restrict__ m_len,
    const bool* __restrict__ m_prefix, const int32_t* __restrict__ m_rule,
    const bool* __restrict__ m_live, int Nm, int Wm,
    const uint8_t* __restrict__ p_needle, const int32_t* __restrict__ p_len,
    const bool* __restrict__ p_prefix, const int32_t* __restrict__ p_rule,
    const bool* __restrict__ p_live, int Np, int Wp,
    const bool* __restrict__ method_any, const bool* __restrict__ path_any,
    int F, int L, int R, int tile, bool* __restrict__ method_ok,
    bool* __restrict__ path_ok) {
  extern __shared__ uint32_t smem[];
  RowMeta* s_meta = reinterpret_cast<RowMeta*>(smem);  // [tile]
  uint32_t* s_needle = smem + 2 * tile;                 // [tile, W / 4]

  // Threads past F load tiles with the others and compare nothing.
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = f < F;
  const size_t fi = valid ? static_cast<size_t>(f) : 0;
  const uint8_t* row = data + fi * L;
  if (valid) {
    for (int r = 0; r < R; ++r) {
      method_ok[fi * R + r] = method_any[r];
      path_ok[fi * R + r] = path_any[r];
    }
  }
  const int s1 = valid ? sp1[fi] : 0;
  for (int slot = 0; slot < 2; ++slot) {
    const bool is_m = slot == 0;
    const int n_all = is_m ? Nm : Np;
    const int wpr = (is_m ? Wm : Wp) / 4;
    const uint8_t* g_needle = is_m ? m_needle : p_needle;
    const int32_t* g_len = is_m ? m_len : p_len;
    const bool* g_prefix = is_m ? m_prefix : p_prefix;
    const int32_t* g_rule = is_m ? m_rule : p_rule;
    const bool* g_live = is_m ? m_live : p_live;
    const int start = is_m ? 0 : s1 + 1;
    const int end = valid ? (is_m ? s1 : sp2[fi]) : 0;
    const int last_nl = valid ? (is_m ? last_nl_m[fi] : last_nl_p[fi]) : 0;
    const int span_len = max(end - start, 0);
    uint32_t win[kWords];
    pack_window(row, L, start, valid ? min(span_len, kLitW) : 0, win);
    bool* out = (is_m ? method_ok : path_ok) + fi * R;
    for (int base = 0; base < n_all; base += tile) {
      const int n = min(tile, n_all - base);
      __syncthreads();  // the previous tile's compares are done
      for (int k = threadIdx.x; k < n; k += blockDim.x) {
        const int i = base + k;
        s_meta[k].rule = g_rule[i];
        s_meta[k].info = (g_len[i] & 0xFFFF) | (g_prefix[i] ? 1 << 16 : 0) |
                         (g_live[i] ? 1 << 17 : 0);
      }
      const uint32_t* gw =
          reinterpret_cast<const uint32_t*>(g_needle) + static_cast<size_t>(base) * wpr;
      for (int i = threadIdx.x; i < n * wpr; i += blockDim.x) s_needle[i] = gw[i];
      __syncthreads();
      if (valid) tile_hits(win, span_len, start, last_nl, s_meta, s_needle, n, wpr, out);
    }
  }
}

}  // namespace

CILIUM_EXPORT int http_lit(
    const void* data, const void* sp1, const void* sp2, const void* last_nl_m, const void* last_nl_p, const void* m_needle,
    const void* m_len, const void* m_prefix, const void* m_rule,
    const void* m_live, int Nm, int Wm, const void* p_needle,
    const void* p_len, const void* p_prefix, const void* p_rule,
    const void* p_live, int Np, int Wp, const void* method_any,
    const void* path_any, int F, int L, int R, void* method_ok, void* path_ok,
    void* stream) {
  if (F <= 0) return cudaSuccess;
  if (Wm % 8 || Wp % 8 || Wm > kLitW || Wp > kLitW || Nm < 0 || Np < 0)
    return cudaErrorInvalidValue;
  const size_t per_row = sizeof(RowMeta) + static_cast<size_t>(std::max(Wm, Wp));
  const int tile = static_cast<int>(
      std::min<size_t>(std::max(std::max(Nm, Np), 1), kSmemBudget / per_row));
  const size_t smem = static_cast<size_t>(tile) * per_row;
  cudaError_t err = allow_smem(http_lit_kernel, smem);
  if (err != cudaSuccess) return err;
  http_lit_kernel<<<(F + kThreads - 1) / kThreads, kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<const int32_t*>(sp1),
      static_cast<const int32_t*>(sp2), static_cast<const int32_t*>(last_nl_m),
      static_cast<const int32_t*>(last_nl_p),
      static_cast<const uint8_t*>(m_needle), static_cast<const int32_t*>(m_len),
      static_cast<const bool*>(m_prefix), static_cast<const int32_t*>(m_rule),
      static_cast<const bool*>(m_live), Nm, Wm,
      static_cast<const uint8_t*>(p_needle), static_cast<const int32_t*>(p_len),
      static_cast<const bool*>(p_prefix), static_cast<const int32_t*>(p_rule),
      static_cast<const bool*>(p_live), Np, Wp,
      static_cast<const bool*>(method_any), static_cast<const bool*>(path_any),
      F, L, R, tile, static_cast<bool*>(method_ok), static_cast<bool*>(path_ok));
  return cudaGetLastError();
}
