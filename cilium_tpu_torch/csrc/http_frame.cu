// K5 http_frame: frame one HTTP request head per flow row and tokenize its
// request line.
//
// Replaces the framing half of cilium_tpu/models/http.py:425
// (_http_rule_hits, :440-449) and the reductions it calls: _first_crlfcrlf
// (:539), first_subsequence2 and first_occurrence
// (cilium_tpu/ops/bytescan.py:29, :19), _first_occurrence_after (:385), and
// _last_in_span (:394) for the two literal slots (:409).  On the TPU each
// was a full [F, L] masked min/max.
//
// Bound on the H100: bytes.  The work is a few compares per byte, so the
// floor is reading each row up to its head end once (the 32-byte sectors
// up to min(head_len, len)).  Design (frame_scan.cuh): a group of lanes
// owns a row and each lane reads 16 bytes a load, so a batch of short
// heads is in flight at once and a 32 KB head takes tens of dependent
// steps; the row's first bytes are loaded before its length arrives.  One
// pass: each lane turns its chunk into CRLF, CRLFCRLF, space and LF masks,
// and the group settles every output from them, carrying its state from
// step to step; the scan ends at the CRLFCRLF.  Nothing is re-read.
//
// Semantics ("not found" is the bound, cilium_tpu/ops/bytescan.py:9-10):
//   crlf2     = first CRLFCRLF at pos with pos + 3 < len, else len
//   complete  = crlf2 < len,  head_len = crlf2 + 4
//   line_end  = first CRLF at pos with pos + 1 < len, else len
//   sp1       = first 0x20 in [0, line_end), else line_end
//   sp2       = first 0x20 in (sp1, line_end), else line_end
//   last_nl_m = last 0x0A in [0, sp1), else -1
//   last_nl_p = last 0x0A in [sp1 + 1, sp2), else -1
#include "frame_scan.cuh"

namespace {

using frame::Group;
using frame::kInf;
using frame::kThreads;

template <int G, int V, bool A>
__global__ void __launch_bounds__(kThreads)
http_frame_kernel(const uint8_t* __restrict__ data, const int32_t* __restrict__ lengths, int F,
                  int L, int32_t* __restrict__ crlf2_out, bool* __restrict__ complete_out,
                  int32_t* __restrict__ head_len_out, int32_t* __restrict__ line_end_out,
                  int32_t* __restrict__ sp1_out, int32_t* __restrict__ sp2_out,
                  int32_t* __restrict__ last_nl_m_out, int32_t* __restrict__ last_nl_p_out) {
  constexpr int S = 16 * G * V;
  const Group<G> g;
  const int f = blockIdx.x * (kThreads / G) + static_cast<int>(threadIdx.x) / G;
  const bool ok = f < F;  // rows past F ride along: no load, no store
  const uint8_t* row = data + static_cast<size_t>(ok ? f : 0) * L;

  // The row's first kEager bytes go out with the length load.
  const int len = ok ? lengths[f] : 0;
  uint4 cur[V], nxt[V];
#pragma unroll
  for (int v = 0; v < V; ++v)
    cur[v] = frame::load16<A>(row, frame::chunk<G>(0, v, g.q), ok ? min(L, frame::kEager) : 0, L);
  const int n = max(0, min(len, L));
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int c = frame::chunk<G>(0, v, g.q);
    if (c >= frame::kEager) cur[v] = frame::load16<A>(row, c, n, L);
  }

  // kInf: not found yet.  sp1 is settled once a space or the line end is
  // seen, sp2 once a second space or the line end is.
  int line_end = kInf, head = kInf, sp1 = kInf, sp2 = kInf;
  int last_m = -1, last_p = -1;
  for (int base = 0;; base += S) {
    const bool more = head == kInf && base + S < n;
#pragma unroll
    for (int v = 0; v < V; ++v)
      nxt[v] = frame::load16<A>(row, frame::chunk<G>(base + S, v, g.q), more ? n : 0, L);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int c = frame::chunk<G>(base, v, g.q);
      unsigned w[5];
      frame::words<G, V>(g, cur, nxt, v, w);
      const unsigned crlf = frame::crlf_mask(w);

      // The first CRLF and the first CRLFCRLF (a CRLF two bytes on).
      const unsigned cm = crlf & frame::below(n - 1 - c);
      const unsigned cb = g.ballot(cm != 0);
      const int line_hit = g.lowest(c + __ffs(cm) - 1, cb);
      if (line_end == kInf && cb) line_end = line_hit;
      const unsigned hm = crlf & (crlf >> 2) & frame::below(n - 3 - c);
      const unsigned hb = g.ballot(hm != 0);
      const int head_hit = g.lowest(c + __ffs(hm) - 1, hb);
      if (head == kInf && hb) head = head_hit;

      // Spaces and LFs count only up to the line end: skipped once every
      // row of the warp has its line end before this chunk.
      if (!__any_sync(frame::kFull, line_end >= frame::chunk<G>(base, v, 0))) continue;

      // The first two spaces before the line end: the group's first, and
      // the second bit of that lane or else the next lane's first.
      const unsigned sm = frame::byte_mask(w, frame::kSP) & frame::below(min(line_end, n) - c);
      const unsigned sb = g.ballot(sm != 0);
      const unsigned rest = sm & (sm - 1);
      const int first = c + __ffs(sm) - 1;
      const int t1 = g.lowest(first, sb);
      const int t2_lane = g.lowest(rest ? c + __ffs(rest) - 1 : kInf, sb);
      const int t2_next = g.lowest(first, sb & (sb - 1));
      const int t2 = t2_lane != kInf ? t2_lane : (sb & (sb - 1)) ? t2_next : kInf;
      if (sb) {
        if (sp1 == kInf) {
          sp1 = t1;
          sp2 = t2;
        } else if (sp2 == kInf) {
          sp2 = t1;
        }
      }

      // The last LF in [0, sp1) and in [sp1 + 1, sp2), as far as each is settled.
      const unsigned lm = frame::byte_mask(w, frame::kLF) & frame::below(n - c);
      const int e1 = sp1 != kInf ? sp1 : line_end;
      const int e2 = sp2 != kInf ? sp2 : line_end;
      const int s2 = sp1 != kInf ? sp1 + 1 : kInf;
      const unsigned m1 = lm & frame::below(e1 - c);
      const unsigned m2 = lm & frame::below(e2 - c) & ~frame::below(s2 - c);
      const unsigned b1 = g.ballot(m1 != 0);
      const unsigned b2 = g.ballot(m2 != 0);
      const int l1 = g.highest(c + 31 - __clz(m1), b1);
      const int l2 = g.highest(c + 31 - __clz(m2), b2);
      if (b1) last_m = l1;
      if (b2) last_p = l2;
    }
    if (!__any_sync(frame::kFull, more && head == kInf)) break;
#pragma unroll
    for (int v = 0; v < V; ++v) cur[v] = nxt[v];
  }

  if (ok && g.q == 0) {
    const int le = line_end != kInf ? line_end : len;
    const int h = head != kInf ? head : len;
    crlf2_out[f] = h;
    complete_out[f] = h < len;
    head_len_out[f] = h + 4;
    line_end_out[f] = le;
    sp1_out[f] = sp1 != kInf ? sp1 : le;
    sp2_out[f] = sp2 != kInf ? sp2 : le;
    last_nl_m_out[f] = last_m;
    last_nl_p_out[f] = last_p;
  }
}

struct Launch {
  const void* data;
  const void* lengths;
  int F, L;
  void *crlf2, *complete, *head_len, *line_end, *sp1, *sp2, *last_nl_m, *last_nl_p;
  cudaStream_t stream;

  template <int G, int V, bool A>
  cudaError_t run() const {
    const int rows = kThreads / G;
    http_frame_kernel<G, V, A><<<(F + rows - 1) / rows, kThreads, 0, stream>>>(
        static_cast<const uint8_t*>(data), static_cast<const int32_t*>(lengths), F, L,
        static_cast<int32_t*>(crlf2), static_cast<bool*>(complete),
        static_cast<int32_t*>(head_len), static_cast<int32_t*>(line_end),
        static_cast<int32_t*>(sp1), static_cast<int32_t*>(sp2),
        static_cast<int32_t*>(last_nl_m), static_cast<int32_t*>(last_nl_p));
    return cudaGetLastError();
  }
};

}  // namespace

CILIUM_EXPORT int http_frame(const void* data, const void* lengths, int F,
                             int L, void* crlf2, void* complete,
                             void* head_len, void* line_end, void* sp1,
                             void* sp2, void* last_nl_m, void* last_nl_p,
                             void* stream) {
  if (F <= 0) return cudaSuccess;
  const Launch launch{data,     lengths, F,   L,         crlf2,     complete, head_len,
                      line_end, sp1,     sp2, last_nl_m, last_nl_p, static_cast<cudaStream_t>(stream)};
  return frame::dispatch(frame::geometry(L, F, data), launch);
}
