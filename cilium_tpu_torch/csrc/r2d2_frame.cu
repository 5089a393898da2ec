// K1 r2d2_frame: frame and tokenize one r2d2 message per flow row.
//
// Replaces the framing half of cilium_tpu/models/r2d2.py:211
// (_r2d2_rule_hits) and the bytescan reductions it calls:
// first_subsequence2 (cilium_tpu/ops/bytescan.py:29), first_occurrence
// (:19) and count_byte (:44).  On the TPU each was a full [F, L] masked
// min/sum.
//
// Bound on the H100: bytes.  The work is a compare per byte, so the floor
// is reading each row up to its first CRLF once (the 32-byte sectors up
// to min(crlf + 2, len)).  Design (frame_scan.cuh): a group of lanes owns
// a row and each lane reads 16 bytes a load, so a batch of short rows is
// in flight at once and a long row takes few dependent steps; the row's
// first bytes are loaded before its length arrives.  One pass: each lane
// turns its chunk into CRLF and space masks; the group's first CRLF ends
// the scan, and the spaces before it give the first space and the count
// (saturated at 2).  Nothing is re-read.
//
// Semantics (cilium_tpu/ops/bytescan.py:9-10, :39): "not found" is the
// bound; a CRLF counts only when pos + 1 < len.
//   crlf     = first CRLF at pos with pos + 1 < len, else len
//   complete = crlf < len,  msg_len = crlf + 2
//   sp       = first 0x20 in [0, crlf), else crlf
//   file     = (sp + 1, crlf) when exactly one 0x20 in [0, crlf), else (0, 0)
#include "frame_scan.cuh"

namespace {

using frame::Group;
using frame::kThreads;

template <int G, int V, bool A>
__global__ void __launch_bounds__(kThreads)
r2d2_frame_kernel(const uint8_t* __restrict__ data, const int32_t* __restrict__ lengths, int F,
                  int L, int32_t* __restrict__ crlf_out, bool* __restrict__ complete_out,
                  int32_t* __restrict__ msg_len_out, int32_t* __restrict__ sp_out,
                  int32_t* __restrict__ file_start_out, int32_t* __restrict__ file_end_out) {
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

  bool found = false;  // the first CRLF
  int crlf = 0;
  int sp = 0;
  int spaces = 0;  // saturates at 2
  for (int base = 0;; base += S) {
    const bool more = !found && base + S < n;
#pragma unroll
    for (int v = 0; v < V; ++v)
      nxt[v] = frame::load16<A>(row, frame::chunk<G>(base + S, v, g.q), more ? n : 0, L);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int c = frame::chunk<G>(base, v, g.q);
      unsigned w[5];
      frame::words<G, V>(g, cur, nxt, v, w);
      const unsigned cm = frame::crlf_mask(w) & frame::below(n - 1 - c);
      const unsigned cb = g.ballot(cm != 0);
      const int hit = g.lowest(c + __ffs(cm) - 1, cb);
      if (!found && cb) {
        found = true;
        crlf = hit;
      }
      const unsigned sm = frame::byte_mask(w, frame::kSP) & frame::below((found ? crlf : n) - c);
      const unsigned sb = g.ballot(sm != 0);
      const unsigned sb2 = g.ballot(__popc(sm) > 1);
      const int first = g.lowest(c + __ffs(sm) - 1, sb);
      if (spaces == 0 && sb) sp = first;
      spaces = min(2, spaces + (sb2 ? 2 : __popc(sb)));
    }
    if (!__any_sync(frame::kFull, more && !found)) break;
#pragma unroll
    for (int v = 0; v < V; ++v) cur[v] = nxt[v];
  }

  if (ok && g.q == 0) {
    const int e = found ? crlf : len;
    const bool one = spaces == 1;
    crlf_out[f] = e;
    complete_out[f] = e < len;
    msg_len_out[f] = e + 2;
    sp_out[f] = spaces ? sp : e;
    file_start_out[f] = one ? sp + 1 : 0;
    file_end_out[f] = one ? e : 0;
  }
}

struct Launch {
  const void* data;
  const void* lengths;
  int F, L;
  void *crlf, *complete, *msg_len, *sp, *file_start, *file_end;
  cudaStream_t stream;

  template <int G, int V, bool A>
  cudaError_t run() const {
    const int rows = kThreads / G;
    r2d2_frame_kernel<G, V, A><<<(F + rows - 1) / rows, kThreads, 0, stream>>>(
        static_cast<const uint8_t*>(data), static_cast<const int32_t*>(lengths), F, L,
        static_cast<int32_t*>(crlf), static_cast<bool*>(complete), static_cast<int32_t*>(msg_len),
        static_cast<int32_t*>(sp), static_cast<int32_t*>(file_start),
        static_cast<int32_t*>(file_end));
    return cudaGetLastError();
  }
};

}  // namespace

CILIUM_EXPORT int r2d2_frame(const void* data, const void* lengths, int F,
                             int L, void* crlf, void* complete, void* msg_len,
                             void* sp, void* file_start, void* file_end,
                             void* stream) {
  if (F <= 0) return cudaSuccess;
  const Launch launch{data, lengths, F, L, crlf, complete, msg_len, sp, file_start, file_end,
                      static_cast<cudaStream_t>(stream)};
  return frame::dispatch(frame::geometry(L, F, data), launch);
}
