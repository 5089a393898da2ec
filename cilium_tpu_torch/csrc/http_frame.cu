// K5 http_frame: frame one HTTP request head per flow row and tokenize its
// request line.
//
// Replaces the framing half of cilium_tpu/models/http.py:425
// (_http_rule_hits, :440-449) and the reductions it calls: _first_crlfcrlf
// (:539), first_subsequence2 and first_occurrence
// (cilium_tpu/ops/bytescan.py:29, :19), _first_occurrence_after (:385), and
// _last_in_span (:394) for the two literal slots (:409).  On the TPU each
// was a full [F, L] masked min/max; here one warp owns one row and stops
// at the first CRLFCRLF.
//
// Bound on the H100: bytes.  The work is a few compares per byte, so the
// floor is reading each row up to its head end once (the 32-byte sectors
// up to min(head_len, len)).  Design: 32 lanes read 32 neighbouring bytes
// per step (coalesced), warp ballots find the first CRLF and the first
// CRLFCRLF in one pass that ends at the CRLFCRLF; the space and LF passes
// re-read only the request line, from L1.  No byte at or past min(len, L)
// is read.
//
// Semantics ("not found" is the bound, cilium_tpu/ops/bytescan.py:9-10):
//   crlf2     = first CRLFCRLF at pos with pos + 3 < len, else len
//   complete  = crlf2 < len,  head_len = crlf2 + 4
//   line_end  = first CRLF at pos with pos + 1 < len, else len
//   sp1       = first 0x20 in [0, line_end), else line_end
//   sp2       = first 0x20 in (sp1, line_end), else line_end
//   last_nl_m = last 0x0A in [0, sp1), else -1
//   last_nl_p = last 0x0A in [sp1 + 1, sp2), else -1
#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

__global__ void http_frame_kernel(const uint8_t* __restrict__ data,
                                  const int32_t* __restrict__ lengths, int F,
                                  int L, int32_t* __restrict__ crlf2_out,
                                  bool* __restrict__ complete_out,
                                  int32_t* __restrict__ head_len_out,
                                  int32_t* __restrict__ line_end_out,
                                  int32_t* __restrict__ sp1_out,
                                  int32_t* __restrict__ sp2_out,
                                  int32_t* __restrict__ last_nl_m_out,
                                  int32_t* __restrict__ last_nl_p_out) {
  const int lane = threadIdx.x & 31;
  const int f = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (f >= F) return;  // whole warp: f is warp-uniform
  const uint8_t* row = data + static_cast<size_t>(f) * L;
  const int len = lengths[f];
  const int n = max(0, min(len, L));

  // Pass 1: the first CRLF and the first CRLFCRLF fully inside [0, n).
  // A CRLFCRLF starts with a CRLF, so the line end is found first.
  int line_end = len;
  int crlf2 = len;
  bool have_line = false;
  for (int base = 0; base + 1 < n; base += 32) {
    const int pos = base + lane;
    const bool crlf =
        pos + 1 < n && row[pos] == 0x0D && row[pos + 1] == 0x0A;
    const bool crlf2_hit =
        crlf && pos + 3 < n && row[pos + 2] == 0x0D && row[pos + 3] == 0x0A;
    const unsigned b1 = __ballot_sync(kFull, crlf);
    const unsigned b2 = __ballot_sync(kFull, crlf2_hit);
    if (!have_line && b1) {
      line_end = base + __ffs(b1) - 1;
      have_line = true;
    }
    if (b2) {
      crlf2 = base + __ffs(b2) - 1;
      break;
    }
  }

  // Pass 2: the first two spaces in [0, min(line_end, L)).
  const int m = max(0, min(line_end, L));
  int sp1 = line_end;
  int sp2 = line_end;
  int spaces = 0;
  for (int base = 0; base < m && spaces < 2; base += 32) {
    const int pos = base + lane;
    unsigned b = __ballot_sync(kFull, pos < m && row[pos] == 0x20);
    while (b && spaces < 2) {
      const int hit = base + __ffs(b) - 1;
      b &= b - 1;
      if (spaces == 0) sp1 = hit; else sp2 = hit;
      ++spaces;
    }
  }

  // Pass 3: the last LF before sp1 and the last one in (sp1, sp2).
  const int e = max(0, min(sp2, L));
  int last_m = -1;
  int last_p = -1;
  for (int base = 0; base < e; base += 32) {
    const int pos = base + lane;
    const bool nl = pos < e && row[pos] == 0x0A;
    const unsigned bm = __ballot_sync(kFull, nl && pos < sp1);
    const unsigned bp = __ballot_sync(kFull, nl && pos > sp1);
    if (bm) last_m = base + 31 - __clz(bm);
    if (bp) last_p = base + 31 - __clz(bp);
  }

  if (lane == 0) {
    crlf2_out[f] = crlf2;
    complete_out[f] = crlf2 < len;
    head_len_out[f] = crlf2 + 4;
    line_end_out[f] = line_end;
    sp1_out[f] = sp1;
    sp2_out[f] = sp2;
    last_nl_m_out[f] = last_m;
    last_nl_p_out[f] = last_p;
  }
}

}  // namespace

CILIUM_EXPORT int http_frame(const void* data, const void* lengths, int F,
                             int L, void* crlf2, void* complete,
                             void* head_len, void* line_end, void* sp1,
                             void* sp2, void* last_nl_m, void* last_nl_p,
                             void* stream) {
  if (F <= 0) return cudaSuccess;
  const int blocks = (F + kWarpsPerBlock - 1) / kWarpsPerBlock;
  http_frame_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<const int32_t*>(lengths),
      F, L, static_cast<int32_t*>(crlf2), static_cast<bool*>(complete),
      static_cast<int32_t*>(head_len), static_cast<int32_t*>(line_end),
      static_cast<int32_t*>(sp1), static_cast<int32_t*>(sp2),
      static_cast<int32_t*>(last_nl_m), static_cast<int32_t*>(last_nl_p));
  return cudaGetLastError();
}
