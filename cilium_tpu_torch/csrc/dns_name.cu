// K8 dns_name: frame each row's first DNS-over-TCP query, walk its QNAME
// label chain and rewrite the row to the dotted, 0x20-folded name.
//
// Replaces cilium_tpu/models/dns.py:223 (_dns_name_span).  The TPU version
// was one lax.scan over the byte columns: every flow's single label chain
// advanced when the scan reached its current label-length position, so
// the scan touched all F x L bytes L times over in column slices, since
// gathers serialize there.
//
// Bound on the H100: bytes.  `dotted` is the whole row folded, so every
// input byte is read once and every output byte written once (F x L each
// way), plus lengths and five [F] outputs; the walk is a few byte loads a
// row.  Design: a block owns 128 consecutive rows.  Phase 1, one thread a
// row: read the prefix, QDCOUNT and the label chain (at most MAX_LABELS
// + 1 dependent byte loads, all below min(msg_len, L)), write the five
// [F] outputs and keep the separator positions in shared memory.  Phase
// 2: the block's rows are one contiguous run of 128 x L bytes, copied
// folded by all threads together, 16 bytes a thread where aligned.
// Phase 3, after a barrier: each thread stores '.' at its row's
// separators, over the folded copy.
//
// Semantics (cilium_tpu/models/dns.py:223-288 and
// proxylib/parsers/dns.py parse_dns_query):
//   L < 19: dotted = data unchanged, every [F] output 0 / false.
//   msg_len = (data[0] << 8 | data[1]) + 2
//   complete = lengths >= 2 and msg_len <= lengths
//   the walk runs only if complete, msg_len >= 19 and QDCOUNT >= 1; from
//   pos = 14, below limit = min(msg_len, L): a zero byte ends it (done);
//   a byte > 63, or a 41st label, makes the row invalid and marks
//   nothing; otherwise pos is a separator and pos += 1 + byte; reaching
//   limit makes the row invalid.  Separators marked before an
//   invalidation stay '.'.
//   valid = done and pos + 5 <= msg_len; span_start = 15;
//   span_end = pos where valid, else 15.
//   dotted = A-Z folded to a-z over the whole row, then '.' at separators.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kPrefixLen = 2;   // proxylib/parsers/dns.py DNS_PREFIX_LEN
constexpr int kQnameOff = 14;   // DNS_PREFIX_LEN + DNS_HEADER_LEN
constexpr int kMinFrame = 19;   // models/dns.py DNS_MIN_FRAME
constexpr int kMaxLabel = 63;   // MAX_LABEL
constexpr int kMaxLabels = 40;  // MAX_LABELS

__device__ __forceinline__ uint32_t fold4(uint32_t w) {
  uint32_t out = 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t b = (w >> (8 * i)) & 0xFFu;
    if (b - 0x41u <= 0x19u) b += 0x20u;  // 'A'..'Z'
    out |= b << (8 * i);
  }
  return out;
}

__global__ void dns_name_kernel(const uint8_t* __restrict__ data,
                                const int32_t* __restrict__ lengths, int F,
                                int L, bool* __restrict__ complete,
                                int32_t* __restrict__ msg_len,
                                bool* __restrict__ valid,
                                int32_t* __restrict__ span_start,
                                int32_t* __restrict__ span_end,
                                uint8_t* __restrict__ dotted) {
  // seps[k][t]: the k-th separator of this block's row t (conflict-free).
  __shared__ int32_t seps[kMaxLabels][kThreads];
  const int t = threadIdx.x;
  const int f0 = blockIdx.x * kThreads;
  const int f = f0 + t;
  const bool fold = L >= kMinFrame;
  int nsep = 0;

  // Phase 1: one thread a row.
  if (f < F) {
    bool c = false, ok = false;
    int ml = 0, start = 0, end = 0;
    if (fold) {
      const uint8_t* row = data + static_cast<size_t>(f) * L;
      ml = ((static_cast<int>(row[0]) << 8) | row[1]) + kPrefixLen;
      const int len = lengths[f];
      c = len >= kPrefixLen && ml <= len;
      const int qd = (static_cast<int>(row[6]) << 8) | row[7];
      start = end = kQnameOff + 1;
      if (c && ml >= kMinFrame && qd >= 1) {
        const int limit = min(ml, L);
        int pos = kQnameOff;
        bool done = false;
        while (pos < limit) {
          const int lb = row[pos];
          if (lb == 0) {
            done = true;
            break;
          }
          if (lb > kMaxLabel || nsep >= kMaxLabels) break;  // invalid
          seps[nsep++][t] = pos;
          pos += 1 + lb;
        }
        ok = done && pos + 5 <= ml;
        if (ok) end = pos;
      }
    }
    complete[f] = c;
    msg_len[f] = ml;
    valid[f] = ok;
    span_start[f] = start;
    span_end[f] = end;
  }

  // Phase 2: the block's rows, folded, by all threads.
  const int rows = min(kThreads, F - f0);
  const size_t base = static_cast<size_t>(f0) * L;
  const size_t n = static_cast<size_t>(rows) * L;
  const uint8_t* src = data + base;
  uint8_t* dst = dotted + base;
  const bool vec = ((reinterpret_cast<uintptr_t>(src) |
                     reinterpret_cast<uintptr_t>(dst) | n) & 15u) == 0;
  if (vec) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (size_t i = t; i < n / 16; i += kThreads) {
      uint4 v = s4[i];
      if (fold) {
        v.x = fold4(v.x);
        v.y = fold4(v.y);
        v.z = fold4(v.z);
        v.w = fold4(v.w);
      }
      d4[i] = v;
    }
  } else {
    for (size_t i = t; i < n; i += kThreads) {
      uint8_t b = src[i];
      if (fold && static_cast<uint32_t>(b) - 0x41u <= 0x19u) b += 0x20;
      dst[i] = b;
    }
  }
  __syncthreads();

  // Phase 3: '.' over each separator of this thread's row.
  if (f < F) {
    uint8_t* row = dotted + static_cast<size_t>(f) * L;
    for (int k = 0; k < nsep; ++k) row[seps[k][t]] = '.';
  }
}

}  // namespace

CILIUM_EXPORT int dns_name(const void* data, const void* lengths, int F,
                           int L, void* complete, void* msg_len, void* valid,
                           void* span_start, void* span_end, void* dotted,
                           void* stream) {
  if (F <= 0) return cudaSuccess;
  dns_name_kernel<<<(F + kThreads - 1) / kThreads, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<const int32_t*>(lengths),
      F, L, static_cast<bool*>(complete), static_cast<int32_t*>(msg_len),
      static_cast<bool*>(valid), static_cast<int32_t*>(span_start),
      static_cast<int32_t*>(span_end), static_cast<uint8_t*>(dotted));
  return cudaGetLastError();
}
