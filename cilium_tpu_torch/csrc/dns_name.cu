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
// way), plus lengths and five [F] outputs; the walk is a few byte reads a
// row.  Design (frame_scan.cuh's lane groups and loads): a group of G
// lanes owns a row and a step covers 16 * G * V bytes of it, each lane V
// chunks of 16 bytes in registers (16-byte loads where the rows and the
// output are 16-byte aligned, byte loads otherwise), the next step's
// chunks loaded before the current one is walked.  The lanes put the
// step's chunks into shared memory, a row's bytes contiguous, and every lane of the group
// walks the same label chain there: a label costs one shared-memory byte
// read (the group's lanes read one address) and an add, never a load from
// device memory that waits on the previous label, and no warp-wide
// shuffle or vote a label.  A lane keeps a 16-bit mask of the separators
// in each of its chunks, folds A-Z four bytes at a time (SWAR), puts '.'
// at the masked bytes and stores each chunk once from its registers: one
// read and one write a byte, no second pass, no block barrier.
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
#include "frame_scan.cuh"

namespace {

using frame::Group;

constexpr int kMaxThreads = 256;
constexpr int kPrefixLen = 2;   // proxylib/parsers/dns.py DNS_PREFIX_LEN
constexpr int kQnameOff = 14;   // DNS_PREFIX_LEN + DNS_HEADER_LEN
constexpr int kMinFrame = 19;   // models/dns.py DNS_MIN_FRAME
constexpr int kMaxLabel = 63;   // MAX_LABEL
constexpr int kMaxLabels = 40;  // MAX_LABELS

struct Geometry {
  int lanes;     // G: lanes a row
  int vecs;      // V: 16-byte chunks a lane a step
  bool aligned;  // 16-byte loads and stores, else byte loads and stores
  int threads;   // a block
};

// Batches of at least this many rows fill the card at 2 lanes a row.
constexpr int kManyRows = 8192;

// The variant a launch takes, from the row width, the rows and the two
// row bases: for many rows 2 lanes x 2 chunks (64 bytes a step, the
// fewest instructions a byte); for fewer, lanes enough that one step of a
// chunk a lane covers the row (4 to 64 bytes, 8 to 128, 16 to 256, a warp
// past that), in blocks of 256 threads, or of 128 or 64 where fewer would
// leave SMs idle (chip_frame_variants.py's readings).
inline Geometry geometry(int L, int F, const void* data, const void* dotted) {
  Geometry g;
  const bool many = F >= kManyRows;
  g.lanes = many ? 2 : L <= 64 ? 4 : L <= 128 ? 8 : L <= 256 ? 16 : 32;
  g.vecs = many ? 2 : 1;
  g.aligned = L % 16 == 0 && ((reinterpret_cast<uintptr_t>(data) |
                               reinterpret_cast<uintptr_t>(dotted)) & 15u) == 0;
  g.threads = kMaxThreads;
  while (g.threads > 64 && static_cast<long long>(F) * g.lanes < 132LL * g.threads) g.threads /= 2;
  return g;
}

// A-Z to a-z in each byte (the bytes 0x41-0x5a, high bit clear): exact,
// since no sum carries out of a byte's seven low bits.
__device__ __forceinline__ unsigned fold4(unsigned x) {
  const unsigned h = x & 0x7f7f7f7fu;
  const unsigned upper = (h + 0x3f3f3f3fu) & ~(h + 0x25252525u) & ~x & 0x80808080u;
  return x + (upper >> 2);
}

// '.' in the bytes of x whose bit is set in m4 (bits 0-3): the multiply
// spreads bit i to bit 8i, with no carries.
__device__ __forceinline__ unsigned dots(unsigned x, unsigned m4) {
  const unsigned b = ((m4 * 0x00204081u) & 0x01010101u) * 0xffu;
  return (x & ~b) | (0x2e2e2e2eu & b);
}

// The chunk at row + c (c < L), as load16 reads them.
template <bool A>
__device__ __forceinline__ void store16(uint8_t* __restrict__ row, int c, int L, const uint4& x) {
  if (A) {
    *reinterpret_cast<uint4*>(row + c) = x;
    return;
  }
  const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (c + i < L) row[c + i] = static_cast<uint8_t>(w[i >> 2] >> (8 * (i & 3)));
}

// Bytes of shared memory a row's step takes: its S bytes, and 16 more so
// that the rows of a warp start on different banks.
template <int G, int V>
__host__ __device__ constexpr int step_stride() { return 16 * G * V + 16; }

template <int G, int V, bool A>
__global__ void __launch_bounds__(kMaxThreads)
dns_name_kernel(const uint8_t* __restrict__ data, const int32_t* __restrict__ lengths, int F, int L,
                bool* __restrict__ complete, int32_t* __restrict__ msg_len,
                bool* __restrict__ valid, int32_t* __restrict__ span_start,
                int32_t* __restrict__ span_end, uint8_t* __restrict__ dotted) {
  constexpr int S = 16 * G * V;
  extern __shared__ uint4 s_steps[];  // each row's current step, step_stride bytes a row
  const Group<G> g;
  const int f = blockIdx.x * (blockDim.x / G) + static_cast<int>(threadIdx.x) / G;
  const bool ok = f < F;  // rows past F ride along: no load, no store
  const bool fold = L >= kMinFrame;
  const size_t off = static_cast<size_t>(ok ? f : 0) * L;
  const uint8_t* row = data + off;
  uint8_t* out = dotted + off;
  uint8_t* s_row = reinterpret_cast<uint8_t*>(s_steps) + (threadIdx.x / G) * step_stride<G, V>();

  const int len = ok && fold ? __ldg(lengths + f) : 0;
  uint4 cur[V], nxt[V];
#pragma unroll
  for (int v = 0; v < V; ++v) cur[v] = frame::load16<A>(row, frame::chunk<G>(0, v, g.q), ok ? L : 0, L);

  int ml = 0, limit = 0;
  bool c = false, walking = false, done = false;
  int pos = kQnameOff, nsep = 0;
  for (int base = 0; base < L; base += S) {
    // The next step's chunks go out before this one is walked.
    const bool more = base + S < L;
#pragma unroll
    for (int v = 0; v < V; ++v)
      nxt[v] = frame::load16<A>(row, frame::chunk<G>(base + S, v, g.q), ok && more ? L : 0, L);
    // The step into shared memory, where every lane of the group reads the
    // chain's length bytes (the same address: one broadcast).
#pragma unroll
    for (int v = 0; v < V; ++v) reinterpret_cast<uint4*>(s_row)[v * G + g.q] = cur[v];
    __syncwarp();
    if (base == 0 && fold) {  // the prefix (bytes 0-1) and QDCOUNT (bytes 6-7)
      ml = ((static_cast<int>(s_row[0]) << 8) | s_row[1]) + kPrefixLen;
      c = len >= kPrefixLen && ml <= len;
      const int qd = (static_cast<int>(s_row[6]) << 8) | s_row[7];
      limit = min(ml, L);
      walking = ok && c && ml >= kMinFrame && qd >= 1;
    }
    unsigned sep[V];
#pragma unroll
    for (int v = 0; v < V; ++v) sep[v] = 0u;
    // The labels whose length byte lies in this step: a zero ends the chain
    // (done), a byte over 63 or a 41st label makes the row invalid, else pos
    // is a separator (marked by the lane whose chunk holds it) and the chain
    // goes on unless it leaves the frame (invalid).
    while (walking && pos < base + S) {
      const int lb = s_row[pos - base];
      const bool step = lb != 0 && lb <= kMaxLabel && nsep < kMaxLabels;
      done |= lb == 0;
      if (step) {
        const int k = (pos - base) >> 4;  // the step's chunk holding pos
        if ((k & (G - 1)) == g.q) {
#pragma unroll
          for (int v = 0; v < V; ++v)
            if (k / G == v) sep[v] |= 1u << (pos & 15);
        }
        ++nsep;
        pos += 1 + lb;
      }
      walking = step && pos < limit;
    }
    __syncwarp();  // the group's reads of this step are done
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int c0 = frame::chunk<G>(base, v, g.q);
      if (ok && c0 < L) {
        uint4 x = cur[v];
        if (fold) {
          x.x = fold4(x.x);
          x.y = fold4(x.y);
          x.z = fold4(x.z);
          x.w = fold4(x.w);
          if (sep[v]) {
            x.x = dots(x.x, sep[v] & 0xfu);
            x.y = dots(x.y, (sep[v] >> 4) & 0xfu);
            x.z = dots(x.z, (sep[v] >> 8) & 0xfu);
            x.w = dots(x.w, (sep[v] >> 12) & 0xfu);
          }
        }
        store16<A>(out, c0, L, x);
      }
    }
#pragma unroll
    for (int v = 0; v < V; ++v) cur[v] = nxt[v];
  }

  if (ok && g.q == 0) {
    const bool good = done && pos + 5 <= ml;
    const int start = fold ? kQnameOff + 1 : 0;
    complete[f] = c;
    msg_len[f] = ml;
    valid[f] = good;
    span_start[f] = start;
    span_end[f] = good ? pos : start;
  }
}

struct Launch {
  const uint8_t* data;
  const int32_t* lengths;
  int F, L;
  bool* complete;
  int32_t* msg_len;
  bool* valid;
  int32_t* span_start;
  int32_t* span_end;
  uint8_t* dotted;
  cudaStream_t stream;
  Geometry geom;

  template <int G, int V, bool A>
  cudaError_t run() const {
    const int rows = geom.threads / G;
    const int blocks = (F + rows - 1) / rows;
    const size_t smem = static_cast<size_t>(rows) * step_stride<G, V>();
    dns_name_kernel<G, V, A><<<blocks, geom.threads, smem, stream>>>(
        data, lengths, F, L, complete, msg_len, valid, span_start, span_end, dotted);
    return cudaGetLastError();
  }

  // run<G, V, A>() for the geometry's lanes, chunks and alignment.
  cudaError_t dispatch() const {
    const bool a = geom.aligned;
    if (geom.vecs == 2) return a ? run<2, 2, true>() : run<2, 2, false>();
    switch (geom.lanes) {
      case 4: return a ? run<4, 1, true>() : run<4, 1, false>();
      case 8: return a ? run<8, 1, true>() : run<8, 1, false>();
      case 16: return a ? run<16, 1, true>() : run<16, 1, false>();
      default: return a ? run<32, 1, true>() : run<32, 1, false>();
    }
  }
};

Launch make_launch(const void* data, const void* lengths, int F, int L, void* complete,
                   void* msg_len, void* valid, void* span_start, void* span_end, void* dotted,
                   void* stream) {
  return Launch{static_cast<const uint8_t*>(data), static_cast<const int32_t*>(lengths), F, L,
                static_cast<bool*>(complete), static_cast<int32_t*>(msg_len),
                static_cast<bool*>(valid), static_cast<int32_t*>(span_start),
                static_cast<int32_t*>(span_end), static_cast<uint8_t*>(dotted),
                static_cast<cudaStream_t>(stream), geometry(L, F, data, dotted)};
}

}  // namespace

// The variant K8's launcher takes for F rows of width L at data, written
// to dotted: lanes | vecs << 8 | aligned << 16 | threads << 17
// (kernels.name_variant).  The library also exports frame_scan.cuh's
// frame_variant, which is the framing kernels' and not K8's.
CILIUM_EXPORT int name_variant(int L, int F, const void* data, const void* dotted) {
  const Geometry g = geometry(L, F, data, dotted);
  return g.lanes | g.vecs << 8 | (g.aligned ? 1 : 0) << 16 | g.threads << 17;
}

CILIUM_EXPORT int dns_name(const void* data, const void* lengths, int F,
                           int L, void* complete, void* msg_len, void* valid,
                           void* span_start, void* span_end, void* dotted,
                           void* stream) {
  if (F <= 0) return cudaSuccess;
  return make_launch(data, lengths, F, L, complete, msg_len, valid, span_start, span_end, dotted,
                     stream)
      .dispatch();
}
