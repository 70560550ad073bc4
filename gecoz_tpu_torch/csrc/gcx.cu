// Decode of a block's .gcx sampled suffix array for Hopper (sm_90a): the
// stored bit streams unpacked, the index wavelet tree's level walks and the
// sampled rows' compaction.
//
// Replaces no TPU kernel.  The JAX package decodes the .gcx on the host
// (gecoz_tpu/index/iwt.py::deserialize_iwt, a stable argsort a level, and
// ssa.py::sampled_rows) and uploads the two int32 arrays; so did the port,
// and at chromosome scale that host decode was half of a decompress.  Here
// the .gcx's bytes go up as they are stored and are decoded on the card.
//
// The stored form: the mark (a ranked bit vector over the block's n rows)
// and the IWT's nlv = bit_length(m) level planes over its m sampled values,
// top level first, each a ranked bit vector of m bits.  A ranked bit vector
// interleaves its packed bits with rank counters: 64 data bytes, then a
// 2-byte counter before each further 64, and 8 bytes more before every
// 8192 (index/rankbv.py); data byte k of a vector sits at
// 66 * (k >> 6) + 6 * (k >> 13) + (k & 63).
//
// Entry points (each enqueues on `stream`, never synchronises, and returns
// cudaGetLastError()):
//   gecoz_gcx_unpack  one thread per 32-bit word of the mark and of every
//                     plane: gathers the word's four bytes from its stream,
//                     clears the bits past the vector's length, writes the
//                     word and its popcount.  A scan of the popcounts
//                     (scan.cu's cumsum_i32) then gives every word its
//                     inclusive rank.
//   gecoz_gcx_decode  launches
//     * iwt_walk: one thread per sampled position j walks the planes top
//       to bottom as index/iwt.py::LazyIWT.get does and writes perm[j], the
//       value (SA >> sf) of the j-th sampled row, and inv[perm[j]] = j;
//     * mark_rows: one thread per mark word writes the word's exclusive
//       rank and the rows of its set bits at their ranks, so the sampled
//       rows come out ascending, and the row of value 0 (the wrap row);
//       its first thread writes the one-counts of the mark and of every
//       plane, which the host checks.
//   gecoz_gcx_init    loads the kernels before the first launch.
//
// The walk reads one word and one rank a level, where LazyIWT.get reads
// three ranks: the values are a permutation of 0..m-1, so at level i (s =
// nlv - i bits left) the node holding value v spans positions [lo, lo +
// 2^s) clipped to m with lo = (v >> s) << s, its zeros are the first
// min(2^(s-1), m - lo) of them, and its ones before lo number lo / 2.  Only
// the rank at the walk's own position needs the plane.
//
// What bounds it: dependent reads, two a level and nlv levels a thread (21
// at hg38's m of 1.46 M).  The planes' words and ranks are nlv * m / 4 bytes
// (7.7 MB at hg38), resident in the 50 MB L2, so a read waits on L2
// latency, not HBM; each thread holds one walk, and the card keeps enough
// of them in flight to cover it.  The top levels are read by every thread
// and stay in L1.  The outputs, 12 bytes a sampled value, are written once;
// inv is a scatter.  At a short block (m of a few hundred) every launch is
// a few microseconds and the lift is bounded by the host's launches: four
// kernels and two copies a block, whatever m is.
// A position that leaves its node (the bits of a damaged file) is clamped
// into it, and a value past m writes no inv: no read or write leaves its
// array.  Offsets are 64-bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) {
  return a < b ? a : b;
}
__device__ __forceinline__ int64_t lmax(int64_t a, int64_t b) {
  return a > b ? a : b;
}

// Ones of `word` at bits 0..b.
__device__ __forceinline__ int ones_through(uint32_t word, int b) {
  return __popc(word & (0xffffffffu >> (31 - b)));
}

__global__ void __launch_bounds__(kThreads)
unpack(const uint8_t* __restrict__ raw, int64_t n, int64_t m, int64_t wn,
       int64_t wm, int nlv, int64_t planes_at, int64_t plane_bytes,
       int32_t* __restrict__ words, int32_t* __restrict__ pc) {
  const int64_t o = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (o >= wn + nlv * wm) return;
  int64_t w = o, at = 0, len = n;
  if (o >= wn) {
    const int64_t q = o - wn, i = q / wm;
    w = q - i * wm;
    at = planes_at + i * plane_bytes;
    len = m;
  }
  const int64_t k = w << 2;
  const uint8_t* p = raw + at + 66 * (k >> 6) + 6 * (k >> 13) + (k & 63);
  uint32_t word = p[0] | (p[1] << 8) | (p[2] << 16) |
                  (static_cast<uint32_t>(p[3]) << 24);
  const int64_t valid = len - (w << 5);
  if (valid < 32) word &= (1u << valid) - 1;
  words[o] = static_cast<int32_t>(word);
  pc[o] = __popc(word);
}

__global__ void __launch_bounds__(kThreads)
iwt_walk(const uint32_t* __restrict__ words, const int32_t* __restrict__ inc,
         int64_t wn, int64_t wm, int nlv, int64_t m,
         int32_t* __restrict__ perm, int32_t* __restrict__ inv,
         int32_t* __restrict__ info) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (j >= m) return;
  if (j == 0) info[1] = -1;                  // no wrap row found yet
  int64_t p = j, lo = 0;
  uint32_t val = 0;
  for (int i = 0; i < nlv; ++i) {
    const int64_t at = wn + i * wm;          // the plane's first word
    const uint32_t word = __ldg(&words[at + (p >> 5)]);
    const int b = static_cast<int>(p & 31);
    const uint32_t bit = (word >> b) & 1u;
    val = (val << 1) | bit;
    if (i == nlv - 1) break;
    const int s = nlv - i;
    const int64_t mid = lmin(lo + (int64_t{1} << (s - 1)), m);
    const int64_t hi = lmin(lo + (int64_t{1} << s), m);
    // ones in [0, p] of the plane, and before the node
    const int64_t r1p = __ldg(&inc[at + (p >> 5)]) - __ldg(&inc[at - 1]) -
                        __popc(word) + ones_through(word, b);
    const int64_t r1lo = lo >> 1;
    int64_t nlo, nhi;
    if (bit) {
      p = mid + (r1p - r1lo) - 1;
      nlo = mid, nhi = hi;
    } else {
      p = p - r1p + r1lo;
      nlo = lo, nhi = mid;
    }
    p = lmax(nlo, lmin(p, nhi - 1));
    lo = nlo;
  }
  perm[j] = static_cast<int32_t>(val);
  if (val < m) inv[val] = static_cast<int32_t>(j);
}

__global__ void __launch_bounds__(kThreads)
mark_rows(const uint32_t* __restrict__ words, const int32_t* __restrict__ inc,
          const int32_t* __restrict__ inv, int64_t wn, int64_t wm, int nlv,
          int64_t m, int32_t* __restrict__ rows,
          int32_t* __restrict__ mark_pre, int32_t* __restrict__ info) {
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (w >= wn) return;
  if (w == 0) {
    info[0] = inc[wn - 1];
    for (int i = 0; i < nlv; ++i)
      info[2 + i] = inc[wn + (i + 1) * wm - 1] - inc[wn + i * wm - 1];
  }
  uint32_t bits = words[w];
  int64_t r = inc[w] - __popc(bits);
  mark_pre[w] = static_cast<int32_t>(r);
  const int64_t wrap = inv[0];              // the sample of value 0
  while (bits) {
    const int32_t row = static_cast<int32_t>((w << 5) + __ffs(bits) - 1);
    if (r < m) rows[r] = row;
    if (r == wrap) info[1] = row;
    ++r;
    bits &= bits - 1;
  }
}

unsigned grid_for(int64_t count) {
  return static_cast<unsigned>((count + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// Unpacks the stored streams in `raw` (the mark's at 0, the planes' at
// `planes_at`, `plane_bytes` apart, each readable 4 bytes past its end)
// into int32 words [wn + nlv * wm] and their popcounts, wn = ceil(n / 32),
// wm = ceil(m / 32).
int gecoz_gcx_unpack(const void* raw, int64_t n, int64_t m, int nlv,
                     int64_t planes_at, int64_t plane_bytes, void* words,
                     void* pc, void* stream) {
  const int64_t wn = (n + 31) >> 5, wm = (m + 31) >> 5;
  unpack<<<grid_for(wn + nlv * wm), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(raw), n, m, wn, wm, nlv, planes_at,
      plane_bytes, static_cast<int32_t*>(words), static_cast<int32_t*>(pc));
  return static_cast<int>(cudaGetLastError());
}

// Decodes one block's .gcx from the unpacked words and their inclusive
// ranks `inc` (see the top of this file); writes int32 perm [m], inv [m],
// rows [m], mark_pre [wn] and info [2 + nlv]: the mark's one-count, the
// wrap row (-1 where none), each plane's one-count.  m >= 1, n >= 1.
int gecoz_gcx_decode(const void* words, const void* inc, int64_t n,
                     int64_t m, int nlv, void* perm, void* inv, void* rows,
                     void* mark_pre, void* info, void* stream) {
  if (nlv < 1 || nlv > 31) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t wn = (n + 31) >> 5, wm = (m + 31) >> 5;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto w = static_cast<const uint32_t*>(words);
  const auto c = static_cast<const int32_t*>(inc);
  const auto o = static_cast<int32_t*>(info);
  iwt_walk<<<grid_for(m), kThreads, 0, st>>>(
      w, c, wn, wm, nlv, m, static_cast<int32_t*>(perm),
      static_cast<int32_t*>(inv), o);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  mark_rows<<<grid_for(wn), kThreads, 0, st>>>(
      w, c, static_cast<const int32_t*>(inv), wn, wm, nlv, m,
      static_cast<int32_t*>(rows), static_cast<int32_t*>(mark_pre), o);
  return static_cast<int>(cudaGetLastError());
}

// Load every kernel now (the library's runtime set up, each kernel's
// attributes read), so the first launch pays no set-up.  Returns the first
// error, or 0.
int gecoz_gcx_init(void) {
  cudaFuncAttributes a;
  const void* kernels[] = {reinterpret_cast<const void*>(unpack),
                           reinterpret_cast<const void*>(iwt_walk),
                           reinterpret_cast<const void*>(mark_rows)};
  for (const void* k : kernels) {
    const cudaError_t e = cudaFuncGetAttributes(&a, k);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

const char* gecoz_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
