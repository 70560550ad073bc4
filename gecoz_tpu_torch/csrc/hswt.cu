// Decode of a block's BWT out of its Huffman-shaped wavelet tree for Hopper
// (sm_90a): the nodes' stored bit streams unpacked, then one walk of every
// BWT position from the root to its leaf.
//
// Replaces no TPU kernel.  The JAX package decodes the BWT on the host
// (gecoz_tpu/index/hswt.py::decode_bwt, a recursive partition of every
// node's positions) and uploads the bytes; so did the port, and at
// chromosome scale that host decode was ~88% of a decompress.  Here the
// .gcz's node streams go up as they are stored and are decoded on the card.
//
// The stored form (index/hswt.py::stored_streams): the internal nodes in
// pre-order, each a ranked bit vector of its length in bits, interleaving
// its packed bits with rank counters: 64 data bytes, then a 2-byte counter
// before each further 64, and 8 bytes more before every 8192
// (index/rankbv.py); data byte k of a node sits at
// 66 * (k >> 6) + 6 * (k >> 13) + (k & 63) from the node's first byte.
//
// `raw` holds the node table first, int64 [nodes][5] (kCols): the node's
// byte offset from `streams_at`, its length in bits, its first word among
// every node's words (`wbase`), and its 0-side and 1-side, each a child
// node's row (greater than the node's own: pre-order) or ~symbol at a leaf.
// The streams follow at `streams_at`, readable 4 bytes past their end.
//
// Entry points (each enqueues on `stream`, never synchronises, and returns
// cudaGetLastError()):
//   gecoz_hswt_unpack  one thread per 32-bit word of every node: finds its
//                      node (a binary search of the table's word bases in
//                      shared memory), gathers the word's four bytes from
//                      the node's stream, clears the bits past the node's
//                      length, writes the word and its popcount.  A scan of
//                      the popcounts (scan.cu's cumsum_i32) then gives every
//                      word its inclusive rank over all the nodes' words.
//   gecoz_hswt_decode  one thread per 4 adjacent BWT positions: each walks
//                      from the root, reading at each node one word (its
//                      bit) and, where the side taken is a node, one rank:
//                      p' = rank1(p) - 1 on a 1, p - rank1(p) on a 0
//                      (HSWT.getRS).  A node's rank of p is the word's
//                      inclusive rank less its ones past p, less the
//                      node's base (the rank before its first word), in
//                      uint32, so the int32 scan's wrap cancels.  The
//                      thread writes its 4 symbols in one 4-byte store.
//   gecoz_hswt_init    loads the kernels before the first launch.
//
// What bounds the walk: bytes.  At hg38's chr21 block (n = 46.7 M, ~2.2
// levels a position, ~13 MB of streams) it reads the streams once
// (unpack), the words and their ranks a few times (unpack's writes, the
// scan, the walk's reads: 8 bytes a word each), and writes one byte a
// position.  Consecutive positions stay monotone at every level, so a
// warp's 128 positions read a few adjacent words of one node, and its
// stores are 4 bytes a thread, adjacent.  The table sits in shared memory,
// loaded by each block.  At a Swiss-Prot block (~24,000 residues, 22
// symbols, 21 nodes) each launch is a few microseconds: the lift there is
// bounded by launch latency, three kernels and one copy a block.
// A position that leaves its node (the bits of a damaged file) is clamped
// into it, and a child row that is not past its parent's ends the walk at
// symbol 0: no read or write leaves its array.  Offsets are 64-bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxNodes = 255;          // 256 symbols: 255 internal nodes
constexpr int kCols = 5;                // off, len, wbase, child0, child1
constexpr int kPerThread = 4;           // positions a decode thread walks

__device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) {
  return a < b ? a : b;
}
__device__ __forceinline__ int64_t lmax(int64_t a, int64_t b) {
  return a > b ? a : b;
}

__global__ void __launch_bounds__(kThreads)
wt_unpack(const uint8_t* __restrict__ raw, int nodes, int64_t streams_at,
          int64_t total, int32_t* __restrict__ words,
          int32_t* __restrict__ pc) {
  __shared__ int64_t s_off[kMaxNodes], s_len[kMaxNodes], s_wbase[kMaxNodes];
  const auto table = reinterpret_cast<const int64_t*>(raw);
  for (int i = threadIdx.x; i < nodes; i += kThreads) {
    s_off[i] = table[i * kCols];
    s_len[i] = table[i * kCols + 1];
    s_wbase[i] = table[i * kCols + 2];
  }
  __syncthreads();
  const int64_t o = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (o >= total) return;
  int lo = 0, hi = nodes - 1;               // the last node starting <= o
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (s_wbase[mid] <= o) lo = mid; else hi = mid - 1;
  }
  const int64_t w = o - s_wbase[lo], k = w << 2;
  const uint8_t* p = raw + streams_at + s_off[lo] + 66 * (k >> 6) +
                     6 * (k >> 13) + (k & 63);
  uint32_t word = p[0] | (p[1] << 8) | (p[2] << 16) |
                  (static_cast<uint32_t>(p[3]) << 24);
  const int64_t valid = s_len[lo] - (w << 5);
  if (valid < 32) word &= valid > 0 ? (1u << valid) - 1 : 0u;
  words[o] = static_cast<int32_t>(word);
  pc[o] = __popc(word);
}

__global__ void __launch_bounds__(kThreads)
wt_walk(const uint8_t* __restrict__ raw, const uint32_t* __restrict__ words,
        const uint32_t* __restrict__ inc, int nodes, int64_t n,
        uint32_t* __restrict__ out) {
  __shared__ int64_t s_len[kMaxNodes], s_wbase[kMaxNodes];
  __shared__ uint32_t s_base[kMaxNodes];
  __shared__ int32_t s_child[2][kMaxNodes];
  const auto table = reinterpret_cast<const int64_t*>(raw);
  for (int i = threadIdx.x; i < nodes; i += kThreads) {
    s_len[i] = table[i * kCols + 1];
    const int64_t wb = table[i * kCols + 2];
    s_wbase[i] = wb;
    s_base[i] = wb > 0 ? inc[wb - 1] : 0u;
    s_child[0][i] = static_cast<int32_t>(table[i * kCols + 3]);
    s_child[1][i] = static_cast<int32_t>(table[i * kCols + 4]);
  }
  __syncthreads();
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t p0 = t * kPerThread;
  if (p0 >= n) return;
  uint32_t packed = 0;
  for (int j = 0; j < kPerThread && p0 + j < n; ++j) {
    int node = 0;
    int64_t p = p0 + j;
    uint32_t sym = 0;
    for (;;) {
      const int64_t at = s_wbase[node] + (p >> 5);
      const uint32_t word = __ldg(&words[at]);
      const int b = static_cast<int>(p & 31);
      const uint32_t bit = (word >> b) & 1u;
      const int32_t child = s_child[bit][node];
      if (child < 0) {
        sym = static_cast<uint32_t>(~child) & 0xffu;
        break;
      }
      if (child <= node || child >= nodes) break;        // symbol 0
      // ones of the node at 0..p
      const uint32_t r1 = __ldg(&inc[at]) - s_base[node] - __popc(word) +
                          __popc(word & (0xffffffffu >> (31 - b)));
      p = bit ? static_cast<int64_t>(r1) - 1 : p - static_cast<int64_t>(r1);
      node = child;
      p = lmax(0, lmin(p, s_len[node] - 1));
    }
    packed |= sym << (8 * j);
  }
  out[t] = packed;
}

unsigned grid_for(int64_t count) {
  return static_cast<unsigned>((count + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// Unpacks every node's stored stream (the table and streams in `raw`, see
// the top of this file) into int32 words [total] and their popcounts.
int gecoz_hswt_unpack(const void* raw, int nodes, int64_t streams_at,
                      int64_t total, void* words, void* pc, void* stream) {
  if (nodes < 1 || nodes > kMaxNodes || total < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  wt_unpack<<<grid_for(total), kThreads, 0,
              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(raw), nodes, streams_at, total,
      static_cast<int32_t*>(words), static_cast<int32_t*>(pc));
  return static_cast<int>(cudaGetLastError());
}

// Decodes the n BWT symbols from the unpacked words and their inclusive
// ranks `inc` into `out`, uint8 [4 * ceil(n / 4)] (the bytes past n are
// written 0).  n >= 1; the root, row 0, holds n bits.
int gecoz_hswt_decode(const void* raw, const void* words, const void* inc,
                      int nodes, int64_t n, void* out, void* stream) {
  if (nodes < 1 || nodes > kMaxNodes || n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t threads = (n + kPerThread - 1) / kPerThread;
  wt_walk<<<grid_for(threads), kThreads, 0,
            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(raw), static_cast<const uint32_t*>(words),
      static_cast<const uint32_t*>(inc), nodes, n,
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Load every kernel now (the library's runtime set up, each kernel's
// attributes read), so the first launch pays no set-up.  Returns the first
// error, or 0.
int gecoz_hswt_init(void) {
  cudaFuncAttributes a;
  const void* kernels[] = {reinterpret_cast<const void*>(wt_unpack),
                           reinterpret_cast<const void*>(wt_walk)};
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
