// Batched FM-index backward search for Hopper (sm_90a): kernel K1, fm_search.
//
// Replaces the Pallas TPU kernel tools/probe_pallas.py::step1_vmem_gather, a
// gather from a small table held in VMEM, at the place the JAX package wanted
// it: the per-step lookups of search_batch (gecoz_tpu/ops/fmq.py:688-741)
// into c[257], sym_plane[256] and the k-mer level offsets.  Here those small
// tables are staged in shared memory once per block, and every step of every
// pattern reads them there.
//
// One thread per pattern.  The k-mer seed is one 8-byte read of kmer_tab
// (the pattern's last min(len, k) characters, plane-coded); the columns left
// of it then run backward in the same launch, each step two occ lookups.
// The active/bad rules of search_batch apply exactly, so (sp, ep) equal the
// reference's bit for bit.
//
// What bounds it: dependent random reads from device memory.  Each step's
// occ lookups land on random places of tables that outgrow the 50 MB L2 at
// chromosome scale, and the next step needs their result.  On the H100 a
// random read costs a whole 32-byte sector at the card's random-row rate
// (PERF.md: about 29 G rows/s, under a third of what 3.35 TB/s would give
// in sectors), so the kernel's time is the number of distinct sectors its
// patterns touch, not their bytes: more reads in flight only lengthen the
// HBM's queues.  The design therefore reads fewer sectors:
//   * rank_blocks (ops/fmq.py::with_rank_blocks): int32 [sigma * Wb, 8], one
//     aligned 32-byte block per 224 BWT positions of a plane, holding the
//     plane's count of ones before the block and its next 7 bit words.  An
//     occ lookup is one sector (two 16-byte loads of it): the count is the
//     block's prefix, the popcounts of the whole words before the position's
//     word, and the popcount of that word under the mask.  The flat planes
//     cost two sectors a lookup (a word and its prefix, two arrays).
//   * The sp - 1 and ep lookups of a step share the block when they fall in
//     the same one, which is most steps once the range is narrow.
//   * A thread reads its pattern 16 aligned bytes at a time and keeps them
//     in registers, one load per 16 columns (a 16-mer row is one load, and a
//     warp's 16-mers are 512 contiguous bytes), not one byte a step.  The
//     aligned word around a pattern byte never leaves that byte's page.
//
// Offsets into the tables, the patterns and the k-mer table are 64-bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 32;  // longest k-mer level the offsets table holds
// BWT positions of a rank block: 7 words (ops/fmsearch.py::BLOCK_CHARS)
constexpr int kBlockChars = 224;

// c[], sym_plane[] and the k-mer level offsets into shared memory.
__device__ __forceinline__ void load_small_tables(
    const int32_t* __restrict__ c_g, const int32_t* __restrict__ plane_g,
    int bits, int k, int32_t* c, int32_t* plane, int64_t* offs) {
  for (int i = threadIdx.x; i < 257; i += blockDim.x) c[i] = c_g[i];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) plane[i] = plane_g[i];
  if (threadIdx.x < k + 2) {
    // start row of the length-j level: sum of 2^(bits*i) for i in [1, j)
    int64_t o = 0;
    for (int i = 1; i < static_cast<int>(threadIdx.x); ++i)
      o += int64_t{1} << (bits * i);
    offs[threadIdx.x] = o;
  }
  __syncthreads();
}

// The k-mer seed of a pattern whose byte at column `col` is at(col): (sp,
// ep) of its last min(len, k) characters (1, 0 when one is absent).
template <class At>
__device__ __forceinline__ int2 kmer_seed(At& at, int64_t L, int32_t n_b,
                                          const int32_t* plane,
                                          const int64_t* offs,
                                          const int32_t* __restrict__ kmer_tab,
                                          int bits, int k) {
  // char at column L-1-t sits at bit position bits*t of the code
  uint32_t code = 0;
  bool bad = false;
  for (int t = 0; t < k; ++t) {
    const int32_t row = plane[at(L - 1 - t)];
    code |= static_cast<uint32_t>(row > 0 ? row : 0) << (bits * t);
    bad |= row < 0 && t < n_b;  // absent symbol inside the query
  }
  const int j = n_b < 1 ? 1 : (n_b > k ? k : n_b);
  code &= (1u << (bits * j)) - 1u;
  const int2 seed =
      *reinterpret_cast<const int2*>(kmer_tab + 2 * (offs[j] + code));
  return bad ? make_int2(1, 0) : seed;
}

// One pattern row read 16 aligned bytes at a time, kept in registers:
// columns are visited right to left, so one load serves up to 16 of them.
struct Row {
  const uint8_t* p;
  uintptr_t at;  // address of the word held in w (1: none yet)
  uint4 w;

  __device__ __forceinline__ int operator()(int64_t col) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(p + col);
    const uintptr_t base = a & ~uintptr_t{15};
    if (base != at) {
      w = __ldg(reinterpret_cast<const uint4*>(base));
      at = base;
    }
    const int q = static_cast<int>((a >> 2) & 3);
    const uint32_t word = q == 0 ? w.x : q == 1 ? w.y : q == 2 ? w.z : w.w;
    return static_cast<int>((word >> (8 * (a & 3))) & 255u);
  }
};

// Ones of a plane at and before offset `off` (0..223) of the rank block
// (lo, hi): its prefix, the whole words before the offset's word, and that
// word under the mask.
__device__ __forceinline__ int32_t block_rank(const int4& lo, const int4& hi,
                                              int off) {
  const int wi = off >> 5;
  // 2u << 31 wraps to 0, so bit 31 gives the full mask, as in the reference
  const uint32_t mask = (2u << (off & 31)) - 1u;
  const uint32_t w[7] = {
      static_cast<uint32_t>(lo.y), static_cast<uint32_t>(lo.z),
      static_cast<uint32_t>(lo.w), static_cast<uint32_t>(hi.x),
      static_cast<uint32_t>(hi.y), static_cast<uint32_t>(hi.z),
      static_cast<uint32_t>(hi.w)};
  int32_t cnt = lo.x;
#pragma unroll
  for (int j = 0; j < 7; ++j)
    cnt += __popc(w[j] & (j < wi ? 0xffffffffu : j == wi ? mask : 0u));
  return cnt;
}

__global__ void __launch_bounds__(kThreads)
    fm_search(const uint8_t* __restrict__ pat, const int32_t* __restrict__ len,
              int64_t B, int64_t L, const int4* __restrict__ blocks,
              int64_t Wb, const int32_t* __restrict__ c_g,
              const int32_t* __restrict__ plane_g,
              const int32_t* __restrict__ kmer_tab, int bits, int k,
              int32_t* __restrict__ sp_out, int32_t* __restrict__ ep_out) {
  __shared__ int32_t c[257];
  __shared__ int32_t plane[256];
  __shared__ int64_t offs[kMaxK + 2];
  load_small_tables(c_g, plane_g, bits, k, c, plane, offs);

  const int64_t b = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (b >= B) return;
  Row row{pat + b * L, 1, make_uint4(0, 0, 0, 0)};
  const int32_t n_b = len[b];
  int32_t sp, ep;
  int64_t start_col;  // first column left of what the seed consumed
  if (k > 0) {
    const int2 seed = kmer_seed(row, L, n_b, plane, offs, kmer_tab, bits, k);
    sp = seed.x;
    ep = seed.y;
    start_col = L - k;
  } else {
    const int last = row(L - 1);
    sp = c[last];
    ep = c[last + 1] - 1;
    start_col = L - 1;
  }
  // columns descend, so once a pattern's left end (or column 0, for a length
  // past the width) or an empty range is reached it stays inactive: stop there
  for (int64_t col = start_col - 1; col >= 0 && col >= L - n_b && sp <= ep;
       --col) {
    const int ch = row(col);
    const int32_t r = plane[ch];
    const int32_t cs = c[ch];
    int32_t lo = 0, hi = 0;
    if (r >= 0) {
      // sp <= ep here, so ep >= 0 and a = sp - 1 >= -1
      const int32_t a = sp - 1;
      const int32_t be = ep / kBlockChars;
      const int32_t ba = a >= 0 ? a / kBlockChars : be;
      const int4* qe = blocks + 2 * (static_cast<int64_t>(r) * Wb + be);
      const int4 e0 = __ldg(qe), e1 = __ldg(qe + 1);
      int4 a0 = e0, a1 = e1;
      if (ba != be) {  // issued before either block is used
        const int4* qa = blocks + 2 * (static_cast<int64_t>(r) * Wb + ba);
        a0 = __ldg(qa);
        a1 = __ldg(qa + 1);
      }
      hi = block_rank(e0, e1, ep - be * kBlockChars);
      lo = a >= 0 ? block_rank(a0, a1, a - ba * kBlockChars) : 0;
    }
    sp = cs + lo;
    ep = cs + hi - 1;
  }
  sp_out[b] = sp;
  ep_out[b] = ep;
}

unsigned grid_of(int64_t B) {
  return static_cast<unsigned>((B + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

int gecoz_fm_search_max_k(void) { return kMaxK; }

// Backward search of B right-aligned patterns (uint8 [B, L]) with lengths
// int32 [B] against one block's rank table (int32 [sigma * Wb, 8], 32-byte
// aligned, Wb blocks a plane).  k = 0 starts from c[] alone; k > 0 seeds
// from kmer_tab (int32 [T, 2]) with `bits` bits per plane code.  Writes
// int32 sp, ep [B].  Enqueues on `stream`, never synchronises, and returns
// cudaGetLastError().  B >= 1, L >= 1.
int gecoz_fm_search(const void* patterns, const void* lengths, int64_t B,
                    int64_t L, const void* rank_blocks, int64_t Wb,
                    const void* c, const void* sym_plane, const void* kmer_tab,
                    int bits, int k, void* sp, void* ep, void* stream) {
  fm_search<<<grid_of(B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(patterns),
      static_cast<const int32_t*>(lengths), B, L,
      static_cast<const int4*>(rank_blocks), Wb,
      static_cast<const int32_t*>(c), static_cast<const int32_t*>(sym_plane),
      static_cast<const int32_t*>(kmer_tab), bits, k,
      static_cast<int32_t*>(sp), static_cast<int32_t*>(ep));
  return cudaGetLastError();
}

// Loads the search kernel: the first CUDA call of the library's (static)
// runtime initialises it, and the attribute query loads the kernel, work
// that would otherwise fall on the first launch.  Returns the error, or 0.
int gecoz_fm_init(void) {
  cudaFuncAttributes a;
  return static_cast<int>(
      cudaFuncGetAttributes(&a, reinterpret_cast<const void*>(fm_search)));
}

const char* gecoz_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
