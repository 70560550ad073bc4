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
// of it then run backward in the same launch, each step two occ lookups: a
// bit word and its rank prefix from plane_words/plane_pres, then
// __popc(word & mask).  The active/bad rules of search_batch apply exactly,
// so (sp, ep) equal the reference's bit for bit.
//
// What bounds it: dependent random reads from device memory.  Each step's
// two occ lookups land on random words of plane arrays that outgrow the
// 50 MB L2 at chromosome scale, and the next step needs their result, so a
// pattern's time is its step count times the latency of a read.  The design
// keeps many patterns in flight (one thread each, 256 a block, blocks on
// every SM), issues the two lookups of a step (sp and ep) together, and
// keeps the small tables in shared memory so that only plane reads go to
// device memory.  Interleaving several patterns per thread is later work.
//
// Offsets into the planes, the patterns and the k-mer table are 64-bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 32;  // longest k-mer level the offsets table holds

// Count of the symbol with plane row `row` in BWT[0..pos] (0 when pos < 0 or
// the symbol is absent: row < 0).
__device__ __forceinline__ int32_t occ(const uint32_t* __restrict__ words,
                                       const int32_t* __restrict__ pres,
                                       int64_t W, int32_t row, int32_t pos) {
  if (pos < 0 || row < 0) return 0;
  const int64_t base = static_cast<int64_t>(row) * W + (pos >> 5);
  // 2u << 31 wraps to 0, so bit 31 gives the full mask, as in the reference
  const uint32_t mask = (2u << (pos & 31)) - 1u;
  return __ldg(pres + base) + __popc(__ldg(words + base) & mask);
}

__global__ void __launch_bounds__(kThreads)
    fm_search(const uint8_t* __restrict__ pat, const int32_t* __restrict__ len,
              int64_t B, int64_t L, const uint32_t* __restrict__ words,
              const int32_t* __restrict__ pres, int64_t W,
              const int32_t* __restrict__ c_g,
              const int32_t* __restrict__ plane_g,
              const int32_t* __restrict__ kmer_tab, int bits, int k,
              int32_t* __restrict__ sp_out, int32_t* __restrict__ ep_out) {
  __shared__ int32_t c[257];
  __shared__ int32_t plane[256];
  __shared__ int64_t offs[kMaxK + 2];
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

  const int64_t b = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (b >= B) return;
  const uint8_t* p = pat + b * L;
  const int32_t n_b = len[b];
  int32_t sp, ep;
  int64_t start_col;  // first column left of what the seed consumed
  if (k > 0) {
    // char at column L-1-t sits at bit position bits*t of the code
    uint32_t code = 0;
    bool bad = false;
    for (int t = 0; t < k; ++t) {
      const int32_t row = plane[p[L - 1 - t]];
      code |= static_cast<uint32_t>(row > 0 ? row : 0) << (bits * t);
      bad |= row < 0 && t < n_b;  // absent symbol inside the query
    }
    const int j = n_b < 1 ? 1 : (n_b > k ? k : n_b);
    code &= (1u << (bits * j)) - 1u;
    const int2 seed =
        *reinterpret_cast<const int2*>(kmer_tab + 2 * (offs[j] + code));
    sp = bad ? 1 : seed.x;
    ep = bad ? 0 : seed.y;
    start_col = L - k;
  } else {
    const int last = p[L - 1];
    sp = c[last];
    ep = c[last + 1] - 1;
    start_col = L - 1;
  }
  // columns descend, so once a pattern's left end (or column 0, for a length
  // past the width) or an empty range is reached it stays inactive: stop there
  for (int64_t col = start_col - 1; col >= 0 && col >= L - n_b && sp <= ep;
       --col) {
    const int ch = p[col];
    const int32_t row = plane[ch];
    const int32_t cs = c[ch];
    const int32_t lo = occ(words, pres, W, row, sp - 1);
    const int32_t hi = occ(words, pres, W, row, ep);
    sp = cs + lo;
    ep = cs + hi - 1;
  }
  sp_out[b] = sp;
  ep_out[b] = ep;
}

}  // namespace

extern "C" {

int gecoz_fm_search_max_k(void) { return kMaxK; }

// Backward search of B right-aligned patterns (uint8 [B, L]) with lengths
// int32 [B] against one block's planes (W words per plane).  k = 0 starts
// from c[] alone; k > 0 seeds from kmer_tab (int32 [T, 2]) with `bits` bits
// per plane code.  Writes int32 sp, ep [B].  Enqueues on `stream`, never
// synchronises, and returns cudaGetLastError().  B >= 1, L >= 1.
int gecoz_fm_search(const void* patterns, const void* lengths, int64_t B,
                    int64_t L, const void* words, const void* pres, int64_t W,
                    const void* c, const void* sym_plane, const void* kmer_tab,
                    int bits, int k, void* sp, void* ep, void* stream) {
  const unsigned grid = static_cast<unsigned>((B + kThreads - 1) / kThreads);
  fm_search<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(patterns),
      static_cast<const int32_t*>(lengths), B, L,
      static_cast<const uint32_t*>(words), static_cast<const int32_t*>(pres),
      W, static_cast<const int32_t*>(c), static_cast<const int32_t*>(sym_plane),
      static_cast<const int32_t*>(kmer_tab), bits, k,
      static_cast<int32_t*>(sp), static_cast<int32_t*>(ep));
  return cudaGetLastError();
}

const char* gecoz_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
