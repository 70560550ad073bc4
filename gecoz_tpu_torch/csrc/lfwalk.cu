// LF walks of decode and locate for Hopper (sm_90a): kernel K2, lf_walk.
//
// Replaces the Pallas TPU kernel tools/probe_gather2d.py::main (k_walk, the
// fused 32-step LF walk over a packed (lf << 8) | sym table, and the 2-D
// row/lane gathers it was built from), at the place the JAX package wanted
// it: the decode walks of decode_text_jit (gecoz_tpu/ops/fmq.py:842-892) and
// the fused-table locate walk of locate_batch (fmq.py:774-792).  Mosaic
// could not lower the 1-D walk gather, so the JAX package kept XLA gathers;
// here the walks chase rows in device memory.
//
// Entry points:
//   gecoz_lf_decode  W walks of `rate` steps from `seeds`; step j of walk w
//                    writes out[w * rate + rate - 1 - j].  Modes:
//                      0 lfk16: rows (LF^16, 8 plane codes, 8 plane codes),
//                               12 bytes;
//                      1 lfk8:  rows (LF^8, 8 plane codes), 8 bytes;
//                      2 lfk4:  rows (LF^4, 4 symbol bytes), 8 bytes;
//                    (lfk tables start 8-byte aligned);
//                      3 packed lf_tab rows (lf << 8) | sym (| mark << 31);
//                      4 plain  lf_tab rows lf (| mark << 31), the symbol
//                               read from bwt.
//                    Plane codes (4 bits, step j at bits 4j) turn back into
//                    bytes through a 16-entry map held in shared memory.
//   gecoz_lf_locate  per row: walk lf_tab until a row with bit 31 (sampled)
//                    is reached, at most rate + 1 reads, then the sampled
//                    value (rank in the mark plane, ssa_perm) plus the steps
//                    taken; -1 where no mark was reached.
//   gecoz_lf_init    loads the kernels (the library's CUDA runtime and its
//                    module) so that the first launch pays no set-up.
//
// What bounds it: dependent random reads from device memory.  Every step
// needs the row the previous step read, and at chromosome scale the tables
// (4-12 bytes a row, n rows) are far past the 50 MB L2, so every row read
// opens its own 32-byte sector of HBM.  Measured on the H100 (PERF.md),
// the walks run at the card's random-read rate, the rate of a library
// gather of as many random rows: in useful bytes, a fifth or less of the
// HBM's 3.35 TB/s.
//
// The design:
// * decode, lfk modes (the default path): a persistent grid (blocks = SMs
//   x the occupancy the kernel's registers and shared memory allow) walks
//   over warp tiles of 32 consecutive walks, one walk a lane.  A 12-byte
//   lfk16 row is read as two loads, an aligned 8-byte pair and a 4-byte
//   word (which pair depends on the row's parity), not three words, so the
//   table must be 8-byte aligned.  The output is staged per warp in shared
//   memory, a chunk of min(rate, 32) bytes of each of 32 walks at a time,
//   and written with 16-byte stores by consecutive lanes: at rate 32 a warp
//   tile is 1 KiB of contiguous output written as whole 128-byte lines
//   once, where one thread per walk wrote each 32-byte sector in two halves
//   from two separate rounds.  Chunks need rate <= 32 or rate % 32 == 0
//   (rates are powers of two).  Measured on the card and not taken
//   (PERF.md): 2 and 4 walks a thread, no faster, and rows padded to 16
//   bytes, 5% faster for a third more table memory.
// * locate keeps one walk a thread (lf_locate): on the H100 it already
//   reads rows faster than a library gather of as many random rows, and
//   both alternatives measured on the card were slower
//   (PERF.md): a persistent kernel whose lanes each held 1-4 walks as small
//   state machines and took the warp's next row when one ended, and an L2
//   access-policy window keeping ssa_perm resident while lf_tab streams.
// * packed and plain rows keep one thread per walk (their tables are the
//   per-step lf_tab; they are off the default path).
// Offsets into the tables and the output are 64-bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;             // staged bytes a walk, at most

enum Mode { kLfk16 = 0, kLfk8 = 1, kLfk4 = 2, kPacked = 3, kPlain = 4 };

// Four output bytes (little-endian in the word) from four 4-bit plane codes
// of `word`, the code at bits 4 * top first and 4 * (top - 3) last.
__device__ __forceinline__ uint32_t codes4(const uint8_t* map, uint32_t word,
                                           int top) {
  uint32_t out = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    out |= static_cast<uint32_t>(map[(word >> (4 * (top - i))) & 15u])
           << (8 * i);
  return out;
}

// ---------------------------------------------------------------- decode

// One fused row: the LF^k target and up to two words of step symbols.
struct Row {
  uint32_t next, a, b;
};

template <int kMode>
__device__ __forceinline__ Row load_row(const uint32_t* __restrict__ tab,
                                        uint32_t idx) {
  Row r;
  if (kMode == kLfk16) {
    // row idx starts at word 3 idx: an odd row's words 1-2 and an even
    // row's words 0-1 are an 8-byte aligned pair; the third word is apart
    const uint32_t* p = tab + 3 * static_cast<int64_t>(idx);
    const uint32_t odd = idx & 1u;
    const uint2 pair = __ldg(reinterpret_cast<const uint2*>(p + odd));
    const uint32_t single = __ldg(p + (odd ? 0 : 2));
    r.next = odd ? single : pair.x;
    r.a = odd ? pair.x : pair.y;
    r.b = odd ? pair.y : single;
  } else {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(tab) + idx);
    r.next = v.x; r.a = v.y; r.b = 0;
  }
  return r;
}

// The k bytes of one row, latest step first, stored at `dst` (k-aligned).
template <int kMode>
__device__ __forceinline__ void put_row(const uint8_t* map, const Row& r,
                                        uint8_t* dst) {
  if (kMode == kLfk16) {
    // word b's codes 7..0, then word a's codes 7..0
    uint4 v;
    v.x = codes4(map, r.b, 7);
    v.y = codes4(map, r.b, 3);
    v.z = codes4(map, r.a, 7);
    v.w = codes4(map, r.a, 3);
    *reinterpret_cast<uint4*>(dst) = v;
  } else if (kMode == kLfk8) {
    uint2 v;
    v.x = codes4(map, r.a, 7);
    v.y = codes4(map, r.a, 3);
    *reinterpret_cast<uint2*>(dst) = v;
  } else {
    // step j's byte at bits 8j; memory order is latest step first
    *reinterpret_cast<uint32_t*>(dst) = __byte_perm(r.a, 0, 0x0123);
  }
}

// Write a staged chunk: rows 0..nrows-1 of `st` (C bytes each) are bytes
// [col, col + C) of walks wbase.. wbase+nrows-1.  C == rate: the rows are
// contiguous in `out`; else C == 32 and each row is one whole sector.
__device__ __forceinline__ void flush(const uint8_t* st, uint8_t* out,
                                      int64_t wbase, int nrows, int rate,
                                      int col, int C, int lane) {
  if (C == rate) {
    uint8_t* dst = out + wbase * rate;
    const int nbytes = nrows * C;
    for (int p = 16 * lane; p < nbytes; p += 16 * 32) {
      if (p + 16 <= nbytes) {
        *reinterpret_cast<uint4*>(dst + p) =
            *reinterpret_cast<const uint4*>(st + p);
      } else {
        for (int q = p; q < nbytes; ++q) dst[q] = st[q];
      }
    }
  } else {
    for (int p = lane; p < 2 * nrows; p += 32) {
      const int row = p >> 1, half = 16 * (p & 1);
      *reinterpret_cast<uint4*>(out + (wbase + row) * rate + col + half) =
          *reinterpret_cast<const uint4*>(st + kChunk * row + half);
    }
  }
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
    lf_decode_tiles(const uint32_t* __restrict__ tab,
                    const int32_t* __restrict__ seeds, int64_t W, int rate,
                    const uint8_t* __restrict__ map_g,
                    uint8_t* __restrict__ out) {
  constexpr int K = kMode == kLfk16 ? 16 : kMode == kLfk8 ? 8 : 4;
  __shared__ __align__(16) uint8_t stage[kWarps][32 * kChunk];
  __shared__ uint8_t map[16];
  if (kMode != kLfk4) {
    if (threadIdx.x < 16) map[threadIdx.x] = map_g[threadIdx.x];
    __syncthreads();
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int C = rate < kChunk ? rate : kChunk;
  const int64_t tiles = (W + 31) / 32;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
       t < tiles; t += static_cast<int64_t>(gridDim.x) * kWarps) {
    const int64_t w0 = 32 * t;
    const bool live = w0 + lane < W;
    const int nrows = static_cast<int>(W - w0 < 32 ? W - w0 : 32);
    uint32_t idx = live ? static_cast<uint32_t>(seeds[w0 + lane]) : 0u;
    for (int col = rate - C; col >= 0; col -= C) {
      // chunk: bytes [col, col + C) of every walk, rounds latest first
      for (int off = C - K; off >= 0; off -= K) {
        if (live) {
          const Row r = load_row<kMode>(tab, idx);
          put_row<kMode>(map, r, &stage[warp][lane * C + off]);
          idx = r.next;
        }
      }
      __syncwarp();
      flush(stage[warp], out, w0, nrows, rate, col, C, lane);
      __syncwarp();
    }
  }
}

// Per-step rows (packed, plain): one thread per walk.
template <int kMode>
__global__ void __launch_bounds__(kThreads)
    lf_decode_steps(const uint32_t* __restrict__ tab,
                    const uint8_t* __restrict__ bwt,
                    const int32_t* __restrict__ seeds, int64_t W, int rate,
                    uint8_t* __restrict__ out) {
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (w >= W) return;
  uint8_t* o = out + w * rate;
  uint32_t idx = static_cast<uint32_t>(seeds[w]);
  for (int j = 0; j < rate; ++j) {
    const uint32_t v = __ldg(tab + idx);
    if (kMode == kPacked) {
      o[rate - 1 - j] = static_cast<uint8_t>(v & 255u);
      idx = (v >> 8) & 0x7FFFFFu;
    } else {
      o[rate - 1 - j] = __ldg(bwt + idx);
      idx = v & 0x7FFFFFFFu;
    }
  }
}

// ----------------------------------------------------------------- locate

// One walk a thread: 256 threads a block, one block per 256 rows.  A walk
// ends at the first row with bit 31 set (at most rate + 1 reads); the row's
// rank among the sampled rows (popcount in the mark plane) picks its value.
__global__ void __launch_bounds__(kThreads)
    lf_locate(const uint32_t* __restrict__ tab,
              const int32_t* __restrict__ rows, int64_t B,
              const uint32_t* __restrict__ mark_words,
              const int32_t* __restrict__ mark_pre,
              const int32_t* __restrict__ ssa_perm, int sf, int packed,
              int32_t* __restrict__ out) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (b >= B) return;
  uint32_t idx = static_cast<uint32_t>(rows[b]);
  const int rate = 1 << sf;
  for (int steps = 0; steps <= rate; ++steps) {
    const uint32_t v = __ldg(tab + idx);
    if (v >> 31) {
      const uint32_t wd = idx >> 5;
      const uint32_t mask = (2u << (idx & 31u)) - 1u;
      const int32_t rank =
          __ldg(mark_pre + wd) + __popc(__ldg(mark_words + wd) & mask);
      out[b] = (__ldg(ssa_perm + (rank > 1 ? rank - 1 : 0)) << sf) + steps;
      return;
    }
    idx = packed ? (v >> 8) & 0x7FFFFFu : v & 0x7FFFFFFFu;
  }
  out[b] = -1;
}

// ------------------------------------------------------------- launching

unsigned grid_for(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

// Blocks that fill every SM to the occupancy the kernel's registers and
// shared memory allow (asked once per kernel: the port runs on one card).
template <typename Kernel>
int64_t resident_blocks(Kernel kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  return static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
}

// A persistent grid: at most one resident wave, never more than `want`.
unsigned persistent_grid(int64_t full, int64_t want) {
  return static_cast<unsigned>(want < full ? (want > 0 ? want : 1) : full);
}

template <int kMode>
void launch_tiles(const uint32_t* t, const int32_t* s, int64_t W, int rate,
                  const uint8_t* m, uint8_t* o, cudaStream_t st) {
  auto kernel = lf_decode_tiles<kMode>;
  static const int64_t full = resident_blocks(kernel);
  const int64_t blocks = (W + 32 * kWarps - 1) / (32 * kWarps);
  kernel<<<persistent_grid(full, blocks), kThreads, 0, st>>>(t, s, W, rate, m,
                                                             o);
}

}  // namespace

extern "C" {

// W walks (int32 seeds [W]) of `rate` steps over `tab` in `mode` (see the
// top of this file); writes uint8 out [W, rate].  `bwt` is read in mode 4
// only, `code_map` (uint8 [16]) in modes 0 and 1 only.  The lfk modes need
// rate % k == 0, rate <= 32 or rate % 32 == 0, and an 8-byte aligned
// `tab`.  Enqueues on `stream`, never synchronises, and returns
// cudaGetLastError().  W >= 1.
int gecoz_lf_decode(const void* tab, const void* bwt, const void* seeds,
                    int64_t W, int rate, int mode, const void* code_map,
                    void* out, void* stream) {
  const auto t = static_cast<const uint32_t*>(tab);
  const auto s = static_cast<const int32_t*>(seeds);
  const auto m = static_cast<const uint8_t*>(code_map);
  const auto o = static_cast<uint8_t*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  if (mode <= kLfk4 && ((rate > kChunk && rate % kChunk) ||
                        reinterpret_cast<uintptr_t>(tab) % 8))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (mode) {
    case kLfk16: launch_tiles<kLfk16>(t, s, W, rate, m, o, st); break;
    case kLfk8: launch_tiles<kLfk8>(t, s, W, rate, m, o, st); break;
    case kLfk4: launch_tiles<kLfk4>(t, s, W, rate, m, o, st); break;
    case kPacked:
      lf_decode_steps<kPacked><<<grid_for(W), kThreads, 0, st>>>(
          t, nullptr, s, W, rate, o);
      break;
    case kPlain:
      lf_decode_steps<kPlain><<<grid_for(W), kThreads, 0, st>>>(
          t, static_cast<const uint8_t*>(bwt), s, W, rate, o);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// B locate walks from rows (int32 [B]) over lf_tab (packed != 0: packed
// rows) with the mark plane (u32 words, int32 exclusive prefixes) and the
// sampled values ssa_perm (>> sf, row order); writes int32 out [B].
// Enqueues on `stream`, never synchronises, returns cudaGetLastError().
// B >= 1.
int gecoz_lf_locate(const void* tab, const void* rows, int64_t B,
                    const void* mark_words, const void* mark_pre,
                    const void* ssa_perm, int sf, int packed, void* out,
                    void* stream) {
  lf_locate<<<grid_for(B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(tab), static_cast<const int32_t*>(rows), B,
      static_cast<const uint32_t*>(mark_words),
      static_cast<const int32_t*>(mark_pre),
      static_cast<const int32_t*>(ssa_perm), sf, packed,
      static_cast<int32_t*>(out));
  return cudaGetLastError();
}

// Load every kernel the paths launch now: the first CUDA call of the
// library's (static) runtime initialises it, and each attribute query
// loads a kernel, work that would otherwise fall on the first launch.
// Returns the first error, or 0.
int gecoz_lf_init(void) {
  cudaFuncAttributes a;
  const void* kernels[] = {
      reinterpret_cast<const void*>(lf_decode_tiles<kLfk16>),
      reinterpret_cast<const void*>(lf_decode_tiles<kLfk8>),
      reinterpret_cast<const void*>(lf_decode_tiles<kLfk4>),
      reinterpret_cast<const void*>(lf_decode_steps<kPacked>),
      reinterpret_cast<const void*>(lf_decode_steps<kPlain>),
      reinterpret_cast<const void*>(lf_locate)};
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
