// LF walks of decode and locate for Hopper (sm_90a): kernel K2, lf_walk.
//
// Replaces the Pallas TPU kernel tools/probe_gather2d.py::main (k_walk, the
// fused 32-step LF walk over a packed (lf << 8) | sym table, and the 2-D
// row/lane gathers it was built from), at the place the JAX package wanted
// it: the decode walks of decode_text_jit (gecoz_tpu/ops/fmq.py:842-892) and
// the fused-table locate walk of locate_batch (fmq.py:774-792).  Mosaic
// could not lower the 1-D walk gather, so the JAX package kept XLA gathers;
// here each walk is one thread chasing rows in device memory.
//
// Entry points:
//   gecoz_lf_decode  W walks of `rate` steps from `seeds`; step j of walk w
//                    writes out[w * rate + rate - 1 - j].  Modes:
//                      0 lfk16: rows (LF^16, 8 plane codes, 8 plane codes),
//                               12 bytes, 4-byte aligned;
//                      1 lfk8:  rows (LF^8, 8 plane codes), 8 bytes;
//                      2 lfk4:  rows (LF^4, 4 symbol bytes), 8 bytes;
//                      3 packed lf_tab rows (lf << 8) | sym (| mark << 31);
//                      4 plain  lf_tab rows lf (| mark << 31), the symbol
//                               read from bwt.
//                    Plane codes (4 bits, step j at bits 4j) turn back into
//                    bytes through a 16-entry map held in shared memory.
//   gecoz_lf_locate  per row: walk lf_tab until a row with bit 31 (sampled)
//                    is reached, at most rate + 1 reads, then the sampled
//                    value (rank in the mark plane, ssa_perm) plus the steps
//                    taken; -1 where no mark was reached.
//
// What bounds it: dependent random reads from device memory.  Every step
// needs the row the previous step read, and at chromosome scale the tables
// (4-12 bytes a row, n rows) are far past the 50 MB L2, so a walk's time is
// its read count times the latency of a read.  The design keeps one walk
// per thread with 256 threads a block and as many blocks as walks, so that
// tens of thousands of independent reads are in flight across the SMs; the
// fused k-step rows cut the reads of a decode walk by k (16 text bytes per
// 12-byte read at the default sampling of 32); a round's k output bytes
// are assembled in registers and written with one k-byte store.
// Interleaving several walks per thread and L2 access-policy windows are
// later work.
//
// Offsets into the tables and the output are 64-bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

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

template <int kMode>
__global__ void __launch_bounds__(kThreads)
    lf_decode(const uint32_t* __restrict__ tab, const uint8_t* __restrict__ bwt,
              const int32_t* __restrict__ seeds, int64_t W, int rate,
              const uint8_t* __restrict__ map_g, uint8_t* __restrict__ out) {
  __shared__ uint8_t map[16];
  if (kMode == kLfk16 || kMode == kLfk8) {
    if (threadIdx.x < 16) map[threadIdx.x] = map_g[threadIdx.x];
    __syncthreads();
  }
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (w >= W) return;
  uint8_t* o = out + w * rate;
  uint32_t idx = static_cast<uint32_t>(seeds[w]);
  if (kMode == kLfk16) {
    // round r covers steps 16r .. 16r+15, bytes rate-16(r+1) .. rate-16r-1,
    // latest step first: word 2's codes 7..0, then word 1's codes 7..0
    for (int r = 0; r < rate / 16; ++r) {
      const uint32_t* row = tab + 3 * static_cast<int64_t>(idx);
      const uint32_t nxt = __ldg(row), a = __ldg(row + 1), b = __ldg(row + 2);
      uint4 v;
      v.x = codes4(map, b, 7);
      v.y = codes4(map, b, 3);
      v.z = codes4(map, a, 7);
      v.w = codes4(map, a, 3);
      *reinterpret_cast<uint4*>(o + rate - 16 * (r + 1)) = v;
      idx = nxt;
    }
  } else if (kMode == kLfk8) {
    for (int r = 0; r < rate / 8; ++r) {
      const uint2 row =
          __ldg(reinterpret_cast<const uint2*>(tab) + static_cast<int64_t>(idx));
      uint2 v;
      v.x = codes4(map, row.y, 7);
      v.y = codes4(map, row.y, 3);
      *reinterpret_cast<uint2*>(o + rate - 8 * (r + 1)) = v;
      idx = row.x;
    }
  } else if (kMode == kLfk4) {
    for (int r = 0; r < rate / 4; ++r) {
      const uint2 row =
          __ldg(reinterpret_cast<const uint2*>(tab) + static_cast<int64_t>(idx));
      // step j's byte at bits 8j; memory order is latest step first
      *reinterpret_cast<uint32_t*>(o + rate - 4 * (r + 1)) =
          __byte_perm(row.y, 0, 0x0123);
      idx = row.x;
    }
  } else {
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
}

__global__ void __launch_bounds__(kThreads)
    lf_locate(const uint32_t* __restrict__ tab, const int32_t* __restrict__ rows,
              int64_t B, const uint32_t* __restrict__ mark_words,
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
      // sampled here: its rank among the sampled rows picks the value
      const uint32_t wd = idx >> 5;
      const uint32_t mask = (2u << (idx & 31u)) - 1u;  // bit 31: wraps to ~0
      const int32_t rank =
          __ldg(mark_pre + wd) + __popc(__ldg(mark_words + wd) & mask);
      out[b] = (__ldg(ssa_perm + (rank > 1 ? rank - 1 : 0)) << sf) + steps;
      return;
    }
    idx = packed ? (v >> 8) & 0x7FFFFFu : v & 0x7FFFFFFFu;
  }
  out[b] = -1;
}

unsigned grid_for(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// W walks (int32 seeds [W]) of `rate` steps over `tab` in `mode` (see the
// top of this file); writes uint8 out [W, rate].  `bwt` is read in mode 4
// only, `code_map` (uint8 [16]) in modes 0 and 1 only.  The lfk modes need
// rate % k == 0.  Enqueues on `stream`, never synchronises, and returns
// cudaGetLastError().  W >= 1.
int gecoz_lf_decode(const void* tab, const void* bwt, const void* seeds,
                    int64_t W, int rate, int mode, const void* code_map,
                    void* out, void* stream) {
  const auto t = static_cast<const uint32_t*>(tab);
  const auto bw = static_cast<const uint8_t*>(bwt);
  const auto s = static_cast<const int32_t*>(seeds);
  const auto m = static_cast<const uint8_t*>(code_map);
  const auto o = static_cast<uint8_t*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  const unsigned g = grid_for(W);
  switch (mode) {
    case kLfk16: lf_decode<kLfk16><<<g, kThreads, 0, st>>>(t, bw, s, W, rate, m, o); break;
    case kLfk8: lf_decode<kLfk8><<<g, kThreads, 0, st>>>(t, bw, s, W, rate, m, o); break;
    case kLfk4: lf_decode<kLfk4><<<g, kThreads, 0, st>>>(t, bw, s, W, rate, m, o); break;
    case kPacked: lf_decode<kPacked><<<g, kThreads, 0, st>>>(t, bw, s, W, rate, m, o); break;
    case kPlain: lf_decode<kPlain><<<g, kThreads, 0, st>>>(t, bw, s, W, rate, m, o); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return cudaGetLastError();
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

const char* gecoz_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
