// Streaming int32 scans for Hopper (sm_90a): cumsum, cummax, reverse cummin
// and the segmented fills, one kernel template over (combine op, direction).
//
// Replaces the Pallas TPU kernel gecoz_tpu/ops/scan_pallas.py::_scan_pallas
// (kernel body _make_kernel).  On the TPU the grid runs in order and carries
// the running value across chunks in SMEM; on Hopper blocks run in no order,
// so this is a reduce-then-scan in three launches:
//
//   1. tile_reduce: each block folds one tile of kTile elements to its
//      aggregate;
//   2. agg_scan: one block turns the aggregates into exclusive prefixes;
//   3. tile_scan: each block rescans its tile with that carry-in and writes.
//
// A tile is 256 threads x 16 int32.  Loads and stores are striped across the
// block (neighbouring threads on neighbouring addresses) and transposed
// through shared memory so each thread scans 16 consecutive elements; the
// threads' totals are combined by a __shfl_up_sync warp scan and a scan over
// the eight warp totals.  An input that fits one tile takes launch 3 alone.
//
// What bounds it: memory traffic.  It moves about 12 bytes per element (read
// in pass 1, read and write in pass 3), so at 3.35 TB/s a 64 Mi scan cannot
// beat ~0.24 ms.  A one-pass decoupled look-back scan (8 bytes per element)
// is the next step and work for a later change.
//
// Conventions kept from the TPU kernel:
//   * combine(closer, farther): "closer" is the element nearer the output
//     position in scan direction.  Op kLast (nearest non-negative wins) is
//     associative but NOT commutative, so every combine below keeps that
//     order: the warp scan, the warp-total scan and the tile carry.
//   * The ragged tail is padded with the op's unit (scan_pallas._UNITS).
//   * Reverse scans mirror the index (logical j -> physical n-1-j) inside
//     the kernel; no flipped copies are made.
//   * int32 add wraps (done in uint32; signed overflow is undefined in C++).
//   * Offsets are 64-bit, so n up to 2^31-1 is safe.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;  // 4096 elements
constexpr int kWarps = kThreads / 32;
constexpr int kSmem = kTile + kTile / 32;  // one pad word per 32: no bank conflicts
constexpr unsigned kFull = 0xffffffffu;

enum Op { kAdd = 0, kMax = 1, kMin = 2, kLast = 3 };

template <int OP>
struct Combine;

template <>
struct Combine<kAdd> {
  static constexpr int32_t unit = 0;
  __device__ static int32_t f(int32_t farther, int32_t closer) {
    return static_cast<int32_t>(static_cast<uint32_t>(farther) +
                                static_cast<uint32_t>(closer));
  }
};

template <>
struct Combine<kMax> {
  static constexpr int32_t unit = -2147483647 - 1;
  __device__ static int32_t f(int32_t farther, int32_t closer) {
    return closer > farther ? closer : farther;
  }
};

template <>
struct Combine<kMin> {
  static constexpr int32_t unit = 2147483647;
  __device__ static int32_t f(int32_t farther, int32_t closer) {
    return closer < farther ? closer : farther;
  }
};

template <>
struct Combine<kLast> {
  static constexpr int32_t unit = -1;
  __device__ static int32_t f(int32_t farther, int32_t closer) {
    return closer >= 0 ? closer : farther;
  }
};

__device__ __forceinline__ int pad(int k) { return k + (k >> 5); }

template <bool REV>
__device__ __forceinline__ int64_t phys(int64_t j, int64_t n) {
  return REV ? n - 1 - j : j;
}

// Logical elements [base, base + kTile) into registers, blocked: thread t
// holds v[i] = element base + t * kItems + i.  Past n reads the unit.
template <int OP, bool REV>
__device__ __forceinline__ void load_tile(const int32_t* __restrict__ x,
                                          int64_t n, int64_t base,
                                          int32_t* smem, int32_t (&v)[kItems]) {
#pragma unroll
  for (int m = 0; m < kItems; ++m) {
    const int k = m * kThreads + threadIdx.x;
    const int64_t j = base + k;
    smem[pad(k)] = j < n ? x[phys<REV>(j, n)] : Combine<OP>::unit;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kItems; ++i) v[i] = smem[pad(threadIdx.x * kItems + i)];
  __syncthreads();
}

// Blocked registers back to logical elements [base, base + kTile), striped.
// `shift` = 1 writes the exclusive form: element k gets v of k - 1, and
// element 0 gets `first`.
template <bool REV>
__device__ __forceinline__ void store_tile(int32_t* __restrict__ out,
                                           int64_t n, int64_t base,
                                           int32_t* smem,
                                           const int32_t (&v)[kItems],
                                           int shift, int32_t first) {
#pragma unroll
  for (int i = 0; i < kItems; ++i) smem[pad(threadIdx.x * kItems + i)] = v[i];
  __syncthreads();
#pragma unroll
  for (int m = 0; m < kItems; ++m) {
    const int k = m * kThreads + threadIdx.x;
    const int64_t j = base + k;
    if (j < n) out[phys<REV>(j, n)] = k < shift ? first : smem[pad(k - shift)];
  }
  __syncthreads();
}

// Inclusive scan of the tile held in v, in logical order, with `carry` (the
// combine of everything logically before the tile) folded in from the
// farther side.  Returns combine(carry, tile total).
template <int OP>
__device__ __forceinline__ int32_t block_scan(int32_t (&v)[kItems],
                                              int32_t carry, int32_t* wt) {
  using C = Combine<OP>;
#pragma unroll
  for (int i = 1; i < kItems; ++i) v[i] = C::f(v[i - 1], v[i]);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int32_t t = v[kItems - 1];
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int32_t o = __shfl_up_sync(kFull, t, d);
    if (lane >= d) t = C::f(o, t);
  }
  int32_t excl = __shfl_up_sync(kFull, t, 1);
  if (lane == 0) excl = C::unit;
  if (lane == 31) wt[warp] = t;
  __syncthreads();
  if (warp == 0) {
    int32_t w = lane < kWarps ? wt[lane] : C::unit;
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const int32_t o = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w = C::f(o, w);
    }
    int32_t we = __shfl_up_sync(kFull, w, 1);
    if (lane == 0) we = C::unit;
    if (lane < kWarps) wt[lane] = C::f(carry, we);
    if (lane == kWarps - 1) wt[kWarps] = C::f(carry, w);
  }
  __syncthreads();
  const int32_t pre = C::f(wt[warp], excl);
#pragma unroll
  for (int i = 0; i < kItems; ++i) v[i] = C::f(pre, v[i]);
  const int32_t total = wt[kWarps];
  __syncthreads();
  return total;
}

template <int OP, bool REV>
__global__ void __launch_bounds__(kThreads)
    tile_reduce(const int32_t* __restrict__ x, int32_t* __restrict__ agg,
                int64_t n) {
  __shared__ int32_t smem[kSmem];
  __shared__ int32_t wt[kWarps + 1];
  int32_t v[kItems];
  load_tile<OP, REV>(x, n, static_cast<int64_t>(blockIdx.x) * kTile, smem, v);
  const int32_t total = block_scan<OP>(v, Combine<OP>::unit, wt);
  if (threadIdx.x == 0) agg[blockIdx.x] = total;
}

// One block, in place: agg[t] <- combine of agg[0..t-1] (unit for t = 0).
template <int OP>
__global__ void __launch_bounds__(kThreads)
    agg_scan(int32_t* agg, int64_t tiles) {
  __shared__ int32_t smem[kSmem];
  __shared__ int32_t wt[kWarps + 1];
  int32_t v[kItems];
  int32_t carry = Combine<OP>::unit;
  for (int64_t base = 0; base < tiles; base += kTile) {
    load_tile<OP, false>(agg, tiles, base, smem, v);
    const int32_t total = block_scan<OP>(v, carry, wt);
    store_tile<false>(agg, tiles, base, smem, v, 1, carry);
    carry = total;
  }
}

template <int OP, bool REV>
__global__ void __launch_bounds__(kThreads)
    tile_scan(const int32_t* __restrict__ x, int32_t* __restrict__ out,
              const int32_t* __restrict__ carry_in, int64_t n) {
  __shared__ int32_t smem[kSmem];
  __shared__ int32_t wt[kWarps + 1];
  int32_t v[kItems];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  load_tile<OP, REV>(x, n, base, smem, v);
  const int32_t carry = carry_in ? carry_in[blockIdx.x] : Combine<OP>::unit;
  block_scan<OP>(v, carry, wt);
  store_tile<REV>(out, n, base, smem, v, 0, 0);
}

template <int OP, bool REV>
cudaError_t launch(const int32_t* x, int32_t* out, int32_t* agg, int64_t n,
                   cudaStream_t stream) {
  const int64_t tiles = (n + kTile - 1) / kTile;
  if (tiles > 1) {
    const unsigned grid = static_cast<unsigned>(tiles);
    tile_reduce<OP, REV><<<grid, kThreads, 0, stream>>>(x, agg, n);
    agg_scan<OP><<<1, kThreads, 0, stream>>>(agg, tiles);
    tile_scan<OP, REV><<<grid, kThreads, 0, stream>>>(x, out, agg, n);
  } else {
    tile_scan<OP, REV><<<1, kThreads, 0, stream>>>(x, out, nullptr, n);
  }
  return cudaGetLastError();
}

template <int OP>
cudaError_t launch_dir(const int32_t* x, int32_t* out, int32_t* agg,
                       int64_t n, int reverse, cudaStream_t stream) {
  return reverse ? launch<OP, true>(x, out, agg, n, stream)
                 : launch<OP, false>(x, out, agg, n, stream);
}

}  // namespace

extern "C" {

// Elements per tile: the caller sizes `agg` to ceil(n / tile) int32 when
// that count is above 1 (it may pass a null `agg` otherwise).
int64_t gecoz_scan_tile(void) { return kTile; }

// out[0..n) <- inclusive scan of x[0..n) under `op` (0 add, 1 max, 2 min,
// 3 last), back to front when `reverse`.  Enqueues on `stream`, never
// synchronises, and returns cudaGetLastError() (0 when the launches were
// accepted).  n must be >= 1; x and out must not overlap.
int gecoz_scan_i32(const void* x, void* out, void* agg, int64_t n, int op,
                   int reverse, void* stream) {
  const auto* xi = static_cast<const int32_t*>(x);
  auto* oi = static_cast<int32_t*>(out);
  auto* ai = static_cast<int32_t*>(agg);
  auto s = static_cast<cudaStream_t>(stream);
  switch (op) {
    case kAdd: return launch_dir<kAdd>(xi, oi, ai, n, reverse, s);
    case kMax: return launch_dir<kMax>(xi, oi, ai, n, reverse, s);
    case kMin: return launch_dir<kMin>(xi, oi, ai, n, reverse, s);
    case kLast: return launch_dir<kLast>(xi, oi, ai, n, reverse, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* gecoz_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
