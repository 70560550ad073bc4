// Streaming int32 scans for Hopper (sm_90a): cumsum, cummax, reverse cummin
// and the segmented fills, one kernel template over (combine op, direction).
//
// Replaces the Pallas TPU kernel gecoz_tpu/ops/scan_pallas.py::_scan_pallas
// (kernel body _make_kernel).  On the TPU the grid runs in order and carries
// the running value across chunks in SMEM; on Hopper blocks run in no order,
// so the carry crosses blocks through memory: a single-pass scan with
// decoupled look-back, one launch.
//
//   * Tile ids come from an atomicAdd on a counter in the scratch, in the
//     order blocks start, so a block only ever waits on tiles whose blocks
//     are already running: forward progress holds whatever the scheduler
//     does.
//   * Each tile has one 64-bit status word: a flag (none, aggregate,
//     inclusive prefix) in bits 32-33 and the int32 value in bits 0-31,
//     written by one 64-bit store after a __threadfence() and read with
//     volatile loads, so a reader never sees a flag without its value.
//   * A block scans its tile, publishes the tile's aggregate at once, then
//     its first warp looks back over the 32 nearest predecessors at a time:
//     __ballot_sync finds the nearest inclusive prefix, and the values from
//     that tile up to the current one are folded in order; a window with no
//     prefix folds all 32 aggregates and steps 32 tiles back.  The block
//     then publishes its own inclusive prefix and applies the exclusive one.
//   * Tiles lie on out's 16-byte grid in both directions, so stores are 16
//     bytes wide but at the array's two ends; loads are 16 bytes wide
//     wherever the 16 bytes lie whole inside x, so any 4-byte aligned view
//     such as x[1:] works.  Both go through shared memory, striped across
//     the block, and each thread scans kItems consecutive elements; the
//     threads' totals are combined by a __shfl_up_sync warp scan and a scan
//     over the warp totals.
//
// What bounds it: memory traffic.  It moves 8 bytes per element (one read,
// one write) plus 8 bytes of status per tile, so at 3.35 TB/s a 64 Mi scan
// cannot beat ~0.16 ms; the three-launch reduce-then-scan it replaced moved
// 12 bytes per element.  The scratch is int64 [tiles + 1], zeroed by the
// caller (the last word is the tile counter); an input of one tile needs
// none.  The tile shape is a constant (PathShape: 256 threads x 32, five
// blocks an SM); gecoz_scan_sweep runs the add at the shapes it is timed
// against (chip_smoke.py).
//
// Conventions kept from the TPU kernel:
//   * combine(farther, closer): "closer" is the element nearer the output
//     position in scan direction.  Op kLast (nearest non-negative wins) is
//     associative but NOT commutative, so every combine below keeps that
//     order: the warp scan, the warp-total scan and the look-back, where
//     the running value of the closer tiles becomes f(farther, running).
//   * The ragged tail is padded with the op's unit (scan_pallas._UNITS).
//   * Reverse scans mirror the index (logical j -> physical n-1-j) inside
//     the kernel; no flipped copies are made.
//   * int32 add wraps (done in uint32; signed overflow is undefined in C++).
//   * Offsets are 64-bit, so n up to 2^31-1 is safe.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

using u64 = unsigned long long;
constexpr unsigned kFull = 0xffffffffu;
constexpr u64 kFlagAgg = 1ull << 32;   // the tile's own aggregate
constexpr u64 kFlagPre = 2ull << 32;   // the inclusive prefix through the tile

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

// A tile of THREADS x ITEMS elements (ITEMS a multiple of 4), MINB blocks
// resident on an SM: __launch_bounds__ then caps a thread's registers at
// 65536 / (THREADS * MINB).
template <int THREADS, int ITEMS, int MINB>
struct Shape {
  static constexpr int kMinBlocks = MINB;
  static constexpr int kThreads = THREADS;
  static constexpr int kItems = ITEMS;
  static constexpr int kTile = THREADS * ITEMS;
  static constexpr int kWarps = THREADS / 32;
  static constexpr int kSmem = kTile + kTile / 32;  // a pad word per 32
  static constexpr int kVecs = ITEMS / 4 + 1;       // 16-byte slots a thread
};

// The shape every entry point launches, and the ones the sweep times it
// against (PERF.md): 256 x 32 beat 256 x 16 and 512 x 16; the sweep holds
// five blocks an SM (48 registers, no spills) against four (64).
using PathShape = Shape<256, 32, 5>;
using Sweep1 = Shape<256, 32, 4>;
using Sweep2 = Shape<256, 16, 6>;

// One pad word per 32 keeps both the striped (stride 1 and 4) and the
// blocked (stride kItems) shared-memory accesses free of bank conflicts.
__device__ __forceinline__ int pad(int k) { return k + (k >> 5); }

// Elements of `p` before the 16-byte boundary at or below it.
__device__ __forceinline__ int lead(const int32_t* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

__device__ __forceinline__ void publish(u64* word, u64 flag, int32_t v) {
  __threadfence();
  *reinterpret_cast<volatile u64*>(word) = flag | static_cast<uint32_t>(v);
}

// The tile's elements x[p0, p0 + cnt) into smem at their logical offsets
// (mirrored when REV); slots [cnt, kTile) get the unit.  16-byte loads cover
// [p0 - lead, p0 + cnt) on the array's 16-byte grid; a slot that does not lie
// whole inside x[0, n) is read element by element.  Values of the
// neighbouring tiles that a slot also reads are dropped.
template <int OP, bool REV, class S>
__device__ __forceinline__ void load_tile(const int32_t* __restrict__ x,
                                          int64_t n, int64_t p0, int cnt,
                                          int32_t* smem) {
  const int head = lead(x + p0);
  const int64_t q0 = p0 - head;
  const int nvec = (head + cnt + 3) >> 2;
  int4 r[S::kVecs];
#pragma unroll
  for (int m = 0; m < S::kVecs; ++m) {
    const int v = m * S::kThreads + threadIdx.x;
    const int64_t e0 = q0 + 4 * static_cast<int64_t>(v);
    r[m] = make_int4(Combine<OP>::unit, Combine<OP>::unit, Combine<OP>::unit,
                     Combine<OP>::unit);
    if (v < nvec) {
      if (e0 >= 0 && e0 + 4 <= n) {
        r[m] = __ldg(reinterpret_cast<const int4*>(x + e0));
      } else {
        if (e0 >= 0 && e0 < n) r[m].x = x[e0];
        if (e0 + 1 >= 0 && e0 + 1 < n) r[m].y = x[e0 + 1];
        if (e0 + 2 >= 0 && e0 + 2 < n) r[m].z = x[e0 + 2];
        if (e0 + 3 >= 0 && e0 + 3 < n) r[m].w = x[e0 + 3];
      }
    }
  }
#pragma unroll
  for (int m = 0; m < S::kVecs; ++m) {
    const int v = m * S::kThreads + threadIdx.x;
    if (v >= nvec) continue;
    const int k0 = 4 * v - head;  // logical-in-tile offset of r[m].x (fwd)
    const int32_t val[4] = {r[m].x, r[m].y, r[m].z, r[m].w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int k = k0 + c;
      if (k >= 0 && k < cnt) smem[pad(REV ? cnt - 1 - k : k)] = val[c];
    }
  }
  for (int k = cnt + threadIdx.x; k < S::kTile; k += S::kThreads)
    smem[pad(k)] = Combine<OP>::unit;
  __syncthreads();
}

// smem's first cnt logical elements to out[p0, p0 + cnt) (mirrored when
// REV): 16-byte stores for slots whole inside the tile, scalar ones at its
// two ends, so no store touches a neighbouring tile.
template <bool REV, class S>
__device__ __forceinline__ void store_tile(int32_t* __restrict__ out,
                                           int64_t p0, int cnt,
                                           const int32_t* smem) {
  const int head = lead(out + p0);
  const int64_t q0 = p0 - head;
  const int nvec = (head + cnt + 3) >> 2;
#pragma unroll
  for (int m = 0; m < S::kVecs; ++m) {
    const int v = m * S::kThreads + threadIdx.x;
    if (v >= nvec) continue;
    const int k0 = 4 * v - head;
    int32_t val[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int k = k0 + c;
      val[c] = k >= 0 && k < cnt ? smem[pad(REV ? cnt - 1 - k : k)] : 0;
    }
    int32_t* dst = out + q0 + 4 * static_cast<int64_t>(v);
    if (k0 >= 0 && k0 + 4 <= cnt) {
      *reinterpret_cast<int4*>(dst) =
          make_int4(val[0], val[1], val[2], val[3]);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (k0 + c >= 0 && k0 + c < cnt) dst[c] = val[c];
    }
  }
}

// Inclusive scan of the tile held in v (thread t holds logical elements
// t * kItems + i), in logical order.  Returns the tile's total.
template <int OP, class S>
__device__ __forceinline__ int32_t block_scan(int32_t (&v)[S::kItems],
                                              int32_t* wt) {
  using C = Combine<OP>;
#pragma unroll
  for (int i = 1; i < S::kItems; ++i) v[i] = C::f(v[i - 1], v[i]);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int32_t t = v[S::kItems - 1];
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
    int32_t w = lane < S::kWarps ? wt[lane] : C::unit;
#pragma unroll
    for (int d = 1; d < S::kWarps; d <<= 1) {
      const int32_t o = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w = C::f(o, w);
    }
    int32_t we = __shfl_up_sync(kFull, w, 1);
    if (lane == 0) we = C::unit;
    if (lane < S::kWarps) wt[lane] = we;
    if (lane == S::kWarps - 1) wt[S::kWarps] = w;
  }
  __syncthreads();
  const int32_t pre = C::f(wt[warp], excl);
#pragma unroll
  for (int i = 0; i < S::kItems; ++i) v[i] = C::f(pre, v[i]);
  const int32_t total = wt[S::kWarps];
  __syncthreads();
  return total;
}

// Run by the 32 lanes of one warp for tile `tile` >= 1 with aggregate
// `agg`: publishes the aggregate, folds the predecessors back to the
// nearest inclusive prefix, publishes this tile's inclusive prefix and
// returns the exclusive one (on every lane).
template <int OP>
__device__ int32_t look_back(u64* status, int64_t tile, int32_t agg) {
  using C = Combine<OP>;
  const int lane = threadIdx.x & 31;
  if (lane == 0) publish(status + tile, kFlagAgg, agg);
  int32_t acc = C::unit;  // the tiles already folded, closer than the window
  for (int64_t top = tile - 1;; top -= 32) {
    const int64_t t = top - lane;  // lane 0 is the nearest predecessor
    u64 w = kFlagPre | static_cast<uint32_t>(C::unit);
    do {
      if (t >= 0) w = *reinterpret_cast<const volatile u64*>(status + t);
    } while (__any_sync(kFull, (w >> 32) == 0));
    const unsigned pre = __ballot_sync(kFull, (w & kFlagPre) != 0);
    const int stop = pre ? __ffs(pre) - 1 : 31;
    int32_t r = lane <= stop ? static_cast<int32_t>(static_cast<uint32_t>(w))
                             : C::unit;
    // lanes [l, l + 2d) fold as f(lanes [l + d, l + 2d), lanes [l, l + d))
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t o = __shfl_down_sync(kFull, r, d);
      if (lane + d < 32) r = C::f(o, r);
    }
    acc = C::f(__shfl_sync(kFull, r, 0), acc);
    if (pre) break;
  }
  if (lane == 0) publish(status + tile, kFlagPre, C::f(acc, agg));
  return acc;
}

// Tiles lie on out's 16-byte grid, whatever the direction: physical tile j
// is [j * kTile - g, (j + 1) * kTile - g) within [0, n), g = lead(out), so
// only the array's two ends take scalar stores.  There are
// ceil((n + g) / kTile) of them.
template <class S>
int64_t tiles_of(const int32_t* out, int64_t n) {
  const auto g = static_cast<int64_t>(
      (reinterpret_cast<uintptr_t>(out) >> 2) & 3);
  return (n + g + S::kTile - 1) / S::kTile;
}

// One tile a block, in logical order of tile ids (a reverse scan takes the
// physical tiles from the top).  status: int64 [tiles + 1], zeroed, the
// last word the tile counter; nullptr when there is one tile.
template <int OP, bool REV, class S>
__global__ void __launch_bounds__(S::kThreads, S::kMinBlocks)
    scan_onepass(const int32_t* __restrict__ x, int32_t* __restrict__ out,
                 u64* status, int64_t n, int64_t tiles) {
  using C = Combine<OP>;
  __shared__ int32_t smem[S::kSmem];
  __shared__ int32_t wt[S::kWarps + 1];
  __shared__ int64_t tile_id;
  __shared__ int32_t carry;
  if (threadIdx.x == 0)
    tile_id = status ? static_cast<int64_t>(atomicAdd(status + tiles, 1ull))
                     : 0;
  __syncthreads();
  const int64_t tile = tile_id;
  const int64_t j = REV ? tiles - 1 - tile : tile;  // physical tile
  const int64_t lo = j * S::kTile - lead(out);
  const int64_t p0 = lo > 0 ? lo : 0;
  const int cnt = static_cast<int>(
      (lo + S::kTile < n ? lo + S::kTile : n) - p0);
  load_tile<OP, REV, S>(x, n, p0, cnt, smem);
  int32_t v[S::kItems];
#pragma unroll
  for (int i = 0; i < S::kItems; ++i)
    v[i] = smem[pad(threadIdx.x * S::kItems + i)];
  const int32_t agg = block_scan<OP, S>(v, wt);
  if (tile == 0) {
    if (status != nullptr && threadIdx.x == 0)
      publish(status, kFlagPre, agg);
  } else {
    if (threadIdx.x < 32) {
      const int32_t e = look_back<OP>(status, tile, agg);
      if (threadIdx.x == 0) carry = e;
    }
    __syncthreads();
    const int32_t e = carry;
#pragma unroll
    for (int i = 0; i < S::kItems; ++i) v[i] = C::f(e, v[i]);
  }
#pragma unroll
  for (int i = 0; i < S::kItems; ++i)
    smem[pad(threadIdx.x * S::kItems + i)] = v[i];
  __syncthreads();
  store_tile<REV, S>(out, p0, cnt, smem);
}

template <int OP, bool REV, class S>
cudaError_t launch(const int32_t* x, int32_t* out, u64* status, int64_t n,
                   cudaStream_t stream) {
  const int64_t tiles = tiles_of<S>(out, n);
  scan_onepass<OP, REV, S><<<static_cast<unsigned>(tiles), S::kThreads, 0,
                             stream>>>(x, out, tiles > 1 ? status : nullptr,
                                       n, tiles);
  return cudaGetLastError();
}

template <int OP>
cudaError_t launch_dir(const int32_t* x, int32_t* out, u64* status, int64_t n,
                       int reverse, cudaStream_t stream) {
  return reverse ? launch<OP, true, PathShape>(x, out, status, n, stream)
                 : launch<OP, false, PathShape>(x, out, status, n, stream);
}

}  // namespace

extern "C" {

// Elements per tile: the caller passes a zeroed int64 scratch of tiles + 1
// words, tiles = ceil((n + g) / tile) with g = (out's address / 4) % 4,
// when that count is above 1 (it may pass a null scratch otherwise).
int64_t gecoz_scan_tile(void) { return PathShape::kTile; }

// out[0..n) <- inclusive scan of x[0..n) under `op` (0 add, 1 max, 2 min,
// 3 last), back to front when `reverse`: one launch.  Enqueues on `stream`,
// never synchronises, and returns cudaGetLastError() (0 when the launch was
// accepted).  n must be >= 1; x and out must not overlap.
int gecoz_scan_i32(const void* x, void* out, void* status, int64_t n, int op,
                   int reverse, void* stream) {
  const auto* xi = static_cast<const int32_t*>(x);
  auto* oi = static_cast<int32_t*>(out);
  auto* st = static_cast<u64*>(status);
  auto s = static_cast<cudaStream_t>(stream);
  switch (op) {
    case kAdd: return launch_dir<kAdd>(xi, oi, st, n, reverse, s);
    case kMax: return launch_dir<kMax>(xi, oi, st, n, reverse, s);
    case kMin: return launch_dir<kMin>(xi, oi, st, n, reverse, s);
    case kLast: return launch_dir<kLast>(xi, oi, st, n, reverse, s);
    default: return cudaErrorInvalidValue;
  }
}

// The tile-shape sweep (chip_smoke.py): the forward add at shape 0 (the
// path's, 256 x 32 at five blocks an SM), 1 (256 x 32 at four) or 2
// (256 x 16 at six).  The tile of a shape, or
// 0 for an unknown one; scratch as for gecoz_scan_i32.
int64_t gecoz_scan_sweep_tile(int shape) {
  switch (shape) {
    case 0: return PathShape::kTile;
    case 1: return Sweep1::kTile;
    case 2: return Sweep2::kTile;
    default: return 0;
  }
}

int gecoz_scan_sweep(const void* x, void* out, void* status, int64_t n,
                     int shape, void* stream) {
  const auto* xi = static_cast<const int32_t*>(x);
  auto* oi = static_cast<int32_t*>(out);
  auto* st = static_cast<u64*>(status);
  auto s = static_cast<cudaStream_t>(stream);
  switch (shape) {
    case 0: return launch<kAdd, false, PathShape>(xi, oi, st, n, s);
    case 1: return launch<kAdd, false, Sweep1>(xi, oi, st, n, s);
    case 2: return launch<kAdd, false, Sweep2>(xi, oi, st, n, s);
    default: return cudaErrorInvalidValue;
  }
}

// Loads the path's kernels: the first CUDA call of the library's (static)
// runtime initialises it, and each attribute query loads a kernel, work
// that would otherwise fall on the first launch.  Returns the first error,
// or 0.
int gecoz_scan_init(void) {
  cudaFuncAttributes a;
  const void* kernels[] = {
      reinterpret_cast<const void*>(scan_onepass<kAdd, false, PathShape>),
      reinterpret_cast<const void*>(scan_onepass<kAdd, true, PathShape>),
      reinterpret_cast<const void*>(scan_onepass<kMax, false, PathShape>),
      reinterpret_cast<const void*>(scan_onepass<kMax, true, PathShape>),
      reinterpret_cast<const void*>(scan_onepass<kMin, false, PathShape>),
      reinterpret_cast<const void*>(scan_onepass<kMin, true, PathShape>),
      reinterpret_cast<const void*>(scan_onepass<kLast, false, PathShape>),
      reinterpret_cast<const void*>(scan_onepass<kLast, true, PathShape>)};
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
