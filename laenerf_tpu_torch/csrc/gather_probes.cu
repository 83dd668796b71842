// K2, K3, K4: the gather probes, by hand for Hopper (sm_90a).
//
//   K2 take_rows   out[i, j] = tbl[rows[i, j], j]          tbl [R, W], rows [Q, W]
//   K3 take_lanes  out[r, q] = tbl[r, idx[r * s + q]]      tbl [R, L], idx [R or 1, N]
//   K4 grid_probe  out[q, j] = grid[row[q], col[q]]        grid [R, C], j < lanes
//
// They replace the TPU gather probes, which are all jnp.take_along_axis on
// whole VMEM arrays (Mosaic's tpu.dynamic_gather):
//   K2: perf/microbench_pallas.py:77 _k_ax0 (P1, P2b), :99 _k_ax0_i8 (P2);
//       perf/microbench_gather.py:174 _kernel (G), :200 _kernel2 (G2).
//   K3: perf/microbench_pallas.py:138 _k_ax1 (P3), :230 _k_wide (P3x).
//   K4: perf/microbench_pallas.py:167 _k_march_probe (P4, P4b: the one-event
//       occupancy lookup, written into all 128 lanes), :261 _k_two_step (P6:
//       the wide gather plus one-hot row select, one int32 lane out).
// The TPU forms are shaped by Mosaic: the index array must have the table's
// shape, the (8, 128) tiling, and G2's 2048-row query blocks for VMEM
// residency. None of that exists here. K3 takes the index array's row stride
// (0 for _k_wide's broadcast row), so the broadcast is never materialised;
// K4 reads one (row, col) pair per ray instead of a broadcast-row gather
// followed by a lane select.
//
// What bounds them on an H100: bytes. There is no arithmetic. Each output
// element is one random 4-byte or 1-byte read from a table that sits in the
// 50 MB L2 (the largest, P4's [16384, 128] int32 grid, is 8 MB), beside
// coalesced index reads and output writes. K2 and K4 are one thread per
// output element with a grid-stride loop. K3 gives each thread a chunk of
// V = 16 / sizeof(T) consecutive outputs of a row (16 int8, 4 f32 or
// int32): it reads the chunk's V indices with 16-byte loads, issues all V
// table reads before it uses one, and writes the chunk with one 16-byte
// store. The grid is 2-D (chunks of a row by rows), so no thread divides;
// it is capped at about one wave of the card, and a thread then walks rows
// (with a broadcast index row, s = 0, its indices stay in registers). A
// call whose rows do not start on 16-byte boundaries (N % V != 0) or whose
// idx is a view at an offset off a 16-byte boundary takes the scalar path
// for the whole call: the same chunks of V, read and written one element
// at a time, V apart, so that each warp access stays coalesced.
//
// Indices must lie in range (the TPU kernels' mode="promise_in_bounds"); the
// wrappers' plain versions raise on indices out of range, the kernels do not
// check. Plain C interface, loaded with ctypes. Each kernel runs on the
// caller's stream and each entry point returns cudaGetLastError() after the
// launch.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 32768;  // grid-stride beyond ~250 blocks/SM

unsigned blocks_for(int64_t n) {
  const int64_t b = (n + kThreads - 1) / kThreads;
  return (unsigned)(b < kMaxBlocks ? b : kMaxBlocks);
}

template <typename T>
__global__ void take_rows_kernel(const T* __restrict__ tbl,
                                 const int32_t* __restrict__ rows,
                                 T* __restrict__ out, int64_t n, int64_t W) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int64_t j = i % W;
    out[i] = tbl[(int64_t)rows[i] * W + j];
  }
}

constexpr int kLaneThreads = 256;  // K3: most threads a block

__device__ __forceinline__ uint32_t bits(float v) { return __float_as_uint(v); }
__device__ __forceinline__ uint32_t bits(int32_t v) { return (uint32_t)v; }

// One 16-byte store of a K3 chunk: 4 f32 or int32, or 16 int8 packed.
template <typename T>
__device__ __forceinline__ void store16(T* dst, const T (&v)[4]) {
  *reinterpret_cast<uint4*>(dst) =
      make_uint4(bits(v[0]), bits(v[1]), bits(v[2]), bits(v[3]));
}
__device__ __forceinline__ void store16(int8_t* dst, const int8_t (&v)[16]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = (uint32_t)(uint8_t)v[4 * i] | (uint32_t)(uint8_t)v[4 * i + 1] << 8 |
           (uint32_t)(uint8_t)v[4 * i + 2] << 16 |
           (uint32_t)(uint8_t)v[4 * i + 3] << 24;
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}

// K3: the V indices of a chunk, at src = the index row + q0: V / 4
// 16-byte loads (kWide), or V loads `step` apart, lane 0 where !ok.
template <int V, bool kWide>
__device__ __forceinline__ void load_lanes(int32_t (&lane)[V],
                                           const int32_t* __restrict__ src,
                                           const bool (&ok)[V],
                                           int64_t step) {
  if constexpr (kWide) {
#pragma unroll
    for (int j = 0; j < V; j += 4) {
      const int4 w = __ldg(reinterpret_cast<const int4*>(src + j));
      lane[j] = w.x, lane[j + 1] = w.y, lane[j + 2] = w.z, lane[j + 3] = w.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) lane[j] = ok[j] ? __ldg(src + j * step) : 0;
  }
}

// K3: thread (x, y) owns the V outputs q0 + j * step (j < V) of rows
// y, y + Y, ... where Y = gridDim.y * blockDim.y. kWide: step 1, N % V == 0
// and idx and out 16-byte aligned, so every chunk is whole and aligned.
// Scalar: step = blockDim.x, outputs past N skipped.
template <typename T, bool kWide>
__global__ void __launch_bounds__(kLaneThreads)
    take_lanes_kernel(const T* __restrict__ tbl,
                      const int32_t* __restrict__ idx, T* __restrict__ out,
                      int64_t R, int64_t N, int64_t L,
                      int64_t idx_row_stride) {
  constexpr int V = 16 / sizeof(T);
  const int64_t step = kWide ? 1 : blockDim.x;
  const int64_t q0 =
      kWide ? ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * V
            : (int64_t)blockIdx.x * blockDim.x * V + threadIdx.x;
  int64_t r = (int64_t)blockIdx.y * blockDim.y + threadIdx.y;
  if (q0 >= N || r >= R) return;
  const int64_t r_step = (int64_t)gridDim.y * blockDim.y;
  bool ok[V];
#pragma unroll
  for (int j = 0; j < V; ++j) ok[j] = kWide || q0 + j * step < N;
  int32_t lane[V];
  load_lanes<V, kWide>(lane, idx + r * idx_row_stride + q0, ok, step);
  while (true) {
    const T* row = tbl + r * L;
    T v[V];  // every table read issued before any is used
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = ok[j] ? __ldg(row + lane[j]) : T(0);
    T* dst = out + r * N + q0;
    if constexpr (kWide) {
      store16(dst, v);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j)
        if (ok[j]) dst[j * step] = v[j];
    }
    r += r_step;
    if (r >= R) break;
    if (idx_row_stride != 0)  // a broadcast row's lanes stay in registers
      load_lanes<V, kWide>(lane, idx + r * idx_row_stride + q0, ok, step);
  }
}

template <typename Tin, typename Tout>
__global__ void grid_probe_kernel(const Tin* __restrict__ grid,
                                  const int32_t* __restrict__ row,
                                  const int32_t* __restrict__ col,
                                  Tout* __restrict__ out, int64_t n,
                                  int64_t lanes, int64_t C) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int64_t q = i / lanes;
    out[i] = (Tout)grid[(int64_t)row[q] * C + col[q]];
  }
}

template <typename T>
int take_rows(const void* tbl, const void* rows, void* out, long long Q,
              long long W, void* stream) {
  const int64_t n = (int64_t)Q * W;
  if (n <= 0) return (int)cudaSuccess;
  take_rows_kernel<T><<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)tbl, (const int32_t*)rows, (T*)out, n, (int64_t)W);
  return (int)cudaGetLastError();
}

// K3's launch: blocks of up to kLaneThreads threads, bx along a row's
// chunks and by = threads / bx rows, halved (down to one warp) while the
// grid would leave SMs idle; at most about one wave of blocks, after which
// each thread walks rows.
template <typename T>
int take_lanes(const void* tbl, const void* idx, void* out, long long R,
               long long L, long long N, long long idx_row_stride,
               void* stream) {
  if (R <= 0 || N <= 0) return (int)cudaSuccess;
  constexpr int V = 16 / sizeof(T);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&per_sm,
                                 cudaDevAttrMaxThreadsPerMultiProcessor, dev);
  if (err != cudaSuccess) return (int)err;
  const int64_t chunks = (N + V - 1) / V;  // a row's chunks of V outputs
  int threads = kLaneThreads;
  while (threads > 32 && chunks * R / threads < sms) threads /= 2;
  int bx = 32;
  while (bx < threads && bx < chunks) bx *= 2;
  const int by = threads / bx;
  const int64_t gx = (chunks + bx - 1) / bx;
  const int64_t wave = (int64_t)sms * per_sm / threads;  // blocks
  int64_t gy = (R + by - 1) / by;
  gy = std::max<int64_t>(1, std::min<int64_t>({gy, wave / gx, 65535}));
  if (gx > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)gx, (unsigned)gy), block(bx, by);
  const bool wide = N % V == 0 && (uintptr_t)idx % 16 == 0 &&
                    (uintptr_t)out % 16 == 0;
  if (wide)
    take_lanes_kernel<T, true><<<grid, block, 0, (cudaStream_t)stream>>>(
        (const T*)tbl, (const int32_t*)idx, (T*)out, (int64_t)R, (int64_t)N,
        (int64_t)L, (int64_t)idx_row_stride);
  else
    take_lanes_kernel<T, false><<<grid, block, 0, (cudaStream_t)stream>>>(
        (const T*)tbl, (const int32_t*)idx, (T*)out, (int64_t)R, (int64_t)N,
        (int64_t)L, (int64_t)idx_row_stride);
  return (int)cudaGetLastError();
}

template <typename Tin, typename Tout>
int grid_probe(const void* grid, const void* row, const void* col, void* out,
               long long Q, long long lanes, long long C, void* stream) {
  const int64_t n = (int64_t)Q * lanes;
  if (n <= 0) return (int)cudaSuccess;
  grid_probe_kernel<Tin, Tout>
      <<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
          (const Tin*)grid, (const int32_t*)row, (const int32_t*)col,
          (Tout*)out, n, (int64_t)lanes, (int64_t)C);
  return (int)cudaGetLastError();
}

}  // namespace

#define TAKE_ROWS(name, T)                                                  \
  extern "C" int name(const void* tbl, const void* rows, void* out,         \
                      long long Q, long long W, void* stream) {             \
    return take_rows<T>(tbl, rows, out, Q, W, stream);                      \
  }
TAKE_ROWS(take_rows_f32, float)
TAKE_ROWS(take_rows_i32, int32_t)
TAKE_ROWS(take_rows_i8, int8_t)

#define TAKE_LANES(name, T)                                                 \
  extern "C" int name(const void* tbl, const void* idx, void* out,          \
                      long long R, long long L, long long N,                \
                      long long idx_row_stride, void* stream) {             \
    return take_lanes<T>(tbl, idx, out, R, L, N, idx_row_stride, stream);   \
  }
TAKE_LANES(take_lanes_f32, float)
TAKE_LANES(take_lanes_i32, int32_t)
TAKE_LANES(take_lanes_i8, int8_t)

#define GRID_PROBE(name, Tin, Tout)                                         \
  extern "C" int name(const void* grid, const void* row, const void* col,   \
                      void* out, long long Q, long long lanes, long long C, \
                      void* stream) {                                       \
    return grid_probe<Tin, Tout>(grid, row, col, out, Q, lanes, C, stream); \
  }
GRID_PROBE(grid_probe_f32_f32, float, float)
GRID_PROBE(grid_probe_i32_i32, int32_t, int32_t)
GRID_PROBE(grid_probe_i8_i8, int8_t, int8_t)
GRID_PROBE(grid_probe_i8_i32, int8_t, int32_t)
