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
// coalesced index reads and output writes. This first version is one thread
// per output element with a grid-stride loop; vector loads, TMA and keeping
// a table in shared memory are later work.
//
// Indices must lie in range (the TPU kernels' mode="promise_in_bounds"); the
// wrappers' plain versions raise on indices out of range, the kernels do not
// check. Plain C interface, loaded with ctypes. Each kernel runs on the
// caller's stream and each entry point returns cudaGetLastError() after the
// launch.

#include <cuda_runtime.h>
#include <stdint.h>

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

template <typename T>
__global__ void take_lanes_kernel(const T* __restrict__ tbl,
                                  const int32_t* __restrict__ idx,
                                  T* __restrict__ out, int64_t n, int64_t N,
                                  int64_t L, int64_t idx_row_stride) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int64_t r = i / N;
    const int64_t q = i - r * N;
    out[i] = tbl[r * L + idx[r * idx_row_stride + q]];
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

template <typename T>
int take_lanes(const void* tbl, const void* idx, void* out, long long R,
               long long L, long long N, long long idx_row_stride,
               void* stream) {
  const int64_t n = (int64_t)R * N;
  if (n <= 0) return (int)cudaSuccess;
  take_lanes_kernel<T><<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)tbl, (const int32_t*)idx, (T*)out, n, (int64_t)N,
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
