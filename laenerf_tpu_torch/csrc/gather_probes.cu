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
// coalesced index reads and output writes. A random read still moves a
// whole 32-byte sector from L2 to the SM, so K2 cannot reach a bound that
// counts each distinct sector once (P1: 16.8 MB of sectors move against
// 4.2 MB of table). All three give a thread a chunk of 16 bytes of output,
// V = 16 / sizeof(T) consecutive outputs of one row (16 int8, 4 f32 or
// int32), on one launch shape (chunk_grid): a 2-D grid of chunks of a row
// by rows, so no thread divides, capped at about one wave of the card,
// after which a thread walks rows. A row of fewer than 32 chunks (K2 int8
// at W = 128: 8; K4 at P4b: 8, at P6: 1) gets a block narrower than a
// warp, and one warp covers several rows.
//   K2, K3 (one chunk body, gather_chunks, but for a table read's address):
//   the thread reads the chunk's V indices with V / 4 16-byte loads, issues
//   all V table reads before it uses one, and writes the chunk with one
//   16-byte store. K3 takes the index array's row stride (0: one row
//   serves all, and its indices stay in registers while a thread walks).
//   K4: the thread reads its ray's row, col and cell once (the ray's
//   threads read the same addresses: one broadcast each) and writes V
//   copies of the value with one 16-byte store.
// A call whose rows do not start on 16-byte boundaries (K2: W % V != 0; K3:
// N % V != 0; K4: lanes % V != 0, V of the output type) or whose index array
// or output is a view off a 16-byte boundary takes the scalar path for the
// whole call: the same chunks, read and written one element at a time,
// blockDim.x apart, so that each warp access stays coalesced.
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
#include <atomic>

namespace {

constexpr int kThreads = 256;    // most threads a block
constexpr int kMaxDevices = 64;  // devices whose size card_size keeps

__device__ __forceinline__ uint32_t bits(float v) { return __float_as_uint(v); }
__device__ __forceinline__ uint32_t bits(int32_t v) { return (uint32_t)v; }

// One 16-byte store of a chunk: 4 f32 or int32, or 16 int8 packed.
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

// One 16-byte store of 16 / sizeof(T) copies of v (K4).
template <typename T>
__device__ __forceinline__ void fill16(T* dst, T v) {
  const T c[4] = {v, v, v, v};
  store16(dst, c);
}
__device__ __forceinline__ void fill16(int8_t* dst, int8_t v) {
  const uint32_t w = (uint32_t)(uint8_t)v * 0x01010101u;
  *reinterpret_cast<uint4*>(dst) = make_uint4(w, w, w, w);
}

// The V indices of a chunk, at src = the index row + q0: V / 4 16-byte
// loads (kWide), or V loads `step` apart, lane 0 where !ok.
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

// Where output (r, q) with index i reads its table element: K3 at row r,
// lane i of an [R, L] table; K2 at row i, column q of an [R, W] one.
struct LaneAt {
  int64_t L;
  __device__ int64_t operator()(int64_t r, int64_t, int32_t i) const {
    return r * L + i;
  }
};
struct RowAt {
  int64_t W;
  __device__ int64_t operator()(int64_t, int64_t q, int32_t i) const {
    return (int64_t)i * W + q;
  }
};

// K2 and K3: thread (x, y) owns the V outputs q0 + j * step (j < V) of rows
// y, y + Y, ... (Y = gridDim.y * blockDim.y) of an [R, N] output, whose
// indices lie at the same places of idx, rows s apart (s = 0: one row
// serves all); output (r, q) with index i reads tbl[at(r, q, i)]. kWide:
// step 1, N % V == 0 and idx and out 16-byte aligned, so every chunk is
// whole and aligned. Scalar: step = blockDim.x, outputs past N skipped.
template <typename T, bool kWide, typename At>
__device__ __forceinline__ void gather_chunks(const T* __restrict__ tbl,
                                              const int32_t* __restrict__ idx,
                                              T* __restrict__ out, int64_t R,
                                              int64_t N, int64_t s, At at) {
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
  load_lanes<V, kWide>(lane, idx + r * s + q0, ok, step);
  while (true) {
    T v[V];  // every table read issued before any is used
#pragma unroll
    for (int j = 0; j < V; ++j)
      v[j] = ok[j] ? __ldg(tbl + at(r, q0 + j * step, lane[j])) : T(0);
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
    if (s != 0)  // a broadcast row's lanes stay in registers
      load_lanes<V, kWide>(lane, idx + r * s + q0, ok, step);
  }
}

template <typename T, bool kWide>
__global__ void __launch_bounds__(kThreads)
    take_rows_kernel(const T* __restrict__ tbl,
                     const int32_t* __restrict__ rows, T* __restrict__ out,
                     int64_t Q, int64_t W) {
  gather_chunks<T, kWide>(tbl, rows, out, Q, W, W, RowAt{W});
}

template <typename T, bool kWide>
__global__ void __launch_bounds__(kThreads)
    take_lanes_kernel(const T* __restrict__ tbl,
                      const int32_t* __restrict__ idx, T* __restrict__ out,
                      int64_t R, int64_t N, int64_t L,
                      int64_t idx_row_stride) {
  gather_chunks<T, kWide>(tbl, idx, out, R, N, idx_row_stride, LaneAt{L});
}

// K4: thread (x, y) owns the V lanes q0 + j * step (j < V), V of the output
// type, of rays y, y + Y, ... (Y = gridDim.y * blockDim.y). kWide: lanes %
// V == 0 and out 16-byte aligned, one 16-byte store of V copies. Scalar:
// step = blockDim.x, lanes past `lanes` skipped.
template <typename Tin, typename Tout, bool kWide>
__global__ void __launch_bounds__(kThreads)
    grid_probe_kernel(const Tin* __restrict__ grid,
                      const int32_t* __restrict__ row,
                      const int32_t* __restrict__ col, Tout* __restrict__ out,
                      int64_t Q, int64_t lanes, int64_t C) {
  constexpr int V = 16 / sizeof(Tout);
  const int64_t step = kWide ? 1 : blockDim.x;
  const int64_t q0 =
      kWide ? ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * V
            : (int64_t)blockIdx.x * blockDim.x * V + threadIdx.x;
  if (q0 >= lanes) return;
  const int64_t q_step = (int64_t)gridDim.y * blockDim.y;
  for (int64_t q = (int64_t)blockIdx.y * blockDim.y + threadIdx.y; q < Q;
       q += q_step) {
    const Tout v =
        (Tout)__ldg(grid + (int64_t)__ldg(row + q) * C + __ldg(col + q));
    Tout* dst = out + q * lanes + q0;
    if constexpr (kWide) {
      fill16(dst, v);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j)
        if (q0 + j * step < lanes) dst[j * step] = v;
    }
  }
}

// The current device's SM count and the most threads an SM holds, asked
// of the runtime once per device: the wrappers' host cost is the whole of
// a small call.
cudaError_t card_size(int* sms, int* per_sm) {
  static std::atomic<int> kept[kMaxDevices][2];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool keep = dev >= 0 && dev < kMaxDevices;
  if (keep) {
    *sms = kept[dev][0].load(std::memory_order_relaxed);
    *per_sm = kept[dev][1].load(std::memory_order_relaxed);
    if (*sms > 0 && *per_sm > 0) return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(per_sm,
                                 cudaDevAttrMaxThreadsPerMultiProcessor, dev);
  if (err == cudaSuccess && keep) {
    kept[dev][0].store(*sms, std::memory_order_relaxed);
    kept[dev][1].store(*per_sm, std::memory_order_relaxed);
  }
  return err;
}

// The launch of K2, K3 and K4 over `rows` rows of `chunks` chunks: blocks
// of up to kThreads threads, bx along a row's chunks (a power of two from
// 1: a row of fewer than 32 chunks shares its warp with other rows) and
// by = threads / bx rows, halved (down to one warp) while the grid would
// leave SMs idle; at most about one wave of blocks, after which each
// thread walks rows.
cudaError_t chunk_grid(int64_t chunks, int64_t rows, dim3* grid,
                       dim3* block) {
  int sms = 0, per_sm = 0;
  const cudaError_t err = card_size(&sms, &per_sm);
  if (err != cudaSuccess) return err;
  int threads = kThreads;
  while (threads > 32 && chunks * rows / threads < sms) threads /= 2;
  int bx = 1;
  while (bx < threads && bx < chunks) bx *= 2;
  const int by = threads / bx;
  const int64_t gx = (chunks + bx - 1) / bx;
  const int64_t wave = (int64_t)sms * per_sm / threads;  // blocks
  int64_t gy = (rows + by - 1) / by;
  gy = std::max<int64_t>(1, std::min<int64_t>({gy, wave / gx, 65535}));
  if (gx > INT_MAX) return cudaErrorInvalidConfiguration;
  *grid = dim3((unsigned)gx, (unsigned)gy);
  *block = dim3(bx, by);
  return cudaSuccess;
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

template <typename T>
int take_rows(const void* tbl, const void* rows, void* out, long long Q,
              long long W, void* stream) {
  if (Q <= 0 || W <= 0) return (int)cudaSuccess;
  constexpr int V = 16 / sizeof(T);
  dim3 grid, block;
  const cudaError_t err = chunk_grid((W + V - 1) / V, Q, &grid, &block);
  if (err != cudaSuccess) return (int)err;
  const auto s = (cudaStream_t)stream;
  if (W % V == 0 && aligned16(rows) && aligned16(out))
    take_rows_kernel<T, true><<<grid, block, 0, s>>>(
        (const T*)tbl, (const int32_t*)rows, (T*)out, (int64_t)Q, (int64_t)W);
  else
    take_rows_kernel<T, false><<<grid, block, 0, s>>>(
        (const T*)tbl, (const int32_t*)rows, (T*)out, (int64_t)Q, (int64_t)W);
  return (int)cudaGetLastError();
}

template <typename T>
int take_lanes(const void* tbl, const void* idx, void* out, long long R,
               long long L, long long N, long long idx_row_stride,
               void* stream) {
  if (R <= 0 || N <= 0) return (int)cudaSuccess;
  constexpr int V = 16 / sizeof(T);
  dim3 grid, block;
  const cudaError_t err = chunk_grid((N + V - 1) / V, R, &grid, &block);
  if (err != cudaSuccess) return (int)err;
  const auto s = (cudaStream_t)stream;
  if (N % V == 0 && aligned16(idx) && aligned16(out))
    take_lanes_kernel<T, true><<<grid, block, 0, s>>>(
        (const T*)tbl, (const int32_t*)idx, (T*)out, (int64_t)R, (int64_t)N,
        (int64_t)L, (int64_t)idx_row_stride);
  else
    take_lanes_kernel<T, false><<<grid, block, 0, s>>>(
        (const T*)tbl, (const int32_t*)idx, (T*)out, (int64_t)R, (int64_t)N,
        (int64_t)L, (int64_t)idx_row_stride);
  return (int)cudaGetLastError();
}

template <typename Tin, typename Tout>
int grid_probe(const void* grid, const void* row, const void* col, void* out,
               long long Q, long long lanes, long long C, void* stream) {
  if (Q <= 0 || lanes <= 0) return (int)cudaSuccess;
  constexpr int V = 16 / sizeof(Tout);
  dim3 g, block;
  const cudaError_t err = chunk_grid((lanes + V - 1) / V, Q, &g, &block);
  if (err != cudaSuccess) return (int)err;
  const auto s = (cudaStream_t)stream;
  if (lanes % V == 0 && aligned16(out))
    grid_probe_kernel<Tin, Tout, true><<<g, block, 0, s>>>(
        (const Tin*)grid, (const int32_t*)row, (const int32_t*)col,
        (Tout*)out, (int64_t)Q, (int64_t)lanes, (int64_t)C);
  else
    grid_probe_kernel<Tin, Tout, false><<<g, block, 0, s>>>(
        (const Tin*)grid, (const int32_t*)row, (const int32_t*)col,
        (Tout*)out, (int64_t)Q, (int64_t)lanes, (int64_t)C);
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
