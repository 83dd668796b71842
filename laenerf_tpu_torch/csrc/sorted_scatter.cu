// K5, K6: the sorted scatter-add, by hand for Hopper (sm_90a).
//
//   out[t, c] = sum over update rows q with qs[q] == t of gs[q, c]
//
// over update rows sorted by destination row, into a table of n_tiles tiles
// of `tile` rows. Rows outside [0, n_tiles * tile) are dropped.
//
// They replace three TPU prototypes of the hash-grid backward's scatter-add,
// which compute this one function and differ in their schedule:
//   K5 tile_scatter: perf/microbench_scatter2.py:137 _scatter_tile_kernel
//      (one grid step per 1,024-row table tile; a dynamic-trip fori_loop DMAs
//      the tile's sorted slab [lo[k], lo[k+1]) in 1,024-update sub-blocks and
//      accumulates one-hot [TILE, MAXU] @ [MAXU, C] MXU products).
//   K6 worklist_scatter: perf/probe_worklist.py:71 _kernel (f32 rows) and
//      perf/probe_worklist2.py:71 _kernel (bf16 rows): one grid step per
//      (table tile wt, update block wb) work item; the output block of a
//      tile is revisited by consecutive items and carried in VMEM.
// The one-hot products were the TPU's way to resolve conflicts without a
// scatter. Here a block accumulates its run of sorted updates with f32
// atomics into a [tile, C] f32 tile in shared memory (accumulate_run, shared
// by both kernels), the form the MXU products took.
//   K5: one block per table tile. It reads its own lo[k], lo[k+1] (the TPU's
//       scalar prefetch), walks its slab with a trip count that depends on
//       the data, and stores the whole tile once, coalesced: no global
//       atomics, no zero-fill.
//   K6: one block per work item. Blocks run in parallel and in no order, so
//       the TPU's revisited output block would be a race here: each block
//       adds the rows of the tile that its updates touched into a
//       zero-filled output with f32 atomicAdd (the TPU's wfirst zero-fill is
//       the wrapper's torch.zeros). Items with wreal == 0 do nothing.
//
// What bounds them on an H100: bytes. Each update row is read once (qs 4 B,
// gs 4 * C or 2 * C B) and each output row written once; at the probes' shape
// (2,097,152 updates of C = 8 into 2,937,856 rows) that is 169.5 MB with f32
// rows, 50.6 us at 3.35 TB/s. One f32 add per update element is far below
// the card's rate. What this first version does not address: the load is
// uneven (the probes' dense levels put up to 141,569 updates, 6.75% of all,
// into one 1,024-row tile, which one K5 block walks alone), and sorted runs
// hit one shared-memory row many times in a row, which serialises the shared
// atomics. A warp-segmented reduction, TMA slabs and persistent blocks are
// later work. The sum order of the atomics varies from run to run, so results
// match a sequential sum only to f32 rounding.
//
// Update rows come in as f32 or bf16; accumulation is always f32. Plain C
// interface, loaded with ctypes. Each kernel runs on the caller's stream and
// each entry point returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "smem.cuh"

namespace {

constexpr int kThreads = 512;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ int64_t clamp64(int64_t v, int64_t lo,
                                           int64_t hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Adds updates [begin, end) whose row lies in [base, base + tile) into the
// shared f32 tile acc[tile * C], one thread per (update, channel) element,
// and marks the rows it touched when `touched` is given.
template <typename T>
__device__ void accumulate_run(const int32_t* __restrict__ qs,
                               const T* __restrict__ gs, int64_t begin,
                               int64_t end, int64_t base, int tile, int C,
                               float* acc, unsigned char* touched) {
  const int64_t n = (end - begin) * C;
  for (int64_t i = threadIdx.x; i < n; i += blockDim.x) {
    const int64_t u = i / C;
    const int c = (int)(i - u * C);
    const int64_t q = begin + u;
    const int64_t local = (int64_t)qs[q] - base;
    if (local < 0 || local >= tile) continue;
    atomicAdd(acc + local * C + c, to_f32(gs[q * C + c]));
    if (touched != nullptr && c == 0) touched[local] = 1;
  }
}

__device__ void zero_shared(float* acc, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) acc[i] = 0.0f;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    tile_scatter_kernel(const int32_t* __restrict__ qs,
                        const T* __restrict__ gs,
                        const int32_t* __restrict__ lo,
                        float* __restrict__ out, int64_t Q, int tile, int C) {
  extern __shared__ float acc[];
  const int64_t k = blockIdx.x;
  const int64_t begin = clamp64(lo[k], 0, Q);
  const int64_t end = clamp64(lo[k + 1], begin, Q);
  zero_shared(acc, tile * C);
  __syncthreads();
  accumulate_run<T>(qs, gs, begin, end, k * tile, tile, C, acc, nullptr);
  __syncthreads();
  float* dst = out + k * tile * C;
  for (int i = threadIdx.x; i < tile * C; i += blockDim.x) dst[i] = acc[i];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    worklist_scatter_kernel(const int32_t* __restrict__ qs,
                            const T* __restrict__ gs,
                            const int32_t* __restrict__ wt,
                            const int32_t* __restrict__ wb,
                            const int32_t* __restrict__ wreal,
                            float* __restrict__ out, int64_t Q,
                            int64_t n_tiles, int tile, int maxu, int C) {
  const int64_t w = blockIdx.x;
  const int64_t t = wt[w];
  if (wreal[w] == 0 || t < 0 || t >= n_tiles) return;  // uniform per block
  extern __shared__ float acc[];
  unsigned char* touched = reinterpret_cast<unsigned char*>(acc + tile * C);
  const int64_t begin = clamp64((int64_t)wb[w] * maxu, 0, Q);
  const int64_t end = clamp64(begin + maxu, begin, Q);
  zero_shared(acc, tile * C);
  for (int i = threadIdx.x; i < tile; i += blockDim.x) touched[i] = 0;
  __syncthreads();
  accumulate_run<T>(qs, gs, begin, end, t * tile, tile, C, acc, touched);
  __syncthreads();
  float* dst = out + t * tile * C;
  for (int i = threadIdx.x; i < tile * C; i += blockDim.x) {
    if (touched[i / C]) atomicAdd(dst + i, acc[i]);
  }
}

template <typename T>
int tile_scatter(const void* qs, const void* gs, const void* lo, void* out,
                 long long Q, long long n_tiles, int tile, int C,
                 void* stream) {
  if (n_tiles <= 0) return (int)cudaSuccess;
  const size_t smem = (size_t)tile * C * sizeof(float);
  const int err = set_smem(tile_scatter_kernel<T>, smem);
  if (err != (int)cudaSuccess) return err;
  tile_scatter_kernel<T><<<(unsigned)n_tiles, kThreads, smem,
                           (cudaStream_t)stream>>>(
      (const int32_t*)qs, (const T*)gs, (const int32_t*)lo, (float*)out,
      (int64_t)Q, tile, C);
  return (int)cudaGetLastError();
}

template <typename T>
int worklist_scatter(const void* qs, const void* gs, const void* wt,
                     const void* wb, const void* wreal, void* out,
                     long long Q, long long n_items, long long n_tiles,
                     int tile, int maxu, int C, void* stream) {
  if (n_items <= 0) return (int)cudaSuccess;
  const size_t smem = (size_t)tile * C * sizeof(float) + (size_t)tile;
  const int err = set_smem(worklist_scatter_kernel<T>, smem);
  if (err != (int)cudaSuccess) return err;
  worklist_scatter_kernel<T><<<(unsigned)n_items, kThreads, smem,
                               (cudaStream_t)stream>>>(
      (const int32_t*)qs, (const T*)gs, (const int32_t*)wt,
      (const int32_t*)wb, (const int32_t*)wreal, (float*)out, (int64_t)Q,
      (int64_t)n_tiles, tile, maxu, C);
  return (int)cudaGetLastError();
}

}  // namespace

#define TILE_SCATTER(name, T)                                                \
  extern "C" int name(const void* qs, const void* gs, const void* lo,        \
                      void* out, long long Q, long long n_tiles, int tile,   \
                      int C, void* stream) {                                 \
    return tile_scatter<T>(qs, gs, lo, out, Q, n_tiles, tile, C, stream);    \
  }
TILE_SCATTER(tile_scatter_f32, float)
TILE_SCATTER(tile_scatter_bf16, __nv_bfloat16)

#define WORKLIST_SCATTER(name, T)                                            \
  extern "C" int name(const void* qs, const void* gs, const void* wt,        \
                      const void* wb, const void* wreal, void* out,          \
                      long long Q, long long n_items, long long n_tiles,     \
                      int tile, int maxu, int C, void* stream) {             \
    return worklist_scatter<T>(qs, gs, wt, wb, wreal, out, Q, n_items,       \
                               n_tiles, tile, maxu, C, stream);              \
  }
WORKLIST_SCATTER(worklist_scatter_f32, float)
WORKLIST_SCATTER(worklist_scatter_bf16, __nv_bfloat16)
