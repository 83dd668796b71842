// K7: the construct probes, by hand for Hopper (sm_90a).
//
// perf/bisect_mosaic.py tried one Pallas construct per kernel (k1 ... k7,
// k6b) to find which one the TPU compiler refused: the constructs that the
// sorted scatter-add (perf/microbench_scatter2.py:137) is built from. Each
// entry point here is the Hopper counterpart of one of them. Every one writes
// an f32 [n_tiles * tile, C] output, one block per tile k:
//
//   k1 probe_prefetch_write   tile k = lo[k]: the block reads its own index
//                             (scalar prefetch, bisect_mosaic.py:28)
//   k2 probe_static_copy      tile k = g[0 : tile] by a bulk asynchronous
//                             copy into shared memory that completes on an
//                             mbarrier (static 2-D DMA, :46)
//   k3 probe_dynamic_copy     tile k = g[lo[k] : lo[k] + tile], the same copy
//                             at an offset read from memory (:70)
//   k4 probe_copy_1d          row r of tile k = q[lo[k] + r], a 1-D int32
//                             bulk copy (:97)
//   k5 probe_dynamic_loop     tile k = 1 added lo[k] times: a loop whose trip
//                             count is read from memory (fori_loop, :124)
//   k6 probe_onehot_dot       tile k = onehot(local_k) @ g_k: the [tile, maxu]
//                             one-hot of local_k [maxu] (row r, column m is
//                             local_k[m] == r) times g_k [maxu, C] bf16, on
//                             the tensor cores (wmma, f32 accumulation);
//                             C = 8 (:149) and C = 128 (k6b, :170)
//   k7 probe_iota             row r of tile k = r (a 1-D iota, :190)
//
// What bounds them on an H100: the launch. The outputs are 256 KB (C = 8) and
// 4 MB (C = 128), below a microsecond of memory time; k6b's product is 2.1
// GFLOP at bf16 tensor-core rate, about 2 us. k6 skips the 16-column steps of
// the product whose one-hot block is all zero (the sum is the same), so its
// work follows the one-hot's nonzeros, not tile * maxu.
//
// Bulk copies need 16-byte aligned addresses and sizes: the wrappers check
// the base pointers and that a row of g is a multiple of 16 bytes; k4 copies
// the 16-byte aligned window around q[lo[k] : lo[k] + tile], which stays
// inside q when q's length is a multiple of 4. Offsets must lie in range (the
// plain versions raise, the kernels do not check). Plain C interface, loaded
// with ctypes. Each kernel runs on the caller's stream and each entry point
// returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "smem.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One thread: announce `bytes` and start the copy gmem -> smem on `bar`.
__device__ __forceinline__ void bulk_load(void* smem, const void* gmem,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(smem)),
      "l"(gmem), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

__global__ void prefetch_write_kernel(const int32_t* __restrict__ lo,
                                      float* __restrict__ out, int tile,
                                      int C) {
  const float v = (float)lo[blockIdx.x];
  float* dst = out + (int64_t)blockIdx.x * tile * C;
  for (int i = threadIdx.x; i < tile * C; i += blockDim.x) dst[i] = v;
}

// k2 (lo == nullptr: offset 0) and k3 (offset lo[k]): rows of g via smem.
__global__ void row_copy_kernel(const float* __restrict__ g,
                                const int32_t* __restrict__ lo,
                                float* __restrict__ out, int tile, int C) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar;
  float* scr = reinterpret_cast<float*>(smem_raw);
  const int64_t start = lo == nullptr ? 0 : (int64_t)lo[blockIdx.x];
  if (threadIdx.x == 0) mbar_init(&bar, 1);
  __syncthreads();
  if (threadIdx.x == 0)
    bulk_load(scr, g + start * C, (uint32_t)(tile * C * sizeof(float)), &bar);
  mbar_wait(&bar, 0);
  float* dst = out + (int64_t)blockIdx.x * tile * C;
  for (int i = threadIdx.x; i < tile * C; i += blockDim.x) dst[i] = scr[i];
}

__global__ void copy_1d_kernel(const int32_t* __restrict__ q,
                               const int32_t* __restrict__ lo,
                               float* __restrict__ out, int tile, int C) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar;
  int32_t* scr = reinterpret_cast<int32_t*>(smem_raw);
  const int64_t start = lo[blockIdx.x];
  const int64_t aligned = start & ~(int64_t)3;  // 16-byte aligned source
  const int off = (int)(start - aligned);
  const int n = (off + tile + 3) & ~3;  // whole 16-byte units
  if (threadIdx.x == 0) mbar_init(&bar, 1);
  __syncthreads();
  if (threadIdx.x == 0)
    bulk_load(scr, q + aligned, (uint32_t)(n * sizeof(int32_t)), &bar);
  mbar_wait(&bar, 0);
  float* dst = out + (int64_t)blockIdx.x * tile * C;
  for (int i = threadIdx.x; i < tile * C; i += blockDim.x)
    dst[i] = (float)scr[off + i / C];
}

__global__ void dynamic_loop_kernel(const int32_t* __restrict__ lo,
                                    float* __restrict__ out, int tile,
                                    int C) {
  const int n = lo[blockIdx.x];
  float* dst = out + (int64_t)blockIdx.x * tile * C;
  for (int i = threadIdx.x; i < tile * C; i += blockDim.x) {
    float acc = 0.0f;
    for (int j = 0; j < n; ++j) acc += 1.0f;
    dst[i] = acc;
  }
}

// k6, k6b: each warp owns [M, N] output blocks of the tile and runs the
// product over maxu in steps of 16 with one-hot A blocks built in shared
// memory. M x N x 16 is m32n8k16 for C == 8 and m16n16k16 for C % 16 == 0.
template <int M, int N>
__global__ void __launch_bounds__(kThreads)
    onehot_dot_kernel(const int32_t* __restrict__ local,
                      const __nv_bfloat16* __restrict__ g,
                      float* __restrict__ out, int tile, int maxu, int C) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ __align__(32) __nv_bfloat16 a_stage[kWarps][M * 16];
  int32_t* loc = reinterpret_cast<int32_t*>(smem_raw);  // [maxu]
  const int64_t k = blockIdx.x;
  for (int m = threadIdx.x; m < maxu; m += blockDim.x)
    loc[m] = local[k * maxu + m];
  __syncthreads();
  const __nv_bfloat16* gk = g + k * maxu * C;
  float* ok = out + k * tile * C;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_col = C / N;
  const __nv_bfloat16 one = __float2bfloat16(1.0f);
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);
  for (int blk = warp; blk < (tile / M) * n_col; blk += kWarps) {
    const int r0 = (blk / n_col) * M, n0 = (blk % n_col) * N;
    wmma::fragment<wmma::accumulator, M, N, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int k0 = 0; k0 < maxu; k0 += 16) {
      const int v = lane < 16 ? loc[k0 + lane] : -1;
      if (!__any_sync(0xffffffffu, lane < 16 && v >= r0 && v < r0 + M))
        continue;  // an all-zero one-hot block adds nothing
      for (int e = lane; e < M * 16; e += 32)
        a_stage[warp][e] = loc[k0 + e % 16] == r0 + e / 16 ? one : zero;
      __syncwarp();
      wmma::fragment<wmma::matrix_a, M, N, 16, __nv_bfloat16,
                     wmma::row_major>
          a;
      wmma::fragment<wmma::matrix_b, M, N, 16, __nv_bfloat16,
                     wmma::row_major>
          b;
      wmma::load_matrix_sync(a, a_stage[warp], 16);
      wmma::load_matrix_sync(b, gk + (int64_t)k0 * C + n0, C);
      wmma::mma_sync(acc, a, b, acc);
      __syncwarp();
    }
    wmma::store_matrix_sync(ok + (int64_t)r0 * C + n0, acc, C,
                            wmma::mem_row_major);
  }
}

__global__ void iota_kernel(float* __restrict__ out, int tile, int C) {
  float* dst = out + (int64_t)blockIdx.x * tile * C;
  for (int i = threadIdx.x; i < tile * C; i += blockDim.x)
    dst[i] = (float)(i / C);
}

int row_copy(const void* g, const void* lo, void* out, long long n_tiles,
             int tile, int C, void* stream) {
  if (n_tiles <= 0) return (int)cudaSuccess;
  const size_t smem = (size_t)tile * C * sizeof(float);
  const int err = set_smem(row_copy_kernel, smem);
  if (err != (int)cudaSuccess) return err;
  row_copy_kernel<<<(unsigned)n_tiles, kThreads, smem,
                    (cudaStream_t)stream>>>(
      (const float*)g, (const int32_t*)lo, (float*)out, tile, C);
  return (int)cudaGetLastError();
}

template <int M, int N>
int onehot_dot(const void* local, const void* g, void* out,
               long long n_tiles, int tile, int maxu, int C, void* stream) {
  const size_t smem = (size_t)maxu * sizeof(int32_t);
  const int err = set_smem(onehot_dot_kernel<M, N>, smem);
  if (err != (int)cudaSuccess) return err;
  onehot_dot_kernel<M, N><<<(unsigned)n_tiles, kThreads, smem,
                            (cudaStream_t)stream>>>(
      (const int32_t*)local, (const __nv_bfloat16*)g, (float*)out, tile,
      maxu, C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int probe_prefetch_write(const void* lo, void* out,
                                    long long n_tiles, int tile, int C,
                                    void* stream) {
  if (n_tiles <= 0) return (int)cudaSuccess;
  prefetch_write_kernel<<<(unsigned)n_tiles, kThreads, 0,
                          (cudaStream_t)stream>>>((const int32_t*)lo,
                                                  (float*)out, tile, C);
  return (int)cudaGetLastError();
}

extern "C" int probe_static_copy(const void* g, void* out, long long n_tiles,
                                 int tile, int C, void* stream) {
  return row_copy(g, nullptr, out, n_tiles, tile, C, stream);
}

extern "C" int probe_dynamic_copy(const void* g, const void* lo, void* out,
                                  long long n_tiles, int tile, int C,
                                  void* stream) {
  return row_copy(g, lo, out, n_tiles, tile, C, stream);
}

extern "C" int probe_copy_1d(const void* q, const void* lo, void* out,
                             long long n_tiles, int tile, int C,
                             void* stream) {
  if (n_tiles <= 0) return (int)cudaSuccess;
  const size_t smem = (size_t)(tile + 4) * sizeof(int32_t);
  const int err = set_smem(copy_1d_kernel, smem);
  if (err != (int)cudaSuccess) return err;
  copy_1d_kernel<<<(unsigned)n_tiles, kThreads, smem,
                   (cudaStream_t)stream>>>((const int32_t*)q,
                                           (const int32_t*)lo, (float*)out,
                                           tile, C);
  return (int)cudaGetLastError();
}

extern "C" int probe_dynamic_loop(const void* lo, void* out,
                                  long long n_tiles, int tile, int C,
                                  void* stream) {
  if (n_tiles <= 0) return (int)cudaSuccess;
  dynamic_loop_kernel<<<(unsigned)n_tiles, kThreads, 0,
                        (cudaStream_t)stream>>>((const int32_t*)lo,
                                                (float*)out, tile, C);
  return (int)cudaGetLastError();
}

// C == 8 or a multiple of 16; tile a multiple of 32; maxu of 16.
extern "C" int probe_onehot_dot(const void* local, const void* g, void* out,
                                long long n_tiles, int tile, int maxu, int C,
                                void* stream) {
  if (n_tiles <= 0) return (int)cudaSuccess;
  if (C % 16 == 0)
    return onehot_dot<16, 16>(local, g, out, n_tiles, tile, maxu, C, stream);
  return onehot_dot<32, 8>(local, g, out, n_tiles, tile, maxu, C, stream);
}

extern "C" int probe_iota(void* out, long long n_tiles, int tile, int C,
                          void* stream) {
  if (n_tiles <= 0) return (int)cudaSuccess;
  iota_kernel<<<(unsigned)n_tiles, kThreads, 0, (cudaStream_t)stream>>>(
      (float*)out, tile, C);
  return (int)cudaGetLastError();
}
