// K1: row scatter-add for the hash-grid backward, by hand for Hopper (sm_90a).
//
//   out[t, c] += g[q, c]   for every update row q with idx[q] == t
//
// Replaces the TPU kernel laenerf_tpu/ops/scatter_add.py::_kernel (a sorted
// work list of one-hot MXU matmuls). On the card the conflict resolution that
// the TPU did with matmuls is done by f32 atomics into a zero-filled [T, C]
// output, the form of the original instant-ngp gridencoder backward.
//
// What bounds it on an H100: atomic throughput and random 16-byte row traffic
// (C = 4 floats) into the table gradient. At the main-path shape the table is
// 2.94 M rows x 16 B = 47 MB, which fits the 50 MB L2, so the atomics mostly
// resolve in L2 rather than in HBM. This first version keeps one thread per
// (row, channel) element with scalar atomicAdd (the result is unused, so the
// compiler emits RED, not ATOM); vector float4 atomics, sorting and fusing the
// corner weights into the kernel are later work.
//
// Update rows come in as f32 or bf16 (the "bf16" precision of the reference
// rounds rows to bf16 and accumulates in f32); accumulation is always f32.
// Rows whose index lies outside [0, T) are dropped. The sum order of the
// atomics varies from run to run, so results match a sequential sum only to
// f32 rounding.
//
// Plain C interface, loaded with ctypes. The kernel runs on the caller's
// stream and the entry points return cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void scatter_add_rows_kernel(const int32_t* __restrict__ idx,
                                        const T* __restrict__ g,
                                        float* __restrict__ out,
                                        int64_t n_elems, int C,
                                        int64_t table_rows) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_elems; i += stride) {
    const int64_t q = i / C;
    const int c = (int)(i - q * C);
    const int64_t t = idx[q];
    if (t < 0 || t >= table_rows) continue;
    atomicAdd(out + t * C + c, to_f32(g[i]));
  }
}

template <typename T>
int launch(const void* idx, const void* g, void* out, long long Q, int C,
           long long table_rows, void* stream) {
  const int64_t n = (int64_t)Q * C;
  if (n <= 0) return (int)cudaSuccess;
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  // grid-stride loop beyond this many blocks (about 250 blocks per SM)
  if (blocks > 32768) blocks = 32768;
  scatter_add_rows_kernel<T><<<(unsigned)blocks, threads, 0,
                               (cudaStream_t)stream>>>(
      (const int32_t*)idx, (const T*)g, (float*)out, n, C,
      (int64_t)table_rows);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int scatter_add_rows_f32(const void* idx, const void* g, void* out,
                                    long long Q, int C, long long table_rows,
                                    void* stream) {
  return launch<float>(idx, g, out, Q, C, table_rows, stream);
}

extern "C" int scatter_add_rows_bf16(const void* idx, const void* g,
                                     void* out, long long Q, int C,
                                     long long table_rows, void* stream) {
  return launch<__nv_bfloat16>(idx, g, out, Q, C, table_rows, stream);
}
