// K1: row scatter-add for the hash-grid backward, by hand for Hopper (sm_90a).
//
//   out[t, c] += g[q, c]   for every update row q with idx[q] == t
//
// Replaces the TPU kernel laenerf_tpu/ops/scatter_add.py::_kernel (a sorted
// work list of one-hot MXU matmuls). On the card the conflict resolution that
// the TPU did with matmuls is done by f32 atomics into a zero-filled [T, C]
// output, the form of the original instant-ngp gridencoder backward.
//
// What bounds it on an H100: the atomics' traffic in L2. At the main-path
// shape (4,194,304 update rows of C = 4 bf16 into 2,936,936 rows) the
// function moves 97.3 MB, 29 us at 3.35 TB/s, but each kept run costs one
// read-modify-write of a random 16-byte row of the 47 MB table gradient,
// in L2 and, for the rows L2 does not hold, in HBM; the card resolves a few
// tens of G such REDs a second (PERF.md), so their count sets the time.
// The first port ran a thread per (row, channel) element, a 64-bit
// division and a scalar RED each (a row's four adds came from neighbouring
// lanes of one instruction, so L2 probably saw them as one sector request;
// no counter on the card confirms it). This design:
//   - A thread owns whole update rows, kGroup = 4 channels of them: it loads
//     a row's group in one access (8 B of bf16 or 16 B of f32 at C = 4) and
//     adds it with one vector RED, float4 atomicAdd (sm_90's
//     REDG.E.ADD.F32x4) where C % 4 == 0, float2 where C % 2 == 0, scalar
//     adds otherwise; the launcher picks the width for the whole call from C
//     and the pointers' alignment, so a misaligned view takes a narrow path.
//   - Runs down the columns are merged, which cuts the REDs L2 sees. The
//     updates come as [S, P] rows (the backward passes [samples, levels x
//     corners]: the samples in (ray, slot) order, so consecutive samples of
//     a ray often hit the same corner row of a coarse level). A warp takes
//     consecutive columns of one row s, 32 at C <= 4, one coalesced access,
//     and each lane walks down its column over a span of `span` rows,
//     summing in f32 registers while the index stays the same; it adds the
//     sum when the index changes and at the end of its span. An
//     out-of-range index drops its row and ends a run. A 1-D idx is split
//     into rows of 32 (P = 32, the last row cut at Q) and walked with a
//     span of 1: a lane per update row.
//   - The lanes that share a column hold its channel groups side by side,
//     so they meet the same run ends together and their REDs to one row
//     leave in one instruction (at C = 8 two float4 REDs to one 32-byte
//     sector, as the first port's eight scalar adds did).
// A warp's unit of work is (span, columns, channel groups), decomposed
// once per thread with 32-bit division; no per-element division is left.
// Sorting (which would merge every run), staging table tiles in shared
// memory and fusing the corner weights into the kernel are not done here.
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
#include <limits.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;  // 8 warps a block
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 4;  // channels a thread owns: one float4

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <int B>
struct Raw;  // an unsigned type of B bytes
template <>
struct Raw<2> { using type = unsigned short; };
template <>
struct Raw<4> { using type = unsigned int; };
template <>
struct Raw<8> { using type = uint2; };
template <>
struct Raw<16> { using type = uint4; };

template <int W>
struct Floats;  // W floats as one value, for a W-wide atomicAdd
template <>
struct Floats<1> {
  static __device__ float of(const float* v) { return v[0]; }
};
template <>
struct Floats<2> {
  static __device__ float2 of(const float* v) {
    return make_float2(v[0], v[1]);
  }
};
template <>
struct Floats<4> {
  static __device__ float4 of(const float* v) {
    return make_float4(v[0], v[1], v[2], v[3]);
  }
};

// acc[0, left) += row[0, left), read V elements at a time (streamed: the
// rows are read once and should not evict the table from L2). V divides C
// and the row pointer is aligned to V elements, so a V-wide piece lies
// wholly inside or wholly past C.
template <typename T, int V>
__device__ __forceinline__ void add_row(const T* __restrict__ row, int left,
                                        float (&acc)[kGroup]) {
  using R = typename Raw<V * sizeof(T)>::type;
#pragma unroll
  for (int i = 0; i < kGroup; i += V) {
    if (i < left) {
      const R raw = __ldcs(reinterpret_cast<const R*>(row + i));
      const T* t = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < V; ++j) acc[i + j] += to_f32(t[j]);
    }
  }
}

// dst[0, left) += acc with W-wide atomics (W divides C, so dst is aligned
// to W floats); float2 and float4 atomicAdd are sm_90's vector REDs.
template <int W>
__device__ __forceinline__ void red_group(float* dst, int left,
                                          const float (&acc)[kGroup]) {
#pragma unroll
  for (int i = 0; i < kGroup; i += W) {
    if (i < left) {
      auto x = Floats<W>::of(acc + i);  // float, float2 or float4
      atomicAdd(reinterpret_cast<decltype(x)*>(dst + i), x);
    }
  }
}

// A warp covers `cols` consecutive columns of one row s and `gpw` channel
// groups of each, the group fastest over the lanes, so its lanes read (and
// add) one run of contiguous memory: 32 columns at C <= 4, 16 columns of
// two groups at C = 8, one column of 32 groups past C = 128. Warp unit u =
// (span j, column chunk pc, group chunk gc), gc fastest: lane l sums column
// p = pc * cols + l / gpw, rows [j * span, (j + 1) * span) cut at S,
// channel group cg = gc * gpw + l % gpw, channels [cg * kGroup, cg * kGroup
// + kGroup) cut at C; element q = s * P + p exists while q < Q (a 1-D idx
// cuts its last row there).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    scatter_add_rows_kernel(const int32_t* __restrict__ idx,
                            const T* __restrict__ g, float* __restrict__ out,
                            int64_t S, int64_t P, int64_t Q, int C,
                            int64_t table_rows, int span, unsigned gpw,
                            unsigned cols, unsigned col_chunks,
                            unsigned group_chunks, unsigned units) {
  const unsigned u = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const unsigned lane = threadIdx.x & 31;
  if (u >= units || lane >= cols * gpw) return;
  const unsigned rest = u / group_chunks;
  const int64_t p = (int64_t)(rest % col_chunks) * cols + lane / gpw;
  const unsigned cg = (u % group_chunks) * gpw + lane % gpw;
  if (p >= P || (int64_t)cg * kGroup >= C) return;
  const int c0 = (int)cg * kGroup;
  const int left = min(kGroup, C - c0);
  const int64_t s0 = (int64_t)(rest / col_chunks) * span;
  const int64_t s1 = s0 + span < S ? s0 + span : S;
  float acc[kGroup];
  int64_t run = -1;  // the row being summed; -1 while there is none
  for (int64_t s = s0; s < s1; ++s) {
    const int64_t q = s * P + p;
    if (q >= Q) break;
    const int64_t t = __ldcs(idx + q);
    if (t != run) {
      if (run >= 0) red_group<V>(out + run * C + c0, left, acc);
      run = (t >= 0 && t < table_rows) ? t : -1;
#pragma unroll
      for (int i = 0; i < kGroup; ++i) acc[i] = 0.0f;
    }
    if (run >= 0) add_row<T, V>(g + q * C + c0, left, acc);
  }
  if (run >= 0) red_group<V>(out + run * C + c0, left, acc);
}

template <typename T>
int launch(const void* idx, const void* g, void* out, long long S,
           long long P, long long Q, int C, long long table_rows, int span,
           void* stream) {
  if (Q <= 0 || C <= 0 || S <= 0 || P <= 0 || span <= 0)
    return (int)cudaSuccess;
  const long long groups = (C + kGroup - 1) / kGroup;
  const long long gpw = groups < 32 ? groups : 32;  // groups a warp covers
  const long long cols = 32 / gpw;                   // columns a warp covers
  const long long col_chunks = (P + cols - 1) / cols;
  const long long group_chunks = (groups + gpw - 1) / gpw;
  const long long units =
      (S + span - 1) / span * col_chunks * group_chunks;
  if (units > UINT_MAX - kWarps) return (int)cudaErrorInvalidConfiguration;
  const unsigned blocks = (unsigned)((units + kWarps - 1) / kWarps);
  // the widest of 4, 2 and 1 floats that divides C and to which both row
  // pointers are aligned (out is a fresh allocation, so only g can miss)
  int V = 4;
  while (V > 1 && (C % V != 0 || (uintptr_t)g % (V * sizeof(T)) != 0 ||
                   (uintptr_t)out % (V * sizeof(float)) != 0)) {
    V /= 2;
  }
  auto go = [&](auto v) {
    scatter_add_rows_kernel<T, decltype(v)::value>
        <<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
            (const int32_t*)idx, (const T*)g, (float*)out, (int64_t)S,
            (int64_t)P, (int64_t)Q, C, (int64_t)table_rows, span,
            (unsigned)gpw, (unsigned)cols, (unsigned)col_chunks,
            (unsigned)group_chunks, (unsigned)units);
    return (int)cudaGetLastError();
  };
  if (V == 4) return go(std::integral_constant<int, 4>());
  if (V == 2) return go(std::integral_constant<int, 2>());
  return go(std::integral_constant<int, 1>());
}

}  // namespace

// idx [Q] viewed as [S, P] (Q <= S * P), g [Q, C]; `span` rows a lane walks.
extern "C" int scatter_add_rows_f32(const void* idx, const void* g, void* out,
                                    long long S, long long P, long long Q,
                                    int C, long long table_rows, int span,
                                    void* stream) {
  return launch<float>(idx, g, out, S, P, Q, C, table_rows, span, stream);
}

extern "C" int scatter_add_rows_bf16(const void* idx, const void* g,
                                     void* out, long long S, long long P,
                                     long long Q, int C, long long table_rows,
                                     int span, void* stream) {
  return launch<__nv_bfloat16>(idx, g, out, S, P, Q, C, table_rows, span,
                               stream);
}
