// K5, K6: the sorted scatter-add, by hand for Hopper (sm_90a).
//
//   out[t, c] = sum over update rows q with qs[q] == t of gs[q, c]
//
// over update rows sorted by destination row, into a table of n_tiles tiles
// of `tile` rows. Rows outside [0, n_tiles * tile) are dropped, and so is an
// update that lies outside the slab [lo[k], lo[k+1]) of its row's tile k.
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
// scatter; a card resolves them with a reduction and atomics.
//
// What bounds them on an H100: bytes. Each update row is read once (qs 4 B,
// gs 4 * C or 2 * C B) and each output row written once; at the probes' shape
// (2,097,152 updates of C = 8 into 2,937,856 rows) that is 169.5 MB with f32
// rows, 50.6 us at 3.35 TB/s. One f32 add per update element is far below
// the card's rate.
//
// K5 does not keep the TPU's tile-per-grid-step schedule. Its first port did
// (one block per tile, f32 atomicAdd into a shared [tile, C] tile), and two
// things made it 50x its bound: a tile's work followed its slab, so one block
// walked the heaviest tile's 141,569 updates (6.75% of all) alone; and the
// shared f32 atomicAdd compiles to a compare-and-swap loop (ATOMS.CAST.SPIN)
// that retries on every update of a sorted run of one row. So now:
//   - An even grid: each block takes 2,048 consecutive sorted updates (256
//     per warp), whatever the tiles hold; the heaviest tile spreads over ~70
//     blocks.
//   - Membership in O(1): update q of row r counts iff 0 <= r < n_tiles *
//     tile and lo[k] <= q < lo[k+1] for k = r / tile. For a non-decreasing lo
//     this is the tile-per-slab rule (slabs are disjoint, so q lies in at
//     most one); a dropped update becomes key -1, which is never written.
//   - Wide loads: a lane reads its update's row 16 bytes at a time where C
//     and the row pointer allow (two float4 at C = 8 f32, one uint4 at C = 8
//     bf16), narrower otherwise; channels go 8 at a time.
//   - Runs reduced in registers: equal keys of neighbouring lanes form a
//     run; a segmented inclusive scan with __shfl_up_sync, only as many
//     steps as the warp's longest run needs, leaves each run's sum in its
//     last lane.
//   - One global write per (32 updates, run), into an output the wrapper
//     zero-fills, by the run's last lane. qs is sorted, so all kept updates
//     of a row are adjacent: a run that neither starts at lane 0 nor ends at
//     lane 31 is the whole row and is stored (float4 stores); a run at an
//     edge of the 32 may go on in another window and is added with float4
//     atomicAdd (a RED to L2 on sm_90). At the probes' shape 122,424 of the
//     1,158,562 runs lie at an edge; a run of 902 updates costs 29 vector
//     adds, not 7,216 contended shared-memory spins.
// The zero-fill writes the 94 MB output before the kernel runs, the kernel
// writes the 1.16 M touched rows again, and an added row is also read, so
// zero-fill and kernel move about 210.5 MB (62.8 us) against the
// function's 169.5 MB.
//
// K6 shares K5's warp body (reduce_span) and differs in how a warp finds
// its updates, which it keeps, and how it writes:
//   - The work list is the grid: one block per item w, its maxu updates
//     [wb[w] * maxu, wb[w] * maxu + maxu) cut at Q, each warp one eighth
//     of them in whole windows of 32. Items hold at most maxu updates, so
//     the grid is even: the heaviest tile spreads over ~139 items.
//   - Membership: update q of row r counts in item w iff r lies in tile
//     wt[w]; an item with wreal[w] == 0 or wt[w] outside the tiles does
//     nothing. A window without a kept update is skipped, and only the kept
//     updates' rows are read: the items of a block each read its qs, but
//     each row only once.
//   - Every run is added with float4 (float2, float) atomicAdd into the
//     zero-filled output, never stored: K6 takes any work list (the plain
//     version counts an update once for every real item that covers it, so
//     a duplicated item adds twice, and qs need not be sorted), so a run
//     inside a window need not be its row's whole sum.
// No shared memory, so no limit on the tile size.
//
// The sum order of the atomics varies from run to run, so results match a
// sequential sum only to f32 rounding. Update rows come in as f32 or bf16;
// accumulation is always f32. Plain C interface, loaded with ctypes. Each
// kernel runs on the caller's stream and each entry point returns
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kRunThreads = 256;  // 8 warps a block
constexpr int kWarps = kRunThreads / 32;
constexpr int kWarpSpan = 256;     // K5: consecutive updates a warp reduces
constexpr int kChunk = kWarps * kWarpSpan;  // K5: updates a block
constexpr int kGroup = 8;          // channels a lane holds at a time
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ int64_t clamp64(int64_t v, int64_t lo,
                                           int64_t hi) {
  return v < lo ? lo : (v > hi ? hi : v);
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
struct Floats;  // W floats as one value, for a W-wide store or atomicAdd
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

// v = channels [c0, c0 + kGroup) of update row q, read V elements at a
// time; channels at or past C, and rows that are not read, read as 0. V
// divides C and the row pointer is aligned to V elements (the launcher
// checks), so a V-wide piece lies wholly inside or wholly past C.
template <typename T, int V>
__device__ __forceinline__ void load_group(const T* __restrict__ gs,
                                           int64_t q, int C, int c0,
                                           bool read, float (&v)[kGroup]) {
  using R = typename Raw<V * sizeof(T)>::type;
#pragma unroll
  for (int i = 0; i < kGroup; i += V) {
    if (read && c0 + i < C) {
      const R raw = __ldcs(reinterpret_cast<const R*>(gs + q * C + c0 + i));
      const T* t = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < V; ++j) v[i + j] = to_f32(t[j]);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) v[i + j] = 0.0f;
    }
  }
}

// dst[0, min(kGroup, left)) += v with atomics (add) or = v with stores, W
// floats at a time (W divides C, so dst is aligned to W floats); float2 and
// float4 atomicAdd are sm_90's vector REDs.
template <int W>
__device__ __forceinline__ void write_group(float* dst, int left, bool add,
                                            const float (&v)[kGroup]) {
#pragma unroll
  for (int i = 0; i < kGroup; i += W) {
    if (i < left) {
      auto x = Floats<W>::of(v + i);  // float, float2 or float4
      auto* p = reinterpret_cast<decltype(x)*>(dst + i);
      if (add) {
        atomicAdd(p, x);
      } else {
        *p = x;
      }
    }
  }
}

// K5: update q of row r counts iff r lies in the table and q in the slab of
// r's tile. qs is sorted and the slabs are disjoint, so each update is read
// once (streamed, its row read before membership is known: nearly every
// update is kept) and a run inside its window is its row's whole sum, which
// is stored.
struct SlabRule {
  const int32_t* lo;
  int64_t rows;
  int tile;
  static constexpr bool kSorted = true;
  __device__ __forceinline__ bool keep(int r, int64_t q) const {
    if (r < 0 || (int64_t)r >= rows) return false;
    const int k = r / tile;
    return (int64_t)__ldg(lo + k) <= q && q < (int64_t)__ldg(lo + k + 1);
  }
};

// K6: update q of row r counts in an item iff r lies in the item's tile
// [r0, r1). Any work list is taken: the items of a block all read its qs
// (kept in cache), each reads only its kept rows, and every run is added.
struct ItemRule {
  int64_t r0, r1;
  static constexpr bool kSorted = false;
  __device__ __forceinline__ bool keep(int r, int64_t) const {
    return r >= r0 && r < r1;
  }
};

// One warp reduces updates [w0, w1), 32 at a time: lane i holds update
// base + i, its key the row where rule keeps it, else -1. Equal keys of
// neighbouring lanes form a run; a segmented scan sums it into its last
// lane, which writes the sum into out (zero-filled by the caller), kGroup
// channels at a time: added with atomics, or stored where qs is sorted and
// the run touches neither edge of the window.
template <typename T, int V, typename Rule>
__device__ __forceinline__ void reduce_span(const int32_t* __restrict__ qs,
                                            const T* __restrict__ gs,
                                            float* __restrict__ out,
                                            int64_t w0, int64_t w1, int C,
                                            const Rule& rule) {
  constexpr int W = V < 4 ? V : 4;  // floats a write takes
  const int lane = threadIdx.x & 31;
  for (int64_t base = w0; base < w1; base += 32) {  // warp-uniform
    const int64_t q = base + lane;
    const bool live = q < w1;
    int r = -1;
    if (live) r = Rule::kSorted ? __ldcs(qs + q) : __ldg(qs + q);
    float v[kGroup];
    // K5 reads the row in flight with lo's reads
    if constexpr (Rule::kSorted) load_group<T, V>(gs, q, C, 0, live, v);
    const int key = live && rule.keep(r, q) ? r : -1;
    if (!__any_sync(kAll, key >= 0)) continue;
    const bool read = Rule::kSorted ? live : key >= 0;
    if constexpr (!Rule::kSorted) load_group<T, V>(gs, q, C, 0, read, v);
    const int prev = __shfl_up_sync(kAll, key, 1);
    const int next = __shfl_down_sync(kAll, key, 1);
    const bool tail = lane == 31 || next != key;
    const unsigned heads = __ballot_sync(kAll, lane == 0 || prev != key);
    // the run's first lane: the highest head at or below this lane
    const int start = 31 - __clz(heads & (kAll >> (31 - lane)));
    // the longest kept run (runs of dropped updates are never written)
    const int longest = __reduce_max_sync(kAll,
                                          key >= 0 ? lane - start + 1 : 1);
    const bool add = !Rule::kSorted || start == 0 || lane == 31;
    for (int c0 = 0;;) {
      // after the steps of d < longest, lane i holds the sum over
      // [max(start, i - 2d + 1), i], the whole run at its last lane
      for (int d = 1; d < longest; d <<= 1) {
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          const float up = __shfl_up_sync(kAll, v[j], d);
          if (lane - d >= start) v[j] += up;
        }
      }
      if (tail && key >= 0) {
        write_group<W>(out + (int64_t)key * C + c0, C - c0, add, v);
      }
      c0 += kGroup;
      if (c0 >= C) break;
      load_group<T, V>(gs, q, C, c0, read, v);
    }
  }
}

// K5: one block per kChunk consecutive updates, one warp per kWarpSpan.
template <typename T, int V>
__global__ void __launch_bounds__(kRunThreads)
    tile_scatter_kernel(const int32_t* __restrict__ qs,
                        const T* __restrict__ gs,
                        const int32_t* __restrict__ lo,
                        float* __restrict__ out, int64_t Q, int64_t n_tiles,
                        int tile, int C) {
  const int64_t w0 = (int64_t)blockIdx.x * kChunk
                     + (int64_t)(threadIdx.x >> 5) * kWarpSpan;
  const int64_t w1 = w0 + kWarpSpan < Q ? w0 + kWarpSpan : Q;
  reduce_span<T, V>(qs, gs, out, w0, w1, C,
                    SlabRule{lo, n_tiles * tile, tile});
}

// K6: one block per work item; warp i takes the i-th eighth of the item's
// updates, in whole windows of 32.
template <typename T, int V>
__global__ void __launch_bounds__(kRunThreads)
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
  const int64_t begin = clamp64((int64_t)wb[w] * maxu, 0, Q);
  const int64_t end = clamp64(begin + maxu, begin, Q);
  const int64_t span = (end - begin + kRunThreads - 1) / kRunThreads * 32;
  const int64_t w0 = begin + (int64_t)(threadIdx.x >> 5) * span;
  const int64_t w1 = w0 + span < end ? w0 + span : end;
  reduce_span<T, V>(qs, gs, out, w0, w1, C,
                    ItemRule{t * tile, (t + 1) * tile});
}

// Returns launch(std::integral_constant<int, V>()) for the widest V of 16,
// 8, 4 or 2 bytes of T (or one element) that divides C and to which the
// row pointer gs is aligned: the elements a load reads.
template <typename T, typename F>
int with_width(const void* gs, int C, F launch) {
  int V = 16 / (int)sizeof(T);
  while (V > 1 && (C % V != 0 || (uintptr_t)gs % (V * sizeof(T)) != 0)) {
    V /= 2;
  }
  if constexpr (sizeof(T) == 2) {
    if (V == 8) return launch(std::integral_constant<int, 8>());
  }
  if (V == 4) return launch(std::integral_constant<int, 4>());
  if (V == 2) return launch(std::integral_constant<int, 2>());
  return launch(std::integral_constant<int, 1>());
}

template <typename T>
int tile_scatter(const void* qs, const void* gs, const void* lo, void* out,
                 long long Q, long long n_tiles, int tile, int C,
                 void* stream) {
  if (Q <= 0 || n_tiles <= 0 || C <= 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((Q + kChunk - 1) / kChunk);
  return with_width<T>(gs, C, [&](auto v) {
    tile_scatter_kernel<T, decltype(v)::value>
        <<<blocks, kRunThreads, 0, (cudaStream_t)stream>>>(
            (const int32_t*)qs, (const T*)gs, (const int32_t*)lo,
            (float*)out, (int64_t)Q, (int64_t)n_tiles, tile, C);
    return (int)cudaGetLastError();
  });
}

template <typename T>
int worklist_scatter(const void* qs, const void* gs, const void* wt,
                     const void* wb, const void* wreal, void* out,
                     long long Q, long long n_items, long long n_tiles,
                     int tile, int maxu, int C, void* stream) {
  if (n_items <= 0) return (int)cudaSuccess;
  return with_width<T>(gs, C, [&](auto v) {
    worklist_scatter_kernel<T, decltype(v)::value>
        <<<(unsigned)n_items, kRunThreads, 0, (cudaStream_t)stream>>>(
            (const int32_t*)qs, (const T*)gs, (const int32_t*)wt,
            (const int32_t*)wb, (const int32_t*)wreal, (float*)out,
            (int64_t)Q, (int64_t)n_tiles, tile, maxu, C);
    return (int)cudaGetLastError();
  });
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
