// K7: the construct probes, by hand for Hopper (sm_90a).
//
// perf/bisect_mosaic.py tried one Pallas construct per kernel (k1 ... k7,
// k6b) to find which one the TPU compiler refused: the constructs that the
// sorted scatter-add (perf/microbench_scatter2.py:137) is built from. Each
// entry point here is the Hopper counterpart of one of them. Every one writes
// an f32 [n_tiles * tile, C] output, tile k in rows [k*tile, (k+1)*tile):
//
//   k1 probe_prefetch_write   tile k = lo[k]: each block reads its tile's
//                             index (scalar prefetch, bisect_mosaic.py:28)
//   k2 probe_static_copy      tile k = g[0 : tile] by a bulk asynchronous
//                             copy into shared memory that completes on an
//                             mbarrier, then a bulk copy out (static 2-D
//                             DMA, :46)
//   k3 probe_dynamic_copy     tile k = g[lo[k] : lo[k] + tile], the same copy
//                             at an offset read from memory (:70)
//   k4 probe_copy_1d          row r of tile k = q[lo[k] + r], a 1-D int32
//                             bulk copy (:97)
//   k5 probe_dynamic_loop     tile k = 1 added lo[k] times: a loop whose trip
//                             count is read from memory (fori_loop, :124)
//   k6 probe_onehot_dot       tile k = onehot(local_k) @ g_k: the [tile, maxu]
//                             one-hot of local_k [maxu] (row r, column m is
//                             local_k[m] == r) times g_k [maxu, C] bf16, on
//                             the tensor cores (mma.sync m16n8k16, f32
//                             accumulation); C = 8 (:149) and C = 128 (k6b,
//                             :170)
//   k7 probe_iota             row r of tile k = r (a 1-D iota, :190)
//
// What bounds them on an H100: k1-k5 and k7 the launch (outputs of 256 KB).
// k1, k5 and k7 share one fill body (fill_slices, the value a functor) that
// spreads each tile over the card, one 128-thread block per (tile, 2 KB
// slice of its tile * C * 4 bytes), 128 blocks at the probe's shape, each
// thread one float4 store of its value; a tile that starts or ends off 16
// bytes (tile * C % 4 != 0) stores its head and tail one float at a time.
// k1's value is lo[k]; k5's thread runs the loop of lo[k] trips once and
// stores its sum; k7's float4 lies in one row when C % 4 == 0, its row the
// float4's index over C / 4 (a 32-bit division a thread), and other C take
// a scalar path on the same kind of grid, one float a thread. k2 and
// k3 spread each tile over the card: a tile of g is one contiguous run of
// tile * C * 4 bytes, so one block per (tile, 2 KB slice of it), 128 blocks
// at the probe's shape, whose one thread starts a bulk load of the slice
// into shared memory on an mbarrier and, once it lands, a bulk store of the
// same bytes to the output; no thread loads or stores a float itself. k4
// spreads its tiles the same way, one 64-thread block per (tile, 64 rows),
// 128 blocks at the probe's shape (2 KB of output each at C = 8): one bulk
// load brings the rows' int32 q into shared memory on an mbarrier, and each
// thread converts one row and writes its C floats with 16-byte stores. k6
// and k6b are bound by bytes: at k6b the 2 MB of bf16 g read, the 4 MB f32
// output written and the 32 KB of local, 6.32 MB at 3.35 TB/s =
// 1.89 us. The dense [tile, maxu] @ [maxu, C] product would be 2.15 GFLOP,
// but the one-hot has only maxu nonzeros a tile, one per column, so a kernel
// that scans every (output block, 16-column step) pair spends nearly all its
// time finding nothing to add. The one-hot kernel instead launches one block
// per (tile, 32-row window, channel chunk), 256 blocks at k6 and 512 at k6b,
// and each block buckets the tile's columns once: it reads local_k in chunks
// of 1,024 columns with 16-byte loads and keeps, in column order (ballot and
// popc prefix), the columns whose row lies in its window. It gathers the kept
// columns' g rows into shared memory, builds the one-hot A fragments in
// registers straight from the kept rows, and runs mma.sync over the kept
// columns only, 16 at a time. Its work follows the window's columns, not
// tile * maxu; a window with no columns runs no product and stores zeros.
//
// Bulk copies need 16-byte aligned addresses and sizes: the wrappers check
// the base pointers and that a row of g is a multiple of 16 bytes (so are a
// tile and each slice of it); k4 copies the 16-byte aligned window around
// each block's rows of q[lo[k] : lo[k] + tile], which stays inside q when
// q's length is a multiple of 4. Offsets must lie in range (the
// plain versions raise, the kernels do not check). Plain C interface, loaded
// with ctypes. Each kernel runs on the caller's stream and each entry point
// returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

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

// One thread: start the copy smem -> gmem as a bulk group and wait until it
// has read all of smem (the block may then exit; the writes land anyway).
__device__ __forceinline__ void bulk_store(void* gmem, const void* smem,
                                           uint32_t bytes) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          gmem),
      "r"(smem_addr(smem)), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
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

constexpr int kFillThreads = 128;  // k1, k5, k7: a thread stores 16 bytes
constexpr int kFillSlice = kFillThreads * 4;  // floats a fill block stores

// The fill body of k1, k5 and k7: block b fills slice b % slices of tile k =
// b / slices. The tile's n floats start at float k * n of the 16-byte
// aligned output, so they split into a head of up to 3 floats up to the
// first 16-byte boundary, whole float4s, and a tail of up to 3: slice s
// stores float4s [s * kFillThreads, (s + 1) * kFillThreads) of the tile's,
// one a thread, and slice 0 also stores the head and the tail one float a
// thread. Each thread asks value(k, i) once, i its float4's index in the
// tile, and stores that value in every float it writes: so the value must
// hold over the thread's floats (k1, k5: the whole tile; k7: a row, with
// C % 4 == 0, so a float4 lies in one row and the tile has no head or tail).
template <class Value>
__device__ __forceinline__ void fill_slices(float* __restrict__ out,
                                            int64_t n, unsigned slices,
                                            const Value& value) {
  const unsigned k = blockIdx.x / slices;
  const int64_t slice = blockIdx.x - (int64_t)k * slices;
  float* dst = out + (int64_t)k * n;
  const int64_t to16 = (int64_t)((4 - ((uintptr_t)dst >> 2)) & 3);
  const int64_t head = to16 < n ? to16 : n;
  const int64_t n4 = (n - head) >> 2;  // whole float4s
  const int64_t i = slice * kFillThreads + threadIdx.x;
  const float v = value(k, i);
  if (i < n4) {
    reinterpret_cast<float4*>(dst + head)[i] = make_float4(v, v, v, v);
  }
  if (slice == 0 && threadIdx.x < 3) {
    const int64_t tail = n - head - 4 * n4;  // both at most 3
    if (threadIdx.x < head) dst[threadIdx.x] = v;
    if (threadIdx.x < tail) dst[head + 4 * n4 + threadIdx.x] = v;
  }
}

// k1: tile k = (float)lo[k].
__global__ void __launch_bounds__(kFillThreads)
    prefetch_write_kernel(const int32_t* __restrict__ lo,
                          float* __restrict__ out, int64_t n,
                          unsigned slices) {
  fill_slices(out, n, slices,
              [lo](unsigned k, int64_t) { return (float)__ldg(lo + k); });
}

// k5: tile k = 1.0f added lo[k] times, by a loop whose trip count each
// thread reads from memory and runs once (a dependent chain of FADDs; 0
// trips for lo[k] <= 0).
__global__ void __launch_bounds__(kFillThreads)
    dynamic_loop_kernel(const int32_t* __restrict__ lo,
                        float* __restrict__ out, int64_t n,
                        unsigned slices) {
  fill_slices(out, n, slices, [lo](unsigned k, int64_t) {
    const int trips = __ldg(lo + k);
    float acc = 0.0f;
    for (int j = 0; j < trips; ++j) acc += 1.0f;
    return acc;
  });
}

// k7, row r of each tile = r. kVec (C % 4 == 0, a 16-byte aligned output):
// the fill body, float4 i of a tile in row i / (C / 4), one 32-bit division
// a thread. Otherwise one float a thread: block b covers floats
// [s * kFillThreads, (s + 1) * kFillThreads) of tile k = b / slices, s = b
// % slices, float e in row e / C. The launcher keeps n < 2^31.
template <bool kVec>
__global__ void __launch_bounds__(kFillThreads)
    iota_rows_kernel(float* __restrict__ out, int64_t n, unsigned C,
                     unsigned slices) {
  if constexpr (kVec) {
    const unsigned c4 = C / 4;
    fill_slices(out, n, slices, [c4](unsigned, int64_t i) {
      return (float)((unsigned)i / c4);
    });
  } else {
    const unsigned k = blockIdx.x / slices;
    const unsigned e = (blockIdx.x - k * slices) * kFillThreads + threadIdx.x;
    if (e < (unsigned)n) out[(int64_t)k * n + e] = (float)(e / C);
  }
}

constexpr int kSlice = 2048;  // k2, k3: bytes of a tile a block copies

// k2 (lo == nullptr: offset 0) and k3 (offset lo[k]): block b copies slice
// b % slices of tile k = b / slices, the bytes [off, off + kSlice) of the
// tile's tile_bytes (the last slice may be shorter), through shared memory.
// One thread a block.
__global__ void row_copy_kernel(const float* __restrict__ g,
                                const int32_t* __restrict__ lo,
                                float* __restrict__ out, int64_t tile_bytes,
                                int64_t row_bytes, unsigned slices) {
  __shared__ __align__(128) unsigned char buf[kSlice];
  __shared__ __align__(8) uint64_t bar;
  const unsigned k = blockIdx.x / slices;
  const int64_t off = (int64_t)(blockIdx.x % slices) * kSlice;
  const uint32_t bytes =
      (uint32_t)(tile_bytes - off < kSlice ? tile_bytes - off : kSlice);
  const int64_t start = lo == nullptr ? 0 : (int64_t)lo[k];
  mbar_init(&bar, 1);
  bulk_load(buf, reinterpret_cast<const char*>(g) + start * row_bytes + off,
            bytes, &bar);
  mbar_wait(&bar, 0);  // a single use: phase 0
  bulk_store(reinterpret_cast<char*>(out) + k * tile_bytes + off, buf, bytes);
}

constexpr int kCopyRows = 64;  // k4: rows of a tile a block converts

// k4: block b converts the rows [r0, r0 + rows) of tile k = b / slices,
// r0 = (b % slices) * kCopyRows, one thread a row. Thread 0 starts one bulk
// load of the rows' q, as the 16-byte aligned window around
// q[lo[k] + r0 : lo[k] + r0 + rows], on an mbarrier; each thread then
// converts its row's int32 and writes it into all C lanes, as float4
// stores where C % 4 == 0 (every row then starts 16-byte aligned) and one
// float at a time otherwise.
__global__ void __launch_bounds__(kCopyRows)
    copy_1d_kernel(const int32_t* __restrict__ q,
                   const int32_t* __restrict__ lo, float* __restrict__ out,
                   int tile, int C, unsigned slices) {
  __shared__ __align__(16) int32_t scr[kCopyRows + 4];
  __shared__ __align__(8) uint64_t bar;
  const unsigned k = blockIdx.x / slices;
  const int r0 = (int)(blockIdx.x - k * slices) * kCopyRows;
  const int rows = min(kCopyRows, tile - r0);
  const int64_t start = (int64_t)lo[k] + r0;
  const int64_t aligned = start & ~(int64_t)3;  // 16-byte aligned source
  const int off = (int)(start - aligned);
  if (threadIdx.x == 0) {
    mbar_init(&bar, 1);
    // whole 16-byte units; the window ends at most at round_up(lo[k] +
    // tile, 4) <= len(q), a multiple of 4
    bulk_load(scr, q + aligned,
              (uint32_t)(((off + rows + 3) & ~3) * sizeof(int32_t)), &bar);
  }
  __syncthreads();  // the barrier is initialised before anyone waits on it
  mbar_wait(&bar, 0);
  const int t = threadIdx.x;
  if (t >= rows) return;
  const float v = (float)scr[off + t];
  float* dst = out + ((int64_t)k * tile + r0 + t) * C;
  if (C % 4 == 0) {
    const float4 v4 = make_float4(v, v, v, v);
    for (int c = 0; c < C; c += 4) *reinterpret_cast<float4*>(dst + c) = v4;
  } else {
    for (int c = 0; c < C; ++c) dst[c] = v;
  }
}

// k6, k6b (see the header). A block owns the kWin rows [r0, r0 + kWin) of
// tile k and the channels [c0, c0 + CW) (the last chunk may be narrower; C
// is 8 or a multiple of 16, so chunks hold whole n8 tiles). Its output is
// two m16 tiles by CW / 8 n8 tiles; warp w owns m16 tile w & 1 and n8 tiles
// (w >> 1) + 4 i, in f32 registers for the whole tile k.
constexpr int kWin = 32;             // output rows a block: one window
constexpr int kScan = 4 * kThreads;  // columns of local a bucketing chunk
constexpr int kStage = 128;          // kept columns gathered a product pass

// Two bf16 one-hot entries (row == r) packed as an mma A register, the
// lower-indexed column in the low half. 0x3F80 is bf16 1.0.
__device__ __forceinline__ uint32_t onehot_pair(int lo, int hi, int r) {
  return (lo == r ? 0x3F80u : 0u) | (hi == r ? 0x3F800000u : 0u);
}

// d += a @ b for one m16n8k16 bf16 tile, f32 accumulation (fragment layouts
// of the PTX ISA: a row-major 16 x 16, b column-major 16 x 8).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int CW>
__global__ void __launch_bounds__(kThreads)
    onehot_dot_kernel(const int32_t* __restrict__ local,
                      const __nv_bfloat16* __restrict__ g,
                      float* __restrict__ out, int tile, int maxu, int C) {
  constexpr int kNt = CW / 8;                    // n8 tiles of a full chunk
  constexpr int kAcc = (kNt + 3) / 4;            // n8 tiles a warp owns
  constexpr int kRowB = CW + 8;                  // bf16 a staged g row
  constexpr int kRowO = CW + 4;                  // f32 a staged output row
  __shared__ int32_t cols[kScan];                // kept columns, in order
  __shared__ int8_t rows[kScan];                 // their rows - r0
  __shared__ int warp_kept[kWarps];
  __shared__ __align__(16) uint16_t gs[kStage * kRowB];
  __shared__ __align__(16) float os[kWin * kRowO];

  const unsigned n_chunk = (C + CW - 1) / CW, n_win = tile / kWin;
  unsigned b = blockIdx.x;
  const int chunk = (int)(b % n_chunk);
  b /= n_chunk;
  const int r0 = (int)(b % n_win) * kWin;
  const int64_t k = b / n_win;
  const int c0 = chunk * CW, cw = min(CW, C - c0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;  // fragment row, column pair
  const int mt = warp & 1;
  const int32_t* lk = local + k * maxu;
  const uint16_t* gk = reinterpret_cast<const uint16_t*>(g) + k * maxu * C
                       + c0;
  float acc[kAcc][4] = {};

  for (int base = 0; base < maxu; base += kScan) {
    // bucket: each thread reads 4 columns and keeps those in the window
    const int m = base + 4 * threadIdx.x;
    int4 v = make_int4(-1, -1, -1, -1);
    if (m < maxu) v = *reinterpret_cast<const int4*>(lk + m);
    const int vs[4] = {v.x, v.y, v.z, v.w};
    int keep = 0;
    #pragma unroll
    for (int j = 0; j < 4; ++j)
      keep |= ((unsigned)vs[j] - (unsigned)r0 < (unsigned)kWin) << j;
    // this thread's place in the warp's list: a prefix of the counts
    // (0..4), one ballot per bit
    const int cnt = __popc(keep);
    const unsigned below = (1u << lane) - 1u;
    int pos = 0;
    for (int bit = 0; bit < 3; ++bit)
      pos += __popc(__ballot_sync(0xffffffffu, (cnt >> bit) & 1) & below)
             << bit;
    if (lane == 31) warp_kept[warp] = pos + cnt;
    __syncthreads();
    int n = 0;
    for (int w = 0; w < kWarps; ++w) {
      if (w == warp) pos += n;
      n += warp_kept[w];
    }
    #pragma unroll
    for (int j = 0; j < 4; ++j)
      if ((keep >> j) & 1) {
        cols[pos] = m + j;
        rows[pos] = (int8_t)(vs[j] - r0);
        ++pos;
      }
    __syncthreads();

    // the product over the kept columns: kStage at a time, 16 a k-step,
    // the tail padded with zero g rows that no one-hot entry selects
    for (int s0 = 0; s0 < n; s0 += kStage) {
      const int ns = min(kStage, (n - s0 + 15) & ~15);
      const int vecs = cw / 8;  // 16-byte vectors of a row chunk
      for (int i = threadIdx.x; i < ns * vecs; i += kThreads) {
        const int e = i / vecs, q = i % vecs;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (s0 + e < n)
          val = *reinterpret_cast<const uint4*>(
              gk + (int64_t)cols[s0 + e] * C + 8 * q);
        *reinterpret_cast<uint4*>(gs + e * kRowB + 8 * q) = val;
      }
      __syncthreads();
      for (int e0 = 0; e0 < ns; e0 += 16) {
        int r[4];  // rows of k-step columns 2t, 2t + 1, 2t + 8, 2t + 9
        #pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int e = s0 + e0 + 2 * tig + (j & 1) + 8 * (j >> 1);
          r[j] = e < n ? rows[e] : -1;
        }
        const int ra = 16 * mt + gid, rb = ra + 8;
        const uint32_t a[4] = {onehot_pair(r[0], r[1], ra),
                               onehot_pair(r[0], r[1], rb),
                               onehot_pair(r[2], r[3], ra),
                               onehot_pair(r[2], r[3], rb)};
        const uint16_t* bs = gs + (e0 + 2 * tig) * kRowB + gid;
        #pragma unroll
        for (int i = 0; i < kAcc; ++i) {
          const int nt = (warp >> 1) + 4 * i;
          if (nt >= kNt || 8 * nt >= cw) continue;  // warp-uniform
          const uint16_t* bp = bs + 8 * nt;
          mma_bf16(acc[i], a, bp[0] | (uint32_t)bp[kRowB] << 16,
                   bp[8 * kRowB] | (uint32_t)bp[9 * kRowB] << 16);
        }
      }
      __syncthreads();
    }
  }

  // epilogue: fragments to shared memory, then 16-byte row stores
  #pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int nt = (warp >> 1) + 4 * i;
    if (nt >= kNt || 8 * nt >= cw) continue;
    float* o = os + (16 * mt + gid) * kRowO + 8 * nt + 2 * tig;
    o[0] = acc[i][0];
    o[1] = acc[i][1];
    o[8 * kRowO] = acc[i][2];
    o[8 * kRowO + 1] = acc[i][3];
  }
  __syncthreads();
  const int q4 = cw / 4;
  float* ow = out + (k * tile + r0) * C + c0;
  for (int i = threadIdx.x; i < kWin * q4; i += kThreads) {
    const int r = i / q4, q = i % q4;
    *reinterpret_cast<float4*>(ow + (int64_t)r * C + 4 * q) =
        *reinterpret_cast<const float4*>(os + r * kRowO + 4 * q);
  }
}

int row_copy(const void* g, const void* lo, void* out, long long n_tiles,
             int tile, int C, void* stream) {
  if (n_tiles <= 0) return (int)cudaSuccess;
  const int64_t row_bytes = (int64_t)C * sizeof(float);
  const int64_t tile_bytes = tile * row_bytes;
  const long long slices = (tile_bytes + kSlice - 1) / kSlice;
  if (n_tiles * slices > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  row_copy_kernel<<<(unsigned)(n_tiles * slices), 1, 0,
                    (cudaStream_t)stream>>>(
      (const float*)g, (const int32_t*)lo, (float*)out, tile_bytes, row_bytes,
      (unsigned)slices);
  return (int)cudaGetLastError();
}

template <int CW>
int onehot_dot(const void* local, const void* g, void* out,
               long long n_tiles, int tile, int maxu, int C, void* stream) {
  const long long blocks =
      n_tiles * (tile / kWin) * (long long)((C + CW - 1) / CW);
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  onehot_dot_kernel<CW><<<(unsigned)blocks, kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const int32_t*)local, (const __nv_bfloat16*)g, (float*)out, tile,
      maxu, C);
  return (int)cudaGetLastError();
}

// Blocks of a fill of n_tiles tiles of n floats, `per` floats a block (the
// fill body's 4 * kFillThreads: enough float4s for a tile's body at any
// offset, and slice 0 at least), with the slices of a tile; 0 where there is
// nothing to fill, -1 where the grid is too large.
long long fill_grid(long long n_tiles, long long n, int per,
                    unsigned* slices) {
  if (n_tiles <= 0 || n <= 0) return 0;
  const long long s = (n + per - 1) / per;
  if (n_tiles * s > INT_MAX) return -1;
  *slices = (unsigned)s;
  return n_tiles * s;
}

// k1, k5: one value a tile, from lo.
int tile_fill(void (*kernel)(const int32_t*, float*, int64_t, unsigned),
              const void* lo, void* out, long long n_tiles, int tile, int C,
              void* stream) {
  const long long n = (long long)tile * C;
  unsigned slices = 0;
  const long long blocks = fill_grid(n_tiles, n, kFillSlice, &slices);
  if (blocks <= 0)
    return (int)(blocks ? cudaErrorInvalidConfiguration : cudaSuccess);
  kernel<<<(unsigned)blocks, kFillThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)lo, (float*)out, (int64_t)n, slices);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int probe_prefetch_write(const void* lo, void* out,
                                    long long n_tiles, int tile, int C,
                                    void* stream) {
  return tile_fill(prefetch_write_kernel, lo, out, n_tiles, tile, C, stream);
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
  const long long slices = (tile + kCopyRows - 1) / kCopyRows;
  if (n_tiles * slices > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  copy_1d_kernel<<<(unsigned)(n_tiles * slices), kCopyRows, 0,
                   (cudaStream_t)stream>>>((const int32_t*)q,
                                           (const int32_t*)lo, (float*)out,
                                           tile, C, (unsigned)slices);
  return (int)cudaGetLastError();
}

extern "C" int probe_dynamic_loop(const void* lo, void* out,
                                  long long n_tiles, int tile, int C,
                                  void* stream) {
  return tile_fill(dynamic_loop_kernel, lo, out, n_tiles, tile, C, stream);
}

// C == 8 or a multiple of 16; tile a multiple of 32; maxu of 16; local 16-
// and g 32-byte aligned. C = 8 is one 8-wide chunk, wider C 64-wide chunks.
extern "C" int probe_onehot_dot(const void* local, const void* g, void* out,
                                long long n_tiles, int tile, int maxu, int C,
                                void* stream) {
  if (n_tiles <= 0) return (int)cudaSuccess;
  if (C == 8)
    return onehot_dot<8>(local, g, out, n_tiles, tile, maxu, C, stream);
  return onehot_dot<64>(local, g, out, n_tiles, tile, maxu, C, stream);
}

extern "C" int probe_iota(void* out, long long n_tiles, int tile, int C,
                          void* stream) {
  const long long n = (long long)tile * C;
  if (n > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  const bool vec = C % 4 == 0 && (uintptr_t)out % 16 == 0;
  unsigned slices = 0;
  const long long blocks =
      fill_grid(n_tiles, n, vec ? kFillSlice : kFillThreads, &slices);
  if (blocks <= 0)
    return (int)(blocks ? cudaErrorInvalidConfiguration : cudaSuccess);
  const auto kernel = vec ? iota_rows_kernel<true> : iota_rows_kernel<false>;
  kernel<<<(unsigned)blocks, kFillThreads, 0, (cudaStream_t)stream>>>(
      (float*)out, (int64_t)n, (unsigned)C, slices);
  return (int)cudaGetLastError();
}
