// K8: the train path's ray march, by hand for Hopper (sm_90a).
//
//   for each ray r, events i = 0 .. S-1 from t = t0[r]:
//     ts[r, i] = t, dts[r, i] = dt(t), valid[r, i] = occupied(t) && t < far
//     t = t + dt (occupied cell) or a jump past the empty cells around t
//
// Replaces no Pallas kernel. The JAX package marches with an XLA
// lax.scan inside a while_loop (laenerf_tpu/ops/raymarch.py::
// march_rays_train); the port first ran the same events as a Python loop of
// small PyTorch operations over all rays (ops/raymarch.py::
// march_rays_train_plain), about 60 launches an event and ~27,000 a train
// step at 1,024 events, so a profile of the train step on the H100 showed
// the card idle most of the step while the host dispatched the march. This
// kernel is that loop as one launch, a thread a ray, as the reference
// LAENeRF/torch-ngp marches (raymarching.cu:312-480).
//
// Numbers: the kernel computes the plain loop's function bit for bit on
// every slot the loop marks valid. Each PyTorch operation of the loop is a
// kernel of its own that rounds once, so every multiply, add and divide
// here is an explicit round-to-nearest intrinsic (__fmul_rn, __fadd_rn,
// __fsub_rn, __fdiv_rn): nvcc would otherwise contract a multiply and an
// add into one FMA and move t by an ulp. min, max and clamp propagate NaN
// as torch.clamp, torch.amin and torch.maximum do on the card (a zero
// direction component puts 0 * inf into the exit distances); float to int
// conversions truncate, as .to(torch.int32) does. Every scalar constant
// comes from the host already rounded to float, as PyTorch rounds a Python
// number before it meets a float32 tensor.
//
// What bounds it on an H100: latency, not bandwidth. The outputs are N * S *
// 9 bytes (ts and dts f32, valid one byte), 75.5 MB at the NeRF cell's
// 8,192 rays x 1,024 events, 22.5 us at 3.35 TB/s; but each event is one
// dependent load of the int8 skip field (2 MB at 128^3, held in L2) and a
// chain of ~60 dependent float operations, and a warp runs until its
// slowest ray ends. The design:
//   - 64-thread blocks, so that 8,192 rays spread over 128 of the 132 SMs
//     instead of 32 blocks of 256.
//   - A warp stages 32 events of its 32 rays' ts and dts in shared memory
//     (a padded 32 x 33 tile, no bank conflicts either way) and their valid
//     bits in a register mask, then stores them row by row: each store
//     instruction writes one ray's 32 consecutive slots, 128 coalesced bytes
//     of ts, not 32 scattered 4-byte stores an event.
//   - A ray that has ended (t >= far) skips the load and the arithmetic;
//     once every ray of a warp has ended, the warp fills the rest of its rows
//     with their frozen values (ts = the last t, dts = dt(t), valid false)
//     straight from registers, with the same row stores.
//   - Every slot is written, so the outputs are torch.empty; the kernel
//     also writes each ray's valid count and its live events (events whose
//     t was < far, which the tracer reads). No host synchronisation.
// The plain loop stops at the end of the first 32-event block at which no
// ray is alive and leaves zeros after it; the kernel writes frozen values
// there instead. Nothing reads ts or dts where valid is false. A ray whose
// t turns NaN (a zero direction component and an origin on a cell's exit
// plane give 0 * inf) is never done, so the loop marks its occupied events
// valid until the batch stops; a second, one-block pass
// (march_unended_kernel) clears its valid bits after that point, so that
// valid and n_samples equal the loop's on every ray.
//
// Plain C interface, loaded with ctypes. The kernels run on the caller's
// stream and the entry point returns cudaGetLastError() after the launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;  // 2 warps a block
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;  // events a warp stages before it stores them
constexpr int kPitch = kChunk + 1;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  int N, S, H, top_level;  // top_level: cascades - 1
  float bound, dt_min, dt_max, gamma;
  // single level: mb = min(1, bound), scale = 0.5 H / mb,
  // cell_world = (2 / H) mb; both: two_over_h = 2 / H, h_minus_1 = H - 1,
  // h = H; multi-level: tiny = 1e-30, the floor under log2's argument
  float mb, scale, cell_world, two_over_h, h_minus_1, h, tiny;
};

__device__ __forceinline__ bool is_nan(float v) { return v != v; }

// torch.clamp on the card: NaN passes, else min(max(v, lo), hi)
__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  return is_nan(v) ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float clamp_min_nan(float v, float lo) {
  return is_nan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_max_nan(float v, float hi) {
  return is_nan(v) ? v : fminf(v, hi);
}
// torch.maximum on the card: a NaN operand wins, the first one first
__device__ __forceinline__ float maximum_nan(float a, float b) {
  return is_nan(a) ? a : (is_nan(b) ? b : fmaxf(a, b));
}
// the combine step of torch.amin's reduction on the card
__device__ __forceinline__ float min_nan(float a, float b) {
  return (is_nan(a) || a < b) ? a : b;
}

// floor(log2(max(v, tiny))) + 1: frexp's exponent of v > 0
__device__ __forceinline__ int frexp_exp(float v, float tiny) {
  return __float2int_rz(floorf(log2f(clamp_min_nan(v, tiny)))) + 1;
}

struct Ray {
  float ox, oy, oz, dx, dy, dz;
  float rx, ry, rz;  // 1 / d
  float fx, fy, fz;  // 0.5 + 0.5 sign(d): the exit face per axis
};

__device__ __forceinline__ float face_of(float d) {
  const float sgn = static_cast<float>((0.0f < d) - (d < 0.0f));
  return __fadd_rn(__fmul_rn(sgn, 0.5f), 0.5f);
}

__device__ __forceinline__ float dt_of(float t, const Params& p) {
  return p.gamma == 0.0f ? p.dt_min
                         : clamp_nan(__fmul_rn(t, p.gamma), p.dt_min,
                                     p.dt_max);
}

// Single level: the cell of a clamped coordinate.
__device__ __forceinline__ int cell_single(float v, const Params& p) {
  return __float2int_rz(
      clamp_nan(__fmul_rn(__fadd_rn(v, p.mb), p.scale), 0.0f, p.h_minus_1));
}

// Cascades: the cell of a clamped coordinate in the level of inv = 1 / mip.
__device__ __forceinline__ int cell_multi(float v, float inv,
                                          const Params& p) {
  const float u = __fmul_rn(__fadd_rn(__fmul_rn(v, inv), 1.0f), 0.5f);
  return __float2int_rz(clamp_nan(__fmul_rn(u, p.h), 0.0f, p.h_minus_1));
}

// make_march_event's event at t for a ray that is not done: whether the
// cell at t is occupied, and the t of the next event.
template <bool kSingle>
__device__ __forceinline__ float march_event(const Ray& r, float t, float dt,
                                             const int8_t* __restrict__ skip,
                                             const Params& p, bool& occ) {
  const float x = clamp_nan(__fadd_rn(r.ox, __fmul_rn(t, r.dx)), -p.bound,
                            p.bound);
  const float y = clamp_nan(__fadd_rn(r.oy, __fmul_rn(t, r.dy)), -p.bound,
                            p.bound);
  const float z = clamp_nan(__fadd_rn(r.oz, __fmul_rn(t, r.dz)), -p.bound,
                            p.bound);
  const int H = p.H;
  int nx, ny, nz, idx;
  float mip, cell_world;
  if (kSingle) {
    nx = cell_single(x, p);
    ny = cell_single(y, p);
    nz = cell_single(z, p);
    idx = (nx * H + ny) * H + nz;
    mip = p.mb;
    cell_world = p.cell_world;
  } else {
    const float mx_pos =
        maximum_nan(fabsf(x), maximum_nan(fabsf(y), fabsf(z)));
    const float mx_dt = __fmul_rn(__fmul_rn(dt, p.h), 0.5f);
    int level = max(frexp_exp(mx_pos, p.tiny), frexp_exp(mx_dt, p.tiny));
    level = min(max(level, 0), p.top_level);
    mip = clamp_max_nan(exp2f(static_cast<float>(level)), p.bound);
    const float inv = __fdiv_rn(1.0f, mip);
    nx = cell_multi(x, inv, p);
    ny = cell_multi(y, inv, p);
    nz = cell_multi(z, inv, p);
    idx = ((level * H + nx) * H + ny) * H + nz;
    cell_world = __fmul_rn(mip, p.two_over_h);
  }
  const int f = __ldg(skip + idx);
  occ = f == 0;

  // distance to the cell's exit face along each axis
  const float tvx = __fmul_rn(
      __fsub_rn(__fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(
                                        static_cast<float>(nx), r.fx),
                                    p.two_over_h), 1.0f), mip), x), r.rx);
  const float tvy = __fmul_rn(
      __fsub_rn(__fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(
                                        static_cast<float>(ny), r.fy),
                                    p.two_over_h), 1.0f), mip), y), r.ry);
  const float tvz = __fmul_rn(
      __fsub_rn(__fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(
                                        static_cast<float>(nz), r.fz),
                                    p.two_over_h), 1.0f), mip), z), r.rz);
  const float tt_fine = __fadd_rn(
      t, clamp_min_nan(min_nan(min_nan(tvx, tvy), tvz), 0.0f));

  // field level f guarantees 2^(f-1) - 1 free cells in every direction
  const float m = static_cast<float>((1 << max(f - 1, 0)) - 1);
  const float tt = maximum_nan(tt_fine, __fadd_rn(t, __fmul_rn(m, cell_world)));

  // jump on the dt lattice
  const float n_skip = __fadd_rn(floorf(__fdiv_rn(__fsub_rn(tt, t), dt)), 1.0f);
  const float t_skip = __fadd_rn(t, __fmul_rn(clamp_min_nan(n_skip, 1.0f), dt));
  return occ ? __fadd_rn(t, dt) : t_skip;
}

template <bool kSingle>
__global__ void __launch_bounds__(kThreads)
    march_rays_train_kernel(const float* __restrict__ rays_o,
                            const float* __restrict__ rays_d,
                            const int8_t* __restrict__ skip,
                            const float* __restrict__ t0,
                            const float* __restrict__ fars,
                            float* __restrict__ ts, float* __restrict__ dts,
                            uint8_t* __restrict__ valid,
                            int* __restrict__ n_samples,
                            int* __restrict__ live_events, Params p) {
  __shared__ float s_ts[kWarps][32][kPitch];
  __shared__ float s_dt[kWarps][32][kPitch];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads +
                          warp * 32;  // the warp's first ray
  if (first >= p.N) return;  // whole warps only: the rest stay converged
  const long long ray = first + lane;
  const bool has_ray = ray < p.N;
  const int rows = static_cast<int>(min(32LL, p.N - first));
  const int S = p.S;

  Ray r{};
  float t = 0.0f, far = 0.0f;  // a lane without a ray is done at once
  if (has_ray) {
    r.ox = rays_o[3 * ray];
    r.oy = rays_o[3 * ray + 1];
    r.oz = rays_o[3 * ray + 2];
    r.dx = rays_d[3 * ray];
    r.dy = rays_d[3 * ray + 1];
    r.dz = rays_d[3 * ray + 2];
    r.rx = __fdiv_rn(1.0f, r.dx);
    r.ry = __fdiv_rn(1.0f, r.dy);
    r.rz = __fdiv_rn(1.0f, r.dz);
    r.fx = face_of(r.dx);
    r.fy = face_of(r.dy);
    r.fz = face_of(r.dz);
    t = t0[ray];
    far = fars[ray];
  }
  int count = 0, live = 0;

  int c0 = 0;
  for (; c0 < S; c0 += kChunk) {
    if (__all_sync(kFull, t >= far)) break;  // every ray frozen
    const int n = min(kChunk, S - c0);
    unsigned mask = 0;
    for (int j = 0; j < n; ++j) {
      const float dt = dt_of(t, p);
      const bool done = t >= far;  // a NaN t marches on, as in the loop
      live += t < far;
      s_ts[warp][lane][j] = t;
      s_dt[warp][lane][j] = dt;
      if (!done) {
        bool occ;
        t = march_event<kSingle>(r, t, dt, skip, p, occ);
        mask |= static_cast<unsigned>(occ) << j;
      }
    }
    count += __popc(mask);
    __syncwarp();
    for (int k = 0; k < rows; ++k) {
      const unsigned m = __shfl_sync(kFull, mask, k);
      if (lane < n) {
        const long long at = (first + k) * S + c0 + lane;
        ts[at] = s_ts[warp][k][lane];
        dts[at] = s_dt[warp][k][lane];
        valid[at] = (m >> lane) & 1u;
      }
    }
    __syncwarp();
  }
  // the frozen tail: every ray of the warp has t >= far from event c0 on
  const float dt_end = dt_of(t, p);
  for (int k = 0; k < rows; ++k) {
    const float tk = __shfl_sync(kFull, t, k);
    const float dk = __shfl_sync(kFull, dt_end, k);
    const long long row = (first + k) * S;
    for (int c = c0 + lane; c < S; c += 32) {
      ts[row + c] = tk;
      dts[row + c] = dk;
      valid[row + c] = 0;
    }
  }
  if (has_ray) {
    n_samples[ray] = count;
    live_events[ray] = live;
  }
}

// The plain loop marches whole blocks of kChunk events while any ray is
// alive (t < far) and leaves everything after its last block invalid. A ray
// whose t or far is NaN is never alive and never done (t >= far), so the
// loop marks its occupied events valid until the batch's last live ray
// ends, and K8, which cannot see the batch, marches it to S. This pass
// clears such a ray's valid bits from the loop's last event on and takes
// them off its n_samples. One block: the batch's longest live run decides
// where the loop stopped. Every other ray has no valid bit there: its live
// events end by the loop's last, and it is done from then on.
constexpr int kUnendedThreads = 1024;

__global__ void __launch_bounds__(kUnendedThreads)
    march_unended_kernel(const float* __restrict__ ts,
                         const float* __restrict__ fars,
                         const int* __restrict__ live_events,
                         uint8_t* __restrict__ valid,
                         int* __restrict__ n_samples, int N, int S) {
  __shared__ int s_longest;
  if (threadIdx.x == 0) s_longest = 0;
  __syncthreads();
  int longest = 0;
  for (int r = threadIdx.x; r < N; r += kUnendedThreads)
    longest = max(longest, live_events[r]);
  longest = __reduce_max_sync(kFull, longest);
  if (threadIdx.x % 32 == 0) atomicMax(&s_longest, longest);
  __syncthreads();
  const int n_run = min(S, (s_longest + kChunk - 1) / kChunk * kChunk);
  if (n_run == S) return;
  for (int r = threadIdx.x; r < N; r += kUnendedThreads) {
    const long long row = static_cast<long long>(r) * S;
    if (ts[row + S - 1] >= fars[r]) continue;  // the ray ended
    int cleared = 0;
    for (int c = n_run; c < S; ++c) {
      cleared += valid[row + c];
      valid[row + c] = 0;
    }
    n_samples[r] -= cleared;
  }
}

template <bool kSingle>
cudaError_t launch(const void* rays_o, const void* rays_d, const void* skip,
                   const void* t0, const void* fars, void* ts, void* dts,
                   void* valid, void* n_samples, void* live_events,
                   const Params& p, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((p.N + kThreads - 1) /
                                                kThreads);
  march_rays_train_kernel<kSingle><<<blocks, kThreads, 0, stream>>>(
      static_cast<const float*>(rays_o), static_cast<const float*>(rays_d),
      static_cast<const int8_t*>(skip), static_cast<const float*>(t0),
      static_cast<const float*>(fars), static_cast<float*>(ts),
      static_cast<float*>(dts), static_cast<uint8_t*>(valid),
      static_cast<int*>(n_samples), static_cast<int*>(live_events), p);
  if (p.S > kChunk && p.S % kChunk == 0)  // the plain loop's blocks
    march_unended_kernel<<<1, kUnendedThreads, 0, stream>>>(
        static_cast<const float*>(ts), static_cast<const float*>(fars),
        static_cast<const int*>(live_events), static_cast<uint8_t*>(valid),
        static_cast<int*>(n_samples), p.N, p.S);
  return cudaGetLastError();
}

}  // namespace

// rays_o, rays_d [N, 3] f32; skip the flat int8 skip field; t0, fars [N]
// f32; outputs ts, dts [N, S] f32, valid [N, S] bool, n_samples and
// live_events [N] int32. The scalars are MarchConfig's, rounded to float
// on the host; cascades == 1 picks the kernel's variant.
extern "C" int march_rays_train(const void* rays_o, const void* rays_d,
                                const void* skip, const void* t0,
                                const void* fars, void* ts, void* dts,
                                void* valid, void* n_samples,
                                void* live_events, int N, int S, int H,
                                int cascades, float bound, float dt_min,
                                float dt_max, float gamma, float mb,
                                float scale, float cell_world,
                                float two_over_h, float h_minus_1, float h,
                                float tiny, void* stream) {
  if (N <= 0 || S <= 0) return 0;
  const Params p{N,      S,     H,          cascades - 1, bound,
                 dt_min, dt_max, gamma,     mb,           scale,
                 cell_world, two_over_h, h_minus_1, h,    tiny};
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      cascades == 1
          ? launch<true>(rays_o, rays_d, skip, t0, fars, ts, dts, valid,
                         n_samples, live_events, p, s)
          : launch<false>(rays_o, rays_d, skip, t0, fars, ts, dts, valid,
                          n_samples, live_events, p, s);
  return static_cast<int>(err);
}
