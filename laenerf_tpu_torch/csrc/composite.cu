// K9: the train path's composite over packed samples, by hand for Hopper
// (sm_90a), forward and backward.
//
//   for each ray r, its evaluated samples p = start_r .. start_r + k_r - 1
//   (ray by ray, in march order, as the train path's compaction packs them):
//     sd = sigma * dt, csum += sd
//     w = (1 - exp(-sd)) * exp(-(csum - sd)), times 0 unless the
//         transmittance before the sample, exp(-csum_prev), is >= T_thresh
//     weights_sum += w, depth += w * ((t + dt) - t0), image += w * rgb
//
// Replaces no Pallas kernel. The JAX package composites a padded [N, S]
// grid of sample slots with XLA operations (laenerf_tpu/ops/composite.py::
// composite_rays_train) after scattering the evaluated samples back into it
// (ops/compaction.py::scatter_back). The port did the same with PyTorch
// operations: at the NeRF cell's 8,192 rays x 1,024 slots, a 16-byte row
// gather at each of the 8.4 M slots (~5 ms a step on the H100, nearly every
// slot reading the one fill row) and ~15 elementwise passes with their
// autograd backward. These kernels read the M packed samples instead, as
// torch-ngp composites (raymarching.cu: composite_rays_train_forward and
// _backward).
//
// Numbers: the forward keeps the padded function's arithmetic, each multiply,
// add and subtract an explicit round-to-nearest intrinsic, so that nvcc
// contracts none of them into an FMA and the backward recomputes the running
// sum and the keep-mask bit for bit; expf is the accurate one (no fast
// math). The running sum is a warp scan, so it adds in another order than
// torch.cumsum on the CPU, and the sums over a ray in another order than
// torch.sum: results differ from the padded function's by rounding.
// Backward (torch-ngp's suffix form, with w' = dL/dw = g_ws + g_depth *
// delta + g_image . rgb):
//   dL/drgb_k   = g_image * w_k
//   dL/dsigma_k = dt_k * (mask_k * exp(-(csum_k - sd_k)) * exp(-sd_k) * w'_k
//                         - sum_{i > k} w_i w'_i)
// where the suffix sum is Q - (its prefix through k), Q = g_ws * weights_sum
// + g_depth * depth + g_image . image from the forward's outputs, and is 0
// exactly from the last sample whose keep-mask is set (the forward's
// n_open): past it every w is 0, as autograd finds through the padded
// function's cumsum.
//
// What bounds it on an H100: latency. The bytes are few (the forward reads
// M x 24 B and writes N x 24 B: 6.5 MB at the NeRF cell's 262,144 samples,
// ~2 us at 3.35 TB/s; the backward reads as much again and writes M x 16
// B), but a ray's samples are a chain through the running sum, and rays hold
// 0 to S samples. A warp takes one ray: its lanes load 32 consecutive
// samples at a time (coalesced), a shuffle scan carries the running sum
// across them, and each lane keeps partial sums that one butterfly adds at
// the end. A long ray costs ceil(k / 32) rounds, not k; an empty ray one
// load of its count. Four rays a block. No host synchronisation; every
// output element is written, so the wrapper allocates with torch.empty.
//
// Plain C interface, loaded with ctypes. The kernels run on the caller's
// stream and each entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRays = 4;  // rays (warps) a block
constexpr unsigned kFull = 0xffffffffu;

// Ray r's first packed sample and how many of its samples were evaluated:
// ends is the inclusive running count of the rays' samples, and only the
// first M of all of them were evaluated.
__device__ __forceinline__ int ray_run(const int64_t* ends,
                                       const int32_t* counts, int r,
                                       int64_t M, int64_t* start) {
  const int n = counts[r];
  *start = ends[r] - n;
  const int64_t room = M - *start;
  return room <= 0 ? 0 : (room < n ? static_cast<int>(room) : n);
}

// Inclusive prefix sum over the warp's lanes.
__device__ __forceinline__ float warp_scan(float x, int lane) {
#pragma unroll
  for (int o = 1; o < kWarp; o <<= 1) {
    const float y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x = __fadd_rn(x, y);
  }
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1)
    x = __fadd_rn(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

// One round of 32 samples of a ray: the loads, the running sum and the
// keep-mask, shared by the forward and the backward so that both compute
// them alike.
struct Sample {
  bool in;     // the lane holds one of the ray's evaluated samples
  bool keep;   // the transmittance before it is >= T_thresh
  float sd;    // sigma * dt
  float csum;  // the running sum through this sample
  float dt;
};

__device__ __forceinline__ Sample load_round(const float* sigma,
                                             const float* dts, int64_t p,
                                             bool in, float carry, int lane,
                                             float T_thresh) {
  Sample s;
  s.in = in;
  s.dt = in ? dts[p] : 0.0f;
  s.sd = __fmul_rn(in ? sigma[p] : 0.0f, s.dt);
  s.csum = __fadd_rn(carry, warp_scan(s.sd, lane));
  float prev = __shfl_up_sync(kFull, s.csum, 1);
  if (lane == 0) prev = carry;  // the first sample of a ray sees exp(0) = 1
  s.keep = in && expf(-prev) >= T_thresh;
  return s;
}

__global__ void __launch_bounds__(kRays * kWarp)
    composite_forward_kernel(const float* __restrict__ sigma,
                             const float* __restrict__ rgb,
                             const float* __restrict__ ts,
                             const float* __restrict__ dts,
                             const int64_t* __restrict__ ends,
                             const int32_t* __restrict__ counts,
                             const float* __restrict__ t0, int N, int64_t M,
                             float T_thresh, float* __restrict__ ws_out,
                             float* __restrict__ depth_out,
                             float* __restrict__ image_out,
                             int32_t* __restrict__ open_out) {
  const int lane = threadIdx.x % kWarp;
  const int r = blockIdx.x * kRays + threadIdx.x / kWarp;
  if (r >= N) return;  // the whole warp
  int64_t start;
  const int k = ray_run(ends, counts, r, M, &start);
  const float t0r = t0[r];
  float carry = 0.0f;
  float ws = 0.0f, depth = 0.0f, c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;
  int n_open = 0;  // 1 + the last sample whose keep-mask is set
  for (int base = 0; base < k; base += kWarp) {
    const int i = base + lane;
    const int64_t p = start + i;
    const Sample s = load_round(sigma, dts, p, i < k, carry, lane, T_thresh);
    if (s.in) {
      const float T = expf(-__fsub_rn(s.csum, s.sd));
      const float alpha = __fsub_rn(1.0f, expf(-s.sd));
      const float w = __fmul_rn(__fmul_rn(alpha, T), s.keep ? 1.0f : 0.0f);
      const float delta = __fsub_rn(__fadd_rn(ts[p], s.dt), t0r);
      ws = __fadd_rn(ws, w);
      depth = __fadd_rn(depth, __fmul_rn(w, delta));
      c0 = __fadd_rn(c0, __fmul_rn(w, rgb[3 * p]));
      c1 = __fadd_rn(c1, __fmul_rn(w, rgb[3 * p + 1]));
      c2 = __fadd_rn(c2, __fmul_rn(w, rgb[3 * p + 2]));
    }
    const unsigned open = __ballot_sync(kFull, s.keep);
    if (open) n_open = base + kWarp - __clz(open);
    carry = __shfl_sync(kFull, s.csum, kWarp - 1);
  }
  ws = warp_sum(ws);
  depth = warp_sum(depth);
  c0 = warp_sum(c0);
  c1 = warp_sum(c1);
  c2 = warp_sum(c2);
  if (lane == 0) {
    ws_out[r] = ws;
    depth_out[r] = depth;
    image_out[3 * r] = c0;
    image_out[3 * r + 1] = c1;
    image_out[3 * r + 2] = c2;
    open_out[r] = n_open;
  }
}

// Gradients to sigma [M] and rgb [M, 3]. A null output gradient reads 0.
__global__ void __launch_bounds__(kRays * kWarp)
    composite_backward_kernel(
        const float* __restrict__ g_ws, const float* __restrict__ g_depth,
        const float* __restrict__ g_image, const float* __restrict__ sigma,
        const float* __restrict__ rgb, const float* __restrict__ ts,
        const float* __restrict__ dts, const int64_t* __restrict__ ends,
        const int32_t* __restrict__ counts, const float* __restrict__ t0,
        const float* __restrict__ ws, const float* __restrict__ depth,
        const float* __restrict__ image, const int32_t* __restrict__ n_open,
        int N, int64_t M, float T_thresh, float* __restrict__ g_sigma,
        float* __restrict__ g_rgb) {
  const int lane = threadIdx.x % kWarp;
  const int r = blockIdx.x * kRays + threadIdx.x / kWarp;
  if (r >= N) return;
  int64_t start;
  const int k = ray_run(ends, counts, r, M, &start);
  if (k == 0) return;
  const float t0r = t0[r];
  const int open = n_open[r];
  const float gw = g_ws ? g_ws[r] : 0.0f;
  const float gd = g_depth ? g_depth[r] : 0.0f;
  const float gi0 = g_image ? g_image[3 * r] : 0.0f;
  const float gi1 = g_image ? g_image[3 * r + 1] : 0.0f;
  const float gi2 = g_image ? g_image[3 * r + 2] : 0.0f;
  // sum over the ray of w * dL/dw
  const float Q = gw * ws[r] + gd * depth[r] + gi0 * image[3 * r] +
                  gi1 * image[3 * r + 1] + gi2 * image[3 * r + 2];
  float carry = 0.0f, q_carry = 0.0f;
  for (int base = 0; base < k; base += kWarp) {
    const int i = base + lane;
    const int64_t p = start + i;
    const Sample s = load_round(sigma, dts, p, i < k, carry, lane, T_thresh);
    float w = 0.0f, q = 0.0f, direct = 0.0f;
    if (s.in) {
      const float T = expf(-__fsub_rn(s.csum, s.sd));
      const float e = expf(-s.sd);
      w = __fmul_rn(__fmul_rn(__fsub_rn(1.0f, e), T), s.keep ? 1.0f : 0.0f);
      const float delta = __fsub_rn(__fadd_rn(ts[p], s.dt), t0r);
      const float gwk = gw + gd * delta +
                        (gi0 * rgb[3 * p] + gi1 * rgb[3 * p + 1] +
                         gi2 * rgb[3 * p + 2]);
      q = w * gwk;
      direct = s.keep ? gwk * T * e : 0.0f;
    }
    const float prefix = q_carry + warp_scan(q, lane);
    if (s.in) {
      const float suffix = i + 1 < open ? Q - prefix : 0.0f;
      g_sigma[p] = (direct - suffix) * s.dt;
      g_rgb[3 * p] = gi0 * w;
      g_rgb[3 * p + 1] = gi1 * w;
      g_rgb[3 * p + 2] = gi2 * w;
    }
    carry = __shfl_sync(kFull, s.csum, kWarp - 1);
    q_carry = __shfl_sync(kFull, prefix, kWarp - 1);
  }
}

inline int blocks_for(int N) { return (N + kRays - 1) / kRays; }

}  // namespace

extern "C" int composite_rays_train_packed(
    const void* sigma, const void* rgb, const void* dts, const void* ts,
    const void* ends, const void* counts, const void* t0, void* ws,
    void* depth, void* image, void* n_open, int N, long long M,
    float T_thresh, void* stream) {
  if (N <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  composite_forward_kernel<<<blocks_for(N), kRays * kWarp, 0, s>>>(
      static_cast<const float*>(sigma), static_cast<const float*>(rgb),
      static_cast<const float*>(ts), static_cast<const float*>(dts),
      static_cast<const int64_t*>(ends), static_cast<const int32_t*>(counts),
      static_cast<const float*>(t0), N, M, T_thresh,
      static_cast<float*>(ws), static_cast<float*>(depth),
      static_cast<float*>(image), static_cast<int32_t*>(n_open));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int composite_rays_train_packed_backward(
    const void* g_ws, const void* g_depth, const void* g_image,
    const void* sigma, const void* rgb, const void* dts, const void* ts,
    const void* ends, const void* counts, const void* t0, const void* ws,
    const void* depth, const void* image, const void* n_open,
    void* g_sigma, void* g_rgb, int N, long long M, float T_thresh,
    void* stream) {
  if (N <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  composite_backward_kernel<<<blocks_for(N), kRays * kWarp, 0, s>>>(
      static_cast<const float*>(g_ws), static_cast<const float*>(g_depth),
      static_cast<const float*>(g_image), static_cast<const float*>(sigma),
      static_cast<const float*>(rgb), static_cast<const float*>(ts),
      static_cast<const float*>(dts), static_cast<const int64_t*>(ends),
      static_cast<const int32_t*>(counts), static_cast<const float*>(t0),
      static_cast<const float*>(ws), static_cast<const float*>(depth),
      static_cast<const float*>(image), static_cast<const int32_t*>(n_open),
      N, M, T_thresh, static_cast<float*>(g_sigma),
      static_cast<float*>(g_rgb));
  return static_cast<int>(cudaGetLastError());
}
