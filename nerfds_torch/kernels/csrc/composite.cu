// Volume-compositing forward for Hopper (sm_90a), f32 in and f32 out.
//
// Replaces the TPU kernel nerfds_tpu/pallas/composite.py:_kernel (called by
// _forward_pallas). Per ray it computes the distances (the last one 1e10 or
// 1e-19) times |dir|, alpha = 1 - exp(-sigma * dist), the exclusive running
// product of (1 - alpha + eps), the weights, and the rgb / depth / acc
// reductions; it writes weights, alpha and accum as well.
//
// Bound: device memory. At 4096 rays x 128 samples it moves about 17 MB
// (rgb, sigma and z in; weights, alpha and accum out) for some ten flops per
// sample: 5 us at 3.35 TB/s. At a training batch (512 rays) the bound is
// below a launch's own cost, so there the aim is the launch floor.
//
// Design: one warp a ray, WARPS rays a block (a 512-ray batch is 128 blocks
// over the 132 SMs). Lane l takes samples s0 + 32 u + l, so every load and
// store of sigma, z, weights, alpha and accum is one 128-byte line a warp;
// rgb's three channels are three loads a chunk whose lines the L1 cache
// shares. A pass issues the loads of UNROLL chunks of 32 samples before it
// uses any of them, so a 128-sample ray is one round trip to memory. The
// running product of a chunk is an inclusive scan of the 32 factors by
// shuffles (Hillis-Steele, 5 steps), shifted by one lane for the exclusive
// product and scaled by the product of the chunks before it; the sums are
// per lane over the ray, then a butterfly over the warp. Nothing but the
// inputs and outputs touches memory. The TPU kernel's log-prefix-sum by
// triangular matmul and its per-channel rgb planes existed only for Mosaic
// and are not carried over.
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;   // rays a block, one warp each
constexpr int LANES = 32;
constexpr int UNROLL = 4;  // chunks of LANES samples a pass loads at once

__global__ void __launch_bounds__(WARPS * LANES) composite_fwd_kernel(
    const float* __restrict__ rgb, const float* __restrict__ sigma,
    const float* __restrict__ z, const float* __restrict__ dirs,
    float* __restrict__ out_rgb, float* __restrict__ out_depth,
    float* __restrict__ out_acc, float* __restrict__ weights,
    float* __restrict__ alpha, float* __restrict__ accum, int num_rays,
    int num_samples, int sample_at_infinity, float eps) {
  const int lane = threadIdx.x & (LANES - 1);
  const int ray = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (ray >= num_rays) return;  // the whole warp: one ray a warp
  const float dx = __ldg(dirs + 3 * ray), dy = __ldg(dirs + 3 * ray + 1),
              dz = __ldg(dirs + 3 * ray + 2);
  const float dir_norm = sqrtf(dx * dx + dy * dy + dz * dz);
  const float last = sample_at_infinity ? 1e10f : 1e-19f;
  const size_t base = static_cast<size_t>(ray) * num_samples;

  float carry = 1.0f;  // product of (1 - alpha + eps) over earlier chunks
  float sr = 0.0f, sg = 0.0f, sb = 0.0f, sd = 0.0f, sa = 0.0f;
  for (int s0 = 0; s0 < num_samples; s0 += LANES * UNROLL) {
    float sig[UNROLL], zc[UNROLL], zn[UNROLL], cr[UNROLL], cg[UNROLL],
        cb[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int s = s0 + u * LANES + lane;
      sig[u] = zc[u] = zn[u] = cr[u] = cg[u] = cb[u] = 0.0f;
      if (s < num_samples) {
        const size_t i = base + s;
        sig[u] = __ldg(sigma + i);
        zc[u] = __ldg(z + i);
        if (s + 1 < num_samples) zn[u] = __ldg(z + i + 1);
        cr[u] = __ldg(rgb + 3 * i);
        cg[u] = __ldg(rgb + 3 * i + 1);
        cb[u] = __ldg(rgb + 3 * i + 2);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int s = s0 + u * LANES + lane;
      const bool valid = s < num_samples;
      const float dist = (s + 1 < num_samples ? zn[u] - zc[u] : last) * dir_norm;
      const float a = valid ? 1.0f - expf(-sig[u] * dist) : 0.0f;
      // Inclusive product over lanes 0..lane of this chunk's factors.
      float p = valid ? (1.0f - a) + eps : 1.0f;
#pragma unroll
      for (int d = 1; d < LANES; d <<= 1) {
        const float q = __shfl_up_sync(0xffffffffu, p, d);
        if (lane >= d) p *= q;
      }
      const float before = __shfl_up_sync(0xffffffffu, p, 1);
      const float trans = lane == 0 ? carry : carry * before;
      carry *= __shfl_sync(0xffffffffu, p, LANES - 1);
      if (!valid) continue;
      const float w = a * trans;
      const size_t i = base + s;
      alpha[i] = a;
      accum[i] = trans;
      weights[i] = w;
      sr += w * cr[u];
      sg += w * cg[u];
      sb += w * cb[u];
      sd += w * zc[u];
      sa += w;
    }
  }
#pragma unroll
  for (int d = LANES / 2; d > 0; d >>= 1) {
    sr += __shfl_xor_sync(0xffffffffu, sr, d);
    sg += __shfl_xor_sync(0xffffffffu, sg, d);
    sb += __shfl_xor_sync(0xffffffffu, sb, d);
    sd += __shfl_xor_sync(0xffffffffu, sd, d);
    sa += __shfl_xor_sync(0xffffffffu, sa, d);
  }
  if (lane == 0) {
    out_rgb[3 * ray] = sr;
    out_rgb[3 * ray + 1] = sg;
    out_rgb[3 * ray + 2] = sb;
    out_depth[ray] = sd;
    out_acc[ray] = sa;
  }
}

}  // namespace

extern "C" int composite_fwd(const float* rgb, const float* sigma,
                             const float* z, const float* dirs,
                             float* out_rgb, float* out_depth, float* out_acc,
                             float* weights, float* alpha, float* accum,
                             int num_rays, int num_samples,
                             int sample_at_infinity, float eps,
                             void* stream) {
  if (num_rays < 1 || num_samples < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (num_rays + WARPS - 1) / WARPS;
  composite_fwd_kernel<<<blocks, WARPS * LANES, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      rgb, sigma, z, dirs, out_rgb, out_depth, out_acc, weights, alpha, accum,
      num_rays, num_samples, sample_at_infinity, eps);
  return static_cast<int>(cudaGetLastError());
}
