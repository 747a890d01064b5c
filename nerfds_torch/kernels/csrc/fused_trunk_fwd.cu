// NeRF trunk forward with dsigma/dfeat for Hopper (sm_90a), f32 in and out.
//
// Replaces the TPU kernel nerfds_tpu/pallas/fused_trunk.py:_fwd_kernel
// (called by _pallas_forward). One launch computes, for every row of feat:
// the relu trunk (depth x 256, input re-fed at the skip layers), the
// sigma + normal head, the bottleneck, and g = dsigma/dfeat by a reverse
// sweep over the stored relu masks seeded with the sigma column of the head.
// Outputs: sigma [N,1], normal [N,norm_dim], trunk_out [N,256],
// bottleneck [N,256], g [N,D].
//
// Bound: operations. The nerf_ds trunk (8 x 256, skip at 4, D = 52) does
// about 1.04 M multiply-adds per row, forward and reverse, against about
// 2.3 KB of input and output per row: far above the f32 CUDA-core ridge.
// Design: a block owns a tile of 32 rows and keeps the tile's input, its
// current activation and the relu masks of every layer in shared memory
// (about 105 KB for depth 8, so two blocks fit on an SM); no per-layer
// activation ever reaches device memory. Weights (about 2.3 MB) stream
// through L1/L2: each warp reads one contiguous 1 KB weight row per step of
// the contraction and every warp of the block reuses it from L1. Each thread
// keeps a 4 x 8 register tile of the 32 x 256 layer output, so each weight
// value loaded feeds four FMAs. The wrapper passes every weight in both
// orientations ([in, out] for the forward, [out, in] for the reverse sweep),
// so both directions read contiguous rows. Plain FMA loops; wgmma, TMA and
// bf16 are later work. The Mosaic layout rule of the TPU kernel does not
// apply here.
#include <cuda_runtime.h>
#include <stdint.h>

#include "trunk_tile.cuh"

namespace {

constexpr int MAXD = 16;       // deepest trunk supported

struct TrunkParams {
  const float* wf_h[MAXD];  // forward weight read by h ([D,256] at layer 0)
  const float* wf_x[MAXD];  // forward weight read by feat at skip layers
  const float* wr_h[MAXD];  // reverse weight to h, [256 out, 256 in]
  const float* wr_x[MAXD];  // reverse weight to feat, [256 out, D]
  const float* b[MAXD];
  const float* head_w;      // [256, hc]
  const float* head_b;      // [hc]
  const float* bn_w;        // [256, 256] or null
  const float* bn_b;        // [256] or null
};

__global__ void __launch_bounds__(NT, 2) fused_trunk_fwd_kernel(
    const float* __restrict__ feat, int n, int d, int depth,
    unsigned skip_bits, int hc, int norm_dim, int has_bn, TrunkParams p,
    float* __restrict__ sigma_out, float* __restrict__ norm_out,
    float* __restrict__ trunk_out, float* __restrict__ bn_out,
    float* __restrict__ g_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* hbuf = reinterpret_cast<float*>(smem);  // [TM][LDH]
  float* xbuf = hbuf + TM * LDH;                 // [TM][LDX]
  uint8_t* masks = reinterpret_cast<uint8_t*>(xbuf + TM * LDX);  // [depth][TM][WIDTH]

  const int t = threadIdx.x;
  const int row0 = blockIdx.x * TM;
  for (int i = t; i < TM * d; i += NT) {
    const int r = i / d, c = i - r * d;
    const int gr = row0 + r;
    xbuf[r * LDX + c] = gr < n ? feat[static_cast<size_t>(gr) * d + c] : 0.0f;
  }
  __syncthreads();

  const int c0 = (t & 31) * 8, r0 = (t >> 5) * 4;
  float acc[4][8];

  // Forward: h_i = relu(h_{i-1} W_i [+ feat Wx_i] + b_i); masks_i = h_i > 0.
  for (int i = 0; i < depth; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[r][j] = __ldg(p.b[i] + c0 + j);
    if (i == 0) {
      mm_wide(acc, xbuf, LDX, d, p.wf_h[0]);
    } else {
      mm_wide(acc, hbuf, LDH, WIDTH, p.wf_h[i]);
      if ((skip_bits >> i) & 1u) mm_wide(acc, xbuf, LDX, d, p.wf_x[i]);
    }
    __syncthreads();  // every read of h_{i-1} is done
    uint8_t* m = masks + static_cast<size_t>(i) * TM * WIDTH;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      unsigned long long bits = 0ull;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const bool on = acc[r][j] > 0.0f;
        bits |= static_cast<unsigned long long>(on) << (8 * j);
        hbuf[(r0 + r) * LDH + c0 + j] = on ? acc[r][j] : 0.0f;
      }
      *reinterpret_cast<unsigned long long*>(m + (r0 + r) * WIDTH + c0) = bits;
    }
    __syncthreads();
  }

  // trunk_out.
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int gr = row0 + r0 + r;
    if (gr < n) {
      float* dst = trunk_out + static_cast<size_t>(gr) * WIDTH + c0;
      const float* src = hbuf + (r0 + r) * LDH + c0;
      reinterpret_cast<float4*>(dst)[0] = make_float4(src[0], src[1], src[2], src[3]);
      reinterpret_cast<float4*>(dst)[1] = make_float4(src[4], src[5], src[6], src[7]);
    }
  }

  // Head: [sigma, normal] = h W_head + b_head.
  {
    const int hc0 = (t & 7) * 8, hrow = t >> 3;
    float hacc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) hacc[j] = (hc0 + j < hc) ? __ldg(p.head_b + hc0 + j) : 0.0f;
    mm_narrow(hacc, hbuf, LDH, WIDTH, p.head_w, hc);
    const int gr = row0 + hrow;
    if (gr < n && hc0 == 0) {
      sigma_out[gr] = hacc[0];
      for (int j = 0; j < norm_dim; ++j)
        norm_out[static_cast<size_t>(gr) * norm_dim + j] = hacc[1 + j];
    }
  }

  // Bottleneck (or trunk_out again when there is none).
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      acc[r][j] = has_bn ? __ldg(p.bn_b + c0 + j) : hbuf[(r0 + r) * LDH + c0 + j];
  if (has_bn) mm_wide(acc, hbuf, LDH, WIDTH, p.bn_w);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int gr = row0 + r0 + r;
    if (gr < n) {
      float* dst = bn_out + static_cast<size_t>(gr) * WIDTH + c0;
      reinterpret_cast<float4*>(dst)[0] = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      reinterpret_cast<float4*>(dst)[1] = make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
    }
  }
  __syncthreads();  // head and bottleneck have read h

  // Reverse sweep, seeded with the sigma column of the head:
  // c_i = r_i * mask_i; r_{i-1} = c_i Wh_i^T; g += c_i Wx_i^T at layer 0
  // and at the skip layers.
  {
    const uint8_t* m = masks + static_cast<size_t>(depth - 1) * TM * WIDTH;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        hbuf[(r0 + r) * LDH + c0 + j] =
            m[(r0 + r) * WIDTH + c0 + j] ? __ldg(p.head_w + (c0 + j) * hc) : 0.0f;
  }
  __syncthreads();
  float gacc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int i = depth - 1; i >= 0; --i) {
    if (i == 0 || ((skip_bits >> i) & 1u)) mm_narrow(gacc, hbuf, LDH, WIDTH, p.wr_x[i], d);
    if (i > 0) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[r][j] = 0.0f;
      mm_wide(acc, hbuf, LDH, WIDTH, p.wr_h[i]);
      __syncthreads();  // every read of c_i is done
      const uint8_t* m = masks + static_cast<size_t>(i - 1) * TM * WIDTH;
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          hbuf[(r0 + r) * LDH + c0 + j] = m[(r0 + r) * WIDTH + c0 + j] ? acc[r][j] : 0.0f;
      __syncthreads();
    }
  }
  {
    const int gc0 = (t & 7) * 8, grow = row0 + (t >> 3);
    if (grow < n) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (gc0 + j < d) g_out[static_cast<size_t>(grow) * d + gc0 + j] = gacc[j];
    }
  }
}

}  // namespace

// ptrs: five per layer (wf_h, wf_x, wr_h, wr_x, bias; 0 where unused), then
// head_w, head_b, bn_w, bn_b. Returns cudaGetLastError() of the launch.
extern "C" int fused_trunk_fwd(const float* feat, const uint64_t* ptrs, int n,
                               int d, int depth, unsigned skip_bits, int hc,
                               int norm_dim, int has_bn, float* sigma,
                               float* norm, float* trunk, float* bneck,
                               float* g, void* stream) {
  if (depth < 1 || depth > MAXD || d < 1 || d > DMAX || hc < 1 ||
      hc > HCMAX || norm_dim < 0 || norm_dim >= hc || n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  TrunkParams p = {};
  for (int i = 0; i < depth; ++i) {
    p.wf_h[i] = reinterpret_cast<const float*>(ptrs[5 * i]);
    p.wf_x[i] = reinterpret_cast<const float*>(ptrs[5 * i + 1]);
    p.wr_h[i] = reinterpret_cast<const float*>(ptrs[5 * i + 2]);
    p.wr_x[i] = reinterpret_cast<const float*>(ptrs[5 * i + 3]);
    p.b[i] = reinterpret_cast<const float*>(ptrs[5 * i + 4]);
  }
  p.head_w = reinterpret_cast<const float*>(ptrs[5 * depth]);
  p.head_b = reinterpret_cast<const float*>(ptrs[5 * depth + 1]);
  p.bn_w = reinterpret_cast<const float*>(ptrs[5 * depth + 2]);
  p.bn_b = reinterpret_cast<const float*>(ptrs[5 * depth + 3]);

  const int smem = TM * LDH * 4 + TM * LDX * 4 + depth * TM * WIDTH;
  cudaError_t err = cudaFuncSetAttribute(
      fused_trunk_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n + TM - 1) / TM;
  fused_trunk_fwd_kernel<<<blocks, NT, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      feat, n, d, depth, skip_bits, hc, norm_dim, has_bn, p, sigma, norm,
      trunk, bneck, g);
  return static_cast<int>(cudaGetLastError());
}
