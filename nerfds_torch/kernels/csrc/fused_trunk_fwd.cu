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
// 2.3 KB of input and output per row: far above the f32 CUDA-core ridge
// (16.2 ms at 67 TFLOP/s for a 524,288-row render chunk).
//
// Design (trunk_tile.cuh): a block owns 64 rows and keeps their input, the
// current activation and the relu bits of every layer in shared memory; no
// per-layer activation reaches device memory. Each layer is one product of
// the k-major activation tile with a weight streamed through the cp.async
// ring, so every weight element is read from L2 once per 64 rows and each
// thread's 8 x 8 register tile does 64 FMAs per four shared loads. The
// head, g and their weights (zero-padded to 64 columns by the wrapper) go
// through the same ring with a 4 x 4 tile a thread. Sums run in k order
// from the bias, in f32; no tensor cores.
//
// Shared memory a block (one block an SM, 8 warps):
//   activation tile [256][68] f32   69,632 B
//   input tile      [64][68] f32    17,408 B
//   weight ring     3 x 16 x 256    49,152 B
//   relu bits       depth x 2 KB    16,384 B at depth 8, 32,768 at 16
//   total                          152,576 B at depth 8, 168,960 at 16
// of the 232,448 B a block may use.
#include <cuda_runtime.h>
#include <stdint.h>

#include "trunk_tile.cuh"

namespace {

constexpr int MAXD = 16;       // deepest trunk supported

struct TrunkParams {
  const float* wf_h[MAXD];  // forward weight read by h ([D,256] at layer 0)
  const float* wf_x[MAXD];  // forward weight read by feat at skip layers
  const float* wr_h[MAXD];  // reverse weight to h, [256 out, 256 in]
  const float* wr_x[MAXD];  // reverse weight to feat, [256 out, NW]
  const float* b[MAXD];
  const float* head_w;      // [256, NW]: the head's hc columns, zero-padded
  const float* head_b;      // [hc]
  const float* bn_w;        // [256, 256] or null
  const float* bn_b;        // [256] or null
};

__host__ __device__ constexpr int fwd_smem_bytes(int depth) {
  return (TILE_FLOATS + XTILE_FLOATS + RING_FLOATS) * 4 + depth * MASK_BYTES;
}

__global__ void __launch_bounds__(NT, 1) fused_trunk_fwd_kernel(
    const float* __restrict__ feat, int n, int d, int depth,
    unsigned skip_bits, int hc, int norm_dim, int has_bn,
    const __grid_constant__ TrunkParams p, float* __restrict__ sigma_out,
    float* __restrict__ norm_out, float* __restrict__ trunk_out,
    float* __restrict__ bn_out, float* __restrict__ g_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* hbuf = reinterpret_cast<float*>(smem);  // [WIDTH][LDA]
  float* xbuf = hbuf + TILE_FLOATS;              // [DMAX][LDA]
  float* ring = xbuf + XTILE_FLOATS;             // [STAGES][CHUNK]
  uint64_t* masks = reinterpret_cast<uint64_t*>(ring + RING_FLOATS);  // [depth][NT]

  const int t = threadIdx.x;
  const int row0 = blockIdx.x * TM;
  load_narrow_tile(xbuf, feat, d, d, DMAX, row0, n);

  // Forward: h_i = relu(h_{i-1} W_i [+ feat Wx_i] + b_i); masks_i = h_i > 0.
  float acc[8][8];
  for (int i = 0; i < depth; ++i) {
    fill_columns(acc, p.b[i], 1);
    if (i == 0) {
      mm_wide(acc, xbuf, d, p.wf_h[0], ring);
    } else {
      mm_wide(acc, hbuf, WIDTH, p.wf_h[i], ring);
      if ((skip_bits >> i) & 1u) mm_wide(acc, xbuf, d, p.wf_x[i], ring);
    }
    masks[i * NT + t] = relu_bits(acc);
    put_tile(hbuf, acc);  // every read of h_{i-1} ended at mm_wide's barrier
  }
  store_rows(trunk_out, row0, n, acc);
  if (!has_bn) store_rows(bn_out, row0, n, acc);

  // Head: [sigma, normal] = h W_head + b_head.
  {
    const int r0 = (t >> 4) * 4, c0 = (t & 15) * 4;
    float hacc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float bj = c0 + j < hc ? __ldg(p.head_b + c0 + j) : 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i) hacc[i][j] = bj;
    }
    mm_narrow(hacc, hbuf, WIDTH, p.head_w, ring);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gr = row0 + r0 + i;
      if (gr >= n) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + j;
        if (col == 0) sigma_out[gr] = hacc[i][j];
        else if (col <= norm_dim)
          norm_out[static_cast<size_t>(gr) * norm_dim + col - 1] = hacc[i][j];
      }
    }
  }

  // Bottleneck.
  if (has_bn) {
    fill_columns(acc, p.bn_b, 1);
    mm_wide(acc, hbuf, WIDTH, p.bn_w, ring);
    store_rows(bn_out, row0, n, acc);
  }

  // Reverse sweep, seeded with the sigma column of the head:
  // c_i = r_i * mask_i; r_{i-1} = c_i Wh_i^T; g += c_i Wx_i^T at layer 0
  // and at the skip layers. The head and bottleneck have read h (barrier
  // at the end of each product).
  fill_columns(acc, p.head_w, NW);
  apply_bits(acc, masks[(depth - 1) * NT + t]);
  put_tile(hbuf, acc);
  float gacc[4][4] = {};
  for (int i = depth - 1; i >= 0; --i) {
    if (i == 0 || ((skip_bits >> i) & 1u))
      mm_narrow(gacc, hbuf, WIDTH, p.wr_x[i], ring);
    if (i > 0) {
      fill_tile(acc, 0.0f);
      mm_wide(acc, hbuf, WIDTH, p.wr_h[i], ring);
      apply_bits(acc, masks[(i - 1) * NT + t]);
      put_tile(hbuf, acc);
    }
  }
  store_narrow(g_out, row0, n, d, gacc);
}

}  // namespace

// ptrs: five per layer (wf_h, wf_x, wr_h, wr_x, bias; 0 where unused), then
// head_w, head_b, bn_w, bn_b. wr_x and head_w are zero-padded to NW = 64
// columns. Returns cudaGetLastError() of the launch.
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

  const int smem = fwd_smem_bytes(depth);
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
