// NeRF trunk forward with dsigma/dfeat for Hopper (sm_90a) in the
// bf16-operand mode (the TPU kernel's compute_dtype = bf16), on the tensor
// cores: f32 in and out, bf16 operands, f32 sums.
//
// Replaces the TPU kernel nerfds_tpu/pallas/fused_trunk.py:_fwd_kernel
// (called by _pallas_forward) with compute_dtype = bf16; computes what
// fused_trunk_fwd.cu computes: the relu trunk (depth x 256, input re-fed at
// the skip layers), the sigma + normal head, the bottleneck, and g =
// dsigma/dfeat by a reverse sweep over the stored relu masks seeded with
// the sigma column of the head. Outputs: sigma [N,1], normal [N,norm_dim],
// trunk_out [N,256], bottleneck [N,256], g [N,D].
//
// Rounding points, those of the TPU kernel: the weights arrive in bf16
// (biases f32); feat, each layer's relu output h and each reverse-sweep
// cotangent c are rounded to bf16 where they are written to a tile. The
// masks test the f32 pre-activation, trunk_out is the last layer's
// unrounded f32 h, and every product sums in f32 on the tensor cores
// (mma.sync m16n8k16): the result is the TPU kernel's up to the order of
// its f32 sums. A sum that a mask or a rounding decides and that lies near
// its decision is summed again in k order (trunk_mma.cuh's resum), so that
// h, c and the masks fall as the plain version's f32 sums make them fall.
//
// Bound: operations on the tensor cores. The nerf_ds trunk (8 x 256, skip
// at 4, D = 52) does about 1.04 M multiply-adds per row against about
// 2.3 KB of input and output: 0.137 ms at 989 TFLOP/s for N = 65,536.
//
// Design (trunk_mma.cuh): a block owns 64 rows and keeps their input, the
// current activation and the relu bits of every layer in shared memory; no
// per-layer activation reaches device memory. Each layer is one product of
// the swizzled activation tile with a weight (W^T: wr_h, wr_x, the head's
// and the bottleneck's transposes) streamed through the cp.async ring; the
// reverse sweep reads the forward weights (wf_h, wf_x) as its W^T. Every
// weight element is read from L2 once per 64 rows.
//
// Shared memory a block (one block an SM, 8 warps):
//   activation tile [64][256] bf16   32,768 B
//   input tile      [64][64] bf16     8,192 B
//   weight ring     3 x 32 KB        98,304 B
//   relu bits       depth x 2 KB     16,384 B at depth 8, 32,768 at 16
//   row maxima of the two tiles       2,048 B
//   the warps' resum lists            4,096 B
//   total                           161,792 B at depth 8, 178,176 at 16
// of the 232,448 B a block may use.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "trunk_mma.cuh"

namespace {

constexpr int MAXD = 16;  // deepest trunk supported

struct TrunkParamsBf16 {
  const bf16* wf_h[MAXD];  // [in][out] ([D][256] at layer 0): reverse W^T
  const bf16* wf_x[MAXD];  // [D][256] at the skip layers: reverse W^T to g
  const bf16* wr_h[MAXD];  // [out][in] = wf_h^T, layers > 0: forward W^T
  const bf16* wr_x[MAXD];  // [256][NW]: feat's weight^T, layer 0 and skips
  const float* b[MAXD];
  const bf16* head_wt;     // [HCMAX][256]: the head^T, zero rows past hc
  const float* head_b;     // [hc]
  const bf16* bn_wt;       // [256][256]: the bottleneck^T, or null
  const float* bn_b;       // [256] or null
};

__host__ __device__ constexpr int fwd_bf16_smem_bytes(int depth) {
  return (TILE + XTILE + STAGES * STAGE) * 2 + depth * MASK_BYTES +
         2 * RM * 4 + SEQ_LIST_BYTES;
}

__global__ void __launch_bounds__(NT, 1) fused_trunk_fwd_bf16_kernel(
    const float* __restrict__ feat, int n, int d, int depth,
    unsigned skip_bits, int hc, int norm_dim, int has_bn,
    const __grid_constant__ TrunkParamsBf16 p, const float* __restrict__ l1,
    float* __restrict__ sigma_out,
    float* __restrict__ norm_out, float* __restrict__ trunk_out,
    float* __restrict__ bn_out, float* __restrict__ g_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* hbuf = reinterpret_cast<bf16*>(smem);  // [TM][WIDTH]
  bf16* xbuf = hbuf + TILE;                    // [TM][DMAX]
  bf16* ring = xbuf + XTILE;                   // [STAGES][STAGE]
  uint64_t* masks = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE);
  float* rmh = reinterpret_cast<float*>(masks + depth * NT);  // resum's
  float* rmx = rmh + RM;                                        // row maxima
  unsigned char* list = reinterpret_cast<unsigned char*>(rmx + RM);

  const int t = threadIdx.x;
  const int row0 = blockIdx.x * TM;
  load_narrow_tile(xbuf, feat, d, d, row0, n, rmx);

  // Forward: h_i = relu(h_{i-1} W_i [+ feat Wx_i] + b_i); masks_i = a_i > 0.
  float acc[2][8][4];
  for (int i = 0; i < depth; ++i) {
    const SeqTerm tx = {xbuf, rmx, DMAX, p.wr_x[i], NW,
                        l1 + (3 * i + 1) * WIDTH};
    fill_bias(acc, p.b[i]);
    if (i == 0) {
      mm_wide(acc, xbuf, DMAX, d, p.wr_x[0], NW, ring);
      resum<true>(acc, row0, n, tx, SeqTerm{}, 0ull, nullptr, p.b[i], list,
                  ring);
    } else {
      const bool skip = (skip_bits >> i) & 1u;
      const SeqTerm th = {hbuf, rmh, WIDTH, p.wr_h[i], WIDTH,
                          l1 + 3 * i * WIDTH};
      mm_wide(acc, hbuf, WIDTH, WIDTH, p.wr_h[i], WIDTH, ring);
      if (skip) mm_wide(acc, xbuf, DMAX, d, p.wr_x[i], NW, ring);
      resum<true>(acc, row0, n, th, skip ? tx : SeqTerm{}, 0ull, nullptr,
                  p.b[i], list, ring);  // ends with a barrier: h_{i-1} is free
    }
    masks[i * NT + t] = relu_bits<false>(acc);
    put_tile(hbuf, acc, rmh);
  }
  store_rows(trunk_out, row0, n, acc);
  if (!has_bn) store_rows(bn_out, row0, n, acc);

  // Head: [sigma, normal] = h W_head + b_head.
  {
    float hacc[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = narrow_col(nt) + (q & 1);
        hacc[nt][q] = c < hc ? __ldg(p.head_b + c) : 0.0f;
      }
    mm_narrow(hacc, hbuf, p.head_wt, HCMAX, ring);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int gr = row0 + narrow_row(q);
      if (gr >= n) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = narrow_col(nt) + (q & 1);
        if (col == 0) sigma_out[gr] = hacc[nt][q];
        else if (col <= norm_dim)
          norm_out[static_cast<size_t>(gr) * norm_dim + col - 1] = hacc[nt][q];
      }
    }
  }

  // Bottleneck.
  if (has_bn) {
    fill_bias(acc, p.bn_b);
    mm_wide(acc, hbuf, WIDTH, WIDTH, p.bn_wt, WIDTH, ring);
    store_rows(bn_out, row0, n, acc);
  }

  // Reverse sweep, seeded with the sigma column of the head:
  // c_i = r_i * mask_i; r_{i-1} = c_i Wh_i^T; g += c_i Wx_i^T at layer 0
  // and at the skip layers. The head and bottleneck have read h (barrier
  // at the end of each product).
  fill_columns(acc, p.head_wt, 1);
  apply_bits(acc, masks[(depth - 1) * NT + t]);
  put_tile(hbuf, acc, rmh);
  bool first = true;  // g's first share is stored, later ones added
  for (int i = depth - 1; i >= 0; --i) {
    if (i == 0 || ((skip_bits >> i) & 1u)) {
      float gacc[4][4] = {};
      mm_narrow(gacc, hbuf, i == 0 ? p.wf_h[0] : p.wf_x[i], d, ring);
      store_narrow(g_out, row0, n, d, gacc, !first);
      first = false;
    }
    if (i > 0) {
      const uint64_t on = masks[(i - 1) * NT + t];
      const SeqTerm tc = {hbuf, rmh, WIDTH, p.wf_h[i], WIDTH,
                          l1 + (3 * i + 2) * WIDTH};
      fill(acc, 0.0f);
      mm_wide(acc, hbuf, WIDTH, WIDTH, p.wf_h[i], WIDTH, ring);
      resum<false>(acc, row0, n, tc, SeqTerm{}, on, nullptr, nullptr, list,
                   ring);  // ends with a barrier: c_i is free
      apply_bits(acc, on);
      put_tile(hbuf, acc, rmh);
    }
  }
}

}  // namespace

// ptrs: five per layer (wf_h, wf_x, wr_h, wr_x, bias; 0 where unused; wr_x
// zero-padded to NW = 64 columns), then head_wt, head_b, bn_wt, bn_b. Every
// weight is bf16, every bias f32. l1: 3 * depth * 256 floats, resum's
// weight norms, written here. Returns cudaGetLastError() of the launches.
extern "C" int fused_trunk_fwd_bf16(const float* feat, const uint64_t* ptrs,
                                    int n, int d, int depth,
                                    unsigned skip_bits, int hc, int norm_dim,
                                    int has_bn, float* sigma, float* norm,
                                    float* trunk, float* bneck, float* g,
                                    float* l1, void* stream) {
  if (depth < 1 || depth > MAXD || d < 1 || d > DMAX || hc < 1 ||
      hc > HCMAX || norm_dim < 0 || norm_dim >= hc || n < 1 || l1 == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  TrunkParamsBf16 p = {};
  for (int i = 0; i < depth; ++i) {
    p.wf_h[i] = reinterpret_cast<const bf16*>(ptrs[5 * i]);
    p.wf_x[i] = reinterpret_cast<const bf16*>(ptrs[5 * i + 1]);
    p.wr_h[i] = reinterpret_cast<const bf16*>(ptrs[5 * i + 2]);
    p.wr_x[i] = reinterpret_cast<const bf16*>(ptrs[5 * i + 3]);
    p.b[i] = reinterpret_cast<const float*>(ptrs[5 * i + 4]);
  }
  p.head_wt = reinterpret_cast<const bf16*>(ptrs[5 * depth]);
  p.head_b = reinterpret_cast<const float*>(ptrs[5 * depth + 1]);
  p.bn_wt = reinterpret_cast<const bf16*>(ptrs[5 * depth + 2]);
  p.bn_b = reinterpret_cast<const float*>(ptrs[5 * depth + 3]);

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  trunk_l1_kernel<<<3 * depth, WIDTH, 0, st>>>(
      l1_layers(depth, p.wr_h, p.wr_x, p.wf_h), l1);
  const int smem = fwd_bf16_smem_bytes(depth);
  cudaError_t err = cudaFuncSetAttribute(
      fused_trunk_fwd_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n + TM - 1) / TM;
  fused_trunk_fwd_bf16_kernel<<<blocks, NT, smem, st>>>(
      feat, n, d, depth, skip_bits, hc, norm_dim, has_bn, p, l1, sigma, norm,
      trunk, bneck, g);
  return static_cast<int>(cudaGetLastError());
}

#ifdef TRUNK_SEQ_STATS
// resum's counters since the last call (a build with -DTRUNK_SEQ_STATS).
extern "C" int trunk_fwd_bf16_seq_stats(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, seq_stats, sizeof(seq_stats));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zero[4] = {};
  return static_cast<int>(cudaMemcpyToSymbol(seq_stats, zero, sizeof(zero)));
}
#endif
