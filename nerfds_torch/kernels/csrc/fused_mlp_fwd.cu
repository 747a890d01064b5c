// Whole-MLP forward for Hopper (sm_90a): f32 in, f32 out, optional bf16
// rounding of the operands and activations.
//
// Replaces the TPU kernel nerfds_tpu/pallas/fused_mlp.py:fused_mlp_forward.
// One launch runs every Dense layer of a models.mlp.MLP stack over the rows
// of x: the hidden layers (input re-fed at the skip layers as [h, x]), their
// activation, and an optional output layer with its own activation. Only the
// last layer's columns reach device memory.
//
// Bound: operations. The nerf_ds trunk (8 x 256, skip at 4, 52 inputs) does
// about 0.49 M multiply-adds per row against about 1.2 KB of input and
// output per row: far above the f32 CUDA-core ridge.
// Design: a block owns a tile of 32 rows and keeps the tile's input (for the
// skip re-feed) and two ping-pong activation tiles in shared memory, sized
// per launch from the input width and the widest layer (74 KB for the
// trunk, so two blocks fit on an SM). The TPU kernel holds every weight in
// VMEM; about 2 MB of weights do not fit in an SM's 228 KB, so each layer's
// weights stream through L1/L2, one contiguous weight row per step of the
// contraction. Each thread keeps an RT x 8 register tile of the layer's
// 32-row output: RT = 4 for layers wider than 128 columns, 2 up to 128 and 1
// up to 64, so every layer width keeps all 256 threads busy; the bias and
// the activation run in the epilogue. Plain FMA loops; wgmma, TMA and bf16
// tensor-core operands are later work.
//
// bf16 compute (round_bf16 = 1) rounds where the TPU kernel's .astype puts
// a bf16: the input tile at load (the wrapper passes the weights and biases
// already rounded), each layer's sum after the f32 accumulation, the bias
// add, and the activation. Products are exact in f32 and summed in f32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 32;          // rows per block
constexpr int NT = 256;         // threads per block
constexpr int MAXL = 17;        // most layers: 16 hidden + the output layer
constexpr int WMAX = 256;       // widest layer output supported
constexpr int CIN_MAX = 1024;   // widest input supported

enum Act { kNone = 0, kRelu = 1, kSigmoid = 2, kSoftplus = 3, kTanh = 4 };

struct MlpParams {
  const float* w[MAXL];  // [rows, cols] row-major, as the model stores it
  const float* b[MAXL];  // [cols]
  int cols[MAXL];
  int skip[MAXL];        // 1: the layer reads [h, x] (h's rows first)
  int act[MAXL];
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case kRelu: return v > 0.0f ? v : 0.0f;
    case kSigmoid: return 1.0f / (1.0f + expf(-v));
    case kSoftplus: return v > 20.0f ? v : log1pf(expf(v));
    case kTanh: return tanhf(v);
    default: return v;
  }
}

// acc[RT][8] += A[r0:r0+RT, 0:K] @ B[0:K, c0:c0+8], B row-major with nc
// columns. Thread t: c0 = (t % (8 RT)) * 8, r0 = (t / (8 RT)) * RT, so the
// 256 threads cover 32 rows x 64 RT columns.
template <int RT>
__device__ __forceinline__ void mm(float (&acc)[RT][8],
                                   const float* __restrict__ a_tile, int lda,
                                   int k_dim, const float* __restrict__ b_mat,
                                   int nc, int c0) {
  const int r0 = (threadIdx.x / (8 * RT)) * RT;
  const float* a = a_tile + r0 * lda;
  const float* b = b_mat + c0;
  if ((nc & 3) == 0 && c0 + 8 <= nc) {
#pragma unroll 4
    for (int k = 0; k < k_dim; ++k) {
      const float4 b0 = __ldg(reinterpret_cast<const float4*>(
          b + static_cast<size_t>(k) * nc));
      const float4 b1 = __ldg(reinterpret_cast<const float4*>(
          b + static_cast<size_t>(k) * nc + 4));
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float av = a[r * lda + k];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[r][j] = fmaf(av, bv[j], acc[r][j]);
      }
    }
  } else {
    for (int k = 0; k < k_dim; ++k) {
      float bv[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        bv[j] = c0 + j < nc ? __ldg(b + static_cast<size_t>(k) * nc + j)
                            : 0.0f;
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float av = a[r * lda + k];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[r][j] = fmaf(av, bv[j], acc[r][j]);
      }
    }
  }
}

// One Dense layer of the tile: reads `cur` (k_cur columns) and, at a skip
// layer, the input tile; writes the activated output to `dst` (a shared
// tile) or, for the last layer, to the rows of `out` below n.
template <int RT>
__device__ __forceinline__ void layer(
    const MlpParams& p, int l, const float* cur, int lda, int k_cur,
    const float* xbuf, int ldx, int c_in, int rnd, float* dst, int ldh,
    float* __restrict__ out, int row0, int n, bool last) {
  const int nc = p.cols[l];
  const int c0 = (threadIdx.x % (8 * RT)) * 8;
  const int r0 = (threadIdx.x / (8 * RT)) * RT;
  if (c0 >= nc) return;
  float acc[RT][8];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[r][j] = 0.0f;
  mm<RT>(acc, cur, lda, k_cur, p.w[l], nc, c0);
  if (p.skip[l])
    mm<RT>(acc, xbuf, ldx, c_in, p.w[l] + static_cast<size_t>(k_cur) * nc,
           nc, c0);
  const int act = p.act[l];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (c0 + j >= nc) break;
    const float bias = __ldg(p.b[l] + c0 + j);
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      float v = acc[r][j];
      if (rnd) v = round_bf16(round_bf16(v) + bias);
      else v = v + bias;
      v = activate(v, act);
      if (rnd) v = round_bf16(v);
      if (last) {
        const int gr = row0 + r0 + r;
        if (gr < n) out[static_cast<size_t>(gr) * nc + c0 + j] = v;
      } else {
        dst[(r0 + r) * ldh + c0 + j] = v;
      }
    }
  }
}

__global__ void __launch_bounds__(NT, 2) fused_mlp_fwd_kernel(
    const float* __restrict__ x, int n, int c_in, int ldx, int ldh,
    int num_layers, int rnd, MlpParams p, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* xbuf = smem;                 // [TM][ldx]
  float* hbuf0 = xbuf + TM * ldx;     // [TM][ldh]
  float* hbuf1 = hbuf0 + TM * ldh;    // [TM][ldh]

  const int row0 = blockIdx.x * TM;
  for (int i = threadIdx.x; i < TM * c_in; i += NT) {
    const int r = i / c_in, c = i - r * c_in;
    const int gr = row0 + r;
    float v = gr < n ? x[static_cast<size_t>(gr) * c_in + c] : 0.0f;
    xbuf[r * ldx + c] = rnd ? round_bf16(v) : v;
  }
  __syncthreads();

  const float* cur = xbuf;
  int lda = ldx, k_cur = c_in;
  for (int l = 0; l < num_layers; ++l) {
    // Ping-pong: layer l writes the tile that layer l - 1 did not, so one
    // barrier a layer (after the writes) orders every read and write.
    float* dst = (l & 1) ? hbuf1 : hbuf0;
    const bool last = l == num_layers - 1;
    const int nc = p.cols[l];
    if (nc > 128)
      layer<4>(p, l, cur, lda, k_cur, xbuf, ldx, c_in, rnd, dst, ldh, out,
               row0, n, last);
    else if (nc > 64)
      layer<2>(p, l, cur, lda, k_cur, xbuf, ldx, c_in, rnd, dst, ldh, out,
               row0, n, last);
    else
      layer<1>(p, l, cur, lda, k_cur, xbuf, ldx, c_in, rnd, dst, ldh, out,
               row0, n, last);
    __syncthreads();
    cur = dst;
    lda = ldh;
    k_cur = nc;
  }
}

}  // namespace

// ptrs: (w, b) per layer; dims: (cols, skip, act) per layer. Returns
// cudaGetLastError() of the launch.
extern "C" int fused_mlp_fwd(const float* x, int n, int c_in,
                             const uint64_t* ptrs, const int* dims,
                             int num_layers, int round_bf16, float* out,
                             void* stream) {
  if (n < 1 || c_in < 1 || c_in > CIN_MAX || num_layers < 1 ||
      num_layers > MAXL)
    return static_cast<int>(cudaErrorInvalidValue);
  MlpParams p = {};
  int wmax = 0;
  for (int l = 0; l < num_layers; ++l) {
    p.w[l] = reinterpret_cast<const float*>(ptrs[2 * l]);
    p.b[l] = reinterpret_cast<const float*>(ptrs[2 * l + 1]);
    p.cols[l] = dims[3 * l];
    p.skip[l] = dims[3 * l + 1];
    p.act[l] = dims[3 * l + 2];
    if (p.cols[l] < 1 || p.cols[l] > WMAX)
      return static_cast<int>(cudaErrorInvalidValue);
    if (l < num_layers - 1 && p.cols[l] > wmax) wmax = p.cols[l];
  }
  // Padded rows (+4 floats) stagger the rows of a tile across banks.
  const int ldx = ((c_in + 3) / 4) * 4 + 4;
  const int ldh = ((wmax + 3) / 4) * 4 + 4;
  const int smem = 4 * TM * (ldx + 2 * ldh);
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n + TM - 1) / TM;
  fused_mlp_fwd_kernel<<<blocks, NT, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      x, n, c_in, ldx, ldh, num_layers, round_bf16, p, out);
  return static_cast<int>(cudaGetLastError());
}
