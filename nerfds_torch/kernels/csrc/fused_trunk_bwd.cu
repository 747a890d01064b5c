// Hand-derived backward of the NeRF trunk with dsigma/dfeat for Hopper
// (sm_90a), f32 in and out.
//
// Replaces the TPU kernel nerfds_tpu/pallas/fused_trunk.py:_bwd_kernel
// (called by _pallas_backward). Given the forward's input feat [N,D] and the
// cotangents of its outputs (head [N,hcu] = [sigma_bar, normal_bar], T_bar
// and B_bar [N,256], G_bar [N,D]) it returns feat_bar [N,D] and the grad of
// every trunk, bottleneck and head kernel and bias, with the second-order
// terms of G_bar . g (see nerfds_torch/kernels/fused_trunk.py).
//
// Bound: operations. For the nerf_ds trunk (8 x 256, skip at 4, D = 52) the
// forward recompute, the tangent sweep tau, the first-order reverse sweep r
// and the two weight-grad contractions are each one trunk's worth of
// multiply-adds (about 485 k a row), the g-path sweep r_g about 459 k, the
// head and bottleneck about 133 k: about 6.0 MFLOP a row against about
// 2.7 KB of input and output a row.
//
// Design, in three launches on the caller's stream:
// 1. trunk_bwd_sweep_kernel: a block owns 32 rows, as in the forward kernel
//    (trunk_tile.cuh), and runs the recompute, tau, and r with r_g in
//    lockstep, as 32 x 256 tiles in shared memory (two tiles, reused from
//    sweep to sweep) with every layer's relu mask kept as bits: 93 KB for
//    depth 8, so two blocks fit on an SM. A tile cannot hold the TPU
//    kernel's [depth, tile, width] stores of h and tau for the weight
//    grads, and the weight grads sum over every row of N, across blocks. So
//    the sweep writes h_i, tau_i, c1_i = r_i * m_i and c_g,i = r_g,i * m_i
//    of every layer to device-memory scratch that the wrapper allocates:
//    4 * depth * N * 256 floats, 2.1 GB at depth 8 and N = 65,536, written
//    once and read back by step 2 (about 1.3 ms of HBM time at 3.35 TB/s,
//    against the 5.9 ms operations bound).
// 2. trunk_wgrad_kernel: every grad is a sum over rows of one or two outer
//    products, dW = A^T C + A2^T C2 (zin^T c1 + tin^T c_g for a trunk layer,
//    h_L^T [sigma_bar, n_bar] + tau_L^T e0 for the head, a column of ones
//    for a bias). A block owns a 128 x 128 tile of one grad and one fixed
//    slice of the rows, walks them in order and writes a partial sum.
// 3. trunk_wgrad_reduce_kernel adds the slices' partials in slice order.
// No atomics: two launches on the same inputs give the same bits. Plain FMA
// loops; wgmma, TMA and TF32 are later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "trunk_tile.cuh"

namespace {

constexpr int MAXD = 12;      // deepest trunk supported (shared memory)
constexpr int MAXDESC = 40;   // grads of the deepest trunk, all skips
constexpr int TK = 128;       // weight-grad tile rows (input channels)
constexpr int TJ = 128;       // weight-grad tile columns (output channels)
constexpr int RB = 8;         // rows staged per step of the reduction

struct BwdParams {
  const float* wf_h[MAXD];  // forward weight read by h ([D,256] at layer 0)
  const float* wf_x[MAXD];  // forward weight read by feat at skip layers
  const float* wr_h[MAXD];  // reverse weight to h, [256 out, 256 in]
  const float* wr_x[MAXD];  // reverse weight to feat, [256 out, D]
  const float* b[MAXD];
  const float* head_w;      // [256, hc]: column 0 is w_sigma
  const float* wa_t;        // [hcu, 256]: the used head columns, transposed
  const float* wb_t;        // [256, 256]: the bottleneck, transposed, or null
};

// Stores a thread's 4 x 8 register tile to rows row0 + r0 .. of a [N, 256]
// matrix, skipping rows past n.
__device__ __forceinline__ void store_tile(float* __restrict__ dst, int row0,
                                           int n, const float (&v)[4][8]) {
  const int c0 = (threadIdx.x & 31) * 8, r0 = (threadIdx.x >> 5) * 4;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int gr = row0 + r0 + r;
    if (gr < n) {
      float4* out = reinterpret_cast<float4*>(
          dst + static_cast<size_t>(gr) * WIDTH + c0);
      out[0] = make_float4(v[r][0], v[r][1], v[r][2], v[r][3]);
      out[1] = make_float4(v[r][4], v[r][5], v[r][6], v[r][7]);
    }
  }
}

__device__ __forceinline__ void put_tile(float* __restrict__ buf,
                                         const float (&v)[4][8]) {
  const int c0 = (threadIdx.x & 31) * 8, r0 = (threadIdx.x >> 5) * 4;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) buf[(r0 + r) * LDH + c0 + j] = v[r][j];
}

__device__ __forceinline__ void zero_tile(float (&v)[4][8]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) v[r][j] = 0.0f;
}

// Relu masks are kept as bits: byte (row, lane) of a layer's [TM][32] mask
// holds the 8 columns lane * 8 .. lane * 8 + 7 of that row.
__device__ __forceinline__ uint8_t mask_bits(float (&v)[4][8], int r) {
  unsigned bits = 0u;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const bool on = v[r][j] > 0.0f;
    bits |= static_cast<unsigned>(on) << j;
    v[r][j] = on ? v[r][j] : 0.0f;
  }
  return static_cast<uint8_t>(bits);
}

// v *= mask, for the thread's 4 x 8 tile of a layer's bit mask.
__device__ __forceinline__ void apply_mask(float (&v)[4][8],
                                           const uint8_t* __restrict__ m) {
  const int lane = threadIdx.x & 31, r0 = (threadIdx.x >> 5) * 4;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const unsigned bits = m[(r0 + r) * 32 + lane];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (!((bits >> j) & 1u)) v[r][j] = 0.0f;
  }
}

__device__ __forceinline__ void get_tile(float (&v)[4][8],
                                         const float* __restrict__ buf) {
  const int c0 = (threadIdx.x & 31) * 8, r0 = (threadIdx.x >> 5) * 4;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) v[r][j] = buf[(r0 + r) * LDH + c0 + j];
}

// Two blocks an SM: two activation tiles and bit masks keep shared memory
// at 93 KB for depth 8, and one accumulator tile keeps registers at 128.
__global__ void __launch_bounds__(NT, 2) trunk_bwd_sweep_kernel(
    const float* __restrict__ feat, const float* __restrict__ head_cot,
    const float* __restrict__ tbar, const float* __restrict__ bbar,
    const float* __restrict__ gbar, int n, int d, int depth,
    unsigned skip_bits, int hc, int hcu, int has_bn,
    const __grid_constant__ BwdParams p,
    float* __restrict__ xbar, float* __restrict__ h_s,
    float* __restrict__ tau_s, float* __restrict__ c1_s,
    float* __restrict__ cg_s) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* buf0 = reinterpret_cast<float*>(smem);  // h, B_bar, tau, r_g
  float* buf1 = buf0 + TM * LDH;                 // r             [TM][LDH]
  float* xbuf = buf1 + TM * LDH;                 // feat          [TM][LDX]
  float* gbuf = xbuf + TM * LDX;                 // G_bar         [TM][LDX]
  float* hcbuf = gbuf + TM * LDX;                // head cot.     [TM][HCMAX]
  uint8_t* masks = reinterpret_cast<uint8_t*>(hcbuf + TM * HCMAX);

  const int t = threadIdx.x;
  const int row0 = blockIdx.x * TM;
  const int c0 = (t & 31) * 8, r0 = (t >> 5) * 4, lane = t & 31;
  const size_t layer = static_cast<size_t>(n) * WIDTH;
  for (int i = t; i < TM * d; i += NT) {
    const int r = i / d, c = i - r * d;
    const int gr = row0 + r;
    const size_t at = static_cast<size_t>(gr) * d + c;
    xbuf[r * LDX + c] = gr < n ? feat[at] : 0.0f;
    gbuf[r * LDX + c] = gr < n ? gbar[at] : 0.0f;
  }
  for (int i = t; i < TM * HCMAX; i += NT) {
    const int r = i / HCMAX, c = i - r * HCMAX;
    const int gr = row0 + r;
    hcbuf[i] = (gr < n && c < hcu) ? head_cot[static_cast<size_t>(gr) * hcu + c]
                                   : 0.0f;
  }
  __syncthreads();

  float acc[4][8];
  // 1. Forward recompute: h_i = relu(h_{i-1} W_i [+ feat Wx_i] + b_i).
  for (int i = 0; i < depth; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[r][j] = __ldg(p.b[i] + c0 + j);
    if (i == 0) {
      mm_wide(acc, xbuf, LDX, d, p.wf_h[0]);
    } else {
      mm_wide(acc, buf0, LDH, WIDTH, p.wf_h[i]);
      if ((skip_bits >> i) & 1u) mm_wide(acc, xbuf, LDX, d, p.wf_x[i]);
    }
    __syncthreads();  // every read of h_{i-1} is done
    uint8_t* m = masks + static_cast<size_t>(i) * TM * 32;
#pragma unroll
    for (int r = 0; r < 4; ++r) m[(r0 + r) * 32 + lane] = mask_bits(acc, r);
    put_tile(buf0, acc);
    store_tile(h_s + i * layer, row0, n, acc);
    __syncthreads();
  }

  // 2. Seed of the first-order sweep:
  //    r = T_bar + [sigma_bar, n_bar] W_head^T (+ B_bar W_bn^T).
  if (has_bn) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int gr = row0 + r0 + r;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        buf0[(r0 + r) * LDH + c0 + j] =
            gr < n ? bbar[static_cast<size_t>(gr) * WIDTH + c0 + j] : 0.0f;
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int gr = row0 + r0 + r;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      acc[r][j] = gr < n ? tbar[static_cast<size_t>(gr) * WIDTH + c0 + j] : 0.0f;
  }
  __syncthreads();
  mm_wide(acc, hcbuf, HCMAX, hcu, p.wa_t);
  if (has_bn) mm_wide(acc, buf0, LDH, WIDTH, p.wb_t);
  put_tile(buf1, acc);
  __syncthreads();  // B_bar in buf0 is read

  // 3. Tangent sweep seeded with G_bar at every input injection:
  //    tau_i = (tau_{i-1} W_i [+ G_bar Wx_i]) * m_i, tau_0 = (G_bar W_0) * m_0.
  for (int i = 0; i < depth; ++i) {
    zero_tile(acc);
    if (i == 0) {
      mm_wide(acc, gbuf, LDX, d, p.wf_h[0]);
    } else {
      mm_wide(acc, buf0, LDH, WIDTH, p.wf_h[i]);
      if ((skip_bits >> i) & 1u) mm_wide(acc, gbuf, LDX, d, p.wf_x[i]);
    }
    __syncthreads();  // every read of tau_{i-1} is done
    apply_mask(acc, masks + static_cast<size_t>(i) * TM * 32);
    put_tile(buf0, acc);
    store_tile(tau_s + i * layer, row0, n, acc);
    __syncthreads();
  }

  // 4. Reverse sweeps in lockstep: c1_i = r_i * m_i and c_g,i = r_g,i * m_i,
  //    with r_g seeded by w_sigma; feat_bar += c1_i Wx_i^T at layer 0 and the
  //    skips; r_{i-1} = c1_i Wh_i^T, r_g,i-1 = c_g,i Wh_i^T. r lives in buf1,
  //    r_g in buf0.
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      buf0[(r0 + r) * LDH + c0 + j] =
          __ldg(p.head_w + static_cast<size_t>(c0 + j) * hc);
  float xacc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int i = depth - 1; i >= 0; --i) {
    // Each thread masks its own elements in place.
    const uint8_t* m = masks + static_cast<size_t>(i) * TM * 32;
    get_tile(acc, buf1);
    apply_mask(acc, m);
    store_tile(c1_s + i * layer, row0, n, acc);
    put_tile(buf1, acc);
    get_tile(acc, buf0);
    apply_mask(acc, m);
    store_tile(cg_s + i * layer, row0, n, acc);
    put_tile(buf0, acc);
    __syncthreads();
    if (i == 0 || ((skip_bits >> i) & 1u))
      mm_narrow(xacc, buf1, LDH, WIDTH, p.wr_x[i], d);
    if (i > 0) {
      zero_tile(acc);
      mm_wide(acc, buf1, LDH, WIDTH, p.wr_h[i]);
      __syncthreads();  // every read of c1_i is done
      put_tile(buf1, acc);
      zero_tile(acc);
      mm_wide(acc, buf0, LDH, WIDTH, p.wr_h[i]);
      __syncthreads();  // every read of c_g,i is done
      put_tile(buf0, acc);
      __syncthreads();
    }
  }
  {
    const int xc0 = (t & 7) * 8, xrow = row0 + (t >> 3);
    if (xrow < n) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (xc0 + j < d) xbar[static_cast<size_t>(xrow) * d + xc0 + j] = xacc[j];
    }
  }
}

// Kernel parameters are __grid_constant__: indexed by a loop variable, they
// are read in place rather than copied to each thread's stack.

// One grad: out[k, j] (row stride ldo) = sum over rows of
// A[row, k] C[row, j] + A2[row, k] C2[row, j], k < k_dim, j < nc.
// A null means a column of ones (k_dim 1); A2 null means no second product.
struct WgDesc {
  const float* a;
  const float* a2;
  const float* c;
  const float* c2;
  float* out;
  int lda, ldc, k_dim, nc, ldo;
  int tile_begin;       // first block (grid x) of this grad
  int j_tiles;          // tiles along j
  long long part_off;   // offset of this grad's partials within a split
};

struct WgParams {
  WgDesc desc[MAXDESC];
  int ndesc;
  int n;
  int rows_per_split;
  long long per_split;  // partial-sum floats of one split
  float* partials;      // [splits][per_split]
};

// A block owns a 128 x 128 output tile; thread (ty, tx) keeps the 8 x 8
// outputs at k rows ty*4 + {0..3, 64..67} and j columns tx*4 + {0..3,
// 64..67} in registers, so each row staged in shared memory feeds 64 FMAs
// per product from four 16-byte loads.
__global__ void __launch_bounds__(256) trunk_wgrad_kernel(
    const __grid_constant__ WgParams p) {
  __shared__ __align__(16) float as[RB][TK];
  __shared__ __align__(16) float a2s[RB][TK];
  __shared__ __align__(16) float cs[RB][TJ];
  __shared__ __align__(16) float c2s[RB][TJ];
  int di = 0;
  while (di + 1 < p.ndesc && p.desc[di + 1].tile_begin <= static_cast<int>(blockIdx.x)) ++di;
  const WgDesc& D = p.desc[di];
  const int local = blockIdx.x - D.tile_begin;
  const int k0 = (local / D.j_tiles) * TK, j0 = (local % D.j_tiles) * TJ;
  const int split = blockIdx.y;
  const int rbeg = split * p.rows_per_split;
  const int rend = min(p.n, rbeg + p.rows_per_split);
  const int t = threadIdx.x, ty = t >> 4, tx = t & 15;
  const bool two = D.a2 != nullptr;
  float acc[8][8] = {};
  for (int rb = rbeg; rb < rend; rb += RB) {
    for (int e = t; e < RB * TK; e += 256) {
      const int r = e / TK, kk = e - r * TK;
      const int row = rb + r;
      const bool in_rows = row < rend;
      const int kc = k0 + kk, jc = j0 + kk;
      const bool ok_a = in_rows && kc < D.k_dim;
      const bool ok_c = in_rows && jc < D.nc;
      const size_t arow = static_cast<size_t>(row) * D.lda + kc;
      const size_t crow = static_cast<size_t>(row) * D.ldc + jc;
      as[r][kk] = ok_a ? (D.a ? D.a[arow] : 1.0f) : 0.0f;
      cs[r][kk] = ok_c ? D.c[crow] : 0.0f;
      if (two) {
        a2s[r][kk] = ok_a ? D.a2[arow] : 0.0f;
        c2s[r][kk] = ok_c ? D.c2[crow] : 0.0f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[r][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[r][64 + ty * 4]);
      const float4 c0 = *reinterpret_cast<const float4*>(&cs[r][tx * 4]);
      const float4 c1 = *reinterpret_cast<const float4*>(&cs[r][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float cv[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], cv[j], acc[i][j]);
      if (two) {
        const float4 b0 = *reinterpret_cast<const float4*>(&a2s[r][ty * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&a2s[r][64 + ty * 4]);
        const float4 e0 = *reinterpret_cast<const float4*>(&c2s[r][tx * 4]);
        const float4 e1 = *reinterpret_cast<const float4*>(&c2s[r][64 + tx * 4]);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
        const float ev[8] = {e0.x, e0.y, e0.z, e0.w, e1.x, e1.y, e1.z, e1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(bv[i], ev[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
  float* part = p.partials + static_cast<size_t>(split) * p.per_split + D.part_off;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = k0 + (i < 4 ? ty * 4 + i : 60 + ty * 4 + i);
    if (k >= D.k_dim) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int jj = j0 + (j < 4 ? tx * 4 + j : 60 + tx * 4 + j);
      if (jj < D.nc) part[static_cast<size_t>(k) * D.nc + jj] = acc[i][j];
    }
  }
}

// out = sum of the splits' partials, in split order.
__global__ void trunk_wgrad_reduce_kernel(const __grid_constant__ WgParams p,
                                          int splits) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= p.per_split) return;
  int di = 0;
  while (di + 1 < p.ndesc && p.desc[di + 1].part_off <= e) ++di;
  const WgDesc& D = p.desc[di];
  const long long local = e - D.part_off;
  const int k = static_cast<int>(local / D.nc), j = static_cast<int>(local % D.nc);
  float s = 0.0f;
  for (int sp = 0; sp < splits; ++sp)
    s += p.partials[static_cast<size_t>(sp) * p.per_split + e];
  D.out[static_cast<size_t>(k) * D.ldo + j] = s;
}

}  // namespace

// wptrs: five per layer (wf_h, wf_x, wr_h, wr_x, bias; 0 where unused), then
// head_w, wa_t, wb_t (0 without a bottleneck). gptrs: (kernel grad, bias
// grad) per layer, then the bottleneck's (0, 0 without one), then the head's.
// e0 [N, hcu] is 1 in column 0 and 0 elsewhere. scratch holds
// 4 * depth * N * 256 floats, partials splits * per_split floats.
// Returns cudaGetLastError() of the launches.
extern "C" int fused_trunk_bwd(const float* feat, const float* head_cot,
                               const float* tbar, const float* bbar,
                               const float* gbar, const uint64_t* wptrs,
                               const uint64_t* gptrs, const float* e0, int n,
                               int d, int depth, unsigned skip_bits, int hc,
                               int hcu, int has_bn, int splits, long per_split,
                               float* xbar, float* scratch, float* partials,
                               void* stream) {
  if (depth < 1 || depth > MAXD || d < 1 || d > DMAX || hc < 1 ||
      hc > HCMAX || hcu < 1 || hcu > hc || n < 1 || splits < 1 ||
      (skip_bits & 1u) || (has_bn && bbar == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdParams bp = {};
  for (int i = 0; i < depth; ++i) {
    bp.wf_h[i] = reinterpret_cast<const float*>(wptrs[5 * i]);
    bp.wf_x[i] = reinterpret_cast<const float*>(wptrs[5 * i + 1]);
    bp.wr_h[i] = reinterpret_cast<const float*>(wptrs[5 * i + 2]);
    bp.wr_x[i] = reinterpret_cast<const float*>(wptrs[5 * i + 3]);
    bp.b[i] = reinterpret_cast<const float*>(wptrs[5 * i + 4]);
  }
  bp.head_w = reinterpret_cast<const float*>(wptrs[5 * depth]);
  bp.wa_t = reinterpret_cast<const float*>(wptrs[5 * depth + 1]);
  bp.wb_t = reinterpret_cast<const float*>(wptrs[5 * depth + 2]);

  const size_t layer = static_cast<size_t>(n) * WIDTH;
  float* h_s = scratch;
  float* tau_s = h_s + depth * layer;
  float* c1_s = tau_s + depth * layer;
  float* cg_s = c1_s + depth * layer;

  // The grads, in the order of their partials.
  WgParams wp = {};
  int tiles = 0;
  long long off = 0;
  auto add = [&](const float* a, const float* a2, const float* c,
                 const float* c2, int lda, int ldc, int k_dim, int nc,
                 float* out, int ldo) {
    WgDesc& D = wp.desc[wp.ndesc++];
    D.a = a; D.a2 = a2; D.c = c; D.c2 = c2; D.out = out;
    D.lda = lda; D.ldc = ldc; D.k_dim = k_dim; D.nc = nc; D.ldo = ldo;
    D.tile_begin = tiles;
    D.j_tiles = (nc + TJ - 1) / TJ;
    D.part_off = off;
    tiles += ((k_dim + TK - 1) / TK) * D.j_tiles;
    off += static_cast<long long>(k_dim) * nc;
  };
  for (int i = 0; i < depth; ++i) {
    float* dw = reinterpret_cast<float*>(gptrs[2 * i]);
    float* db = reinterpret_cast<float*>(gptrs[2 * i + 1]);
    const float* c1 = c1_s + i * layer;
    const float* cg = cg_s + i * layer;
    if (i == 0) {
      add(feat, gbar, c1, cg, d, WIDTH, d, WIDTH, dw, WIDTH);
    } else {
      add(h_s + (i - 1) * layer, tau_s + (i - 1) * layer, c1, cg, WIDTH,
          WIDTH, WIDTH, WIDTH, dw, WIDTH);
      if ((skip_bits >> i) & 1u)
        add(feat, gbar, c1, cg, d, WIDTH, d, WIDTH, dw + WIDTH * WIDTH, WIDTH);
    }
    add(nullptr, nullptr, c1, nullptr, 1, WIDTH, 1, WIDTH, db, WIDTH);
  }
  const float* h_last = h_s + (depth - 1) * layer;
  if (has_bn) {
    float* dw = reinterpret_cast<float*>(gptrs[2 * depth]);
    float* db = reinterpret_cast<float*>(gptrs[2 * depth + 1]);
    add(h_last, nullptr, bbar, nullptr, WIDTH, WIDTH, WIDTH, WIDTH, dw, WIDTH);
    add(nullptr, nullptr, bbar, nullptr, 1, WIDTH, 1, WIDTH, db, WIDTH);
  }
  {
    float* dw = reinterpret_cast<float*>(gptrs[2 * depth + 2]);
    float* db = reinterpret_cast<float*>(gptrs[2 * depth + 3]);
    add(h_last, tau_s + (depth - 1) * layer, head_cot, e0, WIDTH, hcu, WIDTH,
        hcu, dw, hc);
    add(nullptr, nullptr, head_cot, nullptr, 1, hcu, 1, hcu, db, hcu);
  }
  if (off != per_split) return static_cast<int>(cudaErrorInvalidValue);
  wp.n = n;
  wp.rows_per_split = (n + splits - 1) / splits;
  wp.per_split = off;
  wp.partials = partials;

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem = 2 * TM * LDH * 4 + 2 * TM * LDX * 4 + TM * HCMAX * 4 +
                   depth * TM * 32;
  cudaError_t err = cudaFuncSetAttribute(
      trunk_bwd_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  trunk_bwd_sweep_kernel<<<(n + TM - 1) / TM, NT, smem, st>>>(
      feat, head_cot, tbar, bbar, gbar, n, d, depth, skip_bits, hc, hcu,
      has_bn, bp, xbar, h_s, tau_s, c1_s, cg_s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  trunk_wgrad_kernel<<<dim3(tiles, splits), 256, 0, st>>>(wp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  trunk_wgrad_reduce_kernel<<<static_cast<unsigned>((off + 255) / 256), 256, 0,
                              st>>>(wp, splits);
  return static_cast<int>(cudaGetLastError());
}
