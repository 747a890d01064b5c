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
// 2.7 KB of input and output a row (5.9 ms at 67 TFLOP/s for N = 65,536).
//
// Design, in three launches on the caller's stream, all f32 FMA on the CUDA
// cores:
// 1. trunk_bwd_sweep_kernel: a block owns 64 rows and runs the recompute,
//    tau, the seed of r, then r with r_g in lockstep, layer by layer, every
//    product on the row-tile engine of trunk_tile.cuh. r and r_g each take
//    their own pass over a reverse weight: one pass feeding both (128
//    accumulators a thread) ran the sweep slower on the H100. Shared
//    memory a block (one block an SM):
//      two activation tiles [256][68] f32      139,264 B
//        (feat, G_bar and the head cotangent live in the second tile's
//        space until r takes it over)
//      weight ring 3 x 16 x 256 f32             49,152 B
//      relu bits depth x 2 KB                    16,384 B at depth 8,
//                                               24,576 B at depth 12
//      total                                   204,800 B at depth 8,
//                                              212,992 B at depth 12
//    of 232,448 B. The weight grads sum over every row of N, across
//    blocks, so the sweep writes h_i, tau_i, c1_i = r_i * m_i and
//    c_g,i = r_g,i * m_i of every layer to device-memory scratch:
//    4 * depth * N * 256 floats, 2.1 GB at depth 8 and N = 65,536, written
//    once and read back by step 2, about 1.3 ms of HBM time at 3.35 TB/s
//    against the 5.9 ms operations bound, partly hidden under the FMAs.
// 2. trunk_wgrad_kernel: every grad is a sum over rows of one or two outer
//    products, dW = A^T C + A2^T C2 (zin^T c1 + tin^T c_g for a trunk layer,
//    h_L^T [sigma_bar, n_bar] + tau_L^T e0 for the head). A block owns a
//    128 x 128 tile of one grad and one fixed slice of the rows, and walks
//    the slice in stages of 16 rows, double-buffered in a 3-stage cp.async
//    ring (16-byte copies, 96 KB, two blocks an SM); each thread keeps 8 x 8
//    outputs and does 64 FMAs a product per four 16-byte shared loads. The
//    blocks of k-tile 0 also sum the first product's C over their rows:
//    that is the bias grad (sum of c1, of B_bar, of the head cotangent).
// 3. trunk_wgrad_reduce_kernel adds the slices' partials in slice order.
// No atomics: two launches on the same inputs give the same bits.
//
// The bf16-operand mode runs on the tensor cores instead:
// fused_trunk_bwd_bf16.cu.
#include <cuda_runtime.h>
#include <stdint.h>

#include "trunk_tile.cuh"

namespace {

constexpr int MAXD = 12;      // deepest trunk supported (grad table size)
constexpr int MAXDESC = 28;   // grads of the deepest trunk, all skips
constexpr int TK = 128;       // weight-grad tile rows (input channels)
constexpr int TJ = 128;       // weight-grad tile columns (output channels)
constexpr int RB = 16;        // rows a stage of the weight-grad ring
constexpr int WSTAGES = 3;    // stages of the weight-grad ring

struct BwdParams {
  const float* wf_h[MAXD];  // forward weight read by h ([D,256] at layer 0)
  const float* wf_x[MAXD];  // forward weight read by feat at skip layers
  const float* wr_h[MAXD];  // reverse weight to h, [256 out, 256 in]
  const float* wr_x[MAXD];  // reverse weight to feat, [256 out, NW]
  const float* b[MAXD];
  const float* head_w;      // [256, hc]: column 0 is w_sigma
  const float* wa_t;        // [hcu, 256]: the used head columns, transposed
  const float* wb_t;        // [256, 256]: the bottleneck, transposed, or null
};

__host__ __device__ constexpr int sweep_smem_bytes(int depth) {
  return (2 * TILE_FLOATS + RING_FLOATS) * 4 + depth * MASK_BYTES;
}

// feat and G_bar have rows of ldx = D rounded up to 4 floats; the head
// cotangent rows of HCMAX floats (the wrapper pads them). h_s holds every
// layer's h; tau_s layers 0 .. depth - 2 of tau, tau_last the last.
__global__ void __launch_bounds__(NT, 1) trunk_bwd_sweep_kernel(
    const float* __restrict__ feat, const float* __restrict__ head_cot,
    const float* __restrict__ tbar, const float* __restrict__ bbar,
    const float* __restrict__ gbar, int n, int d, int ldx, int depth,
    unsigned skip_bits, int hc, int hcu, int has_bn,
    const __grid_constant__ BwdParams p,
    float* __restrict__ xbar, float* __restrict__ h_s,
    float* __restrict__ tau_s, float* __restrict__ tau_last,
    float* __restrict__ c1_s, float* __restrict__ cg_s) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* buf0 = reinterpret_cast<float*>(smem);  // h, tau, B_bar, c_g
  float* buf1 = buf0 + TILE_FLOATS;              // c1
  float* xbuf = buf1;                            // feat   [DMAX][LDA]
  float* gbuf = buf1 + XTILE_FLOATS;             // G_bar  [DMAX][LDA]
  float* hcbuf = gbuf + XTILE_FLOATS;            // head cotangent [KC][LDA]
  float* ring = buf1 + TILE_FLOATS;
  uint64_t* masks = reinterpret_cast<uint64_t*>(ring + RING_FLOATS);

  const int t = threadIdx.x;
  const int row0 = blockIdx.x * TM;
  const size_t layer = static_cast<size_t>(n) * WIDTH;
  load_narrow_tile(xbuf, feat, ldx, d, DMAX, row0, n);
  load_narrow_tile(gbuf, gbar, ldx, d, DMAX, row0, n);
  load_narrow_tile(hcbuf, head_cot, HCMAX, hcu, KC, row0, n);

  float acc[8][8];
  // 1. Forward recompute: h_i = relu(h_{i-1} W_i [+ feat Wx_i] + b_i).
  for (int i = 0; i < depth; ++i) {
    fill_columns(acc, p.b[i], 1);
    if (i == 0) {
      mm_wide(acc, xbuf, d, p.wf_h[0], ring);
    } else {
      mm_wide(acc, buf0, WIDTH, p.wf_h[i], ring);
      if ((skip_bits >> i) & 1u) mm_wide(acc, xbuf, d, p.wf_x[i], ring);
    }
    masks[i * NT + t] = relu_bits(acc);
    if (i + 1 < depth) put_tile(buf0, acc);
    store_rows(h_s + i * layer, row0, n, acc);
  }

  // 2. Tangent sweep seeded with G_bar at every input injection:
  //    tau_i = (tau_{i-1} W_i [+ G_bar Wx_i]) * m_i, tau_0 = (G_bar W_0) * m_0.
  for (int i = 0; i < depth; ++i) {
    fill_tile(acc, 0.0f);
    if (i == 0) {
      mm_wide(acc, gbuf, d, p.wf_h[0], ring);
    } else {
      mm_wide(acc, buf0, WIDTH, p.wf_h[i], ring);
      if ((skip_bits >> i) & 1u) mm_wide(acc, gbuf, d, p.wf_x[i], ring);
    }
    apply_bits(acc, masks[i * NT + t]);
    if (i + 1 < depth) {
      put_tile(buf0, acc);
      store_rows(tau_s + i * layer, row0, n, acc);
    } else {
      store_rows(tau_last, row0, n, acc);
    }
  }

  // 3. Seed of the first-order sweep:
  //    r = T_bar + [sigma_bar, n_bar] W_head^T (+ B_bar W_bn^T).
  if (has_bn) {
    load_rows(acc, bbar, row0, n);
    put_tile(buf0, acc);
  }
  load_rows(acc, tbar, row0, n);
  mm_wide(acc, hcbuf, hcu, p.wa_t, ring);
  if (has_bn) mm_wide(acc, buf0, WIDTH, p.wb_t, ring);

  // 4. Reverse sweeps in lockstep: c1_i = r_i * m_i and c_g,i = r_g,i * m_i,
  //    with r_g seeded by w_sigma; feat_bar += c1_i Wx_i^T at layer 0 and the
  //    skips; r_{i-1} = c1_i Wh_i^T, r_g,i-1 = c_g,i Wh_i^T. feat, G_bar and
  //    the head cotangent are no longer read, so c1 takes buf1.
  float accg[8][8];
  fill_columns(accg, p.head_w, hc);
  float xacc[4][4] = {};
  for (int i = depth - 1; i >= 0; --i) {
    const uint64_t bits = masks[i * NT + t];
    apply_bits(acc, bits);
    apply_bits(accg, bits);
    store_rows(c1_s + i * layer, row0, n, acc);
    store_rows(cg_s + i * layer, row0, n, accg);
    put_tile(buf1, acc);
    put_tile(buf0, accg);
    if (i == 0 || ((skip_bits >> i) & 1u))
      mm_narrow(xacc, buf1, WIDTH, p.wr_x[i], ring);
    if (i > 0) {
      fill_tile(acc, 0.0f);
      mm_wide(acc, buf1, WIDTH, p.wr_h[i], ring);
      fill_tile(accg, 0.0f);
      mm_wide(accg, buf0, WIDTH, p.wr_h[i], ring);
    }
  }
  store_narrow(xbar, row0, n, d, xacc);
}

// One grad: out[k, j] (row stride ldo) = sum over rows of
// A[row, k] C[row, j] + A2[row, k] C2[row, j], k < k_dim, j < nc, and, if
// bias is set, bias[j] = sum over rows of C[row, j]. A2 null means no
// second product.
struct WgDesc {
  const float* a;
  const float* a2;
  const float* c;
  const float* c2;
  float* out;
  float* bias;
  int lda, ldc, k_dim, nc, ldo;
  int tile_begin;       // first block (grid x) of this grad
  int j_tiles;          // tiles along j
  long long part_off;   // offset of this grad's partials within a split
};

// Kernel parameters are __grid_constant__: indexed by a loop variable, they
// are read in place rather than copied to each thread's stack.
struct WgParams {
  WgDesc desc[MAXDESC];
  int ndesc;
  int n;
  int rows_per_split;
  long long per_split;  // partial-sum floats of one split
  float* partials;      // [splits][per_split]
};

// Floats of one weight-grad stage: A, C, A2, C2, each [RB][128].
constexpr int WG_STAGE = 4 * RB * TK;
constexpr int WG_SMEM_BYTES = WSTAGES * WG_STAGE * 4;

// Copies the 16-byte pieces of rows [rb, rb + RB) x columns [col0,
// col0 + 128) of a row-major matrix (row stride ld) into dst [RB][128];
// rows at or past rend and columns at or past ncol are zero.
__device__ __forceinline__ void stage_rows(float* dst,
                                           const float* __restrict__ src,
                                           int ld, int col0, int ncol, int rb,
                                           int rend) {
#pragma unroll
  for (int q = 0; q < RB * TK / 4 / 256; ++q) {
    const int e = threadIdx.x + q * 256;
    const int r = e >> 5, c4 = e & 31;
    const int row = rb + r, col = col0 + c4 * 4;
    const int valid = row < rend ? max(0, min(4, ncol - col)) : 0;
    const float* from =
        valid ? src + static_cast<size_t>(row) * ld + col : src;
    cp_async16(dst + r * TK + c4 * 4, from, 4 * valid);
  }
}

// A block owns a 128 x 128 output tile. Warp w covers k rows (w / 2) * 32
// .. + 32 and j columns (w % 2) * 64 .. + 64; its lane l keeps the 8 x 8
// outputs at k rows (l / 8) * 4 + {0..3, 16..19} and j columns
// (l % 8) * 4 + {0..3, 32..35} of the warp's in registers.
__global__ void __launch_bounds__(256, 2) trunk_wgrad_kernel(
    const __grid_constant__ WgParams p) {
  extern __shared__ __align__(16) float wsm[];  // [WSTAGES][WG_STAGE]
  int di = 0;
  while (di + 1 < p.ndesc &&
         p.desc[di + 1].tile_begin <= static_cast<int>(blockIdx.x))
    ++di;
  const WgDesc& D = p.desc[di];
  const int local = blockIdx.x - D.tile_begin;
  const int k0 = (local / D.j_tiles) * TK, j0 = (local % D.j_tiles) * TJ;
  const int split = blockIdx.y;
  const int rbeg = split * p.rows_per_split;
  const int rend = min(p.n, rbeg + p.rows_per_split);
  const int nstages = rend > rbeg ? (rend - rbeg + RB - 1) / RB : 0;
  const int t = threadIdx.x;
  const int kb = ((t >> 6) << 5) + (((t >> 3) & 3) << 2);  // first k row
  const int jb = (((t >> 5) & 1) << 6) + ((t & 7) << 2);   // first j column
  const bool two = D.a2 != nullptr;
  const bool bias = D.bias != nullptr && k0 == 0;

  auto load = [&](int s, int q) {
    float* st = wsm + s * WG_STAGE;
    const int rb = rbeg + q * RB;
    stage_rows(st, D.a, D.lda, k0, D.k_dim, rb, rend);
    stage_rows(st + RB * TK, D.c, D.ldc, j0, D.nc, rb, rend);
    if (two) {
      stage_rows(st + 2 * RB * TK, D.a2, D.lda, k0, D.k_dim, rb, rend);
      stage_rows(st + 3 * RB * TK, D.c2, D.ldc, j0, D.nc, rb, rend);
    }
  };

  float acc[8][8] = {};
  float bsum[8] = {};
#pragma unroll
  for (int s = 0; s < WSTAGES - 1; ++s) {
    if (s < nstages) load(s, s);
    cp_async_commit();
  }
  for (int q = 0; q < nstages; ++q) {
    cp_async_wait<WSTAGES - 2>();
    __syncthreads();
    const int next = q + WSTAGES - 1;
    if (next < nstages) load(next % WSTAGES, next);
    cp_async_commit();
    const float* st = wsm + (q % WSTAGES) * WG_STAGE;
#pragma unroll 4
    for (int r = 0; r < RB; ++r) {
      const float* as = st + r * TK;
      const float* cs = st + RB * TK + r * TK;
      const float4 c0 = *reinterpret_cast<const float4*>(cs + jb);
      const float4 c1 = *reinterpret_cast<const float4*>(cs + jb + 32);
      if (bias) {
        bsum[0] += c0.x; bsum[1] += c0.y; bsum[2] += c0.z; bsum[3] += c0.w;
        bsum[4] += c1.x; bsum[5] += c1.y; bsum[6] += c1.z; bsum[7] += c1.w;
      }
      fma_8x8(acc, *reinterpret_cast<const float4*>(as + kb),
              *reinterpret_cast<const float4*>(as + kb + 16), c0, c1);
      if (two) {
        const float* as2 = st + 2 * RB * TK + r * TK;
        const float* cs2 = st + 3 * RB * TK + r * TK;
        fma_8x8(acc, *reinterpret_cast<const float4*>(as2 + kb),
                *reinterpret_cast<const float4*>(as2 + kb + 16),
                *reinterpret_cast<const float4*>(cs2 + jb),
                *reinterpret_cast<const float4*>(cs2 + jb + 32));
      }
    }
  }
  float* part = p.partials + static_cast<size_t>(split) * p.per_split +
                D.part_off;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = k0 + kb + (i & 3) + (i >> 2) * 16;
    if (k >= D.k_dim) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int jj = j0 + jb + (j & 3) + (j >> 2) * 32;
      if (jj < D.nc) part[static_cast<size_t>(k) * D.nc + jj] = acc[i][j];
    }
  }
  if (bias && kb == 0) {  // one thread of each column group writes
    float* bpart = part + static_cast<size_t>(D.k_dim) * D.nc;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int jj = j0 + jb + (j & 3) + (j >> 2) * 32;
      if (jj < D.nc) bpart[jj] = bsum[j];
    }
  }
}

}  // namespace

// wptrs: five per layer (wf_h, wf_x, wr_h, wr_x, bias; 0 where unused; wr_x
// zero-padded to NW = 64 columns), then head_w, wa_t, wb_t (0 without a
// bottleneck). gptrs: (kernel grad, bias grad) per layer, then the
// bottleneck's (0, 0 without one), then the head's. feat and gbar have rows
// of D rounded up to 4 floats, head_cot and e0 rows of HCMAX = 8 floats
// (zero past hcu; e0 is 1 in column 0). scratch holds 4 * depth * N * 256
// floats, partials splits * per_split floats.
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
  const int ldx = (d + 3) & ~3;
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

  // Scratch: c1 and c_g of every layer, the last tau layer, then h of every
  // layer and tau of the others.
  const size_t layer = static_cast<size_t>(n) * WIDTH;
  float* c1_s = scratch;
  float* cg_s = c1_s + depth * layer;
  float* tau_last = cg_s + depth * layer;
  float* h_s = tau_last + layer;
  float* tau_s = h_s + depth * layer;

  // The grads, in the order of their partials.
  WgParams wp = {};
  int tiles = 0;
  long long off = 0;
  auto add = [&](const float* a, const float* a2, const float* c,
                 const float* c2, int lda, int ldc, int k_dim, int nc,
                 float* out, int ldo, float* bias) {
    WgDesc& D = add_grad<TK, TJ>(wp, tiles, off, k_dim, nc, out, ldo, bias);
    D.a = a; D.a2 = a2; D.c = c; D.c2 = c2; D.lda = lda; D.ldc = ldc;
  };
  for (int i = 0; i < depth; ++i) {
    float* dw = reinterpret_cast<float*>(gptrs[2 * i]);
    float* db = reinterpret_cast<float*>(gptrs[2 * i + 1]);
    const float* c1 = c1_s + i * layer;
    const float* cg = cg_s + i * layer;
    if (i == 0) {
      add(feat, gbar, c1, cg, ldx, WIDTH, d, WIDTH, dw, WIDTH, db);
    } else {
      add(h_s + (i - 1) * layer, tau_s + (i - 1) * layer, c1, cg, WIDTH,
          WIDTH, WIDTH, WIDTH, dw, WIDTH, db);
      if ((skip_bits >> i) & 1u)
        add(feat, gbar, c1, cg, ldx, WIDTH, d, WIDTH, dw + WIDTH * WIDTH,
            WIDTH, nullptr);
    }
  }
  const float* h_last = h_s + (depth - 1) * layer;
  if (has_bn) {
    float* dw = reinterpret_cast<float*>(gptrs[2 * depth]);
    float* db = reinterpret_cast<float*>(gptrs[2 * depth + 1]);
    add(h_last, nullptr, bbar, nullptr, WIDTH, WIDTH, WIDTH, WIDTH, dw, WIDTH,
        db);
  }
  {
    // h_L^T [sigma_bar, n_bar] + tau_L^T e0.
    float* dw = reinterpret_cast<float*>(gptrs[2 * depth + 2]);
    float* db = reinterpret_cast<float*>(gptrs[2 * depth + 3]);
    add(h_last, tau_last, head_cot, e0, WIDTH, HCMAX, WIDTH, hcu, dw, hc, db);
  }
  if (off != per_split) return static_cast<int>(cudaErrorInvalidValue);
  wp.n = n;
  wp.rows_per_split = (n + splits - 1) / splits;
  wp.per_split = off;
  wp.partials = partials;

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem = sweep_smem_bytes(depth);
  cudaError_t err = cudaFuncSetAttribute(
      trunk_bwd_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  trunk_bwd_sweep_kernel<<<(n + TM - 1) / TM, NT, smem, st>>>(
      feat, head_cot, tbar, bbar, gbar, n, d, ldx, depth, skip_bits, hc, hcu,
      has_bn, bp, xbar, h_s, tau_s, tau_last, c1_s, cg_s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(trunk_wgrad_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             WG_SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  trunk_wgrad_kernel<<<dim3(tiles, splits), 256, WG_SMEM_BYTES, st>>>(wp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  trunk_wgrad_reduce_kernel<<<static_cast<unsigned>((off + 255) / 256), 256, 0,
                              st>>>(wp, splits);
  return static_cast<int>(cudaGetLastError());
}
