// Hand-derived backward of the NeRF trunk with dsigma/dfeat for Hopper
// (sm_90a), f32 in and out, with f32 or bf16 operands.
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
// bf16-operand mode (the TPU kernel's compute_dtype = bf16). The weights
// arrive in bf16 (biases f32); every product takes bf16 operands, widened
// to f32 and summed in f32, rounded where the TPU kernel casts: feat,
// G_bar, the head cotangent and B_bar as they are read; h and tau as they
// are stored; c1 and c_g where they enter a product. The masks test the
// stored bf16 h. The sums that the TPU kernel takes in f32 stay f32: the
// bias grads (sums of the unrounded c1, B_bar and head cotangent) and the
// sigma column's sum of tau_L. So the scratch holds what the TPU kernel
// keeps in its bf16 scratch, h_i and tau_i, in bf16, and the rest in f32:
// c1_i and c_g,i, and the last tangent layer tau_L, whose f32 sum feeds
// the head grad. At depth 8, N = 65,536: h 268 MB, tau 235 MB (7 layers),
// tau_L 67 MB, c1 and c_g 1,074 MB; 1,644 MB against 2,147 MB in f32.
// The weight-grad kernel reads h, tau, and bf16 copies of feat and G_bar
// (made by the wrapper) as bf16, and rounds c1, c_g, B_bar and the head
// cotangent to bf16 after it has summed them for the bias grads.
#include <cuda_bf16.h>
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

// Weights in T (float or bf16), biases in f32.
template <class T>
struct BwdParams {
  const T* wf_h[MAXD];  // forward weight read by h ([D,256] at layer 0)
  const T* wf_x[MAXD];  // forward weight read by feat at skip layers
  const T* wr_h[MAXD];  // reverse weight to h, [256 out, 256 in]
  const T* wr_x[MAXD];  // reverse weight to feat, [256 out, NW]
  const float* b[MAXD];
  const T* head_w;      // [256, hc]: column 0 is w_sigma
  const T* wa_t;        // [hcu, 256]: the used head columns, transposed
  const T* wb_t;        // [256, 256]: the bottleneck, transposed, or null
};

template <class T>
__host__ __device__ constexpr int sweep_smem_bytes(int depth) {
  return (2 * TILE_FLOATS + RING_FLOATS) * static_cast<int>(sizeof(T)) +
         depth * MASK_BYTES;
}

// feat and G_bar have rows of ldx = D rounded up to 4 floats; the head
// cotangent rows of HCMAX floats (the wrapper pads them). h_s holds every
// layer's h; tau_s layers 0 .. depth - 2 of tau, tau_last the last.
template <class T>
__global__ void __launch_bounds__(NT, 1) trunk_bwd_sweep_kernel(
    const float* __restrict__ feat, const float* __restrict__ head_cot,
    const float* __restrict__ tbar, const float* __restrict__ bbar,
    const float* __restrict__ gbar, int n, int d, int ldx, int depth,
    unsigned skip_bits, int hc, int hcu, int has_bn,
    const __grid_constant__ BwdParams<T> p,
    float* __restrict__ xbar, T* __restrict__ h_s,
    T* __restrict__ tau_s, float* __restrict__ tau_last,
    float* __restrict__ c1_s, float* __restrict__ cg_s) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* buf0 = reinterpret_cast<T*>(smem);  // h, tau, B_bar, c_g
  T* buf1 = buf0 + TILE_FLOATS;          // c1
  T* xbuf = buf1;                        // feat   [DMAX][LDA]
  T* gbuf = buf1 + XTILE_FLOATS;         // G_bar  [DMAX][LDA]
  T* hcbuf = gbuf + XTILE_FLOATS;        // head cotangent [KC][LDA]
  T* ring = buf1 + TILE_FLOATS;
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
    masks[i * NT + t] = relu_bits<T>(acc);
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
// second product. C and C2 are f32. mode 0: A and A2 f32, nothing
// rounded. mode 1: A and A2 bf16, C and C2 rounded to bf16 for the
// products (the bias sums the unrounded C). mode 2: as 1 but A2 f32.
struct WgDesc {
  const void* a;
  const void* a2;
  const float* c;
  const float* c2;
  float* out;
  float* bias;
  int lda, ldc, k_dim, nc, ldo;
  int mode;
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
// col0 + 128) of a row-major matrix (row stride ld, a multiple of 16
// bytes) into dst [RB][128]; rows at or past rend and columns at or past
// ncol are zero.
template <class T>
__device__ __forceinline__ void stage_rows(T* dst, const T* __restrict__ src,
                                           int ld, int col0, int ncol, int rb,
                                           int rend) {
  constexpr int EPP = 16 / sizeof(T);  // elements a 16-byte piece
  constexpr int PER_ROW = TK / EPP;
#pragma unroll
  for (int q = 0; q < RB * PER_ROW / 256; ++q) {
    const int e = threadIdx.x + q * 256;
    const int r = e / PER_ROW, c = (e % PER_ROW) * EPP;
    const int row = rb + r, col = col0 + c;
    const int valid = row < rend ? max(0, min(EPP, ncol - col)) : 0;
    const T* from = valid ? src + static_cast<size_t>(row) * ld + col : src;
    cp_async16(dst + r * TK + c, from, static_cast<int>(sizeof(T)) * valid);
  }
}

__device__ __forceinline__ float4 round4(float4 v) {
  return make_float4(round_to<__nv_bfloat16>(v.x), round_to<__nv_bfloat16>(v.y),
                     round_to<__nv_bfloat16>(v.z), round_to<__nv_bfloat16>(v.w));
}

// A block owns a 128 x 128 output tile. Warp w covers k rows (w / 2) * 32
// .. + 32 and j columns (w % 2) * 64 .. + 64; its lane l keeps the 8 x 8
// outputs at k rows (l / 8) * 4 + {0..3, 16..19} and j columns
// (l % 8) * 4 + {0..3, 32..35} of the warp's in registers. TA and TA2 are
// the element types of A and A2; RND rounds C and C2 to bf16.
template <class TA, class TA2, bool RND>
__device__ __forceinline__ void wgrad_tile(const WgDesc& D, const WgParams& p,
                                           float* wsm) {
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
  const TA* a = static_cast<const TA*>(D.a);
  const TA2* a2 = static_cast<const TA2*>(D.a2);

  // A stage: A, C, A2, C2 regions of RB x 128 floats each (a bf16 operand
  // fills the first half of its region).
  auto load = [&](int s, int q) {
    float* st = wsm + s * WG_STAGE;
    const int rb = rbeg + q * RB;
    stage_rows(reinterpret_cast<TA*>(st), a, D.lda, k0, D.k_dim, rb, rend);
    stage_rows(st + RB * TK, D.c, D.ldc, j0, D.nc, rb, rend);
    if (two) {
      stage_rows(reinterpret_cast<TA2*>(st + 2 * RB * TK), a2, D.lda, k0,
                 D.k_dim, rb, rend);
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
      const TA* as = reinterpret_cast<const TA*>(st) + r * TK;
      const float* cs = st + RB * TK + r * TK;
      float4 c0 = ld4(cs + jb);
      float4 c1 = ld4(cs + jb + 32);
      if (bias) {
        bsum[0] += c0.x; bsum[1] += c0.y; bsum[2] += c0.z; bsum[3] += c0.w;
        bsum[4] += c1.x; bsum[5] += c1.y; bsum[6] += c1.z; bsum[7] += c1.w;
      }
      if (RND) {
        c0 = round4(c0);
        c1 = round4(c1);
      }
      fma_8x8(acc, ld4(as + kb), ld4(as + kb + 16), c0, c1);
      if (two) {
        const TA2* as2 =
            reinterpret_cast<const TA2*>(st + 2 * RB * TK) + r * TK;
        const float* cs2 = st + 3 * RB * TK + r * TK;
        float4 d0 = ld4(cs2 + jb);
        float4 d1 = ld4(cs2 + jb + 32);
        if (RND) {
          d0 = round4(d0);
          d1 = round4(d1);
        }
        fma_8x8(acc, ld4(as2 + kb), ld4(as2 + kb + 16), d0, d1);
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

__global__ void __launch_bounds__(256, 2) trunk_wgrad_kernel(
    const __grid_constant__ WgParams p) {
  extern __shared__ __align__(16) float wsm[];  // [WSTAGES][WG_STAGE]
  int di = 0;
  while (di + 1 < p.ndesc &&
         p.desc[di + 1].tile_begin <= static_cast<int>(blockIdx.x))
    ++di;
  const WgDesc& D = p.desc[di];
  if (D.mode == 0)
    wgrad_tile<float, float, false>(D, p, wsm);
  else if (D.mode == 1)
    wgrad_tile<__nv_bfloat16, __nv_bfloat16, true>(D, p, wsm);
  else
    wgrad_tile<__nv_bfloat16, float, true>(D, p, wsm);
}

// out = sum of the splits' partials, in split order. A grad's partials are
// its k_dim x nc kernel entries, then its nc bias entries if it has them.
__global__ void trunk_wgrad_reduce_kernel(const __grid_constant__ WgParams p,
                                          int splits) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= p.per_split) return;
  int di = 0;
  while (di + 1 < p.ndesc && p.desc[di + 1].part_off <= e) ++di;
  const WgDesc& D = p.desc[di];
  const long long local = e - D.part_off;
  float s = 0.0f;
  for (int sp = 0; sp < splits; ++sp)
    s += p.partials[static_cast<size_t>(sp) * p.per_split + e];
  const long long kernel_size = static_cast<long long>(D.k_dim) * D.nc;
  if (local < kernel_size) {
    const int k = static_cast<int>(local / D.nc), j = static_cast<int>(local % D.nc);
    D.out[static_cast<size_t>(k) * D.ldo + j] = s;
  } else {
    D.bias[local - kernel_size] = s;
  }
}

template <class T>
int launch_bwd(const float* feat, const float* head_cot, const float* tbar,
               const float* bbar, const float* gbar, const void* feat16,
               const void* gbar16, int ld16, const uint64_t* wptrs,
               const uint64_t* gptrs, const float* e0, int n, int d,
               int depth, unsigned skip_bits, int hc, int hcu, int has_bn,
               int splits, long per_split, float* xbar, float* scratch,
               float* partials, cudaStream_t st) {
  constexpr bool kHalf = sizeof(T) == 2;
  const int ldx = (d + 3) & ~3;
  BwdParams<T> bp = {};
  for (int i = 0; i < depth; ++i) {
    bp.wf_h[i] = reinterpret_cast<const T*>(wptrs[5 * i]);
    bp.wf_x[i] = reinterpret_cast<const T*>(wptrs[5 * i + 1]);
    bp.wr_h[i] = reinterpret_cast<const T*>(wptrs[5 * i + 2]);
    bp.wr_x[i] = reinterpret_cast<const T*>(wptrs[5 * i + 3]);
    bp.b[i] = reinterpret_cast<const float*>(wptrs[5 * i + 4]);
  }
  bp.head_w = reinterpret_cast<const T*>(wptrs[5 * depth]);
  bp.wa_t = reinterpret_cast<const T*>(wptrs[5 * depth + 1]);
  bp.wb_t = reinterpret_cast<const T*>(wptrs[5 * depth + 2]);

  // Scratch: c1 and c_g of every layer and the last tau layer in f32, then
  // h of every layer and tau of the others in T.
  const size_t layer = static_cast<size_t>(n) * WIDTH;
  float* c1_s = scratch;
  float* cg_s = c1_s + depth * layer;
  float* tau_last = cg_s + depth * layer;
  T* h_s = reinterpret_cast<T*>(tau_last + layer);
  T* tau_s = h_s + depth * layer;

  // The grads, in the order of their partials. The products' A operands
  // in T: feat and G_bar themselves, or the wrapper's bf16 copies.
  const void* fa = kHalf ? feat16 : static_cast<const void*>(feat);
  const void* ga = kHalf ? gbar16 : static_cast<const void*>(gbar);
  const int lda_x = kHalf ? ld16 : ldx;
  const int mode = kHalf ? 1 : 0;
  WgParams wp = {};
  int tiles = 0;
  long long off = 0;
  auto add = [&](const void* a, const void* a2, const float* c,
                 const float* c2, int lda, int ldc, int k_dim, int nc,
                 float* out, int ldo, float* bias, int m) {
    WgDesc& D = wp.desc[wp.ndesc++];
    D.a = a; D.a2 = a2; D.c = c; D.c2 = c2; D.out = out; D.bias = bias;
    D.lda = lda; D.ldc = ldc; D.k_dim = k_dim; D.nc = nc; D.ldo = ldo;
    D.mode = m;
    D.tile_begin = tiles;
    D.j_tiles = (nc + TJ - 1) / TJ;
    D.part_off = off;
    tiles += ((k_dim + TK - 1) / TK) * D.j_tiles;
    off += static_cast<long long>(k_dim) * nc + (bias ? nc : 0);
  };
  for (int i = 0; i < depth; ++i) {
    float* dw = reinterpret_cast<float*>(gptrs[2 * i]);
    float* db = reinterpret_cast<float*>(gptrs[2 * i + 1]);
    const float* c1 = c1_s + i * layer;
    const float* cg = cg_s + i * layer;
    if (i == 0) {
      add(fa, ga, c1, cg, lda_x, WIDTH, d, WIDTH, dw, WIDTH, db, mode);
    } else {
      add(h_s + (i - 1) * layer, tau_s + (i - 1) * layer, c1, cg, WIDTH,
          WIDTH, WIDTH, WIDTH, dw, WIDTH, db, mode);
      if ((skip_bits >> i) & 1u)
        add(fa, ga, c1, cg, lda_x, WIDTH, d, WIDTH, dw + WIDTH * WIDTH, WIDTH,
            nullptr, mode);
    }
  }
  const T* h_last = h_s + (depth - 1) * layer;
  if (has_bn) {
    float* dw = reinterpret_cast<float*>(gptrs[2 * depth]);
    float* db = reinterpret_cast<float*>(gptrs[2 * depth + 1]);
    add(h_last, nullptr, bbar, nullptr, WIDTH, WIDTH, WIDTH, WIDTH, dw, WIDTH,
        db, mode);
  }
  {
    // h_L^T [sigma_bar, n_bar] + tau_L^T e0: tau_L's sum stays f32.
    float* dw = reinterpret_cast<float*>(gptrs[2 * depth + 2]);
    float* db = reinterpret_cast<float*>(gptrs[2 * depth + 3]);
    add(h_last, tau_last, head_cot, e0, WIDTH, HCMAX, WIDTH, hcu, dw, hc, db,
        kHalf ? 2 : 0);
  }
  if (off != per_split) return static_cast<int>(cudaErrorInvalidValue);
  wp.n = n;
  wp.rows_per_split = (n + splits - 1) / splits;
  wp.per_split = off;
  wp.partials = partials;

  const int smem = sweep_smem_bytes<T>(depth);
  cudaError_t err = cudaFuncSetAttribute(
      trunk_bwd_sweep_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  trunk_bwd_sweep_kernel<T><<<(n + TM - 1) / TM, NT, smem, st>>>(
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

}  // namespace

// wptrs: five per layer (wf_h, wf_x, wr_h, wr_x, bias; 0 where unused; wr_x
// zero-padded to NW = 64 columns), then head_w, wa_t, wb_t (0 without a
// bottleneck). gptrs: (kernel grad, bias grad) per layer, then the
// bottleneck's (0, 0 without one), then the head's. feat and gbar have rows
// of D rounded up to 4 floats, head_cot and e0 rows of HCMAX = 8 floats
// (zero past hcu; e0 is 1 in column 0). partials holds splits * per_split
// floats. bf16 = 0: every weight f32, feat16 and gbar16 unused, scratch of
// 4 * depth * N * 256 floats. bf16 = 1: every weight (not the biases) bf16,
// feat16 and gbar16 bf16 copies of feat and G_bar with rows of ld16 = D
// rounded up to 8, scratch of (2 * depth + 1) * N * 256 floats and
// (2 * depth - 1) * N * 256 bf16 values.
// Returns cudaGetLastError() of the launches.
extern "C" int fused_trunk_bwd(const float* feat, const float* head_cot,
                               const float* tbar, const float* bbar,
                               const float* gbar, const void* feat16,
                               const void* gbar16, const uint64_t* wptrs,
                               const uint64_t* gptrs, const float* e0, int n,
                               int d, int depth, unsigned skip_bits, int hc,
                               int hcu, int has_bn, int bf16, int splits,
                               long per_split, float* xbar, float* scratch,
                               float* partials, void* stream) {
  if (depth < 1 || depth > MAXD || d < 1 || d > DMAX || hc < 1 ||
      hc > HCMAX || hcu < 1 || hcu > hc || n < 1 || splits < 1 ||
      (skip_bits & 1u) || (has_bn && bbar == nullptr) ||
      (bf16 && (feat16 == nullptr || gbar16 == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ld16 = (d + 7) & ~7;
  if (bf16)
    return launch_bwd<__nv_bfloat16>(
        feat, head_cot, tbar, bbar, gbar, feat16, gbar16, ld16, wptrs, gptrs,
        e0, n, d, depth, skip_bits, hc, hcu, has_bn, splits, per_split, xbar,
        scratch, partials, st);
  return launch_bwd<float>(feat, head_cot, tbar, bbar, gbar, nullptr, nullptr,
                           ld16, wptrs, gptrs, e0, n, d, depth, skip_bits, hc,
                           hcu, has_bn, splits, per_split, xbar, scratch,
                           partials, st);
}
