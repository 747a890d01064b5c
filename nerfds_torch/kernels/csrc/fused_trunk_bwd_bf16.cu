// Hand-derived backward of the NeRF trunk with dsigma/dfeat for Hopper
// (sm_90a) in the bf16-operand mode (the TPU kernel's compute_dtype =
// bf16), on the tensor cores: f32 in and out, bf16 operands, f32 sums.
//
// Replaces the TPU kernel nerfds_tpu/pallas/fused_trunk.py:_bwd_kernel
// (called by _pallas_backward) with compute_dtype = bf16; computes what
// fused_trunk_bwd.cu computes: given the forward's input feat [N,D] and the
// cotangents of its outputs (head [N,hcu] = [sigma_bar, normal_bar], T_bar
// and B_bar [N,256], G_bar [N,D]) it returns feat_bar [N,D] and the grad of
// every trunk, bottleneck and head kernel and bias, with the second-order
// terms of G_bar . g (see nerfds_torch/kernels/fused_trunk.py).
//
// Rounding points, those of the TPU kernel: the weights arrive in bf16
// (biases f32); feat, G_bar, the head cotangent and B_bar are rounded to
// bf16 as they are read, h and tau as they are stored, c1 and c_g where
// they enter a product; the masks test the stored bf16 h. The sums the TPU
// kernel takes in f32 stay f32: the bias grads (sums of the unrounded c1,
// B_bar and head cotangent) and the sigma column's sum of tau_L. Every
// product sums in f32 on the tensor cores (mma.sync m16n8k16), and every
// sum that a rounding or a mask decides and that lies near its decision
// is summed again in k order (trunk_mma.cuh's resum), so that h, tau, c1,
// c_g and the masks fall as the plain version's f32 sums make them fall.
//
// Bound: operations on the tensor cores, about 6.0 MFLOP a row for the
// nerf_ds trunk (0.400 ms at 989 TFLOP/s for N = 65,536). The scratch
// below adds a floor of its own: written once and read back, 1,644 MB at
// depth 8 and N = 65,536 take 0.98 ms at 3.35 TB/s.
//
// Design, in four launches on the caller's stream:
// 0. trunk_l1_kernel: the L1 norms of the weights' rows (resum's window).
// 1. trunk_bwd_bf16_sweep_kernel: a block owns 64 rows and runs, on the
//    engine of trunk_mma.cuh, the recompute, tau, the seed of r, then r
//    with r_g in lockstep, layer by layer, each in its own pass over the
//    reverse weight (one register tile for both: two in flight spilled).
//    Shared memory a block (one block an SM):
//      two activation tiles [64][256] bf16        65,536 B
//      feat, G_bar, head cotangent [64][64] bf16  24,576 B
//      weight ring 3 x 32 KB                      98,304 B
//      relu bits depth x 2 KB                     16,384 B at depth 8,
//                                                 24,576 B at depth 12
//      row maxima of the five tiles                5,120 B
//      the warps' resum lists                      4,096 B
//      total                                     214,016 B at depth 8,
//                                                222,208 B at depth 12
//    of 232,448 B. The weight grads sum over every row of N, across
//    blocks, so the sweep writes what they need to device-memory scratch,
//    as the f32 kernel does but with h_i and tau_i in bf16: c1_i and c_g,i
//    of every layer and tau_L in f32, h_i of every layer and tau_i of the
//    others in bf16 (1,644 MB at depth 8, N = 65,536).
// 2. trunk_wgrad_bf16_kernel: every grad is a sum over rows of one or two
//    outer products, dW = A^T C + A2^T C2 (zin^T c1 + tin^T c_g for a
//    trunk layer, h_L^T [sigma_bar, n_bar] for the head, plus the f32
//    column sum of tau_L into the sigma column). A block owns a 128 x 128
//    tile of one grad and one fixed slice of the rows, and walks the slice
//    in stages of 16 rows through a 3-stage cp.async ring (two blocks an
//    SM). Each stage's f32 C and C2 are summed for the bias (blocks of
//    k-tile 0) and rounded into bf16 tiles; then one k16 step of mma with
//    A^T and C both taken by ldmatrix.trans from their [rows][128] tiles,
//    summed from zero and added to the f32 accumulator.
// 3. trunk_wgrad_reduce_kernel (trunk_common.cuh) adds the slices' partials
//    in slice order. No atomics: two launches on the same inputs give the
//    same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "trunk_mma.cuh"

namespace {

constexpr int MAXD = 12;      // deepest trunk supported (grad table size)
constexpr int MAXDESC = 28;   // grads of the deepest trunk, all skips
constexpr int TK = 128;       // weight-grad tile rows (input channels)
constexpr int TJ = 128;       // weight-grad tile columns (output channels)
constexpr int RB = 16;        // rows a stage of the weight-grad ring
constexpr int WSTAGES = 3;    // stages of the weight-grad ring

struct BwdParamsBf16 {
  const bf16* wf_h[MAXD];  // [in][out] ([D][256] at layer 0): reverse W^T
  const bf16* wf_x[MAXD];  // [D][256] at the skip layers: reverse W^T
  const bf16* wr_h[MAXD];  // [out][in] = wf_h^T, layers > 0: forward W^T
  const bf16* wr_x[MAXD];  // [256][NW]: feat's weight^T, layer 0 and skips
  const float* b[MAXD];
  const bf16* head_w;      // [256][HCMAX]: the head, zero columns past hc
  const bf16* bn_w;        // [256][256]: the bottleneck, or null
};

__host__ __device__ constexpr int sweep_bf16_smem_bytes(int depth) {
  return (2 * TILE + 3 * XTILE + STAGES * STAGE) * 2 + depth * MASK_BYTES +
         5 * RM * 4 + SEQ_LIST_BYTES;
}

// feat and G_bar have rows of ldx = D rounded up to 4 floats; the head
// cotangent rows of HCMAX floats (the wrapper pads them). h_s holds every
// layer's h; tau_s layers 0 .. depth - 2 of tau, tau_last the last.
__global__ void __launch_bounds__(NT, 1) trunk_bwd_bf16_sweep_kernel(
    const float* __restrict__ feat, const float* __restrict__ head_cot,
    const float* __restrict__ tbar, const float* __restrict__ bbar,
    const float* __restrict__ gbar, int n, int d, int ldx, int depth,
    unsigned skip_bits, int hcu, int has_bn,
    const __grid_constant__ BwdParamsBf16 p, const float* __restrict__ l1,
    float* __restrict__ xbar,
    bf16* __restrict__ h_s, bf16* __restrict__ tau_s,
    float* __restrict__ tau_last, float* __restrict__ c1_s,
    float* __restrict__ cg_s) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* buf0 = reinterpret_cast<bf16*>(smem);  // h, tau, B_bar, c_g
  bf16* buf1 = buf0 + TILE;                    // c1
  bf16* xbuf = buf1 + TILE;                    // feat   [TM][DMAX]
  bf16* gbuf = xbuf + XTILE;                   // G_bar  [TM][DMAX]
  bf16* hcbuf = gbuf + XTILE;                  // head cotangent [TM][DMAX]
  bf16* ring = hcbuf + XTILE;
  uint64_t* masks = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE);
  // Row maxima of buf0, buf1, feat, G_bar and the head cotangent (resum).
  float* rm0 = reinterpret_cast<float*>(masks + depth * NT);
  float* rm1 = rm0 + RM;
  float* rmx = rm1 + RM;
  float* rmg = rmx + RM;
  float* rmh = rmg + RM;
  unsigned char* list = reinterpret_cast<unsigned char*>(rmh + RM);

  const int t = threadIdx.x;
  const int row0 = blockIdx.x * TM;
  const size_t layer = static_cast<size_t>(n) * WIDTH;
  load_narrow_tile(xbuf, feat, ldx, d, row0, n, rmx);
  load_narrow_tile(gbuf, gbar, ldx, d, row0, n, rmg);
  load_narrow_tile(hcbuf, head_cot, HCMAX, hcu, row0, n, rmh);

  float acc[2][8][4];
  // 1. Forward recompute: h_i = relu(h_{i-1} W_i [+ feat Wx_i] + b_i).
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
      const SeqTerm th = {buf0, rm0, WIDTH, p.wr_h[i], WIDTH,
                          l1 + 3 * i * WIDTH};
      mm_wide(acc, buf0, WIDTH, WIDTH, p.wr_h[i], WIDTH, ring);
      if (skip) mm_wide(acc, xbuf, DMAX, d, p.wr_x[i], NW, ring);
      resum<true>(acc, row0, n, th, skip ? tx : SeqTerm{}, 0ull, nullptr,
                  p.b[i], list, ring);
    }
    masks[i * NT + t] = relu_bits<true>(acc);
    if (i + 1 < depth) put_tile(buf0, acc, rm0);
    store_rows(h_s + i * layer, row0, n, acc);
  }

  // 2. Tangent sweep seeded with G_bar at every input injection:
  //    tau_i = (tau_{i-1} W_i [+ G_bar Wx_i]) * m_i, tau_0 = (G_bar W_0) * m_0.
  //    tau_L is kept in f32 and rounded nowhere: no resum.
  for (int i = 0; i < depth; ++i) {
    const uint64_t on = masks[i * NT + t];
    const bool last = i + 1 == depth;
    const SeqTerm tg = {gbuf, rmg, DMAX, p.wr_x[i], NW,
                        l1 + (3 * i + 1) * WIDTH};
    fill(acc, 0.0f);
    if (i == 0) {
      mm_wide(acc, gbuf, DMAX, d, p.wr_x[0], NW, ring);
      if (!last)
        resum<false>(acc, row0, n, tg, SeqTerm{}, on, nullptr, nullptr, list,
                     ring);
    } else {
      const bool skip = (skip_bits >> i) & 1u;
      const SeqTerm th = {buf0, rm0, WIDTH, p.wr_h[i], WIDTH,
                          l1 + 3 * i * WIDTH};
      mm_wide(acc, buf0, WIDTH, WIDTH, p.wr_h[i], WIDTH, ring);
      if (skip) mm_wide(acc, gbuf, DMAX, d, p.wr_x[i], NW, ring);
      if (!last)
        resum<false>(acc, row0, n, th, skip ? tg : SeqTerm{}, on, nullptr,
                     nullptr, list, ring);
    }
    apply_bits(acc, on);
    if (!last) {
      put_tile(buf0, acc, rm0);
      store_rows(tau_s + i * layer, row0, n, acc);
    } else {
      store_rows(tau_last, row0, n, acc);
    }
  }

  // 3. Seed of the first-order sweep:
  //    r = T_bar + [sigma_bar, n_bar] W_head^T (+ B_bar W_bn^T).
  if (has_bn) {
    load_rows(acc, bbar, row0, n);
    put_tile(buf0, acc, rm0);
  }
  load_rows(acc, tbar, row0, n);
  mm_wide(acc, hcbuf, DMAX, hcu, p.head_w, HCMAX, ring);
  if (has_bn) mm_wide(acc, buf0, WIDTH, WIDTH, p.bn_w, WIDTH, ring);
  {
    const SeqTerm th = {hcbuf, rmh, DMAX, p.head_w, HCMAX,
                        l1 + 3 * depth * WIDTH};
    const SeqTerm tb = {buf0, rm0, WIDTH, p.bn_w, WIDTH,
                        l1 + (3 * depth + 1) * WIDTH};
    resum<false, true>(acc, row0, n, th, has_bn ? tb : SeqTerm{},
                       masks[(depth - 1) * NT + t], tbar, nullptr, list,
                       ring);
  }

  // 4. Reverse sweeps in lockstep: c1_i = r_i * m_i and c_g,i = r_g,i * m_i,
  //    with r_g seeded by w_sigma; feat_bar += c1_i Wx_i^T at layer 0 and the
  //    skips; r_{i-1} = c1_i Wh_i^T, r_g,i-1 = c_g,i Wh_i^T. acc holds r,
  //    then r_g: each is summed again near its rounding, masked, stored and
  //    put in its tile (c1 in buf1, c_g in buf0) as soon as it is summed,
  //    so that one register tile serves both.
  auto emit = [&](float* dst, bf16* buf, float* rm, int i) {
    apply_bits(acc, masks[i * NT + t]);
    store_rows(dst + i * layer, row0, n, acc);
    put_tile(buf, acc, rm);
  };
  emit(c1_s, buf1, rm1, depth - 1);
  fill_columns(acc, p.head_w, HCMAX);
  emit(cg_s, buf0, rm0, depth - 1);
  bool first = true;  // feat_bar's first share is stored, later ones added
  for (int i = depth - 1; i >= 0; --i) {
    if (i == 0 || ((skip_bits >> i) & 1u)) {
      float xacc[4][4] = {};
      mm_narrow(xacc, buf1, i == 0 ? p.wf_h[0] : p.wf_x[i], d, ring);
      store_narrow(xbar, row0, n, d, xacc, !first);
      first = false;
    }
    if (i > 0) {
      const uint64_t on = masks[(i - 1) * NT + t];
      const float* l1r = l1 + (3 * i + 2) * WIDTH;
      const SeqTerm tc1 = {buf1, rm1, WIDTH, p.wf_h[i], WIDTH, l1r};
      const SeqTerm tcg = {buf0, rm0, WIDTH, p.wf_h[i], WIDTH, l1r};
      fill(acc, 0.0f);
      mm_wide(acc, buf1, WIDTH, WIDTH, p.wf_h[i], WIDTH, ring);
      resum<false>(acc, row0, n, tc1, SeqTerm{}, on, nullptr, nullptr, list,
                   ring);
      emit(c1_s, buf1, rm1, i - 1);
      fill(acc, 0.0f);
      mm_wide(acc, buf0, WIDTH, WIDTH, p.wf_h[i], WIDTH, ring);
      resum<false>(acc, row0, n, tcg, SeqTerm{}, on, nullptr, nullptr, list,
                   ring);
      emit(cg_s, buf0, rm0, i - 1);
    }
  }
}

// One grad: out[k, j] (row stride ldo) = sum over rows of
// A[row, k] C[row, j] + A2[row, k] C2[row, j], k < k_dim, j < nc; if bias
// is set, bias[j] = sum over rows of C[row, j]; if colsum is set, out[k, 0]
// also holds the sum over rows of colsum[row, k]. A and A2 are bf16 with
// row stride lda, C, C2 and colsum f32 (colsum with row stride lda). A2
// null means no second product; colsum takes A2's place.
struct WgDesc {
  const bf16* a;
  const bf16* a2;
  const float* c;
  const float* c2;
  const float* colsum;
  float* out;
  float* bias;
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

// One weight-grad stage: A and A2 [RB][TK] bf16 (swizzled), C and C2 (or
// colsum) [RB][TJ] f32. Then the bf16 tiles of C and C2, and the sums'
// partials of the four row groups.
constexpr int WG_A = RB * TK;                    // bf16 of A
constexpr int WG_STAGE_BYTES = 2 * WG_A * 2 + 2 * RB * TJ * 4;
constexpr int WG_SMEM_BYTES =
    WSTAGES * WG_STAGE_BYTES + 2 * RB * TJ * 2 + 2 * 4 * TJ * 4;

// Copies rows [rb, rb + RB) x columns [col0, col0 + 128) of a row-major
// matrix (row stride ld elements, a multiple of 16 bytes) into dst
// [RB][128], swizzled for bf16; rows at or past rend and columns at or
// past ncol are zero.
__device__ __forceinline__ void stage_rows(bf16* dst,
                                           const bf16* __restrict__ src,
                                           int ld, int col0, int ncol, int rb,
                                           int rend) {
  const int r = threadIdx.x >> 4, c = (threadIdx.x & 15) * 8;
  const int row = rb + r, col = col0 + c;
  const int valid = row < rend ? max(0, min(8, ncol - col)) : 0;
  const bf16* from = valid ? src + static_cast<size_t>(row) * ld + col : src;
  cp_async16(dst + swz(r, c, TK), from, 2 * valid);
}
__device__ __forceinline__ void stage_rows(float* dst,
                                           const float* __restrict__ src,
                                           int ld, int col0, int ncol, int rb,
                                           int rend) {
#pragma unroll
  for (int q = 0; q < RB * TJ / 4 / NT; ++q) {
    const int e = threadIdx.x + q * NT;
    const int r = e >> 5, c = (e & 31) * 4;
    const int row = rb + r, col = col0 + c;
    const int valid = row < rend ? max(0, min(4, ncol - col)) : 0;
    const float* from =
        valid ? src + static_cast<size_t>(row) * ld + col : src;
    cp_async16(dst + r * TJ + c, from, 4 * valid);
  }
}

// A block owns a 128 x 128 output tile (k x j). Warp w covers k rows
// (w / 2) * 32 .. + 32 (two m16 tiles) and j columns (w % 2) * 64 .. + 64
// (eight n8 tiles) as mma accumulators; the stage's 16 rows are the mma's
// k16. Thread t converts and sums columns 2 (t % 64) + {0, 1} of rows
// t / 64 + {0, 4, 8, 12} of each stage.
__global__ void __launch_bounds__(NT, 2) trunk_wgrad_bf16_kernel(
    const __grid_constant__ WgParams p) {
  extern __shared__ __align__(128) unsigned char wsm[];
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
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const bool two = D.a2 != nullptr;
  const bool csum = D.colsum != nullptr;
  const bool bias = D.bias != nullptr && k0 == 0;
  bf16* cb = reinterpret_cast<bf16*>(wsm + WSTAGES * WG_STAGE_BYTES);
  bf16* cb2 = cb + RB * TJ;
  float* red = reinterpret_cast<float*>(cb2 + RB * TJ);  // [2][4][TJ]

  auto a_of = [&](int s) {
    return reinterpret_cast<bf16*>(wsm + s * WG_STAGE_BYTES);
  };
  auto c_of = [&](int s) {
    return reinterpret_cast<float*>(wsm + s * WG_STAGE_BYTES + 4 * WG_A);
  };
  auto load = [&](int s, int q) {
    const int rb = rbeg + q * RB;
    bf16* a = a_of(s);
    float* c = c_of(s);
    stage_rows(a, D.a, D.lda, k0, D.k_dim, rb, rend);
    stage_rows(c, D.c, D.ldc, j0, D.nc, rb, rend);
    if (two) {
      stage_rows(a + WG_A, D.a2, D.lda, k0, D.k_dim, rb, rend);
      stage_rows(c + RB * TJ, D.c2, D.ldc, j0, D.nc, rb, rend);
    } else if (csum) {
      stage_rows(c + RB * TJ, D.colsum, D.lda, k0, D.k_dim, rb, rend);
    }
  };

  // ldmatrix.trans lanes: A^T's fragments from A [rows][k], C's from
  // [rows][j].
  const int am = ((warp >> 1) << 5) + (((lane >> 3) & 1) << 3);
  const int ar = (lane & 7) + ((lane >> 4) << 3);
  const int bj = ((warp & 1) << 6) + ((lane >> 4) << 3);
  const int br = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int cc = (t & 63) * 2, cr = t >> 6;

  float acc[2][8][4] = {};
  float bsum[2] = {}, ssum[2] = {};
#pragma unroll
  for (int s = 0; s < WSTAGES - 1; ++s) {
    if (s < nstages) load(s, s);
    cp_async_commit();
  }
  for (int q = 0; q < nstages; ++q) {
    cp_async_wait<WSTAGES - 2>();
    __syncthreads();  // stage q landed; the last step's reads of cb ended
    const int next = q + WSTAGES - 1;
    if (next < nstages) load(next % WSTAGES, next);
    cp_async_commit();
    const bf16* a = a_of(q % WSTAGES);
    const float* c = c_of(q % WSTAGES);
#pragma unroll
    for (int rr = 0; rr < RB / 4; ++rr) {
      const int r = cr + 4 * rr;
      const float2 v = *reinterpret_cast<const float2*>(c + r * TJ + cc);
      if (bias) {
        bsum[0] += v.x;
        bsum[1] += v.y;
      }
      *reinterpret_cast<unsigned*>(cb + swz(r, cc, TJ)) = pack_bf16x2(v.x, v.y);
      if (two || csum) {
        const float2 v2 =
            *reinterpret_cast<const float2*>(c + RB * TJ + r * TJ + cc);
        if (two) {
          *reinterpret_cast<unsigned*>(cb2 + swz(r, cc, TJ)) =
              pack_bf16x2(v2.x, v2.y);
        } else {
          ssum[0] += v2.x;
          ssum[1] += v2.y;
        }
      }
    }
    __syncthreads();  // cb and cb2 hold the stage's C and C2 in bf16
    // The stage's k16 step, each mma summed from zero and added in f32
    // (trunk_mma.cuh's mma_add).
    unsigned af[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      ldsm4_t(af[mt], a + swz(ar, am + mt * 16, TK));
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      unsigned bfr[4];
      ldsm4_t(bfr, cb + swz(br, bj + np * 16, TJ));
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma_add(acc[mt][2 * np], af[mt], bfr[0], bfr[1]);
        mma_add(acc[mt][2 * np + 1], af[mt], bfr[2], bfr[3]);
      }
    }
    if (two) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldsm4_t(af[mt], a + WG_A + swz(ar, am + mt * 16, TK));
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        unsigned bfr[4];
        ldsm4_t(bfr, cb2 + swz(br, bj + np * 16, TJ));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_add(acc[mt][2 * np], af[mt], bfr[0], bfr[1]);
          mma_add(acc[mt][2 * np + 1], af[mt], bfr[2], bfr[3]);
        }
      }
    }
  }

  // The four row groups' sums, added in group order.
  red[cr * TJ + cc] = bsum[0];
  red[cr * TJ + cc + 1] = bsum[1];
  red[(4 + cr) * TJ + cc] = ssum[0];
  red[(4 + cr) * TJ + cc + 1] = ssum[1];
  __syncthreads();
  float* part = p.partials + static_cast<size_t>(split) * p.per_split +
                D.part_off;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int kl =
          ((warp >> 1) << 5) + mt * 16 + (lane >> 2) + ((q >> 1) << 3);
      const int k = k0 + kl;
      if (k >= D.k_dim) continue;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int jj =
            j0 + ((warp & 1) << 6) + nt * 8 + ((lane & 3) << 1) + (q & 1);
        if (jj >= D.nc) continue;
        float v = acc[mt][nt][q];
        if (csum && jj == 0)
          v += red[4 * TJ + kl] + red[5 * TJ + kl] + red[6 * TJ + kl] +
               red[7 * TJ + kl];
        part[static_cast<size_t>(k) * D.nc + jj] = v;
      }
    }
  if (bias && t < TJ && j0 + t < D.nc)
    part[static_cast<size_t>(D.k_dim) * D.nc + j0 + t] =
        red[t] + red[TJ + t] + red[2 * TJ + t] + red[3 * TJ + t];
}

}  // namespace

// wptrs: five per layer (wf_h, wf_x, wr_h, wr_x, bias; 0 where unused; wr_x
// zero-padded to NW = 64 columns), then head_w (zero-padded to HCMAX = 8
// columns) and bn_w (0 without a bottleneck); every weight bf16, every
// bias f32. gptrs: (kernel grad, bias grad) per layer, then the
// bottleneck's (0, 0 without one), then the head's. feat and gbar have rows
// of D rounded up to 4 floats, head_cot rows of HCMAX floats (zero past
// hcu); feat16 and gbar16 are their bf16 copies with rows of D rounded up
// to 8. scratch holds (2 * depth + 1) * N * 256 floats and then
// (2 * depth - 1) * N * 256 bf16 values, partials splits * per_split
// floats, l1 (3 * depth + 2) * 256 floats (resum's weight norms, written
// here). Returns cudaGetLastError() of the launches.
extern "C" int fused_trunk_bwd_bf16(
    const float* feat, const float* head_cot, const float* tbar,
    const float* bbar, const float* gbar, const void* feat16,
    const void* gbar16, const uint64_t* wptrs, const uint64_t* gptrs, int n,
    int d, int depth, unsigned skip_bits, int hc, int hcu, int has_bn,
    int splits, long per_split, float* xbar, float* scratch, float* partials,
    float* l1, void* stream) {
  if (depth < 1 || depth > MAXD || d < 1 || d > DMAX || hc < 1 ||
      hc > HCMAX || hcu < 1 || hcu > hc || n < 1 || splits < 1 ||
      (skip_bits & 1u) || (has_bn && bbar == nullptr) || feat16 == nullptr ||
      gbar16 == nullptr || l1 == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ldx = (d + 3) & ~3, ld16 = (d + 7) & ~7;
  BwdParamsBf16 bp = {};
  for (int i = 0; i < depth; ++i) {
    bp.wf_h[i] = reinterpret_cast<const bf16*>(wptrs[5 * i]);
    bp.wf_x[i] = reinterpret_cast<const bf16*>(wptrs[5 * i + 1]);
    bp.wr_h[i] = reinterpret_cast<const bf16*>(wptrs[5 * i + 2]);
    bp.wr_x[i] = reinterpret_cast<const bf16*>(wptrs[5 * i + 3]);
    bp.b[i] = reinterpret_cast<const float*>(wptrs[5 * i + 4]);
  }
  bp.head_w = reinterpret_cast<const bf16*>(wptrs[5 * depth]);
  bp.bn_w = reinterpret_cast<const bf16*>(wptrs[5 * depth + 1]);

  // Scratch: c1 and c_g of every layer and the last tau layer in f32, then
  // h of every layer and tau of the others in bf16.
  const size_t layer = static_cast<size_t>(n) * WIDTH;
  float* c1_s = scratch;
  float* cg_s = c1_s + depth * layer;
  float* tau_last = cg_s + depth * layer;
  bf16* h_s = reinterpret_cast<bf16*>(tau_last + layer);
  bf16* tau_s = h_s + depth * layer;

  // The grads, in the order of their partials.
  const bf16* fa = static_cast<const bf16*>(feat16);
  const bf16* ga = static_cast<const bf16*>(gbar16);
  WgParams wp = {};
  int tiles = 0;
  long long off = 0;
  auto add = [&](const bf16* a, const bf16* a2, const float* c,
                 const float* c2, const float* colsum, int lda, int ldc,
                 int k_dim, int nc, float* out, int ldo, float* bias) {
    WgDesc& D = add_grad<TK, TJ>(wp, tiles, off, k_dim, nc, out, ldo, bias);
    D.a = a; D.a2 = a2; D.c = c; D.c2 = c2; D.colsum = colsum;
    D.lda = lda; D.ldc = ldc;
  };
  for (int i = 0; i < depth; ++i) {
    float* dw = reinterpret_cast<float*>(gptrs[2 * i]);
    float* db = reinterpret_cast<float*>(gptrs[2 * i + 1]);
    const float* c1 = c1_s + i * layer;
    const float* cg = cg_s + i * layer;
    if (i == 0) {
      add(fa, ga, c1, cg, nullptr, ld16, WIDTH, d, WIDTH, dw, WIDTH, db);
    } else {
      add(h_s + (i - 1) * layer, tau_s + (i - 1) * layer, c1, cg, nullptr,
          WIDTH, WIDTH, WIDTH, WIDTH, dw, WIDTH, db);
      if ((skip_bits >> i) & 1u)
        add(fa, ga, c1, cg, nullptr, ld16, WIDTH, d, WIDTH,
            dw + WIDTH * WIDTH, WIDTH, nullptr);
    }
  }
  const bf16* h_last = h_s + (depth - 1) * layer;
  if (has_bn) {
    float* dw = reinterpret_cast<float*>(gptrs[2 * depth]);
    float* db = reinterpret_cast<float*>(gptrs[2 * depth + 1]);
    add(h_last, nullptr, bbar, nullptr, nullptr, WIDTH, WIDTH, WIDTH, WIDTH,
        dw, WIDTH, db);
  }
  {
    // h_L^T [sigma_bar, n_bar], and sum_rows tau_L (f32) into column 0.
    float* dw = reinterpret_cast<float*>(gptrs[2 * depth + 2]);
    float* db = reinterpret_cast<float*>(gptrs[2 * depth + 3]);
    add(h_last, nullptr, head_cot, nullptr, tau_last, WIDTH, HCMAX, WIDTH,
        hcu, dw, hc, db);
  }
  if (off != per_split) return static_cast<int>(cudaErrorInvalidValue);
  wp.n = n;
  wp.rows_per_split = (n + splits - 1) / splits;
  wp.per_split = off;
  wp.partials = partials;

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  L1Params lp = l1_layers(depth, bp.wr_h, bp.wr_x, bp.wf_h);
  lp.w[3 * depth] = bp.head_w;
  lp.ldw[3 * depth] = HCMAX;
  lp.k[3 * depth] = hcu;
  lp.w[3 * depth + 1] = bp.bn_w;
  lp.ldw[3 * depth + 1] = lp.k[3 * depth + 1] = WIDTH;
  trunk_l1_kernel<<<3 * depth + 2, WIDTH, 0, st>>>(lp, l1);
  const int smem = sweep_bf16_smem_bytes(depth);
  cudaError_t err = cudaFuncSetAttribute(
      trunk_bwd_bf16_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  trunk_bwd_bf16_sweep_kernel<<<(n + TM - 1) / TM, NT, smem, st>>>(
      feat, head_cot, tbar, bbar, gbar, n, d, ldx, depth, skip_bits, hcu,
      has_bn, bp, l1, xbar, h_s, tau_s, tau_last, c1_s, cg_s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(trunk_wgrad_bf16_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             WG_SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  trunk_wgrad_bf16_kernel<<<dim3(tiles, splits), NT, WG_SMEM_BYTES, st>>>(wp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  trunk_wgrad_reduce_kernel<<<static_cast<unsigned>((off + 255) / 256), 256, 0,
                              st>>>(wp, splits);
  return static_cast<int>(cudaGetLastError());
}

#ifdef TRUNK_SEQ_STATS
// resum's counters since the last call (a build with -DTRUNK_SEQ_STATS).
extern "C" int trunk_bwd_bf16_seq_stats(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, seq_stats, sizeof(seq_stats));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zero[4] = {};
  return static_cast<int>(cudaMemcpyToSymbol(seq_stats, zero, sizeof(zero)));
}
#endif
