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
// output per row: far above the f32 CUDA-core ridge (7.6 ms at 67 TFLOP/s
// for a 524,288-row render chunk).
//
// Design: the trunk kernels' row-tile engine (trunk_tile.cuh). A block of
// 256 threads owns 64 rows. A layer's input h lives in shared memory as a
// k-major [256][68] activation tile and its output in registers; the
// layer's weight streams through the 3-stage cp.async.cg ring, so each
// weight element crosses from L2 into shared memory once a block and feeds
// all 64 rows from there. The layer's bias rides in the same cp.async
// groups into one of two bias slots in shared memory, so the epilogue
// (bias add, activation, the tile or out written) reads it there and does
// not wait on L2 (an __ldg in the epilogue cost 2-4% of K3's time on
// nerf_ds()'s stacks on an H100). The register tile follows the layer's
// width, which the wrapper pads with zero columns to W = 256, 128 or 64
// (or 16 for the last layer): 8 x 8, 8 x 4, 4 x 4 or 1 x 4 outputs a
// thread, so a 128-wide layer costs half the FMAs of a 256-wide one. A ring
// chunk of a product with h holds KC = 4096 / W weight rows (at most 64),
// so every chunk feeds the block the same 262,144 FMAs. x is not kept in
// shared memory: at layer 0 and at each skip layer its k-chunks stream
// through a second ring, beside the weight chunk of the same k rows (at
// most 32), as row-major [64][KC + 4] pieces read from L2 (64 x c_in x 4
// bytes a block a pass). So x may be 1024 channels wide while the block's
// shared memory stays fixed.
//
// Two instantiations: a stack with a 256-wide layer takes the 8 x 8 tile's
// 255 registers and a 256-row activation tile, so one block an SM; every
// narrower stack (the mask MLP, the SE(3) trunk, the hyper sheet, the rgb
// branch, the heads) runs a second one limited to 128 registers and a
// 128-row tile, two blocks an SM, so one block's pipeline fill at the start
// of each short layer overlaps the other's FMAs.
//
// Padded columns: a hidden layer's padded columns hold act(0), which is not
// 0 for sigmoid (0.5) or softplus (ln 2). They are harmless because each
// product reads k_dim = the previous layer's true width and the ring
// zero-fills weight rows past k_dim; and the last layer writes only its
// true columns. Every hidden width class (64, 128, 256) is a multiple of
// every KC, so a product never reads a tile row that no layer wrote; the
// 16-wide class is for the last layer alone.
//
// Numerics as the first version of this kernel: each output starts at 0,
// sums h's rows and then, at a skip, x's rows, in k order in f32; then the
// bias add and the activation. bf16 compute (round_bf16 = 1) rounds where
// the TPU kernel's .astype puts a bf16: the input (the wrapper passes x,
// the weights and the biases already rounded), each layer's sum after the
// f32 accumulation, the bias add, and the activation. Products are exact in
// f32 and summed in f32. No tensor cores.
//
// Shared memory a block (8 warps):
//                    256-wide stacks   narrower stacks
//   activation tile  [256][68] f32     [128][68] f32     69,632 / 34,816 B
//   weight ring      3 x 4096 f32                        49,152 B
//   input ring       3 x 64 x 36 f32                     27,648 B
//   bias slots       2 x 256 f32       2 x 128 f32       2,048 / 1,024 B
//   total            148,480 B (1 block an SM)   112,640 B (2 blocks an SM)
// of the 232,448 B a block and 233,472 B an SM may use (1 KB of it
// reserved a block).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "trunk_tile.cuh"

namespace {

constexpr int MAXL = 17;      // most layers: 16 hidden + the output layer
constexpr int WMAX = 256;     // widest layer output supported
constexpr int CIN_MAX = 1024; // widest input supported
constexpr int KCMAX = 64;     // most weight rows in a ring chunk
constexpr int KCX = 32;       // most rows in a chunk of a product with x
constexpr int HEADW = 16;     // the last layer's narrowest width class
constexpr int NARROW = 128;   // widest layer of the narrow instantiation
constexpr int XSTAGE = TM * (KCX + 4);  // floats of an input-ring stage

// Shared memory of an instantiation whose widest layer is wmax columns.
__host__ __device__ constexpr int smem_bytes(int wmax) {
  return (wmax * LDA + RING_FLOATS + STAGES * XSTAGE + 2 * wmax) * 4;
}

enum Act { kNone = 0, kRelu = 1, kSigmoid = 2, kSoftplus = 3, kTanh = 4 };

struct MlpParams {
  const float* w[MAXL];  // [rows, W] row-major: the model's kernel, zero-padded columns
  const float* b[MAXL];  // [W], zero-padded
  int cols[MAXL];        // true output columns
  int wpad[MAXL];        // W: 256, 128, 64, or 16 (last layer only)
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

// The register tile of a layer padded to W columns: RM rows x RN columns a
// thread; row(i) and col(j) are the tile row and column of register (i, j).
// Rows come in runs of 4 (RM = 8: a second run 16 rows on), columns in runs
// of 4 (RN = 8: a second run 32 columns on), so each run is one 16-byte
// shared-memory access.
template <int W> struct Tile;
// 256: the engine's layout; a warp covers 32 rows x 64 columns.
template <> struct Tile<256> {
  static constexpr int RM = 8, RN = 8;
  static __device__ int row(int i) { return row_base() + (i & 3) + (i >> 2) * 16; }
  static __device__ int col(int j) { return col_base() + (j & 3) + (j >> 2) * 32; }
};
// 128: rows as at 256; a warp covers 32 rows x 32 columns.
template <> struct Tile<128> {
  static constexpr int RM = 8, RN = 4;
  static __device__ int row(int i) { return row_base() + (i & 3) + (i >> 2) * 16; }
  static __device__ int col(int j) {
    return (((threadIdx.x >> 5) & 3) << 5) + ((threadIdx.x & 7) << 2) + j;
  }
};
// 64: mm_narrow's layout, 16 threads across the columns.
template <> struct Tile<64> {
  static constexpr int RM = 4, RN = 4;
  static __device__ int row(int i) { return ((threadIdx.x >> 4) << 2) + i; }
  static __device__ int col(int j) { return ((threadIdx.x & 15) << 2) + j; }
};
// 16 (the last layer only): one row, 4 columns a thread.
template <> struct Tile<HEADW> {
  static constexpr int RM = 1, RN = 4;
  static __device__ int row(int) { return threadIdx.x >> 2; }
  static __device__ int col(int j) { return ((threadIdx.x & 3) << 2) + j; }
};

// Weight rows a ring chunk holds at width W: of a product with h, and of a
// product with x.
template <int W> __host__ __device__ constexpr int kc_of() {
  return CHUNK / W < KCMAX ? CHUNK / W : KCMAX;
}
template <int W> __host__ __device__ constexpr int kcx_of() {
  return kc_of<W>() < KCX ? kc_of<W>() : KCX;
}

template <int W>
using Acc = float[Tile<W>::RM][Tile<W>::RN];

template <int W>
__device__ __forceinline__ void fma_tile(Acc<W>& acc,
                                         const float (&av)[Tile<W>::RM],
                                         const float (&bv)[Tile<W>::RN]) {
#pragma unroll
  for (int i = 0; i < Tile<W>::RM; ++i)
#pragma unroll
    for (int j = 0; j < Tile<W>::RN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
}

// The thread's RN weights of row k of a chunk (bk = the row).
template <int W>
__device__ __forceinline__ void b_row(float (&bv)[Tile<W>::RN],
                                      const float* bk) {
#pragma unroll
  for (int g = 0; g < Tile<W>::RN / 4; ++g) {
    const float4 v = *reinterpret_cast<const float4*>(bk + Tile<W>::col(4 * g));
    bv[4 * g] = v.x; bv[4 * g + 1] = v.y; bv[4 * g + 2] = v.z; bv[4 * g + 3] = v.w;
  }
}

// Rows [k0, k0 + kc) of a row-major [k_dim][W] weight; rows past k_dim are
// zero-filled.
template <int W, int kc>
__device__ __forceinline__ void stage_w(float* st, const float* __restrict__ w,
                                        int k0, int k_dim) {
  constexpr int per_row = W / 4, pieces = kc * per_row;
#pragma unroll
  for (int q = 0; q < (pieces + NT - 1) / NT; ++q) {
    const int e = threadIdx.x + q * NT;  // 16-byte piece of the chunk
    if (pieces % NT && e >= pieces) break;  // a 16-wide chunk of x's rows
    const int kk = e / per_row, c4 = e % per_row;
    const int k = k0 + kk;
    const float* src = w + static_cast<size_t>(min(k, k_dim - 1)) * W + c4 * 4;
    cp_async16(st + kk * W + c4 * 4, src, k < k_dim ? 16 : 0);
  }
}

// Columns [k0, k0 + KC) of rows row0 .. row0 + TM of x (row stride ldx, a
// multiple of 4, zero past c_in) into a row-major [TM][KC + 4] stage; zero
// past n and past ldx.
template <int KC>
__device__ __forceinline__ void stage_x(float* xs, const float* __restrict__ x,
                                        int ldx, int k0, int row0, int n) {
  constexpr int per_row = KC / 4;
#pragma unroll
  for (int q = 0; q < TM * per_row / NT; ++q) {
    const int e = threadIdx.x + q * NT;
    const int r = e / per_row, kk = (e % per_row) * 4;
    const int gr = row0 + r, k = k0 + kk;
    const bool ok = gr < n && k < ldx;
    const float* src = ok ? x + static_cast<size_t>(gr) * ldx + k : x;
    cp_async16(xs + r * (KC + 4) + kk, src, ok ? 16 : 0);
  }
}

// acc += H[:, 0:k_dim] @ W[0:k_dim, :] for the k-major activation tile h.
template <int W>
__device__ __forceinline__ void mm_h(Acc<W>& acc, const float* h, int k_dim,
                                     const float* __restrict__ w, float* ring) {
  constexpr int kc = kc_of<W>(), RM = Tile<W>::RM;
  run_ring(
      ring, (k_dim + kc - 1) / kc,
      [&](float* st, int c) { stage_w<W, kc>(st, w, c * kc, k_dim); },
      [&](const float* st, int c) {
        const float* hk = h + c * kc * LDA;
#pragma unroll 16
        for (int kk = 0; kk < kc; ++kk) {
          float av[RM], bv[Tile<W>::RN];
#pragma unroll
          for (int g = 0; g < (RM + 3) / 4; ++g) {
            const float* p = hk + kk * LDA + Tile<W>::row(4 * g);
            if constexpr (RM == 1) {
              av[0] = *p;
            } else {
              const float4 v = *reinterpret_cast<const float4*>(p);
              av[4 * g] = v.x; av[4 * g + 1] = v.y; av[4 * g + 2] = v.z;
              av[4 * g + 3] = v.w;
            }
          }
          b_row<W>(bv, st + kk * W);
          fma_tile<W>(acc, av, bv);
        }
      });
}

// acc += X[:, 0:c_in] @ W[0:c_in, :], x's k-chunks staged in the input ring
// (stage c % STAGES holds chunk c, as in run_ring's weight ring).
template <int W>
__device__ __forceinline__ void mm_x(Acc<W>& acc, const float* __restrict__ x,
                                     int ldx, int c_in, int row0, int n,
                                     const float* __restrict__ w, float* ring,
                                     float* xring) {
  constexpr int kc = kcx_of<W>(), RM = Tile<W>::RM;
  run_ring(
      ring, (c_in + kc - 1) / kc,
      [&](float* st, int c) {
        stage_w<W, kc>(st, w, c * kc, c_in);
        stage_x<kc>(xring + (c % STAGES) * XSTAGE, x, ldx, c * kc, row0, n);
      },
      [&](const float* st, int c) {
        const float* xs = xring + (c % STAGES) * XSTAGE;
#pragma unroll
        for (int k4 = 0; k4 < kc; k4 += 4) {
          float4 xa[RM];
#pragma unroll
          for (int i = 0; i < RM; ++i)
            xa[i] = *reinterpret_cast<const float4*>(
                xs + Tile<W>::row(i) * (kc + 4) + k4);
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            float av[RM], bv[Tile<W>::RN];
#pragma unroll
            for (int i = 0; i < RM; ++i)
              av[i] = s == 0 ? xa[i].x : s == 1 ? xa[i].y : s == 2 ? xa[i].z : xa[i].w;
            b_row<W>(bv, st + (k4 + s) * W);
            fma_tile<W>(acc, av, bv);
          }
        }
      });
}

// Writes the thread's registers into the k-major activation tile (column c
// of the layer output is row c of the next layer's input).
template <int W>
__device__ __forceinline__ void put_h(float* __restrict__ h, const Acc<W>& v) {
  constexpr int RM = Tile<W>::RM;
#pragma unroll
  for (int j = 0; j < Tile<W>::RN; ++j) {
    float* p = h + Tile<W>::col(j) * LDA;
#pragma unroll
    for (int g = 0; g < (RM + 3) / 4; ++g) {
      if constexpr (RM == 1) {
        p[Tile<W>::row(0)] = v[0][j];
      } else {
        *reinterpret_cast<float4*>(p + Tile<W>::row(4 * g)) = make_float4(
            v[4 * g][j], v[4 * g + 1][j], v[4 * g + 2][j], v[4 * g + 3][j]);
      }
    }
  }
}

// Stores columns < cols of the thread's registers to rows row0 + .. below n
// of the row-major [N][cols] output; 16-byte stores where cols % 4 == 0.
template <int W>
__device__ __forceinline__ void store_out(float* __restrict__ out, int row0,
                                          int n, int cols, const Acc<W>& v) {
  const bool vec = (cols & 3) == 0;
#pragma unroll
  for (int i = 0; i < Tile<W>::RM; ++i) {
    const int gr = row0 + Tile<W>::row(i);
    if (gr >= n) continue;
#pragma unroll
    for (int g = 0; g < Tile<W>::RN / 4; ++g) {
      const int c = Tile<W>::col(4 * g);
      float* dst = out + static_cast<size_t>(gr) * cols + c;
      if (vec && c + 4 <= cols) {
        *reinterpret_cast<float4*>(dst) = make_float4(
            v[i][4 * g], v[i][4 * g + 1], v[i][4 * g + 2], v[i][4 * g + 3]);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (c + u < cols) dst[u] = v[i][4 * g + u];
      }
    }
  }
}

// Issues the copy of layer l's bias (wpad floats) into slot l % 2 of the
// [2][wmax] bias slots. The next cp.async commit, the first product's
// first, takes it along, so the products' barriers publish it before the
// epilogue; the slot's last reader, the layer two before, is a ring
// barrier or more behind.
__device__ __forceinline__ void stage_bias(const MlpParams& p, int l,
                                           float* bias_s, int wmax) {
  if (static_cast<int>(threadIdx.x) < p.wpad[l] / 4)
    cp_async16(bias_s + (l & 1) * wmax + 4 * threadIdx.x,
               p.b[l] + 4 * threadIdx.x, 16);
}

// One Dense layer of the tile at padded width W: reads h (k_cur rows) or,
// at layer 0, x; at a skip layer x again; then bias, activation, and either
// the activation tile or, for the last layer, out.
template <int W>
__device__ __forceinline__ void layer(const MlpParams& p, int l, int k_cur,
                                      float* h, const float* __restrict__ x,
                                      int ldx, int c_in, int row0, int n,
                                      float* ring, float* xring,
                                      float* bias_s, int wmax, int rnd,
                                      bool last, float* __restrict__ out) {
  Acc<W> acc;
#pragma unroll
  for (int i = 0; i < Tile<W>::RM; ++i)
#pragma unroll
    for (int j = 0; j < Tile<W>::RN; ++j) acc[i][j] = 0.0f;
  stage_bias(p, l, bias_s, wmax);
  const float* w = p.w[l];
  if (l == 0) mm_x<W>(acc, x, ldx, c_in, row0, n, w, ring, xring);
  else mm_h<W>(acc, h, k_cur, w, ring);
  if (p.skip[l])
    mm_x<W>(acc, x, ldx, c_in, row0, n,
            w + static_cast<size_t>(l == 0 ? c_in : k_cur) * W, ring, xring);
  const int act = p.act[l];
#pragma unroll
  for (int j = 0; j < Tile<W>::RN; ++j) {
    const float b = bias_s[(l & 1) * wmax + Tile<W>::col(j)];
#pragma unroll
    for (int i = 0; i < Tile<W>::RM; ++i) {
      float v = acc[i][j];
      if (rnd) v = round_bf16(round_bf16(v) + b);
      else v = v + b;
      v = activate(v, act);
      acc[i][j] = rnd ? round_bf16(v) : v;
    }
  }
  // Every read of h ended at the products' last barrier; the next layer's
  // first barrier publishes these writes.
  if (last) store_out<W>(out, row0, n, p.cols[l], acc);
  else put_h<W>(h, acc);
}

// WIDE: the stack has a 256-wide layer (see the note above).
template <bool WIDE>
__global__ void __launch_bounds__(NT, WIDE ? 1 : 2) fused_mlp_fwd_kernel(
    const float* __restrict__ x, int n, int c_in, int ldx, int num_layers,
    int rnd, const __grid_constant__ MlpParams p, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* h = smem;                                   // [wmax][LDA]
  float* ring = h + (WIDE ? WIDTH : NARROW) * LDA;   // [STAGES][CHUNK]
  float* xring = ring + RING_FLOATS;                 // [STAGES][TM][KCX + 4]
  constexpr int wmax = WIDE ? WIDTH : NARROW;
  float* bias_s = xring + STAGES * XSTAGE;           // [2][wmax]
  const int row0 = blockIdx.x * TM;
  int k_cur = c_in;
  for (int l = 0; l < num_layers; ++l) {
    const bool last = l == num_layers - 1;
    switch (p.wpad[l]) {
      case 256:
        if constexpr (WIDE)
          layer<256>(p, l, k_cur, h, x, ldx, c_in, row0, n, ring, xring,
                     bias_s, wmax, rnd, last, out);
        break;
      case 128:
        layer<128>(p, l, k_cur, h, x, ldx, c_in, row0, n, ring, xring,
                   bias_s, wmax, rnd, last, out);
        break;
      case 64:
        layer<64>(p, l, k_cur, h, x, ldx, c_in, row0, n, ring, xring,
                  bias_s, wmax, rnd, last, out);
        break;
      default:
        layer<HEADW>(p, l, k_cur, h, x, ldx, c_in, row0, n, ring, xring,
                     bias_s, wmax, rnd, last, out);
    }
    k_cur = p.cols[l];
  }
}

}  // namespace

// x: [n][ldx] row-major, ldx a multiple of 4 >= c_in, zero past c_in, 16-byte
// aligned. ptrs: (w, b) per layer; dims: (cols, W, skip, act) per layer.
// Returns cudaGetLastError() of the launch.
extern "C" int fused_mlp_fwd(const float* x, int n, int c_in, int ldx,
                             const uint64_t* ptrs, const int* dims,
                             int num_layers, int round_bf16, float* out,
                             void* stream) {
  if (n < 1 || c_in < 1 || c_in > CIN_MAX || ldx < c_in || ldx % 4 ||
      num_layers < 1 || num_layers > MAXL)
    return static_cast<int>(cudaErrorInvalidValue);
  MlpParams p = {};
  bool wide = false;
  for (int l = 0; l < num_layers; ++l) {
    p.w[l] = reinterpret_cast<const float*>(ptrs[2 * l]);
    p.b[l] = reinterpret_cast<const float*>(ptrs[2 * l + 1]);
    p.cols[l] = dims[4 * l];
    p.wpad[l] = dims[4 * l + 1];
    p.skip[l] = dims[4 * l + 2];
    p.act[l] = dims[4 * l + 3];
    const int w = p.wpad[l];
    const bool last = l == num_layers - 1;
    if (!(w == 256 || w == 128 || w == 64 || (w == HEADW && last)) ||
        p.cols[l] < 1 || p.cols[l] > w || w > WMAX)
      return static_cast<int>(cudaErrorInvalidValue);
    wide = wide || w > NARROW;
  }
  const auto kernel =
      wide ? fused_mlp_fwd_kernel<true> : fused_mlp_fwd_kernel<false>;
  const int smem = smem_bytes(wide ? WIDTH : NARROW);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n + TM - 1) / TM;
  kernel<<<blocks, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      x, n, c_in, ldx, num_layers, round_bf16, p, out);
  return static_cast<int>(cudaGetLastError());
}
