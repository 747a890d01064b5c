// Row-tile engine shared by the NeRF trunk kernels (fused_trunk_fwd.cu,
// fused_trunk_bwd.cu), f32 on the CUDA cores. Their bf16-operand mode has
// its own engine on the tensor cores, trunk_mma.cuh.
//
// A block of NT = 256 threads owns TM = 64 rows. A layer's input lives in
// shared memory as a k-major activation tile a[k * LDA + row] (a [K][LDA]
// array: 256 x 68 floats, 69,632 bytes, for a 256-wide layer); its output
// lives in registers, 8 rows x 8 columns a thread. Warp w covers rows
// (w / 4) * 32 .. + 32 and columns (w % 4) * 64 .. + 64; its lane l keeps
//   rows    (l / 8) * 4 + {0..3, 16..19} of the warp's rows,
//   columns (l % 8) * 4 + {0..3, 32..35} of the warp's columns,
// so a warp's 16-byte loads of a k step touch 32 distinct rows and 64
// distinct columns: 384 bytes of shared memory for 2,048 FMAs.
// Weights are row-major [K][256] in device memory (a wrapper passes each in
// both orientations, so the forward and the reverse sweeps both read whole
// rows). They stream through a ring of STAGES chunks in shared memory, each
// chunk KC = 16 contiguous weight rows (16 KB), copied by cp.async.cg
// 16-byte copies that bypass L1: while the block multiplies chunk c, the
// copies of chunks c + 1 and c + 2 are in flight. So each weight element
// crosses from L2 into shared memory once a block and feeds all 64 rows of
// the tile from there. Per k step a thread makes four 16-byte shared loads
// (its 8 rows and its 8 weight columns) for 64 FMAs, which keeps the loop
// on the FMA pipes.
//
// Narrow products (the σ/normal head, g and feat_bar, <= 64 columns) read
// weights zero-padded by the wrapper to NW = 64 columns, 64 rows a chunk,
// through the same ring, with a 4 x 4 register tile a thread.
//
// Relu masks are bits: a thread's 64 outputs of one layer are one uint64,
// bit i * 8 + j for register row i and column j, so a layer's masks take
// NT * 8 = 2 KB of shared memory and each thread reads back only its own.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "trunk_common.cuh"

namespace {

constexpr int TM = 64;             // rows per block
constexpr int WIDTH = 256;         // trunk width
constexpr int NT = 256;            // threads per block
constexpr int DMAX = 64;           // most feature channels supported
constexpr int HCMAX = 8;           // most head channels supported
constexpr int LDA = TM + 4;        // padded k-row of an activation tile
constexpr int KC = 16;             // weight rows in a wide chunk
constexpr int NW = 64;             // columns of a narrow (padded) weight
constexpr int KCN = KC * WIDTH / NW;  // weight rows in a narrow chunk
constexpr int STAGES = 3;          // chunks in the ring
constexpr int CHUNK = KC * WIDTH;  // floats in a ring stage
constexpr int TILE_FLOATS = WIDTH * LDA;  // one [256][LDA] activation tile
constexpr int XTILE_FLOATS = DMAX * LDA;  // one [DMAX][LDA] input tile
constexpr int RING_FLOATS = STAGES * CHUNK;
constexpr int MASK_BYTES = NT * 8;        // one layer's relu bits

// Four consecutive elements as floats, and back.
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
// One element, read through the read-only cache.
__device__ __forceinline__ float ldg_f(const float* p) { return __ldg(p); }

// Runs nchunks chunks through the ring (trunk_common.cuh's ring_pipeline).
template <class Load, class Compute>
__device__ __forceinline__ void run_ring(float* ring, int nchunks, Load load,
                                         Compute compute) {
  ring_pipeline<STAGES, CHUNK>(ring, nchunks, load, compute);
}

// Rows [k0, k0 + KC) of a row-major [k_dim][256] weight; rows past k_dim are
// zero-filled.
__device__ __forceinline__ void stage_wide(float* st,
                                           const float* __restrict__ w,
                                           int k0, int k_dim) {
  constexpr int EPP = 16 / sizeof(float);  // elements a 16-byte piece
  constexpr int PER_ROW = WIDTH / EPP;
#pragma unroll
  for (int q = 0; q < CHUNK / EPP / NT; ++q) {
    const int e = threadIdx.x + q * NT;  // 16-byte piece of the chunk
    const int kk = e / PER_ROW, c = (e % PER_ROW) * EPP;
    const int k = k0 + kk;
    const float* src = w + static_cast<size_t>(min(k, k_dim - 1)) * WIDTH + c;
    cp_async16(st + kk * WIDTH + c, src, k < k_dim ? 16 : 0);
  }
}

// Rows [k0, k0 + KCN) of a row-major [k_dim][NW] weight, zero past k_dim.
__device__ __forceinline__ void stage_narrow(float* st,
                                             const float* __restrict__ w,
                                             int k0, int k_dim) {
  constexpr int EPP = 16 / sizeof(float);
  constexpr int PER_ROW = NW / EPP;
#pragma unroll
  for (int q = 0; q < CHUNK / EPP / NT; ++q) {
    const int e = threadIdx.x + q * NT;
    const int kk = e / PER_ROW, c = (e % PER_ROW) * EPP;
    const int k = k0 + kk;
    const float* src = w + static_cast<size_t>(min(k, k_dim - 1)) * NW + c;
    cp_async16(st + kk * NW + c, src, k < k_dim ? 16 : 0);
  }
}

// First tile row and column of the thread's register tile (see above).
__device__ __forceinline__ int row_base() {
  return ((threadIdx.x >> 7) << 5) + (((threadIdx.x >> 3) & 3) << 2);
}
__device__ __forceinline__ int col_base() {
  return (((threadIdx.x >> 5) & 3) << 6) + ((threadIdx.x & 7) << 2);
}

__device__ __forceinline__ void fma_8x8(float (&acc)[8][8], const float4 a0,
                                        const float4 a1, const float4 b0,
                                        const float4 b1) {
  const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
}

// acc += A[:, 0:k_dim] @ W[0:k_dim, :], summed in k order. A is a k-major
// tile whose rows up to k_dim rounded up to KC are finite (zero past
// k_dim); W is [k_dim][256] in device memory.
__device__ __forceinline__ void mm_wide(float (&acc)[8][8], const float* a,
                                        int k_dim,
                                        const float* __restrict__ w,
                                        float* ring) {
  const int r0 = row_base(), c0 = col_base();
  run_ring(
      ring, (k_dim + KC - 1) / KC,
      [&](float* st, int c) { stage_wide(st, w, c * KC, k_dim); },
      [&](const float* st, int c) {
        const float* ak = a + c * KC * LDA + r0;
#pragma unroll
        for (int kk = 0; kk < KC; ++kk) {
          const float4 a0 = ld4(ak + kk * LDA);
          const float4 a1 = ld4(ak + kk * LDA + 16);
          const float4 b0 = ld4(st + kk * WIDTH + c0);
          const float4 b1 = ld4(st + kk * WIDTH + 32 + c0);
          fma_8x8(acc, a0, a1, b0, b1);
        }
      });
}

// acc[4][4] += A[:, 0:k_dim] @ W[0:k_dim, 0:NW] for a narrow weight
// zero-padded to NW columns. Thread t: rows (t / 16) * 4 + {0..3}, columns
// (t % 16) * 4 + {0..3}.
__device__ __forceinline__ void mm_narrow(float (&acc)[4][4], const float* a,
                                          int k_dim,
                                          const float* __restrict__ w,
                                          float* ring) {
  const int r0 = (threadIdx.x >> 4) * 4, c0 = (threadIdx.x & 15) * 4;
  run_ring(
      ring, (k_dim + KCN - 1) / KCN,
      [&](float* st, int c) { stage_narrow(st, w, c * KCN, k_dim); },
      [&](const float* st, int c) {
        const float* ak = a + c * KCN * LDA + r0;
#pragma unroll 16
        for (int kk = 0; kk < KCN; ++kk) {
          const float4 a4 = ld4(ak + kk * LDA);
          const float4 b4 = ld4(st + kk * NW + c0);
          const float av[4] = {a4.x, a4.y, a4.z, a4.w};
          const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
      });
}

// The thread's tile row of register row i, and column of register column j.
__device__ __forceinline__ int tile_row(int i) {
  return row_base() + (i & 3) + (i >> 2) * 16;
}
__device__ __forceinline__ int tile_col(int j) {
  return col_base() + (j & 3) + (j >> 2) * 32;
}

__device__ __forceinline__ void fill_tile(float (&v)[8][8], float x) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) v[i][j] = x;
}

// v[i][j] = vec[column j] for every row (a bias, or the w_sigma seed).
__device__ __forceinline__ void fill_columns(float (&v)[8][8],
                                             const float* __restrict__ vec,
                                             int stride) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float x = ldg_f(vec + static_cast<size_t>(tile_col(j)) * stride);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i][j] = x;
  }
}

// Writes the thread's registers into a k-major [256][LDA] tile (column c of
// the layer output is row c of the next layer's input).
__device__ __forceinline__ void put_tile(float* __restrict__ buf,
                                         const float (&v)[8][8]) {
  const int r0 = row_base();
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float* p = buf + tile_col(j) * LDA + r0;
    st4(p, make_float4(v[0][j], v[1][j], v[2][j], v[3][j]));
    st4(p + 16, make_float4(v[4][j], v[5][j], v[6][j], v[7][j]));
  }
}

// Stores the thread's registers to rows row0 + .. of a row-major [N][256]
// matrix, skipping rows past n.
__device__ __forceinline__ void store_rows(float* __restrict__ dst, int row0,
                                           int n, const float (&v)[8][8]) {
  const int c0 = col_base();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gr = row0 + tile_row(i);
    if (gr < n) {
      float* p = dst + static_cast<size_t>(gr) * WIDTH + c0;
      st4(p, make_float4(v[i][0], v[i][1], v[i][2], v[i][3]));
      st4(p + 32, make_float4(v[i][4], v[i][5], v[i][6], v[i][7]));
    }
  }
}

// Loads rows row0 + .. of a row-major [N][256] matrix, zero past n.
__device__ __forceinline__ void load_rows(float (&v)[8][8],
                                          const float* __restrict__ src,
                                          int row0, int n) {
  const int c0 = col_base();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gr = row0 + tile_row(i);
    float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
    if (gr < n) {
      const float* p = src + static_cast<size_t>(gr) * WIDTH + c0;
      lo = __ldg(reinterpret_cast<const float4*>(p));
      hi = __ldg(reinterpret_cast<const float4*>(p + 32));
    }
    v[i][0] = lo.x; v[i][1] = lo.y; v[i][2] = lo.z; v[i][3] = lo.w;
    v[i][4] = hi.x; v[i][5] = hi.y; v[i][6] = hi.z; v[i][7] = hi.w;
  }
}

// Relu in place; returns the thread's mask bits (bit i * 8 + j: v[i][j] > 0).
__device__ __forceinline__ uint64_t relu_bits(float (&v)[8][8]) {
  uint64_t bits = 0ull;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const bool on = v[i][j] > 0.0f;
      bits |= static_cast<uint64_t>(on) << (i * 8 + j);
      v[i][j] = on ? v[i][j] : 0.0f;
    }
  return bits;
}

// v *= mask, for the thread's bits of one layer.
__device__ __forceinline__ void apply_bits(float (&v)[8][8], uint64_t bits) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (!((bits >> (i * 8 + j)) & 1ull)) v[i][j] = 0.0f;
}

// A k-major [DMAX][LDA] tile of rows row0 .. row0 + TM of a row-major
// [N][ld] matrix's first d columns; zero past n and for k >= d.
__device__ __forceinline__ void load_narrow_tile(float* __restrict__ buf,
                                                 const float* __restrict__ src,
                                                 int ld, int d, int kmax,
                                                 int row0, int n) {
  for (int e = threadIdx.x; e < TM * kmax; e += NT) {
    const int r = e / kmax, c = e - r * kmax;
    const int gr = row0 + r;
    buf[c * LDA + r] =
        (gr < n && c < d) ? __ldg(src + static_cast<size_t>(gr) * ld + c)
                          : 0.0f;
  }
}

// Stores a narrow [TM][<= NW] register tile (mm_narrow's layout) to
// columns < d of rows row0 + .. of a row-major [N][d] matrix.
__device__ __forceinline__ void store_narrow(float* __restrict__ dst, int row0,
                                             int n, int d,
                                             const float (&v)[4][4]) {
  const int r0 = (threadIdx.x >> 4) * 4, c0 = (threadIdx.x & 15) * 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = row0 + r0 + i;
    if (gr >= n) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c0 + j < d) dst[static_cast<size_t>(gr) * d + c0 + j] = v[i][j];
  }
}

}  // namespace
