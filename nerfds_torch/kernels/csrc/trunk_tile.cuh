// Row-tile helpers shared by the NeRF trunk kernels (fused_trunk_fwd.cu,
// fused_trunk_bwd.cu): a block of NT threads owns TM rows of a 256-wide
// layer, kept in shared memory as padded [TM][LDH] or [TM][LDX] tiles.
#pragma once
#include <cuda_runtime.h>

namespace {

constexpr int TM = 32;         // rows per block
constexpr int WIDTH = 256;     // trunk width
constexpr int NT = 256;        // threads per block
constexpr int DMAX = 64;       // most feature channels supported
constexpr int HCMAX = 8;       // most head channels supported
constexpr int LDH = WIDTH + 4; // padded row of the activation tile
constexpr int LDX = DMAX + 4;  // padded row of the input tile

// acc[4][8] += A[r0:r0+4, 0:K] @ B[0:K, c0:c0+8], B row-major with 256
// columns. Thread t: c0 = (t % 32) * 8, r0 = (t / 32) * 4, so a warp shares
// its rows (shared-memory broadcast) and reads one contiguous B row.
__device__ __forceinline__ void mm_wide(float (&acc)[4][8],
                                        const float* __restrict__ a_tile,
                                        int lda, int k_dim,
                                        const float* __restrict__ b_mat) {
  const int c0 = (threadIdx.x & 31) * 8;
  const int r0 = (threadIdx.x >> 5) * 4;
  const float* a = a_tile + r0 * lda;
  const float* b = b_mat + c0;
#pragma unroll 4
  for (int k = 0; k < k_dim; ++k) {
    const float4 b0 = __ldg(reinterpret_cast<const float4*>(
        b + static_cast<size_t>(k) * WIDTH));
    const float4 b1 = __ldg(reinterpret_cast<const float4*>(
        b + static_cast<size_t>(k) * WIDTH + 4));
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float av = a[r * lda + k];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[r][j] = fmaf(av, bv[j], acc[r][j]);
    }
  }
}

// acc[8] += A[row, 0:K] @ B[0:K, c0:c0+8] for a narrow B with nc <= 64
// columns (row-major, nc per row). Thread t: c0 = (t % 8) * 8, row = t / 8.
__device__ __forceinline__ void mm_narrow(float (&acc)[8],
                                          const float* __restrict__ a_tile,
                                          int lda, int k_dim,
                                          const float* __restrict__ b_mat,
                                          int nc) {
  const int c0 = (threadIdx.x & 7) * 8;
  const int row = threadIdx.x >> 3;
  if (c0 >= nc) return;
  const float* a = a_tile + row * lda;
  for (int k = 0; k < k_dim; ++k) {
    const float av = a[k];
    const float* b = b_mat + static_cast<size_t>(k) * nc + c0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (c0 + j < nc) acc[j] = fmaf(av, __ldg(b + j), acc[j]);
    }
  }
}

}  // namespace
