// What the NeRF trunk kernels' two engines share (trunk_tile.cuh, f32 on
// the CUDA cores; trunk_mma.cuh, bf16 on the tensor cores): the cp.async
// copies and the ring that streams weights through shared memory, and the
// layout and the reduction of the backward's weight-grad partials.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Runs nchunks chunks through a ring of STAGES chunks of CHUNK elements:
// load(stage, c) issues the copies of chunk c, compute(stage, c) consumes
// it. Entry needs the ring free (every run ends with a barrier); the first
// barrier inside also publishes what the threads wrote to the activation
// tiles before the call.
template <int STAGES, int CHUNK, class T, class Load, class Compute>
__device__ __forceinline__ void ring_pipeline(T* ring, int nchunks, Load load,
                                              Compute compute) {
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nchunks) load(ring + s * CHUNK, s);
    cp_async_commit();
  }
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of chunk c landed
    __syncthreads();              // everyone's landed; chunk c-1 is consumed
    const int next = c + STAGES - 1;
    if (next < nchunks) load(ring + (next % STAGES) * CHUNK, next);
    cp_async_commit();
    compute(ring + (c % STAGES) * CHUNK, c);
  }
  __syncthreads();
}

// The backward's weight grads. Each grad has a descriptor in Params::desc
// (its operands, out [k_dim][ldo], bias [nc] or null); a block of the
// weight-grad kernel owns a TK x TJ tile of one grad and one slice of the
// rows, and writes its partial sums to partials [splits][per_split]: a
// grad's k_dim x nc kernel entries, then its nc bias entries if it has
// them, at part_off within a split.

// Appends a grad's descriptor: its tiles from `tiles` on, its partials from
// `off` on (both advanced past it). The caller sets its operands.
template <int TK, int TJ, class Params>
inline auto& add_grad(Params& wp, int& tiles, long long& off, int k_dim,
                      int nc, float* out, int ldo, float* bias) {
  auto& D = wp.desc[wp.ndesc++];
  D.out = out;
  D.bias = bias;
  D.k_dim = k_dim;
  D.nc = nc;
  D.ldo = ldo;
  D.tile_begin = tiles;
  D.j_tiles = (nc + TJ - 1) / TJ;
  D.part_off = off;
  tiles += ((k_dim + TK - 1) / TK) * D.j_tiles;
  off += static_cast<long long>(k_dim) * nc + (bias ? nc : 0);
  return D;
}

// out = sum of the splits' partials, in split order: no atomics, so two
// launches on the same inputs give the same bits.
template <class Params>
__global__ void trunk_wgrad_reduce_kernel(const __grid_constant__ Params p,
                                          int splits) {
  const long long e =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= p.per_split) return;
  int di = 0;
  while (di + 1 < p.ndesc && p.desc[di + 1].part_off <= e) ++di;
  const auto& D = p.desc[di];
  const long long local = e - D.part_off;
  float s = 0.0f;
  for (int sp = 0; sp < splits; ++sp)
    s += p.partials[static_cast<size_t>(sp) * p.per_split + e];
  const long long kernel_size = static_cast<long long>(D.k_dim) * D.nc;
  if (local < kernel_size) {
    const int k = static_cast<int>(local / D.nc);
    const int j = static_cast<int>(local % D.nc);
    D.out[static_cast<size_t>(k) * D.ldo + j] = s;
  } else {
    D.bias[local - kernel_size] = s;
  }
}

}  // namespace
