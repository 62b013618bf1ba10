// Philox play-step draws: 13 uniforms + 4 Box-Muller normals per (step, row).
//
// Replaces the two Pallas RNG kernels of the JAX package:
//   fast_monte_carlo_tpu/ops/rng_pallas.py:32  _kernel        (step_draws, one step)
//   fast_monte_carlo_tpu/ops/rng_pallas.py:94  _chunk_kernel  (chunk_draws, a play chunk)
// The TPU kernels seed the chip's hardware PRNG per 2048-row block.  Hopper
// has no such generator, so this kernel uses counter-based Philox4x32-10
// (philox.cuh).  Key = the 64-bit launch seed; counter = (row, absolute step,
// block 0..4, 0).  A game's draws therefore depend only on (seed, absolute
// step, row): the chunked stream equals the per-step stream, the contract
// stated in rng_pallas.py:8-12.
//
// Bound: one launch writes ch * n * 17 f32 (107 MB at ch=24, n=65,536) and
// computes 5 Philox blocks (50 rounds of two 32x32 multiplies) per thread, so
// it is bound by the stores; one thread per (step, row) keeps every output
// row in one thread's registers.  Vector stores and fusing the draws into the
// game kernel (which would remove the buffer entirely) are later work.
#include <cstdint>
#include <cuda_runtime.h>

#include "philox.cuh"

namespace {

__global__ void philox_draws_kernel(uint32_t k0, uint32_t k1, uint32_t step_base,
                                    int ch, int n, float* __restrict__ u,
                                    float* __restrict__ z) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long total = static_cast<long long>(ch) * n;
  if (t >= total) return;
  const int j = static_cast<int>(t / n);
  const uint32_t row = static_cast<uint32_t>(t - static_cast<long long>(j) * n);
  const uint32_t step = step_base + static_cast<uint32_t>(j);

  float uu[philox::kUniforms], zz[philox::kNormals];
  philox::step_draws(k0, k1, step, row, uu, zz);
  float* uo = u + t * philox::kUniforms;
#pragma unroll
  for (int i = 0; i < philox::kUniforms; ++i) uo[i] = uu[i];
  float* zo = z + t * philox::kNormals;
#pragma unroll
  for (int i = 0; i < philox::kNormals; ++i) zo[i] = zz[i];
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// u: (ch, n, 13) f32 contiguous; z: (ch, n, 4) f32 contiguous.
extern "C" int philox_draws_launch(uint32_t k0, uint32_t k1, uint32_t step_base,
                                   int ch, int n, void* u, void* z, void* stream) {
  const long long total = static_cast<long long>(ch) * n;
  if (total <= 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  philox_draws_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      k0, k1, step_base, ch, n, static_cast<float*>(u), static_cast<float*>(z));
  return static_cast<int>(cudaGetLastError());
}
