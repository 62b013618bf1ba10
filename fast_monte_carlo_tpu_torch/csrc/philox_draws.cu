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
// stated in rng_pallas.py:8-12.  A launch draws rows row0 .. row0 + n - 1,
// so a rank that plays a block of a launch's games draws exactly the rows
// the unsharded launch gives them (one add to the counter's row word).
//
// Bound on the H100: a launch writes ch * n * 68 bytes (107 MB at
// (24, 65,536), 0.0319 ms at 3.35 TB/s).  Per item it needs about 357
// dispatched instructions: 138 on the 64 lanes of the ALU pipe (Philox's
// XORs and masks, Box-Muller's compares and selects), 83 Philox products
// on the 64 of IMAD, 25 conversions and square roots on the 16 of MUFU
// (chip_smoke.py counts them by class), each class under the bytes.  So
// the stores bind.  One thread per item storing its 13 uniforms as 13
// scalar stores, 52 bytes from its neighbour's, reached 12% of that rate.
//
// Design: each block owns a tile of kTile consecutive items of the flat
// (step, row) index, one item per thread.  The tile's output regions in u
// and z are contiguous and, as kTile is a multiple of 4, 16-byte aligned for
// any n.  A thread writes its 4 normals as one float4 (a warp stores 512
// contiguous bytes).  Its 13 uniforms go to shared memory at stride 13 (odd,
// so the 32 lanes hit 32 banks); after a barrier the block copies the tile's
// 13 * kTile floats out with 16-byte stores, contiguous across the warp, and
// the few floats past the last whole float4 of a ragged tile one by one.
// The stores are evict-first (st.global.cs): a launch writes twice the L2.
// The step j of item t is one 32-bit division (the wrapper keeps
// ch * n < 2^31).  One cp.async.bulk copy of the tile, started by one thread,
// was tried in place of the block's vector stores and ran 1% slower.
#include <cstdint>
#include <cuda_runtime.h>

#include "philox.cuh"

namespace {

constexpr int kTile = 256;
static_assert(kTile % 4 == 0, "a tile's u region must start 16-byte aligned");
constexpr int kTileFloats = kTile * philox::kUniforms;

__global__ void __launch_bounds__(kTile)
    philox_draws_kernel(uint32_t k0, uint32_t k1, uint32_t step_base, uint32_t row0,
                        uint32_t n, uint32_t total, float* __restrict__ u,
                        float4* __restrict__ z) {
  __shared__ float4 tile4[kTileFloats / 4];
  float* tile = reinterpret_cast<float*>(tile4);
  const uint32_t t0 = blockIdx.x * kTile;
  const uint32_t items = min(total - t0, static_cast<uint32_t>(kTile));
  const uint32_t t = t0 + threadIdx.x;
  if (threadIdx.x < items) {
    const uint32_t j = t / n;
    float uu[philox::kUniforms], zz[philox::kNormals];
    philox::step_draws(k0, k1, step_base + j, row0 + t - j * n, uu, zz);
#pragma unroll
    for (int i = 0; i < philox::kUniforms; ++i) tile[threadIdx.x * philox::kUniforms + i] = uu[i];
    __stcs(z + t, make_float4(zz[0], zz[1], zz[2], zz[3]));
  }
  __syncthreads();
  // the tile's uniforms: 13 * items floats from float 13 * t0, 16-byte aligned
  const uint32_t floats = items * philox::kUniforms;
  float* out = u + static_cast<size_t>(t0) * philox::kUniforms;
  float4* out4 = reinterpret_cast<float4*>(out);
  for (uint32_t v = threadIdx.x; v < floats / 4; v += kTile) __stcs(out4 + v, tile4[v]);
  for (uint32_t f = (floats & ~3u) + threadIdx.x; f < floats; f += kTile) out[f] = tile[f];
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// u: (ch, n, 13) f32 contiguous; z: (ch, n, 4) f32 contiguous; both 16-byte
// aligned, ch * n < 2^31 and row0 + n <= 2^32 (the wrapper checks).
extern "C" int philox_draws_launch(uint32_t k0, uint32_t k1, uint32_t step_base,
                                   uint32_t row0, int ch, int n, void* u, void* z,
                                   void* stream) {
  const long long total = static_cast<long long>(ch) * n;
  if (total <= 0) return 0;
  const unsigned blocks = static_cast<unsigned>((total + kTile - 1) / kTile);
  philox_draws_kernel<<<blocks, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      k0, k1, step_base, row0, static_cast<uint32_t>(n), static_cast<uint32_t>(total),
      static_cast<float*>(u), static_cast<float4*>(z));
  return static_cast<int>(cudaGetLastError());
}
