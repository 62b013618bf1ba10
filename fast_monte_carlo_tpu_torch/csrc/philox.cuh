// Philox4x32-10 and the play-step draw transform, shared by every kernel that
// draws (philox_draws.cu, fused_step.cu, nano_game.cu).
//
// Philox4x32-10: Salmon et al., "Parallel random numbers: as easy as 1, 2, 3",
// SC'11.  A play step of a game uses 5 blocks with counter (row, step,
// block 0..4, 0) under the 64-bit launch key, 20 words of which the first 17
// are used: words 0-12 are uniforms, words 13-16 feed Box-Muller.  The
// transforms follow fast_monte_carlo_tpu/ops/rng_pallas.py:40-55: the low 24
// bits of a word become an exact-in-f32 uniform in [0, 1); Box-Muller on
// (13, 14) and (15, 16), with max(a, 1e-7), gives 4 normals.
#pragma once

#include <cstdint>

namespace philox {

constexpr uint32_t kM0 = 0xD2511F53u;
constexpr uint32_t kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u;
constexpr uint32_t kW1 = 0xBB67AE85u;
constexpr int kUniforms = 13;
constexpr int kNormals = 4;

__device__ __forceinline__ void philox4x32_10(uint32_t c[4], uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += kW0;
      k1 += kW1;
    }
    const uint32_t hi0 = __umulhi(kM0, c[0]);
    const uint32_t lo0 = kM0 * c[0];
    const uint32_t hi1 = __umulhi(kM1, c[2]);
    const uint32_t lo1 = kM1 * c[2];
    const uint32_t n0 = hi1 ^ c[1] ^ k0;
    const uint32_t n2 = hi0 ^ c[3] ^ k1;
    c[0] = n0;
    c[1] = lo1;
    c[2] = n2;
    c[3] = lo0;
  }
}

// Block b of (key, step, row): its 4 words as uniforms.
__device__ __forceinline__ void block_uniforms(uint32_t k0, uint32_t k1, uint32_t step,
                                               uint32_t row, uint32_t b, float w[4]) {
  uint32_t c[4] = {row, step, b, 0u};
  philox4x32_10(c, k0, k1);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // 24 bits are exact in f32; the scale is a power of two
    w[i] = static_cast<float>(c[i] & 0x00FFFFFFu) * 5.9604644775390625e-8f;
  }
}

// The 13 uniforms and 4 normals of a step from its 5 blocks' 20 uniforms.
__device__ __forceinline__ void words_to_draws(const float w[20], float u[kUniforms],
                                               float z[kNormals]) {
#pragma unroll
  for (int i = 0; i < kUniforms; ++i) u[i] = w[i];

  const float two_pi = 6.283185307179586f;
  const float a0 = fmaxf(w[13], 1e-7f);
  const float a1 = fmaxf(w[15], 1e-7f);
  const float r0 = sqrtf(-2.0f * logf(a0));
  const float r1 = sqrtf(-2.0f * logf(a1));
  const float t0 = two_pi * w[14];
  const float t1 = two_pi * w[16];
  // one range reduction per angle; the same values as sinf and cosf
  float s0, c0, s1, c1;
  sincosf(t0, &s0, &c0);
  sincosf(t1, &s1, &c1);
  z[0] = r0 * c0;
  z[1] = r0 * s0;
  z[2] = r1 * c1;
  z[3] = r1 * s1;
}

// The 13 uniforms and 4 normals of one (key, step, row).
__device__ __forceinline__ void step_draws(uint32_t k0, uint32_t k1, uint32_t step,
                                           uint32_t row, float u[kUniforms],
                                           float z[kNormals]) {
  float w[20];
#pragma unroll
  for (int b = 0; b < 5; ++b) block_uniforms(k0, k1, step, row, b, w + 4 * b);
  words_to_draws(w, u, z);
}

// step_draws with block kGiven's uniforms already drawn (`given`, as
// block_uniforms makes them): a kernel that draws one block first
// (nano_game.cu: the player slots' uniforms) draws the other four here.
template <int kGiven>
__device__ __forceinline__ void step_draws_given(uint32_t k0, uint32_t k1, uint32_t step,
                                                 uint32_t row, const float (&given)[4],
                                                 float u[kUniforms], float z[kNormals]) {
  float w[20];
#pragma unroll
  for (int b = 0; b < 5; ++b) {
    if (b == kGiven) {
#pragma unroll
      for (int i = 0; i < 4; ++i) w[4 * b + i] = given[i];
    } else {
      block_uniforms(k0, k1, step, row, b, w + 4 * b);
    }
  }
  words_to_draws(w, u, z);
}

}  // namespace philox
