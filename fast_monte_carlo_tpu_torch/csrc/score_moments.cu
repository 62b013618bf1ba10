// K2: the moment and histogram epilogue of a launch of games.
//
// Replaces fast_monte_carlo_tpu/parallel/aggregate.py:76 score_moments (XLA
// on the TPU, not a Pallas kernel), as the port takes it before its one
// rounding: parallel/aggregate.exact_moments over (G, n, 2) int32 scores,
// per matchup g the exact int64 game count, wins of each side, ties, point
// sums and sums of squares, and the int32 histograms of each side's points
// (2 x 128), the margin s0 - s1 + 128 (256) and the total s0 + s1 (256),
// each value clamped into its range as _hist clamps it.  Its plain version
// is exact_moments_plain, the torch body.
//
// Bound on the H100: a launch reads 8 bytes a game (0.52 MB at 65,536
// games, 0.16 us at 3.35 TB/s) and writes 3 KB a matchup; about 30
// instructions a game.  At these sizes a launch is bound by its latency.
//
// Design: a grid of (blocks a matchup, G) blocks of 256 threads, each block
// striding over its matchup's games.  A thread keeps its counts in
// registers (sums in int64) and adds each game to the block's four
// histograms in shared memory; the block then sums its threads' counts by
// warp shuffles and one shared slot a warp, and adds them, and its
// histograms' nonzero bins, to the outputs with integer atomics.  Integer
// addition is associative, so the result does not depend on the order the
// blocks run in and equals the torch body's bit for bit.  The wrapper zeroes
// the outputs; block (0, g) writes matchup g's count.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPts = 128;                    // MAX_PTS
constexpr int kMargin = 256;                 // 2 * MARGIN_OFF
constexpr int kTotal = 256;                  // 2 * MAX_PTS
constexpr int kBins = 2 * kPts + kMargin + kTotal;
constexpr int kCounts = 7;                   // wins 2, ties, sums 2, squares 2

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// counts: n (G), wins (G, 2), ties (G), s_sum (G, 2), s_sumsq (G, 2), one
// after the other, int64; hist: pts (G, 2, 128), margin (G, 256), total
// (G, 256), one after the other, int32.  Both zeroed.
__global__ void __launch_bounds__(kThreads)
    score_moments_kernel(const int* __restrict__ score, int n, int groups,
                         long long* __restrict__ counts, int* __restrict__ hist) {
  __shared__ int h[kBins];
  __shared__ long long part[kWarps][kCounts];
  const int g = blockIdx.y;
  for (int k = threadIdx.x; k < kBins; k += kThreads) h[k] = 0;
  __syncthreads();
  const int2* s = reinterpret_cast<const int2*>(score) + static_cast<long long>(g) * n;
  long long acc[kCounts] = {0, 0, 0, 0, 0, 0, 0};
  for (int b = blockIdx.x * kThreads + threadIdx.x; b < n; b += gridDim.x * kThreads) {
    const int2 p = s[b];
    acc[0] += p.x > p.y;
    acc[1] += p.y > p.x;
    acc[2] += p.x == p.y;
    acc[3] += p.x;
    acc[4] += p.y;
    acc[5] += static_cast<long long>(p.x) * p.x;
    acc[6] += static_cast<long long>(p.y) * p.y;
    atomicAdd(&h[clampi(p.x, 0, kPts - 1)], 1);
    atomicAdd(&h[kPts + clampi(p.y, 0, kPts - 1)], 1);
    atomicAdd(&h[2 * kPts + clampi(p.x - p.y + kMargin / 2, 0, kMargin - 1)], 1);
    atomicAdd(&h[2 * kPts + kMargin + clampi(p.x + p.y, 0, kTotal - 1)], 1);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kCounts; ++k) {
    const long long v = warp_sum(acc[k]);
    if (lane == 0) part[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < kCounts) {
    long long v = 0;
    for (int w = 0; w < kWarps; ++w) v += part[w][threadIdx.x];
    // slot k of the counts: wins at G + 2g, ties at 3G + g, sums at 4G + 2g,
    // squares at 6G + 2g
    const int k = threadIdx.x;
    const long long at = k < 2 ? groups + 2LL * g + k
                         : k == 2 ? 3LL * groups + g
                         : k < 5 ? 4LL * groups + 2LL * g + (k - 3)
                                 : 6LL * groups + 2LL * g + (k - 5);
    // two's-complement addition: a signed sum added as unsigned is exact
    if (v != 0)
      atomicAdd(reinterpret_cast<unsigned long long*>(counts + at),
                static_cast<unsigned long long>(v));
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) counts[g] = n;
  int* out_pts = hist + static_cast<long long>(g) * 2 * kPts;
  int* out_margin = hist + static_cast<long long>(groups) * 2 * kPts
                    + static_cast<long long>(g) * kMargin;
  int* out_total = hist + static_cast<long long>(groups) * (2 * kPts + kMargin)
                   + static_cast<long long>(g) * kTotal;
  for (int k = threadIdx.x; k < kBins; k += kThreads) {
    const int v = h[k];
    if (v == 0) continue;
    int* dst = k < 2 * kPts ? out_pts + k
               : k < 2 * kPts + kMargin ? out_margin + (k - 2 * kPts)
                                        : out_total + (k - 2 * kPts - kMargin);
    atomicAdd(dst, v);
  }
}

}  // namespace

// The exact moments of `groups` matchups of n games each: score (groups, n,
// 2) int32, contiguous and 8-byte aligned; counts and hist as the kernel
// takes them, zeroed.  `blocks` blocks a matchup.  Launches on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int score_moments_launch(const void* score, int n, int groups, int blocks,
                                    void* counts, void* hist, void* stream) {
  if (n <= 0 || groups <= 0) return 0;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(groups));
  score_moments_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(score), n, groups, static_cast<long long*>(counts),
      static_cast<int*>(hist));
  return static_cast<int>(cudaGetLastError());
}
