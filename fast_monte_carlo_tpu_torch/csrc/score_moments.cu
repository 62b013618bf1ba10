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
// games, 0.16 us at 3.35 TB/s) and writes 3 KB a matchup; about 35
// instructions a game.  At these sizes a launch is bound by its latency.
//
// Design: one launch, no zero fills, no global atomics.  Each matchup is
// one thread-block cluster of kCluster blocks of kThreads threads (grid
// (kCluster, G)); block r of the cluster strides over games r * kThreads +
// t + k * kCluster * kThreads.  A thread keeps its counts in registers (sums
// in int64) and adds each game to its block's four histograms in shared
// memory; the block sums its threads' counts by warp shuffles and one
// shared slot a warp.  Then every block but the cluster's first adds its
// nonzero bins and its counts into block 0's shared memory through
// distributed shared memory (cooperative_groups::this_cluster,
// map_shared_rank), and after the cluster's barrier block 0 stores the
// matchup's outputs with plain stores, so the wrapper allocates them
// uninitialised.  Integer addition is associative, so the result does not
// depend on the order the blocks run in and equals the torch body's bit for
// bit; a block that gets no game (n under the cluster's threads) adds
// zeros.
//
// Cluster and block size, held ms on an NVIDIA H100 80GB HBM3 at 700 W at
// (1, 65,536) / (60, 32,768) (probes/kernels.py --games-only on
// copies of this file; the first version's three launches, 11985e6, 0.0089
// / 0.0140 in the same call): 8 blocks of 256 threads 0.0073 / 0.0099; of
// 512 0.0071 / 0.0137; of 1,024 0.0078 / 0.0192; 16 blocks (non-portable)
// of 256 0.0060 / 0.0178, of 512 0.0060 / 0.0208: 16-block clusters win
// the one-matchup launch and lose the slate's, 8 blocks of 256 are fixed.
// A one-matchup launch puts 65,536 games on 8 SMs, 32 a thread and four
// shared-memory atomics a game; at 2.2% of its bytes bound it stays bound
// by latency, not by its 0.5 MB.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kCluster = 8;                  // blocks a matchup (portable)
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
// (G, 256), one after the other, int32.  Every element is stored once, by
// block 0 of its matchup's cluster.
__global__ void __launch_bounds__(kThreads)
    score_moments_kernel(const int* __restrict__ score, int n, int groups,
                         long long* __restrict__ counts, int* __restrict__ hist) {
  __shared__ int h[kBins];
  __shared__ unsigned long long tot[kCounts];
  __shared__ long long part[kWarps][kCounts];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int g = blockIdx.y;
  for (int k = threadIdx.x; k < kBins; k += kThreads) h[k] = 0;
  if (threadIdx.x < kCounts) tot[threadIdx.x] = 0;
  // every block's shared memory zeroed, and every block running, before
  // any block adds into block 0's
  cluster.sync();

  const int2* s = reinterpret_cast<const int2*>(score) + static_cast<long long>(g) * n;
  long long acc[kCounts] = {0, 0, 0, 0, 0, 0, 0};
  for (int b = rank * kThreads + threadIdx.x; b < n; b += kCluster * kThreads) {
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

  // into block 0's shared memory: its own counts by a local add, the other
  // blocks' counts and nonzero bins through distributed shared memory
  int* h0 = cluster.map_shared_rank(h, 0);
  unsigned long long* tot0 = cluster.map_shared_rank(tot, 0);
  if (threadIdx.x < kCounts) {
    long long v = 0;
    for (int w = 0; w < kWarps; ++w) v += part[w][threadIdx.x];
    // two's-complement addition: a signed sum added as unsigned is exact
    if (v != 0) atomicAdd(tot0 + threadIdx.x, static_cast<unsigned long long>(v));
  }
  if (rank != 0) {
    for (int k = threadIdx.x; k < kBins; k += kThreads) {
      const int v = h[k];
      if (v != 0) atomicAdd(h0 + k, v);
    }
  }
  // every add into block 0 done; the other blocks may then exit
  cluster.sync();
  if (rank != 0) return;

  if (threadIdx.x == 0) counts[g] = n;
  if (threadIdx.x < kCounts) {
    // slot k of the counts: wins at G + 2g, ties at 3G + g, sums at 4G + 2g,
    // squares at 6G + 2g
    const int k = threadIdx.x;
    const long long at = k < 2 ? groups + 2LL * g + k
                         : k == 2 ? 3LL * groups + g
                         : k < 5 ? 4LL * groups + 2LL * g + (k - 3)
                                 : 6LL * groups + 2LL * g + (k - 5);
    counts[at] = static_cast<long long>(tot[k]);
  }
  int* out_pts = hist + static_cast<long long>(g) * 2 * kPts;
  int* out_margin = hist + static_cast<long long>(groups) * 2 * kPts
                    + static_cast<long long>(g) * kMargin;
  int* out_total = hist + static_cast<long long>(groups) * (2 * kPts + kMargin)
                   + static_cast<long long>(g) * kTotal;
  for (int k = threadIdx.x; k < kBins; k += kThreads) {
    int* dst = k < 2 * kPts ? out_pts + k
               : k < 2 * kPts + kMargin ? out_margin + (k - 2 * kPts)
                                        : out_total + (k - 2 * kPts - kMargin);
    *dst = h[k];
  }
}

}  // namespace

// The exact moments of `groups` matchups of n games each: score (groups, n,
// 2) int32, contiguous and 8-byte aligned; counts and hist as the kernel
// takes them, uninitialised (every element is stored).  One cluster of
// kCluster blocks a matchup: groups <= 65,535.  Launches on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int score_moments_launch(const void* score, int n, int groups, void* counts,
                                    void* hist, void* stream) {
  if (groups <= 0) return 0;
  if (kCluster > 8) {
    // a cluster past the portable 8 blocks is the card's option
    const cudaError_t err = cudaFuncSetAttribute(
        score_moments_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, static_cast<unsigned>(groups));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, score_moments_kernel, static_cast<const int*>(score), n, groups,
                         static_cast<long long*>(counts), static_cast<int*>(hist));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
