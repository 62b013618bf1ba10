// K5: tree-ensemble margins, margins[b, c] = base[c] + sum over the trees t
// of class c of the leaf value row b reaches in tree t.
//
// Replaces fast_monte_carlo_tpu/ops/forest_eval.py:96 eval_margin, which is
// XLA on the TPU, not a Pallas kernel: a depth-bounded gather walk over a
// (B, T) front of (row, tree) pairs, one (B*T, 8) node-record gather a
// level, and the class sum as a (B, T) x (T, C) product on the MXU.
//
// What bounds it on the H100: the walk is a chain of dependent steps per
// (row, tree) - read the node, read the value it splits on, compare, step
// to the child - so the latency of each step and the instructions it
// issues bound it, not bytes (a 400-tree forest is 48 KB of records against
// 5 MB of rows).  The design, against that:
//
// * Compact records, built once on the host (ops/forest_eval.py
//   pack_kernel_records, which states the layout): 8 bytes a node, word 0
//   the threshold (f32), a categorical node's category id (int32) or a
//   leaf's value, word 1 the byte offset of the left child's record in its
//   tree (the right child's is 8 more), the byte offset of the row word the
//   node reads (a group's id or a numeric feature), and flag bits.  A
//   categorical node's two outcomes (the id matches or not) are resolved on
//   the host, zeros-as-missing included; a leaf reads as a categorical
//   node that never goes right, so it stays put and a walk takes a fixed
//   number of levels with no leaf test.  A level is one 8-byte and one
//   4-byte shared-memory load and a dozen integer and compare
//   instructions: no float->int conversion, no address scaling, no
//   separate leaf load.  Limits (the wrapper raises ValueError beyond
//   them): a tree of at most kTileRecords records (the 15-bit child
//   offset), at most kGroups groups and kMaxFeatures numerics (the 9-bit
//   row offset).
// * Records in shared memory: the forest is cut on the host into tiles of
//   whole trees (at most kTileRecords records, each from a 16-byte
//   boundary); thread 0 copies them with cp.async.bulk (TMA, 1D) into two
//   buffers under an mbarrier each, so tile i + 1 arrives while tile i is
//   walked, and a block of kThreads rows reuses each tile kThreads times.
// * Rows in shared memory: a block stages its rows as words [id_0 ..
//   id_3, x_0 .. x_{F-1}] at an odd stride (no bank conflict when a warp
//   reads one slot).
// * Walks in flight: a thread takes one row and walks kWalks trees of the
//   tile at once, level by level, so kWalks independent chains hide each
//   other's latency; then it adds their leaf values to its class sums in
//   tree order, as the plain version (`eval_margin_reference`) does, so
//   the two agree bitwise.
//   A walk's level and the tile copies are forest_walk.cuh's, which K1's
//   exact-mode instantiation shares (csrc/nano_game.cu).
#include <cstdint>
#include <cuda_runtime.h>

#include "forest_walk.cuh"

namespace {

using fw::kGroups;
using fw::kMaxFeatures;
using fw::kTileBytes;
using fw::kTileRecords;
using fw::kWalks;
using fw::row_stride;

constexpr int kThreads = 256;     // rows a block
constexpr size_t kRowsOffset = 2 * kTileBytes + 128;  // after the tiles and barriers

size_t smem_bytes(int n_feat) {
  return kRowsOffset + static_cast<size_t>(kThreads) * row_stride(n_feat) * 4;
}

template <int C, bool LT, bool ZAM>
__global__ void __launch_bounds__(kThreads, 2)
    forest_eval_kernel(const uint2* __restrict__ recs, const int4* __restrict__ tiles,
                       const int* __restrict__ tree_off, const int* __restrict__ tree_class,
                       const float* __restrict__ base, const float* __restrict__ x,
                       const int* __restrict__ cid, float* __restrict__ out, int n_rows,
                       int n_feat, int n_groups, int n_tiles, int steps) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + 2 * kTileBytes);
  unsigned* xs = reinterpret_cast<unsigned*>(smem + kRowsOffset);
  const int tid = static_cast<int>(threadIdx.x);
  const int stride = row_stride(n_feat);

  if (tid == 0) {
    fw::mbar_init(&bar[0]);
    fw::mbar_init(&bar[1]);
    fw::fence_barrier_init();
    for (int i = 0; i < 2 && i < n_tiles; ++i) {
      const int4 tl = __ldg(tiles + i);
      fw::load_tile(smem + i * kTileBytes, recs + tl.x, static_cast<unsigned>(tl.y), &bar[i]);
    }
  }
  // the block's rows, read coalesced while the first tiles arrive
  const long long row0 = static_cast<long long>(blockIdx.x) * kThreads;
  const int rows = static_cast<int>(min(static_cast<long long>(kThreads), n_rows - row0));
  const float* xb = x + row0 * n_feat;
  for (int i = tid; i < rows * n_feat; i += kThreads)
    xs[(i / n_feat) * stride + kGroups + i % n_feat] = __float_as_uint(__ldg(xb + i));
  const int* cb = cid + row0 * n_groups;
  for (int i = tid; i < rows * n_groups; i += kThreads)
    xs[(i / n_groups) * stride + i % n_groups] = static_cast<unsigned>(__ldg(cb + i));
  __syncthreads();

  // a thread past the last row walks whatever its staged row holds (every
  // record offset stays in its tree) and stores nothing
  const unsigned char* xr = reinterpret_cast<const unsigned char*>(xs + tid * stride);
  float acc[C];
#pragma unroll
  for (int k = 0; k < C; ++k) acc[k] = 0.0f;

  for (int i = 0; i < n_tiles; ++i) {
    const int4 tl = __ldg(tiles + i);
    const unsigned char* tile = smem + (i & 1) * kTileBytes;
    int next[kWalks];  // the byte offsets of the next kWalks trees' roots
#pragma unroll
    for (int k = 0; k < kWalks; ++k) next[k] = __ldg(tree_off + min(tl.z + k, tl.w - 1)) * 8;
    fw::mbar_wait(&bar[i & 1], static_cast<unsigned>(i >> 1) & 1u);
    for (int t = tl.z; t < tl.w; t += kWalks) {
      const unsigned char* root[kWalks];
      unsigned node[kWalks];
#pragma unroll
      for (int k = 0; k < kWalks; ++k) {
        root[k] = tile + next[k];
        node[k] = 0;
        next[k] = __ldg(tree_off + min(t + kWalks + k, tl.w - 1)) * 8;
      }
      for (int s = 0; s < steps; ++s) {
#pragma unroll
        for (int k = 0; k < kWalks; ++k) node[k] = fw::walk_step<LT, ZAM>(root[k], node[k], xr);
      }
#pragma unroll
      for (int k = 0; k < kWalks; ++k) {
        if (t + k < tl.w) {
          const float v = *reinterpret_cast<const float*>(root[k] + node[k]);
          if (C == 1) {
            acc[0] += v;
          } else {
            const int c = __ldg(tree_class + t + k);
#pragma unroll
            for (int j = 0; j < C; ++j)
              if (c == j) acc[j] += v;
          }
        }
      }
    }
    __syncthreads();  // every thread is done with this buffer
    if (tid == 0 && i + 2 < n_tiles) {
      const int4 nx = __ldg(tiles + i + 2);
      fw::load_tile(smem + (i & 1) * kTileBytes, recs + nx.x, static_cast<unsigned>(nx.y),
                    &bar[i & 1]);
    }
  }
  if (tid < rows) {
    const long long b = row0 + tid;
#pragma unroll
    for (int k = 0; k < C; ++k) out[b * C + k] = acc[k] + __ldg(base + k);
  }
}

template <int C, bool LT, bool ZAM>
cudaError_t launch(const uint2* recs, const int4* tiles, const int* tree_off,
                   const int* tree_class, const float* base, const float* x, const int* cid,
                   float* out, int n_rows, int n_feat, int n_groups, int n_tiles, int steps,
                   cudaStream_t st) {
  // above 48 KB of dynamic shared memory only by this attribute, set on
  // the current device
  auto fn = forest_eval_kernel<C, LT, ZAM>;
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem_bytes(kMaxFeatures)));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  const unsigned blocks = static_cast<unsigned>((n_rows + kThreads - 1) / kThreads);
  forest_eval_kernel<C, LT, ZAM><<<blocks, kThreads, smem_bytes(n_feat), st>>>(
      recs, tiles, tree_off, tree_class, base, x, cid, out, n_rows, n_feat, n_groups, n_tiles,
      steps);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_c(bool lt, bool zm, const uint2* recs, const int4* tiles,
                     const int* tree_off, const int* tree_class, const float* base,
                     const float* x, const int* cid, float* out, int n_rows, int n_feat,
                     int n_groups, int n_tiles, int steps, cudaStream_t st) {
  if (lt && zm)
    return launch<C, true, true>(recs, tiles, tree_off, tree_class, base, x, cid, out, n_rows,
                                 n_feat, n_groups, n_tiles, steps, st);
  if (lt)
    return launch<C, true, false>(recs, tiles, tree_off, tree_class, base, x, cid, out, n_rows,
                                  n_feat, n_groups, n_tiles, steps, st);
  if (zm)
    return launch<C, false, true>(recs, tiles, tree_off, tree_class, base, x, cid, out, n_rows,
                                  n_feat, n_groups, n_tiles, steps, st);
  return launch<C, false, false>(recs, tiles, tree_off, tree_class, base, x, cid, out, n_rows,
                                 n_feat, n_groups, n_tiles, steps, st);
}

}  // namespace

// margins out (n_rows, n_classes) f32 of x (n_rows, n_feat) f32 and category
// ids cid (n_rows, n_groups) int32 through a forest's packed records recs
// (R, 2) int32 (16-byte aligned), its tiles (n_tiles, 4) int32 [first
// record (even), bytes to copy (a multiple of 16), first tree, end tree],
// each tree's first record within its tile tree_off (T,) int32, tree_class
// (T,) int32 and base (n_classes,) f32; all contiguous.  Every walk takes
// `steps` levels.  1 <= n_groups <= 4, 1 <= n_classes <= 8, n_feat <= 64,
// tile_records == kTileRecords (the wrapper's packing) or the launch is
// refused.  Launches on `stream` and returns cudaGetLastError() (0 on
// success).
extern "C" int forest_eval_packed_launch(const void* recs, const void* tiles,
                                         const void* tree_off, const void* tree_class,
                                         const void* base, const void* x, const void* cid,
                                         void* out, int n_rows, int n_feat, int n_groups,
                                         int n_tiles, int n_classes, int steps, int cmp_lt,
                                         int zero_as_missing, int tile_records, void* stream) {
  if (tile_records != kTileRecords || n_feat > kMaxFeatures || n_feat < 0 || n_groups < 1 ||
      n_groups > kGroups || n_tiles < 1 || steps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows <= 0) return 0;
  const uint2* rc = static_cast<const uint2*>(recs);
  const int4* tl = static_cast<const int4*>(tiles);
  const int* to = static_cast<const int*>(tree_off);
  const int* tc = static_cast<const int*>(tree_class);
  const float* bs = static_cast<const float*>(base);
  const float* xx = static_cast<const float*>(x);
  const int* ci = static_cast<const int*>(cid);
  float* o = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool lt = cmp_lt != 0, zm = zero_as_missing != 0;
#define FOREST_EVAL_CASE(K)                                                               \
  case K:                                                                                 \
    return static_cast<int>(launch_c<K>(lt, zm, rc, tl, to, tc, bs, xx, ci, o, n_rows,   \
                                        n_feat, n_groups, n_tiles, steps, st));
  switch (n_classes) {
    FOREST_EVAL_CASE(1)
    FOREST_EVAL_CASE(2)
    FOREST_EVAL_CASE(3)
    FOREST_EVAL_CASE(4)
    FOREST_EVAL_CASE(5)
    FOREST_EVAL_CASE(6)
    FOREST_EVAL_CASE(7)
    FOREST_EVAL_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FOREST_EVAL_CASE
}
