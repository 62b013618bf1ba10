// Table-row gathers: out = table[idx] and out = table[idx].sum(1).
//
// Replaces the Pallas gather probes of the JAX package's benchmarks/:
//   pallas_gather_probe.py:33  gather_kernel   take(tab, idx, 0).sum(1)  (row_gather_sum, B3)
//   pallas_gather_forms.py:23-43  k_take, k_tala, k_index, k_gather, k_lane:
//                              five spellings of table[idx]             (row_gather, B4)
//   pallas_dyngather.py:11     take_along_axis, per-row index over lanes (row_gather, B5)
//   pallas_dma_gather.py:9     per-row DMA through prefetched indices    (row_gather, B6)
// On the TPU the table sat in VMEM or came in 8-row blocks; on Hopper the
// rows come from device memory (or L2, which holds all of the probes'
// tables) and the index array is read once.  Indices outside [0, rows) are
// clipped to the table, as the probes' XLA reference (`mode="clip"`) does.
//
// row_gather.  It moves values and does no arithmetic, so it is bound by
// bytes (the index array and the touched rows in, the rows out) where
// there are many, and by the launch itself where there are few.  At the
// probes' shapes: B3's 131,072 rows of 8 (7.2 MB, 0.0022 ms at the HBM
// rate), B5's 8,192 rows of 128 and B6's 8,192 (8.4 MB, 0.0025 ms) are
// bytes; B4's 1,024 rows of 8 (52 KB), B5's 512 and 2,048 rows and B6's
// 1,024 (0.5-2.1 MB, 0.0002-0.0006 ms) are under the card's gap between
// back-to-back kernels (about 0.0019 ms on an H100), so what counts there
// is how soon the kernel starts and how short its dependent chain is.
// So the kernel keeps a thread's work before its row load short: one item
// a thread found by dividing a 64-bit thread index by the row width is a
// software routine (the card has no 64-bit integer divide), and a thread
// that loads its row's index itself waits on that load.  Design:
//  - a group of T lanes per output row, T = min(32, next_pow2(items)), an
//    item being a float4 where C % 4 == 0 and both table and out are
//    16-byte aligned, else a float (the same groups over scalars).  The
//    group's first lane reads the index, clips it and passes it on by
//    __shfl_sync; lane l copies items l, l + T, ... of its row, so a row is
//    read and written as contiguous accesses, neighbouring lanes on
//    neighbouring addresses, and rows wider than 32 items loop within the
//    warp.  The grid's ragged edge is masked, not returned, so that the
//    shuffle's lanes stay converged.
//  - 32-bit arithmetic: the thread's row is a shift, a row's offset one
//    32-bit multiply, widened once where it becomes a pointer.  The wrapper
//    (probes/gather.py) refuses a table or an output of 2^31 elements or
//    more, so no offset overflows; the thread and row counters are
//    unsigned, since the grid may pass 2^31 threads.
//  - programmatic dependent launch (pdl.cuh), waiting just ahead of the
//    index load, the first global access: in B5's loop the kernel follows
//    torch's `%` kernel, whose end its launch then overlaps.  A loop step
//    (the shift and `%` in torch, this kernel, the accumulate) took 10-13%
//    less device time on an H100 than without it.
// Dropped, each slower in turns (PERF.md): two rows a group, their loads
// issued before their stores (12% faster alone at 2,048 rows of 128, no
// faster in B5's loop, 2-3% slower at 8,192 rows of 128 and 22% at B3's
// shape), four rows a group (28% slower at 8,192 rows of 128), and a bulk
// copy of each row into shared memory (cp.async.bulk and an mbarrier) with
// one bulk store a block (21-240% slower).
//
// row_gather_sum writes 4 bytes per row it reads, so its bytes are the rows
// read; and at the probes' shapes one launch is one wave (131,072 rows of 8
// at B3, 8,192 of 128 at B6): an index load, a dependent row load and a
// store, with nothing to overlap them.  One thread walking one row with
// scalar loads reached 23% of the bytes bound at B3 and 7% at 128 columns,
// where a warp's load touched 32 rows 512 bytes apart.  Design: the lane
// groups above, one row each (float4 items where the table alone is
// 16-byte aligned).  Lane l of a group adds items l, l + T, ...
// of its row; the group reduces by __shfl_xor_sync, and its first lane
// writes out[i]: the sum is in lane order, not column order.  It is
// launched with programmatic dependent launch (pdl.cuh) and waits for the
// kernel before it just ahead of its index load, its first global access:
// in B3's loop it follows torch's `%` kernel, whose end its launch then
// overlaps, and a loop step (index shift, `%`, this kernel, accumulate)
// took 0.0095 ms of device time on an H100 against 0.0107 without it
// (PERF.md).  Two items per lane (half the lanes) was 9-10% faster at
// 2,048 and 8,192 rows of 128 and 6-33% slower at B3 and at 1,024 rows or
// fewer.
#include <cstdint>
#include <cuda_runtime.h>

#include "pdl.cuh"

namespace {

__device__ __forceinline__ long long clip_row(int r, int rows) {
  return static_cast<long long>(min(max(r, 0), rows - 1));
}

__device__ __forceinline__ float item_sum(float4 v) { return (v.x + v.y) + (v.z + v.w); }
__device__ __forceinline__ float item_sum(float v) { return v; }

constexpr int kThreads = 256;

// out (n, width) = table[clip(idx)], `width` in items V; groups of
// 2^lanes_log2 lanes, one row each.
template <typename V>
__global__ void __launch_bounds__(kThreads)
    row_gather_kernel(const V* __restrict__ table, const int* __restrict__ idx,
                      V* __restrict__ out, int rows, int width, int n, int lanes_log2) {
  pdl::launch_dependents();
  const int lanes = 1 << lanes_log2;
  const unsigned i = (blockIdx.x * kThreads + threadIdx.x) >> lanes_log2;
  const int l = threadIdx.x & (lanes - 1);
  const bool live = i < static_cast<unsigned>(n);
  pdl::wait();
  int r = live && l == 0 ? min(max(idx[i], 0), rows - 1) : 0;
  r = __shfl_sync(0xffffffffu, r, 0, lanes);
  if (live) {
    const V* row = table + r * width;
    V* dst = out + i * width;
    for (int c = l; c < width; c += lanes) dst[c] = row[c];
  }
}

// `width` is the row width in items V; groups of 2^lanes_log2 lanes, one
// row each.  Every lane of the block takes part in the shuffles: the grid's
// ragged edge is masked, not returned.
template <typename V>
__global__ void __launch_bounds__(kThreads)
    row_gather_sum_kernel(const V* __restrict__ table, const int* __restrict__ idx,
                          float* __restrict__ out, int rows, int width, int n, int lanes_log2) {
  pdl::launch_dependents();
  const int lanes = 1 << lanes_log2;
  const long long i = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> lanes_log2;
  const int l = threadIdx.x & (lanes - 1);
  const bool live = i < n;
  pdl::wait();
  int r = live && l == 0 ? idx[i] : 0;
  r = __shfl_sync(0xffffffffu, r, 0, lanes);
  float s = 0.0f;
  if (live) {
    const V* row = table + clip_row(r, rows) * width;
#pragma unroll 4
    for (int c = l; c < width; c += lanes) s += item_sum(row[c]);
  }
  for (int o = lanes >> 1; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (live && l == 0) out[i] = s;
}

unsigned blocks_for(long long total) {
  return static_cast<unsigned>((total + kThreads - 1) / kThreads);
}

}  // namespace

// out (n, cols) = table (rows, cols)[idx (n,)]; f32, int32, contiguous.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int row_gather_launch(const void* table, const void* idx, void* out, int rows,
                                 int cols, int n, void* stream) {
  if (n <= 0 || cols <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = cols % 4 == 0 && reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int items = vec ? cols / 4 : cols;
  int lanes_log2 = 0;
  while (lanes_log2 < 5 && (1 << lanes_log2) < items) ++lanes_log2;
  const unsigned blocks = blocks_for(static_cast<long long>(n) << lanes_log2);
  const int* ix = static_cast<const int*>(idx);
  const cudaError_t err =
      vec ? pdl::launch(row_gather_kernel<float4>, blocks, kThreads, st,
                        static_cast<const float4*>(table), ix, static_cast<float4*>(out), rows,
                        items, n, lanes_log2)
          : pdl::launch(row_gather_kernel<float>, blocks, kThreads, st,
                        static_cast<const float*>(table), ix, static_cast<float*>(out), rows,
                        items, n, lanes_log2);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// out (n,) = table (rows, cols)[idx (n,)].sum(1), summed in lane order.
extern "C" int row_gather_sum_launch(const void* table, const void* idx, void* out,
                                     int rows, int cols, int n, void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = cols % 4 == 0 && reinterpret_cast<uintptr_t>(table) % 16 == 0;
  const int items = vec ? cols / 4 : cols;
  int lanes_log2 = 0;
  while (lanes_log2 < 5 && (1 << lanes_log2) < items) ++lanes_log2;
  const unsigned blocks = blocks_for(static_cast<long long>(n) << lanes_log2);
  const int* ix = static_cast<const int*>(idx);
  float* o = static_cast<float*>(out);
  const cudaError_t err =
      vec ? pdl::launch(row_gather_sum_kernel<float4>, blocks, kThreads, st,
                        static_cast<const float4*>(table), ix, o, rows, items, n, lanes_log2)
          : pdl::launch(row_gather_sum_kernel<float>, blocks, kThreads, st,
                        static_cast<const float*>(table), ix, o, rows, items, n, lanes_log2);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
