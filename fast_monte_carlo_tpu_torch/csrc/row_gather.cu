// Table-row gathers: out = table[idx] and out = table[idx].sum(1).
//
// Replaces the Pallas gather probes of the JAX package's benchmarks/:
//   pallas_gather_probe.py:33  gather_kernel   take(tab, idx, 0).sum(1)  (row_gather_sum)
//   pallas_gather_forms.py:23-43  k_take, k_tala, k_index, k_gather, k_lane:
//                              five spellings of table[idx]             (row_gather)
//   pallas_dyngather.py:11     take_along_axis, per-row index over lanes (row_gather)
//   pallas_dma_gather.py:9     per-row DMA through prefetched indices    (row_gather)
// On the TPU the table sat in VMEM or came in 8-row blocks; on Hopper each
// thread reads its own table row from device memory (or L2, which holds all
// of the probes' tables) and the index array is read once.
//
// Bound: bytes.  A gather moves the touched rows in, the index array in and
// the rows out; it does no arithmetic (the row sum adds C floats per row).
// row_gather gives one thread one float4 of one output row where the row
// width allows it (C % 4 == 0 and 16-byte-aligned pointers), else one float,
// so a warp's loads and stores cover neighbouring addresses of one or a few
// rows.  Indices outside [0, rows) are clipped to the table, as the probes'
// XLA reference (`mode="clip"`) does.
//
// row_gather_sum writes 4 bytes per row it reads, so its bytes are the rows
// read; and at the probes' shapes one launch is one wave (131,072 rows of 8
// at B3, 8,192 of 128 at B6): an index load, a dependent row load and a
// store, with nothing to overlap them.  One thread walking one row with
// scalar loads reached 23% of the bytes bound at B3 and 7% at 128 columns,
// where a warp's load touched 32 rows 512 bytes apart.  Design: a group of
// T lanes per row, T = min(32, next_pow2(items)), an item being a float4
// where C % 4 == 0 and the table is 16-byte aligned, else a float (the same
// groups over scalars).  Lane l of a group adds items l, l + T, ... of its
// row, so a row is read as contiguous 16-byte loads, neighbouring lanes on
// neighbouring addresses; rows wider than 32 items loop within the warp.
// The group's first lane reads the index and passes it on by a shuffle,
// the group reduces by __shfl_xor_sync, and its first lane writes out[i]: the
// sum is in lane order, not column order.  It is launched with
// programmatic dependent launch (pdl.cuh) and waits for the kernel before
// it just ahead of its index load, its first global access: in B3's loop
// it follows torch's `%` kernel, whose end its launch then overlaps, and a
// loop step (index shift, `%`, this kernel, accumulate) took 0.0095 ms of
// device time on an H100 against 0.0107 without it (PERF.md, PR 4).
// Two items per lane (half the lanes) was 9-10% faster at 2,048 and 8,192
// rows of 128 and 6-33% slower at B3 and at 1,024 rows or fewer.
#include <cstdint>
#include <cuda_runtime.h>

#include "pdl.cuh"

namespace {

__device__ __forceinline__ long long clip_row(int r, int rows) {
  return static_cast<long long>(min(max(r, 0), rows - 1));
}

template <typename T>
__global__ void row_gather_kernel(const T* __restrict__ table, const int* __restrict__ idx,
                                  T* __restrict__ out, int rows, int width, long long total) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const long long i = t / width;
  const int c = static_cast<int>(t - i * width);
  out[t] = table[clip_row(idx[i], rows) * width + c];
}

__device__ __forceinline__ float item_sum(float4 v) { return (v.x + v.y) + (v.z + v.w); }
__device__ __forceinline__ float item_sum(float v) { return v; }

constexpr int kThreads = 256;

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
  if (vec) {
    const long long total = static_cast<long long>(n) * (cols / 4);
    row_gather_kernel<float4><<<blocks_for(total), kThreads, 0, st>>>(
        static_cast<const float4*>(table), static_cast<const int*>(idx),
        static_cast<float4*>(out), rows, cols / 4, total);
  } else {
    const long long total = static_cast<long long>(n) * cols;
    row_gather_kernel<float><<<blocks_for(total), kThreads, 0, st>>>(
        static_cast<const float*>(table), static_cast<const int*>(idx),
        static_cast<float*>(out), rows, cols, total);
  }
  return static_cast<int>(cudaGetLastError());
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
