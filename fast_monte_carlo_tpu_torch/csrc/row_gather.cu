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
// rows.  row_gather_sum gives one thread one row and sums it in column order.
// Indices outside [0, rows) are clipped to the table, as the probes' XLA
// reference (`mode="clip"`) does.
#include <cstdint>
#include <cuda_runtime.h>

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

__global__ void row_gather_sum_kernel(const float* __restrict__ table,
                                      const int* __restrict__ idx, float* __restrict__ out,
                                      int rows, int width, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* row = table + clip_row(idx[i], rows) * width;
  float s = 0.0f;
  for (int c = 0; c < width; ++c) s += row[c];
  out[i] = s;
}

constexpr int kThreads = 256;

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

// out (n,) = table (rows, cols)[idx (n,)].sum(1), summed in column order.
extern "C" int row_gather_sum_launch(const void* table, const void* idx, void* out,
                                     int rows, int cols, int n, void* stream) {
  if (n <= 0) return 0;
  row_gather_sum_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const int*>(idx),
      static_cast<float*>(out), rows, cols, n);
  return static_cast<int>(cudaGetLastError());
}
