// Programmatic dependent launch (PDL), Hopper's overlap of back-to-back
// kernels on one stream (row_gather.cu's row_gather_sum).
//
// A kernel launched by pdl::launch may start while the kernel before it on
// the stream is still running, once every block of that kernel has run
// pdl::launch_dependents (or exited).  pdl::wait then blocks until that
// kernel has finished and its writes are visible.  The rule for every
// kernel launched this way: nothing before pdl::wait reads or writes global
// memory.  Its inputs may be the previous kernel's outputs, and its outputs
// buffers that the caching allocator has just taken back from a kernel
// still running.  Registers, shared memory and kernel parameters are free
// to use before it.  Launched without the attribute, both instructions
// return at once.
#pragma once

#include <utility>

#include <cuda_runtime.h>

namespace pdl {

// Let the next kernel on the stream launch now; call it first.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// Wait for the previous kernel on the stream to finish and flush.
__device__ __forceinline__ void wait() { asm volatile("griddepcontrol.wait;" ::: "memory"); }

// kernel<<<blocks, threads, 0, stream>>>(args...) with programmatic stream
// serialization allowed; returns the launch's error.
template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), unsigned blocks, unsigned threads,
                   cudaStream_t stream, Args&&... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
}

}  // namespace pdl
