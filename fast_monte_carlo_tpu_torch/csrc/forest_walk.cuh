// The tree walk of K5 (forest_eval.cu), shared with K1's exact-mode
// instantiation (nano_game.cu): the record layout's constants, the tile
// copies into shared memory (cp.async.bulk under an mbarrier a buffer) and
// a walk's level on a staged row (`walk_step`); each kernel walks kWalks
// trees of its row at once with it and adds the leaves to its class sums
// in tree order.  forest_eval.cu's header states the design;
// ops/forest_eval.py (pack_kernel_records) the layout.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace fw {

constexpr int kWalks = 8;         // trees a thread walks at once
constexpr int kGroups = 4;        // id slots at the front of a staged row
constexpr int kTileRecords = 4096;  // records a tile buffer: 32 KB
constexpr int kMaxFeatures = 64;
// the record's meta word (ops/forest_eval.py states the layout and limits)
constexpr unsigned kSlotMask = (1u << 9) - 1;  // byte offset of the row word read
constexpr unsigned kIsCat = 1u << 9;
constexpr unsigned kDefaultRight = 1u << 10;
constexpr unsigned kCatMatchRight = 1u << 11;
constexpr unsigned kCatMissRight = 1u << 12;
constexpr int kLeftShift = 17;  // the left child's byte offset in its tree
// the walk reads the three outcome bits as bit 3 (the right child's extra
// 8 bytes) after a shift
static_assert(kDefaultRight >> 7 == 8 && kCatMatchRight >> 8 == 8 && kCatMissRight >> 9 == 8,
              "outcome bits");
constexpr size_t kTileBytes = static_cast<size_t>(kTileRecords) * 8;

// a staged row's words: the kGroups ids, then n_feat features, at an odd
// stride (no bank conflict when a warp reads one slot)
__host__ __device__ inline int row_stride(int n_feat) { return (kGroups + n_feat) | 1; }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// the tile's bytes arrive on `bar`, which the calling thread arms for them
__device__ __forceinline__ void load_tile(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  // order this block's earlier reads of the buffer before the async write
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// One level of a walk: the record at `node` (a byte offset from its tree's
// root `root`, in a tile in shared memory) read, the row word it names read
// from the staged row `xr`, compared, and the byte offset of the child to
// go to returned.  LT: a numeric node goes left where the value is under its
// threshold (else at or under); ZAM: a value of 0.0 is missing and takes the
// node's default child.  A leaf (a categorical node that never goes right)
// returns its own offset, so a walk takes a fixed number of levels.
template <bool LT, bool ZAM>
__device__ __forceinline__ unsigned walk_step(const unsigned char* root, unsigned node,
                                              const unsigned char* xr) {
  const uint2 r = *reinterpret_cast<const uint2*>(root + node);
  const unsigned m = r.y;
  const unsigned w = *reinterpret_cast<const unsigned*>(xr + (m & kSlotMask));
  const float wf = __uint_as_float(w), th = __uint_as_float(r.x);
  // 8 (the right child's extra offset) or 0, kept as integers so that no
  // bool is materialised: the numeric compare, else a categorical node's
  // outcome bit (11 on a match, 12 otherwise; bit 3 after the shift)
  unsigned right = (LT ? wf < th : wf <= th) ? 0u : 8u;
  if (ZAM && wf == 0.0f) right = (m >> 7) & 8u;
  const unsigned cat_right = (m >> (w == r.x ? 8 : 9)) & 8u;
  right = (m & kIsCat) ? cat_right : right;
  return (m >> kLeftShift) + right;
}

}  // namespace fw
