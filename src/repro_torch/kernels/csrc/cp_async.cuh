// cp.async helpers shared by the port's streaming kernels (sm_80 and later).
#pragma once

namespace cpasync {

// Copy `Bytes` bytes (4, 8 or 16; 16 bypasses L1) from global to shared
// memory without going through registers.  Only `src_bytes` of them are read
// from `src` (0 reads nothing, and `src` may then be any valid pointer); the
// rest of the destination is zero-filled.  Both addresses must be aligned to
// `Bytes`.
template <int Bytes>
__device__ __forceinline__ void copy(void* dst, const void* src,
                                     int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (Bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(src_bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                 "l"(src), "n"(Bytes), "r"(src_bytes));
  }
}

// Close the group of copies issued since the last commit.
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most `Pending` committed groups are still in flight.
template <int Pending>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending));
}

}  // namespace cpasync
