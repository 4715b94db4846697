// Staging rows of a row-major (frames, width) float map into shared memory
// with cp.async, one commit group a call: the serial kernels (mas.cu, ctc.cu)
// consume one chunk of frames while the next is in flight.
#pragma once

#include <cstddef>

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// frames [lo, hi) of a (frames, width) map into dst, by every thread of the
// block, as one cp.async group
__device__ __forceinline__ void stage_frames(float* dst, const float* map, int lo, int hi,
                                             int width) {
  const float* src = map + static_cast<size_t>(lo) * width;
  const int n = (hi - lo) * width;
  for (int k = threadIdx.x; k < n; k += blockDim.x) cp_async4(dst + k, src + k);
  cp_async_commit();
}
