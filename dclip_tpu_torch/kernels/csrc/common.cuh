// Shared helpers for the Hopper encoder-block kernels (sm_90a).
//
// Every kernel here takes raw device pointers and a cudaStream_t from the
// Python wrapper (kernels/vit_block.py), launches on that stream, never
// synchronises and never allocates. Each extern "C" entry point returns
// cudaGetLastError() after its launch so that a refused launch (too much
// shared memory, bad grid) reaches Python as an exception.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dclip {

constexpr unsigned kFullMask = 0xffffffffu;
// The TPU kernels' finite mask value (`_NEG` in kernels/vit_attention.py):
// exp2(kNegBig - m) is 0 against any real row max and 1 in a row whose
// every key is masked, never NaN.
constexpr float kNegBig = -1e30f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

// 16-byte global -> shared copy through cp.async; when `pred` is false
// nothing is read and the 16 destination bytes are zero-filled (the
// ragged-edge mask of every tile load).
__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem,
                                            bool pred) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Eight bf16 values <-> one 16-byte vector.
__device__ __forceinline__ void unpack8(const uint4& v, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float* f) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return v;
}

// Rows [r0, r0 + 64) x 64 bf16 columns of `src` (already offset to its
// first column; row stride `ld` elements) into a [64, ldd] shared tile,
// by NT threads in 16-byte vectors; rows >= rows_valid are zero.
template <int NT>
__device__ __forceinline__ void load_tile64(__nv_bfloat16* dst, int ldd,
                                            const __nv_bfloat16* __restrict__ src,
                                            int r0, int rows_valid, int ld) {
#pragma unroll
  for (int i = 0; i < (64 * 8) / NT; ++i) {
    const int c = threadIdx.x + i * NT;
    const int row = c >> 3, c8 = (c & 7) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r0 + row < rows_valid)
      v = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r0 + row) * ld + c8);
    *reinterpret_cast<uint4*>(dst + row * ldd + c8) = v;
  }
}

}  // namespace dclip
