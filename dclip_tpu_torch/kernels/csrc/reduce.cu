// Reductions over rows, in two passes without atomics:
//   colsum_partial  part[z][j] = sum of x[r][j] over the rows r of split z
//                   (x bf16 [rows, n]), f32 sums;
//   reduce_rows     out[j] = sum over z of part[z][j], in split order: the
//                   second pass of colsum_partial, of gemm.cu's split
//                   weight-gradient mode and of layernorm.cu's weight-
//                   gradient partials.
// The order of every sum depends only on the shapes, so a result is the
// same from run to run (a resumed run repeats an uninterrupted one bit
// for bit).
//
// Replaces: the bias-gradient row sums of dclip_tpu/kernels/mlp_trainable.py
//   (K8: db2 = sum g at line 123 in `_bwd_a_kernel`, db1 = sum da1 at line
//   166 in `_bwd_b_kernel`) and of the K9 VJP in attn_block_trainable.py
//   (dbo, dbq, dbk, dbv at lines 245, 267-269). The TPU accumulates them in
//   VMEM across its sequential batch grid; Hopper blocks run in no order,
//   so each block writes a partial and a second launch sums them.
// Bound on the H100: memory. A column sum reads each bf16 element once
//   for one add; the second pass reads splits x n f32.
// Design: colsum_partial runs blocks of 32 x 8 threads; a thread owns 8
//   adjacent columns (one 16-byte load per row) and every 8th row of its
//   split, and the 8 row-strided sums of a column meet in shared memory.
//   reduce_rows gives each thread one output column (coalesced reads of
//   every split's row).
#include "common.cuh"

namespace {

constexpr int kColsPerBlock = 256;  // 32 threads x 8 columns

__global__ void __launch_bounds__(256)
    colsum_partial_kernel(const __nv_bfloat16* __restrict__ x, float* __restrict__ part,
                          int rows, int n, int rows_per_split) {
  __shared__ float red[8][kColsPerBlock];
  const int col = blockIdx.x * kColsPerBlock + threadIdx.x * 8;
  const int r0 = blockIdx.y * rows_per_split;
  const int r1 = min(rows, r0 + rows_per_split);
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (col < n) {
    for (int r = r0 + threadIdx.y; r < r1; r += 8) {
      float f[8];
      dclip::unpack8(*reinterpret_cast<const uint4*>(x + static_cast<size_t>(r) * n + col), f);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] += f[e];
    }
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) red[threadIdx.y][threadIdx.x * 8 + e] = acc[e];
  __syncthreads();
  if (threadIdx.y == 0 && col < n) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float s = 0.f;
#pragma unroll
      for (int y = 0; y < 8; ++y) s += red[y][threadIdx.x * 8 + e];
      part[static_cast<size_t>(blockIdx.y) * n + col + e] = s;
    }
  }
}

__global__ void __launch_bounds__(256)
    reduce_rows_kernel(const float* __restrict__ part, float* __restrict__ out, int splits,
                       int n) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += part[static_cast<size_t>(z) * n + j];
  out[j] = s;
}

}  // namespace

// x: [rows, n] bf16 row-major, 16-byte aligned, n % 8 == 0; part: [splits,
// n] f32; split z sums rows [z * rows_per_split, (z + 1) * rows_per_split).
extern "C" int dclip_colsum_partial_bf16(const void* x, void* part, int rows, int n,
                                         int rows_per_split, int splits, void* stream) {
  const dim3 grid((n + kColsPerBlock - 1) / kColsPerBlock, splits);
  colsum_partial_kernel<<<grid, dim3(32, 8), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<float*>(part), rows, n,
      rows_per_split);
  return static_cast<int>(cudaGetLastError());
}

// part: [splits, n] f32, out: [n] f32.
extern "C" int dclip_reduce_rows_f32(const void* part, void* out, int splits, int n,
                                     void* stream) {
  reduce_rows_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), static_cast<float*>(out), splits, n);
  return static_cast<int>(cudaGetLastError());
}
