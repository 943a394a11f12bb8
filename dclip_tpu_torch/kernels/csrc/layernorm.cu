// LayerNorm over the last dimension: bf16 rows in, f32 scale and bias,
// bf16 rows out, statistics in f32. And its backward with respect to x
// for frozen scale and bias, plus a residual gradient:
//   dx = g + rstd (dxhat - mean(dxhat) - xhat mean(dxhat xhat)),
//   dxhat = dh * scale, statistics recomputed from x;
// and the same backward for a trainable LayerNorm, which also emits the
// weight gradients dscale = sum over rows of dh * xhat and dbias = sum of
// dh (dx optional), as per-block partials that reduce.cu sums.
//
// Replaces: the LN1 / LN2 prologue of dclip_tpu/kernels/vit_block.py
//   `_attn_kernel` (line 52) and `_mlp_kernel` (line 100), `_layer_norm`;
//   the backward replaces the LayerNorm tail of
//   dclip_tpu/kernels/mlp_frozen.py `_bwd_dx_kernel` (K6, lines 167-198),
//   which the TPU runs in VMEM on the [S, D] f32 dh it just accumulated;
//   here dh arrives in f32 from the second backward GEMM (gemm.cu). The
//   weight-gradient backward replaces the LayerNorm tails of
//   dclip_tpu/kernels/mlp_trainable.py `_bwd_a_kernel` (K8, lines 124-131:
//   dx and the dLN scale / bias accumulators) and of the K9 VJP,
//   attn_block_trainable.py:276-282 (LN1, computed in XLA there).
// Bound on the H100: memory. One row of D=768 bf16 is 1.5 KB and takes
//   ~5 flops per element, far below the ~295 flop/byte ridge.
// Design: one warp per row, 16-byte vector loads (D % 8 == 0), two f32
//   passes for mean and variance (the same two-pass formula as the TPU
//   kernel, no E[x^2]-E[x]^2 cancellation); the re-reads of the row hit
//   L1. The output is rounded to bf16 once, because the GEMM that reads it
//   runs on bf16 tensor cores. The backward keeps dh in f32 (as the TPU
//   does) and makes four passes over a row (mean, variance, the two
//   reductions, the output), all but the first from L1. In the
//   weight-gradient backward a warp walks rows with a grid stride; each
//   lane always holds the same 8-column chunks of a row, so it sums its
//   columns' dh * xhat and dh in registers across all its rows (d <= 1024:
//   at most 4 chunks a lane), the block's 8 warps add theirs into shared
//   memory one warp after another, and the block writes one partial.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;

__global__ void __launch_bounds__(kWarps * 32)
    layernorm_kernel(const __nv_bfloat16* __restrict__ x,
                     const float* __restrict__ scale,
                     const float* __restrict__ bias,
                     __nv_bfloat16* __restrict__ y, int rows, int d,
                     float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const __nv_bfloat16* xr = x + static_cast<size_t>(row) * d;
  __nv_bfloat16* yr = y + static_cast<size_t>(row) * d;
  const int chunks = d / 8;
  float f[8];

  float sum = 0.f;
  for (int c = lane; c < chunks; c += 32) {
    dclip::unpack8(*reinterpret_cast<const uint4*>(xr + c * 8), f);
#pragma unroll
    for (int e = 0; e < 8; ++e) sum += f[e];
  }
  const float mean = dclip::warp_sum(sum) / d;

  float sq = 0.f;
  for (int c = lane; c < chunks; c += 32) {
    dclip::unpack8(*reinterpret_cast<const uint4*>(xr + c * 8), f);
#pragma unroll
    for (int e = 0; e < 8; ++e) sq += (f[e] - mean) * (f[e] - mean);
  }
  const float rstd = rsqrtf(dclip::warp_sum(sq) / d + eps);

  for (int c = lane; c < chunks; c += 32) {
    dclip::unpack8(*reinterpret_cast<const uint4*>(xr + c * 8), f);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int i = c * 8 + e;
      f[e] = (f[e] - mean) * rstd * scale[i] + bias[i];
    }
    *reinterpret_cast<uint4*>(yr + c * 8) = dclip::pack8(f);
  }
}

__global__ void __launch_bounds__(kWarps * 32)
    layernorm_bwd_kernel(const __nv_bfloat16* __restrict__ x,
                         const __nv_bfloat16* __restrict__ g,
                         const float* __restrict__ dh, const float* __restrict__ scale,
                         __nv_bfloat16* __restrict__ dx, int rows, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const size_t base = static_cast<size_t>(row) * d;
  const __nv_bfloat16* xr = x + base;
  const int chunks = d / 8;
  float f[8];

  float sum = 0.f;
  for (int c = lane; c < chunks; c += 32) {
    dclip::unpack8(*reinterpret_cast<const uint4*>(xr + c * 8), f);
#pragma unroll
    for (int e = 0; e < 8; ++e) sum += f[e];
  }
  const float mean = dclip::warp_sum(sum) / d;
  float sq = 0.f;
  for (int c = lane; c < chunks; c += 32) {
    dclip::unpack8(*reinterpret_cast<const uint4*>(xr + c * 8), f);
#pragma unroll
    for (int e = 0; e < 8; ++e) sq += (f[e] - mean) * (f[e] - mean);
  }
  const float rstd = rsqrtf(dclip::warp_sum(sq) / d + eps);

  float s1 = 0.f, s2 = 0.f;
  for (int c = lane; c < chunks; c += 32) {
    dclip::unpack8(*reinterpret_cast<const uint4*>(xr + c * 8), f);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int i = c * 8 + e;
      const float dxhat = dh[base + i] * scale[i];
      s1 += dxhat;
      s2 += dxhat * (f[e] - mean) * rstd;
    }
  }
  const float m1 = dclip::warp_sum(s1) / d, m2 = dclip::warp_sum(s2) / d;

  for (int c = lane; c < chunks; c += 32) {
    float gv[8];
    dclip::unpack8(*reinterpret_cast<const uint4*>(xr + c * 8), f);
    dclip::unpack8(*reinterpret_cast<const uint4*>(g + base + c * 8), gv);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int i = c * 8 + e;
      const float xhat = (f[e] - mean) * rstd;
      gv[e] += rstd * (dh[base + i] * scale[i] - m1 - xhat * m2);
    }
    *reinterpret_cast<uint4*>(dx + base + c * 8) = dclip::pack8(gv);
  }
}


constexpr int kMaxChunks = 4;  // 8-column chunks per lane: d <= 32 * 8 * 4

__global__ void __launch_bounds__(kWarps * 32)
    layernorm_bwd_wgrad_kernel(const __nv_bfloat16* __restrict__ x,
                               const __nv_bfloat16* __restrict__ g,
                               const float* __restrict__ dh, const float* __restrict__ scale,
                               __nv_bfloat16* __restrict__ dx, float* __restrict__ part,
                               int rows, int d, float eps) {
  __shared__ float red[2][32 * 8 * kMaxChunks];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int chunks = d / 8;
  float acc_s[kMaxChunks][8], acc_b[kMaxChunks][8];
#pragma unroll
  for (int i = 0; i < kMaxChunks; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc_s[i][e] = acc_b[i][e] = 0.f;

  for (int row = blockIdx.x * kWarps + warp; row < rows; row += gridDim.x * kWarps) {
    const size_t base = static_cast<size_t>(row) * d;
    const __nv_bfloat16* xr = x + base;
    float f[8];
    float sum = 0.f;
    for (int c = lane; c < chunks; c += 32) {
      dclip::unpack8(*reinterpret_cast<const uint4*>(xr + c * 8), f);
#pragma unroll
      for (int e = 0; e < 8; ++e) sum += f[e];
    }
    const float mean = dclip::warp_sum(sum) / d;
    float sq = 0.f;
    for (int c = lane; c < chunks; c += 32) {
      dclip::unpack8(*reinterpret_cast<const uint4*>(xr + c * 8), f);
#pragma unroll
      for (int e = 0; e < 8; ++e) sq += (f[e] - mean) * (f[e] - mean);
    }
    const float rstd = rsqrtf(dclip::warp_sum(sq) / d + eps);

    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxChunks; ++i) {
      const int c = lane + 32 * i;
      if (c < chunks) {
        float hv[8];
        dclip::unpack8(*reinterpret_cast<const uint4*>(xr + c * 8), f);
        const float4 h0 = *reinterpret_cast<const float4*>(dh + base + c * 8);
        const float4 h1 = *reinterpret_cast<const float4*>(dh + base + c * 8 + 4);
        hv[0] = h0.x, hv[1] = h0.y, hv[2] = h0.z, hv[3] = h0.w;
        hv[4] = h1.x, hv[5] = h1.y, hv[6] = h1.z, hv[7] = h1.w;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float xhat = (f[e] - mean) * rstd;
          const float dxhat = hv[e] * scale[c * 8 + e];
          s1 += dxhat;
          s2 += dxhat * xhat;
          acc_s[i][e] += hv[e] * xhat;
          acc_b[i][e] += hv[e];
        }
      }
    }
    if (dx == nullptr) continue;
    const float m1 = dclip::warp_sum(s1) / d, m2 = dclip::warp_sum(s2) / d;
    for (int c = lane; c < chunks; c += 32) {
      float gv[8];
      dclip::unpack8(*reinterpret_cast<const uint4*>(xr + c * 8), f);
      dclip::unpack8(*reinterpret_cast<const uint4*>(g + base + c * 8), gv);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int i = c * 8 + e;
        const float xhat = (f[e] - mean) * rstd;
        gv[e] += rstd * (dh[base + i] * scale[i] - m1 - xhat * m2);
      }
      *reinterpret_cast<uint4*>(dx + base + c * 8) = dclip::pack8(gv);
    }
  }

  for (int i = threadIdx.x; i < 2 * d; i += blockDim.x) red[i / d][i % d] = 0.f;
  __syncthreads();
  for (int w = 0; w < kWarps; ++w) {  // warp order: the same sums every run
    if (warp == w) {
#pragma unroll
      for (int i = 0; i < kMaxChunks; ++i) {
        const int c = lane + 32 * i;
        if (c < chunks) {
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            red[0][c * 8 + e] += acc_s[i][e];
            red[1][c * 8 + e] += acc_b[i][e];
          }
        }
      }
    }
    __syncthreads();
  }
  float* out = part + static_cast<size_t>(blockIdx.x) * 2 * d;
  for (int i = threadIdx.x; i < 2 * d; i += blockDim.x) out[i] = red[i / d][i % d];
}

}  // namespace

// x, y: [rows, d] bf16, contiguous, 16-byte aligned; scale, bias: [d] f32.
extern "C" int dclip_layernorm_bf16(const void* x, const void* scale,
                                    const void* bias, void* y, int rows,
                                    int d, float eps, void* stream) {
  const dim3 grid((rows + kWarps - 1) / kWarps);
  layernorm_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(y), rows, d,
      eps);
  return static_cast<int>(cudaGetLastError());
}

// x, g, dx: [rows, d] bf16; dh: [rows, d] f32; scale: [d] f32; all
// contiguous and 16-byte aligned, d % 8 == 0.
extern "C" int dclip_layernorm_bwd_bf16(const void* x, const void* g, const void* dh,
                                        const void* scale, void* dx, int rows, int d,
                                        float eps, void* stream) {
  const dim3 grid((rows + kWarps - 1) / kWarps);
  layernorm_bwd_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(g),
      static_cast<const float*>(dh), static_cast<const float*>(scale),
      static_cast<__nv_bfloat16*>(dx), rows, d, eps);
  return static_cast<int>(cudaGetLastError());
}

// x, g: [rows, d] bf16; dh: [rows, d] f32; scale: [d] f32; dx: [rows, d]
// bf16 or null (no input gradient wanted); part: [blocks, 2, d] f32, block
// b's (sum dh * xhat, sum dh) over its rows; all contiguous and 16-byte
// aligned, d % 8 == 0, d <= 1024. Sum `part` over blocks with
// dclip_reduce_rows_f32 (n = 2 * d) for (dscale, dbias).
extern "C" int dclip_layernorm_bwd_wgrad_bf16(const void* x, const void* g, const void* dh,
                                              const void* scale, void* dx, void* part,
                                              int rows, int d, float eps, int blocks,
                                              void* stream) {
  layernorm_bwd_wgrad_kernel<<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(g),
      static_cast<const float*>(dh), static_cast<const float*>(scale),
      static_cast<__nv_bfloat16*>(dx), static_cast<float*>(part), rows, d, eps);
  return static_cast<int>(cudaGetLastError());
}
