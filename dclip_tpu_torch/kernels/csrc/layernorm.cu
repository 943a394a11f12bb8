// LayerNorm over the last dimension: bf16 rows in, f32 scale and bias,
// bf16 rows out, statistics in f32. And its backward with respect to x
// for frozen scale and bias, plus a residual gradient:
//   dx = g + rstd (dxhat - mean(dxhat) - xhat mean(dxhat xhat)),
//   dxhat = dh * scale, statistics recomputed from x;
// and the same backward for a trainable LayerNorm, which also emits the
// weight gradients dscale = sum over rows of dh * xhat and dbias = sum of
// dh (dx optional), as per-block partials that reduce.cu sums. d % 8 == 0
// and d <= 1280 (every width of the supported presets: 1,152 is SigLIP
// so400m's).
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
//   ~5 flops per element, far below the ~295 flop/byte ridge: the forward
//   moves 4 bytes an element (bf16 in, bf16 out), the backward 10 (x, g,
//   dx bf16, dh f32).
// Design: one warp per row with the row in registers, read once from
//   device memory and written once. A lane holds kVec = ceil(d / 256)
//   16-byte vectors of the row (8 columns each; 2, 3, 4 at d = 512, 768,
//   1024; 5 at 1,152, whose fifth vector half the lanes hold, in kernels of
//   one block an SM with the registers that takes), a template parameter,
//   so every load of a row is unrolled and
//   issued before the first is used; other widths take the same kernels
//   with the vectors past d predicated off. Mean and variance are the
//   TPU kernel's two passes (no E[x^2]-E[x]^2 cancellation), both over
//   the registers. Warps walk the rows with a grid stride, one wave of
//   resident blocks, so the forward reads scale and bias (f32, as float4)
//   once per warp and keeps them in registers across its rows, and the
//   frozen backward does the same with scale. The output is rounded to
//   bf16 once, because the GEMM that reads it runs on bf16 tensor cores.
//   The backward holds x, g and dh (f32, as float4) of a row in registers.
//   In the weight-gradient backward each lane always holds the same
//   8-column chunks, so it sums its columns' dh * xhat and dh in registers
//   across all its rows (that kernel reads scale per row, as float4 from
//   L1, to leave the registers to those sums); the block's 8 warps add
//   theirs into shared memory one warp after another, and the block writes
//   one partial: every sum in a fixed order, the same bits every run.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kMaxVec = 5;  // 16-byte vectors per lane: d <= 32 * 8 * 5

// Resident blocks an SM of a kVec-vector kernel: two up to d = 1024, one
// beyond (a row of x, g, dh and the scale in registers outgrows 128 a thread).
template <int kVec>
constexpr int kBlocksPerSm = kVec > 4 ? 1 : 2;

// Whether vector i of this lane lies inside the row (always, when exact).
template <bool kExact>
__device__ __forceinline__ bool has(int i, int lane, int chunks) {
  return kExact || lane + 32 * i < chunks;
}

__device__ __forceinline__ void load8(const float* __restrict__ p, float* f) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
  f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}

// Mean and 1 / std of the row held in xv, two passes over the registers.
template <int kVec, bool kExact>
__device__ __forceinline__ void row_stats(const uint4 (&xv)[kVec], int lane, int chunks, int d,
                                          float eps, float& mean, float& rstd) {
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    if (!has<kExact>(i, lane, chunks)) continue;
    float f[8];
    dclip::unpack8(xv[i], f);
#pragma unroll
    for (int e = 0; e < 8; ++e) sum += f[e];
  }
  mean = dclip::warp_sum(sum) / d;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    if (!has<kExact>(i, lane, chunks)) continue;
    float f[8];
    dclip::unpack8(xv[i], f);
#pragma unroll
    for (int e = 0; e < 8; ++e) sq += (f[e] - mean) * (f[e] - mean);
  }
  rstd = rsqrtf(dclip::warp_sum(sq) / d + eps);
}

template <int kVec, bool kExact>
__device__ __forceinline__ void load_row(uint4 (&v)[kVec], const __nv_bfloat16* __restrict__ row,
                                         int lane, int chunks) {
#pragma unroll
  for (int i = 0; i < kVec; ++i)
    v[i] = has<kExact>(i, lane, chunks)
               ? *reinterpret_cast<const uint4*>(row + (lane + 32 * i) * 8)
               : make_uint4(0, 0, 0, 0);
}

template <int kVec, bool kExact>
__global__ void __launch_bounds__(kWarps * 32, kBlocksPerSm<kVec>)
    layernorm_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ scale,
                     const float* __restrict__ bias, __nv_bfloat16* __restrict__ y, int rows,
                     int d, float eps) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, chunks = d / 8;
  float sc[kVec][8], bi[kVec][8];
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    if (has<kExact>(i, lane, chunks)) {
      load8(scale + (lane + 32 * i) * 8, sc[i]);
      load8(bias + (lane + 32 * i) * 8, bi[i]);
    }
  }
  for (int row = blockIdx.x * kWarps + warp; row < rows; row += gridDim.x * kWarps) {
    const size_t base = static_cast<size_t>(row) * d;
    uint4 xv[kVec];
    load_row<kVec, kExact>(xv, x + base, lane, chunks);
    float mean, rstd;
    row_stats<kVec, kExact>(xv, lane, chunks, d, eps, mean, rstd);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      if (!has<kExact>(i, lane, chunks)) continue;
      float f[8];
      dclip::unpack8(xv[i], f);
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = (f[e] - mean) * rstd * sc[i][e] + bi[i][e];
      *reinterpret_cast<uint4*>(y + base + (lane + 32 * i) * 8) = dclip::pack8(f);
    }
  }
}

template <int kVec, bool kExact>
__global__ void __launch_bounds__(kWarps * 32, kBlocksPerSm<kVec>)
    layernorm_bwd_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ g,
                         const float* __restrict__ dh, const float* __restrict__ scale,
                         __nv_bfloat16* __restrict__ dx, int rows, int d, float eps) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, chunks = d / 8;
  float sc[kVec][8];
#pragma unroll
  for (int i = 0; i < kVec; ++i)
    if (has<kExact>(i, lane, chunks)) load8(scale + (lane + 32 * i) * 8, sc[i]);
  for (int row = blockIdx.x * kWarps + warp; row < rows; row += gridDim.x * kWarps) {
    const size_t base = static_cast<size_t>(row) * d;
    uint4 xv[kVec], gv[kVec];
    float hv[kVec][8];
    load_row<kVec, kExact>(xv, x + base, lane, chunks);
    load_row<kVec, kExact>(gv, g + base, lane, chunks);
#pragma unroll
    for (int i = 0; i < kVec; ++i)
      if (has<kExact>(i, lane, chunks)) load8(dh + base + (lane + 32 * i) * 8, hv[i]);
    float mean, rstd;
    row_stats<kVec, kExact>(xv, lane, chunks, d, eps, mean, rstd);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      if (!has<kExact>(i, lane, chunks)) continue;
      float f[8];
      dclip::unpack8(xv[i], f);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float dxhat = hv[i][e] * sc[i][e];
        s1 += dxhat;
        s2 += dxhat * (f[e] - mean) * rstd;
      }
    }
    const float m1 = dclip::warp_sum(s1) / d, m2 = dclip::warp_sum(s2) / d;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      if (!has<kExact>(i, lane, chunks)) continue;
      float f[8], o[8];
      dclip::unpack8(xv[i], f);
      dclip::unpack8(gv[i], o);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float xhat = (f[e] - mean) * rstd;
        o[e] += rstd * (hv[i][e] * sc[i][e] - m1 - xhat * m2);
      }
      *reinterpret_cast<uint4*>(dx + base + (lane + 32 * i) * 8) = dclip::pack8(o);
    }
  }
}

template <int kVec, bool kExact>
__global__ void __launch_bounds__(kWarps * 32)
    layernorm_bwd_wgrad_kernel(const __nv_bfloat16* __restrict__ x,
                               const __nv_bfloat16* __restrict__ g,
                               const float* __restrict__ dh, const float* __restrict__ scale,
                               __nv_bfloat16* __restrict__ dx, float* __restrict__ part,
                               int rows, int d, float eps) {
  __shared__ float red[2][32 * 8 * (kVec > 4 ? kVec : 4)];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, chunks = d / 8;
  float acc_s[kVec][8], acc_b[kVec][8];
#pragma unroll
  for (int i = 0; i < kVec; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc_s[i][e] = acc_b[i][e] = 0.f;

  for (int row = blockIdx.x * kWarps + warp; row < rows; row += gridDim.x * kWarps) {
    const size_t base = static_cast<size_t>(row) * d;
    uint4 xv[kVec], gv[kVec];
    float hv[kVec][8];
    load_row<kVec, kExact>(xv, x + base, lane, chunks);
    if (dx != nullptr) load_row<kVec, kExact>(gv, g + base, lane, chunks);
#pragma unroll
    for (int i = 0; i < kVec; ++i)
      if (has<kExact>(i, lane, chunks)) load8(dh + base + (lane + 32 * i) * 8, hv[i]);
    float mean, rstd;
    row_stats<kVec, kExact>(xv, lane, chunks, d, eps, mean, rstd);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      if (!has<kExact>(i, lane, chunks)) continue;
      float f[8], sc[8];
      dclip::unpack8(xv[i], f);
      load8(scale + (lane + 32 * i) * 8, sc);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float xhat = (f[e] - mean) * rstd;
        const float dxhat = hv[i][e] * sc[e];
        s1 += dxhat;
        s2 += dxhat * xhat;
        acc_s[i][e] += hv[i][e] * xhat;
        acc_b[i][e] += hv[i][e];
      }
    }
    if (dx == nullptr) continue;
    const float m1 = dclip::warp_sum(s1) / d, m2 = dclip::warp_sum(s2) / d;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      if (!has<kExact>(i, lane, chunks)) continue;
      float f[8], o[8], sc[8];
      dclip::unpack8(xv[i], f);
      dclip::unpack8(gv[i], o);
      load8(scale + (lane + 32 * i) * 8, sc);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float xhat = (f[e] - mean) * rstd;
        o[e] += rstd * (hv[i][e] * sc[e] - m1 - xhat * m2);
      }
      *reinterpret_cast<uint4*>(dx + base + (lane + 32 * i) * 8) = dclip::pack8(o);
    }
  }

  for (int i = threadIdx.x; i < 2 * d; i += blockDim.x) red[i / d][i % d] = 0.f;
  __syncthreads();
  for (int w = 0; w < kWarps; ++w) {  // warp order: the same sums every run
    if (warp == w) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        if (!has<kExact>(i, lane, chunks)) continue;
        const int c = lane + 32 * i;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          red[0][c * 8 + e] += acc_s[i][e];
          red[1][c * 8 + e] += acc_b[i][e];
        }
      }
    }
    __syncthreads();
  }
  float* out = part + static_cast<size_t>(blockIdx.x) * 2 * d;
  for (int i = threadIdx.x; i < 2 * d; i += blockDim.x) out[i] = red[i / d][i % d];
}

// Blocks of `kernel` resident on the whole card at once: the grid of the
// row-walking kernels, capped by the rows.
template <typename Kernel>
int resident_grid(Kernel kernel, int rows) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kWarps * 32, 0);
  const int want = (rows + kWarps - 1) / kWarps;
  return want < per_sm * sms ? want : (per_sm > 0 ? per_sm * sms : 1);
}

// Calls launch(kernel template instance) for d's vector count: exact at
// 512, 768, 1024, predicated otherwise. d % 8 != 0 or d > 1280: refused.
template <typename Launch>
int dispatch(int d, Launch&& launch) {
  if (d <= 0 || d % 8 || d > 32 * 8 * kMaxVec) return static_cast<int>(cudaErrorInvalidValue);
  switch (d) {
    case 512: return launch(std::integral_constant<int, 2>{}, std::true_type{});
    case 768: return launch(std::integral_constant<int, 3>{}, std::true_type{});
    case 1024: return launch(std::integral_constant<int, 4>{}, std::true_type{});
    default: break;
  }
  switch ((d / 8 + 31) / 32) {
    case 1: return launch(std::integral_constant<int, 1>{}, std::false_type{});
    case 2: return launch(std::integral_constant<int, 2>{}, std::false_type{});
    case 3: return launch(std::integral_constant<int, 3>{}, std::false_type{});
    case 4: return launch(std::integral_constant<int, 4>{}, std::false_type{});
    default: return launch(std::integral_constant<int, 5>{}, std::false_type{});
  }
}

}  // namespace

// x, y: [rows, d] bf16, contiguous, 16-byte aligned; scale, bias: [d] f32,
// 16-byte aligned; d % 8 == 0, d <= 1280.
extern "C" int dclip_layernorm_bf16(const void* x, const void* scale,
                                    const void* bias, void* y, int rows,
                                    int d, float eps, void* stream) {
  return dispatch(d, [&](auto vec, auto exact) {
    constexpr int kVec = decltype(vec)::value;
    constexpr bool kExact = decltype(exact)::value;
    auto kernel = layernorm_kernel<kVec, kExact>;
    kernel<<<resident_grid(kernel, rows), kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(scale),
        static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(y), rows, d, eps);
    return static_cast<int>(cudaGetLastError());
  });
}

// x, g, dx: [rows, d] bf16; dh: [rows, d] f32; scale: [d] f32; all
// contiguous and 16-byte aligned, d % 8 == 0, d <= 1280.
extern "C" int dclip_layernorm_bwd_bf16(const void* x, const void* g, const void* dh,
                                        const void* scale, void* dx, int rows, int d,
                                        float eps, void* stream) {
  return dispatch(d, [&](auto vec, auto exact) {
    constexpr int kVec = decltype(vec)::value;
    constexpr bool kExact = decltype(exact)::value;
    auto kernel = layernorm_bwd_kernel<kVec, kExact>;
    kernel<<<resident_grid(kernel, rows), kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(g),
        static_cast<const float*>(dh), static_cast<const float*>(scale),
        static_cast<__nv_bfloat16*>(dx), rows, d, eps);
    return static_cast<int>(cudaGetLastError());
  });
}

// x, g: [rows, d] bf16; dh: [rows, d] f32; scale: [d] f32; dx: [rows, d]
// bf16 or null (no input gradient wanted); part: [blocks, 2, d] f32, block
// b's (sum dh * xhat, sum dh) over its rows; all contiguous and 16-byte
// aligned, d % 8 == 0, d <= 1280. Sum `part` over blocks with
// dclip_reduce_rows_f32 (n = 2 * d) for (dscale, dbias).
extern "C" int dclip_layernorm_bwd_wgrad_bf16(const void* x, const void* g, const void* dh,
                                              const void* scale, void* dx, void* part,
                                              int rows, int d, float eps, int blocks,
                                              void* stream) {
  return dispatch(d, [&](auto vec, auto exact) {
    constexpr int kVec = decltype(vec)::value;
    constexpr bool kExact = decltype(exact)::value;
    layernorm_bwd_wgrad_kernel<kVec, kExact>
        <<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(g),
            static_cast<const float*>(dh), static_cast<const float*>(scale),
            static_cast<__nv_bfloat16*>(dx), static_cast<float*>(part), rows, d, eps);
    return static_cast<int>(cudaGetLastError());
  });
}
