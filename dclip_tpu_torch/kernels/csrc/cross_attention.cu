// The meta-teacher's bidirectional cross-attention, less its four
// projections (which run on gemm.cu):
//   core:    for each batch row b, head h and direction,
//              out[q, h*hd:(h+1)*hd] = softmax(mask(q_h k_h^T / sqrt(hd))) v_h
//            text queries over image keys (key mask: the image mask) and
//            image queries over text keys (key mask: the text mask), with
//            q, k and v read from the two f32 input-projection buffers
//            [B, S, 3D] = [q | k | v] of each stream;
//   add+LN:  y = LayerNorm(x + a) over rows of both streams, all in f32.
//
// Replaces: dclip_tpu/kernels/cross_attention.py `_kernel` (K10, line 74:
//   the body of `cross_attention_fused`, pallas_call at line 255), which
//   runs one TPU program per batch row with the 8 projection matrices
//   resident in VMEM. On Hopper the projections are four tiled bf16 GEMMs
//   over all rows of the batch (two [512, 1536] input projections of the
//   concatenated weights, two out-projections; gemm.cu, f32 outputs), and
//   this file holds what sits between and after them. The algebra is the
//   TPU kernel's: f32 logits with q scaled by head_dim**-0.5, a masked
//   logit becomes the finite -1e30 of `_NEG` (an image row with no valid
//   box averages the text values uniformly, never NaN), f32 softmax,
//   residual + LayerNorm (eps 1e-5, two-pass statistics) in f32.
// Bound on the H100: the whole of K10 at the distillation step's shapes
//   (B=256, T=77 text tokens, P=8 boxes, D=512, 8 heads) is ~46 GFLOP, 44 of
//   them in the projections on the tensor cores, over ~93 MB: ~0.047 ms at
//   the bf16 peak (operations bound it). The core below is ~0.6 GFLOP of f32
//   CUDA-core work over ~48 MB (its f32 q|k|v reads): bound by the bytes,
//   ~0.015 ms; the add+LN pass is bound by its ~134 MB of f32 traffic.
// Design: one block of 4 warps per (b, h, direction), keys <= 128, head
//   dim a multiple of 32 up to 128. The block stages the head's K and V
//   ([Sk, hd] f32, rows padded to hd + 1 words so lane j reading key row j
//   hits bank (j + c) % 32) and the key mask in shared memory; each warp
//   takes one query row at a time: the row's scaled q in shared memory
//   (broadcast), lane j holds the logits of keys j, j + 32, j + 64, j + 96
//   in registers, warp-shuffle max and sum, then each lane accumulates hd /
//   32 output columns over the keys with the weights broadcast by shuffle.
//   The output is rounded to bf16 once: it is the A operand of the
//   out-projection GEMM. add+LN: one warp per
//   row, float4 loads (D % 4 == 0), the passes after the first from L1.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kMaxCols = 4;  // head_dim <= 128: at most four output columns per lane

size_t core_smem_bytes(int sk, int hd) {
  return (static_cast<size_t>(2 * sk * (hd + 1)) + kWarps * hd + sk) * sizeof(float);
}

__global__ void __launch_bounds__(kWarps * 32)
    cross_attention_core_kernel(const float* __restrict__ qkv_t,
                                const float* __restrict__ qkv_i,
                                const float* __restrict__ text_mask,
                                const float* __restrict__ image_mask,
                                __nv_bfloat16* __restrict__ out_t,
                                __nv_bfloat16* __restrict__ out_i, int t, int p,
                                int d, int hd, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, h = blockIdx.y, image_queries = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ld = 3 * d;
  // Direction 0: text queries, image keys; direction 1: the reverse.
  const int sq = image_queries ? p : t;
  const int sk = image_queries ? t : p;
  const float* qsrc = image_queries ? qkv_i + static_cast<size_t>(b) * p * ld
                                    : qkv_t + static_cast<size_t>(b) * t * ld;
  const float* kvsrc = image_queries ? qkv_t + static_cast<size_t>(b) * t * ld
                                     : qkv_i + static_cast<size_t>(b) * p * ld;
  const float* mask = image_queries ? text_mask : image_mask;
  __nv_bfloat16* out = image_queries ? out_i + static_cast<size_t>(b) * p * d
                                     : out_t + static_cast<size_t>(b) * t * d;

  const int kv_ld = hd + 1, cols = hd / 32;
  float* ks = smem;
  float* vs = ks + sk * kv_ld;
  float* qs = vs + sk * kv_ld;
  float* keep = qs + kWarps * hd;
  const int col0 = h * hd;
  for (int i = threadIdx.x; i < sk * hd; i += kWarps * 32) {
    const int r = i / hd, c = i % hd;
    const float* row = kvsrc + static_cast<size_t>(r) * ld + col0 + c;
    ks[r * kv_ld + c] = row[d];
    vs[r * kv_ld + c] = row[2 * d];
  }
  for (int j = threadIdx.x; j < sk; j += kWarps * 32)
    keep[j] = (mask == nullptr || mask[static_cast<size_t>(b) * sk + j] > 0.f) ? 1.f : 0.f;
  __syncthreads();

  float* qw = qs + warp * hd;
  for (int r = warp; r < sq; r += kWarps) {
    const float* qrow = qsrc + static_cast<size_t>(r) * ld + col0;
    for (int c = lane; c < hd; c += 32) qw[c] = qrow[c] * scale;
    __syncwarp();
    float l[4];
    float m = -INFINITY;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int j = lane + 32 * s;
      l[s] = -INFINITY;  // slots past the keys: excluded, not keys of the row
      if (j < sk) {
        const float* kr = ks + j * kv_ld;
        float acc = 0.f;
#pragma unroll 16
        for (int c = 0; c < hd; ++c) acc += qw[c] * kr[c];
        l[s] = keep[j] > 0.f ? acc : dclip::kNegBig;
      }
      m = fmaxf(m, l[s]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(dclip::kFullMask, m, o));
    float e[4], sum = 0.f;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      e[s] = lane + 32 * s < sk ? expf(l[s] - m) : 0.f;
      sum += e[s];
    }
    const float inv = 1.f / dclip::warp_sum(sum);
    float o[kMaxCols] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      for (int jj = 0; jj < 32; ++jj) {
        const int j = 32 * s + jj;
        if (j >= sk) break;  // uniform across the warp
        const float pj = __shfl_sync(dclip::kFullMask, e[s], jj);
        const float* vr = vs + j * kv_ld + lane;
#pragma unroll
        for (int c = 0; c < kMaxCols; ++c)
          if (c < cols) o[c] += pj * vr[32 * c];
      }
    }
    __nv_bfloat16* orow = out + static_cast<size_t>(r) * d + col0 + lane;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c)
      if (c < cols) orow[32 * c] = __float2bfloat16_rn(o[c] * inv);
    __syncwarp();  // every lane has read qw before the next row overwrites it
  }
}

constexpr int kLnWarps = 8;

// Rows [0, rows0) of the first stream, then rows1 rows of the second.
__global__ void __launch_bounds__(kLnWarps * 32)
    add_layernorm_f32_kernel(const float* __restrict__ x0, const float* __restrict__ a0,
                             const float* __restrict__ s0, const float* __restrict__ b0,
                             float* __restrict__ y0, int rows0,
                             const float* __restrict__ x1, const float* __restrict__ a1,
                             const float* __restrict__ s1, const float* __restrict__ b1,
                             float* __restrict__ y1, int rows1, int d, float eps) {
  const int lane = threadIdx.x & 31;
  int row = blockIdx.x * kLnWarps + (threadIdx.x >> 5);
  if (row >= rows0 + rows1) return;
  const bool first = row < rows0;
  if (!first) row -= rows0;
  const size_t base = static_cast<size_t>(row) * d;
  const float4* x = reinterpret_cast<const float4*>((first ? x0 : x1) + base);
  const float4* a = reinterpret_cast<const float4*>((first ? a0 : a1) + base);
  const float* scale = first ? s0 : s1;
  const float* bias = first ? b0 : b1;
  float4* y = reinterpret_cast<float4*>((first ? y0 : y1) + base);
  const int chunks = d / 4;

  float sum = 0.f;
  for (int c = lane; c < chunks; c += 32) {
    const float4 u = x[c], v = a[c];
    sum += (u.x + v.x) + (u.y + v.y) + (u.z + v.z) + (u.w + v.w);
  }
  const float mean = dclip::warp_sum(sum) / d;
  float sq = 0.f;
  for (int c = lane; c < chunks; c += 32) {
    const float4 u = x[c], v = a[c];
    const float z0 = u.x + v.x - mean, z1 = u.y + v.y - mean;
    const float z2 = u.z + v.z - mean, z3 = u.w + v.w - mean;
    sq += z0 * z0 + z1 * z1 + z2 * z2 + z3 * z3;
  }
  const float rstd = rsqrtf(dclip::warp_sum(sq) / d + eps);
  for (int c = lane; c < chunks; c += 32) {
    const float4 u = x[c], v = a[c];
    const int i = 4 * c;
    y[c] = make_float4((u.x + v.x - mean) * rstd * scale[i] + bias[i],
                       (u.y + v.y - mean) * rstd * scale[i + 1] + bias[i + 1],
                       (u.z + v.z - mean) * rstd * scale[i + 2] + bias[i + 2],
                       (u.w + v.w - mean) * rstd * scale[i + 3] + bias[i + 3]);
  }
}

}  // namespace

// qkv_t: [b, t, 3d] f32, qkv_i: [b, p, 3d] f32, contiguous; text_mask [b, t]
// and image_mask [b, p] f32 (1 = valid key) or both null; out_t [b, t, d]
// and out_i [b, p, d] bf16. d = heads * hd with hd % 32 == 0 and hd <= 128;
// t, p in [1, 128].
extern "C" int dclip_cross_attention_core(const void* qkv_t, const void* qkv_i,
                                          const void* text_mask, const void* image_mask,
                                          void* out_t, void* out_i, int b, int t, int p,
                                          int d, int heads, void* stream) {
  const int hd = d / heads;
  const size_t smem = core_smem_bytes(t > p ? t : p, hd);
  cudaError_t err = cudaFuncSetAttribute(cross_attention_core_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(b, heads, 2);
  cross_attention_core_kernel<<<grid, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(qkv_t), static_cast<const float*>(qkv_i),
      static_cast<const float*>(text_mask), static_cast<const float*>(image_mask),
      static_cast<__nv_bfloat16*>(out_t), static_cast<__nv_bfloat16*>(out_i), t, p, d, hd,
      1.f / sqrtf(static_cast<float>(hd)));
  return static_cast<int>(cudaGetLastError());
}

// y_k = LayerNorm(x_k + a_k; scale_k, bias_k) for the two streams k = 0, 1:
// x, a, y [rows_k, d] f32, scale and bias [d] f32, all contiguous and
// 16-byte aligned, d % 4 == 0.
extern "C" int dclip_add_layernorm_f32(const void* x0, const void* a0, const void* s0,
                                       const void* b0, void* y0, int rows0, const void* x1,
                                       const void* a1, const void* s1, const void* b1,
                                       void* y1, int rows1, int d, float eps, void* stream) {
  const dim3 grid((rows0 + rows1 + kLnWarps - 1) / kLnWarps);
  add_layernorm_f32_kernel<<<grid, kLnWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x0), static_cast<const float*>(a0),
      static_cast<const float*>(s0), static_cast<const float*>(b0), static_cast<float*>(y0),
      rows0, static_cast<const float*>(x1), static_cast<const float*>(a1),
      static_cast<const float*>(s1), static_cast<const float*>(b1), static_cast<float*>(y1),
      rows1, d, eps);
  return static_cast<int>(cudaGetLastError());
}
