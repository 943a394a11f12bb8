// The student objective of the distillation step, forward and backward:
//   L = li + lt + w lc,   li = 1 - mean_i cos(si_i, ti_i),
//   lt = 1 - mean_i cos(st_i, tt_i),
//   lc = (mean_i lse_row_i + mean_j lse_col_j) / 2 - mean_i Z_ii,
//   Z = si^ st^T / T (rows normalised, T the InfoNCE temperature),
// with the closed-form gradients for the student rows si, st:
//   gZ = c_lc ((P_row - I) + (P_col - I)) / (2 B T),
//   g_si = -(c_li / B) ti^ + gZ st^,  g_st = -(c_lt / B) tt^ + gZ^T si^,
//   dsi = (g_si - <g_si, si^> si^) / |si|   (and dst alike),
// where c_li, c_lt, c_lc are the cotangent weights of the four parts.
// si, st bf16 [B, D] (the student's compute dtype); ti, tt f32 [B, D]
// (the cached teacher targets); all arithmetic in f32.
//
// Replaces: dclip_tpu/kernels/distill_loss.py `_fwd_kernel` (K11, line 47)
//   and `_bwd_kernel` (line 73), called by `_run_fwd` / `_run_bwd` (lines
//   115 / 132). The TPU runs each as one program with the [B, B] matrix Z
//   resident in VMEM (hence its B <= 1024 bound). Hopper blocks run in
//   parallel with no order between them, so here each direction of Z gets
//   one block per row (block (i, 0): row i of Z; block (i, 1): column i),
//   which recomputes its row of Z from the inputs; a small second pass
//   reduces to the four scalars (forward) or the gradient rows (backward).
//   No [B, B] tensor reaches device memory, and, as on the TPU, the
//   backward saves no residual: it recomputes the log-sum-exps.
// Bound on the H100: at B = 256, D = 512 it is 2 x 34 MFLOP and 0.5 MB of
//   input per pass: latency-bound (4 launches of 512 / 1 blocks). The
//   design keeps it to those launches and reads each input row from L2.
// Design: 256 threads per block; the block's own row is normalised into
//   shared memory; each warp walks every 8th other row with 16-byte loads,
//   keeps an online log-sum-exp (forward) or a per-lane gradient
//   accumulator of D / 32 floats (backward); warps combine in shared
//   memory. D % 8 == 0 and D <= 1024.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kMaxD = 1024, kMaxChunks = kMaxD / (32 * 8);
constexpr float kEps = 1e-12f;

__device__ float block_sum(float v, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  v = dclip::warp_sum(v);
  __syncthreads();  // red is free
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += red[w];
  return t;
}

__device__ __forceinline__ float inv_norm(float sq) { return rsqrtf(fmaxf(sq, kEps * kEps)); }

// Row `row` of a [B, D] bf16 or f32 matrix into shared f32 `dst`,
// normalised; returns 1 / |row| (clamped as the TPU kernel clamps it).
__device__ float load_normalised(float* dst, const __nv_bfloat16* bf, const float* f32,
                                 int row, int d, float* red) {
  float sq = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const size_t at = static_cast<size_t>(row) * d + i;
    const float v = bf != nullptr ? __bfloat162float(bf[at]) : f32[at];
    dst[i] = v;
    sq += v * v;
  }
  const float inv = inv_norm(block_sum(sq, red));
  for (int i = threadIdx.x; i < d; i += kThreads) dst[i] *= inv;
  __syncthreads();
  return inv;
}

// z = <anchor^, other_r^> / T over the warp's lanes; the lane keeps its
// chunks of the raw other row in f and gets 1 / |other_r| in inv.
__device__ __forceinline__ float row_logit(const float* anchor, const __nv_bfloat16* other,
                                           int r, int d, float temperature,
                                           float (&f)[kMaxChunks][8], float& inv) {
  const int lane = threadIdx.x & 31, chunks = d / 8;
  float dot = 0.f, sq = 0.f;
#pragma unroll
  for (int cc = 0; cc < kMaxChunks; ++cc) {
    const int c = lane + 32 * cc;
    if (c < chunks) {
      dclip::unpack8(*reinterpret_cast<const uint4*>(other + static_cast<size_t>(r) * d + c * 8),
                     f[cc]);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        dot += anchor[c * 8 + e] * f[cc][e];
        sq += f[cc][e] * f[cc][e];
      }
    }
  }
  inv = inv_norm(dclip::warp_sum(sq));
  return dclip::warp_sum(dot) * inv / temperature;
}

// part: [5, B] f32 = lse_row, lse_col, diag Z, cos(si, ti), cos(st, tt).
__global__ void __launch_bounds__(kThreads)
    distill_lse_kernel(const __nv_bfloat16* __restrict__ si,
                       const __nv_bfloat16* __restrict__ st, const float* __restrict__ ti,
                       const float* __restrict__ tt, float* __restrict__ part, int b, int d,
                       float temperature) {
  __shared__ float anchor[kMaxD];
  __shared__ float red[kWarps], wm[kWarps], ws[kWarps];
  const int i = blockIdx.x, dir = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  load_normalised(anchor, dir == 0 ? si : st, nullptr, i, d, red);
  const __nv_bfloat16* other = dir == 0 ? st : si;

  float m_w = -INFINITY, s_w = 0.f;
  for (int r = warp; r < b; r += kWarps) {
    float f[kMaxChunks][8], inv;
    const float z = row_logit(anchor, other, r, d, temperature, f, inv);
    const float m_new = fmaxf(m_w, z);
    s_w = s_w * expf(m_w - m_new) + expf(z - m_new);
    m_w = m_new;
    if (dir == 0 && r == i && lane == 0) part[2 * b + i] = z;
  }
  if (lane == 0) {
    wm[warp] = m_w;
    ws[warp] = s_w;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float mx = -INFINITY;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w]);
    float sum = 0.f;
    for (int w = 0; w < kWarps; ++w) sum += ws[w] * expf(wm[w] - mx);
    part[dir * b + i] = mx + logf(sum);
  }
  if (dir != 0) return;
  // The cosine terms of row i: <si^, ti^> and <st^, tt^>.
  float dt = 0.f, t2 = 0.f, ds = 0.f, s2 = 0.f, u2 = 0.f;
  for (int c = threadIdx.x; c < d; c += kThreads) {
    const size_t at = static_cast<size_t>(i) * d + c;
    const float tv = ti[at], sv = __bfloat162float(st[at]), uv = tt[at];
    dt += anchor[c] * tv;
    t2 += tv * tv;
    ds += sv * uv;
    s2 += sv * sv;
    u2 += uv * uv;
  }
  dt = block_sum(dt, red);
  t2 = block_sum(t2, red);
  ds = block_sum(ds, red);
  s2 = block_sum(s2, red);
  u2 = block_sum(u2, red);
  if (threadIdx.x == 0) {
    part[3 * b + i] = dt * inv_norm(t2);
    part[4 * b + i] = ds * inv_norm(s2) * inv_norm(u2);
  }
}

// out[4] = li, lt, lc, total.
__global__ void __launch_bounds__(kThreads)
    distill_reduce_kernel(const float* __restrict__ part, float* __restrict__ out, int b,
                          float weight) {
  __shared__ float red[kWarps];
  float acc[5];
#pragma unroll
  for (int p = 0; p < 5; ++p) {
    float v = 0.f;
    for (int i = threadIdx.x; i < b; i += kThreads) v += part[p * b + i];
    acc[p] = block_sum(v, red) / b;
  }
  if (threadIdx.x == 0) {
    const float li = 1.f - acc[3], lt = 1.f - acc[4];
    const float lc = 0.5f * (acc[0] + acc[1]) - acc[2];
    out[0] = li;
    out[1] = lt;
    out[2] = lc;
    out[3] = li + lt + weight * lc;
  }
}

// Block (i, 0) writes dsi_i, block (i, 1) writes dst_i. cts[3] = c_li,
// c_lt, c_lc; part holds the log-sum-exps of the pass just before.
__global__ void __launch_bounds__(kThreads)
    distill_grad_kernel(const __nv_bfloat16* __restrict__ si,
                        const __nv_bfloat16* __restrict__ st, const float* __restrict__ ti,
                        const float* __restrict__ tt, const float* __restrict__ part,
                        const float* __restrict__ cts, __nv_bfloat16* __restrict__ dsi,
                        __nv_bfloat16* __restrict__ dst, int b, int d, float temperature) {
  __shared__ float anchor[kMaxD], teacher[kMaxD];
  __shared__ float acc_w[kWarps][kMaxD];
  __shared__ float red[kWarps];
  const int i = blockIdx.x, dir = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, chunks = d / 8;
  const float inv_a = load_normalised(anchor, dir == 0 ? si : st, nullptr, i, d, red);
  load_normalised(teacher, nullptr, dir == 0 ? ti : tt, i, d, red);
  const __nv_bfloat16* other = dir == 0 ? st : si;
  const float lse_self = part[dir * b + i];
  const float* lse_other = part + (1 - dir) * b;
  const float c_cos = cts[dir], c_lc = cts[2];
  const float gscale = c_lc / (2.f * b * temperature);

  float acc[kMaxChunks][8];
#pragma unroll
  for (int cc = 0; cc < kMaxChunks; ++cc)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[cc][e] = 0.f;
  for (int r = warp; r < b; r += kWarps) {
    float f[kMaxChunks][8], inv;
    const float z = row_logit(anchor, other, r, d, temperature, f, inv);
    const float eye = r == i ? 1.f : 0.f;
    const float gz = gscale * ((expf(z - lse_self) - eye) + (expf(z - lse_other[r]) - eye));
#pragma unroll
    for (int cc = 0; cc < kMaxChunks; ++cc)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[cc][e] += gz * inv * f[cc][e];
  }
#pragma unroll
  for (int cc = 0; cc < kMaxChunks; ++cc) {
    const int c = lane + 32 * cc;
    if (c < chunks)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc_w[warp][c * 8 + e] = acc[cc][e];
  }
  __syncthreads();
  // g = sum over warps - (c_cos / B) t^; then the normalisation chain rule.
  float dot = 0.f;
  for (int c = threadIdx.x; c < d; c += kThreads) {
    float g = -(c_cos / b) * teacher[c];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) g += acc_w[w][c];
    acc_w[0][c] = g;
    dot += g * anchor[c];
  }
  dot = block_sum(dot, red);
  __nv_bfloat16* out = (dir == 0 ? dsi : dst) + static_cast<size_t>(i) * d;
  for (int c = threadIdx.x; c < d; c += kThreads)
    out[c] = __float2bfloat16((acc_w[0][c] - dot * anchor[c]) * inv_a);
}

}  // namespace

// si, st: [b, d] bf16; ti, tt: [b, d] f32; part: [5, b] f32 scratch;
// out: [4] f32 (li, lt, lc, total). All contiguous, 16-byte aligned,
// d % 8 == 0, d <= 1024.
extern "C" int dclip_distill_loss_fwd(const void* si, const void* st, const void* ti,
                                      const void* tt, void* part, void* out, int b, int d,
                                      float temperature, float weight, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  distill_lse_kernel<<<dim3(b, 2), kThreads, 0, s>>>(
      static_cast<const __nv_bfloat16*>(si), static_cast<const __nv_bfloat16*>(st),
      static_cast<const float*>(ti), static_cast<const float*>(tt), static_cast<float*>(part),
      b, d, temperature);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  distill_reduce_kernel<<<1, kThreads, 0, s>>>(static_cast<const float*>(part),
                                               static_cast<float*>(out), b, weight);
  return static_cast<int>(cudaGetLastError());
}

// As above; cts: [3] f32 device (c_li, c_lt, c_lc); dsi, dst: [b, d] bf16.
extern "C" int dclip_distill_loss_bwd(const void* si, const void* st, const void* ti,
                                      const void* tt, void* part, const void* cts, void* dsi,
                                      void* dst, int b, int d, float temperature,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using B16 = __nv_bfloat16;
  distill_lse_kernel<<<dim3(b, 2), kThreads, 0, s>>>(
      static_cast<const B16*>(si), static_cast<const B16*>(st), static_cast<const float*>(ti),
      static_cast<const float*>(tt), static_cast<float*>(part), b, d, temperature);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  distill_grad_kernel<<<dim3(b, 2), kThreads, 0, s>>>(
      static_cast<const B16*>(si), static_cast<const B16*>(st), static_cast<const float*>(ti),
      static_cast<const float*>(tt), static_cast<const float*>(part),
      static_cast<const float*>(cts), static_cast<B16*>(dsi), static_cast<B16*>(dst), b, d,
      temperature);
  return static_cast<int>(cudaGetLastError());
}
