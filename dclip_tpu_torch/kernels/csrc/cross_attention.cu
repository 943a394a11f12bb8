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
//   CUDA-core work against ~155 MB (its f32 q|k|v reads, 133 MB, and its
//   bf16 output): bound by the bytes, ~0.047 ms; the add+LN pass is bound
//   by its ~134 MB of f32 traffic.
// Core design: the work is small next to the bytes, so the kernel is built
//   to keep loads in flight and to spend few instructions on the rest. One
//   block of 4 warps per (batch row, head, direction), grid (b, heads, 2):
//   at the step's shape 4,096 blocks of at most 47 KB, four an SM. On the
//   H100 this ran faster than one block per (batch row, head) taking both
//   directions, with 8 warps (75 KB, three an SM) or with 4; each q, k, v
//   byte is read once either way. A block takes its queries in chunks
//   whose probabilities fit 16 KB (all of them below 32 queries x 128
//   keys). It issues every load of its slab at once, the head's q, k and v
//   slices of each row as 16-byte cp.async copies (each slice is
//   hd x 4 contiguous bytes, 16-byte aligned since hd % 32 == 0), waits
//   once, and computes from shared memory (rows padded to hd + 4 floats),
//   templated on head_dim so every dot product unrolls, in three phases:
//   1. Logits: a thread a 2 x 2 tile of (query, key) pairs in registers,
//      rows half the count apart so a warp reads neighbouring rows; scaled
//      and masked into the probability buffer.
//   2. Softmax, lanes by key count: a row takes a group of g lanes, g the
//      power of two at least the key count, at most 32; lane j of the group
//      holds keys j, j + g, j + 2g, j + 3g (keys <= 128), so a warp runs
//      32 / g rows at once (four at P = 8 boxes), with max and sum as
//      shuffles within the group.
//   3. P V: a thread two queries x 8 output columns in registers, the
//      keys' probabilities and two float4 of v a step, stored as 16-byte
//      bf16 vectors. The output is rounded to bf16 once: it is the A
//      operand of the out-projection GEMM.
// add+LN: one warp per row, float4 loads (D % 4 == 0), the passes after the
//   first from L1.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 4, kThreads = kWarps * 32;
constexpr int kMaxSlots = 4;  // keys <= 128: at most four keys per lane
// A block's probabilities: as many queries at a time as fit, 32 queries x
// 128 keys at the widest shape.
constexpr int kProbFloats = 4096;

__host__ __device__ constexpr int row_ld(int hd) { return hd + 4; }
__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

// Floats of one direction's slab: q [sq, ld], k and v [sk, ld], keep [sk]
// rounded up to 4 (every part starts 16-byte aligned).
__host__ __device__ __forceinline__ int slab_floats(int sq, int sk, int hd) {
  return (sq + 2 * sk) * row_ld(hd) + round4(sk);
}

__host__ __device__ __forceinline__ int group_width(int sk) {
  int g = 1;
  while (g < sk && g < 32) g <<= 1;
  return g;
}

struct Direction {
  const float* q;     // query stream's qkv, row 0, this head's q columns
  const float* k;     // key stream's qkv, row 0, this head's k columns
  const float* mask;  // key mask of this batch row, or null
  __nv_bfloat16* out;  // [sq, d] output, row 0, this head's columns
  int sq, sk;
};

// Direction 0: text queries over image keys; 1: image queries over text keys.
__device__ __forceinline__ Direction direction(int which, const float* qkv_t,
                                               const float* qkv_i, const float* text_mask,
                                               const float* image_mask, __nv_bfloat16* out_t,
                                               __nv_bfloat16* out_i, int b, int t, int p,
                                               int d, int col0) {
  const size_t ld3 = 3 * static_cast<size_t>(d);
  const float* text = qkv_t + b * t * ld3 + col0;
  const float* image = qkv_i + b * p * ld3 + col0;
  if (which == 0)
    return {text, image + d, image_mask ? image_mask + static_cast<size_t>(b) * p : nullptr,
            out_t + static_cast<size_t>(b) * t * d + col0, t, p};
  return {image, text + d, text_mask ? text_mask + static_cast<size_t>(b) * t : nullptr,
          out_i + static_cast<size_t>(b) * p * d + col0, p, t};
}

// Issue every 16-byte copy of the direction's q, k, v slices into `slab`.
template <int HD>
__device__ __forceinline__ void stage(float* slab, const Direction& dir, int d) {
  constexpr int ld = row_ld(HD), vecs = HD / 4;
  const int ld3 = 3 * d;
  float* ks = slab + dir.sq * ld;
  float* keep = ks + 2 * dir.sk * ld;
  const int nq = dir.sq * vecs, nk = dir.sk * vecs;
  for (int i = threadIdx.x; i < nq + 2 * nk; i += kThreads) {
    const bool is_q = i < nq;
    int j = is_q ? i : i - nq;
    const int v = is_q ? 0 : j >= nk;  // 1: a v row
    j -= v * nk;
    const int r = j / vecs, c = 4 * (j % vecs);
    const float* src = (is_q ? dir.q : dir.k + v * d) + static_cast<size_t>(r) * ld3 + c;
    float* dst = (is_q ? slab : ks + v * dir.sk * ld) + r * ld + c;
    dclip::cp_async_16(dst, src, true);
  }
  for (int j = threadIdx.x; j < dir.sk; j += kThreads)
    keep[j] = (dir.mask == nullptr || dir.mask[j] > 0.f) ? 1.f : 0.f;
}

// Phase 1, one item: the masked, scaled logits of queries q0 + (r, r + nh)
// against keys (j, j + kh), a 2 x 2 register tile (rows nh and kh apart,
// so the lanes of a warp read neighbouring rows), into prob[rl, key].
template <int HD>
__device__ __forceinline__ void logits(const float* slab, float* prob, const Direction& dir,
                                       float scale, int q0, int n, int item) {
  constexpr int ld = row_ld(HD);
  const int sk = dir.sk, nh = (n + 1) / 2, kh = (sk + 1) / 2;
  const int r = item / kh, j = item % kh;
  const int rr[2] = {q0 + r, q0 + min(r + nh, n - 1)}, jj[2] = {j, min(j + kh, sk - 1)};
  const float* ks = slab + dir.sq * ld;
  const float* keep = ks + 2 * sk * ld;
  float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
  for (int c = 0; c < HD; c += 4) {
    float4 q[2], k[2];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      q[x] = *reinterpret_cast<const float4*>(slab + rr[x] * ld + c);
      k[x] = *reinterpret_cast<const float4*>(ks + jj[x] * ld + c);
    }
#pragma unroll
    for (int x = 0; x < 2; ++x)
#pragma unroll
      for (int y = 0; y < 2; ++y)
        acc[x][y] += q[x].x * k[y].x + q[x].y * k[y].y + q[x].z * k[y].z + q[x].w * k[y].w;
  }
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int rl = r + x * nh;
    if (x == 1 && rl >= n) break;
#pragma unroll
    for (int y = 0; y < 2; ++y) {
      const int key = j + y * kh;
      if (y == 1 && key >= sk) break;
      prob[rl * sk + key] = keep[key] > 0.f ? acc[x][y] * scale : dclip::kNegBig;
    }
  }
}

// Phase 2: softmax of rows rbase + lane / g of prob (g lanes a row, g the
// power of two at least the key count, at most 32; lane j of the group
// holds keys j, j + g, j + 2g, j + 3g), in place.
__device__ __forceinline__ void softmax_rows(float* prob, int sk, int n, int rbase) {
  const int lane = threadIdx.x & 31, g = group_width(sk), gl = lane & (g - 1);
  const int rl = rbase + lane / g;
  float* row = prob + (rl < n ? rl : n - 1) * sk;  // a group past n: its shuffles only
  float l[kMaxSlots], m = -INFINITY;
#pragma unroll
  for (int s = 0; s < kMaxSlots; ++s) {
    const int j = gl + g * s;
    l[s] = j < sk ? row[j] : -INFINITY;  // slots past the keys: excluded
    m = fmaxf(m, l[s]);
  }
  for (int o = g >> 1; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(dclip::kFullMask, m, o));
  float e[kMaxSlots], sum = 0.f;
#pragma unroll
  for (int s = 0; s < kMaxSlots; ++s) {
    e[s] = gl + g * s < sk ? expf(l[s] - m) : 0.f;
    sum += e[s];
  }
  for (int o = g >> 1; o > 0; o >>= 1) sum += __shfl_xor_sync(dclip::kFullMask, sum, o);
  const float inv = 1.f / sum;
  __syncwarp();  // every lane has read its row before any lane writes
  if (rl >= n) return;
#pragma unroll
  for (int s = 0; s < kMaxSlots; ++s)
    if (gl + g * s < sk) row[gl + g * s] = e[s] * inv;
}

// Phase 3, one item: out[q0 + (r, r + nh), c .. c + 7] = P V, two queries
// x 8 columns in registers, stored as 16-byte bf16 vectors.
template <int HD>
__device__ __forceinline__ void weighted_values(const float* slab, const float* prob,
                                                const Direction& dir, int d, int q0, int n,
                                                int item) {
  constexpr int ld = row_ld(HD), chunks = HD / 8;
  const int sk = dir.sk, nh = (n + 1) / 2;
  const int r = item / chunks, c = 8 * (item % chunks);
  const float* vs = slab + (dir.sq + sk) * ld + c;
  const float* p0 = prob + r * sk;
  const float* p1 = prob + min(r + nh, n - 1) * sk;
  float o[2][8];
#pragma unroll
  for (int x = 0; x < 2; ++x)
#pragma unroll
    for (int e = 0; e < 8; ++e) o[x][e] = 0.f;
#pragma unroll 4
  for (int j = 0; j < sk; ++j) {
    const float4 v0 = *reinterpret_cast<const float4*>(vs + j * ld);
    const float4 v1 = *reinterpret_cast<const float4*>(vs + j * ld + 4);
    const float pj[2] = {p0[j], p1[j]};
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      o[x][0] += pj[x] * v0.x;
      o[x][1] += pj[x] * v0.y;
      o[x][2] += pj[x] * v0.z;
      o[x][3] += pj[x] * v0.w;
      o[x][4] += pj[x] * v1.x;
      o[x][5] += pj[x] * v1.y;
      o[x][6] += pj[x] * v1.z;
      o[x][7] += pj[x] * v1.w;
    }
  }
  *reinterpret_cast<uint4*>(dir.out + static_cast<size_t>(q0 + r) * d + c) = dclip::pack8(o[0]);
  if (r + nh < n)
    *reinterpret_cast<uint4*>(dir.out + static_cast<size_t>(q0 + r + nh) * d + c) =
        dclip::pack8(o[1]);
}

// Grid (b, heads, 2): block (b, h, k) takes direction k of batch row b and
// head h, as many queries at a time as kProbFloats of probabilities hold.
template <int HD>
__global__ void __launch_bounds__(kThreads, 4)
    cross_attention_core_kernel(const float* __restrict__ qkv_t,
                                const float* __restrict__ qkv_i,
                                const float* __restrict__ text_mask,
                                const float* __restrict__ image_mask,
                                __nv_bfloat16* __restrict__ out_t,
                                __nv_bfloat16* __restrict__ out_i, int t, int p, int d,
                                float scale) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5;
  const Direction dir = direction(blockIdx.z, qkv_t, qkv_i, text_mask, image_mask, out_t, out_i,
                                  blockIdx.x, t, p, d, blockIdx.y * HD);
  const int sk = dir.sk, qc = min(dir.sq, kProbFloats / sk);
  float* slab = smem;
  float* prob = slab + slab_floats(dir.sq, sk, HD);
  stage<HD>(slab, dir, d);
  dclip::cp_async_commit();
  dclip::cp_async_wait<0>();
  __syncthreads();
  const int per = 32 / group_width(sk);
  for (int q0 = 0; q0 < dir.sq; q0 += qc) {
    const int n = min(qc, dir.sq - q0), pairs = (n + 1) / 2;
    for (int it = threadIdx.x; it < pairs * ((sk + 1) / 2); it += kThreads)
      logits<HD>(slab, prob, dir, scale, q0, n, it);
    __syncthreads();
    for (int it = warp; it * per < n; it += kWarps) softmax_rows(prob, sk, n, it * per);
    __syncthreads();
    for (int it = threadIdx.x; it < pairs * (HD / 8); it += kThreads)
      weighted_values<HD>(slab, prob, dir, d, q0, n, it);
    __syncthreads();  // the probabilities are rewritten by the next chunk
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

template <int HD>
int launch_core(dim3 grid, size_t smem, void* stream, const void* qkv_t, const void* qkv_i,
                const void* text_mask, const void* image_mask, void* out_t, void* out_i, int t,
                int p, int d, float scale) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(cross_attention_core_kernel<HD>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cross_attention_core_kernel<HD><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(qkv_t), static_cast<const float*>(qkv_i),
      static_cast<const float*>(text_mask), static_cast<const float*>(image_mask),
      static_cast<__nv_bfloat16*>(out_t), static_cast<__nv_bfloat16*>(out_i), t, p, d, scale);
  return static_cast<int>(cudaGetLastError());
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
  // A block's slab and the probabilities of as many queries at a time as
  // kProbFloats holds; the larger of the two directions sets the size.
  const auto bytes = [&](int sq, int sk) {
    return sizeof(float) * (slab_floats(sq, sk, hd) +
                            round4((sq < kProbFloats / sk ? sq : kProbFloats / sk) * sk));
  };
  const size_t smem = bytes(t, p) > bytes(p, t) ? bytes(t, p) : bytes(p, t);
  const dim3 grid(b, heads, 2);
  const float scale = 1.f / sqrtf(static_cast<float>(hd));
  switch (hd) {
    case 32: return launch_core<32>(grid, smem, stream, qkv_t, qkv_i, text_mask, image_mask,
                                    out_t, out_i, t, p, d, scale);
    case 64: return launch_core<64>(grid, smem, stream, qkv_t, qkv_i, text_mask, image_mask,
                                    out_t, out_i, t, p, d, scale);
    case 96: return launch_core<96>(grid, smem, stream, qkv_t, qkv_i, text_mask, image_mask,
                                    out_t, out_i, t, p, d, scale);
    case 128: return launch_core<128>(grid, smem, stream, qkv_t, qkv_i, text_mask, image_mask,
                                      out_t, out_i, t, p, d, scale);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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
