// Multi-head self-attention backward, head_dim 64, from the forward's
// output and softmax statistics: dq, dk, dv given q, k, v, the output
// gradient g, the output o, m (log2-domain row max) and rinv [B, S, H].
//
// Replaces: dclip_tpu/kernels/vit_attention.py `_bwd_kernel` (K5, line
//   308, `_self_attention_bwd_stats`). The algebra is the TPU's: per head,
//   e = exp2(mask(scale log2e q k^T) - m) recomputed from the saved stats
//   (no max or sum pass), dV = e^T (g rinv), dP = g v^T,
//   dS = e ((dP - delta) rinv), dQ = scale dS k, dK = scale dS^T q, with
//   delta = rowsum(g o) per head in f32 (the flash-attention identity).
//   Masks as in the forward (`_mask_logits`, the finite -1e30). The TPU
//   keeps every head's [S, S] tiles of one batch row in VMEM; blocks here
//   run in parallel with no order between them, so the work splits into
//   two kernels with no atomics:
//   - dq: one block per (query tile, head, batch row) walks the key tiles;
//     it also computes delta for its rows and writes it out;
//   - dkdv: one block per (key tile, head, batch row) walks the query
//     tiles and reads delta.
//   No [S, S] tensor reaches device memory.
// Bound on the H100: like the forward, latency and the 16-byte tile loads
//   at S = 197 / 77; each block does 2 (dq) or 4 (dkdv) 16x64x64 WMMA
//   products per tile pair. Occupancy: B * H * ceil(S/64) blocks of each.
// Design: 4 warps x 16 rows, tiles of 64 in shared memory, scores and dP
//   in per-warp f32 scratch, e and dS rounded to bf16 for the tensor cores
//   (as the TPU kernel rounds them to the input dtype), f32 accumulators in
//   WMMA fragments. Rows and keys past S are zero-filled and contribute
//   nothing (e = 0 there); their outputs are not stored.
#include <math.h>
#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int kHd = 64, kTile = 64, kWarps = 4, kThreads = kWarps * 32;
constexpr int kLdh = kHd + 8;   // bf16 tile rows
constexpr int kLds = kTile + 4; // f32 scratch rows
constexpr int kTileBytes = kTile * kLdh * 2;
constexpr int kWarpF32Bytes = kWarps * 16 * kLds * 4;
constexpr int kWarpBf16Bytes = kWarps * 16 * kLdh * 2;
constexpr float kScale = 0.125f;                           // 64^-0.5
constexpr float kScaleLog2 = 0.125f * 1.4426950408889634f;  // with log2(e)

using FragAcc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragBRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragBCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major>;

// out[16, 64] (f32, ld kLds) = a[16, 64] . bt[64, 64]^T; a and bt are
// row-major bf16 tiles with ld kLdh (bt row-major is bt^T column-major).
__device__ __forceinline__ void warp_abt(float* out, const __nv_bfloat16* a,
                                         const __nv_bfloat16* bt) {
  FragAcc acc[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) wmma::fill_fragment(acc[c], 0.f);
#pragma unroll
  for (int kk = 0; kk < kHd; kk += 16) {
    FragA fa;
    wmma::load_matrix_sync(fa, a + kk, kLdh);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      FragBCol fb;
      wmma::load_matrix_sync(fb, bt + c * 16 * kLdh + kk, kLdh);
      wmma::mma_sync(acc[c], fa, fb, acc[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c)
    wmma::store_matrix_sync(out + c * 16, acc[c], kLds, wmma::mem_row_major);
}

// acc[16, 64] += a[16, 64] . bm[64, 64]; both row-major bf16, ld kLdh.
__device__ __forceinline__ void warp_ab_acc(FragAcc (&acc)[4], const __nv_bfloat16* a,
                                            const __nv_bfloat16* bm) {
#pragma unroll
  for (int kk = 0; kk < kTile; kk += 16) {
    FragA fa;
    wmma::load_matrix_sync(fa, a + kk, kLdh);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      FragBRow fb;
      wmma::load_matrix_sync(fb, bm + kk * kLdh + c * 16, kLdh);
      wmma::mma_sync(acc[c], fa, fb, acc[c]);
    }
  }
}

// The warp's 16 rows of acc * scale as bf16 into dst (row `first_row` of
// a head slice with row stride ld); rows >= s are not stored.
__device__ __forceinline__ void store_rows(FragAcc (&acc)[4], float* scratch,
                                           __nv_bfloat16* dst, int ld, int first_row,
                                           int s, float scale) {
  const int lane = threadIdx.x & 31, row = lane >> 1, half = lane & 1;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    wmma::store_matrix_sync(scratch + c * 16, acc[c], kLds, wmma::mem_row_major);
  __syncwarp();
  if (first_row + row < s) {
    const float* src = scratch + row * kLds + half * 32;
    __nv_bfloat16* out = dst + static_cast<size_t>(first_row + row) * ld + half * 32;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = src[c * 8 + e] * scale;
      *reinterpret_cast<uint4*>(out + c * 8) = dclip::pack8(v);
    }
  }
  __syncwarp();
}

constexpr int kDqSmem = 4 * kTileBytes + 2 * kWarpF32Bytes + kWarpBf16Bytes + 2 * kTile * 4;

__global__ void __launch_bounds__(kThreads)
    attention_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v, int ldq, int ldk, int ldv,
                            const __nv_bfloat16* __restrict__ g,
                            const __nv_bfloat16* __restrict__ o,
                            const float* __restrict__ m, const float* __restrict__ r,
                            const float* __restrict__ pad, const int* __restrict__ seg,
                            float* __restrict__ delta, __nv_bfloat16* __restrict__ dq,
                            int lddq, int s, int heads, int causal) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sg = sq + kTile * kLdh;
  __nv_bfloat16* sk = sg + kTile * kLdh;
  __nv_bfloat16* sv = sk + kTile * kLdh;
  float* ss_all = reinterpret_cast<float*>(smem + 4 * kTileBytes);
  float* sdp_all = reinterpret_cast<float*>(smem + 4 * kTileBytes + kWarpF32Bytes);
  __nv_bfloat16* sds_all =
      reinterpret_cast<__nv_bfloat16*>(smem + 4 * kTileBytes + 2 * kWarpF32Bytes);
  float* kpad = reinterpret_cast<float*>(smem + 4 * kTileBytes + 2 * kWarpF32Bytes +
                                         kWarpBf16Bytes);
  int* kseg = reinterpret_cast<int*>(kpad + kTile);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int d = heads * kHd;
  const size_t rows0 = static_cast<size_t>(b) * s;
  const __nv_bfloat16* qb = q + rows0 * ldq + h * kHd;
  const __nv_bfloat16* kb = k + rows0 * ldk + h * kHd;
  const __nv_bfloat16* vb = v + rows0 * ldv + h * kHd;
  float* ss = ss_all + warp * 16 * kLds;
  float* sdp = sdp_all + warp * 16 * kLds;
  __nv_bfloat16* sds = sds_all + warp * 16 * kLdh;

  dclip::load_tile64<kThreads>(sq, kLdh, qb, q0, s, ldq);
  dclip::load_tile64<kThreads>(sg, kLdh, g + rows0 * d + h * kHd, q0, s, d);
  dclip::load_tile64<kThreads>(sk, kLdh, o + rows0 * d + h * kHd, q0, s, d);  // O, briefly
  __syncthreads();

  // Lane owns half (32 columns) of row `row` of its warp's 16 query rows.
  const int row = lane >> 1, half = lane & 1, lr = warp * 16 + row;
  const int gq = q0 + lr;
  float dl = 0.f;
#pragma unroll 8
  for (int e = 0; e < 32; ++e)
    dl += __bfloat162float(sg[lr * kLdh + half * 32 + e]) *
          __bfloat162float(sk[lr * kLdh + half * 32 + e]);
  dl += __shfl_xor_sync(dclip::kFullMask, dl, 1);
  float mrow = 0.f, rrow = 0.f;
  int qseg = 0;
  if (gq < s) {
    const size_t at = (rows0 + gq) * heads + h;
    mrow = m[at];
    rrow = r[at];
    if (half == 0) delta[at] = dl;
    if (seg != nullptr) qseg = seg[rows0 + gq];
  }

  FragAcc acc[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) wmma::fill_fragment(acc[c], 0.f);

  for (int k0 = 0; k0 < s; k0 += kTile) {
    __syncthreads();  // every warp is done with the previous tile (and with O)
    dclip::load_tile64<kThreads>(sk, kLdh, kb, k0, s, ldk);
    dclip::load_tile64<kThreads>(sv, kLdh, vb, k0, s, ldv);
    if (threadIdx.x < kTile) {
      const int key = k0 + threadIdx.x;
      kpad[threadIdx.x] = (pad != nullptr && key < s) ? pad[rows0 + key] : 1.f;
      kseg[threadIdx.x] = (seg != nullptr && key < s) ? seg[rows0 + key] : 0;
    }
    __syncthreads();
    warp_abt(ss, sq + warp * 16 * kLdh, sk);   // S = Q K^T
    warp_abt(sdp, sg + warp * 16 * kLdh, sv);  // dP = G V^T
    __syncwarp();
#pragma unroll 8
    for (int e = 0; e < 32; ++e) {
      const int j = half * 32 + e, key = k0 + j;
      float ds = 0.f;
      if (gq < s && key < s) {
        const bool keep = (!causal || key <= gq) && (seg == nullptr || kseg[j] == qseg) &&
                          kpad[j] > 0.f;
        const float l = keep ? ss[row * kLds + j] * kScaleLog2 : dclip::kNegBig;
        ds = exp2f(l - mrow) * ((sdp[row * kLds + j] - dl) * rrow);
      }
      sds[row * kLdh + j] = __float2bfloat16(ds);
    }
    __syncwarp();
    warp_ab_acc(acc, sds, sk);  // dQ += dS K
  }
  store_rows(acc, ss, dq + rows0 * lddq + h * kHd, lddq, q0 + warp * 16, s, kScale);
}

constexpr int kDkvSmem =
    5 * kTileBytes + 2 * kWarpF32Bytes + 2 * kWarpBf16Bytes + 4 * kTile * 4;

__global__ void __launch_bounds__(kThreads)
    attention_bwd_dkdv_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v, int ldq, int ldk,
                              int ldv, const __nv_bfloat16* __restrict__ g,
                              const float* __restrict__ m, const float* __restrict__ r,
                              const float* __restrict__ delta,
                              const float* __restrict__ pad, const int* __restrict__ seg,
                              __nv_bfloat16* __restrict__ dk, int lddk,
                              __nv_bfloat16* __restrict__ dv, int lddv, int s, int heads,
                              int causal) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sk = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sv = sk + kTile * kLdh;
  __nv_bfloat16* sq = sv + kTile * kLdh;
  __nv_bfloat16* sg = sq + kTile * kLdh;
  __nv_bfloat16* sgr = sg + kTile * kLdh;
  float* sst_all = reinterpret_cast<float*>(smem + 5 * kTileBytes);
  float* sdpt_all = reinterpret_cast<float*>(smem + 5 * kTileBytes + kWarpF32Bytes);
  __nv_bfloat16* se_all =
      reinterpret_cast<__nv_bfloat16*>(smem + 5 * kTileBytes + 2 * kWarpF32Bytes);
  __nv_bfloat16* sdst_all = se_all + kWarps * 16 * kLdh;
  float* qm = reinterpret_cast<float*>(smem + 5 * kTileBytes + 2 * kWarpF32Bytes +
                                       2 * kWarpBf16Bytes);
  float* qr = qm + kTile;
  float* qd = qr + kTile;
  int* qsg = reinterpret_cast<int*>(qd + kTile);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int d = heads * kHd;
  const size_t rows0 = static_cast<size_t>(b) * s;
  const __nv_bfloat16* qb = q + rows0 * ldq + h * kHd;
  const __nv_bfloat16* gb = g + rows0 * d + h * kHd;
  float* sst = sst_all + warp * 16 * kLds;
  float* sdpt = sdpt_all + warp * 16 * kLds;
  __nv_bfloat16* se = se_all + warp * 16 * kLdh;
  __nv_bfloat16* sdst = sdst_all + warp * 16 * kLdh;

  dclip::load_tile64<kThreads>(sk, kLdh, k + rows0 * ldk + h * kHd, k0, s, ldk);
  dclip::load_tile64<kThreads>(sv, kLdh, v + rows0 * ldv + h * kHd, k0, s, ldv);

  // Lane owns half (32 query columns) of key row `row` of its warp's 16.
  const int row = lane >> 1, half = lane & 1;
  const int gk = k0 + warp * 16 + row;
  const float kp = (pad != nullptr && gk < s) ? pad[rows0 + gk] : 1.f;
  const int ks = (seg != nullptr && gk < s) ? seg[rows0 + gk] : 0;

  FragAcc dk_acc[4], dv_acc[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    wmma::fill_fragment(dk_acc[c], 0.f);
    wmma::fill_fragment(dv_acc[c], 0.f);
  }

  for (int q0 = 0; q0 < s; q0 += kTile) {
    __syncthreads();  // every warp is done with the previous query tile
    dclip::load_tile64<kThreads>(sq, kLdh, qb, q0, s, ldq);
    dclip::load_tile64<kThreads>(sg, kLdh, gb, q0, s, d);
    if (threadIdx.x < kTile) {
      const int qi = q0 + threadIdx.x;
      float mv = 0.f, rv = 0.f, dv_ = 0.f;
      int sv_ = 0;
      if (qi < s) {
        const size_t at = (rows0 + qi) * heads + h;
        mv = m[at];
        rv = r[at];
        dv_ = delta[at];
        if (seg != nullptr) sv_ = seg[rows0 + qi];
      }
      qm[threadIdx.x] = mv;
      qr[threadIdx.x] = rv;
      qd[threadIdx.x] = dv_;
      qsg[threadIdx.x] = sv_;
    }
    __syncthreads();
    // GR = bf16(g * rinv) per query row (the TPU's `grs`).
    for (int c = threadIdx.x; c < kTile * 8; c += kThreads) {
      const int qrow = c >> 3, c8 = (c & 7) * 8;
      float f[8];
      dclip::unpack8(*reinterpret_cast<const uint4*>(sg + qrow * kLdh + c8), f);
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] *= qr[qrow];
      *reinterpret_cast<uint4*>(sgr + qrow * kLdh + c8) = dclip::pack8(f);
    }
    __syncthreads();
    warp_abt(sst, sk + warp * 16 * kLdh, sq);   // S^T = K Q^T
    warp_abt(sdpt, sv + warp * 16 * kLdh, sg);  // dP^T = V G^T
    __syncwarp();
#pragma unroll 8
    for (int e = 0; e < 32; ++e) {
      const int j = half * 32 + e, qi = q0 + j;
      float p = 0.f, ds = 0.f;
      if (qi < s && gk < s) {
        const bool keep = (!causal || gk <= qi) && (seg == nullptr || ks == qsg[j]) && kp > 0.f;
        const float l = keep ? sst[row * kLds + j] * kScaleLog2 : dclip::kNegBig;
        p = exp2f(l - qm[j]);
        ds = p * ((sdpt[row * kLds + j] - qd[j]) * qr[j]);
      }
      se[row * kLdh + j] = __float2bfloat16(p);
      sdst[row * kLdh + j] = __float2bfloat16(ds);
    }
    __syncwarp();
    warp_ab_acc(dv_acc, se, sgr);   // dV += e^T (g rinv)
    warp_ab_acc(dk_acc, sdst, sq);  // dK += dS^T Q
  }
  store_rows(dk_acc, sst, dk + rows0 * lddk + h * kHd, lddk, k0 + warp * 16, s, kScale);
  store_rows(dv_acc, sst, dv + rows0 * lddv + h * kHd, lddv, k0 + warp * 16, s, 1.f);
}

}  // namespace

// q, k, v: [b, s, heads * 64] bf16 views (unit column stride, row strides
// ldq / ldk / ldv, batch stride s * ld); g, o: [b, s, heads * 64] bf16
// contiguous; m, r: [b, s, heads] f32 from the forward; pad [b, s] f32 or
// null; seg [b, s] int32 or null; delta: [b, s, heads] f32 scratch; dq,
// dk, dv: bf16 views like q, k, v with row strides lddq / lddk / lddv.
// Launches the dq kernel (which writes delta), then the dk/dv kernel.
extern "C" int dclip_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                        int ldq, int ldk, int ldv, const void* g,
                                        const void* o, const void* m, const void* r,
                                        const void* pad, const void* seg, void* delta,
                                        void* dq, void* dk, void* dv, int lddq, int lddk,
                                        int lddv, int b, int s, int heads, int causal,
                                        void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      attention_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(attention_bwd_dkdv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kDkvSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s + kTile - 1) / kTile, heads, b);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using B16 = __nv_bfloat16;
  attention_bwd_dq_kernel<<<grid, kThreads, kDqSmem, st>>>(
      static_cast<const B16*>(q), static_cast<const B16*>(k), static_cast<const B16*>(v),
      ldq, ldk, ldv, static_cast<const B16*>(g), static_cast<const B16*>(o),
      static_cast<const float*>(m), static_cast<const float*>(r),
      static_cast<const float*>(pad), static_cast<const int*>(seg),
      static_cast<float*>(delta), static_cast<B16*>(dq), lddq, s, heads, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_dkdv_kernel<<<grid, kThreads, kDkvSmem, st>>>(
      static_cast<const B16*>(q), static_cast<const B16*>(k), static_cast<const B16*>(v),
      ldq, ldk, ldv, static_cast<const B16*>(g), static_cast<const float*>(m),
      static_cast<const float*>(r), static_cast<const float*>(delta),
      static_cast<const float*>(pad), static_cast<const int*>(seg), static_cast<B16*>(dk),
      lddk, static_cast<B16*>(dv), lddv, s, heads, causal);
  return static_cast<int>(cudaGetLastError());
}
