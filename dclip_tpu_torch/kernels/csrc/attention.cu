// Multi-head self-attention forward, head_dim 64, with optional masks and
// softmax statistics:
//   out[b, s, h*64:(h+1)*64] = softmax(mask(q_h k_h^T / sqrt(64))) v_h
//   m[b, s, h]    = max of the masked log2-domain logits of the row
//   rinv[b, s, h] = 1 / sum(exp2(l2 - m)) over the keys of the row
// q, k and v are read by row stride, so one kernel serves the serving
// path's fused QKV buffer [B, S, 3D] and the trainable tower's [B, S, 3D]
// product of the concatenated q/k/v weights alike.
//
// Replaces: dclip_tpu/kernels/vit_attention.py `_kernel` (K3, line 127:
//   `self_attention_fused`) and `_fwd_stats_kernel` (K4, line 246:
//   `_self_attention_fwd_stats`), and the attention core of
//   dclip_tpu/kernels/vit_block.py `_attn_kernel` (lines 59-90). The
//   algebra is the TPU's: log2-domain logits (the 1/sqrt(64) scale folded
//   with log2 e), masks from `_mask_logits` (lines 68-89: causal, a [B, S]
//   key-padding row, a [B, S] segment-id row; a masked logit becomes the
//   finite -1e30 of `_NEG`, so an all-masked row averages its keys as on
//   the TPU and exp2(l - m) is never NaN), normalisation after the PV
//   product, and the stats contract (m in the log2 domain, rinv the
//   reciprocal row sum). The schedule is not the TPU's: the TPU runs one
//   program per batch row with every head's [S, S] logits in VMEM; here a
//   block owns one (batch row, head, 64-query tile) and walks the keys in
//   tiles of 64 with an online softmax, so no [S, S] tensor exists.
// Bound on the H100: at S = 197 (vision) and 77 (text) the per-head work is
//   small (~10 MFLOP per query tile), so the kernel is bound by latency and
//   by the 16-byte loads of K and V; occupancy comes from B * H * ceil(S/64)
//   blocks (12,288 at the training batch of 256 images).
// Design: 4 warps x 16 query rows. Per key tile: QK^T on WMMA bf16
//   fragments into an f32 scratch, a row-wise online softmax in f32 (two
//   lanes per row), P rounded to bf16 and PV on WMMA accumulating into an
//   f32 output tile in shared memory that the softmax rescales. Keys past S
//   are zero-filled and excluded with -inf (they are tile padding, not
//   keys of the row); query rows past S are computed on zeros and not
//   stored. The row sum is taken in f32 over the bf16-rounded P that
//   enters the PV product, so the normalised weights sum to one exactly as
//   in the TPU's ones-column trick and rinv is the one the backward needs.
//   K and V of one head at S=197 take 50 KB, above the 48 KB static limit;
//   tiling the keys keeps the block at 70 KB of dynamic shared memory.
#include <math.h>
#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int kHd = 64;          // head_dim (the only one taken)
constexpr int kQTile = 64, kKTile = 64, kWarps = 4;
constexpr int kLdh = kHd + 8;    // bf16 rows of Q, K, V, P tiles
constexpr int kLds = kKTile + 4; // f32 rows of S and O scratch (kHd == kKTile)
constexpr int kQBytes = kQTile * kLdh * 2;
constexpr int kKBytes = kKTile * kLdh * 2;
constexpr int kSBytes = kWarps * 16 * kLds * 4;
constexpr int kPBytes = kWarps * 16 * kLdh * 2;
constexpr int kMaskBytes = 2 * kKTile * 4;
constexpr int kSmemBytes = kQBytes + 2 * kKBytes + 2 * kSBytes + kPBytes + kMaskBytes;

__global__ void __launch_bounds__(kWarps * 32)
    attention_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, int ldq, int ldk,
                     int ldv, __nv_bfloat16* __restrict__ out,
                     const float* __restrict__ pad, const int* __restrict__ seg,
                     float* __restrict__ m_out, float* __restrict__ r_out,
                     int s, int heads, int causal) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sk = reinterpret_cast<__nv_bfloat16*>(smem + kQBytes);
  __nv_bfloat16* sv = reinterpret_cast<__nv_bfloat16*>(smem + kQBytes + kKBytes);
  float* ss_all = reinterpret_cast<float*>(smem + kQBytes + 2 * kKBytes);
  float* so_all = reinterpret_cast<float*>(smem + kQBytes + 2 * kKBytes + kSBytes);
  __nv_bfloat16* sp_all =
      reinterpret_cast<__nv_bfloat16*>(smem + kQBytes + 2 * kKBytes + 2 * kSBytes);
  float* kpad = reinterpret_cast<float*>(smem + kQBytes + 2 * kKBytes + 2 * kSBytes + kPBytes);
  int* kseg = reinterpret_cast<int*>(kpad + kKTile);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * kQTile, h = blockIdx.y, b = blockIdx.z;
  const int d = heads * kHd;
  const __nv_bfloat16* qb = q + static_cast<size_t>(b) * s * ldq + h * kHd;
  const __nv_bfloat16* kb = k + static_cast<size_t>(b) * s * ldk + h * kHd;
  const __nv_bfloat16* vb = v + static_cast<size_t>(b) * s * ldv + h * kHd;
  float* ss = ss_all + warp * 16 * kLds;
  float* so = so_all + warp * 16 * kLds;
  __nv_bfloat16* sp = sp_all + warp * 16 * kLdh;

  dclip::load_tile64<kWarps * 32>(sq, kLdh, qb, q0, s, ldq);
  for (int i = lane; i < 16 * kHd; i += 32) so[(i / kHd) * kLds + i % kHd] = 0.f;

  // Lane owns half (32 columns) of row `row` of its warp's 16 query rows.
  const int row = lane >> 1, half = lane & 1;
  const int gq = q0 + warp * 16 + row;
  const int qseg = (seg != nullptr && gq < s) ? seg[static_cast<size_t>(b) * s + gq] : 0;
  const float scale_log2 = 0.125f * 1.4426950408889634f;  // 64^-0.5 * log2(e)
  float m_run = -INFINITY, l_run = 0.f;

  for (int k0 = 0; k0 < s; k0 += kKTile) {
    __syncthreads();  // every warp is done with the previous K/V tile
    dclip::load_tile64<kWarps * 32>(sk, kLdh, kb, k0, s, ldk);
    dclip::load_tile64<kWarps * 32>(sv, kLdh, vb, k0, s, ldv);
    if (threadIdx.x < kKTile) {
      const int key = k0 + threadIdx.x;
      const size_t at = static_cast<size_t>(b) * s + key;
      kpad[threadIdx.x] = (pad != nullptr && key < s) ? pad[at] : 1.f;
      kseg[threadIdx.x] = (seg != nullptr && key < s) ? seg[at] : 0;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys.
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kKTile / 16];
#pragma unroll
      for (int c = 0; c < kKTile / 16; ++c) wmma::fill_fragment(acc[c], 0.f);
#pragma unroll
      for (int kk = 0; kk < kHd; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fq;
        wmma::load_matrix_sync(fq, sq + warp * 16 * kLdh + kk, kLdh);
#pragma unroll
        for (int c = 0; c < kKTile / 16; ++c) {
          // K stored [key][dim] row-major is K^T in column-major.
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fk;
          wmma::load_matrix_sync(fk, sk + c * 16 * kLdh + kk, kLdh);
          wmma::mma_sync(acc[c], fq, fk, acc[c]);
        }
      }
#pragma unroll
      for (int c = 0; c < kKTile / 16; ++c)
        wmma::store_matrix_sync(ss + c * 16, acc[c], kLds, wmma::mem_row_major);
    }
    __syncwarp();

    // Masked online softmax in the log2 domain over this lane's 32 keys.
    float* srow = ss + row * kLds + half * 32;
    float mx = -INFINITY;
#pragma unroll 8
    for (int e = 0; e < 32; ++e) {
      const int j = half * 32 + e, key = k0 + j;
      float l = -INFINITY;
      if (key < s) {
        const bool keep = (!causal || key <= gq) && (seg == nullptr || kseg[j] == qseg) &&
                          kpad[j] > 0.f;
        l = keep ? srow[e] * scale_log2 : dclip::kNegBig;
      }
      srow[e] = l;
      mx = fmaxf(mx, l);
    }
    mx = fmaxf(mx, __shfl_xor_sync(dclip::kFullMask, mx, 1));
    const float m_new = fmaxf(m_run, mx);  // finite: every tile has a key < s
    const float alpha = exp2f(m_run - m_new);
    __nv_bfloat16* prow = sp + row * kLdh + half * 32;
    float rs = 0.f;
#pragma unroll 8
    for (int e = 0; e < 32; ++e) {
      const __nv_bfloat16 p = __float2bfloat16(exp2f(srow[e] - m_new));
      prow[e] = p;
      rs += __bfloat162float(p);
    }
    rs += __shfl_xor_sync(dclip::kFullMask, rs, 1);
    l_run = l_run * alpha + rs;
    m_run = m_new;
    float* orow = so + row * kLds + half * 32;
#pragma unroll 8
    for (int e = 0; e < 32; ++e) orow[e] *= alpha;
    __syncwarp();

    // O += P V.
#pragma unroll
    for (int c = 0; c < kHd / 16; ++c) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> fo;
      wmma::load_matrix_sync(fo, so + c * 16, kLds, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kKTile; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fp;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fv;
        wmma::load_matrix_sync(fp, sp + kk, kLdh);
        wmma::load_matrix_sync(fv, sv + kk * kLdh + c * 16, kLdh);
        wmma::mma_sync(fo, fp, fv, fo);
      }
      wmma::store_matrix_sync(so + c * 16, fo, kLds, wmma::mem_row_major);
    }
    __syncwarp();
  }

  if (gq < s) {
    const float inv = 1.f / l_run;
    const float* orow = so + row * kLds + half * 32;
    __nv_bfloat16* dst = out + (static_cast<size_t>(b) * s + gq) * d + h * kHd + half * 32;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float o[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) o[e] = orow[c * 8 + e] * inv;
      *reinterpret_cast<uint4*>(dst + c * 8) = dclip::pack8(o);
    }
    if (m_out != nullptr && half == 0) {
      const size_t at = (static_cast<size_t>(b) * s + gq) * heads + h;
      m_out[at] = m_run;
      r_out[at] = inv;
    }
  }
}

int launch(const void* q, const void* k, const void* v, int ldq, int ldk, int ldv,
           void* out, const void* pad, const void* seg, void* m, void* r, int b,
           int s, int heads, int causal, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s + kQTile - 1) / kQTile, heads, b);
  attention_kernel<<<grid, kWarps * 32, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), ldq, ldk, ldv,
      static_cast<__nv_bfloat16*>(out), static_cast<const float*>(pad),
      static_cast<const int*>(seg), static_cast<float*>(m), static_cast<float*>(r), s,
      heads, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// qkv: [b, s, 3 * heads * 64] bf16 (q | k | v, head-major inside each);
// out: [b, s, heads * 64] bf16. Both contiguous and 16-byte aligned.
// Unmasked, no statistics: the frozen image tower's attention core.
extern "C" int dclip_attention_bf16(const void* qkv, void* out, int b, int s,
                                    int heads, void* stream) {
  const int d = heads * kHd;
  const __nv_bfloat16* base = static_cast<const __nv_bfloat16*>(qkv);
  return launch(base, base + d, base + 2 * d, 3 * d, 3 * d, 3 * d, out, nullptr,
                nullptr, nullptr, nullptr, b, s, heads, 0, stream);
}

// q, k, v: [b, s, heads * 64] bf16 views with unit column stride and row
// strides ldq / ldk / ldv (elements, multiples of 8; batch stride s * ld),
// 16-byte aligned. out: [b, s, heads * 64] bf16 contiguous. pad: [b, s] f32
// (key j valid when > 0) or null; seg: [b, s] int32 or null; m, r:
// [b, s, heads] f32 or both null (the stats-free mode).
extern "C" int dclip_attention_fwd_bf16(const void* q, const void* k, const void* v,
                                        int ldq, int ldk, int ldv, void* out,
                                        const void* pad, const void* seg, void* m,
                                        void* r, int b, int s, int heads, int causal,
                                        void* stream) {
  return launch(q, k, v, ldq, ldk, ldv, out, pad, seg, m, r, b, s, heads, causal, stream);
}
