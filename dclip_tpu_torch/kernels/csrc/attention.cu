// Unmasked multi-head self-attention core, head_dim 64:
//   out[b, s, h*64:(h+1)*64] = softmax(q_h k_h^T / sqrt(64)) v_h
// reading q, k and v straight out of the fused QKV buffer [B, S, 3D].
//
// Replaces: the attention core of dclip_tpu/kernels/vit_block.py
//   `_attn_kernel` (lines 59-90): log2-domain softmax (exp2 with the scale
//   folded with log2 e), f32 row max and row sum, normalisation after the
//   PV product. The algebra is the same; the schedule is not. The TPU runs
//   one program per image with every head's [S, S] logits in VMEM; here a
//   block owns one (image, head, 64-query tile) and walks the keys in tiles
//   of 64 with an online softmax, so no [S, S] tensor exists anywhere.
// Bound on the H100: at S = 197 the per-head work is small (~10 MFLOP per
//   query tile), so the kernel is bound by latency and by the 16-byte
//   loads of K and V; occupancy comes from B * H * ceil(S/64) blocks
//   (3,072 at the serving bucket of 64).
// Design: 4 warps x 16 query rows. Per key tile: QK^T on WMMA bf16
//   fragments into an f32 scratch, a row-wise online softmax in f32 (two
//   lanes per row), P rounded to bf16 and PV on WMMA accumulating into an
//   f32 output tile in shared memory that the softmax rescales. Keys past S
//   are zero-filled and masked to -inf (197 is not a multiple of 16 or 64);
//   query rows past S are computed on zeros and not stored. The row sum is
//   taken over the bf16-rounded P that enters the PV product, so the
//   normalised weights sum to one exactly as in the ones-column trick.
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
constexpr int kSmemBytes = kQBytes + 2 * kKBytes + 2 * kSBytes + kPBytes;

// rows [r0, r0 + 64) of one 64-column head slice at column `col` of the
// [S, ld] buffer into a [64, kLdh] shared tile; rows >= s are zero.
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* __restrict__ src,
                                          int r0, int s, int ld, int col) {
#pragma unroll
  for (int i = 0; i < (64 * 8) / (kWarps * 32); ++i) {
    const int c = threadIdx.x + i * kWarps * 32;
    const int row = c >> 3, c8 = (c & 7) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r0 + row < s)
      v = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r0 + row) * ld + col + c8);
    *reinterpret_cast<uint4*>(dst + row * kLdh + c8) = v;
  }
}

__global__ void __launch_bounds__(kWarps * 32)
    attention_kernel(const __nv_bfloat16* __restrict__ qkv,
                     __nv_bfloat16* __restrict__ out, int s, int heads) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sk = reinterpret_cast<__nv_bfloat16*>(smem + kQBytes);
  __nv_bfloat16* sv = reinterpret_cast<__nv_bfloat16*>(smem + kQBytes + kKBytes);
  float* ss_all = reinterpret_cast<float*>(smem + kQBytes + 2 * kKBytes);
  float* so_all = reinterpret_cast<float*>(smem + kQBytes + 2 * kKBytes + kSBytes);
  __nv_bfloat16* sp_all =
      reinterpret_cast<__nv_bfloat16*>(smem + kQBytes + 2 * kKBytes + 2 * kSBytes);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * kQTile, h = blockIdx.y, b = blockIdx.z;
  const int d = heads * kHd, ld = 3 * d;
  const __nv_bfloat16* base = qkv + static_cast<size_t>(b) * s * ld;
  float* ss = ss_all + warp * 16 * kLds;
  float* so = so_all + warp * 16 * kLds;
  __nv_bfloat16* sp = sp_all + warp * 16 * kLdh;

  load_rows(sq, base, q0, s, ld, h * kHd);
  for (int i = lane; i < 16 * kHd; i += 32) so[(i / kHd) * kLds + i % kHd] = 0.f;

  // Lane owns half (32 columns) of row `row` of its warp's 16 query rows.
  const int row = lane >> 1, half = lane & 1;
  const float scale_log2 = 0.125f * 1.4426950408889634f;  // 64^-0.5 * log2(e)
  float m_run = -INFINITY, l_run = 0.f;

  for (int k0 = 0; k0 < s; k0 += kKTile) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_rows(sk, base, k0, s, ld, d + h * kHd);
    load_rows(sv, base, k0, s, ld, 2 * d + h * kHd);
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

    // Online softmax in the log2 domain over this lane's 32 keys.
    float* srow = ss + row * kLds + half * 32;
    float mx = -INFINITY;
#pragma unroll 8
    for (int e = 0; e < 32; ++e) {
      const float v = (k0 + half * 32 + e < s) ? srow[e] * scale_log2 : -INFINITY;
      srow[e] = v;
      mx = fmaxf(mx, v);
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

  const int gq = q0 + warp * 16 + row;
  if (gq < s) {
    const float inv = 1.f / l_run;
    const float* orow = so + row * kLds + half * 32;
    __nv_bfloat16* dst = out + (static_cast<size_t>(b) * s + gq) * d + h * kHd + half * 32;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = orow[c * 8 + e] * inv;
      *reinterpret_cast<uint4*>(dst + c * 8) = dclip::pack8(v);
    }
  }
}

}  // namespace

// qkv: [b, s, 3 * heads * 64] bf16 (q | k | v, head-major inside each);
// out: [b, s, heads * 64] bf16. Both contiguous and 16-byte aligned.
extern "C" int dclip_attention_bf16(const void* qkv, void* out, int b, int s,
                                    int heads, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s + kQTile - 1) / kQTile, heads, b);
  attention_kernel<<<grid, kWarps * 32, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<__nv_bfloat16*>(out), s, heads);
  return static_cast<int>(cudaGetLastError());
}
