// Multi-head self-attention forward, head_dim 64 or 72, with optional
// masks and softmax statistics:
//   out[b, s, h*hd:(h+1)*hd] = softmax(mask(q_h k_h^T / sqrt(hd))) v_h
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
//   block owns 128 query rows of one (batch row, head) and walks the keys
//   in tiles of 64 with an online softmax, so no [S, S] tensor exists.
// Bound on the H100: at S = 197 (vision) and 77 (text) the per-head work
//   is small (4 * S^2 * 64 flops, ~10 MFLOP per head at S = 197), so the
//   kernel is bound by latency: the load of each K/V tile, the dependent
//   chain QK^T -> softmax -> PV, and the launch of B * H * ceil(S/128)
//   short blocks (6,144 at the training batch of 256 images).
// Design: two warpgroups per block, each owning 64 consecutive query rows
//   of the same (b, h), so one K/V tile in shared memory serves 128 rows;
//   two blocks per SM (~100 KB of shared memory, at most 128 registers a
//   thread each), so one block's softmax overlaps the other's wgmma. K/V
//   tiles of 64 keys go through a ring of 5 slots filled by 16-byte
//   cp.async stores in the 128-byte-swizzled layout wgmma reads: every
//   tile of S <= 320 (197, 257, 77) is requested before the first is
//   used, and longer rows refill a slot as soon as it is free, so the
//   loads' latency is paid once per block, not once per tile. Per tile and
//   warpgroup,
//   S = Q K^T is four wgmma m64n64k16 (Q and K from shared memory, both
//   K-major) into 32 f32 registers a thread; the masked online softmax runs
//   on those registers in the log2 domain, row max and row sum by quad
//   shuffles (a row's 64 keys lie in the four lanes of a quad); P is
//   rounded to bf16 in registers and is the register A operand of O += P V,
//   four more wgmma m64n64k16 with V from shared memory, MN-major. O stays
//   in f32 registers and is rescaled there; it is normalised once at the
//   end and stored as 16-byte vectors. Keys past S are zero-filled and
//   excluded with -inf (they are tile padding, not keys of the row); query
//   rows past S are computed on zeros and not stored. The row sum is taken
//   in f32 over the bf16-rounded P that enters the PV product, so the
//   normalised weights sum to one exactly as in the TPU's ones-column trick
//   and rinv is the one the backward needs.
// Head_dim 72 (SigLIP so400m: 16 heads of 72 at width 1152): 72 is not a
//   multiple of wgmma's k = 16, and a 128-byte swizzled row holds 64 bf16.
//   Each Q, K and V tile is then two swizzled [64][64] atoms: columns 0-63,
//   and a tail atom whose chunk 0 holds columns 64-71 and chunk 1 zeros, so
//   Q K^T is five k16 steps (the fifth over columns 64-79, eight of them
//   zero in both operands) and P V is an m64n64 product over the first atom
//   plus an m64n8 one over the tail's first eight columns (36 accumulators a
//   thread). The tiles are twice the bytes, so the ring holds two K/V tiles
//   (~97 KB a block, still two blocks an SM). With statistics it can also
//   write o_lo = bf16(o - bf16(o)), what the bf16 output drops: the
//   backward's delta = rowsum(g o) is a small difference of large terms
//   when a head's values are close to their mean (SigLIP's deep unmasked
//   towers at their initial weights), and takes o + o_lo there.
#include <math.h>

#include "common.cuh"
#include "sm90.cuh"

namespace {

namespace sm = dclip::sm90;

constexpr int kTile = 64;                     // query rows per warpgroup, keys per tile
constexpr int kGroups = 2;                    // warpgroups per block
constexpr int kThreads = kGroups * 128;
constexpr int kAtomBytes = kTile * 64 * 2;    // one swizzled [64][64] bf16 atom, 8 KB

// The shapes of head_dim kHd (64 or 72): atoms a tile, k16 steps of Q K^T,
// the K/V ring (all of S <= 320 at 64) and the softmax scale with log2(e).
template <int kHd>
struct Head {
  static_assert(kHd == 64 || kHd == 72, "head_dim 64 or 72");
  static constexpr bool kTail = kHd == 72;
  static constexpr int kTileBytes = (kTail ? 2 : 1) * kAtomBytes;
  static constexpr int kSteps = kTail ? 5 : 4;
  static constexpr int kRing = kTail ? 2 : 5;
  static constexpr int kSmemBytes =
      (kGroups + 2 * kRing) * kTileBytes + kRing * kTile * 8 + 1024;
  static constexpr float kScaleLog2 =
      (kTail ? 0.11785113019775793f : 0.125f) * 1.4426950408889634f;
};

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(dclip::kFullMask, v, 1));
  return fmaxf(v, __shfl_xor_sync(dclip::kFullMask, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(dclip::kFullMask, v, 1);
  return v + __shfl_xor_sync(dclip::kFullMask, v, 2);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// kMasked: any of causal, pad, seg is given (the unmasked frozen-tower
// core skips the per-key mask terms).
template <int kHd, bool kMasked>
__global__ void __launch_bounds__(kThreads, 2)
    attention_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, int ldq, int ldk,
                     int ldv, __nv_bfloat16* __restrict__ out,
                     const float* __restrict__ pad, const int* __restrict__ seg,
                     float* __restrict__ m_out, float* __restrict__ r_out,
                     __nv_bfloat16* __restrict__ o_lo, int s, int heads, int causal) {
  using H = Head<kHd>;
  constexpr int kRing = H::kRing, kTileBytes = H::kTileBytes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sq = sm::align1024(smem_raw);
  unsigned char* sk = sq + kGroups * kTileBytes;  // [kRing] K tiles
  unsigned char* sv = sk + kRing * kTileBytes;    // [kRing] V tiles
  float* kpad = reinterpret_cast<float*>(sv + kRing * kTileBytes);  // [kRing][64]
  int* kseg = reinterpret_cast<int*>(kpad + kRing * kTile);          // [kRing][64]

  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * kGroups * kTile, h = blockIdx.y, b = blockIdx.z;
  const int d = heads * kHd;
  const __nv_bfloat16* qb = q + static_cast<size_t>(b) * s * ldq + h * kHd;
  const __nv_bfloat16* kb = k + static_cast<size_t>(b) * s * ldk + h * kHd;
  const __nv_bfloat16* vb = v + static_cast<size_t>(b) * s * ldv + h * kHd;
  const int tiles = (s + kTile - 1) / kTile;

  // Tile `tile` (if it exists) into ring slot tile % kRing; one cp.async
  // group per call, empty past the last tile, so that "tile j landed" is
  // always "all but the last kRing - 1 groups done".
  auto load_kv = [&](int tile) {
    if (tile < tiles) {
      const int k0 = tile * kTile, slot = tile % kRing;
      sm::load_rows_async<kTile, kThreads>(sk + slot * kTileBytes, kb, k0, s, ldk);
      sm::load_rows_async<kTile, kThreads>(sv + slot * kTileBytes, vb, k0, s, ldv);
      if constexpr (H::kTail) {
        sm::load_tail_async<kTile, kThreads>(sk + slot * kTileBytes + kAtomBytes, kb + 64, k0, s,
                                             ldk, kTileBytes);
        sm::load_tail_async<kTile, kThreads>(sv + slot * kTileBytes + kAtomBytes, vb + 64, k0, s,
                                             ldv, kTileBytes);
      }
      if (kMasked && threadIdx.x < kTile) {
        const int key = k0 + threadIdx.x;
        const size_t at = static_cast<size_t>(b) * s + key;
        kpad[slot * kTile + threadIdx.x] = (pad != nullptr && key < s) ? pad[at] : 1.f;
        kseg[slot * kTile + threadIdx.x] = (seg != nullptr && key < s) ? seg[at] : 0;
      }
    }
    dclip::cp_async_commit();
  };

  // Q joins tile 0's group.
  if constexpr (H::kTail) {
#pragma unroll
    for (int g = 0; g < kGroups; ++g)
      sm::load_rows_async<kTile, kThreads>(sq + g * kTileBytes, qb, q0 + g * kTile, s, ldq);
    sm::load_tail_async<kGroups * kTile, kThreads>(sq + kAtomBytes, qb + 64, q0, s, ldq,
                                                   kTileBytes);
  } else {
    sm::load_rows_async<kGroups * kTile, kThreads>(sq, qb, q0, s, ldq);
  }
#pragma unroll
  for (int t = 0; t < kRing; ++t) load_kv(t);

  // This thread's two rows (of its warp's 16) and its key columns 2 (lane
  // % 4) + {0, 1} of each 8-key group.
  const int row_lo = q0 + wg * kTile + warp * 16 + (lane >> 2), row_hi = row_lo + 8;
  const int col = 2 * (lane & 3);
  int seg_lo = 0, seg_hi = 0;
  if (kMasked && seg != nullptr) {
    if (row_lo < s) seg_lo = seg[static_cast<size_t>(b) * s + row_lo];
    if (row_hi < s) seg_hi = seg[static_cast<size_t>(b) * s + row_hi];
  }
  const float scale_log2 = H::kScaleLog2;  // hd^-0.5 * log2(e)
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
  float o[32], o8[4] = {0.f, 0.f, 0.f, 0.f};  // o8: head_dim 72's columns 64-71
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;

  const uint64_t dq = sm::desc_sw128(sq + wg * kTileBytes, 16, 1024);
  for (int j = 0; j < tiles; ++j) {
    const int slot = j % kRing;
    dclip::cp_async_wait<kRing - 1>();
    sm::fence_proxy_async();  // this thread's cp.async stores, visible to wgmma
    __syncthreads();          // tile j (and Q) landed for every thread

    // S = Q K^T: 64 rows x 64 keys per warpgroup.
    float sacc[32];
    const uint64_t dk = sm::desc_sw128(sk + slot * kTileBytes, 16, 1024);
    sm::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < H::kSteps; ++kk) {
      const uint32_t at = (kk / 4) * kAtomBytes + (kk % 4) * 32;  // the tail: atom 1
      sm::wgmma_m64n64k16_ss<0, 0>(sacc, sm::desc_add(dq, at), sm::desc_add(dk, at), kk > 0);
    }
    sm::wgmma_commit();
    sm::wgmma_wait<0>();
    sm::fence_regs(sacc);

    // Masked log2-domain logits; sacc[4 g + e] is key 8 g + col + (e & 1)
    // of row_lo (e < 2) or row_hi.
    const int k0 = j * kTile;
    const float* tpad = kpad + slot * kTile;
    const int* tseg = kseg + slot * kTile;
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int kl = 8 * (i / 4) + col + (i & 1), key = k0 + kl;
      const bool hi = (i & 2) != 0;
      float l = -INFINITY;
      if (key < s) {
        bool keep = true;
        if (kMasked)
          keep = (!causal || key <= (hi ? row_hi : row_lo)) &&
                 (seg == nullptr || tseg[kl] == (hi ? seg_hi : seg_lo)) && tpad[kl] > 0.f;
        l = keep ? sacc[i] * scale_log2 : dclip::kNegBig;
      }
      sacc[i] = l;
      if (hi) mx_hi = fmaxf(mx_hi, l); else mx_lo = fmaxf(mx_lo, l);
    }
    // Finite: every tile holds a key < s, whose logit is real or -1e30.
    const float mn_lo = fmaxf(m_lo, quad_max(mx_lo)), mn_hi = fmaxf(m_hi, quad_max(mx_hi));
    const float a_lo = exp2f(m_lo - mn_lo), a_hi = exp2f(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;

    // P in bf16, packed as the A fragments of four k16 steps; the row sums
    // over the rounded values.
    uint32_t p[16];
    float rs_lo = 0.f, rs_hi = 0.f;
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const bool hi = (i & 2) != 0;
      const float mref = hi ? mn_hi : mn_lo;
      const __nv_bfloat16 p0 = __float2bfloat16(exp2f(sacc[i] - mref));
      const __nv_bfloat16 p1 = __float2bfloat16(exp2f(sacc[i + 1] - mref));
      const float sum = __bfloat162float(p0) + __bfloat162float(p1);
      if (hi) rs_hi += sum; else rs_lo += sum;
      // Key group g = i / 4 is half (g & 1) of k16 step g / 2: register
      // 4 (g / 2) + 2 (g & 1) + (row_hi ? 1 : 0).
      p[4 * (i / 8) + 2 * ((i / 4) & 1) + (hi ? 1 : 0)] = pack_bf16(p0, p1);
    }
    l_lo = l_lo * a_lo + rs_lo;
    l_hi = l_hi * a_hi + rs_hi;
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] *= (i & 2) ? a_hi : a_lo;
    if constexpr (H::kTail) {
#pragma unroll
      for (int i = 0; i < 4; ++i) o8[i] *= (i & 2) ? a_hi : a_lo;
    }

    // O += P V (head_dim 72: its columns 64-71 from the tail atom).
    const uint64_t dv = sm::desc_sw128(sv + slot * kTileBytes, kAtomBytes, 1024);
    sm::fence_regs(p);
    sm::fence_regs(o);
    if constexpr (H::kTail) sm::fence_regs(o8);
    sm::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
      sm::wgmma_m64n64k16_rs<1>(o, p + 4 * kk, sm::desc_add(dv, kk * 2048), 1);
    if constexpr (H::kTail) {
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk)
        sm::wgmma_m64n8k16_rs<1>(o8, p + 4 * kk, sm::desc_add(dv, kAtomBytes + kk * 2048), 1);
    }
    sm::wgmma_commit();
    sm::wgmma_wait<0>();
    sm::fence_regs(o);
    if constexpr (H::kTail) sm::fence_regs(o8);
    if (j + kRing < tiles) __syncthreads();  // every warpgroup is done with the slot
    load_kv(j + kRing);
  }

  const float inv_lo = 1.f / quad_sum(l_lo), inv_hi = 1.f / quad_sum(l_hi);
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] *= (i & 2) ? inv_hi : inv_lo;
  if constexpr (H::kTail) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = half ? row_hi : row_lo;
      if (row < s) {
        const float inv = half ? inv_hi : inv_lo;
        const float x0 = o8[2 * half] * inv, x1 = o8[2 * half + 1] * inv;
        const __nv_bfloat162 v2 = __floats2bfloat162_rn(x0, x1);
        const size_t at = (static_cast<size_t>(b) * s + row) * d + h * kHd + 64 + col;
        *reinterpret_cast<__nv_bfloat162*>(out + at) = v2;
        if (o_lo != nullptr) {
          const float2 r = __bfloat1622float2(v2);
          *reinterpret_cast<__nv_bfloat162*>(o_lo + at) = __floats2bfloat162_rn(x0 - r.x, x1 - r.y);
        }
      }
    }
  }
#pragma unroll
  for (int g0 = 0; g0 < 64 / 8; g0 += 4) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float vals[8];
      sm::quad_gather8(o, g0, half, vals);
      const int row = half ? row_hi : row_lo;
      if (row < s) {
        const size_t at = (static_cast<size_t>(b) * s + row) * d + h * kHd + (g0 + (lane & 3)) * 8;
        const uint4 packed = dclip::pack8(vals);
        *reinterpret_cast<uint4*>(out + at) = packed;
        if constexpr (H::kTail) {
          if (o_lo != nullptr) {
            float rounded[8];
            dclip::unpack8(packed, rounded);
#pragma unroll
            for (int e = 0; e < 8; ++e) vals[e] -= rounded[e];
            *reinterpret_cast<uint4*>(o_lo + at) = dclip::pack8(vals);
          }
        }
      }
    }
  }
  if (m_out != nullptr && (lane & 3) == 0) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = half ? row_hi : row_lo;
      if (row < s) {
        const size_t at = (static_cast<size_t>(b) * s + row) * heads + h;
        m_out[at] = half ? m_hi : m_lo;
        r_out[at] = half ? inv_hi : inv_lo;
      }
    }
  }
}

template <int kHd, bool kMasked>
int launch_masked(const void* q, const void* k, const void* v, int ldq, int ldk, int ldv,
                  void* out, const void* pad, const void* seg, void* m, void* r, void* o_lo,
                  int b, int s, int heads, int causal, void* stream) {
  constexpr int kSmemBytes = Head<kHd>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<kHd, kMasked>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s + kGroups * kTile - 1) / (kGroups * kTile), heads, b);
  attention_kernel<kHd, kMasked>
      <<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), ldq, ldk, ldv,
      static_cast<__nv_bfloat16*>(out), static_cast<const float*>(pad),
      static_cast<const int*>(seg), static_cast<float*>(m), static_cast<float*>(r),
      static_cast<__nv_bfloat16*>(o_lo), s, heads, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int kHd>
int launch(const void* q, const void* k, const void* v, int ldq, int ldk, int ldv,
           void* out, const void* pad, const void* seg, void* m, void* r, void* o_lo, int b,
           int s, int heads, int causal, void* stream) {
  return (causal || pad != nullptr || seg != nullptr)
             ? launch_masked<kHd, true>(q, k, v, ldq, ldk, ldv, out, pad, seg, m, r, o_lo, b,
                                        s, heads, causal, stream)
             : launch_masked<kHd, false>(q, k, v, ldq, ldk, ldv, out, pad, seg, m, r, o_lo, b,
                                         s, heads, causal, stream);
}

}  // namespace

// qkv: [b, s, 3 * heads * 64] bf16 (q | k | v, head-major inside each);
// out: [b, s, heads * 64] bf16. Both contiguous and 16-byte aligned.
// Unmasked, no statistics: the frozen image tower's attention core.
extern "C" int dclip_attention_bf16(const void* qkv, void* out, int b, int s,
                                    int heads, void* stream) {
  const int d = heads * 64;
  const __nv_bfloat16* base = static_cast<const __nv_bfloat16*>(qkv);
  return launch<64>(base, base + d, base + 2 * d, 3 * d, 3 * d, 3 * d, out, nullptr,
                    nullptr, nullptr, nullptr, nullptr, b, s, heads, 0, stream);
}

// q, k, v: [b, s, heads * head_dim] bf16 views with unit column stride and
// row strides ldq / ldk / ldv (elements, multiples of 8; batch stride s *
// ld), 16-byte aligned; head_dim 64 or 72. out: [b, s, heads * head_dim]
// bf16 contiguous. pad: [b, s] f32 (key j valid when > 0) or null; seg: [b,
// s] int32 or null; m, r: [b, s, heads] f32 or both null (the stats-free
// mode); o_lo: like out, or null (written at head_dim 72 with statistics).
extern "C" int dclip_attention_fwd_bf16(const void* q, const void* k, const void* v,
                                        int ldq, int ldk, int ldv, void* out,
                                        const void* pad, const void* seg, void* m,
                                        void* r, void* o_lo, int b, int s, int heads,
                                        int head_dim, int causal, void* stream) {
  if (head_dim == 64)
    return launch<64>(q, k, v, ldq, ldk, ldv, out, pad, seg, m, r, nullptr, b, s, heads, causal,
                      stream);
  if (head_dim == 72)
    return launch<72>(q, k, v, ldq, ldk, ldv, out, pad, seg, m, r, o_lo, b, s, heads, causal,
                      stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
