// Multi-head self-attention backward, head_dim 64 or 72, from the forward's
// output and softmax statistics: dq, dk, dv given q, k, v, the output
// gradient g, the output o, m (log2-domain row max) and rinv [B, S, H].
//
// Replaces: dclip_tpu/kernels/vit_attention.py `_bwd_kernel` (K5, line
//   308, `_self_attention_bwd_stats`). The algebra is the TPU's: per head,
//   e = exp2(mask(scale log2e q k^T) - m) recomputed from the saved stats
//   (no max or sum pass), dV = e^T bf16(g rinv), dP = g v^T,
//   dS = e ((dP - delta) rinv), dQ = scale dS k, dK = scale dS^T q, with
//   delta = rowsum(g o) per head in f32 (the flash-attention identity).
//   Masks as in the forward (`_mask_logits`, the finite -1e30). The TPU
//   keeps every head's [S, S] tiles of one batch row in VMEM; blocks here
//   run in parallel with no order between them, so the work splits into
//   two kernels with no atomics (7 products per tile pair against 5 for
//   one kernel, but every sum has one owner and a fixed order, so two runs
//   give the same bits):
//   - dq: a block owns 128 query rows of one (batch row, head) and walks
//     the key tiles; it also computes delta for its rows and writes it;
//   - dkdv: a block owns 128 keys and walks the query tiles, reading delta.
//   No [S, S] tensor reaches device memory.
// Bound on the H100: at S = 197 / 77 the work per head is small (~10 flops
//   per byte moved), so the kernels are bound by latency: the loads of the
//   streamed tiles, the dependent chain of products and exponentials per
//   tile, and the launch of B * H * ceil(S/128) short blocks.
// Design: the forward's (csrc/attention.cu). Two warpgroups a block, each
//   owning 64 rows (queries in dq, keys in dkdv), so one streamed tile in
//   shared memory serves 128 rows; two blocks an SM (~100-110 KB of shared
//   memory, at most 128 registers a thread), so one block's exponentials
//   and masks overlap the other's wgmma. The streamed tiles (K/V in dq, Q/g
//   with their m, rinv, delta and segment ids in dkdv) go through a ring of
//   4 slots filled by 16-byte cp.async stores in the 128-byte-swizzled
//   layout wgmma reads (4-byte cp.async for the per-row stats): every tile
//   of S <= 256 (197, 77) is requested before the first is used, and longer
//   rows refill a slot as soon as it is free. Per tile and warpgroup:
//   - dq: S = Q K^T and dP = g V^T are wgmma m64n64k16 with both operands
//     K-major from shared memory, into f32 registers; dS is formed there
//     with the masks, rounded to bf16 in registers and is the register A
//     operand of dQ += dS K (K read MN-major, as the forward reads V).
//   - dkdv: S^T = K Q^T, then P^T = exp2(S^T c - m) in registers (m of the
//     query columns from the staged stats), rounded to bf16, the register A
//     operand of dV += P^T GR, where GR = bf16(g rinv) is formed once per
//     query tile in shared memory (the TPU's `grs`); dP^T = V g^T runs in
//     the same wgmma group; dS^T = P^T ((dP^T - delta) rinv) from the bf16
//     P^T (keeping the f32 one live would cost 32 registers a thread and
//     the second block an SM), rounded to bf16, the A operand of
//     dK += dS^T Q (Q read MN-major).
//   No S, P or dS goes through shared memory. The ragged last tile of a
//   row with at most 16 live columns (S = 197: 5, S = 77: 13) runs
//   m64n16k16 products and one k16 step of the accumulating products, a
//   quarter of a full tile's work. Keys past S are excluded (e = 0); query
//   rows past S arrive as zeros with zero m, rinv and delta, so they add
//   exactly zero to dK and dV; rows past S are not stored.
// Head_dim 72: every Q, K, V, g and GR tile is two swizzled atoms as in the
//   forward (csrc/attention.cu): columns 0-63, and a tail atom with columns
//   64-71 in chunk 0 and zeros in chunk 1. The products over head_dim (S,
//   dP and their transposes) take a fifth k16 step over the tail; those
//   into head_dim (dQ, dK, dV) add an m64n8 product over the tail's first
//   eight columns. The tiles are twice the bytes, so the rings hold two
//   tiles and a block takes its SM alone (~131 KB dq, ~147 KB dk/dv).
//   At head_dim 72 dS enters dQ = dS K and dK = dS^T Q as two bf16 parts,
//   hi = bf16(dS) and lo = bf16(dS - hi), one product each (~16 bits of dS),
//   and the dk/dv kernel forms dS^T from the f32 P^T (the bf16 one still
//   feeds dV). SigLIP's deep unmasked towers at their initial weights carry
//   keys and queries close to one common vector: dQ_i = sum_j dS_ij k_j
//   cancels it exactly because each row of dS sums to zero, and a dS rounded
//   to bf16 alone leaves that vector times its rows' rounding error, larger
//   than the true dQ (and the same for the key projection's gradient).
//   For the same reason delta = rowsum(g o) takes the forward's residual
//   o_lo beside o there (csrc/attention.cu): with values close to their
//   mean, dP - delta is a small difference, and a delta from the bf16 o
//   alone was the larger error of the two (an emulation at 0.1 of the
//   values' spread: 1.2x the true dQ, against 0.015 from dS's rounding).
#include <math.h>

#include <type_traits>

#include "common.cuh"
#include "sm90.cuh"

namespace {

namespace sm = dclip::sm90;

constexpr int kTile = 64;                     // rows per warpgroup, columns per tile
constexpr int kGroups = 2;                    // warpgroups per block
constexpr int kThreads = kGroups * 128;
constexpr int kNarrow = 16;                   // width of the ragged last tile's products
constexpr int kAtomBytes = kTile * 64 * 2;    // one swizzled [64][64] bf16 atom, 8 KB

// The shapes of head_dim kHd (64 or 72): atoms a tile, k16 steps of a
// product over head_dim, the rings (all of S <= 256 at 64), blocks an SM,
// the scale (and with log2(e)), and the two kernels' shared memory: dq
// holds Q, g (two warpgroups) + the K, V ring, key pad / seg per slot and
// delta; dk/dv holds K, V (two warpgroups) + the Q, g ring + GR, and m,
// rinv, delta, seg per slot.
template <int kHd>
struct Head {
  static_assert(kHd == 64 || kHd == 72, "head_dim 64 or 72");
  static constexpr bool kTail = kHd == 72;
  static constexpr int kTileBytes = (kTail ? 2 : 1) * kAtomBytes;
  static constexpr int kSteps = kTail ? 5 : 4;
  static constexpr int kRing = kTail ? 2 : 4;
  static constexpr int kBlocks = kTail ? 1 : 2;
  static constexpr float kScale = kTail ? 0.11785113019775793f : 0.125f;
  static constexpr float kScaleLog2 = kScale * 1.4426950408889634f;
  static constexpr int kDqSmem = (2 * kGroups + 2 * kRing) * kTileBytes + kRing * kTile * 8 +
                                 kGroups * kTile * 4 + 1024;
  static constexpr int kDkvSmem =
      (2 * kGroups + 2 * kRing + 1) * kTileBytes + kRing * kTile * 16 + 1024;
};

// The byte offset of k16 step kk of a product over head_dim in a tile:
// steps 0-3 in the first atom, step 4 (head_dim 72) in the tail atom.
__device__ __forceinline__ constexpr uint32_t step_at(int kk) {
  return (kk / 4) * kAtomBytes + (kk % 4) * 32;
}

using Narrow = std::integral_constant<int, kNarrow>;
using Full = std::integral_constant<int, kTile>;

// 4 bytes global -> shared through cp.async; zero-filled when `pred` is false.
__device__ __forceinline__ void cp_async_4(void* smem, const void* gmem, bool pred) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(pred ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(hi))) << 16);
}

// bf16 pairs of x - bf16(x): what pack_bf16 drops, the low part of a split.
__device__ __forceinline__ uint32_t pack_bf16_rest(float lo, float hi) {
  return pack_bf16(lo - __bfloat162float(__float2bfloat16(lo)),
                   hi - __bfloat162float(__float2bfloat16(hi)));
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return make_float2(__bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(v))),
                     __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(v >> 16))));
}

// D[64 x N] (+)= A B over one k16 step, both operands K-major from shared
// memory; N = 64 or the narrow 16.
template <int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int acc) {
  if constexpr (N == kTile)
    sm::wgmma_m64n64k16_ss<0, 0>(d, a, b, acc);
  else
    sm::wgmma_m64n16k16_ss<0, 0>(d, a, b, acc);
}

// Register index of accumulator pair i (columns 8 (i / 4) + 2 (lane % 4)
// + {0, 1} of row lo (i & 2 == 0) or hi) in the register A fragments of
// the k16 steps (see attention.cu).
__device__ __forceinline__ constexpr int frag(int i) {
  return 4 * (i / 8) + 2 * ((i / 4) & 1) + ((i & 2) ? 1 : 0);
}

// acc * scale as bf16, rows `row_lo` / `row_hi` (< s only) of a head slice
// with row stride ld, 16 bytes at a time; head_dim 72's columns 64-71 from
// acc8, one bf16 pair a lane.
template <bool kTail>
__device__ __forceinline__ void store_rows(const float (&acc)[32], const float (&acc8)[4],
                                           float scale, __nv_bfloat16* __restrict__ dst, int ld,
                                           int row_lo, int row_hi, int s) {
  const int lane = threadIdx.x & 31;
  if constexpr (kTail) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = half ? row_hi : row_lo;
      if (row < s)
        *reinterpret_cast<__nv_bfloat162*>(dst + static_cast<size_t>(row) * ld + 64 +
                                           2 * (lane & 3)) =
            __floats2bfloat162_rn(acc8[2 * half] * scale, acc8[2 * half + 1] * scale);
    }
  }
#pragma unroll
  for (int g0 = 0; g0 < 64 / 8; g0 += 4) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float vals[8];
      sm::quad_gather8(acc, g0, half, vals);
      const int row = half ? row_hi : row_lo;
      if (row < s) {
#pragma unroll
        for (int e = 0; e < 8; ++e) vals[e] *= scale;
        *reinterpret_cast<uint4*>(dst + static_cast<size_t>(row) * ld + (g0 + (lane & 3)) * 8) =
            dclip::pack8(vals);
      }
    }
  }
}

// kMasked: any of causal, pad, seg is given.
template <int kHd, bool kMasked>
__global__ void __launch_bounds__(kThreads, Head<kHd>::kBlocks)
    attention_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v, int ldq, int ldk, int ldv,
                            const __nv_bfloat16* __restrict__ g,
                            const __nv_bfloat16* __restrict__ o,
                            const __nv_bfloat16* __restrict__ o_lo,
                            const float* __restrict__ m, const float* __restrict__ r,
                            const float* __restrict__ pad, const int* __restrict__ seg,
                            float* __restrict__ delta, __nv_bfloat16* __restrict__ dq,
                            int lddq, int s, int heads, int causal) {
  using H = Head<kHd>;
  constexpr int kRing = H::kRing, kTileBytes = H::kTileBytes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sq = sm::align1024(smem_raw);
  unsigned char* sg = sq + kGroups * kTileBytes;
  unsigned char* sk = sg + kGroups * kTileBytes;  // [kRing] K tiles
  unsigned char* sv = sk + kRing * kTileBytes;    // [kRing] V tiles
  float* kpad = reinterpret_cast<float*>(sv + kRing * kTileBytes);  // [kRing][64]
  int* kseg = reinterpret_cast<int*>(kpad + kRing * kTile);          // [kRing][64]
  float* sdelta = reinterpret_cast<float*>(kseg + kRing * kTile);    // [128]

  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * kGroups * kTile, h = blockIdx.y, b = blockIdx.z;
  const int d = heads * kHd;
  const size_t rows0 = static_cast<size_t>(b) * s;
  const __nv_bfloat16* qb = q + rows0 * ldq + h * kHd;
  const __nv_bfloat16* kb = k + rows0 * ldk + h * kHd;
  const __nv_bfloat16* vb = v + rows0 * ldv + h * kHd;
  const __nv_bfloat16* gb = g + rows0 * d + h * kHd;
  const __nv_bfloat16* ob = o + rows0 * d + h * kHd;
  const int tiles = (s + kTile - 1) / kTile;

  // Tile `tile` (if it exists) into ring slot tile % kRing; one cp.async
  // group per call, empty past the last tile.
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
      if (kMasked && threadIdx.x < 2 * kTile) {
        const int j = threadIdx.x % kTile, key = k0 + j;
        const bool ok = key < s;
        const size_t at = rows0 + (ok ? key : 0);
        if (threadIdx.x < kTile) {
          if (pad != nullptr) cp_async_4(kpad + slot * kTile + j, pad + at, ok);
        } else if (seg != nullptr) {
          cp_async_4(kseg + slot * kTile + j, seg + at, ok);
        }
      }
    }
    dclip::cp_async_commit();
  };

  // Q and g join tile 0's group.
  if constexpr (H::kTail) {
#pragma unroll
    for (int w = 0; w < kGroups; ++w) {
      sm::load_rows_async<kTile, kThreads>(sq + w * kTileBytes, qb, q0 + w * kTile, s, ldq);
      sm::load_rows_async<kTile, kThreads>(sg + w * kTileBytes, gb, q0 + w * kTile, s, d);
    }
    sm::load_tail_async<kGroups * kTile, kThreads>(sq + kAtomBytes, qb + 64, q0, s, ldq,
                                                   kTileBytes);
    sm::load_tail_async<kGroups * kTile, kThreads>(sg + kAtomBytes, gb + 64, q0, s, d,
                                                   kTileBytes);
  } else {
    sm::load_rows_async<kGroups * kTile, kThreads>(sq, qb, q0, s, ldq);
    sm::load_rows_async<kGroups * kTile, kThreads>(sg, gb, q0, s, d);
  }
#pragma unroll
  for (int t = 0; t < kRing; ++t) load_kv(t);

  // delta = rowsum(g o) of the block's 128 rows: two threads a row (head_dim
  // 72: the row's nine 8-column chunks alternately).
  if constexpr (H::kTail) {
    const int row = threadIdx.x >> 1, half = threadIdx.x & 1, gq = q0 + row;
    float dl = 0.f;
    if (gq < s) {
      const size_t at = static_cast<size_t>(gq) * d;
      const __nv_bfloat16* gp = gb + at;
      const __nv_bfloat16* op = ob + at;
      const __nv_bfloat16* lp = o_lo == nullptr ? nullptr : o_lo + rows0 * d + h * kHd + at;
#pragma unroll
      for (int c = half; c < kHd / 8; c += 2) {
        float fg[8], fo[8], fl[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        dclip::unpack8(*reinterpret_cast<const uint4*>(gp + c * 8), fg);
        dclip::unpack8(*reinterpret_cast<const uint4*>(op + c * 8), fo);
        if (lp != nullptr) dclip::unpack8(*reinterpret_cast<const uint4*>(lp + c * 8), fl);
#pragma unroll
        for (int e = 0; e < 8; ++e) dl += fg[e] * (fo[e] + fl[e]);
      }
    }
    dl += __shfl_xor_sync(dclip::kFullMask, dl, 1);
    if (half == 0) {
      sdelta[row] = dl;
      if (gq < s) delta[(rows0 + gq) * heads + h] = dl;
    }
  } else {
    const int row = threadIdx.x >> 1, half = threadIdx.x & 1, gq = q0 + row;
    float dl = 0.f;
    if (gq < s) {
      const __nv_bfloat16* gp = gb + static_cast<size_t>(gq) * d + half * 32;
      const __nv_bfloat16* op = ob + static_cast<size_t>(gq) * d + half * 32;
      uint4 gv[4], ov[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        gv[c] = *reinterpret_cast<const uint4*>(gp + c * 8);
        ov[c] = *reinterpret_cast<const uint4*>(op + c * 8);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float fg[8], fo[8];
        dclip::unpack8(gv[c], fg);
        dclip::unpack8(ov[c], fo);
#pragma unroll
        for (int e = 0; e < 8; ++e) dl += fg[e] * fo[e];
      }
    }
    dl += __shfl_xor_sync(dclip::kFullMask, dl, 1);
    if (half == 0) {
      sdelta[row] = dl;
      if (gq < s) delta[(rows0 + gq) * heads + h] = dl;
    }
  }

  // This thread's two query rows and its key columns 2 (lane % 4) + {0, 1}
  // of each 8-key group.
  const int lr = wg * kTile + warp * 16 + (lane >> 2);
  const int row_lo = q0 + lr, row_hi = row_lo + 8;
  const int col = 2 * (lane & 3);
  float m_lo = 0.f, m_hi = 0.f, r_lo = 0.f, r_hi = 0.f;
  int seg_lo = 0, seg_hi = 0;
  if (row_lo < s) {
    const size_t at = (rows0 + row_lo) * heads + h;
    m_lo = m[at];
    r_lo = r[at];
    if (kMasked && seg != nullptr) seg_lo = seg[rows0 + row_lo];
  }
  if (row_hi < s) {
    const size_t at = (rows0 + row_hi) * heads + h;
    m_hi = m[at];
    r_hi = r[at];
    if (kMasked && seg != nullptr) seg_hi = seg[rows0 + row_hi];
  }
  __syncthreads();  // sdelta
  const float dl_lo = sdelta[lr], dl_hi = sdelta[lr + 8];
  const bool live = q0 + wg * kTile < s;  // the warpgroup has a row < s

  float acc[32], acc8[4] = {0.f, 0.f, 0.f, 0.f};  // acc8: head_dim 72's columns 64-71
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  const uint64_t dqa = sm::desc_sw128(sq + wg * kTileBytes, 16, 1024);
  const uint64_t dga = sm::desc_sw128(sg + wg * kTileBytes, 16, 1024);

  for (int j = 0; j < tiles; ++j) {
    const int slot = j % kRing, k0 = j * kTile;
    dclip::cp_async_wait<kRing - 1>();
    sm::fence_proxy_async();  // this thread's cp.async stores, visible to wgmma
    __syncthreads();          // tile j (and Q, g) landed for every thread

    auto step = [&](auto width) {
      constexpr int N = decltype(width)::value;
      float sacc[N / 2], dpacc[N / 2];
      const uint64_t dk = sm::desc_sw128(sk + slot * kTileBytes, 16, 1024);
      const uint64_t dv = sm::desc_sw128(sv + slot * kTileBytes, 16, 1024);
      sm::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < H::kSteps; ++kk)
        mma_ss<N>(sacc, sm::desc_add(dqa, step_at(kk)), sm::desc_add(dk, step_at(kk)), kk > 0);
#pragma unroll
      for (int kk = 0; kk < H::kSteps; ++kk)
        mma_ss<N>(dpacc, sm::desc_add(dga, step_at(kk)), sm::desc_add(dv, step_at(kk)), kk > 0);
      sm::wgmma_commit();
      sm::wgmma_wait<0>();
      sm::fence_regs(sacc);
      sm::fence_regs(dpacc);

      // dS = e ((dP - delta) rinv), masked; sacc[4 g + e] is key
      // 8 g + col + (e & 1) of row_lo (e < 2) or row_hi.
      const float* tpad = kpad + slot * kTile;
      const int* tseg = kseg + slot * kTile;
      uint32_t ds[N / 4], ds_lo[H::kTail ? N / 4 : 1];  // ds_lo: head_dim 72's split
#pragma unroll
      for (int i = 0; i < N / 2; i += 2) {
        const bool hi = (i & 2) != 0;
        float dsv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kl = 8 * (i / 4) + col + e, key = k0 + kl;
          float p = 0.f;
          if (key < s) {
            bool keep = true;
            if (kMasked)
              keep = (!causal || key <= (hi ? row_hi : row_lo)) &&
                     (seg == nullptr || tseg[kl] == (hi ? seg_hi : seg_lo)) &&
                     (pad == nullptr || tpad[kl] > 0.f);
            const float l = keep ? sacc[i + e] * H::kScaleLog2 : dclip::kNegBig;
            p = exp2f(l - (hi ? m_hi : m_lo));
          }
          dsv[e] = p * ((dpacc[i + e] - (hi ? dl_hi : dl_lo)) * (hi ? r_hi : r_lo));
        }
        ds[frag(i)] = pack_bf16(dsv[0], dsv[1]);
        if constexpr (H::kTail) ds_lo[frag(i)] = pack_bf16_rest(dsv[0], dsv[1]);
      }

      // dQ += dS K, K MN-major (head_dim 72: its tail atom into acc8).
      const uint64_t dkm = sm::desc_sw128(sk + slot * kTileBytes, kAtomBytes, 1024);
      sm::fence_regs(ds);
      sm::fence_regs(acc);
      if constexpr (H::kTail) {
        sm::fence_regs(ds_lo);
        sm::fence_regs(acc8);
      }
      sm::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk)
        sm::wgmma_m64n64k16_rs<1>(acc, ds + 4 * kk, sm::desc_add(dkm, kk * 2048), 1);
      if constexpr (H::kTail) {
#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk) {
          sm::wgmma_m64n64k16_rs<1>(acc, ds_lo + 4 * kk, sm::desc_add(dkm, kk * 2048), 1);
          sm::wgmma_m64n8k16_rs<1>(acc8, ds + 4 * kk,
                                   sm::desc_add(dkm, kAtomBytes + kk * 2048), 1);
          sm::wgmma_m64n8k16_rs<1>(acc8, ds_lo + 4 * kk,
                                   sm::desc_add(dkm, kAtomBytes + kk * 2048), 1);
        }
      }
      sm::wgmma_commit();
      sm::wgmma_wait<0>();
      sm::fence_regs(acc);
      if constexpr (H::kTail) sm::fence_regs(acc8);
    };
    if (live) {
      if (s - k0 <= kNarrow) step(Narrow{}); else step(Full{});
    }
    if (j + kRing < tiles) __syncthreads();  // every warpgroup is done with the slot
    load_kv(j + kRing);
  }
  store_rows<H::kTail>(acc, acc8, H::kScale, dq + rows0 * lddq + h * kHd, lddq, row_lo,
                       row_hi, s);
}

template <int kHd, bool kMasked>
__global__ void __launch_bounds__(kThreads, Head<kHd>::kBlocks)
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
  using H = Head<kHd>;
  constexpr int kRing = H::kRing, kTileBytes = H::kTileBytes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sk = sm::align1024(smem_raw);
  unsigned char* sv = sk + kGroups * kTileBytes;
  unsigned char* sq = sv + kGroups * kTileBytes;  // [kRing] Q tiles
  unsigned char* sg = sq + kRing * kTileBytes;    // [kRing] g tiles
  unsigned char* sgr = sg + kRing * kTileBytes;   // GR of the current query tile
  float* qm = reinterpret_cast<float*>(sgr + kTileBytes);   // [kRing][64] each
  float* qr = qm + kRing * kTile;
  float* qd = qr + kRing * kTile;
  int* qs = reinterpret_cast<int*>(qd + kRing * kTile);

  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x & 31;
  const int k0 = blockIdx.x * kGroups * kTile, h = blockIdx.y, b = blockIdx.z;
  const int d = heads * kHd;
  const size_t rows0 = static_cast<size_t>(b) * s;
  const __nv_bfloat16* qb = q + rows0 * ldq + h * kHd;
  const __nv_bfloat16* gb = g + rows0 * d + h * kHd;
  const int tiles = (s + kTile - 1) / kTile;

  // Query tile `tile` and its rows' m, rinv, delta (and segment ids) into
  // ring slot tile % kRing; rows past S arrive as zeros.
  auto load_qg = [&](int tile) {
    if (tile < tiles) {
      const int q0 = tile * kTile, slot = tile % kRing;
      sm::load_rows_async<kTile, kThreads>(sq + slot * kTileBytes, qb, q0, s, ldq);
      sm::load_rows_async<kTile, kThreads>(sg + slot * kTileBytes, gb, q0, s, d);
      if constexpr (H::kTail) {
        sm::load_tail_async<kTile, kThreads>(sq + slot * kTileBytes + kAtomBytes, qb + 64, q0, s,
                                             ldq, kTileBytes);
        sm::load_tail_async<kTile, kThreads>(sg + slot * kTileBytes + kAtomBytes, gb + 64, q0, s,
                                             d, kTileBytes);
      }
      const int j = threadIdx.x % kTile, qi = q0 + j;
      const bool ok = qi < s;
      const size_t row = rows0 + (ok ? qi : 0), at = row * heads + h;
      float* dst = threadIdx.x < kTile ? qm : threadIdx.x < 2 * kTile ? qr : qd;
      const float* src = threadIdx.x < kTile ? m : threadIdx.x < 2 * kTile ? r : delta;
      if (threadIdx.x < 3 * kTile) {
        cp_async_4(dst + slot * kTile + j, src + at, ok);
      } else if (kMasked && seg != nullptr) {
        cp_async_4(qs + slot * kTile + j, seg + row, ok);
      }
    }
    dclip::cp_async_commit();
  };

  // K and V join tile 0's group.
  const __nv_bfloat16* kb = k + rows0 * ldk + h * kHd;
  const __nv_bfloat16* vb = v + rows0 * ldv + h * kHd;
  if constexpr (H::kTail) {
#pragma unroll
    for (int w = 0; w < kGroups; ++w) {
      sm::load_rows_async<kTile, kThreads>(sk + w * kTileBytes, kb, k0 + w * kTile, s, ldk);
      sm::load_rows_async<kTile, kThreads>(sv + w * kTileBytes, vb, k0 + w * kTile, s, ldv);
    }
    sm::load_tail_async<kGroups * kTile, kThreads>(sk + kAtomBytes, kb + 64, k0, s, ldk,
                                                   kTileBytes);
    sm::load_tail_async<kGroups * kTile, kThreads>(sv + kAtomBytes, vb + 64, k0, s, ldv,
                                                   kTileBytes);
  } else {
    sm::load_rows_async<kGroups * kTile, kThreads>(sk, kb, k0, s, ldk);
    sm::load_rows_async<kGroups * kTile, kThreads>(sv, vb, k0, s, ldv);
  }
#pragma unroll
  for (int t = 0; t < kRing; ++t) load_qg(t);

  // This thread's two key rows and its query columns 2 (lane % 4) + {0, 1}
  // of each 8-query group.
  const int key_lo = k0 + wg * kTile + warp * 16 + (lane >> 2), key_hi = key_lo + 8;
  const int col = 2 * (lane & 3);
  float kp_lo = 1.f, kp_hi = 1.f;
  int ks_lo = 0, ks_hi = 0;
  if (kMasked) {
    if (pad != nullptr) {
      kp_lo = key_lo < s ? pad[rows0 + key_lo] : 0.f;
      kp_hi = key_hi < s ? pad[rows0 + key_hi] : 0.f;
    }
    if (seg != nullptr) {
      ks_lo = key_lo < s ? seg[rows0 + key_lo] : 0;
      ks_hi = key_hi < s ? seg[rows0 + key_hi] : 0;
    }
  }
  const bool live = k0 + wg * kTile < s;  // the warpgroup has a key < s

  float dk_acc[32], dv_acc[32];
  float dk8[4] = {0.f, 0.f, 0.f, 0.f}, dv8[4] = {0.f, 0.f, 0.f, 0.f};  // head_dim 72's tail
#pragma unroll
  for (int i = 0; i < 32; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  const uint64_t dka = sm::desc_sw128(sk + wg * kTileBytes, 16, 1024);
  const uint64_t dva = sm::desc_sw128(sv + wg * kTileBytes, 16, 1024);
  const uint64_t grm = sm::desc_sw128(sgr, kAtomBytes, 1024);

  for (int j = 0; j < tiles; ++j) {
    const int slot = j % kRing, q0 = j * kTile;
    dclip::cp_async_wait<kRing - 1>();
    __syncthreads();  // tile j and its stats landed; the last tile's GR is free
    // GR = bf16(g rinv) per query row, in the g tile's swizzled layout.
#pragma unroll
    for (int i = 0; i < kTile * 8 / kThreads; ++i) {
      const int c = threadIdx.x + i * kThreads, row = c >> 3;
      const int off = sm::swizzle128(row, c & 7);
      float f[8];
      dclip::unpack8(*reinterpret_cast<const uint4*>(sg + slot * kTileBytes + off), f);
      const float rr = qr[slot * kTile + row];
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] *= rr;
      *reinterpret_cast<uint4*>(sgr + off) = dclip::pack8(f);
    }
    if constexpr (H::kTail) {
      // The tail's columns 64-71 (chunk 0 of the tail atom; only the m64n8
      // product reads GR's tail).
      if (threadIdx.x < kTile) {
        const int off = kAtomBytes + sm::swizzle128(threadIdx.x, 0);
        float f[8];
        dclip::unpack8(*reinterpret_cast<const uint4*>(sg + slot * kTileBytes + off), f);
        const float rr = qr[slot * kTile + threadIdx.x];
#pragma unroll
        for (int e = 0; e < 8; ++e) f[e] *= rr;
        *reinterpret_cast<uint4*>(sgr + off) = dclip::pack8(f);
      }
    }
    sm::fence_proxy_async();  // cp.async and GR stores, visible to wgmma
    __syncthreads();

    auto step = [&](auto width) {
      constexpr int N = decltype(width)::value;
      const float* tm = qm + slot * kTile;
      const float* tr = qr + slot * kTile;
      const float* td = qd + slot * kTile;
      const int* ts = qs + slot * kTile;
      const uint64_t dqk = sm::desc_sw128(sq + slot * kTileBytes, 16, 1024);
      const uint64_t dgk = sm::desc_sw128(sg + slot * kTileBytes, 16, 1024);

      // S^T = K Q^T: 64 keys x N queries.
      float sacc[N / 2];
      sm::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < H::kSteps; ++kk)
        mma_ss<N>(sacc, sm::desc_add(dka, step_at(kk)), sm::desc_add(dqk, step_at(kk)), kk > 0);
      sm::wgmma_commit();
      sm::wgmma_wait<0>();
      sm::fence_regs(sacc);

      // P^T = exp2(mask(S^T c) - m) in bf16; sacc[4 g + e] is query
      // 8 g + col + (e & 1) of key_lo (e < 2) or key_hi.
      uint32_t p[N / 4];
      float pf[H::kTail ? N / 2 : 1];  // head_dim 72: the f32 P^T that dS^T is formed from
#pragma unroll
      for (int i = 0; i < N / 2; i += 2) {
        const bool hi = (i & 2) != 0;
        float pv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ql = 8 * (i / 4) + col + e;
          bool keep = true;
          if (kMasked)
            keep = (!causal || (hi ? key_hi : key_lo) <= q0 + ql) &&
                   (seg == nullptr || ts[ql] == (hi ? ks_hi : ks_lo)) &&
                   (hi ? kp_hi : kp_lo) > 0.f;
          const float l = keep ? sacc[i + e] * H::kScaleLog2 : dclip::kNegBig;
          pv[e] = exp2f(l - tm[ql]);
        }
        p[frag(i)] = pack_bf16(pv[0], pv[1]);
        if constexpr (H::kTail) {
          pf[i] = pv[0];
          pf[i + 1] = pv[1];
        }
      }

      // dP^T = V g^T and dV += P^T GR (GR MN-major) in one group.
      float dpacc[N / 2];
      sm::fence_regs(p);
      sm::fence_regs(dv_acc);
      if constexpr (H::kTail) {
        sm::fence_regs(pf);
        sm::fence_regs(dv8);
      }
      sm::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < H::kSteps; ++kk)
        mma_ss<N>(dpacc, sm::desc_add(dva, step_at(kk)), sm::desc_add(dgk, step_at(kk)), kk > 0);
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk)
        sm::wgmma_m64n64k16_rs<1>(dv_acc, p + 4 * kk, sm::desc_add(grm, kk * 2048), 1);
      if constexpr (H::kTail) {
#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk)
          sm::wgmma_m64n8k16_rs<1>(dv8, p + 4 * kk, sm::desc_add(grm, kAtomBytes + kk * 2048),
                                   1);
      }
      sm::wgmma_commit();
      sm::wgmma_wait<0>();
      sm::fence_regs(dpacc);
      sm::fence_regs(dv_acc);
      if constexpr (H::kTail) sm::fence_regs(dv8);

      // dS^T = P^T ((dP^T - delta) rinv) in bf16.
      uint32_t ds[N / 4], ds_lo[H::kTail ? N / 4 : 1];
#pragma unroll
      for (int i = 0; i < N / 2; i += 2) {
        const int ql = 8 * (i / 4) + col;
        if constexpr (H::kTail) {
          const float d0 = pf[i] * ((dpacc[i] - td[ql]) * tr[ql]);
          const float d1 = pf[i + 1] * ((dpacc[i + 1] - td[ql + 1]) * tr[ql + 1]);
          ds[frag(i)] = pack_bf16(d0, d1);
          ds_lo[frag(i)] = pack_bf16_rest(d0, d1);
        } else {
          const float2 e2 = unpack_bf16(p[frag(i)]);
          ds[frag(i)] = pack_bf16(e2.x * ((dpacc[i] - td[ql]) * tr[ql]),
                                  e2.y * ((dpacc[i + 1] - td[ql + 1]) * tr[ql + 1]));
        }
      }

      // dK += dS^T Q, Q MN-major.
      const uint64_t dqm = sm::desc_sw128(sq + slot * kTileBytes, kAtomBytes, 1024);
      sm::fence_regs(ds);
      sm::fence_regs(dk_acc);
      if constexpr (H::kTail) {
        sm::fence_regs(ds_lo);
        sm::fence_regs(dk8);
      }
      sm::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk)
        sm::wgmma_m64n64k16_rs<1>(dk_acc, ds + 4 * kk, sm::desc_add(dqm, kk * 2048), 1);
      if constexpr (H::kTail) {
#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk) {
          sm::wgmma_m64n64k16_rs<1>(dk_acc, ds_lo + 4 * kk, sm::desc_add(dqm, kk * 2048), 1);
          sm::wgmma_m64n8k16_rs<1>(dk8, ds + 4 * kk, sm::desc_add(dqm, kAtomBytes + kk * 2048),
                                   1);
          sm::wgmma_m64n8k16_rs<1>(dk8, ds_lo + 4 * kk,
                                   sm::desc_add(dqm, kAtomBytes + kk * 2048), 1);
        }
      }
      sm::wgmma_commit();
      sm::wgmma_wait<0>();
      sm::fence_regs(dk_acc);
      if constexpr (H::kTail) sm::fence_regs(dk8);
    };
    if (live) {
      if (s - q0 <= kNarrow) step(Narrow{}); else step(Full{});
    }
    if (j + kRing < tiles) __syncthreads();  // every warpgroup is done with the slot
    load_qg(j + kRing);
  }
  store_rows<H::kTail>(dk_acc, dk8, H::kScale, dk + rows0 * lddk + h * kHd, lddk, key_lo,
                       key_hi, s);
  store_rows<H::kTail>(dv_acc, dv8, 1.f, dv + rows0 * lddv + h * kHd, lddv, key_lo, key_hi, s);
}

template <int kHd, bool kMasked>
int launch(const void* q, const void* k, const void* v, int ldq, int ldk, int ldv,
           const void* g, const void* o, const void* o_lo, const void* m, const void* r,
           const void* pad, const void* seg, void* delta, void* dq, void* dk, void* dv, int lddq,
           int lddk, int lddv, int b, int s, int heads, int causal, cudaStream_t st) {
  constexpr int kDqSmem = Head<kHd>::kDqSmem, kDkvSmem = Head<kHd>::kDkvSmem;
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_dq_kernel<kHd, kMasked>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(attention_bwd_dkdv_kernel<kHd, kMasked>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kDkvSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s + kGroups * kTile - 1) / (kGroups * kTile), heads, b);
  using B16 = __nv_bfloat16;
  attention_bwd_dq_kernel<kHd, kMasked><<<grid, kThreads, kDqSmem, st>>>(
      static_cast<const B16*>(q), static_cast<const B16*>(k), static_cast<const B16*>(v),
      ldq, ldk, ldv, static_cast<const B16*>(g), static_cast<const B16*>(o),
      static_cast<const B16*>(o_lo), static_cast<const float*>(m), static_cast<const float*>(r),
      static_cast<const float*>(pad), static_cast<const int*>(seg),
      static_cast<float*>(delta), static_cast<B16*>(dq), lddq, s, heads, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_dkdv_kernel<kHd, kMasked><<<grid, kThreads, kDkvSmem, st>>>(
      static_cast<const B16*>(q), static_cast<const B16*>(k), static_cast<const B16*>(v),
      ldq, ldk, ldv, static_cast<const B16*>(g), static_cast<const float*>(m),
      static_cast<const float*>(r), static_cast<const float*>(delta),
      static_cast<const float*>(pad), static_cast<const int*>(seg), static_cast<B16*>(dk),
      lddk, static_cast<B16*>(dv), lddv, s, heads, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v: [b, s, heads * head_dim] bf16 views (unit column stride, row
// strides ldq / ldk / ldv, multiples of 8, batch stride s * ld, 16-byte
// aligned; head_dim 64 or 72); g, o: [b, s, heads * head_dim] bf16
// contiguous; o_lo: like o or null (the forward's residual, read at head_dim
// 72); m, r: [b, s, heads] f32 from
// the forward; pad [b, s] f32 or null; seg [b, s] int32 or null; delta:
// [b, s, heads] f32 scratch; dq, dk, dv: bf16 views like q, k, v with row
// strides lddq / lddk / lddv. Launches the dq kernel (which writes delta),
// then the dk/dv kernel.
extern "C" int dclip_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                        int ldq, int ldk, int ldv, const void* g,
                                        const void* o, const void* o_lo, const void* m,
                                        const void* r,
                                        const void* pad, const void* seg, void* delta,
                                        void* dq, void* dk, void* dv, int lddq, int lddk,
                                        int lddv, int b, int s, int heads, int head_dim,
                                        int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool masked = causal || pad != nullptr || seg != nullptr;
#define DCLIP_HEAD(hd)                                                                         \
  return masked ? launch<hd, true>(q, k, v, ldq, ldk, ldv, g, o, lo, m, r, pad, seg, delta, dq,  \
                                   dk, dv, lddq, lddk, lddv, b, s, heads, causal, st)          \
                : launch<hd, false>(q, k, v, ldq, ldk, ldv, g, o, lo, m, r, pad, seg, delta, dq, \
                                    dk, dv, lddq, lddk, lddv, b, s, heads, causal, st)
  const void* lo = nullptr;
  if (head_dim == 64) DCLIP_HEAD(64);
  lo = o_lo;
  if (head_dim == 72) DCLIP_HEAD(72);
#undef DCLIP_HEAD
  return static_cast<int>(cudaErrorInvalidValue);
}
