// Multi-head self-attention backward, head_dim 64 or 72, from the forward's
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
//   two kernels with no atomics (7 products per tile pair against 5 for
//   one kernel, but every sum has one owner and a fixed order, so two runs
//   give the same bits, and dQ stays in registers where one kernel would
//   need an f32 dQ in device memory, 0.8 GB at SigLIP's vision shape):
//   - dq: 128 query rows of one (batch row, head) walk the key tiles; the
//     kernel also computes delta for its rows and writes it;
//   - dkdv: 128 keys walk the query tiles, reading delta.
//   No [S, S] tensor and no other scratch that grows with B x S x D
//   reaches device memory.
// Bound on the H100: at S = 197 / 77 the work per head is small (~10 flops
//   per byte moved) and the kernels are bound by latency; at SigLIP's S =
//   729 (12 tiles of 64 a row) by the chain of each warpgroup's products
//   and, beside them, the exponentials and the forming of dS on the CUDA
//   cores. Clock counters in the kernel (NVIDIA H100 SXM) put a chain of
//   m64n64k16 products of one warpgroup at ~110 cycles a product, ~90 for
//   an m64n72k16 with A from registers, and a product that switches
//   accumulator, or an m64n8 one, at ~50 whatever its width: so the design
//   below issues few, wide products, each accumulator's in one run, and
//   keeps a second warpgroup's chain beside each one.
//
// Head_dim 72 (SigLIP; both kernels of the warp-specialised pipeline):
//   Tiles: a [64 rows][72 columns] head slice is five [64][16] atoms in
//   the 32-byte swizzle (2 KB each; the fifth holds columns 64-71 and
//   TMA's zeros past the head), 10 KB where two 128-byte-swizzled atoms
//   took 16. A product over head_dim (S, dP and their transposes) takes
//   atom kk as its k16 step kk; a product into head_dim (dQ, dK, dV) reads
//   the five atoms side by side (MN-major, LBO 2 KB) as one m64n72k16.
//   Block: persistent, one 384-thread block per SM walking the work items
//   blockIdx.x, + gridDim.x, ... (the row blocks of one head adjacent, so
//   the blocks running at one time read the same K / V or Q / g from L2).
//   A producer warpgroup drops to 40 registers (setmaxnreg); its first
//   warp loads every tile by TMA (cp.async.bulk.tensor on 4-D maps of
//   (column, head, row, batch row): rows past S and columns past the head
//   arrive as zeros) onto mbarriers, and the streamed rows' 4-byte stats
//   by cp.async onto the same mbarriers (cp.async.mbarrier.arrive): the
//   item's resident tiles (dq: Q and g of its 128 rows; dkdv: K and V),
//   double-buffered so that the next item's arrive while this one runs,
//   and a ring of 4 slots of streamed tiles (dq: K and V with the keys' pad
//   and segment ids; dkdv: Q and g with their rows' m, rinv, delta and
//   segment ids) that runs on across items. Two consumer warpgroups at 232
//   registers own 64 rows each and issue no copies; dq holds Q and g as
//   register A fragments for the item. Per tile a consumer issues one
//   burst of wgmma, the products that finish the previous tile (each
//   accumulator in one run) and those that start this one, then forms this
//   tile's dS in registers while the other consumer's burst runs: the two
//   take turns at the tensor cores by named barriers (one issues its burst
//   once the other has issued its own). A slot goes back to the producer
//   when both consumers' bursts that read it are done (8 warp arrivals on
//   its "empty" mbarrier). A row block's accumulators go to device memory
//   after a last burst that finishes its last tile.
//   - dq: burst j = dQ += dS_{j-1} K_{j-1} (register A, K MN-major) and
//     S_j = Q K_j^T, dP_j = g V_j^T (A from registers); then dS_j = e ((dP
//     - delta) rinv) with the masks, split into two bf16 parts.
//   - dkdv: burst j = dV += (P^T rinv)_{j-1} g_{j-1}, dK += dS^T_{j-1}
//     Q_{j-1} (register A; g, Q MN-major) and S^T_j = K Q_j^T, dP^T_j = V
//     g_j^T (both from shared memory); then P^T = exp2(S^T c - m) in f32,
//     bf16(P^T rinv) for dV, and dS^T = P^T ((dP^T - delta) rinv) from the
//     f32 P^T, split into two bf16 parts.
//   Registers: dq ~200 a consumer thread (dQ 36, S and dP 64, the previous
//   tile's dS and its low part 32, Q and g 40), dkdv ~230 (dK and dV 72,
//   S^T and dP^T 64, the previous tile's P^T rinv, dS^T and its low part
//   48); shared memory ~167 KB, one block an SM. Still two kernels, for
//   determinism and dQ in registers, as above. At [256, 729, 16 x 72] the
//   pair takes ~11 ms, 14% of its bound (NVIDIA H100 80GB HBM3). Not done,
//   as each read slower: the accumulators' products interleaved (every
//   product then switches accumulator), a second dS buffer in dq so that
//   its products overlap the next dS, and the next item's delta inputs
//   loaded before the store (both spill at 232 registers).
//   Numerics: dS enters dQ = dS K and dK = dS^T Q as two bf16 parts, hi =
//   bf16(dS) and lo = bf16(dS - hi), one product each (~16 bits of dS),
//   and the dk/dv kernel forms dS^T from the f32 P^T. SigLIP's deep
//   unmasked towers at their initial weights carry keys and queries close
//   to one common vector: dQ_i = sum_j dS_ij k_j cancels it exactly because
//   each row of dS sums to zero, and a dS rounded to bf16 alone leaves that
//   vector times its rows' rounding error, larger than the true dQ (and the
//   same for the key projection's gradient). For the same reason delta =
//   rowsum(g (o + o_lo)) takes the forward's residual o_lo beside o
//   (csrc/attention.cu): with values close to their mean, dP - delta is a
//   small difference, and a delta from the bf16 o alone was the larger
//   error of the two (an emulation at 0.1 of the values' spread: 1.2x the
//   true dQ, against 0.015 from dS's rounding). dV takes bf16(P^T rinv)
//   against g where the TPU takes bf16(P^T) against bf16(g rinv): one
//   rounding where there were two. The exponent is exp2 of one fma, by
//   ex2.approx.ftz (results below 2^-126 are 0).
//
// Head_dim 64 (CLIP): the cells' rows are short (S = 77-257, at most five
//   tiles a row block), where a row block's start and end weigh most; the
//   pipeline above read 1.3-1.4x these kernels' times there, so head_dim 64
//   keeps the design before it (namespace hd64, at the end of the file).
#include <math.h>

#include <type_traits>

#include "common.cuh"
#include "sm90.cuh"

namespace {

namespace sm = dclip::sm90;

constexpr int kTile = 64;                         // rows per consumer, columns per tile
constexpr int kConsumers = 2;                     // consumer warpgroups
constexpr int kItemRows = kConsumers * kTile;     // rows of a work item
constexpr int kThreads = (kConsumers + 1) * 128;  // the consumers, then the producer warpgroup
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
// 168 a thread at launch (65,536 / 384, rounded down to 8): the producer
// gives back 128 x (168 - 40), the consumers take 256 x (232 - 168).
static_assert(128 * kProducerRegs + kConsumers * 128 * kConsumerRegs <= 65536, "register file");
constexpr int kRing = 4;                          // slots of streamed tiles
constexpr int kNarrow = 16;                       // width of the ragged last tile's products
constexpr int kAtomBytes = kTile * 16 * 2;        // [64 rows][16 columns] bf16, 32-byte swizzle

// A tile's 16-column atoms (the fifth holds columns 64-71 and TMA's zeros
// past the head), which are also the k16 steps of a product over head_dim;
// the accumulator of a product into head_dim (m64n72); the scale (and with
// log2(e)).
constexpr int kHd = 72;
constexpr int kAtoms = 5;
constexpr int kTileBytes = kAtoms * kAtomBytes;
constexpr int kAcc = kHd / 2;
constexpr float kScale = 0.11785113019775793f;
constexpr float kScaleLog2 = kScale * 1.4426950408889634f;

// A block's shared memory: the resident tiles of two work items (two
// tensors of kConsumers tiles each), the ring (two tiles a slot), kStats
// 4-byte values per streamed row and slot, then the mbarriers: full and
// empty per slot, res_full and res_empty per resident buffer.
template <int kStats>
struct Layout {
  static constexpr int kResBytes = 2 * kConsumers * kTileBytes;
  static constexpr int kSlotBytes = 2 * kTileBytes;
  static constexpr int kRingAt = 2 * kResBytes;
  static constexpr int kStatsAt = kRingAt + kRing * kSlotBytes;
  static constexpr int kBarsAt = kStatsAt + kRing * kStats * kTile * 4;
  static constexpr int kBytes = kBarsAt + (2 * kRing + 4) * 8 + 1024;  // + the base's alignment
};

// Head slices of q, k, v, g as 4-D tensors (column in the head, head, row,
// batch row), read in [64 rows][16 columns] boxes in the 32-byte swizzle.
struct Maps {
  CUtensorMap q, k, v, g;
};

// Tile rows [row, row + 64) of head h of batch row b, atom by atom, onto
// `bar`.
__device__ __forceinline__ void load_tile(unsigned char* dst, const CUtensorMap* map,
                                          uint64_t* bar, int h, int row, int b) {
#pragma unroll
  for (int a = 0; a < kAtoms; ++a)
    sm::tma_load_4d(dst + a * kAtomBytes, map, bar, 16 * a, h, row, b);
}

// 4 bytes global -> shared through cp.async; zero-filled when `pred` is false.
__device__ __forceinline__ void cp_async_4(void* smem, const void* gmem, bool pred) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(pred ? 4 : 0)
               : "memory");
}

// (lo, hi) as a bf16 pair, lo in the low half: one cvt.rn.bf16x2.f32.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The split of a pair: hi = bf16(x), and lo = bf16(x - hi), what hi drops.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - hf.x, b - hf.y);
}

// exp2(x) on the special-function unit alone (ex2.approx.ftz): what exp2f
// computes, save that results below 2^-126 flush to 0 (exp2f's range check
// keeps them, at three more instructions an element).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A tile as the K-major operand of a product over head_dim: k16 step kk is
// atom kk.
__device__ __forceinline__ uint64_t k_major(const unsigned char* tile) {
  return sm::desc_sw32(tile, 16, 256);
}

// A tile as the MN-major operand of a product over its rows (keys or
// queries) into head_dim: the atoms side by side (LBO), one k16 step 16
// rows (+512 bytes).
__device__ __forceinline__ uint64_t mn_major(const unsigned char* tile) {
  return sm::desc_sw32(tile, kAtomBytes, 256);
}

// D[64 x N] = A B^T over head_dim, both operands K-major from shared
// memory; N = 64 or the narrow 16.
template <int N>
__device__ __forceinline__ void mma_over_head(float (&d)[N / 2], uint64_t a, uint64_t b) {
#pragma unroll
  for (int kk = 0; kk < kAtoms; ++kk) {
    if constexpr (N == kTile)
      sm::wgmma_m64n64k16_ss<0, 0>(d, sm::desc_add(a, kk * kAtomBytes),
                                   sm::desc_add(b, kk * kAtomBytes), kk > 0);
    else
      sm::wgmma_m64n16k16_ss<0, 0>(d, sm::desc_add(a, kk * kAtomBytes),
                                   sm::desc_add(b, kk * kAtomBytes), kk > 0);
  }
}

// The same with A from registers: `a` holds this thread's k16 fragments of
// A, atom by atom (load_frags).
template <int N>
__device__ __forceinline__ void mma_over_head(float (&d)[N / 2], const uint32_t* a, uint64_t b) {
#pragma unroll
  for (int kk = 0; kk < kAtoms; ++kk) {
    if constexpr (N == kTile)
      sm::wgmma_m64n64k16_rs<0>(d, a + 4 * kk, sm::desc_add(b, kk * kAtomBytes), kk > 0);
    else
      sm::wgmma_m64n16k16_rs<0>(d, a + 4 * kk, sm::desc_add(b, kk * kAtomBytes), kk > 0);
  }
}

// This thread's k16 fragments of a warpgroup's [64 rows] tile as the
// register A operand of a product over head_dim: per atom, rows warp * 16 +
// lane / 4 and + 8, columns 2 (lane % 4) + {0, 1} and + 8 (the order of
// `frag`), read through the 32-byte swizzle (16-byte chunk c of row r at
// chunk c ^ ((r / 4) % 2)).
__device__ __forceinline__ void load_frags(uint32_t (&f)[kAtoms * 4], const unsigned char* tile) {
  const int lane = threadIdx.x & 31, row = (threadIdx.x / 32) % 4 * 16 + (lane >> 2);
#pragma unroll
  for (int a = 0; a < kAtoms; ++a)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row + (e & 1) * 8, chunk = (e >> 1) ^ ((r >> 2) & 1);
      f[4 * a + e] = *reinterpret_cast<const uint32_t*>(tile + a * kAtomBytes + r * 32 +
                                                        chunk * 16 + (lane & 3) * 4);
    }
}

// acc += A B over the N rows of a tile, one wgmma of the whole head a k16
// step: A [64 x N] bf16 from registers in k16 fragments (with kSplit also
// its low part a_lo, a second product), B MN-major.
template <int N, bool kSplit>
__device__ __forceinline__ void mma_into_head(float (&acc)[kAcc], const uint32_t* a,
                                              const uint32_t* a_lo, uint64_t b) {
#pragma unroll
  for (int kk = 0; kk < (kSplit ? 2 : 1) * N / 16; ++kk) {
    const uint32_t* frag = kk < N / 16 ? a + 4 * kk : a_lo + 4 * (kk - N / 16);
    sm::wgmma_m64n72k16_rs<1>(acc, frag, sm::desc_add(b, (kk % (N / 16)) * 512), 1);
  }
}

// Register index of accumulator pair i (columns 8 (i / 4) + 2 (lane % 4)
// + {0, 1} of row lo (i & 2 == 0) or hi) in the register A fragments of
// the k16 steps (see attention.cu).
__device__ __forceinline__ constexpr int frag(int i) {
  return 4 * (i / 8) + 2 * ((i / 4) & 1) + ((i & 2) ? 1 : 0);
}

// acc * scale as bf16, rows `row_lo` / `row_hi` (< s only) of a head slice
// with row stride ld, 16 bytes at a time; head_dim 72's columns 64-71 (the
// accumulator's ninth 8-column group), one bf16 pair a lane.
template <int kN>
__device__ __forceinline__ void store_rows(const float (&acc)[kN], float scale,
                                           __nv_bfloat16* __restrict__ dst, int ld, int row_lo,
                                           int row_hi, int s) {
  const int lane = threadIdx.x & 31;
  if constexpr (kN == 36) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = half ? row_hi : row_lo;
      if (row < s)
        *reinterpret_cast<__nv_bfloat162*>(dst + static_cast<size_t>(row) * ld + 64 +
                                           2 * (lane & 3)) =
            __floats2bfloat162_rn(acc[32 + 2 * half] * scale, acc[33 + 2 * half] * scale);
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

using Narrow = std::integral_constant<int, kNarrow>;
using Full = std::integral_constant<int, kTile>;

// A work item: row block rb (kItemRows rows) of head h of batch row b,
// the row blocks of one head adjacent.
struct Item {
  int rb, h, b;
};

__device__ __forceinline__ Item item_at(int item, int blocks_per_head, int heads) {
  return {item % blocks_per_head, (item / blocks_per_head) % heads,
          item / (blocks_per_head * heads)};
}

// The two consumers' turns at the tensor cores (named barriers 1 and 2,
// both consumer warpgroups): consumer 0 issues a burst once consumer 1 has
// issued its previous one, consumer 1 once consumer 0 has issued the same
// one. `first` / `last`: the warpgroup's first / last burst of the launch.
__device__ __forceinline__ void wait_turn(int wg, bool first) {
  if (wg == 0) {
    if (!first) sm::named_sync(1, 2 * 128);
  } else {
    sm::named_sync(2, 2 * 128);
  }
}

__device__ __forceinline__ void pass_turn(int wg, bool last) {
  if (wg == 0)
    sm::named_arrive(2, 2 * 128);
  else if (!last)
    sm::named_arrive(1, 2 * 128);
}

// Barriers at `bars`: full[kRing], empty[kRing], res_full[2], res_empty[2].
__device__ __forceinline__ void init_barriers(uint64_t* bars, int full_count) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < kRing; ++i) {
      sm::mbar_init(&bars[i], full_count);
      sm::mbar_init(&bars[kRing + i], kConsumers * 4);  // one arrival per consumer warp
    }
    for (int i = 0; i < 2; ++i) {
      sm::mbar_init(&bars[2 * kRing + i], 1);
      sm::mbar_init(&bars[2 * kRing + 2 + i], kConsumers * 4);
    }
    sm::fence_barrier_init();
  }
  __syncthreads();
}

// The producer's first warp: per item, the resident tiles of `res_a` /
// `res_b` (the item's rows) into buffer it % 2, then the item's streamed
// tiles of `ring_a` / `ring_b` into the ring; `stats(slot, t, b, lane)`
// issues the slot's cp.async stats (`kStats`: then every lane arrives on
// the slot's full barrier once its copies land).
template <int kStats, typename Stats>
__device__ __forceinline__ void produce(unsigned char* smem, uint64_t* bars,
                                        const CUtensorMap* res_a, const CUtensorMap* res_b,
                                        const CUtensorMap* ring_a, const CUtensorMap* ring_b,
                                        int items, int s, int heads, Stats stats) {
  using L = Layout<kStats>;
  constexpr int T = kTileBytes;
  uint64_t* full = bars;
  uint64_t* empty = bars + kRing;
  uint64_t* res_full = bars + 2 * kRing;
  uint64_t* res_empty = res_full + 2;
  const int lane = threadIdx.x & 31;
  const int tiles = (s + kTile - 1) / kTile, per_head = (s + kItemRows - 1) / kItemRows;
  if (lane == 0) {
    sm::prefetch_tensormap(res_a);
    sm::prefetch_tensormap(res_b);
    sm::prefetch_tensormap(ring_a);
    sm::prefetch_tensormap(ring_b);
  }
  int pos = 0;
  for (int item = blockIdx.x, it = 0; item < items; item += gridDim.x, ++it) {
    const Item w = item_at(item, per_head, heads);
    const int r0 = w.rb * kItemRows, buf = it & 1;
    sm::mbar_wait(&res_empty[buf], ((it >> 1) & 1) ^ 1);
    if (lane == 0) {
      const int live = r0 + kTile < s ? 2 : 1;  // consumers with a row < s
      unsigned char* res = smem + buf * L::kResBytes;
      sm::mbar_expect_tx(&res_full[buf], 2 * live * T);
      for (int c = 0; c < live; ++c) {
        load_tile(res + c * T, res_a, &res_full[buf], w.h, r0 + c * kTile, w.b);
        load_tile(res + (kConsumers + c) * T, res_b, &res_full[buf], w.h, r0 + c * kTile,
                       w.b);
      }
    }
    for (int t = 0; t < tiles; ++t, ++pos) {
      const int slot = pos % kRing;
      sm::mbar_wait(&empty[slot], ((pos / kRing) & 1) ^ 1);
      if (lane == 0) {
        unsigned char* dst = smem + L::kRingAt + slot * L::kSlotBytes;
        sm::mbar_expect_tx(&full[slot], 2 * T);
        load_tile(dst, ring_a, &full[slot], w.h, t * kTile, w.b);
        load_tile(dst + T, ring_b, &full[slot], w.h, t * kTile, w.b);
      }
      if constexpr (kStats > 0) {
        stats(slot, t, w, lane);
        sm::cp_async_mbar_arrive_noinc(&full[slot]);
      }
    }
  }
}

// kMasked: any of causal, pad, seg is given.
template <bool kMasked>
__global__ void __launch_bounds__(kThreads, 1)
    attention_bwd_dq_kernel(const __grid_constant__ Maps maps,
                            const __nv_bfloat16* __restrict__ g,
                            const __nv_bfloat16* __restrict__ o,
                            const __nv_bfloat16* __restrict__ o_lo,
                            const float* __restrict__ m, const float* __restrict__ r,
                            const float* __restrict__ pad, const int* __restrict__ seg,
                            float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int lddq,
                            int batch, int s, int heads, int causal) {
  constexpr int kStats = kMasked ? 2 : 0;  // per key: pad, segment id
  using L = Layout<kStats>;
  constexpr int T = kTileBytes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = sm::align1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBarsAt);
  float* kpad = reinterpret_cast<float*>(smem + L::kStatsAt);  // [kRing][64]
  int* kseg = reinterpret_cast<int*>(kpad + kRing * kTile);     // [kRing][64]
  const int tiles = (s + kTile - 1) / kTile, per_head = (s + kItemRows - 1) / kItemRows;
  const int items = per_head * heads * batch;
  const int d = heads * kHd;
  init_barriers(bars, 1 + (kMasked ? 32 : 0));
  const int wg = threadIdx.x / 128;

  if (wg == kConsumers) {
    sm::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x / 32 == kConsumers * 4) {
      produce<kStats>(
          smem, bars, &maps.q, &maps.g, &maps.k, &maps.v, items, s, heads,
          [&](int slot, int t, Item w, int lane) {
            const size_t rows0 = static_cast<size_t>(w.b) * s;
#pragma unroll
            for (int j = lane; j < kTile; j += 32) {
              const int key = t * kTile + j;
              const bool ok = key < s;
              const size_t at = rows0 + (ok ? key : 0);
              if (pad != nullptr) cp_async_4(kpad + slot * kTile + j, pad + at, ok);
              if (seg != nullptr) cp_async_4(kseg + slot * kTile + j, seg + at, ok);
            }
          });
    }
  } else {
    sm::setmaxnreg_inc<kConsumerRegs>();
    uint64_t* full = bars;
    uint64_t* empty = bars + kRing;
    uint64_t* res_full = bars + 2 * kRing;
    uint64_t* res_empty = res_full + 2;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x & 31;
    const int lr = wg * kTile + warp * 16 + (lane >> 2);  // this thread's rows lr, lr + 8
    const int col = 2 * (lane & 3);  // and its key columns 2 (lane % 4) + {0, 1} of each 8
    bool first = true;
    uint32_t ds[kTile / 4], ds_lo[kTile / 4];  // the previous tile's dS
    int pos = 0;  // ring position of the item's first tile
    for (int item = blockIdx.x, it = 0; item < items; item += gridDim.x, ++it) {
      const Item w = item_at(item, per_head, heads);
      const int r0 = w.rb * kItemRows, buf = it & 1, h = w.h;
      const size_t rows0 = static_cast<size_t>(w.b) * s;
      const int row_lo = r0 + lr, row_hi = row_lo + 8;
      const bool live = r0 + wg * kTile < s;  // the warpgroup has a row < s
      const bool last_item = item + static_cast<int>(gridDim.x) >= items;

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
      // delta = rowsum(g (o + o_lo)) of the two rows: the four lanes that
      // share them take the rows' 8-column chunks in turn, every load issued
      // before the first is used.
      float dl[2];
      {
        constexpr int kChunks = (kHd / 8 + 3) / 4;  // a lane's chunks of a row
        const size_t head0 = rows0 * d + h * kHd;
        const uint4 zero = make_uint4(0, 0, 0, 0);
        uint4 gv[2][kChunks], ov[2][kChunks], lv[2][kChunks];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = half ? row_hi : row_lo;
          const size_t at = head0 + static_cast<size_t>(row < s ? row : 0) * d;
#pragma unroll
          for (int i = 0; i < kChunks; ++i) {
            const int c = (lane & 3) + 4 * i;
            const bool ok = row < s && c < kHd / 8;
            gv[half][i] = ok ? *reinterpret_cast<const uint4*>(g + at + c * 8) : zero;
            ov[half][i] = ok ? *reinterpret_cast<const uint4*>(o + at + c * 8) : zero;
            lv[half][i] = ok && o_lo != nullptr
                              ? *reinterpret_cast<const uint4*>(o_lo + at + c * 8) : zero;
          }
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float sum = 0.f;
#pragma unroll
          for (int i = 0; i < kChunks; ++i) {
            float fg[8], fo[8], fl[8];
            dclip::unpack8(gv[half][i], fg);
            dclip::unpack8(ov[half][i], fo);
            dclip::unpack8(lv[half][i], fl);
#pragma unroll
            for (int e = 0; e < 8; ++e) sum += fg[e] * (fo[e] + fl[e]);
          }
          sum += __shfl_xor_sync(dclip::kFullMask, sum, 1);
          sum += __shfl_xor_sync(dclip::kFullMask, sum, 2);
          dl[half] = sum;
          const int row = half ? row_hi : row_lo;
          if ((lane & 3) == 0 && row < s) delta[(rows0 + row) * heads + h] = sum;
        }
      }

      float acc[kAcc];
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
      sm::mbar_wait(&res_full[buf], (it >> 1) & 1);
      const unsigned char* res = smem + buf * L::kResBytes;
      // Q and g, the A operands of S and dP, in registers for the item.
      uint32_t qa[kAtoms * 4], ga[kAtoms * 4];
      load_frags(qa, res + wg * T);
      load_frags(ga, res + (kConsumers + wg) * T);

      // Burst j: dQ += dS_{j-1} K_{j-1} (width NC) and S_j, dP_j (width NA);
      // then dS_j into ds / ds_lo.
      auto burst = [&](auto wc, auto wa, bool do_c, bool do_a, int j) {
        constexpr int NC = decltype(wc)::value, NA = decltype(wa)::value;
        const int slot = (pos + j) % kRing, pslot = (pos + j + kRing - 1) % kRing;
        const unsigned char* cur = smem + L::kRingAt + slot * L::kSlotBytes;
        const unsigned char* prev = smem + L::kRingAt + pslot * L::kSlotBytes;
        if (do_a) sm::mbar_wait(&full[slot], ((pos + j) / kRing) & 1);
        wait_turn(wg, first);
        first = false;
        float sacc[NA / 2], dpacc[NA / 2];
        if (live) {
          sm::fence_regs(acc);
          sm::fence_regs(ds);
          sm::fence_regs(ds_lo);
          sm::fence_regs(qa);
          sm::fence_regs(ga);
          sm::wgmma_fence();
          if (do_c) mma_into_head<NC, true>(acc, ds, ds_lo, mn_major(prev));
          if (do_a) {
            mma_over_head<NA>(sacc, qa, k_major(cur));
            mma_over_head<NA>(dpacc, ga, k_major(cur + T));
          }
          sm::wgmma_commit();
        }
        pass_turn(wg, last_item && j == tiles);
        if (live) {
          sm::wgmma_wait<0>();
          sm::fence_regs(acc);
          sm::fence_regs(sacc);
          sm::fence_regs(dpacc);
        }
        if (do_c && lane == 0) sm::mbar_arrive(&empty[pslot]);
        if (do_a && j == tiles - 1 && lane == 0) sm::mbar_arrive(&res_empty[buf]);
        if (!do_a || !live) return;

        // dS = e ((dP - delta) rinv), masked; sacc[4 g + e] is key
        // 8 g + col + (e & 1) of row_lo (e < 2) or row_hi. Only the last
        // tile of a row has keys past S.
        const int k0 = j * kTile;
        const float* tpad = kpad + slot * kTile;
        const int* tseg = kseg + slot * kTile;
        auto form = [&](auto ragged) {
#pragma unroll
          for (int i = 0; i < NA / 2; i += 2) {
            const bool hi = (i & 2) != 0;
            float dsv[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int kl = 8 * (i / 4) + col + e, key = k0 + kl;
              bool keep = true;
              if (kMasked)
                keep = (!causal || key <= (hi ? row_hi : row_lo)) &&
                       (seg == nullptr || tseg[kl] == (hi ? seg_hi : seg_lo)) &&
                       (pad == nullptr || tpad[kl] > 0.f);
              const float mr = hi ? m_hi : m_lo;
              float p = exp2_ftz(keep ? fmaf(sacc[i + e], kScaleLog2, -mr) : dclip::kNegBig - mr);
              if (decltype(ragged)::value && key >= s) p = 0.f;
              dsv[e] = p * ((dpacc[i + e] - dl[hi ? 1 : 0]) * (hi ? r_hi : r_lo));
            }
            split_bf16(dsv[0], dsv[1], ds[frag(i)], ds_lo[frag(i)]);
          }
        };
        if (k0 + kTile > s)
          form(std::true_type{});
        else
          form(std::false_type{});
      };
      for (int j = 0; j <= tiles; ++j) {
        const bool do_a = j < tiles, do_c = j > 0;
        if (do_c && s - (j - 1) * kTile <= kNarrow)
          burst(Narrow{}, Full{}, true, false, j);
        else if (do_a && s - j * kTile <= kNarrow)
          burst(Full{}, Narrow{}, do_c, true, j);
        else
          burst(Full{}, Full{}, do_c, do_a, j);
      }
      store_rows(acc, kScale, dq + rows0 * lddq + h * kHd, lddq, row_lo, row_hi, s);
      pos += tiles;
    }
  }
}

template <bool kMasked>
__global__ void __launch_bounds__(kThreads, 1)
    attention_bwd_dkdv_kernel(const __grid_constant__ Maps maps, const float* __restrict__ m,
                              const float* __restrict__ r, const float* __restrict__ delta,
                              const float* __restrict__ pad, const int* __restrict__ seg,
                              __nv_bfloat16* __restrict__ dk, int lddk,
                              __nv_bfloat16* __restrict__ dv, int lddv, int batch, int s,
                              int heads, int causal) {
  constexpr int kStats = 4;  // per query: m, rinv, delta, segment id
  using L = Layout<kStats>;
  constexpr int T = kTileBytes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = sm::align1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBarsAt);
  float* qm = reinterpret_cast<float*>(smem + L::kStatsAt);  // [kRing][64] each
  float* qr = qm + kRing * kTile;
  float* qd = qr + kRing * kTile;
  int* qs = reinterpret_cast<int*>(qd + kRing * kTile);
  const int tiles = (s + kTile - 1) / kTile, per_head = (s + kItemRows - 1) / kItemRows;
  const int items = per_head * heads * batch;
  init_barriers(bars, 1 + 32);
  const int wg = threadIdx.x / 128;

  if (wg == kConsumers) {
    sm::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x / 32 == kConsumers * 4) {
      produce<kStats>(
          smem, bars, &maps.k, &maps.v, &maps.q, &maps.g, items, s, heads,
          [&](int slot, int t, Item w, int lane) {
            const size_t rows0 = static_cast<size_t>(w.b) * s;
#pragma unroll
            for (int j = lane; j < kTile; j += 32) {
              const int qi = t * kTile + j;
              const bool ok = qi < s;
              const size_t row = rows0 + (ok ? qi : 0), at = row * heads + w.h;
              const int to = slot * kTile + j;
              cp_async_4(qm + to, m + at, ok);
              cp_async_4(qr + to, r + at, ok);
              cp_async_4(qd + to, delta + at, ok);
              if (kMasked && seg != nullptr) cp_async_4(qs + to, seg + row, ok);
            }
          });
    }
  } else {
    sm::setmaxnreg_inc<kConsumerRegs>();
    uint64_t* full = bars;
    uint64_t* empty = bars + kRing;
    uint64_t* res_full = bars + 2 * kRing;
    uint64_t* res_empty = res_full + 2;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x & 31;
    const int lr = wg * kTile + warp * 16 + (lane >> 2);  // this thread's keys lr, lr + 8
    const int col = 2 * (lane & 3);  // and its query columns 2 (lane % 4) + {0, 1} of each 8
    bool first = true;
    // The previous tile's bf16 (P^T rinv) and dS^T (with its low part).
    uint32_t p[kTile / 4], ds[kTile / 4], ds_lo[kTile / 4];
    int pos = 0;
    for (int item = blockIdx.x, it = 0; item < items; item += gridDim.x, ++it) {
      const Item w = item_at(item, per_head, heads);
      const int r0 = w.rb * kItemRows, buf = it & 1, h = w.h;
      const size_t rows0 = static_cast<size_t>(w.b) * s;
      const int key_lo = r0 + lr, key_hi = key_lo + 8;
      const bool live = r0 + wg * kTile < s;  // the warpgroup has a key < s
      const bool last_item = item + static_cast<int>(gridDim.x) >= items;
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

      float dk_acc[kAcc], dv_acc[kAcc];
#pragma unroll
      for (int i = 0; i < kAcc; ++i) dk_acc[i] = dv_acc[i] = 0.f;
      sm::mbar_wait(&res_full[buf], (it >> 1) & 1);
      const unsigned char* res = smem + buf * L::kResBytes;
      const uint64_t ka = k_major(res + wg * T), va = k_major(res + (kConsumers + wg) * T);

      // Burst j: dV += (P^T rinv)_{j-1} g_{j-1}, dK += dS^T_{j-1} Q_{j-1}
      // (width NC) and S^T_j, dP^T_j (width NA); then P^T rinv and dS^T of
      // tile j into p / ds / ds_lo.
      auto burst = [&](auto wc, auto wa, bool do_c, bool do_a, int j) {
        constexpr int NC = decltype(wc)::value, NA = decltype(wa)::value;
        const int slot = (pos + j) % kRing, pslot = (pos + j + kRing - 1) % kRing;
        const unsigned char* cur = smem + L::kRingAt + slot * L::kSlotBytes;
        const unsigned char* prev = smem + L::kRingAt + pslot * L::kSlotBytes;
        if (do_a) sm::mbar_wait(&full[slot], ((pos + j) / kRing) & 1);
        wait_turn(wg, first);
        first = false;
        float sacc[NA / 2], dpacc[NA / 2];
        if (live) {
          sm::fence_regs(dk_acc);
          sm::fence_regs(dv_acc);
          sm::fence_regs(p);
          sm::fence_regs(ds);
          sm::fence_regs(ds_lo);
          sm::wgmma_fence();
          if (do_c) {
            mma_into_head<NC, false>(dv_acc, p, nullptr, mn_major(prev + T));
            mma_into_head<NC, true>(dk_acc, ds, ds_lo, mn_major(prev));
          }
          if (do_a) {
            mma_over_head<NA>(sacc, ka, k_major(cur));
            mma_over_head<NA>(dpacc, va, k_major(cur + T));
          }
          sm::wgmma_commit();
        }
        pass_turn(wg, last_item && j == tiles);
        if (live) {
          sm::wgmma_wait<0>();
          sm::fence_regs(dk_acc);
          sm::fence_regs(dv_acc);
          sm::fence_regs(sacc);
          sm::fence_regs(dpacc);
        }
        if (do_c && lane == 0) sm::mbar_arrive(&empty[pslot]);
        if (do_a && j == tiles - 1 && lane == 0) sm::mbar_arrive(&res_empty[buf]);
        if (!do_a || !live) return;

        // P^T = exp2(mask(S^T c) - m) in f32; sacc[4 g + e] is query
        // 8 g + col + (e & 1) of key_lo (e < 2) or key_hi. dV takes
        // bf16(P^T rinv); dS^T = P^T ((dP^T - delta) rinv) in bf16 (head_dim
        // 72: and its low part).
        const int q0 = j * kTile;
        const float* tm = qm + slot * kTile;
        const float* tr = qr + slot * kTile;
        const float* td = qd + slot * kTile;
        const int* ts = qs + slot * kTile;
#pragma unroll
        for (int i = 0; i < NA / 2; i += 2) {
          const bool hi = (i & 2) != 0;
          const int ql = 8 * (i / 4) + col;  // even: the pair's stats are 8-byte aligned
          const float2 m2 = *reinterpret_cast<const float2*>(tm + ql);
          const float2 r2 = *reinterpret_cast<const float2*>(tr + ql);
          const float2 d2 = *reinterpret_cast<const float2*>(td + ql);
          float pr[2], dsv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            bool keep = true;
            if (kMasked)
              keep = (!causal || (hi ? key_hi : key_lo) <= q0 + ql + e) &&
                     (seg == nullptr || ts[ql + e] == (hi ? ks_hi : ks_lo)) &&
                     (hi ? kp_hi : kp_lo) > 0.f;
            const float mq = e ? m2.y : m2.x, rr = e ? r2.y : r2.x;
            const float pv =
                exp2_ftz(keep ? fmaf(sacc[i + e], kScaleLog2, -mq) : dclip::kNegBig - mq);
            pr[e] = pv * rr;
            dsv[e] = pv * ((dpacc[i + e] - (e ? d2.y : d2.x)) * rr);
          }
          p[frag(i)] = pack_bf16(pr[0], pr[1]);
          split_bf16(dsv[0], dsv[1], ds[frag(i)], ds_lo[frag(i)]);
        }
      };
      for (int j = 0; j <= tiles; ++j) {
        const bool do_a = j < tiles, do_c = j > 0;
        if (do_c && s - (j - 1) * kTile <= kNarrow)
          burst(Narrow{}, Full{}, true, false, j);
        else if (do_a && s - j * kTile <= kNarrow)
          burst(Full{}, Narrow{}, do_c, true, j);
        else
          burst(Full{}, Full{}, do_c, do_a, j);
      }
      store_rows(dk_acc, kScale, dk + rows0 * lddk + h * kHd, lddk, key_lo, key_hi, s);
      store_rows(dv_acc, 1.f, dv + rows0 * lddv + h * kHd, lddv, key_lo, key_hi, s);
      pos += tiles;
    }
  }
}

// The head slices of a [b, s, heads * hd] bf16 view with row stride ld as
// a 4-D tensor (column in the head, head, row, batch row), read in boxes of
// 64 rows by 16 columns of one head in the 32-byte swizzle. Rows past s and
// columns past hd arrive as zeros.
bool encode_heads(CUtensorMap* map, const void* base, int ld, int b, int s, int heads, int hd) {
  sm::EncodeTiledFn fn = sm::encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(s), static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(hd) * 2, static_cast<cuuint64_t>(ld) * 2,
                                 static_cast<cuuint64_t>(s) * ld * 2};
  const cuuint32_t box[4] = {16, 1, kTile, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool kMasked>
int launch(const void* q, const void* k, const void* v, int ldq, int ldk, int ldv,
           const void* g, const void* o, const void* o_lo, const void* m, const void* r,
           const void* pad, const void* seg, void* delta, void* dq, void* dk, void* dv, int lddq,
           int lddk, int lddv, int b, int s, int heads, int causal, cudaStream_t st) {
  constexpr int kDqSmem = Layout<kMasked ? 2 : 0>::kBytes;
  constexpr int kDkvSmem = Layout<4>::kBytes;
  auto* dq_kernel = attention_bwd_dq_kernel<kMasked>;
  auto* dkdv_kernel = attention_bwd_dkdv_kernel<kMasked>;
  // Runtime calls first: they make the device's primary context current in
  // this host thread (autograd's backward worker may have made none), which
  // the driver's tensor-map encode needs.
  cudaError_t err =
      cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDkvSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  Maps maps = {};
  const int d = heads * kHd;
  const bool ok = encode_heads(&maps.q, q, ldq, b, s, heads, kHd) &&
                  encode_heads(&maps.k, k, ldk, b, s, heads, kHd) &&
                  encode_heads(&maps.v, v, ldv, b, s, heads, kHd) &&
                  encode_heads(&maps.g, g, d, b, s, heads, kHd);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const int items = (s + kItemRows - 1) / kItemRows * heads * b;
  const int grid = items < sms ? items : sms;
  using B16 = __nv_bfloat16;
  dq_kernel<<<grid, kThreads, kDqSmem, st>>>(
      maps, static_cast<const B16*>(g), static_cast<const B16*>(o),
      static_cast<const B16*>(o_lo), static_cast<const float*>(m), static_cast<const float*>(r),
      static_cast<const float*>(pad), static_cast<const int*>(seg), static_cast<float*>(delta),
      static_cast<B16*>(dq), lddq, b, s, heads, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv_kernel<<<grid, kThreads, kDkvSmem, st>>>(
      maps, static_cast<const float*>(m), static_cast<const float*>(r),
      static_cast<const float*>(delta), static_cast<const float*>(pad),
      static_cast<const int*>(seg), static_cast<B16*>(dk), lddk, static_cast<B16*>(dv), lddv, b,
      s, heads, causal);
  return static_cast<int>(cudaGetLastError());
}

// -- head_dim 64: two blocks an SM over a cp.async ring ---------------------------
//
// A block of two warpgroups (at most 128 registers a thread, ~100-110 KB
// of shared memory, two blocks an SM, so that one block's start and end
// overlap the other's products) owns 128 query rows (dq) or keys (dkdv) of
// one (batch row, head) and walks the other side's tiles through a ring of
// 4 slots filled by 16-byte cp.async stores in the 128-byte-swizzled
// layout wgmma reads (4-byte cp.async for the per-row stats): every tile of
// S <= 256 is requested before the first is used. dS^T in dk/dv is formed
// from the bf16 P^T, dV from bf16(g rinv) (GR, formed once per query tile
// in shared memory).
namespace hd64 {

constexpr int kHd = 64;
constexpr int kGroups = 2;                    // warpgroups per block
constexpr int kThreads = kGroups * 128;
constexpr int kBlocks = 2;                    // blocks an SM
constexpr int kRing = 4;
constexpr int kTileBytes = kTile * 64 * 2;    // one swizzled [64][64] bf16 tile, 8 KB
constexpr float kScale = 0.125f;
constexpr float kScaleLog2 = kScale * 1.4426950408889634f;
// dq: Q, g (two warpgroups) + the K, V ring, key pad / seg per slot and
// delta; dk/dv: K, V + the Q, g ring + GR, and m, rinv, delta, seg per slot.
constexpr int kDqSmem = (2 * kGroups + 2 * kRing) * kTileBytes + kRing * kTile * 8 +
                        kGroups * kTile * 4 + 1024;
constexpr int kDkvSmem = (2 * kGroups + 2 * kRing + 1) * kTileBytes + kRing * kTile * 16 + 1024;

// D[64 x N] (+)= A B over one k16 step, both operands K-major from shared
// memory; N = 64 or the narrow 16.
template <int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int acc) {
  if constexpr (N == kTile)
    sm::wgmma_m64n64k16_ss<0, 0>(d, a, b, acc);
  else
    sm::wgmma_m64n16k16_ss<0, 0>(d, a, b, acc);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return make_float2(__bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(v))),
                     __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(v >> 16))));
}

template <bool kMasked>
__global__ void __launch_bounds__(kThreads, kBlocks)
    attention_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v, int ldq, int ldk, int ldv,
                            const __nv_bfloat16* __restrict__ g,
                            const __nv_bfloat16* __restrict__ o,
                            const float* __restrict__ m, const float* __restrict__ r,
                            const float* __restrict__ pad, const int* __restrict__ seg,
                            float* __restrict__ delta, __nv_bfloat16* __restrict__ dq,
                            int lddq, int s, int heads, int causal) {
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
  sm::load_rows_async<kGroups * kTile, kThreads>(sq, qb, q0, s, ldq);
  sm::load_rows_async<kGroups * kTile, kThreads>(sg, gb, q0, s, d);
#pragma unroll
  for (int t = 0; t < kRing; ++t) load_kv(t);

  // delta = rowsum(g o) of the block's 128 rows: two threads a row.
  {
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

  float acc[32];
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
      for (int kk = 0; kk < 4; ++kk)
        mma_ss<N>(sacc, sm::desc_add(dqa, kk * 32), sm::desc_add(dk, kk * 32), kk > 0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_ss<N>(dpacc, sm::desc_add(dga, kk * 32), sm::desc_add(dv, kk * 32), kk > 0);
      sm::wgmma_commit();
      sm::wgmma_wait<0>();
      sm::fence_regs(sacc);
      sm::fence_regs(dpacc);

      // dS = e ((dP - delta) rinv), masked; sacc[4 g + e] is key
      // 8 g + col + (e & 1) of row_lo (e < 2) or row_hi.
      const float* tpad = kpad + slot * kTile;
      const int* tseg = kseg + slot * kTile;
      uint32_t ds[N / 4];
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
            const float l = keep ? sacc[i + e] * kScaleLog2 : dclip::kNegBig;
            p = exp2f(l - (hi ? m_hi : m_lo));
          }
          dsv[e] = p * ((dpacc[i + e] - (hi ? dl_hi : dl_lo)) * (hi ? r_hi : r_lo));
        }
        ds[frag(i)] = pack_bf16(dsv[0], dsv[1]);
      }

      // dQ += dS K, K MN-major.
      const uint64_t dkm = sm::desc_sw128(sk + slot * kTileBytes, kTileBytes, 1024);
      sm::fence_regs(ds);
      sm::fence_regs(acc);
      sm::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk)
        sm::wgmma_m64n64k16_rs<1>(acc, ds + 4 * kk, sm::desc_add(dkm, kk * 2048), 1);
      sm::wgmma_commit();
      sm::wgmma_wait<0>();
      sm::fence_regs(acc);
    };
    if (live) {
      if (s - k0 <= kNarrow) step(Narrow{}); else step(Full{});
    }
    if (j + kRing < tiles) __syncthreads();  // every warpgroup is done with the slot
    load_kv(j + kRing);
  }
  store_rows(acc, kScale, dq + rows0 * lddq + h * kHd, lddq, row_lo, row_hi, s);
}

template <bool kMasked>
__global__ void __launch_bounds__(kThreads, kBlocks)
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
  sm::load_rows_async<kGroups * kTile, kThreads>(sk, kb, k0, s, ldk);
  sm::load_rows_async<kGroups * kTile, kThreads>(sv, vb, k0, s, ldv);
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
#pragma unroll
  for (int i = 0; i < 32; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  const uint64_t dka = sm::desc_sw128(sk + wg * kTileBytes, 16, 1024);
  const uint64_t dva = sm::desc_sw128(sv + wg * kTileBytes, 16, 1024);
  const uint64_t grm = sm::desc_sw128(sgr, kTileBytes, 1024);

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
      for (int kk = 0; kk < 4; ++kk)
        mma_ss<N>(sacc, sm::desc_add(dka, kk * 32), sm::desc_add(dqk, kk * 32), kk > 0);
      sm::wgmma_commit();
      sm::wgmma_wait<0>();
      sm::fence_regs(sacc);

      // P^T = exp2(mask(S^T c) - m) in bf16; sacc[4 g + e] is query
      // 8 g + col + (e & 1) of key_lo (e < 2) or key_hi.
      uint32_t p[N / 4];
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
          const float l = keep ? sacc[i + e] * kScaleLog2 : dclip::kNegBig;
          pv[e] = exp2f(l - tm[ql]);
        }
        p[frag(i)] = pack_bf16(pv[0], pv[1]);
      }

      // dP^T = V g^T and dV += P^T GR (GR MN-major) in one group.
      float dpacc[N / 2];
      sm::fence_regs(p);
      sm::fence_regs(dv_acc);
      sm::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_ss<N>(dpacc, sm::desc_add(dva, kk * 32), sm::desc_add(dgk, kk * 32), kk > 0);
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk)
        sm::wgmma_m64n64k16_rs<1>(dv_acc, p + 4 * kk, sm::desc_add(grm, kk * 2048), 1);
      sm::wgmma_commit();
      sm::wgmma_wait<0>();
      sm::fence_regs(dpacc);
      sm::fence_regs(dv_acc);

      // dS^T = P^T ((dP^T - delta) rinv) in bf16, from the bf16 P^T.
      uint32_t ds[N / 4];
#pragma unroll
      for (int i = 0; i < N / 2; i += 2) {
        const int ql = 8 * (i / 4) + col;
        const float2 e2 = unpack_bf16(p[frag(i)]);
        ds[frag(i)] = pack_bf16(e2.x * ((dpacc[i] - td[ql]) * tr[ql]),
                                e2.y * ((dpacc[i + 1] - td[ql + 1]) * tr[ql + 1]));
      }

      // dK += dS^T Q, Q MN-major.
      const uint64_t dqm = sm::desc_sw128(sq + slot * kTileBytes, kTileBytes, 1024);
      sm::fence_regs(ds);
      sm::fence_regs(dk_acc);
      sm::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk)
        sm::wgmma_m64n64k16_rs<1>(dk_acc, ds + 4 * kk, sm::desc_add(dqm, kk * 2048), 1);
      sm::wgmma_commit();
      sm::wgmma_wait<0>();
      sm::fence_regs(dk_acc);
    };
    if (live) {
      if (s - q0 <= kNarrow) step(Narrow{}); else step(Full{});
    }
    if (j + kRing < tiles) __syncthreads();  // every warpgroup is done with the slot
    load_qg(j + kRing);
  }
  store_rows(dk_acc, kScale, dk + rows0 * lddk + h * kHd, lddk, key_lo, key_hi, s);
  store_rows(dv_acc, 1.f, dv + rows0 * lddv + h * kHd, lddv, key_lo, key_hi, s);
}

template <bool kMasked>
int launch(const void* q, const void* k, const void* v, int ldq, int ldk, int ldv,
           const void* g, const void* o, const void* m, const void* r, const void* pad,
           const void* seg, void* delta, void* dq, void* dk, void* dv, int lddq, int lddk,
           int lddv, int b, int s, int heads, int causal, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_dq_kernel<kMasked>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(attention_bwd_dkdv_kernel<kMasked>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kDkvSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s + kGroups * kTile - 1) / (kGroups * kTile), heads, b);
  using B16 = __nv_bfloat16;
  attention_bwd_dq_kernel<kMasked><<<grid, kThreads, kDqSmem, st>>>(
      static_cast<const B16*>(q), static_cast<const B16*>(k), static_cast<const B16*>(v),
      ldq, ldk, ldv, static_cast<const B16*>(g), static_cast<const B16*>(o),
      static_cast<const float*>(m), static_cast<const float*>(r),
      static_cast<const float*>(pad), static_cast<const int*>(seg),
      static_cast<float*>(delta), static_cast<B16*>(dq), lddq, s, heads, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_dkdv_kernel<kMasked><<<grid, kThreads, kDkvSmem, st>>>(
      static_cast<const B16*>(q), static_cast<const B16*>(k), static_cast<const B16*>(v),
      ldq, ldk, ldv, static_cast<const B16*>(g), static_cast<const float*>(m),
      static_cast<const float*>(r), static_cast<const float*>(delta),
      static_cast<const float*>(pad), static_cast<const int*>(seg), static_cast<B16*>(dk),
      lddk, static_cast<B16*>(dv), lddv, s, heads, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace hd64

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
  if (head_dim == 64)
    return masked ? hd64::launch<true>(q, k, v, ldq, ldk, ldv, g, o, m, r, pad, seg, delta, dq,
                                       dk, dv, lddq, lddk, lddv, b, s, heads, causal, st)
                  : hd64::launch<false>(q, k, v, ldq, ldk, ldv, g, o, m, r, pad, seg, delta, dq,
                                        dk, dv, lddq, lddk, lddv, b, s, heads, causal, st);
  if (head_dim == kHd)
    return masked ? launch<true>(q, k, v, ldq, ldk, ldv, g, o, o_lo, m, r, pad, seg, delta, dq,
                                 dk, dv, lddq, lddk, lddv, b, s, heads, causal, st)
                  : launch<false>(q, k, v, ldq, ldk, ldv, g, o, o_lo, m, r, pad, seg, delta, dq,
                                  dk, dv, lddq, lddk, lddv, b, s, heads, causal, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
