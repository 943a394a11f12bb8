// Exact inner-product top-k without the [Q, N] score matrix:
//   for each query q:  the k largest s[q, r] = <queries[q], store[r]> over
//   the store rows r < N, as (score, row) pairs in descending order of
//   score, a tie going to the lower row index; f32 accuracy throughout.
//
// Replaces: dclip_tpu/kernels/topk.py `_kernel` (K12, line 51: the body of
//   `topk_streamed`, pallas_call at line 106), which walks the store in
//   row blocks on one TPU core and folds each block's MXU scores into a
//   running top-k kept in VMEM scratch from one grid step to the next.
//   Blocks run in parallel here, so the running top-k cannot carry from
//   block to block: two passes, no atomics.
// Bound on the H100: the store read once (N D 4 bytes) against 3 x 2 Q N D
//   TF32 tensor-core operations (below). At the serving search (Q = 64,
//   N = 1e6, D = 512) 2.05 GB / 3.35 TB/s = 0.611 ms against 0.397 ms at
//   495 TFLOP/s: bytes bound it (96 flop/byte, under TF32's ridge of 148),
//   so the store has to stream from HBM near its full rate. At the
//   teacher's k-NN gate (Q = 2,048, N = 1e5) 1.271 ms of operations
//   against 0.062 ms of bytes: the tensor cores bound it. (On the CUDA
//   cores, f32 FMAs, the same work is 0.978 / 3.130 ms.) Against the bytes
//   the design keeps a TMA ring streaming while the consumers compute and
//   other warps select; against the operations it feeds wgmma from
//   registers, split there, with two warpgroups taking turns.
// Arithmetic, 3xTF32: a TF32 product keeps 10 mantissa bits and errs by
//   ~1e-4 on unit 512-d rows, over the contract's 1e-5. So each operand is
//   split, x = big + small with big = tf32(x) (rounded to nearest) and
//   small = tf32(x - big) (x - big is exact in f32), and a score is
//   store_small . q_big + store_big . q_small + store_big . q_big, each k8
//   step's three products summed into one f32 accumulator in that order
//   (the small terms first). What it drops, store_small . q_small and the
//   rounding of small, is ~2^-22 relative per term: f32-level error, as
//   the f32 FMA sum's.
// Design:
//   pass 0  (dclip_topk_split_tf32, once per search) splits the queries
//           into q_big and q_small [2, Q, D32], their columns in the k8
//           steps' order (`kstep_column`); they stream from L2.
//   pass 1  grid (query tiles of 64, store chunks), one block per SM: a
//           producer warp, two consumer warpgroups and two selector warps.
//           The producer keeps a ring of 3-4 stages filled by TMA
//           (cp.async.bulk.tensor on mbarriers, 128-byte swizzle): per stage
//           128 store rows x 32 f32 of depth and the same 32 columns of q_big
//           and q_small. Rows past N and columns past D arrive as zeros.
//           Each consumer warpgroup owns 64 of the 128 rows, the store as
//           wgmma's register A operand (M = 64 rows): each thread reads its
//           fragment from the swizzled stage in two 16-byte loads a row,
//           splits it in registers (two integer operations per rounding; no
//           split copy of the store is ever written) and issues per k8 step
//           three wgmma m64n64k8 tf32 products against q_small / q_big from
//           shared memory. The two groups take turns to issue (named
//           barriers), so that one loads and splits while the other's
//           products run. Every tile, the ragged last one too, runs the
//           same instruction sequence over every depth stage, so a score's
//           bits do not depend on where its row falls: duplicated rows tie
//           exactly.
//           Selection, filtered in registers: after a tile's last stage each
//           thread holds 2 rows x 16 queries of scores and tests each against
//           its query's current k-th score (shared memory; it only rises),
//           the round's bound (below) and the chunk's end. Survivors go to a
//           per-query candidate slot with a 64-bit row mask built from warp
//           ballots (no atomics), in one of two buffers per warpgroup handed
//           over on mbarriers, and the consumers go on with the next tile.
//           The selector warps, one thread per query, walk each mask in row
//           order and insert into the query's running list of k (score, row)
//           pairs, ordered by (score descending, row ascending), then
//           publish its k-th score. At N = 1e6 and k = 10 few rows survive
//           after the first tiles. The block writes partials [Q, chunks, k].
//   pass 2  one warp per query merges its chunks x k candidates: each
//           lane folds every 32nd chunk's list into a list of its own
//           (stopping at the first pair behind it: the lists are sorted),
//           then k steps of a warp-wide arg-max over the lanes' heads,
//           under the same order, emit the result.
//   The order is a strict total order on (score, row), so the result is
//   unique: deterministic, and independent of the chunking. One launch of
//   the pair selects k <= 64 pairs; a larger k takes rounds of both passes
//   (the wrapper's loop), each given per query the last pair the round
//   before emitted ("after"): pass 1 considers only the pairs behind it, so
//   round r yields ranks 64 r .. 64 r + 63 of the whole ranking. D is a
//   multiple of 8, a tf32 k step (the wrapper pads with zero columns).
#include <math.h>

#include "common.cuh"
#include "sm90.cuh"

namespace {

namespace sm = dclip::sm90;

constexpr int kTQ = 64;                          // queries per block: the wgmma N
constexpr int kWGRows = 64;                      // store rows per warpgroup: the wgmma M
constexpr int kConsumers = 2;                    // warpgroups
constexpr int kTN = kConsumers * kWGRows;        // store rows per tile
constexpr int kSelectors = 2;                    // selector warps: one thread per query
constexpr int kSelectorBase = kConsumers * 128 + 32;  // after one producer warp
constexpr int kThreads = kSelectorBase + kSelectors * 32;
static_assert(kSelectors * 32 == kTQ, "one selector thread per query");
constexpr int kKC = 32;                          // depth per stage: one 128-byte row
constexpr int kStoreBox = kTN * kKC * 4;         // 16 KB
constexpr int kQueryBox = kTQ * kKC * 4;         // 8 KB, each of q_big and q_small
constexpr int kStageBytes = kStoreBox + 2 * kQueryBox;
constexpr int kMaxStages = 4, kMinStages = 3;
constexpr int kLdC = kWGRows + 4;  // candidate slots per query: conflict-free writes
constexpr int kMaxK = 64;
constexpr int kRegK = 16;  // the selector keeps lists up to this long in registers
constexpr int kMergeWarps = 4;
constexpr int kNoRow = 0x7fffffff;
constexpr int kSmemLimit = 232448;  // a block's dynamic shared memory on the H100

// (s, i) comes before (t, j): a higher score, or an equal one at a lower row.
__device__ __forceinline__ bool ahead(float s, int i, float t, int j) {
  return s > t || (s == t && i < j);
}

// Insert (s, i) into the ordered list (ls, li) of k pairs, dropping its last.
__device__ __forceinline__ void insert(float* ls, int* li, int k, float s, int i) {
  int p = k - 1;
  while (p > 0 && ahead(s, i, ls[p - 1], li[p - 1])) {
    ls[p] = ls[p - 1];
    li[p] = li[p - 1];
    --p;
  }
  ls[p] = s;
  li[p] = i;
}

// The same for a list of kRegK pairs in registers (the first k of them are
// the list; those behind only ever hold pairs behind it): a fixed network,
// pair j taking pair j - 1, the new one or itself.
__device__ __forceinline__ void insert_regs(float (&ls)[kRegK], int (&li)[kRegK], float s,
                                            int i) {
#pragma unroll
  for (int j = kRegK - 1; j > 0; --j) {
    const bool up = ahead(s, i, ls[j - 1], li[j - 1]);
    const bool here = !up && ahead(s, i, ls[j], li[j]);
    ls[j] = up ? ls[j - 1] : here ? s : ls[j];
    li[j] = up ? li[j - 1] : here ? i : li[j];
  }
  if (ahead(s, i, ls[0], li[0])) {
    ls[0] = s;
    li[0] = i;
  }
}

// Bits 4 i (i = 0..7) of x, packed into bits 0..7.
__device__ __forceinline__ uint32_t gather_nibble_bits(uint32_t x) {
  x &= 0x11111111u;
  x = (x | (x >> 3)) & 0x03030303u;
  x = (x | (x >> 6)) & 0x000F000Fu;
  return (x | (x >> 12)) & 0xFFu;
}

// Shared memory past the ring: barriers, bounds, thresholds, masks,
// candidates, then the running lists.
size_t fixed_smem_bytes(int k) {
  return 1024 + (2 * kMaxStages + 4 * kConsumers) * sizeof(uint64_t) + kTQ * 12 +
         2 * kConsumers * kTQ * 8 + sizeof(float) * 2 * kConsumers * kTQ * kLdC +
         static_cast<size_t>(kTQ) * k * 8;
}

int ring_stages(int k) {
  const size_t room = kSmemLimit - fixed_smem_bytes(k);
  return static_cast<int>(room / kStageBytes < kMaxStages ? room / kStageBytes : kMaxStages);
}

size_t pass1_smem_bytes(int k) {
  return fixed_smem_bytes(k) + static_cast<size_t>(ring_stages(k)) * kStageBytes;
}

size_t merge_smem_bytes(int k) {
  return (sizeof(float) + sizeof(int)) * static_cast<size_t>(kMergeWarps) * 32 * k;
}

// Position p (0-7) of k8 step kk of a 32-column stage holds column
// 8 (p % 4) + 2 kk + p / 4: a thread's A elements of all four steps are then
// columns 8 c .. 8 c + 7 of its rows, two 16-byte loads. The B operand (the
// queries) is stored in this order; a dot product does not depend on it.
__device__ __forceinline__ int kstep_column(int j) {
  const int kk = (j & 31) >> 3, p = j & 7;
  return (j & ~31) + 8 * (p & 3) + 2 * kk + (p >> 2);
}

// x [rows, d] -> out [2, rows, d32]: column j of each half holds x's column
// kstep_column(j) (zero past d), TF32-split.
__global__ void split_tf32_kernel(const float* __restrict__ x, float* __restrict__ out, int rows,
                                  int d, int d32) {
  const size_t count = static_cast<size_t>(rows) * d32;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < count;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int row = static_cast<int>(i / d32), col = kstep_column(static_cast<int>(i % d32));
    const float v = col < d ? x[static_cast<size_t>(row) * d + col] : 0.f;
    const uint32_t big = sm::tf32_rna(v);
    out[i] = __uint_as_float(big);
    out[count + i] = __uint_as_float(sm::tf32_rna(v - __uint_as_float(big)));
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    topk_tf32_kernel(const __grid_constant__ CUtensorMap map_store,
                     const __grid_constant__ CUtensorMap map_qbig,
                     const __grid_constant__ CUtensorMap map_qsmall,
                     const float* __restrict__ after_s, const int* __restrict__ after_i,
                     int after_ld, float* __restrict__ part_s, int* __restrict__ part_i, int nq,
                     int n, int d, int k, int rows_per_chunk, int chunks, int stages) {
  extern __shared__ unsigned char smem_raw[];
  // The ring starts at the first 1,024-byte boundary (the 128-byte swizzle's
  // atom). Offsetting the __shared__ array itself, not a pointer cast through
  // an integer, keeps every pointer below in the shared window for the
  // compiler: shared-memory loads and stores, not generic ones.
  unsigned char* ring = smem_raw + ((1024 - (sm::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * kStageBytes);
  uint64_t* empty = full + kMaxStages;
  uint64_t* cand_full = empty + kMaxStages;  // [2 buffers][kConsumers]
  uint64_t* cand_empty = cand_full + 2 * kConsumers;
  float* lim_s = reinterpret_cast<float*>(cand_empty + 2 * kConsumers);  // [kTQ]: the bound
  int* lim_i = reinterpret_cast<int*>(lim_s + kTQ);
  // [kTQ]: each query's k-th score, written by the selector warps only.
  volatile float* kth = reinterpret_cast<float*>(lim_i + kTQ);
  // [2][kConsumers][kTQ][8]: each query's 64-bit mask of surviving tile rows.
  unsigned char* rows_mask = reinterpret_cast<unsigned char*>(const_cast<float*>(kth) + kTQ);
  // [2][kConsumers][kTQ][kLdC]: survivors' scores by query and tile row.
  float* cand = reinterpret_cast<float*>(rows_mask + 2 * kConsumers * kTQ * 8);
  float* top_s = cand + 2 * kConsumers * kTQ * kLdC;  // [kTQ][k]: the running lists
  int* top_i = reinterpret_cast<int*>(top_s + kTQ * k);

  const int t = threadIdx.x;
  const int q0 = blockIdx.x * kTQ, chunk = blockIdx.y;
  const int r_begin = chunk * rows_per_chunk;
  const int r_end = min(n, r_begin + rows_per_chunk);
  const int kc = (d + kKC - 1) / kKC;
  const int tiles = max(0, (r_end - r_begin + kTN - 1) / kTN);
  const int total = tiles * kc;

  if (t == 0) {
    for (int s = 0; s < stages; ++s) {
      sm::mbar_init(&full[s], 1);
      sm::mbar_init(&empty[s], kConsumers * 4);  // one arrival per consumer warp
    }
    for (int b = 0; b < 2 * kConsumers; ++b) {
      sm::mbar_init(&cand_full[b], 128);               // every thread of the warpgroup
      sm::mbar_init(&cand_empty[b], kSelectors * 32);  // every selector thread
    }
    sm::fence_barrier_init();
  }
  for (int i = t; i < kTQ * k; i += kThreads) {
    top_s[i] = -INFINITY;
    top_i[i] = kNoRow;
  }
  // The round's bound per query: only pairs behind it enter. Without one,
  // (+inf, -1) is ahead of every pair that has a score (NaN never enters).
  // No k-th score yet: every score passes the consumers' filter.
  for (int i = t; i < kTQ; i += kThreads) {
    const bool bounded = after_s != nullptr && q0 + i < nq;
    lim_s[i] = bounded ? after_s[static_cast<size_t>(q0 + i) * after_ld] : INFINITY;
    lim_i[i] = bounded ? after_i[static_cast<size_t>(q0 + i) * after_ld] : -1;
    kth[i] = -INFINITY;
  }
  __syncthreads();
  const int wg = t / 128;

  if (t >= kSelectorBase) {
    // Selector warps: thread q keeps query q's list of k (score, row) pairs,
    // ordered by (score descending, row ascending), and merges into it each
    // tile's survivors, warpgroup 0's rows then warpgroup 1's (ascending).
    // For k <= kRegK the list lives in registers (a fixed insertion network:
    // no loads, and the lanes of a warp do not drift apart); else in shared
    // memory.
    const int q = t - kSelectorBase;
    float* ls = top_s + q * k;
    int* li = top_i + q * k;
    const bool in_regs = k <= kRegK;
    float rs[kRegK];
    int ri[kRegK];
#pragma unroll
    for (int j = 0; j < kRegK; ++j) {
      rs[j] = -INFINITY;
      ri[j] = kNoRow;
    }
    float ws = -INFINITY;  // the k-th pair
    int wi = kNoRow;
    for (int tile = 0; tile < tiles; ++tile) {
      const int b = tile & 1;
      for (int w = 0; w < kConsumers; ++w) {
        const int slot = b * kConsumers + w;
        sm::mbar_wait(&cand_full[slot], (tile >> 1) & 1);
        if (q0 + q < nq) {
          uint64_t rows = *reinterpret_cast<const uint64_t*>(rows_mask + (slot * kTQ + q) * 8);
          const float* cs = cand + (slot * kTQ + q) * kLdC;
          const int base = r_begin + tile * kTN + w * kWGRows;
          for (; rows != 0; rows &= rows - 1) {
            const int r = __ffsll(static_cast<long long>(rows)) - 1;
            const float sc = cs[r];
            if (!ahead(sc, base + r, ws, wi)) continue;
            if (in_regs) {
              insert_regs(rs, ri, sc, base + r);
#pragma unroll
              for (int j = 0; j < kRegK; ++j)
                if (j == k - 1) {
                  ws = rs[j];
                  wi = ri[j];
                }
            } else {
              insert(ls, li, k, sc, base + r);
              ws = ls[k - 1];
              wi = li[k - 1];
            }
          }
          kth[q] = ws;
        }
        sm::mbar_arrive(&cand_empty[slot]);
      }
    }
    if (in_regs) {
#pragma unroll
      for (int j = 0; j < kRegK; ++j)
        if (j < k) {
          ls[j] = rs[j];
          li[j] = ri[j];
        }
    }
  } else if (wg == kConsumers) {
    // Producer warp: one thread issues every load.
    if (t == kConsumers * 128) {
      sm::prefetch_tensormap(&map_store);
      sm::prefetch_tensormap(&map_qbig);
      sm::prefetch_tensormap(&map_qsmall);
      int s = 0;
      uint32_t phase = 0;
      for (int it = 0, tile = 0, c = 0; it < total; ++it) {
        sm::mbar_wait(&empty[s], phase ^ 1);
        sm::mbar_expect_tx(&full[s], kStageBytes);
        unsigned char* st = ring + s * kStageBytes;
        sm::tma_load_2d(st, &map_store, &full[s], c * kKC, r_begin + tile * kTN);
        sm::tma_load_2d(st + kStoreBox, &map_qbig, &full[s], c * kKC, q0);
        sm::tma_load_2d(st + kStoreBox + kQueryBox, &map_qsmall, &full[s], c * kKC, q0);
        if (++s == stages) {
          s = 0;
          phase ^= 1;
        }
        if (++c == kc) {
          c = 0;
          ++tile;
        }
      }
    }
  } else {
    const int wt = t & 127, warp = wt >> 5, lane = t & 31;
    const int g4 = lane >> 2, tq = lane & 3;
    // This thread's A rows in a stage's store box: wg * 64 + warp * 16 +
    // lane / 4, and 8 rows further; both swizzle with row & 7 == lane / 4.
    // It reads columns 8 c .. 8 c + 7 of each (c = lane % 4) as two 16-byte
    // vectors: the k8 steps take the columns in the order `kstep_column`
    // gives, which the query split follows.
    const int row_byte = (wg * kWGRows + warp * 16 + g4) * 128;
    const bool bounded = after_s != nullptr;

    float acc[32];
    uint32_t big[16], small[16];

    // One stage's 64 x 32 store fragment of this warpgroup, split: per k8
    // step kk, the A elements (r, p), (r + 8, p), (r, p + 4), (r + 8, p + 4)
    // at positions p = c and p + 4, i.e. columns 8 c + 2 kk and 8 c + 2 kk + 1,
    // with r = this thread's row and c = lane % 4.
    auto load_split = [&](const unsigned char* st) {
      float f[2][8];  // columns 8 c .. 8 c + 7 of rows r and r + 8
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float4 v = *reinterpret_cast<const float4*>(
              st + row_byte + h * 8 * 128 + (((2 * tq + half) ^ g4) << 4));
          f[h][4 * half] = v.x;
          f[h][4 * half + 1] = v.y;
          f[h][4 * half + 2] = v.z;
          f[h][4 * half + 3] = v.w;
        }
#pragma unroll
      for (int kk = 0; kk < kKC / 8; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float x = f[j & 1][2 * kk + (j >> 1)];
          big[4 * kk + j] = sm::tf32_rna(x);
          small[4 * kk + j] = sm::tf32_rna(x - __uint_as_float(big[4 * kk + j]));
        }
    };
    // The three products of every k8 step of one stage, small terms first.
    auto issue = [&](const unsigned char* st) {
      const uint64_t dqb = sm::desc_sw128(st + kStoreBox, 16, 1024);
      const uint64_t dqs = sm::desc_sw128(st + kStoreBox + kQueryBox, 16, 1024);
      sm::fence_regs(acc);
      sm::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKC / 8; ++kk) {
        sm::wgmma_m64n64k8_tf32_rs(acc, &small[4 * kk], sm::desc_add(dqb, kk * 32));
        sm::wgmma_m64n64k8_tf32_rs(acc, &big[4 * kk], sm::desc_add(dqs, kk * 32));
        sm::wgmma_m64n64k8_tf32_rs(acc, &big[4 * kk], sm::desc_add(dqb, kk * 32));
      }
      sm::wgmma_commit();
    };

    // A finished tile's scores, filtered in registers: a score passes if it
    // is at least its query's k-th (read without a lock: it only rises, and
    // the selector compares exactly), is behind the round's bound and its
    // row lies in the chunk. Survivors go to their candidate slots, and each
    // query's 64-bit row mask is built from warp ballots: lane j keeps the
    // ballot of value j = 4 g + 2 h + e, whose bit 4 i + c is row 8 h + i of
    // query 8 g + 2 c + e. Then the selector warps take the buffer over.
    auto select_tile = [&](int tile) {
      const int row0 = r_begin + tile * kTN + wg * kWGRows + warp * 16 + g4;
      uint32_t flags = 0;  // bit 4 g + 2 h + e: acc[4 g + 2 h + e], row row0 + 8 h
#pragma unroll
      for (int g = 0; g < kTQ / 8; ++g) {
        const float ts0 = kth[8 * g + 2 * tq], ts1 = kth[8 * g + 2 * tq + 1];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            flags |= static_cast<uint32_t>(acc[4 * g + 2 * h + e] >= (e ? ts1 : ts0))
                     << (4 * g + 2 * h + e);
      }
      if (bounded) {
#pragma unroll
        for (int g = 0; g < kTQ / 8; ++g) {
          const int q = 8 * g + 2 * tq;
          const float2 bs = *reinterpret_cast<const float2*>(lim_s + q);
          const int2 bi = *reinterpret_cast<const int2*>(lim_i + q);
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (!ahead(e ? bs.y : bs.x, e ? bi.y : bi.x, acc[4 * g + 2 * h + e], row0 + 8 * h))
                flags &= ~(1u << (4 * g + 2 * h + e));
        }
      }
      if (row0 >= r_end) flags = 0;
      else if (row0 + 8 >= r_end) flags &= 0x33333333u;

      const int slot = (tile & 1) * kConsumers + wg;
      sm::mbar_wait(&cand_empty[slot], ((tile >> 1) & 1) ^ 1);
      float* cs = cand + slot * kTQ * kLdC;
      uint32_t mine = 0;
      if (__any_sync(dclip::kFullMask, flags != 0)) {
#pragma unroll
        for (int bit = 0; bit < 32; ++bit) {
          const bool ok = (flags >> bit) & 1;
          if (ok)
            cs[(8 * (bit >> 2) + 2 * tq + (bit & 1)) * kLdC + warp * 16 + g4 +
               8 * ((bit >> 1) & 1)] = acc[bit];
          const uint32_t b = __ballot_sync(dclip::kFullMask, ok);
          if (lane == bit) mine = b;
        }
      }
      // Query q's mask is bytes [q][2 warp + h] (bit i: row 8 h + i).
      unsigned char* rm = rows_mask + slot * kTQ * 8;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        rm[(8 * (lane >> 2) + 2 * c + (lane & 1)) * 8 + warp * 2 + ((lane >> 1) & 1)] =
            static_cast<unsigned char>(gather_nibble_bits(mine >> c));
      sm::mbar_arrive(&cand_full[slot]);
    };

    // The two warpgroups take turns to issue their products (named barriers
    // 1 + wg over both groups' 256 threads): one group loads and splits its
    // next fragment while the other's products run, so the tensor cores do
    // not wait for both to load at once. Group 1 hands group 0 the first turn.
    const int other = 1 - wg;
    if (wg == 1 && total > 0) sm::named_arrive(1 + other, 2 * 128);
    int s = 0;
    uint32_t phase = 0;
    for (int it = 0, tile = 0, c = 0; it < total; ++it) {
      if (c == 0) {
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] = 0.f;
      }
      sm::mbar_wait(&full[s], phase);
      const unsigned char* st = ring + s * kStageBytes;
      load_split(st);
      sm::named_sync(1 + wg, 2 * 128);
      issue(st);
      if (wg == 0 || it + 1 < total) sm::named_arrive(1 + other, 2 * 128);
      sm::wgmma_wait<0>();
      sm::fence_regs(acc);
      sm::fence_regs(big);  // live until the products that read them are done
      sm::fence_regs(small);
      if (lane == 0) sm::mbar_arrive(&empty[s]);
      if (++s == stages) {
        s = 0;
        phase ^= 1;
      }
      if (c == kc - 1) select_tile(tile);
      if (++c == kc) {
        c = 0;
        ++tile;
      }
    }
  }

  __syncthreads();
  for (int i = t; i < kTQ * k; i += kThreads) {
    const int row = i / k, j = i % k;
    if (q0 + row < nq) {
      const size_t o = (static_cast<size_t>(q0 + row) * chunks + chunk) * k + j;
      part_s[o] = top_s[i];
      part_i[o] = top_i[i];
    }
  }
}

__global__ void __launch_bounds__(kMergeWarps * 32)
    topk_merge_kernel(const float* __restrict__ part_s, const int* __restrict__ part_i,
                      float* __restrict__ out_s, int* __restrict__ out_i, int out_ld,
                      int nq, int k, int chunks) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = blockIdx.x * kMergeWarps + warp;
  if (q >= nq) return;  // the whole warp; this kernel has no block barrier
  const int slot = warp * 32 + lane;
  float* ls = smem + static_cast<size_t>(slot) * k;
  int* li = reinterpret_cast<int*>(smem + kMergeWarps * 32 * k) + static_cast<size_t>(slot) * k;
  for (int j = 0; j < k; ++j) {
    ls[j] = -INFINITY;
    li[j] = kNoRow;
  }
  float ws = -INFINITY;
  int wi = kNoRow;
  for (int c = lane; c < chunks; c += 32) {
    const size_t base = (static_cast<size_t>(q) * chunks + c) * k;
    for (int j = 0; j < k; ++j) {
      const float s = part_s[base + j];
      const int i = part_i[base + j];
      if (!ahead(s, i, ws, wi)) break;  // the chunk's list is ordered
      insert(ls, li, k, s, i);
      ws = ls[k - 1];
      wi = li[k - 1];
    }
  }
  int head = 0;
  for (int r = 0; r < k; ++r) {
    float s = head < k ? ls[head] : -INFINITY;
    int i = head < k ? li[head] : kNoRow;
    int who = lane;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float s2 = __shfl_xor_sync(dclip::kFullMask, s, o);
      const int i2 = __shfl_xor_sync(dclip::kFullMask, i, o);
      const int w2 = __shfl_xor_sync(dclip::kFullMask, who, o);
      if (ahead(s2, i2, s, i) || (s2 == s && i2 == i && w2 < who)) {
        s = s2;
        i = i2;
        who = w2;
      }
    }
    if (lane == who) ++head;
    if (lane == 0) {
      out_s[static_cast<size_t>(q) * out_ld + r] = s;
      out_i[static_cast<size_t>(q) * out_ld + r] = i;
    }
  }
}

// A row-major f32 [rows, cols] matrix read in [box_rows][32] boxes (one
// 128-byte row each) with 128-byte swizzle; outside it, zeros.
bool encode_f32(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  dclip::sm90::EncodeTiledFn fn = dclip::sm90::encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 4};
  const cuuint32_t box[2] = {kKC, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// How many pass-1 blocks one SM holds at once for this k (registers and
// shared memory decide it): the wrapper sizes the chunks so that the grid
// fills the card in one wave.
extern "C" int dclip_topk_blocks_per_sm(int k, void* blocks) {
  if (k < 1 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem1 = pass1_smem_bytes(k);
  cudaError_t err = cudaFuncSetAttribute(
      topk_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem1));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      static_cast<int*>(blocks), topk_tf32_kernel, kThreads, smem1));
}

// The queries' TF32 split, once per search: x [rows, d] f32 contiguous ->
// out [2, rows, d32] f32 (d32 = d rounded up to 32), the columns in k8-step
// order (kstep_column): out[0] = tf32(x) (to nearest), out[1] = tf32(x - out[0]).
extern "C" int dclip_topk_split_tf32(const void* x, void* out, int rows, int d, void* stream) {
  if (rows < 0 || d < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int d32 = (d + kKC - 1) / kKC * kKC;
  const size_t count = static_cast<size_t>(rows) * d32;
  if (count == 0) return 0;
  const int blocks = static_cast<int>(count / 256 + 1 < 1024 ? count / 256 + 1 : 1024);
  split_tf32_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), rows, d, d32);
  return static_cast<int>(cudaGetLastError());
}

// One round: `queries` is dclip_topk_split_tf32's [2, nq, d32] output and
// store [n, d] f32, both contiguous, 16-byte aligned, d % 8 == 0; after_s /
// after_i: null (the first round) or each query's bound pair at row stride
// ld; part_s / part_i [nq, chunks, k] f32 / int32 scratch; out_s / out_i:
// the round's k columns of [nq, ld] f32 / int32. 1 <= k <= min(64, n, ld);
// the chunks of rows_per_chunk rows (a multiple of 128) cover [0, n).
extern "C" int dclip_topk_streamed_f32(const void* queries, const void* store,
                                       const void* after_s, const void* after_i, void* part_s,
                                       void* part_i, void* out_s, void* out_i, int ld, int nq,
                                       int n, int d, int k, int rows_per_chunk, int chunks,
                                       void* stream) {
  if (k < 1 || k > kMaxK || k > n || k > ld || nq < 1 || d < 1 || d % 8 ||
      rows_per_chunk % kTN || (after_s == nullptr) != (after_i == nullptr) ||
      static_cast<long long>(rows_per_chunk) * chunks < n)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int stages = ring_stages(k);
  if (stages < kMinStages) return static_cast<int>(cudaErrorInvalidValue);
  // A runtime call first: it makes the device's primary context current in
  // this host thread, which the driver's tensor-map encode needs.
  const size_t smem1 = pass1_smem_bytes(k);
  cudaError_t err = cudaFuncSetAttribute(
      topk_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem1));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int d32 = (d + kKC - 1) / kKC * kKC;
  const float* q_big = static_cast<const float*>(queries);
  CUtensorMap map_store, map_qbig, map_qsmall;
  if (!encode_f32(&map_store, store, n, d, kTN) || !encode_f32(&map_qbig, q_big, nq, d32, kTQ) ||
      !encode_f32(&map_qsmall, q_big + static_cast<size_t>(nq) * d32, nq, d32, kTQ))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid1((nq + kTQ - 1) / kTQ, chunks);
  topk_tf32_kernel<<<grid1, kThreads, smem1, s>>>(
      map_store, map_qbig, map_qsmall, static_cast<const float*>(after_s),
      static_cast<const int*>(after_i), ld, static_cast<float*>(part_s),
      static_cast<int*>(part_i), nq, n, d, k, rows_per_chunk, chunks, stages);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem2 = merge_smem_bytes(k);
  err = cudaFuncSetAttribute(topk_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem2));
  if (err != cudaSuccess) return static_cast<int>(err);
  topk_merge_kernel<<<(nq + kMergeWarps - 1) / kMergeWarps, kMergeWarps * 32, smem2, s>>>(
      static_cast<const float*>(part_s), static_cast<const int*>(part_i),
      static_cast<float*>(out_s), static_cast<int*>(out_i), ld, nq, k, chunks);
  return static_cast<int>(cudaGetLastError());
}
