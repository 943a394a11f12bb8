// Exact inner-product top-k without the [Q, N] score matrix:
//   for each query q:  the k largest s[q, r] = <queries[q], store[r]> over
//   the store rows r < N, as (score, row) pairs in descending order of
//   score, a tie going to the lower row index; f32 throughout.
//
// Replaces: dclip_tpu/kernels/topk.py `_kernel` (K12, line 51: the body of
//   `topk_streamed`, pallas_call at line 106), which walks the store in
//   row blocks on one TPU core and folds each block's MXU scores into a
//   running top-k kept in VMEM scratch from one grid step to the next.
//   Blocks run in parallel here, so the running top-k cannot carry from
//   block to block: two passes, no atomics.
// Bound on the H100: 2 Q N D f32 operations on the CUDA cores (the
//   contract is f32: no TF32) against N D 4 bytes of store read once. At
//   the serving search (Q = 64, N = 1e6, D = 512) 65.5 GFLOP / 67 TFLOP/s
//   = 0.98 ms against 2.05 GB / 3.35 TB/s = 0.61 ms; at the teacher's k-NN
//   gate (Q = 2,048, N = 1e5) 3.1 ms against 0.06 ms: operations bound
//   both.
// Design:
//   pass 1  grid (query tiles of 64, store chunks). A block of 128 threads
//           streams its chunk in tiles of 128 rows. Each tile's 64 x 128
//           scores are a register-tiled f32 product (8 queries x 8 rows a
//           thread: 16 FMAs per shared-memory read; depth in stages of 16,
//           double-buffered, the next stage's global loads in flight during
//           the current one's FMAs), accumulated with FMA in ascending
//           depth order, so a score's bits do not depend on where its row
//           falls (duplicated rows tie exactly). The tile goes to shared memory and one thread per
//           query folds it into that query's running top-k, a list of k
//           (score, row) pairs in shared memory ordered by (score
//           descending, row ascending); a candidate enters only if it is
//           ahead of the list's last pair (and behind the round's
//           bound, below). Rows past the chunk or past N
//           are never loaded or considered (bounds, not padding). Each
//           block writes its lists as partials [Q, chunks, k].
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
//   multiple of 4 (the wrapper pads with zero columns otherwise).
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kTQ = 64;        // queries per block
constexpr int kTN = 128;       // store rows per tile
constexpr int kKT = 16;        // depth per shared-memory stage
constexpr int kThreads = 128;  // 8 x 16: 8 queries x 8 rows per thread
constexpr int kALoads = kTQ * kKT / 4 / kThreads;  // float4 loads a thread, a stage
constexpr int kBLoads = kTN * kKT / 4 / kThreads;
constexpr int kLdA = kTQ + 4;  // padded rows: a 16-byte aligned float4 read
constexpr int kLdB = kTN + 4;  //   of each stage row, fewer store conflicts
constexpr int kLdS = kTN + 1;  // score tile: query t reads row t conflict-free
constexpr int kMaxK = 64;
constexpr int kMergeWarps = 4;
constexpr int kNoRow = 0x7fffffff;

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

size_t pass1_smem_bytes(int k) {
  return sizeof(float) * (2 * kKT * kLdA + 2 * kKT * kLdB + kTQ * kLdS) +
         (sizeof(float) + sizeof(int)) * static_cast<size_t>(kTQ) * k;
}

size_t merge_smem_bytes(int k) {
  return (sizeof(float) + sizeof(int)) * static_cast<size_t>(kMergeWarps) * 32 * k;
}

__global__ void __launch_bounds__(kThreads, 2)
    topk_chunks_kernel(const float* __restrict__ queries, const float* __restrict__ store,
                       const float* __restrict__ after_s, const int* __restrict__ after_i,
                       int after_ld, float* __restrict__ part_s, int* __restrict__ part_i,
                       int nq, int n, int d, int k, int rows_per_chunk, int chunks) {
  extern __shared__ float smem[];
  float* as = smem;                   // [2][kKT][kLdA]: query tiles, depth-major
  float* bs = as + 2 * kKT * kLdA;    // [2][kKT][kLdB]: store tiles, depth-major
  float* sc = bs + 2 * kKT * kLdB;    // [kTQ][kLdS]: one tile's scores
  float* top_s = sc + kTQ * kLdS;     // [kTQ][k]: the running lists
  int* top_i = reinterpret_cast<int*>(top_s + kTQ * k);

  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  const int q0 = blockIdx.x * kTQ, chunk = blockIdx.y;
  const int r_begin = chunk * rows_per_chunk;
  const int r_end = min(n, r_begin + rows_per_chunk);
  const int k_tiles = (d + kKT - 1) / kKT;

  for (int i = t; i < kTQ * k; i += kThreads) {
    top_s[i] = -INFINITY;
    top_i[i] = kNoRow;
  }
  // This round's bound for query t: only pairs behind it enter. Without one,
  // (+inf, -1) is ahead of every pair that has a score (NaN never enters).
  float lim_s = INFINITY;
  int lim_i = -1;
  if (after_s != nullptr && t < kTQ && q0 + t < nq) {
    lim_s = after_s[static_cast<size_t>(q0 + t) * after_ld];
    lim_i = after_i[static_cast<size_t>(q0 + t) * after_ld];
  }

  // One depth stage of both tiles, global -> registers (zero past the
  // queries, the chunk's rows or d), then registers -> shared memory.
  float4 ra[kALoads], rb[kBLoads];
  auto fetch = [&](int n0, int k0) {
#pragma unroll
    for (int h = 0; h < kALoads; ++h) {
      const int e = t + h * kThreads, row = e >> 2, c = (e & 3) * 4;
      ra[h] = (q0 + row < nq && k0 + c < d)
                  ? *reinterpret_cast<const float4*>(queries +
                                                     static_cast<size_t>(q0 + row) * d + k0 + c)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int h = 0; h < kBLoads; ++h) {
      const int e = t + h * kThreads, row = e >> 2, c = (e & 3) * 4;
      rb[h] = (n0 + row < r_end && k0 + c < d)
                  ? *reinterpret_cast<const float4*>(store + static_cast<size_t>(n0 + row) * d +
                                                     k0 + c)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto stash = [&](int buf) {
    float* a = as + buf * kKT * kLdA;
    float* b = bs + buf * kKT * kLdB;
#pragma unroll
    for (int h = 0; h < kALoads; ++h) {
      const int e = t + h * kThreads, row = e >> 2, c = (e & 3) * 4;
      a[(c + 0) * kLdA + row] = ra[h].x;
      a[(c + 1) * kLdA + row] = ra[h].y;
      a[(c + 2) * kLdA + row] = ra[h].z;
      a[(c + 3) * kLdA + row] = ra[h].w;
    }
#pragma unroll
    for (int h = 0; h < kBLoads; ++h) {
      const int e = t + h * kThreads, row = e >> 2, c = (e & 3) * 4;
      b[(c + 0) * kLdB + row] = rb[h].x;
      b[(c + 1) * kLdB + row] = rb[h].y;
      b[(c + 2) * kLdB + row] = rb[h].z;
      b[(c + 3) * kLdB + row] = rb[h].w;
    }
  };

  for (int n0 = r_begin; n0 < r_end; n0 += kTN) {
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    fetch(n0, 0);
    stash(0);
    __syncthreads();
    for (int kt = 0; kt < k_tiles; ++kt) {
      const int buf = kt & 1;
      if (kt + 1 < k_tiles) fetch(n0, (kt + 1) * kKT);  // in flight during the FMAs
      const float* a = as + buf * kKT * kLdA;
      const float* b = bs + buf * kKT * kLdB;
#pragma unroll
      for (int kk = 0; kk < kKT; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(a + kk * kLdA + ty * 8);
        const float4 a1 = *reinterpret_cast<const float4*>(a + kk * kLdA + ty * 8 + 4);
        const float4 b0 = *reinterpret_cast<const float4*>(b + kk * kLdB + tx * 4);
        const float4 b1 = *reinterpret_cast<const float4*>(b + kk * kLdB + 64 + tx * 4);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      if (kt + 1 < k_tiles) stash(buf ^ 1);
      // Every thread is done with `buf` before the next stage overwrites it,
      // and the stash into buf ^ 1 is visible before it is read.
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[(ty * 8 + i) * kLdS + tx * 4 + j] = acc[i][j];
        sc[(ty * 8 + i) * kLdS + 64 + tx * 4 + j] = acc[i][4 + j];
      }
    __syncthreads();
    if (t < kTQ && q0 + t < nq) {
      float* ls = top_s + t * k;
      int* li = top_i + t * k;
      float ws = ls[k - 1];
      int wi = li[k - 1];
      const int valid = min(kTN, r_end - n0);
      const float* row = sc + t * kLdS;
      for (int j = 0; j < valid; ++j) {
        const float s = row[j];
        if (ahead(s, n0 + j, ws, wi) && ahead(lim_s, lim_i, s, n0 + j)) {
          insert(ls, li, k, s, n0 + j);
          ws = ls[k - 1];
          wi = li[k - 1];
        }
      }
    }
    __syncthreads();
  }

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

}  // namespace

// How many pass-1 blocks one SM holds at once for this k (registers and
// shared memory decide it): the wrapper sizes the chunks so that the grid
// fills the card in one wave.
extern "C" int dclip_topk_blocks_per_sm(int k, void* blocks) {
  const size_t smem1 = pass1_smem_bytes(k);
  cudaError_t err = cudaFuncSetAttribute(
      topk_chunks_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem1));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      static_cast<int*>(blocks), topk_chunks_kernel, kThreads, smem1));
}

// One round: queries [nq, d] and store [n, d] f32, contiguous, 16-byte
// aligned, d % 4 == 0; after_s / after_i: null (the first round) or each
// query's bound pair at row stride ld; part_s / part_i [nq, chunks, k] f32 /
// int32 scratch; out_s / out_i: the round's k columns of [nq, ld] f32 /
// int32. 1 <= k <= min(64, n, ld); the chunks of rows_per_chunk rows (a
// multiple of 128) cover [0, n).
extern "C" int dclip_topk_streamed_f32(const void* queries, const void* store,
                                       const void* after_s, const void* after_i, void* part_s,
                                       void* part_i, void* out_s, void* out_i, int ld, int nq,
                                       int n, int d, int k, int rows_per_chunk, int chunks,
                                       void* stream) {
  if (k < 1 || k > kMaxK || k > n || k > ld || d < 1 || d % 4 || rows_per_chunk % kTN ||
      (after_s == nullptr) != (after_i == nullptr) ||
      static_cast<long long>(rows_per_chunk) * chunks < n)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem1 = pass1_smem_bytes(k);
  cudaError_t err = cudaFuncSetAttribute(
      topk_chunks_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem1));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid1((nq + kTQ - 1) / kTQ, chunks);
  topk_chunks_kernel<<<grid1, kThreads, smem1, s>>>(
      static_cast<const float*>(queries), static_cast<const float*>(store),
      static_cast<const float*>(after_s), static_cast<const int*>(after_i), ld,
      static_cast<float*>(part_s), static_cast<int*>(part_i), nq, n, d, k, rows_per_chunk,
      chunks);
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
