// C[M,N] = epilogue(A[M,K] . W[K,N] + bias[N]) [+ R[M,N]], with the
// epilogue one of: none; quick-GELU (x * sigmoid(1.702 x)), optionally
// saving the pre-activation to AUX[M,N]; or a multiply by quick-GELU's
// derivative at AUX[M,N] (the frozen-MLP backward). A, W, R, AUX bf16;
// bias f32 or absent; C bf16 or f32; accumulation and the epilogue in f32.
// Three operand modes, one main loop:
//   NN  A [M,K] and W [K,N], both row-major (the layouts above);
//   NT  W given as [N,K] row-major, nn.Linear's [out, in]: C = A . W^T,
//       so a trainable weight needs one bf16 cast per step and no
//       transposed copy (the same copy serves the backward's NN product);
//   TN  the weight gradient C[M,N] = X^T . Y with X [K,M] and Y [K,N]
//       row-major: K is the B * S rows of the activations and may be
//       ragged. K is split over gridDim.z blocks, each writing its f32
//       partial C to slice z of a workspace; reduce.cu sums the slices in
//       order (no atomics: the result does not change from run to run).
//
// Replaces: the four projections inside dclip_tpu/kernels/vit_block.py
//   `_attn_kernel` (line 47: QKV, out_proj + residual) and `_mlp_kernel`
//   (line 96: fc1 + GELU, fc2 + residual). On the TPU each program keeps
//   the whole weight matrix resident in VMEM (4.7 MB / 9.4 MB); a Hopper
//   block has at most 227 KB of shared memory, so here the weights stream
//   through shared memory in tiles. Also the GEMMs of
//   dclip_tpu/kernels/mlp_frozen.py (K6): `_fwd_save_kernel` (line 135: fc1
//   with the pre-activation a1 saved beside the GELU output, then fc2 +
//   residual) and `_bwd_dx_kernel` (line 159: g W2^T times quick-GELU'(a1),
//   then da1 W1^T into f32 for the LayerNorm backward of layernorm.cu).
//   The NT and TN modes serve the trainable blocks: mlp_trainable.py
//   `_bwd_a_kernel` / `_bwd_b_kernel` (K8, lines 82 and 134: dW2 =
//   gelu(a1)^T g, dW1 = h^T da1, which the TPU accumulates in VMEM across
//   its sequential batch grid) and attn_block_trainable.py `_fwd_kernel`
//   (K9, line 78: QKV, out_proj) with its VJP's weight gradients (line
//   224); and the four projections of K10 (cross_attention.py:74).
// Bound on the H100: tensor-core throughput. At the serving bucket of 64
//   images M = 12,608 rows, and fc1 (K=768, N=3072) does 2*M*K*N flops
//   over 2*(M*K + K*N + M*N) bytes, ~590 flop/byte, above the ~295 ridge;
//   the teacher ViT over 2,048 crops (M = 403,456) does 68.5 TFLOP of
//   projections a step. Only wgmma reaches the card's bf16 rate, and only
//   if the operands arrive without costing the issuing threads anything.
//   A weight gradient reduces over M = 50,432 vision rows into only 36-108
//   output tiles of 128 x 128, fewer than the 132 SMs: hence the split.
// Design: a 128 x 128 output tile per block of two consumer warpgroups and
//   one producer warp. One producer thread keeps a ring of 3 shared-memory
//   stages filled with TMA loads (cp.async.bulk.tensor on CUtensorMaps passed
//   as __grid_constant__, 128-byte swizzle, K in steps of 64), each stage's
//   arrival counted in bytes on its "full" mbarrier; two consumer warpgroups,
//   64 rows each, issue wgmma.mma_async m64n128k16 from shared-memory
//   descriptors into f32 register accumulators, keep one wgmma group in flight
//   and hand each stage back on its "empty" mbarrier. Two blocks share an SM
//   (96 KB of shared memory and 96 registers a thread each, what ptxas allots
//   two 288-thread blocks), so that one block's prologue, pipeline fill and
//   epilogue overlap the other's main loop: at K = 768 a tile's main loop is
//   only 12 stages. (setmaxnreg, to move the producer's registers to the
//   consumers, is not used: ptxas compiles the block at its own register
//   count, below the launch bound, and an increase past what the producer
//   freed stalled the card.) wgmma reads 16-bit operands K-major or MN-major,
//   so the three modes differ only in their descriptors and tensor maps, with
//   no transposed copy: A is K-major in NN / NT and M-major in TN; W is
//   N-major in NN, K-major in NT, and Y N-major in TN. Ragged M (197 * batch
//   rows) and TN's ragged K come from TMA's zero fill out of bounds; stores
//   are guarded. NN and NT need K % 32 == 0 and every mode N % 8 == 0 (TN also
//   M % 8 == 0), which give TMA its 16-byte row strides; each operand's base
//   is 16-byte aligned (the wrappers check). The epilogue runs from the
//   accumulator registers: the residual or quick-GELU' tile is pulled into L2
//   while the main loop runs, a quad transpose gives each lane 8 consecutive
//   columns of a row, then bias, pre-activation save, activation (sigmoid by
//   one tanh.approx) and residual in f32 and one 16-byte bf16 store (or two
//   f32 ones). For K6's forward the GELU output and a1 are both written:
//   applying GELU to A as fc2 loads it would write a1 only, but recompute the
//   GELU once per N-tile of fc2; the extra store is the cheaper of the two.
//   Not yet: a persistent tile schedule (each tile's epilogue overlapping the
//   next one's loads), clusters with TMA multicast, the TN reduction inside a
//   cluster, fp8.
#include "common.cuh"
#include "sm90.cuh"

namespace {

using dclip::sm90::desc_add;
using dclip::sm90::desc_sw128;

constexpr int kBM = 128, kBN = 128, kBK = 64, kStages = 3;
constexpr int kConsumers = 2;                   // warpgroups, 64 rows each
constexpr int kThreads = kConsumers * 128 + 32;  // and one producer warp
constexpr int kBox = 64 * 64 * 2;               // one [64][64] bf16 TMA box, 8 KB
constexpr int kABytes = kBM * kBK * 2;          // 16 KB

constexpr int kModeNN = 0, kModeNT = 1, kModeTN = 2;
constexpr int kEpiNone = 0, kEpiGelu = 1, kEpiDgelu = 2;

constexpr int kStageBytes = kABytes + kBN * kBK * 2;
// The ring, 2 x kStages mbarriers, and slack to align the ring to 1 KB.
constexpr int kSmemBytes = kStages * kStageBytes + 2 * kStages * 8 + 1024;

// sigmoid(y) = (1 + tanh(y / 2)) / 2: one tanh.approx (a single MUFU
// operation, relative error ~2^-11) where expf and a division take three;
// the results are rounded to bf16 (2^-9) or feed a gradient.
__device__ __forceinline__ float sigmoid_fast(float y) {
  float t;
  asm("tanh.approx.f32 %0, %1;" : "=f"(t) : "f"(0.5f * y));
  return fmaf(0.5f, t, 0.5f);
}

// Columns gn .. gn + 7 of row gm; v holds the accumulator's values.
__device__ __forceinline__ void epilogue8(float* v, int gm, int gn, int m, int n,
                                          const float* __restrict__ bias,
                                          const __nv_bfloat16* __restrict__ r,
                                          const __nv_bfloat16* __restrict__ aux_in,
                                          __nv_bfloat16* __restrict__ aux_out, void* c,
                                          size_t slice, int epi, int out_f32) {
  if (gm >= m || gn >= n) return;
  const size_t off = static_cast<size_t>(gm) * n + gn;
  if (bias != nullptr) {
    const float4 b0 = *reinterpret_cast<const float4*>(bias + gn);
    const float4 b1 = *reinterpret_cast<const float4*>(bias + gn + 4);
    v[0] += b0.x; v[1] += b0.y; v[2] += b0.z; v[3] += b0.w;
    v[4] += b1.x; v[5] += b1.y; v[6] += b1.z; v[7] += b1.w;
  }
  if (aux_out != nullptr) *reinterpret_cast<uint4*>(aux_out + off) = dclip::pack8(v);
  if (epi == kEpiGelu) {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] *= sigmoid_fast(1.702f * v[e]);
  } else if (epi == kEpiDgelu) {
    float pre[8];
    dclip::unpack8(*reinterpret_cast<const uint4*>(aux_in + off), pre);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      // d/da quick_gelu(a) = s + 1.702 a s (1 - s), s = sigmoid(1.702 a)
      const float sg = sigmoid_fast(1.702f * pre[e]);
      v[e] *= sg + 1.702f * pre[e] * sg * (1.f - sg);
    }
  }
  if (r != nullptr) {
    float rv[8];
    dclip::unpack8(*reinterpret_cast<const uint4*>(r + off), rv);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] += rv[e];
  }
  if (out_f32) {
    float4* cf = reinterpret_cast<float4*>(static_cast<float*>(c) + slice + off);
    cf[0] = make_float4(v[0], v[1], v[2], v[3]);
    cf[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(c) + slice + off) = dclip::pack8(v);
  }
}

template <int kMode>
__global__ void __launch_bounds__(kThreads, 2)
    gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                const __grid_constant__ CUtensorMap map_b, const float* __restrict__ bias,
                const __nv_bfloat16* __restrict__ r, const __nv_bfloat16* __restrict__ aux_in,
                __nv_bfloat16* __restrict__ aux_out, void* __restrict__ c, int m, int n, int k,
                int epi, int out_f32, int k_tiles_per_split) {
  namespace sm = dclip::sm90;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = sm::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;

  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  // This block's share of the K tiles (all of them unless K is split).
  const int kt0 = blockIdx.z * k_tiles_per_split;
  const int kt1 = min((k + kBK - 1) / kBK, kt0 + k_tiles_per_split);
  const int ktiles = max(kt1 - kt0, 0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm::mbar_init(&full[s], 1);
      sm::mbar_init(&empty[s], kConsumers * 4);  // one arrival per consumer warp
    }
    sm::fence_barrier_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == kConsumers) {
    // Producer warp: one thread issues every load.
    if (threadIdx.x == kConsumers * 128) {
      sm::prefetch_tensormap(&map_a);
      sm::prefetch_tensormap(&map_b);
      for (int kt = 0; kt < ktiles; ++kt) {
        const int s = kt % kStages;
        sm::mbar_wait(&empty[s], ((kt / kStages) & 1) ^ 1);
        sm::mbar_expect_tx(&full[s], kStageBytes);
        unsigned char* sa = smem + s * kStageBytes;
        unsigned char* sb = sa + kABytes;
        const int kk = (kt0 + kt) * kBK;
        if constexpr (kMode == kModeTN) {
          // X [K, M]: two [64 K][64 M] boxes, one per consumer.
          sm::tma_load_2d(sa, &map_a, &full[s], m0, kk);
          sm::tma_load_2d(sa + kBox, &map_a, &full[s], m0 + 64, kk);
        } else {
          sm::tma_load_2d(sa, &map_a, &full[s], kk, m0);  // A [M, K]: [128 M][64 K]
        }
        if constexpr (kMode == kModeNT) {
          sm::tma_load_2d(sb, &map_b, &full[s], kk, n0);  // W [N, K]: [kBN N][64 K]
        } else {
#pragma unroll
          for (int i = 0; i < kBN / 64; ++i)  // W / Y [K, N]: [64 K][64 N] boxes
            sm::tma_load_2d(sb + i * kBox, &map_b, &full[s], n0 + 64 * i, kk);
        }
      }
    }
  } else {
    // The epilogue's residual / quick-GELU' operand tile, 128 rows of two
    // 128-byte lines, pulled into L2 while the main loop runs.
    if (r != nullptr || aux_in != nullptr) {
      const int pr = m0 + threadIdx.x / 2, pc = n0 + (threadIdx.x & 1) * 64;
      if (pr < m && pc < n) {
        const size_t off = static_cast<size_t>(pr) * n + pc;
        sm::prefetch_l2(r != nullptr ? r + off : aux_in + off);
        if (r != nullptr && aux_in != nullptr) sm::prefetch_l2(aux_in + off);
      }
    }
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;

    constexpr int kTransA = kMode == kModeTN ? 1 : 0;
    constexpr int kTransB = kMode == kModeNT ? 0 : 1;
    // Per k16 step: K-major operands move 32 bytes along their rows,
    // MN-major ones 16 rows of 128 bytes.
    constexpr uint32_t kStepA = kTransA ? 2048 : 32, kStepB = kTransB ? 2048 : 32;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x & 31;
    for (int kt = 0; kt < ktiles; ++kt) {
      const int s = kt % kStages;
      sm::mbar_wait(&full[s], (kt / kStages) & 1);
      const unsigned char* sa = smem + s * kStageBytes;
      const unsigned char* sb = sa + kABytes;
      // This warpgroup's 64 rows: 64 rows of 128 bytes (K-major) or the
      // [64 K][64 M] box of its columns (M-major); both 8 KB in.
      const uint64_t da = desc_sw128(sa + wg * kBox, 16, 1024);
      // The 128 columns of B: 128 rows of 128 bytes (K-major), or two
      // [64 K][64 N] boxes 8 KB apart (N-major, the LBO).
      const uint64_t db = desc_sw128(sb, kTransB ? kBox : 16, 1024);
      sm::fence_regs(acc);
      sm::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        sm::wgmma_m64n128k16_ss<kTransA, kTransB>(acc, desc_add(da, kk * kStepA),
                                                  desc_add(db, kk * kStepB), 1);
      sm::wgmma_commit();
      sm::fence_regs(acc);
      // Keep this step's group in flight; the previous one is done, so
      // its stage goes back to the producer.
      sm::wgmma_wait<1>();
      if (kt > 0 && lane == 0) sm::mbar_arrive(&empty[(kt - 1) % kStages]);
    }
    sm::wgmma_wait<0>();
    sm::fence_regs(acc);

    // Epilogue: 8 consecutive columns of one row per lane and store.
    const size_t slice = static_cast<size_t>(blockIdx.z) * m * n;
    const int row = m0 + wg * 64 + warp * 16 + (lane >> 2);
#pragma unroll
    for (int g0 = 0; g0 < 16; g0 += 4) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float v[8];
        sm::quad_gather8(acc, g0, half, v);
        const int col = n0 + (g0 + (lane & 3)) * 8;
        epilogue8(v, row + 8 * half, col, m, n, bias, r, aux_in, aux_out, c, slice, epi,
                  out_f32);
      }
    }
  }
}

// cuTensorMapEncodeTiled is a driver-API function; it is reached through
// the runtime's entry-point query, so the library links without -lcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
        cudaSuccess)
      return nullptr;
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiledFn>(p) : nullptr;
  }();
  return fn;
}

// A row-major bf16 [rows, cols] matrix read in [box_rows][box_cols] boxes
// with 128-byte swizzle (box_cols = 64: one 128-byte row).
bool encode(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kMode>
int launch(const void* a, const void* w, const void* bias, const void* r, const void* aux_in,
           void* aux_out, void* c, int m, int n, int k, int epi, int out_f32,
           int k_tiles_per_split, int splits, void* stream) {
  // A runtime call first: it makes the device's primary context current in
  // this host thread, which the driver's tensor-map encode needs. A thread
  // that has made no runtime call yet (autograd's backward worker, when a
  // GEMM is its first CUDA work) has none, and the encode would fail.
  cudaError_t err = cudaFuncSetAttribute(gemm_kernel<kMode>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap map_a, map_b;
  const bool ok =
      (kMode == kModeTN ? encode(&map_a, a, k, m, 64) : encode(&map_a, a, m, k, kBM)) &&
      (kMode == kModeNT ? encode(&map_b, w, n, k, kBN) : encode(&map_b, w, k, n, 64));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM, splits);
  gemm_kernel<kMode><<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      map_a, map_b, static_cast<const float*>(bias), static_cast<const __nv_bfloat16*>(r),
      static_cast<const __nv_bfloat16*>(aux_in), static_cast<__nv_bfloat16*>(aux_out), c, m, n,
      k, epi, out_f32, k_tiles_per_split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a: [m, k], w: [k, n], r / aux_in / aux_out (each optional, may be null)
// [m, n], all bf16 row-major and 16-byte aligned; bias: [n] f32 or null;
// c: [m, n], f32 when out_f32 else bf16. k % 32 == 0, n % 8 == 0.
// epi: 0 none, 1 quick-GELU (aux_out, when given, receives the
// pre-activation), 2 times quick-GELU'(aux_in).
extern "C" int dclip_gemm_bf16(const void* a, const void* w, const void* bias,
                               const void* r, const void* aux_in, void* aux_out, void* c,
                               int m, int n, int k, int epi, int out_f32, void* stream) {
  return launch<kModeNN>(a, w, bias, r, aux_in, aux_out, c, m, n, k, epi, out_f32,
                         (k + kBK - 1) / kBK, 1, stream);
}

// The same with w given as [n, k] row-major (c = a . w^T).
extern "C" int dclip_gemm_nt_bf16(const void* a, const void* w, const void* bias,
                                  const void* r, const void* aux_in, void* aux_out, void* c,
                                  int m, int n, int k, int epi, int out_f32, void* stream) {
  return launch<kModeNT>(a, w, bias, r, aux_in, aux_out, c, m, n, k, epi, out_f32,
                         (k + kBK - 1) / kBK, 1, stream);
}

// c[z] = x[rows of split z]^T . y[rows of split z] for z < splits: x [k, m]
// and y [k, n] bf16 row-major, 16-byte aligned, m % 8 == 0, n % 8 == 0, any
// k; split z takes K tiles (of 64 rows) [z * k_tiles_per_split, ...);
// c: [splits, m, n] f32 (the split partials, summed by
// dclip_reduce_rows_f32; with splits == 1, the product itself).
extern "C" int dclip_gemm_tn_bf16(const void* x, const void* y, void* c, int m, int n, int k,
                                  int k_tiles_per_split, int splits, void* stream) {
  return launch<kModeTN>(x, y, nullptr, nullptr, nullptr, nullptr, c, m, n, k, kEpiNone, 1,
                         k_tiles_per_split, splits, stream);
}
