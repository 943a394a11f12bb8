// C[M,N] = epilogue(A[M,K] . W[K,N] + bias[N]) [+ R[M,N]], with the
// epilogue one of: none; quick-GELU (x * sigmoid(1.702 x)), optionally
// saving the pre-activation to AUX[M,N]; or a multiply by quick-GELU's
// derivative at AUX[M,N] (the frozen-MLP backward). A, W, R, AUX bf16;
// bias f32 or absent; C bf16 or f32; accumulation and the epilogue in f32.
// Three operand modes, one template each:
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
//   `_attn_kernel` (QKV at lines 56-58, out_proj + residual at 91-93) and
//   `_mlp_kernel` (fc1 + GELU at 101-103, fc2 + residual at 104-106). On
//   the TPU each program keeps the whole weight matrix resident in VMEM
//   (4.7 MB / 9.4 MB); a Hopper block has at most 227 KB of shared memory,
//   so here the weights stream through shared memory in tiles. Also the
//   four GEMMs of dclip_tpu/kernels/mlp_frozen.py (K6): `_fwd_save_kernel`
//   (line 135: fc1 with the pre-activation a1 saved beside the GELU
//   output, then fc2 + residual) and `_bwd_dx_kernel` (line 159:
//   g W2^T times quick-GELU'(a1), then da1 W1^T into f32 for the
//   LayerNorm backward of layernorm.cu). The TPU keeps a1's chunks and the
//   f32 intermediates in VMEM; here each GEMM writes its [M, N] output once.
//   The NT and TN modes serve the trainable blocks: the products of
//   dclip_tpu/kernels/mlp_trainable.py `_bwd_a_kernel` / `_bwd_b_kernel`
//   (K8; dW2 = gelu(a1)^T g at line 107, dW1 = h^T da1 at line 161, which
//   the TPU accumulates in VMEM across its sequential batch grid) and
//   attn_block_trainable.py `_fwd_kernel` (K9; QKV at lines 86-88,
//   out_proj at 119) with its VJP's weight gradients (lines 240, 266).
// Bound on the H100: tensor-core throughput. At the serving bucket of 64
//   images M = 12,608 rows, and fc1 (K=768, N=3072) does 2*M*K*N flops
//   over 2*(M*K + K*N + M*N) bytes, ~590 flop/byte, above the ~295 ridge.
//   A weight gradient reduces over M = 50,432 vision rows into only 36-108
//   output tiles of 128 x 128, fewer than the 132 SMs: hence the split.
// Design: 128x128 output tile per block of 8 warps (2 x 4, each warp a
//   64x32 tile of 4x2 WMMA bf16 m16n16k16 fragments), K walked in steps of
//   32 through a 3-stage cp.async ring so the next tiles load while the
//   tensor cores run. An operand whose K runs along its rows in memory
//   (A in NN / NT, W in NT) is staged [128][32 + 8]; one whose K runs down
//   its columns (W in NN / TN, X in TN) is staged [32][128 + 8], and its
//   WMMA fragment is read column-major where the product wants the
//   transpose. M, N and (in TN) K edges are masked by zero-filled loads
//   and guarded stores (M = 197 * batch is ragged); NN and NT need K % 32
//   == 0, every mode N % 8 == 0 and TN M % 8 == 0. The epilogue stages
//   each fragment through a per-warp 16x16 f32 scratch and writes 16-byte
//   bf16 vectors (or two 16-byte f32 vectors). For K6's forward the GELU
//   output and a1 are both written (2 x M x mlp bf16, 2 x 310 MB per layer
//   at 256 images): applying GELU to A as fc2 loads it would write a1
//   only, but recompute the GELU once per N-tile of fc2 (6 times at N =
//   768) inside the GEMM's main loop; the extra store is the cheaper of
//   the two. wgmma + TMA are later work.
#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int kBM = 128, kBN = 128, kBK = 32, kStages = 3;
constexpr int kThreads = 256;
constexpr int kWarpM = 64, kWarpN = 32;
constexpr int kFragM = kWarpM / 16, kFragN = kWarpN / 16;
// Padded rows (fewer bank conflicts, 32-byte aligned fragments).
constexpr int kKLd = kBK + 8;   // a [128][32] tile, K along the row
constexpr int kMNLd = kBN + 8;  // a [32][128] tile, K down the column
constexpr int kStage = kBM * kKLd;  // bf16 elements; >= kBK * kMNLd, so either layout fits
constexpr int kSmemBytes = kStages * 2 * kStage * 2 + (kThreads / 32) * 16 * 16 * 4;

constexpr int kModeNN = 0, kModeNT = 1, kModeTN = 2;
constexpr int kEpiNone = 0, kEpiGelu = 1, kEpiDgelu = 2;

// Rows [r0, r0 + 128) x columns [k0, k0 + 32) of a row-major [rows, kdim]
// matrix into a [128][kKLd] tile; out-of-range 8-column chunks are zero.
__device__ __forceinline__ void load_rows_k(const __nv_bfloat16* __restrict__ src,
                                            __nv_bfloat16* dst, int r0, int rows, int k0,
                                            int kdim) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int row = c >> 2, col = (c & 3) * 8;
    const bool ok = r0 + row < rows && k0 + col < kdim;
    const __nv_bfloat16* p = ok ? src + static_cast<size_t>(r0 + row) * kdim + k0 + col : src;
    dclip::cp_async_16(dst + row * kKLd + col, p, ok);
  }
}

// Rows [k0, k0 + 32) x columns [c0, c0 + 128) of a row-major [kdim, cols]
// matrix into a [32][kMNLd] tile; out-of-range chunks are zero.
__device__ __forceinline__ void load_k_cols(const __nv_bfloat16* __restrict__ src,
                                            __nv_bfloat16* dst, int k0, int kdim, int c0,
                                            int cols) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int row = c >> 4, col = (c & 15) * 8;
    const bool ok = k0 + row < kdim && c0 + col < cols;
    const __nv_bfloat16* p = ok ? src + static_cast<size_t>(k0 + row) * cols + c0 + col : src;
    dclip::cp_async_16(dst + row * kMNLd + col, p, ok);
  }
}

template <int kMode>
__device__ __forceinline__ void load_stage(const __nv_bfloat16* __restrict__ a,
                                           const __nv_bfloat16* __restrict__ w,
                                           __nv_bfloat16* sa, __nv_bfloat16* sb, int m0, int n0,
                                           int k0, int m, int n, int k) {
  if constexpr (kMode == kModeTN) {
    load_k_cols(a, sa, k0, k, m0, m);  // X [K, M]
  } else {
    load_rows_k(a, sa, m0, m, k0, k);  // A [M, K]
  }
  if constexpr (kMode == kModeNT) {
    load_rows_k(w, sb, n0, n, k0, k);  // W [N, K]
  } else {
    load_k_cols(w, sb, k0, k, n0, n);  // W [K, N]
  }
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
    gemm_bias_act_residual_kernel(const __nv_bfloat16* __restrict__ a,
                                  const __nv_bfloat16* __restrict__ w,
                                  const float* __restrict__ bias,
                                  const __nv_bfloat16* __restrict__ r,
                                  const __nv_bfloat16* __restrict__ aux_in,
                                  __nv_bfloat16* __restrict__ aux_out,
                                  void* __restrict__ c, int m, int n, int k, int epi,
                                  int out_f32, int k_tiles_per_split) {
  using LayoutA = std::conditional_t<kMode == kModeTN, wmma::col_major, wmma::row_major>;
  using LayoutB = std::conditional_t<kMode == kModeNT, wmma::col_major, wmma::row_major>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sa = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sb = sa + kStages * kStage;
  float* scratch = reinterpret_cast<float*>(sb + kStages * kStage);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warp_m = warp / 4, warp_n = warp % 4;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  // This block's share of the K tiles (all of them unless K is split).
  const int kt0 = blockIdx.z * k_tiles_per_split;
  const int kt1 = min((k + kBK - 1) / kBK, kt0 + k_tiles_per_split);
  const int ktiles = max(kt1 - kt0, 0);
  const size_t slice = static_cast<size_t>(blockIdx.z) * m * n;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kFragM][kFragN];
#pragma unroll
  for (int i = 0; i < kFragM; ++i)
#pragma unroll
    for (int j = 0; j < kFragN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles)
      load_stage<kMode>(a, w, sa + s * kStage, sb + s * kStage, m0, n0, (kt0 + s) * kBK, m, n,
                        k);
    dclip::cp_async_commit();
  }

  for (int kt = 0; kt < ktiles; ++kt) {
    dclip::cp_async_wait<kStages - 2>();
    __syncthreads();  // tile kt landed; every warp is done with tile kt-1
    const int next = kt + kStages - 1;
    if (next < ktiles) {
      const int s = next % kStages;
      load_stage<kMode>(a, w, sa + s * kStage, sb + s * kStage, m0, n0, (kt0 + next) * kBK, m,
                        n, k);
    }
    dclip::cp_async_commit();

    const __nv_bfloat16* ta = sa + (kt % kStages) * kStage;
    const __nv_bfloat16* tb = sb + (kt % kStages) * kStage;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, LayoutA> fa[kFragM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, LayoutB> fb[kFragN];
#pragma unroll
      for (int i = 0; i < kFragM; ++i) {
        const int row = warp_m * kWarpM + i * 16;
        if constexpr (kMode == kModeTN) {
          wmma::load_matrix_sync(fa[i], ta + kk * kMNLd + row, kMNLd);
        } else {
          wmma::load_matrix_sync(fa[i], ta + row * kKLd + kk, kKLd);
        }
      }
#pragma unroll
      for (int j = 0; j < kFragN; ++j) {
        const int col = warp_n * kWarpN + j * 16;
        if constexpr (kMode == kModeNT) {
          wmma::load_matrix_sync(fb[j], tb + col * kKLd + kk, kKLd);
        } else {
          wmma::load_matrix_sync(fb[j], tb + kk * kMNLd + col, kMNLd);
        }
      }
#pragma unroll
      for (int i = 0; i < kFragM; ++i)
#pragma unroll
        for (int j = 0; j < kFragN; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  dclip::cp_async_wait<0>();

  // Epilogue: fragment -> per-warp f32 scratch -> bias, activation,
  // residual -> one 16-byte bf16 store (or two f32 ones) per lane (lane
  // covers row lane/2, 8 columns).
  float* sw = scratch + warp * 256;
  const int er = lane >> 1, ec = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < kFragM; ++i) {
#pragma unroll
    for (int j = 0; j < kFragN; ++j) {
      wmma::store_matrix_sync(sw, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int gm = m0 + warp_m * kWarpM + i * 16 + er;
      const int gn = n0 + warp_n * kWarpN + j * 16 + ec;
      if (gm < m && gn < n) {
        const size_t off = static_cast<size_t>(gm) * n + gn;
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = sw[er * 16 + ec + e] + (bias ? bias[gn + e] : 0.f);
        if (aux_out != nullptr) *reinterpret_cast<uint4*>(aux_out + off) = dclip::pack8(v);
        if (epi == kEpiGelu) {
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = v[e] / (1.f + expf(-1.702f * v[e]));
        } else if (epi == kEpiDgelu) {
          float pre[8];
          dclip::unpack8(*reinterpret_cast<const uint4*>(aux_in + off), pre);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            // d/da quick_gelu(a) = s + 1.702 a s (1 - s), s = sigmoid(1.702 a)
            const float sg = 1.f / (1.f + expf(-1.702f * pre[e]));
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
          *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(c) + slice + off) =
              dclip::pack8(v);
        }
      }
      __syncwarp();
    }
  }
}

template <int kMode>
int launch(const void* a, const void* w, const void* bias, const void* r, const void* aux_in,
           void* aux_out, void* c, int m, int n, int k, int epi, int out_f32,
           int k_tiles_per_split, int splits, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(gemm_bias_act_residual_kernel<kMode>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM, splits);
  gemm_bias_act_residual_kernel<kMode><<<grid, kThreads, kSmemBytes,
                                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(bias), static_cast<const __nv_bfloat16*>(r),
      static_cast<const __nv_bfloat16*>(aux_in), static_cast<__nv_bfloat16*>(aux_out), c, m,
      n, k, epi, out_f32, k_tiles_per_split);
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
// k; split z takes K tiles (of 32 rows) [z * k_tiles_per_split, ...);
// c: [splits, m, n] f32 (the split partials, summed by
// dclip_reduce_rows_f32; with splits == 1, the product itself).
extern "C" int dclip_gemm_tn_bf16(const void* x, const void* y, void* c, int m, int n, int k,
                                  int k_tiles_per_split, int splits, void* stream) {
  return launch<kModeTN>(x, y, nullptr, nullptr, nullptr, nullptr, c, m, n, k, kEpiNone, 1,
                         k_tiles_per_split, splits, stream);
}
