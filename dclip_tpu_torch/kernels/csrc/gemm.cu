// C[M,N] = epilogue(A[M,K] . W[K,N] + bias[N]) [+ R[M,N]], with the
// epilogue one of: none; quick-GELU (x * sigmoid(1.702 x)), optionally
// saving the pre-activation to AUX[M,N]; or a multiply by quick-GELU's
// derivative at AUX[M,N] (the frozen-MLP backward). A, W, R, AUX bf16;
// bias f32 or absent; C bf16 or f32; accumulation and the epilogue in f32.
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
// Bound on the H100: tensor-core throughput. At the serving bucket of 64
//   images M = 12,608 rows, and fc1 (K=768, N=3072) does 2*M*K*N flops
//   over 2*(M*K + K*N + M*N) bytes, ~590 flop/byte, above the ~295 ridge.
// Design: 128x128 output tile per block of 8 warps (2 x 4, each warp a
//   64x32 tile of 4x2 WMMA bf16 m16n16k16 fragments), K walked in steps of
//   32 through a 3-stage cp.async ring so the next tiles load while the
//   tensor cores run. M and N edges are masked by zero-filled loads and
//   guarded stores (M = 197 * batch is ragged); K must be a multiple of 32
//   and N of 8. The epilogue stages each fragment through a per-warp 16x16
//   f32 scratch and writes 16-byte bf16 vectors (or two 16-byte f32
//   vectors). For K6's forward the GELU output and a1 are both written
//   (2 x M x mlp bf16, 2 x 310 MB per layer at 256 images): applying GELU
//   to A as fc2 loads it would write a1 only, but recompute the GELU once
//   per N-tile of fc2 (6 times at N = 768) inside the GEMM's main loop;
//   the extra store is the cheaper of the two. wgmma + TMA are later work.
#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int kBM = 128, kBN = 128, kBK = 32, kStages = 3;
constexpr int kThreads = 256;
constexpr int kWarpM = 64, kWarpN = 32;
constexpr int kFragM = kWarpM / 16, kFragN = kWarpN / 16;
constexpr int kALd = kBK + 8;  // padded rows: fewer bank conflicts, 32 B aligned frags
constexpr int kBLd = kBN + 8;
constexpr int kAStage = kBM * kALd;  // bf16 elements
constexpr int kBStage = kBK * kBLd;
constexpr int kSmemBytes =
    kStages * (kAStage + kBStage) * 2 + (kThreads / 32) * 16 * 16 * 4;

__device__ __forceinline__ void load_tile(const __nv_bfloat16* __restrict__ a,
                                          const __nv_bfloat16* __restrict__ w,
                                          __nv_bfloat16* sa, __nv_bfloat16* sb,
                                          int m0, int n0, int k0, int m, int n,
                                          int k) {
  // A tile: 128 rows x 32 cols = 512 chunks of 8; W tile: 32 x 128 = 512.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int row = c >> 2, col = (c & 3) * 8;
    const bool ok = m0 + row < m;
    const __nv_bfloat16* src = a + static_cast<size_t>(ok ? m0 + row : 0) * k + k0 + col;
    dclip::cp_async_16(sa + row * kALd + col, src, ok);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int row = c >> 4, col = (c & 15) * 8;
    const bool ok = n0 + col < n;
    const __nv_bfloat16* src = w + static_cast<size_t>(k0 + row) * n + (ok ? n0 + col : 0);
    dclip::cp_async_16(sb + row * kBLd + col, src, ok);
  }
}

constexpr int kEpiNone = 0, kEpiGelu = 1, kEpiDgelu = 2;

__global__ void __launch_bounds__(kThreads)
    gemm_bias_act_residual_kernel(const __nv_bfloat16* __restrict__ a,
                                  const __nv_bfloat16* __restrict__ w,
                                  const float* __restrict__ bias,
                                  const __nv_bfloat16* __restrict__ r,
                                  const __nv_bfloat16* __restrict__ aux_in,
                                  __nv_bfloat16* __restrict__ aux_out,
                                  void* __restrict__ c, int m, int n, int k, int epi,
                                  int out_f32) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sa = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sb = sa + kStages * kAStage;
  float* scratch = reinterpret_cast<float*>(sb + kStages * kBStage);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warp_m = warp / 4, warp_n = warp % 4;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int ktiles = k / kBK;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kFragM][kFragN];
#pragma unroll
  for (int i = 0; i < kFragM; ++i)
#pragma unroll
    for (int j = 0; j < kFragN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles)
      load_tile(a, w, sa + s * kAStage, sb + s * kBStage, m0, n0, s * kBK, m, n, k);
    dclip::cp_async_commit();
  }

  for (int kt = 0; kt < ktiles; ++kt) {
    dclip::cp_async_wait<kStages - 2>();
    __syncthreads();  // tile kt landed; every warp is done with tile kt-1
    const int next = kt + kStages - 1;
    if (next < ktiles) {
      const int s = next % kStages;
      load_tile(a, w, sa + s * kAStage, sb + s * kBStage, m0, n0, next * kBK, m, n, k);
    }
    dclip::cp_async_commit();

    const __nv_bfloat16* ta = sa + (kt % kStages) * kAStage;
    const __nv_bfloat16* tb = sb + (kt % kStages) * kBStage;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[kFragM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[kFragN];
#pragma unroll
      for (int i = 0; i < kFragM; ++i)
        wmma::load_matrix_sync(fa[i], ta + (warp_m * kWarpM + i * 16) * kALd + kk, kALd);
#pragma unroll
      for (int j = 0; j < kFragN; ++j)
        wmma::load_matrix_sync(fb[j], tb + kk * kBLd + warp_n * kWarpN + j * 16, kBLd);
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
          float4* cf = reinterpret_cast<float4*>(static_cast<float*>(c) + off);
          cf[0] = make_float4(v[0], v[1], v[2], v[3]);
          cf[1] = make_float4(v[4], v[5], v[6], v[7]);
        } else {
          *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(c) + off) = dclip::pack8(v);
        }
      }
      __syncwarp();
    }
  }
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
  cudaError_t err = cudaFuncSetAttribute(gemm_bias_act_residual_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  gemm_bias_act_residual_kernel<<<grid, kThreads, kSmemBytes,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(bias), static_cast<const __nv_bfloat16*>(r),
      static_cast<const __nv_bfloat16*>(aux_in), static_cast<__nv_bfloat16*>(aux_out), c, m,
      n, k, epi, out_f32);
  return static_cast<int>(cudaGetLastError());
}
