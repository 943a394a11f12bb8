// C[M,N] = A[M,K] . W[K,N] + bias[N], then an optional quick-GELU
// (x * sigmoid(1.702 x)), then an optional + R[M,N] residual.
// A, W, R, C bf16; bias f32; accumulation and the epilogue in f32.
//
// Replaces: the four projections inside dclip_tpu/kernels/vit_block.py
//   `_attn_kernel` (QKV at lines 56-58, out_proj + residual at 91-93) and
//   `_mlp_kernel` (fc1 + GELU at 101-103, fc2 + residual at 104-106). On
//   the TPU each program keeps the whole weight matrix resident in VMEM
//   (4.7 MB / 9.4 MB); a Hopper block has at most 227 KB of shared memory,
//   so here the weights stream through shared memory in tiles.
// Bound on the H100: tensor-core throughput. At the serving bucket of 64
//   images M = 12,608 rows, and fc1 (K=768, N=3072) does 2*M*K*N flops
//   over 2*(M*K + K*N + M*N) bytes, ~590 flop/byte, above the ~295 ridge.
// Design: 128x128 output tile per block of 8 warps (2 x 4, each warp a
//   64x32 tile of 4x2 WMMA bf16 m16n16k16 fragments), K walked in steps of
//   32 through a 3-stage cp.async ring so the next tiles load while the
//   tensor cores run. M and N edges are masked by zero-filled loads and
//   guarded stores (M = 197 * batch is ragged); K must be a multiple of 32
//   and N of 8. The epilogue stages each fragment through a per-warp 16x16
//   f32 scratch and writes 16-byte bf16 vectors. wgmma + TMA are later work.
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

__global__ void __launch_bounds__(kThreads)
    gemm_bias_act_residual_kernel(const __nv_bfloat16* __restrict__ a,
                                  const __nv_bfloat16* __restrict__ w,
                                  const float* __restrict__ bias,
                                  const __nv_bfloat16* __restrict__ r,
                                  __nv_bfloat16* __restrict__ c, int m, int n,
                                  int k, int gelu) {
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

  // Epilogue: fragment -> per-warp f32 scratch -> bias, GELU, residual ->
  // one 16-byte bf16 store per lane (lane covers row lane/2, 8 columns).
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
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          v[e] = sw[er * 16 + ec + e] + bias[gn + e];
          if (gelu) v[e] = v[e] / (1.f + expf(-1.702f * v[e]));
        }
        const size_t off = static_cast<size_t>(gm) * n + gn;
        if (r != nullptr) {
          float rv[8];
          dclip::unpack8(*reinterpret_cast<const uint4*>(r + off), rv);
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] += rv[e];
        }
        *reinterpret_cast<uint4*>(c + off) = dclip::pack8(v);
      }
      __syncwarp();
    }
  }
}

}  // namespace

// a: [m, k], w: [k, n], r (optional, may be null) and c: [m, n], all bf16
// row-major and 16-byte aligned; bias: [n] f32. k % 32 == 0, n % 8 == 0.
extern "C" int dclip_gemm_bias_act_residual_bf16(const void* a, const void* w,
                                                 const void* bias, const void* r,
                                                 void* c, int m, int n, int k,
                                                 int gelu, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(gemm_bias_act_residual_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  gemm_bias_act_residual_kernel<<<grid, kThreads, kSmemBytes,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(bias), static_cast<const __nv_bfloat16*>(r),
      static_cast<__nv_bfloat16*>(c), m, n, k, gelu);
  return static_cast<int>(cudaGetLastError());
}
