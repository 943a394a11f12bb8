// C[M,N] = epilogue(A[M,K] . W[K,N] + bias[N]) [+ R[M,N]], with the
// epilogue one of: none; quick-GELU (x * sigmoid(1.702 x)) or tanh-GELU
// (0.5 x (1 + tanh(sqrt(2 / pi) (x + 0.044715 x^3))), SigLIP's), optionally
// saving the pre-activation to AUX[M,N]; or a multiply by that GELU's
// derivative at AUX[M,N] (the frozen-MLP backward). A, W, R, AUX bf16;
// bias f32 or absent; C bf16 or f32; accumulation and the epilogue in f32.
// Three operand modes:
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
// Design, NN / NT: a persistent, warp-specialised kernel. One 384-thread
//   block per SM (min(tiles, SMs) of them) walks the output tiles t =
//   blockIdx.x, + gridDim.x, ... in row-major order (the column tiles of one
//   row block together, so that the blocks running at one time read the same
//   rows of A, from L2 after the first read). Its producer warpgroup drops to
//   40 registers (setmaxnreg) and one of its threads keeps a ring of TMA
//   stages full (cp.async.bulk.tensor on CUtensorMaps passed as
//   __grid_constant__, 128-byte swizzle, K in steps of 64), each stage's
//   arrival counted in bytes on its "full" mbarrier, across tile boundaries;
//   the two consumer warpgroups rise to 232 registers (128 x 40 + 256 x 232
//   = 64,512 of the 65,536) and issue wgmma.mma_async from shared-memory
//   descriptors into f32 register accumulators, one group in flight, handing
//   each stage back on its "empty" mbarrier. Two schedules, chosen by the
//   wrapper from M, N and the SM count (`gemm_tile_n`):
//   wide    128 x 256 tiles, cooperative: each consumer warpgroup owns 64
//           rows (m64n256k16, 128 accumulators a thread) and both release
//           every stage; a 4-stage ring of 48 KB (3 with a staged operand,
//           below). At the region encode's and K6's row counts.
//   narrow  128 x 128 tiles, ping-pong: each consumer warpgroup owns whole
//           tiles (two m64n128k16, 128 accumulators), the block's tiles
//           alternating between the two, so that one's epilogue runs while
//           the other issues wgmma; a 6-stage ring of 32 KB (5). A
//           warpgroup skips the other's ring positions and an mbarrier's
//           parity tells only two phases apart, so the warpgroups take turns
//           by named barriers: one starts a tile's main loop once the other
//           has passed every stage of its tile (after its last wgmma_wait:
//           the second's wgmma groups would otherwise hold the first's last
//           one). Measured beside the wide schedule at the region encode
//           (45-61% of peak against 64-71%) and the cooperative 128 x 128
//           tile at the small shapes (3-5% slower): each is kept where it
//           is the faster.
//   The epilogue runs on the accumulator fragment as it lies (each lane
//   holds column pairs of two rows): bias, pre-activation, activation
//   (sigmoid by one tanh.approx) and residual in f32, then bf16x2 or f32x2
//   into a warpgroup's 128-byte-swizzled staging buffers with conflict-free
//   st.shared, stored by TMA ([64 rows][128 bytes] boxes, asynchronous, whole
//   lines) a sub-tile at a time; the buffers alternate so that one store
//   drains while the next sub-tile is written. Ragged M, N and K come from
//   TMA's zero fill on loads and its clipping on stores. Each epilogue form
//   the main path runs (bias; bias + residual; bias + quick-GELU, with or
//   without the pre-activation; quick-GELU'; f32 out, with or without bias;
//   none) is a kernel of its own whose epilogue holds only its own
//   arithmetic: an epilogue carrying every form's branches, unrolled over a
//   tile, ran from instruction-cache misses at ~145 cycles a column pair
//   (clock64 inside the kernel). The other forms share one kernel that reads
//   the form from its arguments. The residual or quick-GELU' operand is
//   loaded by TMA into the staging area half way through the main loop and
//   each output pair overwrites its own operand pair (the other forms'
//   operand goes to registers at the tile's start).
// Design, TN: the weight gradient keeps its non-persistent kernel: a 128 x
//   128 tile per block of two consumer warpgroups and one producer warp, a
//   3-stage ring, two blocks an SM, K split over gridDim.z.
// Every mode: wgmma reads 16-bit operands K-major or MN-major, so the modes
//   differ only in their descriptors and tensor maps, with no transposed
//   copy: A is K-major in NN / NT and M-major in TN; W is N-major in NN,
//   K-major in NT, and Y N-major in TN. Every mode needs K % 8 == 0 and N %
//   8 == 0 (TN also M % 8 == 0), which give TMA its 16-byte row strides; a
//   ragged last K step (SigLIP's fc2 and dx at K = 4,304, 16 past the last
//   whole 64) reads TMA's zero fill in both operands. Each operand's base is
//   16-byte aligned (the wrappers check).
//   For K6's forward the GELU output and a1 are both written: applying GELU
//   to A as fc2 loads it would write a1 only, but recompute the GELU once per
//   N-tile of fc2; the extra store is the cheaper of the two.
// What bounds it now: the wide main loop issues at ~98% of the tensor cores
//   (clock64 over a tile) and reaches ~78% of peak with its epilogue
//   skipped, the ring's 48 KB a stage from L2 the limit of a schedule that
//   loads each tile's operands alone; the epilogue, not overlapped in the
//   cooperative schedule, takes the rest: 64-71% of peak at the region
//   encode's qkv, fc1 and fc2, 53-61% with the residual, 49-53% with
//   quick-GELU' (H100 SXM, chip_smoke.py's GEMM phase).
// Not yet: clusters with TMA multicast (half the ring's L2 traffic), the TN
//   mode on the persistent schedule with its reduction inside a cluster,
//   fp8.
#include "common.cuh"
#include "sm90.cuh"

namespace {

using dclip::sm90::desc_add;
using dclip::sm90::desc_sw128;

constexpr int kBK = 64;
constexpr int kBox = 64 * 64 * 2;  // one [64][64] bf16 TMA box, 8 KB

constexpr int kModeNN = 0, kModeNT = 1;
// The wrapper's `epi` (0: none): quick-GELU, its derivative; tanh-GELU, its
// derivative.
constexpr int kEpiGelu = 1, kEpiDgelu = 2, kEpiGeluTanh = 3, kEpiDgeluTanh = 4;

// sigmoid(y) = (1 + tanh(y / 2)) / 2: one tanh.approx (a single MUFU
// operation, relative error ~2^-11) where expf and a division take three;
// the results are rounded to bf16 (2^-9) or feed a gradient.
__device__ __forceinline__ float sigmoid_fast(float y) {
  float t;
  asm("tanh.approx.f32 %0, %1;" : "=f"(t) : "f"(0.5f * y));
  return fmaf(0.5f, t, 0.5f);
}

// tanh-GELU as x sigmoid(2 u), u = sqrt(2 / pi) (x + 0.044715 x^3): the same
// one tanh.approx; and its derivative s + x s (1 - s) 2 u' with s = sigmoid(2
// u), 2 u' = 2 sqrt(2 / pi) (1 + 3 0.044715 x^2).
constexpr float kTwoRootTwoOverPi = 1.5957691216057308f;
__device__ __forceinline__ float gelu_tanh_fast(float x) {
  return x * sigmoid_fast(kTwoRootTwoOverPi * x * fmaf(0.044715f * x, x, 1.f));
}

__device__ __forceinline__ float gelu_tanh_grad_fast(float x) {
  const float s = sigmoid_fast(kTwoRootTwoOverPi * x * fmaf(0.044715f * x, x, 1.f));
  return fmaf(x * s * (1.f - s), kTwoRootTwoOverPi * fmaf(0.134145f * x, x, 1.f), s);
}

// -- NN / NT: the persistent, warp-specialised kernel -----------------------------

constexpr int kThreads = 384;  // two consumer warpgroups, then the producer's
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
// 168 a thread at launch (65,536 / 384, rounded down to 8): the producer
// gives back 128 x (168 - 40) = 16,384, the consumers take 256 x (232 -
// 168) = 16,384, and 128 x 40 + 256 x 232 = 64,512 <= 65,536.
static_assert(128 * kProducerRegs + 256 * kConsumerRegs <= 65536, "register file");
constexpr int kMaxSmem = 232448;  // a block's dynamic shared memory on sm_90

// kAtoms m64 row blocks a consumer warpgroup owns of each of its output
// tiles, kBN columns. Cooperative: both warpgroups share every tile (rows
// 0-63 and 64-127 of a 128-row tile) and release each stage together.
// Ping-pong: each warpgroup owns whole tiles, the block's tiles alternating
// between the two, so one's epilogue runs while the other issues wgmma.
// kSlots: [64 rows][128 bytes] buffers in a consumer warpgroup's staging
// area (4: its whole share of a tile in bf16, where the operand is staged).
template <int kAtoms, int kBN, bool kPingPong, int kSlots>
struct Schedule {
  static constexpr int kOutBytes = kSlots * kBox;
  static_assert(kSlots == 2 || kAtoms * kBN * 64 * 2 == kOutBytes, "a share fills 4 slots");
  static constexpr int kWgRows = 64 * kAtoms;
  static constexpr int kBM = kPingPong ? kWgRows : 2 * kWgRows;
  static constexpr int kABytes = kBM * kBK * 2;
  static constexpr int kStageBytes = kABytes + kBN * kBK * 2;
  static constexpr int kFit = (kMaxSmem - 2 * kOutBytes - 1024 - 256) / kStageBytes;
  static constexpr int kStages = kFit < 8 ? kFit : 8;
  static constexpr int kRingBytes = kStages * kStageBytes;
  static constexpr int kSmemBytes = kRingBytes + 2 * kOutBytes + (2 * kStages + 2) * 8 + 1024;
  static constexpr int kJobStride = kPingPong ? 2 : 1;  // a warpgroup's step through the jobs
  static constexpr int kReaders = kPingPong ? 4 : 8;    // warps that hand a stage back
};

// The epilogue's form, a set of these bits: each form the main path runs
// is a kernel of its own, whose epilogue holds only its own arithmetic (the
// epilogue is unrolled over the whole tile, and one that carried every
// form's code would outgrow the instruction cache: measured at ~145 cycles
// a pair); kAnyForm reads the form from the arguments and serves the rest.
// kOpTanh makes kOpGelu / kOpDgelu tanh-GELU's.
constexpr int kOpBias = 1, kOpGelu = 2, kOpDgelu = 4, kOpRes = 8, kOpPre = 16, kOpF32 = 32,
              kOpTanh = 64;
constexpr int kAnyForm = -1;

template <int kForm>
__device__ __forceinline__ bool has(int op, bool given) {
  return kForm == kAnyForm ? given : (kForm & op) != 0;
}

// The forms whose bf16 operand (the residual, or quick-GELU's
// pre-activation) TMA loads into the staging area, where each pair of the
// output then overwrites its own operand pair.
template <int kForm>
constexpr bool kStagedOperand =
    kForm == (kOpBias | kOpRes) || kForm == kOpDgelu || kForm == (kOpDgelu | kOpTanh);
template <int kForm>
constexpr int kSlotsOf = kStagedOperand<kForm> ? 4 : 2;

template <int kBN, int kTransB>
__device__ __forceinline__ void mma_k16(float (&d)[kBN / 2], uint64_t da, uint64_t db) {
  if constexpr (kBN == 256) {
    dclip::sm90::wgmma_m64n256k16_ss<0, kTransB>(d, da, db, 1);
  } else {
    dclip::sm90::wgmma_m64n128k16_ss<0, kTransB>(d, da, db, 1);
  }
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float2 unpack2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// The epilogue's bf16 operand at this thread's accumulator fragment of one
// warpgroup's 64 rows from gm0 (the other forms' path): a wgmma
// accumulator gives lane l of a warp, for each 8-column group g, the column
// pair 8 g + 2 (l % 4) + {0, 1} of rows l / 4 and l / 4 + 8 (d[4 g + 2 h +
// {0, 1}], h the row half); o[2 g + h] holds the same pair as bf16x2.
template <int kBN>
__device__ __forceinline__ void load_operand(uint32_t (&o)[kBN / 4],
                                             const __nv_bfloat16* __restrict__ src, int gm0,
                                             int n0, int m, int n) {
  const int tid = threadIdx.x % 128, q = tid & 3;
  const int row = gm0 + (tid / 32) * 16 + ((tid & 31) >> 2);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gm = row + 8 * h;
    const __nv_bfloat16* p = src + static_cast<size_t>(gm < m ? gm : 0) * n + n0 + 2 * q;
#pragma unroll
    for (int g = 0; g < kBN / 8; ++g)
      o[2 * g + h] =
          gm < m && n0 + 8 * g + 2 * q < n ? *reinterpret_cast<const uint32_t*>(p + 8 * g) : 0u;
  }
}

// One warpgroup's 64 rows from gm0 of an output tile: bias, pre-activation,
// activation and residual in f32 on the accumulator fragment, written pair
// by pair (bf16x2 or f32x2, conflict-free) into the staging area's
// 128-byte-swizzled buffers ([64 rows][64 bf16] or [64][32 f32]) and
// stored by TMA a sub-tile at a time. `i0` is this row block's first
// sub-tile in the tile; sub-tile i takes the slots from (i x slots a
// sub-tile) mod kSlots, waiting for their last store to have read them
// when it comes round again. (Rare forms go to global memory directly: a bf16
// pre-activation beside an f32 C, and a residual beside quick-GELU'.)
template <int kBN, int kForm, bool kF32>
__device__ __forceinline__ void store_rows(const float (&acc)[kBN / 2],
                                           const uint32_t (&opnd)[kBN / 4], int gm0, int n0,
                                           int m, int n, const float* __restrict__ bias,
                                           const __nv_bfloat16* __restrict__ r,
                                           const __nv_bfloat16* __restrict__ aux_in,
                                           __nv_bfloat16* __restrict__ aux_out, int epi,
                                           unsigned char* stage, const CUtensorMap* map_c,
                                           const CUtensorMap* map_pre, int bar, int i0) {
  namespace sm = dclip::sm90;
  constexpr int kSubCols = kF32 ? 32 : 64, kSubGroups = kSubCols / 8;
  constexpr bool kStaged = kStagedOperand<kForm>;
  constexpr int kSlots = kSlotsOf<kForm>;
  const bool with_bias = has<kForm>(kOpBias, bias != nullptr);
  const bool gelu = has<kForm>(kOpGelu, epi == kEpiGelu || epi == kEpiGeluTanh);
  const bool dgelu = has<kForm>(kOpDgelu, epi == kEpiDgelu || epi == kEpiDgeluTanh);
  const bool tanh_form = has<kForm>(kOpTanh, epi == kEpiGeluTanh || epi == kEpiDgeluTanh);
  const bool with_res = has<kForm>(kOpRes, r != nullptr);
  const bool with_pre = has<kForm>(kOpPre, aux_out != nullptr);
  const bool stage_pre = !kF32 && with_pre;
  const int tid = threadIdx.x % 128, q = tid & 3;
  const int rl0 = (tid / 32) * 16 + ((tid & 31) >> 2);
  const uint32_t stage_s = sm::smem_u32(stage);
#pragma unroll
  for (int st = 0; st < kBN / kSubCols; ++st) {
    const int i = i0 + st, nb = stage_pre ? 2 : 1, slot = i * nb % kSlots;
    if (i * nb >= kSlots) {
      // The slots come round again: the sub-tile that had them must have
      // been read out (the later sub-tiles' stores may still run).
      if (tid == 0) {
        if (stage_pre) {
          sm::bulk_wait_read<kSlots / 2 - 1>();
        } else {
          sm::bulk_wait_read<kSlots - 1>();
        }
      }
      sm::named_sync(bar, 128);
    }
    const uint32_t pre_s = stage_s + slot * kBox, out_s = pre_s + (stage_pre ? kBox : 0);
#pragma unroll
    for (int gl = 0; gl < kSubGroups; ++gl) {
      const int g = st * kSubGroups + gl, gn = n0 + 8 * g + 2 * q;
      float2 b = make_float2(0.f, 0.f);
      if (with_bias && gn < n) b = *reinterpret_cast<const float2*>(bias + gn);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rl = rl0 + 8 * h, gm = gm0 + rl;
        float v0 = acc[4 * g + 2 * h] + b.x, v1 = acc[4 * g + 2 * h + 1] + b.y;
        // This pair's place in a bf16 sub-tile: 16-byte chunk gl of row rl.
        const uint32_t at16 = rl * 128 + ((gl ^ (rl & 7)) << 4) + 4 * q;
        if (stage_pre) {
          sm::st_shared_b32(pre_s + at16, pack2(v0, v1));
        } else if (with_pre && gm < m && gn < n) {
          *reinterpret_cast<uint32_t*>(aux_out + static_cast<size_t>(gm) * n + gn) = pack2(v0, v1);
        }
        uint32_t op = 0;
        if (kStaged) {
          op = sm::ld_shared_b32(out_s + at16);
        } else if (dgelu || with_res) {
          op = opnd[2 * g + h];
        }
        if (gelu && tanh_form) {
          v0 = gelu_tanh_fast(v0);
          v1 = gelu_tanh_fast(v1);
        } else if (gelu) {
          v0 *= sigmoid_fast(1.702f * v0);
          v1 *= sigmoid_fast(1.702f * v1);
        } else if (dgelu && tanh_form) {
          const float2 a = unpack2(op);
          v0 *= gelu_tanh_grad_fast(a.x);
          v1 *= gelu_tanh_grad_fast(a.y);
        } else if (dgelu) {
          // d/da quick_gelu(a) = s + 1.702 a s (1 - s), s = sigmoid(1.702 a)
          const float2 a = unpack2(op);
          const float s0 = sigmoid_fast(1.702f * a.x), s1 = sigmoid_fast(1.702f * a.y);
          v0 *= s0 + 1.702f * a.x * s0 * (1.f - s0);
          v1 *= s1 + 1.702f * a.y * s1 * (1.f - s1);
        }
        if (with_res) {
          // The residual is the operand unless quick-GELU' took it.
          const float2 rv = unpack2(
              !dgelu ? op
              : gm < m && gn < n
                  ? *reinterpret_cast<const uint32_t*>(r + static_cast<size_t>(gm) * n + gn)
                  : 0u);
          v0 += rv.x;
          v1 += rv.y;
        }
        if constexpr (kF32) {
          // f32 columns 8 gl + 2 q, + 1: chunk 2 gl + q / 2, 8 bytes in for odd q.
          sm::st_shared_v2f32(
              out_s + rl * 128 + (((2 * gl + (q >> 1)) ^ (rl & 7)) << 4) + 8 * (q & 1), v0, v1);
        } else {
          sm::st_shared_b32(out_s + at16, pack2(v0, v1));
        }
      }
    }
    // The sub-tile is written: make it visible to the TMA unit and store.
    sm::fence_proxy_async();
    sm::named_sync(bar, 128);
    if (tid == 0) {
      sm::tma_store_2d(map_c, stage + (out_s - stage_s), n0 + kSubCols * st, gm0);
      if (stage_pre) sm::tma_store_2d(map_pre, stage + (pre_s - stage_s), n0 + kSubCols * st, gm0);
      sm::bulk_commit();
    }
  }
}

template <int kMode, int kAtoms, int kBN, bool kPingPong, int kForm>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_persistent_kernel(const __grid_constant__ CUtensorMap map_a,
                           const __grid_constant__ CUtensorMap map_b,
                           const __grid_constant__ CUtensorMap map_c,
                           const __grid_constant__ CUtensorMap map_pre,
                           const __grid_constant__ CUtensorMap map_op,
                           const float* __restrict__ bias, const __nv_bfloat16* __restrict__ r,
                           const __nv_bfloat16* __restrict__ aux_in,
                           __nv_bfloat16* __restrict__ aux_out, int m, int n, int k, int epi,
                           int out_f32) {
  namespace sm = dclip::sm90;
  using S = Schedule<kAtoms, kBN, kPingPong, kSlotsOf<kForm>>;
  constexpr bool kStaged = kStagedOperand<kForm>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = sm::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::kRingBytes + 2 * S::kOutBytes);
  uint64_t* empty = full + S::kStages;
  uint64_t* op_full = empty + S::kStages;  // a warpgroup's staged operand has landed

  // Tile t covers rows (t / tiles_n) * kBM and columns (t % tiles_n) * kBN:
  // the tiles of one row block are consecutive, so the blocks running at
  // one time read the same rows of A (from L2 after the first read).
  const int tiles_n = (n + kBN - 1) / kBN;
  const int tiles = (m + S::kBM - 1) / S::kBM * tiles_n;
  const int ktiles = (k + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      sm::mbar_init(&full[s], 1);
      sm::mbar_init(&empty[s], S::kReaders);
    }
    sm::mbar_init(&op_full[0], 1);
    sm::mbar_init(&op_full[1], 1);
    sm::fence_barrier_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == 2) {
    // Producer warpgroup: one thread walks the block's tiles (jobs j = 0,
    // 1, ... at t = blockIdx.x + j * gridDim.x) and their K steps in order,
    // one ring position after another.
    sm::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 256) {
      sm::prefetch_tensormap(&map_a);
      sm::prefetch_tensormap(&map_b);
      int pos = 0;
      for (int t = blockIdx.x; t < tiles; t += static_cast<int>(gridDim.x)) {
        const int m0 = t / tiles_n * S::kBM, n0 = t % tiles_n * kBN;
        for (int kt = 0; kt < ktiles; ++kt, ++pos) {
          const int s = pos % S::kStages;
          sm::mbar_wait(&empty[s], ((pos / S::kStages) & 1) ^ 1);
          sm::mbar_expect_tx(&full[s], S::kStageBytes);
          unsigned char* sa = smem + s * S::kStageBytes;
          unsigned char* sb = sa + S::kABytes;
          sm::tma_load_2d(sa, &map_a, &full[s], kt * kBK, m0);  // A [M, K]: [kBM M][64 K]
          if constexpr (kMode == kModeNT) {
            sm::tma_load_2d(sb, &map_b, &full[s], kt * kBK, n0);  // W [N, K]: [kBN N][64 K]
          } else {
#pragma unroll
            for (int i = 0; i < kBN / 64; ++i)  // W [K, N]: [64 K][64 N] boxes
              sm::tma_load_2d(sb + i * kBox, &map_b, &full[s], n0 + 64 * i, kt * kBK);
          }
        }
      }
    }
  } else {
    sm::setmaxnreg_inc<kConsumerRegs>();
    constexpr int kTransB = kMode == kModeNT ? 0 : 1;
    // Per k16 step: K-major operands move 32 bytes along their rows,
    // MN-major ones 16 rows of 128 bytes.
    constexpr uint32_t kStepB = kTransB ? 2048 : 32;
    const int lane = threadIdx.x & 31;
    const bool leader = threadIdx.x % 128 == 0;
    const int row0 = kPingPong ? 0 : wg * S::kWgRows;  // this warpgroup's rows of a tile
    const int block = blockIdx.x, blocks = gridDim.x;
    unsigned char* stage = smem + S::kRingBytes + wg * S::kOutBytes;
    if (leader) {
      sm::prefetch_tensormap(&map_c);
      if (has<kForm>(kOpPre, aux_out != nullptr)) sm::prefetch_tensormap(&map_pre);
      if (kStaged) sm::prefetch_tensormap(&map_op);
    }
    // The other forms' operand, read into registers: quick-GELU's
    // pre-activation, else the residual, else none.
    const __nv_bfloat16* operand =
        kStaged                                                          ? nullptr
        : has<kForm>(kOpDgelu, epi == kEpiDgelu || epi == kEpiDgeluTanh) ? aux_in
        : has<kForm>(kOpRes, r != nullptr)                               ? r
                                                                         : nullptr;
    float acc[kAtoms][kBN / 2];
    for (int j = kPingPong ? wg : 0, jt = 0; block + j * blocks < tiles;
         j += S::kJobStride, ++jt) {
      const int t = block + j * blocks;
      const int m0 = t / tiles_n * S::kBM, n0 = t % tiles_n * kBN;
      // Ping-pong: this warpgroup skips the other's ring positions, and an
      // mbarrier's parity tells only two phases apart, so it waits for a
      // tile's stages only once the other warpgroup has passed every stage
      // of the tile before (named barrier 1 + wg, 256 threads).
      if (kPingPong && j > 0) sm::named_sync(1 + wg, 256);
      // The other forms' operand, read into registers while the main loop
      // runs (the loads' unit is otherwise idle: TMA feeds the ring).
      uint32_t opnd[kAtoms][kBN / 4];
      if (operand != nullptr) {
#pragma unroll
        for (int a = 0; a < kAtoms; ++a)
          load_operand<kBN>(opnd[a], operand, m0 + row0 + a * 64, n0, m, n);
      }
#pragma unroll
      for (int a = 0; a < kAtoms; ++a)
#pragma unroll
        for (int i = 0; i < kBN / 2; ++i) acc[a][i] = 0.f;

      const int pos0 = j * ktiles;
      for (int kt = 0; kt < ktiles; ++kt) {
        const int pos = pos0 + kt, s = pos % S::kStages;
        sm::mbar_wait(&full[s], (pos / S::kStages) & 1);
        const unsigned char* sa = smem + s * S::kStageBytes + row0 * 128;
        // This warpgroup's rows of A: 128 bytes each (K-major), an atom of
        // 64 rows 8 KB on. B's kBN columns: kBN rows of 128 bytes (K-major),
        // or [64 K][64 N] boxes 8 KB apart (N-major, the LBO).
        const uint64_t da = desc_sw128(sa, 16, 1024);
        const uint64_t db = desc_sw128(smem + s * S::kStageBytes + S::kABytes,
                                       kTransB ? kBox : 16, 1024);
#pragma unroll
        for (int a = 0; a < kAtoms; ++a) sm::fence_regs(acc[a]);
        sm::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
          for (int a = 0; a < kAtoms; ++a)
            mma_k16<kBN, kTransB>(acc[a], desc_add(da, a * kBox + kk * 32),
                                  desc_add(db, kk * kStepB));
        sm::wgmma_commit();
#pragma unroll
        for (int a = 0; a < kAtoms; ++a) sm::fence_regs(acc[a]);
        // Keep this step's group in flight; the previous one is done, so
        // its stage goes back to the producer.
        sm::wgmma_wait<1>();
        if (kt > 0 && lane == 0) sm::mbar_arrive(&empty[(pos - 1) % S::kStages]);
        if (kStaged && leader && kt == ktiles / 2) {
          // The operand tile into the staging area, once the last tile's
          // stores have read it (half way through the main loop: they have
          // had the time, and the loads have the other half).
          sm::bulk_wait_read<0>();
          sm::mbar_expect_tx(&op_full[wg], S::kOutBytes);
#pragma unroll
          for (int a = 0; a < kAtoms; ++a)
#pragma unroll
            for (int c = 0; c < kBN / 64; ++c)
              sm::tma_load_2d(stage + (a * kBN / 64 + c) * kBox, &map_op, &op_full[wg],
                              n0 + 64 * c, m0 + row0 + 64 * a);
        }
      }
      sm::wgmma_wait<0>();
#pragma unroll
      for (int a = 0; a < kAtoms; ++a) sm::fence_regs(acc[a]);
      if (lane == 0) sm::mbar_arrive(&empty[(pos0 + ktiles - 1) % S::kStages]);
      // Ping-pong: the other warpgroup's next tile may start its main loop
      // (only now: its wgmma groups would otherwise hold this tile's last).
      if (kPingPong && t + blocks < tiles) sm::named_arrive(2 - wg, 256);
      if (kStaged) {
        sm::mbar_wait(&op_full[wg], jt & 1);
      } else {
        // The staging area is free once the last tile's stores have read it.
        if (leader) sm::bulk_wait_read<0>();
        sm::named_sync(3 + wg, 128);
      }
#pragma unroll
      for (int a = 0; a < kAtoms; ++a) {
        const int gm0 = m0 + row0 + a * 64;
        if (kForm == kAnyForm ? out_f32 != 0 : (kForm & kOpF32) != 0) {
          store_rows<kBN, kForm, true>(acc[a], opnd[a], gm0, n0, m, n, bias, r, aux_in, aux_out,
                                       epi, stage, &map_c, &map_pre, 3 + wg, a * kBN / 32);
        } else {
          store_rows<kBN, kForm, false>(acc[a], opnd[a], gm0, n0, m, n, bias, r, aux_in,
                                        aux_out, epi, stage, &map_c, &map_pre, 3 + wg,
                                        a * kBN / 64);
        }
      }
    }
    // The last stores must have read their staging buffers before the
    // block's shared memory goes.
    if (leader) sm::bulk_wait<0>();
  }
}

// -- TN: the weight gradient, K split over blocks ---------------------------------

constexpr int kTnBM = 128, kTnBN = 128, kTnStages = 3;
constexpr int kTnConsumers = 2;                     // warpgroups, 64 rows each
constexpr int kTnThreads = kTnConsumers * 128 + 32;  // and one producer warp
constexpr int kTnABytes = kTnBM * kBK * 2;          // 16 KB
constexpr int kTnStageBytes = kTnABytes + kTnBN * kBK * 2;
// The ring, 2 x kTnStages mbarriers, and slack to align the ring to 1 KB.
constexpr int kTnSmemBytes = kTnStages * kTnStageBytes + 2 * kTnStages * 8 + 1024;

__global__ void __launch_bounds__(kTnThreads, 2)
    gemm_tn_kernel(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_b, float* __restrict__ c, int m, int n,
                   int k, int k_tiles_per_split) {
  namespace sm = dclip::sm90;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = sm::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kTnStages * kTnStageBytes);
  uint64_t* empty = full + kTnStages;

  const int m0 = blockIdx.y * kTnBM, n0 = blockIdx.x * kTnBN;
  // This block's share of the K tiles (all of them unless K is split).
  const int kt0 = blockIdx.z * k_tiles_per_split;
  const int kt1 = min((k + kBK - 1) / kBK, kt0 + k_tiles_per_split);
  const int ktiles = max(kt1 - kt0, 0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kTnStages; ++s) {
      sm::mbar_init(&full[s], 1);
      sm::mbar_init(&empty[s], kTnConsumers * 4);  // one arrival per consumer warp
    }
    sm::fence_barrier_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == kTnConsumers) {
    // Producer warp: one thread issues every load.
    if (threadIdx.x == kTnConsumers * 128) {
      sm::prefetch_tensormap(&map_a);
      sm::prefetch_tensormap(&map_b);
      for (int kt = 0; kt < ktiles; ++kt) {
        const int s = kt % kTnStages;
        sm::mbar_wait(&empty[s], ((kt / kTnStages) & 1) ^ 1);
        sm::mbar_expect_tx(&full[s], kTnStageBytes);
        unsigned char* sa = smem + s * kTnStageBytes;
        unsigned char* sb = sa + kTnABytes;
        const int kk = (kt0 + kt) * kBK;
        // X [K, M]: two [64 K][64 M] boxes, one per consumer.
        sm::tma_load_2d(sa, &map_a, &full[s], m0, kk);
        sm::tma_load_2d(sa + kBox, &map_a, &full[s], m0 + 64, kk);
#pragma unroll
        for (int i = 0; i < kTnBN / 64; ++i)  // Y [K, N]: [64 K][64 N] boxes
          sm::tma_load_2d(sb + i * kBox, &map_b, &full[s], n0 + 64 * i, kk);
      }
    }
  } else {
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;

    // Both operands MN-major: a k16 step moves 16 rows of 128 bytes.
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x & 31;
    for (int kt = 0; kt < ktiles; ++kt) {
      const int s = kt % kTnStages;
      sm::mbar_wait(&full[s], (kt / kTnStages) & 1);
      const unsigned char* sa = smem + s * kTnStageBytes;
      const unsigned char* sb = sa + kTnABytes;
      // This warpgroup's 64 columns of X: the [64 K][64 M] box, 8 KB in.
      const uint64_t da = desc_sw128(sa + wg * kBox, 16, 1024);
      // The 128 columns of Y: two [64 K][64 N] boxes 8 KB apart (the LBO).
      const uint64_t db = desc_sw128(sb, kBox, 1024);
      sm::fence_regs(acc);
      sm::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        sm::wgmma_m64n128k16_ss<1, 1>(acc, desc_add(da, kk * 2048), desc_add(db, kk * 2048), 1);
      sm::wgmma_commit();
      sm::fence_regs(acc);
      // Keep this step's group in flight; the previous one is done, so
      // its stage goes back to the producer.
      sm::wgmma_wait<1>();
      if (kt > 0 && lane == 0) sm::mbar_arrive(&empty[(kt - 1) % kTnStages]);
    }
    sm::wgmma_wait<0>();
    sm::fence_regs(acc);

    // Epilogue: 8 consecutive columns of one row per lane, two 16-byte
    // f32 stores into slice z.
    float* cz = c + static_cast<size_t>(blockIdx.z) * m * n;
    const int row = m0 + wg * 64 + warp * 16 + (lane >> 2);
#pragma unroll
    for (int g0 = 0; g0 < 16; g0 += 4) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float v[8];
        sm::quad_gather8(acc, g0, half, v);
        const int gm = row + 8 * half, gn = n0 + (g0 + (lane & 3)) * 8;
        if (gm < m && gn < n) {
          float4* cf = reinterpret_cast<float4*>(cz + static_cast<size_t>(gm) * n + gn);
          cf[0] = make_float4(v[0], v[1], v[2], v[3]);
          cf[1] = make_float4(v[4], v[5], v[6], v[7]);
        }
      }
    }
  }
}

// A row-major [rows, cols] matrix, bf16 or (f32) f32, read or written in
// [box_rows][128 bytes] boxes with 128-byte swizzle.
bool encode(CUtensorMap* map, const void* base, int rows, int cols, int box_rows,
            bool f32 = false) {
  dclip::sm90::EncodeTiledFn fn = dclip::sm90::encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * (f32 ? 4 : 2)};
  const cuuint32_t box[2] = {f32 ? 32u : 64u, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
            const_cast<void*>(base), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kMode, int kAtoms, int kBN, bool kPingPong, int kForm>
int launch(const void* a, const void* w, const void* bias, const void* r, const void* aux_in,
           void* aux_out, void* c, int m, int n, int k, int epi, int out_f32, int sms,
           void* stream) {
  using S = Schedule<kAtoms, kBN, kPingPong, kSlotsOf<kForm>>;
  auto* kernel = gemm_persistent_kernel<kMode, kAtoms, kBN, kPingPong, kForm>;
  // A runtime call first: it makes the device's primary context current in
  // this host thread, which the driver's tensor-map encode needs. A thread
  // that has made no runtime call yet (autograd's backward worker, when a
  // GEMM is its first CUDA work) has none, and the encode would fail.
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  // C, the staged pre-activation and the staged operand move in [64 rows]
  // [128 bytes] boxes (a bf16 pre-activation beside an f32 C is stored
  // directly).
  CUtensorMap map_a, map_b, map_c, map_pre = {}, map_op = {};
  const bool ok =
      encode(&map_a, a, m, k, S::kBM) &&
      (kMode == kModeNT ? encode(&map_b, w, n, k, kBN) : encode(&map_b, w, k, n, 64)) &&
      encode(&map_c, c, m, n, 64, out_f32 != 0) &&
      (aux_out == nullptr || out_f32 || encode(&map_pre, aux_out, m, n, 64)) &&
      (!kStagedOperand<kForm> ||
       encode(&map_op, epi == kEpiDgelu || epi == kEpiDgeluTanh ? aux_in : r, m, n, 64));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (m + S::kBM - 1) / S::kBM * ((n + kBN - 1) / kBN);
  kernel<<<tiles < sms ? tiles : sms, kThreads, S::kSmemBytes,
           static_cast<cudaStream_t>(stream)>>>(
      map_a, map_b, map_c, map_pre, map_op, static_cast<const float*>(bias),
      static_cast<const __nv_bfloat16*>(r), static_cast<const __nv_bfloat16*>(aux_in),
      static_cast<__nv_bfloat16*>(aux_out), m, n, k, epi, out_f32);
  return static_cast<int>(cudaGetLastError());
}

// The kernel of this call's epilogue form: the forms the main path runs
// each have their own (kOpF32 alone: K6's dx and the tensor-parallel
// partial products; with kOpBias: K10's out-projections; none: K9's
// backward; SigLIP's K6, tanh-GELU with a1 saved and tanh-GELU', in the NN
// mode on wide tiles only, where its row count puts them), the rest share
// kAnyForm.
template <int kMode, int kAtoms, int kBN, bool kPingPong>
int launch_form(const void* a, const void* w, const void* bias, const void* r,
                const void* aux_in, void* aux_out, void* c, int m, int n, int k, int epi,
                int out_f32, int sms, void* stream) {
  const bool tanh_form = epi == kEpiGeluTanh || epi == kEpiDgeluTanh;
  const int form = (bias != nullptr ? kOpBias : 0) |
                   (epi == kEpiGelu || epi == kEpiGeluTanh ? kOpGelu : 0) |
                   (epi == kEpiDgelu || epi == kEpiDgeluTanh ? kOpDgelu : 0) |
                   (r != nullptr ? kOpRes : 0) | (aux_out != nullptr ? kOpPre : 0) |
                   (out_f32 ? kOpF32 : 0) | (tanh_form ? kOpTanh : 0);
#define DCLIP_FORM(f)                                                                        \
  case f:                                                                                    \
    return launch<kMode, kAtoms, kBN, kPingPong, f>(a, w, bias, r, aux_in, aux_out, c, m, n, \
                                                    k, epi, out_f32, sms, stream)
  if constexpr (kMode == kModeNN && !kPingPong) {
    switch (form) {
      DCLIP_FORM(kOpBias | kOpGelu | kOpPre | kOpTanh);
      DCLIP_FORM(kOpDgelu | kOpTanh);
      default:
        break;
    }
  }
  switch (form) {
    DCLIP_FORM(0);
    DCLIP_FORM(kOpBias);
    DCLIP_FORM(kOpBias | kOpRes);
    DCLIP_FORM(kOpBias | kOpGelu);
    DCLIP_FORM(kOpBias | kOpGelu | kOpPre);
    DCLIP_FORM(kOpDgelu);
    DCLIP_FORM(kOpF32);
    DCLIP_FORM(kOpBias | kOpF32);
    default:
      return launch<kMode, kAtoms, kBN, kPingPong, kAnyForm>(a, w, bias, r, aux_in, aux_out, c,
                                                             m, n, k, epi, out_f32, sms, stream);
  }
#undef DCLIP_FORM
}

// The schedule `tile_n` names (the wrapper's `gemm_tile_n`): 256, the wide
// cooperative 128 x 256 tiles; 128, the narrow ping-pong 128 x 128 ones.
template <int kMode>
int launch_schedule(const void* a, const void* w, const void* bias, const void* r,
                    const void* aux_in, void* aux_out, void* c, int m, int n, int k, int epi,
                    int out_f32, int tile_n, int sms, void* stream) {
  if (sms < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (tile_n == 256)
    return launch_form<kMode, 1, 256, false>(a, w, bias, r, aux_in, aux_out, c, m, n, k, epi,
                                             out_f32, sms, stream);
  if (tile_n == 128)
    return launch_form<kMode, 2, 128, true>(a, w, bias, r, aux_in, aux_out, c, m, n, k, epi,
                                            out_f32, sms, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// a: [m, k], w: [k, n], r / aux_in / aux_out (each optional, may be null)
// [m, n], all bf16 row-major and 16-byte aligned; bias: [n] f32 or null;
// c: [m, n], f32 when out_f32 else bf16. k % 8 == 0, n % 8 == 0.
// epi: 0 none, 1 quick-GELU (aux_out, when given, receives the
// pre-activation), 2 times quick-GELU'(aux_in), 3 tanh-GELU (as 1), 4
// times tanh-GELU'(aux_in).
extern "C" int dclip_gemm_bf16(const void* a, const void* w, const void* bias,
                               const void* r, const void* aux_in, void* aux_out, void* c,
                               int m, int n, int k, int epi, int out_f32, int tile_n, int sms,
                               void* stream) {
  return launch_schedule<kModeNN>(a, w, bias, r, aux_in, aux_out, c, m, n, k, epi, out_f32,
                                  tile_n, sms, stream);
}

// The same with w given as [n, k] row-major (c = a . w^T).
extern "C" int dclip_gemm_nt_bf16(const void* a, const void* w, const void* bias,
                                  const void* r, const void* aux_in, void* aux_out, void* c,
                                  int m, int n, int k, int epi, int out_f32, int tile_n,
                                  int sms, void* stream) {
  return launch_schedule<kModeNT>(a, w, bias, r, aux_in, aux_out, c, m, n, k, epi, out_f32,
                                  tile_n, sms, stream);
}

// c[z] = x[rows of split z]^T . y[rows of split z] for z < splits: x [k, m]
// and y [k, n] bf16 row-major, 16-byte aligned, m % 8 == 0, n % 8 == 0, any
// k; split z takes K tiles (of 64 rows) [z * k_tiles_per_split, ...);
// c: [splits, m, n] f32 (the split partials, summed by
// dclip_reduce_rows_f32; with splits == 1, the product itself).
extern "C" int dclip_gemm_tn_bf16(const void* x, const void* y, void* c, int m, int n, int k,
                                  int k_tiles_per_split, int splits, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(gemm_tn_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kTnSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap map_a, map_b;
  if (!encode(&map_a, x, k, m, 64) || !encode(&map_b, y, k, n, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kTnBN - 1) / kTnBN, (m + kTnBM - 1) / kTnBM, splits);
  gemm_tn_kernel<<<grid, kTnThreads, kTnSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      map_a, map_b, static_cast<float*>(c), m, n, k, k_tiles_per_split);
  return static_cast<int>(cudaGetLastError());
}
