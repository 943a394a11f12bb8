// The student objective of the distillation step, forward and backward:
//   L = li + lt + w lc,   li = 1 - mean_i cos(si_i, ti_i),
//   lt = 1 - mean_i cos(st_i, tt_i),
//   lc = (mean_i lse_row_i + mean_j lse_col_j) / 2 - mean_i Z_ii,
//   Z = si^ st^T / T (rows normalised, T the InfoNCE temperature),
// with the closed-form gradients for the student rows si, st:
//   gZ = c_lc ((P_row - I) + (P_col - I)) / (2 B T),
//   g_si = -(c_li / B) ti^ + gZ st^,  g_st = -(c_lt / B) tt^ + gZ^T si^,
//   dsi = (g_si - <g_si, si^> si^) / |si|   (and dst alike),
// where c_li, c_lt, c_lc are the cotangent weights of the four parts.
// si, st bf16 [B, D] (the student's compute dtype); ti, tt f32 [B, D]
// (the cached teacher targets); all arithmetic in f32.
//
// Replaces: dclip_tpu/kernels/distill_loss.py `_fwd_kernel` (K11, line 47)
//   and `_bwd_kernel` (line 73), called by `_run_fwd` / `_run_bwd` (lines
//   115 / 132). The TPU runs each as one program with the [B, B] matrix Z
//   resident in VMEM (hence its B <= 1024 bound); here Z is cut in tiles
//   over many blocks, so any B works. As on the TPU, the backward saves no
//   residual of the forward: it recomputes the log-sum-exps.
// Bound on the H100: at B = 256, D = 512 the forward is 2 B^2 D = 67 MFLOP
//   of f32 (~1 us at 67 TFLOP/s) over 0.8 MB of input; the backward three
//   times the operations. Neither is bound by the card's rates: the cost is
//   launches, memory latency and the serial merge of the tiles' results.
// Design:
//   distill_tiles_kernel, grid (nt, nt) of 32 x 32 tiles of Z (nt =
//     ceil(B / 32); 16 x 16 tiles ran about as fast at B = 256 and much
//     slower at B = 4,096), 256 threads: block (bj, bi) takes
//     Z[32 bi : +32, 32 bj : +32]. It copies its si
//     and st rows whole into shared memory by 16-byte cp.async (one wait,
//     no memory latency inside the loop), sums each row's squares, and
//     multiplies them straight from bf16 (a 2 x 2 micro-tile a thread;
//     converting chunks to f32 once first measured slower). Meanwhile it folds one slice of D of the teacher rows into
//     per-row partial sums (<si, ti>, |ti|^2 over slice bj for its si rows;
//     <st, tt>, |tt|^2 over slice bi for its st rows): every block loads
//     1 / nt of the teacher bytes, issued before its wait. It writes its
//     tile's (max, sum exp) for each of its rows and columns (and Z_ii on
//     the diagonal, the inverse norms in the first block row and column);
//     the backward also writes Z ([B, round4(B)] f32, 0.25 MB at B = 256).
//     Completion tickets (the only atomics, on no value) find the last
//     block of each row strip and each column strip, which merges that
//     strip's partials in a fixed order into the log-sum-exps, cosines and
//     teacher norms, so the merges run in parallel; the last strip merge
//     of the forward reduces the four parts in a fixed order and writes
//     them: one launch.
//   distill_grad_kernel, grid (ceil(B / 32), ceil(D / 64), 2), 256
//     threads: block (x, y, 0) writes dsi for 32 rows x 64 columns,
//     (x, y, 1) dst. It streams the other matrix's rows in tiles of 32
//     through a 4-stage cp.async ring (the tile's 64 bf16 columns, the
//     matching 32 x 32 block of Z, and the tile's log-sum-exps and inverse
//     norms), forms gZ[own rows, tile rows] / |other row| in shared
//     memory, and accumulates a 2 x 4 micro-tile a thread. The chain
//     rule's <g, s^> spans all of D, which one block does not hold, so it
//     is formed from what it does: T sum_j gZ_ij Z_ij (= <gZ st^, si^_i>)
//     and cos_i (= <ti^_i, si^_i>).
//   The backward is two launches (tiles, then gradients), not one
//   cooperative launch: a grid-wide barrier needs every block resident at
//   once, which a B of thousands of rows (nt^2 tile blocks) does not give.
// The tickets: 1 + 2 nt unsigned, each set back to 0 by its last user in
//   every launch, so no launch is needed to zero them. The wrapper keeps
//   one set per (device, stream), zeroed once when allocated: launches on
//   one stream run in order, so no two calls in flight share one. A call
//   captured into a CUDA graph gets a set of its own, zeroed by the graph
//   (`_workspace` in kernels/distill_loss.py).
// No atomics on values: every sum runs in a fixed order, so two calls on
//   the same inputs give the same bits. D % 8 == 0, D <= 1536 (the two
//   strips of the tile kernel, 2 x 32 x (D + 8) bf16, fit a block's shared
//   memory).
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kGradRows = 32, kGradCols = 64, kStages = 4;  // a gradient block; its ring
constexpr float kEps = 1e-12f;

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }
__host__ __device__ __forceinline__ int strip_ld(int d) { return d + 8; }  // bf16, padded
constexpr int kTile = 32;  // the tile of Z

__device__ __forceinline__ float inv_norm(float sq) { return rsqrtf(fmaxf(sq, kEps * kEps)); }

// Max and sum over aligned groups of kWidth lanes (a power of two up to 32).
template <int kWidth>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = kWidth / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(dclip::kFullMask, v, o));
  return v;
}

template <int kWidth>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = kWidth / 2; o > 0; o >>= 1) v += __shfl_xor_sync(dclip::kFullMask, v, o);
  return v;
}

// Fixed-order block sum: the warps' shuffle trees, then warp 0..7 in order.
__device__ float block_sum(float v, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  v = dclip::warp_sum(v);
  __syncthreads();  // red is free
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += red[w];
  return t;
}

// The scratch of one call, 8 nt B + 9 round4(B) floats, nt = ceil(B / 32)
// (kernels/distill_loss.py allocates it): per tile, the (max,
// sum exp) of every row over each column tile and of every column over
// each row tile, and the teacher partials (<s, t>, |t|^2) of every si and
// st row over each slice of D; then per row (each array 16-byte aligned)
// Z_ii, the two cosines, the inverse norms of si, st, ti and tt, and the
// two log-sum-exps.
struct Scratch {
  float2 *prow, *pcol, *pti, *ptt;
  float *diag, *cos_i, *cos_t, *inv_i, *inv_t, *inv_ti, *inv_tt, *lse_row, *lse_col;
};

__device__ __forceinline__ Scratch carve(float* base, int b) {
  const size_t part = static_cast<size_t>((b + kTile - 1) / kTile) * b;
  const int bp = round4(b);
  Scratch s;
  s.prow = reinterpret_cast<float2*>(base);
  s.pcol = s.prow + part;
  s.pti = s.pcol + part;
  s.ptt = s.pti + part;
  float* f = reinterpret_cast<float*>(s.ptt + part);
  s.diag = f;
  s.cos_i = f + bp;
  s.cos_t = f + 2 * bp;
  s.inv_i = f + 3 * bp;
  s.inv_t = f + 4 * bp;
  s.inv_ti = f + 5 * bp;
  s.inv_tt = f + 6 * bp;
  s.lse_row = f + 7 * bp;
  s.lse_col = f + 8 * bp;
  return s;
}

// (m, s) <- the log-sum-exp pair of (m, s) and (vm, vs); m = -inf is the
// empty pair. The result does not depend on the order of the two.
__device__ __forceinline__ void merge_into(float& m, float& s, float vm, float vs) {
  if (vm == -INFINITY) return;
  if (m == -INFINITY) {
    m = vm;
    s = vs;
    return;
  }
  const float mn = fmaxf(m, vm);
  s = s * expf(m - mn) + vs * expf(vm - mn);
  m = mn;
}

__device__ __forceinline__ float dot8(const float (&a)[8], const float (&x)[8]) {
  return a[0] * x[0] + a[1] * x[1] + a[2] * x[2] + a[3] * x[3] + a[4] * x[4] + a[5] * x[5] +
         a[6] * x[6] + a[7] * x[7];
}

__device__ __forceinline__ float dot8(const float (&a)[8], const float4& x, const float4& y) {
  return a[0] * x.x + a[1] * x.y + a[2] * x.z + a[3] * x.w + a[4] * y.x + a[5] * y.y +
         a[6] * y.z + a[7] * y.w;
}

__device__ __forceinline__ float sq8(const float4& x, const float4& y) {
  return x.x * x.x + x.y * x.y + x.z * x.z + x.w * x.w + y.x * y.x + y.y * y.y + y.z * y.z +
         y.w * y.w;
}

// The last block of a row strip (rows = true) or column strip merges its
// 32 entries: R = 8 threads an entry, each folding the tiles
// R apart in order, then a shuffle tree over the R threads (the same
// fixed order on every call). Writes the log-sum-exp, the cosine and the
// teacher's inverse norm of each entry.
__device__ void merge_strip(const Scratch& sc, bool rows, int strip, int nt, int b) {
  constexpr int R = kThreads / kTile;
  const int e = threadIdx.x / R, part = threadIdx.x % R, i = strip * kTile + e;
  const int ic = i < b ? i : b - 1;
  const float2* lse_part = rows ? sc.prow : sc.pcol;
  const float2* t_part = rows ? sc.pti : sc.ptt;
  float m = -INFINITY, s = 0.f, dt = 0.f, qt = 0.f;
  for (int k0 = part; k0 < nt; k0 += 4 * R) {  // four tiles' loads issued together
    float2 v[4], w[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = k0 + u * R;
      const size_t at = static_cast<size_t>(k < nt ? k : 0) * b + ic;
      v[u] = k < nt ? __ldcg(&lse_part[at]) : make_float2(-INFINITY, 0.f);
      w[u] = k < nt ? __ldcg(&t_part[at]) : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      merge_into(m, s, v[u].x, v[u].y);
      dt += w[u].x;
      qt += w[u].y;
    }
  }
#pragma unroll
  for (int o = R / 2; o > 0; o >>= 1) {
    const float mo = __shfl_xor_sync(dclip::kFullMask, m, o);
    const float so = __shfl_xor_sync(dclip::kFullMask, s, o);
    merge_into(m, s, mo, so);
    dt += __shfl_xor_sync(dclip::kFullMask, dt, o);
    qt += __shfl_xor_sync(dclip::kFullMask, qt, o);
  }
  if (part != 0 || i >= b) return;
  const float it = inv_norm(qt);
  if (rows) {
    sc.lse_row[i] = m + logf(s);
    sc.inv_ti[i] = it;
    sc.cos_i[i] = dt * __ldcg(&sc.inv_i[i]) * it;
  } else {
    sc.lse_col[i] = m + logf(s);
    sc.inv_tt[i] = it;
    sc.cos_t[i] = dt * __ldcg(&sc.inv_t[i]) * it;
  }
}

// out != null: the forward (writes the four parts); else the backward's
// first launch (writes Z into z and the per-row results into the scratch).
// Dynamic shared memory: the two bf16 strips, [2][32][d + 8]. tickets:
// [0] the strip merges done, [1 + s] the blocks done of row strip s,
// [1 + nt + s] of column strip s; each reset to 0 by its last user.
__global__ void __launch_bounds__(kThreads)
    distill_tiles_kernel(const __nv_bfloat16* __restrict__ si,
                         const __nv_bfloat16* __restrict__ st, const float* __restrict__ ti,
                         const float* __restrict__ tt, float* __restrict__ scratch,
                         float* __restrict__ z, unsigned* __restrict__ tickets,
                         float* __restrict__ out, int b, int d, float temperature,
                         float weight) {
  constexpr int M = kTile / 16;        // an M x M micro-tile a thread
  constexpr int R = kThreads / kTile;  // threads a strip row in the row passes
  extern __shared__ __align__(16) __nv_bfloat16 strips[];
  __shared__ float zt[kTile][kTile + 1];
  __shared__ float inv_a[kTile], inv_b[kTile], red[kWarps];
  __shared__ int flags;
  const Scratch sc = carve(scratch, b);
  const int nt = gridDim.x, bj = blockIdx.x, bi = blockIdx.y;
  const int i0 = bi * kTile, j0 = bj * kTile, ldb = strip_ld(d), vecs = d / 8;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  __nv_bfloat16* sa = strips;
  __nv_bfloat16* sb = strips + kTile * ldb;

  // 1. Both strips, every copy issued at once (rows past B zero-filled).
  for (int i = tid; i < kTile * vecs; i += kThreads) {
    const int r = i / vecs, c = 8 * (i % vecs);
    const int ra = min(i0 + r, b - 1), rb = min(j0 + r, b - 1);
    dclip::cp_async_16(sa + r * ldb + c, si + static_cast<size_t>(ra) * d + c, i0 + r < b);
    dclip::cp_async_16(sb + r * ldb + c, st + static_cast<size_t>(rb) * d + c, j0 + r < b);
  }
  dclip::cp_async_commit();

  // 2. The teacher slices: R threads a strip row (row tr), vectors tv, tv +
  //    R, ... of the slice; the first two vectors' loads go out before the
  //    wait.
  const int width = 8 * ((vecs + nt - 1) / nt);  // columns of a slice, a multiple of 8
  const int tr = tid / R, tv = tid % R;
  const int ca = bj * width, cb = bi * width;  // this block's slices: ti rows, tt rows
  const bool ra_ok = i0 + tr < b, rb_ok = j0 + tr < b;
  float dti = 0.f, qti = 0.f, dtt = 0.f, qtt = 0.f;
  auto teacher = [&](const float* m, int row, int col, bool ok, float4& x, float4& y) {
    ok = ok && col < d;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    x = ok ? *reinterpret_cast<const float4*>(m + static_cast<size_t>(row) * d + col) : zero;
    y = ok ? *reinterpret_cast<const float4*>(m + static_cast<size_t>(row) * d + col + 4) : zero;
  };
  for (int v0 = 0; v0 < width / 8; v0 += 2 * R) {
    float4 ta[2][2], tb[2][2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int v = v0 + tv + R * u;
      const bool in = v < width / 8;
      teacher(ti, i0 + tr, ca + 8 * v, ra_ok && in, ta[u][0], ta[u][1]);
      teacher(tt, j0 + tr, cb + 8 * v, rb_ok && in, tb[u][0], tb[u][1]);
    }
    if (v0 == 0) {
      dclip::cp_async_wait<0>();
      __syncthreads();
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int c = 8 * (v0 + tv + R * u);
      float fa[8], fb[8];
      // Columns past the slice or D meet zero teacher values; clamp the read.
      dclip::unpack8(*reinterpret_cast<const uint4*>(sa + tr * ldb + min(ca + c, d - 8)), fa);
      dclip::unpack8(*reinterpret_cast<const uint4*>(sb + tr * ldb + min(cb + c, d - 8)), fb);
      dti += dot8(fa, ta[u][0], ta[u][1]);
      qti += sq8(ta[u][0], ta[u][1]);
      dtt += dot8(fb, tb[u][0], tb[u][1]);
      qtt += sq8(tb[u][0], tb[u][1]);
    }
  }
  dti = group_sum<R>(dti);
  qti = group_sum<R>(qti);
  dtt = group_sum<R>(dtt);
  qtt = group_sum<R>(qtt);
  if (tv == 0 && ra_ok) sc.pti[static_cast<size_t>(bj) * b + i0 + tr] = make_float2(dti, qti);
  if (tv == 0 && rb_ok) sc.ptt[static_cast<size_t>(bi) * b + j0 + tr] = make_float2(dtt, qtt);

  // 3. Row norms from the strips, R threads a row.
  float sqa = 0.f, sqb = 0.f;
  for (int v = tv; v < vecs; v += R) {
    float fa[8], fb[8];
    dclip::unpack8(*reinterpret_cast<const uint4*>(sa + tr * ldb + 8 * v), fa);
    dclip::unpack8(*reinterpret_cast<const uint4*>(sb + tr * ldb + 8 * v), fb);
    sqa += dot8(fa, fa);
    sqb += dot8(fb, fb);
  }
  sqa = group_sum<R>(sqa);
  sqb = group_sum<R>(sqb);
  if (tv == 0) {
    inv_a[tr] = inv_norm(sqa);
    inv_b[tr] = inv_norm(sqb);
    if (bj == 0 && ra_ok) sc.inv_i[i0 + tr] = inv_norm(sqa);
    if (bi == 0 && rb_ok) sc.inv_t[j0 + tr] = inv_norm(sqb);
  }

  // 4. The product from the bf16 strips: rows ty + 16 x, columns tx + 16 y.
  const int ty = tid / 16, tx = tid % 16;
  float acc[M][M];
#pragma unroll
  for (int x = 0; x < M; ++x)
#pragma unroll
    for (int y = 0; y < M; ++y) acc[x][y] = 0.f;
#pragma unroll 2
  for (int k = 0; k < d; k += 8) {
    float fa[M][8], fb[M][8];
#pragma unroll
    for (int x = 0; x < M; ++x) {
      dclip::unpack8(*reinterpret_cast<const uint4*>(sa + (ty + 16 * x) * ldb + k), fa[x]);
      dclip::unpack8(*reinterpret_cast<const uint4*>(sb + (tx + 16 * x) * ldb + k), fb[x]);
    }
#pragma unroll
    for (int x = 0; x < M; ++x)
#pragma unroll
      for (int y = 0; y < M; ++y) acc[x][y] += dot8(fa[x], fb[y]);
  }
  __syncthreads();  // inv_a, inv_b
#pragma unroll
  for (int x = 0; x < M; ++x)
#pragma unroll
    for (int y = 0; y < M; ++y)
      zt[ty + 16 * x][tx + 16 * y] =
          acc[x][y] * inv_a[ty + 16 * x] * inv_b[tx + 16 * y] / temperature;
  __syncthreads();

  // 5. Per row and column of the tile, (max, sum exp): a warp an entry, a
  //    lane a value, eight entries a pass.
  const int ldz = round4(b), c = lane % kTile;
#pragma unroll
  for (int q = 0; q < kTile * kTile / kThreads; ++q) {
    const int r = q * (kThreads / kTile) + warp * (32 / kTile) + lane / kTile;
    const int i = i0 + r, j = j0 + c;
    const float vr = j < b ? zt[r][c] : -INFINITY;
    const float mr = group_max<kTile>(vr);
    const float sr = group_sum<kTile>(j < b ? expf(vr - mr) : 0.f);
    const float vc = i0 + c < b ? zt[c][r] : -INFINITY;
    const float mc = group_max<kTile>(vc);
    const float scol = group_sum<kTile>(i0 + c < b ? expf(vc - mc) : 0.f);
    if (c == 0 && i < b) sc.prow[static_cast<size_t>(bj) * b + i] = make_float2(mr, sr);
    if (c == 0 && j0 + r < b) sc.pcol[static_cast<size_t>(bi) * b + j0 + r] = make_float2(mc, scol);
    if (bi == bj && c == r && i < b) sc.diag[i] = zt[r][r];
    if (z != nullptr && i < b && j < b) z[static_cast<size_t>(i) * ldz + j] = zt[r][c];
  }

  // 6. The last block of a row strip merges its rows, of a column strip its
  //    columns; the last strip merge finishes the forward.
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const unsigned last = static_cast<unsigned>(nt - 1);
    flags = (atomicAdd(&tickets[1 + bi], 1u) == last ? 1 : 0) |
            (atomicAdd(&tickets[1 + nt + bj], 1u) == last ? 2 : 0);
  }
  __syncthreads();
  const int f = flags;
  if (f == 0) return;
  __threadfence();
  if (f & 1) merge_strip(sc, true, bi, nt, b);
  if (f & 2) merge_strip(sc, false, bj, nt, b);
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    if (f & 1) tickets[1 + bi] = 0u;  // ready for the next launch on this stream
    if (f & 2) tickets[1 + nt + bj] = 0u;
    const unsigned merges = (f & 1) + (f >> 1);
    flags = atomicAdd(&tickets[0], merges) + merges == static_cast<unsigned>(2 * nt) ? 4 : 0;
  }
  __syncthreads();
  if (flags != 4) return;
  __threadfence();
  if (out != nullptr) {
    float s_row = 0.f, s_col = 0.f, s_diag = 0.f, s_ci = 0.f, s_ct = 0.f;
    for (int i = tid; i < b; i += kThreads) {
      s_row += __ldcg(&sc.lse_row[i]);
      s_col += __ldcg(&sc.lse_col[i]);
      s_diag += __ldcg(&sc.diag[i]);
      s_ci += __ldcg(&sc.cos_i[i]);
      s_ct += __ldcg(&sc.cos_t[i]);
    }
    s_row = block_sum(s_row, red) / b;
    s_col = block_sum(s_col, red) / b;
    s_diag = block_sum(s_diag, red) / b;
    s_ci = block_sum(s_ci, red) / b;
    s_ct = block_sum(s_ct, red) / b;
    if (tid == 0) {
      const float li = 1.f - s_ci, lt = 1.f - s_ct;
      const float lc = 0.5f * (s_row + s_col) - s_diag;
      out[0] = li;
      out[1] = lt;
      out[2] = lc;
      out[3] = li + lt + weight * lc;
    }
  }
  if (tid == 0) tickets[0] = 0u;
}

// One stage of the gradient kernel's ring: 32 rows of the other matrix
// (this block's 64 columns), the 32 x 32 block of Z between the block's own
// rows and those rows (dir 0: [own][other], dir 1: [other][own], as Z
// holds them), and those rows' log-sum-exps and inverse norms.
struct GradStage {
  __nv_bfloat16 other[kGradRows][kGradCols];
  float z[kGradRows][kGradRows];
  float lse[kGradRows], inv[kGradRows];
};

// Block (x, y, 0) writes dsi[32 x : +32, 64 y : +64], block (x, y, 1) the
// same of dst.
__global__ void __launch_bounds__(kThreads)
    distill_grad_kernel(const __nv_bfloat16* __restrict__ si,
                        const __nv_bfloat16* __restrict__ st, const float* __restrict__ ti,
                        const float* __restrict__ tt, float* __restrict__ scratch,
                        const float* __restrict__ z, const float* __restrict__ cts,
                        __nv_bfloat16* __restrict__ dsi, __nv_bfloat16* __restrict__ dst, int b,
                        int d, float temperature) {
  __shared__ __align__(16) GradStage ring[kStages];
  __shared__ float gzs[kGradRows][kGradRows + 1];  // [other row][own row]
  __shared__ float lse_own[kGradRows], dots[kGradRows], zpart[kWarps][kGradRows];
  const Scratch sc = carve(scratch, b);
  const int dir = blockIdx.z, i0 = blockIdx.x * kGradRows, c0 = blockIdx.y * kGradCols;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int warp = tid >> 5, lane = tid & 31;
  const int ldz = round4(b), nt = (b + kGradRows - 1) / kGradRows;
  const __nv_bfloat16* other = dir == 0 ? st : si;
  const float* lse_other = dir == 0 ? sc.lse_col : sc.lse_row;
  const float* inv_other = dir == 0 ? sc.inv_t : sc.inv_i;
  const float c_cos = cts[dir], gscale = cts[2] / (2.f * b * temperature);
  if (tid < kGradRows) lse_own[tid] = i0 + tid < b ? (dir == 0 ? sc.lse_row : sc.lse_col)[i0 + tid] : 0.f;

  // Thread tid copies the other tile's row tid / 8, columns 8 (tid % 8) ..;
  // Z's row tid / 8, columns 4 (tid % 8) ..; threads 0-15 the lse and inv.
  auto issue = [&](int tile) {
    GradStage& g = ring[tile % kStages];
    const int j0 = tile * kGradRows, r = tid / 8, v = tid % 8;
    const int o = j0 + r, col = c0 + 8 * v;
    dclip::cp_async_16(&g.other[r][8 * v],
                       other + static_cast<size_t>(min(o, b - 1)) * d + min(col, d - 8),
                       o < b && col < d);
    // dir 0: Z[i0 + r, j0 + 4 v ..]; dir 1: Z[j0 + r, i0 + 4 v ..] (rows
    // padded to round4(B), so a 16-byte copy never leaves its row).
    const int zr = dir == 0 ? i0 + r : j0 + r, zc = dir == 0 ? j0 + 4 * v : i0 + 4 * v;
    dclip::cp_async_16(&g.z[r][4 * v], z + static_cast<size_t>(min(zr, b - 1)) * ldz + min(zc, ldz - 4),
                       zr < b && zc < b);
    if (tid < 16) {
      const int k = j0 + 4 * (tid % 8);
      const float* src = (tid < 8 ? lse_other : inv_other) + min(k, ldz - 4);
      dclip::cp_async_16(tid < 8 ? &g.lse[4 * (tid % 8)] : &g.inv[4 * (tid % 8)], src, k < b);
    }
  };

  float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  float zd[4] = {0.f, 0.f, 0.f, 0.f};  // sums of gZ Z, see below
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nt) issue(s);
    dclip::cp_async_commit();
  }
  for (int tile = 0; tile < nt; ++tile) {
    __syncthreads();  // the slot refilled below and gzs are free
    if (tile + kStages - 1 < nt) issue(tile + kStages - 1);
    dclip::cp_async_commit();
    dclip::cp_async_wait<kStages - 1>();
    __syncthreads();
    const GradStage& g = ring[tile % kStages];
    const int j0 = tile * kGradRows;
    // gZ from the staged Z block g.z[4 warp + u][lane]: dir 0 reads own row
    // 4 warp + u against other row lane, dir 1 own row lane against other
    // row 4 warp + u.
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int own = dir == 0 ? 4 * warp + u : lane, oth = dir == 0 ? lane : 4 * warp + u;
      const float zz = g.z[4 * warp + u][lane];
      float w = 0.f;  // past B the staged values are padding: never read
      if (i0 + own < b && j0 + oth < b) {
        const float eye = i0 + own == j0 + oth ? 1.f : 0.f;
        const float gz =
            gscale * ((expf(zz - lse_own[own]) - eye) + (expf(zz - g.lse[oth]) - eye));
        zd[u] += gz * zz;
        w = gz * g.inv[oth];
      }
      gzs[oth][own] = w;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kGradRows; ++k) {
      const float g0 = gzs[k][ty], g1 = gzs[k][ty + 16];
      const uint2 raw = *reinterpret_cast<const uint2*>(&g.other[k][4 * tx]);
      const float2 v0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
      const float2 v1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
      acc[0][0] += g0 * v0.x;
      acc[0][1] += g0 * v0.y;
      acc[0][2] += g0 * v1.x;
      acc[0][3] += g0 * v1.y;
      acc[1][0] += g1 * v0.x;
      acc[1][1] += g1 * v0.y;
      acc[1][2] += g1 * v1.x;
      acc[1][3] += g1 * v1.y;
    }
  }
  // dots[own] = sum_j gZ Z of the own row: dir 0 holds rows 4 warp + u over
  // the lanes, dir 1 row lane over the warps.
  if (dir == 0) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float t = dclip::warp_sum(zd[u]);
      if (lane == 0) dots[4 * warp + u] = t;
    }
  } else {
    zpart[warp][lane] = zd[0] + zd[1] + zd[2] + zd[3];
    __syncthreads();
    if (tid < kGradRows) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) t += zpart[w][tid];
      dots[tid] = t;
    }
  }
  __syncthreads();
  const int col = c0 + 4 * tx;
  if (col >= d) return;
  const __nv_bfloat16* self = dir == 0 ? si : st;
  const float* teacher = dir == 0 ? ti : tt;
  const float* inv_self = dir == 0 ? sc.inv_i : sc.inv_t;
  const float* inv_teacher = dir == 0 ? sc.inv_ti : sc.inv_tt;
  const float* cos_self = dir == 0 ? sc.cos_i : sc.cos_t;
  __nv_bfloat16* outp = dir == 0 ? dsi : dst;
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int r = ty + 16 * x, i = i0 + r;
    if (i >= b) continue;
    // g = acc - (c_cos / B) t^;  <g, s^> = T sum_j gZ Z - (c_cos / B) cos.
    const float tcoef = -(c_cos / b) * inv_teacher[i], is = inv_self[i];
    const float dot = temperature * dots[r] - (c_cos / b) * cos_self[i];
    const size_t at = static_cast<size_t>(i) * d + col;
    const float4 t4 = *reinterpret_cast<const float4*>(teacher + at);
    const uint2 raw = *reinterpret_cast<const uint2*>(self + at);
    const float2 x0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 x1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    const float tv[4] = {t4.x, t4.y, t4.z, t4.w}, sv[4] = {x0.x, x0.y, x1.x, x1.y};
    float gv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) gv[e] = ((acc[x][e] + tcoef * tv[e]) - dot * (sv[e] * is)) * is;
    __nv_bfloat162 h[2] = {__floats2bfloat162_rn(gv[0], gv[1]),
                           __floats2bfloat162_rn(gv[2], gv[3])};
    *reinterpret_cast<uint2*>(outp + at) = *reinterpret_cast<const uint2*>(h);
  }
}

int tiles(const void* si, const void* st, const void* ti, const void* tt, void* scratch,
          void* z, void* tickets, void* out, int b, int d, float temperature, float weight,
          cudaStream_t stream) {
  // The opt-in past 48 KB counts the static arrays too (under 5 KB).
  const int smem = 2 * kTile * strip_ld(d) * static_cast<int>(sizeof(__nv_bfloat16));
  if (smem + 5 * 1024 > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        distill_tiles_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int nt = (b + kTile - 1) / kTile;
  distill_tiles_kernel<<<dim3(nt, nt), kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(si), static_cast<const __nv_bfloat16*>(st),
      static_cast<const float*>(ti), static_cast<const float*>(tt), static_cast<float*>(scratch),
      static_cast<float*>(z), static_cast<unsigned*>(tickets), static_cast<float*>(out), b, d,
      temperature, weight);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// si, st: [b, d] bf16; ti, tt: [b, d] f32; scratch: 8 nt b + 9 round4(b)
// f32 and tickets: 1 + 2 nt unsigned, nt = ceil(b / 32) (the tickets
// 0 at the launch and used by no other launch in flight); out: [4] f32 (li, lt,
// lc, total). All contiguous, 16-byte aligned, d % 8 == 0, d <= 1536.
extern "C" int dclip_distill_loss_fwd(const void* si, const void* st, const void* ti,
                                      const void* tt, void* scratch, void* tickets, void* out,
                                      int b, int d, float temperature, float weight,
                                      void* stream) {
  return tiles(si, st, ti, tt, scratch, nullptr, tickets, out, b, d, temperature, weight,
               static_cast<cudaStream_t>(stream));
}

// As above; z: [b, round4(b)] f32 scratch; cts: [3] f32 device (c_li,
// c_lt, c_lc); dsi, dst: [b, d] bf16.
extern "C" int dclip_distill_loss_bwd(const void* si, const void* st, const void* ti,
                                      const void* tt, void* scratch, void* z, void* tickets,
                                      const void* cts, void* dsi, void* dst, int b, int d,
                                      float temperature, void* stream) {
  using B16 = __nv_bfloat16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = tiles(si, st, ti, tt, scratch, z, tickets, nullptr, b, d, temperature, 0.f, s);
  if (err != 0) return err;
  const dim3 grid((b + kGradRows - 1) / kGradRows, (d + kGradCols - 1) / kGradCols, 2);
  distill_grad_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const B16*>(si), static_cast<const B16*>(st), static_cast<const float*>(ti),
      static_cast<const float*>(tt), static_cast<float*>(scratch), static_cast<const float*>(z),
      static_cast<const float*>(cts), static_cast<B16*>(dsi), static_cast<B16*>(dst), b, d,
      temperature);
  return static_cast<int>(cudaGetLastError());
}
