// Streamed global attention for Hopper (sm_90a): out = softmax(q·kᵀ·scale)·v with a
// narrow f32 v, for GMFlow's global matching (v = the pixel grid) and global flow
// propagation (v = the flow).
//
// Replaces the TPU kernel `_flash_kernel_streamed` of
// prisma_tpu/ops/pallas/flash_attention.py (entry `flash_attention_streamed`).
// q [B, N, d] and k [B, M, d] (N != M allowed) are bf16 or f32, contiguous, d in {32, 64,
// 128}; v [B, M, dv] is f32 with 1 <= dv <= 4; out [B, N, dv] is f32. The scale is the
// caller's and must be positive.
//
// Numerics: scores, softmax state and the output are f32. P·V runs in f32 by FMA with P
// NOT rounded: v holds pixel coordinates up to ~1440, and rounding P to bf16, as the
// attention kernel does for its bf16 P·V, would cost about 2^-9 · 1440 ≈ 3 px. The TPU
// kernel sums its denominator from the weights as they multiply v
// (`pv = p.astype(v.dtype)`); with f32 v that rule reduces to l = Σp, which is what this
// kernel sums. The TPU's bf16 hi/lo split of v (models/gmflow.py `_global_attend`) was a
// workaround for its bf16 matrix unit and has no counterpart here.
//
// What bounds it on this card: at the matching shape (B=7, N=M=18360, d=128) it does
// 2·B·N·M·d = 604 GFLOP of bf16 products (0.61 ms at the 989 TFLOP/s tensor-core peak) and
// B·N·M = 2.36e9 exp2 (0.56 ms at 16 results per clock per SM on the special-function
// units), while q, k, v and out are 66 MB. Per 128-key tile an SM spends about as many
// cycles in exp2 as in the product, so the two must overlap. And every CTA reads its batch
// row's whole K from L2 (4.7 MB at the matching shape): the query tile sets the L2 traffic.
//
// Design of the bf16 kernel (the Hopper primitives of hopper.cuh, as K1's):
// - one CTA per (batch row b, 256-query tile), CTAs batch-row-major so that the resident
//   ones share one or two rows' K in L2 (the propagation call's K, 66 MB, exceeds it);
//   256-row tiles read 2.4 GB of K from L2 a matching call (64-row tiles: 9.4 GB);
// - a producer warpgroup, of which one warp works, and two consumer warpgroups of 128
//   query rows each; `setmaxnreg` moves registers from the producer (40 a thread) to the
//   consumers (232);
// - loads: the producer's TMA brings the Q tile once and 128-key K tiles into a ring of
//   four slots with full and empty `mbarrier`s; the 3-D tensor maps over [B, N, d] and
//   [B, M, d] read rows past N or M as zeros. v's [M, dv] rows are under TMA's 16-byte box
//   minimum at dv = 2, so the same warp copies each tile's v rows with plain loads into
//   the slot as [128, DV] f32 (DV = 2 or 4: dv padded with zeros), bounds-checked against
//   M and zero past it (never reading past the end of v), and its 32 lanes arrive on the
//   slot's full barrier beside the TMA's bytes;
// - S = Q·Kᵀ: `wgmma.mma_async` m64n128k16 per 16 columns of d, Q and K K-major from
//   swizzled shared memory, S in registers (64 f32 a thread). Each consumer group holds
//   two 64-row blocks (A, B), so two S are in flight against one K tile: the softmax of
//   A(t) runs while the tensor cores compute B(t), and that of B(t) while they compute
//   A(t + 1). O is dv <= 4 floats a row, so the registers K1 spends on O hold the second S;
// - softmax and P·V in the accumulator's layout: a thread holds 32 columns (keys) of two
//   rows of each block; the row max joins over the quad by two shuffles, the scale is
//   folded into one FFMA before a single `ex2.approx` a score, and then l += p and
//   acc[e] += p·v[key][e] by FFMA, v read from shared memory, two keys' v in one 16-byte
//   load at dv <= 2. The quad's partial l and acc are joined once at the end; no S goes
//   through shared memory;
// - the ragged last key tile: keys >= M score 0 (zero-filled), not -inf, so they get
//   p = 0 explicitly; query rows >= N are computed on zero rows and never stored. Nothing
//   is padded in memory.
// Left for later: TMA multicast of each K tile to the CTAs of a 2-CTA cluster (halving the
// L2 reads again), a persistent tile scheduler (the matching call's 504 CTAs are 3.8
// waves on 132 SMs), and exp2 on the FMA pipes for part of the scores.
//
// The f32 kernel is the parity path: one thread per query row, 64-row blocks, 32-key tiles
// in shared memory, plain FMAs.

#include <climits>
#include <cmath>
#include <cstdint>

#include "hopper.cuh"  // mbarriers, TMA, wgmma descriptors and S = Q·Kᵀ, ex2, tensor maps

namespace {

using namespace hopper;

// bf16 kernel
constexpr int TK = 128;                     // keys per tile
constexpr int STAGES = 4;                   // K (and v) tiles in the ring
constexpr int CONSUMERS = 2;                // consumer warpgroups
constexpr int BLOCKS = 2;                   // 64-row blocks per consumer group
constexpr int TQ = 64 * BLOCKS * CONSUMERS;  // query rows per CTA
constexpr int THREADS = (CONSUMERS + 1) * 128;
// setmaxnreg: the producer's registers go to the consumers; the totals stay within the
// launch's 65536 / THREADS (170, so 168) registers a thread
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
static_assert(PRODUCER_REGS * 128 + CONSUMER_REGS * 128 * CONSUMERS <= 65536, "registers");

// f32 kernel
constexpr int BQ = 64;      // query rows per block
constexpr int BK_F32 = 32;  // keys per tile
constexpr int DV_F32 = 4;   // v columns held per key (dv <= 4, zero-filled)

// Shared memory of the bf16 kernel for head dim D and DV v columns a key, from a 1024-byte
// aligned base (the 128-byte swizzle repeats every 8 rows of 128 bytes): the Q tile, the
// ring's K and v slots, then the barriers.
template <int D, int DV>
struct Plan : Atoms<D> {
  static constexpr uint32_t Q_BYTES = TQ * D * 2;
  static constexpr uint32_t K_BYTES = TK * D * 2;
  static constexpr uint32_t V_BYTES = TK * DV * 4;
  static constexpr uint32_t K_OFF = Q_BYTES;
  static constexpr uint32_t V_OFF = K_OFF + STAGES * K_BYTES;
  static constexpr uint32_t BAR_OFF = V_OFF + STAGES * V_BYTES;
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;  // + alignment slack
  static_assert(SMEM <= 232448, "shared memory");
};

// Barriers, 8 bytes each from BAR_OFF: Q full, then per slot full and empty. A full
// barrier takes 33 arrivals (the TMA's expect_tx, then each producer lane once its v rows
// are written); an empty one takes one arrival from each consumer warp.
struct Bars {
  uint32_t q;
  __device__ __forceinline__ uint32_t full(int s) const { return q + 8 * (1 + s); }
  __device__ __forceinline__ uint32_t empty(int s) const { return q + 8 * (1 + STAGES + s); }
};

// The producer warp: Q once, then each key tile's K (TMA) and v rows (plain loads) into the
// ring, each into its slot once every consumer warp has released the slot's last tile.
template <int D, int DV>
__device__ __forceinline__ void produce(const CUtensorMap& tq, const CUtensorMap& tk,
                                        const float* __restrict__ v, float* sv, uint32_t base,
                                        int b, int q0, int m, int dv) {
  using P = Plan<D, DV>;
  const int lane = threadIdx.x & 31;
  const Bars bars{base + P::BAR_OFF};
  const int ntiles = (m + TK - 1) / TK;
  if (lane == 0) {
    mbar_arrive_expect_tx(bars.q, P::Q_BYTES);
#pragma unroll
    for (int a = 0; a < P::COUNT; ++a)
      tma_load_3d(base + a * TQ * P::ROW_BYTES, &tq, bars.q, a * P::ATOM, q0, b);
  }
  const float* vb = v + size_t(b) * m * dv;
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % STAGES;
    mbar_wait(bars.empty(s), ((t / STAGES) & 1) ^ 1);  // the first round passes at once
    if (lane == 0) {
      mbar_arrive_expect_tx(bars.full(s), P::K_BYTES);
#pragma unroll
      for (int a = 0; a < P::COUNT; ++a)
        tma_load_3d(base + P::K_OFF + s * P::K_BYTES + a * TK * P::ROW_BYTES, &tk,
                    bars.full(s), a * P::ATOM, t * TK, b);
    }
    // v rows [t·TK, t·TK + TK) as [TK, DV]: zero past m and past dv
    const int rows = min(TK, m - t * TK);
    const float* src = vb + size_t(t) * TK * dv;
    float* dst = sv + s * TK * DV;
    // in rounds of 8 loads in flight a lane (the producer has 40 registers)
#pragma unroll
    for (int i0 = 0; i0 < TK * DV / 32; i0 += 8) {
      float val[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = (lane + 32 * (i0 + i)) / DV;
        const int e = (lane + 32 * (i0 + i)) % DV;
        val[i] = r < rows && e < dv ? __ldg(src + r * dv + e) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) dst[lane + 32 * (i0 + i)] = val[i];
    }
    mbar_arrive(bars.full(s));
  }
}

// A thread's share of two rows (r and r + 8) of one 64-row block: running max of the
// log2-domain scores, and the partial sum and P·V over its 32 columns of each key tile.
template <int DV>
struct Rows {
  float m[2];
  float l[2];
  float acc[2][DV];
};

// One key tile's online softmax and P·V for one block, on S in the accumulator layout:
// s[4c + 2i + j] = row i, column 8c + 2·quad + j. sv is the tile's v, [TK, DV]. S is only
// read: a write to it while the other block's product is in flight would make ptxas
// serialize the wgmma. RAGGED (the last tile, k0 + TK > m) gives the keys >= m score -inf.
template <int DV, bool RAGGED>
__device__ __forceinline__ void softmax_pv(const float (&s)[TK / 2], Rows<DV>& r,
                                           const float* sv, int k0, int m,
                                           float scale_log2, int quad) {
  // the score in column 8c + 2·quad + j of row i, -inf past the last key
  auto score = [&](int c, int i, int j) {
    return RAGGED && k0 + 8 * c + 2 * quad + j >= m ? -INFINITY : s[4 * c + 2 * i + j];
  };
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int c = 0; c < TK / 8; ++c) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      mx0 = fmaxf(mx0, score(c, 0, j));
      mx1 = fmaxf(mx1, score(c, 1, j));
    }
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  // finite: every tile has a valid key; the max commutes with the positive scale
  const float mn0 = fmaxf(r.m[0], mx0 * scale_log2);
  const float mn1 = fmaxf(r.m[1], mx1 * scale_log2);
  const float alpha0 = ex2(r.m[0] - mn0);
  const float alpha1 = ex2(r.m[1] - mn1);
  r.m[0] = mn0;
  r.m[1] = mn1;
  r.l[0] *= alpha0;
  r.l[1] *= alpha1;
#pragma unroll
  for (int e = 0; e < DV; ++e) {
    r.acc[0][e] *= alpha0;
    r.acc[1][e] *= alpha1;
  }
#pragma unroll
  for (int c = 0; c < TK / 8; ++c) {
    // p = 2^(s·scale - m): one FFMA and one ex2 a score (2^-inf = 0 on the masked tail)
    const float p00 = ex2(fmaf(score(c, 0, 0), scale_log2, -mn0));
    const float p01 = ex2(fmaf(score(c, 0, 1), scale_log2, -mn0));
    const float p10 = ex2(fmaf(score(c, 1, 0), scale_log2, -mn1));
    const float p11 = ex2(fmaf(score(c, 1, 1), scale_log2, -mn1));
    r.l[0] += p00;
    r.l[0] += p01;
    r.l[1] += p10;
    r.l[1] += p11;
    // v of the thread's two keys of the chunk, 8c + 2·quad and the next
    const float4* vk = reinterpret_cast<const float4*>(sv + (8 * c + 2 * quad) * DV);
    if constexpr (DV == 2) {
      const float4 w = vk[0];  // (v0[0], v0[1], v1[0], v1[1])
      r.acc[0][0] = fmaf(p01, w.z, fmaf(p00, w.x, r.acc[0][0]));
      r.acc[0][1] = fmaf(p01, w.w, fmaf(p00, w.y, r.acc[0][1]));
      r.acc[1][0] = fmaf(p11, w.z, fmaf(p10, w.x, r.acc[1][0]));
      r.acc[1][1] = fmaf(p11, w.w, fmaf(p10, w.y, r.acc[1][1]));
    } else {
      const float4 w0 = vk[0];
      const float4 w1 = vk[1];
      r.acc[0][0] = fmaf(p01, w1.x, fmaf(p00, w0.x, r.acc[0][0]));
      r.acc[0][1] = fmaf(p01, w1.y, fmaf(p00, w0.y, r.acc[0][1]));
      r.acc[0][2] = fmaf(p01, w1.z, fmaf(p00, w0.z, r.acc[0][2]));
      r.acc[0][3] = fmaf(p01, w1.w, fmaf(p00, w0.w, r.acc[0][3]));
      r.acc[1][0] = fmaf(p11, w1.x, fmaf(p10, w0.x, r.acc[1][0]));
      r.acc[1][1] = fmaf(p11, w1.y, fmaf(p10, w0.y, r.acc[1][1]));
      r.acc[1][2] = fmaf(p11, w1.z, fmaf(p10, w0.z, r.acc[1][2]));
      r.acc[1][3] = fmaf(p11, w1.w, fmaf(p10, w0.w, r.acc[1][3]));
    }
  }
}

// Joins the quad's partial sums and writes rows row0 and row0 + 8 (those below n): lane
// `quad` of the quad writes column `quad`.
template <int DV>
__device__ __forceinline__ void store_rows(const Rows<DV>& r, float* __restrict__ o, int b,
                                           int row0, int n, int dv, int quad) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = r.l[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    float mine = 0.f;
#pragma unroll
    for (int e = 0; e < DV; ++e) {
      float a = r.acc[i][e];
      a += __shfl_xor_sync(0xffffffffu, a, 1);
      a += __shfl_xor_sync(0xffffffffu, a, 2);
      if (quad == e) mine = a;
    }
    const int row = row0 + 8 * i;
    if (row < n && quad < dv) o[(size_t(b) * n + row) * dv + quad] = mine / l;
  }
}

// What a consumer thread works with: its warpgroup's two 64-row blocks (A: the group's
// rows 0-63, B: 64-127) of the Q tile, the ring, and its share of each block's rows.
template <int D, int DV>
struct Consumer {
  using P = Plan<D, DV>;
  uint32_t base;   // the 1024-byte aligned shared-memory base
  uint32_t qa;     // block A's rows of each Q atom
  uint32_t qb;     // block B's
  const float* sv;  // the ring's v slots
  Bars bars;
  int m;
  int quad;
  int lane;
  float scale_log2;
  Rows<DV> ra, rb;

  __device__ __forceinline__ uint32_t k_tile(int t) const {
    return base + P::K_OFF + (t % STAGES) * P::K_BYTES;
  }

  // Key tile t, S_A(t) already in sa: S_B(t) runs under A(t)'s softmax and, if NEXT,
  // S_A(t + 1) under B(t)'s. Each wgmma group is waited on before the next is issued, and
  // the code between a group's issue and its wait is one basic block that reads only the
  // other block's S: so ptxas keeps the wgmma asynchronous (a branch there, a group in
  // flight across a loop's back edge or a write to S made it serialize them).
  template <bool RAGGED, bool NEXT>
  __device__ __forceinline__ void tile(int t, float (&sa)[TK / 2], float (&sb)[TK / 2]) {
    const float* v_t = sv + (t % STAGES) * TK * DV;
    wgmma_fence();
    issue_qk<D>(sb, qb, TQ, k_tile(t));
    wgmma_commit();
    softmax_pv<DV, RAGGED>(sa, ra, v_t, t * TK, m, scale_log2, quad);
    wgmma_wait<0>();
    reg_fence(sb);
    if constexpr (NEXT) {
      mbar_wait(bars.full((t + 1) % STAGES), ((t + 1) / STAGES) & 1);
      wgmma_fence();
      issue_qk<D>(sa, qa, TQ, k_tile(t + 1));
      wgmma_commit();
    }
    softmax_pv<DV, RAGGED>(sb, rb, v_t, t * TK, m, scale_log2, quad);
    __syncwarp();
    mbar_arrive_if(bars.empty(t % STAGES), lane == 0);  // the warp has read K and v of tile t
    if constexpr (NEXT) {
      wgmma_wait<0>();
      reg_fence(sa);
    }
  }
};

// A consumer warpgroup: its two 64-row blocks against every key tile, one block's S in
// flight while the other's softmax runs. Thread (warp w, lane l) holds rows 16w + l/4 and
// 16w + l/4 + 8 of each block.
template <int D, int DV>
__device__ __forceinline__ void consume(uint32_t base, const float* sv, float* __restrict__ o,
                                       int b, int q0, int n, int m, int dv, float scale_log2) {
  using P = Plan<D, DV>;
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x & 31;
  const uint32_t qa = base + wg * 128 * P::ROW_BYTES;
  Consumer<D, DV> c{base, qa, qa + 64 * P::ROW_BYTES, sv, Bars{base + P::BAR_OFF}, m,
                    lane & 3, lane, scale_log2};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    c.ra.m[i] = c.rb.m[i] = -INFINITY;
    c.ra.l[i] = c.rb.l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DV; ++e) c.ra.acc[i][e] = c.rb.acc[i][e] = 0.f;
  }

  float sa[TK / 2], sb[TK / 2];  // S of blocks A and B
  mbar_wait(c.bars.q, 0);
  mbar_wait(c.bars.full(0), 0);
  wgmma_fence();
  issue_qk<D>(sa, c.qa, TQ, c.k_tile(0));
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(sa);
  const int ntiles = (m + TK - 1) / TK;
  for (int t = 0; t + 1 < ntiles; ++t) c.template tile<false, true>(t, sa, sb);
  if (m % TK)  // only the last tile can be ragged
    c.template tile<true, false>(ntiles - 1, sa, sb);
  else
    c.template tile<false, false>(ntiles - 1, sa, sb);

  const int row0 = q0 + wg * 128 + warp * 16 + (lane >> 2);
  store_rows<DV>(c.ra, o, b, row0, n, dv, c.quad);
  store_rows<DV>(c.rb, o, b, row0 + 64, n, dv, c.quad);
}

template <int D, int DV>
__global__ void __launch_bounds__(THREADS, 1)
flash_streamed_bf16(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const float* __restrict__ v, float* __restrict__ o, int n, int m, int dv,
                    int tiles, float scale_log2) {
  using P = Plan<D, DV>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (1024 - (raw & 1023)) & 1023;
  const uint32_t base = raw + pad;
  float* sv = reinterpret_cast<float*>(smem_raw + pad + P::V_OFF);
  const int b = blockIdx.x / tiles;
  const int q0 = (blockIdx.x % tiles) * TQ;

  if (threadIdx.x == 0) {
    const Bars bars{base + P::BAR_OFF};
    mbar_init(bars.q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars.full(s), 33);
      mbar_init(bars.empty(s), CONSUMERS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // one if-else for the two roles, never rejoined, so that setmaxnreg holds
  if (threadIdx.x / 128 == CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (threadIdx.x % 128 < 32) produce<D, DV>(tq, tk, v, sv, base, b, q0, m, dv);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
    consume<D, DV>(base, sv, o, b, q0, n, m, dv, scale_log2);
  }
}

// Copies rows [row0, row0 + rows) of a [m, dv] f32 matrix into a [rows, DV_F32] shared
// tile, zero-filling the columns past dv and the rows past m.
__device__ __forceinline__ void load_v(float* dst, const float* src, int row0, int rows,
                                       int m, int dv, int threads) {
  for (int i = threadIdx.x; i < rows * DV_F32; i += threads) {
    const int r = i / DV_F32;
    const int c = i % DV_F32;
    dst[i] = (row0 + r < m && c < dv) ? src[size_t(row0 + r) * dv + c] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(BQ)
flash_streamed_f32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ o, int n, int m,
                   int dv, int tiles, float scale_log2) {
  __shared__ float sk[BK_F32][D];
  __shared__ __align__(16) float sv[BK_F32 * DV_F32];
  const int b = blockIdx.x / tiles;
  const int row = (blockIdx.x % tiles) * BQ + threadIdx.x;
  const bool live = row < n;
  const float* kb = k + size_t(b) * m * D;
  const float* vb = v + size_t(b) * m * dv;

  float qr[D];
#pragma unroll
  for (int d = 0; d < D; ++d) qr[d] = live ? q[(size_t(b) * n + row) * D + d] : 0.f;
  float acc[DV_F32] = {0.f, 0.f, 0.f, 0.f};
  float mrun = -INFINITY;
  float l = 0.f;

  for (int k0 = 0; k0 < m; k0 += BK_F32) {
    __syncthreads();
    for (int i = threadIdx.x; i < BK_F32 * D; i += BQ) {
      const int r = i / D;
      const int c = i % D;
      sk[r][c] = k0 + r < m ? kb[size_t(k0 + r) * D + c] : 0.f;
    }
    load_v(sv, vb, k0, BK_F32, m, dv, BQ);
    __syncthreads();

    const int valid = min(BK_F32, m - k0);
    float s[BK_F32];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK_F32; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], sk[j][d], dot);
      s[j] = j < valid ? dot * scale_log2 : -INFINITY;
      mx = fmaxf(mx, s[j]);
    }
    const float m_new = fmaxf(mrun, mx);
    const float alpha = exp2f(mrun - m_new);
    l *= alpha;
#pragma unroll
    for (int e = 0; e < DV_F32; ++e) acc[e] *= alpha;
#pragma unroll
    for (int j = 0; j < BK_F32; ++j) {
      const float p = exp2f(s[j] - m_new);
      l += p;
#pragma unroll
      for (int e = 0; e < DV_F32; ++e) acc[e] = fmaf(p, sv[j * DV_F32 + e], acc[e]);
    }
    mrun = m_new;
  }

  if (live) {
    const float inv = 1.f / l;
    float* dst = o + (size_t(b) * n + row) * dv;
    for (int e = 0; e < dv; ++e) dst[e] = acc[e] * inv;
  }
}

// Blocks for `batch` rows of `n` queries in tiles of `rows`; false if they overflow int.
bool grid_of(int batch, int n, int rows, int* tiles, int* blocks) {
  *tiles = (n + rows - 1) / rows;
  const long long nb = static_cast<long long>(batch) * *tiles;
  *blocks = static_cast<int>(nb);
  return nb <= INT_MAX;
}

template <int D, int DV>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, int batch, int n,
                        int m, int dv, float scale_log2, cudaStream_t stream) {
  using P = Plan<D, DV>;
  int tiles, blocks;
  if (!grid_of(batch, n, TQ, &tiles, &blocks)) return cudaErrorInvalidValue;
  CUtensorMap tq, tk;  // Q in boxes of the query tile, K of the key tile
  cudaError_t err = encode_tensor_map<D>(&tq, q, batch, n, TQ);
  if (err == cudaSuccess) err = encode_tensor_map<D>(&tk, k, batch, m, TK);
  static SmemCap cap;
  if (err == cudaSuccess) err = cap.raise(flash_streamed_bf16<D, DV>, P::SMEM);
  if (err != cudaSuccess) return err;
  flash_streamed_bf16<D, DV><<<blocks, THREADS, P::SMEM, stream>>>(
      tq, tk, static_cast<const float*>(v), static_cast<float*>(o), n, m, dv, tiles,
      scale_log2);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int batch, int n,
                       int m, int dv, float scale_log2, cudaStream_t stream) {
  int tiles, blocks;
  if (!grid_of(batch, n, BQ, &tiles, &blocks)) return cudaErrorInvalidValue;
  flash_streamed_f32<D><<<blocks, BQ, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), n, m, dv, tiles, scale_log2);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int batch, int n,
                   int m, int dv, int dtype, float scale_log2, cudaStream_t s) {
  if (dtype == 0) return launch_f32<D>(q, k, v, o, batch, n, m, dv, scale_log2, s);
  if (dtype != 1) return cudaErrorInvalidValue;
  return dv <= 2 ? launch_bf16<D, 2>(q, k, v, o, batch, n, m, dv, scale_log2, s)
                 : launch_bf16<D, 4>(q, k, v, o, batch, n, m, dv, scale_log2, s);
}

}  // namespace

// dtype (of q and k): 0 = float32, 1 = bfloat16. d: 32, 64 or 128. v and out are f32,
// 1 <= dv <= 4. scale > 0. Launches on `stream` and returns the cudaError_t of the launch
// (0 on success); it does not synchronise.
extern "C" int prisma_flash_attention_streamed(const void* q, const void* k, const void* v,
                                               void* o, int batch, int n, int m, int d,
                                               int dv, int dtype, float scale, void* stream) {
  if (batch <= 0 || n <= 0 || m <= 0 || dv < 1 || dv > 4) return cudaErrorInvalidValue;
  if (!(scale > 0.f) || !std::isfinite(scale)) return cudaErrorInvalidValue;
  const float scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch<32>(q, k, v, o, batch, n, m, dv, dtype, scale_log2, s);
    case 64: return launch<64>(q, k, v, o, batch, n, m, dv, dtype, scale_log2, s);
    case 128: return launch<128>(q, k, v, o, batch, n, m, dv, dtype, scale_log2, s);
  }
  return cudaErrorInvalidValue;
}
