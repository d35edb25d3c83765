// Flash attention forward for Hopper (sm_90a): out = softmax(q·kᵀ·d^-0.5 + bias)·v.
//
// Replaces the TPU kernel `_flash_kernel` of prisma_tpu/ops/pallas/flash_attention.py
// (entry `flash_attention`) in both of its forms:
// - K1, the bias-free form (kernels flash_fwd_bf16 / flash_fwd_f32);
// - K2, the region-bias form that GMFlow's shifted windows use (kernels flash_region_bf16 /
//   flash_region_f32): tokens on opposite sides of a region boundary attend with an
//   additive -100 on the scaled f32 score. Two ways to give the regions, as the TPU entry:
//   `bands` ([nwin, 2] int32 (bh, bw) per window, with `win_w` the window's token-row
//   width; batch row b is window b % nwin, token j's code is
//   2·(j >= bh·win_w) + (j % win_w >= bw)), or `ids` ([B, N] int32 labels).
//   The TPU kernel folds the `ids` labels into one-hot qk lanes and computes the band
//   codes with unrolled subtracts; here each key tile's codes are computed once into
//   shared memory and each query row's code once into a register.
// q, k, v and out are [B, N, d], contiguous; B folds batch, heads and windows. The softmax
// state (running max, running sum) and the output accumulator are f32 whatever the input
// type; the scale is applied to the f32 scores.
//
// What bounds it on this card: only q, k, v and out cross HBM (the [N, N] scores never
// leave the SM). At the main-path shapes the two products, 4·B·N²·d operations, take
// ~100x longer at the bf16 tensor-core peak than those bytes at the HBM rate, so the
// bound is the tensor cores. Next come the B·N² exp2 of the softmax on the SFUs (16 a
// clock per SM): per 128-key tile as many SM cycles as the products at d = 64, half as
// many at d = 128. And every CTA reads its batch row's K and V again from L2: 1/TQ bytes
// per operation, ~4 TB/s at d = 128 and the measured rate.
//
// Design of the bf16 kernels (FA3-shaped; Hopper's primitives as inline PTX in hopper.cuh,
// shared with K3; no CUTLASS):
// - one CTA per (batch row b, query tile) with a producer warpgroup, of which one warp
//   works, and consumer warpgroups of 64 query rows each: two (128-row tiles, 384
//   threads) at d = 128; three (192-row tiles, 512 threads) at d <= 64, where a tile's
//   exp2 take as long as its products and a third group keeps the tensor cores fed.
//   `setmaxnreg` moves registers from the producer (40 or 32 a thread) to the consumers
//   (232 or 160);
// - loads: the producer's TMA (`cp.async.bulk.tensor.3d`) brings the Q tile once and
//   128-key tiles of K and V into a ring of two slots each, with full and empty
//   `mbarrier`s: a K slot is refilled once every consumer warp has taken its tile's
//   softmax, a V slot once its P·V is done. The tensor maps are 3-D over [B, N, d], so
//   rows past N of one batch row read as zeros, never as the next row's keys; the host
//   encodes them per call (`cuTensorMapEncodeTiled`, fetched with
//   `cudaGetDriverEntryPoint`: no -lcuda) and passes them as `__grid_constant__`
//   parameters. Tiles land in 64-column atoms with the TMA's 128-byte swizzle (d = 64,
//   128) or in one 32-column atom with its 64-byte swizzle (d = 32): the layouts that the
//   wgmma descriptors name;
// - S = Q·Kᵀ: `wgmma.mma_async` m64n128k16 per 16 columns of d, Q and K K-major from
//   shared memory, S in registers (64 f32 a thread);
// - the online softmax runs on S in registers, in the accumulator's layout: a thread holds
//   32 columns of two rows, and a row's four threads join by two quad shuffles. The scale
//   is folded into one FFMA before a single `ex2.approx` a score. The region penalty (K2)
//   compares each key's code, written beside the K tile by the producer warp, with the
//   row's code in a register. A window whose bands are its own extent (one in four at
//   GMFlow's 2x2 split) has no boundary, and its CTAs skip the codes;
// - P·V: P rounded to bf16 in registers is the register A operand of a second wgmma,
//   m64n{d}k16, with V MN-major from shared memory (the transpose bit). It is issued
//   together with the next tile's S, and the group waits once for both. O stays in
//   registers across the key loop and is written once, with masked stores. The row sum
//   adds f32 P, per thread, and the four threads of a row join at the end;
// - the ragged last key tile: columns >= N get probability 0 (a zero-filled key scores 0,
//   not -inf, so it must be masked); query rows >= N are computed on zero rows and never
//   stored. N is not padded in memory.
// Left for later: this tile's softmax under the next tile's S in the same group (a second
// S in registers), TMA multicast of K and V to the CTAs of one batch row (a cluster, to
// halve the L2 reads), a persistent tile scheduler, and a TMA store of O.
//
// The f32 kernels are the parity path: one thread per query row, 64-row blocks, 32-key
// tiles in shared memory, plain FMAs. The bias-free and region forms are one templated
// body each, compiled into kernels of their own names so that a profiler tells them apart.

#include <climits>
#include <cmath>
#include <cstdint>

#include "hopper.cuh"  // mbarriers, TMA, wgmma descriptors and S = Q·Kᵀ, ex2, tensor maps

namespace {

using namespace hopper;

using bf16 = __nv_bfloat16;

// GMFlow's region penalty, 100, in the log2 domain the scores are carried in
constexpr float PENALTY_LOG2 = 100.f * 1.4426950408889634f;

// bf16 kernels (the query tile and the warpgroups per head dim: Tiles<D> below)
constexpr int TK = 128;         // keys per tile
constexpr int STAGES = 2;       // K/V tiles in the ring

// f32 kernels
constexpr int BQ = 64;          // query rows per block
constexpr int BK_F32 = 32;      // keys per tile

// Where the region codes come from: none (K1), per-window bands or per-token ids (K2).
enum Mode { NONE = 0, BANDS = 1, IDS = 2 };

struct Region {
  int mode;
  const int* bands;  // [nwin, 2] (bh, bw) when mode == BANDS
  const int* ids;    // [B, N] labels when mode == IDS
  int nwin;
  int win_w;
};

// The region code of token j of batch row b (j < n).
__device__ __forceinline__ int region_code(const Region& rg, int b, int j, int n) {
  if (rg.mode == IDS) return rg.ids[size_t(b) * n + j];
  const int win = b % rg.nwin;
  const int bh = rg.bands[2 * win];
  const int bw = rg.bands[2 * win + 1];
  return 2 * (j >= bh * rg.win_w) + ((j % rg.win_w) >= bw);
}

// False where every token of batch row b has code 0: bands that are the window's extent.
__device__ __forceinline__ bool has_boundary(const Region& rg, int b, int n) {
  if (rg.mode != BANDS) return rg.mode == IDS;
  const int win = b % rg.nwin;
  return rg.bands[2 * win] * rg.win_w < n || rg.bands[2 * win + 1] < rg.win_w;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The P·V forms of wgmma, A in registers at m64n{32,64,128}k16, with every accumulator
// register named (inline PTX takes no arrays). S = Q·Kᵀ is hopper::issue_qk.

// d += A·B, m64n32k16: A [64, 16] bf16 in registers, B [16, 32] MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d += A·B, m64n64k16: A [64, 16] bf16 in registers, B [16, 64] MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d += A·B, m64n128k16: A [64, 16] bf16 in registers, B [16, 128] MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// The plan of the bf16 kernels for head dim D: warpgroups, registers and shared memory
// (offsets from a 1024-byte aligned base: the 128-byte swizzle repeats every 8 rows of
// 128 bytes).
template <int D>
struct Tiles : Atoms<D> {
  // Consumer warpgroups of 64 query rows each. At d <= 64 a key tile's exp2 take the SM
  // as long as its products, so a third group keeps the tensor cores fed (FA3's choice).
  static constexpr int CONSUMERS = D <= 64 ? 3 : 2;
  static constexpr int TQ = 64 * CONSUMERS;              // query rows per CTA
  static constexpr int THREADS = (CONSUMERS + 1) * 128;  // and the producer warpgroup
  // setmaxnreg: the producer's registers go to the consumers; the totals equal the
  // launch's cap (65536 / THREADS, 168 or 128 a thread) times THREADS
  static constexpr int PRODUCER_REGS = CONSUMERS == 2 ? 40 : 32;
  static constexpr int CONSUMER_REGS = CONSUMERS == 2 ? 232 : 160;
  static_assert(PRODUCER_REGS * 128 + CONSUMER_REGS * 128 * CONSUMERS <= 65536, "registers");
  static constexpr int ATOMS = Atoms<D>::COUNT;
  static constexpr uint32_t Q_BYTES = TQ * D * 2;
  static constexpr uint32_t KV_BYTES = TK * D * 2;
  static constexpr uint32_t K_OFF = Q_BYTES;
  static constexpr uint32_t V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr uint32_t CODE_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr uint32_t BAR_OFF = CODE_OFF + STAGES * TK * sizeof(int);
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 4 * STAGES) + 1024;  // + alignment slack
};

// Barriers, 8 bytes each from BAR_OFF: Q full, then per stage K full, V full, K empty and
// V empty. K's full barrier takes the producer warp's 32 arrivals (each lane writes
// region codes first); an empty barrier takes one arrival from each consumer warp.
struct Bars {
  uint32_t q;
  __device__ __forceinline__ uint32_t k_full(int s) const { return q + 8 * (1 + s); }
  __device__ __forceinline__ uint32_t v_full(int s) const { return q + 8 * (1 + STAGES + s); }
  __device__ __forceinline__ uint32_t k_empty(int s) const {
    return q + 8 * (1 + 2 * STAGES + s);
  }
  __device__ __forceinline__ uint32_t v_empty(int s) const {
    return q + 8 * (1 + 3 * STAGES + s);
  }
};

// The producer warp: Q once, then each key tile's K (with its region codes) and V into
// the ring, each into its slot once every consumer warp has released the slot's last
// tile.
template <int D>
__device__ __forceinline__ void produce(const CUtensorMap& tq, const CUtensorMap& tk,
                                        const CUtensorMap& tv, uint32_t base, int* codes,
                                        int b, int q0, int n, bool biased, const Region& rg) {
  using T = Tiles<D>;
  const int lane = threadIdx.x & 31;
  const Bars bars{base + T::BAR_OFF};
  const int ntiles = (n + TK - 1) / TK;
  if (lane == 0) {
    mbar_arrive_expect_tx(bars.q, T::Q_BYTES);
#pragma unroll
    for (int a = 0; a < T::ATOMS; ++a)
      tma_load_3d(base + a * T::TQ * T::ROW_BYTES, &tq, bars.q, a * T::ATOM, q0, b);
  }
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % STAGES;
    const uint32_t free_parity = ((t / STAGES) & 1) ^ 1;  // the first round passes at once
    mbar_wait(bars.k_empty(s), free_parity);
    if (biased) {
      for (int i = lane; i < TK; i += 32) {
        const int j = t * TK + i;
        codes[s * TK + i] = j < n ? region_code(rg, b, j, n) : 0;
      }
    }
    if (lane == 0) {
      mbar_arrive_expect_tx(bars.k_full(s), T::KV_BYTES);
#pragma unroll
      for (int a = 0; a < T::ATOMS; ++a)
        tma_load_3d(base + T::K_OFF + s * T::KV_BYTES + a * TK * T::ROW_BYTES, &tk,
                    bars.k_full(s), a * T::ATOM, t * TK, b);
    } else {
      mbar_arrive(bars.k_full(s));
    }
    mbar_wait(bars.v_empty(s), free_parity);
    if (lane == 0) {
      mbar_arrive_expect_tx(bars.v_full(s), T::KV_BYTES);
#pragma unroll
      for (int a = 0; a < T::ATOMS; ++a)
        tma_load_3d(base + T::V_OFF + s * T::KV_BYTES + a * TK * T::ROW_BYTES, &tv,
                    bars.v_full(s), a * T::ATOM, t * TK, b);
    }
  }
}

// S = Q·Kᵀ for the key tile in slot st: issued, not waited on. The first product writes
// S without reading it, so S is not live across P·V.
template <int D>
__device__ __forceinline__ void issue_s(float (&s)[TK / 2], uint32_t q_tile, uint32_t base,
                                        int st) {
  using T = Tiles<D>;
  issue_qk<D>(s, q_tile, T::TQ, base + T::K_OFF + st * T::KV_BYTES);
}

// A consumer warpgroup: 64 query rows against every key tile. Thread (warp w, lane l)
// holds rows 16w + l/4 and 16w + l/4 + 8 of the group's 64, and in each 8-column chunk c
// of S (and of O) the columns 8c + 2(l % 4) and 8c + 2(l % 4) + 1: the wgmma accumulator
// layout, s[4c + 2i + j] = row i, column 8c + 2(l % 4) + j.
//
// Once tile t's softmax is done, a group issues P·V of tile t and S of tile t + 1
// together and waits once for both; the other groups' softmax runs under them. (A turn
// passed round the groups on named barriers, FA3's ping-pong, was slower here.)
template <int D, bool REGION>
__device__ __forceinline__ void consume(uint32_t base, const int* codes, bf16* __restrict__ o,
                                        int b, int q0, int n, bool biased, float scale_log2,
                                        const Region& rg) {
  using T = Tiles<D>;
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x & 31;
  const int quad = lane & 3;
  const int row0 = q0 + wg * 64 + warp * 16 + (lane >> 2);
  const int row1 = row0 + 8;
  int qc0 = 0, qc1 = 0;
  if (REGION && biased) {
    qc0 = row0 < n ? region_code(rg, b, row0, n) : 0;
    qc1 = row1 < n ? region_code(rg, b, row1, n) : 0;
  }
  const Bars bars{base + T::BAR_OFF};
  const uint32_t q_tile = base + wg * 64 * T::ROW_BYTES;  // this group's 64 rows of each atom
  const int ntiles = (n + TK - 1) / TK;

  float acc[D / 2];  // O, f32
  float s[TK / 2];   // S, then P in f32
  uint32_t p[TK / 4];  // P in bf16 pairs: the A fragments of P·V, four per 16 keys
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of the log2-domain scores
  float l0 = 0.f, l1 = 0.f;              // this thread's share of the running sum

  mbar_wait(bars.q, 0);
  mbar_wait(bars.k_full(0), 0);
  wgmma_fence();
  issue_s<D>(s, q_tile, base, 0);
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(s);

  for (int t = 0; t < ntiles; ++t) {
    const int st = t % STAGES;

    // The region penalty (K2) is taken on the scaled score, in place, and then f = 1;
    // otherwise S stays raw and f is the scale. The ragged tail gets -inf. Then the online
    // softmax, p = 2^(s·f - m): one FFMA and one ex2 a score.
    const int k0 = t * TK;
    const bool ragged = k0 + TK > n;
    const bool penalised = REGION && biased;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int c = 0; c < TK / 8; ++c) {
      int2 kc = make_int2(0, 0);
      if (penalised) kc = *reinterpret_cast<const int2*>(codes + st * TK + 8 * c + 2 * quad);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float x0 = s[4 * c + j];
        float x1 = s[4 * c + 2 + j];
        if (penalised) {
          const int code = j ? kc.y : kc.x;
          x0 = x0 * scale_log2 - (code != qc0 ? PENALTY_LOG2 : 0.f);
          x1 = x1 * scale_log2 - (code != qc1 ? PENALTY_LOG2 : 0.f);
        }
        if (ragged && k0 + 8 * c + 2 * quad + j >= n) x0 = x1 = -INFINITY;
        s[4 * c + j] = x0;
        s[4 * c + 2 + j] = x1;
        mx0 = fmaxf(mx0, x0);
        mx1 = fmaxf(mx1, x1);
      }
    }
    const float f = penalised ? 1.f : scale_log2;
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // every lane's maxima, and so its reads of the codes, are in: K's slot can go
    if (lane == 0) mbar_arrive(bars.k_empty(st));
    const float mn0 = fmaxf(m0, mx0 * f);  // finite: every tile has a valid column
    const float mn1 = fmaxf(m1, mx1 * f);
    const float alpha0 = ex2(m0 - mn0);
    const float alpha1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int c = 0; c < TK / 8; ++c) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float p0 = ex2(fmaf(s[4 * c + j], f, -mn0));
        const float p1 = ex2(fmaf(s[4 * c + 2 + j], f, -mn1));
        s[4 * c + j] = p0;
        s[4 * c + 2 + j] = p1;
        sum0 += p0;
        sum1 += p1;
      }
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
    // P to bf16, in the register A layout of m64k16: per 16 keys, (row 0, keys 2q..),
    // (row 1, keys 2q..), (row 0, keys 8 + 2q..), (row 1, keys 8 + 2q..)
#pragma unroll
    for (int i = 0; i < TK / 4; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      acc[4 * c] *= alpha0;
      acc[4 * c + 1] *= alpha0;
      acc[4 * c + 2] *= alpha1;
      acc[4 * c + 3] *= alpha1;
    }

    // once their tiles are in: O += P·V for tile t, and S for tile t + 1
    const bool more = t + 1 < ntiles;
    mbar_wait(bars.v_full(st), (t / STAGES) & 1);
    if (more) mbar_wait(bars.k_full((t + 1) % STAGES), ((t + 1) / STAGES) & 1);
    reg_fence(acc);
    reg_fence(p);
    wgmma_fence();
    const uint32_t v_tile = base + T::V_OFF + st * T::KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
      wgmma_rs(acc, a,
               smem_desc(v_tile + kk * 16 * T::ROW_BYTES, TK * T::ROW_BYTES, T::GROUP_BYTES,
                         T::SWIZZLE));
    }
    if (more) issue_s<D>(s, q_tile, base, (t + 1) % STAGES);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(acc);
    reg_fence(p);
    reg_fence(s);
    if (lane == 0) mbar_arrive(bars.v_empty(st));  // V of tile t is read
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0;
  const float inv1 = 1.f / l1;
  bf16* out0 = o + (size_t(b) * n + row0) * D + 2 * quad;
  bf16* out1 = out0 + 8 * D;
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    if (row0 < n)
      *reinterpret_cast<__nv_bfloat162*>(out0 + 8 * c) =
          __floats2bfloat162_rn(acc[4 * c] * inv0, acc[4 * c + 1] * inv0);
    if (row1 < n)
      *reinterpret_cast<__nv_bfloat162*>(out1 + 8 * c) =
          __floats2bfloat162_rn(acc[4 * c + 2] * inv1, acc[4 * c + 3] * inv1);
  }
}

template <int D, bool REGION>
__device__ __forceinline__ void flash_bf16_body(const CUtensorMap& tq, const CUtensorMap& tk,
                                                const CUtensorMap& tv, bf16* __restrict__ o,
                                                int n, int tiles, float scale_log2, Region rg) {
  using T = Tiles<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (1024 - (raw & 1023)) & 1023;
  const uint32_t base = raw + pad;
  int* codes = reinterpret_cast<int*>(smem_raw + pad + T::CODE_OFF);
  const int b = blockIdx.x / tiles;
  const int q0 = (blockIdx.x % tiles) * T::TQ;
  const bool biased = REGION && has_boundary(rg, b, n);

  if (threadIdx.x == 0) {
    const Bars bars{base + T::BAR_OFF};
    mbar_init(bars.q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars.k_full(s), 32);
      mbar_init(bars.v_full(s), 1);
      mbar_init(bars.k_empty(s), T::CONSUMERS * 4);
      mbar_init(bars.v_empty(s), T::CONSUMERS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // one if-else for the two roles, never rejoined, so that setmaxnreg holds
  if (threadIdx.x / 128 == T::CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(T::PRODUCER_REGS));
    if (threadIdx.x % 128 < 32)
      produce<D>(tq, tk, tv, base, codes, b, q0, n, biased, rg);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(T::CONSUMER_REGS));
    consume<D, REGION>(base, codes, o, b, q0, n, biased, scale_log2, rg);
  }
}

template <int D, bool REGION>
__device__ __forceinline__ void flash_f32_body(const float* __restrict__ q,
                                               const float* __restrict__ k,
                                               const float* __restrict__ v,
                                               float* __restrict__ o, int n, int tiles,
                                               float scale_log2, Region rg) {
  __shared__ float sk[BK_F32][D];
  __shared__ float sv[BK_F32][D];
  __shared__ float ss[BK_F32][BQ];  // each thread's scores of the tile, one column each
  __shared__ int kcode[BK_F32];
  const int b = blockIdx.x / tiles;
  const int row = (blockIdx.x % tiles) * BQ + threadIdx.x;
  const bool live = row < n;
  const size_t base = size_t(b) * n * D;
  const int qcode = (REGION && live) ? region_code(rg, b, row, n) : 0;

  float qr[D];
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = live ? q[base + size_t(row) * D + d] : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY;
  float l = 0.f;

  for (int k0 = 0; k0 < n; k0 += BK_F32) {
    __syncthreads();
    for (int i = threadIdx.x; i < BK_F32 * D; i += BQ) {
      const int r = i / D;
      const int c = i % D;
      const bool in = k0 + r < n;
      sk[r][c] = in ? k[base + size_t(k0 + r) * D + c] : 0.f;
      sv[r][c] = in ? v[base + size_t(k0 + r) * D + c] : 0.f;
    }
    if (REGION && threadIdx.x < BK_F32 && k0 + threadIdx.x < n)
      kcode[threadIdx.x] = region_code(rg, b, k0 + threadIdx.x, n);
    __syncthreads();

    // the key loops stay rolled (only the d loops unroll): the scores wait in
    // shared memory, which keeps the build of this parity path short
    const int valid = min(BK_F32, n - k0);
    float mx = -INFINITY;
#pragma unroll 1
    for (int j = 0; j < BK_F32; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], sk[j][d], dot);
      float s = j < valid ? dot * scale_log2 : -INFINITY;
      if (REGION && j < valid && kcode[j] != qcode) s -= PENALTY_LOG2;
      ss[j][threadIdx.x] = s;
      mx = fmaxf(mx, s);
    }
    const float m_new = fmaxf(m, mx);
    const float alpha = exp2f(m - m_new);
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= alpha;
    float sum = 0.f;
#pragma unroll 1
    for (int j = 0; j < BK_F32; ++j) {
      const float p = exp2f(ss[j][threadIdx.x] - m_new);
      sum += p;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(p, sv[j][d], acc[d]);
    }
    l = l * alpha + sum;
    m = m_new;
  }

  if (live) {
    const float inv = 1.f / l;
#pragma unroll
    for (int d = 0; d < D; ++d) o[base + size_t(row) * D + d] = acc[d] * inv;
  }
}

// K1: the bias-free kernels.
template <int D>
__global__ void __launch_bounds__(Tiles<D>::THREADS, 1)
flash_fwd_bf16(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, bf16* o, int n, int tiles,
               float scale_log2, Region rg) {
  flash_bf16_body<D, false>(tq, tk, tv, o, n, tiles, scale_log2, rg);
}

template <int D>
__global__ void __launch_bounds__(BQ)
flash_fwd_f32(const float* q, const float* k, const float* v, float* o, int n, int tiles,
              float scale_log2, Region rg) {
  flash_f32_body<D, false>(q, k, v, o, n, tiles, scale_log2, rg);
}

// K2: the region-bias kernels.
template <int D>
__global__ void __launch_bounds__(Tiles<D>::THREADS, 1)
flash_region_bf16(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, bf16* o, int n, int tiles,
                  float scale_log2, Region rg) {
  flash_bf16_body<D, true>(tq, tk, tv, o, n, tiles, scale_log2, rg);
}

template <int D>
__global__ void __launch_bounds__(BQ)
flash_region_f32(const float* q, const float* k, const float* v, float* o, int n, int tiles,
                 float scale_log2, Region rg) {
  flash_f32_body<D, true>(q, k, v, o, n, tiles, scale_log2, rg);
}

// Blocks for `batch` rows of `n` queries in tiles of `rows`; false if they overflow int.
bool grid_of(int batch, int n, int rows, int* tiles, int* blocks) {
  *tiles = (n + rows - 1) / rows;
  const long long nb = static_cast<long long>(batch) * *tiles;
  *blocks = static_cast<int>(nb);
  return nb <= INT_MAX;
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, int batch, int n,
                        float scale_log2, const Region& rg, cudaStream_t stream) {
  using T = Tiles<D>;
  int tiles, blocks;
  if (!grid_of(batch, n, T::TQ, &tiles, &blocks)) return cudaErrorInvalidValue;
  CUtensorMap maps[3];
  const void* src[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {  // Q in boxes of the query tile, K and V of the key tile
    const cudaError_t err = encode_tensor_map<D>(&maps[i], src[i], batch, n, i ? TK : T::TQ);
    if (err != cudaSuccess) return err;
  }
  const int smem = T::SMEM;
  static SmemCap fwd_cap, region_cap;  // one per kernel of this instantiation
  auto kernel = rg.mode == NONE ? flash_fwd_bf16<D> : flash_region_bf16<D>;
  const cudaError_t err = (rg.mode == NONE ? fwd_cap : region_cap)
                              .raise(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, T::THREADS, smem, stream>>>(maps[0], maps[1], maps[2],
                                               static_cast<bf16*>(o), n, tiles, scale_log2, rg);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int batch, int n,
                       float scale_log2, const Region& rg, cudaStream_t stream) {
  int tiles, blocks;
  if (!grid_of(batch, n, BQ, &tiles, &blocks)) return cudaErrorInvalidValue;
  auto kernel = rg.mode == NONE ? flash_fwd_f32<D> : flash_region_f32<D>;
  kernel<<<blocks, BQ, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), n, tiles, scale_log2, rg);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. d: 32, 64 or 128. mode: 0 = no bias (K1), 1 = bands
// (`bands` [nwin, 2] int32 with win_w > 0, batch a multiple of nwin), 2 = ids (`ids`
// [batch, n] int32). Launches on `stream` and returns the cudaError_t of the launch (0 on
// success); it does not synchronise.
extern "C" int prisma_flash_attention(const void* q, const void* k, const void* v, void* o,
                                      int batch, int n, int d, int dtype, int mode,
                                      const void* bands, const void* ids, int nwin, int win_w,
                                      void* stream) {
  if (batch <= 0 || n <= 0) return cudaErrorInvalidValue;
  if (mode == BANDS && (bands == nullptr || nwin <= 0 || batch % nwin || win_w <= 0))
    return cudaErrorInvalidValue;
  if (mode == IDS && ids == nullptr) return cudaErrorInvalidValue;
  if (mode != NONE && mode != BANDS && mode != IDS) return cudaErrorInvalidValue;
  const Region rg{mode, static_cast<const int*>(bands), static_cast<const int*>(ids), nwin,
                  win_w};
  const float scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(d));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    switch (d) {
      case 32: return launch_bf16<32>(q, k, v, o, batch, n, scale_log2, rg, s);
      case 64: return launch_bf16<64>(q, k, v, o, batch, n, scale_log2, rg, s);
      case 128: return launch_bf16<128>(q, k, v, o, batch, n, scale_log2, rg, s);
    }
  } else if (dtype == 0) {
    switch (d) {
      case 32: return launch_f32<32>(q, k, v, o, batch, n, scale_log2, rg, s);
      case 64: return launch_f32<64>(q, k, v, o, batch, n, scale_log2, rg, s);
      case 128: return launch_f32<128>(q, k, v, o, batch, n, scale_log2, rg, s);
    }
  }
  return cudaErrorInvalidValue;
}
