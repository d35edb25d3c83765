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
// Design (one simple, correct kernel; speed is later work):
// - one thread block per (row b, 64-query tile); a loop inside the block walks 64-key
//   tiles of K and V staged in shared memory, with an online softmax in f32;
// - bf16 inputs: four warps, each owning 16 query rows; S = Q·Kᵀ and P·V run on the
//   tensor cores through nvcuda::wmma bf16 16x16x16 fragments with f32 accumulation.
//   P is rounded to bf16 before P·V, as the TPU kernel does; the row sum uses f32 P;
// - f32 inputs: one thread per query row, plain FMAs (the parity path);
// - the ragged last key tile is masked (its zero-filled rows get probability 0) and
//   query rows past N are computed but never stored. N is not padded in memory.
// The bias-free and region forms are one templated body, compiled into kernels of their
// own names so that a profiler tells them apart.
//
// What bounds it on this card: only q, k, v and out cross HBM (the [N, N] scores never
// leave the SM), so the kernel is bound by tensor-core issue and by the f32 softmax
// passes over each 16x64 score tile, which go through shared memory (the region compare
// adds one shared-memory read and one integer compare per score). The simple design
// leaves on the table: wgmma (the legacy mma.sync path behind wmma runs at a fraction of
// Hopper's peak), TMA or cp.async loads overlapped with compute (loads here are
// synchronous, so every tile waits on memory), keeping S and P in registers instead of
// round-tripping them through shared memory, and warp specialisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int BQ = 64;             // query rows per block
constexpr int BK = 64;             // keys per tile (bf16 kernel)
constexpr int WARPS = BQ / 16;     // each warp owns 16 query rows
constexpr int THREADS = WARPS * 32;
constexpr int BK_F32 = 32;         // keys per tile (f32 kernel)
// GMFlow's region penalty, 100, in the log2 domain the scores are carried in
constexpr float PENALTY_LOG2 = 100.f * 1.4426950408889634f;

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

template <int D>
struct Bf16Layout {
  static constexpr int LDH = D + 8;                     // bf16 row stride of the q, k, v tiles
  static constexpr int LDS = (BK > D ? BK : D) + 4;     // f32 row stride of the S / P·V scratch
  static constexpr int LDP = BK + 8;                    // bf16 row stride of P
  static constexpr size_t QKV_BYTES = size_t(BQ + 2 * BK) * LDH * sizeof(bf16);
  static constexpr size_t SCR_BYTES = size_t(WARPS) * 16 * LDS * sizeof(float);
  static constexpr size_t P_BYTES = size_t(WARPS) * 16 * LDP * sizeof(bf16);
  static constexpr size_t CODE_BYTES = size_t(BK) * sizeof(int);
  static constexpr size_t SMEM = QKV_BYTES + SCR_BYTES + P_BYTES + CODE_BYTES;
};

// Copies rows [row0, row0 + 64) of a [n, D] bf16 matrix into a padded shared tile;
// rows past n are zero-filled, so the masked keys contribute finite zeros to P·V.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int row0, int n) {
  constexpr int LDH = Bf16Layout<D>::LDH;
  constexpr int VEC = 8;  // bf16 per 16-byte load
  constexpr int PER_ROW = D / VEC;
  for (int i = threadIdx.x; i < 64 * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW;
    const int c = (i % PER_ROW) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n) val = *reinterpret_cast<const uint4*>(src + size_t(row0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * LDH + c) = val;
  }
}

template <int D, bool REGION>
__device__ __forceinline__ void flash_bf16_body(const bf16* __restrict__ q,
                                                const bf16* __restrict__ k,
                                                const bf16* __restrict__ v,
                                                bf16* __restrict__ o, int n, int tiles,
                                                float scale_log2, Region rg) {
  using L = Bf16Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sk = sq + BQ * L::LDH;
  bf16* sv = sk + BK * L::LDH;
  float* scr_all = reinterpret_cast<float*>(smem + L::QKV_BYTES);
  bf16* p_all = reinterpret_cast<bf16*>(smem + L::QKV_BYTES + L::SCR_BYTES);
  int* kcode = reinterpret_cast<int*>(smem + L::QKV_BYTES + L::SCR_BYTES + L::P_BYTES);

  const int b = blockIdx.x / tiles;
  const int q0 = (blockIdx.x % tiles) * BQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t base = size_t(b) * n * D;
  float* scr = scr_all + warp * 16 * L::LDS;
  bf16* pw = p_all + warp * 16 * L::LDP;
  // lane (r, h) owns row r of the warp's 16 and the columns c with c % 2 == h
  const int r = lane >> 1;
  const int h = lane & 1;
  const int row = q0 + warp * 16 + r;
  const int qcode = (REGION && row < n) ? region_code(rg, b, row, n) : 0;

  load_tile<D>(sq, q + base, q0, n);

  float m = -INFINITY;  // running max of the log2-domain scores
  float l = 0.f;        // running softmax denominator
  float acc[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;

  for (int k0 = 0; k0 < n; k0 += BK) {
    __syncthreads();  // the previous tile is consumed (and the q tile is visible)
    load_tile<D>(sk, k + base, k0, n);
    load_tile<D>(sv, v + base, k0, n);
    if (REGION && threadIdx.x < BK && k0 + threadIdx.x < n)
      kcode[threadIdx.x] = region_code(rg, b, k0 + threadIdx.x, n);
    __syncthreads();

    // S = Q_w · Kᵀ: [16, D] x [D, 64] -> scr
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> s_frag;
      wmma::fill_fragment(s_frag, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bt;
        wmma::load_matrix_sync(a, sq + warp * 16 * L::LDH + kk * 16, L::LDH);
        wmma::load_matrix_sync(bt, sk + j * 16 * L::LDH + kk * 16, L::LDH);
        wmma::mma_sync(s_frag, a, bt, s_frag);
      }
      wmma::store_matrix_sync(scr + j * 16, s_frag, L::LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // scaled scores (and the region penalty) in place, then the online softmax over
    // row r: two lanes per row, joined by one shuffle
    const int valid = min(BK, n - k0);  // >= 1
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      const int c = 2 * j + h;
      if (c < valid) {
        float s = scr[r * L::LDS + c] * scale_log2;
        if (REGION && kcode[c] != qcode) s -= PENALTY_LOG2;
        scr[r * L::LDS + c] = s;
        mx = fmaxf(mx, s);
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);  // finite: the tile has a valid column
    const float alpha = exp2f(m - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      const int c = 2 * j + h;
      const float p = c < valid ? exp2f(scr[r * L::LDS + c] - m_new) : 0.f;
      sum += p;
      pw[r * L::LDP + c] = __float2bfloat16(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l = l * alpha + sum;
    m = m_new;
    __syncwarp();

    // P_w · V: [16, 64] x [64, D] -> scr (the scores are consumed)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> o_frag;
      wmma::fill_fragment(o_frag, 0.f);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
        wmma::load_matrix_sync(a, pw + kk * 16, L::LDP);
        wmma::load_matrix_sync(bv, sv + kk * 16 * L::LDH + j * 16, L::LDH);
        wmma::mma_sync(o_frag, a, bv, o_frag);
      }
      wmma::store_matrix_sync(scr + j * 16, o_frag, L::LDS, wmma::mem_row_major);
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < D / 2; ++j) acc[j] = acc[j] * alpha + scr[r * L::LDS + 2 * j + h];
  }

  if (row < n) {
    const float inv = 1.f / l;
    bf16* dst = o + base + size_t(row) * D;
#pragma unroll
    for (int j = 0; j < D / 2; ++j) dst[2 * j + h] = __float2bfloat16(acc[j] * inv);
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
__global__ void __launch_bounds__(THREADS)
flash_fwd_bf16(const bf16* q, const bf16* k, const bf16* v, bf16* o, int n, int tiles,
               float scale_log2, Region rg) {
  flash_bf16_body<D, false>(q, k, v, o, n, tiles, scale_log2, rg);
}

template <int D>
__global__ void __launch_bounds__(BQ)
flash_fwd_f32(const float* q, const float* k, const float* v, float* o, int n, int tiles,
              float scale_log2, Region rg) {
  flash_f32_body<D, false>(q, k, v, o, n, tiles, scale_log2, rg);
}

// K2: the region-bias kernels.
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_region_bf16(const bf16* q, const bf16* k, const bf16* v, bf16* o, int n, int tiles,
                  float scale_log2, Region rg) {
  flash_bf16_body<D, true>(q, k, v, o, n, tiles, scale_log2, rg);
}

template <int D>
__global__ void __launch_bounds__(BQ)
flash_region_f32(const float* q, const float* k, const float* v, float* o, int n, int tiles,
                 float scale_log2, Region rg) {
  flash_f32_body<D, true>(q, k, v, o, n, tiles, scale_log2, rg);
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, int n,
                        int tiles, int blocks, float scale_log2, const Region& rg,
                        cudaStream_t stream) {
  const size_t smem = Bf16Layout<D>::SMEM;
  auto kernel = rg.mode == NONE ? flash_fwd_bf16<D> : flash_region_bf16<D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<blocks, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), n, tiles, scale_log2, rg);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int n,
                       int tiles, int blocks, float scale_log2, const Region& rg,
                       cudaStream_t stream) {
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
  const int tiles = (n + BQ - 1) / BQ;
  const long long blocks = static_cast<long long>(batch) * tiles;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const float scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(d));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = static_cast<int>(blocks);
  if (dtype == 1) {
    switch (d) {
      case 32: return launch_bf16<32>(q, k, v, o, n, tiles, nb, scale_log2, rg, s);
      case 64: return launch_bf16<64>(q, k, v, o, n, tiles, nb, scale_log2, rg, s);
      case 128: return launch_bf16<128>(q, k, v, o, n, tiles, nb, scale_log2, rg, s);
    }
  } else if (dtype == 0) {
    switch (d) {
      case 32: return launch_f32<32>(q, k, v, o, n, tiles, nb, scale_log2, rg, s);
      case 64: return launch_f32<64>(q, k, v, o, n, tiles, nb, scale_log2, rg, s);
      case 128: return launch_f32<128>(q, k, v, o, n, tiles, nb, scale_log2, rg, s);
    }
  }
  return cudaErrorInvalidValue;
}
