// Streamed global attention for Hopper (sm_90a): out = softmax(q·kᵀ·scale)·v with a
// narrow f32 v, for GMFlow's global matching (v = the pixel grid) and global flow
// propagation (v = the flow).
//
// Replaces the TPU kernel `_flash_kernel_streamed` of
// prisma_tpu/ops/pallas/flash_attention.py (entry `flash_attention_streamed`).
// q [B, N, d] and k [B, M, d] (N != M allowed) are bf16 or f32, contiguous; v [B, M, dv] is
// f32 with 1 <= dv <= 4; out [B, N, dv] is f32. The scale is the caller's.
//
// Numerics: scores, softmax state and the output are f32. P·V runs in f32 by FMA with P
// NOT rounded: v holds pixel coordinates up to ~1440, and rounding P to bf16, as the
// attention kernel does for its bf16 P·V, would cost about 2^-9 · 1440 ≈ 3 px. The TPU
// kernel sums its denominator from the weights as they multiply v
// (`pv = p.astype(v.dtype)`); with f32 v that rule reduces to l = Σp, which is what this
// kernel sums. The TPU's bf16 hi/lo split of v (models/gmflow.py `_global_attend`) was a
// workaround for its bf16 matrix unit and has no counterpart here.
//
// Design (one simple, correct kernel; speed is later work):
// - one thread block per (row b, 64-query tile); a loop inside the block walks 64-key
//   tiles of K (and the matching rows of v) staged in shared memory, with an online
//   softmax in f32. Nothing is padded in memory: keys past M load as zeros and get
//   probability 0, query rows past N are computed but never stored;
// - bf16 q, k: four warps of 16 query rows; S = Q·Kᵀ on the tensor cores through
//   nvcuda::wmma bf16 16x16x16 fragments with f32 accumulation, into a per-warp f32
//   scratch; two lanes own each row, each keeps a partial denominator and a partial
//   P·V over its half of the columns (both rescaled by the row's common alpha), and
//   the two halves are joined once at the end;
// - f32 q, k (the parity path): one thread per query row, plain FMAs.
//
// What bounds it on this card: at the matching shape (B=7, N=M=18360, d=128) it does
// 2·B·N·M·d = 604 GFLOP of bf16 products (0.61 ms at the 989 TFLOP/s tensor-core peak),
// 2.36e9 exp2 (0.57 ms at 16 results per clock per SM on the special-function units), and
// 2·B·N·M·dv = 9.4 GFLOP of f32 FMAs, while q, k, v and out are 66 MB: it is bound by
// operations, the tensor cores first and the exp2 a close second. The simple design
// leaves on the table: wgmma, asynchronous (TMA or cp.async) loads overlapped with
// compute, and keeping S in registers instead of round-tripping it through shared memory.

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
constexpr int DV = 4;              // v columns held per key (dv <= 4, zero-filled)

template <int D>
struct Layout {
  static constexpr int LDH = D + 8;   // bf16 row stride of the q and k tiles
  static constexpr int LDS = BK + 4;  // f32 row stride of the score scratch
  static constexpr size_t QK_BYTES = size_t(BQ + BK) * LDH * sizeof(bf16);
  static constexpr size_t V_BYTES = size_t(BK) * DV * sizeof(float);
  static constexpr size_t SCR_BYTES = size_t(WARPS) * 16 * LDS * sizeof(float);
  static constexpr size_t SMEM = QK_BYTES + V_BYTES + SCR_BYTES;
};

// Copies rows [row0, row0 + 64) of a [n, D] bf16 matrix into a padded shared tile;
// rows past n are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int row0, int n) {
  constexpr int LDH = Layout<D>::LDH;
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

// Copies rows [row0, row0 + rows) of a [m, dv] f32 matrix into a [rows, DV] shared tile,
// zero-filling the columns past dv and the rows past m.
__device__ __forceinline__ void load_v(float* dst, const float* src, int row0, int rows,
                                       int m, int dv, int threads) {
  for (int i = threadIdx.x; i < rows * DV; i += threads) {
    const int r = i / DV;
    const int c = i % DV;
    dst[i] = (row0 + r < m && c < dv) ? src[size_t(row0 + r) * dv + c] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_streamed_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o, int n, int m,
                    int dv, int tiles, float scale_log2) {
  using L = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sk = sq + BQ * L::LDH;
  float* sv = reinterpret_cast<float*>(smem + L::QK_BYTES);
  float* scr_all = reinterpret_cast<float*>(smem + L::QK_BYTES + L::V_BYTES);

  const int b = blockIdx.x / tiles;
  const int q0 = (blockIdx.x % tiles) * BQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* scr = scr_all + warp * 16 * L::LDS;
  // lane (r, h) owns row r of the warp's 16 and the columns c with c % 2 == h
  const int r = lane >> 1;
  const int h = lane & 1;
  const bf16* kb = k + size_t(b) * m * D;
  const float* vb = v + size_t(b) * m * dv;

  load_tile<D>(sq, q + size_t(b) * n * D, q0, n);

  float mrun = -INFINITY;  // running max of the log2-domain scores (row-uniform)
  float l = 0.f;           // this lane's part of the softmax denominator
  float acc[DV] = {0.f, 0.f, 0.f, 0.f};  // this lane's part of P·V

  for (int k0 = 0; k0 < m; k0 += BK) {
    __syncthreads();  // the previous tile is consumed (and the q tile is visible)
    load_tile<D>(sk, kb, k0, m);
    load_v(sv, vb, k0, BK, m, dv, THREADS);
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

    const int valid = min(BK, m - k0);  // >= 1
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      const int c = 2 * j + h;
      if (c < valid) mx = fmaxf(mx, scr[r * L::LDS + c] * scale_log2);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(mrun, mx);  // finite: the tile has a valid column
    const float alpha = exp2f(mrun - m_new);
    l *= alpha;
#pragma unroll
    for (int e = 0; e < DV; ++e) acc[e] *= alpha;
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      const int c = 2 * j + h;
      if (c < valid) {
        const float p = exp2f(scr[r * L::LDS + c] * scale_log2 - m_new);
        l += p;
        const float4 vv = *reinterpret_cast<const float4*>(sv + c * DV);
        acc[0] = fmaf(p, vv.x, acc[0]);
        acc[1] = fmaf(p, vv.y, acc[1]);
        acc[2] = fmaf(p, vv.z, acc[2]);
        acc[3] = fmaf(p, vv.w, acc[3]);
      }
    }
    mrun = m_new;
    __syncwarp();
  }

  // join the two lanes of each row
  l += __shfl_xor_sync(0xffffffffu, l, 1);
#pragma unroll
  for (int e = 0; e < DV; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], 1);
  const int row = q0 + warp * 16 + r;
  if (row < n && h == 0) {
    const float inv = 1.f / l;
    float* dst = o + (size_t(b) * n + row) * dv;
    for (int e = 0; e < dv; ++e) dst[e] = acc[e] * inv;
  }
}

template <int D>
__global__ void __launch_bounds__(BQ)
flash_streamed_f32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ o, int n, int m,
                   int dv, int tiles, float scale_log2) {
  __shared__ float sk[BK_F32][D];
  __shared__ __align__(16) float sv[BK_F32 * DV];
  const int b = blockIdx.x / tiles;
  const int row = (blockIdx.x % tiles) * BQ + threadIdx.x;
  const bool live = row < n;
  const float* kb = k + size_t(b) * m * D;
  const float* vb = v + size_t(b) * m * dv;

  float qr[D];
#pragma unroll
  for (int d = 0; d < D; ++d) qr[d] = live ? q[(size_t(b) * n + row) * D + d] : 0.f;
  float acc[DV] = {0.f, 0.f, 0.f, 0.f};
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
    for (int e = 0; e < DV; ++e) acc[e] *= alpha;
#pragma unroll
    for (int j = 0; j < BK_F32; ++j) {
      const float p = exp2f(s[j] - m_new);
      l += p;
#pragma unroll
      for (int e = 0; e < DV; ++e) acc[e] = fmaf(p, sv[j * DV + e], acc[e]);
    }
    mrun = m_new;
  }

  if (live) {
    const float inv = 1.f / l;
    float* dst = o + (size_t(b) * n + row) * dv;
    for (int e = 0; e < dv; ++e) dst[e] = acc[e] * inv;
  }
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, int n, int m,
                        int dv, int tiles, int blocks, float scale_log2, cudaStream_t stream) {
  const size_t smem = Layout<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(flash_streamed_bf16<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  flash_streamed_bf16<D><<<blocks, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), n, m, dv, tiles, scale_log2);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int n, int m,
                       int dv, int tiles, int blocks, float scale_log2, cudaStream_t stream) {
  flash_streamed_f32<D><<<blocks, BQ, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), n, m, dv, tiles, scale_log2);
  return cudaGetLastError();
}

}  // namespace

// dtype (of q and k): 0 = float32, 1 = bfloat16. d: 32, 64 or 128. v and out are f32,
// 1 <= dv <= 4. Launches on `stream` and returns the cudaError_t of the launch (0 on
// success); it does not synchronise.
extern "C" int prisma_flash_attention_streamed(const void* q, const void* k, const void* v,
                                               void* o, int batch, int n, int m, int d,
                                               int dv, int dtype, float scale, void* stream) {
  if (batch <= 0 || n <= 0 || m <= 0 || dv < 1 || dv > DV) return cudaErrorInvalidValue;
  const int tiles = (n + BQ - 1) / BQ;
  const long long blocks = static_cast<long long>(batch) * tiles;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const float scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = static_cast<int>(blocks);
  if (dtype == 1) {
    switch (d) {
      case 32: return launch_bf16<32>(q, k, v, o, n, m, dv, tiles, nb, scale_log2, s);
      case 64: return launch_bf16<64>(q, k, v, o, n, m, dv, tiles, nb, scale_log2, s);
      case 128: return launch_bf16<128>(q, k, v, o, n, m, dv, tiles, nb, scale_log2, s);
    }
  } else if (dtype == 0) {
    switch (d) {
      case 32: return launch_f32<32>(q, k, v, o, n, m, dv, tiles, nb, scale_log2, s);
      case 64: return launch_f32<64>(q, k, v, o, n, m, dv, tiles, nb, scale_log2, s);
      case 128: return launch_f32<128>(q, k, v, o, n, m, dv, tiles, nb, scale_log2, s);
    }
  }
  return cudaErrorInvalidValue;
}
