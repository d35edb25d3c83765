// The mask band's epilogue for Hopper (sm_90a): the kept instances' composite and the
// capped SDF green channel, equal bit for bit to the plain versions in
// prisma_tpu_torch/ops/sdf.py (`kept_composite`, `sdf_green_device`).
//
// Replaces no TPU kernel: the JAX package computes both with jnp ops
// (prisma_tpu/ops/sdf.py, prisma_tpu/bands/mask_band.py), which XLA fuses. On this card
// the plain PyTorch version made one pass over device memory per operation: the
// composite wrote two f32 [N, H, W] temporaries a frame (N = 100 instance slots, ~3.9 GB
// of traffic a 1080p frame), and the SDF made 7 vertical and 133 horizontal passes over a
// [2, B, H, W] f32 tensor (~88 GB a batch of 8).
//
// What bounds the work: bytes. A batch needs the kept instances' mask bytes read once, the
// f32 composite and green written once, and nothing else (~0.2-0.35 GB a batch of 8 at
// 1080p, ~0.1 ms at 3.35 TB/s); the 133-tap minimum is ~4.4 G integer operations a batch.
// The design keeps everything else on chip:
//
// kept_composite_kernel: one launch over up to MAX_FRAMES frames, one pointer a frame (the
//   slabs are separate tensors). The keep flags go to shared memory; a thread owns 16
//   pixels, reads 16 bytes of each kept instance's mask (the others are never read) and
//   adds them as packed bytes (flushed every 255 instances), then writes 255 · count as f32
//   (exact: the plain float sum of 255s is exact up to 2^24) and one byte count != 0, the
//   SDF's mask (16.6 MB a batch of 8: it stays in the 50 MB L2 for the next kernel).
//
// sdf_green_kernel: one launch over the batch; a block owns a tile of TH x TW pixels and
//   loads the marked bytes of the tile's columns widened by CAP on each side. Each thread
//   sweeps one column down then up over the tile's rows and CAP rows each way, keeping the
//   distance to the nearest marked and unmarked pixel above and below: the vertical
//   distances capped at CAP, exactly what the plain version's min-plus passes give. Their
//   squares go to shared memory, packed two to a word (each <= CAP² < 2^16). Then each
//   thread takes one row and RUN neighbouring columns and forms
//   D²[x] = min(CAP², min_t g²[t] + (t - x)²) over the RUN + 2·CAP columns around them
//   (a tap beyond |dx| = CAP adds at least 67² > CAP² and cannot win, so none is skipped),
//   for the mask and its complement at once. The lanes of a warp hold 32 rows of one
//   column: a row pitch of EXT + 1 words puts them on 32 banks.
//   The green mapping follows the plain version operation by operation, each rounded as
//   PyTorch rounds it: sqrt (correctly rounded), outside - inside, + 127, a true division
//   by 255, - 0.25, x 2, the clamp to [0, 1], 1 - x, written with the _rn intrinsics so
//   that nvcc contracts nothing into an FMA (no --use_fast_math).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int MAX_FRAMES = 32;  // frames a composite launch (pointers passed by value)
constexpr int COMP_THREADS = 256;
constexpr int COMP_PIX = 16;  // pixels a thread on the 16-byte path

constexpr int CAP = 66;  // as ops/sdf.CAP: |signed distance| > 64.25 px clamps
constexpr int CAP2 = CAP * CAP;
constexpr int TH = 32;     // a tile's rows: one lane each
constexpr int RUN = 16;    // neighbouring columns a thread
constexpr int WARPS = 12;  // column runs a tile
constexpr int TW = RUN * WARPS;      // 192 columns a tile
constexpr int EXT = TW + 2 * CAP;    // 324 columns with their halo
constexpr int PITCH = EXT + 1;       // words a shared row
constexpr int SDF_THREADS = 32 * WARPS;
constexpr int FAR = 1 << 20;  // "no such pixel yet" in the sweeps

struct Frames {
  const uint8_t* masks[MAX_FRAMES];  // [n, hw] bool bytes, one slab a frame
  const uint8_t* keep[MAX_FRAMES];   // [n] bool bytes
};

// composite[f][p] = 255 · #{i : keep[f][i] and masks[f][i][p]}, marked[f][p] = that != 0.
template <bool VEC>
__global__ void __launch_bounds__(COMP_THREADS)
kept_composite_kernel(Frames frames, int n, long long hw, float* __restrict__ composite,
                      uint8_t* __restrict__ marked) {
  extern __shared__ uint8_t keep_s[];
  const int f = blockIdx.y;
  const uint8_t* keep = frames.keep[f];
  for (int i = threadIdx.x; i < n; i += COMP_THREADS) keep_s[i] = keep[i] != 0;
  __syncthreads();
  const uint8_t* masks = frames.masks[f];
  float* out = composite + f * hw;
  uint8_t* mark = marked + f * hw;

  if (VEC) {
    const long long p = (static_cast<long long>(blockIdx.x) * COMP_THREADS + threadIdx.x) *
                        COMP_PIX;
    if (p >= hw) return;
    int count[COMP_PIX];
#pragma unroll
    for (int e = 0; e < COMP_PIX; ++e) count[e] = 0;
    for (int i0 = 0; i0 < n; i0 += 255) {  // packed bytes hold up to 255 instances
      uint4 acc = make_uint4(0u, 0u, 0u, 0u);
      const int i1 = min(n, i0 + 255);
      for (int i = i0; i < i1; ++i) {
        if (!keep_s[i]) continue;  // the same for the whole block: no divergence
        const uint4 m = __ldg(reinterpret_cast<const uint4*>(masks + i * hw + p));
        acc.x += m.x;  // bytes of 0 or 1: no carry into the next byte
        acc.y += m.y;
        acc.z += m.z;
        acc.w += m.w;
      }
      const uint32_t words[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
      for (int e = 0; e < COMP_PIX; ++e) count[e] += (words[e / 4] >> (8 * (e % 4))) & 0xffu;
    }
    float4 vals[COMP_PIX / 4];
    float* v = reinterpret_cast<float*>(vals);
    uint32_t flags[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int e = 0; e < COMP_PIX; ++e) {
      v[e] = __fmul_rn(255.f, static_cast<float>(count[e]));
      flags[e / 4] |= static_cast<uint32_t>(count[e] != 0) << (8 * (e % 4));
    }
    float4* dst = reinterpret_cast<float4*>(out + p);
#pragma unroll
    for (int q = 0; q < COMP_PIX / 4; ++q) dst[q] = vals[q];
    *reinterpret_cast<uint4*>(mark + p) = make_uint4(flags[0], flags[1], flags[2], flags[3]);
  } else {
    const long long p = static_cast<long long>(blockIdx.x) * COMP_THREADS + threadIdx.x;
    if (p >= hw) return;
    int count = 0;
    for (int i = 0; i < n; ++i)
      if (keep_s[i]) count += masks[i * hw + p] != 0;
    out[p] = __fmul_rn(255.f, static_cast<float>(count));
    mark[p] = count != 0;
  }
}

// green[b][y][x] from marked[b][y][x] (bytes, 0 or 1): see the note at the top.
__global__ void __launch_bounds__(SDF_THREADS)
sdf_green_kernel(const uint8_t* __restrict__ marked, float* __restrict__ green, int H, int W) {
  __shared__ uint32_t g2[TH][PITCH];  // g_out² | g_in² << 16 (41.6 KB)
  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  const size_t plane = static_cast<size_t>(blockIdx.z) * H * W;
  const int rows = min(TH, H - y0);

  // 1. vertical distances, capped at CAP, one column a thread
  for (int c = threadIdx.x; c < EXT; c += SDF_THREADS) {
    const int x = x0 - CAP + c;
    if (x < 0 || x >= W) {  // off the frame: as the plain version's padding
      for (int r = 0; r < rows; ++r) g2[r][c] = CAP2 | (CAP2 << 16);
      continue;
    }
    const uint8_t* col = marked + plane + x;
    int last_on = -FAR, last_off = -FAR;  // nearest marked / unmarked row above
#pragma unroll 4
    for (int y = max(0, y0 - CAP); y < y0; ++y) {
      const bool on = col[static_cast<size_t>(y) * W] != 0;
      last_on = on ? y : last_on;
      last_off = on ? last_off : y;
    }
    for (int y = y0; y < y0 + rows; ++y) {
      const bool on = col[static_cast<size_t>(y) * W] != 0;
      last_on = on ? y : last_on;
      last_off = on ? last_off : y;
      g2[y - y0][c] = min(y - last_on, CAP) | (min(y - last_off, CAP) << 16);
    }
    int next_on = FAR, next_off = FAR;  // nearest marked / unmarked row below
#pragma unroll 4
    for (int y = min(H, y0 + TH + CAP) - 1; y >= y0 + rows; --y) {
      const bool on = col[static_cast<size_t>(y) * W] != 0;
      next_on = on ? y : next_on;
      next_off = on ? next_off : y;
    }
    for (int y = y0 + rows - 1; y >= y0; --y) {
      const bool on = col[static_cast<size_t>(y) * W] != 0;
      next_on = on ? y : next_on;
      next_off = on ? next_off : y;
      const uint32_t down = g2[y - y0][c];
      const int g_on = min(static_cast<int>(down & 0xffffu), next_on - y);
      const int g_off = min(static_cast<int>(down >> 16), next_off - y);
      g2[y - y0][c] = (g_on * g_on) | ((g_off * g_off) << 16);
    }
  }
  __syncthreads();

  // 2. D² over the taps, for the mask (outside) and its complement (inside)
  const int r = threadIdx.x & 31;
  const int run = threadIdx.x >> 5;
  if (r >= rows) return;
  const uint32_t* row = &g2[r][run * RUN];  // window: tile columns run·RUN - CAP ...
  int d2_out[RUN], d2_in[RUN];
#pragma unroll
  for (int j = 0; j < RUN; ++j) {
    d2_out[j] = CAP2;
    d2_in[j] = CAP2;
  }
  // output j sits at window index j + CAP; tap t at dx = t - j - CAP
#pragma unroll 1
  for (int t0 = 0; t0 < RUN + 2 * CAP; t0 += 4) {
#pragma unroll
    for (int tt = 0; tt < 4; ++tt) {
      const int t = t0 + tt;
      const uint32_t v = row[t];
      const int lo = v & 0xffffu;
      const int hi = v >> 16;
#pragma unroll
      for (int j = 0; j < RUN; ++j) {
        const int dx = t - j - CAP;
        const int dx2 = dx * dx;
        d2_out[j] = min(d2_out[j], lo + dx2);
        d2_in[j] = min(d2_in[j], hi + dx2);
      }
    }
  }

  // 3. the green mapping (ops/sdf.sdf_green_device), each operation rounded once
  const int y = y0 + r;
  const int xr = x0 + run * RUN;
  float out[RUN];
#pragma unroll
  for (int j = 0; j < RUN; ++j) {
    float s = __fsub_rn(__fsqrt_rn(static_cast<float>(d2_out[j])),
                        __fsqrt_rn(static_cast<float>(d2_in[j])));
    s = __fdiv_rn(__fadd_rn(s, 127.f), 255.f);
    s = __fmul_rn(__fsub_rn(s, 0.25f), 2.f);
    s = fminf(fmaxf(s, 0.f), 1.f);
    out[j] = __fsub_rn(1.f, s);
  }
  float* dst = green + plane + static_cast<size_t>(y) * W + xr;
  if (W % 4 == 0 && xr + RUN <= W) {
#pragma unroll
    for (int q = 0; q < RUN / 4; ++q)
      reinterpret_cast<float4*>(dst)[q] =
          make_float4(out[4 * q], out[4 * q + 1], out[4 * q + 2], out[4 * q + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < RUN; ++j)
      if (xr + j < W) dst[j] = out[j];
  }
}

}  // namespace

// masks, keep: nframes (<= MAX_FRAMES) device pointers each, a frame's [n, hw] bool slab
// and its [n] bool keep flags. composite: [nframes, hw] f32, marked: [nframes, hw] bytes.
// The 16-byte path needs hw % 16 == 0 and every pointer 16-byte aligned (vec = 1).
// Launches on `stream` and returns the cudaError_t of the launch (0 on success); it does
// not synchronise.
extern "C" int prisma_kept_composite(const void* const* masks, const void* const* keep,
                                     int nframes, int n, long long hw, void* composite,
                                     void* marked, int vec, void* stream) {
  if (nframes <= 0 || nframes > MAX_FRAMES || n <= 0 || hw <= 0 || n > 48 * 1024)
    return cudaErrorInvalidValue;
  Frames frames{};
  for (int f = 0; f < nframes; ++f) {
    frames.masks[f] = static_cast<const uint8_t*>(masks[f]);
    frames.keep[f] = static_cast<const uint8_t*>(keep[f]);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long per_block = vec ? COMP_THREADS * COMP_PIX : COMP_THREADS;
  const dim3 grid(static_cast<unsigned>((hw + per_block - 1) / per_block), nframes);
  if (vec) {
    kept_composite_kernel<true><<<grid, COMP_THREADS, n, s>>>(
        frames, n, hw, static_cast<float*>(composite), static_cast<uint8_t*>(marked));
  } else {
    kept_composite_kernel<false><<<grid, COMP_THREADS, n, s>>>(
        frames, n, hw, static_cast<float*>(composite), static_cast<uint8_t*>(marked));
  }
  return cudaGetLastError();
}

// marked: [batch, H, W] bytes (0 or 1), green: [batch, H, W] f32, both contiguous; green
// 16-byte aligned. Launches on `stream` and returns the cudaError_t of the launch.
extern "C" int prisma_sdf_green(const void* marked, void* green, int batch, int H, int W,
                                void* stream) {
  if (batch <= 0 || batch > 65535 || H <= 0 || W <= 0) return cudaErrorInvalidValue;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, batch);
  sdf_green_kernel<<<grid, SDF_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(marked), static_cast<float*>(green), H, W);
  return cudaGetLastError();
}
