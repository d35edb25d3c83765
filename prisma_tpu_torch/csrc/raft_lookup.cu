// RAFT's correlation-window lookup for Hopper (sm_90a): for every pixel n and pyramid
// level l, the bilinear (2r+1)² window (r = 4) around the centre coords[n] / 2^l in the
// pixel's own [Hl, Wl] correlation plane, zero outside the plane, with the x-offset on
// the slow window axis (the reference's channel order, corr.py:37-43). All levels in one
// launch; out is [N, levels·81], level-major, each pixel's outputs contiguous.
//
// Replaces both TPU kernels of this function: `_fetch_kernel` of
// prisma_tpu/ops/pallas/raft_lookup.py (one DMA per (2r+2)² patch into VMEM, the blend
// outside) and `_window_kernel` of prisma_tpu/ops/pallas/raft_window.py (the volume
// streamed through VMEM in a transposed [N, Wp, Hp] layout, taps picked with lane
// gathers). Both fight the TPU's tiling: a DMA slice must be (8, 128)-aligned and a lane
// gather must fit one 128-lane tile. A CUDA thread reads any address, so the volume stays
// in the model's [N, Hl, Wl] layout, untransposed and unpadded.
//
// Numerics: every tap shares the centre's fraction, so the window is four shifted
// (2r+1)² slices of one integer (2r+2)² patch. The blend is f32 whatever the volume's
// type, computed with explicit round-to-nearest operations (no FMA contraction) in the
// plain version's order, ((1-fx)(1-fy)·p00 + fx(1-fy)·p10) + (1-fx)fy·p01) + fx·fy·p11,
// then cast once to the volume's type: kernel and plain version compute the same f32
// values. A centre is clamped to [-(r+2), Wl+r] x [-(r+2), Hl+r] before the integer
// conversion (the clamp moves only centres whose every tap is outside the plane), and a
// non-finite centre gives an all-zero window, so no read ever leaves the plane. Planes
// are indexed with 64-bit offsets: level 0 of RAFT at 810x1440 holds 4.7e9 values.
//
// Design (simple and correct first): a block of 256 threads takes PIX = 8 pixels. It
// computes each (pixel, level)'s patch origin and fraction once, stages the 32 patches
// of 10x10 values in shared memory as f32 (taps outside the plane as zeros; neighbouring
// threads read neighbouring values of a patch row), then each thread blends outputs
// from shared memory, and the 8·324 outputs of the block are written contiguously.
//
// What bounds it on this card: memory, and only the bytes the windows touch: each
// (pixel, level) reads 10 rows of 10 values (about 16 32-byte sectors in bf16), not the
// plane. At the RAFT main shape (N = 257040, four levels) that is about 0.5 GB per
// call, 0.15 ms at 3.35 TB/s; the scattered 20-byte row reads are latency-bound, so this
// first version sits well above that. Vectorised loads, coalescing across pixels and L2
// residency of the small levels are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int R = 4;                    // window radius
constexpr int NW = 2 * R + 1;           // window side, 9
constexpr int P = NW + 1;               // patch side, 10
constexpr int PP = P * P;               // patch values, 100
constexpr int TAPS = NW * NW;           // 81
constexpr int MAX_LEVELS = 4;
constexpr int PIX = 8;                  // pixels per block
constexpr int THREADS = 256;

template <typename T>
struct Pyramid {
  const T* vol[MAX_LEVELS];
  int h[MAX_LEVELS];
  int w[MAX_LEVELS];
  int levels;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
raft_window_lookup_kernel(const Pyramid<T> pyr, const float* __restrict__ coords,
                          T* __restrict__ out, long long n_pix) {
  __shared__ float patch[PIX * MAX_LEVELS][PP];
  __shared__ int x0s[PIX * MAX_LEVELS];
  __shared__ int y0s[PIX * MAX_LEVELS];
  __shared__ float fxs[PIX * MAX_LEVELS];
  __shared__ float fys[PIX * MAX_LEVELS];

  const int L = pyr.levels;
  const int items = PIX * L;                 // (pixel, level) pairs, pixel-major
  const long long pix0 = static_cast<long long>(blockIdx.x) * PIX;

  // 1. each (pixel, level)'s patch origin and fraction
  for (int it = threadIdx.x; it < items; it += THREADS) {
    const int p = it / L;
    const int l = it - p * L;
    const long long n = pix0 + p;
    const float hl = static_cast<float>(pyr.h[l]);
    const float wl = static_cast<float>(pyr.w[l]);
    float cx = -(R + 2.f);
    float cy = -(R + 2.f);
    if (n < n_pix) {
      const float s = 1.f / static_cast<float>(1 << l);  // exact: a power of two
      const float x = coords[2 * n] * s;
      const float y = coords[2 * n + 1] * s;
      if (isfinite(x) && isfinite(y)) {
        cx = fminf(fmaxf(x, -(R + 2.f)), wl + R);
        cy = fminf(fmaxf(y, -(R + 2.f)), hl + R);
      }
    }
    const float fx0 = floorf(cx);
    const float fy0 = floorf(cy);
    x0s[it] = static_cast<int>(fx0);
    y0s[it] = static_cast<int>(fy0);
    fxs[it] = cx - fx0;
    fys[it] = cy - fy0;
  }
  __syncthreads();

  // 2. stage the patches, zeros outside the plane
  for (int i = threadIdx.x; i < items * PP; i += THREADS) {
    const int it = i / PP;
    const int k = i - it * PP;
    const int py = k / P;
    const int px = k - py * P;
    const int p = it / L;
    const int l = it - p * L;
    const long long n = pix0 + p;
    const int hl = pyr.h[l];
    const int wl = pyr.w[l];
    const int y = y0s[it] - R + py;
    const int x = x0s[it] - R + px;
    float v = 0.f;
    if (n < n_pix && y >= 0 && y < hl && x >= 0 && x < wl) {
      const size_t plane = static_cast<size_t>(hl) * static_cast<size_t>(wl);
      v = to_f32(pyr.vol[l][static_cast<size_t>(n) * plane
                            + static_cast<size_t>(y) * wl + x]);
    }
    patch[it][k] = v;
  }
  __syncthreads();

  // 3. blend; output j of a pixel is level l = j / 81, tap ix·9 + iy (x slow)
  const int per_pix = L * TAPS;
  for (int i = threadIdx.x; i < PIX * per_pix; i += THREADS) {
    const int p = i / per_pix;
    const long long n = pix0 + p;
    if (n >= n_pix) break;                   // i grows: the rest are past the end too
    const int j = i - p * per_pix;
    const int l = j / TAPS;
    const int t = j - l * TAPS;
    const int ix = t / NW;
    const int iy = t - ix * NW;
    const int it = p * L + l;
    const float fx = fxs[it];
    const float fy = fys[it];
    const float gx = __fsub_rn(1.f, fx);
    const float gy = __fsub_rn(1.f, fy);
    const float* pt = patch[it];
    const float p00 = pt[iy * P + ix];
    const float p10 = pt[iy * P + ix + 1];
    const float p01 = pt[(iy + 1) * P + ix];
    const float p11 = pt[(iy + 1) * P + ix + 1];
    float v = __fmul_rn(__fmul_rn(gx, gy), p00);
    v = __fadd_rn(v, __fmul_rn(__fmul_rn(fx, gy), p10));
    v = __fadd_rn(v, __fmul_rn(__fmul_rn(gx, fy), p01));
    v = __fadd_rn(v, __fmul_rn(__fmul_rn(fx, fy), p11));
    out[n * per_pix + j] = from_f32<T>(v);
  }
}

template <typename T>
int launch(const void* const* vols, const int* hw, int levels, const float* coords,
           void* out, long long n, cudaStream_t s) {
  Pyramid<T> pyr{};
  for (int l = 0; l < levels; ++l) {
    pyr.vol[l] = static_cast<const T*>(vols[l]);
    pyr.h[l] = hw[2 * l];
    pyr.w[l] = hw[2 * l + 1];
  }
  pyr.levels = levels;
  const long long blocks = (n + PIX - 1) / PIX;
  raft_window_lookup_kernel<T><<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(
      pyr, coords, static_cast<T*>(out), n);
  return cudaGetLastError();
}

}  // namespace

// vols: `levels` (1 to 4) device pointers to contiguous [n, h_l, w_l] planes of one
// dtype (0 = float32, 1 = bfloat16); hw: host array {h_0, w_0, h_1, w_1, ...} (a level
// may be empty); coords: [n, 2] float32 (x, y) at level 0's scale; out: [n, levels·81]
// of the volume's dtype. r must be 4. Launches on `stream` and returns the cudaError_t
// of the launch (0 on success); it does not synchronise.
extern "C" int prisma_raft_window_lookup(const void* const* vols, const int* hw,
                                         int levels, const float* coords, void* out,
                                         long long n, int r, int dtype, void* stream) {
  if (r != R || levels < 1 || levels > MAX_LEVELS || n <= 0) return cudaErrorInvalidValue;
  if ((n + PIX - 1) / PIX > 0x7fffffffLL) return cudaErrorInvalidValue;
  for (int l = 0; l < levels; ++l) {
    if (hw[2 * l] < 0 || hw[2 * l + 1] < 0) return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch<bf16>(vols, hw, levels, coords, out, n, s);
  if (dtype == 0) return launch<float>(vols, hw, levels, coords, out, n, s);
  return cudaErrorInvalidValue;
}
