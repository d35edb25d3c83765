// The two probe kernels of scripts/probe_gather_kernel.py, for Hopper (sm_90a):
//
//   lane_gather      o[s, l] = x[s, clip(off[s] + min(l, taps - 1), 0, H - 1)]
//                    (replaces `lane_gather_kernel`, probe_gather_kernel.py:31)
//   minor_transpose  [B, W, T] -> [B, T, W]
//                    (replaces `transpose_kernel`, probe_gather_kernel.py:53)
//
// On the TPU they were design probes for the gather-based RAFT lookup
// (prisma_tpu/ops/pallas/raft_window.py): can a kernel gather along the 128-lane axis,
// and swap the two minor axes of a slab? A CUDA thread reads any address, so neither
// question arises here; they are ported as the functions they compute.
//
// What bounds them on this card: memory. Each reads its input once and writes its output
// once, and at the probe's sizes (a few MB) the launch path's host time exceeds the
// device work (chip_smoke.py times an empty kernel through the same path beside them).
// lane_gather: one thread per output value, rows walked by consecutive threads, so
// reads and writes of a row are coalesced (the gathered columns of a row are a shifted
// window, mostly contiguous). minor_transpose: 32x32 tiles through shared memory (a
// column of padding against bank conflicts), so both the read of [W, T] rows and the
// write of [T, W] rows are coalesced.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// Both kernels only move values, so they work on the bits: uint16_t carries a bfloat16,
// uint32_t a float32.

constexpr int GATHER_THREADS = 256;
constexpr int TILE = 32;
constexpr int TILE_ROWS = 8;

template <typename T>
__global__ void __launch_bounds__(GATHER_THREADS)
lane_gather_kernel(const T* __restrict__ x, const int* __restrict__ off,
                   T* __restrict__ o, long long total, int h, int taps) {
  const long long i = static_cast<long long>(blockIdx.x) * GATHER_THREADS + threadIdx.x;
  if (i >= total) return;
  const long long s = i / h;
  const int l = static_cast<int>(i - s * h);
  int idx = off[s] + min(l, taps - 1);
  idx = min(max(idx, 0), h - 1);
  o[i] = x[s * h + idx];
}

template <typename T>
__global__ void __launch_bounds__(TILE * TILE_ROWS)
minor_transpose_kernel(const T* __restrict__ x, T* __restrict__ o, int w, int t) {
  __shared__ T tile[TILE][TILE + 1];
  const size_t b = blockIdx.z;
  const T* src = x + b * static_cast<size_t>(w) * t;   // [w, t]
  T* dst = o + b * static_cast<size_t>(w) * t;         // [t, w]
  const int t0 = blockIdx.x * TILE;
  const int w0 = blockIdx.y * TILE;
  for (int r = threadIdx.y; r < TILE; r += TILE_ROWS) {
    const int wi = w0 + r;
    const int ti = t0 + threadIdx.x;
    if (wi < w && ti < t) tile[r][threadIdx.x] = src[static_cast<size_t>(wi) * t + ti];
  }
  __syncthreads();
  for (int r = threadIdx.y; r < TILE; r += TILE_ROWS) {
    const int ti = t0 + r;
    const int wi = w0 + threadIdx.x;
    if (wi < w && ti < t) dst[static_cast<size_t>(ti) * w + wi] = tile[threadIdx.x][r];
  }
}

// Does nothing: the launch path's own cost, the floor under both kernels' times.
__global__ void empty_kernel() {}

}  // namespace

// x: [s, h] contiguous, off: [s] int32, o: [s, h]; dtype 0 = float32, 1 = bfloat16.
// Launches on `stream`, returns the cudaError_t of the launch; does not synchronise.
extern "C" int prisma_lane_gather(const void* x, const int* off, void* o, long long s,
                                  int h, int taps, int dtype, void* stream) {
  if (s <= 0 || h <= 0 || taps <= 0) return cudaErrorInvalidValue;
  const long long total = s * h;
  const long long blocks = (total + GATHER_THREADS - 1) / GATHER_THREADS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    lane_gather_kernel<uint16_t><<<static_cast<unsigned>(blocks), GATHER_THREADS, 0, st>>>(
        static_cast<const uint16_t*>(x), off, static_cast<uint16_t*>(o), total, h, taps);
  } else if (dtype == 0) {
    lane_gather_kernel<uint32_t><<<static_cast<unsigned>(blocks), GATHER_THREADS, 0, st>>>(
        static_cast<const uint32_t*>(x), off, static_cast<uint32_t*>(o), total, h, taps);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// x: [b, w, t] contiguous -> o: [b, t, w]; dtype as above.
extern "C" int prisma_minor_transpose(const void* x, void* o, int b, int w, int t,
                                      int dtype, void* stream) {
  if (b <= 0 || w <= 0 || t <= 0 || b > 65535) return cudaErrorInvalidValue;
  const dim3 grid((t + TILE - 1) / TILE, (w + TILE - 1) / TILE, b);
  const dim3 block(TILE, TILE_ROWS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    minor_transpose_kernel<uint16_t><<<grid, block, 0, st>>>(
        static_cast<const uint16_t*>(x), static_cast<uint16_t*>(o), w, t);
  } else if (dtype == 0) {
    minor_transpose_kernel<uint32_t><<<grid, block, 0, st>>>(
        static_cast<const uint32_t*>(x), static_cast<uint32_t*>(o), w, t);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// The empty kernel, one block of 32 threads, on `stream`.
extern "C" int prisma_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}
