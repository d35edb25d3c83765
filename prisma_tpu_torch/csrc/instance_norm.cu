// Instance norm (+ optional ReLU) for Hopper (sm_90a), over contiguous NCHW planes:
// y = (x - mean) · rsqrt(max(E[x²] - mean², 0) + eps), then max(y, 0) when asked.
//
// Replaces the TPU kernels `_stats_kernel` and `_apply_kernel` of
// prisma_tpu/ops/pallas/instance_norm.py (entry `instance_norm_relu`), which the port's
// GMFlow backbone uses for the 15 norms the JAX model computes with `_inorm_relu`. The
// TPU kernels work on NHWC rows and keep one [1, C] accumulator per sample across a
// sequential grid; the port's convolutions are NCHW, so here each (sample, channel) plane
// of H·W values is contiguous and one thread block owns one plane: no permute copy goes
// around the kernel, and no sum crosses blocks.
//
// Numerics: the sum and the sum of squares are f32 whatever the input type (one pass,
// the single-pass moments of the JAX model), the normalisation is f32 too, and the result
// is cast back once. (In bf16 the JAX model normalises in bf16; the port holds its bf16
// output to this kernel's plain version instead.)
//
// Design (simple and correct first): 512 threads per plane; pass 1 reads the plane with
// 16-byte loads where the plane is 16-byte aligned (H·W a multiple of 8 bf16 or 4 f32
// values), else value by value, and reduces (sum, sum of squares) through warp shuffles
// and shared memory; pass 2 reads the plane again and writes the result.
//
// What bounds it on this card: memory. The function must read x once and write y once
// (1.05 GB at the largest GMFlow norm, [14, 64, 408, 720] bf16: 0.31 ms at 3.35 TB/s);
// the kernel reads x twice, the second time partly from L2, so its floor is about 1.5x
// that. A later version could keep planes that fit in shared memory on chip between the
// two passes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 512;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);
}

// Sums a and b over the block; every thread gets the totals.
__device__ __forceinline__ void block_sum2(float& a, float& b) {
  __shared__ float part[2][THREADS / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    part[0][warp] = a;
    part[1][warp] = b;
  }
  __syncthreads();
  a = 0.f;
  b = 0.f;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) {
    a += part[0][w];
    b += part[1][w];
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
instance_norm_relu_kernel(const T* __restrict__ x, T* __restrict__ y, int hw, float eps,
                          int relu) {
  constexpr int VEC = 16 / sizeof(T);  // values per 16-byte load
  const size_t base = size_t(blockIdx.x) * hw;
  const T* src = x + base;
  T* dst = y + base;
  const bool vec = hw % VEC == 0;  // the plane starts on a 16-byte boundary

  float sum = 0.f;
  float sq = 0.f;
  if (vec) {
    for (int i = threadIdx.x * VEC; i < hw; i += THREADS * VEC) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + i);
      const T* val = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float f = to_f32(val[e]);
        sum += f;
        sq = fmaf(f, f, sq);
      }
    }
  } else {
    for (int i = threadIdx.x; i < hw; i += THREADS) {
      const float f = to_f32(src[i]);
      sum += f;
      sq = fmaf(f, f, sq);
    }
  }
  block_sum2(sum, sq);
  const float inv_n = 1.f / static_cast<float>(hw);
  const float mean = sum * inv_n;
  const float var = fmaxf(sq * inv_n - mean * mean, 0.f);
  const float scale = rsqrtf(var + eps);

  if (vec) {
    for (int i = threadIdx.x * VEC; i < hw; i += THREADS * VEC) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + i);
      const T* val = reinterpret_cast<const T*>(&raw);
      uint4 out_raw;
      T* out = reinterpret_cast<T*>(&out_raw);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        float f = (to_f32(val[e]) - mean) * scale;
        if (relu) f = fmaxf(f, 0.f);
        out[e] = from_f32<T>(f);
      }
      *reinterpret_cast<uint4*>(dst + i) = out_raw;
    }
  } else {
    for (int i = threadIdx.x; i < hw; i += THREADS) {
      float f = (to_f32(src[i]) - mean) * scale;
      if (relu) f = fmaxf(f, 0.f);
      dst[i] = from_f32<T>(f);
    }
  }
}

}  // namespace

// x, y: [planes, hw] contiguous (NCHW with planes = N·C, hw = H·W), 16-byte aligned.
// dtype: 0 = float32, 1 = bfloat16. relu: 0 or 1. Launches on `stream` and returns the
// cudaError_t of the launch (0 on success); it does not synchronise.
extern "C" int prisma_instance_norm_relu(const void* x, void* y, int planes, int hw,
                                         int dtype, float eps, int relu, void* stream) {
  if (planes <= 0 || hw <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    instance_norm_relu_kernel<bf16><<<planes, THREADS, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<bf16*>(y), hw, eps, relu);
  } else if (dtype == 0) {
    instance_norm_relu_kernel<float><<<planes, THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(y), hw, eps, relu);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
