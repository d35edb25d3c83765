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
// non-finite centre gives an all-zero window. Planes and rows are indexed with 64-bit
// offsets: level 0 of RAFT at 810x1440 holds 4.7e9 values.
//
// What bounds it on this card: memory, and only the bytes the windows touch. Every pixel
// has its own planes, so nothing is shared between pixels: each (pixel, level) reads 10
// rows of 10 values (20 bytes in bf16, at any 2-byte offset), about 16 32-byte sectors,
// not the plane. At the RAFT main shape (N = 257040, four bf16 levels) that is about
// 0.53 GB per call, 0.16 ms at 3.35 TB/s: a gather of short rows, so the work is to keep
// enough of them in flight.
//
// Design:
// - Loads are aligned 16-byte chunks, `cp.async.cg` (LDGSTS: to shared memory through L2,
//   no registers held while in flight). A patch row spans 2 or 3 chunks in bf16 (3 when
//   it starts at byte 14 of a chunk) and at most 4 in f32; only the chunks that overlap
//   the row's live span [max(0, x0-r), min(Wl, x0+r+2)) are issued, each into a fixed
//   48-byte (bf16) or 64-byte (f32) slot of shared memory, with the row's byte offset in
//   its first chunk kept beside it. A chunk lies inside one 32-byte sector, so the chunks
//   read no sector that the row does not touch. TMA does not fit: a tensor map needs row
//   strides that are multiples of 16 bytes, and RAFT's planes have rows of 360, 180, 90
//   and 44 bytes, at any offset.
// - No read leaves a level's tensor: a chunk that is not wholly inside the tensor's bytes
//   (its first chunk if the tensor does not start on 16 bytes, the chunk that holds its
//   last bytes) is read value by value, only the values inside it. Chunk bytes that
//   belong to a neighbouring row or plane, and slots never written, are never blended:
//   the blend takes a value only where its row and column lie on the plane (bit masks
//   per (pixel, level)), zero elsewhere.
// - Many pixels in flight: a block of 256 threads walks over groups of GROUP = 16 pixels
//   (all levels) with two buffers: it issues the next group's chunks before it waits for
//   the current group's and blends them. Each issued row is one thread's (its centre,
//   masks and offsets once); levels (1-4) are a template parameter and r, the patch side
//   and the tap layout compile-time constants, so no runtime division is left in the
//   loops. In bf16 at four levels a group is 640 rows, ~22 KB of chunks; a block holds
//   75 KB of shared memory and three blocks fit an SM, so ~65 KB per SM are in flight
//   while the SM blends, against the ~25 KB that Little's law asks for at 3.35 TB/s and
//   ~1 µs of loaded latency. The grid is as many blocks as fit the card at once.
// - Blend and store: a thread takes one window column (pixel, level, x-offset): it reads
//   10 rows of two neighbouring values from shared memory and blends the column's 9
//   outputs, which are consecutive in `out`, into a staging buffer; the group's outputs
//   (16 x levels x 81 values, a multiple of 16 bytes) then go out as 16-byte stores, the
//   ragged last group's tail value by value.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int R = 4;                    // window radius
constexpr int NW = 2 * R + 1;           // window side, 9
constexpr int P = NW + 1;               // patch side, 10
constexpr int TAPS = NW * NW;           // 81
constexpr int MAX_LEVELS = 4;
constexpr int GROUP = 16;               // pixels per group
constexpr int THREADS = 256;
constexpr int MAX_DEVICES = 64;

template <typename T>
struct Pyramid {
  const T* vol[MAX_LEVELS];
  int h[MAX_LEVELS];
  int w[MAX_LEVELS];
};

// a (pixel, level)'s fraction and which of its patch rows and columns lie on the plane
struct Item {
  float fx, fy;
  unsigned rows, cols;
};

// the dynamic shared memory of one block: two buffers of row slots, two of items, the
// staged outputs, two of row offsets
template <int L, typename T>
struct Layout {
  static constexpr int ITEMS = GROUP * L;
  static constexpr int ROWS = ITEMS * P;
  static constexpr int SLOT = sizeof(T) == 2 ? 48 : 64;  // the chunks a row can span
  static constexpr int OUTS = ITEMS * TAPS;
  static constexpr int BUF = ROWS * SLOT;
  static constexpr int ITEMS_AT = 2 * BUF;
  static constexpr int STAGE_AT = ITEMS_AT + 2 * ITEMS * int(sizeof(Item));
  static constexpr int SHIFTS_AT = STAGE_AT + OUTS * int(sizeof(T));
  static constexpr int BYTES = SHIFTS_AT + 2 * ROWS;
  static_assert(STAGE_AT % 16 == 0 && (OUTS * sizeof(T)) % 16 == 0, "16-byte stores");
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ void cp_async16(void* smem, uintptr_t gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

struct Centre {
  int x0, y0;
  float fx, fy;
};

// the patch corner floor(c) and fraction of pixel n's centre at level l; a pixel past the
// end or a non-finite centre is moved off the plane
__device__ __forceinline__ Centre centre(const float* __restrict__ coords, long long n,
                                         long long n_pix, int l, int hl, int wl) {
  float cx = -(R + 2.f);
  float cy = -(R + 2.f);
  if (n < n_pix) {
    const float s = 1.f / static_cast<float>(1 << l);  // exact: a power of two
    const float x = coords[2 * n] * s;
    const float y = coords[2 * n + 1] * s;
    if (isfinite(x) && isfinite(y)) {
      cx = fminf(fmaxf(x, -(R + 2.f)), static_cast<float>(wl) + R);
      cy = fminf(fmaxf(y, -(R + 2.f)), static_cast<float>(hl) + R);
    }
  }
  const float fx0 = floorf(cx);
  const float fy0 = floorf(cy);
  return {static_cast<int>(fx0), static_cast<int>(fy0), cx - fx0, cy - fy0};
}

// issue group g's chunks into one buffer; fill its items and row offsets
template <int L, typename T>
__device__ __forceinline__ void issue(const T* const* vol, const int* hs, const int* ws,
                                      const float* __restrict__ coords, long long n_pix,
                                      long long g, unsigned char* buf, Item* items,
                                      unsigned char* shifts) {
  using Lay = Layout<L, T>;
  for (int q = threadIdx.x; q < Lay::ROWS; q += THREADS) {
    const int item = q / P;
    const int r = q - item * P;
    const int p = item / L;
    const int l = item - p * L;
    const long long n = g * GROUP + p;
    const int hl = hs[l];
    const int wl = ws[l];
    const Centre c = centre(coords, n, n_pix, l, hl, wl);
    const int y = c.y0 - R + r;
    const int xs = max(c.x0 - R, 0);
    const int xe = min(c.x0 + R + 2, wl);
    int shift = 0;
    if (n < n_pix && y >= 0 && y < hl && xs < xe) {
      const long long plane = static_cast<long long>(hl) * wl;
      const long long row = n * plane + static_cast<long long>(y) * wl;  // column 0
      const uintptr_t begin = reinterpret_cast<uintptr_t>(vol[l]);
      const uintptr_t end = begin + static_cast<uintptr_t>(n_pix * plane) * sizeof(T);
      // the patch's column 0 (off the plane, even before the tensor, when x0 - r < 0:
      // only an address, never read)
      const uintptr_t a0 = begin + static_cast<uintptr_t>((row + c.x0 - R) *
                                                          static_cast<long long>(sizeof(T)));
      const uintptr_t origin = a0 & ~uintptr_t(15);
      shift = static_cast<int>(a0 & 15);
      const uintptr_t first = (begin + static_cast<uintptr_t>(row + xs) * sizeof(T))
                              & ~uintptr_t(15);
      const uintptr_t last = (begin + static_cast<uintptr_t>(row + xe) * sizeof(T) - 1)
                             & ~uintptr_t(15);
      unsigned char* slot = buf + q * Lay::SLOT;
      for (uintptr_t ch = first; ch <= last; ch += 16) {
        unsigned char* dst = slot + (ch - origin);
        if (ch >= begin && ch + 16 <= end) {
          cp_async16(dst, ch);
        } else {  // the tensor's first or last chunk: only the values inside it
          const uintptr_t lo = ch > begin ? ch : begin;
          const uintptr_t hi = ch + 16 < end ? ch + 16 : end;
          for (uintptr_t a = lo; a < hi; a += sizeof(T))
            *reinterpret_cast<T*>(dst + (a - ch)) = *reinterpret_cast<const T*>(a);
        }
      }
    }
    shifts[q] = static_cast<unsigned char>(shift);
    if (r == 0) {
      unsigned rows = 0, cols = 0;
      if (n < n_pix) {
#pragma unroll
        for (int k = 0; k < P; ++k) {
          const int yk = c.y0 - R + k;
          const int xk = c.x0 - R + k;
          rows |= static_cast<unsigned>(yk >= 0 && yk < hl) << k;
          cols |= static_cast<unsigned>(xk >= 0 && xk < wl) << k;
        }
      }
      items[item] = Item{c.fx, c.fy, rows, cols};
    }
  }
}

// blend one buffer's windows into the staging buffer, one window column a thread
template <int L, typename T>
__device__ __forceinline__ void blend(const unsigned char* buf, const Item* items,
                                      const unsigned char* shifts, T* stage) {
  using Lay = Layout<L, T>;
  for (int c = threadIdx.x; c < Lay::ITEMS * NW; c += THREADS) {
    const int item = c / NW;
    const int ix = c - item * NW;
    const Item it = items[item];
    const float gx = __fsub_rn(1.f, it.fx);
    const float gy = __fsub_rn(1.f, it.fy);
    const float w00 = __fmul_rn(gx, gy);
    const float w10 = __fmul_rn(it.fx, gy);
    const float w01 = __fmul_rn(gx, it.fy);
    const float w11 = __fmul_rn(it.fx, it.fy);
    const bool c0 = (it.cols >> ix) & 1u;
    const bool c1 = (it.cols >> (ix + 1)) & 1u;
    const int q0 = item * P;
    T* o = stage + c * NW;  // the column's 9 outputs: level-major, x slow
    float u0 = 0.f, v0 = 0.f;
#pragma unroll
    for (int r = 0; r < P; ++r) {
      const bool live = (it.rows >> r) & 1u;
      const T* row = reinterpret_cast<const T*>(buf + (q0 + r) * Lay::SLOT + shifts[q0 + r]);
      const float u1 = live && c0 ? to_f32(row[ix]) : 0.f;
      const float v1 = live && c1 ? to_f32(row[ix + 1]) : 0.f;
      if (r > 0) {
        float v = __fmul_rn(w00, u0);
        v = __fadd_rn(v, __fmul_rn(w10, v0));
        v = __fadd_rn(v, __fmul_rn(w01, u1));
        v = __fadd_rn(v, __fmul_rn(w11, v1));
        o[r - 1] = from_f32<T>(v);
      }
      u0 = u1;
      v0 = v1;
    }
  }
}

// the staged outputs of group g to out, 16 bytes a store; the ragged tail value by value
template <int L, typename T>
__device__ __forceinline__ void store(const T* stage, T* __restrict__ out, long long g,
                                      long long n_pix) {
  constexpr int PER_PIX = L * TAPS;
  constexpr int VEC = 16 / sizeof(T);
  T* dst = out + g * GROUP * PER_PIX;
  const long long left = (n_pix - g * GROUP) * PER_PIX;
  const int valid = left < GROUP * PER_PIX ? static_cast<int>(left) : GROUP * PER_PIX;
  for (int k = threadIdx.x * VEC; k < valid; k += THREADS * VEC) {
    if (k + VEC <= valid) {
      *reinterpret_cast<uint4*>(dst + k) = *reinterpret_cast<const uint4*>(stage + k);
    } else {
      for (int e = k; e < valid; ++e) dst[e] = stage[e];
    }
  }
}

template <int L, typename T>
__global__ void __launch_bounds__(THREADS)
raft_window_lookup_kernel(const Pyramid<T> pyr, const float* __restrict__ coords,
                          T* __restrict__ out, long long n_pix, long long n_groups) {
  using Lay = Layout<L, T>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ const T* vol[L];
  __shared__ int hs[L];
  __shared__ int ws[L];
  if (threadIdx.x == 0) {
#pragma unroll
    for (int l = 0; l < L; ++l) {  // constant indices: the parameter is not copied to the stack
      vol[l] = pyr.vol[l];
      hs[l] = pyr.h[l];
      ws[l] = pyr.w[l];
    }
  }
  __syncthreads();
  Item* items = reinterpret_cast<Item*>(smem + Lay::ITEMS_AT);
  T* stage = reinterpret_cast<T*>(smem + Lay::STAGE_AT);
  unsigned char* shifts = smem + Lay::SHIFTS_AT;

  long long g = blockIdx.x;
  issue<L, T>(vol, hs, ws, coords, n_pix, g, smem, items, shifts);
  cp_async_commit();
  for (int b = 0; g < n_groups; g += gridDim.x, b ^= 1) {
    const long long next = g + gridDim.x;
    if (next < n_groups)
      issue<L, T>(vol, hs, ws, coords, n_pix, next, smem + (b ^ 1) * Lay::BUF,
                  items + (b ^ 1) * Lay::ITEMS, shifts + (b ^ 1) * Lay::ROWS);
    cp_async_commit();
    cp_async_wait_one();  // this thread's chunks of group g have landed
    __syncthreads();      // and every thread's
    blend<L, T>(smem + b * Lay::BUF, items + b * Lay::ITEMS, shifts + b * Lay::ROWS,
                stage);
    __syncthreads();      // the buffer is free again, the stage full
    store<L, T>(stage, out, g, n_pix);
  }
}

// blocks of the <L, T> kernel that fit one SM and the SMs of the current device, set up
// once per device (the dynamic shared memory above 48 KB is opted into there)
template <int L, typename T>
cudaError_t residency(int* blocks_per_sm, int* sms) {
  static int cached[MAX_DEVICES][2];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (cached[dev][0] == 0) {
    const auto kernel = raft_window_lookup_kernel<L, T>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Layout<L, T>::BYTES);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&cached[dev][0], kernel, THREADS,
                                                          Layout<L, T>::BYTES);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&cached[dev][1], cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess && cached[dev][0] == 0) err = cudaErrorInvalidConfiguration;
    if (err != cudaSuccess) {
      cached[dev][0] = 0;
      return err;
    }
  }
  *blocks_per_sm = cached[dev][0];
  *sms = cached[dev][1];
  return cudaSuccess;
}

template <int L, typename T>
int launch(const void* const* vols, const int* hw, const float* coords, void* out,
           long long n, cudaStream_t s) {
  Pyramid<T> pyr{};
  for (int l = 0; l < L; ++l) {
    pyr.vol[l] = static_cast<const T*>(vols[l]);
    pyr.h[l] = hw[2 * l];
    pyr.w[l] = hw[2 * l + 1];
  }
  int blocks_per_sm = 0, sms = 0;
  const cudaError_t err = residency<L, T>(&blocks_per_sm, &sms);
  if (err != cudaSuccess) return err;
  const long long groups = (n + GROUP - 1) / GROUP;
  const long long resident = static_cast<long long>(blocks_per_sm) * sms;
  const unsigned grid = static_cast<unsigned>(groups < resident ? groups : resident);
  raft_window_lookup_kernel<L, T><<<grid, THREADS, Layout<L, T>::BYTES, s>>>(
      pyr, coords, static_cast<T*>(out), n, groups);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* const* vols, const int* hw, int levels, const float* coords,
             void* out, long long n, cudaStream_t s) {
  switch (levels) {
    case 1: return launch<1, T>(vols, hw, coords, out, n, s);
    case 2: return launch<2, T>(vols, hw, coords, out, n, s);
    case 3: return launch<3, T>(vols, hw, coords, out, n, s);
    default: return launch<4, T>(vols, hw, coords, out, n, s);
  }
}

template <typename T>
int occupancy(int levels) {
  int blocks = 0, sms = 0;
  cudaError_t err;
  switch (levels) {
    case 1: err = residency<1, T>(&blocks, &sms); break;
    case 2: err = residency<2, T>(&blocks, &sms); break;
    case 3: err = residency<3, T>(&blocks, &sms); break;
    default: err = residency<4, T>(&blocks, &sms); break;
  }
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

}  // namespace

// vols: `levels` (1 to 4) device pointers to contiguous [n, h_l, w_l] planes of one
// dtype (0 = float32, 1 = bfloat16); hw: host array {h_0, w_0, h_1, w_1, ...} (a level
// may be empty); coords: [n, 2] float32 (x, y) at level 0's scale; out: [n, levels·81]
// of the volume's dtype, 16-byte aligned. r must be 4. Launches on `stream` and returns
// the cudaError_t of the launch (0 on success); it does not synchronise.
extern "C" int prisma_raft_window_lookup(const void* const* vols, const int* hw,
                                         int levels, const float* coords, void* out,
                                         long long n, int r, int dtype, void* stream) {
  if (r != R || levels < 1 || levels > MAX_LEVELS || n <= 0) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(out) % 16 != 0) return cudaErrorInvalidValue;
  for (int l = 0; l < levels; ++l) {
    if (hw[2 * l] < 0 || hw[2 * l + 1] < 0) return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return dispatch<bf16>(vols, hw, levels, coords, out, n, s);
  if (dtype == 0) return dispatch<float>(vols, hw, levels, coords, out, n, s);
  return cudaErrorInvalidValue;
}

// The blocks of the kernel for `levels` levels of `dtype` that fit one SM of the current
// device (its occupancy), or minus a cudaError_t.
extern "C" int prisma_raft_window_lookup_blocks_per_sm(int levels, int dtype) {
  if (levels < 1 || levels > MAX_LEVELS) return -static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1) return occupancy<bf16>(levels);
  if (dtype == 0) return occupancy<float>(levels);
  return -static_cast<int>(cudaErrorInvalidValue);
}
