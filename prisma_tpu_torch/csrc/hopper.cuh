// Hopper (sm_90a) primitives shared by the port's bf16 attention kernels
// (flash_attention.cu: K1/K2; flash_attention_streamed.cu: K3) and the probe kernels
// (probe_gather.cu: K6a/K6b), as inline PTX: shared-memory mbarriers, TMA tile loads, bulk
// copies of contiguous spans, wgmma descriptors and the S = Q·Kᵀ product, the SFU exp2, and
// the host side of a launch (tensor maps, the dynamic shared-memory cap).
//
// ops/cuda/build.py hashes this header into the name of every library whose source
// includes it, so an edit here rebuilds them all.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace hopper {

// ------------------------------------------------------------ device side (PTX)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

// One arrival that also makes the phase wait for `bytes` of TMA traffic.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// One arrival from each thread where `pred` holds, predicated in PTX rather than branched
// around: code between a wgmma and its wait stays one basic block.
__device__ __forceinline__ void mbar_arrive_if(uint32_t bar, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.u32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(bar),
      "r"(uint32_t(pred))
      : "memory");
}

// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// A TMA load of one box at (c0, c1, c2) of a 3-D tensor map into shared memory.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Makes mbarrier inits visible to the async proxy (and the cluster) before first use.
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Orders this thread's earlier generic-proxy accesses to shared memory (stores that a bulk
// store will read, reads of a buffer that a bulk load will overwrite) before later
// async-proxy operations.
__device__ __forceinline__ void fence_proxy_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// A bulk copy (no tensor map) of `bytes` contiguous bytes from global to shared memory,
// completing on the mbarrier `bar` as `bytes` of transaction. Both addresses 16-byte
// aligned, `bytes` a multiple of 16.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// A bulk copy of `bytes` contiguous bytes from shared to global memory, in this thread's
// current bulk group (alignment as bulk_load).
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               ::"l"(reinterpret_cast<uint64_t>(dst)), "r"(src), "r"(bytes)
               : "memory");
}

// Closes this thread's bulk group (an empty one if it issued no bulk store since).
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Waits until at most N of this thread's bulk groups still read shared memory: the buffers of
// the others may be written again.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}

// Waits until at most N of this thread's bulk groups are incomplete.
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Waits until at most N of this warpgroup's committed wgmma groups are still in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Pins registers that an asynchronous wgmma reads or writes at this point of the program,
// so that the compiler moves no access to them across a wgmma fence, commit or wait.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// A wgmma shared-memory matrix descriptor: start address, leading and stride byte offsets
// (16-byte units), and the swizzle (1: 128-byte, 2: 64-byte). K-major swizzled operands
// ignore the leading offset; MN-major ones step to the next 64 (32) columns with it.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint32_t swizzle) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (uint64_t(swizzle) << 62);
}

// d = A·Bᵀ (first) or d += A·Bᵀ, m64n128k16: A [64, 16] and B [128, 16] bf16, both K-major
// in shared memory, d in f32 registers with every accumulator register named (inline PTX
// takes no arrays). The first form writes d without reading it (wgmma's scale-d false).
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}
__device__ __forceinline__ void wgmma_ss_first(float (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      :
      "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
      "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
      "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
      "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
      "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
      "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
      "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
      "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]), "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(0));
}

// 2^x in one SFU instruction (exp2f adds range fix-ups around the same ex2.approx).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The layout of a [rows, D] bf16 tile in shared memory as the TMA writes it and the wgmma
// descriptors read it: 64-column atoms with the 128-byte swizzle (D = 64, 128) or one
// 32-column atom with the 64-byte swizzle (D = 32), each atom [rows, ATOM] in turn.
template <int D>
struct Atoms {
  static constexpr int ATOM = D < 64 ? D : 64;  // columns of one swizzle atom (one TMA box)
  static constexpr int ROW_BYTES = ATOM * 2;    // 128 or 64: the swizzle's width
  static constexpr int COUNT = D / ATOM;
  static constexpr uint32_t SWIZZLE = ROW_BYTES == 128 ? 1 : 2;  // descriptor code
  static constexpr uint32_t GROUP_BYTES = 8 * ROW_BYTES;          // one 8-row pattern

  // Byte offset of columns [16·kk, 16·kk + 16) of a [rows, D] tile.
  static __device__ __forceinline__ uint32_t k_offset(int kk, int rows) {
    return (kk * 16 / ATOM) * rows * ROW_BYTES + (kk * 16 % ATOM) * 2;
  }
  // The descriptor of the K-major [64 or 128, 16] slice kk of a tile at `tile` (the tile's
  // first row, which must start a swizzle pattern) with `rows` rows in each atom.
  static __device__ __forceinline__ uint64_t desc(uint32_t tile, int kk, int rows) {
    return smem_desc(tile + k_offset(kk, rows), 16, GROUP_BYTES, SWIZZLE);
  }
};

// S = Q·Kᵀ for 64 query rows at q_tile (in a Q tile of q_rows rows an atom) and a 128-key
// tile at k_tile: D / 16 wgmma issued, neither committed nor waited on. The first product
// writes S without reading it, so S's old values need not be live.
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[64], uint32_t q_tile, int q_rows,
                                         uint32_t k_tile) {
  using A = Atoms<D>;
  wgmma_ss_first(s, A::desc(q_tile, 0, q_rows), A::desc(k_tile, 0, 128));
#pragma unroll
  for (int kk = 1; kk < D / 16; ++kk)
    wgmma_ss(s, A::desc(q_tile, kk, q_rows), A::desc(k_tile, kk, 128));
}

// ------------------------------------------------------------ host side

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, fetched once through the runtime (no -lcuda).
inline EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                                             12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A 3-D tensor map over a [batch, n, D] bf16 tensor whose box is one swizzle atom of
// `rows` rows (Atoms<D>): rows past n of a batch row are out of bounds and read as zeros.
template <int D>
cudaError_t encode_tensor_map(CUtensorMap* map, const void* ptr, int batch, int n, int rows) {
  using A = Atoms<D>;
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[3] = {cuuint64_t(D), cuuint64_t(n), cuuint64_t(batch)};
  const cuuint64_t strides[2] = {cuuint64_t(D) * 2, cuuint64_t(n) * D * 2};  // bytes
  const cuuint32_t box[3] = {cuuint32_t(A::ATOM), cuuint32_t(rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
      unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      A::ROW_BYTES == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The dynamic shared-memory cap of one kernel, raised once per device (the attribute
// belongs to the device's context) instead of on every launch. One static instance per
// kernel.
class SmemCap {
 public:
  template <typename Kernel>
  cudaError_t raise(Kernel* kernel, int bytes) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const uint64_t bit = dev < 64 ? uint64_t(1) << dev : 0;
    if (bit && (done_.load(std::memory_order_acquire) & bit)) return cudaSuccess;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess) done_.fetch_or(bit, std::memory_order_release);
    return err;
  }

 private:
  std::atomic<uint64_t> done_{0};  // one bit per device index below 64
};

}  // namespace hopper
