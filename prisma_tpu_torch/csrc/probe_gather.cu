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
// question arises here; they are ported as the functions they compute, and sized as the probe
// sized them: a [32·180, 102] block of RAFT's level-0 lookup, 2295 such blocks an iteration.
//
// What bounds them on this card: memory. Both only move values (as bits: uint16_t carries a
// bfloat16, uint32_t a float32), so each is exact.
//
// lane_gather. A row's output needs only its `taps` window of x: column l >= taps - 1 repeats
// the last tap. A block owns tiles of up to 64 whole rows, each one contiguous span of o (26 KB
// of float32, 13 KB of bfloat16 at H = 102); it builds a tile's span in shared memory and
// writes it with one bulk copy (cp.async.bulk, shared -> global). The grid is persistent and
// each block has two span buffers, so a tile's store drains while the next tile is built.
// Where taps <= 32 (the fast path) a warp reads a row's window and last tap in one load (lane
// j: tap j, its clamped index computed once), and the reads run ahead of the writes in a
// pipeline: a tile's offsets (one load for a warp's rows, then shuffles) two tiles ahead, its
// windows one tile ahead, so that no tile waits for memory; the build then writes two columns
// a lane (8 or 4 bytes a store). Other taps go through the general build, four rows a warp at
// a time, and rows longer than an eighth of a span a chunk of one row at a time. A span whose
// bytes are not a multiple of 16 or whose start in o is not 16-byte aligned (the ragged last
// tile, rows whose length does not align them) is written by the block's threads, value by
// value: the one tail path.
//
// minor_transpose. Each batch's [W, T] slab of x is one contiguous run, and so is its [T, W]
// slab of o. A block takes a tile of whole slabs (as many as fit 24 KB) with one bulk copy
// into shared memory, transposes it into a second buffer and writes that with one bulk copy;
// two buffers each way and a persistent grid keep a tile's load and the previous tile's store
// in flight under the transpose. There the warps step along t together, each lane one w of a
// run of 32, with no division; lane group q starts q (2q for 2-byte values) further along t,
// so that the 32 reads of a step fall in different banks where rows w·T share them (T = 16:
// lanes 2q and 2q + 1) and its 32 writes, consecutive w, do too; odd T needs no shift. Slabs
// larger than a buffer take 32x32 tiles through padded shared memory; batches are folded into
// a 1-D grid, so B has no limit of its own. Input or output not 16-byte aligned, or slabs
// whose bytes are not a multiple of 16, go through the same shared-memory transpose with plain
// loads and stores.
//
// The kernels the port had before this design (one thread per output value; 32x32 tiles with
// the batch on grid.z) stay below as `*_previous_kernel`, behind their own C entries, so that
// chip_smoke.py can time them beside the new ones at the same shapes. No wrapper calls them.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "hopper.cuh"  // mbarriers, bulk copies, proxy fences

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_DEVICES = 64;

// ------------------------------------------------------------ lane_gather

constexpr int SPAN_MAX = 32768;  // bytes of one span buffer at most; two a block
constexpr int ROWS_MAX = 64;     // rows a tile
constexpr int ROW_BATCH = ROWS_MAX / WARPS;  // rows a warp holds in flight
constexpr int GATHER_BLOCKS_PER_SM = 4;      // the launch bound: 64 registers a thread

struct GatherTiles {
  long long s;      // rows of x
  int h;            // row length
  int t;            // min(taps, h): past h, min(l, taps - 1) = l
  int rows;         // rows a tile: a multiple of 8, at most 64; 1 when a row is chunked
  int cols;         // columns a tile: h, or a chunk of a row longer than an eighth of a span
  int chunks;       // tiles a row group: 1, or ceil(h / cols)
  long long tiles;
  int span;         // values of one span buffer (its bytes a multiple of 16)
};

__device__ __forceinline__ int clamp_col(int i, int h) { return min(max(i, 0), h - 1); }

__device__ __forceinline__ int rows_from(const GatherTiles& g, long long s0) {
  return static_cast<int>(min(static_cast<long long>(g.rows), g.s - s0));
}

// The offsets of a tile of whole rows: lane k of warp w holds row w + 8k's (k < ROW_BATCH),
// clamped to [-h, h] (an offset past either end clamps as one at -h or h does, and off + col
// cannot overflow); 0 past the last tile.
__device__ __forceinline__ int tile_offsets(const int* __restrict__ off, const GatherTiles& g,
                                            long long tile) {
  const int r = (threadIdx.x >> 5) + WARPS * (threadIdx.x & 31);
  const long long s0 = tile * g.rows;
  const int nr = tile < g.tiles ? rows_from(g, s0) : 0;
  return r < nr ? min(max(off[s0 + r], -g.h), g.h) : 0;
}

// The fast path's loads (taps <= 32, whole rows): for row warp + 8u of the tile, lane j < t
// takes x[s, clip(off[s] + j)], the window and at j = t - 1 the last tap, in one load a row.
template <typename T>
__device__ __forceinline__ void fetch_windows(const T* __restrict__ x, const GatherTiles& g,
                                              long long tile, int offs, T (&v)[ROW_BATCH]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long s0 = tile * g.rows;
  const int nr = tile < g.tiles ? rows_from(g, s0) : 0;
#pragma unroll
  for (int u = 0; u < ROW_BATCH; ++u) {
    const int r = warp + WARPS * u;
    const int o = __shfl_sync(FULL, offs, u);
    v[u] = r < nr && lane < g.t ? x[(s0 + r) * g.h + clamp_col(o + lane, g.h)] : T(0);
  }
}

// Two values as one store: 8 bytes of float32, 4 of bfloat16.
template <typename T> struct Pair;
template <> struct Pair<uint32_t> {
  using type = uint2;
  static __device__ __forceinline__ uint2 pack(uint32_t a, uint32_t b) { return make_uint2(a, b); }
};
template <> struct Pair<uint16_t> {
  using type = uint32_t;
  static __device__ __forceinline__ uint32_t pack(uint16_t a, uint16_t b) {
    return uint32_t(a) | (uint32_t(b) << 16);
  }
};

// The fast path's rows into span [nr, h] from fetch_windows' values: columns below t - 1 from
// their lanes, the rest the last tap (lane t - 1's), two columns a lane where h is even.
template <typename T>
__device__ __forceinline__ void write_windows(T* span, const GatherTiles& g, int nr,
                                              const T (&v)[ROW_BATCH]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = g.h, t = g.t;
#pragma unroll
  for (int u = 0; u < ROW_BATCH; ++u) {
    const int r = warp + WARPS * u;
    if (r >= nr) break;  // the same for the whole warp
    T* d = span + r * h;
    const T last = __shfl_sync(FULL, v[u], t - 1);
    if (h % 2 == 0) {  // lane p: columns 2p and 2p + 1; the window ends below column 31
      const T a = __shfl_sync(FULL, v[u], min(2 * lane, 31));
      const T b = __shfl_sync(FULL, v[u], min(2 * lane + 1, 31));
      auto* dp = reinterpret_cast<typename Pair<T>::type*>(d);
      for (int p = lane; 2 * p < h; p += 32)
        dp[p] = Pair<T>::pack(2 * p < t - 1 ? a : last, 2 * p + 1 < t - 1 ? b : last);
    } else {
      for (int c = lane; c < h; c += 32) d[c] = c < t - 1 ? v[u] : last;
    }
  }
}

// The general path, rows: tile rows [s0, s0 + nr) whole into span [nr, h], any taps; offs as
// tile_offsets gives them. Four rows a warp at a time, so that their loads are in flight
// together.
template <typename T>
__device__ __forceinline__ void build_rows(const T* __restrict__ x, T* span, long long s0, int nr,
                                           int h, int t, int offs) {
  constexpr int BATCH = 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int k0 = 0; warp + WARPS * k0 < nr; k0 += BATCH) {
    const T* row[BATCH];
    int o[BATCH];
    T last[BATCH];
    bool live[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int r = warp + WARPS * (k0 + u);
      live[u] = r < nr;
      o[u] = __shfl_sync(FULL, offs, (k0 + u) & 31);
      row[u] = x + (s0 + (live[u] ? r : 0)) * h;
      last[u] = live[u] ? row[u][clamp_col(o[u] + t - 1, h)] : T(0);
    }
    for (int c = lane; c < h; c += 32) {
      T v[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u)
        v[u] = live[u] && c < t - 1 ? row[u][clamp_col(o[u] + c, h)] : last[u];
#pragma unroll
      for (int u = 0; u < BATCH; ++u)
        if (live[u]) span[(warp + WARPS * (k0 + u)) * h + c] = v[u];
    }
  }
}

// The general path, a chunk: columns [c0, c0 + nc) of row s into span [nc], by the whole block.
template <typename T>
__device__ __forceinline__ void build_chunk(const T* __restrict__ x, const int* __restrict__ off,
                                            T* span, long long s, int c0, int nc, int h, int t) {
  const int o = min(max(off[s], -h), h);
  const T* row = x + s * h;
  const T last = row[clamp_col(o + t - 1, h)];
  for (int c = threadIdx.x; c < nc; c += THREADS) {
    const int col = c0 + c;
    span[c] = col < t - 1 ? row[clamp_col(o + col, h)] : last;
  }
}

// Before a span buffer is written: the bulk store of two tiles back has read it.
__device__ __forceinline__ void begin_span() {
  if (threadIdx.x == 0) hopper::bulk_wait_read<1>();
  __syncthreads();
}

// The span's n values to dst: one bulk copy, or, where its bytes are not a multiple of 16 or
// dst is not 16-byte aligned, the block's threads value by value (the tail path). A bulk group
// is committed every tile (an empty one on the tail path), so that "one group left" in
// begin_span always means the previous tile's.
template <typename T>
__device__ __forceinline__ void end_span(const T* span, T* dst, int n) {
  const uint32_t bytes = static_cast<uint32_t>(n) * sizeof(T);
  if (bytes % 16 == 0 && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    hopper::fence_proxy_async_smem();
    __syncthreads();
    if (threadIdx.x == 0) hopper::bulk_store(dst, hopper::smem_u32(span), bytes);
  } else {
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += THREADS) dst[i] = span[i];
  }
  if (threadIdx.x == 0) hopper::bulk_commit();
}

template <typename T>
__global__ void __launch_bounds__(THREADS, GATHER_BLOCKS_PER_SM)
lane_gather_kernel(const T* __restrict__ x, const int* __restrict__ off, T* __restrict__ o,
                   GatherTiles g) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* const spans = reinterpret_cast<T*>(smem);
  const long long step = gridDim.x;
  int it = 0;
  if (g.chunks == 1 && g.t <= 32) {
    // the fast path, a pipeline: a tile's offsets load two tiles ahead and its windows one
    // tile ahead, so that no tile waits on memory for its reads
    int offs_next = tile_offsets(off, g, blockIdx.x + step);
    T v[ROW_BATCH];
    fetch_windows(x, g, blockIdx.x, tile_offsets(off, g, blockIdx.x), v);
    for (long long tile = blockIdx.x; tile < g.tiles; tile += step, ++it) {
      const int offs_after = tile_offsets(off, g, tile + 2 * step);
      T v_next[ROW_BATCH];
      fetch_windows(x, g, tile + step, offs_next, v_next);
      T* span = spans + (it & 1) * g.span;
      const long long s0 = tile * g.rows;
      const int nr = rows_from(g, s0);
      begin_span();
      write_windows(span, g, nr, v);
      end_span(span, o + s0 * g.h, nr * g.h);
#pragma unroll
      for (int u = 0; u < ROW_BATCH; ++u) v[u] = v_next[u];
      offs_next = offs_after;
    }
  } else {
    for (long long tile = blockIdx.x; tile < g.tiles; tile += step, ++it) {
      T* span = spans + (it & 1) * g.span;
      long long group = tile;
      int c0 = 0;
      if (g.chunks > 1) {
        group = tile / g.chunks;  // once a tile
        c0 = static_cast<int>(tile - group * g.chunks) * g.cols;
      }
      const long long s0 = group * g.rows;
      const int nr = rows_from(g, s0);
      const int nc = min(g.cols, g.h - c0);
      begin_span();
      if (g.chunks > 1) {
        build_chunk(x, off, span, s0, c0, nc, g.h, g.t);
      } else {
        build_rows(x, span, s0, nr, g.h, g.t, tile_offsets(off, g, tile));
      }
      end_span(span, o + s0 * g.h + c0, nr * nc);
    }
  }
  if (threadIdx.x == 0) hopper::bulk_wait<0>();
}

// ------------------------------------------------------------ minor_transpose

constexpr int SLAB_BYTES = 24576;  // one buffer: two take slabs in, two send them out
constexpr int SLAB_SMEM = 4 * SLAB_BYTES + 2 * sizeof(uint64_t);  // + two mbarriers
constexpr int TILE = 32;

struct SlabTiles {
  long long b;      // slabs
  int w, t;
  int k;            // slabs a tile
  long long tiles;  // ceil(b / k)
  int rot_shift;    // lane >> rot_shift: the lane's group
  int rot_step;     // elements a group is shifted along t: 1 (4-byte values) or 2 (2-byte)
};

// nk slabs [w, t] of `in` -> [t, w] in `out`, both in shared memory. The warps step along t
// together (warp k takes t = k, k + 8, ...), each lane one w of a run of 32; no division.
template <typename E>
__device__ __forceinline__ void transpose_slabs(const E* in, E* out, int nk, const SlabTiles& g) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int w = g.w, t = g.t;
  const int shift = g.rot_step * (lane >> g.rot_shift);  // < t
  for (int slab = 0; slab < nk; ++slab) {
    const E* src = in + slab * w * t;
    E* dst = out + slab * w * t;
    for (int wi = lane; wi - lane < w; wi += 32) {
      if (wi < w) {
#pragma unroll 4
        for (int k = warp; k < t; k += WARPS) {
          int ti = k + shift;
          if (ti >= t) ti -= t;
          dst[ti * w + wi] = src[wi * t + ti];
        }
      }
    }
  }
}

template <typename E>
__global__ void __launch_bounds__(THREADS)
minor_transpose_kernel(const E* __restrict__ x, E* __restrict__ o, SlabTiles g) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int BUF = SLAB_BYTES / sizeof(E);
  E* const in = reinterpret_cast<E*>(smem);  // two buffers
  E* const out = in + 2 * BUF;               // two buffers
  uint64_t* const bars = reinterpret_cast<uint64_t*>(out + 2 * BUF);
  const long long slab = static_cast<long long>(g.w) * g.t;
  const long long stride = static_cast<long long>(g.k) * slab;  // elements a tile
  const bool bulk = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(o)) & 15) == 0
                    && (slab * static_cast<long long>(sizeof(E))) % 16 == 0;
  auto slabs_of = [&](long long tile) {
    return static_cast<int>(min(static_cast<long long>(g.k), g.b - tile * g.k));
  };

  if (!bulk) {  // the tail path: the same transpose, plain loads and stores
    for (long long tile = blockIdx.x; tile < g.tiles; tile += gridDim.x) {
      const int n = slabs_of(tile) * static_cast<int>(slab);
      const E* src = x + tile * stride;
      E* dst = o + tile * stride;
      __syncthreads();  // the previous tile's reads of both buffers are done
      for (int i = threadIdx.x; i < n; i += THREADS) in[i] = src[i];
      __syncthreads();
      transpose_slabs(in, out, slabs_of(tile), g);
      __syncthreads();
      for (int i = threadIdx.x; i < n; i += THREADS) dst[i] = out[i];
    }
    return;
  }

  const uint32_t bar[2] = {hopper::smem_u32(bars), hopper::smem_u32(bars + 1)};
  auto load = [&](int b, long long tile) {  // one thread
    const uint32_t bytes = static_cast<uint32_t>(slabs_of(tile) * slab * sizeof(E));
    hopper::mbar_arrive_expect_tx(bar[b], bytes);
    hopper::bulk_load(hopper::smem_u32(in + b * BUF), x + tile * stride, bytes, bar[b]);
  };
  if (threadIdx.x == 0) {
    hopper::mbar_init(bar[0], 1);
    hopper::mbar_init(bar[1], 1);
    hopper::fence_mbar_init();
    for (int b = 0; b < 2; ++b) {
      const long long tile = blockIdx.x + static_cast<long long>(b) * gridDim.x;
      if (tile < g.tiles) load(b, tile);
    }
  }
  __syncthreads();
  int it = 0;
  for (long long tile = blockIdx.x; tile < g.tiles; tile += gridDim.x, ++it) {
    const int b = it & 1;
    const int nk = slabs_of(tile);
    if (threadIdx.x == 0) hopper::bulk_wait_read<1>();  // out[b]'s store two tiles back is read
    hopper::mbar_wait(bar[b], (it >> 1) & 1);           // in[b] has landed
    __syncthreads();
    transpose_slabs(in + b * BUF, out + b * BUF, nk, g);
    hopper::fence_proxy_async_smem();  // out[b] written, in[b] read, before the bulk copies
    __syncthreads();
    if (threadIdx.x == 0) {
      hopper::bulk_store(o + tile * stride, hopper::smem_u32(out + b * BUF),
                         static_cast<uint32_t>(nk * slab * sizeof(E)));
      hopper::bulk_commit();
      const long long next = tile + 2LL * gridDim.x;
      if (next < g.tiles) load(b, next);
    }
  }
  if (threadIdx.x == 0) hopper::bulk_wait<0>();
}

// Slabs larger than a buffer: 32x32 tiles through shared memory (a column of padding), the
// tiles of every slab in one 1-D sequence that the grid walks.
template <typename E>
__global__ void __launch_bounds__(THREADS)
minor_transpose_tiled_kernel(const E* __restrict__ x, E* __restrict__ o, long long b, int w,
                             int t) {
  __shared__ E tile[TILE][TILE + 1];
  const int lane = threadIdx.x & 31, row0 = threadIdx.x >> 5;
  const int tiles_t = (t + TILE - 1) / TILE;
  const long long per_slab = static_cast<long long>(tiles_t) * ((w + TILE - 1) / TILE);
  const long long slab = static_cast<long long>(w) * t;
  for (long long id = blockIdx.x; id < b * per_slab; id += gridDim.x) {
    const long long bi = id / per_slab;  // once a tile of 1024 values
    const int rem = static_cast<int>(id - bi * per_slab);
    const int t0 = (rem % tiles_t) * TILE, w0 = (rem / tiles_t) * TILE;
    const E* src = x + bi * slab;  // [w, t]
    E* dst = o + bi * slab;        // [t, w]
    __syncthreads();               // the previous tile's reads are done
    for (int r = row0; r < TILE; r += WARPS) {
      const int wi = w0 + r, ti = t0 + lane;
      if (wi < w && ti < t) tile[r][lane] = src[static_cast<long long>(wi) * t + ti];
    }
    __syncthreads();
    for (int r = row0; r < TILE; r += WARPS) {
      const int ti = t0 + r, wi = w0 + lane;
      if (wi < w && ti < t) dst[static_cast<long long>(ti) * w + wi] = tile[lane][r];
    }
  }
}

// ------------------------------------------------------------ the previous design (timing only)

constexpr int PREVIOUS_ROWS = 8;

template <typename T>
__global__ void __launch_bounds__(THREADS)
lane_gather_previous_kernel(const T* __restrict__ x, const int* __restrict__ off,
                            T* __restrict__ o, long long total, int h, int taps) {
  const long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= total) return;
  const long long s = i / h;
  const int l = static_cast<int>(i - s * h);
  int idx = off[s] + min(l, taps - 1);
  idx = min(max(idx, 0), h - 1);
  o[i] = x[s * h + idx];
}

template <typename T>
__global__ void __launch_bounds__(TILE * PREVIOUS_ROWS)
minor_transpose_previous_kernel(const T* __restrict__ x, T* __restrict__ o, int w, int t) {
  __shared__ T tile[TILE][TILE + 1];
  const size_t b = blockIdx.z;
  const T* src = x + b * static_cast<size_t>(w) * t;
  T* dst = o + b * static_cast<size_t>(w) * t;
  const int t0 = blockIdx.x * TILE;
  const int w0 = blockIdx.y * TILE;
  for (int r = threadIdx.y; r < TILE; r += PREVIOUS_ROWS) {
    const int wi = w0 + r;
    const int ti = t0 + threadIdx.x;
    if (wi < w && ti < t) tile[r][threadIdx.x] = src[static_cast<size_t>(wi) * t + ti];
  }
  __syncthreads();
  for (int r = threadIdx.y; r < TILE; r += PREVIOUS_ROWS) {
    const int ti = t0 + r;
    const int wi = w0 + threadIdx.x;
    if (wi < w && ti < t) dst[static_cast<size_t>(ti) * w + wi] = tile[threadIdx.x][r];
  }
}

// Does nothing: the launch path's own cost, the floor under both kernels' times.
__global__ void empty_kernel() {}

// ------------------------------------------------------------ host side

// Blocks of `kernel` resident on the whole current device at `smem` bytes of dynamic shared
// memory, found once per device and size: the opt-in to `max_smem` (above 48 KB) once per
// device, then the occupancy of each size met (a few per kernel), each cache entry one 64-bit
// word (size, blocks) so that a concurrent reader sees a whole entry or none. One cache per
// kernel type; every kernel here has a type of its own.
template <typename Kernel>
cudaError_t resident_blocks(Kernel* kernel, int smem, int max_smem, long long* blocks) {
  constexpr int SLOTS = 4;
  static std::atomic<uint64_t> cache[MAX_DEVICES][SLOTS];
  static std::atomic<int> sms[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  for (int i = 0; i < SLOTS; ++i) {
    const uint64_t e = cache[dev][i].load(std::memory_order_acquire);
    if (e && static_cast<int>(e >> 32) == smem) {
      *blocks = static_cast<long long>(e & 0xffffffffu);
      return cudaSuccess;
    }
  }
  int n_sms = sms[dev].load(std::memory_order_acquire);
  if (n_sms == 0) {  // first launch of this kernel on the device
    if (max_smem > 48 * 1024)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    sms[dev].store(n_sms, std::memory_order_release);
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  if (err != cudaSuccess) return err;
  if (per_sm == 0) return cudaErrorInvalidConfiguration;
  *blocks = static_cast<long long>(per_sm) * n_sms;
  int slot = SLOTS - 1;  // a free slot, else the last one
  for (int i = 0; i < SLOTS; ++i) {
    if (cache[dev][i].load(std::memory_order_acquire) == 0) {
      slot = i;
      break;
    }
  }
  cache[dev][slot].store((static_cast<uint64_t>(smem) << 32) | static_cast<uint64_t>(*blocks),
                         std::memory_order_release);
  return cudaSuccess;
}

template <typename T>
int launch_gather(const void* x, const int* off, void* o, long long s, int h, int taps,
                  cudaStream_t st) {
  GatherTiles g{s, h, taps < h ? taps : h, 1, h, 1, 0, 0};
  const long long row_bytes = static_cast<long long>(h) * sizeof(T);
  if (8 * row_bytes <= SPAN_MAX) {  // tiles of whole rows, a multiple of 8 of them
    const int rows = static_cast<int>(SPAN_MAX / row_bytes) / 8 * 8;
    g.rows = rows < ROWS_MAX ? rows : ROWS_MAX;
    g.span = g.rows * h;
  } else {  // rows longer than an eighth of a span: a chunk of one row a tile
    g.cols = SPAN_MAX / sizeof(T);
    g.chunks = (h + g.cols - 1) / g.cols;
    g.span = g.cols;
  }
  g.tiles = (s + g.rows - 1) / g.rows * g.chunks;
  const int smem = 2 * g.span * static_cast<int>(sizeof(T));
  long long blocks = 0;
  const cudaError_t err = resident_blocks(lane_gather_kernel<T>, smem, 2 * SPAN_MAX, &blocks);
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>(g.tiles < blocks ? g.tiles : blocks);
  lane_gather_kernel<T><<<grid, THREADS, smem, st>>>(static_cast<const T*>(x), off,
                                                     static_cast<T*>(o), g);
  return cudaGetLastError();
}

template <typename E>
int launch_transpose(const void* x, void* o, long long b, int w, int t, cudaStream_t st) {
  const long long slab_bytes = static_cast<long long>(w) * t * sizeof(E);
  long long blocks = 0;
  cudaError_t err;
  if (slab_bytes <= SLAB_BYTES) {
    SlabTiles g{b, w, t, static_cast<int>(SLAB_BYTES / slab_bytes), 0, 5, 1};
    g.tiles = (b + g.k - 1) / g.k;
    // the lanes whose rows w·t share a bank are those equal mod 32/g, g the power of two in
    // the row's 4-byte words (at most 32); lane >> log2(32/g) numbers the g of them, each
    // shifted apart along t (2-byte values of an odd T straddle words: no shift)
    const int words = sizeof(E) == 4 ? t : (t % 2 == 0 ? t / 2 : 0);
    if (words) {
      int log2g = 0;
      while (log2g < 5 && ((words >> log2g) & 1) == 0) ++log2g;
      g.rot_shift = 5 - log2g;
      g.rot_step = sizeof(E) == 4 ? 1 : 2;
    }
    err = resident_blocks(minor_transpose_kernel<E>, SLAB_SMEM, SLAB_SMEM, &blocks);
    if (err != cudaSuccess) return err;
    const unsigned grid = static_cast<unsigned>(g.tiles < blocks ? g.tiles : blocks);
    minor_transpose_kernel<E><<<grid, THREADS, SLAB_SMEM, st>>>(
        static_cast<const E*>(x), static_cast<E*>(o), g);
  } else {
    err = resident_blocks(minor_transpose_tiled_kernel<E>, 0, 0, &blocks);
    if (err != cudaSuccess) return err;
    const long long tiles =
        b * ((t + TILE - 1) / TILE) * static_cast<long long>((w + TILE - 1) / TILE);
    const unsigned grid = static_cast<unsigned>(tiles < blocks ? tiles : blocks);
    minor_transpose_tiled_kernel<E><<<grid, THREADS, 0, st>>>(
        static_cast<const E*>(x), static_cast<E*>(o), b, w, t);
  }
  return cudaGetLastError();
}

}  // namespace

// x: [s, h] contiguous, off: [s] int32, o: [s, h]; dtype 0 = float32, 1 = bfloat16.
// Launches on `stream`, returns the cudaError_t of the launch; does not synchronise.
extern "C" int prisma_lane_gather(const void* x, const int* off, void* o, long long s, int h,
                                  int taps, int dtype, void* stream) {
  if (s <= 0 || h <= 0 || h >= (1 << 30) || taps <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_gather<uint16_t>(x, off, o, s, h, taps, st);
  if (dtype == 0) return launch_gather<uint32_t>(x, off, o, s, h, taps, st);
  return cudaErrorInvalidValue;
}

// x: [b, w, t] contiguous -> o: [b, t, w]; w·t < 2^31; dtype as above.
extern "C" int prisma_minor_transpose(const void* x, void* o, long long b, int w, int t,
                                      int dtype, void* stream) {
  if (b <= 0 || w <= 0 || t <= 0 || static_cast<long long>(w) * t >= (1LL << 31))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_transpose<uint16_t>(x, o, b, w, t, st);
  if (dtype == 0) return launch_transpose<uint32_t>(x, o, b, w, t, st);
  return cudaErrorInvalidValue;
}

// The previous design of lane_gather, with its own arguments as above; for timing only.
extern "C" int prisma_lane_gather_previous(const void* x, const int* off, void* o, long long s,
                                           int h, int taps, int dtype, void* stream) {
  if (s <= 0 || h <= 0 || taps <= 0) return cudaErrorInvalidValue;
  const long long total = s * h;
  const long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    lane_gather_previous_kernel<uint16_t><<<static_cast<unsigned>(blocks), THREADS, 0, st>>>(
        static_cast<const uint16_t*>(x), off, static_cast<uint16_t*>(o), total, h, taps);
  } else if (dtype == 0) {
    lane_gather_previous_kernel<uint32_t><<<static_cast<unsigned>(blocks), THREADS, 0, st>>>(
        static_cast<const uint32_t*>(x), off, static_cast<uint32_t*>(o), total, h, taps);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// The previous design of minor_transpose (b <= 65535: the batch rides on grid.z); for timing
// only.
extern "C" int prisma_minor_transpose_previous(const void* x, void* o, int b, int w, int t,
                                               int dtype, void* stream) {
  if (b <= 0 || w <= 0 || t <= 0 || b > 65535) return cudaErrorInvalidValue;
  const dim3 grid((t + TILE - 1) / TILE, (w + TILE - 1) / TILE, b);
  const dim3 block(TILE, PREVIOUS_ROWS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    minor_transpose_previous_kernel<uint16_t><<<grid, block, 0, st>>>(
        static_cast<const uint16_t*>(x), static_cast<uint16_t*>(o), w, t);
  } else if (dtype == 0) {
    minor_transpose_previous_kernel<uint32_t><<<grid, block, 0, st>>>(
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
