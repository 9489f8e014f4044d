// CBP blocked matmul for Hopper: (M, K) @ (K, N) with planner-chosen
// block knobs, f32 accumulation, output in the input dtype.
//
// Replaces the Pallas kernel `cbp_matmul` (body `_mm_kernel`) in
// src/repro/kernels/cbp_matmul/kernel.py.  There the grid (m, n, k) walks
// (block_m x block_n) output tiles with an f32 accumulator carried in VMEM
// across the k steps of block_k, after zero-padding the operands to the
// block multiple; the docstring gives block_k its meaning: "block_k sets
// how much VMEM the in-flight K-panels occupy (deep prefetch = large
// block_k); throttling = shrinking it".
//
// What bounds it on an H100: operations.  At the qwen3-8b FFN shape
// (4096 x 4096 @ 4096 x 12288, bf16) the 4.1e11 FLOP at the bf16
// tensor-core rate take 0.42 ms, the 0.23 GB of operands 0.07 ms.  Only
// `wgmma` reaches that rate, so this is one tensor-core kernel, templated
// on the input type and on how its tiles are loaded.  In practice the
// feed binds first: at the path's 128 x 128 regions every k step brings
// a block 16 KiB from L2, and tools/matmul_probe.py measures the kernel
// as long as its loads alone there.
//
//   * Mainloop.  A block of 288 threads: warps 0-7 are two consumer
//     warpgroups, each owning 64 rows of a 128 x 128 output tile in f32
//     registers (`wgmma` m64n128); warp 8 is the producer.  It keeps a
//     ring of S stages full; a stage holds the A tile (128 x kT) and the
//     B tile (kT x 128) of one k step, kT = 32.  Stage s has two
//     mbarriers: `full` (the tile has landed) and `empty` (all 8 consumer
//     warps are done with it).  One producer warp, not a warpgroup, leaves
//     each consumer thread up to 224 registers (65,536 / 288).
//   * bf16: TMA loads A K-major with a 64-byte swizzle (kT bf16 a row) and
//     B as it lies in memory, (K, N) row-major, in two 64-column boxes with
//     a 128-byte swizzle; `wgmma` reads B N-major through its transpose
//     bit, so B is never transposed.  Two m64n128k16 products a stage.
//   * f32 on the tensor cores at f32 accuracy: 3xTF32.  `wgmma` takes TF32
//     only K-major for both operands, and TF32 keeps 11 significant bits.
//     TMA loads the f32 tiles unswizzled; each consumer warpgroup splits
//     its 64 rows of A and all of B into hi = tf32(x) and lo = tf32(x - hi)
//     and writes them K-major (128-byte swizzle) into its own tiles, which
//     transposes B; then it issues hi*hi, hi*lo and lo*hi (four m64n128k8
//     each a stage).  `wgmma` sums into its f32 accumulator with less
//     care than f32 rounding (tools/matmul_probe.py: at K = 4096 one
//     accumulator over all of k leaves 8 % of the outputs beyond the
//     1e-4 limit of the exact product), so each stage's products go into
//     a fresh accumulator that is added to the tile's in ordinary f32
//     once they are done: the tensor core never sums more than 32 terms.  hi + lo carries 22 bits of x and the
//     dropped lo*lo term is ~2^-22 relative.  Chosen over a scheme on the
//     CUDA cores (67 TFLOP/s at best) and over 1xTF32 (11 bits, beyond
//     the 1e-4 limit).  The split tiles take 96 KiB, so S <= 4 in f32.
//   * Load stage.  TMA needs 16-byte-aligned bases and row strides.  When
//     a row of A or B (K or N elements) or a base is not, the producer
//     warp's 32 lanes copy the same tiles into the same layouts
//     with ordinary loads and stores, zero-filling past the matrix, then
//     fence them to the async proxy and arrive on `full` (kTma = false).
//     Not `cp.async`: it copies 4, 8 or 16 bytes from an address aligned
//     to that size, and a bf16 row of odd length starts on a 2-byte
//     boundary.  The mainloop and the epilogue are shared; TMA zero-fills
//     past the matrix edge on its own.
//
// The knobs keep their meaning:
//   * block_m x block_n is the region one block owns; the grid is
//     (ceil(N / block_n), ceil(M / block_m)); blocks take regions in
//     groups of 8 region rows, column by column, so that the blocks in
//     flight share A and B panels in L2 (in plain row order the 132
//     blocks of a wave span all of B at full width, and B, 100 MB, is
//     read from memory once per row of regions).  The block walks its region
//     in 128 x 128 tiles, row by row; where the region is not a multiple
//     of 128 (24, 40, 104, ...) a tile's extra rows and columns are
//     computed and not stored: the epilogue masks to region and matrix.
//   * block_k is the k depth kept in flight:
//     S = clamp(ceil(block_k / kT), 2, the stages that fit in 232,448
//     bytes), so block_k = 128 gives 4 stages (64 KiB in bf16).  kT = 32
//     is small so that the path's knobs (128) still give 4 stages.
//
// Dynamic shared memory, the quantity the planner partitions
// (`cbp_matmul_smem_bytes`, mirrored by `smem_footprint_bytes`): S stages
// of 2 * 128 * kT elements of the input type, the f32 split tiles (2
// warpgroups x (64 + 128) x kT x 2 f32 = 96 KiB, f32 only) and the 2 S
// mbarriers: bf16 S * 16,400 bytes, f32 98,304 + S * 32,784 bytes.  The
// launcher refuses a launch whose passed size differs.
//
// The epilogue converts to the input type and stores from registers,
// two columns a store where the row allows, masked to region and matrix.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kConsumers = 256;  // 2 consumer warpgroups (warps 0-7)
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kGroup = 8;       // region rows a raster group spans
constexpr int kTile = 128;      // output tile edge
constexpr int kT = 32;          // k depth of one stage
constexpr int kMaxSmem = 232448;
constexpr int kBarBytes = 16;   // full + empty mbarrier of one stage

// Per input type: the swizzle of the A and B stage tiles and the columns
// of one B box (a TMA box row is at most the swizzle's width).
template <typename T> struct Traits;
template <> struct Traits<__nv_bfloat16> {
  static constexpr int kASw = 64, kBSw = 128, kBBox = 64, kSplit = 0;
};
template <> struct Traits<float> {
  // Split tiles of one warpgroup: A hi, A lo (64 x kT), B hi, B lo
  // (128 x kT), f32.
  static constexpr int kASw = 0, kBSw = 0, kBBox = 128;
  static constexpr int kSplitA = 64 * kT * 4, kSplitB = kTile * kT * 4;
  static constexpr int kSplit = 2 * 2 * (kSplitA + kSplitB);
};

// The tiles of one ring stage: A (kTile x kT), then B (kT x kTile).
__host__ __device__ constexpr int stage_bytes(int dtype_bytes) {
  return 2 * kTile * kT * dtype_bytes;
}

int split_bytes(int dtype_bytes) {
  return dtype_bytes == 4 ? Traits<float>::kSplit : 0;
}

int stages_for(int block_k, int dtype_bytes) {
  const int cap = (kMaxSmem - split_bytes(dtype_bytes)) /
                  (stage_bytes(dtype_bytes) + kBarBytes);
  int s = (block_k + kT - 1) / kT;
  s = s < 2 ? 2 : s;
  return s > cap ? cap : s;
}

// Copies the (rows x cols) tile at (r0, c0) of a row-major matrix with
// `ld` columns into `dst` as TMA would: boxes of kBox columns, each
// stored row-major with a kSw-byte swizzle, zeros past (nr, nc).  Run by
// the 32 lanes of the producer warp.
template <typename T, int kSw, int kBox>
__device__ __forceinline__ void copy_tile(unsigned char* dst,
                                          const T* __restrict__ src, int ld,
                                          int r0, int c0, int nr, int nc,
                                          int rows, int cols, int lane) {
  constexpr int kRowBytes = kBox * (int)sizeof(T);
  for (int e = lane; e < rows * cols; e += 32) {
    const int r = e / cols, c = e % cols;
    const int gr = r0 + r, gc = c0 + c;
    const T v = (gr < nr && gc < nc) ? src[(long)gr * ld + gc] : T(0.f);
    const uint32_t off = (c / kBox) * rows * kRowBytes +
                         hopper::swizzle<kSw>(r * kRowBytes +
                                              (c % kBox) * (int)sizeof(T));
    *reinterpret_cast<T*>(dst + off) = v;
  }
}

// Splits the f32 tile `src` (rows x kT at row stride `ld` floats, or,
// with kTrans, kT x rows, i.e. B) into K-major tf32 hi and lo tiles of
// `rows` rows of kT with a 128-byte swizzle.  Run by one warpgroup.
template <bool kTrans>
__device__ __forceinline__ void split_tile(const float* src, int ld,
                                           unsigned char* hi,
                                           unsigned char* lo, int rows,
                                           int tid) {
  for (int e = tid; e < rows * (kT / 4); e += 128) {
    // kTrans: a thread owns row (n) e % rows, so a warp reads 32
    // consecutive floats of each B row; else a warp reads 4 whole A rows.
    const int r = kTrans ? e % rows : e / (kT / 4);
    const int c = kTrans ? e / rows : e % (kT / 4);
    float x[4];
    if (kTrans) {
#pragma unroll
      for (int j = 0; j < 4; ++j) x[j] = src[(4 * c + j) * ld + r];
    } else {
      const float4 v = *reinterpret_cast<const float4*>(src + r * ld + 4 * c);
      x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
    }
    float4 h, l;
    float* hp = &h.x;
    float* lp = &l.x;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      hp[j] = hopper::to_tf32(x[j]);
      lp[j] = hopper::to_tf32(x[j] - hp[j]);
    }
    const uint32_t off = hopper::swizzle<128>(r * kT * 4 + c * 16);
    *reinterpret_cast<float4*>(hi + off) = h;
    *reinterpret_cast<float4*>(lo + off) = l;
  }
}

// Stores columns col and col + 1 of a row (the second only if `two`),
// with one 2-element store when `pair` (both in range and aligned).
__device__ __forceinline__ void store2(float* p, float x, float y, bool two,
                                       bool pair) {
  if (pair) {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
    return;
  }
  p[0] = x;
  if (two) p[1] = y;
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y,
                                       bool two, bool pair) {
  if (pair) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
    return;
  }
  p[0] = __float2bfloat16(x);
  if (two) p[1] = __float2bfloat16(y);
}

// Region (rm, rn) of linear block `id` in a grid of gm x gn regions, in
// groups of kGroup region rows walked column by column, so the blocks in
// flight at once share a few A row panels and B column panels in L2.
__device__ __forceinline__ void region_of(int id, int gm, int gn, int& rm,
                                          int& rn) {
  const int per_group = kGroup * gn;
  const int first = (id / per_group) * kGroup;
  const int rows = min(gm - first, kGroup);
  rm = first + (id % per_group) % rows;
  rn = (id % per_group) / rows;
}

template <typename T, bool kTma>
__global__ void __launch_bounds__(kThreads, 1)
cbp_matmul_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_b,
                  const T* __restrict__ a, const T* __restrict__ b,
                  T* __restrict__ out, int M, int N, int K, int block_m,
                  int block_n, int stages) {
  using Tr = Traits<T>;
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int kStage = stage_bytes(sizeof(T));
  constexpr int kA = kStage / 2;  // the A tile; B follows it
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* split = smem + stages * kStage;
  uint64_t* full = reinterpret_cast<uint64_t*>(split + Tr::kSplit);
  uint64_t* empty = full + stages;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(&full[s], kTma ? 1 : 32);
      hopper::mbar_init(&empty[s], kConsumers / 32);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  // The region of this block, clipped to the matrix, and its tiles.
  int rm, rn;
  region_of(blockIdx.x + blockIdx.y * gridDim.x, gridDim.y, gridDim.x, rm,
            rn);
  const int m0 = rm * block_m, n0 = rn * block_n;
  const int m_end = min(m0 + block_m, M), n_end = min(n0 + block_n, N);
  const int tiles_n = (n_end - n0 + kTile - 1) / kTile;
  const int tiles = tiles_n * ((m_end - m0 + kTile - 1) / kTile);
  const int nk = (K + kT - 1) / kT;

  if (tid >= kConsumers) {
    // ---- producer warp ----
    const int lane = tid - kConsumers;
    if (kTma && lane != 0) return;
    int it = 0;
    for (int t = 0; t < tiles; ++t) {
      const int tm = m0 + (t / tiles_n) * kTile;
      const int tn = n0 + (t % tiles_n) * kTile;
      for (int kb = 0; kb < nk; ++kb, ++it) {
        const int s = it % stages;
        hopper::mbar_wait(&empty[s], ((it / stages) & 1) ^ 1);
        unsigned char* st = smem + s * kStage;
        if constexpr (kTma) {
          hopper::mbar_arrive_expect_tx(&full[s], kStage);
          hopper::tma_load_2d(st, &map_a, &full[s], kb * kT, tm);
#pragma unroll
          for (int j = 0; j < kTile / Tr::kBBox; ++j)
            hopper::tma_load_2d(st + kA + j * kT * Tr::kBBox * sizeof(T),
                                &map_b, &full[s], tn + j * Tr::kBBox,
                                kb * kT);
        } else {
          copy_tile<T, Tr::kASw, kT>(st, a, K, tm, kb * kT, M, K, kTile, kT,
                                     lane);
          copy_tile<T, Tr::kBSw, Tr::kBBox>(st + kA, b, N, kb * kT, tn, K, N,
                                            kT, kTile, lane);
          hopper::fence_proxy_async();
          hopper::mbar_arrive(&full[s]);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup c owns rows 64 c .. 64 c + 63 of a tile ----
  const int c = tid / 128;
  const int ctid = tid % 128;
  const int warp = ctid / 32, lane = ctid % 32;
  float acc[kTile / 2];
  // f32: the products of one stage, added to acc once they are done, so
  // the tensor core's own sum never grows past one stage's 32 terms.
  float part[kF32 ? kTile / 2 : 1];
  int it = 0;
  for (int t = 0; t < tiles; ++t) {
    const int tm = m0 + (t / tiles_n) * kTile;
    const int tn = n0 + (t % tiles_n) * kTile;
#pragma unroll
    for (int i = 0; i < kTile / 2; ++i) acc[i] = 0.f;
    hopper::fence_operands(acc);
    int pending = -1;  // the stage whose products may still run
    for (int kb = 0; kb < nk; ++kb, ++it) {
      const int s = it % stages;
      hopper::mbar_wait(&full[s], (it / stages) & 1);
      unsigned char* st = smem + s * kStage;
      if constexpr (kF32) {
        // Once this warpgroup's previous products are done (they read the
        // split tiles), add them to acc, then split and multiply.
        unsigned char* a_hi = split + c * (Tr::kSplit / 2);
        unsigned char* a_lo = a_hi + Tr::kSplitA;
        unsigned char* b_hi = a_lo + Tr::kSplitA;
        unsigned char* b_lo = b_hi + Tr::kSplitB;
        if (pending >= 0) {
          hopper::wgmma_wait<0>();
          hopper::fence_operands(part);
#pragma unroll
          for (int i = 0; i < kTile / 2; ++i) acc[i] += part[i];
          hopper::named_bar_sync(1 + c, 128);
        }
        split_tile<false>(reinterpret_cast<const float*>(st) + 64 * c * kT,
                          kT, a_hi, a_lo, 64, ctid);
        split_tile<true>(reinterpret_cast<const float*>(st + kA), kTile,
                         b_hi, b_lo, kTile, ctid);
        hopper::fence_proxy_async();
        hopper::named_bar_sync(1 + c, 128);
        if (lane == 0) hopper::mbar_arrive(&empty[s]);
#pragma unroll
        for (int i = 0; i < kTile / 2; ++i) part[i] = 0.f;
        hopper::fence_operands(part);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kT / 8; ++kk) {
          const uint64_t ah = hopper::smem_desc<128>(a_hi + 32 * kk, 16, 1024);
          const uint64_t al = hopper::smem_desc<128>(a_lo + 32 * kk, 16, 1024);
          const uint64_t bh = hopper::smem_desc<128>(b_hi + 32 * kk, 16, 1024);
          const uint64_t bl = hopper::smem_desc<128>(b_lo + 32 * kk, 16, 1024);
          hopper::wgmma_tf32<kTile>(part, al, bh);
          hopper::wgmma_tf32<kTile>(part, ah, bl);
          hopper::wgmma_tf32<kTile>(part, ah, bh);
        }
        hopper::wgmma_commit();
        hopper::fence_operands(part);
        pending = s;
      } else {
        // A: 64 rows of 64 bytes from row 64 c; B: two 64-column boxes
        // (LBO = 4096 bytes apart), 8-row groups 1024 bytes apart.
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kT / 16; ++kk) {
          const uint64_t da = hopper::smem_desc<64>(
              st + c * 64 * kT * 2 + 32 * kk, 16, 512);
          const uint64_t db = hopper::smem_desc<128>(
              st + kA + kk * 16 * 128, kT * 128, 1024);
          hopper::wgmma_bf16<kTile>(acc, da, db);
        }
        hopper::wgmma_commit();
        hopper::fence_operands(acc);
        hopper::wgmma_wait<1>();
        hopper::fence_operands(acc);
        if (pending >= 0 && lane == 0) hopper::mbar_arrive(&empty[pending]);
        pending = s;
      }
    }
    hopper::wgmma_wait<0>();
    if constexpr (kF32) {
      hopper::fence_operands(part);
#pragma unroll
      for (int i = 0; i < kTile / 2; ++i) acc[i] += part[i];
      // The next tile's first split must not overwrite tiles a slower
      // warp of this warpgroup is still reading.
      hopper::named_bar_sync(1 + c, 128);
    } else {
      hopper::fence_operands(acc);
      if (lane == 0) hopper::mbar_arrive(&empty[pending]);
    }

    // Epilogue: acc[4 j + 2 h + e] is row 16 warp + lane / 4 + 8 h, column
    // 8 j + 2 (lane % 4) + e of this warpgroup's 64 x 128 part.
    const bool even = (N % 2) == 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = tm + 64 * c + 16 * warp + lane / 4 + 8 * h;
      if (row >= m_end) continue;
      T* orow = out + (long)row * N;
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j) {
        const int col = tn + 8 * j + 2 * (lane % 4);
        if (col >= n_end) continue;
        const bool two = col + 1 < n_end;
        store2(orow + col, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1], two,
               two && even && col % 2 == 0);
      }
    }
  }
}

CUtensorMapSwizzle swizzle_mode(int sw) {
  return sw == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
         : sw == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                    : CU_TENSOR_MAP_SWIZZLE_NONE;
}

// Tensor map of a row-major (rows x cols) matrix, boxes of
// (box_rows x box_cols).
template <typename T>
bool encode(CUtensorMap* map, const void* p, int rows, int cols,
            int box_rows, int box_cols, int sw) {
  hopper::EncodeTiled fn = hopper::encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUtensorMapDataType type = sizeof(T) == 4
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return fn(map, type, 2, const_cast<void*>(p), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_mode(sw),
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, bool kTma>
int launch(const void* a, const void* b, void* out, int M, int N, int K,
           int block_m, int block_n, int stages, int smem,
           cudaStream_t stream) {
  using Tr = Traits<T>;
  CUtensorMap map_a = {}, map_b = {};
  if (kTma && !(encode<T>(&map_a, a, M, K, kTile, kT, Tr::kASw) &&
                encode<T>(&map_b, b, K, N, kT, Tr::kBBox, Tr::kBSw)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + block_n - 1) / block_n, (M + block_m - 1) / block_m);
  auto kernel = cbp_matmul_kernel<T, kTma>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, kThreads, smem, stream>>>(
      map_a, map_b, static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<T*>(out), M, N, K, block_m, block_n, stages);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// Dynamic shared memory (bytes) the kernel requests for these knobs and
// an input element of `dtype_bytes` bytes (block_m and block_n do not
// change it: they set the region, not the staging).
extern "C" int cbp_matmul_smem_bytes(int block_m, int block_n, int block_k,
                                     int dtype_bytes) {
  (void)block_m;
  (void)block_n;
  return split_bytes(dtype_bytes) + stages_for(block_k, dtype_bytes) *
                                        (stage_bytes(dtype_bytes) + kBarBytes);
}

// Launches on `stream`; returns cudaGetLastError() (0 on success).  a is
// (M, K), b (K, N), out (M, N), all C-contiguous device pointers of one
// dtype (0: float32, 1: bfloat16).  `tma` (0 or 1) picks the load stage:
// 1 needs 16-byte-aligned a and b and rows of A and B whose bytes are a
// multiple of 16.  `smem` must equal cbp_matmul_smem_bytes(...) for
// these knobs, else cudaErrorInvalidValue.
extern "C" int cbp_matmul_launch(const void* a, const void* b, void* out,
                                 int M, int N, int K, int block_m,
                                 int block_n, int block_k, int tma,
                                 int dtype, int smem, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return 0;
  if (block_m <= 0 || block_n <= 0 || block_k <= 0 ||
      (dtype != 0 && dtype != 1) || (tma != 0 && tma != 1))
    return (int)cudaErrorInvalidValue;
  const int bytes = dtype == 0 ? 4 : 2;
  if (smem != cbp_matmul_smem_bytes(block_m, block_n, block_k, bytes))
    return (int)cudaErrorInvalidValue;
  if (tma && !(aligned16(a) && aligned16(b) && (long)K * bytes % 16 == 0 &&
               (long)N * bytes % 16 == 0))
    return (int)cudaErrorInvalidValue;
  const int stages = stages_for(block_k, bytes);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return tma ? launch<float, true>(a, b, out, M, N, K, block_m, block_n,
                                     stages, smem, s)
               : launch<float, false>(a, b, out, M, N, K, block_m, block_n,
                                      stages, smem, s);
  return tma ? launch<__nv_bfloat16, true>(a, b, out, M, N, K, block_m,
                                           block_n, stages, smem, s)
             : launch<__nv_bfloat16, false>(a, b, out, M, N, K, block_m,
                                            block_n, stages, smem, s);
}

extern "C" const char* cbp_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
