// Mamba2 SSD chunk scan for Hopper as one tensor-core kernel: f32 math,
// output in the input dtype.
//
// Replaces the Pallas kernel `ssd_scan` (body `_ssd_kernel`) in
// src/repro/kernels/ssd_scan/kernel.py.  Per (batch, head) and per chunk of
// `chunk` steps, with dA = dt * A_h and cs its inclusive cumsum inside the
// chunk, it computes
//
//   y_i   = sum_{j <= i} (C_i . B_j) exp(cs_i - cs_j) x_j dt_j
//           + exp(cs_i) (C_i . state^T)
//   state = exp(cs_last) state + sum_j (x_j dt_j)^T B_j exp(cs_last - cs_j)
//
// with the (P, N) state carried across the chunks in order; B and C are
// shared by the heads of a batch row (the Pallas index map's g // h).
//
// What bounds it on an H100: at mamba2-1.3b (2 x 4096 steps, 64 heads of
// P = 64, N = 128, chunk 128) the chunked form is 2.16e10 FLOP with C.B^T
// counted once per batch row; this kernel recomputes C.B^T per head
// (3.0e10) and, in f32, runs every product three times on the bf16 tensor
// cores (0.09 ms at 989 TFLOP/s), against 0.28 GB of inputs and output in
// f32 (0.08 ms).  Only `wgmma` reaches those rates, so every product is a
// `wgmma`; one block owns one (batch, head) and walks its chunks in order.
//
//   * Tiles.  The kernel walks a chunk in tiles of 64 steps (wgmma's 64
//     rows): row tile i of the chunk, and for it the column tiles j = i,
//     i - 1, ..., 0 of the chunk's lower triangle (tiles wholly above the
//     diagonal are never visited).  A chunk that is not a multiple of 64
//     ends in a partial tile; a chunk smaller than 64 (8, 32) is one
//     partial tile.  A partial tile's rows past the chunk come in as
//     zeros (the tensor maps give the chunk's steps a dimension of their
//     own) and are masked: its steps cost a whole tile's products, and no
//     step of another chunk reaches the outputs.
//   * Products, all bf16 `wgmma` with f32 accumulators.  G = C_i B_j^T
//     (m64n64k16, C and B K-major as they lie); M = G * decay * dt_j in
//     registers; y_i += M x_j (M from registers in the accumulator's
//     layout, x read N-major through the transpose bit); y_i += exp(cs_i)
//     C_i state^T (the state stored K-major); state += (x_j w_j)^T B_j
//     (x w built in registers, B through the transpose bit).  No operand
//     is ever transposed in shared memory: bf16 `wgmma` reads either
//     major order, which TF32 cannot.
//   * Precision.  Operands computed in f32 (M, x w, the state) are split
//     into bf16 hi + lo and enter twice; in f32 the inputs C, B, x are
//     split the same way and each product is hi*hi + hi*lo + lo*hi
//     (relative error ~2^-16), in bf16 the inputs are exact.  Each (i, j)
//     product M x_j sums into its own accumulator, added to y in f32.
//   * Decay.  The feed warp stores each tile's inclusive cumsum ls
//     relative to the tile's start and each tile's total D; exponents are
//     built from those (ls_i - ls_j + D_j + ... + D_{i-1}, summed as the
//     column tiles walk down), only for j <= i, so no term is ever
//     factored as exp(cs_i) exp(-cs_j) and none overflows, and no small
//     exponent is taken as the difference of two large cumsums.
//   * Warps.  384 threads.  Warpgroup 0 computes y, one column tile
//     after the other (G, M, M x_j).  Warpgroup 1 carries the state (the
//     update runs beside warpgroup 0's intra-chunk products, so the chain
//     of chunks costs one handshake a chunk) and writes each chunk's
//     state as bf16 hi / lo for warpgroup 0.  Warp 9 feeds: it loads dt
//     (a chunk of up to 4 tiles once, all loads in flight), runs the
//     cumsum as a warp scan, and loads the tiles by TMA (3-D maps of B
//     and C as (N, chunk, chunks), a 4-D map of x as (P, H, chunk,
//     chunks), 128-byte boxes with a 128-byte swizzle; zeros past N, P
//     and the chunk), in bf16 straight into the stage, in f32 into a ring
//     of three raw boxes that warps 8, 10 and 11 split into the bf16 hi /
//     lo tiles.  Bases or rows TMA cannot take are copied by warp 9's
//     lanes into the same layouts (kTma = false).  setmaxnreg moves
//     warpgroup 2's registers to the other two.
//
// Shapes: P <= 128, N <= 128, with P and N padded to 64 or 128 and the
// padded P * N <= 8192 (the state held in warpgroup 1's registers); the
// padded columns are zeros and cost their products.  Dynamic shared
// memory (`ssd_scan_smem_bytes`, mirrored by `smem_bytes` in ops.py): two
// C stages, the ring of B / x stages (4 in bf16, 2 in f32), the state's
// two pieces, f32's raw box ring, the mbarriers, and a table of 16 bytes
// per tile of the chunk, double-buffered.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kT = 64;  // steps of a tile
constexpr int kThreads = 384;
constexpr int kMaxSmem = 232448;
constexpr int kMaxP = 128;
constexpr int kMaxN = 128;
constexpr int kMaxState = 8192;  // padded P * padded N
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ constexpr int up1024(int x) {
  return (x + 1023) / 1024 * 1024;
}

// Per input type: bf16 pieces of a raw input (1: exact; 2: hi + lo),
// columns of a TMA box (128 bytes), B / x stages, raw f32 box slots, and
// the registers of warpgroup 2 and of the state warpgroup (with
// warpgroup 0's 232: 3 x 168 = 504).
template <typename T> struct Cfg;
template <> struct Cfg<__nv_bfloat16> {
  static constexpr int kPieces = 1, kBox = 64, kStages = 4, kRaw = 0;
  static constexpr int kProdRegs = 64, kStateRegs = 208;
};
template <> struct Cfg<float> {
  static constexpr int kPieces = 2, kBox = 32, kStages = 2, kRaw = 3;
  static constexpr int kProdRegs = 88, kStateRegs = 184;
};

// Shared memory before the tile table: C stages (pieces, then the rows'
// ls), B / x stages (B pieces, x pieces, then (ls, dt) of the steps), the
// state's hi and lo, the raw box ring, the mbarriers.
__host__ __device__ constexpr int fixed_bytes(int pieces, int stages, int raw,
                                              int kp, int kn) {
  return 2 * up1024(pieces * kT * kn * 2 + kT * 4) +
         stages * up1024(pieces * kT * (kn + kp) * 2 + kT * 8) +
         2 * kp * kn * 2 + raw * kT * 128 + 256;
}

template <typename T, int kP, int kN> struct Layout {
  using C = Cfg<T>;
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int kPieces = C::kPieces, kS = C::kStages, kR = C::kRaw;
  static constexpr int kTileC = kT * kN * 2;  // one piece of a C or B tile
  static constexpr int kTileX = kT * kP * 2;  // one piece of an x tile
  static constexpr int kCsC = kPieces * kTileC;
  static constexpr int kCsBX = kPieces * (kTileC + kTileX);
  static constexpr int kCStage = up1024(kCsC + kT * 4);
  static constexpr int kBXStage = up1024(kCsBX + kT * 8);
  static constexpr int kBXRing = 2 * kCStage;
  static constexpr int kState = kBXRing + kS * kBXStage;
  static constexpr int kStatePiece = kP * kN * 2;
  static constexpr int kRawRing = kState + 2 * kStatePiece;
  static constexpr int kBar = kRawRing + kR * kT * 128;
  static constexpr int kInfo = kBar + 256;
  static constexpr int kBoxesC = kN / C::kBox, kBoxesX = kP / C::kBox;
  static_assert(kInfo == fixed_bytes(kPieces, kS, kR, kP, kN), "layout");
  static_assert(4 + 2 * kS + 2 * kR + 6 <= 32, "barriers");
  static_assert(kP * kN <= kMaxState, "state registers");
};

// Byte offset of element (r, c) of a bf16 tile of `rows` rows stored as
// 64-column chunks of 128-byte rows with a 128-byte swizzle.
__device__ __forceinline__ uint32_t piece_off(int r, int c, int rows) {
  return (c >> 6) * rows * 128 + hopper::swizzle<128>(r * 128 + (c & 63) * 2);
}

// The descriptor of the tile `off` bytes past the one `d` describes (the
// address field counts 16-byte units; shared memory is below 256 KB).
__device__ __forceinline__ uint64_t desc_at(uint64_t d, uint32_t off) {
  return d + (off >> 4);
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float expf_fast(float x) {
  return exp2_approx(x * kLog2e);
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (a, b) as a bf16 pair hi and the pair of what hi leaves, lo.
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(a - hf.x, b - hf.y));
}

__device__ __forceinline__ float bf16_at(const unsigned char* p) {
  return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(p));
}

// dt of steps 2 lane and 2 lane + 1 of the `len` steps of a tile starting
// at global row `row0`; 0 past len.
template <typename T>
__device__ __forceinline__ void tile_dt(const T* __restrict__ dt, long row0,
                                        int H, int hh, int len, int lane,
                                        float& dt0, float& dt1) {
  const int s0 = 2 * lane;
  dt0 = s0 < len ? to_f32(dt[(row0 + s0) * H + hh]) : 0.f;
  dt1 = s0 + 1 < len ? to_f32(dt[(row0 + s0 + 1) * H + hh]) : 0.f;
}

// Inclusive cumsum ls of dA = dt * a over a tile's steps, two a lane (a
// warp scan).  Returns the tile's total (the last ls) in every lane.
__device__ __forceinline__ float tile_scan(float dt0, float dt1, float a,
                                           int lane, float& ls0, float& ls1) {
  const float v0 = dt0 * a, v1 = dt1 * a;
  float inc = v0 + v1;
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    const float y = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += y;
  }
  float ex = __shfl_up_sync(0xffffffffu, inc, 1);
  if (lane == 0) ex = 0.f;
  ls0 = ex + v0;
  ls1 = ls0 + v1;
  return __shfl_sync(0xffffffffu, ls1, 31);
}

// Exclusive prefix sums of the tiles' totals d(t), t = 0 .. nt - 1, taken
// in the order `order(k)` gives, written by `put(t, sum)`; one warp.
template <typename Get, typename Put>
__device__ __forceinline__ void warp_exclusive(int nt, int lane, Get get,
                                               Put put) {
  float carry = 0.f;
  for (int base = 0; base < nt; base += 32) {
    const int k = base + lane;
    const float d = k < nt ? get(k) : 0.f;
    float inc = d;
#pragma unroll
    for (int off = 1; off < 32; off *= 2) {
      const float y = __shfl_up_sync(0xffffffffu, inc, off);
      if (lane >= off) inc += y;
    }
    float ex = __shfl_up_sync(0xffffffffu, inc, 1);
    if (lane == 0) ex = 0.f;
    if (k < nt) put(k, carry + ex);
    carry += __shfl_sync(0xffffffffu, inc, 31);
  }
}

// Copies a (64 rows x cols) tile of a row-major matrix with row stride
// `ld` into bf16 piece layout (bf16 input) or one f32 box (64 x 32, the
// TMA layout); zeros from row `rows` (the chunk's end) on and past
// `ncols`.  The feed warp's lanes.
__device__ __forceinline__ void copy_piece(unsigned char* dst,
                                           const __nv_bfloat16* src, long ld,
                                           long row0, long rows, int c0,
                                           int ncols, int lane) {
#pragma unroll 4
  for (int e = lane; e < kT * 64; e += 32) {
    const int r = e / 64, c = e % 64;
    const bool in = row0 + r < rows && c0 + c < ncols;
    *reinterpret_cast<__nv_bfloat16*>(dst + piece_off(r, c, kT)) =
        in ? src[(row0 + r) * ld + c0 + c] : __float2bfloat16(0.f);
  }
}
__device__ __forceinline__ void copy_box(unsigned char* dst, const float* src,
                                         long ld, long row0, long rows, int c0,
                                         int ncols, int lane) {
#pragma unroll 4
  for (int e = lane; e < kT * 32; e += 32) {
    const int r = e / 32, c = e % 32;
    const bool in = row0 + r < rows && c0 + c < ncols;
    *reinterpret_cast<float*>(dst + hopper::swizzle<128>(r * 128 + c * 4)) =
        in ? src[(row0 + r) * ld + c0 + c] : 0.f;
  }
}

template <typename T, int kP, int kN, bool kTma>
__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_kernel(const __grid_constant__ CUtensorMap map_x,
                const __grid_constant__ CUtensorMap map_b,
                const __grid_constant__ CUtensorMap map_c,
                const T* __restrict__ x, const T* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, T* __restrict__ out, int S, int H,
                int P, int N, int L) {
  using Lo = Layout<T, kP, kN>;
  using Cf = Cfg<T>;
  constexpr bool kF32 = Lo::kF32;
  constexpr int kS = Lo::kS, kR = Lo::kR;
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* cfull = reinterpret_cast<uint64_t*>(smem + Lo::kBar);
  uint64_t* cempty = cfull + 2;
  uint64_t* bfull = cempty + 2;
  uint64_t* bempty = bfull + kS;
  uint64_t* rfull = bempty + kS;
  uint64_t* rempty = rfull + kR;
  uint64_t* kfull = rempty + kR;
  uint64_t* kempty = kfull + 2;
  uint64_t* sfull = kempty + 2;
  uint64_t* sempty = sfull + 1;
  float4* info = reinterpret_cast<float4*>(smem + Lo::kInfo);
  unsigned char* sstate = smem + Lo::kState;

  const int tid = threadIdx.x;
  if (tid == 0) {
    // A stage is full once the feed warp has written its cumsum and its
    // tiles are in (TMA bytes or the copy; f32: the splitter's arrival
    // too); B / x stages are emptied by both computing warpgroups, C
    // stages by warpgroup 0.
    constexpr int kFull = kF32 ? 2 : 1;
    for (int s = 0; s < 2; ++s) {
      hopper::mbar_init(&cfull[s], kFull);
      hopper::mbar_init(&cempty[s], 4);
      hopper::mbar_init(&kfull[s], 1);
      hopper::mbar_init(&kempty[s], 8);
    }
    for (int s = 0; s < kS; ++s) {
      hopper::mbar_init(&bfull[s], kFull);
      hopper::mbar_init(&bempty[s], 8);
    }
    for (int s = 0; s < kR; ++s) {
      hopper::mbar_init(&rfull[s], 1);
      hopper::mbar_init(&rempty[s], 3);
    }
    hopper::mbar_init(sfull, 1);
    hopper::mbar_init(sempty, 4);
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int g = blockIdx.x;
  const int bi = g / H, hh = g % H;
  const float a = A[hh];
  const int nt = (L + kT - 1) / kT;
  const int nc = S / L;
  const long row_b = (long)bi * S;

  if (tid >= 256) {
    hopper::setmaxnreg_dec<Cf::kProdRegs>();
    const int warp = (tid - 256) / 32, lane = tid % 32;
    if (warp == 1) {
      // ---- feed warp: for each row tile i of a chunk, the stage of C_i,
      // then those of B_j / x_j for j = i down to 0.  Per chunk the tiles'
      // totals D and their exclusive prefix T and suffix R; per stage the
      // tile's cumsum ls (and dt), then its tiles: bf16 by TMA (or the
      // lanes' copy) straight into the stage, f32 boxes into the raw ring
      // ahead of the splitter.  A chunk of up to kCached tiles loads its dt
      // once, all loads in flight, and serves its stages from registers;
      // a longer one reloads per stage.
      constexpr int kCached = 4;
      int cit = 0, bit = 0, rit = 0;
      float cdt[kCached][2], cls[kCached][2];
      // dt and ls of tile t of chunk row c_row: cached, or loaded.
      auto tile = [&](long c_row, int t, float& dt0, float& dt1, float& ls0,
                      float& ls1) {
        if (nt <= kCached) {
#pragma unroll
          for (int k = 0; k < kCached; ++k)
            if (k == t) {
              dt0 = cdt[k][0], dt1 = cdt[k][1];
              ls0 = cls[k][0], ls1 = cls[k][1];
            }
        } else {
          tile_dt(dt, c_row + (long)t * kT, H, hh, min(kT, L - t * kT), lane,
                  dt0, dt1);
          tile_scan(dt0, dt1, a, lane, ls0, ls1);
        }
      };
      // f32: one raw box of tile t of chunk cg (first row c_row) into the
      // ring (TMA by lane 0, or the lanes' copy).
      auto raw_box = [&](const CUtensorMap* map, const T* src, long ld,
                         int ncols, int c0, long c_row, int cg, int t,
                         bool is_x) {
        if constexpr (kF32) {
          const int rs = rit % kR;
          unsigned char* dst = smem + Lo::kRawRing + rs * kT * 128;
          if constexpr (kTma) {
            if (lane == 0) {
              hopper::mbar_wait(&rempty[rs], ((rit / kR) & 1) ^ 1);
              hopper::mbar_arrive_expect_tx(&rfull[rs], kT * 128);
              if (is_x)
                hopper::tma_load_4d(dst, map, &rfull[rs], c0, hh, t * kT, cg);
              else
                hopper::tma_load_3d(dst, map, &rfull[rs], c0, t * kT, cg);
            }
          } else {
            hopper::mbar_wait(&rempty[rs], ((rit / kR) & 1) ^ 1);
            copy_box(dst, reinterpret_cast<const float*>(src), ld,
                     c_row + (long)t * kT, c_row + L, c0, ncols, lane);
            hopper::fence_proxy_async();
            __syncwarp();
            if (lane == 0) hopper::mbar_arrive(&rfull[rs]);
          }
          ++rit;
        }
      };
      const T* xh = x + (long)hh * P;
      for (int c = 0; c < nc; ++c) {
        const int slot = c & 1;
        const long c_row = row_b + (long)c * L;
        const int cg = bi * nc + c;  // the chunk's index in the tensor maps
        float4* inf = info + slot * nt;
        if (nt <= kCached) {
#pragma unroll
          for (int k = 0; k < kCached; ++k)
            if (k < nt)
              tile_dt(dt, c_row + (long)k * kT, H, hh, min(kT, L - k * kT),
                      lane, cdt[k][0], cdt[k][1]);
        }
        hopper::mbar_wait(&kempty[slot], ((c >> 1) & 1) ^ 1);
        if (nt <= kCached) {
#pragma unroll
          for (int k = 0; k < kCached; ++k)
            if (k < nt) {
              const float d = tile_scan(cdt[k][0], cdt[k][1], a, lane,
                                        cls[k][0], cls[k][1]);
              if (lane == 0) inf[k].z = d;
            }
        } else {
          for (int t = 0; t < nt; ++t) {
            float dt0, dt1, ls0, ls1;
            tile_dt(dt, c_row + (long)t * kT, H, hh, min(kT, L - t * kT),
                    lane, dt0, dt1);
            const float d = tile_scan(dt0, dt1, a, lane, ls0, ls1);
            if (lane == 0) inf[t].z = d;
          }
        }
        __syncwarp();
        warp_exclusive(
            nt, lane, [&](int k) { return inf[k].z; },
            [&](int k, float v) { inf[k].x = v; });
        warp_exclusive(
            nt, lane, [&](int k) { return inf[nt - 1 - k].z; },
            [&](int k, float v) { inf[nt - 1 - k].y = v; });
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&kfull[slot]);
        for (int i = 0; i < nt; ++i, ++cit) {
          const long ri = c_row + (long)i * kT;
          if constexpr (kF32) {
            for (int k = 0; k < Lo::kBoxesC; ++k)
              raw_box(&map_c, Cm, N, N, k * 32, c_row, cg, i, false);
          }
          const int s = cit % 2;
          unsigned char* st = smem + s * Lo::kCStage;
          float* cs = reinterpret_cast<float*>(st + Lo::kCsC);
          float dt0, dt1, ls0, ls1;
          tile(c_row, i, dt0, dt1, ls0, ls1);
          hopper::mbar_wait(&cempty[s], ((cit / 2) & 1) ^ 1);
          cs[2 * lane] = ls0;
          cs[2 * lane + 1] = ls1;
          __syncwarp();
          if constexpr (kF32) {
            if (lane == 0) hopper::mbar_arrive(&cfull[s]);
          } else if constexpr (kTma) {
            if (lane == 0) {
              hopper::mbar_arrive_expect_tx(&cfull[s], Lo::kTileC);
              for (int k = 0; k < Lo::kBoxesC; ++k)
                hopper::tma_load_3d(st + k * kT * 128, &map_c, &cfull[s],
                                    k * 64, i * kT, cg);
            }
          } else {
            for (int k = 0; k < Lo::kBoxesC; ++k)
              copy_piece(st + k * kT * 128, Cm, N, ri, c_row + L, k * 64, N,
                         lane);
            hopper::fence_proxy_async();
            __syncwarp();
            if (lane == 0) hopper::mbar_arrive(&cfull[s]);
          }
          for (int j = i; j >= 0; --j, ++bit) {
            const long rj = c_row + (long)j * kT;
            if constexpr (kF32) {
              for (int k = 0; k < Lo::kBoxesC; ++k)
                raw_box(&map_b, Bm, N, N, k * 32, c_row, cg, j, false);
              for (int k = 0; k < Lo::kBoxesX; ++k)
                raw_box(&map_x, xh, (long)H * P, P, k * 32, c_row, cg, j,
                        true);
            }
            const int s = bit % kS;
            unsigned char* st = smem + Lo::kBXRing + s * Lo::kBXStage;
            float2* cs = reinterpret_cast<float2*>(st + Lo::kCsBX);
            float dt0, dt1, ls0, ls1;
            tile(c_row, j, dt0, dt1, ls0, ls1);
            hopper::mbar_wait(&bempty[s], ((bit / kS) & 1) ^ 1);
            cs[2 * lane] = make_float2(ls0, dt0);
            cs[2 * lane + 1] = make_float2(ls1, dt1);
            __syncwarp();
            if constexpr (kF32) {
              if (lane == 0) hopper::mbar_arrive(&bfull[s]);
            } else if constexpr (kTma) {
              if (lane == 0) {
                hopper::mbar_arrive_expect_tx(&bfull[s],
                                              Lo::kTileC + Lo::kTileX);
                for (int k = 0; k < Lo::kBoxesC; ++k)
                  hopper::tma_load_3d(st + k * kT * 128, &map_b, &bfull[s],
                                      k * 64, j * kT, cg);
                for (int k = 0; k < Lo::kBoxesX; ++k)
                  hopper::tma_load_4d(st + Lo::kTileC + k * kT * 128, &map_x,
                                      &bfull[s], k * 64, hh, j * kT, cg);
              }
            } else {
              for (int k = 0; k < Lo::kBoxesC; ++k)
                copy_piece(st + k * kT * 128, Bm, N, rj, c_row + L, k * 64, N,
                           lane);
              for (int k = 0; k < Lo::kBoxesX; ++k)
                copy_piece(st + Lo::kTileC + k * kT * 128, xh, (long)H * P,
                           rj, c_row + L, k * 64, P, lane);
              hopper::fence_proxy_async();
              __syncwarp();
              if (lane == 0) hopper::mbar_arrive(&bfull[s]);
            }
          }
        }
      }
      return;
    }
    if constexpr (kF32) {
      // ---- splitter (warps 8, 10, 11): each raw f32 box into the bf16 hi
      // and lo pieces of its stage ----
      const int ct = 32 * (warp == 0 ? 0 : warp - 1) + lane;
      int cit = 0, bit = 0, rit = 0;
      // float4 e = ct + 96 u of a raw box is row r = e / 8, columns 4 lc
      // .. 4 lc + 3 with lc = (e % 8) ^ (r % 8) (the 128-byte swizzle);
      // in a piece tile those 4 bf16 of a box at column c0 (a multiple of
      // 32) lie at (c0 / 64) 8192 + (o[u] ^ (c0 % 64 ? 64 : 0)).
      constexpr int kU = (kT * 8 + 95) / 96;
      uint32_t o[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int e = ct + 96 * u, r = e >> 3, lc = (e & 7) ^ (r & 7);
        o[u] = piece_off(r, 4 * lc, kT);
      }
      // Splits the stage's boxes: the first nb1 into tile 1 (C or B, kN
      // columns), the rest into tile 2 (x, kP columns).
      auto split_stage = [&](unsigned char* st, int nb1, int nb2,
                             int tile1) {
        for (int k = 0; k < nb1 + nb2; ++k, ++rit) {
          const int rs = rit % kR;
          const float4* src = reinterpret_cast<const float4*>(
              smem + Lo::kRawRing + rs * kT * 128);
          hopper::mbar_wait(&rfull[rs], (rit / kR) & 1);
          float4 v[kU];
#pragma unroll
          for (int u = 0; u < kU; ++u)
            if (ct + 96 * u < kT * 8) v[u] = src[ct + 96 * u];
          hopper::fence_proxy_async();
          __syncwarp();
          if (lane == 0) hopper::mbar_arrive(&rempty[rs]);
          const bool first = k < nb1;
          unsigned char* dst = first ? st : st + 2 * tile1;
          const int tile = first ? tile1 : Lo::kTileX;
          const int c0 = (first ? k : k - nb1) * 32;
          unsigned char* cdst = dst + (c0 >> 6) * kT * 128;
          const uint32_t flip = (c0 & 32) ? 64 : 0;
#pragma unroll
          for (int u = 0; u < kU; ++u) {
            if (ct + 96 * u >= kT * 8) continue;
            const uint32_t off = o[u] ^ flip;
            uint2 hi, lo;
            split2(v[u].x, v[u].y, hi.x, lo.x);
            split2(v[u].z, v[u].w, hi.y, lo.y);
            *reinterpret_cast<uint2*>(cdst + off) = hi;
            *reinterpret_cast<uint2*>(cdst + tile + off) = lo;
          }
        }
        hopper::fence_proxy_async();
        hopper::named_bar_sync(1, 96);
      };
      for (int c = 0; c < nc; ++c) {
        for (int i = 0; i < nt; ++i) {
          {
            const int s = cit % 2;
            hopper::mbar_wait(&cempty[s], ((cit / 2) & 1) ^ 1);
            split_stage(smem + s * Lo::kCStage, Lo::kBoxesC, 0, Lo::kTileC);
            if (ct == 0) hopper::mbar_arrive(&cfull[s]);
            ++cit;
          }
          for (int j = i; j >= 0; --j, ++bit) {
            const int s = bit % kS;
            hopper::mbar_wait(&bempty[s], ((bit / kS) & 1) ^ 1);
            split_stage(smem + Lo::kBXRing + s * Lo::kBXStage, Lo::kBoxesC,
                        Lo::kBoxesX, Lo::kTileC);
            if (ct == 0) hopper::mbar_arrive(&bfull[s]);
          }
        }
      }
    }
    return;
  }

  const int wg = tid / 128, wt = tid % 128;
  const int warp = wt / 32, lane = wt % 32;
  const int rq = 16 * warp + lane / 4, tq = lane % 4;

  if (wg == 1) {
    // ---- state warpgroup: acc is the (kP x kN) state, m-block mb holds
    // rows 64 mb + rq (+ 8); per chunk acc = exp(cs_last) acc, then
    // acc += (x_j w_j)^T B_j for every diagonal stage j, w_j = dt_j
    // exp(cs_last - cs_j); then acc goes out as bf16 hi / lo ----
    hopper::setmaxnreg_inc<Cf::kStateRegs>();
    constexpr int kMB = kP / 64;
    float acc[kMB][kN / 2];
#pragma unroll
    for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
      for (int e = 0; e < kN / 2; ++e) acc[mb][e] = 0.f;
    for (int e = wt; e < 2 * Lo::kStatePiece / 16; e += 128)
      reinterpret_cast<uint4*>(sstate)[e] = make_uint4(0, 0, 0, 0);
    hopper::fence_proxy_async();
    hopper::named_bar_sync(2, 128);
    if (wt == 0) hopper::mbar_arrive(sfull);
    int bit = 0;
    for (int c = 0; c < nc; ++c) {
      const int slot = c & 1;
      const float4* inf = info + slot * nt;
      hopper::mbar_wait(&kfull[slot], (c >> 1) & 1);
      const float decay = expf_fast(inf[0].z + inf[0].y);
#pragma unroll
      for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
        for (int e = 0; e < kN / 2; ++e) acc[mb][e] *= decay;
      for (int i = 0; i < nt; ++i) {
        for (int j = i; j >= 0; --j, ++bit) {
          const int s = bit % kS;
          const unsigned char* st = smem + Lo::kBXRing + s * Lo::kBXStage;
          hopper::mbar_wait(&bfull[s], (bit / kS) & 1);
          if (j == i) {
            const float2* cs =
                reinterpret_cast<const float2*>(st + Lo::kCsBX);
            const unsigned char* xs = st + Lo::kPieces * Lo::kTileC;
            const int len = min(kT, L - j * kT);
            const float rj = inf[j].y, dj = inf[j].z;
            // w of step 16 kk + 8 hk + 2 tq + e
            float w[4][2][2];
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
#pragma unroll
              for (int hk = 0; hk < 2; ++hk)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const int st_ = 16 * kk + 8 * hk + 2 * tq + e;
                  const float2 v = cs[st_];
                  w[kk][hk][e] =
                      st_ < len ? v.y * expf_fast(rj + (dj - v.x)) : 0.f;
                }
            // Step 16 kk + 8 hk + 2 tq + e, column p = 64 mb + rq + 8 r8 of
            // the x piece: the swizzle XORs the 16-byte chunk with the
            // step mod 8 = 2 tq + e, the same for every kk and hk.
            uint32_t xo[2][2];
#pragma unroll
            for (int e = 0; e < 2; ++e)
#pragma unroll
              for (int r8 = 0; r8 < 2; ++r8)
                xo[e][r8] = (2 * tq + e) * 128 +
                            (((rq + 8 * r8) * 2) ^ ((2 * tq + e) << 4));
            const uint64_t db = hopper::smem_desc<128>(st, kT * 128, 1024);
#pragma unroll
            for (int mb = 0; mb < kMB; ++mb) {
              uint32_t ah[4][4], al[4][4];
#pragma unroll
              for (int kk = 0; kk < 4; ++kk)
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                  const int hk = q >> 1;
                  float xv[2];
#pragma unroll
                  for (int e = 0; e < 2; ++e) {
                    const uint32_t off = xo[e][q & 1] + mb * kT * 128 +
                                         (16 * kk + 8 * hk) * 128;
                    xv[e] = bf16_at(xs + off);
                    if constexpr (kF32) xv[e] += bf16_at(xs + Lo::kTileX + off);
                    xv[e] *= w[kk][hk][e];
                  }
                  split2(xv[0], xv[1], ah[kk][q], al[kk][q]);
                }
              hopper::fence_operands(acc[mb]);
              hopper::wgmma_fence();
#pragma unroll
              for (int kk = 0; kk < 4; ++kk) {
                const uint64_t b0 = desc_at(db, kk * 16 * 128);
                if constexpr (kF32) {
                  const uint64_t b1 =
                      desc_at(db, Lo::kTileC + kk * 16 * 128);
                  hopper::wgmma_bf16_rs<kN>(acc[mb], al[kk], b0);
                  hopper::wgmma_bf16_rs<kN>(acc[mb], ah[kk], b1);
                } else {
                  hopper::wgmma_bf16_rs<kN>(acc[mb], al[kk], b0);
                }
                hopper::wgmma_bf16_rs<kN>(acc[mb], ah[kk], b0);
              }
              hopper::wgmma_commit();
              hopper::wgmma_wait<0>();
              hopper::fence_operands(acc[mb]);
            }
            // The generic reads of x are done before TMA refills it.
            hopper::fence_proxy_async();
          }
          __syncwarp();
          if (lane == 0) hopper::mbar_arrive(&bempty[s]);
        }
      }
      // The chunk's state out as bf16 hi / lo, once warpgroup 0 is done
      // with the last one.
      hopper::mbar_wait(sempty, c & 1);
#pragma unroll
      for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
        for (int e2 = 0; e2 < kN / 4; ++e2) {
          const int p = 64 * mb + rq + 8 * (e2 & 1);
          const int n = 8 * (e2 >> 1) + 2 * tq;
          uint32_t hi, lo;
          split2(acc[mb][2 * e2], acc[mb][2 * e2 + 1], hi, lo);
          const uint32_t off = piece_off(p, n, kP);
          *reinterpret_cast<uint32_t*>(sstate + off) = hi;
          *reinterpret_cast<uint32_t*>(sstate + Lo::kStatePiece + off) = lo;
        }
      hopper::fence_proxy_async();
      hopper::named_bar_sync(2, 128);
      if (wt == 0) hopper::mbar_arrive(sfull);
      if (lane == 0) hopper::mbar_arrive(&kempty[slot]);
    }
    return;
  }

  // ---- warpgroup 0: y of each row tile; thread holds rows rq and rq + 8
  // of the tile, columns 8 q + 2 tq (+ 1) ----
  hopper::setmaxnreg_inc<232>();
  const bool pairs = P % 2 == 0;
  int cit = 0, bit = 0;
  for (int c = 0; c < nc; ++c) {
    const int slot = c & 1;
    const float4* inf = info + slot * nt;
    hopper::mbar_wait(&kfull[slot], (c >> 1) & 1);
    for (int i = 0; i < nt; ++i, ++cit) {
      const int ilen = min(kT, L - i * kT);
      const int cs_ = cit % 2;
      const unsigned char* cst = smem + cs_ * Lo::kCStage;
      hopper::mbar_wait(&cfull[cs_], (cit / 2) & 1);
      const float* lsc = reinterpret_cast<const float*>(cst + Lo::kCsC);
      const float lsr[2] = {lsc[rq], lsc[rq + 8]};
      const uint64_t dc = hopper::smem_desc<128>(cst, 16, 1024);
      auto desc_c = [&](int piece, int kk) {
        return desc_at(dc, piece * Lo::kTileC + (kk / 4) * kT * 128 +
                               32 * (kk % 4));
      };
      float y[kP / 2], part[kP / 2];
#pragma unroll
      for (int e = 0; e < kP / 2; ++e) y[e] = 0.f;
      float dT = 0.f;
      for (int j = i; j >= 0; --j, ++bit) {
        const int s = bit % kS;
        const unsigned char* st = smem + Lo::kBXRing + s * Lo::kBXStage;
        const unsigned char* xs = st + Lo::kPieces * Lo::kTileC;
        hopper::mbar_wait(&bfull[s], (bit / kS) & 1);
        // G = C_i B_j^T.
        float gm[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) gm[e] = 0.f;
        hopper::fence_operands(gm);
        hopper::wgmma_fence();
        const uint64_t dbk = hopper::smem_desc<128>(st, 16, 1024);
#pragma unroll
        for (int kk = 0; kk < kN / 16; ++kk) {
          const int ob = (kk / 4) * kT * 128 + 32 * (kk % 4);
          const uint64_t b0 = desc_at(dbk, ob);
          if constexpr (kF32) {
            const uint64_t b1 = desc_at(dbk, Lo::kTileC + ob);
            hopper::wgmma_bf16_kmajor<64>(gm, desc_c(1, kk), b0);
            hopper::wgmma_bf16_kmajor<64>(gm, desc_c(0, kk), b1);
          }
          hopper::wgmma_bf16_kmajor<64>(gm, desc_c(0, kk), b0);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_operands(gm);
        // M = G exp(cs_i - cs_j) dt_j below the diagonal, split into bf16
        // hi / lo pairs: pair 2 q + h is row rq + 8 h, columns 8 q + 2 tq
        // (+ 1), so k16 step kk takes pairs 4 kk .. 4 kk + 3.
        const float2* cs = reinterpret_cast<const float2*>(st + Lo::kCsBX);
        const int jlen = min(kT, L - j * kT);
        uint32_t ph[16], pl[16];
#pragma unroll
        for (int e2 = 0; e2 < 16; ++e2) {
          const int h = e2 & 1, row = rq + 8 * h;
          float m[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * (e2 >> 1) + 2 * tq + e;
            const float2 v = cs[col];
            const bool live =
                row < ilen && col < jlen && (j < i || col <= row);
            m[e] = live ? gm[2 * e2 + e] * expf_fast(lsr[h] - v.x + dT) * v.y
                        : 0.f;
          }
          split2(m[0], m[1], ph[e2], pl[e2]);
        }
        // part = M x_j.
#pragma unroll
        for (int e = 0; e < kP / 2; ++e) part[e] = 0.f;
        hopper::fence_operands(part);
        hopper::wgmma_fence();
        const uint64_t dx = hopper::smem_desc<128>(xs, kT * 128, 1024);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint32_t ah[4] = {ph[4 * kk], ph[4 * kk + 1], ph[4 * kk + 2],
                                  ph[4 * kk + 3]};
          const uint32_t al[4] = {pl[4 * kk], pl[4 * kk + 1], pl[4 * kk + 2],
                                  pl[4 * kk + 3]};
          const uint64_t x0 = desc_at(dx, kk * 16 * 128);
          if constexpr (kF32) {
            const uint64_t x1 = desc_at(dx, Lo::kTileX + kk * 16 * 128);
            hopper::wgmma_bf16_rs<kP>(part, al, x0);
            hopper::wgmma_bf16_rs<kP>(part, ah, x1);
          } else {
            hopper::wgmma_bf16_rs<kP>(part, al, x0);
          }
          hopper::wgmma_bf16_rs<kP>(part, ah, x0);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_operands(part);
        if (lane == 0) hopper::mbar_arrive(&bempty[s]);
#pragma unroll
        for (int e = 0; e < kP / 2; ++e) y[e] += part[e];
        if (j > 0) dT += inf[j - 1].z;
      }
      // part = C_i state^T, with the state of this chunk's start.
      hopper::mbar_wait(sfull, c & 1);
#pragma unroll
      for (int e = 0; e < kP / 2; ++e) part[e] = 0.f;
      hopper::fence_operands(part);
      hopper::wgmma_fence();
      const uint64_t ds = hopper::smem_desc<128>(sstate, 16, 1024);
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk) {
        const int ob = (kk / 4) * kP * 128 + 32 * (kk % 4);
        const uint64_t s0 = desc_at(ds, ob);
        const uint64_t s1 = desc_at(ds, Lo::kStatePiece + ob);
        if constexpr (kF32) {
          hopper::wgmma_bf16_kmajor<kP>(part, desc_c(1, kk), s0);
        }
        hopper::wgmma_bf16_kmajor<kP>(part, desc_c(0, kk), s1);
        hopper::wgmma_bf16_kmajor<kP>(part, desc_c(0, kk), s0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operands(part);
      if (lane == 0) {
        hopper::mbar_arrive(&cempty[cs_]);
        if (i == nt - 1) hopper::mbar_arrive(sempty);
      }
      // y += exp(cs_i) part; store the rows of the chunk.
      const float sc[2] = {expf_fast(inf[i].x + lsr[0]),
                           expf_fast(inf[i].x + lsr[1])};
      const long r0 = row_b + (long)c * L + (long)i * kT;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = rq + 8 * h;
        if (row >= ilen) continue;
        T* orow = out + ((r0 + row) * H + hh) * P;
#pragma unroll
        for (int q = 0; q < kP / 8; ++q) {
          const int col = 8 * q + 2 * tq;
          if (col >= P) continue;
          const float v0 = y[4 * q + 2 * h] + part[4 * q + 2 * h] * sc[h];
          const float v1 =
              y[4 * q + 2 * h + 1] + part[4 * q + 2 * h + 1] * sc[h];
          if (pairs) {
            if constexpr (kF32) {
              *reinterpret_cast<float2*>(orow + col) = make_float2(v0, v1);
            } else {
              *reinterpret_cast<__nv_bfloat162*>(orow + col) =
                  __floats2bfloat162_rn(v0, v1);
            }
          } else {
            store_as(orow + col, v0);
            if (col + 1 < P) store_as(orow + col + 1, v1);
          }
        }
      }
    }
    if (lane == 0) hopper::mbar_arrive(&kempty[slot]);
  }
}

// Tensor map of B or C as (N = cols, L, chunks), or with `heads` > 0 of x
// as (P = cols, heads, L, chunks): a chunk's steps are a dimension of
// their own, so a box reaching past the chunk's last step reads zeros, as
// do columns past `cols`; boxes of 128 bytes by 64 steps with a 128-byte
// swizzle.
template <typename T>
bool encode(CUtensorMap* map, const void* p, long chunks, int L, int cols,
            int heads) {
  hopper::EncodeTiled fn = hopper::encode_tiled();
  if (fn == nullptr) return false;
  const CUtensorMapDataType type = sizeof(T) == 4
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const cuuint64_t e = sizeof(T);
  const cuuint32_t box_cols = 128 / (cuuint32_t)sizeof(T);
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  if (heads > 0) {
    const cuuint64_t dims[4] = {(cuuint64_t)cols, (cuuint64_t)heads,
                                (cuuint64_t)L, (cuuint64_t)chunks};
    const cuuint64_t strides[3] = {cols * e, (cuuint64_t)heads * cols * e,
                                   (cuuint64_t)L * heads * cols * e};
    const cuuint32_t box[4] = {box_cols, 1, (cuuint32_t)kT, 1};
    return fn(map, type, 4, const_cast<void*>(p), dims, strides, box, elem,
              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
              CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
  }
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)L,
                              (cuuint64_t)chunks};
  const cuuint64_t strides[2] = {cols * e, (cuuint64_t)L * cols * e};
  const cuuint32_t box[3] = {box_cols, (cuuint32_t)kT, 1};
  return fn(map, type, 3, const_cast<void*>(p), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int kP, int kN, bool kTma>
int launch(const void* x, const void* dt, const float* A, const void* Bm,
           const void* Cm, void* out, int batch, int S, int H, int P, int N,
           int L, cudaStream_t stream) {
  using Lo = Layout<T, kP, kN>;
  const int smem = Lo::kInfo + 32 * ((L + kT - 1) / kT);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const long chunks = (long)batch * (S / L);
  CUtensorMap mx = {}, mb = {}, mc = {};
  if (kTma && !(encode<T>(&mx, x, chunks, L, P, H) &&
                encode<T>(&mb, Bm, chunks, L, N, 0) &&
                encode<T>(&mc, Cm, chunks, L, N, 0)))
    return (int)cudaErrorInvalidValue;
  auto kernel = ssd_scan_kernel<T, kP, kN, kTma>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<batch * H, kThreads, smem, stream>>>(
      mx, mb, mc, static_cast<const T*>(x), static_cast<const T*>(dt), A,
      static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      static_cast<T*>(out), S, H, P, N, L);
  return (int)cudaGetLastError();
}

template <typename T, bool kTma>
int launch_shape(const void* x, const void* dt, const float* A,
                 const void* Bm, const void* Cm, void* out, int batch, int S,
                 int H, int P, int N, int L, cudaStream_t s) {
  if (P <= 64 && N <= 64)
    return launch<T, 64, 64, kTma>(x, dt, A, Bm, Cm, out, batch, S, H, P, N,
                                   L, s);
  if (P <= 64)
    return launch<T, 64, 128, kTma>(x, dt, A, Bm, Cm, out, batch, S, H, P, N,
                                    L, s);
  return launch<T, 128, 64, kTma>(x, dt, A, Bm, Cm, out, batch, S, H, P, N, L,
                                  s);
}

int pad64(int n) { return n <= 64 ? 64 : 128; }

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// Dynamic shared memory (bytes) of a launch with these sizes and
// `dtype_bytes`-byte elements (4: float32, 2: bfloat16).
extern "C" int ssd_scan_smem_bytes(int P, int N, int chunk, int dtype_bytes) {
  const int kp = P <= 64 ? 64 : 64 * ((P + 63) / 64);
  const int kn = N <= 64 ? 64 : 64 * ((N + 63) / 64);
  const int fixed =
      dtype_bytes == 4
          ? fixed_bytes(Cfg<float>::kPieces, Cfg<float>::kStages,
                        Cfg<float>::kRaw, kp, kn)
          : fixed_bytes(Cfg<__nv_bfloat16>::kPieces,
                        Cfg<__nv_bfloat16>::kStages, Cfg<__nv_bfloat16>::kRaw,
                        kp, kn);
  return fixed + 32 * ((chunk + kT - 1) / kT);
}

// Launches on `stream`; returns cudaGetLastError() (0 on success).  x is
// (batch, S, H, P), dt (batch, S, H), Bm and Cm (batch, S, N), out like x,
// all C-contiguous device pointers of one dtype (0: float32, 1: bfloat16);
// A is (H,) float32.  Requires S % chunk == 0, P <= 128, N <= 128 and P, N
// padded to 64 or 128 with a product <= 8192 (checked by the Python
// wrapper; refused here with cudaErrorInvalidValue).  Tiles load by TMA
// when x, Bm and Cm are 16-byte aligned and a row of P or N elements is a
// multiple of 16 bytes, else by the producer warp's copy.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const float* A,
                               const void* Bm, const void* Cm, void* out,
                               int batch, int S, int H, int P, int N,
                               int chunk, int dtype, void* stream) {
  if (batch <= 0 || H <= 0 || S <= 0) return 0;
  if (chunk <= 0 || S % chunk != 0 || P < 1 || P > kMaxP || N < 1 ||
      N > kMaxN || pad64(P) * pad64(N) > kMaxState ||
      (dtype != 0 && dtype != 1) || (long)batch * S > 0x7fffffffL)
    return (int)cudaErrorInvalidValue;
  const int bytes = dtype == 0 ? 4 : 2;
  const bool tma = aligned16(x) && aligned16(Bm) && aligned16(Cm) &&
                   P * bytes % 16 == 0 && N * bytes % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return tma ? launch_shape<float, true>(x, dt, A, Bm, Cm, out, batch, S, H,
                                           P, N, chunk, s)
               : launch_shape<float, false>(x, dt, A, Bm, Cm, out, batch, S,
                                            H, P, N, chunk, s);
  return tma ? launch_shape<__nv_bfloat16, true>(x, dt, A, Bm, Cm, out, batch,
                                                 S, H, P, N, chunk, s)
             : launch_shape<__nv_bfloat16, false>(x, dt, A, Bm, Cm, out,
                                                  batch, S, H, P, N, chunk, s);
}

extern "C" const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
