// Flash-attention forward for Hopper, causal or not, f32 softmax
// statistics, output in the input dtype.
//
// Replaces the Pallas kernel `flash_attention_fwd` (body
// `_flash_fwd_kernel`) in src/repro/kernels/flash_attention/kernel.py.
// There the grid (B*H, Sq/block_q, Sk/block_kv) runs the kv axis in order
// on one core and carries the online-softmax (m, l, acc) in VMEM scratch;
// causal kv blocks strictly above the diagonal are skipped; masked scores
// are NEG_INF = -1e30, the mask is kpos <= qpos from index 0 (top-left
// aligned, also when Sq != Sk), the scale Dh^-0.5, and the output
// acc / max(l, 1e-30).
//
// What bounds it on an H100: operations.  At qwen3-8b prefill (1 x 32 x
// 4096 x 128, causal) the two products are 1.37e11 FLOP, 0.139 ms at the
// bf16 tensor-core rate, against 0.13 GB of q/k/v/out (0.04 ms).  Only
// `wgmma` reaches that rate, so this is one tensor-core kernel, templated
// on the input type, the padded head width kD and the load stage.
//
//   * Warps.  A block of 384 threads: warpgroups 0 and 1 compute, warp 8
//     loads.  The producer warp loads a tile's Q once and keeps a ring of
//     K/V stages full behind `full` / `empty` mbarriers (Q has its own
//     pair), through 3-D tensor maps (Dh, S, B*H): no box crosses into
//     the next head, and rows past S or columns past Dh come in as zeros.
//     Every operand tile is stored as 128-byte row chunks (64 bf16 or 32
//     f32 of Dh) with a 128-byte swizzle.  Warpgroup 2 gives its
//     registers to the other two (setmaxnreg: 40 + 2 x 232 = 3 x 168).
//   * bf16: each warpgroup owns 64 rows of a 128-row tile; stages of 128
//     keys.  S = Q K^T by `wgmma` m64n128k16 from shared memory (K as it
//     lies is K-major).  The online softmax runs on the accumulator
//     fragment (row max and sum by quad shuffles, the mask applied in
//     registers, only on stages that need it).  P is split into bf16
//     P_hi + P_lo, because P rounded once to bf16 leaves outputs beyond
//     the bf16 limit; O += P_hi V + P_lo V by `wgmma` m64nDk16 with P from
//     registers and V read through the transpose bit, so V is never
//     transposed.  Each warpgroup runs S, softmax, P V in turn; warpgroup
//     1 starts half a stage after warpgroup 0, so that each one's softmax
//     runs beside the other's products (orders that queue a stage's S
//     behind the last P V, with or without turns, measured slower).
//   * f32 on the tensor cores at f32 accuracy: 3xTF32 (hi = tf32(x),
//     lo = tf32(x - hi); hi*hi + hi*lo + lo*hi), since one TF32 pass
//     leaves outputs beyond the 2e-5 limit.  Q hi / lo, the ring and the
//     split K and V^T do not fit two computing warpgroups at Dh = 128,
//     so warpgroup 0 owns a 64-row tile and warpgroup 1 splits for it:
//     Q once a tile (hi in place, lo beside it), and each 32-key ring
//     stage, taken into registers so that the ring refills at once, into
//     one of two split stages: K hi / lo elementwise and V transposed
//     into K-major V^T hi / lo (TF32 has no transpose bit).  S by
//     m64n32k8 from shared memory; P hi / lo stay in registers, and V^T
//     holds the keys of each group of 8 permuted (2m -> m, 2m+1 -> m+4)
//     so that the accumulator's column pairs are the A fragment's k and
//     k + 4.  Each stage's P V goes into its own accumulator, added to
//     the rescaled O in f32: `wgmma`'s own f32 sum over thousands of keys
//     drifts (tools/matmul_probe.py measured it for the matmul).
//   * Load stage.  TMA needs 16-byte-aligned bases and rows (Dh times the
//     element size).  Otherwise the producer warp's 32 lanes copy the
//     same tiles into the same layouts with ordinary loads, zero-filling,
//     then fence them to the async proxy and arrive (kTma = false).
//
// Head widths: Dh <= 64 runs at kD = 64, 64 < Dh <= 128 at kD = 128; the
// columns past Dh are zeros in shared memory and cost their products.
//
// The knobs keep their meaning.  block_q is the extent of query rows a
// block owns, walked in tiles of 128 (bf16) or 64 (f32) rows; rows past
// it are computed and not stored.  block_kv is the step of the Pallas
// kernel's causal block skip; the kernel walks each tile's keys up to its
// last stored row (or Sk), which that skip never cuts, in stages of 128
// or 32 keys.  The last stage ends exactly at that key: it starts earlier
// and masks the keys the stage before it had, so no key past the limit
// (nor another head's key) is ever read.  A warpgroup passes over the
// stages that lie wholly above its own rows' diagonal.  Blocks launch in
// order of falling work (the last query blocks of every head first).
//
// Dynamic shared memory (`flash_attention_smem_bytes`, mirrored by
// `attention_smem_bytes` in ops.py): bf16 Q (128 x kD) + 3 stages of K
// and V (128 x kD each); f32 Q hi (64 x kD) + Q lo + 1 stage of K and V
// (32 x kD each) + 2 split stages (K hi, K lo, V^T hi, V^T lo); then the
// mbarriers: 229,448 bytes at kD = 128 in both types.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kMaxDh = 128;
constexpr int kMaxSmem = 232448;
// Warpgroups 0 and 1 compute; warp 8 of warpgroup 2 loads, and that
// warpgroup gives its registers to the other two (40 + 2 x 232 = 3 x 168).
constexpr int kThreads = 384;
constexpr int kProducer = 256;

// Per input type: consumer warpgroups (64 query rows each), keys of a
// stage, stages of the TMA ring and, f32 only, of the split ring that
// warpgroup 1 (the splitter) fills for warpgroup 0.
template <typename T> struct Cfg;
template <> struct Cfg<__nv_bfloat16> {
  static constexpr int kWG = 2, kN = 128, kStages = 3, kSplits = 0;
};
template <> struct Cfg<float> {
  static constexpr int kWG = 1, kN = 32, kStages = 1, kSplits = 2;
};

// Shared-memory layout (byte offsets) for type T and head width kD.
template <typename T, int kD> struct Layout {
  using C = Cfg<T>;
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int kM = 64 * C::kWG;   // query rows of a tile
  static constexpr int kBox = 128 / (int)sizeof(T);  // Dh of a row chunk
  static constexpr int kChunks = kD / kBox;
  static constexpr int kQ = kM * kD * (int)sizeof(T);
  static constexpr int kKV = C::kN * kD * (int)sizeof(T);  // K or V tile
  static constexpr int kStage = 2 * kKV;                    // K, then V
  static constexpr int kQLo = kQ;                           // f32 only
  static constexpr int kRing = kF32 ? 2 * kQ : kQ;
  // f32 split stages: K hi, K lo, V^T hi, V^T lo.
  static constexpr int kSplit = kRing + C::kStages * kStage;
  static constexpr int kBar = kSplit + C::kSplits * 4 * kKV;
  // full / empty per stage and per split stage; qfull, qready, qempty.
  static constexpr int kBytes =
      kBar + (2 * C::kStages + 2 * C::kSplits + 3) * 8;
  static_assert(kBytes <= kMaxSmem, "shared memory");
};

template <typename T>
int smem_bytes_t(int dh) {
  return dh <= 64 ? Layout<T, 64>::kBytes : Layout<T, 128>::kBytes;
}

// Byte offset of element (r, c) in a tile of `rows` rows stored as
// 128-byte row chunks with a 128-byte swizzle.
template <typename T>
__device__ __forceinline__ uint32_t tile_off(int r, int c, int rows) {
  constexpr int kBox = 128 / (int)sizeof(T);
  return (c / kBox) * rows * 128 +
         hopper::swizzle<128>(r * 128 + (c % kBox) * (int)sizeof(T));
}

// Copies rows r0 .. r0 + rows - 1 of a (n, dh) row-major matrix into a
// tile laid out as TMA would write it, zeros outside [0, n) x [0, dh).
// Run by the 32 lanes of the producer warp.
template <typename T, int kD>
__device__ __forceinline__ void copy_tile(unsigned char* dst,
                                          const T* __restrict__ src, int dh,
                                          int r0, int n, int rows,
                                          int lane) {
  for (int e = lane; e < rows * kD; e += 32) {
    const int r = e / kD, c = e % kD;
    const int gr = r0 + r;
    const T x = (gr >= 0 && gr < n && c < dh) ? src[(long)gr * dh + c]
                                              : T(0.f);
    *reinterpret_cast<T*>(dst + tile_off<T>(r, c, rows)) = x;
  }
}

// hi = tf32(x) in place of x and lo = tf32(x - hi) at the same offset in
// `lo`, for kBytes bytes of f32.  Run by one warpgroup.
template <int kBytes>
__device__ __forceinline__ void split_in_place(unsigned char* x,
                                               unsigned char* lo, int tid) {
  static_assert(kBytes % (16 * 128) == 0, "whole float4 rounds");
#pragma unroll
  for (int i = 0; i < kBytes / (16 * 128); ++i) {
    const int e = tid + 128 * i;
    const float4 v = reinterpret_cast<const float4*>(x)[e];
    float4 h, l;
    h.x = hopper::to_tf32(v.x);
    h.y = hopper::to_tf32(v.y);
    h.z = hopper::to_tf32(v.z);
    h.w = hopper::to_tf32(v.w);
    l.x = hopper::to_tf32(v.x - h.x);
    l.y = hopper::to_tf32(v.y - h.y);
    l.z = hopper::to_tf32(v.z - h.z);
    l.w = hopper::to_tf32(v.w - h.w);
    reinterpret_cast<float4*>(x)[e] = h;
    reinterpret_cast<float4*>(lo)[e] = l;
  }
}

// One f32 stage (K then V, 32 keys x kD each, as TMA wrote them) in the
// registers of the splitter warpgroup: K float4 e = tid + 128 i as it
// lies; V float4 e holds key e % 32, columns 4 (e / 32) .. + 3.
template <int kD>
struct StageRegs {
  static constexpr int kPer = 32 * kD / (4 * 128);
  float4 k[kPer], v[kPer];
};

template <int kD>
__device__ __forceinline__ void load_stage(const unsigned char* st,
                                           StageRegs<kD>& r, int tid) {
  constexpr int kKV = 32 * kD * 4;
#pragma unroll
  for (int i = 0; i < StageRegs<kD>::kPer; ++i) {
    const int e = tid + 128 * i;
    r.k[i] = reinterpret_cast<const float4*>(st)[e];
    r.v[i] = *reinterpret_cast<const float4*>(
        st + kKV + tile_off<float>(e % 32, 4 * (e / 32), 32));
  }
}

// Writes the split stage: K hi and K lo in K's own layout, and V^T hi and
// V^T lo: kD rows of the 32 keys (128 bytes, 128-byte swizzle), key kk of
// each group of 8 at position kk / 2 + 4 (kk % 2).
template <int kD>
__device__ __forceinline__ void write_split(const StageRegs<kD>& r,
                                            unsigned char* dst, int tid) {
  constexpr int kKV = 32 * kD * 4;
  unsigned char* vt = dst + 2 * kKV;
#pragma unroll
  for (int i = 0; i < StageRegs<kD>::kPer; ++i) {
    const int e = tid + 128 * i;
    const float* x = &r.k[i].x;
    float4 h, l;
    float* hp = &h.x;
    float* lp = &l.x;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      hp[j] = hopper::to_tf32(x[j]);
      lp[j] = hopper::to_tf32(x[j] - hp[j]);
    }
    reinterpret_cast<float4*>(dst)[e] = h;
    reinterpret_cast<float4*>(dst + kKV)[e] = l;
    const int key = e % 32, c4 = 4 * (e / 32);
    const int pos = (key & ~7) | ((key & 7) >> 1) | ((key & 1) << 2);
    const float* y = &r.v[i].x;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float hv = hopper::to_tf32(y[j]);
      const uint32_t off = hopper::swizzle<128>((c4 + j) * 128 + pos * 4);
      *reinterpret_cast<float*>(vt + off) = hv;
      *reinterpret_cast<float*>(vt + kKV + off) = hopper::to_tf32(y[j] - hv);
    }
  }
}

// Stores columns col and col + 1 of a row (the second only if `two`),
// with one 2-element store when `pair`.
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

// 2^x by the SFU (ex2.approx, relative error ~2^-22; 0 for -inf).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// Keys [0, limit) the tile of rows t0 .. t0 + rows - 1 of block rows
// [., qb_end) reads: up to its last stored row when causal, else all.
__device__ __forceinline__ int key_limit(int t0, int rows, int qb_end,
                                         int Sk, int causal) {
  const int last = min(t0 + rows, qb_end) - 1;
  return causal ? min(last + 1, Sk) : Sk;
}

// The first key of stage i of a tile whose keys end at `lim`: stages of
// kN keys from 0, the last one ending at lim (it repeats keys below
// i * kN, or starts below 0, and masks them).
template <int kN>
__device__ __forceinline__ int stage_key(int i, int n, int lim) {
  return i < n - 1 ? i * kN : lim - kN;
}

// The online softmax of one stage on the S fragment of a warpgroup:
// sc[4 j + 2 h + x] is row row0 + rq + 8 h, key k0 + 8 j + 2 tq + x.
// Masks keys below lo_key and, when causal, past the row (only a stage
// that repeats keys or reaches past the warpgroup's first row has any);
// turns sc into p = 2^(s scale log2(e) - m') with m' the new row maximum
// of the raw scores; returns alpha, the factor of the old terms, per
// row, and updates the row's max m and this thread's part of the sum l.
template <int kN>
__device__ __forceinline__ void softmax_stage(float (&sc)[kN / 2],
                                              float (&m)[2], float (&l)[2],
                                              float (&alpha)[2], int k0,
                                              int lo_key, int row0, int rq,
                                              int tq, int causal,
                                              float scale_log2) {
  if (k0 < lo_key || (causal && k0 + kN - 1 > row0)) {
#pragma unroll
    for (int e = 0; e < kN / 2; ++e) {
      const int key = k0 + 8 * (e / 4) + 2 * tq + (e % 2);
      const int qpos = row0 + rq + 8 * ((e / 2) % 2);
      if (key < lo_key || (causal && key > qpos)) sc[e] = -INFINITY;
    }
  }
  float mx[2] = {m[0], m[1]}, neg[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int e = 0; e < kN / 2; ++e)
    mx[(e / 2) % 2] = fmaxf(mx[(e / 2) % 2], sc[e]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    // No live key yet: the row's terms are all 0, and so is alpha.
    neg[h] = mx[h] == -INFINITY ? 0.f : -mx[h] * scale_log2;
    alpha[h] = exp2_approx(fmaf(m[h], scale_log2, neg[h]));
    m[h] = mx[h];
  }
#pragma unroll
  for (int e = 0; e < kN / 2; ++e) {
    const int h = (e / 2) % 2;
    sc[e] = exp2_approx(fmaf(sc[e], scale_log2, neg[h]));
    sum[h] += sc[e];
  }
  l[0] = l[0] * alpha[0] + sum[0];
  l[1] = l[1] * alpha[1] + sum[1];
}

template <typename T, int kD, bool kTma>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int BH,
                       int Sq, int Sk, int dh, int block_q, int causal,
                       float scale) {
  using C = Cfg<T>;
  using L = Layout<T, kD>;
  constexpr bool kF32 = L::kF32;
  constexpr int kN = C::kN, kM = L::kM, kS = C::kStages;
  constexpr int kConsumerWarps = 4 * C::kWG;
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* sq = smem;
  unsigned char* q_lo = smem + L::kQLo;  // f32
  unsigned char* ring = smem + L::kRing;
  unsigned char* split = smem + L::kSplit;  // f32
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* empty = full + kS;
  uint64_t* sfull = empty + kS;  // f32: split stages
  uint64_t* sempty = sfull + C::kSplits;
  uint64_t* qfull = sempty + C::kSplits;
  uint64_t* qready = qfull + 1;  // f32: Q split
  uint64_t* qempty = qready + 1;

  const int tid = threadIdx.x;
  if (tid == 0) {
    // TMA arrives once with the bytes; the copy stage once a lane.  In
    // f32 the splitter (warpgroup 1) empties the ring and one of its
    // threads fills a split stage; warpgroup 0 empties those.
    for (int s = 0; s < kS; ++s) {
      hopper::mbar_init(&full[s], kTma ? 1 : 32);
      hopper::mbar_init(&empty[s], kF32 ? 4 : kConsumerWarps);
    }
    for (int s = 0; s < C::kSplits; ++s) {
      hopper::mbar_init(&sfull[s], 1);
      hopper::mbar_init(&sempty[s], 4);
    }
    hopper::mbar_init(qfull, kTma ? 1 : 32);
    hopper::mbar_init(qready, 1);
    hopper::mbar_init(qempty, kConsumerWarps);
    hopper::mbar_init_fence();
  }
  __syncthreads();

  // The heaviest query blocks (the last of each head) launch first.
  const int nqb = Sq / block_q;
  const int qi = nqb - 1 - (int)(blockIdx.x / BH);
  const int g = blockIdx.x % BH;
  const int qb0 = qi * block_q, qb_end = qb0 + block_q;
  const int n_qt = (block_q + kM - 1) / kM;

  if (tid >= kProducer) {
    // ---- producer warp: Q once a tile, K/V stages into the ring ----
    hopper::setmaxnreg_dec<40>();
    const int lane = tid - kProducer;
    if (lane >= (kTma ? 1 : 32)) return;
    const T* qg = q + (long)g * Sq * dh;
    const T* kg = k + (long)g * Sk * dh;
    const T* vg = v + (long)g * Sk * dh;
    int it = 0;
    for (int qt = 0; qt < n_qt; ++qt) {
      const int t0 = qb0 + qt * kM;
      hopper::mbar_wait(qempty, (qt & 1) ^ 1);
      if constexpr (kTma) {
        hopper::mbar_arrive_expect_tx(qfull, L::kQ);
#pragma unroll
        for (int ch = 0; ch < L::kChunks; ++ch)
          hopper::tma_load_3d(sq + ch * kM * 128, &map_q, qfull,
                              ch * L::kBox, t0, g);
      } else {
        copy_tile<T, kD>(sq, qg, dh, t0, Sq, kM, lane);
        hopper::fence_proxy_async();
        hopper::mbar_arrive(qfull);
      }
      const int lim = key_limit(t0, kM, qb_end, Sk, causal);
      const int n = (lim + kN - 1) / kN;
      for (int i = 0; i < n; ++i, ++it) {
        const int s = it % kS;
        const int k0 = stage_key<kN>(i, n, lim);
        unsigned char* st = ring + s * L::kStage;
        hopper::mbar_wait(&empty[s], ((it / kS) & 1) ^ 1);
        if constexpr (kTma) {
          hopper::mbar_arrive_expect_tx(&full[s], L::kStage);
#pragma unroll
          for (int ch = 0; ch < L::kChunks; ++ch) {
            hopper::tma_load_3d(st + ch * kN * 128, &map_k, &full[s],
                                ch * L::kBox, k0, g);
            hopper::tma_load_3d(st + L::kKV + ch * kN * 128, &map_v,
                                &full[s], ch * L::kBox, k0, g);
          }
        } else {
          copy_tile<T, kD>(st, kg, dh, k0, Sk, kN, lane);
          copy_tile<T, kD>(st + L::kKV, vg, dh, k0, Sk, kN, lane);
          hopper::fence_proxy_async();
          hopper::mbar_arrive(&full[s]);
        }
      }
    }
    return;
  }

  hopper::setmaxnreg_inc<232>();
  const int wg = tid / 128, wtid = tid % 128;
  const int warp = wtid / 32, lane = wtid % 32;

  if constexpr (kF32) {
    if (wg == 1) {
      // ---- splitter: Q hi / lo in place once a tile; each ring stage
      // into registers (freeing it for the next load), then into a split
      // stage: K hi / lo and the transposed V^T hi / lo ----
      int it = 0;
      for (int qt = 0; qt < n_qt; ++qt) {
        const int t0 = qb0 + qt * kM;
        hopper::mbar_wait(qfull, qt & 1);
        split_in_place<L::kQ>(sq, q_lo, wtid);
        hopper::fence_proxy_async();
        hopper::named_bar_sync(1, 128);
        if (wtid == 0) hopper::mbar_arrive(qready);
        const int lim = key_limit(t0, kM, qb_end, Sk, causal);
        const int n = (lim + kN - 1) / kN;
        for (int i = 0; i < n; ++i, ++it) {
          const int s = it % kS, j = it % C::kSplits;
          StageRegs<kD> r;
          hopper::mbar_wait(&full[s], (it / kS) & 1);
          load_stage<kD>(ring + s * L::kStage, r, wtid);
          // The reads are done before TMA (the async proxy) refills it.
          hopper::fence_proxy_async();
          __syncwarp();
          if (lane == 0) hopper::mbar_arrive(&empty[s]);
          hopper::mbar_wait(&sempty[j], ((it / C::kSplits) & 1) ^ 1);
          write_split<kD>(r, split + j * 4 * L::kKV, wtid);
          hopper::fence_proxy_async();
          hopper::named_bar_sync(1, 128);
          if (wtid == 0) hopper::mbar_arrive(&sfull[j]);
        }
      }
      return;
    }
  }

  // ---- consumers: warpgroup c owns rows 64 c .. 64 c + 63 of a tile;
  // thread (warp, lane) holds rows rq and rq + 8 of those 64 ----
  const int c = wg;
  const int rq = 16 * warp + lane / 4, tq = lane % 4;
  const float scale_log2 = scale * 1.4426950408889634f;
  float o[kD / 2];
  int it = 0;
  for (int qt = 0; qt < n_qt; ++qt) {
    const int t0 = qb0 + qt * kM;
    const int lim = key_limit(t0, kM, qb_end, Sk, causal);
    const int n = (lim + kN - 1) / kN;
    const int row0 = t0 + 64 * c;
    const int my_last = min(row0 + 64, qb_end) - 1;  // < row0: none stored
    hopper::mbar_wait(kF32 ? qready : qfull, qt & 1);
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];

    if constexpr (kF32) {
      for (int i = 0; i < n; ++i, ++it) {
        const int j = it % C::kSplits;
        const unsigned char* k_hi = split + j * 4 * L::kKV;
        const unsigned char* k_lo = k_hi + L::kKV;
        const unsigned char* vt_hi = k_lo + L::kKV;
        const unsigned char* vt_lo = vt_hi + L::kKV;
        hopper::mbar_wait(&sfull[j], (it / C::kSplits) & 1);
        // S = Q K^T in 3xTF32.
        float sc[kN / 2];
#pragma unroll
        for (int e = 0; e < kN / 2; ++e) sc[e] = 0.f;
        hopper::fence_operands(sc);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kD / 8; ++kk) {
          const int off_q = (kk / 4) * kM * 128 + 32 * (kk % 4);
          const int off_k = (kk / 4) * kN * 128 + 32 * (kk % 4);
          const uint64_t qh = hopper::smem_desc<128>(sq + off_q, 16, 1024);
          const uint64_t ql = hopper::smem_desc<128>(q_lo + off_q, 16, 1024);
          const uint64_t kh = hopper::smem_desc<128>(k_hi + off_k, 16, 1024);
          const uint64_t kl = hopper::smem_desc<128>(k_lo + off_k, 16, 1024);
          hopper::wgmma_tf32<kN>(sc, ql, kh);
          hopper::wgmma_tf32<kN>(sc, qh, kl);
          hopper::wgmma_tf32<kN>(sc, qh, kh);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_operands(sc);
        softmax_stage<kN>(sc, m, l, alpha, stage_key<kN>(i, n, lim), i * kN,
                          row0, rq, tq, causal, scale_log2);
        // P hi / lo as tf32 A fragments: k step jj takes keys 8 jj + 2 tq
        // (as k = tq) and 8 jj + 2 tq + 1 (as k = tq + 4), which is where
        // write_split put those keys in V^T.  Each stage's P V goes into
        // its own accumulator, added to O in f32.
        uint32_t ph[kN / 2], pl[kN / 2];
#pragma unroll
        for (int e = 0; e < kN / 2; ++e) {
          const float hi = hopper::to_tf32(sc[e]);
          ph[e] = __float_as_uint(hi);
          pl[e] = __float_as_uint(hopper::to_tf32(sc[e] - hi));
        }
        float part[kD / 2];
#pragma unroll
        for (int e = 0; e < kD / 2; ++e) part[e] = 0.f;
        hopper::fence_operands(part);
        hopper::wgmma_fence();
#pragma unroll
        for (int jj = 0; jj < kN / 8; ++jj) {
          const uint32_t ah[4] = {ph[4 * jj], ph[4 * jj + 2], ph[4 * jj + 1],
                                  ph[4 * jj + 3]};
          const uint32_t al[4] = {pl[4 * jj], pl[4 * jj + 2], pl[4 * jj + 1],
                                  pl[4 * jj + 3]};
          const uint64_t vh = hopper::smem_desc<128>(vt_hi + 32 * jj, 16, 1024);
          const uint64_t vl = hopper::smem_desc<128>(vt_lo + 32 * jj, 16, 1024);
          hopper::wgmma_tf32_rs<kD>(part, al, vh);
          hopper::wgmma_tf32_rs<kD>(part, ah, vl);
          hopper::wgmma_tf32_rs<kD>(part, ah, vh);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_operands(part);
        if (lane == 0) hopper::mbar_arrive(&sempty[j]);
#pragma unroll
        for (int e = 0; e < kD / 2; ++e)
          o[e] = o[e] * alpha[(e / 2) % 2] + part[e];
      }
    } else {
      // bf16: S, softmax, P V in turn; the two warpgroups interleave.  P
      // is a bf16 pair split into hi + lo: pair 2 j + h is row rq + 8 h,
      // keys 8 j + 2 tq ..+1, so k16 step kk takes pairs 4 kk .. 4 kk + 3.
      // Stages past this warpgroup's own key limit are wholly masked for
      // it: it computes only the first n_c.
      const int my_lim = my_last < row0
                             ? 0
                             : key_limit(row0, 64, qb_end, Sk, causal);
      const int n_c = min(n, (my_lim + kN - 1) / kN);
      for (int i = 0; i < n; ++i) {
        const int s = (it + i) % kS;
        const unsigned char* st = ring + s * L::kStage;
        // Warpgroup 1 starts once warpgroup 0 has its first P: staggered
        // by half a stage, each one's softmax runs beside the other's
        // products.
        if (c == 1 && qt == 0 && i == 0) hopper::named_bar_sync(2, 256);
        hopper::mbar_wait(&full[s], ((it + i) / kS) & 1);
        if (i < n_c) {
          float sc[kN / 2];
#pragma unroll
          for (int e = 0; e < kN / 2; ++e) sc[e] = 0.f;
          hopper::fence_operands(sc);
          hopper::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kD / 16; ++kk) {
            const uint64_t dq = hopper::smem_desc<128>(
                sq + (kk / 4) * kM * 128 + c * 64 * 128 + 32 * (kk % 4), 16,
                1024);
            const uint64_t dk = hopper::smem_desc<128>(
                st + (kk / 4) * kN * 128 + 32 * (kk % 4), 16, 1024);
            hopper::wgmma_bf16_kmajor<kN>(sc, dq, dk);
          }
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          hopper::fence_operands(sc);
          softmax_stage<kN>(sc, m, l, alpha, stage_key<kN>(i, n, lim), i * kN,
                            row0, rq, tq, causal, scale_log2);
          if (c == 0 && qt == 0 && i == 0) hopper::named_bar_arrive(2, 256);
          uint32_t ph[kN / 4], pl[kN / 4];
#pragma unroll
          for (int e = 0; e < kN / 4; ++e) {
            const __nv_bfloat162 hi =
                __floats2bfloat162_rn(sc[2 * e], sc[2 * e + 1]);
            const float2 hf = __bfloat1622float2(hi);
            ph[e] = bf16x2_bits(hi);
            pl[e] = bf16x2_bits(__floats2bfloat162_rn(sc[2 * e] - hf.x,
                                                       sc[2 * e + 1] - hf.y));
          }
          // O = O alpha, skipped by a warp whose row maxima all held.
          if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
            for (int e = 0; e < kD / 2; ++e) o[e] *= alpha[(e / 2) % 2];
          }
          hopper::fence_operands(o);
          hopper::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kN / 16; ++kk) {
            const uint32_t ah[4] = {ph[4 * kk], ph[4 * kk + 1],
                                    ph[4 * kk + 2], ph[4 * kk + 3]};
            const uint32_t al[4] = {pl[4 * kk], pl[4 * kk + 1],
                                    pl[4 * kk + 2], pl[4 * kk + 3]};
            // V (kN keys x kD) N-major: 64-column chunks kN * 128 bytes
            // apart (LBO), 8-key groups 1024 bytes apart (SBO).
            const uint64_t dv = hopper::smem_desc<128>(
                st + L::kKV + kk * 16 * 128, kN * 128, 1024);
            hopper::wgmma_bf16_rs<kD>(o, al, dv);
            hopper::wgmma_bf16_rs<kD>(o, ah, dv);
          }
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          hopper::fence_operands(o);
        }
        // Stages past n_c are wholly masked for these rows: given back.
        if (lane == 0) hopper::mbar_arrive(&empty[s]);
      }
      it += n;
    }

    // Every product that read this tile's Q is done.
    if (lane == 0) hopper::mbar_arrive(qempty);

    // ---- epilogue: o[4 j + 2 h + x] is row rq + 8 h, column 8 j + 2 tq
    // + x; l is summed over the quad of the row ----
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      l[h] = fmaxf(l[h], 1e-30f);
    }
    const bool even = dh % 2 == 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + rq + 8 * h;
      if (row > my_last) continue;
      T* orow = out + ((long)g * Sq + row) * dh;
#pragma unroll
      for (int j = 0; j < kD / 8; ++j) {
        const int col = 8 * j + 2 * tq;
        if (col >= dh) continue;
        const bool two = col + 1 < dh;
        store2(orow + col, o[4 * j + 2 * h] / l[h],
               o[4 * j + 2 * h + 1] / l[h], two, two && even);
      }
    }
  }
}

// Tensor map of a (bh, s, dh) row-major array as (dh, s, bh), boxes of
// (box_cols, box_rows, 1) with a 128-byte swizzle; zeros outside.
template <typename T>
bool encode(CUtensorMap* map, const void* p, int bh, int s, int dh,
            int box_rows) {
  hopper::EncodeTiled fn = hopper::encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)dh, (cuuint64_t)s, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)dh * sizeof(T),
                                 (cuuint64_t)s * dh * sizeof(T)};
  const cuuint32_t box[3] = {128 / (cuuint32_t)sizeof(T),
                             (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapDataType type = sizeof(T) == 4
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return fn(map, type, 3, const_cast<void*>(p), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int kD, bool kTma>
int launch(const void* q, const void* k, const void* v, void* out, int BH,
           int Sq, int Sk, int dh, int block_q, int causal, float scale,
           cudaStream_t stream) {
  using L = Layout<T, kD>;
  CUtensorMap mq = {}, mk = {}, mv = {};
  if (kTma && !(encode<T>(&mq, q, BH, Sq, dh, L::kM) &&
                encode<T>(&mk, k, BH, Sk, dh, Cfg<T>::kN) &&
                encode<T>(&mv, v, BH, Sk, dh, Cfg<T>::kN)))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_attention_kernel<T, kD, kTma>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (e != cudaSuccess) return (int)e;
  const long blocks = (long)BH * (Sq / block_q);
  kernel<<<(unsigned)blocks, kThreads, L::kBytes, stream>>>(
      mq, mk, mv, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), BH, Sq, Sk, dh,
      block_q, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_t(const void* q, const void* k, const void* v, void* out, int BH,
             int Sq, int Sk, int dh, int block_q, int causal, float scale,
             bool tma, cudaStream_t s) {
  if (dh <= 64)
    return tma ? launch<T, 64, true>(q, k, v, out, BH, Sq, Sk, dh, block_q,
                                     causal, scale, s)
               : launch<T, 64, false>(q, k, v, out, BH, Sq, Sk, dh, block_q,
                                      causal, scale, s);
  return tma ? launch<T, 128, true>(q, k, v, out, BH, Sq, Sk, dh, block_q,
                                    causal, scale, s)
             : launch<T, 128, false>(q, k, v, out, BH, Sq, Sk, dh, block_q,
                                     causal, scale, s);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// Dynamic shared memory (bytes) a launch at head dim `dh` (1..128) with
// `dtype_bytes`-byte elements (4: float32, 2: bfloat16) requests; the
// knobs do not change it.
extern "C" int flash_attention_smem_bytes(int dh, int dtype_bytes) {
  return dtype_bytes == 4 ? smem_bytes_t<float>(dh)
                          : smem_bytes_t<__nv_bfloat16>(dh);
}

// Launches on `stream`; returns cudaGetLastError() (0 on success).  q is
// (BH, Sq, dh), k and v (BH, Sk, dh), out (BH, Sq, dh), C-contiguous
// device pointers of one dtype (0: float32, 1: bfloat16).  Requires
// Sq % block_q == 0, Sk % block_kv == 0, Sk >= 1 and 1 <= dh <= 128
// (checked by the Python wrapper; refused here with
// cudaErrorInvalidValue).  Tiles load by TMA when q, k and v are 16-byte
// aligned and a row (dh elements) is a multiple of 16 bytes, else by the
// producer warp's copy stage.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int BH,
                                      int Sq, int Sk, int dh, int block_q,
                                      int block_kv, int causal, float scale,
                                      int dtype, void* stream) {
  if (BH <= 0 || Sq <= 0) return 0;
  if (block_q <= 0 || block_kv <= 0 || Sk <= 0 || Sq % block_q != 0 ||
      Sk % block_kv != 0 || dh < 1 || dh > kMaxDh ||
      (dtype != 0 && dtype != 1) || (long)BH * (Sq / block_q) > 0x7fffffffL)
    return (int)cudaErrorInvalidValue;
  const int bytes = dtype == 0 ? 4 : 2;
  const bool tma = aligned16(q) && aligned16(k) && aligned16(v) &&
                   dh * bytes % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_t<float>(q, k, v, out, BH, Sq, Sk, dh, block_q, causal,
                           scale, tma, s);
  return launch_t<__nv_bfloat16>(q, k, v, out, BH, Sq, Sk, dh, block_q,
                                 causal, scale, tma, s);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
