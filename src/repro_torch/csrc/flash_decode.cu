// Flash decode for Hopper: one query token per (batch, head) against a KV
// cache masked at a length read from device memory; f32 online softmax,
// output in the input dtype.
//
// Replaces the Pallas kernel `flash_decode` (body `_decode_kernel`) in
// src/repro/kernels/flash_decode/kernel.py.  There the grid (B*H,
// Smax/block_kv) runs the kv blocks in order on one core with (m, l, acc)
// in VMEM scratch; `cur_len` arrives by scalar prefetch, blocks wholly past
// it are skipped, positions past it inside a block are NEG_INF = -1e30;
// scale Dh^-0.5; output acc / max(l, 1e-30), so cur_len = 0 gives zeros.
//
// What bounds it on an H100: bytes.  At qwen3-8b decode (8 x 32 heads, a
// 8192 x 128 bf16 cache) the live part of the two caches, 1.07 GB at
// cur_len = 8192, streams once: 0.32 ms at 3.35 TB/s; the arithmetic is
// ~2 FLOP per byte.  Reaching the memory rate takes many bytes in flight
// on every SM, and few instructions and little serial latency per key.
//
// The design:
//   * The kv axis is split across thread blocks (a TPU grid axis runs in
//     order; CUDA blocks do not): block (j, g) owns kv block j of (batch,
//     head) g, the extent the knob gives it.  It reads cur_len from device
//     memory (no host synchronisation); a block wholly past cur_len writes
//     the neutral partial (m = -1e30, l = 0, acc = 0) and exits without
//     touching the cache, which is the Pallas kernel's skip.
//   * Loads are 16 bytes a lane (8 bf16 or 4 f32), with the streaming
//     (evict-first) cache hint, since every byte is read once: a key
//     row takes G lanes (16 at Dh = 128 bf16), so one warp instruction
//     reads 32 / G consecutive keys.  Each warp issues the K and V loads of
//     kDepth such steps before it uses any of them, so 4 x 32/G keys per
//     warp are in flight.  A row whose bytes or base are not a multiple of
//     16 bytes (an odd Dh, say) is read one element a lane, in the same
//     kernel.
//   * A key's score is reduced over its G lanes only (log2 G shuffles,
//     every key of the warp at once), and the online softmax rescales once
//     per kDepth keys of a lane group, not once per key.
//   * Positions past cur_len inside a block are neither read nor weighted.
//   * At the end the lane groups of a warp merge with shuffles and the
//     warps in shared memory into one partial (m, l, acc[Dh]) in f32
//     scratch.  A second kernel merges the partials of each (batch, head)
//     in kv order and divides.  It is kept apart, not fused into the last
//     block of each head: it reads B*H*(Smax/block_kv)*(Dh + 2) f32 words
//     (8.5 MB at block_kv = 128) from L2 in a few microseconds, while a
//     fused merge needs a zeroed counter per head, which costs a memset
//     launch of its own on every call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kDepth = 4;        // load steps in flight per warp
constexpr int kMaxHeadDim = 256;
constexpr float kNegInf = -1e30f;

// One load of VB bytes.
template <int VB> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<2> { using type = unsigned short; };

template <int VB>
__device__ __forceinline__ typename Raw<VB>::type load_stream(const void* p) {
  return __ldcs(static_cast<const typename Raw<VB>::type*>(p));
}

__device__ __forceinline__ float bf16_lo(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

// The VB / sizeof(T) elements of one load, as f32.
template <typename T, int VB>
__device__ __forceinline__ void unpack(const typename Raw<VB>::type& x,
                                       float* out) {
  if constexpr (VB == 16 && sizeof(T) == 4) {
    out[0] = __uint_as_float(x.x);
    out[1] = __uint_as_float(x.y);
    out[2] = __uint_as_float(x.z);
    out[3] = __uint_as_float(x.w);
  } else if constexpr (VB == 16) {
    const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = bf16_lo(w[i]);
      out[2 * i + 1] = bf16_hi(w[i]);
    }
  } else if constexpr (sizeof(T) == 4) {
    out[0] = __uint_as_float(x);
  } else {
    out[0] = bf16_lo(x);
  }
}

// Partial of block (j, g) at part + (g * n_blk + j) * (dh + 2):
// [m, l, acc[0..dh)].  T is the element type, VB the bytes of one load,
// G the lanes of one key row, NV the loads of a row a lane makes.
template <typename T, int VB, int G, int NV>
__global__ void __launch_bounds__(kThreads)
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v,
                      const int* __restrict__ cur_len_ptr,
                      float* __restrict__ part, int smax, int dh,
                      int block_kv, float scale) {
  constexpr int VEC = VB / (int)sizeof(T);  // elements per load
  constexpr int KPW = 32 / G;               // keys per warp instruction
  constexpr int STEP = kWarps * KPW;        // keys per load step of a block
  using R = typename Raw<VB>::type;
  __shared__ float w_m[kWarps];
  __shared__ float w_l[kWarps];
  __shared__ float w_acc[kWarps][kMaxHeadDim];

  const int j = blockIdx.x;
  const int g = blockIdx.y;
  const int n_blk = gridDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int grp = lane / G;   // which key of a warp instruction
  const int gl = lane % G;    // which piece of that key's row
  const int n_vec = dh / VEC;
  float* dst = part + ((size_t)g * n_blk + j) * (dh + 2);
  const int cur_len = *cur_len_ptr;
  const int start = j * block_kv;
  if (start >= cur_len) {  // wholly past cur_len: neutral partial
    for (int d = tid; d < dh + 2; d += kThreads)
      dst[d] = d == 0 ? kNegInf : 0.f;
    return;
  }
  const int end = min(start + block_kv, cur_len);

  // Lane piece c covers elements [(c * G + gl) * VEC, + VEC) of a row.
  float qr[NV][VEC], acc[NV][VEC];
#pragma unroll
  for (int c = 0; c < NV; ++c) {
    const int vi = c * G + gl;
    R raw{};
    if (vi < n_vec) raw = *reinterpret_cast<const R*>(q + (size_t)g * dh +
                                                      vi * VEC);
    unpack<T, VB>(raw, qr[c]);
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[c][e] = 0.f;
  }
  float m = kNegInf, l = 0.f;
  const size_t base = (size_t)g * smax * dh;

  for (int key0 = start; key0 < end; key0 += STEP * kDepth) {
    R kr[kDepth][NV], vr[kDepth][NV];
    bool live[kDepth];
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      const int key = key0 + (d * kWarps + warp) * KPW + grp;
      live[d] = key < end;
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        const int vi = c * G + gl;
        kr[d][c] = R{};
        vr[d][c] = R{};
        if (live[d] && vi < n_vec) {
          const size_t off = base + (size_t)key * dh + vi * VEC;
          kr[d][c] = load_stream<VB>(k + off);
          vr[d][c] = load_stream<VB>(v + off);
        }
      }
    }
    float s[kDepth];
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        float kf[VEC];
        unpack<T, VB>(kr[d][c], kf);
#pragma unroll
        for (int e = 0; e < VEC; ++e) dot += qr[c][e] * kf[e];
      }
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      s[d] = dot * scale;
    }
    float m_new = m;
#pragma unroll
    for (int d = 0; d < kDepth; ++d)
      if (live[d]) m_new = fmaxf(m_new, s[d]);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int c = 0; c < NV; ++c)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[c][e] *= alpha;
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      const float p = live[d] ? expf(s[d] - m_new) : 0.f;
      l += p;
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        float vf[VEC];
        unpack<T, VB>(vr[d][c], vf);
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[c][e] += p * vf[e];
      }
    }
    m = m_new;
  }

  // Merge the warp's lane groups (each ends with the warp's partial).
#pragma unroll
  for (int off = G; off < 32; off <<= 1) {
    const float m_o = __shfl_xor_sync(0xffffffffu, m, off);
    const float l_o = __shfl_xor_sync(0xffffffffu, l, off);
    const float mx = fmaxf(m, m_o);
    const float a = expf(m - mx), b = expf(m_o - mx);
    l = l * a + l_o * b;
#pragma unroll
    for (int c = 0; c < NV; ++c)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        acc[c][e] = acc[c][e] * a +
                    __shfl_xor_sync(0xffffffffu, acc[c][e], off) * b;
    m = mx;
  }
  if (lane == 0) {
    w_m[warp] = m;
    w_l[warp] = l;
  }
  if (grp == 0) {
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      const int vi = c * G + gl;
      if (vi < n_vec)
#pragma unroll
        for (int e = 0; e < VEC; ++e) w_acc[warp][vi * VEC + e] = acc[c][e];
    }
  }
  __syncthreads();
  float mx = kNegInf;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, w_m[w]);
  for (int d = tid; d < dh + 2; d += kThreads) {
    float val = 0.f;
    if (d == 0) {
      val = mx;
    } else {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float f = expf(w_m[w] - mx);  // 0 for a warp with no key
        val += f * (d == 1 ? w_l[w] : w_acc[w][d - 2]);
      }
    }
    dst[d] = val;
  }
}

template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ part,
                                      T* __restrict__ out, int n_blk,
                                      int dh) {
  const int g = blockIdx.x;
  const float* src = part + (size_t)g * n_blk * (dh + 2);
  float mx = kNegInf;
  for (int j = 0; j < n_blk; ++j) mx = fmaxf(mx, src[(size_t)j * (dh + 2)]);
  for (int d = threadIdx.x; d < dh; d += blockDim.x) {
    float l = 0.f, acc = 0.f;
#pragma unroll 8
    for (int j = 0; j < n_blk; ++j) {
      const float* p = src + (size_t)j * (dh + 2);
      const float f = expf(p[0] - mx);
      l += f * p[1];
      acc += f * p[2 + d];
    }
    store_as(&out[(size_t)g * dh + d], acc / fmaxf(l, 1e-30f));
  }
}

template <typename T, int VB, int G, int NV>
int launch_partial(const void* q, const void* k, const void* v,
                   const int* cur_len, float* part, int BH, int smax, int dh,
                   int block_kv, float scale, cudaStream_t stream) {
  const dim3 grid(smax / block_kv, BH);
  decode_partial_kernel<T, VB, G, NV><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), cur_len, part, smax, dh, block_kv, scale);
  return (int)cudaGetLastError();
}

// Lanes per key row for a row of n loads: the next power of two, at least
// 4 (so at most 8 keys share a warp instruction).
template <typename T, int VB>
int launch_rows(int n, const void* q, const void* k, const void* v,
                const int* cur_len, float* part, int BH, int smax, int dh,
                int block_kv, float scale, cudaStream_t stream) {
  if (n <= 4)
    return launch_partial<T, VB, 4, 1>(q, k, v, cur_len, part, BH, smax, dh,
                                       block_kv, scale, stream);
  if (n <= 8)
    return launch_partial<T, VB, 8, 1>(q, k, v, cur_len, part, BH, smax, dh,
                                       block_kv, scale, stream);
  if (n <= 16)
    return launch_partial<T, VB, 16, 1>(q, k, v, cur_len, part, BH, smax,
                                        dh, block_kv, scale, stream);
  if constexpr (VB == 16) {
    if (n <= 32)
      return launch_partial<T, VB, 32, 1>(q, k, v, cur_len, part, BH, smax,
                                          dh, block_kv, scale, stream);
    // f32 rows of 33-64 loads (Dh <= 256).
    return launch_partial<T, VB, 32, 2>(q, k, v, cur_len, part, BH, smax,
                                        dh, block_kv, scale, stream);
  } else {
    // One element a lane, up to 8 a lane (Dh <= 256).
    return launch_partial<T, VB, 32, 8>(q, k, v, cur_len, part, BH, smax,
                                        dh, block_kv, scale, stream);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* cur_len,
           float* part, void* out, int BH, int smax, int dh, int block_kv,
           float scale, cudaStream_t stream) {
  // 16-byte loads where every row and base is 16-byte aligned.
  const bool wide =
      (dh * sizeof(T)) % 16 == 0 &&
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v)) % 16) == 0;
  int err;
  if (wide)
    err = launch_rows<T, 16>(dh * (int)sizeof(T) / 16, q, k, v, cur_len,
                             part, BH, smax, dh, block_kv, scale, stream);
  else
    err = launch_rows<T, (int)sizeof(T)>(dh, q, k, v, cur_len, part, BH,
                                         smax, dh, block_kv, scale, stream);
  if (err != 0) return err;
  decode_combine_kernel<T><<<BH, 128, 0, stream>>>(
      part, static_cast<T*>(out), smax / block_kv, dh);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches both kernels on `stream`; returns cudaGetLastError() (0 on
// success).  q is (BH, dh), k and v (BH, smax, dh), out (BH, dh), one dtype
// (0: float32, 1: bfloat16); cur_len points at one int32 on the device;
// part is f32 scratch of BH * (smax / block_kv) * (dh + 2) words.  Requires
// smax % block_kv == 0 and 1 <= dh <= 256.
extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, const int* cur_len,
                                   float* part, void* out, int BH, int smax,
                                   int dh, int block_kv, float scale,
                                   int dtype, void* stream) {
  if (BH <= 0) return 0;
  if (block_kv <= 0 || smax <= 0 || smax % block_kv != 0 || dh < 1 ||
      dh > kMaxHeadDim || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, cur_len, part, out, BH, smax, dh,
                         block_kv, scale, s);
  return launch<__nv_bfloat16>(q, k, v, cur_len, part, out, BH, smax, dh,
                               block_kv, scale, s);
}

extern "C" const char* flash_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
