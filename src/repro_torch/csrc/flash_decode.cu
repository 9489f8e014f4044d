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
// Here the kv axis is split across thread blocks (a TPU grid axis runs in
// order; CUDA blocks do not): block (j, g) owns kv block j of (batch, head)
// g, the extent the knob gives it.  It reads cur_len from device memory
// (no host synchronisation); if j * block_kv >= cur_len it writes the
// neutral partial (m = -1e30, l = 0, acc = 0) and exits without touching
// the cache, which is the Pallas kernel's skip.  Otherwise its eight warps
// stride the block's keys below cur_len: a warp holds q in registers
// (dims lane + 32c), reduces each score with shuffles and keeps its own
// online softmax; the warps merge in shared memory into one partial
// (m, l, acc[Dh]) in f32 scratch.  A second kernel merges the partials of
// each (batch, head) in kv order and divides.  Positions past cur_len
// inside a block are not read: their NEG_INF scores add exactly nothing
// once the block has one live key, which every processed block has.
//
// What bounds it on an H100: bytes.  At qwen3-8b decode (8 x 32 heads, a
// 8192 x 128 bf16 cache) the live part of the two caches, 1.07 GB at
// cur_len = 8192, streams once: 0.32 ms at 3.35 TB/s; the arithmetic is
// ~2 FLOP per byte.  The split over kv blocks (16,384 blocks at
// block_kv = 128) keeps every SM streaming; the partials add
// B*H*(Smax/block_kv)*(Dh + 2) f32 words (8.5 MB there).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPerLane = 8;  // dims per lane: Dh <= 256
constexpr float kNegInf = -1e30f;

// Partial of block (j, g) at part + (g * n_blk + j) * (dh + 2):
// [m, l, acc[0..dh)].
template <typename T, int PER_LANE>
__global__ void __launch_bounds__(kThreads)
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v,
                      const int* __restrict__ cur_len_ptr,
                      float* __restrict__ part, int smax, int dh,
                      int block_kv, float scale) {
  __shared__ float w_m[kWarps];
  __shared__ float w_l[kWarps];
  __shared__ float w_acc[kWarps][32 * PER_LANE];
  const int j = blockIdx.x;
  const int g = blockIdx.y;
  const int n_blk = gridDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float* dst = part + ((size_t)g * n_blk + j) * (dh + 2);
  const int cur_len = *cur_len_ptr;
  const int start = j * block_kv;
  if (start >= cur_len) {  // wholly past cur_len: neutral partial
    for (int d = tid; d < dh + 2; d += kThreads)
      dst[d] = d == 0 ? kNegInf : 0.f;
    return;
  }
  const int end = min(start + block_kv, cur_len);

  float qr[PER_LANE], acc[PER_LANE];
#pragma unroll
  for (int c = 0; c < PER_LANE; ++c) {
    const int d = lane + 32 * c;
    qr[c] = d < dh ? to_f32(q[(size_t)g * dh + d]) : 0.f;
    acc[c] = 0.f;
  }
  float m = kNegInf, l = 0.f;
  const size_t base = (size_t)g * smax * dh;
  for (int key = start + warp; key < end; key += kWarps) {
    const T* krow = k + base + (size_t)key * dh;
    const T* vrow = v + base + (size_t)key * dh;
    float vv[PER_LANE];
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < PER_LANE; ++c) {
      const int d = lane + 32 * c;
      const bool ok = d < dh;
      s += ok ? qr[c] * to_f32(krow[d]) : 0.f;
      vv[c] = ok ? to_f32(vrow[d]) : 0.f;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    s *= scale;
    const float m_new = fmaxf(m, s);
    const float alpha = expf(m - m_new);
    const float p = expf(s - m_new);
    l = l * alpha + p;
#pragma unroll
    for (int c = 0; c < PER_LANE; ++c) acc[c] = acc[c] * alpha + p * vv[c];
    m = m_new;
  }
  if (lane == 0) {
    w_m[warp] = m;
    w_l[warp] = l;
  }
#pragma unroll
  for (int c = 0; c < PER_LANE; ++c) w_acc[warp][lane + 32 * c] = acc[c];
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
    for (int j = 0; j < n_blk; ++j) {
      const float* p = src + (size_t)j * (dh + 2);
      const float f = expf(p[0] - mx);
      l += f * p[1];
      acc += f * p[2 + d];
    }
    store_as(&out[(size_t)g * dh + d], acc / fmaxf(l, 1e-30f));
  }
}

template <typename T, int PER_LANE>
int launch_partial(const void* q, const void* k, const void* v,
                   const int* cur_len, float* part, int BH, int smax, int dh,
                   int block_kv, float scale, cudaStream_t stream) {
  const dim3 grid(smax / block_kv, BH);
  decode_partial_kernel<T, PER_LANE><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), cur_len, part, smax, dh, block_kv, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* cur_len,
           float* part, void* out, int BH, int smax, int dh, int block_kv,
           float scale, cudaStream_t stream) {
  int err;
  if (dh <= 32)
    err = launch_partial<T, 1>(q, k, v, cur_len, part, BH, smax, dh,
                               block_kv, scale, stream);
  else if (dh <= 64)
    err = launch_partial<T, 2>(q, k, v, cur_len, part, BH, smax, dh,
                               block_kv, scale, stream);
  else if (dh <= 128)
    err = launch_partial<T, 4>(q, k, v, cur_len, part, BH, smax, dh,
                               block_kv, scale, stream);
  else
    err = launch_partial<T, kMaxPerLane>(q, k, v, cur_len, part, BH, smax,
                                         dh, block_kv, scale, stream);
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
      dh > 32 * kMaxPerLane || (dtype != 0 && dtype != 1))
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
