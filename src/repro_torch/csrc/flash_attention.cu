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
// Here a thread block owns the block_q query rows of one (batch, head),
// the extent the knob gives it, and walks them in sub-tiles of at most 64
// rows.  For each sub-tile it strides the keys in steps of block_kv, in
// order, staging each step through shared memory in pieces of at most 64
// keys (K and V converted to f32).  A piece that lies wholly above the
// causal diagonal is skipped: its scores would all be NEG_INF, which adds
// exactly nothing once a row has seen key 0, and key 0 is in the first
// piece.  So any knobs the planner gives (up to 4096 x 4096 at its default
// budget) run in the same shared memory: the knobs set the work a block
// owns and its order, not the size of what is staged.
//
// Shared memory: Q sub-tile, K piece and V piece (64 x Dh f32 each, K and Q
// with an odd row stride), the 64 x 64 score/probability tile and the row
// statistics: 116 KB at Dh = 128 (Dh <= 128).
//
// What bounds it on an H100: at qwen3-8b prefill (1 x 32 x 4096 x 128,
// bf16, causal) the ~1.4e11 FLOP of the two products at the bf16
// tensor-core rate (~0.14 ms) against 0.13 GB of q/k/v/out: operations.
// This first kernel does the products as f32 FMAs on the CUDA cores, a
// 4 x 4 (scores) and 4 x 8 (output) register tile per thread; tensor cores
// (wgmma) and TMA-fed pipelines are a later PR's work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;     // query rows of a sub-tile, keys of a piece
constexpr int kMaxDh = 128;
constexpr float kNegInf = -1e30f;

__host__ __device__ inline int smem_floats(int dh) {
  return kTile * (dh + 1)       // Q sub-tile
         + kTile * (dh + 1)     // K piece
         + kTile * dh           // V piece
         + kTile * (kTile + 1)  // scores / probabilities
         + 3 * kTile;           // m, l, alpha per row
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int Sq,
                       int Sk, int dh, int block_q, int block_kv, int causal,
                       float scale) {
  extern __shared__ __align__(16) float smem[];
  const int ld = dh + 1;
  float* Qs = smem;                 // [kTile][ld]
  float* Ks = Qs + kTile * ld;      // [kTile][ld]
  float* Vs = Ks + kTile * ld;      // [kTile][dh]
  float* Ps = Vs + kTile * dh;      // [kTile][kTile + 1]
  float* m_s = Ps + kTile * (kTile + 1);
  float* l_s = m_s + kTile;
  float* a_s = l_s + kTile;
  constexpr int pld = kTile + 1;

  const int g = blockIdx.x;   // (batch, head)
  const int qi = blockIdx.y;  // block of block_q query rows
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const size_t q_base = (size_t)g * Sq * dh;
  const size_t kv_base = (size_t)g * Sk * dh;
  const int qb0 = qi * block_q;
  const int qb_last = qb0 + block_q - 1;
  const int n_kv = Sk / block_kv;

  for (int q0 = qb0; q0 <= qb_last; q0 += kTile) {
    const int qt = min(kTile, qb_last + 1 - q0);
    for (int e = tid; e < kTile * dh; e += kThreads) {
      const int r = e / dh, d = e % dh;
      Qs[r * ld + d] = r < qt ? to_f32(q[q_base + (size_t)(q0 + r) * dh + d])
                              : 0.f;
    }
    if (tid < kTile) {
      m_s[tid] = kNegInf;
      l_s[tid] = 0.f;
    }
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
    const int q_last = q0 + qt - 1;

    for (int kj = 0; kj < n_kv; ++kj) {
      const int kb0 = kj * block_kv;
      if (causal && kb0 > qb_last) break;  // the Pallas kernel's block skip
      const int kb_end = kb0 + block_kv;
      for (int k0 = kb0; k0 < kb_end; k0 += kTile) {
        if (causal && k0 > q_last) break;  // piece wholly above the diagonal
        const int kt = min(kTile, kb_end - k0);
        __syncthreads();  // previous piece (and Q staging) finished
        for (int e = tid; e < kt * dh; e += kThreads) {
          const int r = e / dh, d = e % dh;
          const size_t src = kv_base + (size_t)(k0 + r) * dh + d;
          Ks[r * ld + d] = to_f32(k[src]);
          Vs[r * dh + d] = to_f32(v[src]);
        }
        __syncthreads();
        // Scores: rows ty*4+i, keys tx+16j.
        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
        for (int d = 0; d < dh; ++d) {
          float qv[4], kv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * ld + d];
#pragma unroll
          for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * ld + d];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] += qv[i] * kv[j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qpos = q0 + ty * 4 + i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int col = tx + 16 * j;
            float val = s[i][j] * scale;
            if (causal && k0 + col > qpos) val = kNegInf;
            if (col >= kt) val = -INFINITY;  // past the step: contributes 0
            Ps[(ty * 4 + i) * pld + col] = val;
          }
        }
        __syncthreads();
        // Online softmax: four threads per row, 16 keys each.
        {
          const int row = tid / 4, part = tid % 4;
          float* prow = Ps + row * pld + part * 16;
          float mx = -INFINITY;
#pragma unroll
          for (int j = 0; j < 16; ++j) mx = fmaxf(mx, prow[j]);
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_prev = m_s[row];
          const float m_new = fmaxf(m_prev, mx);
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const float p = expf(prow[j] - m_new);
            prow[j] = p;
            sum += p;
          }
          sum += __shfl_xor_sync(0xffffffffu, sum, 1);
          sum += __shfl_xor_sync(0xffffffffu, sum, 2);
          __syncwarp();
          if (part == 0) {
            const float alpha = expf(m_prev - m_new);
            l_s[row] = l_s[row] * alpha + sum;
            m_s[row] = m_new;
            a_s[row] = alpha;
          }
        }
        __syncthreads();
        // acc = acc * alpha + P @ V: rows ty*4+i, dims tx+16c.
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float alpha = a_s[ty * 4 + i];
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[i][c] *= alpha;
        }
        for (int j = 0; j < kt; ++j) {
          float pv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * pld + j];
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const int d = tx + 16 * c;
            if (d < dh) {
              const float vv = Vs[j * dh + d];
#pragma unroll
              for (int i = 0; i < 4; ++i) acc[i][c] += pv[i] * vv;
            }
          }
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      if (r >= qt) continue;
      const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int d = tx + 16 * c;
        if (d < dh)
          store_as(&out[q_base + (size_t)(q0 + r) * dh + d], acc[i][c] / l);
      }
    }
    __syncthreads();  // m_s/l_s and Qs are reset for the next sub-tile
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int BH,
           int Sq, int Sk, int dh, int block_q, int block_kv, int causal,
           float scale, cudaStream_t stream) {
  const int smem = smem_floats(dh) * (int)sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(BH, Sq / block_q);
  flash_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, dh, block_q,
      block_kv, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).  q is
// (BH, Sq, dh), k and v (BH, Sk, dh), out (BH, Sq, dh), C-contiguous
// device pointers of one dtype (0: float32, 1: bfloat16).  Requires
// Sq % block_q == 0, Sk % block_kv == 0 and 1 <= dh <= 128 (checked by the
// Python wrapper; refused here with cudaErrorInvalidValue).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int BH,
                                      int Sq, int Sk, int dh, int block_q,
                                      int block_kv, int causal, float scale,
                                      int dtype, void* stream) {
  if (BH <= 0 || Sq <= 0) return 0;
  if (block_q <= 0 || block_kv <= 0 || Sk <= 0 || Sq % block_q != 0 ||
      Sk % block_kv != 0 || dh < 1 || dh > kMaxDh ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, out, BH, Sq, Sk, dh, block_q, block_kv,
                         causal, scale, s);
  return launch<__nv_bfloat16>(q, k, v, out, BH, Sq, Sk, dh, block_q,
                               block_kv, causal, scale, s);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
