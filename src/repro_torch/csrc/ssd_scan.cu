// Mamba2 SSD chunk scan for Hopper: f32 math, output in the input dtype.
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
// Here one thread block owns one (batch, head) and walks its chunks in
// order, the state in shared memory for the whole sequence (a TPU grid
// axis carried it in VMEM scratch).  The chunk is the knob: the block
// takes it as the unit of the recurrence above, and stages its work
// through shared memory in pieces of 64 rows (i) by 64 columns (j), so a
// chunk far larger than shared memory (the planner gives 4096 at its
// default budget) needs only its two f32 vectors cs and dt resident.  The
// decay exp(cs_i - cs_j) overflows for j > i; the kernel computes it only
// for j <= i, and column pieces wholly above the diagonal are not visited.
// As in the Pallas kernel, C . B^T is recomputed for every head although B
// and C are head-shared.
//
// What bounds it on an H100: at mamba2-1.3b (2 x 4096 steps, 64 heads of
// P = 64, N = 128, f32, chunk 128) the 3.0e10 FLOP of the chunk products
// below the diagonal at the f32 rate of the CUDA cores (0.45 ms at
// 67 TFLOP/s) against 0.28 GB of inputs and output (0.08 ms): operations.
// Only B*H = 128 blocks exist, one per SM, each serial over 32 chunks;
// this first kernel does its products as f32 FMAs with 4 x 4 (G) and
// 4 x 8 (y) register tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kT = 64;           // rows (i) and columns (j) of a piece
constexpr int kMaxP = 128;       // y tile: 16 threads x 8 columns
constexpr int kStatePerThread = 32;  // P * N <= 256 * 32

__host__ __device__ inline int smem_floats(int P, int N, int L) {
  return P * (N + 1)        // state
         + 2 * L            // cs, dt of the chunk
         + 2 * kT * (N + 1) // C piece, B piece
         + kT * P           // x * dt piece
         + kT * (kT + 1);   // masked decay product G
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, T* __restrict__ out, int S, int H,
                int P, int N, int L) {
  extern __shared__ __align__(16) float smem[];
  const int nld = N + 1;
  constexpr int gld = kT + 1;
  float* St = smem;            // [P][nld]
  float* cs = St + P * nld;    // [L]
  float* dts = cs + L;         // [L]
  float* Cs = dts + L;         // [kT][nld]
  float* Bs = Cs + kT * nld;   // [kT][nld]
  float* Xs = Bs + kT * nld;   // [kT][P]
  float* Gs = Xs + kT * P;     // [kT][gld]

  const int g = blockIdx.x;
  const int bi = g / H, hi = g % H;
  const float a = A[hi];
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int PN = P * N;
  const size_t row_bn = (size_t)bi * S;  // first step of this batch row

  for (int e = tid; e < P * nld; e += kThreads) St[e] = 0.f;

  // x_t dt_t of steps c0 + j0 .. c0 + j0 + tj into Xs; B of those steps,
  // times `decay_to` (cs_last - cs_j) when asked, into Bs.
  auto stage_bx = [&](int c0, int j0, int tj, bool decay_to_end) {
    const float cl = cs[L - 1];
    for (int e = tid; e < kT * N; e += kThreads) {
      const int r = e / N, n = e % N;
      float bv = 0.f;
      if (r < tj) {
        bv = to_f32(Bm[(row_bn + c0 + j0 + r) * N + n]);
        if (decay_to_end) bv *= expf(cl - cs[j0 + r]);
      }
      Bs[r * nld + n] = bv;
    }
    for (int e = tid; e < kT * P; e += kThreads) {
      const int r = e / P, p = e % P;
      Xs[e] = r < tj ? to_f32(x[((row_bn + c0 + j0 + r) * H + hi) * P + p]) *
                           dts[j0 + r]
                     : 0.f;
    }
  };

  for (int c0 = 0; c0 < S; c0 += L) {
    __syncthreads();  // the previous chunk is done with cs, dts and St
    for (int t = tid; t < L; t += kThreads)
      dts[t] = to_f32(dt[(row_bn + c0 + t) * H + hi]);
    __syncthreads();
    if (tid == 0) {  // inclusive cumsum of dA, in order
      float run = 0.f;
      for (int t = 0; t < L; ++t) {
        run += dts[t] * a;
        cs[t] = run;
      }
    }
    __syncthreads();

    for (int i0 = 0; i0 < L; i0 += kT) {
      const int ti = min(kT, L - i0);
      for (int e = tid; e < kT * N; e += kThreads) {
        const int r = e / N, n = e % N;
        Cs[r * nld + n] =
            r < ti ? to_f32(Cm[(row_bn + c0 + i0 + r) * N + n]) : 0.f;
      }
      float y[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) y[i][c] = 0.f;

      // Intra-chunk: column pieces up to the diagonal.
      for (int j0 = 0; j0 < i0 + ti; j0 += kT) {
        const int tj = min(kT, L - j0);
        __syncthreads();  // Cs staged; Bs/Xs/Gs free
        stage_bx(c0, j0, tj, false);
        __syncthreads();
        float gacc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) gacc[i][j] = 0.f;
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = Cs[(ty * 4 + i) * nld + n];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = Bs[(tx + 16 * j) * nld + n];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) gacc[i][j] += cv[i] * bv[j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int ri = ty * 4 + i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int cj = tx + 16 * j;
            const bool live = ri < ti && cj < tj && j0 + cj <= i0 + ri;
            Gs[ri * gld + cj] =
                live ? gacc[i][j] * expf(cs[i0 + ri] - cs[j0 + cj]) : 0.f;
          }
        }
        __syncthreads();
        for (int jj = 0; jj < tj; ++jj) {
          float gv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) gv[i] = Gs[(ty * 4 + i) * gld + jj];
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const int p = tx + 16 * c;
            if (p < P) {
              const float xv = Xs[jj * P + p];
#pragma unroll
              for (int i = 0; i < 4; ++i) y[i][c] += gv[i] * xv;
            }
          }
        }
      }

      // Inter-chunk: the carried state, decayed to each step; store y.
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ri = ty * 4 + i;
        if (ri >= ti) continue;
        const float sdec = expf(cs[i0 + ri]);
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int p = tx + 16 * c;
          if (p >= P) continue;
          float inter = 0.f;
          for (int n = 0; n < N; ++n)
            inter += Cs[ri * nld + n] * St[p * nld + n];
          store_as(&out[((row_bn + c0 + i0 + ri) * H + hi) * P + p],
                   y[i][c] + inter * sdec);
        }
      }
      __syncthreads();  // Cs is restaged by the next row piece
    }

    // State update: each thread owns entries tid + 256 r of the (P, N) state.
    float contrib[kStatePerThread];
#pragma unroll
    for (int r = 0; r < kStatePerThread; ++r) contrib[r] = 0.f;
    for (int j0 = 0; j0 < L; j0 += kT) {
      const int tj = min(kT, L - j0);
      __syncthreads();
      stage_bx(c0, j0, tj, true);
      __syncthreads();
#pragma unroll
      for (int r = 0; r < kStatePerThread; ++r) {
        const int e = tid + kThreads * r;
        if (e < PN) {
          const int p = e / N, n = e - (e / N) * N;
          float s = 0.f;
          for (int jj = 0; jj < tj; ++jj)
            s += Xs[jj * P + p] * Bs[jj * nld + n];
          contrib[r] += s;
        }
      }
    }
    const float total = expf(cs[L - 1]);
#pragma unroll
    for (int r = 0; r < kStatePerThread; ++r) {
      const int e = tid + kThreads * r;
      if (e < PN) {
        const int p = e / N, n = e - (e / N) * N;
        St[p * nld + n] = total * St[p * nld + n] + contrib[r];
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* dt, const float* A, const void* Bm,
           const void* Cm, void* out, int batch, int S, int H, int P, int N,
           int L, cudaStream_t stream) {
  const int smem = smem_floats(P, N, L) * (int)sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  ssd_scan_kernel<T><<<batch * H, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), A,
      static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      static_cast<T*>(out), S, H, P, N, L);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory (bytes) of a launch with these sizes.
extern "C" int ssd_scan_smem_bytes(int P, int N, int chunk) {
  return smem_floats(P, N, chunk) * (int)sizeof(float);
}

// Launches on `stream`; returns cudaGetLastError() (0 on success).  x is
// (batch, S, H, P), dt (batch, S, H), Bm and Cm (batch, S, N), out like x,
// all C-contiguous device pointers of one dtype (0: float32, 1: bfloat16);
// A is (H,) float32.  Requires S % chunk == 0, P <= 128 and P * N <= 8192.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const float* A,
                               const void* Bm, const void* Cm, void* out,
                               int batch, int S, int H, int P, int N,
                               int chunk, int dtype, void* stream) {
  if (batch <= 0 || H <= 0 || S <= 0) return 0;
  if (chunk <= 0 || S % chunk != 0 || P < 1 || P > kMaxP || N < 1 ||
      P * N > kThreads * kStatePerThread || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, dt, A, Bm, Cm, out, batch, S, H, P, N, chunk, s);
  return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, out, batch, S, H, P, N,
                               chunk, s);
}

extern "C" const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
