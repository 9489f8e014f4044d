// UCP Lookahead greedy (paper §3.2.1) for Hopper: one thread block per row.
//
// Replaces the Pallas kernel `lookahead_greedy_rows` (body
// `_lookahead_kernel`) in src/repro/kernels/lookahead_greedy/kernel.py.
// For each row b of a batch of utility curves (B, n, U+1) it runs the
// greedy of that kernel: every trip takes the best step (client i, k
// units) by marginal utility (c_i[a_i + k] - c_i[a_i]) / k over the active
// clients with k <= min(balance, remaining - a_i); ties go to the smallest
// k, then to the lowest client.  A trip whose best marginal utility is not
// positive retires the row.  It returns the allocation and the leftover
// balance; the zero-utility spread stays with the caller
// (repro_torch.core.cache_controller._zero_spread), as on the TPU.
//
// Bit parity with the Pallas kernel and its numpy oracle is the contract:
//   * mu is computed as (c[a+k] - c[a]) / (double)k: an IEEE division, no
//     reciprocal multiply;
//   * build without -use_fast_math;
//   * the reduction keeps the first maximum: (mu, i*U + k-1) pairs compare
//     by mu, then by the smaller flat index, which is the smaller client
//     and, within it, the smaller k.
//
// What bounds it on an H100: the row's curve is read from device memory
// once (n*(U+1)*8 bytes, 32.9 KB at n=16, U=256) and then lives in shared
// memory, so the bytes are small; the work is the f64 divisions, one per
// candidate step of every trip the row needs (up to U+1 trips of n*U
// candidates).  The design spends the block's 256 threads on those
// candidates (16 each at n=16, U=256), reads both curve points from shared
// memory, and reduces with warp shuffles, so a trip costs two block
// barriers and no device-memory traffic.  Rows are independent, so B
// blocks fill the SMs for the batch sizes of a sweep (B = G * mixes).
//
// Inputs must be finite curves, 0 <= min_units and n*min_units <= U; for
// memory safety a step never reads past column min(remaining, U).

#include <cuda_runtime.h>

#include <climits>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ bool better(double mu_a, int f_a, double mu_b,
                                       int f_b) {
  return mu_a > mu_b || (mu_a == mu_b && f_a < f_b);
}

__device__ __forceinline__ void warp_argmax(double& mu, int& f) {
  for (int off = 16; off > 0; off >>= 1) {
    const double o_mu = __shfl_down_sync(0xffffffffu, mu, off);
    const int o_f = __shfl_down_sync(0xffffffffu, f, off);
    if (better(o_mu, o_f, mu, f)) {
      mu = o_mu;
      f = o_f;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
lookahead_greedy_kernel(const double* __restrict__ curves,
                        const int* __restrict__ min_units,
                        const int* __restrict__ active,
                        const int* __restrict__ remaining,
                        int* __restrict__ alloc_out,
                        int* __restrict__ balance_out, int n, int U) {
  extern __shared__ double smem[];
  const int U1 = U + 1;
  double* curve = smem;                                            // n*(U+1)
  int* s_alloc = reinterpret_cast<int*>(curve + (size_t)n * U1);   // n
  int* s_cap = s_alloc + n;                                        // n
  int* s_active = s_cap + n;                                       // n
  __shared__ double warp_mu[kWarps];
  __shared__ int warp_f[kWarps];
  __shared__ int s_balance;
  __shared__ int s_stuck;

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const double* src = curves + (size_t)row * n * U1;
  for (int j = tid; j < n * U1; j += kThreads) curve[j] = src[j];
  const int min_u = min_units[row];
  const int top = min(remaining[row], U);
  for (int i = tid; i < n; i += kThreads) {
    s_alloc[i] = min_u;
    s_active[i] = active[(size_t)row * n + i] != 0;
  }
  if (tid == 0) {
    s_balance = U - n * min_u;
    s_stuck = 0;
  }
  __syncthreads();

  const int n_cand = n * U;
  // Each trip allocates >= 1 unit or retires the row: <= U + 1 trips.
  for (int trip = 0; trip <= U; ++trip) {
    const int balance = s_balance;  // block-uniform: read after a barrier
    if (balance <= 0 || s_stuck) break;
    for (int i = tid; i < n; i += kThreads) {
      const int a = s_alloc[i];
      s_cap[i] = (s_active[i] && a >= 0) ? min(balance, top - a) : 0;
    }
    __syncthreads();

    double best_mu = -CUDART_INF;
    int best_f = INT_MAX;
    for (int f = tid; f < n_cand; f += kThreads) {  // f rises: first max
      const int i = f / U;
      const int k = f - i * U + 1;
      if (k <= s_cap[i]) {
        const double* c = curve + (size_t)i * U1 + s_alloc[i];
        const double mu = (c[k] - c[0]) / (double)k;
        if (mu > best_mu) {
          best_mu = mu;
          best_f = f;
        }
      }
    }
    warp_argmax(best_mu, best_f);
    if (lane == 0) {
      warp_mu[warp] = best_mu;
      warp_f[warp] = best_f;
    }
    __syncthreads();
    if (warp == 0) {
      best_mu = lane < kWarps ? warp_mu[lane] : -CUDART_INF;
      best_f = lane < kWarps ? warp_f[lane] : INT_MAX;
      warp_argmax(best_mu, best_f);
      if (lane == 0) {
        if (best_mu > 0.0) {
          const int i = best_f / U;
          const int k = best_f - i * U + 1;
          s_alloc[i] += k;
          s_balance = balance - k;
        } else {
          s_stuck = 1;
        }
      }
    }
    __syncthreads();
  }
  for (int i = tid; i < n; i += kThreads)
    alloc_out[(size_t)row * n + i] = s_alloc[i];
  if (tid == 0) balance_out[row] = s_balance;
}

}  // namespace

// Launches the kernel on `stream` over B rows; returns cudaGetLastError()
// (0 on success).  Pointers are device pointers; curves is (B, n, U+1)
// float64, min_units and remaining (B,) int32, active (B, n) int32, alloc
// (B, n) int32 and balance (B,) int32, all C-contiguous.
extern "C" int lookahead_greedy_launch(const double* curves,
                                       const int* min_units,
                                       const int* active,
                                       const int* remaining, int* alloc,
                                       int* balance, int B, int n, int U,
                                       void* stream) {
  if (B <= 0) return 0;
  const size_t smem =
      (size_t)n * (U + 1) * sizeof(double) + 3 * (size_t)n * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lookahead_greedy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  lookahead_greedy_kernel<<<B, kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      curves, min_units, active, remaining, alloc, balance, n, U);
  return (int)cudaGetLastError();
}

extern "C" const char* lookahead_greedy_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
