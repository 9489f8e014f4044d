// UCP Lookahead greedy (paper §3.2.1) for Hopper: one warp per row, each
// client's best step cached between trips.
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
//   * within a client the first maximum goes to the smallest k, across
//     clients to the lowest index.
//
// What bounds it on an H100: neither bytes nor the FP64 rate but the
// latency of the trips, each a chain of shared-memory reads, f64
// divisions and warp reductions.  A row is up to U+1 serial trips (192 on
// the sweep's ATD curves at n=16, U=256), and rows can only run side by
// side as far as their curves fit in shared memory (32.9 KB a row there).
// The Pallas kernel recomputes all n*U candidates every trip; on the card
// that cost a 256-thread block per row three block barriers and a
// two-level reduction a trip.
//
// The design shortens the trip.  Between trips only the stepped client's
// position changes and the balance shrinks, so every other client's cached
// first maximum (mu_i, k_i) stays exact while k_i <= min(balance,
// remaining - a_i): the argmax over a prefix that still holds the old
// argmax is unchanged (the invariant of the JAX package's `_greedy_loop`,
// src/repro/core/cache_controller_jax.py).  Each row runs on one warp:
//   * its curve is copied to shared memory once, with cp.async;
//   * the cache is filled once (n*U divisions, lanes over k);
//   * a trip picks the first maximum of the n cached entries, steps, and
//     recomputes only the stepped client and any client whose k_i no
//     longer fits its shrunken cap (lanes over k, up to min(balance,
//     remaining - a) divisions each);
//   * only a positive mu can be stepped, and positive doubles order as
//     their bit patterns, so a first maximum over the warp is three
//     hardware warp reductions of 32-bit words (the high word, the low
//     word, the least index), not five rounds of shuffles of a (double,
//     int) pair.  A client whose best mu is not positive can never step
//     again (its position stays and its cap only shrinks) and is dropped.
// A trip thus costs about U divisions and two warp reductions instead of
// n*U divisions and three block barriers.  A block holds as many rows
// (warps) as fit the SM's shared memory best (7 at n=16, U=256), warps
// share no data and never wait on each other, and the grid is one
// resident wave whose warps stride over the rows.
//
// Inputs must be finite curves, 0 <= min_units and n*min_units <= U; for
// memory safety a step never reads past column min(remaining, U).

#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <math_constants.h>
#include <mutex>

namespace {

constexpr int kMaxRowsPerBlock = 8;

// Shared memory of one row: its curve n*(U+1), then per client the cached
// best mu (double), the allocation a and the cached best k (int).  k = -1
// marks a client that can never step again: inactive, its cap reached 0,
// or its best mu not positive (caps only shrink).
__host__ __device__ inline size_t row_bytes(int n, int U) {
  const size_t b = (size_t)n * (U + 1) * sizeof(double) +
                   (size_t)n * (sizeof(double) + 2 * sizeof(int));
  return (b + 15) & ~(size_t)15;
}

// First maximum over the warp of the lanes' (mu, i), among positive mu
// only: positive doubles order as their bit patterns, so it is a maximum
// of the high words, then of the low words among the lanes that hold the
// high one, then the least i among the lanes that hold both (three warp
// reductions in hardware).  Every lane returns the winning (mu, i), or
// (-inf, -1) if no lane holds a positive mu.
__device__ __forceinline__ void first_max(double& mu, int& i) {
  const unsigned long long key =
      mu > 0.0 ? (unsigned long long)__double_as_longlong(mu) : 0ull;
  const unsigned hi = (unsigned)(key >> 32), lo = (unsigned)key;
  const unsigned top_hi = __reduce_max_sync(0xffffffffu, hi);
  const unsigned top_lo =
      __reduce_max_sync(0xffffffffu, hi == top_hi ? lo : 0u);
  const bool wins = key != 0ull && hi == top_hi && lo == top_lo;
  const unsigned top_i =
      __reduce_min_sync(0xffffffffu, wins ? (unsigned)i : 0xffffffffu);
  if ((top_hi | top_lo) == 0u) {
    mu = -CUDART_INF;
    i = -1;
  } else {
    mu = __longlong_as_double(
        (long long)(((unsigned long long)top_hi << 32) | top_lo));
    i = (int)top_i;
  }
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Client i's first maximum over k in [1, cap] (cap >= 1) from position a:
// lanes take k = lane+1, lane+33, ...; every lane returns (mu, k), or
// (-inf, -1) if no step has a positive mu.
__device__ __forceinline__ void client_best(const double* c, int cap,
                                            int lane, double& mu, int& k) {
  const double base = c[0];
  mu = -CUDART_INF;
  k = INT_MAX;
  for (int kk = lane + 1; kk <= cap; kk += 32) {  // k rises: first max
    const double m = (c[kk] - base) / (double)kk;
    if (m > mu) {
      mu = m;
      k = kk;
    }
  }
  first_max(mu, k);
}

__global__ void lookahead_greedy_kernel(const double* __restrict__ curves,
                                        const int* __restrict__ min_units,
                                        const int* __restrict__ active,
                                        const int* __restrict__ remaining,
                                        int* __restrict__ alloc_out,
                                        int* __restrict__ balance_out, int B,
                                        int n, int U) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int U1 = U + 1;
  double* curve = reinterpret_cast<double*>(smem + warp * row_bytes(n, U));
  double* s_mu = curve + (size_t)n * U1;                  // n
  int* s_alloc = reinterpret_cast<int*>(s_mu + n);        // n
  int* s_k = s_alloc + n;                                 // n

  const int warps = gridDim.x * (blockDim.x >> 5);
  for (int row = blockIdx.x * (blockDim.x >> 5) + warp; row < B;
       row += warps) {
    const double* src = curves + (size_t)row * n * U1;
    for (int j = lane; j < n * U1; j += 32) cp_async8(curve + j, src + j);
    const int min_u = min_units[row];
    const int top = min(remaining[row], U);
    int balance = U - n * min_u;
    for (int i = lane; i < n; i += 32) {
      s_alloc[i] = min_u;
      s_k[i] = (active[(size_t)row * n + i] != 0 && min_u >= 0) ? 0 : -1;
    }
    cp_async_wait_all();
    __syncwarp();

    if (balance > 0) {
      // Fill the cache: every live client's first maximum.
      for (int i = 0; i < n; ++i) {
        const int cap = min(balance, top - min_u);
        double mu = -CUDART_INF;
        int k = -1;
        if (s_k[i] >= 0 && cap > 0)
          client_best(curve + (size_t)i * U1 + min_u, cap, lane, mu, k);
        __syncwarp();
        if (lane == 0) {
          s_mu[i] = mu;
          s_k[i] = k;
        }
      }
      __syncwarp();

      // Each trip allocates >= 1 unit or retires the row: <= U + 1 trips.
      for (int trip = 0; trip <= U; ++trip) {
        double mu = -CUDART_INF;
        int i_sel = -1;
        for (int i = lane; i < n; i += 32) {  // i rises: first max
          if (s_k[i] > 0 && s_mu[i] > mu) {
            mu = s_mu[i];
            i_sel = i;
          }
        }
        first_max(mu, i_sel);
        if (i_sel < 0) break;  // no positive mu: retire the row
        const int k_sel = s_k[i_sel];
        balance -= k_sel;
        __syncwarp();
        if (lane == (i_sel & 31)) s_alloc[i_sel] += k_sel;
        if (balance <= 0) break;
        __syncwarp();

        // Refresh the stepped client and every client whose cached k no
        // longer fits its cap; the rest stay exact.
        for (int c0 = 0; c0 < n; c0 += 32) {
          const int i = c0 + lane;
          bool stale = false;
          if (i < n && s_k[i] > 0)
            stale = i == i_sel || s_k[i] > min(balance, top - s_alloc[i]);
          unsigned mask = __ballot_sync(0xffffffffu, stale);
          while (mask) {
            const int j = c0 + __ffs(mask) - 1;
            mask &= mask - 1;
            const int a = s_alloc[j];
            const int cap = min(balance, top - a);
            double mu_j = -CUDART_INF;
            int k_j = -1;
            if (cap > 0)
              client_best(curve + (size_t)j * U1 + a, cap, lane, mu_j, k_j);
            __syncwarp();
            if (lane == 0) {
              s_mu[j] = mu_j;
              s_k[j] = k_j;
            }
          }
        }
        __syncwarp();
      }
    }

    for (int i = lane; i < n; i += 32)
      alloc_out[(size_t)row * n + i] = s_alloc[i];
    if (lane == 0) balance_out[row] = balance;
    __syncwarp();  // the next row's copy overwrites this row's shared data
  }
}

// Rows per block (warps) that keep the most rows resident per SM, ties to
// fewer, for rows of `bytes` shared memory; and how many such blocks the
// card holds at once.
int compute_config(int dev, size_t bytes, int& rows, int& blocks) {
  int optin, sms;
  cudaError_t e = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  if (bytes > (size_t)optin) return (int)cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(lookahead_greedy_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           optin);
  if (e != cudaSuccess) return (int)e;
  rows = blocks = 0;
  for (int r = 1; r <= kMaxRowsPerBlock && r * bytes <= (size_t)optin; ++r) {
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, lookahead_greedy_kernel, 32 * r, r * bytes);
    if (e != cudaSuccess) return (int)e;
    if (r * per_sm > rows * (blocks / sms)) {
      rows = r;
      blocks = per_sm * sms;
    }
  }
  return blocks > 0 ? 0 : (int)cudaErrorInvalidConfiguration;
}

// compute_config, remembered per (device, row bytes).  A launch whose
// configuration is remembered makes no runtime call but cudaGetDevice and
// the launch itself, so a CUDA graph capture after a warm-up call records
// the kernel and nothing else.
struct Config {
  int dev;
  size_t bytes;
  int rows, blocks;
};
constexpr int kMaxConfigs = 64;
Config g_configs[kMaxConfigs];
int g_n_configs = 0;
std::mutex g_configs_mutex;

int configure(size_t bytes, int& rows, int& blocks) {
  int dev;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  std::lock_guard<std::mutex> lock(g_configs_mutex);
  for (int i = 0; i < g_n_configs; ++i) {
    if (g_configs[i].dev == dev && g_configs[i].bytes == bytes) {
      rows = g_configs[i].rows;
      blocks = g_configs[i].blocks;
      return 0;
    }
  }
  const int err = compute_config(dev, bytes, rows, blocks);
  if (err == 0 && g_n_configs < kMaxConfigs)
    g_configs[g_n_configs++] = {dev, bytes, rows, blocks};
  return err;
}

}  // namespace

// Launches the kernel on `stream` over B rows; returns a cudaError_t (0 on
// success).  Pointers are device pointers; curves is (B, n, U+1) float64,
// min_units and remaining (B,) int32, active (B, n) int32, alloc (B, n)
// int32 and balance (B,) int32, all C-contiguous.  One row's curve must fit
// a block's shared memory: 8*n*(U+1) + 16*n bytes <= 232,448 on an H100.
extern "C" int lookahead_greedy_launch(const double* curves,
                                       const int* min_units,
                                       const int* active,
                                       const int* remaining, int* alloc,
                                       int* balance, int B, int n, int U,
                                       void* stream) {
  if (B <= 0) return 0;
  if (n <= 0 || U <= 0) return (int)cudaErrorInvalidValue;
  const size_t bytes = row_bytes(n, U);
  int rows, blocks;
  const int err = configure(bytes, rows, blocks);
  if (err != 0) return err;
  rows = std::min(rows, B);
  blocks = std::min((B + rows - 1) / rows, blocks);
  lookahead_greedy_kernel<<<blocks, 32 * rows, rows * bytes,
                            static_cast<cudaStream_t>(stream)>>>(
      curves, min_units, active, remaining, alloc, balance, B, n, U);
  return (int)cudaGetLastError();
}

extern "C" const char* lookahead_greedy_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
