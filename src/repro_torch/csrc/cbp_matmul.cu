// CBP blocked matmul for Hopper: (M, K) @ (K, N) with planner-chosen
// block knobs, f32 accumulation, output in the input dtype.
//
// Replaces the Pallas kernel `cbp_matmul` (body `_mm_kernel`) in
// src/repro/kernels/cbp_matmul/kernel.py.  There the grid (m, n, k) walks
// (block_m x block_n) output tiles with an f32 accumulator carried in VMEM
// across the k steps of block_k, after zero-padding the operands to the
// block multiple.  Here:
//
//   * a thread block owns one (block_m x block_n) output region, the extent
//     the knobs give it, and walks it in (<= 64 x 64) sub-tiles; a sub-tile's
//     f32 accumulator lives in registers (4 x 4 per thread) for the whole k
//     range, which the block strides in steps of block_k, staging each step
//     through shared memory in pieces of at most 32 columns of A / rows of B
//     (stored in the input dtype).  So knobs far larger than shared memory
//     (the planner gives up to 4096 x 6144 x 4096 at its default budget) run
//     unchanged: they only set how much work one block owns and how it walks;
//   * the ragged edge is masked in the kernel (bounds checks on every load
//     and store) instead of padding the operands.
//
// Dynamic shared memory, the quantity the planner partitions
// (`smem_footprint_bytes` on the Python side, `cbp_matmul_smem_bytes`
// here): kc * ((sub_m + 1) + sub_n) elements of the input dtype with
// sub_m = min(block_m, 64), sub_n = min(block_n, 64), kc = min(block_k, 32);
// the launcher refuses a launch whose passed size differs.
//
// What bounds it on an H100: at the qwen3-8b FFN shape (4096 x 4096 @
// 4096 x 12288, bf16) the 4.1e11 FLOP at the bf16 tensor-core rate
// (0.42 ms) against 0.23 GB of operands (0.07 ms): operations.  This first
// kernel does its multiply-adds as f32 FMAs on the CUDA cores (no wgmma, no
// TMA), so it is far from that bound; tensor cores are a later PR's work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSub = 64;    // output sub-tile edge; 16 x 16 threads of 4 x 4
constexpr int kChunk = 32;  // k extent staged through shared memory at once

__host__ __device__ inline int smem_elems(int block_m, int block_n,
                                          int block_k) {
  const int sub_m = block_m < kSub ? block_m : kSub;
  const int sub_n = block_n < kSub ? block_n : kSub;
  const int kc = block_k < kChunk ? block_k : kChunk;
  return kc * ((sub_m + 1) + sub_n);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
cbp_matmul_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  T* __restrict__ out, int M, int N, int K, int block_m,
                  int block_n, int block_k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int sub_m = min(block_m, kSub);
  const int sub_n = min(block_n, kSub);
  const int kc = min(block_k, kChunk);
  const int a_ld = sub_m + 1;  // odd stride: conflict-free transposed stores
  T* As = reinterpret_cast<T*>(smem_raw);  // [kc][a_ld], A piece transposed
  T* Bs = As + kc * a_ld;                  // [kc][sub_n]

  const int tid = threadIdx.x;
  const int ty = tid / 16;  // rows ty*4 .. ty*4+3 of the sub-tile
  const int tx = tid % 16;  // cols tx, tx+16, tx+32, tx+48
  const long m0 = (long)blockIdx.y * block_m;
  const long n0 = (long)blockIdx.x * block_n;
  const long m_end = min(m0 + block_m, (long)M);
  const long n_end = min(n0 + block_n, (long)N);

  for (long sm = m0; sm < m_end; sm += sub_m) {
    const int rows = (int)min((long)sub_m, m_end - sm);
    for (long sn = n0; sn < n_end; sn += sub_n) {
      const int cols = (int)min((long)sub_n, n_end - sn);
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

      for (long k0 = 0; k0 < K; k0 += block_k) {
        const long k_end = min(k0 + block_k, (long)K);
        for (long kk = k0; kk < k_end; kk += kc) {
          const int kw = (int)min((long)kc, k_end - kk);
          // A piece (rows x kw), read along k (coalesced), stored [k][row].
          for (int e = tid; e < sub_m * kc; e += kThreads) {
            const int r = e / kc, c = e % kc;
            const bool ok = r < rows && c < kw;
            As[c * a_ld + r] = ok ? a[(sm + r) * K + kk + c] : T(0.f);
          }
          // B piece (kw x cols), read along n (coalesced), stored [k][col].
          for (int e = tid; e < kc * sub_n; e += kThreads) {
            const int r = e / sub_n, c = e % sub_n;
            const bool ok = r < kw && c < cols;
            Bs[r * sub_n + c] = ok ? b[(kk + r) * N + sn + c] : T(0.f);
          }
          __syncthreads();
          for (int c = 0; c < kw; ++c) {
            float av[4], bv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int r = ty * 4 + i;
              av[i] = r < sub_m ? to_f32(As[c * a_ld + r]) : 0.f;
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int q = tx + 16 * j;
              bv[j] = q < sub_n ? to_f32(Bs[c * sub_n + q]) : 0.f;
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
          }
          __syncthreads();
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        if (r >= rows) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int q = tx + 16 * j;
          if (q < cols) store_as(&out[(sm + r) * N + sn + q], acc[i][j]);
        }
      }
    }
  }
}

template <typename T>
int launch(const void* a, const void* b, void* out, int M, int N, int K,
           int block_m, int block_n, int block_k, int smem,
           cudaStream_t stream) {
  const dim3 grid((N + block_n - 1) / block_n, (M + block_m - 1) / block_m);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        cbp_matmul_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  cbp_matmul_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<T*>(out), M, N, K, block_m, block_n, block_k);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory (bytes) the kernel needs for these knobs and an
// input element of `dtype_bytes` bytes.
extern "C" int cbp_matmul_smem_bytes(int block_m, int block_n, int block_k,
                                     int dtype_bytes) {
  return smem_elems(block_m, block_n, block_k) * dtype_bytes;
}

// Launches on `stream`; returns cudaGetLastError() (0 on success).  a is
// (M, K), b (K, N), out (M, N), all C-contiguous device pointers of one
// dtype (0: float32, 1: bfloat16).  `smem` must equal
// cbp_matmul_smem_bytes(...) for these knobs, else cudaErrorInvalidValue.
extern "C" int cbp_matmul_launch(const void* a, const void* b, void* out,
                                 int M, int N, int K, int block_m,
                                 int block_n, int block_k, int dtype,
                                 int smem, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return 0;
  if (block_m <= 0 || block_n <= 0 || block_k <= 0 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int bytes = dtype == 0 ? 4 : 2;
  if (smem != cbp_matmul_smem_bytes(block_m, block_n, block_k, bytes))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(a, b, out, M, N, K, block_m, block_n, block_k,
                         smem, s);
  return launch<__nv_bfloat16>(a, b, out, M, N, K, block_m, block_n, block_k,
                               smem, s);
}

extern "C" const char* cbp_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
