// Dense matrix product for Hopper (sm_90a):
//   C = A @ B,   A (M, K), B (K, N), C (M, N) row-major,
// accumulated in the operands' own type (float32 or float64).
//
// Replaces: src/repro/kernels/power.py matmul_kernel (launched by
// matmul_pallas), the A @ Q step of ops.power_iteration_lambda2: lambda_2 of
// the Laplacian by deflated block power iteration, the spectral bound on
// bisection width.
//
// What bounds it on the H100: bytes.  On its path the product is skinny:
// A is the N x N 0/1 adjacency, B a block of 8 iteration vectors.  At
// N = 8192 that reads 268.4 MB of A for 0.54 G fused multiply-adds, so the
// least time is 0.080 ms at 3.35 TB/s, against 0.016 ms at the FP32 issue
// rate.  Tensor cores would not help a product this skinny; moving A's bytes
// is the whole cost.
//
// Design (simple first): each block owns a 64 x 64 output tile and loops
// over the WHOLE K range inside the block, staging 64 x 32 tiles of A
// (stored transposed) and 32 x 64 tiles of B in shared memory; each of the
// 256 threads keeps a 4 x 4 register accumulator (rows ty + 16 i, columns
// tx + 16 j: conflict-free shared reads, coalesced stores).  The Pallas
// kernel carried its accumulator across sequential K grid steps; here the K
// loop is inside the block, so blocks are independent and there is no
// split-K and no atomic: every output is summed by one thread in k order, an
// order fixed by position alone, so the result is the same on every run.
// Out-of-range elements load as 0, so ragged shapes need no padding copies.
// The kernel takes each operand's element strides, so the column-major Q
// that torch.linalg.qr returns is read in place without a copy.
//
// Known cost of that simplicity: at N = 8 columns a 64-wide output tile
// leaves 56 of its 64 columns idle, and only M / 64 blocks (128 at
// N = 8192) stream A, one per SM.  Row-band blocks sized to the narrow B,
// cp.async / TMA streaming of A, and fewer bits for a 0/1 adjacency are the
// named next steps.
#include <cuda_runtime.h>

namespace {

constexpr int TM = 64;
constexpr int TN = 64;
constexpr int TK = 32;
constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
matmul_kernel(const T* __restrict__ A, const T* __restrict__ B,
              T* __restrict__ C, int M, int N, int K, long long sa0,
              long long sa1, long long sb0, long long sb1) {
  __shared__ T As[TK][TM + 1];  // A tile, transposed: As[k][m]
  __shared__ T Bs[TK][TN];
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int row0 = blockIdx.y * TM;
  const int col0 = blockIdx.x * TN;

  T acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = T(0);

  for (int k0 = 0; k0 < K; k0 += TK) {
    for (int e = threadIdx.x; e < TM * TK; e += THREADS) {
      const int m = e / TK;
      const int k = e % TK;
      const int gr = row0 + m;
      const int gk = k0 + k;
      As[k][m] = (gr < M && gk < K) ? A[gr * sa0 + gk * sa1] : T(0);
    }
    for (int e = threadIdx.x; e < TK * TN; e += THREADS) {
      const int k = e / TN;
      const int n = e % TN;
      const int gk = k0 + k;
      const int gc = col0 + n;
      Bs[k][n] = (gk < K && gc < N) ? B[gk * sb0 + gc * sb1] : T(0);
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < TK; ++k) {
      T a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = row0 + ty + 16 * i;
    if (gr >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gc = col0 + tx + 16 * j;
      if (gc < N) C[(size_t)gr * N + gc] = acc[i][j];
    }
  }
}

template <typename T>
int launch(const T* A, const T* B, T* C, int M, int N, int K, long long sa0,
           long long sa1, long long sb0, long long sb1, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM, 1);
  matmul_kernel<T><<<grid, THREADS, 0, st>>>(A, B, C, M, N, K, sa0, sa1, sb0,
                                              sb1);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// A (M, K) and B (K, N) on the device with element strides (sa0, sa1) and
// (sb0, sb1); C (M, N) row-major contiguous.  K >= 1.
int matmul_f32_launch(const float* A, const float* B, float* C, int M, int N,
                      int K, long long sa0, long long sa1, long long sb0,
                      long long sb1, void* stream) {
  return launch<float>(A, B, C, M, N, K, sa0, sa1, sb0, sb1, stream);
}

int matmul_f64_launch(const double* A, const double* B, double* C, int M,
                      int N, int K, long long sa0, long long sa1,
                      long long sb0, long long sb1, void* stream) {
  return launch<double>(A, B, C, M, N, K, sa0, sa1, sb0, sb1, stream);
}

}  // extern "C"
