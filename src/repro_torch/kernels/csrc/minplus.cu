// Tropical (min, +) matrix product for Hopper (sm_90a):
//   C[i, j] = min_k A[i, k] + B[k, j]
//
// Replaces: src/repro/kernels/minplus.py minplus_kernel, the tile body of
// the min-plus APSP squarings (ops.apsp_minplus / apsp_minplus_blocked).
//
// What bounds it on the H100: operations.  An (M, K) x (K, N) product does
// M*N*K additions and as many minimums, 2*N^3 operations for one squaring of
// an N x N distance matrix (1.1e12 at N = 8192), on the CUDA cores' FP32
// pipes: tensor cores cannot evaluate (min, +).  Bytes are small beside
// that (each operand is read once per 64-wide output stripe).
//
// Design: each block owns a 64 x 64 output tile and loops over the WHOLE K
// range inside the block, staging 64 x 32 tiles of A (stored transposed) and
// 32 x 64 tiles of B in shared memory; each of the 256 threads keeps a 4 x 4
// register accumulator (rows ty + 16 i, columns tx + 16 j, so shared-memory
// reads are conflict-free and output stores coalesce), doing 16 adds and 16
// minimums per pair of shared-memory reads.  Out-of-range elements load as
// +inf, the additive identity of min, so ragged shapes need no padding
// copies.  The Pallas kernel carried its accumulator across sequential K
// grid steps; here the K loop is inside the block, so blocks are independent.
//
// Exactness: hop counts are small integers, and sums and minimums of small
// integers in float32 are exact, so the result equals the plain version bit
// for bit in any evaluation order.
//
// Not used yet: Hopper's DPX instructions (__viaddmin_s32 and relatives)
// fuse the add and the min for 32-bit integers in one instruction, and a
// 16-bit form packs two per register: the natural next step for int16 hops.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int TM = 64;
constexpr int TN = 64;
constexpr int TK = 32;
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
minplus_kernel(const float* __restrict__ A, const float* __restrict__ B,
               float* __restrict__ C, int M, int N, int K) {
  __shared__ float As[TK][TM + 1];  // A tile, transposed: As[k][m]
  __shared__ float Bs[TK][TN];
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int row0 = blockIdx.y * TM;
  const int col0 = blockIdx.x * TN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = CUDART_INF_F;

  for (int k0 = 0; k0 < K; k0 += TK) {
    for (int e = threadIdx.x; e < TM * TK; e += THREADS) {
      const int m = e / TK;
      const int k = e % TK;
      const int gr = row0 + m;
      const int gk = k0 + k;
      As[k][m] = (gr < M && gk < K) ? A[(size_t)gr * K + gk] : CUDART_INF_F;
    }
    for (int e = threadIdx.x; e < TK * TN; e += THREADS) {
      const int k = e / TN;
      const int n = e % TN;
      const int gk = k0 + k;
      const int gc = col0 + n;
      Bs[k][n] = (gk < K && gc < N) ? B[(size_t)gk * N + gc] : CUDART_INF_F;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < TK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fminf(acc[i][j], a[i] + b[j]);
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

}  // namespace

extern "C" {

// A (M, K), B (K, N), C (M, N) float32, row-major contiguous, on the device.
int minplus_launch(const float* A, const float* B, float* C, int M, int N,
                   int K, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM, 1);
  minplus_kernel<<<grid, THREADS, 0, st>>>(A, B, C, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
