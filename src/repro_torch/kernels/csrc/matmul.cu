// Dense matrix product for Hopper (sm_90a):
//   C = A @ B,   A (M, K), B (K, N) with any element strides, C (M, N)
// row-major, accumulated in the operands' own type (float32 or float64).
//
// Replaces: src/repro/kernels/power.py matmul_kernel (launched by
// matmul_pallas), the A @ Q step of ops.power_iteration_lambda2: lambda_2 of
// the Laplacian by deflated block power iteration, the spectral bound on
// bisection width.
//
// What bounds it on the H100: bytes.  On its path the product is skinny:
// A is the N x N 0/1 adjacency, B a block of 8 iteration vectors (the
// column-major Q that torch.linalg.qr returns).  At N = 8192 that reads
// 268.4 MB of A for 0.54 G fused multiply-adds, so the least time is 0.080 ms
// at 3.35 TB/s, against 0.016 ms at the FP32 issue rate.  Tensor cores would
// not help a product this skinny; moving A's bytes is the whole cost, and
// the card needs some 15-20 KB in flight per SM to move them at its rate.
//
// Two kernels, chosen by the wrapper (kernels/power.py):
//
// matmul_narrow_kernel (N <= 16, every shape of the spectral path).  Each
// block owns a band of BM = 8 or 16 rows and the whole N (the wrapper picks
// 16 when that still gives two blocks per SM, so 8192 rows run as 512 blocks
// and 792 rows as 99).  Each warp owns R = BM / 8 rows; its lanes split K by
// fixed position (lane l takes the 16 bytes at k = k0 + l * VEC of every
// chunk) and keep N accumulators per row.  A is streamed through a 4-stage
// cp.async ring in shared memory, so three chunks of BM rows x 512 bytes are
// in flight while one is multiplied: 16-byte copies where a row is
// contiguous and 16-byte aligned, 4- or 8-byte copies of single elements
// from any strides otherwise (a transposed view: the same kernel, its
// scalar-copy variant).  B is staged per K chunk in the same ring as a
// (NB, K chunk) transposed tile, read from any strides (16-byte copies when
// its columns are contiguous, as QR's Q is), so every lane reads its A and B
// values as 16-byte shared loads with no bank conflict.  At the end a fixed
// xor-shuffle tree sums the 32 lanes of each accumulator.  Out-of-range rows,
// columns and K positions copy as zeros (cp.async src-size 0) and add +0.
//
// matmul_kernel (N > 16: the 1024^3 and float64 checks; no main path).  Each
// block owns a 64 x 64 output tile and loops over the whole K range,
// staging 64 x 32 tiles of A (transposed) and 32 x 64 tiles of B in shared
// memory; each of the 256 threads keeps a 4 x 4 register accumulator.
//
// The Pallas kernel carried its accumulator across sequential K grid steps;
// here the K loop is inside the block in both kernels, so blocks are
// independent: no split-K and no atomic, every sum in an order fixed by
// position alone, the same result on every run.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "cp_async.cuh"

namespace {

// ---- tiled kernel (N > 16) ----------------------------------------------- //

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
int launch_tiled(const T* A, const T* B, T* C, int M, int N, int K,
                 long long sa0, long long sa1, long long sb0, long long sb1,
                 cudaStream_t st) {
  dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM, 1);
  matmul_kernel<T><<<grid, THREADS, 0, st>>>(A, B, C, M, N, K, sa0, sa1, sb0,
                                              sb1);
  return static_cast<int>(cudaGetLastError());
}

// ---- narrow kernel (N <= 16) --------------------------------------------- //

constexpr int NW_WARPS = 8;
constexpr int NW_THREADS = NW_WARPS * 32;
constexpr int NW_STAGES = 4;
constexpr int NW_MAX_N = 16;

__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}

// 16 bytes of T from shared memory: VEC = 4 floats or 2 doubles.
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
  static __device__ __forceinline__ void unpack(const float4& v, float* o) {
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
};
template <>
struct Vec16<double> {
  using type = double2;
  static __device__ __forceinline__ void unpack(const double2& v, double* o) {
    o[0] = v.x; o[1] = v.y;
  }
};

// T, NB (N rounded up to 1, 2, 4, 8 or 16), R rows per warp, VA: 16-byte
// copies of A (rows contiguous and aligned) or one element per copy.
template <typename T, int NB, int R, bool VA>
__global__ void __launch_bounds__(NW_THREADS, sizeof(T) == 4 ? 4 : 1)
matmul_narrow_kernel(const T* __restrict__ A, const T* __restrict__ B,
                     T* __restrict__ C, int M, int N, int K, long long sa0,
                     long long sa1, long long sb0, long long sb1, int vec_b) {
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte copy
  constexpr int KC = 32 * VEC;         // K chunk: one 16-byte copy per lane
  constexpr int BM = NW_WARPS * R;     // rows per block
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* As = reinterpret_cast<T*>(smem_raw);  // [STAGES][BM][KC]
  T* Bs = As + NW_STAGES * BM * KC;        // [STAGES][NB][KC], B transposed
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * BM;
  const int n_chunks = (K + KC - 1) / KC;
  // single-element copies of A walk rows fastest when A's rows are its
  // contiguous direction (a transposed view), K fastest otherwise
  const bool a_rows_fast = sa0 < sa1;
  const bool b_cols_fast = sb1 < sb0;

  auto issue = [&](int c) {
    const int st = c % NW_STAGES;
    const int k0 = c * KC;
    T* as = As + st * BM * KC;
    T* bs = Bs + st * NB * KC;
    if (VA) {
      for (int e = tid; e < BM * (KC / VEC); e += NW_THREADS) {
        const int r = e / (KC / VEC);
        const int kk = (e % (KC / VEC)) * VEC;
        const int gr = row0 + r;
        const int gk = k0 + kk;
        const bool ok = gr < M && gk < K;  // K % VEC == 0: all or nothing
        cpasync::copy<16>(as + r * KC + kk, ok ? A + gr * sa0 + gk : A,
                     ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < BM * KC; e += NW_THREADS) {
        const int r = a_rows_fast ? e % BM : e / KC;
        const int kk = a_rows_fast ? e / BM : e % KC;
        const int gr = row0 + r;
        const int gk = k0 + kk;
        const bool ok = gr < M && gk < K;
        cpasync::copy<sizeof(T)>(as + r * KC + kk,
                            ok ? A + gr * sa0 + gk * sa1 : A,
                            ok ? (int)sizeof(T) : 0);
      }
    }
    if (vec_b) {  // B's columns contiguous and aligned, K % VEC == 0
      for (int e = tid; e < NB * (KC / VEC); e += NW_THREADS) {
        const int n = e / (KC / VEC);
        const int kk = (e % (KC / VEC)) * VEC;
        const int gk = k0 + kk;
        const bool ok = n < N && gk < K;
        cpasync::copy<16>(bs + n * KC + kk, ok ? B + gk + n * sb1 : B,
                     ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < NB * KC; e += NW_THREADS) {
        const int n = b_cols_fast ? e % NB : e / KC;
        const int kk = b_cols_fast ? e / NB : e % KC;
        const int gk = k0 + kk;
        const bool ok = n < N && gk < K;
        cpasync::copy<sizeof(T)>(bs + n * KC + kk,
                            ok ? B + gk * sb0 + n * sb1 : B,
                            ok ? (int)sizeof(T) : 0);
      }
    }
  };

  T acc[R][NB];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int n = 0; n < NB; ++n) acc[r][n] = T(0);

#pragma unroll
  for (int c = 0; c < NW_STAGES - 1; ++c) {
    if (c < n_chunks) issue(c);
    cpasync::commit();
  }
  using V16 = typename Vec16<T>::type;
  for (int c = 0; c < n_chunks; ++c) {
    cpasync::wait<NW_STAGES - 2>();  // chunk c has landed
    __syncthreads();  // ... for every thread; stage (c - 1) is free again
    if (c + NW_STAGES - 1 < n_chunks) issue(c + NW_STAGES - 1);
    cpasync::commit();
    const int st = c % NW_STAGES;
    const T* as = As + (st * BM + warp * R) * KC + lane * VEC;
    const T* bs = Bs + st * NB * KC + lane * VEC;
    T a[R][VEC];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      Vec16<T>::unpack(*reinterpret_cast<const V16*>(as + r * KC), a[r]);
    }
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      T b[VEC];
      Vec16<T>::unpack(*reinterpret_cast<const V16*>(bs + n * KC), b);
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          acc[r][n] = fma_t(a[r][v], b[v], acc[r][n]);
        }
    }
  }
  cpasync::wait<0>();

  // fixed xor-shuffle tree over the 32 lanes; lane n then holds column n
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int gr = row0 + warp * R + r;
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      T v = acc[r][n];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        v += __shfl_xor_sync(0xffffffffu, v, off);
      }
      if (lane == n && n < N && gr < M) C[(size_t)gr * N + n] = v;
    }
  }
}

template <typename T, int NB, int R, bool VA>
int launch_narrow_t(const T* A, const T* B, T* C, int M, int N, int K,
                    long long sa0, long long sa1, long long sb0,
                    long long sb1, int vec_b, cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int KC = 32 * VEC;
  constexpr int BM = NW_WARPS * R;
  constexpr int smem = NW_STAGES * (BM + NB) * KC * (int)sizeof(T);
  auto kernel = matmul_narrow_kernel<T, NB, R, VA>;
  static bool smem_set = false;  // once per instantiation
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  const int grid = (M + BM - 1) / BM;
  kernel<<<grid, NW_THREADS, smem, st>>>(A, B, C, M, N, K, sa0, sa1, sb0, sb1,
                                         vec_b);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NB>
int launch_narrow_nb(const T* A, const T* B, T* C, int M, int N, int K,
                     long long sa0, long long sa1, long long sb0,
                     long long sb1, int band_rows, int vec_a, int vec_b,
                     cudaStream_t st) {
  if (band_rows == 16) {
    return vec_a ? launch_narrow_t<T, NB, 2, true>(A, B, C, M, N, K, sa0, sa1,
                                                   sb0, sb1, vec_b, st)
                 : launch_narrow_t<T, NB, 2, false>(A, B, C, M, N, K, sa0,
                                                    sa1, sb0, sb1, vec_b, st);
  }
  return vec_a ? launch_narrow_t<T, NB, 1, true>(A, B, C, M, N, K, sa0, sa1,
                                                 sb0, sb1, vec_b, st)
               : launch_narrow_t<T, NB, 1, false>(A, B, C, M, N, K, sa0, sa1,
                                                  sb0, sb1, vec_b, st);
}

template <typename T>
int launch_narrow(const T* A, const T* B, T* C, int M, int N, int K,
                  long long sa0, long long sa1, long long sb0, long long sb1,
                  int band_rows, int vec_a, int vec_b, cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  // the 16-byte variants need what the wrapper checked: refuse otherwise
  const bool a_ok = sa1 == 1 && K % VEC == 0 && (M == 1 || sa0 % VEC == 0) &&
                    reinterpret_cast<uintptr_t>(A) % 16 == 0;
  const bool b_ok = sb0 == 1 && K % VEC == 0 && (N == 1 || sb1 % VEC == 0) &&
                    reinterpret_cast<uintptr_t>(B) % 16 == 0;
  if ((vec_a && !a_ok) || (vec_b && !b_ok) || N > NW_MAX_N ||
      (band_rows != 8 && band_rows != 16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto go = [&](auto nb) {
    return launch_narrow_nb<T, decltype(nb)::value>(
        A, B, C, M, N, K, sa0, sa1, sb0, sb1, band_rows, vec_a, vec_b, st);
  };
  if (N <= 1) return go(std::integral_constant<int, 1>());
  if (N <= 2) return go(std::integral_constant<int, 2>());
  if (N <= 4) return go(std::integral_constant<int, 4>());
  if (N <= 8) return go(std::integral_constant<int, 8>());
  return go(std::integral_constant<int, 16>());
}

}  // namespace

extern "C" {

// A (M, K) and B (K, N) on the device with element strides (sa0, sa1) and
// (sb0, sb1); C (M, N) row-major contiguous.  M, N, K >= 1.
//
// The tiled kernel (any N).
int matmul_f32_launch(const float* A, const float* B, float* C, int M, int N,
                      int K, long long sa0, long long sa1, long long sb0,
                      long long sb1, void* stream) {
  return launch_tiled<float>(A, B, C, M, N, K, sa0, sa1, sb0, sb1,
                             static_cast<cudaStream_t>(stream));
}

int matmul_f64_launch(const double* A, const double* B, double* C, int M,
                      int N, int K, long long sa0, long long sa1,
                      long long sb0, long long sb1, void* stream) {
  return launch_tiled<double>(A, B, C, M, N, K, sa0, sa1, sb0, sb1,
                              static_cast<cudaStream_t>(stream));
}

// The narrow kernel (N <= 16): band_rows 8 or 16; vec_a / vec_b select the
// 16-byte copies of A's rows / B's columns (refused with
// cudaErrorInvalidValue where the strides or alignment do not allow them).
int matmul_narrow_f32_launch(const float* A, const float* B, float* C, int M,
                             int N, int K, long long sa0, long long sa1,
                             long long sb0, long long sb1, int band_rows,
                             int vec_a, int vec_b, void* stream) {
  return launch_narrow<float>(A, B, C, M, N, K, sa0, sa1, sb0, sb1, band_rows,
                              vec_a, vec_b, static_cast<cudaStream_t>(stream));
}

int matmul_narrow_f64_launch(const double* A, const double* B, double* C,
                             int M, int N, int K, long long sa0, long long sa1,
                             long long sb0, long long sb1, int band_rows,
                             int vec_a, int vec_b, void* stream) {
  return launch_narrow<double>(A, B, C, M, N, K, sa0, sa1, sb0, sb1,
                               band_rows, vec_a, vec_b,
                               static_cast<cudaStream_t>(stream));
}

}  // extern "C"
