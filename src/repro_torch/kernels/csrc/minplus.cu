// Tropical (min, +) matrix product for Hopper (sm_90a):
//   C[i, j] = min_k A[i, k] + B[k, j]
//
// Replaces: src/repro/kernels/minplus.py minplus_kernel (launched by
// minplus_pallas), the tile body of the min-plus APSP squarings
// (ops.apsp_minplus / apsp_minplus_blocked).  Two forms of the same product:
//
// minplus_f32_kernel: float32 operands, +inf the identity of min.
// minplus_hops_kernel: canonical int16 hop matrices (sentinel 32767 for
// "unreachable"), two add-min pairs per instruction on Hopper's DPX units.
//
// What bounds both on the H100: operations.  An (M, K) x (K, N) product is
// M*N*K add-min pairs (5.5e11 for one squaring of an 8192-node distance
// matrix); tensor cores cannot evaluate (min, +).  In float32 a pair is two
// instructions (FADD, FMNMX) on the CUDA cores; __viaddmin_s16x2 does two
// pairs in one instruction, at a rate no data sheet gives (chip_smoke.py
// measures it with minplus_rate_kernel).  Bytes are small beside that: each
// operand tile is read once per 128-row or 128/256-column output stripe.
//
// Design (both forms):
// - Register tile.  256 threads own a 128-row output tile; thread (ty, tx)
//   = (tid / 16, tid % 16) keeps rows ty*4 + {0..3} and 64 + ty*4 + {0..3}.
//   float32: columns tx*4 + {0..3} and 64 + tx*4 + {0..3}, an 8 x 8 tile,
//   128 x 128 per block.  int16: column pairs as 32-bit words, words tx*4 +
//   {0..3} and 64 + tx*4 + {0..3} (columns tx*8 + {0..7}, 128 + tx*8 +
//   {0..7}), 8 x 8 words, 128 x 256 per block.  Each k step reads its A and B
//   values as four 16-byte shared loads (LDS.128) for 64 accumulator updates:
//   128 FP32 instructions or 64 DPX instructions.
// - Bank layout.  A is read down a column (8 rows at one k), so the A stage
//   is kept transposed, As[k][m]: a half-warp shares ty and reads one
//   16-byte address (a broadcast), the two half-warps' addresses lie in
//   different banks.  B rows are read as 16 consecutive 16-byte vectors by
//   the 16 values of tx, 128 contiguous bytes per quarter-warp, so no bank
//   is hit twice.  float32 copies A transposed with 4-byte cp.async (rows
//   padded to 132 floats so each k row stays 16-byte aligned); int16 copies
//   A as it lies (rows of 16 + 8 padding int16: 48 bytes, so a quarter-warp
//   reading 8 consecutive rows' 16 bytes covers all 32 banks once) and
//   transposes it in the fix-up pass below.
// - Staging.  A 3-stage cp.async ring (csrc/cp_async.cuh) of 16-deep K
//   chunks: 16-byte copies where rows are contiguous and 16-byte aligned,
//   4-byte copies otherwise, plain loads for int16 rows of odd length.
//   Positions past the end of K are stored as the identity (+inf, or the
//   sentinel), so ragged K needs no padding copies; rows and columns past
//   M and N are never stored.
// - Grid fill.  Where the output tiles give fewer than two blocks per SM
//   (720^3: 36 float32 tiles for 132 SMs), K is split across blocks
//   (blockIdx.z), each writing its partial minimum to a scratch buffer, and
//   minplus_reduce_kernel takes the elementwise minimum of the partials.
//   The wrapper's launch_plan (kernels/minplus.py) chooses the split.
//
// Exactness: every candidate a + b is the same IEEE (or integer) add
// wherever it is done, and min does not depend on order, so split-K and any
// tiling give the plain version's result bit for bit.
//
// The int16 contract.  DPX adds wrap at 16 bits, so on load every value is
// clamped into [0, S] (clamp2 in the fix-up pass): the sentinel, and
// anything at or above S, becomes the working infinity S = 16383, and a
// negative entry becomes 0.  A sum of two loaded values is then at most
// 2 S = 32766 and never wraps.  Accumulators start at S, so every result is
// at most S, and S is written back as the sentinel 32767.  Finite entries
// must lie in [0, S); any result >= S is reported as the sentinel.  For a
// squaring of the hop matrix of a graph of n <= S nodes this is exact: a
// true distance is at most n - 1 < S, and a candidate at or above S is never
// the minimum of a pair that has a finite distance.  Larger graphs take the
// float32 form (ops.apsp_form).  A's values are broadcast into both halves
// of a word (__byte_perm) in the fix-up pass, so one DPX instruction updates
// the two columns of a B word.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TM = 128;     // output rows per block, both forms
constexpr int TK = 16;      // K depth of one stage
constexpr int STAGES = 3;

// ---- float32 ------------------------------------------------------------- //

constexpr int F_TN = 128;
constexpr int F_AS = TM + 4;  // As[k][m] row, 16-byte aligned
constexpr int F_STAGE = TK * F_AS + TK * F_TN;  // floats
constexpr int F_SMEM = STAGES * F_STAGE * 4;

// VB: bytes per copy of B (16 when B's rows are contiguous 4-float runs, 4
// otherwise).  out: C, or the partial of split blockIdx.z.
template <int VB>
__global__ void __launch_bounds__(THREADS, 2)
minplus_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                   float* __restrict__ out, int M, int N, int K, int kps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int row0 = blockIdx.y * TM;
  const int col0 = blockIdx.x * F_TN;
  const int kbeg = blockIdx.z * kps;
  const int kend = min(K, kbeg + kps);
  const int n_chunks = (kend - kbeg + TK - 1) / TK;
  out += (size_t)blockIdx.z * M * N;

  auto issue = [&](int c) {
    float* as = smem + (c % STAGES) * F_STAGE;
    float* bs = as + TK * F_AS;
    const int k0 = kbeg + c * TK;
    // A, transposed into As[k][m]: 16 threads walk one row's 16 k
#pragma unroll
    for (int i = 0; i < TM * TK / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int k = e % TK;
      const int m = e / TK;
      const int gk = k0 + k;
      const int gm = row0 + m;
      float* dst = as + k * F_AS + m;
      if (gk < kend && gm < M) {
        cpasync::copy<4>(dst, A + (size_t)gm * K + gk, 4);
      } else {
        *dst = CUDART_INF_F;
      }
    }
    if constexpr (VB == 16) {
#pragma unroll
      for (int i = 0; i < TK * F_TN / 4 / THREADS; ++i) {
        const int e = tid + i * THREADS;
        const int k = e / (F_TN / 4);
        const int n = (e % (F_TN / 4)) * 4;
        const int gk = k0 + k;
        const int gn = col0 + n;
        float* dst = bs + k * F_TN + n;
        if (gk < kend && gn < N) {  // N % 4 == 0: all four or none
          cpasync::copy<16>(dst, B + (size_t)gk * N + gn, 16);
        } else {
          *reinterpret_cast<float4*>(dst) = make_float4(
              CUDART_INF_F, CUDART_INF_F, CUDART_INF_F, CUDART_INF_F);
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < TK * F_TN / THREADS; ++i) {
        const int e = tid + i * THREADS;
        const int k = e / F_TN;
        const int n = e % F_TN;
        const int gk = k0 + k;
        const int gn = col0 + n;
        float* dst = bs + k * F_TN + n;
        if (gk < kend && gn < N) {
          cpasync::copy<4>(dst, B + (size_t)gk * N + gn, 4);
        } else {
          *dst = CUDART_INF_F;
        }
      }
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = CUDART_INF_F;

#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) {
    if (c < n_chunks) issue(c);
    cpasync::commit();
  }
  for (int c = 0; c < n_chunks; ++c) {
    cpasync::wait<STAGES - 2>();  // chunk c has landed
    __syncthreads();  // ... for every thread; stage (c - 1) is free again
    if (c + STAGES - 1 < n_chunks) issue(c + STAGES - 1);
    cpasync::commit();
    const float* as = smem + (c % STAGES) * F_STAGE;
    const float* bs = as + TK * F_AS;
#pragma unroll
    for (int k = 0; k < TK; ++k) {
      const float* ak = as + k * F_AS;
      const float* bk = bs + k * F_TN;
      const float4 a0 = *reinterpret_cast<const float4*>(ak + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(ak + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(bk + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(bk + 64 + tx * 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fminf(acc[i][j], a[i] + b[j]);
    }
  }
  cpasync::wait<0>();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gr = row0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (gr >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gc = col0 + h * 64 + tx * 4;
      float* dst = out + (size_t)gr * N + gc;
      if constexpr (VB == 16) {
        if (gc < N) {
          *reinterpret_cast<float4*>(dst) =
              make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                          acc[i][4 * h + 3]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (gc + j < N) dst[j] = acc[i][4 * h + j];
        }
      }
    }
  }
}

// ---- int16 hops (DPX) ---------------------------------------------------- //

constexpr int H_TN = 256;           // output columns per block
constexpr int H_AR = TK + 8;        // raw A row: 16 int16 + 8 padding
constexpr int H_RAW_A = TM * H_AR;  // int16
constexpr int H_RAW_B = TK * H_TN;  // int16
constexpr int H_STAGE = H_RAW_A + H_RAW_B;          // int16
constexpr int H_SMEM = STAGES * H_STAGE * 2 + TK * TM * 4;  // + Ad words
constexpr int16_t SENTINEL = 32767;
constexpr unsigned S2 = 0x3FFF3FFFu;  // working infinity S = 16383, twice

// Both int16 halves of w clamped into [0, S].
__device__ __forceinline__ unsigned clamp2(unsigned w) {
  return __vmaxs2(__vmins2(w, S2), 0u);
}

// VB: bytes per copy (16 or 4 with cp.async; 2: plain loads for odd rows).
template <int VB>
__device__ __forceinline__ void hops_copy(int16_t* dst, const int16_t* src,
                                          bool ok) {
  if constexpr (VB == 2) {
    *dst = ok ? *src : SENTINEL;
  } else {
    if (ok) {
      cpasync::copy<VB>(dst, src, VB);
    } else if constexpr (VB == 16) {
      const unsigned s = 0x7FFF7FFFu;
      *reinterpret_cast<uint4*>(dst) = make_uint4(s, s, s, s);
    } else {
      *reinterpret_cast<unsigned*>(dst) = 0x7FFF7FFFu;
    }
  }
}

template <int VB>
__global__ void __launch_bounds__(THREADS, 2)
minplus_hops_kernel(const int16_t* __restrict__ A,
                    const int16_t* __restrict__ B, int16_t* __restrict__ out,
                    int M, int N, int K, int kps) {
  constexpr int VE = VB / 2;  // int16 elements per copy
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int16_t* raw = reinterpret_cast<int16_t*>(smem_raw);
  // A of the current chunk: transposed, mapped and broadcast into both
  // halves of a word, Ad[k][m]
  unsigned* Ad = reinterpret_cast<unsigned*>(raw + STAGES * H_STAGE);
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int row0 = blockIdx.y * TM;
  const int col0 = blockIdx.x * H_TN;
  const int kbeg = blockIdx.z * kps;
  const int kend = min(K, kbeg + kps);
  const int n_chunks = (kend - kbeg + TK - 1) / TK;
  out += (size_t)blockIdx.z * M * N;

  auto issue = [&](int c) {
    int16_t* as = raw + (c % STAGES) * H_STAGE;  // As[m][k], rows of H_AR
    int16_t* bs = as + H_RAW_A;                  // Bs[k][n]
    const int k0 = kbeg + c * TK;
#pragma unroll
    for (int i = 0; i < TM * TK / VE / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int m = e / (TK / VE);
      const int k = (e % (TK / VE)) * VE;
      const int gm = row0 + m;
      const int gk = k0 + k;
      // K % VE == 0, so a copy lies wholly inside or outside [kbeg, kend)
      hops_copy<VB>(as + m * H_AR + k, A + (size_t)gm * K + gk,
                    gk < kend && gm < M);
    }
#pragma unroll
    for (int i = 0; i < TK * H_TN / VE / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int k = e / (H_TN / VE);
      const int n = (e % (H_TN / VE)) * VE;
      const int gk = k0 + k;
      const int gn = col0 + n;
      hops_copy<VB>(bs + k * H_TN + n, B + (size_t)gk * N + gn,
                    gk < kend && gn < N);
    }
  };

  unsigned acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = S2;

#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) {
    if (c < n_chunks) issue(c);
    cpasync::commit();
  }
  for (int c = 0; c < n_chunks; ++c) {
    cpasync::wait<STAGES - 2>();  // chunk c has landed
    __syncthreads();  // ... for every thread; stage (c - 1) and Ad are free
    if (c + STAGES - 1 < n_chunks) issue(c + STAGES - 1);
    cpasync::commit();
    int16_t* as = raw + (c % STAGES) * H_STAGE;
    int16_t* bs = as + H_RAW_A;
    // fix-up: A -> Ad (clamp into [0, S], transpose, broadcast); B clamped
    // in place.  16-byte row pieces (8 k) of A: a quarter-warp reads 8
    // consecutive rows, 48 bytes apart, each bank once.
#pragma unroll
    for (int i = 0; i < TM * TK / 8 / THREADS; ++i) {
      const int piece = tid + i * THREADS;
      const int m = piece % TM;
      const int k8 = (piece / TM) * 8;
      const uint4 w = *reinterpret_cast<const uint4*>(as + m * H_AR + k8);
      const unsigned v[4] = {clamp2(w.x), clamp2(w.y), clamp2(w.z),
                             clamp2(w.w)};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        Ad[(k8 + 2 * q) * TM + m] = __byte_perm(v[q], 0, 0x1010);
        Ad[(k8 + 2 * q + 1) * TM + m] = __byte_perm(v[q], 0, 0x3232);
      }
    }
#pragma unroll
    for (int i = 0; i < H_RAW_B / 8 / THREADS; ++i) {
      uint4* p = reinterpret_cast<uint4*>(bs) + tid + i * THREADS;
      uint4 w = *p;
      w.x = clamp2(w.x);
      w.y = clamp2(w.y);
      w.z = clamp2(w.z);
      w.w = clamp2(w.w);
      *p = w;
    }
    __syncthreads();
    const unsigned* bw = reinterpret_cast<const unsigned*>(bs);
#pragma unroll
    for (int k = 0; k < TK; ++k) {
      const uint4 a0 = *reinterpret_cast<const uint4*>(Ad + k * TM + ty * 4);
      const uint4 a1 =
          *reinterpret_cast<const uint4*>(Ad + k * TM + 64 + ty * 4);
      const uint4 b0 =
          *reinterpret_cast<const uint4*>(bw + k * (H_TN / 2) + tx * 4);
      const uint4 b1 =
          *reinterpret_cast<const uint4*>(bw + k * (H_TN / 2) + 64 + tx * 4);
      const unsigned a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const unsigned b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[i][j] = __viaddmin_s16x2(a[i], b[j], acc[i][j]);
    }
  }
  cpasync::wait<0>();

  // S -> sentinel: OR 0x4000 into each half equal to S (S | 0x4000 = 32767)
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gr = row0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (gr >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      unsigned w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned x = acc[i][4 * h + j];
        w[j] = x | (__vcmpeq2(x, S2) & 0x40004000u);
      }
      const int gc = col0 + h * 128 + tx * 8;
      int16_t* dst = out + (size_t)gr * N + gc;
      if constexpr (VB == 16) {  // N % 8 == 0: all eight or none
        if (gc < N) {
          *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (gc + j < N) {
            dst[j] = static_cast<int16_t>(w[j / 2] >> (16 * (j % 2)));
          }
        }
      }
    }
  }
}

// ---- split-K: elementwise minimum of the partials ------------------------ //

__device__ __forceinline__ float min_t(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ int16_t min_t(int16_t a, int16_t b) {
  return a < b ? a : b;
}

// P (splits, total) -> C (total); with `vec` a thread takes 16 bytes at a
// time (total a multiple of them, P and C 16-byte aligned), else one element.
// The partials of a position are loaded 8 splits at a time, all in flight
// together, before they are folded.
template <typename T, typename V>
__device__ __forceinline__ void fold_splits(const V* p, long long stride,
                                            int splits, V& r) {
  for (int s0 = 1; s0 < splits; s0 += 8) {
    V x[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (s0 + u < splits) x[u] = p[(s0 + u) * stride];
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (s0 + u < splits) {
        T* rv = reinterpret_cast<T*>(&r);
        const T* xv = reinterpret_cast<const T*>(&x[u]);
#pragma unroll
        for (int v = 0; v < (int)(sizeof(V) / sizeof(T)); ++v) {
          rv[v] = min_t(rv[v], xv[v]);
        }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
minplus_reduce_kernel(const T* __restrict__ P, T* __restrict__ C,
                      long long total, int splits, int vec) {
  constexpr int V = 16 / sizeof(T);
  const long long stride = (long long)gridDim.x * THREADS;
  if (vec) {
    const uint4* P4 = reinterpret_cast<const uint4*>(P);
    for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
         i < total / V; i += stride) {
      uint4 r = P4[i];
      fold_splits<T>(P4 + i, total / V, splits, r);
      reinterpret_cast<uint4*>(C)[i] = r;
    }
  } else {
    for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
         i < total; i += stride) {
      T r = P[i];
      fold_splits<T>(P + i, total, splits, r);
      C[i] = r;
    }
  }
}

template <typename T>
int reduce(const T* P, T* C, long long total, int splits, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const int vec = total % V == 0 && reinterpret_cast<uintptr_t>(P) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(C) % 16 == 0;
  const long long work = vec ? total / V : total;
  const long long blocks = (work + THREADS - 1) / THREADS;
  const int grid = static_cast<int>(blocks < 4096 ? blocks : 4096);
  minplus_reduce_kernel<T><<<grid, THREADS, 0, st>>>(P, C, total, splits,
                                                     vec);
  return static_cast<int>(cudaGetLastError());
}

// One launch of a form: the product kernel (into C, or into P split by
// split), then the reduction when K is split.  `kernel` needs `smem` bytes
// of dynamic shared memory, allowed once per kernel (`smem_set`).
template <typename T, typename Kernel>
int launch(Kernel kernel, bool& smem_set, int smem, int tn, const T* A,
           const T* B, T* C, T* P, int M, int N, int K, int kps, int splits,
           cudaStream_t st) {
  if (M <= 0 || N <= 0 || K <= 0 || kps <= 0 || splits <= 0 ||
      (long long)kps * (splits - 1) >= K || (splits > 1 && P == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  dim3 grid((N + tn - 1) / tn, (M + TM - 1) / TM, splits);
  kernel<<<grid, THREADS, smem, st>>>(A, B, splits > 1 ? P : C, M, N, K, kps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return reduce<T>(P, C, (long long)M * N, splits, st);
}

template <int VB>
int launch_f32(const float* A, const float* B, float* C, float* P, int M,
               int N, int K, int kps, int splits, cudaStream_t st) {
  static bool smem_set = false;
  return launch<float>(minplus_f32_kernel<VB>, smem_set, F_SMEM, F_TN, A, B,
                       C, P, M, N, K, kps, splits, st);
}

template <int VB>
int launch_hops(const int16_t* A, const int16_t* B, int16_t* C, int16_t* P,
                int M, int N, int K, int kps, int splits, cudaStream_t st) {
  static bool smem_set = false;
  return launch<int16_t>(minplus_hops_kernel<VB>, smem_set, H_SMEM, H_TN, A,
                         B, C, P, M, N, K, kps, splits, st);
}

// ---- the card's add-min issue rate --------------------------------------- //

// Every thread runs 8 independent chains of `iters` x 16 add-min updates:
// kind 0 __viaddmin_s16x2 (two pairs an instruction), kind 1 the float32
// FADD + FMNMX pair.  The chains' end values are stored only when they hit
// an impossible value, so nothing is optimised away.
__global__ void __launch_bounds__(THREADS)
minplus_rate_kernel(unsigned* out, int kind, int iters, unsigned b,
                    unsigned c) {
  unsigned acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = (threadIdx.x + i * 977u) * 0x00010001u;
  if (kind == 0) {
    for (int it = 0; it < iters; ++it) {
#pragma unroll
      for (int u = 0; u < 16; ++u)
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] = __viaddmin_s16x2(acc[i], b, c);
    }
  } else {
    float f[8];
    const float fb = __uint_as_float(b), fc = __uint_as_float(c);
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = (float)acc[i];
    for (int it = 0; it < iters; ++it) {
#pragma unroll
      for (int u = 0; u < 16; ++u)
#pragma unroll
        for (int i = 0; i < 8; ++i) f[i] = fminf(f[i] + fb, fc);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = __float_as_uint(f[i]);
  }
  unsigned r = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) r ^= acc[i];
  if (r == 0x9E3779B9u) out[blockIdx.x] = r;
}

// Every pointer (null ones aside) a multiple of `bytes`.
template <typename... Ptr>
bool aligned(uintptr_t bytes, Ptr... p) {
  return ((p == nullptr || reinterpret_cast<uintptr_t>(p) % bytes == 0) &&
          ...);
}

}  // namespace

extern "C" {

// A (M, K), B (K, N), C (M, N) row-major contiguous on the device; P a
// (splits, M, N) scratch buffer when splits > 1 (may be null otherwise).
// Split z covers K positions [z * kps, min(K, (z + 1) * kps)); every split
// must be non-empty.  vec: bytes per copy of B, 16 (N % 4 == 0, B, C and P
// 16-byte aligned) or 4.  A width the operands do not allow is refused with
// cudaErrorInvalidValue.
int minplus_f32_launch(const float* A, const float* B, float* C, float* P,
                       int M, int N, int K, int kps, int splits, int vec,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 16 && N % 4 == 0 && aligned(16, B, C, P)) {
    return launch_f32<16>(A, B, C, P, M, N, K, kps, splits, st);
  }
  if (vec == 4) return launch_f32<4>(A, B, C, P, M, N, K, kps, splits, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The int16 form, same arguments; vec: bytes per copy of A and B, 16 (K and
// N multiples of 8, 16-byte aligned), 4 (K and N even, 4-byte aligned) or 2.
int minplus_hops_launch(const int16_t* A, const int16_t* B, int16_t* C,
                        int16_t* P, int M, int N, int K, int kps, int splits,
                        int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 16 && K % 8 == 0 && N % 8 == 0 && aligned(16, A, B, C, P)) {
    return launch_hops<16>(A, B, C, P, M, N, K, kps, splits, st);
  }
  if (vec == 4 && K % 2 == 0 && N % 2 == 0 && aligned(4, A, B, C, P)) {
    return launch_hops<4>(A, B, C, P, M, N, K, kps, splits, st);
  }
  if (vec == 2) return launch_hops<2>(A, B, C, P, M, N, K, kps, splits, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// blocks x 256 threads x iters x 128 add-min instructions of `kind`.
int minplus_rate_launch(unsigned* out, int kind, int blocks, int iters,
                        unsigned b, unsigned c, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  minplus_rate_kernel<<<blocks, THREADS, 0, st>>>(out, kind, iters, b, c);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
