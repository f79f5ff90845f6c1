// Fused congestion kernel for Hopper (sm_90a): loads = B^T r and costs = B w
// from ONE read of the {0,1} path x slot incidence B.
//
// Replaces: src/repro/kernels/congestion.py congestion_kernel (single) and
// congestion_batch_kernel (rank-3 stack).  One kernel serves both: the batch
// member is blockIdx.z, and a rank-2 call is a batch of one.
//
// What bounds it on the H100: bytes.  B is read once (4 bytes per entry,
// 1.79 GB per member at the Fig 1c probe's 34,456 x 12,960 shape), against
// two flops per entry; at 3.35 TB/s that is >= 0.53 ms per member and
// iteration, far below any compute limit.  The design keeps every B read
// coalesced and issues many independent loads per thread:
//
//   pass 1  one block per band of ROWS consecutive rows of B.  Thread t
//           walks the band's columns s = t, t + THREADS, ... in index order;
//           for each column it reads the band's ROWS entries (each a 128-byte
//           warp transaction across neighbouring columns), adds r[p] * B[p, s]
//           down the band in row order into that column's partial load, and
//           adds B[p, s] * w[s] into a per-row register accumulator.  The
//           per-row accumulators are then reduced across the block in a
//           fixed tree (warp shuffles, then warps in order) into costs[p].
//           Each band's partial loads go to scratch: partial[band, s].
//   pass 2  one thread per slot sums partial[0..n_bands, s] in band order.
//
// No atomics: every sum is taken in an order fixed by positions alone.  The
// order also makes zero padding exact: padded rows and columns sit at the
// end of every sequence they join and add +0.  So a member of a padded
// batch equals the unpadded single call bit for bit (the property the
// speculative bisection's wave == sequential identity rests on).
//
// The Pallas kernel accumulated across sequential grid steps
// (pl.when(... == 0) then +=); CUDA blocks run in no order, so the P
// direction's accumulation becomes the ordered second pass instead.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 64;      // rows of B per band (one block)
constexpr int THREADS = 256;  // threads per block of pass 1
constexpr int WARPS = THREADS / 32;

__global__ void __launch_bounds__(THREADS)
congestion_band_kernel(const float* __restrict__ B, const float* __restrict__ r,
                       const float* __restrict__ w, float* __restrict__ costs,
                       float* __restrict__ partial, int P, int S, int n_bands) {
  const int band = blockIdx.x;
  const int bt = blockIdx.z;
  const int p0 = band * ROWS;
  const int rows = min(ROWS, P - p0);
  const float* Bm = B + (size_t)bt * P * S + (size_t)p0 * S;
  const float* wm = w + (size_t)bt * S;
  float* part = partial + ((size_t)bt * n_bands + band) * S;

  __shared__ float r_sh[ROWS];
  __shared__ float red[WARPS][ROWS];
  if (threadIdx.x < ROWS) {
    r_sh[threadIdx.x] =
        threadIdx.x < rows ? r[(size_t)bt * P + p0 + threadIdx.x] : 0.0f;
  }
  __syncthreads();

  float cacc[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) cacc[i] = 0.0f;

  for (int s = threadIdx.x; s < S; s += THREADS) {
    const float ws = wm[s];
    float lacc = 0.0f;
    if (rows == ROWS) {
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float b = Bm[(size_t)i * S + s];
        lacc = fmaf(b, r_sh[i], lacc);
        cacc[i] = fmaf(b, ws, cacc[i]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float b = i < rows ? Bm[(size_t)i * S + s] : 0.0f;
        lacc = fmaf(b, r_sh[i], lacc);
        cacc[i] = fmaf(b, ws, cacc[i]);
      }
    }
    part[s] = lacc;
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    float v = cacc[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v += __shfl_down_sync(0xffffffffu, v, off);
    }
    if (lane == 0) red[warp][i] = v;
  }
  __syncthreads();
  if (threadIdx.x < rows) {
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < WARPS; ++k) acc += red[k][threadIdx.x];
    costs[(size_t)bt * P + p0 + threadIdx.x] = acc;
  }
}

__global__ void congestion_fold_kernel(const float* __restrict__ partial,
                                       float* __restrict__ loads, int S,
                                       int n_bands) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  const int bt = blockIdx.y;
  if (s >= S) return;
  const float* col = partial + (size_t)bt * n_bands * S + s;
  float acc = 0.0f;
  for (int b = 0; b < n_bands; ++b) acc += col[(size_t)b * S];
  loads[(size_t)bt * S + s] = acc;
}

}  // namespace

extern "C" {

// Rows per band; the wrapper sizes the partial-load scratch with it.
int congestion_rows_per_band() { return ROWS; }

// B (Bt, P, S), r (Bt, P), w (Bt, S) float32, contiguous, on the device.
// loads (Bt, S), costs (Bt, P) outputs; partial (Bt, ceil(P/ROWS), S) scratch.
int congestion_launch(const float* B, const float* r, const float* w,
                      float* loads, float* costs, float* partial, int Bt,
                      int P, int S, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_bands = (P + ROWS - 1) / ROWS;
  if (Bt <= 0 || P <= 0 || S <= 0) return 0;
  dim3 grid1(n_bands, 1, Bt);
  congestion_band_kernel<<<grid1, THREADS, 0, st>>>(B, r, w, costs, partial, P,
                                                    S, n_bands);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid2((S + 255) / 256, Bt, 1);
  congestion_fold_kernel<<<grid2, 256, 0, st>>>(partial, loads, S, n_bands);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
