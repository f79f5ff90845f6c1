// Fused congestion kernel for Hopper (sm_90a): loads = B^T r and costs = B w
// from ONE read of the {0,1} path x slot incidence B, for one (P, S)
// incidence or a stack of Bt members, each with its own extent (P_b, S_b).
//
// Replaces: src/repro/kernels/congestion.py congestion_kernel (single) and
// congestion_batch_kernel (rank-3 stack).  One kernel serves both: the batch
// member is blockIdx.y, and a rank-2 call is a batch of one.
//
// What bounds it on the H100: bytes.  B is read once (4 bytes per entry,
// 1.79 GB per member at the Fig 1c probe's 34,456 x 12,960 shape), against
// two FMAs per entry; at 3.35 TB/s that is >= 0.53 ms per member and
// iteration, far below any compute limit.  What the design does about it:
//
//  * Member-sized grid.  Member b is the block (P_b, S_b) at the top left of
//    its (P, S) slice; its extents arrive by value with the launch.  No row
//    at or past P_b and no column at or past S_b is ever read, and every
//    output beyond them is written as an exact zero.  A band wholly past
//    P_b (every band of an empty filler member) writes its zero costs and
//    exits, and the fold stops at the member's last band.  The batched
//    solver's stack is bucketed and carries an empty filler member: 43 % of
//    its bytes are padding that this grid never touches.
//  * Bytes in flight.  A block owns a band of BAND = 64 rows and walks its
//    columns in tiles of TC = 256, each cut into four stages of TR = 16
//    rows (16 KB) that a 4-stage cp.async ring fills with 16-byte copies
//    (8- or 4-byte copies when S is not a multiple of 4): three stages are
//    in flight while one is summed, and no thread waits on its own loads of
//    B.  The 64 per-row cost accumulators stay in registers, which with the
//    loads staged in shared memory take at most 128 a thread: two blocks (and
//    six stages in flight) share an SM.
//  * Sums: thread t owns column t of every tile.  Loads: it adds
//    B[p, t] * r[p] down the band's 64 rows in row order; each band's
//    partial goes to scratch, and a second pass (the fold) sums the
//    partials of column s in band order.  Costs: it adds B[p, t] * w[t]
//    into row p's accumulator tile after tile; at the band's end a fixed
//    shuffle tree sums each warp's 32 accumulators of a row, and the 8 warp
//    sums are added in warp order.
//
// Why 64 accumulators a thread and not a cheaper cost tree per tile: the
// summation order fixes the MW solver's results to the bit, and its anneal
// amplifies any change of order into alpha drift of the order of 1e-3 at
// the Fig 1c probe.  This order (a column per thread, 64-row bands, the
// shuffle tree and warp order below) is the one the solver's recorded
// results were computed with, so the speed of the kernel changes and no
// number the solver computes does.
//
// No atomics: every sum is taken in an order fixed by absolute positions
// (band boundaries, column-tile boundaries, which thread takes which column,
// the shape of every shuffle tree), never by a member's extent or by S, and
// a position outside the extent enters as +0.  So a member of a stacked call
// with extents equals the single call on its unpadded (P_b, S_b) incidence
// bit for bit, and so does a zero-padded member without extents (the
// property the speculative bisection's wave == sequential identity rests
// on).
//
// The Pallas kernel accumulated across sequential grid steps
// (pl.when(... == 0) then +=); CUDA blocks run in no order, so the P
// direction's accumulation becomes the ordered fold instead.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int THREADS = 256;  // threads per block of the band pass
constexpr int WARPS = THREADS / 32;
constexpr int BAND = 64;      // rows of B per band (one block)
constexpr int TR = 16;        // rows per stage
constexpr int SUBS = BAND / TR;  // stages per column tile
constexpr int TC = THREADS;   // columns per tile: one column per thread
constexpr int STAGES = 4;     // cp.async ring depth
constexpr int MAXB = 128;     // members per launch (extents passed by value)
constexpr int SMEM_BYTES = STAGES * TR * TC * 4;
static_assert(BAND % TR == 0 && BAND <= THREADS, "band rows");

struct Extents {
  int rows[MAXB];
  int cols[MAXB];
};

// V: floats per copy of B (4, 2 or 1): S % V == 0 and B aligned to 4V bytes.
template <int V>
__global__ void __launch_bounds__(THREADS, 2)
congestion_band_kernel(const float* __restrict__ B, const float* __restrict__ r,
                       const float* __restrict__ w, float* __restrict__ costs,
                       float* __restrict__ partial, Extents ext, int P, int S,
                       int n_bands) {
  const int band = blockIdx.x;
  const int bt = blockIdx.y;
  const int Pb = ext.rows[bt];
  const int Sb = ext.cols[bt];
  const int p0 = band * BAND;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float* cm = costs + (size_t)bt * P;
  if (p0 >= Pb) {  // band wholly past the member's rows
    if (tid < BAND && p0 + tid < P) cm[p0 + tid] = 0.0f;
    return;
  }
  const float* Bm = B + (size_t)bt * P * S;
  const float* wm = w + (size_t)bt * S;
  float* part = partial + ((size_t)bt * n_bands + band) * S;
  const int n_ct = (Sb + TC - 1) / TC;
  // stage q: rows (q % SUBS) * TR.. of column tile q / SUBS
  const int n_q = n_ct * SUBS;

  __shared__ float r_sh[BAND];
  __shared__ float red[WARPS][BAND];
  extern __shared__ __align__(16) float ring[];  // STAGES x TR x TC
  if (tid < BAND) {
    r_sh[tid] = p0 + tid < Pb ? r[(size_t)bt * P + p0 + tid] : 0.0f;
  }

  auto issue = [&](int q) {
    float* st = ring + (q % STAGES) * TR * TC;
    const int c0 = (q / SUBS) * TC;
    const int pr = p0 + (q % SUBS) * TR;
    constexpr int CPR = TC / V;  // copies per tile row
    for (int e = tid; e < TR * CPR; e += THREADS) {
      const int i = e / CPR;
      const int col = c0 + (e - i * CPR) * V;
      const int p = pr + i;
      const int n = (p < Pb && col < Sb) ? min(V, Sb - col) : 0;
      cpasync::copy<4 * V>(st + i * TC + (col - c0),
                           n ? Bm + (size_t)p * S + col : Bm, 4 * n);
    }
  };

  float cacc[BAND];
#pragma unroll
  for (int i = 0; i < BAND; ++i) cacc[i] = 0.0f;
#pragma unroll
  for (int q = 0; q < STAGES - 1; ++q) {
    if (q < n_q) issue(q);
    cpasync::commit();
  }
  float ws = tid < Sb ? wm[tid] : 0.0f;
  for (int ct = 0; ct < n_ct; ++ct) {
    const int s = ct * TC + tid;
    const float ws_next = s + TC < Sb ? wm[s + TC] : 0.0f;
    float lacc = 0.0f;
#pragma unroll
    for (int rs = 0; rs < SUBS; ++rs) {
      const int q = ct * SUBS + rs;
      cpasync::wait<STAGES - 2>();  // stage q has landed
      __syncthreads();  // ... for every thread; stage q - 1 is free again
      if (q + STAGES - 1 < n_q) issue(q + STAGES - 1);
      cpasync::commit();
      const float* tile = ring + (q % STAGES) * TR * TC + tid;
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const float b = tile[i * TC];
        lacc = fmaf(b, r_sh[rs * TR + i], lacc);
        cacc[rs * TR + i] = fmaf(b, ws, cacc[rs * TR + i]);
      }
    }
    if (s < Sb) part[s] = lacc;
    ws = ws_next;
  }
  cpasync::wait<0>();

#pragma unroll
  for (int i = 0; i < BAND; ++i) {
    float v = cacc[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v += __shfl_down_sync(0xffffffffu, v, off);
    }
    if (lane == 0) red[warp][i] = v;
  }
  __syncthreads();
  if (tid < BAND && p0 + tid < P) {
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < WARPS; ++k) acc += red[k][tid];
    cm[p0 + tid] = p0 + tid < Pb ? acc : 0.0f;
  }
}

// loads[s] = the band partials of column s summed in band order, over the
// member's bands; 0 at s >= S_b.
__global__ void congestion_fold_kernel(const float* __restrict__ partial,
                                       float* __restrict__ loads, Extents ext,
                                       int S, int n_bands) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  const int bt = blockIdx.y;
  if (s >= S) return;
  float acc = 0.0f;
  if (s < ext.cols[bt]) {
    const int nb = (ext.rows[bt] + BAND - 1) / BAND;
    const float* col = partial + (size_t)bt * n_bands * S + s;
#pragma unroll 8
    for (int b = 0; b < nb; ++b) acc += col[(size_t)b * S];
  }
  loads[(size_t)bt * S + s] = acc;
}

template <int V>
int launch(const float* B, const float* r, const float* w, float* loads,
           float* costs, float* partial, const int* rows, const int* cols,
           int Bt, int P, int S, cudaStream_t st) {
  static bool smem_set = false;  // once per instantiation
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        congestion_band_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  const int n_bands = (P + BAND - 1) / BAND;
  for (int b0 = 0; b0 < Bt; b0 += MAXB) {
    const int nb = min(MAXB, Bt - b0);
    Extents ext;
    for (int i = 0; i < nb; ++i) {
      ext.rows[i] = rows[b0 + i];
      ext.cols[i] = cols[b0 + i];
    }
    dim3 grid1(n_bands, nb, 1);
    congestion_band_kernel<V><<<grid1, THREADS, SMEM_BYTES, st>>>(
        B + (size_t)b0 * P * S, r + (size_t)b0 * P, w + (size_t)b0 * S,
        costs + (size_t)b0 * P, partial + (size_t)b0 * n_bands * S, ext, P, S,
        n_bands);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid2((S + 255) / 256, nb, 1);
    congestion_fold_kernel<<<grid2, 256, 0, st>>>(
        partial + (size_t)b0 * n_bands * S, loads + (size_t)b0 * S, ext, S,
        n_bands);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

extern "C" {

// Rows per band; the wrapper sizes the partial-load scratch with it.
int congestion_rows_per_band() { return BAND; }

// B (Bt, P, S), r (Bt, P), w (Bt, S) float32, contiguous, on the device.
// loads (Bt, S), costs (Bt, P) outputs; partial (Bt, ceil(P/BAND), S)
// scratch.  rows, cols: host arrays of the Bt extents, 0 <= rows[b] <= P,
// 0 <= cols[b] <= S.  vec: floats per copy of B, 4, 2 or 1 (S and B's
// address must allow it; refused with cudaErrorInvalidValue otherwise).
int congestion_launch(const float* B, const float* r, const float* w,
                      float* loads, float* costs, float* partial,
                      const int* rows, const int* cols, int Bt, int P, int S,
                      int vec, void* stream) {
  if (Bt <= 0 || P <= 0 || S <= 0) return 0;
  for (int i = 0; i < Bt; ++i) {
    if (rows[i] < 0 || rows[i] > P || cols[i] < 0 || cols[i] > S) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const uintptr_t addr = reinterpret_cast<uintptr_t>(B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 4 && S % 4 == 0 && addr % 16 == 0) {
    return launch<4>(B, r, w, loads, costs, partial, rows, cols, Bt, P, S, st);
  }
  if (vec == 2 && S % 2 == 0 && addr % 8 == 0) {
    return launch<2>(B, r, w, loads, costs, partial, rows, cols, Bt, P, S, st);
  }
  if (vec == 1) {
    return launch<1>(B, r, w, loads, costs, partial, rows, cols, Bt, P, S, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
