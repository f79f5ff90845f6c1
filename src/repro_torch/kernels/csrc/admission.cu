// Fused admissibility + simplicity prune for Hopper (sm_90a):
//   ok[m, c] = dvals[m, c] <= rem[m]  and  cand[m, c] not in pref[m, 0:W]
//
// Replaces: src/repro/kernels/admission.py admission_kernel, the per-level
// prune of the batched path enumerator (routing._admission_mask).
//
// What bounds it on the H100: bytes.  It reads dvals and cand (4 bytes each
// per cell), rem and the (M, W) prefixes once, and writes one byte per cell;
// the W comparisons per cell are integer compares.  The prefix rows are tiny
// (W <= 8 at the paper's diameters) and the threads of a row read the same
// prefix words, which the L1 cache serves.
//
// Design: one thread per (m, c) cell of the flattened mask, neighbouring
// threads on neighbouring cells, so every load and the int8 store coalesce.
// The Pallas kernel built a (bm, bc) boolean accumulator with a fori_loop
// over W; here each thread loops over its row's W prefix entries itself.
// No padding is needed: the grid covers exactly M * C cells.  The result is
// exact (comparisons only) and equals the plain version bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void admission_kernel(const float* __restrict__ dvals,
                                 const float* __restrict__ rem,
                                 const int32_t* __restrict__ cand,
                                 const int32_t* __restrict__ pref,
                                 int8_t* __restrict__ out, unsigned int cells,
                                 unsigned int C, int W) {
  // 32-bit indices (the wrapper keeps M * C below 2^31): a 64-bit division
  // per cell costs more than the cell's loads.
  const unsigned int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= cells) return;
  const unsigned int m = idx / C;
  bool ok = dvals[idx] <= rem[m];
  const int32_t c = cand[idx];
  const int32_t* pr = pref + (size_t)m * W;
  for (int t = 0; t < W; ++t) ok = ok && (pr[t] != c);
  out[idx] = ok ? 1 : 0;
}

}  // namespace

extern "C" {

// dvals (M, C) f32, rem (M,) f32, cand (M, C) int32, pref (M, W) int32,
// out (M, C) int8; all contiguous on the device.
int admission_launch(const float* dvals, const float* rem, const int32_t* cand,
                     const int32_t* pref, int8_t* out, int M, int C, int W,
                     void* stream) {
  const long long cells = (long long)M * C;
  if (cells <= 0) return 0;
  if (cells >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  const long long blocks = (cells + threads - 1) / threads;
  admission_kernel<<<(unsigned int)blocks, threads, 0, st>>>(
      dvals, rem, cand, pref, out, (unsigned int)cells, (unsigned int)C, W);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
