// Ordered fan-in loads for Hopper (sm_90a): for every batch member b and
// directed slot s,
//   loads[b, s] = rates[b, t_0 / L] + rates[b, t_1 / L] + ...   (left to right)
// over the slot's fan-in row t_0 < t_1 < ... of flat path-hop positions
// (t = p * L + l), read from a transposed table (Tb, D, S) int32 whose
// column j holds every slot's j-th position, padded with the sentinel P * L.
//
// Replaces no Pallas kernel.  The reference computes the loads-only product
// (its simulator's waterfill, B^T r with no path costs) as a scatter-add
// over the path table, or through congestion_batch_kernel with zero prices.
// That dense kernel stays for the MW solvers, which need the costs too; this
// kernel takes the loads-only calls on the card, where the dense kernel read
// a whole (P, S) incidence for about 7 entries a row.
//
// What bounds it on the H100: at the sim's shape (8 members, P = 24,576,
// S = 10,240, D = 32, about 72,000 path-hop entries a member) the answer
// needs about 3.4 MB a call, 1 us at 3.35 TB/s, so in practice the launch
// latency.  What the design does about it:
//
//  * One thread per (member, slot): the member is blockIdx.y, as in
//    congestion.cu.  Slots at or past a member's S_b write an exact zero and
//    read nothing.  The table is transposed so that a warp's 32 threads read
//    128 contiguous bytes per fan-in column; rates (at most 98 KB a member)
//    stay in L2.
//  * Loads ahead, additions in order: a thread loads CHUNK indices at once,
//    then the CHUNK rates they select, then adds them.  A position p < P * L
//    contributes rates[b, p / L] (L by value: no repeated copy of the rates
//    is made); the sentinel, or any index outside [0, P * L), ends the row.
//    Every real entry is read on every call, whatever its rate.
//
// The sum equals the plain version (kernels/fanin.py, the arithmetic of
// core.flow._ordered_fan_in_sum) bit for bit on a table whose rows list
// their positions first and the sentinel after: the additions run left to
// right starting from the first entry (not from 0.0f), an empty row is +0,
// and a row shorter than D adds the pad's +0.0f once, as the plain version
// does, which turns a -0.0 sum into +0.0.  Every addition is __fadd_rn: no
// contraction, no atomics, no fast-math.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;  // slots per block
constexpr int CHUNK = 8;      // fan-in entries loaded ahead per round
constexpr int MAXB = 128;     // members per launch (slot extents by value)

struct Slots {
  int n[MAXB];
};

__global__ void __launch_bounds__(THREADS)
fan_in_kernel(const int32_t* __restrict__ table, const float* __restrict__ rates,
              float* __restrict__ loads, Slots slots, long long member_stride,
              int P, int L, int S, int D) {
  const int s = blockIdx.x * THREADS + threadIdx.x;
  if (s >= S) return;
  const int bt = blockIdx.y;
  float* out = loads + (size_t)bt * S + s;
  if (s >= slots.n[bt]) {
    *out = 0.0f;
    return;
  }
  const int32_t* col = table + (size_t)bt * member_stride + s;
  const float* r = rates + (size_t)bt * P;
  const unsigned int PL = (unsigned int)P * (unsigned int)L;
  float acc = 0.0f;
  int n = 0;  // real entries added
  bool ended = false;
  for (int j0 = 0; j0 < D && !ended; j0 += CHUNK) {
    unsigned int idx[CHUNK];
    float v[CHUNK];
#pragma unroll
    for (int k = 0; k < CHUNK; ++k) {
      idx[k] = j0 + k < D ? (unsigned int)__ldg(col + (size_t)(j0 + k) * S)
                          : PL;
    }
#pragma unroll
    for (int k = 0; k < CHUNK; ++k) {
      v[k] = idx[k] < PL ? __ldg(r + idx[k] / (unsigned int)L) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < CHUNK; ++k) {
      if (!ended) {
        if (idx[k] < PL) {
          acc = n == 0 ? v[k] : __fadd_rn(acc, v[k]);
          ++n;
        } else {
          ended = true;
        }
      }
    }
  }
  if (n < D) acc = __fadd_rn(acc, 0.0f);  // the plain version's pad
  *out = acc;
}

}  // namespace

extern "C" {

// table (Bt, D, S) int32, or (D, S) shared by every member (shared != 0);
// rates (Bt, P) and loads (Bt, S) float32; all contiguous on the device.
// slots: host array of the Bt real slot counts, 0 <= slots[b] <= S.
// P * L must stay below 2^31 (refused with cudaErrorInvalidValue).
int fan_in_launch(const int32_t* table, const float* rates, float* loads,
                  const int* slots, int Bt, int shared, int P, int L, int S,
                  int D, void* stream) {
  if (Bt <= 0 || S <= 0) return 0;
  if (P < 0 || L <= 0 || D < 0 || (long long)P * L >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int i = 0; i < Bt; ++i) {
    if (slots[i] < 0 || slots[i] > S) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long stride = shared ? 0LL : (long long)D * S;
  for (int b0 = 0; b0 < Bt; b0 += MAXB) {
    const int nb = Bt - b0 < MAXB ? Bt - b0 : MAXB;
    Slots sl;
    for (int i = 0; i < nb; ++i) sl.n[i] = slots[b0 + i];
    dim3 grid((S + THREADS - 1) / THREADS, nb, 1);
    fan_in_kernel<<<grid, THREADS, 0, st>>>(
        table + (size_t)b0 * stride, rates + (size_t)b0 * P,
        loads + (size_t)b0 * S, sl, stride, P, L, S, D);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // extern "C"
