// B3 peak pass and B4 min-rank pass over the chain-DP parent forest.
//
// Replace the Pallas kernels of longqc_tpu/ops/ringprop.py
// (_make_peak_kernel / peak_pass and _make_minrank_kernel /
// minrank_pass). On the TPU both stream anchor blocks with J-deep rings
// in VMEM because a kernel cannot address the row it is writing; here
// one thread owns a row of the (Q, A) row-major arrays and reads and
// writes global memory directly, so no ring is needed:
//
//   peak (forward):   peak[i] = peak[p[i]] when v[i] > f[i], p[i] >= 0
//                     and i - p[i] <= J (parent in the ring window),
//                     else i  (the walk of chain.c:96-99)
//   min-rank (back):  r[i] = min(own[i], min{r[j] : i < j <= i+J,
//                     p[j] == i})  (ops/chainsel's closed form of the
//                     greedy backtrack); each finished r[j] folds into
//                     the running minimum of its parent.
//
// Bound: one dependent global load per anchor per row (latency-bound,
// Q rows in flight). A parent index outside [i-J, i) reads as the
// TPU kernel's empty ring slot: -1 for peak, no contribution for
// min-rank.

#include <cuda_runtime.h>
#include <stdint.h>

#include "kernels.h"

#define LQ_INF32 0x7FFFFFFF

__global__ void lq_peak_kernel(const int32_t* __restrict__ f,
                               const int32_t* __restrict__ v,
                               const int32_t* __restrict__ p,
                               int32_t* __restrict__ peak, int Q, int A,
                               int J) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= Q) return;
  const size_t b = (size_t)row * A;
  for (int i = 0; i < A; ++i) {
    const int pi = p[b + i];
    const int tgt = i - pi;
    int out = i;
    if (v[b + i] > f[b + i] && pi >= 0 && tgt <= J)
      out = tgt >= 1 ? peak[b + pi] : -1;
    peak[b + i] = out;
  }
}

__global__ void lq_minrank_kernel(const int32_t* __restrict__ p,
                                  const int32_t* __restrict__ own,
                                  int32_t* __restrict__ r, int Q, int A,
                                  int J) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= Q) return;
  const size_t b = (size_t)row * A;
  for (int i = 0; i < A; ++i) r[b + i] = LQ_INF32;  // children's minima
  for (int i = A - 1; i >= 0; --i) {
    const int cm = r[b + i];
    const int o = own[b + i];
    const int ri = o < cm ? o : cm;
    r[b + i] = ri;
    const int pi = p[b + i];
    const int d = i - pi;
    if (pi >= 0 && d >= 1 && d <= J && ri < r[b + pi]) r[b + pi] = ri;
  }
}

extern "C" int lq_peak_pass(const void* f, const void* v, const void* p,
                            void* peak, int Q, int A, int J, void* stream) {
  const int threads = 32;
  if (Q > 0)
    lq_peak_kernel<<<(Q + threads - 1) / threads, threads, 0,
                     (cudaStream_t)stream>>>(
        (const int32_t*)f, (const int32_t*)v, (const int32_t*)p,
        (int32_t*)peak, Q, A, J);
  return (int)cudaGetLastError();
}

extern "C" int lq_minrank_pass(const void* p, const void* own, void* r, int Q,
                               int A, int J, void* stream) {
  const int threads = 32;
  if (Q > 0)
    lq_minrank_kernel<<<(Q + threads - 1) / threads, threads, 0,
                        (cudaStream_t)stream>>>(
        (const int32_t*)p, (const int32_t*)own, (int32_t*)r, Q, A, J);
  return (int)cudaGetLastError();
}
