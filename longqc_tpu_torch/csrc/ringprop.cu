// B3 peak pass and B4 min-rank pass over the chain-DP parent forest.
//
// Replace the Pallas kernels of longqc_tpu/ops/ringprop.py
// (_make_peak_kernel / peak_pass and _make_minrank_kernel /
// minrank_pass). On the TPU both stream anchor blocks through a
// sequential grid with J-deep rings in VMEM, because a kernel cannot
// address the row it is writing. Here they compute, per row of the
// (Q, A) row-major int32 arrays, for any J from 1 to A:
//
//   peak (forward):   peak[i] = peak[p[i]] when v[i] > f[i], p[i] >= 0
//                     and 1 <= i - p[i] <= J; -1 when the walk applies
//                     but p[i] >= i; else i  (the walk of chain.c:96-99)
//   min-rank (back):  r[i] = min(own[i], min{r[j] : p[j] == i,
//                     1 <= j - i <= J})  (ops/chainsel's closed form of
//                     the greedy backtrack: the subtree minimum of the
//                     parent forest, edges inside the window only)
//
// A parent index outside [i-J, i) reads as the TPU kernel's empty ring
// slot: -1 (p >= i) or i (p < i - J) for peak, no edge for min-rank.
//
// Bound: bytes. Each anchor is read once and written once: 4 (B3: f, v,
// p, peak) or 3 (B4: p, own, r) arrays x Q x A x 4 B; the arithmetic is
// a few integer operations per anchor. What keeps a kernel from that
// bound is latency: the passes chase parent pointers, so an anchor-by-
// anchor walk pays one dependent memory round trip per anchor. The
// design takes the chase out of device memory and makes it logarithmic:
//
//  * One block of 1024 threads per row (Q = 128 rows are one wave on
//    the card's 132 SMs). The block walks its row in chunks of C = 4096
//    anchors: B3 forward, B4 backward from the last chunk.
//  * Each chunk is staged in dynamic shared memory by coalesced 4-byte
//    cp.async copies (any A, any row alignment), double-buffered: the
//    next chunk loads while this one resolves. Results are written back
//    coalesced.
//  * B3 resolves a chunk by pointer jumping in shared memory. A state
//    word holds either a final peak (as peak + 1 >= 0) or an in-chunk
//    pointer (as -1 - local index). Every pointer goes strictly back,
//    so jumping ends within ceil(log2 C) rounds. A parent in an earlier
//    chunk is final already: it is read from the row's output, which
//    this block wrote before a __syncthreads. A round is "st[i] =
//    st[st[i]]" for unresolved i, in place: a word read while its owner
//    rewrites it is either its old or its new state, and both are true
//    statements about the same peak.
//  * B4 takes the subtree minimum by doubling: M[i] starts as
//    min(own[i], pending[i]) and anc[i] as the in-chunk parent; round k
//    pushes M[j] to the ancestor 2^k above j (shared atomicMin) and
//    jumps anc[j] to anc[anc[j]]. After round k, M[i] covers the
//    descendants less than 2^(k+1) below it, so ceil(log2 C) rounds
//    finish a chunk. (An in-chunk descendant's path to i stays in the
//    chunk, since parents precede children.) The M array is updated in
//    place: a value read mid-round is a minimum over true descendants
//    and at least the round's input, so it only helps; anc is
//    double-buffered through registers. Rounds stop as soon as no
//    finite M has an ancestor left to push to. This replaces the
//    walkers-with-a-stop-rule scheme: a walker climbs one parent per
//    dependent step, so a chain of depth D costs D steps, where the
//    doubling costs log2 D rounds whatever the shape.
//  * B4 hands a chunk root's final M to its parent in an earlier chunk
//    through the output row itself: a per-row bitmask in shared memory
//    marks which anchors hold a pending value. The first handoff to an
//    anchor (atomicOr finds its bit clear) stores the value; after a
//    __syncthreads the others atomicMin into it. A chunk reads its
//    pending values (L2, not L1) only for marked anchors, so the row
//    needs no INF32 pre-pass. The mask takes A / 8 bytes: up to
//    A = 2^20 it lives in shared memory; past that the caller hands in
//    a (Q, ceil(A / 32)) word array in device memory (`gmark`), which
//    the block clears and reads through L2, like the pending values.

#include <cuda_runtime.h>
#include <stdint.h>

#include "kernels.h"

#define LQ_INF32 0x7FFFFFFF
#define RP_CHUNK 4096                     // anchors per chunk
#define RP_THREADS 1024                   // threads per block (one row)
#define RP_EPT (RP_CHUNK / RP_THREADS)    // anchors per thread per chunk
#define RP_SMEM_MARK_A (1 << 20)          // B4's pending mask fits smem

namespace {

__device__ __forceinline__ void cp_async4(int32_t* dst, const int32_t* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// stage n int32 of src into dst (coalesced, one group per caller)
__device__ __forceinline__ void stage(int32_t* dst, const int32_t* src,
                                      int n) {
  for (int i = threadIdx.x; i < n; i += RP_THREADS)
    cp_async4(dst + i, src + i);
}

__global__ void __launch_bounds__(RP_THREADS, 1)
    lq_peak_kernel(const int32_t* __restrict__ f,
                   const int32_t* __restrict__ v,
                   const int32_t* __restrict__ p, int32_t* peak, int A,
                   int J) {
  extern __shared__ int32_t sm[];
  int32_t* st = sm;                   // C state words
  int32_t* buf = sm + RP_CHUNK;       // 2 buffers x (f, v, p) x C
  const size_t b = (size_t)blockIdx.x * A;
  const int nch = (A + RP_CHUNK - 1) / RP_CHUNK;
  const int tid = threadIdx.x;

  auto load = [&](int c) {
    const int c0 = c * RP_CHUNK, n = min(RP_CHUNK, A - c0);
    int32_t* d = buf + (c & 1) * 3 * RP_CHUNK;
    stage(d, f + b + c0, n);
    stage(d + RP_CHUNK, v + b + c0, n);
    stage(d + 2 * RP_CHUNK, p + b + c0, n);
    cp_async_commit();
  };

  load(0);
  for (int c = 0; c < nch; ++c) {
    const int c0 = c * RP_CHUNK, n = min(RP_CHUNK, A - c0);
    if (c + 1 < nch) {
      load(c + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    // chunk c staged; the previous chunks' peaks are written
    __syncthreads();
    const int32_t* sf = buf + (c & 1) * 3 * RP_CHUNK;
    const int32_t* sv = sf + RP_CHUNK;
    const int32_t* sp = sv + RP_CHUNK;
    bool more = false;
#pragma unroll
    for (int e = 0; e < RP_EPT; ++e) {
      const int i = tid + e * RP_THREADS;
      if (i < n) {
        const int gi = c0 + i, pi = sp[i];
        int w;
        if (!(sv[i] > sf[i] && pi >= 0 && gi - pi <= J))
          w = gi + 1;                          // terminal: own index
        else if (pi >= gi)
          w = 0;                               // garbage parent: -1
        else if (pi >= c0)
          w = -1 - (pi - c0);                  // in-chunk pointer
        else
          w = __ldcg(peak + b + pi) + 1;       // earlier chunk: final
        st[i] = w;
        more |= w < 0;
      }
    }
    volatile int32_t* vs = st;
    while (__syncthreads_or(more)) {
      more = false;
#pragma unroll
      for (int e = 0; e < RP_EPT; ++e) {
        const int i = tid + e * RP_THREADS;
        if (i < n) {
          int w = vs[i];
          if (w < 0) {
            w = vs[-1 - w];
            vs[i] = w;
            more |= w < 0;
          }
        }
      }
    }
#pragma unroll
    for (int e = 0; e < RP_EPT; ++e) {
      const int i = tid + e * RP_THREADS;
      if (i < n) peak[b + c0 + i] = st[i] - 1;
    }
  }
}

__global__ void __launch_bounds__(RP_THREADS, 1)
    lq_minrank_kernel(const int32_t* __restrict__ p,
                      const int32_t* __restrict__ own, int32_t* r, int A,
                      int J, uint32_t* gmark) {
  extern __shared__ int32_t sm[];
  int32_t* M = sm;                    // C subtree minima
  int32_t* anc = M + RP_CHUNK;        // C ancestor pointers (-1: none)
  int32_t* buf = anc + RP_CHUNK;      // 2 buffers x (p, own) x C
  const size_t b = (size_t)blockIdx.x * A;
  const int nch = (A + RP_CHUNK - 1) / RP_CHUNK;
  const int tid = threadIdx.x;
  const int words = (A + 31) / 32;
  // pending bits of the row: shared memory, or the row's words of gmark
  uint32_t* mark = gmark ? gmark + (size_t)blockIdx.x * words
                         : (uint32_t*)(buf + 4 * RP_CHUNK);

  for (int k = tid; k < words; k += RP_THREADS) mark[k] = 0u;

  // step s handles chunk nch - 1 - s (the row backwards)
  auto load = [&](int s) {
    const int c0 = (nch - 1 - s) * RP_CHUNK, n = min(RP_CHUNK, A - c0);
    int32_t* d = buf + (s & 1) * 2 * RP_CHUNK;
    stage(d, p + b + c0, n);
    stage(d + RP_CHUNK, own + b + c0, n);
    cp_async_commit();
  };

  load(0);
  for (int s = 0; s < nch; ++s) {
    const int c0 = (nch - 1 - s) * RP_CHUNK, n = min(RP_CHUNK, A - c0);
    if (s + 1 < nch) {
      load(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    // chunk staged; every handoff from later chunks has landed
    __syncthreads();
    const int32_t* sp = buf + (s & 1) * 2 * RP_CHUNK;
    const int32_t* so = sp + RP_CHUNK;
    int hand[RP_EPT];                 // parent in an earlier chunk, or -1
    bool more = false;
#pragma unroll
    for (int e = 0; e < RP_EPT; ++e) {
      const int i = tid + e * RP_THREADS;
      hand[e] = -1;
      if (i < n) {
        const int gi = c0 + i, pi = sp[i];
        int m = so[i];
        const uint32_t mw = gmark ? __ldcg(mark + (gi >> 5)) : mark[gi >> 5];
        if ((mw >> (gi & 31)) & 1u) m = min(m, __ldcg(r + b + gi));
        int a = -1;
        if (pi >= 0 && pi < gi && gi - pi <= J) {
          if (pi >= c0)
            a = pi - c0;
          else
            hand[e] = pi;
        }
        M[i] = m;
        anc[i] = a;
        more |= a >= 0 && m != LQ_INF32;
      }
    }
    volatile int32_t* vM = M;
    while (__syncthreads_or(more)) {
      int nxt[RP_EPT];
#pragma unroll
      for (int e = 0; e < RP_EPT; ++e) {
        const int i = tid + e * RP_THREADS;
        nxt[e] = -1;
        if (i < n) {
          const int a = anc[i];
          if (a >= 0) {
            const int m = vM[i];
            if (m < vM[a]) atomicMin(&M[a], m);
            nxt[e] = anc[a];
          }
        }
      }
      __syncthreads();
      more = false;
#pragma unroll
      for (int e = 0; e < RP_EPT; ++e) {
        const int i = tid + e * RP_THREADS;
        if (i < n) {
          anc[i] = nxt[e];
          more |= nxt[e] >= 0 && vM[i] != LQ_INF32;
        }
      }
    }
    // M is final: write the chunk, hand chunk roots to earlier chunks
    bool lose[RP_EPT];
#pragma unroll
    for (int e = 0; e < RP_EPT; ++e) {
      const int i = tid + e * RP_THREADS;
      lose[e] = false;
      if (i < n) {
        const int m = M[i], hp = hand[e];
        r[b + c0 + i] = m;
        if (hp >= 0 && m != LQ_INF32) {
          const uint32_t bit = 1u << (hp & 31);
          if (atomicOr(&mark[hp >> 5], bit) & bit) {
            lose[e] = true;
          } else {
            r[b + hp] = m;
            __threadfence();
          }
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < RP_EPT; ++e) {
      const int i = tid + e * RP_THREADS;
      if (lose[e]) {
        atomicMin(r + b + hand[e], M[i]);
        __threadfence();
      }
    }
  }
}

}  // namespace

extern "C" int lq_peak_pass(const void* f, const void* v, const void* p,
                            void* peak, int Q, int A, int J, void* stream) {
  if (Q <= 0 || A <= 0) return 0;
  const int smem = 7 * RP_CHUNK * (int)sizeof(int32_t);
  cudaError_t e = cudaFuncSetAttribute(
      lq_peak_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  lq_peak_kernel<<<Q, RP_THREADS, smem, (cudaStream_t)stream>>>(
      (const int32_t*)f, (const int32_t*)v, (const int32_t*)p,
      (int32_t*)peak, A, J);
  return (int)cudaGetLastError();
}

extern "C" int lq_minrank_pass(const void* p, const void* own, void* r,
                               void* mark, int Q, int A, int J,
                               void* stream) {
  if (Q <= 0 || A <= 0) return 0;
  if (A > RP_SMEM_MARK_A && !mark) return (int)cudaErrorInvalidValue;
  const int smem = 6 * RP_CHUNK * (int)sizeof(int32_t) +
                   (mark ? 0 : (A + 31) / 32 * (int)sizeof(uint32_t));
  cudaError_t e = cudaFuncSetAttribute(
      lq_minrank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  lq_minrank_kernel<<<Q, RP_THREADS, smem, (cudaStream_t)stream>>>(
      (const int32_t*)p, (const int32_t*)own, (int32_t*)r, A, J,
      (uint32_t*)mark);
  return (int)cudaGetLastError();
}
