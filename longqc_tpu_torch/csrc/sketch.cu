// B1: sequential (w,k)-minimizer sketch over packed multi-read rows.
//
// Replaces the Pallas kernel longqc_tpu/ops/sketch_pallas.py
// (_make_kernel / _sketch_pallas_t): the reference's sequential
// sketch (minimap2-coverage sketch.c:76-142) streamed column by column
// with the k-mer registers, the w-slot minimizer ring and the tracked
// minimum held per row.
//
// Design: one thread owns one packed row (up to 64 reads laid
// back-to-back behind w-1 ambiguous separator columns) and walks its W
// columns in order. Because one thread owns the row, every emission is
// added straight to the column it belongs to (emit[] of an earlier
// column of the same row): no atomics, and no attribution window, so
// the TPU kernel's 128-column output ring and its per-lane overflow
// flag have no counterpart here. Outputs are separate emit/hash/rid/
// pos/strand arrays (no 15-bit meta packing), so any W works.
//
// Bound: the per-row recurrence is serial; the work is ~W * (w + 30)
// integer ops per row and R rows run in parallel, so the kernel is
// latency-bound at small R (a 256-row tile occupies 8 SMs). A later
// version can split rows into column chunks with a warm-up overlap.
//
// Edge rules (all as the Pallas kernel and the oracle):
//  - symmetric k-mers neither push a ring entry nor advance the cursor;
//  - ambiguous bases push a sentinel entry and reset l;
//  - the first-window rescan (l == w+k-1) excludes the just-pushed slot,
//    the eviction rescan includes it, and its min prefers the newest
//    column;
//  - a read's final push fires at its end-mask column, gated on the
//    tracked minimum belonging to the current segment.

#include <cuda_runtime.h>
#include <stdint.h>

#include "kernels.h"

#define LQ_SENT 0x7FFFFFFF
#define LQ_RPR 64          // reads per packed row
#define LQ_MAXW 32         // ring slots (w <= 32)
#define LQ_NOCOL (-(1 << 20))

__device__ __forceinline__ uint32_t lq_hash32(uint32_t key, uint32_t mask) {
  // sketch.c hash64 on 2k <= 30-bit keys; wraps mod 2^32 exactly like
  // the u32 fast path of ops/sketch.hash64
  key = (~key + (key << 21)) & mask;
  key = key ^ (key >> 24);
  key = ((key + (key << 3)) + (key << 8)) & mask;
  key = key ^ (key >> 14);
  key = ((key + (key << 2)) + (key << 4)) & mask;
  key = key ^ (key >> 28);
  key = (key + (key << 31)) & mask;
  return key;
}

__device__ __forceinline__ bool lq_bit(const uint32_t* words, int j) {
  return (words[j >> 5] >> (j & 31)) & 1u;
}

__global__ void lq_sketch_rows_kernel(
    const uint32_t* __restrict__ codes2, const uint32_t* __restrict__ nmask,
    const uint32_t* __restrict__ smask, const uint32_t* __restrict__ emask,
    const int32_t* __restrict__ starts, const int32_t* __restrict__ gids,
    int32_t* __restrict__ emit, int32_t* __restrict__ hash,
    int32_t* __restrict__ rid, int32_t* __restrict__ pos,
    int32_t* __restrict__ strand, int R, int W, int k, int w) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const uint32_t mask = (1u << (2 * k)) - 1u;
  const int shift1 = 2 * (k - 1);
  const size_t roff = (size_t)r * W;
  const uint32_t* c2 = codes2 + (size_t)r * (W / 16);
  const uint32_t* nm = nmask + (size_t)r * (W / 32);
  const uint32_t* sb = smask + (size_t)r * (W / 32);
  const uint32_t* eb = emask + (size_t)r * (W / 32);
  int32_t* oe = emit + roff;

  uint32_t k0 = 0, k1 = 0;
  int lc = 0, bp = 0, seg = -1, segst = 0, curg = 0, curs = 0;
  int minh = LQ_SENT, miny = 0, minc = LQ_NOCOL, mins = 0;
  int rh[LQ_MAXW], ry[LQ_MAXW], rc[LQ_MAXW];
  for (int s = 0; s < w; ++s) {
    rh[s] = LQ_SENT;
    ry[s] = 0;
    rc[s] = LQ_NOCOL;
  }

  for (int j = 0; j < W; ++j) {
    const uint32_t c = (c2[j >> 4] >> (2 * (j & 15))) & 3u;
    const bool valid = !lq_bit(nm, j);
    if (lq_bit(sb, j)) {  // a new read (segment) starts at this column
      seg += 1;
      segst = j;
      const bool in = seg < LQ_RPR;
      curg = in ? gids[r * LQ_RPR + seg] : 0;
      curs = in ? starts[r * LQ_RPR + seg] : 0;
    }
    oe[j] = 0;  // emissions to column j only come at steps >= j

    if (valid) {
      k0 = ((k0 << 2) | c) & mask;
      k1 = (k1 >> 2) | ((3u ^ c) << shift1);
    }
    const bool sym = valid && (k0 == k1);
    const bool push = !sym;
    const int l_new = valid ? (sym ? lc : lc + 1) : 0;
    lc = l_new;
    const int z = (k0 < k1) ? 0 : 1;
    const int h = (int)lq_hash32(k0 < k1 ? k0 : k1, mask);
    const bool elig = valid && !sym && l_new >= k;
    const int ih = elig ? h : LQ_SENT;
    const int iy = ((j - curs) << 1) | z;

    // stage this column's record (callers mask non-emitting columns)
    const bool rec_on = push && valid;
    hash[roff + j] = rec_on ? ih : 0;
    rid[roff + j] = rec_on ? curg : 0;
    pos[roff + j] = rec_on ? (j - curs) : 0;
    strand[roff + j] = rec_on ? z : 0;

    if (push) {
      rh[bp] = ih;
      ry[bp] = iy;
      rc[bp] = j;
    }
    // E1: first full window; ties with the tracked min (pushed slot
    // excluded)
    if (push && l_new == w + k - 1 && minh != LQ_SENT) {
      for (int s = 0; s < w; ++s)
        if (s != bp && rh[s] == minh && ry[s] != miny) oe[rc[s]] += 1;
    }
    // E2 (replace push) / E3 (min eviction) emit the old tracked min
    const bool cr = push && ih <= minh;
    const bool ce = push && !cr && bp == mins;
    if (minh != LQ_SENT && ((cr && l_new >= w + k) ||
                            (ce && l_new >= w + k - 1)))
      oe[minc] += 1;
    if (ce) {
      // rescan: min over the ring, ties -> newest column
      int nmh = LQ_SENT;
      for (int s = 0; s < w; ++s) nmh = rh[s] < nmh ? rh[s] : nmh;
      int nmc = LQ_NOCOL;
      for (int s = 0; s < w; ++s)
        if (rh[s] == nmh && rc[s] > nmc) nmc = rc[s];
      int nms = 0, nmy = 0;
      for (int s = 0; s < w; ++s)
        if (rh[s] == nmh && rc[s] == nmc) {
          nms = s > nms ? s : nms;
          nmy = ry[s] > nmy ? ry[s] : nmy;
        }
      if (l_new >= w + k - 1 && nmh != LQ_SENT) {
        for (int s = 0; s < w; ++s)
          if (rh[s] == nmh && ry[s] != nmy) oe[rc[s]] += 1;
      }
      minh = nmh;
      miny = nmy;
      minc = nmc;
      mins = nms;
    } else if (cr) {
      minh = ih;
      miny = iy;
      minc = j;
      mins = bp;
    }
    // read end: the standalone read's final push
    if (lq_bit(eb, j) && minh != LQ_SENT && minc >= segst) oe[minc] += 1;
    if (push) bp = (bp + 1 == w) ? 0 : bp + 1;
  }
}

extern "C" int lq_sketch_rows(const void* codes2, const void* nmask,
                              const void* smask, const void* emask,
                              const void* starts, const void* gids,
                              void* emit, void* hash, void* rid, void* pos,
                              void* strand, int R, int W, int k, int w,
                              void* stream) {
  const int threads = 32;
  const int blocks = (R + threads - 1) / threads;
  if (R > 0)
    lq_sketch_rows_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)codes2, (const uint32_t*)nmask,
        (const uint32_t*)smask, (const uint32_t*)emask,
        (const int32_t*)starts, (const int32_t*)gids, (int32_t*)emit,
        (int32_t*)hash, (int32_t*)rid, (int32_t*)pos, (int32_t*)strand, R,
        W, k, w);
  return (int)cudaGetLastError();
}
