// B1: (w,k)-minimizer sketch over packed multi-read rows, column chunks
// in parallel.
//
// Replaces the Pallas kernel longqc_tpu/ops/sketch_pallas.py
// (_make_kernel / _sketch_pallas_t): the reference's sequential
// sketch (minimap2-coverage sketch.c:76-142) streamed column by column
// with the k-mer registers, the w-slot minimizer ring and the tracked
// minimum held per row.
//
// Design: each row is cut into column chunks of CH columns and one
// thread runs one chunk, so a tile runs R * ceil(W / CH) threads. A
// chunk replays the sequential recurrence from a clean state starting
// at its warm-up column s0 (the (w+k)-th push before the chunk, or the
// row start), with the k-mer registers and the segment state at s0
// preloaded from the chunk plan (ops/sketch_cuda.chunk_plan, plain
// tensor ops). It adds only the emissions decided at its own columns
// and writes hash / rid / pos / strand only for its own columns. Why
// the warm-up reproduces the state: the ring holds the last w pushes
// (every column but a symmetric valid one pushes), the tracked minimum
// is always the ring's minimum with ties to the newest column, and l
// either restarts at an N inside the warm-up or has counted w+k
// non-symmetric valid pushes, past every threshold the rules compare it
// with; the registers and the segment come from the plan. An emission
// can land in a column of an earlier chunk, so emit is added with
// atomicAdd into a zeroed array. The ring is a shift register in
// registers (statically indexed, the ring size a template parameter):
// slot 0 is the newest push, slot w-1 the oldest, so the TPU kernel's
// slot bookkeeping becomes a column compare.
//
// Bound: each chunk is a serial chain of ~(CH + warm-up) columns of
// ~w + 30 integer operations; the R * W / CH chains run in parallel.
// Outputs are separate emit/hash/rid/pos/strand arrays (no 15-bit meta
// packing), so any W works.
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
#define LQ_NOCOL (-(1 << 20))
#define LQ_PLAN 5          // s0, seg, segst, k0, k1 per chunk

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

template <int WM>
__global__ void lq_sketch_chunks_kernel(
    const uint32_t* __restrict__ codes2, const uint32_t* __restrict__ nmask,
    const uint32_t* __restrict__ smask, const uint32_t* __restrict__ emask,
    const int32_t* __restrict__ starts, const int32_t* __restrict__ gids,
    const int32_t* __restrict__ plan, int32_t* emit,
    int32_t* __restrict__ hash, int32_t* __restrict__ rid,
    int32_t* __restrict__ pos, int32_t* __restrict__ strand, int R, int W,
    int k, int w, int CH, int NC) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= R * NC) return;
  const int r = tid / NC;
  const int c0 = (tid - r * NC) * CH;
  const int c1 = min(c0 + CH, W);
  const uint32_t mask = (1u << (2 * k)) - 1u;
  const int shift1 = 2 * (k - 1);
  const size_t roff = (size_t)r * W;
  const uint32_t* c2 = codes2 + (size_t)r * (W / 16);
  const uint32_t* nm = nmask + (size_t)r * (W / 32);
  const uint32_t* sb = smask + (size_t)r * (W / 32);
  const uint32_t* eb = emask + (size_t)r * (W / 32);
  int32_t* oe = emit + roff;

  const int32_t* pl = plan + (size_t)tid * LQ_PLAN;
  const int s0 = pl[0];
  int seg = pl[1];
  int segst = pl[2];
  uint32_t k0 = (uint32_t)pl[3], k1 = (uint32_t)pl[4];
  int curg = 0, curs = 0;
  if (seg >= 0 && seg < LQ_RPR) {
    curg = gids[r * LQ_RPR + seg];
    curs = starts[r * LQ_RPR + seg];
  }
  int lc = 0;
  int minh = LQ_SENT, miny = 0, minc = LQ_NOCOL;
  int rh[WM], ry[WM], rc[WM];
#pragma unroll
  for (int s = 0; s < WM; ++s) {
    rh[s] = LQ_SENT;
    ry[s] = 0;
    rc[s] = LQ_NOCOL;
  }

  uint32_t wc = 0, wn = 0, ws = 0, we = 0;
  for (int j = s0; j < c1; ++j) {
    if (j == s0 || (j & 15) == 0) wc = c2[j >> 4];
    if (j == s0 || (j & 31) == 0) {
      wn = nm[j >> 5];
      ws = sb[j >> 5];
      we = eb[j >> 5];
    }
    const int bit = j & 31;
    const uint32_t c = (wc >> (2 * (j & 15))) & 3u;
    const bool valid = !((wn >> bit) & 1u);
    const bool mine = j >= c0;  // emissions decided here are this chunk's
    if ((ws >> bit) & 1u) {  // a new read (segment) starts at this column
      seg += 1;
      segst = j;
      const bool in = seg < LQ_RPR;
      curg = in ? gids[r * LQ_RPR + seg] : 0;
      curs = in ? starts[r * LQ_RPR + seg] : 0;
    }

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

    if (mine) {
      // this column's record (callers mask non-emitting columns)
      const bool rec_on = push && valid;
      hash[roff + j] = rec_on ? ih : 0;
      rid[roff + j] = rec_on ? curg : 0;
      pos[roff + j] = rec_on ? (j - curs) : 0;
      strand[roff + j] = rec_on ? z : 0;
    }

    // push: the oldest entry (slot w-1) leaves, the new one is slot 0
    bool min_evicted = false;
    if (push) {
#pragma unroll
      for (int s = 0; s < WM; ++s)
        if (s == w - 1) min_evicted = rc[s] == minc;
#pragma unroll
      for (int s = WM - 1; s > 0; --s) {
        rh[s] = rh[s - 1];
        ry[s] = ry[s - 1];
        rc[s] = rc[s - 1];
      }
      rh[0] = ih;
      ry[0] = iy;
      rc[0] = j;
    }
    // E1: first full window; ties with the tracked min (pushed slot
    // excluded)
    if (push && l_new == w + k - 1 && minh != LQ_SENT && mine) {
#pragma unroll
      for (int s = 1; s < WM; ++s)
        if (s < w && rh[s] == minh && ry[s] != miny)
          atomicAdd(oe + rc[s], 1);
    }
    // E2 (replace push) / E3 (min eviction) emit the old tracked min
    const bool cr = push && ih <= minh;
    const bool ce = push && !cr && min_evicted;
    if (mine && minh != LQ_SENT &&
        ((cr && l_new >= w + k) || (ce && l_new >= w + k - 1)))
      atomicAdd(oe + minc, 1);
    if (ce) {
      // rescan: min over the ring, ties -> newest column
      int nmh = LQ_SENT;
#pragma unroll
      for (int s = 0; s < WM; ++s)
        if (s < w) nmh = rh[s] < nmh ? rh[s] : nmh;
      int nmc = LQ_NOCOL, nmy = 0;
#pragma unroll
      for (int s = 0; s < WM; ++s)
        if (s < w && rh[s] == nmh && rc[s] > nmc) {
          nmc = rc[s];
          nmy = ry[s];
        }
      if (mine && l_new >= w + k - 1 && nmh != LQ_SENT) {
#pragma unroll
        for (int s = 0; s < WM; ++s)
          if (s < w && rh[s] == nmh && ry[s] != nmy)
            atomicAdd(oe + rc[s], 1);
      }
      minh = nmh;
      miny = nmy;
      minc = nmc;
    } else if (cr) {
      minh = ih;
      miny = iy;
      minc = j;
    }
    // read end: the standalone read's final push
    if (mine && ((we >> bit) & 1u) && minh != LQ_SENT && minc >= segst)
      atomicAdd(oe + minc, 1);
  }
}

template <int WM>
static void lq_sketch_launch(const void* codes2, const void* nmask,
                             const void* smask, const void* emask,
                             const void* starts, const void* gids,
                             const void* plan, void* emit, void* hash,
                             void* rid, void* pos, void* strand, int R, int W,
                             int k, int w, int CH, int NC,
                             cudaStream_t st) {
  const int threads = 128;
  const long long n = (long long)R * NC;
  lq_sketch_chunks_kernel<WM><<<(int)((n + threads - 1) / threads), threads,
                                0, st>>>(
      (const uint32_t*)codes2, (const uint32_t*)nmask, (const uint32_t*)smask,
      (const uint32_t*)emask, (const int32_t*)starts, (const int32_t*)gids,
      (const int32_t*)plan, (int32_t*)emit, (int32_t*)hash, (int32_t*)rid,
      (int32_t*)pos, (int32_t*)strand, R, W, k, w, CH, NC);
}

extern "C" int lq_sketch_rows(const void* codes2, const void* nmask,
                              const void* smask, const void* emask,
                              const void* starts, const void* gids,
                              const void* plan, void* emit, void* hash,
                              void* rid, void* pos, void* strand, int R,
                              int W, int k, int w, int CH, int NC,
                              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (R <= 0 || NC <= 0) return 0;
  if (w <= 8)
    lq_sketch_launch<8>(codes2, nmask, smask, emask, starts, gids, plan, emit,
                        hash, rid, pos, strand, R, W, k, w, CH, NC, st);
  else if (w <= 16)
    lq_sketch_launch<16>(codes2, nmask, smask, emask, starts, gids, plan,
                         emit, hash, rid, pos, strand, R, W, k, w, CH, NC, st);
  else if (w <= 32)
    lq_sketch_launch<32>(codes2, nmask, smask, emask, starts, gids, plan,
                         emit, hash, rid, pos, strand, R, W, k, w, CH, NC, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
