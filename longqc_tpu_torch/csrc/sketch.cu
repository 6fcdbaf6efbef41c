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
// atomicAdd into a zeroed array.
//
// One kernel body, instantiated per hash word H, ring size WM and ring
// kind DYN:
//  - H = uint32_t for 2k <= 30 (k-mer registers, hash and plan in 32
//    bits, int32 hash output), H = uint64_t for 2k <= 56 (the pb-hifi
//    fast preset's k = 19: u64 registers, hash64 in u64 with the 2k-bit
//    mask, int64 ring hashes with int64 max as sentinel, an int64 hash
//    output and an int64 plan). emit / rid / pos / strand are int32 in
//    both.
//  - w <= 32 (DYN false): the ring is a shift register in registers
//    (statically indexed, WM = 8 / 16 / 32 slots, every loop unrolled):
//    slot 0 is the newest push, slot w-1 the oldest, so the TPU kernel's
//    slot bookkeeping becomes a column compare.
//  - w = 33..255 (DYN true): unrolled at 64-256 slots the shift register
//    would spill, so the ring is a circular buffer in per-thread local
//    memory (WM = 64 / 128 / 256 slots, a power of two >= w), addressed
//    at run time: a push writes slot (head + 1) mod WM, the entry pushed
//    s pushes before the newest sits at (head - s) mod WM, and slots no
//    push has reached yet still hold the clean entry. The wrapper gives
//    these instances wider chunks (ops/sketch_cuda.chunk_width), since
//    the warm-up grows with w.
//
// Bound: each chunk is a serial chain of ~(CH + warm-up) columns of
// ~w + 30 integer operations (64-bit ones cost two on this card); the
// R * W / CH chains run in parallel. Outputs are separate
// emit/hash/rid/pos/strand arrays (no 15-bit meta packing), so any W
// works.
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

#define LQ_RPR 64          // reads per packed row
#define LQ_NOCOL (-(1 << 20))
#define LQ_PLAN 5          // s0, seg, segst, k0, k1 per chunk

// The signed lane a hash word rides outside the k-mer registers: ring
// hashes, the tracked minimum, the hash output and the chunk plan. Its
// max is the sentinel of an ineligible entry; every real hash is below
// it (2k <= 30 bits in the u32 instance, 2k <= 56 in the u64 one), so
// the signed compares order hashes as the unsigned reference does.
template <typename H>
struct lq_lane;
template <>
struct lq_lane<uint32_t> {
  typedef int32_t S;
  __device__ static constexpr S sent() { return 0x7FFFFFFF; }
};
template <>
struct lq_lane<uint64_t> {
  typedef int64_t S;
  __device__ static constexpr S sent() { return 0x7FFFFFFFFFFFFFFFLL; }
};

template <typename H>
__device__ __forceinline__ H lq_hash(H key, H mask) {
  // sketch.c hash64 on 2k-bit keys, the mask re-applied where
  // ops/sketch.hash64 applies it: sums and left shifts wrap mod 2^32 /
  // 2^64 and are masked right after, right shifts act on masked values
  key = (~key + (key << 21)) & mask;
  key = key ^ (key >> 24);
  key = ((key + (key << 3)) + (key << 8)) & mask;
  key = key ^ (key >> 14);
  key = ((key + (key << 2)) + (key << 4)) & mask;
  key = key ^ (key >> 28);
  key = (key + (key << 31)) & mask;
  return key;
}

// ring slot of the entry pushed `s` pushes before the newest one
#define LQ_SLOT(s) (DYN ? ((head - (s)) & (WM - 1)) : (s))
// slots a ring loop visits (each loop also tests s < w)
#define LQ_NSLOT (DYN ? w : WM)

template <typename H, int WM, bool DYN>
__global__ void lq_sketch_chunks_kernel(
    const uint32_t* __restrict__ codes2, const uint32_t* __restrict__ nmask,
    const uint32_t* __restrict__ smask, const uint32_t* __restrict__ emask,
    const int32_t* __restrict__ starts, const int32_t* __restrict__ gids,
    const typename lq_lane<H>::S* __restrict__ plan, int32_t* emit,
    typename lq_lane<H>::S* __restrict__ hash, int32_t* __restrict__ rid,
    int32_t* __restrict__ pos, int32_t* __restrict__ strand, int R, int W,
    int k, int w, int CH, int NC) {
  typedef typename lq_lane<H>::S S;
  const S SENT = lq_lane<H>::sent();
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= R * NC) return;
  const int r = tid / NC;
  const int c0 = (tid - r * NC) * CH;
  const int c1 = min(c0 + CH, W);
  const H mask = ((H)1 << (2 * k)) - (H)1;
  const int shift1 = 2 * (k - 1);
  const size_t roff = (size_t)r * W;
  const uint32_t* c2 = codes2 + (size_t)r * (W / 16);
  const uint32_t* nm = nmask + (size_t)r * (W / 32);
  const uint32_t* sb = smask + (size_t)r * (W / 32);
  const uint32_t* eb = emask + (size_t)r * (W / 32);
  int32_t* oe = emit + roff;

  const S* pl = plan + (size_t)tid * LQ_PLAN;
  const int s0 = (int)pl[0];
  int seg = (int)pl[1];
  int segst = (int)pl[2];
  H k0 = (H)pl[3], k1 = (H)pl[4];
  int curg = 0, curs = 0;
  if (seg >= 0 && seg < LQ_RPR) {
    curg = gids[r * LQ_RPR + seg];
    curs = starts[r * LQ_RPR + seg];
  }
  int lc = 0;
  S minh = SENT;
  int miny = 0, minc = LQ_NOCOL;
  S rh[WM];
  int ry[WM], rc[WM];
  int head = 0;  // DYN: the slot of the newest push
#pragma unroll(DYN ? 1 : WM)
  for (int s = 0; s < WM; ++s) {
    rh[s] = SENT;
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
      k1 = (k1 >> 2) | ((H)(3u ^ c) << shift1);
    }
    const bool sym = valid && (k0 == k1);
    const bool push = !sym;
    const int l_new = valid ? (sym ? lc : lc + 1) : 0;
    lc = l_new;
    const int z = (k0 < k1) ? 0 : 1;
    const S h = (S)lq_hash<H>(k0 < k1 ? k0 : k1, mask);
    const bool elig = valid && !sym && l_new >= k;
    const S ih = elig ? h : SENT;
    const int iy = ((j - curs) << 1) | z;

    if (mine) {
      // this column's record (callers mask non-emitting columns)
      const bool rec_on = push && valid;
      hash[roff + j] = rec_on ? ih : 0;
      rid[roff + j] = rec_on ? curg : 0;
      pos[roff + j] = rec_on ? (j - curs) : 0;
      strand[roff + j] = rec_on ? z : 0;
    }

    // push: the oldest of the w entries leaves, the new one is the newest
    bool min_evicted = false;
    if (push) {
      if constexpr (DYN) {
        min_evicted = rc[LQ_SLOT(w - 1)] == minc;
        head = (head + 1) & (WM - 1);
        rh[head] = ih;
        ry[head] = iy;
        rc[head] = j;
      } else {
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
    }
    // E1: first full window; ties with the tracked min (pushed slot
    // excluded)
    if (push && l_new == w + k - 1 && minh != SENT && mine) {
#pragma unroll(DYN ? 1 : WM)
      for (int s = 1; s < LQ_NSLOT; ++s)
        if (s < w && rh[LQ_SLOT(s)] == minh && ry[LQ_SLOT(s)] != miny)
          atomicAdd(oe + rc[LQ_SLOT(s)], 1);
    }
    // E2 (replace push) / E3 (min eviction) emit the old tracked min
    const bool cr = push && ih <= minh;
    const bool ce = push && !cr && min_evicted;
    if (mine && minh != SENT &&
        ((cr && l_new >= w + k) || (ce && l_new >= w + k - 1)))
      atomicAdd(oe + minc, 1);
    if (ce) {
      // rescan: min over the ring, ties -> newest column
      S nmh = SENT;
#pragma unroll(DYN ? 1 : WM)
      for (int s = 0; s < LQ_NSLOT; ++s)
        if (s < w) nmh = rh[LQ_SLOT(s)] < nmh ? rh[LQ_SLOT(s)] : nmh;
      int nmc = LQ_NOCOL, nmy = 0;
#pragma unroll(DYN ? 1 : WM)
      for (int s = 0; s < LQ_NSLOT; ++s)
        if (s < w && rh[LQ_SLOT(s)] == nmh && rc[LQ_SLOT(s)] > nmc) {
          nmc = rc[LQ_SLOT(s)];
          nmy = ry[LQ_SLOT(s)];
        }
      if (mine && l_new >= w + k - 1 && nmh != SENT) {
#pragma unroll(DYN ? 1 : WM)
        for (int s = 0; s < LQ_NSLOT; ++s)
          if (s < w && rh[LQ_SLOT(s)] == nmh && ry[LQ_SLOT(s)] != nmy)
            atomicAdd(oe + rc[LQ_SLOT(s)], 1);
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
    if (mine && ((we >> bit) & 1u) && minh != SENT && minc >= segst)
      atomicAdd(oe + minc, 1);
  }
}

struct lq_sketch_args {
  const void *codes2, *nmask, *smask, *emask, *starts, *gids, *plan;
  void *emit, *hash, *rid, *pos, *strand;
  int R, W, k, w, CH, NC;
  cudaStream_t st;
};

template <typename H, int WM, bool DYN>
static void lq_sketch_launch(const lq_sketch_args& a) {
  typedef typename lq_lane<H>::S S;
  // the run-time ring's chunks are fewer and longer: narrow blocks
  // spread them over more SMs
  const int threads = DYN ? 32 : 128;
  const long long n = (long long)a.R * a.NC;
  lq_sketch_chunks_kernel<H, WM, DYN>
      <<<(int)((n + threads - 1) / threads), threads, 0, a.st>>>(
          (const uint32_t*)a.codes2, (const uint32_t*)a.nmask,
          (const uint32_t*)a.smask, (const uint32_t*)a.emask,
          (const int32_t*)a.starts, (const int32_t*)a.gids,
          (const S*)a.plan, (int32_t*)a.emit, (S*)a.hash, (int32_t*)a.rid,
          (int32_t*)a.pos, (int32_t*)a.strand, a.R, a.W, a.k, a.w, a.CH,
          a.NC);
}

template <typename H>
static int lq_sketch_dispatch(const lq_sketch_args& a) {
  if (a.w <= 8)
    lq_sketch_launch<H, 8, false>(a);
  else if (a.w <= 16)
    lq_sketch_launch<H, 16, false>(a);
  else if (a.w <= 32)
    lq_sketch_launch<H, 32, false>(a);
  else if (a.w <= 64)
    lq_sketch_launch<H, 64, true>(a);
  else if (a.w <= 128)
    lq_sketch_launch<H, 128, true>(a);
  else
    lq_sketch_launch<H, 256, true>(a);
  return (int)cudaGetLastError();
}

extern "C" int lq_sketch_rows(const void* codes2, const void* nmask,
                              const void* smask, const void* emask,
                              const void* starts, const void* gids,
                              const void* plan, void* emit, void* hash,
                              void* rid, void* pos, void* strand, int R,
                              int W, int k, int w, int CH, int NC, int wide,
                              void* stream) {
  if (R <= 0 || NC <= 0) return 0;
  if (k < 1 || k > (wide ? 28 : 15) || w < 1 || w > 255)
    return (int)cudaErrorInvalidValue;
  const lq_sketch_args a = {codes2, nmask, smask, emask, starts, gids, plan,
                            emit,   hash,  rid,   pos,   strand, R,    W,
                            k,      w,     CH,    NC,    (cudaStream_t)stream};
  return wide ? lq_sketch_dispatch<uint64_t>(a)
              : lq_sketch_dispatch<uint32_t>(a);
}
