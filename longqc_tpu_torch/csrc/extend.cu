// B5: banded ksw2-class extension, score only: extz (one affine gap
// family) and extd (two), with Z-drop.
//
// Replaces the Pallas kernel longqc_tpu/ops/extend_pallas.py
// (_make_kernel / _build_call / extz_device) and computes what it
// computes, bit for bit: the band of 2W+1 rows in which row r at target
// column j is query index j + r - W, a sequential walk over target
// columns, H/E(/E2) carried from column to column, the vertical F
// recurrence as an exclusive max-scan over band rows of
// base - gapo + gape*r (the lazy-F argument, per gap family under
// extd), boundaries -bndcost(l) with bndcost = q + l*e (extd: the
// cheaper family), the column argmax with ties to the smallest row, the
// query-end and target-end maxima, and Z-drop, which stops a pair from
// the next column on. Every value is int32 with the JAX code's adds.
//
// Design: one warp per pair. Lane l holds the NC consecutive band rows
// l*NC .. l*NC+NC-1 in registers (NC = 1, 2 or 4, so W <= 63), so the
// shift to row r+1 of the previous column is a register move plus one
// shuffle per array, and the F scan is a serial max over the lane's
// rows, one warp scan of the lane totals, and a serial fix-up. Query
// codes are read straight from global memory (L1-resident window),
// target codes 32 columns at a time, one per lane, and broadcast by
// shuffle. A pair stops at its own target length, or at its Z-drop:
// both leave every output as the remaining columns would (they are
// inert there). The TPU layout (a 128-sublane band, the rolled query
// window, four fused columns per loop step) has no counterpart.
//
// Bound: the per-column dependency chain (two to three warp scans and
// two warp reductions, five shuffles each) times the columns of the
// longest pair in a warp: latency, with enough warps in flight to hide
// it, not bytes or operations.
//
// The wide body (W >= 64, lq_extend_wide_kernel) takes any band: one
// block of WIDE_THREADS threads per pair (a grid-stride loop over the
// pairs), H / E / E2 of the previous and the current column in a
// ping-pong scratch of 2 x (band + 1) rows each, in dynamic shared
// memory when it fits and in a per-block slice of device memory
// otherwise; row `band` of every buffer stays NEG (the row past the
// last). Per column: the cells' base / E / E2 with rows strided over the
// threads; the F recurrence as a block-wide exclusive max-scan (each
// thread a contiguous run of rows, a warp scan of the run totals, the
// warp totals through shared memory); the column argmax as a block
// reduction, ties to the smallest row; thread 0 keeps the maxima and
// Z-drop, which every thread reads after a barrier. Outputs are stated
// in query and target indices, never in band rows, so each pair's band
// is clamped to W_b = min(W, max(qlen, columns)): past that every cell
// with 0 <= qi < qlen and 0 <= j < columns lies inside the band and the
// rows outside it stay NEG, so the outputs do not change. Bound: the
// same per-column chain, now five barriers, times the columns of each
// pair; a simple body that is right, not yet a fast one.

#include <cuda_runtime.h>
#include <stdint.h>

#include "kernels.h"

#define LQ_FULL 0xffffffffu

namespace {

constexpr int NEG = -0x40000000;
constexpr int BIG = 0x3FFFFFFF;

__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }

struct Gaps {
  int go, ge, go2, ge2;
};

template <bool DUAL>
__device__ __forceinline__ int bndcost(int l, const Gaps& g) {
  const int b1 = g.go + l * g.ge;
  if (!DUAL) return b1;
  const int b2 = g.go2 + l * g.ge2;
  return b1 < b2 ? b1 : b2;
}

// F of one gap family folded into h: for band row r = r0 + i,
// F[r] = max(max_{r' < r}(base[r'] - go + ge*r') - ge*r,
//            q_ok ? hbnd - go - (qi + 1)*ge : NEG),
// the running max starting from NEG as the Pallas scan's fill does.
template <int NC>
__device__ __forceinline__ void fold_f(const int (&base)[NC],
                                       const bool (&qok)[NC],
                                       const int (&qi)[NC], int r0, int go,
                                       int ge, int hbnd, int lane,
                                       int (&h)[NC]) {
  int run[NC];
  int acc = NEG;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    acc = imax(acc, base[i] - go + ge * (r0 + i));
    run[i] = acc;
  }
  int incl = acc;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(LQ_FULL, incl, o);
    if (lane >= o) incl = imax(incl, y);
  }
  int excl = __shfl_up_sync(LQ_FULL, incl, 1);
  if (lane == 0) excl = NEG;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int prev = i == 0 ? excl : imax(excl, run[i - 1]);
    const int fband = prev - ge * (r0 + i);
    const int fbnd = qok[i] ? hbnd - go - (qi[i] + 1) * ge : NEG;
    h[i] = imax(h[i], imax(fband, fbnd));
  }
}

__device__ __forceinline__ int warp_max(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = imax(x, __shfl_xor_sync(LQ_FULL, x, o));
  return x;
}

template <int NC, bool DUAL>
__global__ void lq_extend_kernel(const int32_t* __restrict__ q,
                                 const int32_t* __restrict__ qlens,
                                 const int32_t* __restrict__ t,
                                 const int32_t* __restrict__ tlens,
                                 int32_t* __restrict__ out, int B, int Lq,
                                 int Lt, int W, int match, int mismatch,
                                 Gaps g, int zdrop) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (b >= B) return;
  const int band = 2 * W + 1;
  const int r0 = lane * NC;
  const int ql = qlens[b];
  const int tl = tlens[b];
  const int ncol = tl < Lt ? tl : Lt;
  const int32_t* qrow = q + (size_t)b * Lq;
  const int32_t* trow = t + (size_t)b * Lt;

  int H[NC], E[NC], E2[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) H[i] = E[i] = E2[i] = NEG;
  int best = 0, bq = -1, bt = -1, mqe = NEG, mqet = -1, mte = NEG, mteq = -1;
  int dropped = 0;
  int tbuf = 4;

  // the loop bound and `dropped` are uniform over the warp
  for (int j = 0; j < ncol && !dropped; ++j) {
    if ((j & 31) == 0) tbuf = j + lane < Lt ? trow[j + lane] : 4;
    const int tj = __shfl_sync(LQ_FULL, tbuf, j & 31);
    // row r+1 of the previous column; the row past the last is NEG
    int hn = __shfl_down_sync(LQ_FULL, H[0], 1);
    int en = __shfl_down_sync(LQ_FULL, E[0], 1);
    int e2n = DUAL ? __shfl_down_sync(LQ_FULL, E2[0], 1) : NEG;
    if (lane == 31) hn = en = e2n = NEG;

    int qi[NC], base[NC], nh[NC], ne[NC], ne2[NC];
    bool qok[NC];
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int r = r0 + i;
      qi[i] = j + r - W;
      qok[i] = qi[i] >= 0 && qi[i] < ql && r < band;
      int hl = i + 1 < NC ? H[i + 1] : hn;
      const int el = i + 1 < NC ? E[i + 1] : en;
      int hd;
      if (j == 0) {
        hl = -bndcost<DUAL>(qi[i] + 1, g);
        hd = qi[i] == 0 ? 0 : -bndcost<DUAL>(qi[i], g);
      } else {
        hd = qi[i] == 0 ? -bndcost<DUAL>(j, g) : H[i];
      }
      const int ej = imax(el, hl - g.go) - g.ge;
      const int code = qok[i] && qi[i] < Lq ? qrow[qi[i]] : 4;
      const bool m = code == tj && code < 4 && tj < 4;
      int bs = imax(hd + (m ? match : mismatch), ej);
      int e2j = NEG;
      if (DUAL) {
        const int e2l = i + 1 < NC ? E2[i + 1] : e2n;
        e2j = imax(e2l, hl - g.go2) - g.ge2;
        bs = imax(bs, e2j);
      }
      base[i] = qok[i] ? bs : NEG;
      nh[i] = base[i];
      ne[i] = ej;
      ne2[i] = e2j;
    }
    const int hbnd = -bndcost<DUAL>(j + 1, g);
    fold_f<NC>(base, qok, qi, r0, g.go, g.ge, hbnd, lane, nh);
    if (DUAL) fold_f<NC>(base, qok, qi, r0, g.go2, g.ge2, hbnd, lane, nh);

    // inside the loop the column is before tlen and the pair is live,
    // so validity is q_ok
    int lmax = NEG;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      H[i] = qok[i] ? nh[i] : NEG;
      E[i] = qok[i] ? ne[i] : NEG;
      if (DUAL) E2[i] = qok[i] ? ne2[i] : NEG;
      lmax = imax(lmax, H[i]);
    }
    const int col_best = warp_max(lmax);
    int lrow = BIG;
#pragma unroll
    for (int i = NC - 1; i >= 0; --i)
      if (H[i] == col_best) lrow = r0 + i;
    // rows ascend with the lane, so the lowest lane holding the maximum
    // holds its smallest row (every row is NEG when no row is valid)
    const uint32_t has = __ballot_sync(LQ_FULL, lrow != BIG);
    const int col_r = __shfl_sync(LQ_FULL, lrow, __ffs(has) - 1);
    const int col_qi = j + col_r - W;
    if (col_best > best) {
      best = col_best;
      bq = col_qi;
      bt = j;
    }
    // the row holding query index ql-1, if it lies in the band
    const int rq = ql - 1 - j + W;
    if (rq >= 0 && rq < 32 * NC) {
      int v = NEG;
#pragma unroll
      for (int i = 0; i < NC; ++i)
        if (r0 + i == rq) v = H[i];
      const int qe = __shfl_sync(LQ_FULL, v, rq / NC);
      if (qe > mqe) {
        mqe = qe;
        mqet = j;
      }
    }
    if (j == tl - 1 && col_best > mte) {
      mte = col_best;
      mteq = col_qi;
    }
    if (best - col_best > zdrop) dropped = 1;
  }
  if (lane == 0) {
    out[b] = best;
    out[(size_t)B + b] = bq;
    out[(size_t)2 * B + b] = bt;
    out[(size_t)3 * B + b] = mqe;
    out[(size_t)4 * B + b] = mqet;
    out[(size_t)5 * B + b] = mte;
    out[(size_t)6 * B + b] = mteq;
    out[(size_t)7 * B + b] = dropped;
  }
}

template <int NC>
int lq_extend_launch(const void* q, const void* ql, const void* t,
                     const void* tl, void* out, int B, int Lq, int Lt, int W,
                     int match, int mismatch, Gaps g, int zdrop, int dual,
                     cudaStream_t st) {
  const int warps = 4;
  const int blocks = (B + warps - 1) / warps;
  if (dual)
    lq_extend_kernel<NC, true><<<blocks, 32 * warps, 0, st>>>(
        (const int32_t*)q, (const int32_t*)ql, (const int32_t*)t,
        (const int32_t*)tl, (int32_t*)out, B, Lq, Lt, W, match, mismatch, g,
        zdrop);
  else
    lq_extend_kernel<NC, false><<<blocks, 32 * warps, 0, st>>>(
        (const int32_t*)q, (const int32_t*)ql, (const int32_t*)t,
        (const int32_t*)tl, (int32_t*)out, B, Lq, Lt, W, match, mismatch, g,
        zdrop);
  return (int)cudaGetLastError();
}

constexpr int WIDE_THREADS = 256;
constexpr int WIDE_WARPS = WIDE_THREADS / 32;

// inclusive warp max-scan
__device__ __forceinline__ int warp_incl_max(int x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(LQ_FULL, x, o);
    if (lane >= o) x = imax(x, y);
  }
  return x;
}

// block-wide exclusive max-scan of one value per thread (NEG before
// thread 0); `tot` holds the warp totals; ends with a barrier after
// which `tot` may be written again only past the caller's next barrier
__device__ __forceinline__ int block_excl_max(int x, int* tot, int lane,
                                              int warp) {
  const int incl = warp_incl_max(x, lane);
  int excl = __shfl_up_sync(LQ_FULL, incl, 1);
  if (lane == 0) excl = NEG;
  if (lane == 31) tot[warp] = incl;
  __syncthreads();
  int pre = NEG;
  for (int i = 0; i < warp; ++i) pre = imax(pre, tot[i]);
  return imax(pre, excl);
}

template <bool DUAL>
__global__ void __launch_bounds__(WIDE_THREADS) lq_extend_wide_kernel(
    const int32_t* __restrict__ q, const int32_t* __restrict__ qlens,
    const int32_t* __restrict__ t, const int32_t* __restrict__ tlens,
    int32_t* __restrict__ out, int B, int Lq, int Lt, int W, int match,
    int mismatch, Gaps g, int zdrop, int32_t* scratch, size_t bstride) {
  extern __shared__ int32_t smem[];
  __shared__ int tot1[WIDE_WARPS], tot2[WIDE_WARPS];
  __shared__ int red_v[WIDE_WARPS], red_r[WIDE_WARPS];
  __shared__ int s_drop;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int32_t* buf = scratch ? scratch + blockIdx.x * bstride : smem;

  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    const int ql = qlens[b];
    const int tl = tlens[b];
    const int ncol = tl < Lt ? tl : Lt;
    const int Wb = imax(0, W < imax(ql, ncol) ? W : imax(ql, ncol));
    const int band = 2 * Wb + 1;
    const int ld = band + 1;
    int32_t* Hc = buf;
    int32_t* Hn = buf + ld;
    int32_t* Ec = buf + 2 * ld;
    int32_t* En = buf + 3 * ld;
    int32_t* E2c = buf + 4 * ld;
    int32_t* E2n = buf + 5 * ld;
    for (int r = tid; r < 6 * ld; r += nt) buf[r] = NEG;
    __syncthreads();
    const int32_t* qrow = q + (size_t)b * Lq;
    const int32_t* trow = t + (size_t)b * Lt;
    // thread `tid` owns the contiguous rows [c0, c1) in the scans
    const int rpt = (band + nt - 1) / nt;
    const int c0 = tid * rpt < band ? tid * rpt : band;
    const int c1 = c0 + rpt < band ? c0 + rpt : band;
    int best = 0, bq = -1, bt = -1, mqe = NEG, mqet = -1, mte = NEG,
        mteq = -1, dropped = 0;

    for (int j = 0; j < ncol; ++j) {
      const int tj = trow[j];
      // cells: row r of the previous column is the diagonal, row r + 1
      // the horizontal predecessor
      for (int r = tid; r < band; r += nt) {
        const int qi = j + r - Wb;
        const bool qok = qi >= 0 && qi < ql;
        int hl = Hc[r + 1];
        int hd;
        if (j == 0) {
          hl = -bndcost<DUAL>(qi + 1, g);
          hd = qi == 0 ? 0 : -bndcost<DUAL>(qi, g);
        } else {
          hd = qi == 0 ? -bndcost<DUAL>(j, g) : Hc[r];
        }
        const int ej = imax(Ec[r + 1], hl - g.go) - g.ge;
        const int code = qok && qi < Lq ? qrow[qi] : 4;
        const bool m = code == tj && code < 4 && tj < 4;
        int bs = imax(hd + (m ? match : mismatch), ej);
        int e2j = NEG;
        if (DUAL) {
          e2j = imax(E2c[r + 1], hl - g.go2) - g.ge2;
          bs = imax(bs, e2j);
        }
        Hn[r] = qok ? bs : NEG;
        En[r] = qok ? ej : NEG;
        if (DUAL) E2n[r] = qok ? e2j : NEG;
      }
      __syncthreads();

      // F: exclusive max-scan over rows of base - go + ge * r per family
      int acc1 = NEG, acc2 = NEG;
      for (int r = c0; r < c1; ++r) {
        acc1 = imax(acc1, Hn[r] - g.go + g.ge * r);
        if (DUAL) acc2 = imax(acc2, Hn[r] - g.go2 + g.ge2 * r);
      }
      int run1 = block_excl_max(acc1, tot1, lane, warp);
      int run2 = DUAL ? block_excl_max(acc2, tot2, lane, warp) : NEG;
      const int hbnd = -bndcost<DUAL>(j + 1, g);
      int lmax = NEG, lrow = -1;
      for (int r = c0; r < c1; ++r) {
        const int qi = j + r - Wb;
        const bool qok = qi >= 0 && qi < ql;
        const int bs = Hn[r];
        int h = imax(bs, imax(run1 - g.ge * r,
                              qok ? hbnd - g.go - (qi + 1) * g.ge : NEG));
        run1 = imax(run1, bs - g.go + g.ge * r);
        if (DUAL) {
          h = imax(h, imax(run2 - g.ge2 * r,
                           qok ? hbnd - g.go2 - (qi + 1) * g.ge2 : NEG));
          run2 = imax(run2, bs - g.go2 + g.ge2 * r);
        }
        h = qok ? h : NEG;
        Hn[r] = h;
        // rows ascend, so a strict > keeps the smallest row of a tie
        if (lrow < 0 || h > lmax) {
          lmax = h;
          lrow = r;
        }
      }
      // column argmax: (max, smallest row), threads without rows last
      int v = lrow < 0 ? NEG - 1 : lmax;
      int rr = lrow < 0 ? 0x7FFFFFFF : lrow;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const int v2 = __shfl_xor_sync(LQ_FULL, v, o);
        const int r2 = __shfl_xor_sync(LQ_FULL, rr, o);
        if (v2 > v || (v2 == v && r2 < rr)) {
          v = v2;
          rr = r2;
        }
      }
      if (lane == 0) {
        red_v[warp] = v;
        red_r[warp] = rr;
      }
      __syncthreads();
      if (tid == 0) {
        int col_best = red_v[0], col_r = red_r[0];
        for (int i = 1; i < nt / 32; ++i)
          if (red_v[i] > col_best ||
              (red_v[i] == col_best && red_r[i] < col_r)) {
            col_best = red_v[i];
            col_r = red_r[i];
          }
        const int col_qi = j + col_r - Wb;
        if (col_best > best) {
          best = col_best;
          bq = col_qi;
          bt = j;
        }
        // the row holding query index ql - 1, if it lies in the band
        const int rq = ql - 1 - j + Wb;
        if (rq >= 0 && rq < band && Hn[rq] > mqe) {
          mqe = Hn[rq];
          mqet = j;
        }
        if (j == tl - 1 && col_best > mte) {
          mte = col_best;
          mteq = col_qi;
        }
        dropped = best - col_best > zdrop;
        s_drop = dropped;
      }
      __syncthreads();
      if (s_drop) break;
      int32_t* x = Hc;
      Hc = Hn;
      Hn = x;
      x = Ec;
      Ec = En;
      En = x;
      x = E2c;
      E2c = E2n;
      E2n = x;
    }
    if (tid == 0) {
      out[b] = best;
      out[(size_t)B + b] = bq;
      out[(size_t)2 * B + b] = bt;
      out[(size_t)3 * B + b] = mqe;
      out[(size_t)4 * B + b] = mqet;
      out[(size_t)5 * B + b] = mte;
      out[(size_t)6 * B + b] = mteq;
      out[(size_t)7 * B + b] = dropped;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int lq_extend_fill(const void* q, const void* ql, const void* t,
                              const void* tl, void* out, int B, int Lq,
                              int Lt, int W, int match, int mismatch,
                              int gapo, int gape, int gapo2, int gape2,
                              int zdrop, int dual, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B <= 0) return 0;
  const Gaps g{gapo, gape, gapo2, gape2};
  const int band = 2 * W + 1;
  if (W <= 0) return (int)cudaErrorInvalidValue;
  if (band <= 32)
    return lq_extend_launch<1>(q, ql, t, tl, out, B, Lq, Lt, W, match,
                               mismatch, g, zdrop, dual, st);
  if (band <= 64)
    return lq_extend_launch<2>(q, ql, t, tl, out, B, Lq, Lt, W, match,
                               mismatch, g, zdrop, dual, st);
  if (band <= 128)
    return lq_extend_launch<4>(q, ql, t, tl, out, B, Lq, Lt, W, match,
                               mismatch, g, zdrop, dual, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int lq_extend_wide_fill(const void* q, const void* ql,
                                   const void* t, const void* tl, void* out,
                                   int B, int Lq, int Lt, int W, int Wa,
                                   int match, int mismatch, int gapo,
                                   int gape, int gapo2, int gape2, int zdrop,
                                   int dual, void* scratch, int nblk,
                                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B <= 0) return 0;
  if (W <= 0 || Wa < 0 || Wa > W) return (int)cudaErrorInvalidValue;
  const Gaps g{gapo, gape, gapo2, gape2};
  // six buffers of band + 1 rows at the widest band any pair takes
  const size_t ints = 6 * (size_t)(2 * Wa + 2);
  const size_t smem = scratch ? 0 : ints * sizeof(int32_t);
  const int blocks = scratch ? (nblk < B ? nblk : B) : B;
  if (dual)
    lq_extend_wide_kernel<true><<<blocks, WIDE_THREADS, smem, st>>>(
        (const int32_t*)q, (const int32_t*)ql, (const int32_t*)t,
        (const int32_t*)tl, (int32_t*)out, B, Lq, Lt, W, match, mismatch, g,
        zdrop, (int32_t*)scratch, ints);
  else
    lq_extend_wide_kernel<false><<<blocks, WIDE_THREADS, smem, st>>>(
        (const int32_t*)q, (const int32_t*)ql, (const int32_t*)t,
        (const int32_t*)tl, (int32_t*)out, B, Lq, Lt, W, match, mismatch, g,
        zdrop, (int32_t*)scratch, ints);
  return (int)cudaGetLastError();
}
