// B5: banded ksw2-class extension, score only: extz (one affine gap
// family) and extd (two), with Z-drop.
//
// Replaces the Pallas kernel of longqc_tpu/ops/extend_pallas.py
// (_make_kernel :51, _build_call :185 and its pallas_call at :192;
// entries extz_batch_pallas / extz_device) and computes what it and the
// plain version (ops/extend.extz_batch_plain) compute, bit for bit: the
// band |qi - j| <= W, H/E(/E2) from the left and diagonal cells, the
// vertical F per gap family by the lazy-F argument (base, not H, feeds
// F: extend_pallas.py:16-19), boundaries -bndcost(l) with bndcost =
// q + l*e (extd: the cheaper family), the column argmax with ties to
// the smallest query index, the query-end and target-end maxima, and
// Z-drop, which stops a pair from the next column on. Every value is
// int32 with the JAX code's adds. A pair's columns end at min(tlen,
// Lt); a query index at or past the code array's width reads code 4.
//
// The one-warp body (W <= 63, lq_extend_kernel) is an anti-diagonal
// wavefront. Cell (qi, j) reads (qi, j-1), (qi-1, j-1) and (qi-1, j),
// which lie on the two anti-diagonals before d = qi + j, so the cells
// of one anti-diagonal are independent: no scan over band rows. One
// warp walks one pair, d = 0, 1, ... Column j is in the band on the
// 2W+1 anti-diagonals 2j-W .. 2j+W, so at most W+1 columns are live;
// column j takes slot j mod S (S = 32 * CPL columns, CPL = 1 for
// W <= 31, else 2), held by lane slot / CPL in register slot % CPL, so
// a lane's columns are consecutive: the left neighbour of register c
// is register c-1 of the same lane, or for register 0 the last
// register of lane - 1, one shuffle per carried value (H, E, E2) and
// anti-diagonal. The diagonal value is the left value the column took
// one anti-diagonal before (a register). Each column keeps, besides
// the cell above: its F chain per gap family, F(qi) = max(F(qi-1),
// base(qi-1) - go) - ge, seeded when the column starts with the
// top-boundary term -bndcost(j+1) - go - (qi+1)*ge; its target code,
// loaded once; its running maximum, where cells arrive in ascending qi
// and a strict > keeps the smallest index of a tie; and its last valid
// H, the query-end cell. Query codes: register 0 loads its code (a
// window of the query row that stays in L1), register c takes register
// c-1's code of the anti-diagonal before. Column j retires at
// d = 2j + W, one column every two anti-diagonals: its lane broadcasts
// the column's maximum, argmax and query-end cell, and every lane
// applies the plain loop's update (best / max_q / max_t, mqe / mqe_t,
// mte / mte_q at j == tlen - 1, Z-drop), so the pair's state is the
// same in every lane; a drop ends the walk (cells already computed in
// later columns feed no output). The boundaries (column 0's left and
// diagonal cells, row 0's diagonal, cells above the query) occur only
// on the first W+1 anti-diagonals; the loop after them has none and
// takes two anti-diagonals a trip, the second with the column start
// and retirement. The recursion differs from the plain scan, which
// starts from NEG = -2^30 and adds ge*r, only on terms that come from
// NEG (at most NEG - go - ge); on every cell that holds a query index
// the top-boundary term beats them whenever bndcost(j+1) + go +
// (qi+1)*ge < 2^30 (lengths up to ~10^8 at the default gaps), so H is
// the plain version's. tests/test_torch_extend_sched.py replays this
// schedule on the CPU against the plain version and the Pallas kernel.
//
// Bound on this card: instruction throughput, not bytes. Per cell and
// anti-diagonal some 20 (extz) or 25 (extd) integer instructions with
// no dependency between the cells of one anti-diagonal; per
// anti-diagonal two or three shuffles and one query load a lane; per
// column start some 5-6 selects a register, per retirement three
// broadcasts and some 15 selects. With 48-64 registers a thread,
// 32-40 warps share an SM, and a warp's step waits mostly for its
// turn at the warp scheduler. A pair is 2 x columns + W dependent steps,
// so the pairs with the most columns set the tail: once the short pairs
// are done, the card runs them with few warps. Only W+1 of the S slots
// are live (at W <= 15 half of them idle).
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
// per-column chain, five barriers, times the columns of each pair; a
// simple body that is right, not yet a fast one.

#include <cuda_runtime.h>
#include <stdint.h>

#include "kernels.h"

#define LQ_FULL 0xffffffffu

namespace {

constexpr int NEG = -0x40000000;

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

// One pair's walk in the one-warp body: the pair's constants, lane
// `lane`'s CPL column registers and the pair's outputs so far. Every
// member function is inlined into the kernel, so all of it stays in
// registers.
template <int CPL, bool DUAL>
struct Wave {
  static constexpr int S = 32 * CPL;  // column slots
  const int32_t* qrow;
  const int32_t* trow;
  int lane, W, ql, tl, ncol, match, mismatch, zdrop;
  unsigned qlim;  // query indices below it read the code array
  Gaps g;
  // register c holds column j[c]: its folded target code tx (4 -> -2,
  // never a match), the end qhi of its valid query indices (0 for no
  // column), the F chains' next terms fp / fp2 (F = fp - ge), the
  // running maximum cm at query index cq, the last valid H, and the
  // cell of the last anti-diagonal: H, E, E2 (NEG when not valid), the
  // left H taken then (this step's diagonal) and the query code. A new
  // column resets cm to NEG but not cq or hlast: the retirement reads
  // cq only for a maximum above NEG and hlast only for a column that
  // holds the query's last index, and a valid cell of the column has
  // set them then
  int j[CPL], tx[CPL], qhi[CPL], fp[CPL], fp2[CPL], cm[CPL], cq[CPL];
  int hlast[CPL], H[CPL], E[CPL], E2[CPL], hlp[CPL], code[CPL];
  int best, bq, bt, mqe, mqet, mte, mteq;
  bool dropped;

  __device__ __forceinline__ int qcode(int qi) const {
    const unsigned u = qi;
    return u < qlim ? __ldg(qrow + u) : 4;
  }

  // what column js holds when it enters a register at anti-diagonal d,
  // where its query index is d - js
  struct ColInit {
    int j, tx, qhi, fp, fp2;
  };
  __device__ __forceinline__ ColInit col_init(int js, int d) const {
    const bool live = js >= 0 && js < ncol;
    const int tc = live ? __ldg(trow + (unsigned)js) : 4;
    const int top = ql < js + W + 1 ? ql : js + W + 1;
    const int hb = -bndcost<DUAL>(js + 1, g);
    return {js, tc < 4 ? tc : -2, live ? imax(0, top) : 0,
            hb - g.go - (d - js) * g.ge,
            DUAL ? hb - g.go2 - (d - js) * g.ge2 : NEG};
  }
  // register c takes the column if `take`; selects, not branches, so
  // that no register is ever indexed at run time (which would move the
  // arrays to local memory)
  __device__ __forceinline__ void set_col(int c, const ColInit& v,
                                          bool take) {
    j[c] = take ? v.j : j[c];
    tx[c] = take ? v.tx : tx[c];
    qhi[c] = take ? v.qhi : qhi[c];
    fp[c] = take ? v.fp : fp[c];
    if (DUAL) fp2[c] = take ? v.fp2 : fp2[c];
    cm[c] = take ? NEG : cm[c];
  }

  // columns with 2j - W < 0 are under way at d = 0 (their cells so far
  // lie above the query); every other slot holds column slot - S, none
  __device__ __forceinline__ void init() {
    best = 0;
    bq = bt = mqet = mteq = -1;
    mqe = mte = NEG;
    dropped = false;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int s = lane * CPL + c;
      set_col(c, col_init(2 * s - W < 0 ? s : s - S, 0), true);
      cq[c] = 0;
      H[c] = E[c] = E2[c] = hlp[c] = hlast[c] = NEG;
      code[c] = 4;
    }
  }

  // the cells of anti-diagonal d; BND: with the boundaries (the first
  // W+1 anti-diagonals)
  template <bool BND>
  __device__ __forceinline__ void step(int d) {
    const int src = (lane + 31) & 31;
    const int hn = __shfl_sync(LQ_FULL, H[CPL - 1], src);
    const int en = __shfl_sync(LQ_FULL, E[CPL - 1], src);
    const int e2n = DUAL ? __shfl_sync(LQ_FULL, E2[CPL - 1], src) : NEG;
    // register c takes c-1's code of step d - 1, register 0 loads
#pragma unroll
    for (int c = CPL - 1; c > 0; --c) code[c] = code[c - 1];
    code[0] = qcode(d - j[0]);
    // descending, so that register c reads c-1's cell of step d - 1
#pragma unroll
    for (int c = CPL - 1; c >= 0; --c) {
      const int qi = d - j[c];
      const bool ok = (unsigned)qi < (unsigned)qhi[c];
      int hl = c > 0 ? H[c - 1] : hn;
      const int el = c > 0 ? E[c - 1] : en;
      int hd = hlp[c];
      hlp[c] = hl;
      if (BND) {
        if (j[c] == 0) {
          hl = -bndcost<DUAL>(qi + 1, g);
          hd = qi == 0 ? 0 : -bndcost<DUAL>(qi, g);
        } else if (qi == 0) {
          hd = -bndcost<DUAL>(j[c], g);
        }
      }
      const int e = imax(el, hl - g.go) - g.ge;
      int bs = imax(hd + (code[c] == tx[c] ? match : mismatch), e);
      int e2 = NEG;
      if (DUAL) {
        const int e2l = c > 0 ? E2[c - 1] : e2n;
        e2 = imax(e2l, hl - g.go2) - g.ge2;
        bs = imax(bs, e2);
      }
      // past the boundary steps a column's invalid cells all follow its
      // last valid one, so its F chain needs no mask there
      if (BND && !ok) bs = NEG;
      const int f = fp[c] - g.ge;
      int h = imax(bs, f);
      fp[c] = imax(f, bs - g.go);
      if (DUAL) {
        const int f2 = fp2[c] - g.ge2;
        h = imax(h, f2);
        fp2[c] = imax(f2, bs - g.go2);
      }
      H[c] = ok ? h : NEG;
      E[c] = ok ? e : NEG;
      if (DUAL) E2[c] = ok ? e2 : NEG;
      const bool up = H[c] > cm[c];
      cm[c] = up ? H[c] : cm[c];
      cq[c] = up ? qi : cq[c];
      hlast[c] = ok ? h : hlast[c];
    }
  }

  // column (d + W) / 2 enters its slot at anti-diagonal d
  __device__ __forceinline__ void start(int d) {
    const int js = (d + W) >> 1;
    const int s = js & (S - 1);
    const ColInit v = col_init(js, d);
#pragma unroll
    for (int c = 0; c < CPL; ++c) set_col(c, v, lane * CPL + c == s);
  }

  // column (d - W) / 2 had its last cell at anti-diagonal d: the plain
  // loop's column update, on values broadcast from the column's lane
  // (every condition below is uniform over the warp; selects, no
  // branches)
  __device__ __forceinline__ void retire(int d) {
    const int jr = (d - W) >> 1;
    const int owner = (jr & (S - 1)) / CPL;
    int vb = NEG, vq = 0, vh = NEG;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const bool mine = j[c] == jr;
      vb = mine ? cm[c] : vb;
      vq = mine ? cq[c] : vq;
      vh = mine ? hlast[c] : vh;
    }
    const int colb = __shfl_sync(LQ_FULL, vb, owner);
    const int colq = __shfl_sync(LQ_FULL, vq, owner);
    const int qe = __shfl_sync(LQ_FULL, vh, owner);
    const bool better = colb > best;
    bq = better ? colq : bq;
    bt = better ? jr : bt;
    best = better ? colb : best;
    const bool tend = jr == tl - 1 && colb > mte;
    mteq = tend ? colq : mteq;
    mte = tend ? colb : mte;
    // the query-end cell, if it lies in the column's band
    const bool qend = ql >= 1 && ql - 1 >= jr - W && ql - 1 <= jr + W &&
                      qe > mqe;
    mqet = qend ? jr : mqet;
    mqe = qend ? qe : mqe;
    dropped = best - colb > zdrop;
  }
};

template <int CPL, bool DUAL>
__global__ void __launch_bounds__(128) lq_extend_kernel(
    const int32_t* __restrict__ q, const int32_t* __restrict__ qlens,
    const int32_t* __restrict__ t, const int32_t* __restrict__ tlens,
    int32_t* __restrict__ out, int B, int Lq, int Lt, int W, int match,
    int mismatch, Gaps g, int zdrop) {
  const int b = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (b >= B) return;
  Wave<CPL, DUAL> w;
  w.lane = threadIdx.x & 31;
  w.W = W;
  w.ql = qlens[b];
  w.tl = tlens[b];
  w.ncol = w.tl < Lt ? w.tl : Lt;
  w.match = match;
  w.mismatch = mismatch;
  w.zdrop = zdrop;
  w.qlim = (unsigned)imax(0, w.ql < Lq ? w.ql : Lq);
  w.g = g;
  w.qrow = q + (size_t)b * Lq;
  w.trow = t + (size_t)b * Lt;
  w.init();
  if (w.ncol > 0) {
    // the last column retires at anti-diagonal dend; dend - W is even
    const int dend = 2 * (w.ncol - 1) + W;
    for (int d = 0; d <= W; ++d) {
      if (((d + W) & 1) == 0) w.start(d);
      w.template step<true>(d);
    }
    w.retire(W);
    for (int d = W + 1; d < dend && !w.dropped; d += 2) {
      w.template step<false>(d);
      w.start(d + 1);
      w.template step<false>(d + 1);
      w.retire(d + 1);
    }
  }
  if (w.lane == 0) {
    out[b] = w.best;
    out[(size_t)B + b] = w.bq;
    out[(size_t)2 * B + b] = w.bt;
    out[(size_t)3 * B + b] = w.mqe;
    out[(size_t)4 * B + b] = w.mqet;
    out[(size_t)5 * B + b] = w.mte;
    out[(size_t)6 * B + b] = w.mteq;
    out[(size_t)7 * B + b] = w.dropped;
  }
}

template <int CPL>
int lq_extend_launch(const void* q, const void* ql, const void* t,
                     const void* tl, void* out, int B, int Lq, int Lt, int W,
                     int match, int mismatch, Gaps g, int zdrop, int dual,
                     cudaStream_t st) {
  const int warps = 4;
  const int blocks = (B + warps - 1) / warps;
  if (dual)
    lq_extend_kernel<CPL, true><<<blocks, 32 * warps, 0, st>>>(
        (const int32_t*)q, (const int32_t*)ql, (const int32_t*)t,
        (const int32_t*)tl, (int32_t*)out, B, Lq, Lt, W, match, mismatch, g,
        zdrop);
  else
    lq_extend_kernel<CPL, false><<<blocks, 32 * warps, 0, st>>>(
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
  if (W <= 0 || W > 63) return (int)cudaErrorInvalidValue;
  // the W+1 live columns in 32 (one a lane) or 64 slots (two)
  if (W <= 31)
    return lq_extend_launch<1>(q, ql, t, tl, out, B, Lq, Lt, W, match,
                               mismatch, g, zdrop, dual, st);
  return lq_extend_launch<2>(q, ql, t, tl, out, B, Lq, Lt, W, match,
                             mismatch, g, zdrop, dual, st);
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
