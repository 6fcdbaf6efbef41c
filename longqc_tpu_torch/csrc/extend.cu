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
// The wide body (W >= 64, lq_extend_wide_kernel) is the counterpart of
// the JAX package's lax.scan formulation (longqc_tpu/ops/extend.py:31,
// extz_batch, whose default is W = 64; the Pallas kernel stops at
// W = 63) and computes the same outputs, bit for bit. Each pair's band
// is clamped to W_b = min(W, max(qlen, columns)): past that every cell
// with 0 <= qi < qlen and 0 <= j < columns lies inside the band, so the
// outputs (stated in query and target indices) do not change. A wide
// band has up to W_b + 1 live columns on an anti-diagonal, too many for
// one warp's registers (or a block's), so G warps (1, 2, 4 or 8) walk the
// pair's columns in strips of S = 64 G: column j0 + c of strip j0 in
// warp c / 64, lane c % 64 / 2, register c % 2, as in the one-warp body
// at two columns a lane. Inside a strip the walk is the one-warp body's
// anti-diagonal wavefront, from the step before the first valid cell of
// column j0 (qi = max(0, j0 - W_b)) to the last valid cell of the
// strip's last column (qi = min(qlen - 1, j + W_b)); every column is set
// up when the strip begins, with its F chains seeded by the top-boundary
// term at the strip's first step, and a cell outside [max(0, j - W_b),
// min(qlen - 1, j + W_b)] is masked: base NEG (its F chain walks on from
// the seed) and H / E / E2 NEG, as the plain version's band edges and
// rows past the query are. Warp w > 0's lane 0 takes its left cell from
// warp w - 1's last column of the step before, through shared memory
// (two slots by step parity) and one named barrier of the pair's warps a
// step. The only dependency between strips is column j0 - 1, the left
// neighbour of column j0: the strip's last column writes H, E (and E2)
// of each valid row to a boundary column in device memory (band row
// qi - j + W_b, one a pair slot), and the next strip's column j0 reads it
// in place of a neighbour, NEG outside that column's valid rows. Warp 0
// reads it in batches of 32 rows, one a lane, a batch ahead, and takes
// row qi from lane (qi - batch start) by a shuffle, so its latency stays
// off the chain; the strip's own last column rewrites a row 2 S - 1
// anti-diagonals after the strip read it (the replay checks it), and a
// barrier orders the writes before the next strip's reads. The first
// strip's left edge is the left boundary, -bndcost(qi + 1), with 0 at
// qi = -1 (the diagonal of cell (0, 0)); row 0's diagonal, -bndcost(j),
// is set in the first S + 1 steps of every strip whose first column
// starts at qi = 0 (j0 <= W_b). After the strip's last step its columns
// retire in ascending j, the plain loop's update in every thread on the
// columns' values through shared memory, and Z-drop ends the walk (cells
// already computed in the strip's later columns feed no output). The
// recursion-vs-scan argument above holds unchanged: F is vertical and
// never crosses a strip, and a left value from the boundary column is
// the plain version's own H / E / E2 of cell (qi, j0 - 1), NEG where that
// cell is outside its band or the query. The wrapper (ops/extend_cuda)
// gives a pair 1 warp while the pairs fill the card and up to 8 when
// few long pairs would leave it idle, orders the pairs by band cells, the
// most first, and caps the pair slots, (2 + extd) x (2 W_a + 1) ints of
// scratch each (W_a the widest clamped band), by bytes; a grid-stride
// loop walks the rest of the pairs.
//
// Bound on this card: issue slots, as the one-warp body, and at few
// pairs latency. A strip walks S + h anti-diagonals for S columns (h =
// min(2 W_b + 1, qlen), the column height): at one warp, W = 64 three
// steps a column against the one-warp body's two, W = 255 nine, with
// 89 % of the slots holding a valid cell. Per step, besides the one-warp
// body's work, the left edge's shuffles (two or three), the last
// column's stores and the masked base; per strip the columns' set-up and
// their retirement, a warp max-scan with a few reductions (the columns'
// updates, one after the other, took 7-9 % of the time at W = 64).
// Pairs ordered by size keep the longest from starting last on an
// emptying card. At 1,024 pairs (7-8 warps an SM at one warp a pair) the
// step chain's latency bounds the walk, so there 8 warps a pair walk a
// strip of 512 columns in 1 / 8 of the steps a column, at a barrier a
// step and a ramp of 512 steps a strip.

#include <cuda_runtime.h>
#include <stdint.h>

#include "kernels.h"

#define LQ_FULL 0xffffffffu

namespace {

constexpr int NEG = -0x40000000;

__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }
__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

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

// the wide body's blocks: WIDE_WARPS / G pairs of G warps, or one pair
// of G = 8 warps
constexpr int WIDE_WARPS = 4;

// One pair's walk in the wide body, by G warps of one block: strip j0 of
// 64 G columns, column j0 + 64 wq + 2 lane + c in warp wq, lane `lane`,
// register c; the left edge's batches; the pair's outputs so far, the
// same in every thread. Every member function is inlined into the kernel.
template <int G, bool DUAL>
struct Strip {
  const int32_t* qrow;
  const int32_t* trow;
  int32_t* edge;  // the boundary column: H, E (and E2), ld ints apart
  int* xch;       // [2][G][3]: the warps' last columns, by step parity
  int* rbuf;      // [3][64 G]: the columns' maxima, at retirement
  int ld, lane, wq, bar, ql, tl, ncol, Wb, match, mismatch, zdrop;
  unsigned qlim;  // query indices below it read the code array
  Gaps g;
  int j0, jc;  // the strip's first column; register 0's column
  // register c: the first valid query index qlo and the count nr of
  // valid cells, the folded target code, the F chains' next terms, the
  // running maximum cm at query index cq, the last valid H, the cell of
  // the last step (H, E, E2, NEG when not valid), the left H taken then
  // and the query code
  int qlo[2], tx[2], fp[2], fp2[2], cm[2], cq[2], hlast[2];
  unsigned nr[2];
  int H[2], E[2], E2[2], hlp[2], code[2];
  // warp 0's left edge: column j0 - 1's valid rows [elo, elo + enr); lane
  // holds row qb + lane (c*) and qb + 32 + lane (n*)
  int elo, qb, cH, cE, cE2, nH, nE, nE2;
  unsigned enr;
  int best, bq, bt, mqe, mqet, mte, mteq;
  bool dropped;

  __device__ __forceinline__ int qcode(int qi) const {
    const unsigned u = qi;
    return u < qlim ? __ldg(qrow + u) : 4;
  }

  // the pair's warps meet (named barrier `bar`; one warp: its lanes)
  __device__ __forceinline__ void sync() const {
    if (G > 1)
      asm volatile("bar.sync %0, %1;" ::"r"(bar), "r"(32 * G) : "memory");
    else
      __syncwarp();
  }

  // row r of the left edge: column j0 - 1 from the boundary column, or
  // for the first strip the left boundary, -bndcost(r + 1) (0 at r = -1)
  __device__ __forceinline__ void edge_row(int r, int& h, int& e,
                                           int& e2) const {
    if (j0 == 0) {
      h = r < 0 ? 0 : -bndcost<DUAL>(r + 1, g);
      e = e2 = NEG;
      return;
    }
    const bool ok = (unsigned)(r - elo) < enr;
    const int i = r - (j0 - 1) + Wb;
    h = ok ? edge[i] : NEG;
    e = ok ? edge[ld + i] : NEG;
    e2 = DUAL && ok ? edge[2 * ld + i] : NEG;
  }

  // strip j0, whose first step is d0 - 1: the columns, the F chains
  // seeded at that step (query index d0 - 1 - j), warp 0's left edge's
  // first two batches
  __device__ __forceinline__ void begin(int d0) {
    jc = j0 + 64 * wq + 2 * lane;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int j = jc + c;
      const bool live = j < ncol;
      const int lo = imax(0, j - Wb);
      const int hi = ql - 1 < j + Wb ? ql - 1 : j + Wb;
      qlo[c] = lo;
      nr[c] = live && hi >= lo ? hi - lo + 1 : 0;
      const int tc = live ? __ldg(trow + (unsigned)j) : 4;
      tx[c] = tc < 4 ? tc : -2;
      const int qi0 = d0 - 1 - j;
      const int hb = -bndcost<DUAL>(j + 1, g);
      fp[c] = hb - g.go - qi0 * g.ge;
      if (DUAL) fp2[c] = hb - g.go2 - qi0 * g.ge2;
      cm[c] = H[c] = E[c] = E2[c] = NEG;
    }
    if (wq == 0) {
      elo = imax(0, j0 - 1 - Wb);
      const int ehi = ql - 1 < j0 - 1 + Wb ? ql - 1 : j0 - 1 + Wb;
      enr = ehi >= elo ? ehi - elo + 1 : 0;
      qb = d0 - 1 - j0;
      edge_row(qb + lane, cH, cE, cE2);
      edge_row(qb + 32 + lane, nH, nE, nE2);
    }
  }

  // the cells of anti-diagonal d; BND: row 0's diagonal may occur (the
  // first 64 G + 1 steps of a strip whose first column starts at
  // qi = 0); wr: the strip's last column writes its valid rows to the
  // boundary column
  template <bool BND>
  __device__ __forceinline__ void step(int d, bool wr) {
    const int src = (lane + 31) & 31;
    int hn = __shfl_sync(LQ_FULL, H[1], src);
    int en = __shfl_sync(LQ_FULL, E[1], src);
    int e2n = DUAL ? __shfl_sync(LQ_FULL, E2[1], src) : NEG;
    if (wq == 0) {
      // lane 0: row d - j0 of the left edge, from the lane that holds it
      int off = d - j0 - qb;
      if (off == 32) {
        // orders the lanes' earlier edge loads before the last column's
        // later stores to the same rows (with G > 1 the step's barrier
        // orders them too)
        __syncwarp();
        cH = nH;
        cE = nE;
        cE2 = nE2;
        qb += 32;
        off = 0;
        edge_row(qb + 32 + lane, nH, nE, nE2);
      }
      const int bh = __shfl_sync(LQ_FULL, cH, off);
      const int be = __shfl_sync(LQ_FULL, cE, off);
      const int be2 = DUAL ? __shfl_sync(LQ_FULL, cE2, off) : NEG;
      if (lane == 0) {
        hn = bh;
        en = be;
        e2n = be2;
      }
    } else if (lane == 0) {
      // warp wq - 1's last column, one step before
      const int* x = xch + (((d - 1) & 1) * G + wq - 1) * 3;
      hn = x[0];
      en = x[1];
      if (DUAL) e2n = x[2];
    }
    code[1] = code[0];
    code[0] = qcode(d - jc);
    bool ok1 = false;
    // descending, so that register 1 reads register 0's cell of step d-1
#pragma unroll
    for (int c = 1; c >= 0; --c) {
      const int qi = d - jc - c;
      const bool ok = (unsigned)(qi - qlo[c]) < nr[c];
      if (c == 1) ok1 = ok;
      const int hl = c > 0 ? H[0] : hn;
      const int el = c > 0 ? E[0] : en;
      int hd = hlp[c];
      hlp[c] = hl;
      if (BND && qi == 0 && jc + c != 0) hd = -bndcost<DUAL>(jc + c, g);
      const int e = imax(el, hl - g.go) - g.ge;
      int bs = imax(hd + (code[c] == tx[c] ? match : mismatch), e);
      int e2 = NEG;
      if (DUAL) {
        const int e2l = c > 0 ? E2[0] : e2n;
        e2 = imax(e2l, hl - g.go2) - g.ge2;
        bs = imax(bs, e2);
      }
      bs = ok ? bs : NEG;
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
    if (lane == 31) {
      if (wq + 1 < G) {
        // to warp wq + 1, for its next step
        int* x = xch + ((d & 1) * G + wq) * 3;
        x[0] = H[1];
        x[1] = E[1];
        if (DUAL) x[2] = E2[1];
      } else if (wr && ok1) {
        // the right edge: the strip's last column, band row qi - j + Wb
        const int i = d - 2 * (jc + 1) + Wb;
        edge[i] = H[1];
        edge[ld + i] = E[1];
        if (DUAL) edge[2 * ld + i] = E2[1];
      }
    }
    if (G > 1) sync();
  }

  // the strip's columns retired in ascending j: the pair's outputs as
  // the plain loop's column by column updates leave them, in every warp
  // on the columns' values through shared memory. Lane l takes columns
  // C l .. C l + C - 1; a warp max-scan gives the best before each
  // column; the first column whose best passes it by more than zdrop
  // ends the strip (and the walk); the outputs are the first columns of
  // the largest values up to it. The first barrier also orders the
  // right edge's stores before the next strip's loads
  __device__ __forceinline__ void retire() {
    constexpr int R = 64 * G, C = 2 * G;
    sync();
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int s = jc - j0 + c;
      rbuf[s] = cm[c];
      rbuf[R + s] = cq[c];
      rbuf[2 * R + s] = hlast[c];
    }
    sync();
    const int n = imin(ncol - j0, R);
    const int s0 = C * lane;
    // column s's maximum (NEG past the strip's last live column)
    auto colb = [&](int s) { return s < n ? rbuf[s] : NEG; };
    int m = NEG;
#pragma unroll
    for (int k = 0; k < C; ++k) m = imax(m, colb(s0 + k));
    // the best before the lane's first column
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(LQ_FULL, m, o);
      if (lane >= o) m = imax(m, y);
    }
    int run = __shfl_up_sync(LQ_FULL, m, 1);
    run = imax(best, lane == 0 ? NEG : run);
    int kd = C;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int v = colb(s0 + k);
      run = imax(run, v);
      if (kd == C && s0 + k < n && run - v > zdrop) kd = k;
    }
    const unsigned dm = __ballot_sync(LQ_FULL, kd < C);
    int end = n - 1;  // the strip's last column that counts
    dropped = dm != 0;
    if (dropped) {
      const int l = __ffs(dm) - 1;
      end = C * l + __shfl_sync(LQ_FULL, kd, l);
    }
    // the first column of the largest maximum up to `end`, if above best
    int v = NEG;
#pragma unroll
    for (int k = 0; k < C; ++k)
      if (s0 + k <= end) v = imax(v, colb(s0 + k));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      v = imax(v, __shfl_xor_sync(LQ_FULL, v, o));
    if (v > best) {
      int kb = C;
#pragma unroll
      for (int k = C - 1; k >= 0; --k)
        if (s0 + k <= end && colb(s0 + k) == v) kb = k;
      const unsigned bm = __ballot_sync(LQ_FULL, kb < C);
      const int l = __ffs(bm) - 1;
      const int s = C * l + __shfl_sync(LQ_FULL, kb, l);
      best = v;
      bq = rbuf[R + s];
      bt = j0 + s;
    }
    // the target's last column
    const int st = tl - 1 - j0;
    if (st >= 0 && st <= end && rbuf[st] > mte) {
      mte = rbuf[st];
      mteq = rbuf[R + st];
    }
    // the query-end cell: the first column of the largest among those
    // whose band holds query index ql - 1
    const int lo = imax(0, ql - 1 - Wb - j0);
    const int hi = imin(end, ql - 1 + Wb - j0);
    if (ql >= 1 && lo <= hi) {
      int u = NEG;
#pragma unroll
      for (int k = 0; k < C; ++k)
        if (s0 + k >= lo && s0 + k <= hi) u = imax(u, rbuf[2 * R + s0 + k]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        u = imax(u, __shfl_xor_sync(LQ_FULL, u, o));
      if (u > mqe) {
        int kq = C;
#pragma unroll
        for (int k = C - 1; k >= 0; --k)
          if (s0 + k >= lo && s0 + k <= hi && rbuf[2 * R + s0 + k] == u)
            kq = k;
        const unsigned qm = __ballot_sync(LQ_FULL, kq < C);
        const int l = __ffs(qm) - 1;
        mqe = u;
        mqet = j0 + C * l + __shfl_sync(LQ_FULL, kq, l);
      }
    }
  }
};

// G warps a pair, P pairs a block: pair slot k = block x P + warp / G,
// below nslot, walks the pairs order[k],
// order[k + nslot], ...; its boundary column at scratch + k * (2 +
// DUAL) * ld, its warps meet at named barrier 1 + warp / G
template <int G, bool DUAL>
__global__ void __launch_bounds__(32 * (G < WIDE_WARPS ? WIDE_WARPS : G))
    lq_extend_wide_kernel(
    const int32_t* __restrict__ q, const int32_t* __restrict__ qlens,
    const int32_t* __restrict__ t, const int32_t* __restrict__ tlens,
    const int32_t* __restrict__ order, int32_t* __restrict__ out, int B,
    int Lq, int Lt, int W, int match, int mismatch, Gaps g, int zdrop,
    int32_t* scratch, int ld, int nslot) {
  constexpr int P = G < WIDE_WARPS ? WIDE_WARPS / G : 1;  // pairs a block
  __shared__ int xch[P][2 * G * 3];
  __shared__ int rbuf[P][3 * 64 * G];
  const int warp = threadIdx.x >> 5;
  const int slot = blockIdx.x * P + warp / G;
  if (slot >= nslot) return;
  Strip<G, DUAL> w;
  w.lane = threadIdx.x & 31;
  w.wq = warp % G;
  w.bar = 1 + warp / G;
  w.match = match;
  w.mismatch = mismatch;
  w.zdrop = zdrop;
  w.g = g;
  w.ld = ld;
  w.edge = scratch + (size_t)slot * (DUAL ? 3 : 2) * ld;
  w.xch = xch[warp / G];
  w.rbuf = rbuf[warp / G];
  w.code[0] = w.code[1] = 4;
  w.hlp[0] = w.hlp[1] = NEG;
  w.cq[0] = w.cq[1] = 0;
  w.hlast[0] = w.hlast[1] = NEG;
  constexpr int S = 64 * G;
  for (int i = slot; i < B; i += nslot) {
    const int b = order[i];
    w.ql = qlens[b];
    w.tl = tlens[b];
    w.ncol = w.tl < Lt ? w.tl : Lt;
    const int m = imax(w.ql, w.ncol);
    w.Wb = imax(0, W < m ? W : m);
    w.qlim = (unsigned)imax(0, w.ql < Lq ? w.ql : Lq);
    w.qrow = q + (size_t)b * Lq;
    w.trow = t + (size_t)b * Lt;
    w.best = 0;
    w.bq = w.bt = w.mqet = w.mteq = -1;
    w.mqe = w.mte = NEG;
    w.dropped = false;
    for (int j0 = 0; j0 < w.ncol && !w.dropped; j0 += S) {
      w.j0 = j0;
      const int d0 = j0 + imax(0, j0 - w.Wb);
      const int jend = imin(w.ncol, j0 + S) - 1;
      const int dlast = jend + imin(w.ql - 1, jend + w.Wb);
      const bool wr = j0 + S < w.ncol;
      w.begin(d0);
      int d = d0 - 1;
      if (d0 == j0)
        for (const int dend = imin(dlast, j0 + S - 1); d <= dend; ++d)
          w.template step<true>(d, wr);
      for (; d <= dlast; ++d) w.template step<false>(d, wr);
      w.retire();
    }
    if (w.wq == 0 && w.lane == 0) {
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
}

template <int G>
int lq_extend_wide_launch(const void* q, const void* ql, const void* t,
                          const void* tl, const void* order, void* out, int B,
                          int Lq, int Lt, int W, int match, int mismatch,
                          Gaps g, int zdrop, int dual, void* scratch, int ld,
                          int nslot, cudaStream_t st) {
  constexpr int P = G < WIDE_WARPS ? WIDE_WARPS / G : 1;
  const int blocks = (nslot + P - 1) / P;
  if (dual)
    lq_extend_wide_kernel<G, true><<<blocks, 32 * G * P, 0, st>>>(
        (const int32_t*)q, (const int32_t*)ql, (const int32_t*)t,
        (const int32_t*)tl, (const int32_t*)order, (int32_t*)out, B, Lq, Lt,
        W, match, mismatch, g, zdrop, (int32_t*)scratch, ld, nslot);
  else
    lq_extend_wide_kernel<G, false><<<blocks, 32 * G * P, 0, st>>>(
        (const int32_t*)q, (const int32_t*)ql, (const int32_t*)t,
        (const int32_t*)tl, (const int32_t*)order, (int32_t*)out, B, Lq, Lt,
        W, match, mismatch, g, zdrop, (int32_t*)scratch, ld, nslot);
  return (int)cudaGetLastError();
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
                                   const void* t, const void* tl,
                                   const void* order, void* out, int B,
                                   int Lq, int Lt, int W, int Wa, int match,
                                   int mismatch, int gapo, int gape,
                                   int gapo2, int gape2, int zdrop, int dual,
                                   void* scratch, int nslot, int G,
                                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B <= 0) return 0;
  if (W <= 0 || Wa < 0 || Wa > W || nslot <= 0 || !scratch)
    return (int)cudaErrorInvalidValue;
  const Gaps g{gapo, gape, gapo2, gape2};
  // a pair slot's boundary column: 2 Wa + 1 band rows of H, E (and E2)
  const int ld = 2 * Wa + 1;
  if (nslot > B) nslot = B;
  switch (G) {
    case 1:
      return lq_extend_wide_launch<1>(q, ql, t, tl, order, out, B, Lq, Lt, W,
                                      match, mismatch, g, zdrop, dual,
                                      scratch, ld, nslot, st);
    case 2:
      return lq_extend_wide_launch<2>(q, ql, t, tl, order, out, B, Lq, Lt, W,
                                      match, mismatch, g, zdrop, dual,
                                      scratch, ld, nslot, st);
    case 4:
      return lq_extend_wide_launch<4>(q, ql, t, tl, order, out, B, Lq, Lt, W,
                                      match, mismatch, g, zdrop, dual,
                                      scratch, ld, nslot, st);
    case 8:
      return lq_extend_wide_launch<8>(q, ql, t, tl, order, out, B, Lq, Lt, W,
                                      match, mismatch, g, zdrop, dual,
                                      scratch, ld, nslot, st);
  }
  return (int)cudaErrorInvalidValue;
}
