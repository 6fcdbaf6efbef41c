// The adapter search's alignment of every candidate window of one side
// (ops/adapter.cut_adapter): one traceback's distance, start, end and
// length, and the bounds over every optimal alignment, for C windows
// against one adapter in one launch.
//
// Replaces no TPU kernel: the JAX package runs this traceback on the
// host, one candidate at a time (longqc_tpu/ops/adapter.py,
// hw_align_host and hw_align_optrange); the port's plain twin
// (ops/adapter.hw_align_batch on CPU tensors) runs the same DP by numpy
// over all windows at once. Per candidate the kernel gives, bit for bit,
// what the two host functions give: the semi-global (HW) DP D[i][j] =
// min(D[i-1][j-1] + (a[i-1] != t[j-1]), D[i-1][j] + 1, D[i][j-1] + 1)
// with D[0][j] = 0 and D[i][0] = i; dist, the minimum of row m over
// columns 1..n, and end + 1, the first column that reaches it; the
// traceback from (m, end + 1), a diagonal move first, then a query
// move, then a target move, down to row 0, with its start column and its count of moves (align_len); and
// amin / amax / smin / smax at (m, end + 1): over the optimal prefix
// paths from a cell (0, s) to a cell, the fewest and most moves and the
// smallest and largest s, each the min / max over the cell's optimal
// predecessors (+1 for the moves), from (0, j) = (0, 0, j, j) and
// (i, 0) = (i, i, 0, 0). A cell's bounds read only its three
// predecessors, which the wavefront has finished before it, so one pass
// gives them at every cell and no second DP runs once `end` is known.
//
// One warp a candidate. The adapter's rows are walked in strips of 32,
// one row a lane (row 32 k + lane + 1 in strip k), so any adapter length
// runs. A strip is an anti-diagonal wavefront over the window's columns:
// at step s lane l computes column j = s - l from its own cell of the
// step before (left) and lane l - 1's cells of the two steps before
// (above and diagonal), passed down by one shuffle of five values a
// step. Lane 0 takes row 32 k's cells from the strip before, which that
// strip's lane 31 wrote to an edge buffer in device memory (two by strip
// parity, so a strip never reads the buffer it writes), loaded two steps
// ahead. Each cell's move (0 diagonal, 1 query, 2 target) is a byte in
// device memory at (strip, step, lane), so the 32 lanes of a step write
// one 32-byte sector. The lane of row m keeps the first column of the
// row's minimum and its bounds; after the last strip lane 0 walks the
// moves back from (m, end + 1) and writes the eight outputs. A window of
// no columns gives -1 in every output, where the host functions give
// None. The wrapper (ops/adapter.hw_align_batch) gives each of nslot
// warp slots its moves and edges in scratch; a warp walks candidates
// slot, slot + nslot, ...
//
// Bound on this card: integer operations, some 20 a cell (the min of
// three, three compares, four bounds of up to three terms, the move), on
// about 5,200 candidates x 18 or 28 rows x 150 columns in a sampleqc job
// of the ont-ligation preset: 20-30 M operations, microseconds at the
// card's integer rate. At such sizes the kernel is bound by latency and
// its launch: one wave of warps (1,850-3,700 on 132 SMs) whose walk is
// n + 31 dependent steps a strip (181 at n = 150), each a cell and a
// shuffle's latency, then up to m + n dependent loads of the traceback,
// mostly from L1.

#include <cuda_runtime.h>
#include <stdint.h>

#include "kernels.h"

#define LQ_FULL 0xffffffffu

namespace {

constexpr int WARPS = 4;          // warps (candidate slots) a block
constexpr int BIG = 0x3fffffff;

__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }

// one DP cell: its distance and its four bounds
struct Cell {
  int d, amin, amax, smin, smax;
};

__device__ __forceinline__ Cell shfl_up1(const Cell& c) {
  return {__shfl_up_sync(LQ_FULL, c.d, 1),
          __shfl_up_sync(LQ_FULL, c.amin, 1),
          __shfl_up_sync(LQ_FULL, c.amax, 1),
          __shfl_up_sync(LQ_FULL, c.smin, 1),
          __shfl_up_sync(LQ_FULL, c.smax, 1)};
}

// row 32 k's cell at column j (j <= n is read), for lane 0 of strip k:
// row 0 for k = 0, else the edge buffer the strip before wrote
__device__ __forceinline__ Cell edge_cell(const int32_t* e, int k, int j,
                                          int n) {
  if (k == 0) return {0, 0, 0, j, j};
  const int32_t* p = e + 5 * imin(j, n);
  return {p[0], p[1], p[2], p[3], p[4]};
}

__global__ void __launch_bounds__(32 * WARPS) lq_adapter_align_kernel(
    const int32_t* __restrict__ adp, const int32_t* __restrict__ win,
    const int32_t* __restrict__ wlen, int32_t* __restrict__ out,
    uint8_t* __restrict__ moves, int32_t* __restrict__ edges, int C, int m,
    int Lw, int nslot) {
  const int lane = threadIdx.x & 31;
  const int slot = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (slot >= nslot) return;
  const int strips = (m + 31) >> 5;
  const int T = Lw + 32;  // steps a strip, at most: the moves' stride
  const int EW = 5 * (Lw + 1);
  uint8_t* mv = moves + (size_t)slot * strips * T * 32;
  int32_t* eb = edges + (size_t)slot * 2 * EW;
  for (int c = slot; c < C; c += nslot) {
    const int n = imin(imax(__ldg(wlen + c), 0), Lw);
    if (n == 0) {
      if (lane < 8) out[(size_t)lane * C + c] = -1;
      continue;
    }
    const int32_t* t = win + (size_t)c * Lw;
    // row m's minimum so far (in its lane): distance, column, bounds
    int best = BIG, bj = 0, bamin = 0, bamax = 0, bsmin = 0, bsmax = 0;
    for (int k = 0; k < strips; ++k) {
      const int i = 32 * k + lane + 1;
      const int rows = imin(32, m - 32 * k);
      const bool row = lane < rows;
      const int a = row ? __ldg(adp + i - 1) : 0;
      const int32_t* ein = eb + ((k + 1) & 1) * EW;
      int32_t* eout = (k + 1 < strips && lane == 31) ? eb + (k & 1) * EW
                                                     : nullptr;
      uint8_t* ms = mv + (size_t)k * T * 32 + lane;
      Cell L = {i, i, i, 0, 0};  // column 0
      Cell U = edge_cell(ein, k, 0, n), G = U;
      Cell nx = edge_cell(ein, k, 1, n);
      const int steps = n + rows;
      for (int s = 0; s < steps; ++s) {
        const int j = s - lane;
        Cell o = L;  // column 0 at j == 0, else this step's cell
        if (row && j >= 1 && j <= n) {
          const int dg = G.d + (a != __ldg(t + j - 1));
          const int up = U.d + 1, lf = L.d + 1;
          const int d = imin(dg, imin(up, lf));
          int amn = BIG, amx = -BIG, smn = BIG, smx = -BIG;
          if (dg == d) {
            amn = G.amin; amx = G.amax; smn = G.smin; smx = G.smax;
          }
          if (up == d) {
            amn = imin(amn, U.amin); amx = imax(amx, U.amax);
            smn = imin(smn, U.smin); smx = imax(smx, U.smax);
          }
          if (lf == d) {
            amn = imin(amn, L.amin); amx = imax(amx, L.amax);
            smn = imin(smn, L.smin); smx = imax(smx, L.smax);
          }
          o = {d, amn + 1, amx + 1, smn, smx};
          ms[(size_t)s * 32] = dg == d ? 0 : (up == d ? 1 : 2);
          if (i == m && d < best) {
            best = d; bj = j;
            bamin = o.amin; bamax = o.amax; bsmin = o.smin; bsmax = o.smax;
          }
          L = o;
        }
        if (eout != nullptr && j >= 0 && j <= n) {
          int32_t* p = eout + 5 * j;
          p[0] = o.d; p[1] = o.amin; p[2] = o.amax; p[3] = o.smin;
          p[4] = o.smax;
        }
        const Cell above = shfl_up1(o);
        G = U;
        if (lane == 0) {
          U = nx;
          nx = edge_cell(ein, k, s + 2, n);
        } else {
          U = above;
        }
      }
      __syncwarp();  // the moves and the edge before their readers
    }
    const int src = (m - 1) & 31;  // row m's lane
    best = __shfl_sync(LQ_FULL, best, src);
    bj = __shfl_sync(LQ_FULL, bj, src);
    bamin = __shfl_sync(LQ_FULL, bamin, src);
    bamax = __shfl_sync(LQ_FULL, bamax, src);
    bsmin = __shfl_sync(LQ_FULL, bsmin, src);
    bsmax = __shfl_sync(LQ_FULL, bsmax, src);
    if (lane == 0) {
      int ii = m, jj = bj, ops = 0;
      while (ii > 0 && jj > 0) {
        const int l = (ii - 1) & 31;
        const int mo = mv[((size_t)((ii - 1) >> 5) * T + jj + l) * 32 + l];
        ++ops;
        if (mo != 2) --ii;
        if (mo != 1) --jj;
      }
      ops += ii;  // column 0: query moves down to row 0
      const int res[8] = {best, jj, bj - 1, ops, bamin, bamax, bsmin, bsmax};
#pragma unroll
      for (int f = 0; f < 8; ++f) out[(size_t)f * C + c] = res[f];
    }
    __syncwarp();  // the traceback's reads before the next candidate
  }
}

}  // namespace

extern "C" int lq_adapter_align(const void* adp, const void* win,
                                const void* wlen, void* out, void* moves,
                                void* edges, int C, int m, int Lw, int nslot,
                                void* stream) {
  if (C <= 0 || nslot <= 0) return 0;
  const int blocks = (nslot + WARPS - 1) / WARPS;
  lq_adapter_align_kernel<<<blocks, 32 * WARPS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)adp, (const int32_t*)win, (const int32_t*)wlen,
      (int32_t*)out, (uint8_t*)moves, (int32_t*)edges, C, m, Lw, nslot);
  return (int)cudaGetLastError();
}
