// B2: chain-DP score fill over the whole admissible window.
//
// Replaces the Pallas kernel longqc_tpu/ops/chain_pallas.py
// (_make_kernel / _chain_dp_pallas_t), itself a fixed-depth
// reformulation of mm_chain_dp's fill (chain.c:41-80). This kernel
// computes the reference fill exactly (engine/overlap_host.chain_dp):
// for anchor i the predecessors are every earlier anchor j of the row
// with the same x_hi and 0 <= x_lo[i] - x_lo[j] <= max_dist, scored
// youngest first (max_dist / bw gating, gap cost (int)(dd*.01*avg_qspan)
// + (ilog2(dd)>>1) read from the f64-exact host table
// gap_penalty_table, one table per row or one for all), the strict
// running max in age order picks the parent, and the scan stops where
// the max_skip walk breaks. There is no depth limit, so there is no
// truncation flag and no retry at a deeper limit.
//
// Design: the unit of work is a piece, a run of whole segments of one
// row, where a segment is the anchors of one x_hi (one strand of one
// target). An anchor's predecessors share its x_hi, a max_skip mark
// t[p[j]] = i lands on the parent of a valid predecessor (same x_hi),
// and v_pred reads v at the parent: so the fill of a row is the
// concatenation of independent fills, one per segment, and a warp that
// starts at a segment's first anchor with empty registers gives the
// same f, p and v as one that walked the row from its start. A row is
// cut at P nominal points (w * ceil(n / P)), each moved forward to the
// next segment start (an upper bound of x_hi[c - 1] over [c, n): the
// row is sorted), and piece w is [start_w, start_{w+1}); one warp walks
// each piece. P comes from the launch (ops/chain_cuda.pieces_per_row:
// about 32 warps an SM over the call's rows, more a row as a call has
// fewer rows), and a block holds LQ_PIECE_WARPS pieces of one row, which
// share its penalty table in shared memory. A row of one segment gets
// one busy warp; empty pieces only initialise their share of the row.
//
// A warp's walk: the anchors of its piece are a serial recurrence; the
// parallelism is across the ages of one anchor's scan, 32 at a time:
// lane l of chunk c scores age 32c + l + 1. Chunk 0 (ages 1..32) lives
// in registers, as a window that shifts by one lane per anchor (lane 0
// takes the anchor just written). Older chunks read the row's inputs
// and the kernel's own f / p, written earlier by lane 0 of this warp
// (ordered by __syncwarp, read through plain loads: no __ldg / const
// __restrict__ on the outputs). An age that reaches before the piece's
// start is outside the window. The scan stops at the first chunk whose
// oldest lane is outside the window (rows are sorted by (x_hi, x_lo),
// so everything older is outside too) or at the max_skip cut, so most
// anchors pay for one chunk and only repeat-dense windows for more.
// Every age-ordered scan (running max, the skip walk's sum and minimum)
// is a warp scan by shuffles with a prefix handed on from chunk to
// chunk.
//
// max_skip marks: the reference's t[] array, a (Q, A) int32 scratch
// each warp sets to -1 over its piece (t[j] = the anchor that last
// marked j). Marks from younger lanes onto older lanes of the same
// chunk are resolved by ballots; marks onto older chunks are written
// t[p[j]] = i after the chunk's walk. A mark only ever targets an older
// entry and its value is i, which no later anchor tests, so marks
// written by entries past the cut are harmless and one pass gives the
// reference's cut (the TPU kernel's second bounding pass has no
// counterpart).
//
// Counters (cnt, three int32): the non-empty pieces, the longest row
// and the longest piece of the call, in anchors.
//
// Bound: a piece's per-anchor dependency chain (one to a few chunks of
// warp scans of five shuffles, an L1-resident load per older chunk) is
// latency; with Q x P warps in flight the card is bound by the
// instruction throughput across warps, and a call lasts at least as
// long as its longest piece's walk, which is at least its longest
// segment's. The int64 dr / dq arithmetic is the reference's.

#include <cuda_runtime.h>
#include <stdint.h>

#include "kernels.h"

#define LQ_NEG (-1000000000)
#define LQ_FULL 0xffffffffu
// pieces (warps) a block, of one row
#define LQ_PIECE_WARPS 4

namespace {

__device__ __forceinline__ int scan_max(int x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(LQ_FULL, x, o);
    if (lane >= o) x = y > x ? y : x;
  }
  return x;
}

__device__ __forceinline__ int scan_min(int x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(LQ_FULL, x, o);
    if (lane >= o) x = y < x ? y : x;
  }
  return x;
}

__device__ __forceinline__ int scan_add(int x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(LQ_FULL, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// the first anchor at or after c that starts a segment of row x (sorted
// over [0, n)): c itself, or the upper bound of x[c - 1] over [c, n)
__device__ __forceinline__ int piece_start(const int32_t* x, int n, int c) {
  if (c <= 0) return 0;
  if (c >= n) return n;
  const int32_t key = x[c - 1];
  int lo = c, hi = n;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (x[mid] > key) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo;
}

}  // namespace

__global__ void __launch_bounds__(32 * LQ_PIECE_WARPS) lq_chain_fill_kernel(
    const int32_t* __restrict__ axh, const int32_t* __restrict__ axl,
    const int32_t* __restrict__ aq, const int32_t* __restrict__ asp,
    const int32_t* __restrict__ nb, const int32_t* __restrict__ pen_g,
    int32_t* tmark, int32_t* of, int32_t* op, int32_t* ov, int32_t* cnt,
    int Q, int A, int P, int bw, int pen_stride, int max_dist,
    int max_skip) {
  const int row = blockIdx.x;
  if (row >= Q) return;
  extern __shared__ int32_t pen[];
  const int32_t* pen_row = pen_g + (size_t)row * pen_stride;
  for (int t = threadIdx.x; t <= bw; t += blockDim.x) pen[t] = pen_row[t];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int w = blockIdx.y * LQ_PIECE_WARPS + (threadIdx.x >> 5);
  const size_t ab = (size_t)row * A;
  const int32_t* rxh = axh + ab;
  const int32_t* rxl = axl + ab;
  const int32_t* rq = aq + ab;
  int32_t* rt = tmark + ab;
  int32_t* rf = of + ab;
  int32_t* rp = op + ab;
  int32_t* rv = ov + ab;
  const int n = max(0, min(nb[row], A));
  // past n, shared by the row's P warps
  for (int a = n + 32 * w + lane; a < A; a += 32 * P) {
    rf[a] = 0;
    rp[a] = -1;
    rv[a] = 0;
  }
  const int step = (n + P - 1) / P;
  const int s = piece_start(rxh, n, w * step);
  const int e = piece_start(rxh, n, (w + 1) * step);
  if (s >= e) return;
  for (int a = s + lane; a < e; a += 32) rt[a] = -1;
  if (lane == 0) {
    atomicAdd(cnt, 1);
    atomicMax(cnt + 2, e - s);
    if (s == 0) atomicMax(cnt + 1, n);
  }
  __syncwarp();

  // chunk 0 in registers: lane l holds age l + 1 (entry i - 1 - l)
  int cxh = -1, cxl = 0, cq = 0, cf = 0, cp = -1, cv = 0;
  int pxh = 0, pxl = 0, pq = 0, ps = 0;

  for (int i = s; i < e; ++i) {
    const int src = (i - s) & 31;
    if (src == 0 && i + lane < e) {
      pxh = rxh[i + lane];
      pxl = rxl[i + lane];
      pq = rq[i + lane];
      ps = asp[ab + i + lane];
    }
    const int xh = __shfl_sync(LQ_FULL, pxh, src);
    const int xl = __shfl_sync(LQ_FULL, pxl, src);
    const int qi = __shfl_sync(LQ_FULL, pq, src);
    const int si = __shfl_sync(LQ_FULL, ps, src);

    int run = si;          // running max (max_f), from the initial q_span
    int s_prev = 0, m_prev = 0;   // skip walk: sum, min prefix (<= 0)
    int best_sc = si, best_age = 0, best_v = 0;
    for (int c = 0;; ++c) {
      const int age = 32 * c + lane + 1;
      const int j = i - age;
      int exh, exl, eq, ef, ep, ev;
      bool marked;
      if (c == 0) {
        exh = cxh;
        exl = cxl;
        eq = cq;
        ef = cf;
        ep = cp;
        ev = cv;
        marked = false;  // anchor i has written no mark yet
      } else if (j >= s) {
        exh = rxh[j];
        exl = rxl[j];
        eq = rq[j];
        ef = rf[j];
        ep = rp[j];
        ev = 0;
        marked = rt[j] == i;
      } else {
        exh = -1;
        exl = eq = ef = ev = 0;
        ep = -1;
        marked = false;
      }
      const long long dr = (long long)xl - exl;
      const bool in_win = j >= s && exh == xh && dr >= 0 && dr <= max_dist;
      const long long dq = (long long)qi - eq;
      bool valid = in_win && dr != 0 && dq > 0 && dq <= max_dist;
      int sc = LQ_NEG;
      if (valid) {
        const long long dd = dr > dq ? dr - dq : dq - dr;
        valid = dd <= bw;
        if (valid) {
          int m = (int)(dq < dr ? dq : dr);
          m = m < si ? m : si;
          sc = m - pen[(int)dd] + ef;
        }
      }
      // strict running max in age order, exclusive prefix
      const int incl = scan_max(sc, lane);
      int before = __shfl_up_sync(LQ_FULL, incl, 1);
      if (lane == 0) before = LQ_NEG;
      before = before > run ? before : run;
      const bool newmax = valid && sc > before;
      const int tot = __shfl_sync(LQ_FULL, incl, 31);
      run = tot > run ? tot : run;

      // marks from younger lanes of this chunk (valid entries' parents)
      const int tl = (i - ep) - 32 * c - 1;  // parent's lane in this chunk
      const bool mk_src = valid && ep >= 0;
      const uint32_t in_chunk = __reduce_or_sync(
          LQ_FULL, (mk_src && tl > lane && tl < 32) ? (1u << tl) : 0u);
      marked = marked || ((in_chunk >> lane) & 1u);

      // the max_skip walk: n_skip = S - min(0, min prefix of S)
      const bool skipev = valid && !newmax && marked;
      const int S = scan_add(skipev ? 1 : (newmax ? -1 : 0), lane) + s_prev;
      int mn = scan_min(S, lane);
      mn = mn < m_prev ? mn : m_prev;
      const int walk = S - (mn < 0 ? mn : 0);
      const uint32_t brk = __ballot_sync(LQ_FULL, skipev && walk > max_skip);

      // parent: the oldest new maximum before the cut (the highest score)
      uint32_t nm = __ballot_sync(LQ_FULL, newmax);
      if (brk) nm &= (1u << (__ffs(brk) - 1)) - 1u;
      if (nm) {
        const int pl = 31 - __clz(nm);
        best_sc = __shfl_sync(LQ_FULL, sc, pl);
        best_v = __shfl_sync(LQ_FULL, ev, pl);
        best_age = 32 * c + pl + 1;
      }
      const bool more =
          !brk && ((__ballot_sync(LQ_FULL, in_win) >> 31) & 1u);
      if (more) {
        // marks onto older chunks, read by the next chunks' lanes
        if (mk_src && tl >= 32) rt[ep] = i;
        s_prev = __shfl_sync(LQ_FULL, S, 31);
        m_prev = __shfl_sync(LQ_FULL, mn, 31);
        m_prev = m_prev < 0 ? m_prev : 0;
        __syncwarp();
      } else {
        break;
      }
    }

    const bool has_pred = best_age > 0;
    const int f_i = best_sc;
    const int p_i = has_pred ? i - best_age : -1;
    int v_pred = best_v;
    if (has_pred && best_age > 32) v_pred = rv[p_i];
    const int v_i = (has_pred && v_pred > f_i) ? v_pred : f_i;

    // shift the register chunk by one age; lane 0 takes anchor i
    cxh = __shfl_up_sync(LQ_FULL, cxh, 1);
    cxl = __shfl_up_sync(LQ_FULL, cxl, 1);
    cq = __shfl_up_sync(LQ_FULL, cq, 1);
    cf = __shfl_up_sync(LQ_FULL, cf, 1);
    cp = __shfl_up_sync(LQ_FULL, cp, 1);
    cv = __shfl_up_sync(LQ_FULL, cv, 1);
    if (lane == 0) {
      cxh = xh;
      cxl = xl;
      cq = qi;
      cf = f_i;
      cp = p_i;
      cv = v_i;
      rf[i] = f_i;
      rp[i] = p_i;
      rv[i] = v_i;
    }
    __syncwarp();
  }
}

extern "C" int lq_chain_fill(const void* axh, const void* axl, const void* aq,
                             const void* asp, const void* nb, const void* pen,
                             void* tmark, void* of, void* op, void* ov,
                             void* cnt, int Q, int A, int P, int bw,
                             int pen_stride, int max_dist, int max_skip,
                             void* stream) {
  if (Q <= 0) return 0;
  if (P <= 0 || P % LQ_PIECE_WARPS) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(bw + 1) * sizeof(int32_t);
  cudaError_t e = cudaFuncSetAttribute(
      lq_chain_fill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(Q, P / LQ_PIECE_WARPS);
  lq_chain_fill_kernel<<<grid, 32 * LQ_PIECE_WARPS, smem,
                         (cudaStream_t)stream>>>(
      (const int32_t*)axh, (const int32_t*)axl, (const int32_t*)aq,
      (const int32_t*)asp, (const int32_t*)nb, (const int32_t*)pen,
      (int32_t*)tmark, (int32_t*)of, (int32_t*)op, (int32_t*)ov,
      (int32_t*)cnt, Q, A, P, bw, pen_stride, max_dist, max_skip);
  return (int)cudaGetLastError();
}
