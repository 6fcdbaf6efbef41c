// B2: chain-DP score fill over a J-deep predecessor ring.
//
// Replaces the Pallas kernel longqc_tpu/ops/chain_pallas.py
// (_make_kernel / _chain_dp_pallas_t), itself the ring reformulation of
// mm_chain_dp's fill (chain.c:41-80): per anchor i the last J anchors
// are scored as predecessors (max_dist / bw gating, gap cost
// (int)(dd*.01*avg_qspan) + (ilog2(dd)>>1) read from the f64-exact
// host table gap_penalty_table, one table per row or one for all), the
// strict running max in age order
// picks the parent, and the max_skip cut runs the same two bounding
// passes (marks from every admissible entry, then marks from entries
// before the first-pass cut). A row is flagged when the passes
// disagree or when the ring is shorter than the admissible window
// (trunc); the engine escalates flagged rows to J = 128 / 256 and then
// to the exact host spec. The ring carry makes calls chunk-resumable.
//
// Design: one warp per query row. The anchors of a row are a serial
// recurrence, so the parallelism is across the J ring entries of one
// anchor: lane l scores ages l+1, l+33, ... (J/32 of them), and every
// age-ordered scan of the TPU kernel (running max, the skip walk's sum
// and minimum) is a warp scan by shuffles, chunk by chunk with a
// carried prefix. Per-age masks are ballots, so the mark words of the
// max_skip passes are OR-reductions of one word per lane. The ring
// lives in shared memory as a circular buffer (age a at slot
// (head + a - 1) mod J, so a push is one write); the row's (bw+1)-entry
// penalty table sits beside it. Anchors are read 32 at a time, one per
// lane, and broadcast by shuffle. Layout is (Q, A) row-major; carry is
// (7, Q, J) in age order plus a (Q,) flag, the same values as the TPU
// kernel's transposed carry.
//
// Bound: the per-anchor dependency chain (shared-memory loads, three to
// five warp scans of five shuffles), with Q warps in flight: latency,
// not bytes or operations. One warp per block (one row per block, which
// also gives each row its own table) spreads the rows over the SMs.

#include <cuda_runtime.h>
#include <stdint.h>

#include "kernels.h"

#define LQ_NEG (-1000000000)
#define LQ_FULL 0xffffffffu

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

// First age (1-based) at which the max_skip walk breaks, else J + 1.
// Word t bit l of vb / nm / mk stands for age 32t + l + 1.
template <int J>
__device__ __forceinline__ int walk_cut(const uint32_t* vb,
                                        const uint32_t* nm,
                                        const uint32_t* mk, int max_skip,
                                        int lane) {
  constexpr int NW = J / 32;
  int s_carry = 0, m_carry = 1 << 30;
#pragma unroll
  for (int t = 0; t < NW; ++t) {
    const bool v = (vb[t] >> lane) & 1u;
    const bool n = (nm[t] >> lane) & 1u;
    const bool m = (mk[t] >> lane) & 1u;
    const bool skipev = v && !n && m;
    const int S = scan_add(skipev ? 1 : (n ? -1 : 0), lane) + s_carry;
    int mn = scan_min(S, lane);
    mn = mn < m_carry ? mn : m_carry;
    const int walk = S - (mn < 0 ? mn : 0);
    const uint32_t brk = __ballot_sync(LQ_FULL, skipev && walk > max_skip);
    if (brk) return 32 * t + __ffs(brk);
    s_carry = __shfl_sync(LQ_FULL, S, 31);
    m_carry = __shfl_sync(LQ_FULL, mn, 31);
  }
  return J + 1;
}

// Mark words: bit (tgt - 1) for the parent age tgt of every entry of
// age < lim whose parent lies in the ring (tg[t] = that age, or 0).
template <int J>
__device__ __forceinline__ void marks_from(const int* tg, int lim, int lane,
                                           uint32_t* mk) {
  constexpr int NW = J / 32;
#pragma unroll
  for (int wd = 0; wd < NW; ++wd) {
    uint32_t mine = 0u;
#pragma unroll
    for (int t = 0; t < NW; ++t) {
      const int g = tg[t] - 1;
      if (32 * t + lane + 1 < lim && g >= 0 && (g >> 5) == wd)
        mine |= 1u << (g & 31);
    }
    mk[wd] = __reduce_or_sync(LQ_FULL, mine);
  }
}

}  // namespace

template <int J>
__global__ void lq_chain_fill_kernel(
    const int32_t* __restrict__ axh, const int32_t* __restrict__ axl,
    const int32_t* __restrict__ aq, const int32_t* __restrict__ asp,
    const int32_t* __restrict__ nb, const int32_t* __restrict__ pen_g,
    const int32_t* __restrict__ carry_in,
    const int32_t* __restrict__ cflag_in, int32_t* __restrict__ of,
    int32_t* __restrict__ op, int32_t* __restrict__ ov,
    int32_t* __restrict__ carry_out, int32_t* __restrict__ cflag_out, int Q,
    int A, int bw, int pen_stride, int max_dist, int max_skip, int i0) {
  constexpr int NW = J / 32;
  // one warp, so one query row, per block
  const int row = blockIdx.x;
  if (row >= Q) return;
  extern __shared__ int32_t smem[];
  int32_t* pen = smem;
  const int32_t* pen_row = pen_g + (size_t)row * pen_stride;
  const int lane = threadIdx.x;
  for (int t = lane; t <= bw; t += 32) pen[t] = pen_row[t];
  int32_t* ring = smem + ((bw + 4) & ~3);
  int32_t* rxh = ring;
  int32_t* rxl = ring + J;
  int32_t* rq = ring + 2 * J;
  int32_t* rs = ring + 3 * J;
  int32_t* rf = ring + 4 * J;
  int32_t* rv = ring + 5 * J;
  int32_t* rp = ring + 6 * J;
  __syncwarp();

  const size_t QJ = (size_t)Q * J;
  const size_t rb = (size_t)row * J;
  for (int a = lane; a < J; a += 32)
    for (int c = 0; c < 7; ++c) ring[c * J + a] = carry_in[c * QJ + rb + a];
  __syncwarp();
  int head = 0;  // slot of age 1
  int flag = cflag_in[row];
  const int n = nb[row];
  const size_t ab = (size_t)row * A;
  int pxh = 0, pxl = 0, pq = 0, ps = 0;

  for (int li = 0; li < A; ++li) {
    const int src = li & 31;
    if (src == 0 && li + lane < A) {
      pxh = axh[ab + li + lane];
      pxl = axl[ab + li + lane];
      pq = aq[ab + li + lane];
      ps = asp[ab + li + lane];
    }
    const int xh = __shfl_sync(LQ_FULL, pxh, src);
    const int xl = __shfl_sync(LQ_FULL, pxl, src);
    const int qi = __shfl_sync(LQ_FULL, pq, src);
    const int si = __shfl_sync(LQ_FULL, ps, src);
    const int i = i0 + li;
    const bool row_on = i < n;

    int scv[NW], tg[NW];
    uint32_t vb[NW], nm[NW];
    int run = LQ_NEG;  // max of sc over the younger chunks
    bool oldest_ok = false;
#pragma unroll
    for (int t = 0; t < NW; ++t) {
      const int a = 32 * t + lane + 1;
      const int s = (head + a - 1) & (J - 1);
      const bool exists = i - a >= 0;
      const long long dr = (long long)xl - rxl[s];
      const bool dr_ok = xh == rxh[s] && dr >= 0 && dr <= max_dist;
      const long long dq = (long long)qi - rq[s];
      bool valid = exists && dr_ok && dr != 0 && dq > 0 && dq <= max_dist;
      int sc = LQ_NEG;
      if (valid) {
        const long long dd = dr > dq ? dr - dq : dq - dr;
        valid = dd <= bw;
        if (valid) {
          int m = (int)(dq < dr ? dq : dr);
          m = m < si ? m : si;
          sc = m - pen[(int)dd] + rf[s];
        }
      }
      // strict running max in age order, exclusive prefix
      const int incl = scan_max(sc, lane);
      int before = __shfl_up_sync(LQ_FULL, incl, 1);
      if (lane == 0) before = LQ_NEG;
      before = before > run ? before : run;
      before = before > si ? before : si;
      const bool newmax = valid && sc > before;
      const int tot = __shfl_sync(LQ_FULL, incl, 31);
      run = tot > run ? tot : run;
      scv[t] = sc;
      vb[t] = __ballot_sync(LQ_FULL, valid);
      nm[t] = __ballot_sync(LQ_FULL, newmax);
      const int pa = rp[s];
      const int tgt = i - pa;
      tg[t] = (valid && pa > LQ_NEG + J + 1 && tgt >= 1 && tgt <= J) ? tgt : 0;
      if (t == NW - 1)
        oldest_ok = (__ballot_sync(LQ_FULL, exists && dr_ok) >> 31) & 1u;
    }

    // max_skip bounding: two passes (marks from all admissible
    // entries, then from entries before the first cut; the second pass
    // repeats the first when the first did not cut)
    uint32_t mk[NW];
    marks_from<J>(tg, J + 1, lane, mk);
    const int cut0 = walk_cut<J>(vb, nm, mk, max_skip, lane);
    int cut1 = cut0;
    if (cut0 <= J) {
      marks_from<J>(tg, cut0, lane, mk);
      cut1 = walk_cut<J>(vb, nm, mk, max_skip, lane);
    }

    // parent: the oldest new maximum (so the highest score) at age <= cut1
    int p_age = 0;
#pragma unroll
    for (int t = NW - 1; t >= 0; --t) {
      const int keep = cut1 - 32 * t;  // ages 32t+1 .. 32t+keep allowed
      uint32_t m = nm[t];
      if (keep <= 0) m = 0u;
      else if (keep < 32) m &= (1u << keep) - 1u;
      if (p_age == 0 && m) p_age = 32 * t + 32 - __clz(m);
    }
    const bool has_pred = p_age > 0;
    int mine = LQ_NEG;
#pragma unroll
    for (int t = 0; t < NW; ++t)
      if (has_pred && t == ((p_age - 1) >> 5)) mine = scv[t];
    const int sc_p = __shfl_sync(LQ_FULL, mine, (p_age - 1) & 31);
    const int f_i = has_pred ? sc_p : si;
    const int p_abs = has_pred ? i - p_age : LQ_NEG;
    const int v_pred = has_pred ? rv[(head + p_age - 1) & (J - 1)] : LQ_NEG;
    const int v_i = (has_pred && v_pred > f_i) ? v_pred : f_i;
    const bool trunc = cut1 > J && oldest_ok;
    if (row_on && (cut0 != cut1 || trunc)) flag = 1;

    // push: the new entry takes the oldest entry's slot
    __syncwarp();
    head = (head + J - 1) & (J - 1);
    if (lane == 0) {
      rxh[head] = xh;
      rxl[head] = xl;
      rq[head] = qi;
      rs[head] = si;
      rf[head] = f_i;
      rv[head] = v_i;
      rp[head] = p_abs;
      of[ab + li] = row_on ? f_i : 0;
      op[ab + li] = row_on ? (p_abs > -1 ? p_abs : -1) : -1;
      ov[ab + li] = row_on ? v_i : 0;
    }
    __syncwarp();
  }
  for (int a = lane; a < J; a += 32) {
    const int s = (head + a) & (J - 1);
    for (int c = 0; c < 7; ++c) carry_out[c * QJ + rb + a] = ring[c * J + s];
  }
  if (lane == 0) cflag_out[row] = flag;
}

// shared memory of one block: the row's penalty table (padded to 4
// words) plus its 7 x J ring
static size_t lq_chain_smem(int J, int bw) {
  return ((size_t)((bw + 4) & ~3) + (size_t)7 * J) * sizeof(int32_t);
}

template <int J>
static int lq_chain_launch(const void* axh, const void* axl, const void* aq,
                           const void* asp, const void* nb, const void* pen,
                           const void* carry_in, const void* cflag_in,
                           void* of, void* op, void* ov, void* carry_out,
                           void* cflag_out, int Q, int A, int bw,
                           int pen_stride, int max_dist, int max_skip,
                           int i0, cudaStream_t st) {
  const size_t smem = lq_chain_smem(J, bw);
  cudaError_t e = cudaFuncSetAttribute(
      lq_chain_fill_kernel<J>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  lq_chain_fill_kernel<J><<<Q, 32, smem, st>>>(
      (const int32_t*)axh, (const int32_t*)axl, (const int32_t*)aq,
      (const int32_t*)asp, (const int32_t*)nb, (const int32_t*)pen,
      (const int32_t*)carry_in, (const int32_t*)cflag_in, (int32_t*)of,
      (int32_t*)op, (int32_t*)ov, (int32_t*)carry_out, (int32_t*)cflag_out,
      Q, A, bw, pen_stride, max_dist, max_skip, i0);
  return (int)cudaGetLastError();
}

extern "C" int lq_chain_fill(const void* axh, const void* axl, const void* aq,
                             const void* asp, const void* nb, const void* pen,
                             const void* carry_in, const void* cflag_in,
                             void* of, void* op, void* ov, void* carry_out,
                             void* cflag_out, int Q, int A, int J, int bw,
                             int pen_stride, int max_dist, int max_skip,
                             int i0, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (Q <= 0) return 0;
  switch (J) {
    case 64:
      return lq_chain_launch<64>(axh, axl, aq, asp, nb, pen, carry_in,
                                 cflag_in, of, op, ov, carry_out, cflag_out, Q,
                                 A, bw, pen_stride, max_dist, max_skip, i0,
                                 st);
    case 128:
      return lq_chain_launch<128>(axh, axl, aq, asp, nb, pen, carry_in,
                                  cflag_in, of, op, ov, carry_out, cflag_out,
                                  Q, A, bw, pen_stride, max_dist, max_skip,
                                  i0, st);
    case 256:
      return lq_chain_launch<256>(axh, axl, aq, asp, nb, pen, carry_in,
                                  cflag_in, of, op, ov, carry_out, cflag_out,
                                  Q, A, bw, pen_stride, max_dist, max_skip,
                                  i0, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
