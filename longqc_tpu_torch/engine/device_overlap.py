"""Device-resident overlap-coverage engine (one device).

Torch port of longqc_tpu/engine/device_overlap.py. Per index part:

  part reads --pack--> B1 sketch kernel --> flat (hash, rid, pos)
    --> sorted index + occurrence threshold          (engine/device_index)
  per query group (Q = 128 lanes):
    count pass: searchsorted seed lookup + expanded-anchor count n_q,
    which picks the smallest anchor rung A that fits every row ->
    step: weighted anchor expansion -> per-row stable sort -> B2 chain
    fill -> B3 peak pass -> chain candidates -> B4 min-rank pass (chain
    extraction per ops/chainsel's closed form) -> reg geometry,
    lambda/lambda2/m_cnts accounting and interval compression
    (lq_cnt_match + filter_redundant_coords semantics), all on the
    device; the host pulls per-row flags and the compressed interval
    events.

HPC configurations (-H: the spike-in-control filter run) sketch the
homopolymer-compressed queries with the tensor sketch (ops/sketch_hpc;
per-slot spans ride beside the hashes), index the small control
targets with the host spec's index, and split the step in two: the
anchors and their span sums first, then, with one f64-exact gap-penalty
table per row fitted on the host from the row's mean anchor span
(avg_qspan is data-dependent under HPC, sketch.c:90-104), the chain
fill and the accounting with per-anchor spans.

Exactness contract: rows are bit-identical to engine/overlap_host.
Whatever the device math cannot reproduce exactly raises a per-(row,
part) flag: m_cnts approaching uint16 saturation (F_SAT), more accepted
chains than CV (F_CV), anchors past the top rung (F_ANCH, retried at a
bigger rung first), expansion overflow (F_EXP). A flagged row's state
update is discarded and recomputed by the host spec for that part. The
chain fill scans each anchor's whole admissible window (B2), so the
JAX package's F_KERNEL (ring truncation, retried at J = 128 / 256)
never fires here; the overhang-ratio test is the literal f64
comparison, so neither does its F_GEOM.

Shapes follow the JAX engine (GROUP_Q, the _len_bucket query buckets,
the anchor rungs, CV/EOUT/EV_B) so the parity tests compare
intermediates shape for shape. PyTorch runs eagerly, so the TPU-only
machinery (ahead-of-time compiles, asynchronous pulls, the warm-up
thread) has no counterpart.

The part loop is pipelined as in the JAX engine: part N+1 is read and
packed on a side thread while part N's groups step
(DeviceOverlapEngine.run).

Behavioral citations as in overlap_host.py: index.c:69-144,
lqmap.c:140-205, chain.c:22-157, esterr.c:72-140, lqmap.c:25-100,
minimap2-coverage.c:545-617.
"""

import concurrent.futures as cf
import copy
import threading
from bisect import bisect_left
from collections import defaultdict
from dataclasses import dataclass
from logging import getLogger

import numpy as np
import torch

from longqc_tpu_torch import tracing
from longqc_tpu_torch.config import OverlapConfig
from longqc_tpu_torch.engine import device_index as di
from longqc_tpu_torch.engine import overlap_host as oh
from longqc_tpu_torch.ops.chain import gap_penalty_table
from longqc_tpu_torch.ops._ext import require_device
from longqc_tpu_torch.ops.chain_cuda import chain_dp_fill, count_pieces
from longqc_tpu_torch.ops.ringprop import INF32, minrank_pass, peak_pass
from longqc_tpu_torch.ops.sketch import sketch_batch
from longqc_tpu_torch.ops.sketch_cuda import sketch_tiles
from longqc_tpu_torch.ops.sketch_hpc import (hpc_compress, hpc_compress_all,
                                             pack_hpc, sketch_reads_hpc)
from longqc_tpu_torch.tracing import span

logger = getLogger(__name__)

GROUP_Q = 128          # query lanes per step call
CV = 512               # max accepted chains per (row, part) call
EOUT = 4 * CV          # max emitted interval events per call
EV_B = 8192            # cross-row compacted event budget per pull
A_BUCKETS = (2048, 8192, 32768, 131072)
# anchor-capacity rungs, picked per (part, group) from the count pass.
# The JAX package capped its ladder at 65536 for TPU compile time; here
# the bound is memory: a step at rung A holds ~40 (Q, A) int32/int64
# temporaries, ~5.4 GB at the 262144 top rung
A_LADDER = (1024, 2048, 4096, 8192, 16384, 32768, 65536, 131072, 262144)


def _wide_ladder(top, lanes):
    """The rungs past `top`: doubling while one lane of the rung fits
    the footprint of `lanes` lanes at `top`."""
    out = []
    A = 2 * top
    while A <= top * lanes:
        out.append(A)
        A *= 2
    return tuple(out)


# rows past the top rung step at wider rungs on fewer lanes, in the
# footprint of one step over the group's lanes at the top rung (the
# wide rungs): 64 lanes at 524288, 32 at 1048576, one at GROUP_Q x
# 262144. ROW_ANCHORS_MAX is the largest row that steps on the card (the
# engine's row_anchors_max at its defaults); a row past it is computed
# by the host spec
ROW_ANCHORS_MAX = _wide_ladder(A_LADDER[-1], GROUP_Q)[-1]
# per-part read-count paddings (rid-indexed arrays); rid packs into 24
# bits
B_PADS = (8192, 1 << 17, 1 << 21, 1 << 24)

# flag bits (per row, per call); 1 is the JAX package's F_KERNEL
# (chain-ring truncation), which cannot fire here
F_SAT = 2              # m_cnts approaching uint16 saturation
F_CV = 4               # more accepted chains than CV
# (8 is the JAX package's F_GEOM, which cannot fire here)
F_ANCH = 16            # anchors exceed the step's anchor rung
F_EXP = 32             # expanded minimizers exceed M2

_I32 = torch.int32
_I64 = torch.int64


@dataclass(frozen=True)
class StepStatic:
    """Static configuration of one step call."""
    M: int
    M2: int
    A: int
    k: int
    max_gap: int
    bw: int
    max_skip: int
    min_cnt: int
    min_sc: int
    min_sc_m: int
    min_sc_g: int
    max_overhang: int
    min_cov: int
    covt: int
    ava: bool
    min_ratio: float


def _ar(n, like):
    return torch.arange(n, dtype=_I32, device=like.device)


def _seg_fill_last(mask, val, fill):
    """Per row: at each position, the latest `val` at or before it where
    mask is set (fill until the first set position)."""
    Q, L = mask.shape
    pos = torch.arange(L, dtype=_I64, device=mask.device).expand(Q, L)
    lb = torch.cummax(torch.where(mask, pos, -1), dim=1).values
    out = torch.gather(val, 1, lb.clamp(min=0))
    return torch.where(lb >= 0, out, fill)


def _compact_rows(keys, payloads, width, fill_key):
    """Per-row stable compaction: entries with key != fill_key move to
    the front (in original order); returns (Q, width) arrays and the
    per-row valid counts. Slots past the count hold fill_key / 0."""
    Q, L = keys.shape
    valid = keys != fill_key
    tgt = torch.cumsum(valid.to(_I64), dim=1) - 1
    tgt_c = torch.where(valid & (tgt < width), tgt, width)
    n = valid.sum(dim=1).to(_I32)

    def scat(a, fill):
        out = torch.full((Q, width + 1), fill, dtype=a.dtype,
                         device=a.device)
        return out.scatter_(1, tgt_c, a)[:, :width]

    return scat(keys, fill_key), [scat(p, 0) for p in payloads], n


def _scatter_reduce(Q, width, fill, idx, val, reduce):
    """out[r, idx[r, j]] = reduce(...) over (Q, width) with the JAX
    `mode="drop"` semantics for idx == width."""
    out = torch.full((Q, width + 1), fill, dtype=val.dtype,
                     device=val.device)
    out.scatter_reduce_(1, idx.to(_I64), val, reduce=reduce,
                        include_self=True)
    return out[:, :width]


# ---------------------------------------------------------------------------
# query group preparation


def _pack_group_slots(qpos, qstrand, qcnt, n_slots):
    """Per-slot packed minimizer (pos << 1 | strand) and the group's
    total expanded-entry counts (the mini_pos length the reference
    divides m_cnts by, minimap2-coverage.c:545-563)."""
    Q, M = qpos.shape
    slot_ok = _ar(M, qpos)[None, :] < n_slots[:, None]
    qps = (qpos << 1) | qstrand
    n_exp = torch.where(slot_ok, qcnt, 0).sum(dim=1).to(_I32)
    return qps, n_exp


def _count_expanded(ih, qh, qcnt, n_slots, mid_occ, *, mcrop=None):
    """Per-row expanded-anchor count n_q (sum over kept slots of
    duplicate multiplicity x index occurrence count) plus the seed
    lookup tables (left, occ) per slot, which the step consumes.

    Arithmetic follows the JAX count (int32 with the same saturation):
    per-slot contributions saturate at 65535 and 1024-slot block sums
    clamp at 2^23, so the count is monotone and only ever saturates.
    mcrop: search only the first mcrop slots (every valid row's slots
    fit; left/occ pad back to (Q, M) with zeros)."""
    Q, M = qh.shape
    mc = M if mcrop is None else min(mcrop, M)
    qh_c = qh[:, :mc]
    qcnt_c = qcnt[:, :mc]
    slot_on = _ar(mc, qh)[None, :] < n_slots[:, None]
    qs = torch.where(slot_on, qh_c, 0)
    # right(q) == left(q + 1) for integer keys (hashes < 2^2k, below the
    # sentinel of their lanes; ih and qh share one dtype). An index is at
    # most di.INDEX_MAX = 2^31 - 1 wide, so every position fits int32
    lr = torch.searchsorted(ih, torch.cat([qs, qs + 1], dim=1),
                            out_int32=True)
    left = lr[:, :mc]
    occ = lr[:, mc:] - left
    n_q = _count_tail(occ, qcnt_c, slot_on, mid_occ)
    if mc < M:
        pad = torch.zeros((Q, M - mc), dtype=_I32, device=qh.device)
        left = torch.cat([left, pad], dim=1)
        occ = torch.cat([occ, pad], dim=1)
    return n_q, left, occ


def _count_tail(occ, qcnt, slot_on, mid_occ):
    Q, M = occ.shape
    CAP, HALF = 65535, 1 << 15
    kept = slot_on & (occ < mid_occ)
    sat = (occ > HALF) | (qcnt > HALF)
    prod = occ.clamp(max=HALF) * qcnt.clamp(max=HALF)      # <= 2^30
    contrib = torch.where(kept, torch.where(sat, CAP, prod.clamp(max=CAP)),
                          0)
    BLK = 1024 if M % 1024 == 0 else M
    part = contrib.reshape(Q, M // BLK, BLK).sum(dim=2).clamp(max=1 << 23)
    return part.sum(dim=1).to(_I32)


# ---------------------------------------------------------------------------
# the per-(part, group) step


def _geom_ok(a, total, min_ratio):
    """numpy's `a >= total * min_ratio` under f64 semantics: both sides
    promote to f64 (exact below 2^53) and the product rounds to
    nearest-even. The literal f64 test has no add, so no fused
    multiply-add can change it."""
    return a.to(torch.float64) >= total.to(torch.float64) * min_ratio


def _collect_anchors(irid, ips, rid_rank, mid_occ, left_slot, occ_slot,
                     qps, qcnt, n_slots, qlen, qrank, qbisect,
                     st: StepStatic, qspan=None):
    """Seed lookup, kept-minimizer accounting and sorted anchor
    expansion (lqmap.c:140-205). Slot j owns qcnt*occ anchors; the
    t-th reads index occurrence t mod occ (duplicate emissions' anchors
    are identical). qspan: per-slot query minimizer spans (HPC; None =
    plain mode, span == k). Returns (key1, key2, yq, js_s, span_s,
    n_anch, n_q, n_kept, kept_ssum, anch_ssum); span_s (per-anchor
    spans in sorted order) and the span sums are None in plain mode."""
    Q = left_slot.shape[0]
    M, A = st.M, st.A
    slot_on = _ar(M, qps)[None, :] < n_slots[:, None]
    kept = slot_on & (occ_slot < mid_occ)
    kc = torch.where(kept, qcnt, 0).to(_I64)
    kcum = torch.cumsum(kc, dim=1)
    js_slot = kcum - kc            # kept rank of the slot's 1st entry
    n_kept = kcum[:, -1].to(_I32)
    kept_ssum = None
    if qspan is not None:
        kept_ssum = torch.where(kept, qcnt * qspan, 0).sum(dim=1).to(_I32)

    w = torch.where(kept, qcnt * occ_slot, 0)
    ce = torch.cumsum(w.to(_I64), dim=1).clamp(max=1 << 30)
    n_q = ce[:, -1].to(_I32)
    a_ids = torch.arange(A, dtype=_I64, device=qps.device).expand(Q, A)
    ce_pad = torch.cat([torch.zeros((Q, 1), dtype=_I64,
                                    device=qps.device), ce], dim=1)
    starts_s = ce_pad[:, :M]           # run start offset of slot j
    s_ids = torch.arange(M, dtype=_I64, device=qps.device).expand(Q, M)
    seed_at = torch.where(kept & (w > 0), starts_s.clamp(max=A), A)
    seed = _scatter_reduce(Q, A, -1, seed_at, s_ids, "amax")
    e_of_a = torch.cummax(seed, dim=1).values
    t_in_s = a_ids - torch.gather(ce_pad, 1, e_of_a.clamp(min=0))
    valid_a = a_ids < n_q[:, None]
    e_clip = e_of_a.clamp(0, M - 1)

    occ_a = torch.gather(occ_slot, 1, e_clip)
    left_a = torch.gather(left_slot, 1, e_clip)
    qps_a = torch.gather(qps, 1, e_clip)
    js_a0 = torch.gather(js_slot, 1, e_clip)
    idx_run = t_in_s % occ_a.clamp(min=1)
    N = irid.shape[0]
    # int64 (idx_run is): left + occ <= N <= 2^31 - 1 never wraps
    slot = (left_a + idx_run).clamp(0, N - 1)
    rid_a = irid[slot]
    ps_a = ips[slot]
    rpos = ps_a >> 1
    rstrand = ps_a & 1
    qpos_a = qps_a >> 1
    qstr_a = qps_a & 1
    fwd = rstrand == qstr_a
    rev = torch.where(fwd, 0, 1)

    # NO_SELF / AVA suppression (lqmap.c:162-183)
    rrank = rid_rank[rid_a.clamp(0, rid_rank.shape[0] - 1).to(_I64)]
    drop = (rrank == qrank[:, None]) & (rpos == qpos_a)
    if st.ava:
        drop = drop | (rrank < qbisect[:, None])
    live = valid_a & ~drop
    key1 = torch.where(live, (rev << 24) | rid_a, INF32)
    key2 = torch.where(live, rpos, INF32)
    js_a = torch.where(live, js_a0, 0)
    if qspan is None:
        span_a = st.k
    else:
        span_a = torch.gather(qspan, 1, e_clip)
    yq = torch.where(fwd, qpos_a, qlen[:, None] - (qpos_a + 1 - span_a) - 1)
    yq = torch.where(live, yq, 0)
    n_anch = live.sum(dim=1).to(_I32)

    # stable two-key (key1, key2) row sort: both keys are non-negative
    # int32, so one int64 key orders them lexicographically
    ck = (key1.to(_I64) << 32) | key2.to(_I64)
    order = torch.sort(ck, dim=1, stable=True).indices
    key1 = torch.gather(key1, 1, order).to(_I32)
    key2 = torch.gather(key2, 1, order).to(_I32)
    yq = torch.gather(yq, 1, order).to(_I32)
    js_s = torch.gather(js_a, 1, order).to(_I32)
    span_s = anch_ssum = None
    if qspan is not None:
        span_a = torch.where(live, span_a, 0)
        anch_ssum = span_a.sum(dim=1).to(_I32)
        span_s = torch.gather(span_a, 1, order).to(_I32)
    return (key1, key2, yq, js_s, span_s, n_anch, n_q, n_kept, kept_ssum,
            anch_ssum)


def _run_dp(key1, key2, yq, span_s, n_anch, pen_tab, st: StepStatic):
    """B2 chain fill + B3 peak pass over the sorted anchors. span_s:
    per-anchor spans (None = plain mode, span == k); pen_tab: (1, bw+1)
    or one gap-penalty table per row (Q, bw+1). A parent may lie any
    distance back, so the peak pass runs with no window limit (J = A)."""
    Q, A = key1.shape
    span = span_s
    if span is None:
        span = torch.full((Q, A), st.k, dtype=_I32, device=key1.device)
    f, p, v = chain_dp_fill(key1, key2, yq, span, n_anch, pen_tab,
                            max_dist=st.max_gap, bw=st.bw,
                            max_skip=st.max_skip)
    peak = peak_pass(f, v, p, J=A)
    return f, p, v, peak


def _post_dp(key1, key2, yq, js_s, span_s, f, p, v, peak, n_anch,
             n_q, n_kept, seq_lens, qlen, qvalid, n_exp, lam, lam2,
             avgk_set, m_cnts, st: StepStatic):
    """Chain selection, reg geometry, coverage accounting and interval
    compression (chain extraction per ops/chainsel; esterr.c:72-140;
    lqmap.c:25-100). span_s: per-anchor spans in sorted order (None =
    plain mode, span == k)."""
    Q, A = key1.shape
    M2 = st.M2
    dev = key1.device
    a_ids = torch.arange(A, dtype=_I32, device=dev).expand(Q, A)

    # --- chain candidates: ends -> unique peaks -> ranks (chainsel)
    anch_on = a_ids < n_anch[:, None]
    child_on = (p >= 0) & anch_on
    is_parent = _scatter_reduce(Q, A, 0, torch.where(child_on, p, A),
                                child_on.to(_I32), "amax") > 0
    endm = anch_on & ~is_parent & (v >= st.min_sc)
    MAXI = 0x3FFFFFFF
    ek1 = torch.where(endm, MAXI - v, INF32)
    ek2 = torch.where(endm, MAXI - peak, INF32)
    ek = torch.sort((ek1.to(_I64) << 32) | ek2.to(_I64), dim=1).values
    ek1, ek2 = ek >> 32, ek & 0xFFFFFFFF
    it_valid = ek1 != INF32
    prev1 = torch.cat([torch.full((Q, 1), -1, dtype=_I64, device=dev),
                       ek1[:, :-1]], dim=1)
    prev2 = torch.cat([torch.full((Q, 1), -1, dtype=_I64, device=dev),
                       ek2[:, :-1]], dim=1)
    is_new = it_valid & ((ek1 != prev1) | (ek2 != prev2))
    rank_it = torch.cumsum(is_new.to(_I32), dim=1).to(_I32) - 1
    peak_it = torch.where(is_new, MAXI - ek2, A).clamp(0, A)
    own = _scatter_reduce(Q, A, INF32, peak_it,
                          torch.where(is_new, rank_it, INF32), "amin")

    mr = minrank_pass(p, own, J=A)
    mr = torch.where(anch_on, mr, INF32)

    # --- segment chains in (min-rank, idx) order; the stable sort keeps
    # idx ascending within a rank, so run start = root-most anchor and
    # run end = peak
    smr, sidx = torch.sort(mr, dim=1, stable=True)
    sidx = sidx.to(_I32)
    s_valid = smr != INF32
    prev_mr = torch.cat([torch.full((Q, 1), -1, dtype=_I32, device=dev),
                         smr[:, :-1]], dim=1)
    is_b = s_valid & (smr != prev_mr)
    next_mr = torch.cat([smr[:, 1:], torch.full((Q, 1), -1, dtype=_I32,
                                                device=dev)], dim=1)
    is_last = s_valid & (smr != next_mr)
    spos = a_ids
    first_pos = _seg_fill_last(is_b, spos, 0)
    first_idx = _seg_fill_last(is_b, sidx, 0)
    cnt = spos - first_pos + 1

    def gat(arr, idx):
        return torch.gather(arr, 1, idx.clamp(0, A - 1).to(_I64))

    pk_idx = sidx
    score = gat(f, pk_idx)
    stop = gat(p, first_idx)
    f_stop = gat(f, stop)
    score0 = torch.where(stop >= 0, score - f_stop, score)
    accept = is_last & (cnt >= st.min_cnt) & \
        ((stop < 0) | (score0 >= st.min_sc))

    # --- reg coordinates (hit.c:23-38 mm_reg_set_coor)
    k1_f = gat(key1, first_idx)
    c_rev = (k1_f >> 24) & 1
    c_rid = k1_f & ((1 << 24) - 1)
    rs_last = gat(key2, first_idx)
    yq0 = gat(yq, first_idx)
    re = gat(key2, pk_idx) + 1
    yql = gat(yq, pk_idx)
    # span of the chain's root-most anchor (q_span in chain_to_reg)
    span_f = st.k if span_s is None else gat(span_s, first_idx)
    rs = (rs_last + 1 - span_f).clamp(min=0)
    qlen_b = qlen[:, None]
    qs = torch.where(c_rev == 0, yq0 + 1 - span_f, qlen_b - (yql + 1))
    qe = torch.where(c_rev == 0, yql + 1, qlen_b - (yq0 + 1 - span_f))

    # --- lq_cnt_match (esterr.c:72-140)
    capped = (avgk_set != 0) & \
        (torch.div(lam, qlen.to(_I64).clamp(min=1),
                   rounding_mode="floor") > st.covt)
    proc = (qvalid != 0) & (n_kept > 0) & ~capped

    # searchsorted(mp_pos, x0) of the chain's first forward anchor is
    # its precomputed kept rank (js_s)
    first_fwd = torch.where(c_rev == 0, first_idx, pk_idx)
    st_c = gat(js_s, first_fwd).clamp(0, M2 - 1)

    rl = seq_lens[c_rid.clamp(0, seq_lens.shape[0] - 1).to(_I64)]
    hang5 = torch.minimum(qs, rs)
    hang3 = torch.minimum(qlen_b - qe, rl - re)
    span_q = qe - qs
    total = span_q + hang5 + hang3
    geom = _geom_ok(span_q, total, st.min_ratio) & \
        (hang5 <= st.max_overhang) & (hang3 <= st.max_overhang)
    ok = accept & geom & proc[:, None]

    dlen = (qe - qs + 1).to(_I64)
    lam_new = lam + torch.where(ok, dlen, 0).sum(dim=1)
    med = score0 >= st.min_sc_m
    good = ok & (score0 >= st.min_sc_g)
    lam2_new = lam2 + torch.where(good, dlen, 0).sum(dim=1)
    avgk_new = torch.where(proc & (n_kept > 0), 1, avgk_set).to(_I32)

    # m_cnts: st hit per good chain, then one hit per chained anchor
    # excluding the forward-first anchor (esterr.c:120-138)
    mc = torch.cat([m_cnts, torch.zeros((Q, 1), dtype=_I32, device=dev)],
                   dim=1)
    mc = mc.scatter_add(1, torch.where(good, st_c, M2).to(_I64),
                        good.to(_I32))
    rank_at_last = torch.where(is_last, smr, A).clamp(0, A)
    tbl_good = _scatter_reduce(Q, A, 0, rank_at_last, good.to(_I32),
                               "amax")
    tbl_ff = _scatter_reduce(Q, A, -1, rank_at_last,
                             torch.where(is_last, first_fwd, -1), "amax")
    mr_c = mr.clamp(0, A - 1).to(_I64)
    a_good = (mr != INF32) & (torch.gather(tbl_good, 1, mr_c) == 1)
    a_first = torch.gather(tbl_ff, 1, mr_c) == a_ids
    js_c = js_s.clamp(0, M2 - 1)
    walk = a_good & ~a_first & anch_on
    mc = mc.scatter_add(1, torch.where(walk, js_c, M2).to(_I64),
                        walk.to(_I32))[:, :M2]
    flag_sat = mc.amax(dim=1) >= 65535

    # --- interval compression (filter_redundant_coords, lqmap.c:25-100)
    ev_s = ((qs << 3) | torch.where(med, 2, 0)).to(_I32)
    ev_e = ((qe << 3) | torch.where(med, 3, 1)).to(_I32)
    cv_key = torch.where(ok, spos, INF32)
    _, (cv_s, cv_e), n_cv = _compact_rows(cv_key, (ev_s, ev_e), CV, INF32)
    cv_on = _ar(CV, cv_s)[None, :] < n_cv.clamp(max=CV)[:, None]
    flag_cv = n_cv > CV
    cv_s = torch.where(cv_on, cv_s, INF32)
    cv_e = torch.where(cv_on, cv_e, INF32)

    vc = torch.sort(torch.cat([cv_s, cv_e], dim=1), dim=1).values
    vc_on = vc != INF32
    delta = torch.where(vc_on & ((vc & 2) != 0),
                        torch.where((vc & 1) != 0, -1, 1), 0)
    medc = torch.cumsum(delta, dim=1)
    prevc = medc - delta
    up = vc_on & (prevc < st.min_cov) & (medc >= st.min_cov)
    down = vc_on & (prevc >= st.min_cov) & (medc < st.min_cov)
    med_start = _seg_fill_last(up, vc, 0)
    mlen_nz = ((vc >> 3) - med_start) != 0
    is_mc = down & mlen_nz
    ms_c, (me_c,), n_mc = _compact_rows(
        torch.where(is_mc, med_start, INF32), (vc,), CV, INF32)
    mc_on = _ar(CV, ms_c)[None, :] < n_mc.clamp(max=CV)[:, None]
    ms_c = torch.where(mc_on, ms_c, INF32)
    me_c = torch.where(mc_on, me_c, 0)
    # ri = #{ms_c <= cv_s} - 1; ms_c is non-decreasing (medium-run
    # starts in sorted event order, INF32 padding last), so the count
    # is a right-side searchsorted
    ri = torch.searchsorted(ms_c.contiguous(), cv_s.contiguous(),
                            right=True, out_int32=True) - 1
    ri_c = ri.clamp(0, CV - 1).to(_I64)
    contained = (ri >= 0) & (cv_e <= torch.gather(me_c, 1, ri_c)) & \
        (cv_s >= torch.gather(ms_c, 1, ri_c))
    keep_iv = cv_on & ~contained

    cand = torch.cat([
        torch.where(keep_iv, cv_s, INF32),
        torch.where(keep_iv, cv_e, INF32),
        torch.where(mc_on, ms_c | 4, INF32),
        torch.where(mc_on, me_c | 4, INF32)], dim=1)
    events, _, ev_n = _compact_rows(cand, (), EOUT, INF32)

    # --- commit (flagged rows keep their old state)
    new_flags = (torch.where(flag_sat, F_SAT, 0)
                 | torch.where(flag_cv, F_CV, 0)
                 | torch.where(n_q > A, F_ANCH, 0)
                 | torch.where(n_exp > M2, F_EXP, 0)).to(_I32)
    new_flags = torch.where(qvalid != 0, new_flags, 0)
    bad = new_flags != 0
    lam_new = torch.where(bad, lam, lam_new)
    lam2_new = torch.where(bad, lam2, lam2_new)
    avgk_new = torch.where(bad, avgk_set, avgk_new)
    mc = torch.where(bad[:, None], m_cnts, mc)
    ev_n = torch.where(bad | ~proc, 0, ev_n.clamp(max=EOUT)).to(_I32)
    # one packed pull per call: [flags | ev_n | events grouped by row]
    ev_on = _ar(EOUT, events)[None, :] < ev_n[:, None]
    rk = torch.where(ev_on, torch.arange(Q, dtype=_I32, device=dev)[:, None],
                     INF32).reshape(-1)
    vv = torch.where(ev_on, events, 0).reshape(-1)
    vv_s = vv[torch.sort(rk, stable=True).indices]
    packed_small = torch.cat([new_flags, ev_n, vv_s[:EV_B]])
    return (lam_new, lam2_new, avgk_new, mc, packed_small, events, proc,
            new_flags)


def _step_impl(irid, ips, seq_lens, rid_rank, mid_occ, left_slot,
               occ_slot, qps, qcnt, n_slots, n_exp, qlen, qrank, qbisect,
               qvalid, lam, lam2, avgk_set, m_cnts, pen_tab,
               st: StepStatic):
    """One (part x query-group) update (plain sketch, constant span).
    Returns the committed state (lam, lam2, avgk_set, m_cnts), the
    packed [flags | ev_n | compact events] pull target and the
    uncompacted (Q, EOUT) events."""
    key1, key2, yq, js_s, _sp, n_anch, n_q, n_kept, _ks, _as = \
        _collect_anchors(irid, ips, rid_rank, mid_occ, left_slot,
                         occ_slot, qps, qcnt, n_slots, qlen, qrank, qbisect,
                         st)
    f, p, v, peak = _run_dp(key1, key2, yq, None, n_anch, pen_tab, st)
    out = _post_dp(key1, key2, yq, js_s, None, f, p, v, peak, n_anch, n_q,
                   n_kept, seq_lens, qlen, qvalid, n_exp, lam, lam2,
                   avgk_set, m_cnts, st)
    return out[:6]


def _step_hpc_a(irid, ips, rid_rank, mid_occ, left_slot, occ_slot, qps,
                qcnt, n_slots, qspan, qlen, qrank, qbisect, st: StepStatic):
    """HPC step, phase A: anchors with their spans, plus the (Q, 5)
    per-row statistics [n_anch, anchor span sum, n_kept, kept span sum,
    n_q] the host fits each row's gap-penalty table and kept mean span
    from."""
    out = _collect_anchors(irid, ips, rid_rank, mid_occ, left_slot,
                           occ_slot, qps, qcnt, n_slots, qlen, qrank,
                           qbisect, st, qspan=qspan)
    (key1, key2, yq, js_s, span_s, n_anch, n_q, n_kept, kept_ssum,
     anch_ssum) = out
    stats = torch.stack([n_anch, anch_ssum, n_kept, kept_ssum, n_q], dim=1)
    return out[:8], stats


def _step_hpc_b(anchors, seq_lens, qlen, qvalid, n_exp, lam, lam2,
                avgk_set, avgk_val, m_cnts, pen_tab, kept_avg,
                st: StepStatic):
    """HPC step, phase B: chain fill with the per-row tables (pen_tab
    (Q, bw+1)) and per-anchor spans, then the accounting. avgk_val (f32
    state) takes the row's kept-minimizer mean span (kept_avg, computed
    on the host as the host spec's state.avg_k) the first time the row
    is processed. Returns (lam, lam2, avgk_set, avgk_val, m_cnts,
    packed pull, events)."""
    key1, key2, yq, js_s, span_s, n_anch, n_q, n_kept = anchors
    f, p, v, peak = _run_dp(key1, key2, yq, span_s, n_anch, pen_tab, st)
    (lam_n, lam2_n, avgk_n, mc, packed_small, events, proc,
     new_flags) = _post_dp(key1, key2, yq, js_s, span_s, f, p, v, peak,
                           n_anch, n_q, n_kept, seq_lens, qlen, qvalid,
                           n_exp, lam, lam2, avgk_set, m_cnts, st)
    set_now = proc & (n_kept > 0) & (avgk_set == 0) & (new_flags == 0)
    avgk_val_n = torch.where(set_now, kept_avg, avgk_val)
    return lam_n, lam2_n, avgk_n, avgk_val_n, mc, packed_small, events


def _finalize_group(lam, lam2, m_cnts, n_exp):
    """Per-row div-statistics inputs (minimap2-coverage.c:545-563):
    uint32-wrapped m_cnts sum, integer-divided by the full minimizer
    count, then the above-mean match count."""
    wrapped = m_cnts.to(_I64).sum(dim=1) % (1 << 32)
    mv_n = n_exp.to(_I64).clamp(min=1)
    ssum = torch.div(wrapped, mv_n, rounding_mode="floor")
    n_match = (m_cnts.to(_I64) > ssum[:, None]).sum(dim=1)
    return lam, lam2, n_match.to(_I32), ssum.to(_I32)


def _apply_fix(lam, lam2, avgk_set, m_cnts, mask, lam_fix, lam2_fix,
               avgk_fix, m_fix):
    mb = mask != 0
    return (torch.where(mb, lam_fix, lam), torch.where(mb, lam2_fix, lam2),
            torch.where(mb, avgk_fix, avgk_set),
            torch.where(mb[:, None], m_fix, m_cnts))


def _group_valid(n_slots, n_exp, *, M, M2, n_real):
    """Row validity (rows whose sketch compaction or expansion
    overflowed are host-processed; padding lanes are invalid), the
    overflow mask and the max slot count over valid rows (the count
    pass's search-width rung selector)."""
    lane = _ar(n_slots.shape[0], n_slots)
    ovf = (n_slots > M) | (n_exp > M2)
    valid = ~ovf & (lane < n_real)
    ns_max = torch.where(valid, n_slots, 0).amax().to(_I32)
    return valid.to(_I32), ovf & (lane < n_real), ns_max


def _compact_sketch(emit, hsh, pos, strand, *, M):
    """Per-row compaction of the sketch's (B, L) per-column output into
    the first M emitting slots (position order). The hashes keep their
    lanes (int32, or int64 for 2k > 30 and under HPC); empty slots hold
    the lanes' sentinel."""
    B, L = emit.shape
    has = emit > 0
    posl = torch.arange(L, dtype=_I32, device=emit.device).expand(B, L)
    order = torch.argsort(torch.where(has, posl, INF32), dim=1,
                          stable=True)[:, :M]
    n = has.sum(dim=1).to(_I32)
    slot_on = _ar(M, emit)[None, :] < n.clamp(max=M)[:, None]

    def take(a):
        return torch.where(slot_on, torch.gather(a, 1, order), 0)

    qh = torch.where(slot_on, torch.gather(hsh, 1, order),
                     di.infk(hsh.dtype))
    return qh, take(pos), take(strand), take(emit), n


def _compact_sketch_hpc(emit, hsh, pos, strand, *, M):
    """_compact_sketch of the HPC sketch, whose keys pack hash << 8 |
    span: -> (hash, pos, strand, span, emit, n) int32 slots (k <= 15
    keeps the hash in int32)."""
    pk, qpos, qstrand, qcnt, n = _compact_sketch(emit, hsh, pos, strand,
                                                 M=M)
    slot_on = _ar(M, emit)[None, :] < n.clamp(max=M)[:, None]
    qh = torch.where(slot_on, pk >> 8, INF32).to(_I32)
    qspan = torch.where(slot_on, pk & 0xFF, 0).to(_I32)
    return qh, qpos, qstrand, qspan, qcnt, n


def _make_static(cfg, M, M2, A, k):
    m = cfg.map
    f = cfg.flt
    return StepStatic(
        M=M, M2=M2, A=A, k=k,
        max_gap=m.max_gap, bw=m.bw, max_skip=m.max_chain_skip,
        min_cnt=m.min_cnt, min_sc=m.min_chain_score,
        min_sc_m=m.min_score_med, min_sc_g=m.min_score_good,
        max_overhang=f.max_overhang, min_cov=f.min_coverage,
        covt=cfg.covt, ava=cfg.ava, min_ratio=float(f.min_ratio))


def _len_bucket(n):
    b = 4096
    while b < n:
        b *= 4
    return b


class _Group:
    """A batch of query lanes sharing one length bucket, sketched and
    compacted on `device`: their step inputs and their accumulators
    (lam, lam2, avgk_set, avgk_val, m_cnts), which stay on the device
    from staging to the finalize (per-read-owned state,
    minimap2-coverage.c:434-444)."""

    INPUTS = ("qps", "qcnt", "n_slots", "n_exp", "qlen", "qvalid", "qspan")
    STATE = ("lam", "lam2", "avgk_set", "avgk_val", "m_cnts")

    def __init__(self, qids, reads, k, w, device, lanes=GROUP_Q,
                 hpc=False):
        self.lanes = lanes
        self.device = device
        self.qids = qids                     # lane -> global query index
        self.hpc = hpc
        self.idx = None                      # a take's lanes (take)
        self.blen = _len_bucket(max(len(reads[i][1]) for i in qids))
        self.M = self.blen // 2
        self.M2 = self.blen
        if hpc:
            # homopolymer-compressed entries (sketch.c:90-104): one entry
            # per run, positions = run-end read coordinate, spans =
            # windowed run-length sums; the compressed length is at most
            # the read length, so the read's bucket fits
            comp = hpc_compress_all([reads[i][1] for i in qids], k)
            comp += [hpc_compress("A" * k, k)] * (lanes - len(comp))
            codes, lengths, positions, spans = (
                torch.from_numpy(a).to(device)
                for a in pack_hpc(comp, self.blen))
            res = sketch_batch(codes, lengths, w=w, k=k,
                               positions=positions, spans=spans)
            (self.qh, self.qpos, self.qstrand, self.qspan, self.qcnt,
             self.n_slots) = _compact_sketch_hpc(
                res["emit"], res["hash"], res["pos"], res["strand"],
                M=self.M)
        else:
            rows = [reads[i][1] for i in qids]
            rows += ["A" * k] * (lanes - len(rows))
            packed = di.pack_single_rows(rows, self.blen)
            words = [di.to_device_words(a, device) for a in packed[:4]]
            ints = [torch.from_numpy(a).to(device) for a in packed[4:]]
            res = sketch_tiles(*words, *ints, W=self.blen, k=k, w=w)
            (self.qh, self.qpos, self.qstrand, self.qcnt,
             self.n_slots) = _compact_sketch(res["emit"], res["hash"],
                                             res["pos"], res["strand"],
                                             M=self.M)
            self.qspan = None
        self.qps, self.n_exp = _pack_group_slots(
            self.qpos, self.qstrand, self.qcnt, self.n_slots)
        self.qlen = torch.tensor(
            [len(reads[i][1]) for i in qids] + [0] * (lanes - len(qids)),
            dtype=_I32, device=device)
        self.qvalid, ovf, ns_max = _group_valid(
            self.n_slots, self.n_exp, M=self.M, M2=self.M2,
            n_real=len(qids))
        # rows permanently host-processed (sketch compaction/expansion
        # overflow — adversarial periodic reads)
        self.perm_host = ovf.cpu().numpy()
        self.ns_max = int(ns_max)
        self.lam = torch.zeros(lanes, dtype=_I64, device=device)
        self.lam2 = torch.zeros(lanes, dtype=_I64, device=device)
        self.avgk_set = torch.zeros(lanes, dtype=_I32, device=device)
        # HPC: the kept-minimizer mean span (f32) of each processed row
        self.avgk_val = torch.zeros(lanes, dtype=torch.float32,
                                    device=device) if hpc else None
        self.m_cnts = torch.zeros((lanes, self.M2), dtype=_I32,
                                  device=device)
        self._host_sketch = None

    def put(self, a):
        """A per-lane tensor or numpy array of the group on the group's
        device (on a take, its lanes gathered)."""
        a = torch.as_tensor(a, device=self.device)
        return a if self.idx is None else a.index_select(0, self.idx)

    def take(self, lanes):
        """The group's `lanes` (lane indices) alone: their inputs and
        accumulators gathered; give_back scatters the accumulators
        back."""
        sub = copy.copy(self)
        sub.idx = torch.tensor(lanes, dtype=_I64, device=self.device)
        for name in self.INPUTS + self.STATE:
            t = getattr(self, name)
            if t is not None:
                setattr(sub, name, t.index_select(0, sub.idx))
        return sub

    def give_back(self, sub):
        """Scatter the accumulators of `sub` (a take of this group) back
        to their lanes."""
        for name in self.STATE:
            t = getattr(self, name)
            if t is not None:
                t.index_copy_(0, sub.idx, getattr(sub, name))

    def count_crop(self):
        """Search-width rung for the count pass: smallest of
        {M/4, M/2, M} that holds every valid row's slots."""
        for mc in (self.M // 4, self.M // 2):
            if mc >= 1 and self.ns_max <= mc:
                return mc
        return self.M

    def host_sketch_lists(self, k, w, reads):
        """Per-lane (hash, pos, strand, span) expanded lists for the host
        fallback; rows whose compaction overflowed are re-sketched by the
        host spec."""
        if self._host_sketch is None:
            qh = self.qh.cpu().numpy()
            qpos = self.qpos.cpu().numpy()
            qstr = self.qstrand.cpu().numpy()
            qcnt = self.qcnt.cpu().numpy()
            ns = self.n_slots.cpu().numpy()
            qsp = self.qspan.cpu().numpy() if self.hpc else None
            resketch = sketch_reads_hpc if self.hpc else \
                oh.sketch_reads_device
            out = []
            for r in range(self.lanes):
                if r < len(self.qids) and self.perm_host[r]:
                    out.append(resketch([reads[self.qids[r]]], k, w,
                                        device=self.device)[0])
                    continue
                n = min(int(ns[r]), self.M)
                rep = np.repeat(np.arange(n), qcnt[r, :n])
                spans = (qsp[r, rep].astype(np.int64) if self.hpc
                         else np.full(len(rep), k, np.int64))
                out.append((qh[r, rep].astype(np.uint64),
                            qpos[r, rep].astype(np.int64),
                            qstr[r, rep].astype(np.int64), spans))
            self._host_sketch = out
        return self._host_sketch


class _PartIndex:
    """Device index over one target part + host-side metadata (name
    ranks for the AVA order, rid-indexed seq_lens) and the lazy exact
    host index for the per-row fallback. Parts past the width ladder
    take the hash-range build into the same flat layout (n_ranges > 0);
    on IndexOverflowError (past max_entries entries, or a build larger
    than the device's free memory) the part is host_only and every row
    is computed by the host spec. HPC parts (the small spike-in control
    targets, longQC.py:255) take the host spec's index, moved to the
    device layout, and keep the ladder: past it they are host_only.

    The constructor is the host step (names, ranks, lengths and the
    packed tiles; numpy only, so the engine runs it on its side thread);
    build() is the device step (B1, the sorts, the merge), which the
    engine runs on the main thread once the previous part's index is
    released."""

    def __init__(self, part, k, w, mid_occ_fixed, mid_occ_frac, ladder,
                 n_idx_sizes, device, hpc=False, range_max=di.RANGE_MAX,
                 max_entries=di.INDEX_MAX):
        self.part = part
        self.names = [r[0] for r in part]
        uniq = sorted(set(self.names))
        self.name_rank = {n: i for i, n in enumerate(uniq)}
        self.sorted_names = uniq
        B = len(part)
        if B >= 1 << 24:
            # the JAX engine's limit too: anchors pack rev << 24 | rid
            raise ValueError("part of %d reads exceeds the 24-bit read id "
                             "of the anchor keys" % B)
        self.B_pad = next(b for b in B_PADS if B <= b)
        self._rid_rank = np.full(self.B_pad, -2, np.int32)
        self._rid_rank[:B] = [self.name_rank[n] for n in self.names]
        self._seq_lens = np.zeros(self.B_pad, np.int32)
        self._seq_lens[:B] = [len(r[1]) for r in part]
        self.host_only = False
        self.hpc = hpc
        self._host_index = None
        self._k, self._w = k, w
        self._opts = (mid_occ_fixed, mid_occ_frac, ladder, n_idx_sizes,
                      range_max, max_entries)
        self.device = device
        self.ih = self.irid = self.ips = self.mid_occ = None
        self.rid_rank = self.seq_lens = None
        self.n_ranges = 0
        self.tiles = None
        if not hpc:
            self.tiles = di.pack_part(part, w, ladder=ladder)

    def build(self):
        """The device step: the index arrays on self.device."""
        (mid_occ_fixed, mid_occ_frac, ladder, n_idx_sizes, range_max,
         max_entries) = self._opts
        device, k, w = self.device, self._k, self._w
        self.rid_rank = torch.from_numpy(self._rid_rank).to(device)
        self.seq_lens = torch.from_numpy(self._seq_lens).to(device)
        if self.hpc:
            self._host_index = hidx = oh.build_index(self.part, k, w,
                                                     is_hpc=True,
                                                     device=device)
            n_real = len(hidx.h)
            n_idx = next((s for s in n_idx_sizes if n_real <= s), None)
            if n_idx is None:
                self.host_only = True
                return
            arrs = []
            for a, fill in ((hidx.h, INF32), (hidx.rid, 0), (hidx.ps, 0)):
                full = np.full(n_idx, fill, np.int32)
                full[:n_real] = a.astype(np.int64)   # hashes < 2^30
                arrs.append(torch.from_numpy(full).to(device))
            self.ih, self.irid, self.ips = arrs
            self.mid_occ = torch.tensor(
                mid_occ_fixed or hidx.mid_occ(mid_occ_frac),
                dtype=_I32, device=device)
            return
        tiles, self.tiles = self.tiles, None
        try:
            idx = di.build_device_index(
                self.part, k, w, device=device, ladder=ladder,
                n_idx_sizes=n_idx_sizes, mid_occ_fixed=mid_occ_fixed,
                mid_occ_frac=mid_occ_frac, range_max=range_max,
                max_entries=max_entries, tiles=tiles)
            self.ih, self.irid, self.ips = idx["ih"], idx["irid"], idx["ips"]
            self.mid_occ = idx["mid_occ"]
            self.n_ranges = idx["n_ranges"]
        except di.IndexOverflowError:
            logger.warning("device index overflow; part falls back to "
                           "the host path")
            self.host_only = True

    def host_index(self):
        """Exact host MinimizerIndex for this part (built lazily, only
        when a flagged row needs the host fallback)."""
        if self._host_index is None:
            self._host_index = oh.build_index(self.part, self._k, self._w,
                                              is_hpc=self.hpc,
                                              device=self.device)
        return self._host_index


# DeviceOverlapEngine.stats()'s phase_s and index_s: each key's spans
PHASE_SPANS = {"stage": ("group.stage",), "part_wait": ("part.wait",),
               "index": ("part.prep", "index.build"),
               "count": ("step.count",),
               "step": ("step.launch", "step.pull", "step.retry",
                        "step.wide"),
               "pull": ("step.unpack",), "host_fix": ("step.host_fix",),
               "finalize": ("finalize",)}
INDEX_SPANS = {"pack": ("part.pack",), "tiles": ("index.tiles",),
               "merge": ("index.merge",)}


def _wide_batches(rows, nq, rungs, budget):
    """Sub-batches [(A, rows)] of the rows past the top rung: each row
    at the smallest of `rungs` that holds its count-pass anchors nq[r],
    the rows of one rung in batches of at most budget // A lanes, largest
    rows first."""
    by_rung = {}
    for r in sorted(rows, key=lambda r: -int(nq[r])):
        A = next(a for a in rungs if a >= nq[r])
        by_rung.setdefault(A, []).append(r)
    out = []
    for A in sorted(by_rung, reverse=True):
        rs, cap = by_rung[A], budget // A
        out += [(A, rs[i:i + cap]) for i in range(0, len(rs), cap)]
    return out


def anchor_rungs(device):
    """The anchor rungs of a run on `device`: A_LADDER on the card,
    A_BUCKETS on the CPU (the kernels' plain twins)."""
    return A_LADDER if device.type == "cuda" else A_BUCKETS


class DeviceOverlapEngine:
    """Device-resident overlap engine with exact per-row host fallback.
    Produces rows bit-identical to overlap_host.overlap_run."""

    def __init__(self, cfg: OverlapConfig, query_reads, device="cuda",
                 lanes=GROUP_Q, a_ladder=None):
        """device: the torch device of every tensor of the run. On CUDA
        the anchor rungs are A_LADDER and the tile / index widths the
        production ladders; on the CPU (plain kernel twins, tests) the
        coarser A_BUCKETS and the small ladders (the part the JAX
        engine's `geometry=` chooses).

        lanes: the query lanes of a group (GROUP_Q; fewer in tests).

        a_ladder: the anchor rungs (default: by device type,
        anchor_rungs). A row past its top steps in a sub-batch of fewer
        lanes at a wider rung (`wide_ladder`, in the footprint of the
        group's lanes at the top rung), up to `row_anchors_max` anchors
        (ROW_ANCHORS_MAX by default on the card); past that, it is
        computed by the host spec. The JAX engine's `interpret=`
        (Pallas only) has no counterpart."""
        self.hpc = cfg.index.is_hpc
        if self.hpc and 2 * cfg.index.k > 30:
            # HPC keys carry hash << 8 | span and the hash rides int32
            # lanes (k <= 15); every reference HPC surface (spike-in
            # filter, pb-hifi main run) uses k = 15
            raise NotImplementedError("HPC device engine requires k <= 15")
        self.device = require_device(device)
        on_gpu = self.device.type == "cuda"
        self.cfg = cfg
        self.k, self.w = cfg.index.k, cfg.index.w
        # HPC rows get their own tables per step (avg_qspan is
        # data-dependent); plain mode has one for every row
        self.pen_tab = None
        if not self.hpc:
            pen = torch.from_numpy(
                gap_penalty_table(np.float32(self.k), cfg.map.bw)[None, :])
            self.pen_tab = pen.to(self.device)
        self.a_ladder = (anchor_rungs(self.device) if a_ladder is None
                         else tuple(a_ladder))
        if on_gpu:
            self.tile_ladder = di.TILE_LADDER
            self.n_idx_sizes = di.N_IDX_SIZES
        else:
            self.tile_ladder = di.TILE_LADDER_SMALL
            self.n_idx_sizes = di.N_IDX_SIZES_SMALL
        # parts past the width ladder: entries per hash range, and the
        # most entries a part's index may hold
        self.range_max = di.RANGE_MAX
        self.max_index_entries = di.INDEX_MAX
        self.lanes = lanes
        # rows past the top rung: wider rungs on fewer lanes
        self.wide_ladder = _wide_ladder(self.a_ladder[-1], self.lanes)
        self.row_anchors_max = (self.wide_ladder or self.a_ladder)[-1]
        self.queries = query_reads
        by_bucket = {}
        for i, r in enumerate(query_reads):
            by_bucket.setdefault(_len_bucket(len(r[1])), []).append(i)
        self._by_bucket = by_bucket
        self._groups = None
        self.events = [[] for _ in query_reads]   # flat tagged endpoints
        # persistent host ReadStates for permanently host-processed rows
        self.host_state = {}
        self._host_state_done = set()
        self.n_host_fallback = 0
        self.n_host_only_parts = 0
        self.part_ranges = []     # per part: hash ranges (0: the ladder)
        self.n_device_calls = 0
        self.n_retry_steps = 0
        self.n_parts_aside = 0    # parts whose host step ran on the thread
        self.spans = None         # what run() recorded (tracing.run)
        self.flag_counts = defaultdict(int)

    def stats(self):
        """Run counters: wall seconds per phase (`part_wait`: the main
        thread waiting for the side thread's next part) and of the device
        index builds (host packing, B1 plus chunks, the merge), both
        read from the run's spans (PHASE_SPANS, INDEX_SPANS), step
        calls and retry steps, final flag counts by bit pattern,
        host-fixed rows, host-only parts, parts built by hash range and
        each part's number of hash ranges and the parts packed on the
        side thread."""
        fold = self.spans or {"by_name": {}}
        return {"phase_s": tracing.legacy(fold, PHASE_SPANS),
                "index_s": tracing.legacy(fold, INDEX_SPANS),
                "device_calls": self.n_device_calls,
                "retry_steps": self.n_retry_steps,
                "flag_counts": {str(k): v for k, v in
                                sorted(self.flag_counts.items())},
                "host_fixed_rows": self.n_host_fallback,
                "host_only_parts": self.n_host_only_parts,
                "hash_range_parts": self.n_hash_range_parts,
                "part_ranges": list(self.part_ranges),
                "parts_packed_aside": self.n_parts_aside}

    @property
    def n_hash_range_parts(self):
        """Parts whose device index was built by hash range."""
        return sum(1 for s in self.part_ranges if s)

    @property
    def groups(self):
        """Query groups, staged on first access."""
        if self._groups is None:
            with span("group.stage"):
                gs = []
                for blen, idxs in sorted(self._by_bucket.items()):
                    for off in range(0, len(idxs), self.lanes):
                        gs.append(_Group(idxs[off:off + self.lanes],
                                         self.queries, self.k, self.w,
                                         self.device, lanes=self.lanes,
                                         hpc=self.hpc))
            self._groups = gs
        return self._groups

    def _static(self, g, A):
        return _make_static(self.cfg, g.M, g.M2, A, self.k)

    def run(self, target_iter, parts=None, progress=None):
        """Pipelined part loop (the kt_pipeline role, kthread.c:129-158):
        a one-slot side thread reads part N+1 and runs its host step
        (names, ranks, tile packing) while part N's groups step; the main
        thread stages the query groups while the first part is read, and
        runs each part's device build only once the previous part's index
        is released, so one device build is live at a time. A side-thread
        failure is raised here. parts: pre-grouped part read-lists (the
        -d prefetch path), iterated in place of target_iter's parts.
        progress: called with the query index once per row and part.
        What the run records (tracing) is kept in self.spans."""
        try:
            with tracing.run() as scope:
                return self._run(target_iter, parts, progress)
        finally:
            self.spans = scope.fold

    def _run(self, target_iter, parts, progress):
        cfg = self.cfg
        part_iter = (iter(parts) if parts is not None
                     else oh.iter_index_parts(target_iter,
                                              cfg.index.batch_size))
        main = threading.get_ident()

        def prepare():
            with span("part.read"):
                part = next(part_iter, None)
            if part is None:
                return None
            with span("part.prep"):
                pidx = _PartIndex(part, self.k, self.w, cfg.map.mid_occ,
                                  cfg.map.mid_occ_frac, self.tile_ladder,
                                  self.n_idx_sizes, self.device,
                                  hpc=self.hpc, range_max=self.range_max,
                                  max_entries=self.max_index_entries)
            pidx.aside = threading.get_ident() != main
            return pidx

        prepare = tracing.carry("part", prepare)
        with count_pieces() as pieces, cf.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="longqc-part") as ex:
            fut = ex.submit(prepare)
            _ = self.groups
            while True:
                with span("part.wait"):
                    pidx = fut.result()
                if pidx is None:
                    break
                fut = ex.submit(prepare)
                self.n_parts_aside += pidx.aside
                with span("index.build"):
                    pidx.build()
                self.part_ranges.append(pidx.n_ranges)
                self._run_part(pidx, progress)
                pidx = None           # release the index before the next
        with span("finalize"):
            return self._finalize(pieces)

    def _step_group(self, g, pidx, qrank, qbisect, qvalid, A, left, occ,
                    lanes=None):
        """One (part x group) step at anchor rung A. qrank / qbisect:
        per-lane numpy arrays; qvalid: per-lane numpy row mask (None: the
        group's own); left/occ: the count pass's seed-lookup tables.
        lanes: step only these lanes of the group, their inputs and
        accumulators gathered (_Group.take) and the accumulators
        scattered back; the pulls then hold len(lanes) lanes. Returns
        (packed_small, events_full)."""
        st = self._static(g, A)
        sub = g if lanes is None else g.take(lanes)
        if self.hpc:
            small, full = self._step_group_hpc(sub, pidx, qrank, qbisect,
                                               qvalid, st, left, occ)
        else:
            qv = sub.qvalid if qvalid is None else sub.put(qvalid)
            (sub.lam, sub.lam2, sub.avgk_set, sub.m_cnts, small,
             full) = _step_impl(
                pidx.irid, pidx.ips, pidx.seq_lens, pidx.rid_rank,
                pidx.mid_occ, sub.put(left), sub.put(occ), sub.qps,
                sub.qcnt, sub.n_slots, sub.n_exp, sub.qlen, sub.put(qrank),
                sub.put(qbisect), qv, sub.lam, sub.lam2, sub.avgk_set,
                sub.m_cnts, self.pen_tab, st)
        if lanes is not None:
            g.give_back(sub)
        self.n_device_calls += 1
        return small, full

    def _step_group_hpc(self, g, pidx, qrank, qbisect, qvalid, st, left,
                        occ):
        """Two-phase HPC step (g: a group or a take of one): anchors and
        span sums on the device; per row, the f64-exact gap-penalty table
        of its mean anchor span (the host spec's avg_qspan) and its kept
        mean span (state.avg_k) on the host; then the chain fill and the
        accounting on the device."""
        with span("step.hpc_a"):
            anchors, stats = _step_hpc_a(
                pidx.irid, pidx.ips, pidx.rid_rank, pidx.mid_occ,
                g.put(left), g.put(occ), g.qps, g.qcnt, g.n_slots, g.qspan,
                g.qlen, g.put(qrank), g.put(qbisect), st)
            stats_np = stats.cpu().numpy()
        with span("step.hpc_tables"):
            bw = self.cfg.map.bw
            pen = np.zeros((len(stats_np), bw + 1), np.int32)
            kept_avg = np.zeros(len(stats_np), np.float32)
            for r, (n_a, ssum, nk, kss, _nq) in enumerate(stats_np.tolist()):
                if nk > 0:
                    kept_avg[r] = np.float32(kss / nk)
                if n_a > 0:
                    pen[r] = gap_penalty_table(np.float32(ssum / n_a), bw)
        with span("step.hpc_b"):
            qv = g.qvalid if qvalid is None else g.put(qvalid)
            (g.lam, g.lam2, g.avgk_set, g.avgk_val, g.m_cnts, small,
             full) = _step_hpc_b(
                anchors, pidx.seq_lens, g.qlen, qv, g.n_exp, g.lam, g.lam2,
                g.avgk_set, g.avgk_val, g.m_cnts,
                torch.from_numpy(pen).to(g.device),
                torch.from_numpy(kept_avg).to(g.device), st)
        return small, full

    def _unpack_pull(self, small_np, full, L=None):
        """Decode a step's packed pull, one [flags | ev_n | compact
        events] block of L lanes (default: a group's), into (flags,
        per-row event arrays). A block past EV_B events pulls its
        uncompacted events instead."""
        L = L or self.lanes
        flags = small_np[:L].copy()
        en = small_np[L:2 * L]
        ev_rows = [None] * L
        if int(en.sum()) > EV_B:
            full_np = full.cpu().numpy()
            for r in range(L):
                ev_rows[r] = full_np[r, :int(en[r])]
            return flags, ev_rows
        ev = small_np[2 * L:]
        off = 0
        for r in range(L):
            n = int(en[r])
            ev_rows[r] = ev[off:off + n]
            off += n
        return flags, ev_rows

    def _commit_rows(self, g, want, flags_np, ev_rows, progress,
                     forced=()):
        """Record interval events for rows of `want` that came back
        clean; return the rows that still need work. `forced`: rows
        masked off up front (their count exceeds the top anchor rung)."""
        forced = set(forced)
        with span("step.commit"):
            for r in want:
                if flags_np[r] or g.perm_host[r] or r in forced:
                    continue
                qi = g.qids[r]
                ev = ev_rows[r]
                if ev is not None and len(ev):
                    self.events[qi].extend(int(x) for x in ev)
                if progress:
                    progress(qi)
        return [r for r in want
                if flags_np[r] or g.perm_host[r] or r in forced]

    def _pull_step(self, small, full, L=None):
        return self._unpack_pull(small.cpu().numpy(), full, L=L)

    def _retry(self, g, pidx, qrank, qbisect, rows, flags_np, ev_rows, A,
               left, occ, progress):
        """Re-run `rows` alone at rung A; returns the rows still needing
        work."""
        with span("step.retry"):
            qv = np.zeros(self.lanes, np.int32)
            qv[rows] = 1
            small, full = self._step_group(g, pidx, qrank, qbisect, qv, A,
                                           left, occ)
            self.n_retry_steps += 1
            flags2, ev_rows2 = self._pull_step(small, full)
            for r in rows:
                flags_np[r] = flags2[r]
                ev_rows[r] = ev_rows2[r]
        return self._commit_rows(g, rows, flags_np, ev_rows, progress)

    def _step_wide(self, g, pidx, qrank, qbisect, rows, nq, left, occ,
                   flags_np, ev_rows, progress):
        """The rows past the top rung, in sub-batches of fewer lanes at
        wider rungs (_wide_batches), each batch's lanes stepped alone
        (_step_group's `lanes`) and its clean rows committed; its flags
        and events go to flags_np / ev_rows. Returns the rows still
        needing work. One span `step.wide` a batch covers its launch,
        pull, unpack and commit (its `step.commit` inside)."""
        bad = []
        for A, batch in _wide_batches(rows, nq, self.wide_ladder,
                                      self.lanes * self.a_ladder[-1]):
            with span("step.wide"):
                small, full = self._step_group(g, pidx, qrank, qbisect,
                                               None, A, left, occ,
                                               lanes=batch)
                fl, evs = self._pull_step(small, full, L=len(batch))
                for j, r in enumerate(batch):
                    flags_np[r], ev_rows[r] = fl[j], evs[j]
                bad += self._commit_rows(g, batch, flags_np, ev_rows,
                                         progress)
            tracing.count("step.wide_rows", len(batch))
            tracing.count("step.wide_slots", len(batch) * A)
            tracing.count("step.wide_anchors",
                          int(sum(int(nq[r]) for r in batch)))
        return bad

    def _run_part(self, pidx, progress):
        """All query groups against one part: count pass -> step at the
        smallest fitting rung; F_ANCH rows retry at bigger rungs; rows
        past the top rung step in sub-batches at wider rungs
        (_step_wide), and whatever remains flagged, or is past the
        widest rung, is recomputed exactly on the host."""
        if pidx.host_only:
            self.n_host_only_parts += 1
            logger.warning("part has no device index; computed by the "
                           "exact host path")
            with span("step.host_fix"):
                for g in self.groups:
                    self._host_fix(g, pidx, list(range(len(g.qids))),
                                   progress)
            return

        for g in self.groups:
            with span("step.count"):
                with span("step.ranks"):
                    qrank = np.full(self.lanes, -1, np.int32)
                    qbisect = np.zeros(self.lanes, np.int32)
                    for r, qi in enumerate(g.qids):
                        qname = self.queries[qi][0]
                        qrank[r] = pidx.name_rank.get(qname, -1)
                        if self.cfg.ava:
                            qbisect[r] = bisect_left(pidx.sorted_names, qname)
                cnt, left, occ = _count_expanded(
                    pidx.ih, g.qh, g.qcnt, g.n_slots, pidx.mid_occ,
                    mcrop=g.count_crop())
                nq = cnt.cpu().numpy()

            with span("step.launch"):
                live = np.zeros(self.lanes, bool)
                live[:len(g.qids)] = True
                live &= ~g.perm_host
                # rows past the top rung: stepped at the wide rungs up to
                # row_anchors_max (wide), past it host-fixed (forced)
                over = [r for r in range(len(g.qids))
                        if live[r] and nq[r] > self.a_ladder[-1]]
                wide = [r for r in over if nq[r] <= self.row_anchors_max]
                forced = [r for r in over if nq[r] > self.row_anchors_max]
                qvalid = None
                if over:
                    live[over] = False
                    qvalid = g.qvalid.cpu().numpy().copy()
                    qvalid[over] = 0
                nq_max = int(nq[live].max()) if live.any() else 0
                rung = next(a for a in self.a_ladder if a >= nq_max)
                small, full = self._step_group(g, pidx, qrank, qbisect,
                                               qvalid, rung, left, occ)
            with span("step.pull"):
                small_np = small.cpu().numpy()

            with span("step.unpack"):
                flags_np, ev_rows = self._unpack_pull(small_np, full)
            bad = self._commit_rows(g, list(range(len(g.qids))), flags_np,
                                    ev_rows, progress, forced=over)
            wide_set = set(wide)
            bad = [r for r in bad if r not in wide_set]
            self.flag_counts[F_ANCH] += len(forced)
            # F_ANCH safety net: the count pass sized the rung, so this
            # fires only on a count/step disagreement
            rung0 = self.a_ladder.index(rung)
            for A in self.a_ladder[rung0 + 1:]:
                retry = [r for r in bad
                         if flags_np[r] & F_ANCH and not g.perm_host[r]]
                if not retry:
                    break
                bad = [r for r in bad if r not in retry] + self._retry(
                    g, pidx, qrank, qbisect, retry, flags_np, ev_rows, A,
                    left, occ, progress)
            if wide:
                bad += self._step_wide(g, pidx, qrank, qbisect, wide, nq,
                                       left, occ, flags_np, ev_rows,
                                       progress)
            for r in bad:
                if flags_np[r]:
                    self.flag_counts[int(flags_np[r])] += 1
            if bad:
                with span("step.host_fix"):
                    self._host_fix(g, pidx, bad, progress)

    def _ensure_host_state(self, g):
        """Persistent host ReadStates for this group's permanently
        host-processed rows (created on first host access)."""
        if id(g) in self._host_state_done:
            return
        self._host_state_done.add(id(g))
        for r, qi in enumerate(g.qids):
            if g.perm_host[r]:
                sk = g.host_sketch_lists(self.k, self.w, self.queries)[r]
                self.host_state[qi] = oh.ReadState(len(sk[0]))

    def _host_fix(self, g, pidx, rows, progress):
        """Exact host recompute of this part's update for flagged rows
        (their device state was left untouched by the step). The group's
        accumulators are pulled to the host and, where a row was fixed,
        put back on the device."""
        self._ensure_host_state(g)
        cfg = self.cfg
        m = cfg.map
        hidx = pidx.host_index()
        if m.mid_occ:
            mid_occ = m.mid_occ
        elif pidx.mid_occ is not None:
            mid_occ = int(pidx.mid_occ)
        else:
            # host_only part: the host spec's own occurrence quantile
            mid_occ = hidx.mid_occ(m.mid_occ_frac)
        fopt = {"seq_lens": hidx.seq_lens,
                "min_ratio": cfg.flt.min_ratio,
                "max_overhang": cfg.flt.max_overhang}
        sk = g.host_sketch_lists(self.k, self.w, self.queries)
        # copies: on the CPU .numpy() would share the state the loop
        # below writes
        lam, lam2, avgk, mcn = (
            getattr(g, n).to("cpu", copy=True).numpy()
            for n in ("lam", "lam2", "avgk_set", "m_cnts"))
        avgkv = g.avgk_val.to("cpu", copy=True).numpy() if g.hpc else None
        n_exp_np = g.n_exp.cpu().numpy()
        mask = np.zeros(self.lanes, np.int32)
        for r in rows:
            qi = g.qids[r]
            self.n_host_fallback += 1
            q = self.queries[qi]
            if qi in self.host_state:
                state = self.host_state[qi]
            else:
                state = oh.ReadState(0)
                state.lam = int(lam[r])
                state.lam2 = int(lam2[r])
                if not avgk[r]:
                    state.avg_k = np.float32(0.0)
                elif g.hpc:
                    state.avg_k = np.float32(avgkv[r])
                else:
                    state.avg_k = np.float32(self.k)
                n_exp = int(n_exp_np[r])
                mc_row = np.zeros(max(n_exp, len(sk[r][0])), np.uint16)
                upto = min(n_exp, g.M2)
                mc_row[:upto] = mcn[r, :upto].astype(np.uint16)
                state.m_cnts = mc_row
            state.coords = []
            ax, ay, mini_pos = oh.collect_seed_hits(
                hidx, q[0], len(q[1]), sk[r], mid_occ,
                no_self=True, ava=cfg.ava)
            chains = oh.chain_dp(ax, ay, m.max_gap, m.bw,
                                 m.max_chain_skip, m.min_cnt,
                                 m.min_chain_score)
            regs = [oh.chain_to_reg(ax, ay, len(q[1]), sc, idx)
                    for sc, idx in chains]
            cv = oh.lq_cnt_match(state, len(q[1]), regs, ax, ay,
                                 mini_pos, m.min_score_med,
                                 m.min_score_good, fopt, covt=cfg.covt)
            oh.filter_redundant_coords(state, cv, cfg.flt.min_coverage)
            for s, e in state.coords:
                self.events[qi].append(int(np.uint32(s)))
                self.events[qi].append(int(np.uint32(e)))
            if progress:
                progress(qi)
            if qi in self.host_state:
                continue  # state lives host-side permanently
            lam[r] = state.lam
            lam2[r] = state.lam2
            avgk[r] = 1 if state.avg_k != 0.0 else 0
            if g.hpc:
                avgkv[r] = state.avg_k
            mcn[r, :] = 0
            upto = min(len(state.m_cnts), g.M2)
            mcn[r, :upto] = state.m_cnts[:upto].astype(np.int32)
            mask[r] = 1
        if mask.any():
            (g.lam, g.lam2, g.avgk_set, g.m_cnts) = _apply_fix(
                g.lam, g.lam2, g.avgk_set, g.m_cnts, g.put(mask),
                g.put(lam), g.put(lam2), g.put(avgk), g.put(mcn))
            if g.hpc:
                g.avgk_val = g.put(avgkv)

    def _finalize(self, pieces):
        """The rows; B2's counters (pieces, a PieceCounts) ride on the
        first pull and go to the run's counters."""
        cfg = self.cfg
        rows = [None] * len(self.queries)
        pieces.stage()
        for g in self.groups:
            self._ensure_host_state(g)
            out = _finalize_group(g.lam, g.lam2, g.m_cnts, g.n_exp)
            lam, lam2, n_match = (t.cpu().numpy() for t in out[:3])
            n_exp = g.n_exp.cpu().numpy()
            avgkv = g.avgk_val.cpu().numpy() if g.hpc else None
            for r, qi in enumerate(g.qids):
                q = self.queries[qi]
                if qi in self.host_state:
                    st = self.host_state[qi]
                    mv_n = len(st.m_cnts)
                    if mv_n > 0:
                        ssum = int(st.m_cnts.astype(np.uint64).sum()
                                   % (1 << 32)) // mv_n
                        nm = int((st.m_cnts > ssum).sum())
                    else:
                        nm = 0
                    div = oh.div_score(mv_n, nm, st.avg_k)
                    lam_r, lam2_r = st.lam, st.lam2
                else:
                    avg_k = (np.float32(avgkv[r]) if g.hpc
                             else np.float32(self.k))
                    div = oh.div_score(int(n_exp[r]), int(n_match[r]),
                                       avg_k)
                    lam_r, lam2_r = int(lam[r]), int(lam2[r])
                rows[qi] = oh.emit_row(
                    q[0], len(q[1]), q[2], lam_r, lam2_r, div,
                    sorted(self.events[qi]), cfg.flt.min_coverage,
                    cfg.filter_mode)
        pieces.record()
        return rows


def overlap_run_device2(target_iter, query_reads, cfg: OverlapConfig,
                        device="cuda", stats=None, parts=None,
                        progress=None):
    """Device-resident overlap run -> 9-column TSV rows (row-identical
    to overlap_host.overlap_run). stats: optional dict that receives
    the engine's counters (DeviceOverlapEngine.stats). parts:
    pre-grouped part read-lists (the -d prefetch path). progress:
    called with the query index once per row and part."""
    with span("engine.init"):
        eng = DeviceOverlapEngine(cfg, query_reads, device=device)
    rows = eng.run(target_iter, parts=parts, progress=progress)
    if stats is not None:
        stats.update(eng.stats())
    if eng.n_host_fallback:
        logger.info("device overlap: %d calls, %d host-fixed rows",
                    eng.n_device_calls, eng.n_host_fallback)
    return rows
