"""Plain all-vs-sample overlap rows: the reference the overlap rows are
judged by.

A frozen copy of the semantics of minimap2-coverage as LongQC runs it
(the port's host spec, engine/overlap_host.py, copied with what it
needs), in NumPy and plain Python, importing nothing of the port:

  index/occurrence threshold  index.c:69-144
  seed collection             lqmap.c:140-205
  chain DP + backtrack        chain.c:22-157
  coverage accounting         esterr.c:72-140
  interval compression        lqmap.c:25-100
  reliable-region sweep       lqutils.c:83-155
  output rows                 minimap2-coverage.c:545-617

Only the sketch runs as tensor ops (reference/sketch.py), so the index
over a whole part is built in seconds; the per-query chain DP is a
Python loop, so `rows_for` computes the rows of a sample of queries,
each in a worker process of its own pool.

`variant="f32"` is the control: the reference with its float64
arithmetic (meanQ, the coverage ratios) done in float32.
"""

import multiprocessing as mp
import sys
import time

import numpy as np
import torch

from benchmark.reference.sketch import sketch_reads

UINT16_MAX = 0xFFFF
_LO32 = np.uint64(0xFFFFFFFF)

# phred -> error table q2p[] of lqutils.c:26-49 (its literal values)
Q2P = np.array([
    1.000000000000000, 0.794328234724281, 0.630957344480193, 0.501187233627272,
    0.398107170553497, 0.316227766016838, 0.251188643150958, 0.199526231496888,
    0.158489319246111, 0.125892541179417, 0.100000000000000, 0.079432823472428,
    0.063095734448019, 0.050118723362727, 0.039810717055350, 0.031622776601684,
    0.025118864315096, 0.019952623149689, 0.015848931924611, 0.012589254117942,
    0.010000000000000, 0.007943282347243, 0.006309573444802, 0.005011872336273,
    0.003981071705535, 0.003162277660168, 0.002511886431510, 0.001995262314969,
    0.001584893192461, 0.001258925411794, 0.001000000000000, 0.000794328234724,
    0.000630957344480, 0.000501187233627, 0.000398107170554, 0.000316227766017,
    0.000251188643151, 0.000199526231497, 0.000158489319246, 0.000125892541180,
    0.000100000000000, 0.000079432823472, 0.000063095734448, 0.000050118723363,
    0.000039810717055, 0.000031622776602, 0.000025118864315, 0.000019952623150,
    0.000015848931925, 0.000012589254118, 0.000010000000000, 0.000007943282347,
    0.000006309573445, 0.000005011872336, 0.000003981071706, 0.000003162277660,
    0.000002511886432, 0.000001995262315, 0.000001584893193, 0.000001258925412,
    0.000001000000000, 0.000000794328235, 0.000000630957345, 0.000000501187234,
    0.000000398107171, 0.000000316227766, 0.000000251188643, 0.000000199526232,
    0.000000158489319, 0.000000125892541, 0.000000100000000, 0.000000079432824,
    0.000000063095735, 0.000000050118723, 0.000000039810717, 0.000000031622777,
    0.000000025118864, 0.000000019952623, 0.000000015848932, 0.000000012589254,
    0.000000010000000, 0.000000007943282, 0.000000006309574, 0.000000005011872,
    0.000000003981072, 0.000000003162278, 0.000000002511886, 0.000000001995262,
    0.000000001584893, 0.000000001258925, 0.000000001000000, 0.000000000794328,
    0.000000000630957, 0.000000000501187, 0.000000000398107, 0.000000000316228,
    0.000000000251189, 0.000000000199526, 0.000000000158489, 0.000000000125893,
    0.000000000100000, 0.000000000079433, 0.000000000063096, 0.000000000050119,
    0.000000000039811, 0.000000000031623, 0.000000000025119, 0.000000000019953,
    0.000000000015849, 0.000000000012589, 0.000000000010000, 0.000000000007943,
    0.000000000006310, 0.000000000005012, 0.000000000003981, 0.000000000003162,
    0.000000000002512, 0.000000000001995, 0.000000000001585, 0.000000000001259,
    0.000000000001000, 0.000000000000794, 0.000000000000631, 0.000000000000501,
    0.000000000000398, 0.000000000000316, 0.000000000000251], np.float64)


def mean_q(qual, variant=None):
    """meanQ = -10 log10(mean error) with the C's sequential sum
    (lqutils.c:51-58); float32 throughout under the control."""
    idx = np.frombuffer(qual.encode("ascii"), np.uint8).astype(np.int64) - 33
    if variant == "f32":
        s = np.add.accumulate(Q2P[idx].astype(np.float32))[-1]
        return float(np.float32(-10.0) * np.log10(s / np.float32(len(idx))))
    s = float(np.add.accumulate(Q2P[idx])[-1])
    return -10.0 * np.log10(s / len(idx))


# ---------------------------------------------------------------------------
# index


class Index:
    """Sorted (hash, rid, pos << 1 | strand) arrays over one part, with
    each key's first entry and count (khash insertion order: rid, pos)."""

    def __init__(self, target_reads, k, w, device="cpu"):
        sk = sketch_reads(target_reads, k, w, device=device)
        n = np.array([len(s[0]) for s in sk], np.int64)
        h = np.concatenate([s[0] for s in sk]) if len(sk) else \
            np.zeros(0, np.uint64)
        ps = np.concatenate([(s[1] << 1) | s[2] for s in sk]) if len(sk) \
            else np.zeros(0, np.int64)
        rid = np.repeat(np.arange(len(sk), dtype=np.int64), n)
        # one stable sort by hash keeps the (rid, pos) order within a key
        ht = torch.from_numpy(h.view(np.int64)).to(device)
        order = torch.sort(ht, stable=True).indices
        uniq, counts = torch.unique_consecutive(ht[order],
                                                return_counts=True)
        self.h = ht[order].cpu().numpy().view(np.uint64)
        order = order.cpu().numpy()
        self.rid = rid[order]
        self.ps = ps[order]
        self.uniq = uniq.cpu().numpy().view(np.uint64)
        self.counts = counts.cpu().numpy().astype(np.int64)
        self.starts = np.concatenate([[0], np.cumsum(self.counts)[:-1]]
                                     ).astype(np.int64)
        self.seq_lens = np.array([len(r[1]) for r in target_reads],
                                 np.int64)
        names = [r[0] for r in target_reads]
        self.name_rank = {nm: i for i, nm in enumerate(sorted(set(names)))}
        self.rid_rank = np.array([self.name_rank[nm] for nm in names],
                                 np.int64)

    def mid_occ(self, frac):
        """(1 - frac) quantile of the per-key counts, + 1
        (mm_idx_cal_max_occ, index.c:123-144)."""
        if frac <= 0.0:
            return np.iinfo(np.int32).max
        n = len(self.counts)
        if n == 0:
            return 1
        kth = min(int((1.0 - frac) * n), n - 1)
        return int(np.partition(self.counts, kth)[kth]) + 1


def seed_hits(index, qname, qlen, q_sketch, k, max_occ):
    """-> (anchors x, anchors y, mini_pos) per lqmap.c:140-205, own hits
    at the same position dropped (all-vs-sample: no -X)."""
    h_arr, pos_arr, strand_arr = q_sketch
    span_arr = np.full(len(h_arr), k, np.int64)
    ii = np.searchsorted(index.uniq, h_arr)
    ii_c = np.clip(ii, 0, max(len(index.uniq) - 1, 0))
    found = (index.uniq[ii_c] == h_arr) if len(index.uniq) else \
        np.zeros(len(h_arr), bool)
    counts = np.where(found, index.counts[ii_c], 0)
    starts = np.where(found, index.starts[ii_c], 0)
    keep = counts < max_occ
    mini_pos = ((span_arr << 32) | pos_arr)[keep]
    ck, sk = counts[keep], starts[keep]
    n_src = int(ck.sum())
    if n_src == 0:
        return (np.zeros(0, np.uint64), np.zeros(0, np.uint64),
                mini_pos.astype(np.int64))
    rep = np.repeat(np.arange(len(ck)), ck)
    flat = np.repeat(sk, ck) + np.arange(n_src) - np.repeat(
        np.cumsum(ck) - ck, ck)
    rid = index.rid[flat]
    rps = index.ps[flat]
    rpos, rstrand = rps >> 1, rps & 1
    qpos = pos_arr[keep][rep]
    qstrand = strand_arr[keep][rep]
    span = span_arr[keep][rep]
    q_rank = index.name_rank.get(qname, -1)
    k_ = ~((index.rid_rank[rid] == q_rank) & (rpos == qpos))
    rid, rpos, rstrand = rid[k_], rpos[k_], rstrand[k_]
    qpos, qstrand, span = qpos[k_], qstrand[k_], span[k_]
    fwd = rstrand == qstrand
    x = (rid.astype(np.uint64) << np.uint64(32)) | rpos.astype(np.uint64)
    x = x | np.where(fwd, np.uint64(0), np.uint64(1 << 63))
    yq = np.where(fwd, qpos, qlen - (qpos + 1 - span) - 1)
    ay = (span.astype(np.uint64) << np.uint64(32)) | yq.astype(np.uint64)
    order = np.argsort(x, kind="stable")
    return x[order], ay[order], mini_pos.astype(np.int64)


# ---------------------------------------------------------------------------
# chain DP (chain.c:22-157)


def chain_fill(ax, ay, max_dist, bw, max_skip):
    """The score fill of chain.c:41-80 -> (f, p, v) per anchor, as
    Python lists (p the predecessor index or -1)."""
    n = len(ax)
    spans = ((ay >> np.uint64(32)) & np.uint64(0xFF)).astype(np.int64)
    avg_qspan = float(np.float32(spans.sum() / n))
    xs = ax.tolist()
    ys = (ay & _LO32).astype(np.int64).tolist()
    sp = spans.tolist()
    f = [0] * n
    p = [-1] * n
    t = [0] * n
    v = [0] * n
    st = 0
    for i in range(n):
        ri, qi, q_span = xs[i], ys[i], sp[i]
        max_f, max_j, n_skip = q_span, -1, 0
        while st < i and ri - xs[st] > max_dist:
            st += 1
        j = i - 1
        while j >= st:
            dr = ri - xs[j]
            dq = qi - ys[j]
            if dr == 0 or dq <= 0 or dq > max_dist:
                j -= 1
                continue
            dd = dr - dq if dr > dq else dq - dr
            if dd > bw:
                j -= 1
                continue
            min_d = dq if dq < dr else dr
            sc = q_span if min_d > q_span else min_d
            log_dd = dd.bit_length() - 1 if dd else 0
            # double * float in C (chain.c:67)
            sc -= int(dd * 0.01 * avg_qspan) + (log_dd >> 1)
            sc += f[j]
            if sc > max_f:
                max_f, max_j = sc, j
                if n_skip > 0:
                    n_skip -= 1
            elif t[j] == i:
                n_skip += 1
                if n_skip > max_skip:
                    break
            if p[j] >= 0:
                t[p[j]] = i
            j -= 1
        f[i], p[i] = max_f, max_j
        v[i] = v[max_j] if (max_j >= 0 and v[max_j] > max_f) else max_f
    return f, p, v


def chain_backtrack(f, p, v, min_cnt, min_sc):
    """Chains of a filled row (chain.c:82-157) -> [(score, anchor idx)]."""
    n = len(f)
    t = [0] * n
    for i in range(n):
        if p[i] >= 0:
            t[p[i]] = 1
    u = []
    for i in range(n):
        if t[i] == 0 and v[i] >= min_sc:
            j = i
            while j >= 0 and f[j] < v[j]:
                j = p[j]
            if j < 0:
                j = i
            u.append((f[j], j))
    u.sort(reverse=True)
    t = [0] * n
    chains = []
    for score, end in u:
        path = []
        j = end
        while j >= 0 and t[j] == 0:
            path.append(j)
            t[j] = 1
            j = p[j]
        if j < 0:
            if len(path) >= min_cnt:
                chains.append((score, np.array(path[::-1], np.int64)))
        elif score - f[j] >= min_sc:
            if len(path) >= min_cnt:
                chains.append((score - f[j], np.array(path[::-1], np.int64)))
    return chains


def chain_to_reg(ax, ay, qlen, score, idx):
    """hit.c:23-38 mm_reg_set_coor."""
    k0 = idx[0]
    q_span = int((ay[k0] >> np.uint64(32)) & np.uint64(0xFF))
    rev = int(ax[k0] >> np.uint64(63))
    rid = int((ax[k0] << np.uint64(1)) >> np.uint64(33))
    rs_last = int(ax[k0] & _LO32)
    rs = rs_last + 1 - q_span if rs_last + 1 > q_span else 0
    re = int(ax[idx[-1]] & _LO32) + 1
    y0 = int(ay[k0] & _LO32)
    yl = int(ay[idx[-1]] & _LO32)
    if not rev:
        qs, qe = y0 + 1 - q_span, yl + 1
    else:
        qs, qe = qlen - (yl + 1), qlen - (y0 + 1 - q_span)
    return dict(rev=rev, rid=rid, rs=rs, re=re, qs=qs, qe=qe, score0=score,
                idx=idx)


# ---------------------------------------------------------------------------
# coverage accounting (esterr.c, lqmap.c, lqutils.c)


class ReadState:
    def __init__(self, n_mini):
        self.lam = 0
        self.lam2 = 0
        self.avg_k = np.float32(0.0)
        self.m_cnts = np.zeros(n_mini, np.uint16)
        self.coords = []


def _forward_qpos(qlen, ax_v, ay_v):
    x = (ay_v & _LO32).astype(np.int64)
    span = ((ay_v >> np.uint64(32)) & np.uint64(0xFF)).astype(np.int64)
    rev = (ax_v >> np.uint64(63)).astype(bool)
    return np.where(rev, qlen - 1 - (x + 1 - span), x)


def cnt_match(state, qlen, regs, ax, ay, mini_pos, min_sc_m, min_sc_g,
              seq_lens, min_ratio, max_overhang, covt):
    """esterr.c:72-140 -> this call's tagged intervals."""
    n = len(mini_pos)
    cv = []
    if n == 0:
        return cv
    if state.lam // qlen > covt and state.avg_k != 0.0:
        return cv
    if state.avg_k == 0.0:
        state.avg_k = np.float32(((mini_pos >> 32) & 0xFF).sum() / n)
    regs = [r for r in regs if len(r["idx"])]
    if not regs:
        return cv
    mp_pos = (mini_pos & 0xFFFFFFFF).astype(np.int64)
    rev = np.array([r["rev"] for r in regs], bool)
    first = np.array([r["idx"][-1] if r["rev"] else r["idx"][0]
                      for r in regs], np.int64)
    x0 = _forward_qpos(qlen, ax[first], ay[first])
    st = np.searchsorted(mp_pos, x0)
    st_c = np.clip(st, 0, n - 1)
    ok_st = (st < n) & (mp_pos[st_c] == x0)
    rid = np.array([r["rid"] for r in regs], np.int64)
    qs = np.array([r["qs"] for r in regs], np.int64)
    qe = np.array([r["qe"] for r in regs], np.int64)
    rs = np.array([r["rs"] for r in regs], np.int64)
    re_ = np.array([r["re"] for r in regs], np.int64)
    sc0 = np.array([r["score0"] for r in regs], np.int64)
    rl = seq_lens[rid]
    hang5 = np.minimum(qs, rs)
    hang3 = np.minimum(qlen - qe, rl - re_)
    geom = ((qe - qs) >= (qe - qs + hang5 + hang3) * min_ratio) \
        & (hang5 <= max_overhang) & (hang3 <= max_overhang)
    ok = ok_st & geom
    state.lam += int((qe - qs + 1)[ok].sum())
    med = sc0 >= min_sc_m
    starts = (qs << 3) | np.where(med, 2, 0)
    ends = (qe << 3) | np.where(med, 3, 1)
    for i in np.nonzero(ok)[0]:
        cv.append((int(starts[i]), int(ends[i])))
    good = ok & (sc0 >= min_sc_g)
    state.lam2 += int((qe - qs + 1)[good].sum())
    for i in np.nonzero(good)[0]:
        sti = int(st[i])
        if state.m_cnts[sti] < UINT16_MAX:
            state.m_cnts[sti] += 1
        else:
            continue
        idx = regs[i]["idx"]
        if len(idx) < 2:
            continue
        walk = idx[-2::-1] if rev[i] else idx[1:]
        xs = _forward_qpos(qlen, ax[walk], ay[walk])
        js = np.searchsorted(mp_pos, xs)
        js = js[(js < n) & (mp_pos[np.clip(js, 0, n - 1)] == xs)]
        state.m_cnts[js] += 1
    return cv


def filter_redundant_coords(state, cv, min_cov):
    """lqmap.c:25-100 (uint32 wraparound kept)."""
    if not cv:
        return
    vc = sorted(np.uint32(x) for se in cv for x in se)
    mcoords = []
    med_cov = 0
    med_start = np.uint32(0)
    for val in vc:
        old = med_cov
        v32 = int(val)
        if v32 & 2:
            if v32 & 1:
                med_cov -= min_cov if (v32 & 4) else 1
            else:
                med_cov += min_cov if (v32 & 4) else 1
        if old < min_cov <= med_cov:
            med_start = np.uint32(v32)
        elif old >= min_cov > med_cov:
            with np.errstate(over="ignore"):
                mlen = np.uint32(v32 >> 3) - med_start
            if int(mlen) > 0:
                mcoords.append((int(med_start), v32))
                state.coords.append((int(med_start) | 0x4, v32 | 0x4))
    for s, e in cv:
        keep = True
        if not s & 4:
            for ms, me in mcoords:
                if s >= ms and e <= me:
                    keep = False
                    break
        if keep:
            state.coords.append((s, e))


def sweep_events(vc, min_cov):
    """lqutils.c:83-155 over the sorted flat endpoint values."""
    regions, mregions = [], []
    cov = med_cov = 0
    start = med_start = 0
    for val in vc:
        old_cov, old_med = cov, med_cov
        if val & 1:
            cov -= 1
            if val & 2:
                if val & 4:
                    med_cov -= min_cov
                    cov -= (min_cov - 1)
                else:
                    med_cov -= 1
        else:
            cov += 1
            if val & 2:
                if val & 4:
                    med_cov += min_cov
                    cov += (min_cov - 1)
                else:
                    med_cov += 1
        if old_cov < min_cov <= cov:
            start = val >> 3
            if old_med < min_cov <= med_cov:
                med_start = val >> 3
        elif old_cov >= min_cov > cov:
            if (val >> 3) - start > 0:
                regions.append((start, val >> 3))
            if old_med >= min_cov > med_cov:
                if (val >> 3) - med_start > 0:
                    mregions.append((med_start, val >> 3))
        elif old_med < min_cov <= med_cov:
            med_start = val >> 3
        elif old_med >= min_cov > med_cov:
            if (val >> 3) - med_start > 0:
                mregions.append((med_start, val >> 3))
    return regions, mregions


def div_score(mv_n, n_match, avg_k):
    """minimap2-coverage.c:553-563, in float32 as in the C."""
    if mv_n > 0 and n_match > 0:
        r = np.float32(mv_n) / np.float32(n_match)
        return float(np.float32(np.log(r)) / np.float32(avg_k))
    return 1.0


def _ratio(a, b, variant):
    if variant == "f32":
        return float(np.float32(a) / np.float32(b))
    return a / b


def emit_row(qname, qlen, qqual, st, min_cov, filter_mode, variant=None):
    """One 9-column row (minimap2-coverage.c:545-617)."""
    mv_n = len(st.m_cnts)
    if mv_n > 0:
        ssum = int(st.m_cnts.astype(np.uint64).sum() % (1 << 32)) // mv_n
        n_match = int((st.m_cnts > ssum).sum())
    else:
        n_match = 0
    div = div_score(mv_n, n_match, st.avg_k)
    vc = sorted(int(np.uint32(x)) for se in st.coords for x in se)
    regions, mregions = sweep_events(vc, min_cov)
    meanq = mean_q(qqual, variant) if qqual else 0.0
    if regions:
        tot = sum(e - s for s, e in regions)
        coords_s = ",".join("%d-%d" % (s, e) for s, e in regions)
        mcoords_s = (",".join("%d-%d" % (s, e) for s, e in mregions)
                     if mregions else "0")
        if filter_mode:
            c5, c8 = _ratio(tot, qlen, variant), "0.0"
        else:
            c5 = _ratio(st.lam, tot, variant)
            c8 = "%.3f" % _ratio(st.lam2, tot, variant)
        return "%s\t%d\t%d\t%s\t%s\t%.3f\t%.3f\t%.3f\t%s" % (
            qname, qlen, st.lam, coords_s, mcoords_s, c5, meanq, div, c8)
    return "%s\t%d\t%d\t0\t0\t0.0\t%.3f\t%.3f\t0.0" % (
        qname, qlen, st.lam, meanq, div)


def row_key(qname, qlen, qqual, variant=None):
    """The columns of a row that need no overlap: name, length, meanQ."""
    return "%s\t%d\t%.3f" % (qname, qlen,
                             mean_q(qqual, variant) if qqual else 0.0)


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# rows of a query sample, one worker process per query at a time

_SEQ_LENS = None


def _init_worker(seq_lens):
    global _SEQ_LENS
    _SEQ_LENS = seq_lens


def query_row(args):
    """The row of one query from its anchors (one part)."""
    (qname, qlen, qqual, ax, ay, mini_pos, opt, variant) = args
    st = ReadState(opt["n_mini"])
    chains = []
    if len(ax):
        f, p, v = chain_fill(ax, ay, opt["max_gap"], opt["bw"],
                             opt["max_skip"])
        chains = chain_backtrack(f, p, v, opt["min_cnt"], opt["min_sc"])
    regs = [chain_to_reg(ax, ay, qlen, sc, idx) for sc, idx in chains]
    cv = cnt_match(st, qlen, regs, ax, ay, mini_pos, opt["min_sc_med"],
                   opt["min_sc_good"], _SEQ_LENS, opt["min_ratio"],
                   opt["max_overhang"], opt["covt"])
    filter_redundant_coords(st, cv, opt["min_cov"])
    return emit_row(qname, qlen, qqual, st, opt["min_cov"],
                    opt["filter_mode"], variant)


def rows_for(targets, queries, picks, ov, device="cpu", workers=1,
             variant=None):
    """Rows of queries[i] for i in picks, all targets in one index part.

    ov: the overlap settings (k, w, max_gap, bw, max_skip, min_cnt,
    min_chain_score, min_score_med, min_score_good, mid_occ_frac,
    max_overhang, min_ratio, min_cov, covt)."""
    k, w = ov["k"], ov["w"]
    t0 = time.time()
    index = Index(targets, k, w, device=device)
    max_occ = index.mid_occ(ov["mid_occ_frac"])
    _log("reference index: %d entries in %.1f s" % (len(index.h),
                                                    time.time() - t0))
    q_sk = sketch_reads([queries[i] for i in picks], k, w, device=device)
    jobs = []
    for qi, sk in zip(picks, q_sk):
        q = queries[qi]
        ax, ay, mini_pos = seed_hits(index, q[0], len(q[1]), sk, k, max_occ)
        opt = dict(n_mini=len(sk[0]), max_gap=ov["max_gap"], bw=ov["bw"],
                   max_skip=ov["max_skip"], min_cnt=ov["min_cnt"],
                   min_sc=ov["min_chain_score"],
                   min_sc_med=ov["min_score_med"],
                   min_sc_good=ov["min_score_good"],
                   min_ratio=ov["min_ratio"],
                   max_overhang=ov["max_overhang"], covt=ov["covt"],
                   min_cov=ov["min_cov"], filter_mode=False)
        jobs.append((q[0], len(q[1]), q[2], ax, ay, mini_pos, opt, variant))
    seq_lens = index.seq_lens
    del index
    _log("reference anchors of %d queries: %d in %.1f s" % (
        len(jobs), sum(len(j[3]) for j in jobs), time.time() - t0))
    # longest anchor lists first, so the pool's tail is short
    order = sorted(range(len(jobs)), key=lambda j: -len(jobs[j][3]))
    if workers <= 1:
        _init_worker(seq_lens)
        rows = [query_row(jobs[j]) for j in order]
    else:
        ctx = mp.get_context("spawn")
        with ctx.Pool(workers, initializer=_init_worker,
                      initargs=(seq_lens,)) as pool:
            rows = pool.map(query_row, [jobs[j] for j in order],
                            chunksize=1)
            pool.close()
            pool.join()
    _log("reference rows: %.1f s" % (time.time() - t0))
    out = [None] * len(jobs)
    for j, r in zip(order, rows):
        out[j] = r
    return dict(zip(picks, out)), [len(jobs[j][3]) for j in range(len(jobs))]
