"""Host (numpy) reference implementation of the overlap-coverage engine.

Torch port of longqc_tpu/engine/overlap_host.py: the executable *spec*
of the engine, reproducing the reference minimap2-coverage semantics
exactly. The device engine (engine/device_overlap) must match it
bit-for-bit and uses it as its per-row exact fallback. Only the sketch
runs as tensor ops (ops/sketch, on the `device` given); everything
else is numpy.

Pipeline per index part (cf. SURVEY.md §3.1-§3.2):
  target sketch -> sorted-array index (+ occurrence threshold)
  per query: sketch -> seed lookup -> anchors -> chain DP -> chains
           -> coverage accounting (lambda/lambda2, tagged intervals,
              per-minimizer match counts)
  across parts: accumulate; finally reliable-region sweep + 9-col rows.

Behavioral citations:
  index/occurrence threshold  index.c:69-144
  seed collection             lqmap.c:140-205
  chain DP + backtrack        chain.c:22-157
  coverage accounting         esterr.c:72-140
  interval compression        lqmap.c:25-100
  reliable-region sweep       lqutils.c:83-155
  output rows                 minimap2-coverage.c:545-617
  minimizer-count aggregation minimap2-coverage.c:478-543 (-z)

The -d index cache is an npz file per part with the JAX package's keys
and dtypes (h uint64, rid and ps int64, seq_lens int64, names object),
so a cache written by either package loads in the other.
"""

import os

import numpy as np
import torch

from longqc_tpu_torch import tracing
from longqc_tpu_torch.config import OverlapConfig
from longqc_tpu_torch.io.pack import pack_reads
from longqc_tpu_torch.ops._ext import require_device
from longqc_tpu_torch.ops.quality import mean_q_host
from longqc_tpu_torch.ops.sketch import sketch_batch, sketch_to_lists
from longqc_tpu_torch.ops.sketch_hpc import sketch_reads_hpc

UINT16_MAX = 0xFFFF



# ---------------------------------------------------------------------------
# index


class MinimizerIndex:
    """Sorted-array minimizer index over one part of target reads.

    Replaces the reference's bucketed khash (index.c:24-29) with sorted
    (hash, rid, pos<<1|strand) arrays + binary search: the idiomatic
    array-machine equivalent, also directly usable as a device gather.
    Per-key occurrence order matches khash insertion order (rid asc,
    pos asc) by construction.
    """

    def __init__(self, hashes, rids, posstrand, seq_lens, names):
        order = np.lexsort((posstrand, rids, hashes))
        self.h = hashes[order]
        self.rid = rids[order]
        self.ps = posstrand[order]
        self.seq_lens = seq_lens
        self.names = names
        # unique keys + spans for occurrence counting / lookup
        self.uniq, self.starts = np.unique(self.h, return_index=True)
        self.counts = np.diff(np.append(self.starts, len(self.h)))
        # name -> dense id (equal strings share an id: strcmp semantics)
        # plus lexicographic rank for the -X all-vs-all name ordering
        uniq_names = sorted(set(names))
        self.name_rank = {n: i for i, n in enumerate(uniq_names)}
        self.rid_rank = np.array([self.name_rank[n] for n in names],
                                 np.int64)

    def mid_occ(self, frac):
        """Occurrence threshold: (1-frac) quantile of per-key counts + 1
        (cf. mm_idx_cal_max_occ, index.c:123-144)."""
        if frac <= 0.0:
            return np.iinfo(np.int32).max
        n = len(self.counts)
        if n == 0:
            return 1
        kth = int((1.0 - frac) * n)
        kth = min(kth, n - 1)
        return int(np.partition(self.counts, kth)[kth]) + 1

    def lookup(self, h):
        """-> (start, count) into the sorted arrays for hash h."""
        i = np.searchsorted(self.uniq, h)
        if i < len(self.uniq) and self.uniq[i] == h:
            return int(self.starts[i]), int(self.counts[i])
        return 0, 0

    def save(self, path):
        """Persist the index (the -d index-dump equivalent; the cache
        format is npz rather than the reference's MMI)."""
        np.savez_compressed(
            path, h=self.h, rid=self.rid, ps=self.ps,
            seq_lens=self.seq_lens,
            names=np.array(self.names, dtype=object))

    @classmethod
    def load(cls, path):
        """An index saved by `save` (or by the JAX package's)."""
        z = np.load(path, allow_pickle=True)
        idx = cls.__new__(cls)
        idx.h = z["h"]
        idx.rid = z["rid"]
        idx.ps = z["ps"]
        idx.seq_lens = z["seq_lens"]
        idx.names = list(z["names"])
        idx.uniq, idx.starts = np.unique(idx.h, return_index=True)
        idx.counts = np.diff(np.append(idx.starts, len(idx.h)))
        uniq_names = sorted(set(idx.names))
        idx.name_rank = {n: i for i, n in enumerate(uniq_names)}
        idx.rid_rank = np.array([idx.name_rank[n] for n in idx.names],
                                np.int64)
        return idx


def _len_bucket(n):
    """Round up to a power of four (min 4096): compile cost dominates on
    the remote-compiled TPU target, so very few distinct shapes beat
    tighter padding."""
    b = 4096
    while b < n:
        b *= 4
    return b


def sketch_reads_device(reads, k, w, batch_size=128, device="cuda"):
    """Sketch a list of [name, seq, qual] with the tensor sketch on
    `device` (the card unless the caller asks for the CPU), returning
    per-read (hash, pos, strand, span) arrays in input order. Reads are
    bucketed by padded length and batched."""
    device = require_device(device)
    buckets = {}
    for i, r in enumerate(reads):
        buckets.setdefault(_len_bucket(len(r[1])), []).append(i)
    out = [None] * len(reads)
    for blen, idxs in sorted(buckets.items()):
        for off in range(0, len(idxs), batch_size):
            sel = idxs[off:off + batch_size]
            batch = pack_reads([reads[i] for i in sel], max_len=blen,
                               pad_to=blen, with_quals=False)
            res = sketch_batch(torch.from_numpy(batch.codes).to(device),
                               torch.from_numpy(batch.lengths).to(device),
                               w=w, k=k)
            for slot, lst in enumerate(sketch_to_lists(res, k)):
                out[sel[slot]] = lst
    return out


def _sketch_reads(reads, k, w, is_hpc, device):
    if is_hpc:
        return sketch_reads_hpc(reads, k, w, device=device)
    return sketch_reads_device(reads, k, w, device=device)


def build_index(target_reads, k, w, is_hpc=False, sketches=None,
                device="cuda"):
    sketches = sketches or _sketch_reads(target_reads, k, w, is_hpc, device)
    hs, rids, ps = [], [], []
    for rid, (h, pos, strand, _span) in enumerate(sketches):
        hs.append(h.astype(np.uint64))
        rids.append(np.full(len(h), rid, np.int64))
        ps.append((pos.astype(np.int64) << 1) | strand.astype(np.int64))
    hashes = np.concatenate(hs) if hs else np.zeros(0, np.uint64)
    rids_a = np.concatenate(rids) if rids else np.zeros(0, np.int64)
    ps_a = np.concatenate(ps) if ps else np.zeros(0, np.int64)
    seq_lens = np.array([len(r[1]) for r in target_reads], np.int64)
    names = [r[0] for r in target_reads]
    return MinimizerIndex(hashes, rids_a, ps_a, seq_lens, names)


# ---------------------------------------------------------------------------
# anchors


def collect_seed_hits(index, qname, qlen, q_sketch, max_occ, no_self=True,
                      ava=False):
    """-> (anchors_x, anchors_y, mini_pos) per lqmap.c:140-205.

    anchors x = rev<<63 | rid<<32 | rpos ; y = span<<32 | q_for_pos
    mini_pos = span<<32 | qpos for minimizers below max_occ, in sketch
    (position) order.
    """
    h_arr, pos_arr, strand_arr, span_arr = q_sketch
    h_arr = np.asarray(h_arr, np.uint64)
    pos_arr = np.asarray(pos_arr, np.int64)
    strand_arr = np.asarray(strand_arr, np.int64)
    span_arr = np.asarray(span_arr, np.int64)

    ii = np.searchsorted(index.uniq, h_arr)
    ii_c = np.clip(ii, 0, max(len(index.uniq) - 1, 0))
    if len(index.uniq):
        found = index.uniq[ii_c] == h_arr
    else:
        found = np.zeros(len(h_arr), bool)
    counts = np.where(found, index.counts[ii_c], 0)
    starts = np.where(found, index.starts[ii_c], 0)

    keep = counts < max_occ
    mini_pos = ((span_arr << 32) | pos_arr)[keep]

    ck = counts[keep]
    sk = starts[keep]
    n_anchor_src = int(ck.sum())
    if n_anchor_src == 0:
        return (np.zeros(0, np.uint64), np.zeros(0, np.uint64),
                mini_pos.astype(np.int64))
    # flat index into the sorted index arrays, expanding each minimizer
    # to its occurrence list (khash insertion order == (rid, pos) order)
    rep = np.repeat(np.arange(len(ck)), ck)
    within = np.arange(n_anchor_src) - np.repeat(
        np.cumsum(ck) - ck, ck)
    flat = np.repeat(sk, ck) + within
    rid = index.rid[flat]
    rps = index.ps[flat]
    rpos = rps >> 1
    rstrand = rps & 1
    qpos = pos_arr[keep][rep]
    qstrand = strand_arr[keep][rep]
    span = span_arr[keep][rep]

    drop = np.zeros(n_anchor_src, bool)
    if no_self or ava:
        q_rank = index.name_rank.get(qname, -1)
        if no_self:
            drop |= (index.rid_rank[rid] == q_rank) & (rpos == qpos)
        if ava:
            # strcmp(qname, tname) > 0  <=>  rank(tname) < bisect(qname)
            import bisect
            q_pos = bisect.bisect_left(sorted(index.name_rank), qname)
            drop |= index.rid_rank[rid] < q_pos
    k_ = ~drop
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
# chain DP (exact, incl. max_skip pruning) — chain.c:22-157


def chain_dp(ax, ay, max_dist, bw, max_skip, min_cnt, min_sc):
    """-> list of chains [(score, anchor_index_array)], anchors in
    query-ascending order within each chain; backtrack ownership follows
    the reference's (score desc, end-index desc) greedy order."""
    if len(ax) == 0:
        return []
    f, p, v = chain_fill(ax, ay, max_dist, bw, max_skip)
    return chain_backtrack(f, p, v, min_cnt, min_sc)


def chain_fill(ax, ay, max_dist, bw, max_skip, avg_qspan=None):
    """The score fill of chain.c:41-80 -> (f, p, v) per anchor (p the
    predecessor index or -1). avg_qspan: the gap cost's mean span; by
    default the mean anchor span (a C float, as chain.c computes it)."""
    n = len(ax)
    spans = ((ay >> np.uint64(32)) & np.uint64(0xFF)).astype(np.int64)
    if avg_qspan is None:
        avg_qspan = np.float32(spans.sum() / n)

    f = np.zeros(n, np.int32)
    p = np.full(n, -1, np.int64)
    t = np.zeros(n, np.int64)
    v = np.zeros(n, np.int32)
    xi = ax.astype(np.uint64)
    yq = (ay & np.uint64(0xFFFFFFFF)).astype(np.int64)

    st = 0
    for i in range(n):
        ri = int(xi[i])
        qi = int(yq[i])
        q_span = int(spans[i])
        max_f = q_span
        max_j = -1
        n_skip = 0
        while st < i and int(ri - xi[st]) > max_dist:
            st += 1
        j = i - 1
        while j >= st:
            dr = ri - int(xi[j])
            dq = int(qi - yq[j])
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
            # in f64 as chain.c:67 (double * float): a numpy float32
            # operand would round the product to f32 under NumPy >= 2,
            # which truncates differently at some (avg_qspan, dd), e.g.
            # (15.0, 420) and (15.2, 125)
            sc -= int(dd * 0.01 * float(avg_qspan)) + (log_dd >> 1)
            sc += f[j]
            if sc > max_f:
                max_f = sc
                max_j = j
                if n_skip > 0:
                    n_skip -= 1
            elif t[j] == i:
                n_skip += 1
                if n_skip > max_skip:
                    break
            if p[j] >= 0:
                t[p[j]] = i
            j -= 1
        f[i] = max_f
        p[i] = max_j
        v[i] = v[max_j] if (max_j >= 0 and v[max_j] > max_f) else max_f
    return f, p, v


def chain_backtrack(f, p, v, min_cnt, min_sc):
    """Chains of a filled row (chain.c:82-157): end detection, the
    (score, end) order and the greedy backtrack with anchor ownership."""
    n = len(f)
    t = np.zeros(n, np.int64)
    for i in range(n):
        if p[i] >= 0:
            t[p[i]] = 1
    ends = [i for i in range(n) if t[i] == 0 and v[i] >= min_sc]
    if not ends:
        return []
    u = []
    for i in ends:
        j = i
        while j >= 0 and f[j] < v[j]:
            j = p[j]
        if j < 0:
            j = i
        u.append((int(f[j]), j))
    # radix_sort_64 ascending then reversed: descending by (score, end idx)
    u.sort(key=lambda s: (s[0], s[1]), reverse=True)

    # greedy backtrack with anchor ownership; NB: anchors visited by a
    # rejected chain REMAIN marked (chain.c:109-124 keeps t[] set and
    # only rewinds n_v), so they are unavailable to later chains.
    t[:] = 0
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
        elif score - int(f[j]) >= min_sc:
            if len(path) >= min_cnt:
                chains.append((score - int(f[j]),
                               np.array(path[::-1], np.int64)))
    return chains


# ---------------------------------------------------------------------------
# regs (chain -> hit coordinates) — hit.c:23-38 mm_reg_set_coor


def chain_to_reg(ax, ay, qlen, score, idx):
    k0 = idx[0]
    q_span = int((ay[k0] >> np.uint64(32)) & np.uint64(0xFF))
    rev = int(ax[k0] >> np.uint64(63))
    rid = int((ax[k0] << np.uint64(1)) >> np.uint64(33))
    rs_last = int(ax[k0] & np.uint64(0xFFFFFFFF))
    rs = rs_last + 1 - q_span if rs_last + 1 > q_span else 0
    re = int(ax[idx[-1]] & np.uint64(0xFFFFFFFF)) + 1
    y0 = int(ay[k0] & np.uint64(0xFFFFFFFF))
    yl = int(ay[idx[-1]] & np.uint64(0xFFFFFFFF))
    if not rev:
        qs = y0 + 1 - q_span
        qe = yl + 1
    else:
        qs = qlen - (yl + 1)
        qe = qlen - (y0 + 1 - q_span)
    return dict(rev=rev, rid=rid, rs=rs, re=re, qs=qs, qe=qe,
                score0=score, idx=idx)


# ---------------------------------------------------------------------------
# per-read accumulator state


class ReadState:
    """Per-query accumulators (cf. minimap2-coverage.c:433-444)."""

    def __init__(self, n_mini):
        self.lam = 0          # lambda
        self.lam2 = 0         # lambda2
        self.avg_k = np.float32(0.0)
        self.m_cnts = np.zeros(n_mini, np.uint16)
        self.coords = []      # accumulated tagged intervals (uint32 pairs)


def _forward_qpos(qlen, ax_v, ay_v):
    """Forward-strand query positions (get_for_qpos, esterr.c:17-24)."""
    x = (ay_v & np.uint64(0xFFFFFFFF)).astype(np.int64)
    span = ((ay_v >> np.uint64(32)) & np.uint64(0xFF)).astype(np.int64)
    rev = (ax_v >> np.uint64(63)).astype(bool)
    return np.where(rev, qlen - 1 - (x + 1 - span), x)


def lq_cnt_match(state, qlen, regs, ax, ay, mini_pos, min_sc_m, min_sc_g,
                 fopt, covt=150):
    """Coverage accounting per esterr.c:72-140, vectorized across regs.

    The per-chain m_cnts walk — a merge of two strictly ascending
    position sequences where every chained anchor's forward position is
    a mini_pos entry — reduces to a searchsorted gather.
    Returns this call's new tagged intervals (cv).
    """
    n = len(mini_pos)
    cv = []
    if n == 0:
        return cv
    if state.lam // qlen > covt and state.avg_k != 0.0:
        return cv
    if state.avg_k == 0.0:
        spans = (mini_pos >> 32) & 0xFF
        state.avg_k = np.float32(spans.sum() / n)
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
    rl = np.asarray(fopt["seq_lens"])[rid]
    hang5 = np.minimum(qs, rs)
    hang3 = np.minimum(qlen - qe, rl - re_)
    geom = ((qe - qs) >= (qe - qs + hang5 + hang3) * fopt["min_ratio"]) \
        & (hang5 <= fopt["max_overhang"]) & (hang3 <= fopt["max_overhang"])
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
            continue  # C skips all j-increments when [st] saturated
        idx = regs[i]["idx"]
        if len(idx) < 2:
            continue
        walk = idx[-2::-1] if rev[i] else idx[1:]
        xs = _forward_qpos(qlen, ax[walk], ay[walk])
        js = np.searchsorted(mp_pos, xs)
        # all chained anchors' positions exist in mini_pos; guard anyway
        js = js[(js < n) & (mp_pos[np.clip(js, 0, n - 1)] == xs)]
        state.m_cnts[js] += 1  # uint16 wraparound as in the C
    return cv


def filter_redundant_coords(state, cv, min_cov):
    """Interval compression per lqmap.c:25-100 (uint32 wraparound
    semantics of the original are preserved)."""
    if not cv:
        return
    vc = []
    for s, e in cv:
        vc.append(np.uint32(s))
        vc.append(np.uint32(e))
    vc.sort()
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
                mlen = np.uint32(v32 >> 3) - med_start  # wraps as in C
            if int(mlen) > 0:
                mcoords.append((int(med_start), v32))
                marker_s = int(med_start) | 0x4
                marker_e = v32 | 0x4
                state.coords.append((marker_s, marker_e))
    for s, e in cv:
        if s & 4:
            keep = True
        else:
            keep = True
            for ms, me in mcoords:
                if s >= ms and e <= me:
                    keep = False
                    break
        if keep:
            state.coords.append((s, e))


def sweep_events(vc, min_cov):
    """Reliable-region sweep (lqutils.c:83-155) over an already-sorted
    flat list of tagged endpoint values (pairing is irrelevant to the
    sweep; the device engine stores events flat)."""
    regions, mregions = [], []
    cov = med_cov = 0
    start = med_start = 0
    for val in vc:
        old_cov = cov
        old_med = med_cov
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


# ---------------------------------------------------------------------------
# the run


def format_f3(x):
    return "%.3f" % x


def iter_index_parts(target_iter, batch_size, mini_batch_size=50_000_000):
    """Group a target read stream into index parts (-I semantics).

    Two-level grouping per the reference reader (index.c:240-252,
    bseq.c:68-88): reads accumulate into mini-batches that close once
    their size reaches min(mini_batch_size, batch_size) (the crossing
    read included); a part closes before accepting another mini-batch
    when its total strictly exceeds batch_size.
    """
    mbs = min(mini_batch_size, batch_size)
    part, part_bp = [], 0
    mini, mini_bp = [], 0
    for r in target_iter:
        mini.append(r)
        mini_bp += len(r[1])
        if mini_bp >= mbs:
            if part and part_bp > batch_size:
                yield part
                part, part_bp = [], 0
            part.extend(mini)
            part_bp += mini_bp
            mini, mini_bp = [], 0
    if mini:
        if part and part_bp > batch_size:
            yield part
            part, part_bp = [], 0
        part.extend(mini)
    if part:
        yield part


def overlap_run(target_iter, query_reads, cfg: OverlapConfig,
                chain_many=None, parts=None, index_cache=None,
                return_states=False, device="cuda", progress=None,
                stats=None):
    """Full engine run -> list of 9-column TSV row strings
    (cf. minimap2-coverage.c:545-617).

    target_iter: iterable of [name, seq, qual] — consumed once,
    streamed part by part (bounded memory).
    chain_many: optional callable([(ax, ay), ...], map_opt) -> list of
    chain lists; default runs the exact host chain DP per query. The
    batched-chainer path (engine/overlap.DeviceChainer) passes B2 here.
    parts: optional pre-grouped list of part read-lists (overrides
    target_iter streaming; the -d prefetch path).
    index_cache: optional path prefix for per-part MinimizerIndex npz
    persistence (the -d tempdb equivalent, longQC.py:266-277): part i
    loads from `{index_cache}.part{i:04d}.npz` when present, else builds
    and saves.
    return_states: also return the per-read ReadStates and the query
    sketches (overlap_run_with_states).
    device: where the tensor sketch runs (the rest is host numpy); the
    card unless the caller asks for the CPU.
    progress: called with the query index once per query and part.
    stats: optional dict that receives the run's spans (tracing): called
    directly, under its own top-level span `overlap_host`.
    """
    with tracing.run(stats, "overlap_host"):
        return _overlap_run(target_iter, query_reads, cfg, chain_many,
                            parts, index_cache, return_states, device,
                            progress)


def _overlap_run(target_iter, query_reads, cfg, chain_many, parts,
                 index_cache, return_states, device, progress):
    k, w = cfg.index.k, cfg.index.w
    hpc = cfg.index.is_hpc
    q_sketches = _sketch_reads(query_reads, k, w, hpc, device)
    states = [ReadState(len(s[0])) for s in q_sketches]
    m = cfg.map

    if chain_many is None:
        def chain_many(anchor_sets, m):
            return [chain_dp(ax, ay, m.max_gap, m.bw, m.max_chain_skip,
                             m.min_cnt, m.min_chain_score)
                    for ax, ay in anchor_sets]

    group_size = 128
    part_iter = (iter(parts) if parts is not None
                 else iter_index_parts(target_iter, cfg.index.batch_size))
    for part_i, part in enumerate(part_iter):
        cache_path = ("%s.part%04d.npz" % (index_cache, part_i)
                      if index_cache else None)
        if cache_path and os.path.exists(cache_path):
            index = MinimizerIndex.load(cache_path)
        else:
            index = build_index(part, k, w, is_hpc=hpc, device=device)
            if cache_path:
                index.save(cache_path)
        mid_occ = m.mid_occ or index.mid_occ(m.mid_occ_frac)
        fopt = {
            "seq_lens": index.seq_lens,
            "min_ratio": cfg.flt.min_ratio,
            "max_overhang": cfg.flt.max_overhang,
        }
        for g0 in range(0, len(query_reads), group_size):
            group = range(g0, min(g0 + group_size, len(query_reads)))
            anchor_sets, mini_list = [], []
            for qi in group:
                q = query_reads[qi]
                ax, ay, mini_pos = collect_seed_hits(
                    index, q[0], len(q[1]), q_sketches[qi], mid_occ,
                    no_self=True, ava=cfg.ava)
                anchor_sets.append((ax, ay))
                mini_list.append(mini_pos)
            chains_list = chain_many(anchor_sets, m)
            for gi, qi in enumerate(group):
                qlen = len(query_reads[qi][1])
                ax, ay = anchor_sets[gi]
                regs = [chain_to_reg(ax, ay, qlen, sc, idx)
                        for sc, idx in chains_list[gi]]
                cv = lq_cnt_match(states[qi], qlen, regs, ax, ay,
                                  mini_list[gi], m.min_score_med,
                                  m.min_score_good, fopt, covt=cfg.covt)
                filter_redundant_coords(states[qi], cv,
                                        cfg.flt.min_coverage)
                if progress:
                    progress(qi)

    # final per-read rows (minimap2-coverage.c:545-617)
    rows = []
    for qi, q in enumerate(query_reads):
        st = states[qi]
        mv_n = len(st.m_cnts)
        if mv_n > 0:
            # uint32 accumulation with wraparound, then integer division
            # (minimap2-coverage.c:553-558)
            ssum = int(st.m_cnts.astype(np.uint64).sum() % (1 << 32)) // mv_n
            n_match = int((st.m_cnts > ssum).sum())
        else:
            n_match = 0
        div = div_score(mv_n, n_match, st.avg_k)
        vc = []
        for s, e in st.coords:
            vc.append(int(np.uint32(s)))
            vc.append(int(np.uint32(e)))
        vc.sort()
        rows.append(emit_row(q[0], len(q[1]), q[2], st.lam, st.lam2, div,
                             vc, cfg.flt.min_coverage, cfg.filter_mode))
    if return_states:
        return rows, states, q_sketches
    return rows


def overlap_run_with_states(target_iter, query_reads, cfg, **kw):
    """overlap_run returning (rows, per-read ReadStates, query sketches)
    — the -z minimizer-count mode needs the m_cnts state
    (minimap2-coverage.c:478-543)."""
    return overlap_run(target_iter, query_reads, cfg, return_states=True,
                       **kw)


def div_score(mv_n, n_match, avg_k):
    """Per-read divergence (minimap2-coverage.c:553-563): the
    logf(float/float)/float chain evaluated in f32, as in the C."""
    if mv_n > 0 and n_match > 0:
        r = np.float32(mv_n) / np.float32(n_match)
        return float(np.float32(np.log(r)) / np.float32(avg_k))
    return 1.0


def emit_row(qname, qlen, qqual, lam, lam2, div, events_sorted, min_cov,
             filter_mode):
    """One 9-column TSV row (minimap2-coverage.c:587-617) from the
    per-read accumulators and the sorted flat endpoint events."""
    regions, mregions = sweep_events(events_sorted, min_cov)
    meanq = mean_q_host(qqual) if qqual else 0.0
    if regions:
        tot = sum(e - s for s, e in regions)
        coords_s = ",".join("%d-%d" % (s, e) for s, e in regions)
        mcoords_s = (",".join("%d-%d" % (s, e) for s, e in mregions)
                     if mregions else "0")
        if filter_mode:
            c5 = tot / qlen
            c8 = "0.0"
        else:
            c5 = lam / tot
            c8 = format_f3(lam2 / tot)
        return "%s\t%d\t%d\t%s\t%s\t%s\t%s\t%s\t%s" % (
            qname, qlen, lam, coords_s, mcoords_s,
            format_f3(c5), format_f3(meanq), format_f3(div), c8)
    return "%s\t%d\t%d\t0\t0\t0.0\t%s\t%s\t0.0" % (
        qname, qlen, lam, format_f3(meanq), format_f3(div))


def aggregate_minimizer_counts(q_sketches, states):
    """-z minimizer-count aggregation (minimap2-coverage.c:478-543):
    per-minimizer match counts summed over all queries, keyed by
    minimizer hash; -> the totals sorted descending (what the reference
    computes in its paper-revision debug mode)."""
    totals = {}
    for sk, st in zip(q_sketches, states):
        h = np.asarray(sk[0], np.uint64)
        for hh, c in zip(h.tolist(), st.m_cnts.tolist()):
            totals[hh] = totals.get(hh, 0) + int(c)
    return np.sort(np.array(list(totals.values()), np.int64))[::-1]
