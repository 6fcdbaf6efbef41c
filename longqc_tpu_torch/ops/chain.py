"""Chain-DP fill: the exact gap-penalty table and the plain batched fill.

Torch port of the parts of longqc_tpu/ops/chain.py the overlap engine
needs. `chain_dp_batch` is the plain version behind the B2 chain kernel
(ops/chain_cuda): the reference fill (chain.c:41-80,
engine/overlap_host.chain_dp) over each anchor's whole admissible
window, with the max_skip cut, as a loop over anchors vectorised over
rows and window ages. Unlike the TPU chain kernel
(longqc_tpu/ops/chain_pallas), there is no ring depth J, no truncation
flag and no carry. The gap cost `(int)(dd * .01 * avg_qspan) +
(ilog2(dd) >> 1)` (chain.c:67) is read from the f64-exact host table of
the anchor's row for every dd <= bw.
"""

import numpy as np
import torch

NEG = -(10 ** 9)


def gap_penalty_table(avg_qspan, bw):
    """Host: per-query penalty[dd] for dd in [0, bw], f64-exact
    (chain.c:67)."""
    dd = np.arange(bw + 1, dtype=np.float64)
    lin = (dd * 0.01 * np.float64(np.float32(avg_qspan))).astype(np.int64)
    log_dd = np.zeros(bw + 1, dtype=np.int64)
    nz = np.arange(1, bw + 1)
    log_dd[1:] = np.floor(np.log2(nz)).astype(np.int64)
    return (lin + (log_dd >> 1)).astype(np.int32)


def window_depths(ax_hi, ax_lo, n_anchors, max_dist):
    """(Q, A) int64: for each anchor i < n_anchors of a row sorted by
    (x_hi, x_lo), the number of earlier anchors in its admissible
    window (same x_hi, 0 <= x_lo[i] - x_lo[j] <= max_dist); 0 past
    n_anchors. One searchsorted per row on the sorted keys."""
    Q, A = ax_hi.shape
    i64 = torch.int64
    idx = torch.arange(A, dtype=i64, device=ax_hi.device)[None, :]
    on = idx < n_anchors.to(i64)[:, None]
    hi = ax_hi.to(i64) << 32
    lo = ax_lo.to(i64)
    top = torch.iinfo(i64).max
    key = torch.where(on, hi + lo, top).contiguous()
    low = hi + (lo - max_dist).clamp(min=-(1 << 31))
    st = torch.searchsorted(key, torch.where(on, low, top).contiguous())
    return torch.where(on, idx - st, 0)


def piece_starts(ax_hi, n_anchors, P):
    """(Q, P + 1) int64: where each of the P pieces of the B2 kernel
    (csrc/chain.cu) starts on each row, then n_anchors. Rows sorted by
    ax_hi over their first n_anchors entries are cut at w * ceil(n / P),
    each cut moved forward to the next start of a run of one ax_hi (a
    segment), so piece w, [starts[w], starts[w + 1]), holds whole
    segments; empty pieces start where the next one does."""
    Q, A = ax_hi.shape
    i64 = torch.int64
    dev = ax_hi.device
    n = n_anchors.to(i64).clamp(0, A)[:, None]
    idx = torch.arange(A, dtype=i64, device=dev)[None, :]
    key = torch.where(idx < n, ax_hi.to(i64), 1 << 40).contiguous()
    cut = torch.minimum(torch.arange(P + 1, dtype=i64, device=dev)[None, :]
                        * ((n + P - 1) // P), n)
    prev = torch.gather(key, 1, (cut - 1).clamp(0, max(A - 1, 0))) \
        if A else cut
    ub = torch.searchsorted(key, prev.contiguous(), right=True) \
        if A else cut
    return torch.where(cut <= 0, 0, torch.where(cut >= n, n, ub))


def chain_dp_batch(ax_hi, ax_lo, aq, aspan, n_anchors, pen_tab, *,
                   max_dist=10000, bw=500, max_skip=25, return_scan=False):
    """Batched chain-DP fill over the whole admissible window (plain
    version).

    ax_hi (Q, A) int32 anchor x upper bits (rev<<24 | rid), ax_lo
    target positions, aq query positions, aspan spans, each row sorted
    by (ax_hi, ax_lo) over its first n_anchors entries; n_anchors (Q,);
    pen_tab (Q, bw+1) int32 penalty per dd for each row, or (1, bw+1)
    for every row. Returns (f, p, v) (Q, A) int32 (p the absolute
    predecessor index or -1), equal to the reference fill
    (engine/overlap_host.chain_dp). Outputs past n_anchors are f=0,
    p=-1, v=0.

    A loop over anchors vectorised over (Q, J), where J is the deepest
    admissible window of any anchor (window_depths): every predecessor
    of every anchor is scored, so the scan is exact and no deeper than
    the data forces. Marks of the max_skip walk come from every valid
    entry: a mark only targets an older entry, so marks from entries
    past the cut never reach the walk before it. return_scan: also
    return the (Q, A) int32 count of ages the reference visits per
    anchor (to its max_skip cut, else its whole window)."""
    Q, A = ax_hi.shape
    dev = ax_hi.device
    i64 = torch.int64
    nb = n_anchors.to(i64).clamp(max=A)
    J = max(int(window_depths(ax_hi, ax_lo, nb, max_dist).max()), 1) \
        if A else 1
    ages = torch.arange(1, J + 1, dtype=i64, device=dev)[None, :]
    pen = pen_tab.to(i64).to(dev).expand(Q, -1)
    NEGt = torch.full((Q, J), NEG, dtype=i64, device=dev)
    neg1 = torch.full((Q, 1), NEG, dtype=i64, device=dev)
    f_all = torch.zeros((Q, A), dtype=i64, device=dev)
    p_all = torch.full((Q, A), -1, dtype=i64, device=dev)
    v_all = torch.zeros((Q, A), dtype=i64, device=dev)
    cols = [t.to(i64) for t in (ax_hi, ax_lo, aq, aspan)]
    n_max = int(nb.max()) if Q else 0
    scan = torch.zeros((Q, A), dtype=i64, device=dev)

    for i in range(n_max):
        xh, xl, q, s = (c[:, i] for c in cols)
        row_on = i < nb
        jj = i - ages
        exists = jj >= 0
        jc = jj.clamp(min=0).expand(Q, J)

        def at(a):
            return torch.gather(a, 1, jc)

        dr = xl[:, None] - at(cols[1])
        in_win = exists & (xh[:, None] == at(cols[0])) & (dr >= 0) & \
            (dr <= max_dist)
        dq = q[:, None] - at(cols[2])
        valid = in_win & (dr != 0) & (dq > 0) & (dq <= max_dist)
        dd = (dr - dq).abs()
        valid = valid & (dd <= bw)
        sc0 = torch.minimum(torch.minimum(dq, dr), s[:, None])
        sc = torch.where(valid, sc0 - torch.gather(pen, 1, dd.clamp(0, bw))
                         + at(f_all), NEGt)

        # strict running max in visit (age) order, exclusive prefix
        inc = torch.cummax(sc, dim=1).values
        run_before = torch.maximum(torch.cat([neg1, inc[:, :-1]], dim=1),
                                   s[:, None])
        newmax = valid & (sc > run_before)

        # max_skip marks (t[p[j]] = i of every valid j) and the walk
        ep = at(p_all)
        tgt_age = i - ep
        ok = valid & (ep >= 0) & (tgt_age <= J)
        marks = torch.zeros((Q, J + 1), dtype=torch.bool, device=dev)
        marks.scatter_(1, torch.where(ok, tgt_age - 1, J), True)
        skipev = valid & ~newmax & marks[:, :J]
        delta = torch.where(skipev, 1, torch.where(newmax, -1, 0))
        S = torch.cumsum(delta, dim=1)
        minS = torch.cummin(S, dim=1).values
        walk = S - torch.clamp(minS, max=0)
        brk = skipev & (walk > max_skip)
        cut = torch.where(brk, ages, J + 1).amin(dim=1)
        if return_scan:
            depth = in_win.sum(dim=1)
            scan[:, i] = torch.where(row_on, torch.minimum(cut, depth), 0)

        nm_in = newmax & (ages <= cut[:, None])
        p_age = torch.where(nm_in, ages, 0).amax(dim=1)
        has_pred = p_age > 0
        f_i = torch.where(has_pred, torch.where(nm_in, sc, NEGt).amax(dim=1),
                          s)
        p_i = torch.where(has_pred, i - p_age, -1)
        v_pred = torch.gather(v_all, 1, p_i.clamp(min=0)[:, None])[:, 0]
        v_i = torch.where(has_pred & (v_pred > f_i), v_pred, f_i)

        f_all[:, i] = torch.where(row_on, f_i, 0)
        p_all[:, i] = torch.where(row_on, p_i, -1)
        v_all[:, i] = torch.where(row_on, v_i, 0)

    out = (f_all.to(torch.int32), p_all.to(torch.int32),
           v_all.to(torch.int32))
    return out + (scan.to(torch.int32),) if return_scan else out
