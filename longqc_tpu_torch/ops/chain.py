"""Chain-DP fill: the exact gap-penalty table and the plain batched fill.

Torch port of the parts of longqc_tpu/ops/chain.py the overlap engine
needs. `chain_dp_batch` is the plain version behind the B2 chain kernel
(ops/chain_cuda): a loop over anchors vectorised over (Q, J), with the
semantics of the TPU chain kernel (longqc_tpu/ops/chain_pallas): the
J-deep age-ordered predecessor ring, the two-pass max_skip cut, the
per-row flag (pass disagreement or ring truncation) and the resumable
carry. The gap cost `(int)(dd * .01 * avg_qspan) + (ilog2(dd) >> 1)`
(chain.c:67) is read from the f64-exact host table of the anchor's row
for every dd <= bw.
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


def make_carry(Q, J=64, device="cpu"):
    """Fresh ring carry: (7, Q, J) int32 rings in age order (x_hi, x_lo,
    q, span, f, v, p) and a (Q,) int32 flag."""
    ring = torch.zeros((7, Q, J), dtype=torch.int32, device=device)
    ring[0] = -1
    ring[6] = NEG
    return ring, torch.zeros(Q, dtype=torch.int32, device=device)


def chain_dp_batch(ax_hi, ax_lo, aq, aspan, n_anchors, pen_tab, carry, i0,
                   *, J=64, max_dist=10000, bw=500, max_skip=25):
    """Batched, resumable chain-DP fill (plain version).

    ax_hi (Q, A) int32 anchor x upper bits (rev<<24 | rid), ax_lo
    target positions, aq query positions, aspan spans, all row-sorted;
    n_anchors (Q,) total anchors per row; pen_tab (Q, bw+1) int32
    penalty per dd for each row, or (1, bw+1) for every row; carry
    from make_carry or a previous chunk; i0 absolute index of this
    chunk's first anchor. Returns (f, p, v) (Q, A) int32
    (p absolute predecessor index or -1), flags (Q,) bool and the carry
    for the next chunk. Outputs past n_anchors are f=0, p=-1, v=0."""
    Q, A = ax_hi.shape
    dev = ax_hi.device
    i64 = torch.int64
    ring, cflag = carry
    rxh, rxl, rq, rs, rf, rv, rp = [ring[c].to(i64) for c in range(7)]
    flag = cflag != 0
    ages = torch.arange(1, J + 1, dtype=i64, device=dev)[None, :]
    pen = pen_tab.to(i64).to(dev).expand(Q, -1)
    nb = n_anchors.to(i64)
    NEGt = torch.full((Q, J), NEG, dtype=i64, device=dev)
    neg1 = torch.full((Q, 1), NEG, dtype=i64, device=dev)
    f_out = torch.empty((Q, A), dtype=torch.int32, device=dev)
    p_out = torch.empty_like(f_out)
    v_out = torch.empty_like(f_out)
    cols = [t.to(i64) for t in (ax_hi, ax_lo, aq, aspan)]

    def push(r, val):
        return torch.cat([val[:, None], r[:, :-1]], dim=1)

    for li in range(A):
        i = int(i0) + li
        xh, xl, q, s = (c[:, li] for c in cols)
        row_on = i < nb
        exists = (i - ages) >= 0
        dr = xl[:, None] - rxl
        dr_ok = (xh[:, None] == rxh) & (dr >= 0) & (dr <= max_dist)
        dq = q[:, None] - rq
        valid = exists & dr_ok & (dr != 0) & (dq > 0) & (dq <= max_dist)
        dd = (dr - dq).abs()
        valid = valid & (dd <= bw)
        sc0 = torch.minimum(torch.minimum(dq, dr), s[:, None])
        sc = torch.where(valid, sc0 - torch.gather(pen, 1, dd.clamp(0, bw))
                         + rf, NEGt)

        # strict running max in visit (age) order, exclusive prefix
        inc = torch.cummax(sc, dim=1).values
        run_before = torch.maximum(torch.cat([neg1, inc[:, :-1]], dim=1),
                                   s[:, None])
        newmax = valid & (sc > run_before)

        tgt_age = i - rp
        rp_real = rp > NEG + J + 1

        def marks_from(src):
            ok = src & rp_real & (tgt_age >= 1) & (tgt_age <= J)
            m = torch.zeros((Q, J + 1), dtype=torch.bool, device=dev)
            m.scatter_(1, torch.where(ok, tgt_age - 1, J), True)
            return m[:, :J]

        def walk_cut(marks):
            skipev = valid & ~newmax & marks
            delta = torch.where(skipev, 1, torch.where(newmax, -1, 0))
            S = torch.cumsum(delta, dim=1)
            minS = torch.cummin(S, dim=1).values
            walk = S - torch.clamp(minS, max=0)
            brk = skipev & (walk > max_skip)
            return torch.where(brk, ages, J + 1).amin(dim=1)

        cut0 = walk_cut(marks_from(valid))
        cut1 = walk_cut(marks_from(valid & (ages < cut0[:, None])))
        disagree = cut0 != cut1

        nm_in = newmax & (ages <= cut1[:, None])
        p_age = torch.where(nm_in, ages, 0).amax(dim=1)
        has_pred = p_age > 0
        f_i = torch.where(has_pred, torch.where(nm_in, sc, NEGt).amax(dim=1),
                          s)
        p_abs = torch.where(has_pred, i - p_age, NEG)
        v_pred = torch.where(ages == p_age[:, None], rv, NEGt).amax(dim=1)
        v_i = torch.where(has_pred & (v_pred > f_i), v_pred, f_i)

        oldest_ok = exists[:, J - 1] & dr_ok[:, J - 1]
        trunc = (cut1 > J) & oldest_ok
        flag = flag | (row_on & (disagree | trunc))

        rxh, rxl, rq, rs = push(rxh, xh), push(rxl, xl), push(rq, q), \
            push(rs, s)
        rf, rv, rp = push(rf, f_i), push(rv, v_i), push(rp, p_abs)

        f_out[:, li] = torch.where(row_on, f_i, 0)
        p_out[:, li] = torch.where(row_on, p_abs.clamp(min=-1), -1)
        v_out[:, li] = torch.where(row_on, v_i, 0)

    ring_out = torch.stack([rxh, rxl, rq, rs, rf, rv, rp]).to(torch.int32)
    flag_out = flag.to(torch.int32)
    return f_out, p_out, v_out, flag, (ring_out, flag_out)
