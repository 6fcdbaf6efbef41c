"""The schedule of B5's one-warp body (csrc/extend.cu, W <= 63), replayed
on the CPU.

A numpy port of the kernel's order, vectorised over pairs and lanes:
anti-diagonal d = qi + j by anti-diagonal; column j in slot j mod S
(S = 32 x columns per lane, lane = slot / columns per lane); the left
cell (qi, j-1) and the diagonal cell (qi-1, j-1) from the neighbour slot
of the last two anti-diagonals (the diagonal is the left value the slot
took one step before); the vertical F chain per gap family seeded with
the top-boundary term when a column starts; the query code handed from
a lane's column to its next column one step later; a column retired at
d = 2j + W into the pair's maxima and Z-drop; a drop ending the walk.
The replay must equal the plain version (ops/extend.extz_batch_plain)
and the JAX Pallas kernel in interpret mode in all eight outputs
(tolerance 0: integer scores, coordinates and flags; the Pallas kernel
walks the target width rounded up to its 4-column step, so it is held
against the replay on targets padded with code 4 to that width, which
differs from the plain version only for a pair with tl > Lt), and hold the
schedule's invariants: every live column in exactly one slot, a slot
reused only after its column retired, one column retired every two
anti-diagonals from d = W on, the piped query codes equal to direct
loads.

Why the recursive F equals the plain scan: the plain scan starts from
NEG = -2^30 and adds ge*r, the recursion walks down from its seed by
ge a row. They differ only on terms that come from NEG (rows above the
query start, or the row before the band), and each of those is at most
NEG - go - ge. On a cell that holds a query index the top-boundary term
F_bnd = -bndcost(j+1) - go - (qi+1)*ge is larger whenever
bndcost(j+1) + go + (qi+1)*ge < 2^30 (lengths up to ~10^8 at the
default gaps), so both give max(scan over real rows, F_bnd); the
recursion is seeded with exactly that term.

The wide body (W >= 64) has its own replay, `strip_replay`: the same
anti-diagonal cells walked by G warps (as the kernel's wrapper picks G
for the inputs: 1, 2, 4 or 8) in strips of 64 G target columns (lane
c / 2 of the G x 32, register c % 2 for the strip's column c), each
strip from the first valid cell of its first column to the last of its
last, with one step before it that gives the first column its
diagonal; the strip's left edge read from a boundary column (band row
qi - (j0 - 1) + W_b of column j0 - 1) in batches of 32 rows, one a
lane, a batch ahead; that column rewritten in place by the strip's last
column at its valid rows; the columns retired in ascending j after the
strip's last step; a drop ending the walk. It must equal the plain
version on every case and the JAX lax.scan formulation
(longqc_tpu/ops/extend.extz_batch) on one case per W, in all eight
outputs (tolerance 0), and hold the invariants: every valid cell of a
strip's columns computed exactly once, every boundary row that the
next strip reads written by the strip before it and read before it is
overwritten, the last column writing exactly its valid rows, the
columns retired in ascending j, each once."""

import numpy as np
import pytest
import torch
from torch_util import ext_edge_pairs, ext_strip_pairs

from longqc_tpu.ops.extend import extz_batch as jax_extz_batch
from longqc_tpu.ops.extend_pallas import extz_batch_pallas
from longqc_tpu_torch.ops import extend as ext
from longqc_tpu_torch.ops import extend_cuda

NEG = ext.NEG_INF
GAPS = {"extz": {}, "extd": {"gapo2": 24, "gape2": 1}}


def _bndcost(l, go, ge, go2, ge2):  # noqa: E741
    b = go + l * ge
    return b if go2 is None else np.minimum(b, go2 + l * ge2)


def wavefront_replay(qs, qlens, ts, tlens, *, W, match=2, mismatch=-4,
                     gapo=4, gape=2, gapo2=None, gape2=None, zdrop=400):
    """lq_extend_kernel's schedule on (B, Lq) / (B, Lt) codes ->
    (dict of the eight outputs under ext.KEYS, steps walked per pair)."""
    i32 = np.int32
    qs, ts = np.asarray(qs, i32), np.asarray(ts, i32)
    B, Lq = qs.shape
    Lt = ts.shape[1]
    dual = gapo2 is not None
    go2 = gapo2 if dual else 0
    ge2 = gape2 if dual else 0
    CPL = 1 if W <= 31 else 2
    S = 32 * CPL
    assert 0 < W <= 63 and S >= W + 1

    def bnd(l):  # noqa: E741
        return i32(_bndcost(np.asarray(l, np.int64), gapo, gape,
                            gapo2, gape2))

    ql = np.asarray(qlens, i32)
    tl = np.asarray(tlens, i32)
    ncol = np.minimum(tl, Lt)
    qlim = np.clip(np.minimum(ql, Lq), 0, None)
    # the step at which the last column retires (no walk without one)
    dend = np.where(ncol > 0, 2 * (ncol - 1) + W, -1)
    slot = (np.arange(32)[:, None] * CPL + np.arange(CPL)[None, :])
    shape = (B, 32, CPL)

    def full(v):
        return np.full(shape, v, i32)

    j, tx, qhi = full(0), full(-2), full(0)
    fp, fp2, cm, cq, hlast = full(0), full(0), full(NEG), full(0), full(NEG)
    H, E, E2, hlp, code = full(NEG), full(NEG), full(NEG), full(NEG), full(4)
    best = np.zeros(B, i32)
    bq, bt = np.full(B, -1, i32), np.full(B, -1, i32)
    mqe, mqet = np.full(B, NEG, i32), np.full(B, -1, i32)
    mte, mteq = np.full(B, NEG, i32), np.full(B, -1, i32)
    dropped = np.zeros(B, bool)
    retired = [[] for _ in range(B)]

    def init_col(sel, js, d):
        """Column js (array broadcast to shape) starts at step d where
        sel holds (its first band row is query index d - js)."""
        js = np.broadcast_to(js, shape)
        live = (js >= 0) & (js < ncol[:, None, None])
        tc = np.take_along_axis(
            np.broadcast_to(ts, (B, Lt)),
            np.clip(js, 0, Lt - 1).reshape(B, -1), 1).reshape(shape)
        tc = np.where(live, tc, 4)
        top = np.minimum(ql[:, None, None], js + W + 1)
        hb = -bnd(js + 1)
        j[sel] = js[sel]
        tx[sel] = np.where(tc < 4, tc, -2)[sel]
        qhi[sel] = np.where(live, np.maximum(top, 0), 0)[sel]
        fp[sel] = (hb - gapo - (d - js) * gape)[sel]
        fp2[sel] = (hb - go2 - (d - js) * ge2)[sel]
        cm[sel] = NEG        # cq and hlast: set by the column's valid cells

    # columns with 2j - W < 0 are under way at d = 0 (their cells so far
    # lie above the query); every other slot holds column slot - S
    early = np.broadcast_to(2 * slot - W < 0, shape)
    init_col(early, np.where(2 * slot - W < 0, slot, slot - S)[None], 0)
    init_col(~early, (slot - S)[None], 0)

    def left(x):
        """Slot s - 1's value: register c - 1, or lane - 1's last."""
        y = np.empty_like(x)
        y[:, :, 1:] = x[:, :, :-1]
        y[:, :, 0] = np.roll(x[:, :, CPL - 1], 1, axis=1)
        return y

    def load(qi):
        ok = (qi >= 0) & (qi < qlim.reshape((B,) + (1,) * (qi.ndim - 1)))
        idx = np.clip(qi, 0, Lq - 1).reshape(B, -1)
        got = np.take_along_axis(qs, idx, 1).reshape(qi.shape)
        return np.where(ok, got, 4)

    steps = np.zeros(B, np.int64)
    d = 0
    while True:
        act = (d <= dend) & ~dropped
        if not act.any():
            break
        steps += act
        a3 = act[:, None, None]
        bnd_phase = d <= W
        if (d + W) % 2 == 0:
            js = (d + W) // 2
            s = js % S
            sel = np.zeros(shape, bool)
            sel[:, s // CPL, s % CPL] = act
            # the slot's previous column has retired (S >= W + 1)
            assert (2 * j[sel] + W < d).all()
            init_col(sel, js, d)
        # every live column sits in exactly one slot
        lo, hi = -((W - d) // 2), (d + W) // 2
        for b in np.flatnonzero(act):
            live = sorted(x for x in j[b].ravel().tolist()
                          if 2 * x - W <= d <= 2 * x + W and x >= 0)
            assert live == list(range(max(lo, 0), hi + 1)), (d, b)

        # neighbours of step d - 1 (left) and d - 2 (diagonal)
        HL, EL, E2L = left(H), left(E), left(E2)
        HD = hlp.copy()
        nhlp = HL.copy()
        # query codes: register 0 loads, register c takes c - 1's of the
        # step before
        ncode = code.copy()
        ncode[:, :, 1:] = code[:, :, :-1]
        ncode[:, :, 0] = load(d - j[:, :, 0])
        qi = d - j
        ok = (qi >= 0) & (qi < qhi)
        assert (ncode[ok & a3] == load(qi)[ok & a3]).all()
        if bnd_phase:
            c0 = j == 0
            HL = np.where(c0, -bnd(qi + 1), HL)
            HD = np.where(c0, np.where(qi == 0, 0, -bnd(qi)),
                          np.where(qi == 0, -bnd(j), HD))
        sc = np.where(ncode == tx, match, mismatch).astype(i32)
        e = np.maximum(EL, HL - gapo) - gape
        bs = np.maximum(HD + sc, e)
        e2 = np.full(shape, NEG, i32)
        if dual:
            e2 = np.maximum(E2L, HL - gapo2) - gape2
            bs = np.maximum(bs, e2)
        if bnd_phase:
            bs = np.where(ok, bs, NEG)
        f = fp - gape
        h = np.maximum(bs, f)
        nfp = np.maximum(f, bs - gapo)
        nfp2 = fp2
        if dual:
            f2 = fp2 - gape2
            h = np.maximum(h, f2)
            nfp2 = np.maximum(f2, bs - gapo2)
        nH = np.where(ok, h, NEG)
        up = nH > cm
        for arr, new in ((H, nH), (E, np.where(ok, e, NEG)),
                         (E2, np.where(ok, e2, NEG)), (hlp, nhlp),
                         (code, ncode), (fp, nfp), (fp2, nfp2),
                         (cq, np.where(up, qi, cq)),
                         (cm, np.where(up, nH, cm)),
                         (hlast, np.where(ok, h, hlast))):
            arr[...] = np.where(a3, new, arr)

        if d >= W and (d - W) % 2 == 0:
            jr = (d - W) // 2
            s = jr % S
            lane, c = s // CPL, s % CPL
            assert (j[act, lane, c] == jr).all()
            colb, colq = cm[:, lane, c], cq[:, lane, c]
            for b in np.flatnonzero(act):
                retired[b].append(d)
                if colb[b] > best[b]:
                    best[b], bq[b], bt[b] = colb[b], colq[b], jr
                if ql[b] >= 1 and abs(int(ql[b]) - 1 - jr) <= W:
                    qe = hlast[b, lane, c]
                    if qe > mqe[b]:
                        mqe[b], mqet[b] = qe, jr
                if jr == tl[b] - 1 and colb[b] > mte[b]:
                    mte[b], mteq[b] = colb[b], colq[b]
                if int(best[b]) - int(colb[b]) > zdrop:
                    dropped[b] = True
        d += 1

    for b in range(B):
        # one column retires every two anti-diagonals from d = W on
        r = retired[b]
        assert r == list(range(W, W + 2 * len(r), 2))
        assert len(r) == ncol[b] or (dropped[b] and len(r) < ncol[b])
    out = dict(zip(ext.KEYS, (best, bq, bt, mqe, mqet, mte, mteq,
                              dropped)))
    return out, steps


def _pad4(ts):
    """Target codes padded with code 4 to a multiple of 4 columns."""
    pad = -ts.shape[1] % 4
    return np.concatenate([ts, np.full((len(ts), pad), 4, ts.dtype)], 1)


@pytest.mark.parametrize("zdrop", [100, 400])
@pytest.mark.parametrize("W", [1, 15, 16, 31, 32, 63])
@pytest.mark.parametrize("mode", ["extz", "extd"])
def test_wavefront_replay_matches_plain_and_pallas(mode, W, zdrop):
    rng = np.random.RandomState(1000 + W + zdrop + len(mode))
    qs, qlens, ts, tlens = ext_edge_pairs(rng)
    gap = GAPS[mode]
    got, steps = wavefront_replay(qs, qlens, ts, tlens, W=W, zdrop=zdrop,
                                  **gap)
    plain = ext.extz_batch_plain(
        *(torch.from_numpy(a) for a in (qs, qlens, ts, tlens)), W=W,
        zdrop=zdrop, **gap)
    for key in ext.KEYS:
        np.testing.assert_array_equal(got[key], plain[key].numpy(),
                                      err_msg=key)
    # the Pallas kernel walks Lt rounded up to its 4-column step, so a
    # pair with tl > Lt (pair 18) sees the padding columns (code 4) too:
    # it equals the replay on the target padded to that width
    pal = extz_batch_pallas(qs, qlens, ts, tlens, W=W, zdrop=zdrop,
                            interpret=True, **gap)
    got4, _ = wavefront_replay(qs, qlens, _pad4(ts), tlens, W=W,
                               zdrop=zdrop, **gap)
    for key in ext.KEYS:
        np.testing.assert_array_equal(got4[key], np.asarray(pal[key]),
                                      err_msg=key)
    # the walk: no step for tl = 0; W + 1 steps for ql = 0, dropped at
    # its first column (no cell holds a query index); ql << tl dropped at
    # its first column past the query, ql + W; the unrelated pairs
    # Z-dropped at zdrop = 100; some pairs run to their end
    assert steps[15] == 0 and not got["zdropped"][15]
    assert steps[14] == W + 1 and got["zdropped"][14]
    assert got["zdropped"][21] and got["max_t"][21] < qlens[21] + W
    assert steps[21] <= 2 * (qlens[21] + W) + W + 1
    if zdrop == 400:
        assert steps[21] == 2 * (qlens[21] + W) + W + 1
    if zdrop == 100:
        assert got["zdropped"][22] and got["zdropped"][23]
    assert not got["zdropped"].all()


def strip_replay(qs, qlens, ts, tlens, *, W, G=1, match=2, mismatch=-4,
                 gapo=4, gape=2, gapo2=None, gape2=None, zdrop=400):
    """lq_extend_wide_kernel's schedule with G warps a pair on (B, Lq) /
    (B, Lt) codes -> (dict of the eight outputs under ext.KEYS, steps
    walked per pair, columns retired per pair). The G warps are one
    row of 32 G lanes: warp w's lane 0 takes its left cell from warp
    w - 1's lane 31 one step before, as lane l from lane l - 1."""
    i32 = np.int32
    qs, ts = np.asarray(qs, i32), np.asarray(ts, i32)
    B, Lq = qs.shape
    Lt = ts.shape[1]
    S = 64 * G
    dual = gapo2 is not None
    go2 = gapo2 if dual else 0
    ge2 = gape2 if dual else 0
    assert W >= 64

    def bnd(l):  # noqa: E741
        return i32(_bndcost(np.asarray(l, np.int64), gapo, gape,
                            gapo2, gape2))

    ql = np.asarray(qlens, i32)
    tl = np.asarray(tlens, i32)
    ncol = np.minimum(tl, Lt)
    qlim = np.clip(np.minimum(ql, Lq), 0, None)
    Wb = np.clip(np.minimum(W, np.maximum(ql, ncol)), 0, None).astype(i32)
    lanes = np.arange(32)
    slot = np.arange(32 * G)[:, None] * 2 + np.arange(2)[None, :]
    shape = (B, 32 * G, 2)
    col = (slice(None), None, None)
    pairs = np.arange(B)

    def full(v):
        return np.full(shape, v, i32)

    def qlo_of(j, wb):
        return np.maximum(0, j - wb)

    def qhi_of(j, q, wb):
        return np.minimum(q - 1, j + wb)

    ld = 2 * int(Wb.max()) + 1
    buf = np.zeros((3, B, ld), i32)
    wstrip = np.full((B, ld), -9)
    rdone = np.zeros((B, ld), bool)

    fp, fp2, cm, cq, hlast = full(0), full(0), full(NEG), full(0), full(NEG)
    H, E, E2, hlp, code = full(NEG), full(NEG), full(NEG), full(NEG), full(4)
    best = np.zeros(B, i32)
    bq, bt = np.full(B, -1, i32), np.full(B, -1, i32)
    mqe, mqet = np.full(B, NEG, i32), np.full(B, -1, i32)
    mte, mteq = np.full(B, NEG, i32), np.full(B, -1, i32)
    dropped = np.zeros(B, bool)
    retired = [[] for _ in range(B)]
    steps = np.zeros(B, np.int64)
    nstrip = (ncol + S - 1) // S

    def qload(qi):
        ok = (qi >= 0) & (qi < qlim.reshape((B,) + (1,) * (qi.ndim - 1)))
        idx = np.clip(qi, 0, Lq - 1).reshape(B, -1)
        got = np.take_along_axis(qs, idx, 1).reshape(qi.shape)
        return np.where(ok, got, 4)

    def left(x, e):
        y = np.empty_like(x)
        y[:, :, 1] = x[:, :, 0]
        y[:, 1:, 0] = x[:, :-1, 1]
        y[:, 0, 0] = e
        return y

    for k in range(int(nstrip.max()) if B else 0):
        on = (k < nstrip) & ~dropped
        if not on.any():
            break
        j0 = k * S
        j = np.broadcast_to(j0 + slot, shape)
        live = j < ncol[col]
        qlo = qlo_of(j, Wb[col])
        nr = np.where(live, np.maximum(0, qhi_of(j, ql[col], Wb[col]) - qlo
                                       + 1), 0)
        tc = np.take_along_axis(ts, np.clip(j, 0, Lt - 1).reshape(B, -1),
                                1).reshape(shape)
        tx = np.where(live & (tc < 4), tc, -2)
        jl = np.minimum(j0 + S, ncol) - 1
        lo0 = qlo_of(j0, Wb)
        dfirst = j0 + lo0
        dlast = jl + qhi_of(jl, ql, Wb)
        nsteps = np.where(on, dlast - dfirst + 2, 0)
        qi0 = dfirst[col] - 1 - j
        hb = -bnd(j + 1)
        fp[...] = hb - gapo - qi0 * gape
        fp2[...] = hb - go2 - qi0 * ge2
        cm[...] = NEG
        H[...] = NEG
        E[...] = NEG
        E2[...] = NEG
        jb = j0 - 1
        lob = qlo_of(jb, Wb)
        nrb = np.maximum(0, qhi_of(jb, ql, Wb) - lob + 1)

        def batch(base, sel):
            r = base[:, None] + lanes[None, :]
            if k == 0:
                h = np.where(r == -1, 0, -bnd(r + 1))
                n = np.full(r.shape, NEG, i32)
                return np.stack([h, n, n]).astype(i32)
            rel = r - lob[:, None]
            ok = (rel >= 0) & (rel < nrb[:, None]) & sel[:, None]
            idx = np.clip(r - jb + Wb[:, None], 0, ld - 1)
            bi = np.broadcast_to(pairs[:, None], r.shape)
            assert (wstrip[bi[ok], idx[ok]] == k - 1).all()
            rdone[bi[ok], idx[ok]] = True
            return np.where(ok[None], buf[:, bi, idx], NEG).astype(i32)

        qb = lo0 - 1
        cur, nxt = batch(qb, on), batch(qb + 32, on)
        cells = np.zeros(shape, np.int64)
        wrote = [[] for _ in range(B)]
        wr = on & (j0 + S < ncol)
        for t in range(int(nsteps.max())):
            act = t < nsteps
            a3 = act[col]
            steps += act
            d = dfirst - 1 + t
            off = d - j0 - qb
            ref = act & (off == 32)
            if ref.any():
                cur = np.where(ref[None, :, None], nxt, cur)
                qb = np.where(ref, qb + 32, qb)
                nxt = np.where(ref[None, :, None], batch(qb + 32, ref), nxt)
                off = d - j0 - qb
            assert ((off[act] >= 0) & (off[act] < 32)).all()
            edge = cur[:, pairs, np.clip(off, 0, 31)]
            HL, EL, E2L = left(H, edge[0]), left(E, edge[1]), left(E2, edge[2])
            HD = hlp.copy()
            nhlp = HL.copy()
            ncode = code.copy()
            ncode[:, :, 1] = code[:, :, 0]
            ncode[:, :, 0] = qload(d[:, None] - j[:, :, 0])
            qi = d[col] - j
            ok = ((qi - qlo) >= 0) & ((qi - qlo) < nr)
            assert (ncode[ok & a3] == qload(qi)[ok & a3]).all()
            bst = (lo0 == 0) & (d <= j0 + S - 1)
            HD = np.where(bst[col] & (qi == 0) & (j != 0), -bnd(j), HD)
            sc = np.where(ncode == tx, match, mismatch).astype(i32)
            e = np.maximum(EL, HL - gapo) - gape
            bs = np.maximum(HD + sc, e)
            e2 = np.full(shape, NEG, i32)
            if dual:
                e2 = np.maximum(E2L, HL - gapo2) - gape2
                bs = np.maximum(bs, e2)
            bs = np.where(ok, bs, NEG)
            f = fp - gape
            h = np.maximum(bs, f)
            nfp = np.maximum(f, bs - gapo)
            nfp2 = fp2
            if dual:
                f2 = fp2 - gape2
                h = np.maximum(h, f2)
                nfp2 = np.maximum(f2, bs - gapo2)
            nH = np.where(ok, h, NEG)
            up = nH > cm
            cells += ok & a3
            for arr, new in ((H, nH), (E, np.where(ok, e, NEG)),
                             (E2, np.where(ok, e2, NEG)), (hlp, nhlp),
                             (code, ncode), (fp, nfp), (fp2, nfp2),
                             (cq, np.where(up, qi, cq)),
                             (cm, np.where(up, nH, cm)),
                             (hlast, np.where(ok, h, hlast))):
                arr[...] = np.where(a3, new, arr)
            for b in np.flatnonzero(act & wr & ok[:, -1, 1]):
                r = int(qi[b, -1, 1])
                idx = r - (j0 + S - 1) + int(Wb[b])
                assert 0 <= idx < 2 * Wb[b] + 1
                assert wstrip[b, idx] != k - 1 or rdone[b, idx], (b, r)
                buf[:, b, idx] = H[b, -1, 1], E[b, -1, 1], E2[b, -1, 1]
                wstrip[b, idx], rdone[b, idx] = k, False
                wrote[b].append(r)

        assert (cells == nr * on[col]).all()
        for b in np.flatnonzero(wr):
            jw = j0 + S - 1
            lo = qlo_of(jw, Wb[b])
            assert wrote[b] == list(range(lo, qhi_of(jw, ql[b], Wb[b]) + 1))
        for b in np.flatnonzero(on):
            for s in range(int(jl[b]) - j0 + 1):
                lane, c = s // 2, s % 2
                jr = j0 + s
                colb, colq = cm[b, lane, c], cq[b, lane, c]
                retired[b].append(jr)
                if colb > best[b]:
                    best[b], bq[b], bt[b] = colb, colq, jr
                if ql[b] >= 1 and abs(int(ql[b]) - 1 - jr) <= Wb[b]:
                    if hlast[b, lane, c] > mqe[b]:
                        mqe[b], mqet[b] = hlast[b, lane, c], jr
                if jr == tl[b] - 1 and colb > mte[b]:
                    mte[b], mteq[b] = colb, colq
                if int(best[b]) - int(colb) > zdrop:
                    dropped[b] = True
                    break

    for b in range(B):
        r = retired[b]
        assert r == list(range(len(r)))
        assert len(r) == ncol[b] or (dropped[b] and len(r) < ncol[b])
    out = dict(zip(ext.KEYS, (best, bq, bt, mqe, mqet, mte, mteq,
                              dropped)))
    return out, steps, [len(r) for r in retired]


@pytest.mark.parametrize("zdrop", [100, 400])
@pytest.mark.parametrize("W", [64, 65, 127, 128, 255, 1000])
@pytest.mark.parametrize("mode", ["extz", "extd"])
def test_strip_replay_matches_plain_and_jax(mode, W, zdrop):
    """W = 1000 lies past every pair, so each pair's band is clamped to
    max(qlen, columns); pairs of up to 600 bases from W = 255 on, 300
    below, several strips either way."""
    L = 600 if W >= 255 else 300
    rng = np.random.RandomState(2000 + W + zdrop + len(mode))
    qs, qlens, ts, tlens = ext_strip_pairs(rng, L, L - 10)
    gap = GAPS[mode]
    # the warps a pair that the kernel's wrapper gives these 28 pairs: 1
    # up to W = 127, 2 at 128 and 255, 8 at 1000
    Wa = min(W, max(int(qlens.max()), L - 10))
    G = extend_cuda.wide_warps(len(qlens), Wa)
    assert G == (1 if W < 128 else 2 if W < 1000 else 8)
    got, steps, ncols = strip_replay(qs, qlens, ts, tlens, W=W, G=G,
                                     zdrop=zdrop, **gap)
    plain = ext.extz_batch_plain(
        *(torch.from_numpy(a) for a in (qs, qlens, ts, tlens)), W=W,
        zdrop=zdrop, **gap)
    for key in ext.KEYS:
        np.testing.assert_array_equal(got[key], plain[key].numpy(),
                                      err_msg=key)
    # the lax.scan formulation on one case per W, extz and extd in turn
    if zdrop == 400 and mode == ("extz" if W % 2 == 0 else "extd"):
        want = jax_extz_batch(qs, qlens, ts, tlens, W=W, Lq=L, Lt=L - 10,
                              zdrop=zdrop, **gap)
        for key in ext.KEYS:
            np.testing.assert_array_equal(got[key], np.asarray(want[key]),
                                          err_msg=key)
    # no step for tl = 0; ql = 0 dropped at its first column; the pairs
    # of 64, 65 and 128 columns run to their end; the last pair drops in
    # its second strip at zdrop = 100
    assert steps[15] == 0 and ncols[15] == 0
    assert got["zdropped"][14] and ncols[14] == 1
    assert ncols[24:27] == [64, 65, 128]
    assert not got["zdropped"][24:27].any()
    if zdrop == 100:
        assert got["zdropped"][27] and 64 < ncols[27] <= 128
    assert not got["zdropped"].all()
