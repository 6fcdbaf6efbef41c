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
recursion is seeded with exactly that term."""

import numpy as np
import pytest
import torch
from torch_util import ext_edge_pairs

from longqc_tpu.ops.extend_pallas import extz_batch_pallas
from longqc_tpu_torch.ops import extend as ext

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
