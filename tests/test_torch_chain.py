"""B2 plain version (ops/chain_cuda.chain_dp_fill on CPU tensors), which
scans each anchor's whole admissible window, against the JAX Pallas
chain kernel in interpret mode (J-deep ring) and the host specs: f, p, v
exactly on every row the Pallas kernel leaves unflagged; on the rows it
flags (ring truncation), the chains built from the port's f, p, v equal
the JAX package's overlap_host.chain_dp (k = 12, where its f32 gap cost
agrees with f64), and a window deeper than 256 ages gets the host
spec's f, p, v."""

import numpy as np
import pytest
import torch
from torch_util import np_, segment_rows, t32

from longqc_tpu.engine import overlap_host as joh
from longqc_tpu.ops.chain_pallas import (chain_dp_batch_pallas,
                                         make_carry_pallas, penalty_limbs)
from longqc_tpu_torch.engine import overlap_host as toh
from longqc_tpu_torch.ops.chain import (chain_dp_batch, gap_penalty_table,
                                        piece_starts, window_depths)
from longqc_tpu_torch.ops.chain_cuda import (PIECE_WARPS, WARPS_PER_SM,
                                             chain_dp_fill, pieces_per_row)

Q, BW, K, MAX_DIST, MAX_SKIP = 128, 500, 12, 10000, 25
MIN_CNT, MIN_SC = 3, 40


def _rows(rng, A, dense):
    axh = np.zeros((Q, A), np.int32)
    axl = np.zeros((Q, A), np.int32)
    aq = np.zeros((Q, A), np.int32)
    nb = np.zeros(Q, np.int32)
    for r in range(Q):
        if dense:
            # >J anchors inside max_dist with mostly invalid pairings:
            # the truncation regime of (AT)n reads (one row in four
            # shorter than any ring)
            n = rng.randint(20, 60) if r % 4 == 0 else \
                rng.randint(70, min(A, 200))
            pos = np.sort(rng.randint(0, 3000, n))
            q = rng.randint(0, 20000, n)
            d = rng.rand(n) < 0.2
            q[d] = np.clip(pos[d] + rng.randint(-50, 50, d.sum()), 0, None)
        else:
            n = rng.randint(40, A)
            grp = np.sort(rng.randint(0, rng.randint(1, 4), n))
            pos = np.sort(rng.randint(0, 20000, n))
            q = np.clip(pos - 5000 + rng.randint(0, 3, n)
                        * rng.randint(1, 400) + rng.randint(-40, 40, n),
                        0, None)
            axh[r, :n] = grp
        nb[r] = n
        axl[r, :n] = pos
        aq[r, :n] = q
    return axh, axl, aq, nb


def _jax(axh, axl, aq, nb, J):
    A = axh.shape[1]
    limbs = np.repeat(penalty_limbs(float(K), BW)[:, None], Q, axis=1)
    rbad = np.zeros((1, Q), np.int32)
    return chain_dp_batch_pallas(
        axh, axl, aq, np.full((Q, A), K, np.int32), nb, limbs, rbad,
        make_carry_pallas(Q, J), np.int32(0), J=J, max_dist=MAX_DIST, bw=BW,
        max_skip=MAX_SKIP, interpret=True)


def _port(axh, axl, aq, nb):
    pen = torch.from_numpy(gap_penalty_table(np.float32(K), BW))[None, :]
    f, p, v = chain_dp_fill(t32(axh), t32(axl), t32(aq),
                            torch.full(axh.shape, K, dtype=torch.int32),
                            t32(nb), pen, max_dist=MAX_DIST, bw=BW,
                            max_skip=MAX_SKIP)
    return np_(f), np_(p), np_(v)


def _host_row(axh, axl, aq, n):
    """A row as the host spec's (ax, ay) u64 anchors (span K)."""
    ax = (axh[:n].astype(np.uint64) << np.uint64(32)) | \
        axl[:n].astype(np.uint64)
    ay = (np.uint64(K) << np.uint64(32)) | aq[:n].astype(np.uint64)
    return ax, ay


def _depth(axh, axl, nb):
    return np_(window_depths(t32(axh), t32(axl), t32(nb), MAX_DIST))


@pytest.mark.parametrize("J", [64, 128])
@pytest.mark.parametrize("dense", [False, True], ids=["spread", "dense"])
def test_chain_fill_plain_matches_pallas(J, dense):
    rng = np.random.RandomState(J + dense)
    rows = _rows(rng, 256 if dense else 512, dense)
    axh, axl, aq, nb = rows
    jf, jp, jv, jfl = (np.asarray(a) for a in _jax(*rows, J)[:4])
    f, p, v = _port(*rows)
    flagged = jfl != 0
    clean = ~flagged
    assert clean.sum() > 0
    for a, b in ((jf, f), (jp, p), (jv, v)):
        np.testing.assert_array_equal(a[clean], b[clean])
    # the Pallas kernel's flags come from ring truncation alone: every
    # flagged row has an anchor whose window reaches J ages, so its
    # second max_skip pass never changed a row the ring held
    depth = _depth(axh, axl, nb).max(axis=1)
    assert (depth[flagged] >= J).all()
    if dense and J == 64:
        assert flagged.sum() > Q // 2        # the dense rows truncate
    if not dense:
        assert flagged.sum() < Q
    # flagged rows: the chains of the port's f, p, v are the JAX host
    # spec's
    for r in np.nonzero(flagged)[0]:
        n = int(nb[r])
        ax, ay = _host_row(axh[r], axl[r], aq[r], n)
        want = joh.chain_dp(ax, ay, MAX_DIST, BW, MAX_SKIP, MIN_CNT, MIN_SC)
        got = toh.chain_backtrack(f[r, :n], p[r, :n].astype(np.int64),
                                  v[r, :n], MIN_CNT, MIN_SC)
        assert [c[0] for c in got] == [c[0] for c in want]
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a[1], b[1])


def test_chain_fill_deep_window_matches_host_spec():
    """Repeat-dense rows whose admissible windows exceed 256 ages (the
    Pallas kernel flags them at its deepest ring, J = 256, and the JAX
    engine sends them to the host spec): the port's fill equals the
    host spec's f, p, v on every row."""
    rng = np.random.RandomState(7)
    R, A = 8, 640
    axh = np.zeros((R, A), np.int32)
    axl = np.zeros((R, A), np.int32)
    aq = np.zeros((R, A), np.int32)
    nb = rng.randint(400, A, R).astype(np.int32)
    for r in range(R):
        n = nb[r]
        pos = np.sort(rng.randint(0, 1500, n))
        q = rng.randint(0, 30000, n)
        d = rng.rand(n) < 0.3
        q[d] = np.clip(pos[d] + rng.randint(-30, 30, d.sum()), 0, None)
        axl[r, :n] = pos
        aq[r, :n] = q
    depth = _depth(axh, axl, nb).max(axis=1)
    assert (depth > 256).all()
    f, p, v = _port(axh, axl, aq, nb)
    for r in range(R):
        n = int(nb[r])
        hf, hp, hv = toh.chain_fill(*_host_row(axh[r], axl[r], aq[r], n),
                                    MAX_DIST, BW, MAX_SKIP)
        np.testing.assert_array_equal(f[r, :n], hf)
        np.testing.assert_array_equal(p[r, :n], hp)
        np.testing.assert_array_equal(v[r, :n], hv)
        assert (f[r, n:] == 0).all() and (p[r, n:] == -1).all()
    # parents deeper than any ring the JAX engine escalates to
    deep = (np.arange(A)[None, :] - p) > 256
    assert (deep & (p >= 0)).any()


def _segments(axh, n):
    """[(row, start, end)] of each run of one ax_hi in each row."""
    out = []
    for r in range(axh.shape[0]):
        x = axh[r, :n[r]]
        cut = np.flatnonzero(x[1:] != x[:-1]) + 1
        b = np.concatenate([[0], cut, [len(x)]])
        out += [(r, int(s), int(e)) for s, e in zip(b[:-1], b[1:])]
    return out


@pytest.mark.parametrize("tables", ["one", "per_row"])
def test_chain_fill_of_a_row_is_its_segments_fills(tables):
    """B2's independence across (strand, target) segments, which its
    kernel's pieces rely on: the plain fill of whole rows equals, on
    each ax_hi segment, the plain fill of that segment alone, with p
    moved by the segment's start; a repeat-dense segment runs past
    max_skip cuts."""
    rng = np.random.RandomState(11 + (tables == "per_row"))
    R, A = 3, 8192
    axh, axl, aq, nb = segment_rows(rng, R, A, 200, long_lens=(1500,),
                                    dense_len=1200)
    avg = [12] if tables == "one" else [12 + r / 3 for r in range(R)]
    pen = np.stack([gap_penalty_table(np.float32(a), BW) for a in avg])
    span = np.full((R, A), K, np.int32)
    whole = chain_dp_batch(t32(axh), t32(axl), t32(aq), t32(span), t32(nb),
                           t32(pen), max_dist=MAX_DIST, bw=BW,
                           max_skip=MAX_SKIP, return_scan=True)
    f, p, v, scan = (np_(t) for t in whole)
    segs = _segments(axh, nb)
    assert len(segs) > 3 * 150
    assert max(e - s for _, s, e in segs) >= 1200
    # the dense segment: some anchor's scan stops short of its window
    depth = _depth(axh, axl, nb)
    assert ((scan < depth) & (scan > 0)).any()
    # the segments as rows of their own, batched by length
    by_len = {}
    for sg in segs:
        by_len.setdefault(next(b for b in (32, 256, A)
                               if sg[2] - sg[1] <= b), []).append(sg)
    for L, group in by_len.items():
        cols = np.zeros((4, len(group), L), np.int32)
        sn = np.zeros(len(group), np.int32)
        for k, (r, s, e) in enumerate(group):
            for c, a in enumerate((axh, axl, aq, span)):
                cols[c, k, :e - s] = a[r, s:e]
            sn[k] = e - s
        spen = pen[[r if len(pen) > 1 else 0 for r, _, _ in group]]
        sf, sp, sv = (np_(t) for t in chain_dp_batch(
            *(t32(c) for c in cols), t32(sn), t32(spen), max_dist=MAX_DIST,
            bw=BW, max_skip=MAX_SKIP))
        for k, (r, s, e) in enumerate(group):
            m = e - s
            np.testing.assert_array_equal(f[r, s:e], sf[k, :m])
            np.testing.assert_array_equal(
                p[r, s:e], np.where(sp[k, :m] >= 0, sp[k, :m] + s, -1))
            np.testing.assert_array_equal(v[r, s:e], sv[k, :m])


@pytest.mark.parametrize("P", [4, 36, 264])
def test_piece_starts_cut_rows_at_segment_starts(P):
    """ops/chain.piece_starts (where the B2 kernel's P pieces of a row
    start): monotone from 0 to n, each start at or after its nominal
    cut w * ceil(n / P) and at a segment's start, and no segment start
    skipped between a nominal cut and the piece start it moved to."""
    rng = np.random.RandomState(P)
    Q, A = 6, 4096
    axh, _, _, nb = segment_rows(rng, Q, A, 120, long_lens=(900,),
                                 dense_len=300)
    nb[4] = 0                                  # an empty row
    nb[5] = min(int(nb[5]), P // 2)            # a row shorter than P
    st = np_(piece_starts(t32(axh), t32(nb), P))
    assert st.shape == (Q, P + 1)
    for r in range(Q):
        n = int(nb[r])
        s = st[r]
        assert s[0] == 0 and s[-1] == n and (np.diff(s) >= 0).all()
        x = axh[r, :n]
        heads = {0, n} | set((np.flatnonzero(x[1:] != x[:-1]) + 1).tolist())
        cuts = np.minimum(np.arange(P + 1) * -(-n // P), n)
        for c, x in zip(cuts, s):
            assert x in heads and x >= c
            assert not any(c <= h < x for h in heads)


def test_pieces_per_row_from_rows_and_sms():
    """P grows as a call's rows shrink, in whole blocks of PIECE_WARPS
    warps, the fewest that put WARPS_PER_SM warps on each SM."""
    Qs = (128, 64, 32, 16, 1)
    Ps = [pieces_per_row(Q, 132) for Q in Qs]
    assert Ps == sorted(Ps) and Ps[0] < Ps[-1]
    for Q, P in zip(Qs, Ps):
        assert P % PIECE_WARPS == 0
        assert Q * P >= WARPS_PER_SM * 132
        assert Q * (P - PIECE_WARPS) < WARPS_PER_SM * 132
