"""The CUDA kernels against their plain versions on the card (marked
`cuda`: they need a GPU and nvcc, and skip elsewhere), and sampleqc's
run on the card against its run on the CPU. chip_smoke.py runs the same
comparisons at production shapes."""

import filecmp
import json
import os

import numpy as np
import pytest
import torch
from torch_util import (ONT_ADP5, QC_JSON, SAMPLEQC_TABLES, adapter_codes,
                        adapter_windows, compare_qc_json,
                        ext_edge_pairs, ext_strip_pairs,
                        odd_bases, ont_sampleqc_reads, pack_tile,
                        pb_sampleqc_reads, segment_rows)

from longqc_tpu_torch import tracing
from longqc_tpu_torch.engine import device_index as di
from longqc_tpu_torch.ops import _ext
from longqc_tpu_torch.ops import adapter as adp_ops
from longqc_tpu_torch.ops import extend as ext
from longqc_tpu_torch.ops import pack_cuda
from longqc_tpu_torch.ops import ringprop as rp
from longqc_tpu_torch.ops import sketch_cuda as skc
from longqc_tpu_torch.ops.chain import (chain_dp_batch, gap_penalty_table,
                                        piece_starts, window_depths)
from longqc_tpu_torch.ops.chain_cuda import (chain_dp_fill, count_pieces,
                                             pieces_per_row)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _long_run_tile(rng, R, W, sep=4, p_n=.04):
    """Reads with N runs and (AT)n runs longer than the kernel's column
    chunk (ops/sketch_cuda.CHUNK), IUPAC-free random sequence between."""
    b = di._TileBuilder(R, W, sep)
    gid = 0
    while len(b.rows) < R:
        p = [(1 - p_n) / 4] * 4 + [p_n]
        s = "".join(rng.choice(list("ACGTN"), p=p,
                               size=rng.randint(50, min(W // 2, 9000))))
        if gid % 3 == 1:
            s += "AT" * rng.randint(100, 600)
        if gid % 4 == 2:
            p = rng.randint(0, len(s))
            s = s[:p] + "N" * rng.randint(150, 700) + s[p:]
        b.add(gid, s[:W])
        gid += 1
    return b.tiles()[0]


def _tile_args(t, dev):
    return [di.to_device_words(a, dev) for a in
            (t.codes2, t.nmask, t.startmask, t.endmask)] + \
        [torch.from_numpy(a).to(dev) for a in (t.starts, t.gids)]


def _assert_sketch_equals_plain(args, W, k, w):
    kr = skc.sketch_tiles(*args, W=W, k=k, w=w)
    p = skc.sketch_tiles_plain(*args, W=W, k=k, w=w)
    assert torch.equal(kr["emit"], p["emit"])
    on = p["emit"] > 0
    assert int(on.sum()) > 0
    for f in ("hash", "rid", "pos", "strand"):
        assert kr[f].dtype == p[f].dtype
        assert torch.equal(kr[f][on], p[f][on])
    return p


@pytest.mark.parametrize("R,W", [(16, 2048), (256, 8192), (32, 65536)])
def test_sketch_kernel_matches_plain(dev, R, W):
    rng = np.random.RandomState(W)
    args = _tile_args(_long_run_tile(rng, R, W), dev)
    for k, w in ((12, 5), (15, 10)):
        _assert_sketch_equals_plain(args, W, k, w)


@pytest.mark.parametrize("k,w", [(19, 10), (28, 5), (16, 32)])
@pytest.mark.parametrize("R,W", [(16, 2048), (256, 8192), (32, 65536)])
def test_sketch_u64_kernel_matches_plain(dev, R, W, k, w):
    """2k > 30: u64 k-mer registers and hashes, int64 hash output."""
    rng = np.random.RandomState(W + k)
    args = _tile_args(_long_run_tile(rng, R, W), dev)
    p = _assert_sketch_equals_plain(args, W, k, w)
    assert p["hash"].dtype == torch.int64
    assert int(p["hash"].max()) > 1 << 31


@pytest.mark.parametrize("k", [12, 19], ids=["u32", "u64"])
@pytest.mark.parametrize("w", [33, 40, 64, 65, 128, 129, 255])
def test_sketch_ring_kernel_matches_plain(dev, w, k):
    """w > 32: the ring is a circular buffer addressed at run time (64,
    128 or 256 slots), in wider chunks."""
    R, W = 64, 8192
    rng = np.random.RandomState(w + k)
    args = _tile_args(_long_run_tile(rng, R, W, sep=w - 1, p_n=.002), dev)
    _assert_sketch_equals_plain(args, W, k, w)


def _anchor_rows(rng, Q, A, dense):
    """Sorted anchor rows: diagonal-clustered (`dense` False) or
    repeat-dense position bands with scattered query positions, whose
    admissible windows run deeper than 256 ages."""
    pos = np.sort(rng.randint(0, 800 if dense else 6000, (Q, A)), axis=1)
    q = pos + rng.randint(-60, 60, (Q, A))
    if dense:
        far = rng.rand(Q, A) < 0.7
        q[far] = rng.randint(0, 20000, far.sum())
    n = rng.randint(50, A, Q)
    return [torch.from_numpy(a.astype(np.int32)) for a in
            (pos, np.clip(q, 0, None), n)]


@pytest.mark.parametrize("tables", ["one", "per_row"])
@pytest.mark.parametrize("dense", [False, True], ids=["spread", "dense"])
def test_chain_and_ringprop_kernels_match_plain(dev, dense, tables):
    rng = np.random.RandomState(5 + dense)
    Q, A = 128, 1024
    axl, aq, n = (t.to(dev) for t in _anchor_rows(rng, Q, A, dense))
    axh = torch.zeros((Q, A), dtype=torch.int32, device=dev)
    span = torch.full((Q, A), 12, dtype=torch.int32, device=dev)
    depth = window_depths(axh, axl, n, 10000).amax(dim=1)
    if dense:
        assert int((depth > 256).sum()) > Q // 2
    # the plain engine's one (1, bw+1) table (row stride 0), or a
    # distinct table per row (the HPC engine's per-row avg_qspan)
    avg = [12] if tables == "one" else [12 + r / 7 for r in range(Q)]
    pen = torch.from_numpy(np.stack([
        gap_penalty_table(np.float32(a), 500) for a in avg])).to(dev)
    ko = chain_dp_fill(axh, axl, aq, span, n, pen)
    po = chain_dp_batch(axh, axl, aq, span, n, pen)
    for a, b in zip(ko, po):
        assert torch.equal(a, b)
    f, p, v = ko
    # parents may lie any distance back: the passes run with J = A
    assert torch.equal(rp.peak_pass(f, v, p, J=A),
                       rp.peak_pass_plain(f, v, p, J=A))
    own = torch.where(torch.rand((Q, A), device=dev) < 0.1,
                      torch.randint(0, 50, (Q, A), device=dev),
                      rp.INF32).int()
    assert torch.equal(rp.minrank_pass(p, own, J=A),
                       rp.minrank_pass_plain(p, own, J=A))


def _piece_rows(rng, Q, A, P):
    """Multi-segment rows by row mod 5: a long segment (longer than a
    piece) and a repeat-dense one; n == A; segments of 1.5-2.5 nominal
    pieces, so they straddle the nominal cuts; fewer anchors than P;
    none. One row: n == A with a long and a dense segment."""
    step = -(-A // P)
    parts = []
    for r in range(Q):
        mode = 1 if Q == 1 else r % 5
        if mode == 0:
            rows = segment_rows(rng, 1, A, A // 32,
                                long_lens=(max(3 * step, 600),),
                                dense_len=400)
        elif mode == 1:
            rows = segment_rows(rng, 1, A, A // 32,
                                long_lens=(max(3 * step, 600),),
                                dense_len=400, fill=True)
        elif mode == 2:
            lens = rng.randint(step + step // 2, 2 * step + step // 2,
                               A // step + 1)
            rows = segment_rows(rng, 1, A, 0, long_lens=lens, fill=True)
        else:
            rows = segment_rows(rng, 1, A, rng.randint(1, 6) if mode == 3
                                else 0)
            rows[3][:] = min(int(rows[3][0]), P - 1)
        parts.append(rows)
    return [np.concatenate([pt[i] for pt in parts]) for i in range(4)]


@pytest.mark.parametrize("tables", ["one", "per_row"])
@pytest.mark.parametrize("Q,A", [(1, 32768), (16, 16384), (128, 4096)])
def test_chain_kernel_pieces_match_plain(dev, Q, A, tables):
    """B2's pieces (runs of whole (strand, target) segments, one warp
    each, P a row from Q and the card's SMs) against the plain fill on
    multi-segment rows, and the kernel's counters against the pieces of
    ops/chain.piece_starts."""
    P = pieces_per_row(Q, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    rng = np.random.RandomState(Q + A + (tables == "per_row"))
    axh, axl, aq, n = (torch.from_numpy(a).to(dev)
                       for a in _piece_rows(rng, Q, A, P))
    span = torch.full((Q, A), 12, dtype=torch.int32, device=dev)
    avg = [12] if tables == "one" else [12 + r / 7 for r in range(Q)]
    pen = torch.from_numpy(np.stack([
        gap_penalty_table(np.float32(a), 500) for a in avg])).to(dev)
    with count_pieces() as pc:
        ko = chain_dp_fill(axh, axl, aq, span, n, pen)
    po = chain_dp_batch(axh, axl, aq, span, n, pen)
    for a, b in zip(ko, po):
        assert torch.equal(a, b)
    st = piece_starts(axh, n, P)
    ln = (st[:, 1:] - st[:, :-1]).cpu()
    got = list(pc.sums.values())
    assert len(got) == 1
    assert got[0].tolist() == [int((ln > 0).sum()), int(n.max()),
                               int(ln.max())]
    assert int((ln > 0).sum()) > Q
    assert int(n.max()) == A and int(ln.max()) < A
    if Q > 1:
        # the straddling rows: their nominal cuts inside segments
        x = axh[2].cpu().numpy()
        heads = set((np.flatnonzero(x[1:] != x[:-1]) + 1).tolist())
        cuts = np.arange(1, P) * -(-A // P)
        assert sum(int(c) not in heads for c in cuts) >= 0.9 * (P - 1)
        assert int(n[3]) < P and int(n[4]) == 0


def test_chain_kernel_one_piece_a_single_segment_row(dev):
    """Rows of one segment each (x_hi all 0): one non-empty piece a
    row."""
    Q, A = 128, 1024
    axl, aq, n = (t.to(dev) for t in _anchor_rows(
        np.random.RandomState(3), Q, A, False))
    axh = torch.zeros((Q, A), dtype=torch.int32, device=dev)
    span = torch.full((Q, A), 12, dtype=torch.int32, device=dev)
    pen = torch.from_numpy(gap_penalty_table(np.float32(12), 500)[None]).to(
        dev)
    with count_pieces() as pc:
        ko = chain_dp_fill(axh, axl, aq, span, n, pen)
    for a, b in zip(ko, chain_dp_batch(axh, axl, aq, span, n, pen)):
        assert torch.equal(a, b)
    assert next(iter(pc.sums.values())).tolist() == \
        [Q, int(n.max()), int(n.max())]


def _hard_forest_rows(case, rng, Q, A):
    """(Q, A) f / v / p / own: a path of depth A (p[i] = i - 1, the
    deepest anchor smallest), garbage parents (anywhere in [-1, A)) or
    links up to 768 back (past J = 256)."""
    ii = np.arange(A)
    f = rng.randint(1, 200, (Q, A))
    v = f + (rng.rand(Q, A) < 0.8) * rng.randint(1, 40, (Q, A))
    own = np.where(rng.rand(Q, A) < 0.1, rng.randint(0, 5000, (Q, A)),
                   rp.INF32)
    if case == "path":
        p = np.broadcast_to(ii - 1, (Q, A))
        v = f + 1
        own[::2] = A - ii
    elif case == "garbage":
        p = rng.randint(-1, A, (Q, A))
    else:
        p = np.maximum(ii - rng.randint(1, 769, (Q, A)), -1)
    return [torch.from_numpy(np.ascontiguousarray(a).astype(np.int32))
            for a in (f, v, p, own)]


@pytest.mark.parametrize("J", ["A", "256"])
@pytest.mark.parametrize("case", ["path", "garbage", "far"])
def test_ringprop_kernels_match_plain_on_hard_rows(dev, case, J):
    # rows longer than the kernels' 4096-anchor chunk and not a multiple
    # of it, so chains cross chunks and the last chunk is partial
    Q, A = 16, 10000
    J = A if J == "A" else int(J)
    f, v, p, own = (t.to(dev) for t in _hard_forest_rows(
        case, np.random.RandomState(len(case)), Q, A))
    assert torch.equal(rp.peak_pass(f, v, p, J=J),
                       rp.peak_pass_plain(f, v, p, J=J))
    assert torch.equal(rp.minrank_pass(p, own, J=J),
                       rp.minrank_pass_plain(p, own, J=J))


def _ext_pairs(rng, B, Lq, Lt):
    """Related pairs (10% substitutions, a deletion), unrelated pairs
    (Z-drop fires) and unequal lengths, some past the arrays' width."""
    q = rng.randint(0, 4, (B, Lq))
    t = q[:, :Lt].copy()
    sub = rng.rand(B, Lt) < 0.1
    t[sub] = rng.randint(0, 5, sub.sum())
    for b in range(0, B, 3):
        t[b] = rng.randint(0, 4, Lt)
    for b in range(1, B, 5):
        cut = rng.randint(0, Lt // 2)
        t[b, cut:] = np.concatenate([t[b, cut + 30:], rng.randint(0, 4, 30)])
    ql = rng.randint(Lq // 3, Lq + 20, B)
    tl = rng.randint(Lt // 3, Lt + 20, B)
    return [torch.from_numpy(a.astype(np.int32)) for a in (q, ql, t, tl)]


@pytest.mark.parametrize("W", [1, 15, 16, 32, 40, 63, 64, 255, 5000])
@pytest.mark.parametrize("mode", ["extz", "extd"])
def test_extend_kernel_matches_plain(dev, mode, W):
    """W <= 63 takes the one-warp body, wider W the wide body (strips);
    W = 5000 lies past every pair (lengths up to 720), so its band is
    clamped per pair, while the plain version runs the full band."""
    from longqc_tpu_torch.ops import _ext
    rng = np.random.RandomState(W)
    q, ql, t, tl = (a.to(dev) for a in _ext_pairs(rng, 300, 700, 650))
    gap = {"gapo2": 24, "gape2": 1} if mode == "extd" else {}
    name = mode + ("_wide" if W > 63 else "")
    for zdrop in (100, 400):
        n0 = _ext.LAUNCHES[name]
        k = ext.extz_batch(q, ql, t, tl, W=W, zdrop=zdrop, **gap)
        assert _ext.LAUNCHES[name] == n0 + 1
        p = ext.extz_batch_plain(q, ql, t, tl, W=W, zdrop=zdrop, **gap)
        for key in ext.KEYS:
            assert torch.equal(k[key], p[key]), key
        assert bool(k["zdropped"].any()) and not bool(k["zdropped"].all())


@pytest.mark.parametrize("W", [1, 31, 32, 63, 64, 65, 127, 128, 255, 300,
                               5000])
@pytest.mark.parametrize("mode", ["extz", "extd"])
def test_extend_kernel_edges_match_plain(dev, mode, W):
    """The one-warp body (one column a lane up to W = 31, two from 32)
    on the edge pairs of tests/test_torch_extend_sched.py: ql = 0,
    tl = 0, ql = 1, tl = 1, lengths past the arrays' width, an all-4
    query, ql >> tl, ql << tl and pairs that Z-drop early; the wide body
    (W >= 64, strips of 64 columns a warp: 1 warp a pair up to W = 127,
    2 at 128 and 255, 4 at 300, 8 at 5000) on the same kinds of pairs of
    up to 600 bases, and pairs of exactly 64, 65 and 128 columns and one
    that Z-drops in its second strip at zdrop = 100."""
    from longqc_tpu_torch.ops import _ext
    rng = np.random.RandomState(500 + W)
    pairs = ext_edge_pairs(rng) if W <= 63 else ext_strip_pairs(rng)
    q, ql, t, tl = (torch.from_numpy(a).to(dev) for a in pairs)
    gap = {"gapo2": 24, "gape2": 1} if mode == "extd" else {}
    name = mode + ("_wide" if W > 63 else "")
    for zdrop in (100, 400):
        n0 = _ext.LAUNCHES[name]
        k = ext.extz_batch(q, ql, t, tl, W=W, zdrop=zdrop, **gap)
        assert _ext.LAUNCHES[name] == n0 + 1
        p = ext.extz_batch_plain(q, ql, t, tl, W=W, zdrop=zdrop, **gap)
        for key in ext.KEYS:
            assert torch.equal(k[key], p[key]), (zdrop, key)
        assert bool(k["zdropped"][14]) and not bool(k["zdropped"][15])
        if W > 63:
            assert not bool(k["zdropped"][24:27].any())
            assert bool(k["zdropped"][27]) or zdrop == 400


@pytest.mark.parametrize("mode", ["extz", "extd"])
def test_extend_wide_band_in_device_memory(dev, mode, monkeypatch):
    """The wide body with its scratch cap cut to 7 pair slots' boundary
    columns in device memory, so that 7 slots (of 1, 2 and 8 warps at
    W = 64, 255 and 5000) walk the 300 pairs."""
    from longqc_tpu_torch.ops import extend_cuda
    rng = np.random.RandomState(77)
    q, ql, t, tl = (a.to(dev) for a in _ext_pairs(rng, 300, 700, 650))
    gap = {"gapo2": 24, "gape2": 1} if mode == "extd" else {}
    for W in (64, 255, 5000):
        Wa = min(W, max(int(ql.max()), t.shape[1]))
        assert extend_cuda.wide_warps(300, Wa) == {64: 1, 255: 2, 5000: 8}[W]
        ints = (3 if gap else 2) * (2 * Wa + 1)
        monkeypatch.setattr(extend_cuda, "WIDE_SCRATCH_BYTES", 7 * 4 * ints)
        k = ext.extz_batch(q, ql, t, tl, W=W, zdrop=400, **gap)
        p = ext.extz_batch_plain(q, ql, t, tl, W=W, zdrop=400, **gap)
        for key in ext.KEYS:
            assert torch.equal(k[key], p[key]), (W, key)


def _align_both(adp, wins, lens, dev):
    """hw_align_batch on the card and on the CPU (its plain twin)."""
    ins = [torch.from_numpy(x) for x in (adp, wins, lens)]
    card = adp_ops.hw_align_batch(*(t.to(dev) for t in ins))
    assert card.is_cuda and card.dtype == torch.int32
    return card.cpu(), adp_ops.hw_align_batch(*ins)


@pytest.mark.parametrize("m", [18, 28, 45, 64, 100])
def test_adapter_align_kernel_matches_plain(dev, m):
    """The adapter search's alignment kernel on 10,003 windows of 150
    columns and 1,001 of 60 (counts not a multiple of a block's 4 warps),
    every kind of tests/torch_util.adapter_windows (random, the adapter
    planted exact and mutated, poly-A, tandem fragments, repeats, N runs,
    windows of 0, 1, 2 and fewer columns): all eight fields equal the
    plain twin's on every window; C = 0 and C = 1."""
    rng = np.random.RandomState(m)
    adp = adapter_codes(m)
    for C, Lw in ((10003, 150), (1001, 60)):
        wins, lens = adapter_windows(rng, adp, C, Lw)
        card, plain = _align_both(adp, wins, lens, dev)
        assert tuple(card.shape) == (8, C) and torch.equal(card, plain)
    for C in (0, 1):
        wins, lens = adapter_windows(rng, adp, 4, 150)
        wins, lens = wins[3:3 + C], lens[3:3 + C]
        card, plain = _align_both(adp, wins, lens, dev)
        assert tuple(card.shape) == (8, C) and torch.equal(card, plain)


@pytest.mark.parametrize("m", [28, 100])
def test_adapter_align_kernel_walks_on_past_its_slots(dev, m, monkeypatch):
    """Scratch for one warp slot: one warp aligns all 301 windows in
    turn, reusing its moves (and at m = 100 its strip edges)."""
    monkeypatch.setattr(adp_ops, "ALIGN_SCRATCH_BYTES", 1)
    rng = np.random.RandomState(m + 1)
    adp = adapter_codes(m)
    wins, lens = adapter_windows(rng, adp, 301, 150)
    card, plain = _align_both(adp, wins, lens, dev)
    assert torch.equal(card, plain)


def test_cut_adapter_card_run_equals_cpu_run(dev, monkeypatch):
    """cut_adapter with both adapters on the card: one adapter_align
    launch a side; outputs, trimmed reads, TIE_STATS deltas and counters
    equal a run on CPU tensors from the same TIE_STATS, and every
    candidate was aligned on the card."""
    a3 = "GCAATACGTAACTGAACG"
    reads = [[n, s + a3 if i % 3 == 0 else s, q + "I" * len(a3)
              if i % 3 == 0 else q]
             for i, (n, s, q) in enumerate(ont_sampleqc_reads())]
    runs = []
    for device in ("cpu", dev):
        monkeypatch.setattr(adp_ops, "TIE_STATS", {
            "candidates": 150, "ambiguous_identity": 0,
            "ambiguous_start": 0})
        work = [list(r) for r in reads]
        stats = {}
        _ext.reset_launches()
        with tracing.run(stats):
            res = adp_ops.cut_adapter(work, adp_t=ONT_ADP5, adp_b=a3,
                                      device=device)
        runs.append((res, work, dict(adp_ops.TIE_STATS),
                     stats["spans"]["counters"],
                     _ext.LAUNCHES["adapter_align"]))
    (r0, w0, t0, c0, l0), (r1, w1, t1, c1, l1) = runs
    assert (r1, w1, t1) == (r0, w0, t0)
    assert l0 == 0 and l1 == 2
    assert r1[0][1] >= 20 and t1["candidates"] > 150
    assert c0.get("adapter.align_kernel", 0) == 0
    assert c1["adapter.align_kernel"] == c1["adapter.candidates"] > 0
    for key in ("adapter.candidates", "adapter.straddle_dp"):
        assert c1[key] == c0[key]


def _pack_both(t, dev):
    card = pack_cuda.pack_words(torch.from_numpy(t.raw).to(dev),
                                torch.from_numpy(t.row_off).to(dev),
                                torch.from_numpy(t.segs).to(dev),
                                R=t.R, W=t.W)
    return [c.cpu().numpy().view(np.uint32) for c in card], t.words


@pytest.mark.parametrize("R,W", [(256, 8192), (32, 65536), (4, 524288),
                                 (1, 1 << 22)])
def test_pack_kernel_matches_plain(dev, R, W):
    """csrc/pack.cu at the ladder's three shapes and a jumbo tile: its
    four word arrays equal the plain twin's, one launch each."""
    t = pack_tile(np.random.RandomState(R), R, W)
    if R > 1:
        assert int(np.diff(t.row_off).max()) == skc.READS_PER_ROW
        assert int(np.diff(t.row_off)[-1]) == 0
    _ext.reset_launches()
    card, plain = _pack_both(t, dev)
    assert _ext.LAUNCHES["pack_tile"] == 1
    for name, c, p in zip(("codes2", "nmask", "startmask", "endmask"),
                          card, plain):
        assert np.array_equal(c, p), name


def test_pack_kernel_reads_of_no_bases(dev):
    """Reads of no bases first in a row (the end bit on the row before,
    or on the tile's last column), between reads and in runs, on the
    small ladder and a jumbo tile, against the plain twin."""
    rng = np.random.RandomState(3)
    lens = [0, 500, 0, 0, 1200, 2048, 0, 30, 1000, 0, 40000] + \
        list(rng.randint(0, 3, size=40)) + [0]
    part = [["r%d" % i, odd_bases(rng, n, odd=.05), ""]
            for i, n in enumerate(lens)]
    tiles, jumbo = di.pack_part_tiles(part, 5, ladder=di.TILE_LADDER_SMALL)
    firsts = 0
    for t in tiles + jumbo:
        firsts += sum(1 for r in range(t.R)
                      if t.row_off[r + 1] > t.row_off[r]
                      and t.segs[t.row_off[r], 2] == 0)
        card, plain = _pack_both(t, dev)
        for c, p in zip(card, plain):
            assert np.array_equal(c, p)
    assert firsts >= 2 and len(jumbo) == 1


def _index_part():
    from util_synth import make_genome, sample_reads
    rng = np.random.RandomState(23)
    genome = make_genome(rng, 60000)
    part = sample_reads(rng, genome, 120, min_len=50, max_len=6000,
                        err=0.12, junk_frac=0.1)
    part.append(["long", odd_bases(rng, 40000, odd=.01), ""])
    return part


@pytest.mark.parametrize("n_idx_sizes", [di.N_IDX_SIZES_SMALL, (1 << 10,)],
                         ids=["ladder", "hash_range"])
def test_build_device_index_card_equals_cpu(dev, n_idx_sizes):
    """build_device_index on the card (the tiles' words made there)
    against the CPU build: ih, irid, ips (entry multisets within each
    hash) and mid_occ equal; index.pack_tiles counts every tile."""
    part = _index_part()
    kw = dict(ladder=di.TILE_LADDER_SMALL, n_idx_sizes=n_idx_sizes,
              range_max=1 << 12)
    want = di.build_device_index(part, 12, 5, device="cpu", **kw)
    stats = {}
    with tracing.run(stats):
        got = di.build_device_index(part, 12, 5, device=dev, **kw)
    assert stats["spans"]["counters"]["index.pack_tiles"] \
        == got["n_tiles"] == want["n_tiles"] > 1
    for key in ("n_idx", "n_real", "n_ranges"):
        assert got[key] == want[key], key
    assert (got["n_ranges"] > 1) == (n_idx_sizes == (1 << 10,))
    assert int(got["mid_occ"]) == int(want["mid_occ"])
    assert torch.equal(got["ih"].cpu(), want["ih"])

    def triples(idx):
        a = torch.stack([idx["ih"].cpu().long(), idx["irid"].cpu().long(),
                         idx["ips"].cpu().long()], 1).numpy()
        return a[np.lexsort(a.T[::-1])]
    assert np.array_equal(triples(got), triples(want))


def test_device_engine_packs_every_tile_on_the_card(dev):
    """A device engine run over several parts: index.pack_tiles equals
    the parts' tiles, its rows equal the CPU run's."""
    from longqc_tpu_torch.engine import overlap_host as oh
    from longqc_tpu_torch.engine.device_overlap import DeviceOverlapEngine

    reads, cfg = _mesh_inputs()
    want = DeviceOverlapEngine(cfg, reads[:24], device="cpu").run(
        list(reads))
    eng = DeviceOverlapEngine(cfg, reads[:24])
    _ext.reset_launches()
    assert eng.run(list(reads)) == want
    n_tiles = sum(len(di.pack_part(p, 5, ladder=eng.tile_ladder))
                  for p in oh.iter_index_parts(iter(reads),
                                               cfg.index.batch_size))
    assert n_tiles >= 3
    assert eng.spans["counters"]["index.pack_tiles"] == n_tiles \
        == _ext.LAUNCHES["pack_tile"]


@pytest.mark.parametrize("preset", ["ont-ligation", "pb-sequel"])
def test_sampleqc_card_run_equals_cpu_run(tmp_path, dev, preset):
    """Every stage on the card (kernels B1-B4, the chunk-QC torch ops, the
    fits) against the same run on the CPU: the tables byte-identical, the
    QC JSON within the fits' tolerance."""
    from longqc_tpu_torch.engine import pipeline
    from util_synth import write_fastq_file

    reads = (ont_sampleqc_reads() if preset == "ont-ligation"
             else pb_sampleqc_reads())
    fq = str(tmp_path / "in.fq")
    write_fastq_file(fq, reads)
    report = not pipeline.missing_report_modules()
    outs = {}
    for d in ("cpu", "cuda"):
        outs[d] = str(tmp_path / d)
        pipeline.run_sampleqc(fq, outs[d], preset, nsample=30,
                              device=dev if d == "cuda" else d,
                              report=report)
    tables = SAMPLEQC_TABLES + (["analysis/minimap2/spiked_in_control.txt"]
                                if preset == "pb-sequel" else [])
    for table in tables:
        assert filecmp.cmp(os.path.join(outs["cpu"], table),
                           os.path.join(outs["cuda"], table), shallow=False)
    with open(os.path.join(outs["cpu"], QC_JSON)) as f:
        want = json.load(f)
    with open(os.path.join(outs["cuda"], QC_JSON)) as f:
        compare_qc_json(json.load(f), want)


def test_sampleqc_db_card_run_equals_cpu_run(tmp_path, dev):
    """sampleqc -d: the index prefetch sketches on the card beside the
    chunk-QC loop; the npz part, the tables and the QC JSON equal the
    same run on the CPU."""
    from longqc_tpu_torch.engine import pipeline
    from torch_util import assert_same_npz
    from util_synth import write_fastq_file

    fq = str(tmp_path / "in.fq")
    write_fastq_file(fq, ont_sampleqc_reads())
    outs = {}
    for d in ("cpu", "cuda"):
        outs[d] = str(tmp_path / d)
        stats = {}
        pipeline.run_sampleqc(fq, outs[d], "ont-ligation", nsample=30,
                              db=True, device=dev if d == "cuda" else d,
                              report=False, stats=stats)
        assert stats["prefetch"]["parts"] == 1
    part = os.path.join("analysis", "minimap2",
                        "t_db_longqc_k12_w5.part0000.npz")
    assert_same_npz(os.path.join(outs["cuda"], part),
                    os.path.join(outs["cpu"], part))
    for table in SAMPLEQC_TABLES:
        assert filecmp.cmp(os.path.join(outs["cpu"], table),
                           os.path.join(outs["cuda"], table), shallow=False)
    with open(os.path.join(outs["cpu"], QC_JSON)) as f:
        want = json.load(f)
    with open(os.path.join(outs["cuda"], QC_JSON)) as f:
        compare_qc_json(json.load(f), want)


def test_batched_chainer_card_equals_cpu_run(tmp_path, dev, capsys):
    """DeviceChainer with B2 on the card against its CPU run (the plain
    B2) on seeded anchor sets, rows past the top rung included; and
    `mmcov -H -k 17` (the device engine rejects it) on the card against
    its CPU run, B2 launched."""
    from longqc_tpu_torch.cli import main
    from longqc_tpu_torch.config import MapOpt
    from longqc_tpu_torch.engine.overlap import DeviceChainer
    from longqc_tpu_torch.ops import _ext
    from torch_util import (assert_same_chains, chainer_anchor_sets,
                            k17_inputs)

    m = MapOpt()
    for k, w, hpc in ((12, 5, False), (17, 10, True)):
        sets = chainer_anchor_sets(7, 70, k, w, hpc)
        got = {}
        for d in ("cpu", dev):
            ch = DeviceChainer(device=d)
            ch.a_ladder = (128, 256)
            got[str(d)] = ch(sets, m)
        assert_same_chains(got[str(dev)], got["cpu"])
    tf, qf = k17_inputs(tmp_path)
    flags = ["mmcov", "-H", "-k", "17", "-w", "10", "-c", "1", "-l", "0",
             "--filter"]
    assert main(flags + ["--device", "cpu", tf, qf]) == 0
    want = capsys.readouterr().out
    _ext.reset_launches()
    assert main(flags + [tf, qf]) == 0
    assert capsys.readouterr().out == want
    assert _ext.LAUNCHES["chain"] >= 1


def _mesh_inputs():
    """tests/test_multichip.py's input (tests/test_torch_mesh.py)."""
    from longqc_tpu_torch.config import FltOpt, IndexOpt, MapOpt, \
        OverlapConfig
    from util_synth import make_genome, sample_reads

    rng = np.random.RandomState(5)
    reads = sample_reads(rng, make_genome(rng, 20000), 90, min_len=500,
                         max_len=1500, err=0.12, junk_frac=0.1)
    cfg = OverlapConfig(index=IndexOpt(k=12, w=5, batch_size=30000),
                        map=MapOpt(min_score_med=80, min_score_good=160),
                        flt=FltOpt(min_ovlp=0))
    return reads, cfg


def test_part_pipeline_card_equals_cpu_run(dev):
    """A run of 4 parts on one card against its CPU run, B1-B4
    launched."""
    from longqc_tpu_torch.engine.device_overlap import overlap_run_device2
    from longqc_tpu_torch.ops import _ext

    reads, cfg = _mesh_inputs()
    want = overlap_run_device2(list(reads), reads[:24], cfg, device="cpu")
    _ext.reset_launches()
    stats = {}
    assert overlap_run_device2(iter(reads), reads[:24], cfg,
                               stats=stats) == want
    assert len(stats["part_ranges"]) >= 3
    for name in ("sketch", "chain", "peak", "minrank"):
        assert _ext.LAUNCHES[name] >= 1


@pytest.mark.parametrize("case", ["path", "garbage", "far"])
def test_minrank_pending_mask_in_device_memory(dev, case, monkeypatch):
    """B4 with the row's pending bits in device memory (the layout of
    rows past 2^20 anchors), forced at A = 10,000."""
    monkeypatch.setattr(rp, "SMEM_MARK_A", 0)
    Q, A = 16, 10000
    _f, _v, p, own = (t.to(dev) for t in _hard_forest_rows(
        case, np.random.RandomState(len(case) + 7), Q, A))
    assert torch.equal(rp.minrank_pass(p, own, J=A),
                       rp.minrank_pass_plain(p, own, J=A))


def _ring_np(f, v, p, own):
    """Peak and min-rank of one row with J = A, as plain loops."""
    A = len(p)
    peak = np.arange(A)
    for i in range(A):
        if v[i] > f[i] and 0 <= p[i] < i:
            peak[i] = peak[p[i]]
        elif v[i] > f[i] and p[i] >= i:
            peak[i] = -1
    r = own.astype(np.int64).copy()
    for i in range(A - 1, -1, -1):
        if 0 <= p[i] < i and r[i] < r[p[i]]:
            r[p[i]] = r[i]
    return peak, r


def test_ringprop_kernels_on_rows_past_a_million_anchors(dev):
    """B3 and B4 on rows of 2^20 + 5,000 anchors (the wide rungs' rows):
    links up to 768 back and one in 50 anywhere back, across chunks."""
    Q, A = 2, (1 << 20) + 5000
    rng = np.random.RandomState(3)
    f, v, p, own = (t.numpy() for t in _hard_forest_rows("far", rng, Q, A))
    p = p.copy()
    anywhere = rng.rand(Q, A) < 0.02
    p[anywhere] = (rng.rand(int(anywhere.sum())) *
                   np.nonzero(anywhere)[1]).astype(np.int32)
    ins = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
           for a in (f, v, p, own)]
    peak = rp.peak_pass(*ins[:3], J=A).cpu().numpy()
    mr = rp.minrank_pass(ins[2], ins[3], J=A).cpu().numpy()
    for r in range(Q):
        want_peak, want_mr = _ring_np(f[r], v[r], p[r], own[r])
        assert np.array_equal(peak[r], want_peak)
        assert np.array_equal(mr[r], want_mr)


def test_wide_rows_card_equal_cpu_run(dev):
    """Rows past a shrunk top rung stepped at the wide rungs on the card
    (several rungs and lane counts; a query in the 1,048,576 bucket)
    against the host spec on the CPU."""
    from longqc_tpu_torch.config import (FltOpt, IndexOpt, MapOpt,
                                         OverlapConfig)
    from longqc_tpu_torch.engine import overlap_host as oh
    from longqc_tpu_torch.engine.device_overlap import DeviceOverlapEngine
    from util_synth import make_genome, mutate, sample_reads

    cfg = OverlapConfig(index=IndexOpt(k=12, w=5),
                        map=MapOpt(min_score_med=80, min_score_good=160),
                        flt=FltOpt(min_ovlp=0))
    rng = np.random.RandomState(11)
    genome = make_genome(rng, 300000)
    targets = sample_reads(rng, genome, 60, min_len=1000, max_len=8000,
                           err=0.12, junk_frac=0.1)
    big = mutate(rng, genome[10000:280000], 0.12)
    queries = [["ul0", big, "I" * len(big)]] + targets[:40]
    want = oh.overlap_run(list(targets), queries, cfg, device="cpu")
    for ladder, lanes in (((512, 1024), 8), ((1024, 2048), 4)):
        eng = DeviceOverlapEngine(cfg, queries, a_ladder=ladder,
                                  lanes=lanes)
        assert eng.run(list(targets)) == want
        assert eng.spans["counters"]["step.wide_rows"] > 0
        assert eng.stats()["host_fixed_rows"] == 0
