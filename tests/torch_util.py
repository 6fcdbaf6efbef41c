"""Shared helpers of the port's tests (tests/test_torch_*.py).

The tests run on the CPU, where every kernel wrapper of
longqc_tpu_torch runs its plain PyTorch version; pytest-xdist runs
several workers, so each worker keeps to two intra-op threads."""

import numpy as np
import pytest
import torch

from longqc_tpu_torch.config import MapOpt
from longqc_tpu_torch.engine import device_index as di
from longqc_tpu_torch.engine import overlap_host as oh
from longqc_tpu_torch.engine.pipeline import _control_ref_path
from longqc_tpu_torch.io.fastx import iter_fastx
from util_synth import make_genome, sample_reads, write_fastq_file

torch.set_num_threads(2)

ONT_ADP5 = "AATGTACTTCGTTCAGTTACGTATTGCT"
# sampleqc's tables and QC JSON, under its output directory
SAMPLEQC_TABLES = ["analysis/minimap2/coverage_out.txt",
                   "analysis/longqc_sdust.txt", "analysis/subsample.fastq"]
QC_JSON = "QC_vals_longQC_sampleqc.json"


def t32(a):
    """numpy -> int32 CPU tensor (uint32 words keep their bits)."""
    a = np.array(a)                     # a writable copy
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.astype(np.int32, copy=False))


def np_(t):
    return t.cpu().numpy()


def segment_rows(rng, Q, A, n_seg, long_lens=(), dense_len=0, fill=False):
    """B2 input rows of many (strand, target) segments: numpy int32
    ax_hi, ax_lo, aq (Q, A) and n (Q,), each row sorted by (ax_hi,
    ax_lo). A row holds n_seg short segments (1-20 anchors, one in five
    20-200), one of each length in long_lens and, with dense_len, one
    repeat-dense segment (positions in an 800 bp band, scattered query
    positions: deep windows and max_skip cuts), in random order, with
    trailing segments dropped past A; fill: the last segment grown or
    cut so that n == A."""
    axh = np.zeros((Q, A), np.int32)
    axl = np.zeros((Q, A), np.int32)
    aq = np.zeros((Q, A), np.int32)
    n = np.zeros(Q, np.int32)
    for r in range(Q):
        lens = [int(rng.randint(20, 200)) if rng.rand() < 0.2 else
                int(rng.randint(1, 21)) for _ in range(n_seg)]
        lens += [int(x) for x in long_lens]
        kinds = [0] * len(lens)
        if dense_len:
            lens.append(int(dense_len))
            kinds.append(1)
        order = rng.permutation(len(lens))
        lens = [lens[i] for i in order]
        kinds = [kinds[i] for i in order]
        while sum(lens) > A:
            lens.pop()
            kinds.pop()
        if fill and lens:
            lens[-1] += A - sum(lens)
        keys = np.sort(rng.choice(1 << 20, len(lens), replace=False))
        keys = keys | (rng.rand(len(lens)) < 0.5).astype(np.int64) << 24
        keys = np.sort(keys)
        off = 0
        for key, L, dense in zip(keys, lens, kinds):
            if dense:
                pos = np.sort(rng.randint(0, 800, L))
                q = rng.randint(0, 20000, L)
                near = rng.rand(L) < 0.3
                q[near] = pos[near] + rng.randint(-30, 30, int(near.sum()))
            else:
                pos = np.sort(rng.randint(0, max(400, 40 * L), L))
                q = pos + rng.randint(0, 5000) + rng.randint(0, 3, L) * \
                    rng.randint(1, 400) + rng.randint(-40, 40, L)
            axh[r, off:off + L] = key
            axl[r, off:off + L] = pos
            aq[r, off:off + L] = np.clip(q, 0, None)
            off += L
        n[r] = off
    return axh, axl, aq, n


def rand_reads(rng, n, lo, hi, with_n=True):
    """[name, seq, ""] reads of lo..hi random bases, half of them (with
    with_n) carrying a short N run."""
    reads = []
    for i in range(n):
        ln = rng.randint(lo, hi)
        s = "".join("ACGT"[j] for j in rng.randint(0, 4, ln))
        if with_n and ln > 10 and rng.rand() < 0.5:
            p = rng.randint(0, ln - 5)
            s = s[:p] + "N" * rng.randint(1, 4) + s[p + 3:]
        reads.append(["r%04d" % i, s, ""])
    return reads


def index_triples(ih, irid, ips):
    """Sorted real (hash, rid, pos << 1 | strand) entries of a flat
    index or chunk; the max of the hash lanes' dtype marks the empty
    slots."""
    ih, irid, ips = (np.asarray(a) for a in (ih, irid, ips))
    keep = ih != np.iinfo(ih.dtype).max
    return sorted(zip(ih[keep].tolist(), irid[keep].tolist(),
                      ips[keep].tolist()))


def rand_seq(rng, n, with_n=0.0):
    s = rng.choice(list("ACGT"), size=n)
    if with_n:
        s[rng.random_sample(n) < with_n] = "N"
    return "".join(s)


def ont_sampleqc_reads():
    """60 reads of 0.7-2.2 kbp (err 0.1, 10 % junk), the ont-ligation 5'
    adapter planted on the first 25."""
    rng = np.random.RandomState(21)
    reads = sample_reads(rng, make_genome(rng, 15000), 60, min_len=700,
                         max_len=2200, err=0.1, junk_frac=0.1)
    for r in reads[:25]:
        r[1] = ONT_ADP5 + r[1]
        r[2] = "I" * len(ONT_ADP5) + r[2]
    return reads


def pb_sampleqc_reads():
    """50 reads of 0.7-1.8 kbp (err 0.12, 10 % junk), 6 of them (named
    control*) drawn from the Sequel control of the port's refs/."""
    # seed 31 draws a GC window at a read's last 149 bases, where the JAX
    # package raises IndexError (the port's fix is held in
    # tests/test_torch_chunkqc.py::test_chunk_gc_window_at_the_read_end)
    rng = np.random.RandomState(32)
    reads = sample_reads(rng, make_genome(rng, 12000), 44, min_len=700,
                         max_len=1800, err=0.12, junk_frac=0.1)
    ctl = [s for _n, s, _q in iter_fastx(_control_ref_path(True))]
    for i, r in enumerate(sample_reads(rng, ctl[0] * 3, 6, min_len=900,
                                       max_len=2500, err=0.1)):
        reads.insert(3 + 7 * i, ["control%d" % i] + r[1:])
    return reads


def compare_qc_json(got, want, path=""):
    """Two QC JSON dicts: the same keys in the same order, integers and
    strings equal, floats equal except those of the coverage fits
    (Coverage_stats), within rel=1e-9 (EM summation order; see
    tests/test_torch_distfit.py)."""
    assert type(got) is type(want), path
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            compare_qc_json(got[k], want[k], path + "/" + k)
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            compare_qc_json(a, b, "%s[%d]" % (path, i))
    elif isinstance(want, float) and path.startswith("/Coverage_stats"):
        assert got == pytest.approx(want, rel=1e-9), path
    else:
        assert got == want, path


def assert_same_npz(got, want):
    """Two index caches (npz): the same keys, and per key the same dtype
    and values."""
    with np.load(got, allow_pickle=True) as za, \
            np.load(want, allow_pickle=True) as zb:
        a = {key: za[key] for key in za.files}
        b = {key: zb[key] for key in zb.files}
    assert sorted(a) == sorted(b) == ["h", "names", "ps", "rid",
                                      "seq_lens"]
    for key in b:
        assert a[key].dtype == b[key].dtype, key
        assert np.array_equal(a[key], b[key]), key


def chainer_anchor_sets(seed, n, k, w, hpc):
    """Anchor sets of n reads against an index of 80 reads (10 % junk),
    as the host spec collects them (on the CPU)."""
    rng = np.random.RandomState(seed)
    reads = sample_reads(rng, make_genome(rng, 15000), 80, min_len=500,
                         max_len=2500, err=0.12, junk_frac=0.1)
    idx = oh.build_index(reads, k, w, is_hpc=hpc, device="cpu")
    sk = oh._sketch_reads(reads[:n], k, w, hpc, "cpu")
    mid_occ = idx.mid_occ(MapOpt().mid_occ_frac)
    return [oh.collect_seed_hits(idx, q[0], len(q[1]), sk[i], mid_occ)[:2]
            for i, q in enumerate(reads[:n])]


def assert_same_chains(got, want):
    """Two lists of chain lists [(score, anchor indices), ...]."""
    assert len(got) == len(want)
    for g, h in zip(got, want):
        assert [s for s, _ in g] == [s for s, _ in h]
        for (_, gi), (_, hi) in zip(g, h):
            assert gi.dtype == hi.dtype and np.array_equal(gi, hi)


def k17_inputs(tmp_path):
    """`mmcov -H -k 17` inputs: the Sequel control of the port's refs/
    as the target, 14 reads of a random genome and 6 of the control as
    the queries. -> (target path, query path)."""
    rng = np.random.RandomState(41)
    reads = sample_reads(rng, make_genome(rng, 15000), 14, min_len=600,
                         max_len=1400, err=0.12, junk_frac=0.1)
    ctl = [s for _n, s, _q in iter_fastx(_control_ref_path(True))]
    reads += [["ctl%d" % i] + r[1:] for i, r in enumerate(sample_reads(
        rng, ctl[0] * 3, 6, min_len=600, max_len=1400, err=0.12))]
    qf = str(tmp_path / "query.fq")
    write_fastq_file(qf, reads)
    return _control_ref_path(True), qf


def ext_edge_pairs(rng, Lq=200, Lt=190):
    """B5 inputs: (24, Lq) / (24, Lt) int32 codes and (24,) lengths. 14
    pairs of five kinds (related at 10 % substitutions, unrelated, the
    query's first half at 5 %, a 40-base deletion, equal), then ql = 0,
    tl = 0, ql = 1, tl = 1, both lengths past the arrays' width, an
    all-4 query, ql >> tl, ql << tl, and two unrelated pairs (which
    Z-drop at zdrop = 100)."""
    B = 24
    qs = np.full((B, Lq), 4, np.int32)
    ts = np.full((B, Lt), 4, np.int32)
    qlens = np.zeros(B, np.int32)
    tlens = np.zeros(B, np.int32)

    def mutate(x, p):
        x = x.copy()
        hit = rng.rand(len(x)) < p
        x[hit] = rng.randint(0, 4, hit.sum())
        return x

    for b in range(14):
        base = rng.randint(0, 4, rng.randint(60, Lq - 5))
        kind = b % 5
        if kind == 0:
            other = mutate(base, 0.1)
        elif kind == 1:
            other = rng.randint(0, 4, len(base))
        elif kind == 2:
            other = mutate(base[:len(base) // 2], 0.05)
        elif kind == 3:
            cut = len(base) // 3
            other = np.concatenate([base[:cut], base[cut + 40:]])
        else:
            other = base
        qc, tc = base[:Lq], other[:Lt]
        qs[b, :len(qc)], ts[b, :len(tc)] = qc, tc
        qlens[b], tlens[b] = len(qc), len(tc)
    for b in range(14, B):
        qs[b] = rng.randint(0, 4, Lq)
        ts[b] = qs[b, :Lt]
        qlens[b], tlens[b] = Lq - 20, Lt - 20
    qlens[14], tlens[15] = 0, 0
    qlens[16], tlens[17] = 1, 1
    qlens[18], tlens[18] = Lq + 9, Lt + 7
    qs[19], qlens[19] = 4, 120
    qlens[20], tlens[20] = Lq - 10, 12
    qlens[21], tlens[21] = 9, Lt - 5
    for b in (22, 23):
        ts[b] = rng.randint(0, 4, Lt)
    return qs, qlens, ts, tlens


def ext_strip_pairs(rng, Lq=600, Lt=590):
    """B5 inputs for the wide body's strips of 64 columns: the 24 pairs
    of ext_edge_pairs at (Lq, Lt), then related pairs of exactly 64, 65
    and 128 columns, and one whose target turns to code 4 after 40
    columns, which Z-drops in its second strip at zdrop = 100 (Lt >= 150).
    -> (28, Lq) / (28, Lt) int32 codes and (28,) lengths."""
    eq, eql, et, etl = ext_edge_pairs(rng, Lq, Lt)
    qs = np.full((4, Lq), 4, np.int32)
    ts = np.full((4, Lt), 4, np.int32)
    n = min(Lq, Lt) - 10
    qlens = np.array([Lq - 30, Lq - 30, 150, n], np.int32)
    tlens = np.array([64, 65, 128, n], np.int32)
    for b in range(4):
        qs[b, :qlens[b]] = rng.randint(0, 4, qlens[b])
        tc = qs[b, :tlens[b]].copy()
        sub = rng.rand(tlens[b]) < 0.05
        tc[sub] = rng.randint(0, 4, sub.sum())
        ts[b, :tlens[b]] = tc
    ts[3, 40:] = 4
    return (np.concatenate([eq, qs]), np.concatenate([eql, qlens]),
            np.concatenate([et, ts]), np.concatenate([etl, tlens]))


def adapter_codes(m):
    """Codes of an adapter of m bp: a preset's where one has that length
    (18, 28, 45, 50, 59, 64), else two presets' joined and cut to m."""
    from longqc_tpu_torch.config import PRESETS
    from longqc_tpu_torch.ops.adapter import encode
    adps = [a for p in PRESETS.values() for a in (p.adp5, p.adp3) if a]
    one = [a for a in adps if len(a) == m]
    seq = one[0] if one else (PRESETS["ont-rapid"].adp5
                              + PRESETS["ont-1dsq"].adp5) * (m // 109 + 1)
    return encode(seq[:m])


def adapter_windows(rng, adp, C, Lw):
    """(C, Lw) int32 windows and (C,) int32 lengths for the adapter
    search's alignment, by kind in turn: random; the adapter planted exact
    or mutated (substitutions, insertions, deletions), whole or running
    off either end; poly-A; tandem copies of an adapter fragment;
    dinucleotide repeats; random with N runs. Most lengths are Lw, one in
    seven shorter; the first three windows are 0, 1 and 2 columns long."""
    adp = np.asarray(adp, np.int32)
    m = len(adp)
    wins = rng.randint(0, 4, size=(C, Lw)).astype(np.int32)
    for c in range(C):
        kind = c % 7
        w = wins[c]
        if kind in (1, 2):
            a = list(adp)
            for _ in range(0 if kind == 1 else rng.randint(1, 4)):
                p = rng.randint(0, len(a))
                op = rng.randint(0, 3)
                if op == 0:
                    a[p] = (a[p] + rng.randint(1, 4)) % 4
                elif op == 1:
                    a.insert(p, rng.randint(0, 4))
                elif len(a) > 1:
                    del a[p]
            p = rng.randint(-len(a) // 2, Lw)
            lo, hi = max(p, 0), min(p + len(a), Lw)
            if hi > lo:
                w[lo:hi] = a[lo - p:hi - p]
        elif kind == 3:
            w[:] = np.where(rng.rand(Lw) < .05, rng.randint(1, 4, Lw), 0)
        elif kind == 4:
            f = rng.randint(2, max(3, min(m, 12)))
            s = rng.randint(0, m - f + 1) if m > f else 0
            frag = adp[s:s + f]
            w[:] = np.resize(frag, Lw)
        elif kind == 5:
            w[:] = np.resize(rng.randint(0, 4, 2), Lw)
        elif kind == 6:
            p = rng.randint(0, Lw)
            w[p:p + rng.randint(1, 20)] = 4
    lens = np.where(rng.rand(C) < 1 / 7, rng.randint(0, Lw + 1, C), Lw)
    lens[:3] = np.minimum((0, 1, 2), Lw)
    return wins, lens.astype(np.int32)


# bytes the tables tell apart besides ACGT: N, lower case, U / u, IUPAC
# codes, gap and stop symbols
ODD_BASES = list("NnacgtUuRYKMSWBDHVryk-.*")


def odd_bases(rng, n, odd=.03):
    s = rng.choice(list("ACGT"), size=n)
    hit = rng.random_sample(n) < odd
    s[hit] = rng.choice(ODD_BASES, size=int(hit.sum()))
    return "".join(s)


def pack_tile(rng, R, W, sep=4):
    """One R x W tile as the part build makes it: a read of no bases
    first (its end bit is the tile's last column), a read of every ASCII
    byte, ragged reads with N, lower case, U and IUPAC bases, and runs of
    reads of 0-19 bases that READS_PER_ROW cuts; its last row empty
    (R > 2). R = 1: a jumbo tile of one read."""
    b = di._TileBuilder(R, W, sep)
    every = "".join(map(chr, range(128)))
    if R == 1:
        b.add(0, every + odd_bases(rng, W - 5000))
        return b.tiles()[0]
    b.add(0, "")
    b.add(1, every)
    gid = 2
    while len(b.rows) < R - 2:
        # runs of 70 reads of 0-19 bases, then 10 longer ones
        n = rng.randint(0, 20) if gid % 80 < 70 else \
            rng.randint(1, min(W, 30000) // 2)
        b.add(gid, odd_bases(rng, n))
        gid += 1
    b.flush()
    return b.tiles()[0]
